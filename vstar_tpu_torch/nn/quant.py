"""Weight quantization for the decoder and the towers (port of
vstar_tpu/nn/quant.py).

Entries, as in the JAX package:
  * int8 per output channel: {'q': int8 [..., IN, OUT], 's': f32 [..., 1, OUT]}
    (towers add their bias: {'q', 's', 'b'});
  * int4 group-wise: {'q4': uint8 [..., IN/2, OUT] (two's-complement
    nibbles, input 2k low, 2k+1 high), 's4': f32 [..., IN/GROUP4, OUT]}.

`qdot` dispatches as the JAX `qdot` does: int4 entries take the W4A8
kernel (K6) under the act-int8 switch where its gate holds (at most 16
rows, IN % 256 == 0, OUT % 128 == 0), else the W4A16 kernel (K5); int8 entries take
`_w8a8_dot` under the switch, else the int8 matvec kernel (K3/K4) for
at most 16 rows and a dequantize-and-matmul above (where the JAX package
leaves the product to XLA). The quantizers round half to even, as
jnp.round does, and give JAX's bits on the same f32 input.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import _build
from ..kernels.int4_matmul import (dequantize_int4, qdot4, qdot4_w4a8,
                                   w4a8_applies)
from ..kernels.int8_matmul import MAX_ROWS, int8_matmul

WeightEntry = Union[torch.Tensor, Dict[str, torch.Tensor]]

GROUP4 = 128  # int4 group size along the reduction dim

# Per-matrix recipe for quantize='int4mix' (vstar_tpu nn/quant.py:78):
# int4 for these matrices, per-channel int8 for the others.
INT4MIX_INT4_KEYS = ("w_gate", "w_up", "lm_head")

_LLAMA_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _ieee_div(a: torch.Tensor, d: float) -> torch.Tensor:
    """a / d by IEEE division, as JAX and the CPU divide: on CUDA, PyTorch
    divides by a Python scalar as a multiply by its reciprocal, one ulp
    off the quotient for ~4 % of values; a tensor divisor divides."""
    return a / torch.full_like(a, d)


def quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """w: [..., in, out] float -> {'q': int8, 's': f32 per-out-channel}.
    The reduction (in) axis shares a scale."""
    wf = w.float()
    scale = torch.clamp(_ieee_div(wf.abs().amax(dim=-2, keepdim=True), 127.0),
                        min=1e-8)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"q": q, "s": scale}


def quantize_weight_np(w) -> Dict:
    """Host (numpy) twin of quantize_weight, identical math."""
    wf = np.asarray(w, np.float32)
    scale = np.maximum(np.max(np.abs(wf), axis=-2, keepdims=True) / 127.0,
                       1e-8)
    q = np.clip(np.round(wf / scale), -127, 127).astype(np.int8)
    return {"q": q, "s": scale}


def quantize_weight_int4(w: torch.Tensor, group: int = GROUP4
                         ) -> Dict[str, torch.Tensor]:
    """Group-wise symmetric int4, two nibbles packed per uint8.

    w: [..., in, out] -> {'q4': uint8 [..., in/2, out] (element 2k in the
    low nibble, 2k+1 in the high one, both two's-complement signed, so
    `q & 0xF0` read as int8 is 16 * value), 's4': f32 [..., in/group, out]}.
    An `in` that `group` does not divide takes one group (per-channel)."""
    wf = w.float()
    lead = wf.shape[:-2]
    IN, OUT = wf.shape[-2], wf.shape[-1]
    if IN % group != 0:
        group = IN
    if IN % 2:
        raise ValueError(f"int4 needs an even reduction dim, got {IN}")
    g = wf.reshape(*lead, IN // group, group, OUT)
    scale = torch.clamp(_ieee_div(g.abs().amax(dim=-2, keepdim=True), 7.0),
                        min=1e-8)
    q = torch.clamp(torch.round(g / scale), -8, 7).to(torch.int16) & 0xF
    q = q.reshape(*lead, IN, OUT)
    packed = (q[..., 0::2, :] | (q[..., 1::2, :] << 4)).to(torch.uint8)
    return {"q4": packed, "s4": scale[..., 0, :]}


def quantize_weight_int4_np(w, group: int = GROUP4) -> Dict:
    """Host (numpy) twin of quantize_weight_int4, identical math and
    packed layout."""
    wf = np.asarray(w, np.float32)
    IN, OUT = wf.shape[-2], wf.shape[-1]
    if IN % group != 0:
        group = IN
    if IN % 2:
        raise ValueError(f"int4 needs an even reduction dim, got {IN}")
    g = wf.reshape(wf.shape[:-2] + (IN // group, group, OUT))
    scale = np.maximum(np.abs(g).max(axis=-2, keepdims=True) / 7.0, 1e-8)
    q = (np.clip(np.round(g / scale), -8, 7).astype(np.int8) & 0xF)
    q = q.reshape(wf.shape[:-2] + (IN, OUT)).astype(np.uint8)
    packed = (q[..., 0::2, :] | (q[..., 1::2, :] << 4)).astype(np.uint8)
    return {"q4": packed, "s4": scale[..., 0, :].astype(np.float32)}


def resolve_matrix_quant(quantize, name: str):
    """Per-weight quantize mode: 'int4mix' picks int4/int8 by matrix name
    (INT4MIX_INT4_KEYS); every other mode applies uniformly."""
    if quantize == "int4mix":
        return "int4" if name in INT4MIX_INT4_KEYS else "int8"
    return quantize


# The act-int8 switch (vstar_tpu nn/quant.py:152): per-row dynamic int8
# activations against the quantized weights. Off by default; read at
# every qdot call (the JAX package reads it when it traces).
_ACT_INT8 = False

# The int8 products of the act-int8 route of int8 entries (_w8a8_dot, and
# its partial products on an engine's hidden split: torch._int_mm, no
# kernel of the port), counted as the kernels count their launches.
w8a8_calls = 0
# qdot's route for int4 entries (W4A8 or W4A16), counted on every device
int4_routes = {"w4a8": 0, "w4a16": 0}
_build.register_counters(__name__, "w8a8_calls", "int4_routes")


def set_act_int8(on: bool):
    global _ACT_INT8
    _ACT_INT8 = bool(on)


def act_int8() -> bool:
    """The act-int8 switch's state."""
    return _ACT_INT8


def _int32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 [M, K] @ int8 [K, N] -> int32. On the card
    torch._int_mm, on operands padded with zeros to shapes its cuBLASLt
    int8 kernels take (at least 32 rows, K and N multiples of 16; 17 rows
    were refused at small K; the zeros add nothing and are sliced off), so
    the 32003-wide lm_head takes it too; on the CPU an f64 product, exact
    while |sum| < 2**53 (K * 127**2 is far below). Never f32: a 4096-long
    sum of 127**2 leaves f32's exact range."""
    M, K = a.shape
    N = b.shape[1]
    if not a.is_cuda:
        return (a.double() @ b.double()).to(torch.int32)
    pad_m, pad_k, pad_n = max(32 - M, 0), -K % 16, -N % 16
    if pad_m or pad_k:
        a = F.pad(a, (0, pad_k, 0, pad_m))
    if pad_k or pad_n:
        b = F.pad(b, (0, pad_n, 0, pad_k))
    return torch._int_mm(a, b.contiguous())[:M, :N]


def w8a8_quantize(xf: torch.Tensor, amax: Optional[torch.Tensor] = None):
    """_w8a8_dot's per-row int8 activations of f32 rows: sx = max(amax /
    127, 1e-8) (JAX's order: divide, then clamp), xq = clamp(round(xf /
    sx), -127, 127); (xq int8, sx f32 [..., 1]). `amax` [..., 1]: the
    rows' largest |value| where the caller holds part of each row (an
    engine's hidden split: the max over the fsdp group); default xf's."""
    if amax is None:
        amax = xf.abs().amax(dim=-1, keepdim=True)
    sx = torch.clamp(_ieee_div(amax, 127.0), min=1e-8)
    return torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8), sx


def w8a8_acc(xq: torch.Tensor, entry) -> torch.Tensor:
    """The exact int32 product xq [..., IN] @ entry's int8 q [IN, OUT]."""
    global w8a8_calls
    w8a8_calls += 1
    q = entry["q"]
    acc = _int32_matmul(xq.reshape(-1, xq.shape[-1]), q)
    return acc.reshape(*xq.shape[:-1], q.shape[-1])


def w8a8_scale(acc: torch.Tensor, sx: torch.Tensor, entry, dtype
               ) -> torch.Tensor:
    """An int32 product scaled by the rows' sx and the columns' s, in
    `dtype`."""
    return (acc.float() * sx * entry["s"].float()[..., 0, :]).to(dtype)


def _w8a8_dot(x: torch.Tensor, entry) -> torch.Tensor:
    """Per-row int8 activations against per-channel int8 weights, int32
    accumulation (vstar_tpu nn/quant._w8a8_dot)."""
    xq, sx = w8a8_quantize(x.float())
    return w8a8_scale(w8a8_acc(xq, entry), sx, entry, x.dtype)


def dequantize_weight(entry: WeightEntry, dtype=torch.float32
                      ) -> torch.Tensor:
    if isinstance(entry, dict) and "q4" in entry:
        return dequantize_int4(entry["q4"], entry["s4"]).to(dtype)
    if isinstance(entry, dict) and "q" in entry:
        return (entry["q"].float() * entry["s"].float()).to(dtype)
    return entry.to(dtype)


def qdot(x: torch.Tensor, entry: WeightEntry) -> torch.Tensor:
    """x @ W for a raw or quantized (int8 per-channel / int4 group-wise)
    weight entry."""
    if isinstance(entry, dict) and "q4" in entry:
        if _ACT_INT8 and w4a8_applies(x, entry):
            int4_routes["w4a8"] += 1
            return qdot4_w4a8(x, entry)
        int4_routes["w4a16"] += 1
        return qdot4(x, entry)
    if isinstance(entry, dict) and "q" in entry:
        if _ACT_INT8:
            return _w8a8_dot(x, entry)
        IN = x.shape[-1]
        rows = x.numel() // IN
        if rows <= MAX_ROWS and entry["q"].dim() == 2:
            y = int8_matmul(x.reshape(rows, IN).contiguous(), entry["q"],
                            entry["s"])
            return y.reshape(*x.shape[:-1], entry["q"].shape[-1])
        w = entry["q"].to(x.dtype) * entry["s"].to(x.dtype)
        return x @ w
    return x @ entry.to(x.dtype)


def quantize_llama_params(llama_params: Dict) -> Dict:
    """int8 the decoder's large matmul weights (layers + lm_head);
    embeddings and norms stay high-precision."""
    out = dict(llama_params)
    layers = {k: dict(v) for k, v in llama_params["layers"].items()}
    for group in ("attn", "mlp"):
        for k in list(layers[group].keys()):
            if k in _LLAMA_QUANT_KEYS:
                layers[group][k] = quantize_weight(layers[group][k])
    out["layers"] = layers
    out["lm_head"] = quantize_weight(llama_params["lm_head"])
    return out


def quantize_vit_params(vit_params: Dict) -> Dict:
    """Per-channel int8 for a ViT tower's dense matmul weights (attn
    q/k/v/o + MLP); biases, norms and embeddings stay high-precision."""
    out = dict(vit_params)
    layers = {k: (dict(v) if isinstance(v, dict) else v)
              for k, v in vit_params["layers"].items()}
    for group in ("attn", "mlp"):
        g = dict(layers[group])
        for k, entry in g.items():
            qe = quantize_weight(entry["w"])
            e = {kk: v for kk, v in entry.items() if kk != "w"}
            e["q"], e["s"] = qe["q"], qe["s"]
            g[k] = e
        layers[group] = g
    out["layers"] = layers
    return out


def quantize_model_towers(params: Dict) -> Dict:
    """int8 the ViT towers of a built model tree (keys 'vision' and, for
    the VSM, 'owl_tower')."""
    out = dict(params)
    for key in ("vision", "owl_tower"):
        if key in out:
            out[key] = quantize_vit_params(out[key])
    return out
