"""LLaMA decoder (Vicuna-7B shape), port of vstar_tpu/nn/llama.py.

Layer parameters stay stacked along a leading layer axis, as in the JAX
package, and the stack is walked by a Python loop. The KV cache is
ragged (right-padded rows, per-row lengths) and is updated IN PLACE:
each chunk's keys and values are written at the rows' `q_offsets`, and
attention reads the layer's cache slice where it lies. Every attention
call goes through the port's flash_attention (kernel K1 on the card; in
training also its backward K7).

Under a mesh (core/mesh.py) the layer stack is a tree of DTensors
sharded by the partition rules: the loop gathers layer i alone, from its
owner on the fsdp axis (core/mesh.layer_source), inside the recomputed
region under remat, so the gathered layer is dropped after the layer and
gathered again for its backward; in training the next layer's broadcast
is in flight while layer i computes. On a model axis above 1
(core/mesh.model_split, ModelSplit) the decoder is tensor-parallel as
vstar_tpu's compiled step is, in training and in an engine's forward:
each rank's layer holds its own heads and MLP columns, whose counts the
blocks read from the local weights' shapes; a block's normed input (and
LoRA's leaves) enter the split through `ModelSplit.enter`, whose
backward sums their partial gradients over the model group; the products
of wo and w_down are partial sums, reduced over the model group in f32
before the residual add; an engine's KV cache holds the rank's own KV
heads (`kv_heads`). Under remat the recompute runs the attention's
reduce again and stops before the MLP's (torch.utils.checkpoint stops
once the saved tensors are back), as XLA's rematted computation does.

An engine's stack on an fsdp axis above 1 lies on the hidden axis
(core/mesh.hidden_split), as vstar_tpu's compiled engine programs
reshard it: the residual stream is the rank's columns of D (sliced from
the embeddings, gathered whole after the last layer), each rmsnorm
all-reduces its sum of squares over the fsdp group, the q / k / v (and
LoRA's x @ A) and gate / up products are f32 partial sums all-reduced
over it in one call each, and wo and w_down give the rank's own columns
(summed over the model group where the model axis splits them too). The
KV cache is whole on fsdp. Under act-int8 (nn/quant.set_act_int8) the
quantized products of q / k / v and gate / up see the whole row: its
largest |value| is all-reduced over the fsdp group (MAX) first, the int8
entries' partial products are summed in int32 (the unsharded W8A8
product's bits, as XLA computes it), and the int4 entries under the
W4A8 gate run K6 on the rank's rows with the whole row's quantization
(_act_int8_dots).

Training: LoRA adapters (`layers.attn.lora`, train/lora.py) add their
delta to q and v before the reshape and rope, as in JAX; `remat`
recomputes each layer in the backward (torch.utils.checkpoint, the
JAX package's jax.checkpoint); `kv_valid` masks single keys.

Weight layout: dense weights are (in_dim, out_dim), raw or as the
quantized entries of nn/quant.py; every matmul goes through `qdot`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.config import LlamaConfig
from ..core.mesh import ModelSplit, hidden_split, layer_source, model_split
from ..core.params import Init, dense_init, embed_init
from ..kernels.flash_attention import flash_attention
from ..kernels.int4_matmul import (int4_matmul_w4a8, quantize_rows,
                                   w4a8_applies)
from .basic import init_rmsnorm, partial_dot, rmsnorm
from .quant import (act_int8, int4_routes, qdot, quantize_weight,
                    quantize_weight_int4, resolve_matrix_quant, w8a8_acc,
                    w8a8_quantize, w8a8_scale)
from .rope import apply_rope, rope_angles
from ..train.lora import (LORA_TARGETS, lora_delta, split_delta,
                          split_inputs)


@dataclasses.dataclass
class KVCache:
    """Ragged per-row KV cache. k/v: [L, B, S_max, H_kv, Dh]; length: [B].

    int8 mode: k/v int8 with per-(token, head) f32 scales k_scale /
    v_scale [L, B, S_max, H_kv] (vstar_tpu's int8 KV cache). Forwards
    quantize what they insert and dequantize the layer's cache in plain
    torch before attention, as JAX does outside its kernel.

    Forwards write k/v (and the scales) in place; a returned cache shares
    the storage of the one passed in and carries the new lengths."""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor  # int32 [B], valid prefix per row
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def kv_int8(self) -> bool:
        return self.k_scale is not None

    def tensors(self) -> Tuple[torch.Tensor, ...]:
        """The cache's storage: k, v and, in int8 mode, the scales."""
        return tuple(t for t in (self.k, self.v, self.k_scale, self.v_scale)
                     if t is not None)

    def with_length(self, length: torch.Tensor) -> "KVCache":
        """The same storage with other lengths."""
        return dataclasses.replace(self, length=length)


def kv_heads(params: Dict, cfg: LlamaConfig) -> int:
    """The KV heads a cache of this decoder holds on this rank: all of
    cfg's, or this rank's share where the tree's attention is split on
    the model axis (core/mesh.model_split)."""
    split = model_split(params["layers"])
    if split is None or "attn" not in split.blocks:
        return cfg.num_kv_heads
    return cfg.num_kv_heads // split.size


def init_cache(cfg: LlamaConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, kv_int8: bool = False, *,
               device, heads: Optional[int] = None) -> KVCache:
    """heads: the KV heads it holds (`kv_heads`; default all of cfg's)."""
    heads = cfg.num_kv_heads if heads is None else heads
    shape = (cfg.num_layers, batch, max_len, heads, cfg.head_dim)
    length = torch.zeros((batch,), dtype=torch.int32, device=device)
    if kv_int8:
        return KVCache(k=torch.zeros(shape, dtype=torch.int8, device=device),
                       v=torch.zeros(shape, dtype=torch.int8, device=device),
                       length=length,
                       k_scale=torch.zeros(shape[:-1], dtype=torch.float32,
                                           device=device),
                       v_scale=torch.zeros(shape[:-1], dtype=torch.float32,
                                           device=device))
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=length)


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, S, H, D] -> (int8 [B, S, H, D], f32 scale [B, S, H]) per token
    and head: absmax / 127, rounded half to even (vstar_tpu _quantize_kv).
    Both divisions are by tensors: on CUDA a Python-scalar divisor is a
    reciprocal multiply, not the IEEE quotient."""
    xf = x.float()
    s = (xf.abs().amax(dim=-1)
         / torch.full((), 127.0, device=x.device)).clamp_min(1e-10)
    return torch.round(xf / s[..., None]).to(torch.int8), s


def _dequantize_kv(q: torch.Tensor, s: torch.Tensor,
                   dtype) -> torch.Tensor:
    """int8 [B, S, H, D] x f32 [B, S, H] -> dtype."""
    return (q.float() * s[..., None]).to(dtype)


def _matrices(init: Init, quantize, name: str, in_dim: int, out_dim: int,
              lead=()):
    """A (stack of) dense (in, out) matrices, quantized per
    `resolve_matrix_quant(quantize, name)`: drawn one matrix at a time
    and quantized at once, so no full-precision stack is ever resident."""
    mode = resolve_matrix_quant(quantize, name)
    if not mode:
        return dense_init(init, in_dim, out_dim, lead)
    quant = quantize_weight_int4 if mode == "int4" else quantize_weight
    if not lead:
        return quant(dense_init(init, in_dim, out_dim))
    parts = [quant(dense_init(init, in_dim, out_dim))
             for _ in range(lead[0])]
    return {k: torch.stack([e[k] for e in parts]) for k in parts[0]}


def init_llama_params(init: Init, cfg: LlamaConfig, quantize=False) -> Dict:
    """quantize: False | True/'int8' | 'int4' | 'int4mix' (int4 for
    INT4MIX_INT4_KEYS, int8 for the other matrices), as
    vstar_tpu init_llama_params; embeddings and norms stay in init.dtype."""
    D, L = cfg.hidden_size, cfg.num_layers
    inter = cfg.intermediate_size

    def mats(name, in_dim, out_dim):
        return _matrices(init, quantize, name, in_dim, out_dim, (L,))

    layers = {
        "input_norm": init_rmsnorm(init, D, (L,)),
        "post_norm": init_rmsnorm(init, D, (L,)),
        "attn": {
            "wq": mats("wq", D, cfg.q_dim),
            "wk": mats("wk", D, cfg.kv_dim),
            "wv": mats("wv", D, cfg.kv_dim),
            "wo": mats("wo", cfg.q_dim, D),
        },
        "mlp": {
            "w_gate": mats("w_gate", D, inter),
            "w_up": mats("w_up", D, inter),
            "w_down": mats("w_down", inter, D),
        },
    }
    return {
        "embed_tokens": embed_init(init, cfg.vocab_size, D),
        "layers": layers,
        "final_norm": init_rmsnorm(init, D),
        "lm_head": _matrices(init, quantize, "lm_head", D, cfg.vocab_size),
    }


def _ragged_insert(cache_kv: torch.Tensor, new_kv: torch.Tensor,
                   offsets: torch.Tensor) -> None:
    """Write new_kv [B,S,...] into cache_kv [B,Smax,...] at per-row
    offsets, in place. Starts clamp to [0, Smax - S] as
    lax.dynamic_update_slice does."""
    B, S = new_kv.shape[:2]
    start = offsets.long().clamp(0, cache_kv.shape[1] - S)
    pos = start[:, None] + torch.arange(S, device=offsets.device)[None]
    rows = torch.arange(B, device=offsets.device)[:, None]
    cache_kv[rows, pos] = new_kv.to(cache_kv.dtype)


def _out_heads(w, whole: int, head_dim: int) -> int:
    """The heads a q / k / v matrix of this rank computes: its local
    columns over head_dim (a quantized entry is whole on the model
    axis)."""
    return w.shape[-1] // head_dim if isinstance(w, torch.Tensor) else whole


def _row_split_dot(x: torch.Tensor, w, split: Optional[ModelSplit]
                   ) -> torch.Tensor:
    """x @ w for wo / w_down: whole (qdot), or with `split` this rank's
    rows of w times its columns of x, summed over the model group in
    f32 and cast back to x's dtype."""
    if split is None:
        return qdot(x, w)
    return split.reduce(partial_dot(x, w)).to(x.dtype)


def _hidden_dots(x: torch.Tensor, ws, hidden: ModelSplit
                 ) -> Tuple[torch.Tensor, ...]:
    """x @ w for each w of q / k / v or gate / up on an engine's split
    hidden axis: this rank's rows of each w times its columns of x, f32
    partial sums added over the fsdp group in one all-reduce (XLA's
    combined all-reduce of the tuple) and cast back to x's dtype. A
    quantized entry's product is summed as its kernel returns it (in x's
    dtype); under act-int8, whose routes scale each row by its largest
    |value| over the whole row, _act_int8_dots."""
    if act_int8() and any(isinstance(w, dict) for w in ws):
        return _act_int8_dots(x, ws, hidden)
    sums = hidden.reduce_many(*(
        qdot(x, w).float() if isinstance(w, dict) else partial_dot(x, w)
        for w in ws))
    return tuple(y.to(x.dtype) for y in sums)


def _act_int8_dots(x: torch.Tensor, ws, hidden: ModelSplit
                   ) -> Tuple[torch.Tensor, ...]:
    """_hidden_dots under act-int8, as XLA computes vstar_tpu's act-int8
    products on the split: each row's |x| max over the fsdp group in one
    f32 all-reduce (MAX; site "act_max"), then
      * int8 entries: the rows quantized by w8a8_quantize's rule with that
        max, each rank's exact int32 partial dots summed in one int32
        all-reduce (site "act_int32"), then the scales: the unsharded
        _w8a8_dot's bits;
      * int4 entries whose W4A8 gate holds on the whole row: the rows
        quantized by quantize_rows with that max (the whole row's bits),
        K6 on this rank's rows (its f32 group sums), summed over the
        group with the other f32 partial sums, then times the rows' sx;
      * other int4 entries (W4A16, K5), raw matrices and LoRA's A: f32
        partial sums, as without act-int8."""
    lead, n = x.shape[:-1], x.shape[-1]
    int8 = [isinstance(w, dict) and "q" in w for w in ws]
    w4a8 = [isinstance(w, dict) and "q4" in w
            and w4a8_applies(x, w, hidden.size) for w in ws]
    xf = x.float()
    if any(int8) or any(w4a8):
        amax = hidden.max(xf.abs().amax(dim=-1, keepdim=True),
                          site="act_max")
    out = [None] * len(ws)
    if any(int8):
        xq, sx = w8a8_quantize(xf, amax)
        accs = iter(hidden.reduce_many(
            *(w8a8_acc(xq, w) for w, i8 in zip(ws, int8) if i8),
            site="act_int32"))
        for i, w in enumerate(ws):
            if int8[i]:
                out[i] = w8a8_scale(next(accs), sx, w, x.dtype)
    rest = [i for i in range(len(ws)) if not int8[i]]
    if any(w4a8):
        xq4, sx4 = quantize_rows(x.reshape(-1, n), amax.reshape(-1, 1))
        sx4 = sx4.reshape(*lead, 1)
    parts = []
    for i in rest:
        w = ws[i]
        if w4a8[i]:
            int4_routes["w4a8"] += 1
            parts.append(int4_matmul_w4a8(xq4, w["q4"], w["s4"].float())
                         .reshape(*lead, -1))
        elif isinstance(w, dict):
            parts.append(qdot(x, w).float())
        else:
            parts.append(partial_dot(x, w))
    if parts:
        for i, y in zip(rest, hidden.reduce_many(*parts)):
            out[i] = (y * sx4 if w4a8[i] else y).to(x.dtype)
    return tuple(out)


def _attention_block(lp: Dict, cfg: LlamaConfig, x: torch.Tensor,
                     cos: torch.Tensor, sin: torch.Tensor,
                     kv_lens: torch.Tensor,
                     q_offsets: Optional[torch.Tensor],
                     cache_k: Optional[torch.Tensor],
                     cache_v: Optional[torch.Tensor],
                     kv_valid: Optional[torch.Tensor] = None,
                     cache_ks: Optional[torch.Tensor] = None,
                     cache_vs: Optional[torch.Tensor] = None,
                     split: Optional[ModelSplit] = None,
                     hidden: Optional[ModelSplit] = None):
    """split: this block's model split (its wq / wk / wv / wo are the
    rank's shards), None when it computes whole. hidden: an engine's
    split of the hidden axis (x, and the rows of wq / wk / wv / LoRA's
    A and the columns of wo, are the rank's share of D), None when the
    layer is whole on it."""
    B, S, _ = x.shape
    Dh = cfg.head_dim
    H = _out_heads(lp["wq"], cfg.num_heads, Dh)
    Hkv = _out_heads(lp["wk"], cfg.num_kv_heads, Dh)
    lora, scale = lp.get("lora"), lp.get("lora_scale")
    targets = () if lora is None else LORA_TARGETS
    if hidden is not None:
        # x @ A of LoRA's targets is a partial sum too, reduced with q / k
        # / v in one all-reduce (as XLA combines them); B whole
        q, k, v, *xa = _hidden_dots(
            x, [lp["wq"], lp["wk"], lp["wv"]]
            + [lora[f"{t}_a"] for t in targets], hidden)
        extra = () if lora is None else \
            (*xa, *(lora[f"{t}_b"] for t in targets), scale)
    else:
        if split is not None:
            # LoRA's x @ A, B and scale are whole on every rank and get
            # partial gradients (its columns of B): they enter with x
            extra = () if lora is None else split_inputs(lora, scale, x)
            x, *extra = split.enter(x, *extra)
        q = qdot(x, lp["wq"])
        v = qdot(x, lp["wv"])
        k = qdot(x, lp["wk"])
    if lora is not None and split is None and hidden is None:
        q = q + lora_delta(lora, scale, "wq", x)
        v = v + lora_delta(lora, scale, "wv", x)
    elif lora is not None:
        xq, xv, bq, bv, s = extra
        q = q + split_delta(xq, bq, s, split)
        v = v + split_delta(xv, bv, s, split)
    q = apply_rope(q.reshape(B, S, H, Dh), cos, sin)
    k = apply_rope(k.reshape(B, S, Hkv, Dh), cos, sin)
    v = v.reshape(B, S, Hkv, Dh)

    if cache_k is not None:
        offs = q_offsets if q_offsets is not None else \
            torch.zeros((B,), dtype=torch.int32, device=x.device)
        if cache_ks is not None:        # int8 KV cache
            kq, ks = _quantize_kv(k)
            vq, vs = _quantize_kv(v)
            _ragged_insert(cache_k, kq, offs)
            _ragged_insert(cache_v, vq, offs)
            _ragged_insert(cache_ks, ks, offs)
            _ragged_insert(cache_vs, vs, offs)
            k_all = _dequantize_kv(cache_k, cache_ks, k.dtype)
            v_all = _dequantize_kv(cache_v, cache_vs, v.dtype)
        else:
            _ragged_insert(cache_k, k, offs)
            _ragged_insert(cache_v, v, offs)
            k_all, v_all = cache_k, cache_v
    else:
        k_all, v_all = k, v

    if Hkv != H:
        rep = H // Hkv
        k_all = k_all.repeat_interleave(rep, dim=2)
        v_all = v_all.repeat_interleave(rep, dim=2)

    out = flash_attention(q, k_all, v_all, kv_lens=kv_lens,
                          q_offsets=q_offsets, kv_valid=kv_valid)
    return _row_split_dot(out.reshape(B, S, H * Dh), lp["wo"], split)


def _mlp_block(lp: Dict, x: torch.Tensor,
               split: Optional[ModelSplit] = None,
               hidden: Optional[ModelSplit] = None) -> torch.Tensor:
    """split, hidden: as _attention_block's (the rank's MLP columns; its
    share of D)."""
    if split is not None:
        x, = split.enter(x)
    if hidden is not None:
        gate, up = _hidden_dots(x, (lp["w_gate"], lp["w_up"]), hidden)
    else:
        gate, up = qdot(x, lp["w_gate"]), qdot(x, lp["w_up"])
    return _row_split_dot(F.silu(gate) * up, lp["w_down"], split)


def llama_forward(params: Dict, cfg: LlamaConfig, hidden: torch.Tensor,
                  positions: torch.Tensor, kv_lens: torch.Tensor,
                  q_offsets: Optional[torch.Tensor] = None,
                  cache: Optional[KVCache] = None, remat: bool = False,
                  kv_valid: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Run the decoder stack over input embeddings.

    hidden:    [B, S, D] input embeddings
    positions: [B, S] RoPE positions
    kv_lens:   [B] valid kv after this chunk (cache_len + chunk_len)
    q_offsets: [B] kv coordinate of the chunk start (None = 0)
    cache:     optional KVCache, written in place at q_offsets; attention
               then runs over the whole cache.
    remat:     under grad, keep only each layer's input and recompute
               the layer in the backward
    kv_valid:  optional bool [B, S_kv] per-key mask (invalid [LOC] keys)

    Returns (hidden [B,S,D] after the final norm, cache with length
    kv_lens sharing the input cache's storage, or None)."""
    cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    split = model_split(params["layers"], cfg)
    attn_split, mlp_split = (
        None if split is None or name not in split.blocks else split
        for name in ("attn", "mlp"))

    d_split = hidden_split(params["layers"])

    def one_layer(x, lp, ck=None, cv=None, cks=None, cvs=None):
        h = rmsnorm(lp["input_norm"], x, cfg.rms_norm_eps, d_split)
        x = x + _attention_block(lp["attn"], cfg, h, cos, sin, kv_lens,
                                 q_offsets, ck, cv, kv_valid, cks, cvs,
                                 attn_split, d_split)
        h = rmsnorm(lp["post_norm"], x, cfg.rms_norm_eps, d_split)
        return x + _mlp_block(lp["mlp"], h, mlp_split, d_split)

    fetch = layer_source(params["layers"], prefetch=torch.is_grad_enabled())
    x = hidden if d_split is None else d_split.columns(hidden)
    for i in range(cfg.num_layers):
        kv = ()
        if cache is not None:
            kv = tuple(t[i] for t in cache.tensors())
        if remat and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(
                lambda x, *kv, i=i: one_layer(x, fetch(i), *kv), x, *kv,
                use_reentrant=False)
        else:
            x = one_layer(x, fetch(i), *kv)
    if d_split is not None:
        x = d_split.gather(x, site="residual")
    new_cache = None
    if cache is not None:
        new_cache = cache.with_length(kv_lens.to(torch.int32))
    return rmsnorm(params["final_norm"], x, cfg.rms_norm_eps), new_cache


def lm_logits(params: Dict, hidden: torch.Tensor) -> torch.Tensor:
    """Final hidden states -> vocab logits in f32 (for a stable CE)."""
    return qdot(hidden, params["lm_head"]).float()


def embed_tokens(params: Dict, ids: torch.Tensor,
                 dtype=torch.bfloat16) -> torch.Tensor:
    """Token ids -> embeddings; negative ids (sentinels) map to row 0."""
    safe = torch.where(ids < 0, torch.zeros_like(ids), ids).long()
    return F.embedding(safe, params["embed_tokens"]).to(dtype)
