"""LLaMA decoder (Vicuna-7B shape), port of vstar_tpu/nn/llama.py.

Layer parameters stay stacked along a leading layer axis, as in the JAX
package, and the stack is walked by a Python loop. The KV cache is
ragged (right-padded rows, per-row lengths) and is updated IN PLACE:
each chunk's keys and values are written at the rows' `q_offsets`, and
attention reads the layer's cache slice where it lies. Every attention
call goes through the port's flash_attention (kernel K1 on the card; in
training also its backward K7).

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
from ..core.params import Init, dense_init, embed_init, layer
from ..kernels.flash_attention import flash_attention
from .basic import init_rmsnorm, rmsnorm
from .quant import (qdot, quantize_weight, quantize_weight_int4,
                    resolve_matrix_quant)
from .rope import apply_rope, rope_angles
from ..train.lora import lora_delta


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


def init_cache(cfg: LlamaConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, kv_int8: bool = False, *,
               device) -> KVCache:
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
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


def _attention_block(lp: Dict, cfg: LlamaConfig, x: torch.Tensor,
                     cos: torch.Tensor, sin: torch.Tensor,
                     kv_lens: torch.Tensor,
                     q_offsets: Optional[torch.Tensor],
                     cache_k: Optional[torch.Tensor],
                     cache_v: Optional[torch.Tensor],
                     kv_valid: Optional[torch.Tensor] = None,
                     cache_ks: Optional[torch.Tensor] = None,
                     cache_vs: Optional[torch.Tensor] = None):
    B, S, _ = x.shape
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = qdot(x, lp["wq"])
    v = qdot(x, lp["wv"])
    if "lora" in lp:
        q = q + lora_delta(lp["lora"], lp["lora_scale"], "wq", x)
        v = v + lora_delta(lp["lora"], lp["lora_scale"], "wv", x)
    q = apply_rope(q.reshape(B, S, H, Dh), cos, sin)
    k = apply_rope(qdot(x, lp["wk"]).reshape(B, S, Hkv, Dh), cos, sin)
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
    return qdot(out.reshape(B, S, H * Dh), lp["wo"])


def _mlp_block(lp: Dict, x: torch.Tensor) -> torch.Tensor:
    gate = F.silu(qdot(x, lp["w_gate"]))
    return qdot(gate * qdot(x, lp["w_up"]), lp["w_down"])


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

    def one_layer(x, lp, ck=None, cv=None, cks=None, cvs=None):
        h = rmsnorm(lp["input_norm"], x, cfg.rms_norm_eps)
        x = x + _attention_block(lp["attn"], cfg, h, cos, sin, kv_lens,
                                 q_offsets, ck, cv, kv_valid, cks, cvs)
        h = rmsnorm(lp["post_norm"], x, cfg.rms_norm_eps)
        return x + _mlp_block(lp["mlp"], h)

    x = hidden
    for i in range(cfg.num_layers):
        lp = layer(params["layers"], i)
        kv = ()
        if cache is not None:
            kv = tuple(t[i] for t in cache.tensors())
        if remat and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(one_layer, x, lp, *kv,
                                                  use_reentrant=False)
        else:
            x = one_layer(x, lp, *kv)
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
