"""ViT-tower attention: the K2 CUDA kernel and its plain PyTorch version.

Replaces the Pallas `_kernel` of vstar_tpu/kernels/tower_attention.py,
which serves the OWL-ViT B/16 tower at 768x768 (S = 2305, 12 heads,
head_dim 64). That kernel kept all of K and V of a head resident, which
exceeds a Hopper block's shared memory; csrc/tower_attention.cu streams
K/V tiles with an online f32 softmax instead (TMA loads into a ring of
mbarriers, wgmma products, the softmax in registers) and masks the
ragged tail of S itself. On the H100 it is compute-bound (4*S^2*D*H =
16.3 GFLOP per layer per image); its gain is keeping the [S, S] scores
on chip.

A CPU tensor takes the plain version `tower_attention_reference`; a
CUDA tensor launches the kernel or raises. The kernel has no backward
(the towers are frozen in training and run under no_grad), so an input
that requires grad raises under grad mode on either device rather than
cutting the graph.
"""

from __future__ import annotations

import torch

from . import _build
from .flash_attention import _check_operand

launches = 0
plain_calls_cuda = 0
launches_by_batch = {}      # launches by batch size, counted above too
# launches by heads (a rank's share under a model split of the tower,
# nn/vit.py), counted above too
launches_by_heads = {}
_build.register_counters(__name__, "launches", "plain_calls_cuda",
                         "launches_by_batch", "launches_by_heads")

HEAD_DIM = 64


def tower_attention_reference(q, k, v):
    """The TPU kernel's math: f32 scores, full-row f32 softmax,
    probabilities rounded to v's dtype, f32 products. [B,S,H,D]."""
    global plain_calls_cuda
    if q.is_cuda:
        plain_calls_cuda += 1
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float())
    return out.to(q.dtype)


def _validate(q, k, v) -> None:
    if q.dim() != 4:
        raise ValueError(f"q: expected [B, S, H, D], got {tuple(q.shape)}")
    B, S, H, D = q.shape
    if D != HEAD_DIM:
        raise ValueError(f"tower_attention: head_dim {D} (kernel built for "
                         f"{HEAD_DIM})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, (B, S, H, D))
        if t.device != q.device:
            raise ValueError(f"{name}: on {t.device}, q on {q.device}")


def tower_attention(q, k, v):
    """Full bidirectional attention, scale D**-0.5. q, k, v: [B, S, H, D]
    -> [B, S, H, D]."""
    global launches
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError("tower_attention has no backward: run the tower "
                           "under torch.no_grad()")
    if q.device.type == "cpu":
        return tower_attention_reference(q, k, v)
    if not q.is_cuda:
        raise ValueError(f"tower_attention: unsupported device {q.device}")
    _validate(q, k, v)
    B, S, H, D = q.shape
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _build.library()
    code = _build.launch(
        lib.vstar_tower_attention_fwd, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, S, H, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], D ** -0.5)
    _build.check(lib, code, "tower_attention")
    launches += 1
    launches_by_batch[B] = launches_by_batch.get(B, 0) + 1
    launches_by_heads[H] = launches_by_heads.get(H, 0) + 1
    return out
