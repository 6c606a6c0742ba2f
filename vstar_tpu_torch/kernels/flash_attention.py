"""Decoder attention: the K1 forward and K7 backward CUDA kernels, and
their plain PyTorch versions.

K1 replaces the Pallas forward of vstar_tpu/kernels/flash_attention.py
(`_fwd_kernel`); K7 replaces its backward (`_bwd_dq_kernel`,
`_bwd_dkv_kernel`). K1 (csrc/flash_attention.cu) takes every shape the
decoder gives it: prefill at the prompt buckets, 1-token decode, verify
and option chunks at `q_offsets` over a ragged cache, and the training
forward, where it also writes each row's log-sum-exp. K7
(csrc/flash_attention_bwd.cu) computes dQ and dK/dV from that
log-sum-exp and delta = sum(dO * O), as the TPU backward does.

On the H100 decode and short chunks are bound by the KV bytes read, and
prefill by the 4*Sq*Skv*D operations per head; the kernel reads the
cache in place through its strides (the TPU wrapper transposed to
head-major first) and stops at `kv_lens` and at the last causal column.

API (seq-major, as in the JAX package; always causal, scale D**-0.5, the
decoder's only use):
    out = flash_attention(q, k, v, kv_lens=None, q_offsets=None,
                          kv_valid=None)
      q: [B, Sq, H, D]; k, v: [B, Skv, H, D]
      kv_lens:   int [B]  valid keys per row (right padding)
      q_offsets: int [B]  kv coordinate of each row's first query
      kv_valid:  bool [B, Skv] optional per-key mask
With grad mode on and q, k or v requiring grad, `flash_attention` is
differentiable (`_FlashAttention`, the custom_vjp of the JAX package):
the forward keeps the log-sum-exp, the backward runs K7.

A CPU tensor takes the plain versions (`mha_reference`, and in autograd
`mha_forward_lse` / `mha_backward`); a CUDA tensor launches the kernels
or raises.
"""

from __future__ import annotations

import torch

from . import _build

# Kernel launches, and calls of the plain versions on CUDA tensors (a run
# of the main path should see only the launches grow). K1 counts its
# forward launches, with or without the log-sum-exp; K7 counts each of
# its two kernels.
launches = 0
plain_calls_cuda = 0
bwd_launches = {"dq": 0, "dkv": 0}
bwd_plain_calls_cuda = 0

HEAD_DIM = 128   # the head width the kernels are instantiated for


def _mask(q, k, kv_lens, q_offsets, kv_valid):
    """The causal, ragged key mask [B, 1, Sq, Skv] (True = attend)."""
    B, Sq = q.shape[:2]
    Skv = k.shape[1]
    dev = q.device
    if q_offsets is None:
        q_offsets = torch.zeros((B,), dtype=torch.int32, device=dev)
    if kv_lens is None:
        kv_lens = torch.full((B,), Skv, dtype=torch.int32, device=dev)
    ki = torch.arange(Skv, device=dev)[None, None, None, :]
    mask = ki < kv_lens[:, None, None, None]
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, None, :].bool()
    row = (q_offsets[:, None, None, None]
           + torch.arange(Sq, device=dev)[None, None, :, None])
    return mask & (ki <= row)


def mha_reference(q, k, v, kv_lens=None, q_offsets=None, kv_valid=None):
    """Plain causal masked MHA in f32 (vstar_tpu mha_reference).
    [B,S,H,D]."""
    global plain_calls_cuda
    if q.is_cuda:
        plain_calls_cuda += 1
    D = q.shape[-1]
    mask = _mask(q, k, kv_lens, q_offsets, kv_valid)
    qf = q.float() * D ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, k.float())
    logits = logits.masked_fill(~mask, float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.where(mask, torch.exp(logits - m), torch.zeros_like(logits))
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def mha_forward_lse(q, k, v, kv_lens=None, q_offsets=None, kv_valid=None):
    """K1 with its log-sum-exp, step by step in f32 (the TPU `_fwd`):
    (out [B,Sq,H,D] in q's dtype, lse f32 [B,Sq,H]); lse is -inf on a
    row whose keys are all masked."""
    global plain_calls_cuda
    if q.is_cuda:
        plain_calls_cuda += 1
    D = q.shape[-1]
    mask = _mask(q, k, kv_lens, q_offsets, kv_valid)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * D ** -0.5, k.float())
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p / l.clamp_min(1e-30), v.float())
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)),
                      torch.full_like(l, float("-inf")))
    return out.to(q.dtype), lse[..., 0].permute(0, 2, 1).contiguous()


def mha_backward(q, k, v, do, lse, delta, kv_lens=None, q_offsets=None,
                 kv_valid=None):
    """K7 step by step in f32 (the TPU `_bwd`): dq, dk, dv in the inputs'
    dtypes from dO, the forward's lse and delta = sum(dO * O) (f32
    [B,Sq,H]). Masked pairs, and rows with lse = -inf, get P = 0."""
    global bwd_plain_calls_cuda
    if q.is_cuda:
        bwd_plain_calls_cuda += 1
    scale = q.shape[-1] ** -0.5
    mask = _mask(q, k, kv_lens, q_offsets, kv_valid)
    qs = q.float() * scale
    dof = do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qs, k.float())
    lse_b = lse.permute(0, 2, 1)[..., None]            # [B,H,Sq,1]
    p = torch.where(mask, torch.exp(s - lse_b), torch.zeros_like(s))
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    ds = p * (dp - delta.permute(0, 2, 1)[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qs)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_operand(name: str, x: torch.Tensor, shape) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: expected bfloat16 on CUDA, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if x.stride(-1) != 1:
        raise ValueError(f"{name}: last dimension must be contiguous")
    if any(s % 8 for s in x.stride()[:-1]) or x.data_ptr() % 16:
        raise ValueError(f"{name}: rows must be 16-byte aligned (strides "
                         f"{x.stride()})")


def _row_vector(name, x, B, default, dev):
    if x is None:
        return torch.full((B,), default, dtype=torch.int32, device=dev)
    if tuple(x.shape) != (B,) or x.device != dev:
        raise ValueError(f"{name}: expected shape ({B},) on {dev}")
    return x.to(torch.int32).contiguous()


def _validate(q, k, v, kv_lens, q_offsets, kv_valid):
    """Check the kernel's operands; returns (kv_lens, q_offsets, kv_valid)
    as the kernel reads them (int32 [B] twice, uint8 [B, Skv] or None)."""
    if q.dim() != 4:
        raise ValueError(f"q: expected [B, Sq, H, D], got {tuple(q.shape)}")
    B, Sq, H, D = q.shape
    if D != HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {D} (kernel built for "
                         f"{HEAD_DIM})")
    Skv = k.shape[1] if k.dim() == 4 else -1
    _check_operand("q", q, (B, Sq, H, D))
    _check_operand("k", k, (B, Skv, H, D))
    _check_operand("v", v, (B, Skv, H, D))
    dev = q.device
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name}: on {t.device}, q on {dev}")
    kv_lens = _row_vector("kv_lens", kv_lens, B, Skv, dev)
    q_offsets = _row_vector("q_offsets", q_offsets, B, 0, dev)
    if kv_valid is not None:
        if tuple(kv_valid.shape) != (B, Skv) or kv_valid.device != dev:
            raise ValueError(f"kv_valid: expected shape ({B}, {Skv}) on "
                             f"{dev}")
        kv_valid = kv_valid.to(torch.uint8).contiguous()
    return kv_lens, q_offsets, kv_valid


def _forward_kernel(q, k, v, kv_lens, q_offsets, kv_valid, with_lse):
    """K1 on validated operands: out, and lse f32 [B,Sq,H] or None."""
    global launches
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Sq, H), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if out.numel() == 0:
        return out, lse
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.vstar_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            kv_lens.data_ptr(), q_offsets.data_ptr(),
            None if kv_valid is None else kv_valid.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, Sq, Skv, H, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *out.stride()[:3],
            0 if kv_valid is None else kv_valid.stride(0),
            *((0, 0, 0) if lse is None else lse.stride()), D ** -0.5,
            stream)
    _build.check(lib, code, "flash_attention")
    launches += 1
    return out, lse


def _device_route(q, what: str) -> bool:
    """True for a CPU tensor (plain version), False for CUDA (kernel)."""
    if q.device.type == "cpu":
        return True
    if not q.is_cuda:
        raise ValueError(f"{what}: unsupported device {q.device}")
    return False


def flash_attention_lse(q, k, v, kv_lens=None, q_offsets=None,
                        kv_valid=None):
    """(out [B,Sq,H,D], lse f32 [B,Sq,H]): K1 with its log-sum-exp."""
    if _device_route(q, "flash_attention"):
        return mha_forward_lse(q, k, v, kv_lens, q_offsets, kv_valid)
    return _forward_kernel(q, k, v, *_validate(q, k, v, kv_lens, q_offsets,
                                               kv_valid), with_lse=True)


def flash_attention_bwd(q, k, v, do, lse, delta, kv_lens=None,
                        q_offsets=None, kv_valid=None):
    """(dq, dk, dv): K7 from dO [B,Sq,H,D], the forward's lse and delta =
    sum(dO * O) (f32 [B,Sq,H] each)."""
    if _device_route(q, "flash_attention_bwd"):
        return mha_backward(q, k, v, do, lse, delta, kv_lens, q_offsets,
                            kv_valid)
    kv_lens, q_offsets, kv_valid = _validate(q, k, v, kv_lens, q_offsets,
                                             kv_valid)
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    _check_operand("do", do, (B, Sq, H, D))
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (B, Sq, H)
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{name}: expected contiguous float32 "
                             f"({B}, {Sq}, {H}) on {q.device}")
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty((B, Skv, H, D), dtype=k.dtype, device=k.device)
    dv = torch.empty((B, Skv, H, D), dtype=v.dtype, device=v.device)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), kv_lens.data_ptr(),
                q_offsets.data_ptr(),
                None if kv_valid is None else kv_valid.data_ptr(),
                B, Sq, Skv, H, *q.stride()[:3], *k.stride()[:3],
                *v.stride()[:3], *do.stride()[:3], *dq.stride()[:3],
                *dk.stride()[:3], *dv.stride()[:3], *lse.stride(),
                0 if kv_valid is None else kv_valid.stride(0), D ** -0.5,
                stream)
        code = lib.vstar_flash_attention_bwd_dq(*args)
        _build.check(lib, code, "flash_attention_bwd (dq)")
        bwd_launches["dq"] += 1
        code = lib.vstar_flash_attention_bwd_dkv(*args)
    _build.check(lib, code, "flash_attention_bwd (dkv)")
    bwd_launches["dkv"] += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """flash_attention with its backward (the JAX package's custom_vjp,
    flash_attention.py:375-394). The forward keeps q, k, v, out, lse and
    the masks; the backward computes delta outside the kernel, as JAX
    does, and returns no gradient for the masks. It keeps no state beyond
    ctx, so activation checkpointing may run the forward again."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lens, q_offsets, kv_valid):
        out, lse = flash_attention_lse(q, k, v, kv_lens, q_offsets,
                                       kv_valid)
        ctx.save_for_backward(q, k, v, out, lse, kv_lens, q_offsets,
                              kv_valid)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, kv_lens, q_offsets, kv_valid = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * out.float()).sum(-1)
        dq, dk, dv = flash_attention_bwd(q, k, v, do, lse, delta, kv_lens,
                                         q_offsets, kv_valid)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, kv_lens=None, q_offsets=None, kv_valid=None):
    """Causal masked multi-head attention. q,k,v: [B,S,H,D] -> [B,S,H,D]."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, kv_lens, q_offsets, kv_valid)
    if _device_route(q, "flash_attention"):
        return mha_reference(q, k, v, kv_lens, q_offsets, kv_valid)
    return _forward_kernel(q, k, v, *_validate(q, k, v, kv_lens, q_offsets,
                                               kv_valid), with_lse=False)[0]
