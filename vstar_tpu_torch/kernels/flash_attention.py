"""Decoder attention: the K1 forward and K7 backward CUDA kernels, and
their plain PyTorch versions.

K1 replaces the Pallas forward of vstar_tpu/kernels/flash_attention.py
(`_fwd_kernel`); K7 replaces its backward (`_bwd_dq_kernel`,
`_bwd_dkv_kernel`). K1 (csrc/flash_attention.cu) takes every shape the
decoder gives it, on two routes: the tile route (Sq > 16: prefill,
option chunks, the training forward, where it also writes each row's
log-sum-exp), a register-resident FlashAttention-2 tile per block of
query rows; and the split route (Sq <= 16: 1-token decode and verify
chunks), which cuts each (batch, head)'s keys into `split_plan` shares
over the whole card and merges the partials in a second, ordered kernel
(`split_kv_reference` is its algebra in plain PyTorch, for the tests).
K7 (csrc/flash_attention_bwd.cu) computes dQ and dK/dV from that
log-sum-exp and delta = sum(dO * O), as the TPU backward does.

On the H100 decode and short chunks are bound by the KV bytes read, and
prefill by the 4*Sq*Skv*D operations per head; the kernels read the
cache in place through its strides (the TPU wrapper transposed to
head-major first) and stop at `kv_lens` and at the last causal column.

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

import math

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
# K1's launches by route (each wrapper call is one "tile" or one "split"
# launch, counted in `launches` too); "combine" counts the split route's
# second kernel, which merges the partials.
route_launches = {"tile": 0, "split": 0, "combine": 0}
# the split route's launches by query rows (1: a decode step, 8: a
# speculative verify chunk), counted in route_launches["split"] too
split_launches_by_rows = {}
# launches by (batch, query rows), both routes; counted in `launches` too
launches_by_shape = {}
# launches by query heads (a rank's share under a model split of the
# decoder, core/mesh.ModelSplit); counted in `launches` too
launches_by_heads = {}
# K7's calls by heads (each one launch of each of its two kernels,
# counted in `bwd_launches` too)
bwd_launches_by_heads = {}
_build.register_counters(__name__, "launches", "plain_calls_cuda",
                         "bwd_launches", "bwd_plain_calls_cuda",
                         "route_launches", "split_launches_by_rows",
                         "launches_by_shape", "launches_by_heads",
                         "bwd_launches_by_heads")

HEAD_DIM = 128   # the head width the kernels are instantiated for
SPLIT_MAX_SQ = 16    # query rows up to which K1 takes the split route
SPLIT_GROUP = 16     # keys per group: the split route's unit of work
SPLIT_MAX = 64       # most splits per (batch, head)


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


def split_plan(B: int, Sq: int, H: int, Skv: int, sm_count: int) -> int:
    """Splits per (batch, head) on K1's split route, from shapes and the
    card's SM count only (never from kv_lens, so the launch needs no host
    sync and can be captured in a CUDA graph): enough blocks for two per
    SM, at most one 16-key group of the cache capacity each."""
    del Sq      # every split covers all (<= 16) query rows
    want = -(-2 * sm_count // max(1, B * H))
    groups = max(1, -(-Skv // SPLIT_GROUP))
    return max(1, min(want, groups, SPLIT_MAX))


def split_ranges(kv_lens, q_offsets, Sq: int, n_splits: int):
    """[B, n_splits] start and end key of each split: the keys a row may
    see, [0, min(kv_len, q_offset + Sq)), in equal shares of whole 16-key
    groups; a short row leaves later splits empty (start == end)."""
    rng = torch.clamp(torch.minimum(kv_lens.long(), q_offsets.long() + Sq),
                      min=0)
    groups = (rng + SPLIT_GROUP - 1) // SPLIT_GROUP
    per = (groups + n_splits - 1) // n_splits
    s = torch.arange(n_splits, device=rng.device)[None, :]
    g0 = torch.minimum(s * per[:, None], groups[:, None])
    g1 = torch.minimum(g0 + per[:, None], groups[:, None])
    return (torch.minimum(g0 * SPLIT_GROUP, rng[:, None]),
            torch.minimum(g1 * SPLIT_GROUP, rng[:, None]))


def split_kv_reference(q, k, v, kv_lens=None, q_offsets=None, kv_valid=None,
                       n_splits: int = 1):
    """K1's split route step by step in f32: per split, the partial
    (m, l, unnormalised O) over its keys, then the merge in split order,
    O = sum_s e^(m_s - M) O_s / sum_s e^(m_s - M) l_s. Returns (out [B,Sq,H,D]
    in q's dtype, lse f32 [B,Sq,H], -inf on a row that sees no key, whose
    output is exactly 0). Used by the tests only."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    dev = q.device
    if q_offsets is None:
        q_offsets = torch.zeros((B,), dtype=torch.int32, device=dev)
    if kv_lens is None:
        kv_lens = torch.full((B,), Skv, dtype=torch.int32, device=dev)
    kv_lens = torch.clamp(kv_lens.long(), 0, Skv)
    mask = _mask(q, k, kv_lens, q_offsets, kv_valid)       # [B,1,Sq,Skv]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * D ** -0.5, k.float())
    start, end = split_ranges(kv_lens, q_offsets, Sq, n_splits)
    ki = torch.arange(Skv, device=dev)[None, :]
    parts = []
    for i in range(n_splits):
        own = (ki >= start[:, i:i + 1]) & (ki < end[:, i:i + 1])  # [B,Skv]
        mi = mask & own[:, None, None, :]
        si = s.masked_fill(~mi, float("-inf"))
        m = si.amax(dim=-1, keepdim=True)                     # [B,H,Sq,1]
        base = torch.where(torch.isinf(m), torch.zeros_like(m), m)
        p = torch.where(mi, torch.exp(si - base), torch.zeros_like(si))
        parts.append((m, p.sum(-1, keepdim=True),
                      torch.einsum("bhqk,bkhd->bhqd", p, v.float())))
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    Mb = torch.where(torch.isinf(M), torch.zeros_like(M), M)
    L = torch.zeros_like(M)
    O = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=dev)
    for m, l, o in parts:
        w = torch.where(torch.isinf(m), torch.zeros_like(m),
                        torch.exp(m - Mb))
        L = L + w * l
        O = O + w * o
    out = torch.where(L > 0, O / L.clamp_min(1e-30), torch.zeros_like(O))
    lse = torch.where(L > 0, M + torch.log(L.clamp_min(1e-30)),
                      torch.full_like(L, float("-inf")))
    return (out.permute(0, 2, 1, 3).to(q.dtype),
            lse[..., 0].permute(0, 2, 1).contiguous())


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
    if x.shape != shape:
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    st = x.stride()
    if st[-1] != 1:
        raise ValueError(f"{name}: last dimension must be contiguous")
    # every outer stride a multiple of 8 elements <=> so is their gcd
    if math.gcd(*st[:-1]) % 8 or x.data_ptr() % 16:
        raise ValueError(f"{name}: rows must be 16-byte aligned (strides "
                         f"{st})")


def _row_vector(name, x, B, default, dev):
    if x is None:
        return torch.full((B,), default, dtype=torch.int32, device=dev)
    if x.shape != (B,) or x.device != dev:
        raise ValueError(f"{name}: expected shape ({B},) on {dev}")
    if x.dtype == torch.int32 and x.is_contiguous():
        return x
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
        if kv_valid.shape != (B, Skv) or kv_valid.device != dev:
            raise ValueError(f"kv_valid: expected shape ({B}, {Skv}) on "
                             f"{dev}")
        if kv_valid.dtype != torch.uint8 or not kv_valid.is_contiguous():
            kv_valid = kv_valid.to(torch.uint8).contiguous()
    return kv_lens, q_offsets, kv_valid


_SM_COUNT = {}


def _sm_count(dev) -> int:
    n = _SM_COUNT.get(dev.index)
    if n is None:
        n = _SM_COUNT[dev.index] = \
            torch.cuda.get_device_properties(dev).multi_processor_count
    return n


def _forward_kernel(q, k, v, kv_lens, q_offsets, kv_valid, with_lse):
    """K1 on validated operands: out, and lse f32 [B,Sq,H] or None."""
    global launches
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    dev = q.device
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=dev)
    lse = torch.empty((B, Sq, H), dtype=torch.float32, device=dev) \
        if with_lse else None
    if out.numel() == 0:
        return out, lse
    n_splits = split_plan(B, Sq, H, Skv, _sm_count(dev)) \
        if Sq <= SPLIT_MAX_SQ else 0
    ws_o = ws_ml = None
    if n_splits:
        # one f32 workspace: the partial O [B, H, n, Sq, D], then (m, l)
        parts = B * H * n_splits * Sq
        ws = torch.empty((parts * (D + 2),), dtype=torch.float32, device=dev)
        ws_o = ws.data_ptr()
        ws_ml = ws_o + parts * D * 4
    lib = _build.library()
    code = _build.launch(
        lib.vstar_flash_attention_fwd, dev,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        kv_lens.data_ptr(), q_offsets.data_ptr(),
        None if kv_valid is None else kv_valid.data_ptr(),
        None if lse is None else lse.data_ptr(),
        ws_o, ws_ml, n_splits,
        B, Sq, Skv, H, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *out.stride()[:3],
        0 if kv_valid is None else kv_valid.stride(0),
        *((0, 0, 0) if lse is None else lse.stride()), D ** -0.5)
    _build.check(lib, code, "flash_attention")
    launches += 1
    launches_by_shape[(B, Sq)] = launches_by_shape.get((B, Sq), 0) + 1
    launches_by_heads[H] = launches_by_heads.get(H, 0) + 1
    if n_splits:
        route_launches["split"] += 1
        route_launches["combine"] += 1
        split_launches_by_rows[Sq] = split_launches_by_rows.get(Sq, 0) + 1
    else:
        route_launches["tile"] += 1
    return out, lse


def attention_kernel_info():
    """Build facts of every K1, K7 and K2 instantiation (one C call each):
    registers and local (spill) bytes per thread, static and dynamic
    shared memory, resident blocks per SM, threads per block."""
    return _build.kernel_info("vstar_attention_kernel_info")


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
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), kv_lens.data_ptr(), q_offsets.data_ptr(),
            None if kv_valid is None else kv_valid.data_ptr(),
            B, Sq, Skv, H, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *do.stride()[:3], *dq.stride()[:3],
            *dk.stride()[:3], *dv.stride()[:3], *lse.stride(),
            0 if kv_valid is None else kv_valid.stride(0), D ** -0.5)
    code = _build.launch(lib.vstar_flash_attention_bwd_dq, q.device, *args)
    _build.check(lib, code, "flash_attention_bwd (dq)")
    bwd_launches["dq"] += 1
    code = _build.launch(lib.vstar_flash_attention_bwd_dkv, q.device, *args)
    _build.check(lib, code, "flash_attention_bwd (dkv)")
    bwd_launches["dkv"] += 1
    bwd_launches_by_heads[H] = bwd_launches_by_heads.get(H, 0) + 1
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
