"""The compiled search (port of vstar_tpu/search/compiled.py): the guided
search's policy state and transitions on the device, and whole
detect-path searches as device steps.

  * `PolicyState` / `policy_state_init` / `chain_store_init` — the
    fixed-capacity queue and path as tensors (slot allocation is
    monotonic; pop = max score, ties to the earliest insertion, as
    heapq's (-score, counter)), and the chain field [P, Hc, Wc] f32.
  * `injected_step`, `context_push`, `grow_and_pop`, `context_push_low`
    — policy transitions driven by VSM outputs given from outside
    (`visual_search_device_policy` drives them from any VSMClient).
  * `fused_search` / `fused_search_batched` — the production search:
    each step pops the path tail, cuts both tower windows out of the
    device canvas (kernels/image_ops), runs the whole VSM (towers,
    prefill, the speculative decode as graph replays of
    decode/graphs.py, the [LOC] heads) and applies the transition.
    Context cues run in the same steps: a weak step decodes the context
    ANSWER with the stacked context-question layout, the host parses its
    noun chunk, and the next call runs the segment layout and the push.

JAX runs the steps inside one `lax.while_loop` and reads its exit record
once per exit. Here the loop is a host loop of device steps, and each
step reads the packed exit record (`_pack_exit`) once, besides the
decode's one read per verify chunk; the policy state, the chain store,
the heatmaps and the detection arrays stay on the device, and the
detection arrays reach the host only for the root multi-instance accept.
`CompiledVSMSearch.last_host_reads` counts a search's reads.

Every transition is written over a leading batch axis (the JAX
package's vmapped form); the single-search functions are the batch of
one. The chain store is updated in place, as JAX donates it.

Heatmap semantics match the host path: mask logits are bilinear-resized
(torch half-pixel convention, data/preprocess.py resize_bilinear_torch)
onto the patch's canvas window by one-hot weight matmuls, clamped at 0,
min-max normalized; sub-patch scores are heat-mass fractions summed over
the ancestor chain weighted 1/4^level (visual_search.py:451-465), kept
as a running chain field so that child scores are one rect sum.
"""

from __future__ import annotations

import logging
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..decode.graphs import DecodeGraphs

_LOG = logging.getLogger(__name__)


def _log_cap(P_cur: int, P_new) -> None:
    """One line whenever the P path capacity binds (the cap must never
    end a search silently)."""
    if P_new is None:
        _LOG.warning(
            "compiled search hit the grow-limit path capacity (%d); "
            "ending in the low-confidence fallback unlike the host "
            "policy", P_cur)
    else:
        _LOG.info("compiled search outgrew path capacity %d; growing the "
                  "device state to %d", P_cur, P_new)


# Exit codes of a policy transition.
RUNNING = 0
ACCEPT = 1          # top detection sigmoid > confidence_high
NEED_CTX = 2        # heatmap weak -> the context cue
QUEUE_EMPTY = 3
MAX_STEPS = 4       # path hit max_steps (or the P capacity)

_NEG = float(np.float32(-3.4e38))
_BIGI = 2 ** 31 - 1

_I32, _F32 = torch.int32, torch.float32


class PolicyState(NamedTuple):
    # priority queue, capacity K = 4 * P (each processed step pushes <= 4)
    q_bbox: torch.Tensor      # [K, 4] i32 (x, y, w, h) canvas pixels
    q_level: torch.Tensor     # [K] i32 scale level
    q_score: torch.Tensor     # [K] f32 priority
    q_parent: torch.Tensor    # [K] i32 path index of parent
    q_counter: torch.Tensor   # [K] i32 insertion order (heapq tie-break)
    q_valid: torch.Tensor     # [K] bool
    counter: torch.Tensor     # i32 [], next free slot / insertion id
    # search path (visited steps, in visit order), capacity P
    n_path: torch.Tensor      # i32 []
    p_bbox: torch.Tensor      # [P, 4] i32
    p_level: torch.Tensor     # [P] i32
    p_parent: torch.Tensor    # [P] i32
    p_score: torch.Tensor     # [P] f32 (priority the step was queued with)
    p_top_logit: torch.Tensor  # [P] f32 stashed low-confidence top sigmoid
    p_has_stash: torch.Tensor  # [P] bool temp_detection_result present
    p_det_box: torch.Tensor   # [P, 4] f32 patch-local [x, y, w, h] top box


def policy_state_init(root_w: int, root_h: int, P: int,
                      device="cpu") -> PolicyState:
    """Root patch [0, 0, W, H] at scale level 1, the path seeded with it
    (visual_search.py:487-494)."""
    K = 4 * P
    z = dict(device=device)
    p_bbox = torch.zeros((P, 4), dtype=_I32, **z)
    p_bbox[0] = torch.tensor([0, 0, root_w, root_h], dtype=_I32, **z)
    p_level = torch.zeros((P,), dtype=_I32, **z)
    p_level[0] = 1
    return PolicyState(
        q_bbox=torch.zeros((K, 4), dtype=_I32, **z),
        q_level=torch.zeros((K,), dtype=_I32, **z),
        q_score=torch.zeros((K,), dtype=_F32, **z),
        q_parent=torch.zeros((K,), dtype=_I32, **z),
        q_counter=torch.zeros((K,), dtype=_I32, **z),
        q_valid=torch.zeros((K,), dtype=torch.bool, **z),
        counter=torch.zeros((), dtype=_I32, **z),
        n_path=torch.ones((), dtype=_I32, **z),
        p_bbox=p_bbox, p_level=p_level,
        p_parent=torch.full((P,), -1, dtype=_I32, **z),
        p_score=torch.zeros((P,), dtype=_F32, **z),
        p_top_logit=torch.zeros((P,), dtype=_F32, **z),
        p_has_stash=torch.zeros((P,), dtype=torch.bool, **z),
        p_det_box=torch.zeros((P, 4), dtype=_F32, **z))


def chain_store_init(P: int, Hc: int, Wc: int, device="cpu") -> torch.Tensor:
    """Per-path-step accumulated score field (canvas coordinates):
    chain_acc[i] = sum over i and its ancestors of each step's normalized
    heat / (total * 4^level). [P, Hc, Wc] f32 (201 MB at P = 16 on a
    2048 x 1536 canvas)."""
    return torch.zeros((P, Hc, Wc), dtype=_F32, device=device)


def _batch(state: PolicyState) -> PolicyState:
    return PolicyState(*(a[None] for a in state))


def _unbatch(state: PolicyState) -> PolicyState:
    return PolicyState(*(a[0] for a in state))


def stack_states(states: List[PolicyState]) -> PolicyState:
    return PolicyState(*(torch.stack(xs) for xs in zip(*states)))


def _rows(n: int, dev) -> torch.Tensor:
    return torch.arange(n, device=dev)


def _take(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """a[b, i[b]] for every row b: a [B, N, ...], i [B] -> [B, ...]."""
    return a[_rows(a.shape[0], a.device), i.long()]


def _put(a: torch.Tensor, i: torch.Tensor, v: torch.Tensor,
         mask: torch.Tensor) -> torch.Tensor:
    """A copy of a with a[b, i[b]] = v[b] where mask[b]."""
    rows = _rows(a.shape[0], a.device)
    m = mask.reshape(mask.shape + (1,) * (v.dim() - 1))
    out = a.clone()
    out[rows, i.long()] = torch.where(m, v.to(a.dtype), a[rows, i.long()])
    return out


def _select(mask: torch.Tensor, a: PolicyState, b: PolicyState
            ) -> PolicyState:
    """Row-wise where(mask, a, b) over every field; mask [B]."""
    return PolicyState(*(torch.where(
        mask.reshape(mask.shape + (1,) * (x.dim() - 1)), x, y)
        for x, y in zip(a, b)))


def _as_rows(v, B: int, dev, dtype=_F32) -> torch.Tensor:
    """A scalar or per-row value as a [B] tensor (a Python number by a
    fill on the device, not a copy from the host)."""
    if not isinstance(v, torch.Tensor):
        return torch.full((B,), v, dtype=dtype, device=dev)
    return v.to(device=dev, dtype=dtype).expand(B)


# ---------------------------------------------------------------------------
# Heatmap math (the host path's semantics on a statically padded grid)
# ---------------------------------------------------------------------------

def _interp_weights(out_static: int, off: torch.Tensor,
                    out_dyn: torch.Tensor, in_n: int) -> torch.Tensor:
    """[B, out_static, in_n] bilinear one-hot weights (torch half-pixel):
    output pixel o of a window starting at off with out_dyn pixels."""
    dev = off.device
    dyn = out_dyn.to(_F32)
    scale = torch.full_like(dyn, float(in_n)) / dyn         # IEEE quotient
    o = torch.arange(out_static, dtype=_F32, device=dev)[None]
    c = (o - off.to(_F32)[:, None] + 0.5) * scale[:, None] - 0.5
    c0 = torch.floor(c)
    frac = c - c0
    c0c = c0.clamp(0, in_n - 1)
    c1c = (c0 + 1).clamp(0, in_n - 1)
    j = torch.arange(in_n, dtype=_F32, device=dev)[None, None]
    return ((j == c0c[..., None]) * (1 - frac)[..., None]
            + (j == c1c[..., None]) * frac[..., None])


def _bbox_mask(bbox: torch.Tensor, Hc: int, Wc: int) -> torch.Tensor:
    """[B, Hc, Wc] inside each row's [x, y, w, h]."""
    dev = bbox.device
    ys = torch.arange(Hc, device=dev)[None, :, None]
    xs = torch.arange(Wc, device=dev)[None, None, :]
    x0, y0, w, h = (bbox[:, i, None, None] for i in range(4))
    return (ys >= y0) & (ys < y0 + h) & (xs >= x0) & (xs < x0 + w)


def _resize_clip(low: torch.Tensor, bbox: torch.Tensor, Hc: int,
                 Wc: int) -> torch.Tensor:
    in_h, in_w = low.shape[-2:]
    wy = _interp_weights(Hc, bbox[:, 1], bbox[:, 3], in_h)   # [B, Hc, h]
    wx = _interp_weights(Wc, bbox[:, 0], bbox[:, 2], in_w)   # [B, Wc, w]
    out = torch.matmul(torch.matmul(wy, low.to(_F32)), wx.transpose(1, 2))
    return torch.where(_bbox_mask(bbox, Hc, Wc), out.clamp_min(0.0),
                       torch.zeros_like(out))


def resize_clip_canvas(low: torch.Tensor, bbox, Hc: int,
                       Wc: int) -> torch.Tensor:
    """clip(resize_bilinear_torch(low, h, w), 0) placed at the patch's
    canvas window [y0:y0+h, x0:x0+w] of a [Hc, Wc] grid, zero elsewhere;
    bbox a tensor, so one shape serves every patch of a canvas bucket.
    low [h, w] -> [Hc, Wc] (or batched: [B, h, w], bbox [B, 4])."""
    single = low.dim() == 2
    bbox = torch.as_tensor(bbox, device=low.device)
    out = _resize_clip(low[None] if single else low,
                       bbox[None] if single else bbox, Hc, Wc)
    return out[0] if single else out


def _minmax_bbox(heat: torch.Tensor, bbox: torch.Tensor):
    valid = _bbox_mask(bbox, *heat.shape[1:])
    mx = torch.where(valid, heat, _NEG).amax(dim=(1, 2))
    mn = torch.where(valid, heat, -_NEG).amin(dim=(1, 2))
    return mn, mx, valid


def normalize_heat(heat, mn, mx, valid) -> torch.Tensor:
    """normalize_score (policy.py:125-129): (h - mn) / (mx - mn), or zeros
    where the heatmap is constant. heat [B, Hc, Wc]; mn, mx [B]."""
    rng = (mx - mn)[:, None, None]
    ok = valid & (rng != 0)
    return torch.where(ok, (heat - mn[:, None, None])
                       / torch.where(rng != 0, rng, torch.ones_like(rng)),
                       torch.zeros_like(heat))


def rect_sums(heat: torch.Tensor, rects: torch.Tensor) -> torch.Tensor:
    """Sums of heat [B, Hc, Wc] over 4 integer rects [B, 4, 4] per row (a
    contraction with row and column indicators; no gathers)."""
    dev = heat.device
    Hc, Wc = heat.shape[1:]
    ys = torch.arange(Hc, device=dev)[None, None]
    xs = torch.arange(Wc, device=dev)[None, None]
    iy = ((ys >= rects[..., 1:2]) & (ys < rects[..., 1:2] + rects[..., 3:4])
          ).to(_F32)
    ix = ((xs >= rects[..., 0:1]) & (xs < rects[..., 0:1] + rects[..., 2:3])
          ).to(_F32)
    return (torch.matmul(iy, heat) * ix).sum(dim=2)


# ---------------------------------------------------------------------------
# Geometry (split_4subpatches + get_sub_patches, policy.py:91-110)
# ---------------------------------------------------------------------------

def child_rects(bbox: torch.Tensor) -> torch.Tensor:
    """[B, 4] i32 (x, y, w, h) -> [B, 4, 4] i32 children: 2x2, or 4x1 /
    1x4 when the aspect ratio >= 2 or <= 0.5, the remainder absorbed by
    the last patch in each direction."""
    x0, y0, w, h = (bbox[:, i:i + 1] for i in range(4))
    ratio = h.to(_F32) / w.to(_F32)
    two = torch.full_like(w, 2)
    num_w = torch.where(ratio >= 2.0, torch.ones_like(w),
                        torch.where(ratio <= 0.5, 4 * torch.ones_like(w),
                                    two))
    num_h = torch.where(ratio >= 2.0, 4 * torch.ones_like(w),
                        torch.where(ratio <= 0.5, torch.ones_like(w), two))
    ws = torch.div(w, num_w, rounding_mode="floor")
    hs = torch.div(h, num_h, rounding_mode="floor")
    c = torch.arange(4, dtype=_I32, device=bbox.device)[None]
    i = c % num_w
    j = torch.div(c, num_w, rounding_mode="floor")
    cw = torch.where(i == num_w - 1, w - i * ws, ws)
    ch = torch.where(j == num_h - 1, h - j * hs, hs)
    return torch.stack([x0 + i * ws, y0 + j * hs, cw, ch],
                       dim=2).to(_I32)


# ---------------------------------------------------------------------------
# Policy transition pieces (batched over the leading axis)
# ---------------------------------------------------------------------------

def _push_children(state: PolicyState, idx, subs, scores,
                   do_push) -> PolicyState:
    """Queue 4 children at slots [counter, counter + 4) of each row where
    do_push (the slots stay invalid and the counter does not advance
    otherwise)."""
    B, K = state.q_valid.shape
    dev = subs.device
    rows = _rows(B, dev)[:, None]
    raw = state.counter[:, None] + torch.arange(4, dtype=_I32,
                                                device=dev)[None]
    slots = raw.clamp(0, K - 1).long()
    ok = do_push[:, None] & (raw < K)
    level = (_take(state.p_level, idx) + 1)[:, None].expand(B, 4)
    parent = idx[:, None].to(_I32).expand(B, 4)

    def put(a, v):
        m = ok.reshape(ok.shape + (1,) * (a.dim() - 2))
        out = a.clone()
        out[rows, slots] = torch.where(m, v.to(a.dtype), a[rows, slots])
        return out

    return state._replace(
        q_bbox=put(state.q_bbox, subs), q_level=put(state.q_level, level),
        q_score=put(state.q_score, scores),
        q_parent=put(state.q_parent, parent),
        q_counter=put(state.q_counter, raw),
        q_valid=put(state.q_valid, torch.ones_like(ok)),
        counter=state.counter + torch.where(do_push, 4, 0).to(_I32))


def _pop_append(state: PolicyState, max_steps):
    """heapq pop ((-score, counter) lexicographic min = max score, ties to
    the earliest insertion) and append to the path. Returns (state',
    exit_code [B]): QUEUE_EMPTY / MAX_STEPS when a search cannot go on
    (tested in the host policy's order, policy.py:260-262)."""
    P = state.p_bbox.shape[1]
    any_valid = state.q_valid.any(dim=1)
    cap = min(max_steps, P) if max_steps is not None else P
    full = state.n_path >= cap
    code = torch.where(~any_valid, QUEUE_EMPTY,
                       torch.where(full, MAX_STEPS, RUNNING)).to(_I32)
    best = torch.where(state.q_valid, state.q_score, _NEG).amax(dim=1)
    tie = state.q_valid & (state.q_score == best[:, None])
    slot = torch.where(tie, state.q_counter, _BIGI).argmin(dim=1)
    do = code == RUNNING
    n = state.n_path.clamp(0, P - 1)
    new = state._replace(
        q_valid=_put(state.q_valid, slot,
                     torch.zeros_like(do), do),
        p_bbox=_put(state.p_bbox, n, _take(state.q_bbox, slot), do),
        p_level=_put(state.p_level, n, _take(state.q_level, slot), do),
        p_parent=_put(state.p_parent, n, _take(state.q_parent, slot), do),
        p_score=_put(state.p_score, n, _take(state.q_score, slot), do),
        n_path=state.n_path + do.to(_I32))
    return new, code


def _detect_phase(state: PolicyState, det_valid, det_logits, det_boxes,
                  confidence_high, apply_sigmoid: bool = False):
    """Accept test and low-confidence stash for the path tail
    (visual_search.py:398-414). apply_sigmoid: det_logits are raw head
    outputs (production); the VSMClient protocol already delivers sigmoid
    probabilities. Returns (state', accept [B], top_sig [B], box [B, 4])."""
    B = det_logits.shape[0]
    dev = det_logits.device
    idx = state.n_path - 1
    bbox = _take(state.p_bbox, idx)
    w = bbox[:, 2].to(_F32)
    h = bbox[:, 3].to(_F32)
    sig = det_logits.to(_F32)
    if apply_sigmoid:
        sig = torch.sigmoid(sig)
    top = sig.argmax(dim=1)
    rows = _rows(B, dev)
    top_sig = torch.where(det_valid, sig[rows, top],
                          torch.zeros((), dtype=_F32, device=dev))
    scale = torch.stack([w, h, w, h], dim=1)
    fb = det_boxes[rows, top].to(_F32) * scale
    fb = torch.stack([fb[:, 0] - fb[:, 2] / 2, fb[:, 1] - fb[:, 3] / 2,
                      fb[:, 2], fb[:, 3]], dim=1)
    accept = det_valid & (top_sig > _as_rows(confidence_high, B, dev))
    stash = det_valid & ~accept
    state = state._replace(
        p_top_logit=_put(state.p_top_logit, idx, top_sig, stash),
        p_has_stash=_put(state.p_has_stash, idx, torch.ones_like(stash),
                         stash),
        p_det_box=_put(state.p_det_box, idx, fb, det_valid))
    return state, accept, top_sig, fb


def _expand_phase(state: PolicyState, store: torch.Tensor,
                  heat: torch.Tensor, *, max_steps, smallest_size,
                  target_cue_threshold, target_cue_threshold_decay,
                  target_cue_threshold_minimum, skip_threshold=False,
                  commit=None):
    """Threshold test, chain-field update, children push and pop for the
    path tail. heat: clipped heatmap in CANVAS coordinates [B, Hc, Wc]
    (zero outside the tail's window). skip_threshold (bool or [B]): the
    context-cue path (the host already decided; the context heat is
    final whatever its max). store [B, P, Hc, Wc] is updated IN PLACE
    where the step expands and `commit` ([B], default all) holds.

    Returns (state', exit_code [B])."""
    B, P = store.shape[:2]
    dev = store.device
    idx = state.n_path - 1
    bbox = _take(state.p_bbox, idx)
    level = _take(state.p_level, idx).to(_F32)
    hp, wp = bbox[:, 3], bbox[:, 2]

    small = torch.minimum(wp, hp) <= _as_rows(smallest_size, B, dev, _I32)
    mn, mx, valid = _minmax_bbox(heat, bbox)
    decay = torch.full_like(level, float(target_cue_threshold_decay)) \
        if not isinstance(target_cue_threshold_decay, torch.Tensor) \
        else target_cue_threshold_decay.to(_F32).expand(B)
    threshold = torch.maximum(
        _as_rows(target_cue_threshold_minimum, B, dev),
        _as_rows(target_cue_threshold, B, dev) * decay ** (level - 1.0))
    weak = mx <= threshold
    skip = _as_rows(skip_threshold, B, dev, torch.bool)
    need_ctx = ~skip & ~small & weak
    expand = ~small & (skip | ~weak)

    # chain field: the parent's accumulated terms + this step's term
    heat_n = normalize_heat(heat, mn, mx, valid)
    total = heat_n.sum(dim=(1, 2))[:, None, None]
    term = torch.where(total > 0, heat_n / torch.where(
        total > 0, total, torch.ones_like(total)), torch.zeros_like(heat_n))
    term = term / (torch.full_like(level, 4.0) ** level)[:, None, None]
    parent = _take(state.p_parent, idx)
    rows = _rows(B, dev)
    parent_acc = torch.where((parent >= 0)[:, None, None],
                             store[rows, parent.clamp(0, P - 1).long()],
                             torch.zeros_like(term))
    acc = parent_acc + term
    write = expand if commit is None else expand & commit
    store[rows, idx.long()] = torch.where(write[:, None, None], acc,
                                          store[rows, idx.long()])

    subs = child_rects(bbox)
    scores = rect_sums(acc, subs)   # the reference's ancestor loop, by
    #                                 linearity of rect sums
    rec = _push_children(state, idx, subs, scores, expand)
    popped, code = _pop_append(rec, max_steps)
    code = torch.where(need_ctx, NEED_CTX, code).to(_I32)
    # the NEED_CTX exit must not pop (the context push comes first)
    return _select(need_ctx, rec, popped), code


def _tail(state: PolicyState) -> torch.Tensor:
    return _take(state.p_bbox, state.n_path - 1)


def _bool(v, dev) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.bool, device=dev).reshape(1)


# ---------------------------------------------------------------------------
# Injected mode (one transition per VSM call; any VSMClient or oracle)
# ---------------------------------------------------------------------------

def injected_step(state: PolicyState, chain_store: torch.Tensor,
                  det_valid, det_logits, det_boxes, heat: torch.Tensor, *,
                  smallest_size: int, confidence_high: float,
                  target_cue_threshold: float,
                  target_cue_threshold_decay: float,
                  target_cue_threshold_minimum: float, max_steps):
    """One full policy transition for the path tail given its VSM detect
    outputs. heat: the patch's clipped heatmap placed at its canvas
    window of [Hc, Wc]. The store is updated in place. Returns
    (state', store, exit_code, next_bbox)."""
    dev = heat.device
    st = _batch(state)
    st1, accept, _, _ = _detect_phase(st, _bool(det_valid, dev),
                                      det_logits[None], det_boxes[None],
                                      confidence_high)
    st2, code = _expand_phase(
        st1, chain_store[None], heat[None], max_steps=max_steps,
        smallest_size=smallest_size,
        target_cue_threshold=target_cue_threshold,
        target_cue_threshold_decay=target_cue_threshold_decay,
        target_cue_threshold_minimum=target_cue_threshold_minimum,
        commit=~accept)
    out = _select(accept, st1, st2)        # accept preempts expansion
    code = torch.where(accept, ACCEPT, code).to(_I32)
    return _unbatch(out), chain_store, code[0], _tail(out)[0]


def grow_and_pop(state: PolicyState, chain_store: torch.Tensor, *,
                 P2: int, max_steps):
    """Double the path and queue capacity ON THE DEVICE and pop the next
    step. Called when a search hits the P capacity (exit MAX_STEPS) while
    the caller's max_steps is not the binding cap: the reference
    recursion is bounded only by patch size (visual_search.py:416-418).
    The tail step was already processed (children pushed), so growth pops
    the next queued patch. Queue entries can never have been dropped
    before growth: each of the <= P processed steps pushes <= 4 children,
    so counter <= 4P = K. Works on a single state (store [P, Hc, Wc]) or
    a batched one (store [B, P, Hc, Wc]). Returns (state', store',
    exit_code, next_bbox)."""
    single = state.n_path.dim() == 0
    st = _batch(state) if single else state
    store = chain_store[None] if single else chain_store
    P = st.p_bbox.shape[1]
    if P2 <= P:
        raise ValueError(f"grow_and_pop: P2 {P2} <= P {P}")
    K, K2 = 4 * P, 4 * P2

    def pad(a, n, fill=0):
        extra = torch.full((a.shape[0], n) + a.shape[2:], fill,
                           dtype=a.dtype, device=a.device)
        return torch.cat([a, extra], dim=1)

    st = PolicyState(
        q_bbox=pad(st.q_bbox, K2 - K), q_level=pad(st.q_level, K2 - K),
        q_score=pad(st.q_score, K2 - K), q_parent=pad(st.q_parent, K2 - K),
        q_counter=pad(st.q_counter, K2 - K),
        q_valid=pad(st.q_valid, K2 - K),
        counter=st.counter, n_path=st.n_path,
        p_bbox=pad(st.p_bbox, P2 - P), p_level=pad(st.p_level, P2 - P),
        p_parent=pad(st.p_parent, P2 - P, -1),
        p_score=pad(st.p_score, P2 - P),
        p_top_logit=pad(st.p_top_logit, P2 - P),
        p_has_stash=pad(st.p_has_stash, P2 - P),
        p_det_box=pad(st.p_det_box, P2 - P))
    store2 = pad(store, P2 - P)
    st, code = _pop_append(st, max_steps)
    nb = _tail(st)
    if single:
        return _unbatch(st), store2[0], code[0], nb[0]
    return st, store2, code, nb


def context_push(state: PolicyState, chain_store: torch.Tensor,
                 heat: torch.Tensor, *, smallest_size: int,
                 target_cue_threshold: float,
                 target_cue_threshold_decay: float,
                 target_cue_threshold_minimum: float, max_steps):
    """Host-computed context-cue heat (canvas coordinates) for the path
    tail -> chain-field update + push children + pop (the step's detect
    phase already ran). Returns (state', store, exit_code, next_bbox)."""
    st, code = _expand_phase(
        _batch(state), chain_store[None], heat[None], max_steps=max_steps,
        smallest_size=smallest_size,
        target_cue_threshold=target_cue_threshold,
        target_cue_threshold_decay=target_cue_threshold_decay,
        target_cue_threshold_minimum=target_cue_threshold_minimum,
        skip_threshold=True)
    return _unbatch(st), chain_store, code[0], _tail(st)[0]


def context_push_low_batched(states: PolicyState, stores: torch.Tensor,
                             codes: torch.Tensor, ctx_low: torch.Tensor,
                             ctx_valid, ctx_mask, smallest_sizes,
                             target_cue_threshold,
                             target_cue_threshold_decay,
                             target_cue_threshold_minimum, *, max_steps):
    """Production context-cue push, batched: rows with ctx_mask get their
    segment call's raw low-res mask logits as the tail's final heatmap,
    children pushed and the next step popped (RUNNING again unless the
    queue or cap ended them); the other rows pass through."""
    Hc, Wc = stores.shape[2:]
    bbox = _tail(states)
    heat = torch.where(ctx_valid[:, None, None],
                       _resize_clip(ctx_low, bbox, Hc, Wc),
                       torch.zeros((), dtype=_F32, device=stores.device))
    st, code = _expand_phase(
        states, stores, heat, max_steps=max_steps,
        smallest_size=smallest_sizes,
        target_cue_threshold=target_cue_threshold,
        target_cue_threshold_decay=target_cue_threshold_decay,
        target_cue_threshold_minimum=target_cue_threshold_minimum,
        skip_threshold=True, commit=ctx_mask)
    return (_select(ctx_mask, st, states), stores,
            torch.where(ctx_mask, code, codes).to(_I32))


def context_push_low(state: PolicyState, chain_store: torch.Tensor,
                     ctx_low: torch.Tensor, ctx_valid, smallest_size,
                     target_cue_threshold, target_cue_threshold_decay,
                     target_cue_threshold_minimum, *, max_steps):
    """context_push_low_batched for one search. Returns (state', store,
    exit_code)."""
    dev = chain_store.device
    st, store, code = context_push_low_batched(
        _batch(state), chain_store[None],
        torch.zeros((1,), dtype=_I32, device=dev), ctx_low[None].to(_F32),
        _bool(ctx_valid, dev), _bool(True, dev), smallest_size,
        target_cue_threshold, target_cue_threshold_decay,
        target_cue_threshold_minimum, max_steps=max_steps)
    return _unbatch(st), chain_store, code[0]


# ---------------------------------------------------------------------------
# Production fused mode: detect-path searches as device steps
# ---------------------------------------------------------------------------

# Rows of the stacked prompt layouts a step chooses between (ONE
# vsm_generate serves all three).
DETECT_ROW, CTXQ_ROW, CTXSEG_ROW = 0, 1, 2


def _pack_exit(codes, states: PolicyState, ans_tok, ans_n) -> torch.Tensor:
    """i32 [B, 7 + max_new]: [code, n_path, ans_n, tail bbox (4), answer
    tokens] of each row — what the host needs after a step, in ONE
    device-to-host read."""
    idx = (states.n_path - 1).clamp_min(0)
    return torch.cat([
        torch.stack([codes, states.n_path, ans_n], dim=1).to(_I32),
        _take(states.p_bbox, idx).to(_I32), ans_tok.to(_I32)], dim=1)


def _square_windows(bboxes: torch.Tensor) -> torch.Tensor:
    """[B, 4] crops -> [B, 4] f32 centred squares (expand2square)."""
    x0, y0, w, h = bboxes.unbind(1)
    side = torch.maximum(w, h)
    return torch.stack([
        x0 - torch.div(side - w, 2, rounding_mode="floor"),
        y0 - torch.div(side - h, 2, rounding_mode="floor"), side, side],
        dim=1).to(_F32)


def fused_search_batched(params, cfg, canvases: torch.Tensor, states,
                         stores: torch.Tensor, codes, text_ids, feat_idx,
                         is_feat, lens, draft_ids, push_pending,
                         smallest_sizes, confidence_high,
                         target_cue_threshold, target_cue_threshold_decay,
                         target_cue_threshold_minimum, *, loc_token_id: int,
                         max_new_tokens: int, eos_id: int, cache_len: int,
                         compute_dtype, spec_chunk: int, max_steps,
                         graphs: DecodeGraphs,
                         reads: Optional[list] = None):
    """B concurrent searches advance together, one device step at a time,
    until no row is RUNNING (or waiting for its context answer): each
    step cuts every engaged row's tower windows from its canvas, runs ONE
    batched vsm_generate (the weight reads shared by the searches) and
    applies the transition per row. Searches are independent, so results
    equal B separate `fused_search` runs.

    Context cues run in the steps: a row whose step goes weak decodes the
    context ANSWER in its next step (its CTXQ layout row) beside the
    other rows' detect steps; the host parses the phrases and calls again
    with the rows' CTXSEG layouts and push_pending.

    canvases [B, Hc, Wc, 3]; states batched PolicyState; stores
    [B, P, Hc, Wc] (updated in place); codes [B] (RUNNING rows advance);
    text_ids / feat_idx / is_feat [3, B, S], lens [3, B] on the device;
    push_pending [B] bool; smallest_sizes [B]. reads: a list that
    receives one entry per host read of an exit record. Returns (states,
    stores, exit_recs [B, 7 + max_new] on the host (numpy), det_logits
    [B, N], det_boxes [B, N, 4]), the det arrays (on the device) from
    each row's LAST detect step."""
    from ..kernels.image_ops import pair_windows
    from ..models.vsm import vsm_generate

    B, Hc, Wc, _ = canvases.shape
    dev = canvases.device
    clip_size = cfg.vision.image_size
    owl_size = cfg.owl_vision.image_size
    n_det = (owl_size // cfg.owl_vision.patch_size) ** 2
    rows = _rows(B, dev)
    # the host's mirror of the loop condition, from the records it reads
    codes_h = torch.as_tensor(codes).cpu().numpy().astype(np.int32)
    answered_h = np.zeros((B,), bool)
    # JAX's while_loop carry
    codes = torch.as_tensor(codes).to(device=dev, dtype=_I32)
    pending = torch.as_tensor(push_pending).to(dev)
    det_l = torch.zeros((B, n_det), dtype=_F32, device=dev)
    det_b = torch.zeros((B, n_det, 4), dtype=_F32, device=dev)
    ans_tok = torch.zeros((B, max_new_tokens), dtype=_I32, device=dev)
    ans_n = torch.zeros((B,), dtype=_I32, device=dev)
    answered = torch.zeros((B,), dtype=torch.bool, device=dev)
    smallest = _as_rows(smallest_sizes, B, dev, _I32)
    recs = None
    while np.any((codes_h == RUNNING)
                 | ((codes_h == NEED_CTX) & ~answered_h)):
        ctx_ans = (codes == NEED_CTX) & ~answered
        running = codes == RUNNING
        push = running & pending
        detect = running & ~pending
        engaged = ctx_ans | running

        bboxes = _tail(states)                               # [B, 4]
        sq = _square_windows(bboxes)
        crops = bboxes.to(_F32)
        clips, owls = [], []
        for b in range(B):
            c, o = pair_windows(canvases[b], sq[b:b + 1], crops[b:b + 1],
                                clip_size, owl_size)
            clips.append(c[0])
            owls.append(o[0])
        row = torch.where(ctx_ans, CTXQ_ROW,
                          torch.where(push, CTXSEG_ROW, DETECT_ROW)).long()
        out = vsm_generate(params, cfg, torch.stack(clips),
                           torch.stack(owls), text_ids[row, rows],
                           feat_idx[row, rows], is_feat[row, rows],
                           lens[row, rows], loc_token_id=loc_token_id,
                           max_new_tokens=max_new_tokens, eos_id=eos_id,
                           cache_len=cache_len, compute_dtype=compute_dtype,
                           draft_ids=draft_ids, spec_chunk=spec_chunk,
                           graphs=graphs)
        heat = torch.where(out.loc_valid[:, None, None],
                           _resize_clip(out.mask_logits, bboxes, Hc, Wc),
                           torch.zeros((), dtype=_F32, device=dev))
        st2, accept, _, _ = _detect_phase(
            states, out.loc_valid, out.det_logits, out.det_boxes,
            confidence_high, apply_sigmoid=True)
        accept = accept & detect
        # the segment call's det outputs must not stash (the step's
        # detect phase already ran before the context event)
        st2 = _select(detect, st2, states)
        st3, code = _expand_phase(
            st2, stores, heat, max_steps=max_steps,
            smallest_size=smallest,
            target_cue_threshold=target_cue_threshold,
            target_cue_threshold_decay=target_cue_threshold_decay,
            target_cue_threshold_minimum=target_cue_threshold_minimum,
            skip_threshold=push, commit=engaged & ~ctx_ans & ~accept)
        new = _select(ctx_ans, states, _select(accept, st2, st3))
        code = torch.where(ctx_ans, NEED_CTX,
                           torch.where(accept, ACCEPT, code)).to(_I32)
        states = _select(engaged, new, states)
        codes = torch.where(engaged, code, codes)
        det_l = torch.where(detect[:, None], out.det_logits.to(_F32), det_l)
        det_b = torch.where(detect[:, None, None], out.det_boxes.to(_F32),
                            det_b)
        ans_tok = torch.where(ctx_ans[:, None], out.tokens.to(_I32),
                              ans_tok)
        ans_n = torch.where(ctx_ans, out.num_generated.to(_I32), ans_n)
        answered = answered | ctx_ans
        pending = pending & ~push
        # ONE read per step: the packed exit records
        recs = _pack_exit(codes, states, ans_tok, ans_n).cpu().numpy()
        if reads is not None:
            reads.append(1)
        answered_h |= (codes_h == NEED_CTX) & ~answered_h
        codes_h = recs[:, 0].copy()
    if recs is None:                    # no row was running
        recs = _pack_exit(codes, states, ans_tok, ans_n).cpu().numpy()
        if reads is not None:
            reads.append(1)
    return states, stores, recs, det_l, det_b


def fused_search(params, cfg, canvas: torch.Tensor, state: PolicyState,
                 chain_store: torch.Tensor, text_ids, feat_idx, is_feat,
                 lens, draft_ids, push_pending, smallest_size,
                 confidence_high, target_cue_threshold,
                 target_cue_threshold_decay, target_cue_threshold_minimum,
                 *, loc_token_id: int, max_new_tokens: int, eos_id: int,
                 cache_len: int, compute_dtype, spec_chunk: int, max_steps,
                 graphs: DecodeGraphs, reads: Optional[list] = None):
    """One search's device steps until an exit (fused_search_batched with
    one row). text_ids / feat_idx / is_feat [3, 1, S], lens [3, 1];
    canvas [Hc, Wc, 3] CLIP-normalized f32. Returns (state', store,
    exit_rec [7 + max_new] (numpy), det_logits [N], det_boxes [N, 4])."""
    dev = canvas.device
    st, store, recs, det_l, det_b = fused_search_batched(
        params, cfg, canvas[None], _batch(state), chain_store[None],
        torch.zeros((1,), dtype=_I32), text_ids, feat_idx, is_feat, lens,
        draft_ids, _bool(push_pending, dev), smallest_size,
        confidence_high, target_cue_threshold, target_cue_threshold_decay,
        target_cue_threshold_minimum, loc_token_id=loc_token_id,
        max_new_tokens=max_new_tokens, eos_id=eos_id, cache_len=cache_len,
        compute_dtype=compute_dtype, spec_chunk=spec_chunk,
        max_steps=max_steps, graphs=graphs, reads=reads)
    return _unbatch(st), store[0], recs[0], det_l[0], det_b[0]


# ---------------------------------------------------------------------------
# Host loop, injected mode: device policy x any VSMClient
# ---------------------------------------------------------------------------

def visual_search_device_policy(client, image, target_object_name: str,
                                smallest_size: int = 224,
                                confidence_high: float = 0.5,
                                confidence_low: float = 0.3,
                                target_cue_threshold: float = 6.0,
                                target_cue_threshold_decay: float = 0.7,
                                target_cue_threshold_minimum: float = 3.0,
                                max_steps: Optional[int] = None,
                                P: int = 32, grow_limit: int = 256,
                                path_out: Optional[list] = None,
                                device="cuda"):
    """`visual_search` with every policy decision (queue, thresholds,
    splits, ancestor scores) made by device transitions; the host only
    relays VSM calls and the context-cue phrase. Same return contract:
    (final_step, path_length, success, all_valid_boxes).

    P is the initial path capacity; when a search outgrows it (and
    max_steps is not the binding cap) the state doubles on the device
    (grow_and_pop) up to grow_limit, so tail behaviour matches the host
    policy's. device: where the policy state lives (the card unless the
    caller asks for the CPU)."""
    from .policy import (PatchRef, context_phrase, context_question,
                         unwrap_patch)

    dev = torch.device(device)
    W, H = image.width, image.height
    Hc, Wc = H, W          # padded heat grid: every patch fits the root
    state = policy_state_init(W, H, P, dev)
    store = chain_store_init(P, Hc, Wc, dev)
    kw = dict(smallest_size=smallest_size,
              target_cue_threshold=target_cue_threshold,
              target_cue_threshold_decay=target_cue_threshold_decay,
              target_cue_threshold_minimum=target_cue_threshold_minimum,
              max_steps=max_steps)

    def pad_heat(h2d, bbox):
        # the client's heatmap is patch-local; the device policy wants it
        # at the patch's canvas window
        out = np.zeros((Hc, Wc), np.float32)
        a = np.asarray(h2d, np.float32)
        x0, y0 = int(bbox[0]), int(bbox[1])
        out[y0:y0 + a.shape[0], x0:x0 + a.shape[1]] = a
        return torch.from_numpy(out).to(dev)

    def read(code, nb):
        # one read for the exit code and the next tail
        v = torch.cat([code.reshape(1), nb.to(_I32)]).tolist()
        return v[0], v[1:]

    cur_bbox = [0, 0, W, H]
    ctx_cues = {}          # path index -> "answer#phrase"
    accept_info = None     # (boxes, logits, bbox) of the accepting call
    n_steps = 0
    P_cur = P
    with torch.no_grad():
        while True:
            pil = unwrap_patch(PatchRef(image, cur_bbox))
            boxes, logits, heat = client.detect(pil, target_object_name)
            boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
            logits = np.asarray(logits, np.float32).reshape(-1)
            det_valid = len(logits) > 0
            if not det_valid:
                boxes = np.zeros((1, 4), np.float32)
                logits = np.zeros((1,), np.float32)
            state, store, code, nb = injected_step(
                state, store, det_valid, torch.from_numpy(logits).to(dev),
                torch.from_numpy(boxes).to(dev), pad_heat(heat, cur_bbox),
                confidence_high=confidence_high, **kw)
            code, nb = read(code, nb)
            n_steps += 1
            if code == ACCEPT:
                accept_info = (boxes, logits, list(cur_bbox))
                break
            if code == NEED_CTX:
                answer = client.vqa(pil, context_question(target_object_name))
                phrase = context_phrase(answer, target_object_name)
                ctx = client.segment(pil, phrase)
                ctx_cues[n_steps - 1] = answer + "#" + phrase
                state, store, code, nb = context_push(
                    state, store, pad_heat(ctx, cur_bbox), **kw)
                code, nb = read(code, nb)
            if code == MAX_STEPS and (max_steps is None
                                      or max_steps > P_cur):
                if P_cur < grow_limit:
                    P_new = min(2 * P_cur, grow_limit)
                    _log_cap(P_cur, P_new)
                    state, store, code, nb = grow_and_pop(
                        state, store, P2=P_new, max_steps=max_steps)
                    P_cur = P_new
                    code, nb = read(code, nb)
                else:
                    _log_cap(P_cur, None)
            if code != RUNNING:
                break
            cur_bbox = [int(v) for v in nb]

    return _finalize(state, code, accept_info, confidence_low, ctx_cues,
                     path_out)


def pack_record(state: PolicyState) -> torch.Tensor:
    """The host-relevant path record as ONE f32 vector (one read); a
    batched state gives [B, 1 + 14 P]."""
    single = state.n_path.dim() == 0
    st = _batch(state) if single else state
    B = st.n_path.shape[0]
    rec = torch.cat([
        st.n_path[:, None].to(_F32),
        st.p_bbox.to(_F32).reshape(B, -1),       # P*4
        st.p_level.to(_F32),                     # P
        st.p_parent.to(_F32),                    # P
        st.p_score.to(_F32),                     # P
        st.p_top_logit.to(_F32),                 # P
        st.p_has_stash.to(_F32),                 # P
        st.p_det_box.reshape(B, -1),             # P*4
    ], dim=1)
    return rec[0] if single else rec


def _unpack_record(flat, P: int):
    flat = np.asarray(flat, np.float32)
    n = int(flat[0])
    o = 1
    out = {"n": n}
    for name, width, dtype in (
            ("p_bbox", 4 * P, None), ("p_level", P, np.int32),
            ("p_parent", P, np.int32), ("p_score", P, None),
            ("p_top_logit", P, None), ("p_has_stash", P, bool),
            ("p_det_box", 4 * P, None)):
        v = flat[o:o + width]
        o += width
        if width == 4 * P:
            v = v.reshape(P, 4)
        if dtype is not None:
            v = np.round(v).astype(dtype) if dtype is np.int32 \
                else v > 0.5
        out[name] = v[:n]
    return out


def _finalize(state, code: int, accept_info, confidence_low: float,
              ctx_cues: dict, path_out: Optional[list]):
    """Read the path record once and apply the host policy's ending
    (policy.py:266-284): success bookkeeping, root multi-instance boxes,
    the low-confidence fallback over the stashed detections.

    state: a PolicyState or an _unpack_record dict. accept_info may be a
    zero-argument callable, so that the [2304]-wide det arrays reach the
    host only when needed (root multi-instance accept)."""
    from .policy import SearchStep

    if isinstance(state, dict):
        rec = state
    else:
        rec = _unpack_record(pack_record(state).cpu().numpy(),
                             state.p_bbox.shape[0])
    n = rec["n"]
    p_bbox = rec["p_bbox"]
    p_stash_logit = rec["p_top_logit"]
    p_has_stash = rec["p_has_stash"]
    p_det_box = rec["p_det_box"]

    steps = []
    for i in range(n):
        steps.append(SearchStep(
            bbox=[int(v) for v in p_bbox[i]],
            scale_level=int(rec["p_level"][i]),
            score=None if i == 0 else float(rec["p_score"][i]),
            parent_index=int(rec["p_parent"][i]),
            context_cue=ctx_cues.get(i)))
        if p_has_stash[i]:
            steps[i].temp_detection_result = (
                float(p_stash_logit[i]), p_det_box[i].copy())
    if path_out is not None:
        path_out[:] = steps

    if code == ACCEPT:
        final_step = steps[-1]
        final_step.detection_result = p_det_box[n - 1].copy()
        all_valid_boxes = None
        if n == 1:
            boxes, logits, bbox = accept_info() if callable(accept_info) \
                else accept_info
            scale = np.asarray([bbox[2], bbox[3], bbox[2], bbox[3]],
                               np.float32)
            valid = boxes[logits > 0.5].reshape(-1, 4) * scale[None]
            valid[:, :2] -= valid[:, 2:] / 2
            all_valid_boxes = valid
        return final_step, n, True, all_valid_boxes

    max_logit = 0.0
    final_step = None
    path_length = 0
    for i in range(n):
        if p_has_stash[i] and float(p_stash_logit[i]) > max_logit:
            max_logit = float(p_stash_logit[i])
            final_step = steps[i]
            path_length = i + 1
    if final_step is not None:
        final_step.detection_result = final_step.temp_detection_result[1]
    return final_step, path_length, max_logit >= confidence_low, None


# ---------------------------------------------------------------------------
# Production engine: whole searches as device steps over a BatchedVSMEngine
# ---------------------------------------------------------------------------

class CompiledVSMSearch:
    """Whole detect-path searches as device steps.

    Wraps a device-preprocess BatchedVSMEngine: its canvas cache feeds
    `fused_search` (window cutting + VSM + policy per step), its static
    caches and captured decode steps (`engine.graphs`) serve the VSM's
    decode, and its batched waves serve the rare over-bucket context
    segment. Patch pixels come from the device canvas (cubic resampling),
    so this is the throughput / latency mode; the host-preprocess engine
    stays the exact-parity default.

    P sizes the device path record and the [P, Hc, Wc] chain store. A
    search that outgrows it GROWS the state on the device (grow_and_pop:
    capacity doubles up to grow_limit) and goes on, as the host policy,
    whose recursion is bounded only by patch size, would. grow_limit=None
    pins the fallback at P. Batched searches that hit the cap rerun
    serially through the growable path (the searches are independent, so
    the results are unchanged).

    last_host_reads: the device-to-host reads of the last search (or
    search_many call): one exit record per step, the decode's flag
    reads, the context and growth transitions' codes and the final path
    record."""

    BATCH_BUCKETS = (1, 2, 4)

    def __init__(self, engine, P: int = 16, batch_buckets=None,
                 grow_limit: Optional[int] = 256):
        if not getattr(engine, "device_preprocess", False):
            raise ValueError("CompiledVSMSearch needs a device_preprocess "
                             "BatchedVSMEngine")
        self.engine = engine
        self.P = P
        self.grow_limit = P if grow_limit is None else max(P, grow_limit)
        if batch_buckets is not None:
            self.BATCH_BUCKETS = tuple(sorted(batch_buckets))
        self.last_host_reads = 0

    def prefetch_canvas(self, image):
        """Delegate to the wrapped engine, so that admission-time canvas
        uploads keep overlapping with host work when a caller finds the
        hook by getattr (eval/batched_bench.py)."""
        self.engine.prefetch_canvas(image)

    def set_canvas_capacity(self, n: int):
        """Delegate (one shared LRU: the searches read canvases through
        engine._canvas too)."""
        self.engine.set_canvas_capacity(n)

    def _question_ids(self, question: str):
        from ..multimodal.tokenizer import tokenize_with_image
        eng = self.engine
        return tokenize_with_image(eng._build_prompt(question),
                                   eng.tokenizer)

    def _prompt_layouts(self, name: str):
        """(detect layout, context-question layout, shared bucket): both
        prompts of a search live in ONE bucket, so a step can choose
        between them at one shape."""
        from ..multimodal.splicing import build_layout
        from .policy import context_question
        eng = self.engine
        det_ids = self._question_ids(
            f"Please locate the {name} in this image.")
        q_ids = self._question_ids(context_question(name))
        n_img = eng.cfg.image_tokens
        bucket = eng._bucket(max(len(det_ids), len(q_ids)) - 1 + n_img)
        return (*(build_layout(ids, bucket, n_long=n_img, n_short=0,
                               image_long=True) for ids in (det_ids, q_ids)),
                bucket)

    def _seg_layout(self, phrase: str, bucket: int):
        """The context segment prompt's layout at the search's shared
        bucket, or None when the phrase overflows it (rare; that event
        falls back to an engine wave)."""
        from ..multimodal.splicing import build_layout
        eng = self.engine
        ids = self._question_ids(
            f"Please locate the {phrase} in this image.")
        if len(ids) - 1 + eng.cfg.image_tokens > bucket:
            return None
        return build_layout(ids, bucket, n_long=eng.cfg.image_tokens,
                            n_short=0, image_long=True)

    def _decode_answer(self, toks) -> str:
        text = self.engine.tokenizer.decode([int(t) for t in toks],
                                            skip_special_tokens=True)
        return text.replace("\n", "").replace("  ", " ").strip()

    def _stacked(self, trips):
        """[3, B, S] layouts (DETECT, CTXQ, CTXSEG; the CTXSEG rows start
        as detect placeholders, rewritten per context event) and [3, B]
        lengths, on the host."""
        def rows(k, name):
            return np.stack([getattr(t[k], name) for t in trips])
        out = {name: np.stack([rows(0, name), rows(1, name), rows(0, name)])
               for name in ("text_ids", "feat_idx", "is_feat")}
        out["lens"] = np.asarray([[t[0].length for t in trips],
                                  [t[1].length for t in trips],
                                  [t[0].length for t in trips]], np.int32)
        return out

    def _upload(self, lay3):
        dev = self.engine.device
        return [torch.from_numpy(np.ascontiguousarray(lay3[k])).to(dev)
                for k in ("text_ids", "feat_idx", "is_feat", "lens")]

    def _fused_kw(self, cache_len, max_steps, reads):
        eng = self.engine
        return dict(loc_token_id=eng.loc_token_id,
                    max_new_tokens=eng.max_new_tokens, eos_id=eng.eos_id,
                    cache_len=cache_len, compute_dtype=eng.compute_dtype,
                    spec_chunk=eng.spec_chunk, max_steps=max_steps,
                    graphs=eng.graphs, reads=reads)

    def _draft(self, B: int):
        eng = self.engine
        if eng._draft_row is None:
            return None
        return torch.from_numpy(np.tile(eng._draft_row[None], (B, 1))).to(
            eng.device)

    def search(self, image, target_object_name: str,
               smallest_size: int = 224, confidence_high: float = 0.5,
               confidence_low: float = 0.3,
               target_cue_threshold: float = 6.0,
               target_cue_threshold_decay: float = 0.7,
               target_cue_threshold_minimum: float = 3.0,
               max_steps: Optional[int] = None,
               path_out: Optional[list] = None):
        """visual_search-compatible: returns (final_step, path_length,
        success, all_valid_boxes)."""
        with torch.inference_mode():
            return self._search(image, target_object_name, smallest_size,
                                confidence_high, confidence_low,
                                target_cue_threshold,
                                target_cue_threshold_decay,
                                target_cue_threshold_minimum, max_steps,
                                path_out)

    def _search(self, image, name, smallest_size, confidence_high,
                confidence_low, target_cue_threshold,
                target_cue_threshold_decay, target_cue_threshold_minimum,
                max_steps, path_out):
        from .engine import _round128
        from .policy import PatchRef, context_phrase

        eng = self.engine
        dev = eng.device
        reads: List[int] = []
        decode_reads = eng.graphs.host_reads
        canvas = eng._canvas(image)
        Hc, Wc = canvas.shape[:2]
        det_lay, q_lay, bucket = self._prompt_layouts(name)
        cache_len = bucket + _round128(eng.max_new_tokens + eng.spec_chunk)
        draft = self._draft(1)
        state = policy_state_init(image.width, image.height, self.P, dev)
        store = chain_store_init(self.P, Hc, Wc, dev)
        lay3 = self._stacked([(det_lay, q_lay)])
        thresholds = (confidence_high, target_cue_threshold,
                      target_cue_threshold_decay,
                      target_cue_threshold_minimum)

        ctx_cues = {}
        P_cur = self.P
        push = False
        while True:
            state, store, rec, det_logits, det_boxes = fused_search(
                eng.params, eng.cfg, canvas, state, store,
                *self._upload(lay3), draft, push, smallest_size,
                *thresholds, **self._fused_kw(cache_len, max_steps, reads))
            code = int(rec[0])
            push = False
            if code == NEED_CTX:
                # the context ANSWER was decoded in the steps; only the
                # noun-chunk parse runs here, then the next call runs the
                # segment, the push and the rest of the search
                idx = int(rec[1]) - 1
                answer = self._decode_answer(rec[7:7 + int(rec[2])])
                phrase = context_phrase(answer, name)
                ctx_cues[idx] = answer + "#" + phrase
                seg = self._seg_layout(phrase, bucket)
                if seg is not None:
                    for k in ("text_ids", "feat_idx", "is_feat"):
                        lay3[k][CTXSEG_ROW, 0] = getattr(seg, k)
                    lay3["lens"][CTXSEG_ROW, 0] = seg.length
                    push = True
                    continue
                # the phrase overflowed the search's bucket: one engine
                # wave serves this event (rare; any phrase length works)
                patch = PatchRef(image, [int(v) for v in rec[3:7]])
                out, _ = eng._run_many(
                    [patch if eng.wants_patch_refs else patch.pil()],
                    [f"Please locate the {phrase} in this image."])
                state, store, code = context_push_low(
                    state, store, out.mask_logits[0].to(dev),
                    bool(out.loc_valid[0]), smallest_size,
                    target_cue_threshold, target_cue_threshold_decay,
                    target_cue_threshold_minimum, max_steps=max_steps)
                code = int(code)
                reads.append(1)
                if code == RUNNING:
                    continue
            if code == MAX_STEPS and (max_steps is None
                                      or max_steps > P_cur):
                if P_cur < self.grow_limit:
                    P_new = min(2 * P_cur, self.grow_limit)
                    _log_cap(P_cur, P_new)
                    state, store, code, _ = grow_and_pop(
                        state, store, P2=P_new, max_steps=max_steps)
                    P_cur = P_new
                    code = int(code)
                    reads.append(1)
                    if code == RUNNING:
                        continue
                else:
                    _log_cap(P_cur, None)
            break

        # ONE read of the whole path record; the [2304]-wide det arrays
        # reach the host only for a root multi-instance accept
        rec = _unpack_record(pack_record(state).cpu().numpy(), P_cur)
        reads.append(1)

        def accept_info():
            logits = 1.0 / (1.0 + np.exp(-det_logits.cpu().numpy()
                                         .astype(np.float32)))
            bbox = [int(v) for v in rec["p_bbox"][rec["n"] - 1]]
            return det_boxes.cpu().numpy().astype(np.float32), logits, bbox

        self.last_host_reads = len(reads) + eng.graphs.host_reads \
            - decode_reads
        _LOG.debug("compiled search: %d host reads", self.last_host_reads)
        return _finalize(rec, code, accept_info, confidence_low, ctx_cues,
                         path_out)

    # -- batched searches -----------------------------------------------

    def _bucket_b(self, n: int) -> int:
        for b in self.BATCH_BUCKETS:
            if n <= b:
                return b
        return self.BATCH_BUCKETS[-1]

    def search_many(self, images, names, smallest_sizes,
                    confidence_high: float = 0.5,
                    confidence_low: float = 0.3,
                    target_cue_threshold: float = 6.0,
                    target_cue_threshold_decay: float = 0.7,
                    target_cue_threshold_minimum: float = 3.0,
                    max_steps: Optional[int] = None, path_outs=None):
        """B searches together, each a whole search on the device, the VSM
        weight reads shared across them (fused_search_batched). The
        searches are independent: the results are per-search `search`'s.
        All images must land in the SAME canvas bucket (the grouped
        dispatcher chunks by bucket); batch sizes pad up to BATCH_BUCKETS
        with a repeated row. Returns a list of visual_search tuples.
        path_outs (the port's addition): a list per search, or None, that
        receives its visited steps."""
        pol = (confidence_high, confidence_low, target_cue_threshold,
               target_cue_threshold_decay, target_cue_threshold_minimum,
               max_steps)
        n = len(images)
        paths = list(path_outs) if path_outs is not None else [None] * n
        top = self.BATCH_BUCKETS[-1]
        if n > top:
            out = []
            for a in range(0, n, top):
                out.extend(self.search_many(
                    images[a:a + top], names[a:a + top],
                    smallest_sizes[a:a + top], *pol,
                    path_outs=paths[a:a + top]))
            return out
        if n == 1:
            return [self.search(
                images[0], names[0], smallest_size=smallest_sizes[0],
                confidence_high=confidence_high,
                confidence_low=confidence_low,
                target_cue_threshold=target_cue_threshold,
                target_cue_threshold_decay=target_cue_threshold_decay,
                target_cue_threshold_minimum=target_cue_threshold_minimum,
                max_steps=max_steps, path_out=paths[0])]
        with torch.inference_mode():
            return self._search_many(images, names, smallest_sizes, *pol,
                                     paths)

    def _search_many(self, images, names, smallest_sizes, confidence_high,
                     confidence_low, target_cue_threshold,
                     target_cue_threshold_decay,
                     target_cue_threshold_minimum, max_steps, paths):
        from ..multimodal.splicing import build_layout
        from .engine import _round128
        from .policy import PatchRef, context_phrase, context_question

        eng = self.engine
        dev = eng.device
        reads: List[int] = []
        decode_reads = eng.graphs.host_reads
        n = len(images)
        B = self._bucket_b(n)
        pad = B - n
        images = list(images) + [images[0]] * pad
        names = list(names) + [names[0]] * pad
        smallest = list(smallest_sizes) + [smallest_sizes[0]] * pad

        canvases = [eng._canvas(im) for im in images]
        shapes = {tuple(c.shape) for c in canvases}
        if len(shapes) != 1:
            raise ValueError(f"search_many needs one canvas bucket, got "
                             f"{shapes}")
        canvases = torch.stack(canvases)
        Hc, Wc = canvases.shape[1:3]

        trips = [self._prompt_layouts(nm) for nm in names]
        bucket = max(t[2] for t in trips)
        if len({t[2] for t in trips}) > 1:  # re-pad to one shared bucket
            def mk(ids):
                return build_layout(ids, bucket,
                                    n_long=eng.cfg.image_tokens,
                                    n_short=0, image_long=True)
            trips = [(mk(self._question_ids(
                          f"Please locate the {nm} in this image.")),
                      mk(self._question_ids(context_question(nm))), bucket)
                     for nm in names]
        cache_len = bucket + _round128(eng.max_new_tokens + eng.spec_chunk)
        draft = self._draft(B)

        states = stack_states([policy_state_init(im.width, im.height,
                                                 self.P, dev)
                               for im in images])
        stores = torch.zeros((B, self.P, Hc, Wc), dtype=_F32, device=dev)
        codes_np = np.zeros((B,), np.int32)
        lay3 = self._stacked(trips)
        smallest_v = torch.tensor(smallest, dtype=_I32, device=dev)
        thresholds = (confidence_high, target_cue_threshold,
                      target_cue_threshold_decay,
                      target_cue_threshold_minimum)

        ctx_cues = [dict() for _ in range(B)]
        pending = np.zeros((B,), bool)
        det_stash = []   # (rows running, det_logits, det_boxes) per call:
        #                  a row's det outputs come from the LAST call it
        #                  was running in
        while True:
            was_running = codes_np == RUNNING
            states, stores, recs, det_l, det_b = fused_search_batched(
                eng.params, eng.cfg, canvases, states, stores,
                torch.from_numpy(codes_np), *self._upload(lay3), draft,
                torch.from_numpy(pending), smallest_v, *thresholds,
                **self._fused_kw(cache_len, max_steps, reads))
            det_stash.append((was_running, det_l, det_b))
            codes_np = recs[:, 0].astype(np.int32).copy()
            pending = np.zeros((B,), bool)
            ctx_rows = np.where(codes_np == NEED_CTX)[0]
            if len(ctx_rows) == 0:
                break
            # the context answers were decoded in the steps; parse each
            # phrase, write the rows' CTXSEG layouts and call once more
            overflow = []
            for i in ctx_rows:
                answer = self._decode_answer(recs[i, 7:7 + int(recs[i, 2])])
                phrase = context_phrase(answer, names[i])
                ctx_cues[i][int(recs[i, 1]) - 1] = answer + "#" + phrase
                seg = self._seg_layout(phrase, bucket)
                if seg is None:
                    overflow.append((i, phrase))
                    continue
                for k in ("text_ids", "feat_idx", "is_feat"):
                    lay3[k][CTXSEG_ROW, i] = getattr(seg, k)
                lay3["lens"][CTXSEG_ROW, i] = seg.length
                pending[i] = True
                codes_np[i] = RUNNING
            if overflow:
                # phrases too long for the shared bucket: one engine wave
                # serves those events (rare; any phrase length works)
                patches = []
                for i, _ in overflow:
                    p = PatchRef(images[i], [int(v) for v in recs[i, 3:7]])
                    patches.append(p if eng.wants_patch_refs else p.pil())
                out, _ = eng._run_many(
                    patches, [f"Please locate the {ph} in this image."
                              for _, ph in overflow])
                rows = [i for i, _ in overflow]
                low = out.mask_logits[:len(rows)].to(dev, _F32)
                ctx_low = torch.zeros((B,) + low.shape[1:], dtype=_F32,
                                      device=dev)
                ctx_low[torch.tensor(rows, device=dev)] = low
                ctx_valid = np.zeros((B,), bool)
                ctx_mask = np.zeros((B,), bool)
                for j, i in enumerate(rows):
                    ctx_valid[i] = bool(out.loc_valid[j])
                    ctx_mask[i] = True
                states, stores, codes_d = context_push_low_batched(
                    states, stores, torch.from_numpy(codes_np).to(dev),
                    ctx_low, torch.from_numpy(ctx_valid).to(dev),
                    torch.from_numpy(ctx_mask).to(dev), smallest_v,
                    target_cue_threshold, target_cue_threshold_decay,
                    target_cue_threshold_minimum, max_steps=max_steps)
                codes_np = codes_d.cpu().numpy().astype(np.int32).copy()
                reads.append(1)
            if not (np.any(codes_np == RUNNING) or np.any(pending)):
                break

        packed = pack_record(states).cpu().numpy()
        reads.append(1)
        results = []
        for b in range(n):
            if (int(codes_np[b]) == MAX_STEPS and self.grow_limit > self.P
                    and (max_steps is None or max_steps > self.P)):
                # the shared batch is sized P; a row that outgrew it
                # reruns through the growable serial path (the searches
                # are independent: the result is what a larger P gives)
                _LOG.info("batched fused search row %d outgrew P=%d; "
                          "re-running serially with growth", b, self.P)
                results.append(self._search(
                    images[b], names[b], smallest[b], confidence_high,
                    confidence_low, target_cue_threshold,
                    target_cue_threshold_decay,
                    target_cue_threshold_minimum, max_steps, paths[b]))
                reads.append(self.last_host_reads)
                continue
            rec = _unpack_record(packed[b], self.P)

            def accept_info(b=b, rec=rec):
                for mask, dl, db in reversed(det_stash):
                    if mask[b]:
                        logits = 1.0 / (1.0 + np.exp(
                            -dl[b].cpu().numpy().astype(np.float32)))
                        bbox = [int(v)
                                for v in rec["p_bbox"][rec["n"] - 1]]
                        return (db[b].cpu().numpy().astype(np.float32),
                                logits, bbox)
                raise AssertionError("accept without a running fused call")

            results.append(_finalize(rec, int(codes_np[b]), accept_info,
                                     confidence_low, ctx_cues[b], paths[b]))
        self.last_host_reads = sum(reads) + eng.graphs.host_reads \
            - decode_reads
        return results


def warmup_compiled(comp: CompiledVSMSearch, canvas_sizes=((512, 512),),
                    batch_buckets=(1, 2, 4), log=print):
    """Run the compiled searches once per (canvas bucket x batch bucket x
    prompt bucket) before live traffic (serve.server --warmup
    --compiled): on the card this captures the decode graphs of every
    shape and warms cuBLAS and the caching allocator, so no live search
    stalls on a capture. The search's shared token bucket (the larger of
    its detect and context-question prompts) keys the layouts and the
    cache length, so each prompt bucket gets a filler object name long
    enough to land in it. Warm searches use smallest_size >= the image
    side, so each ends after ONE step (the root is too small to split:
    queue empty). Context-cue events capture nothing new: the answer
    decode, segment and push run at the same shapes."""
    from PIL import Image

    from .batched import _filler_for_bucket
    from .policy import context_question

    eng = comp.engine

    def _detect_len(name):
        det = comp._question_ids(f"Please locate the {name} in this "
                                 f"image.")
        q = comp._question_ids(context_question(name))
        return max(len(det), len(q)) - 1 + eng.cfg.image_tokens

    names = ["warm object"]
    bks = list(eng.prompt_buckets)
    for lo, hi in zip(bks[:-1], bks[1:]):
        filler = _filler_for_bucket(_detect_len, lo, hi)
        if filler is None:
            if log:
                log(f"[warmup] compiled: no filler name reaches prompt "
                    f"bucket {hi}; that bucket will compile lazily")
        else:
            names.append(filler)

    rng = np.random.RandomState(0)
    for h, w in canvas_sizes:
        imgs = [Image.fromarray(rng.randint(0, 255, (h, w, 3),
                                            dtype=np.uint8))
                for _ in range(max(batch_buckets))]
        # the largest caches first (decode/graphs.py)
        for b in sorted(batch_buckets, reverse=True):
            for name in reversed(names):
                comp.search_many(imgs[:b], [name] * b, [max(h, w)] * b)
            if log:
                log(f"[warmup] compiled search canvas {h}x{w} B={b} "
                    f"({len(names)} prompt buckets) compiled")
