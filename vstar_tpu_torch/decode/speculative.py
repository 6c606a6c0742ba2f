"""Greedy-equivalent speculative decoding: template drafts and
prompt-lookup drafts (port of vstar_tpu/decode/speculative.py).

Each iteration feeds the last emitted token plus K-1 draft tokens at the
cache frontier (per-row q_offsets) as one K-row forward, takes the argmax
at every position and accepts the longest prefix where the draft
matched. Every emitted token is the one greedy decoding would emit (the
first mismatching position still yields one valid token), so the output
is greedy_decode's for ANY draft; a good draft takes fewer forwards.

  * `speculative_decode`: a static per-row draft, given at dispatch (the
    VSM's "Sure, [LOC]." and the VQA trigger sentence).
  * `lookup_decode`: prompt-lookup drafts, retrieved each chunk from a
    buffer of the prompt's text tokens and everything generated so far.

The JAX loop is a `lax.while_loop`; here it is a loop of verify chunks
over device state (decode/graphs.py: CUDA graph replays on the card,
one host read of the exit flag per chunk by default). Scatters that JAX
writes with mode="drop" go into buffers K columns wider than any
selected position, and unselected positions keep their value, so no
index is ever clamped or out of range.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..core.config import LlamaConfig
from ..nn.llama import KVCache, embed_tokens, llama_forward, lm_logits
from .graphs import DecodeGraphs, run_steps, weights_key
from .sampler import (DecodeResult, _ctl, _trace_buffers, _trace_put,
                      _trace_read, isin)

# verify chunks per host read of the loop's flag (decode/graphs.py): a
# chunk past the end costs a whole chunk's forward
STEPS_PER_READ = 1


def _masked_put(buf: torch.Tensor, pos: torch.Tensor, sel: torch.Tensor,
                vals: torch.Tensor) -> None:
    """buf[b, pos[b, i]] = vals[b, i] where sel[b, i], in place; the other
    positions keep their value. buf [B, W, ...]; pos, sel [B, K]; vals
    [B, K, ...]; every pos < W."""
    idx = pos.long()
    if buf.dim() == 3:
        idx = idx[:, :, None].expand(-1, -1, buf.shape[2])
        sel = sel[:, :, None]
    old = buf.gather(1, idx)
    buf.scatter_(1, idx, torch.where(sel, vals.to(buf.dtype), old))


def _spec_loop(params: Dict, cfg: LlamaConfig, cache: KVCache,
               first_logits: torch.Tensor, first_hidden: torch.Tensor,
               max_new_tokens: int, stop_ids: Sequence[int], chunk: int,
               compute_dtype, draft_fn: Callable,
               aux_update: Optional[Callable], aux: Dict, key: Tuple,
               trace: Optional[List] = None,
               graphs: Optional[DecodeGraphs] = None,
               steps_per_read: int = STEPS_PER_READ,
               replay_trace: Optional[List] = None) -> DecodeResult:
    """The shared draft-and-verify loop.

    draft_fn(s, ngen, feed) -> [B, chunk-1] lookahead proposals, s the
    loop state (the tensors of `aux` among it). aux_update(s, g, emit)
    runs after each verify (and once, before the loop, for the first
    token): g is the [B, chunk] verified greedy tokens, emit how many of
    them each row emitted this iteration (0 for frozen rows). aux: the
    drafts' own state tensors (copied into the loop state); key: what
    else the capture of draft_fn and aux_update froze.

    One verify chunk is one step of device state (decode/graphs.py),
    gated by JAX's loop condition (not every row done, and some row
    below max_new_tokens), with the forward count on the device;
    `steps_per_read` chunks per host read.

    CACHE CAPACITY: every iteration writes `chunk` KV entries at the
    frontier even when fewer are accepted, so the cache must hold at
    least prompt_len + max_new_tokens + chunk - 2 entries; callers add
    spec_chunk before rounding (with less, nn/llama's insert clamps the
    last writes onto valid entries: silent corruption, not an error).

    trace: when a list, receives (start [B], logits [B, chunk, vocab])
    per forward (and the prefill's logits at start 0): logits[:, i]
    decides generated position start + i of each row. A traced decode
    runs eagerly, reading the flag before each chunk. replay_trace: the
    same entries from a decode that runs as usual (greedy_decode's)."""
    B, D = first_hidden.shape
    K = chunk
    dev = first_logits.device
    stop = torch.tensor(list(stop_ids), dtype=torch.int32, device=dev)
    width = torch.arange(K, device=dev)[None]

    # K columns of room: positions ngen + i (i < K) never leave the buffer
    tokens = torch.zeros((B, max_new_tokens + K), dtype=torch.int32,
                         device=dev)
    hiddens = torch.zeros((B, max_new_tokens + K, D),
                          dtype=first_hidden.dtype, device=dev)
    for tr in (trace, replay_trace):
        if tr is not None:
            tr.append((torch.zeros((B,), dtype=torch.int32, device=dev),
                       first_logits[:, None]))
    tok0 = first_logits.argmax(dim=-1).to(torch.int32)
    tokens[:, 0] = tok0
    hiddens[:, 0] = first_hidden
    done = isin(tok0, stop)
    ngen = torch.ones((B,), dtype=torch.int32, device=dev)
    state = {"tokens": tokens, "hiddens": hiddens, "done": done,
             "ngen": ngen, "feed": tok0.clone(),
             "nfwd": torch.zeros((1,), dtype=torch.int32, device=dev),
             "length": cache.length.to(torch.int32).clone(), **aux}
    if aux_update is not None:
        g0 = torch.zeros((B, K), dtype=torch.int32, device=dev)
        g0[:, 0] = tok0
        aux_update(state, g0, torch.ones((B,), dtype=torch.int32,
                                         device=dev))

    def running(s):
        return (s["ngen"] < max_new_tokens).any().reshape(1)

    state["ctl"] = _ctl(running(state), done, state["nfwd"])
    if replay_trace is not None:
        _trace_buffers(state, max_new_tokens, B, K, first_logits.shape[-1])

    def step(s):
        done, ngen, feed, length = s["done"], s["ngen"], s["feed"], \
            s["length"]
        live = running(s) & ~done.all()                          # [1]
        lookahead = draft_fn(s, ngen, feed)                      # [B, K-1]
        chunk_ids = torch.cat([feed[:, None], lookahead.to(torch.int32)],
                              dim=1)
        h = embed_tokens(params, chunk_ids, compute_dtype)
        hidden, _ = llama_forward(
            params, cfg, h, length[:, None] + width, length + K,
            q_offsets=length,
            cache=KVCache(k=cache.k, v=cache.v, length=length))
        logits = lm_logits(params, hidden)                   # [B, K, V]
        if trace is not None:
            trace.append((ngen.clone(), logits))
        _trace_put(s, s["nfwd"], ngen, logits)
        g = logits.argmax(dim=-1).to(torch.int32)            # [B, K]

        # m = length of the leading run of lookahead[i] == g[i]
        matches = lookahead == g[:, :K - 1]
        m = matches.to(torch.int32).cumprod(dim=1).sum(dim=1)
        emit = m + 1
        # truncate at the first stop token among g[:emit]
        is_stop = isin(g, stop) & (width < emit[:, None])
        any_stop = is_stop.any(dim=1)
        first_stop = is_stop.to(torch.uint8).argmax(dim=1).to(torch.int32)
        emit = torch.where(any_stop, first_stop + 1, emit)
        # clamp to the budget, freeze finished rows (and every row of a
        # step past the loop's end)
        emit = torch.minimum(emit, max_new_tokens - ngen)
        frozen = done | ~live
        emit = torch.where(frozen, torch.zeros_like(emit), emit)

        sel = width < emit[:, None]
        at = ngen[:, None] + width
        _masked_put(s["tokens"], at, sel, g)
        _masked_put(s["hiddens"], at, sel, hidden)

        # the cache keeps the feed and the matched drafts: emit entries,
        # less the one that would hold the (unconsumed) next feed token
        consumed = torch.where(frozen, torch.zeros_like(emit),
                               torch.minimum(emit, m + 1))
        length += consumed

        last = (emit - 1).clamp(0, K - 1).long()
        feed.copy_(torch.where(emit > 0, g.gather(1, last[:, None])[:, 0],
                               feed))
        stopped = (is_stop & sel).any(dim=1)
        done |= live & (stopped | (ngen + emit >= max_new_tokens))
        if aux_update is not None:
            aux_update(s, g, emit)
        ngen += emit
        s["nfwd"] += live.to(torch.int32)
        s["ctl"].copy_(_ctl(running(s), done, s["nfwd"]))

    key = ("verify", weights_key(params), cache.k.data_ptr(),
           tuple(cache.k.shape), B, K, max_new_tokens, compute_dtype,
           first_hidden.dtype, tuple(stop_ids),
           replay_trace is not None) + key
    out, nfwd, _ = run_steps(
        graphs, key, state, step, 1 if trace is not None else steps_per_read,
        holds=(cache.k, cache.v, params), check_first=trace is not None)
    _trace_read(out, nfwd, replay_trace)
    ngen = out["ngen"].clone()
    pos = torch.arange(max_new_tokens, device=dev)[None]
    tokens = torch.where(pos < ngen[:, None],
                         out["tokens"][:, :max_new_tokens], stop[0])
    return DecodeResult(tokens=tokens,
                        hiddens=out["hiddens"][:, :max_new_tokens].clone(),
                        num_generated=ngen,
                        cache=KVCache(k=cache.k, v=cache.v,
                                      length=out["length"].clone()),
                        n_forwards=nfwd)


def speculative_decode(params: Dict, cfg: LlamaConfig, cache: KVCache,
                       first_logits: torch.Tensor, first_hidden: torch.Tensor,
                       draft: torch.Tensor, max_new_tokens: int,
                       stop_ids: Sequence[int], chunk: int = 8,
                       compute_dtype=torch.bfloat16,
                       trace: Optional[List] = None,
                       graphs: Optional[DecodeGraphs] = None,
                       steps_per_read: int = STEPS_PER_READ,
                       replay_trace: Optional[List] = None
                       ) -> DecodeResult:
    """Greedy-equivalent decode with a STATIC per-row draft.

    draft: int [B, max_new_tokens + chunk] proposed continuations,
    UNSHIFTED: draft[b, i] proposes generated token i (draft[:, 0] lines
    up with the first token, which comes from first_logits and is never
    read). Pad arbitrarily: padding only means rejections. The chunk
    verified at ngen reads draft[ngen : ngen + chunk - 1]; ngen never
    passes max_new_tokens, so any width from max_new_tokens + chunk - 1
    reads inside the row (JAX's dynamic_slice would clamp a narrower
    row; this one is refused)."""
    K = chunk
    if draft.shape[1] < max_new_tokens + K - 1:
        raise ValueError(
            f"draft is {draft.shape[1]} wide; speculative_decode reads up "
            f"to max_new_tokens + chunk - 1 = {max_new_tokens + K - 1}")
    draft = draft.to(device=first_logits.device, dtype=torch.int32)
    offs = torch.arange(K - 1, device=draft.device)[None]

    def draft_fn(s, ngen, feed):
        return s["draft"].gather(1, (ngen[:, None] + offs).long())

    return _spec_loop(params, cfg, cache, first_logits, first_hidden,
                      max_new_tokens, stop_ids, K, compute_dtype, draft_fn,
                      None, {"draft": draft}, ("template", draft.shape[1]),
                      trace, graphs, steps_per_read, replay_trace)


def lookup_decode(params: Dict, cfg: LlamaConfig, cache: KVCache,
                  first_logits: torch.Tensor, first_hidden: torch.Tensor,
                  ctx_ids: torch.Tensor, ctx_len: torch.Tensor,
                  max_new_tokens: int, stop_ids: Sequence[int],
                  chunk: int = 8, compute_dtype=torch.bfloat16,
                  trace: Optional[List] = None,
                  graphs: Optional[DecodeGraphs] = None,
                  steps_per_read: int = STEPS_PER_READ,
                  replay_trace: Optional[List] = None) -> DecodeResult:
    """Greedy-equivalent decode with PROMPT-LOOKUP drafts.

    Each chunk, a row's draft comes from a buffer holding
    ctx_ids[:ctx_len] (the prompt's text tokens; non-text slots masked to
    -1 never match) followed by every token generated so far: the
    EARLIEST position whose trailing trigram, else bigram, else unigram
    equals the row's last tokens, and the K-1 tokens that followed it. A
    miss proposes -1 (rejected; greedy pace). Self-matches against the
    growing tail are excluded (j < len - 1).

    ctx_ids int [B, C]; ctx_len int [B]. The buffer is C + max_new + K
    wide, so the K-1 tokens after any match (j < len - 1 <= C + max_new
    - 1) lie inside it."""
    B, C = ctx_ids.shape
    K = chunk
    dev = first_logits.device
    W = C + max_new_tokens + K
    buf = torch.full((B, W), -1, dtype=torch.int32, device=dev)
    buf[:, :C] = ctx_ids.to(device=dev, dtype=torch.int32)
    blen = ctx_len.to(device=dev, dtype=torch.int32).clone()
    j = torch.arange(W, device=dev)[None]
    offs = torch.arange(K - 1, device=dev)[None]
    width = torch.arange(K, device=dev)[None]
    fill = torch.full((B, 1), -1, dtype=torch.int32, device=dev)

    def draft_fn(s, ngen, feed):
        buf, blen = s["buf"], s["blen"]

        def at(i):
            return buf.gather(1, i.clamp(0, W - 1).long()[:, None])

        bl = blen[:, None]
        # buf shifted right by one and two: s1[j] = buf[j - 1] for j >= 1
        # and s2[j] = buf[j - 2] for j >= 2, the only positions m2 and m3
        # select
        s1 = torch.cat([fill, buf[:, :-1]], dim=1)
        s2 = torch.cat([fill, fill, buf[:, :-2]], dim=1)
        m1 = (j < bl - 1) & (buf == feed[:, None]) & (j >= 1)
        m2 = m1 & (s1 == at(blen - 2)) & (bl >= 2)
        m3 = m2 & (j >= 2) & (s2 == at(blen - 3)) & (bl >= 3)

        def earliest(mask):
            return torch.where(mask, j, W).amin(dim=1)

        j3, j2, j1 = earliest(m3), earliest(m2), earliest(m1)
        best = torch.where(j3 < W, j3, torch.where(j2 < W, j2, j1))
        hit = best < W
        start = torch.where(hit, best + 1, torch.zeros_like(best))
        cont = buf.gather(1, (start[:, None] + offs).long())
        return torch.where(hit[:, None], cont, -1)

    def aux_update(s, g, emit):
        _masked_put(s["buf"], s["blen"][:, None] + width,
                    width < emit[:, None], g)
        s["blen"] += emit

    return _spec_loop(params, cfg, cache, first_logits, first_hidden,
                      max_new_tokens, stop_ids, K, compute_dtype, draft_fn,
                      aux_update, {"buf": buf, "blen": blen}, ("lookup", C),
                      trace, graphs, steps_per_read, replay_trace)
