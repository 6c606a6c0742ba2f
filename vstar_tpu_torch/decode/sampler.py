"""Decoding over the ragged KV cache with per-step hidden capture: greedy
or temperature / top-p sampling (port of vstar_tpu/decode/sampler.py).

The JAX loop is a `lax.while_loop`; here it is a loop of steps over
device state (decode/graphs.py: CUDA graph replays on the card, one host
read of the exit flag per few steps) with the same contract: it stops
when every row is done; a done row keeps its cache length (its K/V
insert at the frontier is harmless because its length does not grow) and
emits the stop id; the tail past each row's generation is padded with
the stop id. `hiddens[i]` is the final-layer hidden state that produced
`tokens[i]`.

Sampling draws from an explicit `torch.Generator`, never from global
state, so a seeded generator replays its tokens.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence

import torch

from ..core.config import LlamaConfig
from ..nn.llama import KVCache, embed_tokens, llama_forward, lm_logits
from .graphs import DecodeGraphs, run_steps, weights_key


def _scalar(v, dev) -> torch.Tensor:
    """A 0-d f32 tensor of a float (a fill on the device: no host copy,
    so it captures into a CUDA graph) or of a 0-d tensor."""
    if isinstance(v, torch.Tensor):
        return v.to(device=dev, dtype=torch.float32)
    return torch.full((), float(v), dtype=torch.float32, device=dev)


def top_p_filter(scaled: torch.Tensor, top_p) -> torch.Tensor:
    """Set every logit outside the smallest top-probability prefix whose
    cumulative mass reaches top_p to -inf (vstar_tpu sample_token's
    filter). scaled: f32 [B, V]; top_p a float or a 0-d tensor."""
    sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = cum - probs < _scalar(top_p, scaled.device)
    inf = torch.full((), float("inf"), device=scaled.device)
    cutoff = torch.where(keep, sorted_logits, inf).amin(dim=-1,
                                                        keepdim=True)
    return torch.where(scaled < cutoff, -inf, scaled)


def sample_token(logits: torch.Tensor, generator: Optional[torch.Generator],
                 temperature=0.0, top_p=None) -> torch.Tensor:
    """Greedy (temperature <= 0) or temperature / top-p sampling, as the
    reference's generate flags (vstar_bench_eval.py:97-100: do_sample when
    temperature > 0). logits [B, V] -> int32 [B].

    temperature / top_p are Python floats (a greedy call is one argmax;
    a float top_p >= 1 skips the filter, which keeps everything) or 0-d
    tensors (the filter always runs, and a tensor temperature <= 0 picks
    the argmax per call), as vstar_tpu's static and traced values."""
    greedy = logits.argmax(dim=-1).to(torch.int32)
    static_temp = isinstance(temperature, (int, float))
    if static_temp and temperature <= 0.0:
        return greedy
    temp = _scalar(temperature, logits.device)
    scaled = logits.float() / temp.clamp_min(1e-6)
    if top_p is not None and not (isinstance(top_p, (int, float))
                                  and top_p >= 1.0):
        scaled = top_p_filter(scaled, top_p)
    # a categorical draw as argmax(p / E), E ~ Exp(1): no host sync, and
    # a filtered token (p = 0) is never drawn
    probs = torch.softmax(scaled, dim=-1)
    noise = torch.empty_like(probs).exponential_(generator=generator)
    sampled = (probs / noise).argmax(dim=-1).to(torch.int32)
    if static_temp:
        return sampled
    return torch.where(temp > 0.0, sampled, greedy)


class DecodeResult(NamedTuple):
    tokens: torch.Tensor         # int32 [B, max_new], stop-padded
    hiddens: torch.Tensor        # [B, max_new, D]
    num_generated: torch.Tensor  # int32 [B], the stop token included
    cache: KVCache
    # decoder forwards after the prefill: one per token after the first
    # (greedy), one per verify chunk (speculative). Acceptance is
    # (sum(num_generated) - B) / (B * n_forwards) proposals a forward.
    n_forwards: int


def isin(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """torch.isin for a few ids, by comparison (no sort, no host sync:
    it captures into a CUDA graph)."""
    return (x[..., None] == ids).any(dim=-1)


def _ctl(running: torch.Tensor, done: torch.Tensor,
         forwards: torch.Tensor) -> torch.Tensor:
    """int32 [2]: [the loop goes on, forwards so far]; running [1]."""
    return torch.cat([(running & ~done.all()).to(torch.int32),
                      forwards.to(torch.int32)])


def _trace_buffers(state: Dict, n: int, B: int, K: int, V: int) -> None:
    """Device buffers for a replay trace: n forwards' logits [n, B, K, V]
    f32 and the generated position each decides first [n, B]."""
    dev = state["ctl"].device
    state["trace_logits"] = torch.zeros((n, B, K, V), dtype=torch.float32,
                                        device=dev)
    state["trace_start"] = torch.zeros((n, B), dtype=torch.int32,
                                       device=dev)


def _trace_put(s: Dict, forward: torch.Tensor, start: torch.Tensor,
               logits: torch.Tensor) -> None:
    """Write a step's logits at its forward index (a step past the end
    writes the unused entry after the last forward)."""
    if "trace_logits" not in s:
        return
    i = forward.clamp(0, s["trace_logits"].shape[0] - 1).long().reshape(1)
    s["trace_logits"].index_copy_(0, i, logits.float()[None])
    s["trace_start"].index_copy_(0, i, start.to(torch.int32)[None])


def _trace_read(out: Dict, n_forwards: int,
                replay_trace: Optional[List]) -> None:
    if replay_trace is not None:
        replay_trace.extend((out["trace_start"][i].clone(),
                             out["trace_logits"][i].clone())
                            for i in range(n_forwards))


# greedy steps per host read of the loop's flag (decode/graphs.py)
STEPS_PER_READ = 4


def greedy_decode(params: Dict, cfg: LlamaConfig, cache: KVCache,
                  first_logits: torch.Tensor, first_hidden: torch.Tensor,
                  max_new_tokens: int, stop_ids: Sequence[int],
                  compute_dtype=torch.bfloat16, temperature=0.0,
                  top_p=None, generator: Optional[torch.Generator] = None,
                  trace: Optional[List] = None,
                  graphs: Optional[DecodeGraphs] = None,
                  steps_per_read: int = STEPS_PER_READ,
                  replay_trace: Optional[List] = None) -> DecodeResult:
    """Decode after a prefill: greedy by default, temperature / top-p
    sampling from `generator` when temperature > 0. first_logits
    [B, vocab] and first_hidden [B, D] are the last prompt position's.

    The loop is `steps_per_read` steps of device state per host read
    (decode/graphs.py): graph replays on a CUDA tensor (`graphs` keeps
    the captures; on CUDA the cache should be one of its static caches,
    or every call captures anew), eager steps on the CPU. A step is
    gated by JAX's loop condition, t < max_new_tokens and not every row
    done, so the steps past the end move nothing.

    trace: when a list, receives (start [B], logits [B, 1, vocab]) for
    the prefill's logits and each forward; start is the generated
    position the logits decide (decode/speculative.py traces the same).
    A traced decode runs its steps eagerly on any device, reading the
    flag before each (the card's reference for the replay).
    replay_trace: when a list, receives the same entries from a decode
    that runs as usual (by replay on the card): each step also writes
    its logits into a device buffer of max_new_tokens entries."""
    B, D = first_hidden.shape
    dev = first_logits.device
    stop = torch.tensor(list(stop_ids), dtype=torch.int32, device=dev)
    tokens = torch.zeros((B, max_new_tokens), dtype=torch.int32, device=dev)
    hiddens = torch.zeros((B, max_new_tokens, D), dtype=first_hidden.dtype,
                          device=dev)
    for tr in (trace, replay_trace):
        if tr is not None:
            tr.append((torch.zeros((B,), dtype=torch.int32, device=dev),
                       first_logits[:, None]))
    tokens[:, 0] = sample_token(first_logits, generator, temperature, top_p)
    hiddens[:, 0] = first_hidden
    done = isin(tokens[:, 0], stop)
    t = torch.ones((1,), dtype=torch.int32, device=dev)
    state = {"t": t, "tokens": tokens, "hiddens": hiddens, "done": done,
             "ngen": torch.ones((B,), dtype=torch.int32, device=dev),
             "length": cache.length.to(torch.int32).clone(),
             "ctl": _ctl(t < max_new_tokens, done, t - 1)}
    # tensor sampling values are state (copied in at every call); float
    # ones are frozen into the capture and so part of its key
    static = []
    for name, v in (("temperature", temperature), ("top_p", top_p)):
        if isinstance(v, torch.Tensor):
            state[name] = v.to(device=dev, dtype=torch.float32).reshape(())
        else:
            static.append((name, v))
    sampling = not (isinstance(temperature, (int, float))
                    and temperature <= 0.0)
    rows = torch.arange(B, device=dev)[:, None]
    if replay_trace is not None:
        _trace_buffers(state, max_new_tokens, B, 1, first_logits.shape[-1])

    def step(s):
        t, done, length = s["t"], s["done"], s["length"]
        live = (t < max_new_tokens) & ~done.all()                  # [1]
        cur = s["tokens"].gather(1, (t - 1).clamp(0, max_new_tokens - 1)
                                 .long().expand(B)[:, None])
        h = embed_tokens(params, cur, compute_dtype)
        hidden, _ = llama_forward(
            params, cfg, h, length[:, None], length + 1, q_offsets=length,
            cache=cache.with_length(length))
        logits = lm_logits(params, hidden)
        if trace is not None:
            trace.append((t.expand(B).clone(), logits))
        _trace_put(s, t - 1, t.expand(B), logits)
        nxt = sample_token(logits[:, 0], generator,
                           s.get("temperature", temperature),
                           s.get("top_p", top_p))
        nxt = torch.where(done, stop[0], nxt)
        col = t.clamp(max=max_new_tokens - 1).long().expand(B)[:, None]
        s["tokens"][rows, col] = torch.where(
            live, nxt[:, None], s["tokens"][rows, col])
        s["hiddens"][rows, col] = torch.where(
            live[:, None], hidden.to(s["hiddens"].dtype),
            s["hiddens"][rows, col])
        frozen = done | ~live
        length.copy_(torch.where(frozen, length, length + 1))
        s["ngen"].copy_(torch.where(frozen, s["ngen"], s["ngen"] + 1))
        done |= live & isin(nxt, stop)
        t += live.to(torch.int32)
        s["ctl"].copy_(_ctl(t < max_new_tokens, done, t - 1))

    key = ("greedy", weights_key(params), cache.k.data_ptr(),
           tuple(cache.k.shape), cache.kv_int8, B, max_new_tokens,
           compute_dtype, first_hidden.dtype, tuple(stop_ids), tuple(static),
           id(generator) if sampling else None, replay_trace is not None)
    out, n_forwards, _ = run_steps(
        graphs, key, state, step, 1 if trace is not None else steps_per_read,
        holds=cache.tensors() + (params,)
        + ((generator,) if sampling else ()),
        generator=generator if sampling else None,
        check_first=trace is not None)
    _trace_read(out, n_forwards, replay_trace)
    ngen = out["ngen"].clone()
    pos = torch.arange(max_new_tokens, device=dev)[None]
    tokens = torch.where(pos < ngen[:, None], out["tokens"], stop[0])
    return DecodeResult(tokens=tokens, hiddens=out["hiddens"].clone(),
                        num_generated=ngen,
                        cache=cache.with_length(out["length"].clone()),
                        n_forwards=n_forwards)


def decode_stats(ngen_rows: Sequence[int], n_forwards: int) -> Dict:
    """{"tokens", "forwards", "tokens_per_forward"} of one decode: the
    proposals accepted per row and forward (greedy 1.0; DecodeResult's
    acceptance formula), as vstar_tpu's VQAEngine records them."""
    tot = sum(ngen_rows)
    b = max(len(ngen_rows), 1)
    return {"tokens": tot, "forwards": n_forwards,
            "tokens_per_forward":
                (tot - b) / max(b * n_forwards, 1) if n_forwards else 1.0}
