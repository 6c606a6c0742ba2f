"""Decoding over the ragged KV cache with per-step hidden capture: greedy
or temperature / top-p sampling (port of vstar_tpu/decode/sampler.py).

The JAX loop is a `lax.while_loop`; here it is a host loop with the same
contract and one host sync per step (the loop's exit test): it stops
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


def top_p_filter(scaled: torch.Tensor, top_p) -> torch.Tensor:
    """Set every logit outside the smallest top-probability prefix whose
    cumulative mass reaches top_p to -inf (vstar_tpu sample_token's
    filter). scaled: f32 [B, V]; top_p a float or a 0-d tensor."""
    sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = cum - probs < torch.as_tensor(top_p, dtype=torch.float32,
                                         device=scaled.device)
    inf = torch.tensor(float("inf"), device=scaled.device)
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
    temp = torch.as_tensor(temperature, dtype=torch.float32,
                           device=logits.device)
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


def greedy_decode(params: Dict, cfg: LlamaConfig, cache: KVCache,
                  first_logits: torch.Tensor, first_hidden: torch.Tensor,
                  max_new_tokens: int, stop_ids: Sequence[int],
                  compute_dtype=torch.bfloat16, temperature=0.0,
                  top_p=None, generator: Optional[torch.Generator] = None,
                  trace: Optional[List] = None) -> DecodeResult:
    """Decode after a prefill: greedy by default, temperature / top-p
    sampling from `generator` when temperature > 0. first_logits
    [B, vocab] and first_hidden [B, D] are the last prompt position's.

    trace: when a list, receives (start [B], logits [B, 1, vocab]) for
    the prefill's logits and each forward; start is the generated
    position the logits decide (decode/speculative.py traces the same)."""
    B, D = first_hidden.shape
    dev = first_logits.device
    stop = torch.tensor(list(stop_ids), dtype=torch.int32, device=dev)
    tokens = torch.zeros((B, max_new_tokens), dtype=torch.int32, device=dev)
    hiddens = torch.zeros((B, max_new_tokens, D), dtype=first_hidden.dtype,
                          device=dev)
    if trace is not None:
        trace.append((torch.zeros((B,), dtype=torch.int32, device=dev),
                      first_logits[:, None]))
    tokens[:, 0] = sample_token(first_logits, generator, temperature, top_p)
    hiddens[:, 0] = first_hidden
    done = torch.isin(tokens[:, 0], stop)
    ngen = torch.ones((B,), dtype=torch.int32, device=dev)

    t = 1
    while t < max_new_tokens and not bool(done.all()):
        h = embed_tokens(params, tokens[:, t - 1:t], compute_dtype)
        new_lens = torch.where(done, cache.length, cache.length + 1)
        hidden, cache = llama_forward(
            params, cfg, h, cache.length[:, None], cache.length + 1,
            q_offsets=cache.length, cache=cache)
        cache = KVCache(k=cache.k, v=cache.v, length=new_lens)
        logits = lm_logits(params, hidden)
        if trace is not None:
            trace.append((torch.full((B,), t, dtype=torch.int32,
                                     device=dev), logits))
        nxt = sample_token(logits[:, 0], generator, temperature, top_p)
        nxt = torch.where(done, stop[0], nxt)
        tokens[:, t] = nxt
        hiddens[:, t] = hidden[:, 0].to(hiddens.dtype)
        ngen = torch.where(done, ngen, ngen + 1)
        done = done | torch.isin(nxt, stop)
        t += 1
    pos = torch.arange(max_new_tokens, device=dev)[None]
    tokens = torch.where(pos < ngen[:, None], tokens, stop[0])
    return DecodeResult(tokens=tokens, hiddens=hiddens, num_generated=ngen,
                        cache=cache, n_forwards=t - 1)


def decode_stats(ngen_rows: Sequence[int], n_forwards: int) -> Dict:
    """{"tokens", "forwards", "tokens_per_forward"} of one decode: the
    proposals accepted per row and forward (greedy 1.0; DecodeResult's
    acceptance formula), as vstar_tpu's VQAEngine records them."""
    tot = sum(ngen_rows)
    b = max(len(ngen_rows), 1)
    return {"tokens": tot, "forwards": n_forwards,
            "tokens_per_forward":
                (tot - b) / max(b * n_forwards, 1) if n_forwards else 1.0}
