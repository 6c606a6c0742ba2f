"""Greedy decoding over the ragged KV cache with per-step hidden capture
(port of vstar_tpu/decode/sampler.py).

The JAX loop is a `lax.while_loop`; here it is a host loop with the same
contract: it stops when every row is done; a done row keeps its cache
length (its K/V insert at the frontier is harmless because its length
does not grow) and emits the stop id; the tail past each row's
generation is padded with the stop id. `hiddens[i]` is the final-layer
hidden state that produced `tokens[i]`.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence

import torch

from ..core.config import LlamaConfig
from ..nn.llama import KVCache, embed_tokens, llama_forward, lm_logits


class DecodeResult(NamedTuple):
    tokens: torch.Tensor         # int32 [B, max_new], stop-padded
    hiddens: torch.Tensor        # [B, max_new, D]
    num_generated: torch.Tensor  # int32 [B], the stop token included
    cache: KVCache
    n_forwards: int              # decoder forwards after the prefill


def greedy_decode(params: Dict, cfg: LlamaConfig, cache: KVCache,
                  first_logits: torch.Tensor, first_hidden: torch.Tensor,
                  max_new_tokens: int, stop_ids: Sequence[int],
                  compute_dtype=torch.bfloat16) -> DecodeResult:
    """Greedy decode after a prefill. first_logits [B, vocab] and
    first_hidden [B, D] are the last prompt position's."""
    B, D = first_hidden.shape
    dev = first_logits.device
    stop = torch.tensor(list(stop_ids), dtype=torch.int32, device=dev)
    tokens = torch.zeros((B, max_new_tokens), dtype=torch.int32, device=dev)
    hiddens = torch.zeros((B, max_new_tokens, D), dtype=first_hidden.dtype,
                          device=dev)
    tokens[:, 0] = first_logits.argmax(dim=-1).to(torch.int32)
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
        nxt = lm_logits(params, hidden)[:, 0].argmax(dim=-1).to(torch.int32)
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
