"""Multiple-choice scoring by per-option cross-entropy over a shared
prefix cache (port of vstar_tpu/decode/scorer.py).

The question prefill fills the cache once; each option then runs as one
chunk at q_offsets = prefix length. The JAX scorer relies on every option
reading the same immutable cache. Here the cache is written in place,
and the prefix still survives every option: an option writes only at
positions >= the prefix length of its row and reads only below its
kv_lens, so the next option overwrites the previous one's entries.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..core.config import LlamaConfig
from ..nn.llama import KVCache, embed_tokens, llama_forward, lm_logits


def option_ce(params: Dict, cfg: LlamaConfig, cache: KVCache,
              last_logits: torch.Tensor, option_ids: torch.Tensor,
              option_lens: torch.Tensor,
              compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Mean CE [B] of one option continuation. option_ids [B, O] are
    right-padded (no BOS), option_lens [B] >= 1; the logit predicting
    option token 0 is the prefix's last_logits."""
    B, O = option_ids.shape
    dev = option_ids.device
    h = embed_tokens(params, option_ids, compute_dtype)
    pos = cache.length[:, None] + torch.arange(O, device=dev)[None]
    hidden, _ = llama_forward(params, cfg, h, pos,
                              cache.length + option_lens,
                              q_offsets=cache.length, cache=cache)
    chunk_logits = lm_logits(params, hidden)                # [B, O, V]
    pred = torch.cat([last_logits[:, None], chunk_logits[:, :-1]], dim=1)
    logp = F.log_softmax(pred.float(), dim=-1)
    tok_logp = logp.gather(-1, option_ids.long()[..., None])[..., 0]
    valid = (torch.arange(O, device=dev)[None]
             < option_lens[:, None]).float()
    return -(tok_logp * valid).sum(-1) / option_lens.clamp_min(1)


def score_options(params: Dict, cfg: LlamaConfig, cache: KVCache,
                  last_logits: torch.Tensor, option_ids: torch.Tensor,
                  option_lens: torch.Tensor,
                  compute_dtype=torch.bfloat16
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """option_ids [B, N, O], option_lens [B, N] ->
    (losses [B, N], best option [B])."""
    losses = torch.stack(
        [option_ce(params, cfg, cache, last_logits, option_ids[:, n],
                   option_lens[:, n], compute_dtype)
         for n in range(option_ids.shape[1])], dim=1)
    return losses, losses.argmin(dim=1)
