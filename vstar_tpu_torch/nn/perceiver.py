"""Flamingo-style perceiver resampler, the 32-token "short" projector
(port of vstar_tpu/nn/perceiver.py): learned latents cross-attend to the
CLIP patch tokens (keys/values are media and latents), then layernorm and
a linear lift into the LM embedding space. Single image per row."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..core.config import PerceiverConfig
from ..core.params import Init, dense_init, layer
from .basic import dense, init_dense, init_layernorm, layernorm


def init_perceiver_params(init: Init, cfg: PerceiverConfig,
                          out_dim: int) -> Dict:
    D, L = cfg.dim, cfg.depth
    inner = cfg.dim_head * cfg.heads
    ff_inner = D * cfg.ff_mult
    return {
        "pre_ln": init_layernorm(init, D),
        "latents": init.normal((cfg.num_latents, D)),
        "media_pos_emb": init.normal((cfg.num_media_embeds, 1, D)),
        "layers": {
            "norm_media": init_layernorm(init, D, (L,)),
            "norm_latents": init_layernorm(init, D, (L,)),
            "to_q": {"w": dense_init(init, D, inner, (L,))},
            "to_kv": {"w": dense_init(init, D, 2 * inner, (L,))},
            "to_out": {"w": dense_init(init, inner, D, (L,))},
            "ff_norm": init_layernorm(init, D, (L,)),
            "ff_in": {"w": dense_init(init, D, ff_inner, (L,))},
            "ff_out": {"w": dense_init(init, ff_inner, D, (L,))},
        },
        "final_norm": init_layernorm(init, D),
        "out_proj": init_dense(init, D, out_dim),
    }


def _perceiver_attention(lp: Dict, cfg: PerceiverConfig,
                         media: torch.Tensor,
                         latents: torch.Tensor) -> torch.Tensor:
    x = layernorm(lp["norm_media"], media)
    lat = layernorm(lp["norm_latents"], latents)
    B, N, _ = x.shape
    L = lat.shape[1]
    H, Dh = cfg.heads, cfg.dim_head
    q = dense(lp["to_q"], lat).reshape(B, L, H, Dh)
    kv = dense(lp["to_kv"], torch.cat([x, lat], dim=1))
    k, v = kv.chunk(2, dim=-1)
    k = k.reshape(B, N + L, H, Dh)
    v = v.reshape(B, N + L, H, Dh)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float() * Dh ** -0.5,
                          k.float())
    logits = logits - logits.amax(dim=-1, keepdim=True)
    probs = torch.softmax(logits, dim=-1).to(media.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, L, H * Dh)
    return dense(lp["to_out"], out)


def perceiver_resample(params: Dict, cfg: PerceiverConfig,
                       media: torch.Tensor) -> torch.Tensor:
    """media: [B, N, dim] -> [B, num_latents, out_dim]."""
    x = layernorm(params["pre_ln"], media)
    x = x + params["media_pos_emb"][0].to(x.dtype)[None]
    lat = params["latents"].to(x.dtype)[None].expand(
        x.shape[0], cfg.num_latents, cfg.dim)
    for i in range(cfg.depth):
        lp = layer(params["layers"], i)
        lat = lat + _perceiver_attention(lp, cfg, x, lat)
        h = layernorm(lp["ff_norm"], lat)
        lat = lat + dense(lp["ff_out"], F.gelu(dense(lp["ff_in"], h)))
    lat = layernorm(params["final_norm"], lat)
    return dense(params["out_proj"], lat)
