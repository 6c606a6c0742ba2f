"""Vision->LM projectors: linear / mlpNx_gelu / perceiver / identity
(port of vstar_tpu/nn/projectors.py)."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..core.config import ProjectorConfig
from ..core.params import Init
from .basic import dense, init_dense
from .perceiver import init_perceiver_params, perceiver_resample


def init_projector_params(init: Init, cfg: ProjectorConfig) -> Dict:
    if cfg.type == "linear":
        return {"proj": init_dense(init, cfg.in_dim, cfg.out_dim)}
    if cfg.type.startswith("mlp"):
        p = {"fc0": init_dense(init, cfg.in_dim, cfg.out_dim)}
        for i in range(1, cfg.mlp_depth):
            p[f"fc{i}"] = init_dense(init, cfg.out_dim, cfg.out_dim)
        return p
    if cfg.type == "perceiver":
        return {"perceiver": init_perceiver_params(init, cfg.perceiver,
                                                   cfg.out_dim)}
    if cfg.type == "identity":
        return {}
    raise ValueError(f"unknown projector type {cfg.type}")


def apply_projector(params: Dict, cfg: ProjectorConfig,
                    feats: torch.Tensor) -> torch.Tensor:
    """feats: [B, N, in_dim] -> [B, N or num_latents, out_dim]."""
    if cfg.type == "linear":
        return dense(params["proj"], feats)
    if cfg.type.startswith("mlp"):
        x = dense(params["fc0"], feats)
        i = 1
        while f"fc{i}" in params:
            x = dense(params[f"fc{i}"], F.gelu(x))
            i += 1
        return x
    if cfg.type == "perceiver":
        return perceiver_resample(params["perceiver"], cfg.perceiver, feats)
    if cfg.type == "identity":
        return feats
    raise ValueError(f"unknown projector type {cfg.type}")
