"""OWL-ViT detection heads (port of vstar_tpu/nn/owl_heads.py):
query-conditioned cosine class logits with learned per-patch shift/scale,
and a 3-layer GELU box MLP plus a grid box bias, sigmoided to cxcywh."""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.config import OwlHeadConfig
from ..core.params import Init
from .basic import dense, init_dense


def init_owl_head_params(init: Init, cfg: OwlHeadConfig) -> Dict:
    V = cfg.vision_dim
    return {
        "class_head": {
            "dense0": init_dense(init, V, cfg.query_dim),
            "logit_shift": init_dense(init, V, 1),
            "logit_scale": init_dense(init, V, 1),
        },
        "box_head": {
            "dense0": init_dense(init, V, V),
            "dense1": init_dense(init, V, V),
            "dense2": init_dense(init, V, 4),
        },
    }


@functools.lru_cache(maxsize=8)
def _box_bias(num_patches: int) -> np.ndarray:
    """Grid box bias in logit space, [N*N, 4] (host numpy, cached)."""
    coords = (np.stack(
        np.meshgrid(np.arange(1, num_patches + 1, dtype=np.float32),
                    np.arange(1, num_patches + 1, dtype=np.float32)),
        axis=-1) / num_patches)
    coords = np.clip(coords.reshape(-1, 2), 0.0, 1.0)
    coord_bias = np.log(coords + 1e-4) - np.log1p(-coords + 1e-4)
    size = np.full_like(coord_bias, 1.0 / num_patches)
    size_bias = np.log(size + 1e-4) - np.log1p(-size + 1e-4)
    return np.concatenate([coord_bias, size_bias], axis=-1)


def owl_class_logits(params: Dict, image_feats: torch.Tensor,
                     query_embeds: torch.Tensor) -> torch.Tensor:
    """image_feats [B, N, V], query_embeds [B, Q, qdim] -> [B, N, Q]."""
    p = params["class_head"]
    imgf = dense(p["dense0"], image_feats).float()
    qf = query_embeds.float()
    imgf = imgf / (torch.linalg.vector_norm(imgf, dim=-1, keepdim=True)
                   + 1e-6)
    qf = qf / (torch.linalg.vector_norm(qf, dim=-1, keepdim=True) + 1e-6)
    logits = torch.einsum("bnd,bqd->bnq", imgf, qf)
    shift = dense(p["logit_shift"], image_feats).float()
    scale = F.elu(dense(p["logit_scale"], image_feats).float()) + 1.0
    return (logits + shift) * scale


def owl_box_predictions(params: Dict, image_feats: torch.Tensor,
                        grid_size: int) -> torch.Tensor:
    """image_feats [B, N, V] -> boxes cxcywh in [0, 1], [B, N, 4]."""
    p = params["box_head"]
    x = F.gelu(dense(p["dense0"], image_feats))
    x = F.gelu(dense(p["dense1"], x))
    x = dense(p["dense2"], x).float()
    bias = torch.from_numpy(_box_bias(grid_size)).to(x.device)
    return torch.sigmoid(x + bias)


def owl_detect(params: Dict, cfg: OwlHeadConfig, feature_map: torch.Tensor,
               query_embeds: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """feature_map [B, G, G, V], query_embeds [B, Q, qdim] ->
    (pred_logits [B, N, Q], pred_boxes [B, N, 4])."""
    B, G, _, V = feature_map.shape
    image_feats = feature_map.reshape(B, G * G, V)
    return (owl_class_logits(params, image_feats, query_embeds),
            owl_box_predictions(params, image_feats, G))


def owl_head_params_from_torch(sd, prefix: str = "",
                               dtype=torch.float32) -> Dict:
    """Import HF OwlViTForObjectDetection class_head/box_head weights
    (vstar_tpu nn/owl_heads.owl_head_params_from_torch). `prefix` points
    above 'class_head.'/'box_head.' (usually '')."""
    from ..core.hf_import import _lin, _np

    def lin(name):
        return {"w": _lin(sd, prefix + name + ".weight").to(dtype),
                "b": _np(sd[prefix + name + ".bias"]).to(dtype)}

    return {
        "class_head": {
            "dense0": lin("class_head.dense0"),
            "logit_shift": lin("class_head.logit_shift"),
            "logit_scale": lin("class_head.logit_scale"),
        },
        "box_head": {
            "dense0": lin("box_head.dense0"),
            "dense1": lin("box_head.dense1"),
            "dense2": lin("box_head.dense2"),
        },
    }
