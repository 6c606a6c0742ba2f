"""CLIP-style pre-LN vision transformer (port of vstar_tpu/nn/vit.py).

One implementation serves both towers:
  * CLIP ViT-L/14 @224, the VQA/VSM tower: penultimate layer, CLS dropped
    (`clip_patch_features`);
  * OWL-ViT B/16 @768, the VSM detection tower: last layer + post-LN,
    merged CLS (`owlvit_feature_map`).

Inputs are NHWC, already normalized. Dense layers take the raw {w, b}
entries or the int8 {q, s, b} entries of nn/quant.quantize_vit_params. Sequences of 512 tokens or more
(the OWL tower's 2305) take the tower attention kernel K2; CLIP's 257
tokens stay plain PyTorch, as they stay plain XLA in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..core.config import ViTConfig
from ..core.params import Init, dense_init, layer
from ..kernels.tower_attention import tower_attention
from .basic import ACTIVATIONS, dense, init_dense, init_layernorm, layernorm

TOWER_KERNEL_MIN_SEQ = 512


def init_vit_params(init: Init, cfg: ViTConfig) -> Dict:
    D, L = cfg.hidden_size, cfg.num_layers
    patch_dim = cfg.patch_size * cfg.patch_size * 3
    params = {
        "patch_embed": {"w": dense_init(init, patch_dim, D)},
        "position_embedding": init.normal((cfg.seq_len, D), 0.02),
        "layers": {
            "ln1": init_layernorm(init, D, (L,)),
            "ln2": init_layernorm(init, D, (L,)),
            "attn": {name: init_dense(init, D, D, True, (L,))
                     for name in ("wq", "wk", "wv", "wo")},
            "mlp": {
                "fc1": init_dense(init, D, cfg.intermediate_size, True, (L,)),
                "fc2": init_dense(init, cfg.intermediate_size, D, True, (L,)),
            },
        },
        "pre_ln": init_layernorm(init, D),
        "post_ln": init_layernorm(init, D),
    }
    if cfg.use_class_embedding:
        params["class_embedding"] = init.normal((D,), 0.02)
    return params


def patchify(pixel_values: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, N, patch*patch*C] in (ph, pw, c) raster order."""
    B, H, W, C = pixel_values.shape
    gh, gw = H // patch, W // patch
    x = pixel_values.reshape(B, gh, patch, gw, patch, C)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, gh * gw, patch * patch * C)


def _plain_attention(q, k, v):
    """Softmax attention for short towers (CLIP @224: 257 tokens)."""
    Dh = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float() * Dh ** -0.5,
                          k.float())
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    B, S, H, _ = q.shape
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, S, H * Dh)


def _vit_attention(p: Dict, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    B, S, D = x.shape
    Dh = D // num_heads
    q = dense(p["wq"], x).reshape(B, S, num_heads, Dh)
    k = dense(p["wk"], x).reshape(B, S, num_heads, Dh)
    v = dense(p["wv"], x).reshape(B, S, num_heads, Dh)
    if S >= TOWER_KERNEL_MIN_SEQ:
        out = tower_attention(q, k, v).reshape(B, S, D)
    else:
        out = _plain_attention(q, k, v)
    return dense(p["wo"], out)


def vit_forward(params: Dict, cfg: ViTConfig, pixel_values: torch.Tensor,
                feature_layer: Optional[int] = None,
                apply_post_ln: bool = False) -> torch.Tensor:
    """Encode NHWC images to [B, seq, D] token features (CLS first).
    feature_layer: -1 last layer, -2 penultimate; later layers are
    skipped. apply_post_ln: the OWL-ViT path's final layernorm."""
    fl = cfg.feature_layer if feature_layer is None else feature_layer
    n_used = cfg.num_layers + 1 + fl if fl < 0 else fl + 1
    if not 1 <= n_used <= cfg.num_layers:
        raise ValueError(f"feature_layer {fl} outside {cfg.num_layers} "
                         "layers")

    x = patchify(pixel_values, cfg.patch_size)
    x = x @ params["patch_embed"]["w"].to(x.dtype)
    if cfg.use_class_embedding:
        cls = params["class_embedding"].to(x.dtype)[None, None, :]
        x = torch.cat([cls.expand(x.shape[0], 1, x.shape[2]), x], dim=1)
    x = x + params["position_embedding"].to(x.dtype)[None]
    x = layernorm(params["pre_ln"], x, cfg.layer_norm_eps)

    act = ACTIVATIONS[cfg.hidden_act]
    for i in range(n_used):
        lp = layer(params["layers"], i)
        h = layernorm(lp["ln1"], x, cfg.layer_norm_eps)
        x = x + _vit_attention(lp["attn"], h, cfg.num_heads)
        h = layernorm(lp["ln2"], x, cfg.layer_norm_eps)
        x = x + dense(lp["mlp"]["fc2"], act(dense(lp["mlp"]["fc1"], h)))

    if apply_post_ln:
        x = layernorm(params["post_ln"], x, cfg.layer_norm_eps)
    return x


def clip_patch_features(params: Dict, cfg: ViTConfig,
                        pixel_values: torch.Tensor) -> torch.Tensor:
    """LLaVA 'patch' features: penultimate layer, CLS dropped."""
    feats = vit_forward(params, cfg, pixel_values, apply_post_ln=False)
    return feats[:, 1:] if cfg.use_class_embedding else feats


def owlvit_feature_map(params: Dict, cfg: ViTConfig, merge_ln: Dict,
                       pixel_values: torch.Tensor) -> torch.Tensor:
    """OWL-ViT merged-CLS map [B, grid, grid, D]: post-LN states, patches
    times the CLS state, one more layernorm."""
    feats = vit_forward(params, cfg, pixel_values, feature_layer=-1,
                        apply_post_ln=True)
    return owl_merge(merge_ln, cfg, feats)


def owl_merge(merge_ln: Dict, cfg: ViTConfig,
              feats: torch.Tensor) -> torch.Tensor:
    """The OWL tower's post-LN states [B, 1 + grid^2, D] -> the merged-CLS
    map [B, grid, grid, D] (patches times CLS, then `merge_ln`); training
    keeps this layernorm trainable behind a frozen tower."""
    patches = layernorm(merge_ln, feats[:, 1:] * feats[:, :1],
                        cfg.layer_norm_eps)
    g = cfg.grid_size
    return patches.reshape(patches.shape[0], g, g, cfg.hidden_size)
