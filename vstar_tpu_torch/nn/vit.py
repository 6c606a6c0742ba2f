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

Under a mesh whose model axis splits the tower's matrices (core/mesh
.model_local_leaves: VISION_RULES put wq / wk / wv / wo and fc1 on their
columns, fc2 on its rows), each rank computes its shard as XLA
partitions vstar_tpu's tower (its compiled HLO at CLIP-L/14's and
OWL-B/16's widths): the residual stream is split on its features, so
each layernorm sums its moments over the model group (two all-reduces);
the normed states are all-gathered before q / k / v and before fc1, the
attention's output before wo; each rank attends with its H/M heads (K2
on them for OWL's 2305 tokens); fc2's partial products are all-reduced
in f32. The tower's output is gathered once at its end, for the
projectors and heads, which compute whole (XLA lets the features' split
run on into them). A split that would cut a head gathers the matrices
and computes whole.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..core.config import ViTConfig
from ..core.params import Init, dense_init, layer
from ..kernels.tower_attention import tower_attention
from .basic import (ACTIVATIONS, dense, init_dense, init_layernorm,
                    layernorm, partial_dot)

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


def _split_layernorm(p: Dict, x: torch.Tensor, eps: float,
                     split) -> torch.Tensor:
    """layernorm of a residual stream split on its features (this rank's
    columns `x`): the moments' sums over the model group."""
    xf = x.float()
    D = xf.shape[-1] * split.size
    mean = split.reduce(xf.sum(dim=-1, keepdim=True)) / D
    var = split.reduce((xf - mean).square().sum(dim=-1, keepdim=True)) / D
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * split.columns(p["scale"]).float() \
        + split.columns(p["bias"]).float()
    return y.to(x.dtype)


def _column_dense(p: Dict, x: torch.Tensor, split) -> torch.Tensor:
    """x @ this rank's columns of w, plus its columns of the bias."""
    return x @ p["w"].to(x.dtype) + split.columns(p["b"]).to(x.dtype)


def _split_layer(lp: Dict, x: torch.Tensor, cfg: ViTConfig, split,
                 act) -> torch.Tensor:
    """One pre-LN layer on this rank's columns `x` of the residual stream
    (module docstring)."""
    B, S, _ = x.shape
    Dh = cfg.hidden_size // cfg.num_heads
    H = cfg.num_heads // split.size
    eps = cfg.layer_norm_eps
    h = split.gather(_split_layernorm(lp["ln1"], x, eps, split))
    q, k, v = (_column_dense(lp["attn"][n], h, split).reshape(B, S, H, Dh)
               for n in ("wq", "wk", "wv"))
    if S >= TOWER_KERNEL_MIN_SEQ:
        out = tower_attention(q, k, v).reshape(B, S, H * Dh)
    else:
        out = _plain_attention(q, k, v)
    x = x + _column_dense(lp["attn"]["wo"], split.gather(out), split)
    h = split.gather(_split_layernorm(lp["ln2"], x, eps, split))
    f = act(_column_dense(lp["mlp"]["fc1"], h, split))
    fc2 = lp["mlp"]["fc2"]
    y = split.reduce(partial_dot(f, fc2["w"])).to(x.dtype) \
        + fc2["b"].to(x.dtype)
    return x + split.columns(y)


def _tower_split(params: Dict, cfg: ViTConfig):
    """(the tower's model split or None, its layer stack): a stack whose
    matrices are this rank's shards (core/mesh.model_local_leaves) is
    split where the model axis keeps whole heads, else gathered whole
    on it."""
    stack = params["layers"]
    split = getattr(stack["attn"]["wq"].get("w"), "model_split", None)
    if split is None or cfg.num_heads % split.size == 0:
        return split, stack

    def whole(entry, name):     # fc2 is split on its rows
        return dict(entry, w=split.gather(entry["w"],
                                          -2 if name == "fc2" else -1))
    return None, dict(stack, **{
        blk: {n: whole(e, n) for n, e in stack[blk].items()}
        for blk in ("attn", "mlp")})


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
    split, stack = _tower_split(params, cfg)
    eps = cfg.layer_norm_eps
    if split is not None:
        x = _split_layernorm(params["pre_ln"], split.columns(x), eps, split)
    else:
        x = layernorm(params["pre_ln"], x, eps)

    act = ACTIVATIONS[cfg.hidden_act]
    for i in range(n_used):
        lp = layer(stack, i)
        if split is not None:
            x = _split_layer(lp, x, cfg, split, act)
            continue
        h = layernorm(lp["ln1"], x, eps)
        x = x + _vit_attention(lp["attn"], h, cfg.num_heads)
        h = layernorm(lp["ln2"], x, eps)
        x = x + dense(lp["mlp"]["fc2"], act(dense(lp["mlp"]["fc1"], h)))

    if apply_post_ln:
        x = (layernorm(params["post_ln"], x, eps) if split is None else
             _split_layernorm(params["post_ln"], x, eps, split))
    return x if split is None else split.gather(x)


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
