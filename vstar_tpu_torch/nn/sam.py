"""SAM prompt encoder (text path) and mask decoder (port of
vstar_tpu/nn/sam.py). The [LOC] hidden state, projected, is the sparse
prompt; upscaling is bilinear 2x + 3x3 conv, twice.

Layout: NHWC activations and HWIO conv weights, as in the JAX package;
the convs permute to PyTorch's NCHW/OIHW around F.conv2d.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..core.config import SamDecoderConfig
from ..core.params import Init
from .basic import dense, init_dense, init_layernorm, layernorm


# ---------------------------------------------------------------------------
# Prompt encoder (text path + dense PE)
# ---------------------------------------------------------------------------

def init_prompt_encoder_params(init: Init, cfg: SamDecoderConfig) -> Dict:
    return {"pe_gaussian": init.normal((2, cfg.embed_dim // 2)),
            "no_mask_embed": init.normal((cfg.embed_dim,))}


def _pe_encode(coords: torch.Tensor, gaussian: torch.Tensor) -> torch.Tensor:
    c = (2 * coords.float() - 1) @ gaussian.float()
    c = 2 * math.pi * c
    return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


def dense_positional_encoding(params: Dict,
                              cfg: SamDecoderConfig) -> torch.Tensor:
    """Random-Fourier PE over the embedding grid -> [H, W, embed_dim]."""
    h, w = cfg.image_embedding_size
    dev = params["pe_gaussian"].device
    y = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
    x = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
    grid = torch.stack(torch.meshgrid(x, y, indexing="xy"), dim=-1)
    return _pe_encode(grid, params["pe_gaussian"])


def encode_text_prompt(params: Dict, cfg: SamDecoderConfig,
                       text_embeds: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """text_embeds [B, T, C] -> (sparse [B, T, C], dense [B, H, W, C])."""
    B = text_embeds.shape[0]
    h, w = cfg.image_embedding_size
    dense_emb = params["no_mask_embed"].to(text_embeds.dtype)[
        None, None, None, :].expand(B, h, w, cfg.embed_dim)
    return text_embeds, dense_emb


# ---------------------------------------------------------------------------
# TwoWayTransformer
# ---------------------------------------------------------------------------

def _init_attn(init: Init, dim: int, internal: int) -> Dict:
    return {"q": init_dense(init, dim, internal),
            "k": init_dense(init, dim, internal),
            "v": init_dense(init, dim, internal),
            "out": init_dense(init, internal, dim)}


def _attn(p: Dict, num_heads: int, q, k, v):
    qq, kk, vv = dense(p["q"], q), dense(p["k"], k), dense(p["v"], v)
    B, Lq, I = qq.shape
    Lk = kk.shape[1]
    Dh = I // num_heads
    qq = qq.reshape(B, Lq, num_heads, Dh)
    kk = kk.reshape(B, Lk, num_heads, Dh)
    vv = vv.reshape(B, Lk, num_heads, Dh)
    logits = torch.einsum("bqhd,bkhd->bhqk", qq.float(),
                          kk.float()) / math.sqrt(Dh)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vv).reshape(B, Lq, I)
    return dense(p["out"], out)


def init_twoway_transformer_params(init: Init,
                                   cfg: SamDecoderConfig) -> Dict:
    D = cfg.embed_dim
    internal = D // cfg.attention_downsample_rate

    def one_layer():
        return {
            "self_attn": _init_attn(init, D, D),
            "norm1": init_layernorm(init, D),
            "cross_t2i": _init_attn(init, D, internal),
            "norm2": init_layernorm(init, D),
            "mlp_in": init_dense(init, D, cfg.transformer_mlp_dim),
            "mlp_out": init_dense(init, cfg.transformer_mlp_dim, D),
            "norm3": init_layernorm(init, D),
            "norm4": init_layernorm(init, D),
            "cross_i2t": _init_attn(init, D, internal),
        }

    return {"layers": [one_layer() for _ in range(cfg.transformer_depth)],
            "final_attn": _init_attn(init, D, internal),
            "norm_final": init_layernorm(init, D)}


def twoway_transformer(params: Dict, cfg: SamDecoderConfig,
                       image_embedding: torch.Tensor,
                       image_pe: torch.Tensor,
                       point_embedding: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """image_embedding/image_pe [B, HW, C], point_embedding [B, T, C] ->
    (queries [B, T, C], keys [B, HW, C])."""
    H = cfg.transformer_num_heads
    queries, keys = point_embedding, image_embedding
    for i, lp in enumerate(params["layers"]):
        if i == 0:
            queries = _attn(lp["self_attn"], H, queries, queries, queries)
        else:
            q = queries + point_embedding
            queries = queries + _attn(lp["self_attn"], H, q, q, queries)
        queries = layernorm(lp["norm1"], queries)

        q = queries + point_embedding
        k = keys + image_pe
        queries = queries + _attn(lp["cross_t2i"], H, q, k, keys)
        queries = layernorm(lp["norm2"], queries)

        h = F.relu(dense(lp["mlp_in"], queries))
        queries = layernorm(lp["norm3"], queries + dense(lp["mlp_out"], h))

        q = queries + point_embedding
        k = keys + image_pe
        keys = layernorm(lp["norm4"],
                         keys + _attn(lp["cross_i2t"], H, k, q, queries))

    q = queries + point_embedding
    k = keys + image_pe
    queries = queries + _attn(params["final_attn"], H, q, k, keys)
    return layernorm(params["norm_final"], queries), keys


# ---------------------------------------------------------------------------
# Mask decoder
# ---------------------------------------------------------------------------

def _conv3x3(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """NHWC 3x3 'same' conv with an HWIO weight."""
    w = p["w"].to(x.dtype).permute(3, 2, 0, 1)           # HWIO -> OIHW
    y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=1)
    return y.permute(0, 2, 3, 1) + p["b"].to(x.dtype)


def _init_conv3x3(init: Init, cin: int, cout: int) -> Dict:
    return {"w": init.uniform((3, 3, cin, cout), 1.0 / math.sqrt(cin * 9)),
            "b": init.zeros((cout,))}


def init_mask_decoder_params(init: Init, cfg: SamDecoderConfig) -> Dict:
    D = cfg.embed_dim
    n_tokens = cfg.num_mask_tokens

    def mlp3(din, dh, dout):
        return {"fc0": init_dense(init, din, dh),
                "fc1": init_dense(init, dh, dh),
                "fc2": init_dense(init, dh, dout)}

    return {
        "iou_token": init.normal((1, D)),
        "mask_tokens": init.normal((n_tokens, D)),
        "transformer": init_twoway_transformer_params(init, cfg),
        "upscale_conv1": _init_conv3x3(init, D, D // 4),
        "upscale_ln": init_layernorm(init, D // 4),
        "upscale_conv2": _init_conv3x3(init, D // 4, D // 8),
        "hyper_mlps": [mlp3(D, D, D // 8) for _ in range(n_tokens)],
        "iou_head": mlp3(D, cfg.iou_head_hidden_dim, n_tokens),
    }


def _mlp3(p: Dict, x: torch.Tensor) -> torch.Tensor:
    x = F.relu(dense(p["fc0"], x))
    x = F.relu(dense(p["fc1"], x))
    return dense(p["fc2"], x)


def _upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x with half-pixel centres (jax.image.resize 'bilinear',
    which for upsampling equals align_corners=False with edge clamping)."""
    y = F.interpolate(x.float().permute(0, 3, 1, 2), scale_factor=2,
                      mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def mask_decoder(params: Dict, cfg: SamDecoderConfig,
                 image_embeddings: torch.Tensor, image_pe: torch.Tensor,
                 sparse_prompt: torch.Tensor, dense_prompt: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """image_embeddings [B, H, W, C], image_pe [H, W, C], sparse_prompt
    [B, T, C], dense_prompt [B, H, W, C] -> the single-mask output of
    the VSM (multimask_output=False): (mask logits [B, 1, 4H, 4W],
    iou_pred [B, 1])."""
    B = sparse_prompt.shape[0]
    D = cfg.embed_dim
    h, w = cfg.image_embedding_size

    output_tokens = torch.cat([params["iou_token"], params["mask_tokens"]],
                              dim=0)
    output_tokens = output_tokens[None].to(sparse_prompt.dtype).expand(
        B, 1 + cfg.num_mask_tokens, D)
    tokens = torch.cat([output_tokens, sparse_prompt], dim=1)

    src = image_embeddings + dense_prompt
    src_flat = src.reshape(B, h * w, D)
    pe_flat = image_pe.reshape(1, h * w, D).to(src.dtype).expand(B, h * w, D)

    hs, src_out = twoway_transformer(params["transformer"], cfg, src_flat,
                                     pe_flat, tokens)
    iou_token_out = hs[:, 0]
    mask_tokens_out = hs[:, 1:1 + cfg.num_mask_tokens]

    src_img = src_out.reshape(B, h, w, D)
    up = _conv3x3(params["upscale_conv1"], _upsample2x(src_img))
    up = F.gelu(layernorm(params["upscale_ln"], up, eps=1e-6))
    up = F.gelu(_conv3x3(params["upscale_conv2"], _upsample2x(up)))

    hyper = torch.stack(
        [_mlp3(params["hyper_mlps"][i], mask_tokens_out[:, i])
         for i in range(cfg.num_mask_tokens)], dim=1)     # [B, n, D//8]
    up_flat = up.reshape(B, 16 * h * w, D // 8)
    masks = torch.einsum("bnc,bpc->bnp", hyper, up_flat)
    masks = masks.reshape(B, cfg.num_mask_tokens, 4 * h, 4 * w)
    iou_pred = _mlp3(params["iou_head"], iou_token_out)
    return masks[:, :1], iou_pred[:, :1]


def sam_params_from_torch(sd, cfg: SamDecoderConfig, prompt_prefix: str,
                          decoder_prefix: str, dtype=torch.float32
                          ) -> Tuple[Dict, Dict]:
    """Import SAM PromptEncoder/MaskDecoder weights from a torch state_dict
    (vstar_tpu nn/sam.sam_params_from_torch).

    prompt_prefix e.g. 'prompt_encoder.', decoder_prefix e.g. 'mask_decoder.'.
    Returns (prompt_encoder_params, mask_decoder_params).
    """
    from ..core.hf_import import _lin, _np

    def lin(name):
        return {"w": _lin(sd, name + ".weight").to(dtype),
                "b": _np(sd[name + ".bias"]).to(dtype)}

    def ln(name):
        return {"scale": _np(sd[name + ".weight"]).to(dtype),
                "bias": _np(sd[name + ".bias"]).to(dtype)}

    def conv(name):
        w = _np(sd[name + ".weight"]).permute(2, 3, 1, 0)  # OIHW -> HWIO
        return {"w": w.contiguous().to(dtype),
                "b": _np(sd[name + ".bias"]).to(dtype)}

    pe = {
        "pe_gaussian": _np(sd[prompt_prefix + "pe_layer."
                              "positional_encoding_gaussian_matrix"]
                           ).to(dtype),
        "no_mask_embed": _np(sd[prompt_prefix + "no_mask_embed.weight"]
                             )[0].to(dtype),
    }

    def attn(name):
        return {"q": lin(name + ".q_proj"), "k": lin(name + ".k_proj"),
                "v": lin(name + ".v_proj"), "out": lin(name + ".out_proj")}

    dp = decoder_prefix
    layers = []
    for i in range(cfg.transformer_depth):
        b = f"{dp}transformer.layers.{i}."
        layers.append({
            "self_attn": attn(b + "self_attn"),
            "norm1": ln(b + "norm1"),
            "cross_t2i": attn(b + "cross_attn_token_to_image"),
            "norm2": ln(b + "norm2"),
            "mlp_in": lin(b + "mlp.lin1"),
            "mlp_out": lin(b + "mlp.lin2"),
            "norm3": ln(b + "norm3"),
            "norm4": ln(b + "norm4"),
            "cross_i2t": attn(b + "cross_attn_image_to_token"),
        })

    decoder = {
        "iou_token": _np(sd[dp + "iou_token.weight"]).to(dtype),
        "mask_tokens": _np(sd[dp + "mask_tokens.weight"]).to(dtype),
        "transformer": {
            "layers": layers,
            "final_attn": attn(dp + "transformer.final_attn_token_to_image"),
            "norm_final": ln(dp + "transformer.norm_final_attn"),
        },
        "upscale_conv1": conv(dp + "output_upscaling.0.conv"),
        "upscale_ln": ln(dp + "output_upscaling.1"),
        "upscale_conv2": conv(dp + "output_upscaling.3.conv"),
        "hyper_mlps": [
            {"fc0": lin(f"{dp}output_hypernetworks_mlps.{i}.layers.0"),
             "fc1": lin(f"{dp}output_hypernetworks_mlps.{i}.layers.1"),
             "fc2": lin(f"{dp}output_hypernetworks_mlps.{i}.layers.2")}
            for i in range(cfg.num_mask_tokens)],
        "iou_head": {
            "fc0": lin(dp + "iou_prediction_head.layers.0"),
            "fc1": lin(dp + "iou_prediction_head.layers.1"),
            "fc2": lin(dp + "iou_prediction_head.layers.2"),
        },
    }
    return pe, decoder
