"""HF / torch checkpoint import: state_dicts -> the port's parameter trees
(port of vstar_tpu/core/hf_import.py).

The public reference checkpoints (craigwu/seal_vqa_7b, craigwu/seal_vsm_7b)
are HF torch checkpoints. These converters map their flat name -> tensor
dicts onto the port's nested, stacked trees, which keep the JAX layouts:
dense weights (in, out), LLaMA and ViT layers stacked along a leading
axis, the patch conv as a (kh*kw*in, out) matrix.

Every function accepts torch tensors or numpy arrays and works where the
tensors lie: a state_dict read onto the card (core/checkpoint.
load_torch_dir(..., device)) is transposed, cast and quantized there, so
a bf16 checkpoint is never cast through numpy. Each weight passes through
f32 on its way (as JAX's `_np` does), one tensor at a time.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .config import LlamaConfig, PerceiverConfig, ViTConfig


def _np(x) -> torch.Tensor:
    """A checkpoint tensor (torch or numpy) as f32 on its device."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x))
    return x.float()


def _lin(sd: Mapping, name: str) -> torch.Tensor:
    """torch Linear weight (out, in) -> (in, out), f32."""
    return _np(sd[name]).T.contiguous()


def _stack_tree(trees):
    """Stack a list of equal-structure trees leaf by leaf (layer axis 0)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_tree([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


# ---------------------------------------------------------------------------
# LLaMA
# ---------------------------------------------------------------------------

def llama_params_from_torch(sd: Mapping, cfg: LlamaConfig,
                            dtype=torch.float32, quantize=False) -> Dict:
    """Convert an HF LlamaForCausalLM state_dict (bare 'model.layers...'
    or LLaVA-wrapped, whose other keys are ignored here).

    quantize: False | True/'int8' (per-channel int8) | 'int4' (group-128
    int4) | 'int4mix' (int4 gate/up/lm_head, int8 the rest,
    nn/quant.INT4MIX_INT4_KEYS): each matrix is quantized as it is read,
    layer by layer, so the full-precision decoder is never resident."""
    from ..nn.quant import (quantize_weight, quantize_weight_int4,
                            resolve_matrix_quant)

    def quant_fn(name):
        q = resolve_matrix_quant(quantize, name)
        if q == "int4":
            return quantize_weight_int4
        return quantize_weight if q else None

    def stack_lin(fmt, name):
        fn = quant_fn(name)
        if fn is None:
            return torch.stack([_lin(sd, fmt.format(i)).to(dtype)
                                for i in range(cfg.num_layers)])
        parts = [fn(_lin(sd, fmt.format(i))) for i in range(cfg.num_layers)]
        return {k: torch.stack([e[k] for e in parts]) for k in parts[0]}

    def stack_vec(fmt):
        return torch.stack([_np(sd[fmt.format(i)]).to(dtype)
                            for i in range(cfg.num_layers)])

    layers = {
        "input_norm": {"scale": stack_vec(
            "model.layers.{}.input_layernorm.weight")},
        "post_norm": {"scale": stack_vec(
            "model.layers.{}.post_attention_layernorm.weight")},
        "attn": {
            "wq": stack_lin("model.layers.{}.self_attn.q_proj.weight", "wq"),
            "wk": stack_lin("model.layers.{}.self_attn.k_proj.weight", "wk"),
            "wv": stack_lin("model.layers.{}.self_attn.v_proj.weight", "wv"),
            "wo": stack_lin("model.layers.{}.self_attn.o_proj.weight", "wo"),
        },
        "mlp": {
            "w_gate": stack_lin("model.layers.{}.mlp.gate_proj.weight",
                                "w_gate"),
            "w_up": stack_lin("model.layers.{}.mlp.up_proj.weight", "w_up"),
            "w_down": stack_lin("model.layers.{}.mlp.down_proj.weight",
                                "w_down"),
        },
    }
    lm_fn = quant_fn("lm_head")
    lm_head = _lin(sd, "lm_head.weight")
    lm_head = lm_head.to(dtype) if lm_fn is None else lm_fn(lm_head)
    return {
        "embed_tokens": _np(sd["model.embed_tokens.weight"]).to(dtype),
        "layers": layers,
        "final_norm": {"scale": _np(sd["model.norm.weight"]).to(dtype)},
        "lm_head": lm_head,
    }


# ---------------------------------------------------------------------------
# CLIP-style ViT (CLIP ViT-L/14 tower and OWL-ViT B/16 tower)
# ---------------------------------------------------------------------------

def vit_params_from_torch(sd: Mapping, cfg: ViTConfig, prefix: str = "",
                          dtype=torch.float32) -> Dict:
    """Convert an HF CLIPVisionModel / OwlViTVisionModel state_dict.

    `prefix` points at the vision_model root, e.g. 'vision_model.'.
    HF layout: embeddings.{class_embedding,patch_embedding,position_embedding},
    pre_layrnorm (CLIP) / pre_layernorm (OwlViT), encoder.layers.N.
    """
    def g(k):
        return sd[prefix + k]

    # HF CLIP misspells 'pre_layrnorm'; OwlViT uses 'pre_layernorm'.
    pre_ln_key = None
    for cand in ("pre_layrnorm", "pre_layernorm"):
        if prefix + cand + ".weight" in sd:
            pre_ln_key = cand
            break

    def ln(k):
        return {"scale": _np(g(k + ".weight")).to(dtype),
                "bias": _np(g(k + ".bias")).to(dtype)}

    def lyr(i):
        p = f"encoder.layers.{i}."

        def dense(k):
            return {"w": _lin(sd, prefix + p + k + ".weight").to(dtype),
                    "b": _np(g(p + k + ".bias")).to(dtype)}

        return {
            "ln1": ln(p + "layer_norm1"),
            "ln2": ln(p + "layer_norm2"),
            "attn": {
                "wq": dense("self_attn.q_proj"),
                "wk": dense("self_attn.k_proj"),
                "wv": dense("self_attn.v_proj"),
                "wo": dense("self_attn.out_proj"),
            },
            "mlp": {"fc1": dense("mlp.fc1"), "fc2": dense("mlp.fc2")},
        }

    layers = _stack_tree([lyr(i) for i in range(cfg.num_layers)])

    # patch embedding conv: torch (out_c, in_c, kh, kw) -> matmul-friendly
    # (kh*kw*in_c, out_c) with HWC ordering to match the patchify
    pw = _np(g("embeddings.patch_embedding.weight"))
    out_c = pw.shape[0]
    pw = pw.permute(2, 3, 1, 0).reshape(-1, out_c)

    params = {
        "patch_embed": {"w": pw.to(dtype)},
        "position_embedding": _np(
            g("embeddings.position_embedding.weight")).to(dtype),
        "layers": layers,
        "post_ln": ln("post_layernorm"),
    }
    if cfg.use_class_embedding:
        params["class_embedding"] = _np(
            g("embeddings.class_embedding")).to(dtype)
    if pre_ln_key is not None:
        params["pre_ln"] = ln(pre_ln_key)
    return params


# ---------------------------------------------------------------------------
# Projectors
# ---------------------------------------------------------------------------

def linear_projector_from_torch(sd: Mapping, key: str,
                                dtype=torch.float32) -> Dict:
    """mm_projector nn.Linear -> dense params."""
    return {"w": _lin(sd, key + ".weight").to(dtype),
            "b": _np(sd[key + ".bias"]).to(dtype)}


def perceiver_params_from_torch(sd: Mapping, cfg: PerceiverConfig,
                                prefix: str, dtype=torch.float32) -> Dict:
    """Convert the reference perceiver projector:
    nn.Sequential(LayerNorm, PerceiverResampler, Linear)
    (LLaVA/llava/model/multimodal_projector/builder.py:54-68).

    `prefix` points at the Sequential root, e.g. 'model.mm_projector_object.'
    so keys look like '{prefix}0.weight', '{prefix}1.latents',
    '{prefix}1.layers.0.0.to_q.weight', '{prefix}2.weight'.
    """
    def ln(base):
        return {"scale": _np(sd[base + ".weight"]).to(dtype),
                "bias": _np(sd[base + ".bias"]).to(dtype)}

    def w(name):
        return {"w": _lin(sd, name).to(dtype)}

    def layer(i):
        a = f"{prefix}1.layers.{i}.0."   # PerceiverAttention
        f = f"{prefix}1.layers.{i}.1."   # FeedForward Sequential
        return {
            "norm_media": ln(a + "norm_media"),
            "norm_latents": ln(a + "norm_latents"),
            "to_q": w(a + "to_q.weight"),
            "to_kv": w(a + "to_kv.weight"),
            "to_out": w(a + "to_out.weight"),
            "ff_norm": ln(f + "0"),
            "ff_in": w(f + "1.weight"),
            "ff_out": w(f + "3.weight"),
        }

    return {
        "pre_ln": ln(f"{prefix}0"),
        "latents": _np(sd[f"{prefix}1.latents"]).to(dtype),
        "media_pos_emb": _np(sd[f"{prefix}1.media_pos_emb"]).to(dtype),
        "layers": _stack_tree([layer(i) for i in range(cfg.depth)]),
        "final_norm": ln(f"{prefix}1.norm"),
        "out_proj": {"w": _lin(sd, f"{prefix}2.weight").to(dtype),
                     "b": _np(sd[f"{prefix}2.bias"]).to(dtype)},
    }
