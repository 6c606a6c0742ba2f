"""Derive model configs from a checkpoint's config.json (port of
vstar_tpu/core/hf_config.py).

The reference loads models through HF from_pretrained, which shapes the
model from the checkpoint's config.json (LLaVA/llava/model/builder.py:26-151,
VisualSearch/model/VSM.py:162-189) — so any Vicuna size (7B/13B) and both
CLIP-L towers (224/336) "just work". This module gives the same generality
to the pytree importers: read config.json if the checkpoint directory has
one, fall back to the 7B presets otherwise.

Attribute names follow what the reference training code writes into the
saved config: `mm_projector_type` / `object_mm_projector_type`
(llava_search_arch.py:50-51), `mm_hidden_size` (:52), `mm_vision_tower`
(:33), `out_dim` for the VSM det FC (VSM.py:69), plus the standard HF
LlamaConfig fields.
"""

from __future__ import annotations

import json
import os
import re
from typing import Mapping, Optional

from .config import (LlamaConfig, PerceiverConfig, ProjectorConfig,
                     ViTConfig, VQALLMConfig, VSMConfig)


def read_config_json(model_dir: str) -> Optional[dict]:
    path = os.path.join(model_dir, "config.json")
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return json.load(f)


def llama_config_from_hf(d: Mapping) -> LlamaConfig:
    hidden = int(d.get("hidden_size", 4096))
    heads = int(d.get("num_attention_heads", 32))
    return LlamaConfig(
        vocab_size=int(d.get("vocab_size", 32000)),
        hidden_size=hidden,
        intermediate_size=int(d.get("intermediate_size", 11008)),
        num_layers=int(d.get("num_hidden_layers", 32)),
        num_heads=heads,
        num_kv_heads=int(d.get("num_key_value_heads", heads)),
        head_dim=int(d.get("head_dim", hidden // heads)),
        max_position_embeddings=int(d.get("max_position_embeddings", 2048)),
        rope_theta=float(d.get("rope_theta", 10000.0)),
        rms_norm_eps=float(d.get("rms_norm_eps", 1e-6)),
        tie_word_embeddings=bool(d.get("tie_word_embeddings", False)),
    )


def clip_tower_config(tower_name: str) -> ViTConfig:
    """CLIP ViT-L/14 at 224 (seal default) or 336 (llava-1.5 naming)."""
    size = 336 if "336" in (tower_name or "") else 224
    return ViTConfig(image_size=size)


def _projector(proj_type: str, in_dim: int, out_dim: int) -> ProjectorConfig:
    if proj_type == "perceiver":
        return ProjectorConfig(
            type="perceiver", in_dim=in_dim, out_dim=out_dim,
            perceiver=PerceiverConfig(dim=in_dim))
    m = re.fullmatch(r"mlp(\d+)x_gelu", proj_type)
    if m:
        return ProjectorConfig(type=proj_type, in_dim=in_dim,
                               out_dim=out_dim, mlp_depth=int(m.group(1)))
    if proj_type in ("linear", "identity"):
        return ProjectorConfig(type=proj_type, in_dim=in_dim, out_dim=out_dim)
    raise ValueError(f"unknown projector type {proj_type!r}")


def vqa_llm_config_from_hf(d: Mapping) -> VQALLMConfig:
    llama = llama_config_from_hf(d)
    mm_hidden = int(d.get("mm_hidden_size", 1024))
    vision = clip_tower_config(d.get("mm_vision_tower", ""))
    return VQALLMConfig(
        llama=llama,
        vision=vision,
        projector_image=_projector(d.get("mm_projector_type", "linear"),
                                   mm_hidden, llama.hidden_size),
        projector_object=_projector(
            d.get("object_mm_projector_type", "perceiver"),
            mm_hidden, llama.hidden_size),
        context_len=int(d.get("max_sequence_length",
                              d.get("max_position_embeddings", 2048))),
    )


def vsm_config_from_hf(d: Mapping) -> VSMConfig:
    llama = llama_config_from_hf(d)
    mm_hidden = int(d.get("mm_hidden_size", 1024))
    vision = clip_tower_config(d.get("mm_vision_tower",
                                     d.get("vision_tower", "")))
    return VSMConfig(
        llama=llama,
        vision=vision,
        projector=_projector(d.get("mm_projector_type", "linear"),
                             mm_hidden, llama.hidden_size),
        out_dim=int(d.get("out_dim", 512)),
    )


def vqa_llm_config_for(model_dir: str) -> VQALLMConfig:
    """Config for a VQA-LLM checkpoint dir; 7B preset if no config.json."""
    d = read_config_json(model_dir)
    if d is None:
        from .config import vqa_llm_7b
        return vqa_llm_7b()
    return vqa_llm_config_from_hf(d)


def vsm_config_for(model_dir: str) -> VSMConfig:
    """Config for a VSM checkpoint dir; 7B preset if no config.json."""
    d = read_config_json(model_dir)
    if d is None:
        from .config import vsm_7b
        return vsm_7b()
    return vsm_config_from_hf(d)
