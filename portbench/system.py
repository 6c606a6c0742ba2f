"""The system under test: the port's configs and engines, built from a
configuration file and filled with weights.py's weights.

The engines are the eval command line's defaults (eval/vstar_bench.py's
loaders: a VQAEngine and a host-preprocess BatchedVSMEngine, bf16, both
resident) with the decode budget of the search that bench.py discloses
(16 tokens); the free-form budget (32) is passed by the drivers.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from .weights import fill_tree

SERVED_DTYPE = torch.bfloat16
SEARCH_TOKENS = 16


def llama_config(cfg: Dict):
    from vstar_tpu_torch.core.config import LlamaConfig
    return LlamaConfig(
        vocab_size=cfg["vocab_size"] + cfg["added_tokens"],
        hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg["hidden_size"] // cfg["num_attention_heads"],
        max_position_embeddings=cfg["max_position_embeddings"],
        rope_theta=float(cfg["rope_theta"]),
        rms_norm_eps=float(cfg["rms_norm_eps"]),
        tie_word_embeddings=bool(cfg["tie_word_embeddings"]))


def _vit(t: Dict):
    from vstar_tpu_torch.core.config import ViTConfig
    keys = {f.name for f in dataclasses.fields(ViTConfig)}
    return ViTConfig(**{k: v for k, v in t.items() if k in keys})


def model_configs(cfg: Dict):
    """(VQALLMConfig, VSMConfig) of a configuration file."""
    from vstar_tpu_torch.core.config import (OwlHeadConfig, PerceiverConfig,
                                             ProjectorConfig, SamDecoderConfig,
                                             VQALLMConfig, VSMConfig)
    s = cfg["seal"]
    llama = llama_config(cfg)
    D = cfg["hidden_size"]
    vision = _vit(s["vision"])
    sam = dict(s["sam"])
    sam["image_embedding_size"] = tuple(sam["image_embedding_size"])
    sam["input_image_size"] = tuple(sam["input_image_size"])
    vqa = VQALLMConfig(
        llama=llama, vision=vision,
        projector_image=ProjectorConfig(type="linear",
                                        in_dim=s["projector_image"]["in_dim"],
                                        out_dim=D),
        projector_object=ProjectorConfig(
            type="perceiver", in_dim=s["perceiver"]["dim"], out_dim=D,
            perceiver=PerceiverConfig(**s["perceiver"])),
        max_objects=s["max_objects"])
    vsm = VSMConfig(
        llama=llama, vision=vision, owl_vision=_vit(s["owl_vision"]),
        owl_head=OwlHeadConfig(**s["owl_head"]),
        sam=SamDecoderConfig(**{k: v for k, v in sam.items()
                                if k in {f.name for f in dataclasses.fields(
                                    SamDecoderConfig)}}),
        projector=ProjectorConfig(type="linear",
                                  in_dim=s["projector_image"]["in_dim"],
                                  out_dim=D),
        out_dim=s["vsm_out_dim"], seg_dim=s["vsm_seg_dim"])
    return vqa, vsm


def param_shapes(cfg: Dict) -> Dict[str, tuple]:
    """Dotted path -> shape of both trees as the program builds them
    ('vqa.' and 'vsm.' prefixes), from a build on the meta device."""
    from vstar_tpu_torch.core.params import leaves_with_path
    from vstar_tpu_torch.models.vqa_llm import init_vqa_llm_params
    from vstar_tpu_torch.models.vsm import init_vsm_params
    vqa_cfg, vsm_cfg = model_configs(cfg)
    out = {}
    for pre, fn, c in (("vqa.", init_vqa_llm_params, vqa_cfg),
                       ("vsm.", init_vsm_params, vsm_cfg)):
        tree = fn(0, c, device="meta", dtype=SERVED_DTYPE)
        for path, leaf in leaves_with_path(tree):
            out[pre + path] = tuple(leaf.shape)
    return out


def build_engines(cfg: Dict, seed: int, device, dtype=SERVED_DTYPE):
    """(VQAEngine, BatchedVSMEngine) over weights made from `seed`, with
    the engines' default buckets (`dtype` f32 for the CPU tests)."""
    from vstar_tpu_torch.eval.vqa_engine import VQAEngine
    from vstar_tpu_torch.models.vqa_llm import init_vqa_llm_params
    from vstar_tpu_torch.models.vsm import init_vsm_params
    from vstar_tpu_torch.multimodal.stub_tokenizer import StubTokenizer
    from vstar_tpu_torch.search.batched import BatchedVSMEngine
    vqa_cfg, vsm_cfg = model_configs(cfg)
    tok = StubTokenizer(vqa_cfg.llama.vocab_size)
    vqa_p = fill_tree(init_vqa_llm_params(0, vqa_cfg, device="meta",
                                          dtype=dtype),
                      seed, device, dtype, "vqa.")
    vsm_p = fill_tree(init_vsm_params(0, vsm_cfg, device="meta",
                                      dtype=dtype),
                      seed, device, dtype, "vsm.")
    vqa = VQAEngine(vqa_p, vqa_cfg, tok, device=device, compute_dtype=dtype)
    vsm = BatchedVSMEngine(vsm_p, vsm_cfg, tok, loc_token_id=3,
                           device=device, max_new_tokens=SEARCH_TOKENS,
                           compute_dtype=dtype)
    return vqa, vsm
