"""The dual-projector VQA LLM "seal_vqa_7b" (port of
vstar_tpu/models/vqa_llm.py): CLIP ViT-L/14 -> linear (256 "long"
tokens) and perceiver (32 "short" latents) projectors -> spliced into a
Vicuna-7B decoder at <image>/<object> sentinels, over a ragged KV cache.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..core.config import VQALLMConfig
from ..core.params import Init
from ..kernels.image_ops import normalize_u8_images
from ..multimodal.splicing import apply_splice, bank_slot_size
from ..nn.llama import (KVCache, embed_tokens, init_llama_params,
                        llama_forward, lm_logits)
from ..nn.projectors import apply_projector, init_projector_params
from ..nn.vit import clip_patch_features, init_vit_params


def init_vqa_llm_params(seed: int, cfg: VQALLMConfig, *, device,
                        dtype=torch.float32, quantize_llm=False) -> Dict:
    """Random parameters drawn on `device` (the JAX tree's names and
    shapes); quantize_llm as init_llama_params' `quantize`."""
    init = Init(seed, device, dtype)
    return {
        "llama": init_llama_params(init, cfg.llama, quantize_llm),
        "vision": init_vit_params(init, cfg.vision),
        "proj_image": init_projector_params(init, cfg.projector_image),
        "proj_object": init_projector_params(init, cfg.projector_object),
    }


def vqa_llm_params_from_torch(sd, cfg: VQALLMConfig, dtype=torch.float32,
                              strict: bool = False,
                              quantize_llm=False) -> Dict:
    """Import a LlavaSearchLlamaForCausalLM state_dict (vstar_tpu
    models/vqa_llm.vqa_llm_params_from_torch), on the device its tensors
    lie on.

    Key roots: 'model.*' (decoder), 'model.vision_tower.vision_tower.
    vision_model.*' (CLIP), 'model.mm_projector.*' (linear),
    'model.mm_projector_object.{0,1,2}.*' (perceiver Sequential).

    strict=True audits every checkpoint key: unknown (present but never
    consumed) or missing keys raise (core/import_audit.py). quantize_llm
    as llama_params_from_torch's `quantize` (each decoder matrix quantized
    as it is read)."""
    from ..core.hf_import import (linear_projector_from_torch,
                                  llama_params_from_torch,
                                  perceiver_params_from_torch,
                                  vit_params_from_torch)
    if strict:
        from ..core.import_audit import strict_import
        return strict_import(
            sd, lambda s: vqa_llm_params_from_torch(
                s, cfg, dtype, quantize_llm=quantize_llm))
    return {
        "llama": llama_params_from_torch(sd, cfg.llama, dtype,
                                         quantize=quantize_llm),
        "vision": vit_params_from_torch(
            sd, cfg.vision, prefix="model.vision_tower.vision_tower."
            "vision_model.", dtype=dtype),
        "proj_image": {"proj": linear_projector_from_torch(
            sd, "model.mm_projector", dtype)},
        "proj_object": {"perceiver": perceiver_params_from_torch(
            sd, cfg.projector_object.perceiver,
            prefix="model.mm_projector_object.", dtype=dtype)},
    }


def clip_bank_features(params: Dict, cfg: VQALLMConfig,
                       image_pixels: torch.Tensor,
                       object_pixels: torch.Tensor) -> torch.Tensor:
    """CLIP patch features of each row's image and object crops,
    [B*(1+M), N, C] (the tower half of encode_feature_bank; training runs
    it without gradients, as JAX stops them at the tower's parameters)."""
    if image_pixels.dtype == torch.uint8:
        image_pixels = normalize_u8_images(image_pixels)
    if object_pixels.dtype == torch.uint8:
        object_pixels = normalize_u8_images(object_pixels)
    B, M = object_pixels.shape[:2]
    all_pixels = torch.cat([image_pixels[:, None], object_pixels], dim=1)
    all_pixels = all_pixels.reshape((B * (1 + M),)
                                    + tuple(image_pixels.shape[1:]))
    vis_dtype = params["vision"]["patch_embed"]["w"].dtype
    return clip_patch_features(params["vision"], cfg.vision,
                               all_pixels.to(vis_dtype))


def project_bank(params: Dict, cfg: VQALLMConfig, feats: torch.Tensor,
                 batch: int) -> torch.Tensor:
    """Both projectors over clip_bank_features' output -> the splice bank
    [B, (1+M)*(256+32), hidden]."""
    long = apply_projector(params["proj_image"], cfg.projector_image, feats)
    short = apply_projector(params["proj_object"], cfg.projector_object,
                            feats)
    bank = torch.cat([long, short], dim=1)
    slot = bank_slot_size(long.shape[1], short.shape[1])
    return bank.reshape(batch, feats.shape[0] // batch * slot,
                        bank.shape[-1])


def encode_feature_bank(params: Dict, cfg: VQALLMConfig,
                        image_pixels: torch.Tensor,
                        object_pixels: torch.Tensor) -> torch.Tensor:
    """The per-row splice bank [B, (1+M)*(256+32), hidden].

    image_pixels [B, 224, 224, 3] and object_pixels [B, M, 224, 224, 3]
    are CLIP-normalized f32 or uint8 (normalized here). Unused object
    slots may hold anything: their bank entries are never gathered."""
    feats = clip_bank_features(params, cfg, image_pixels, object_pixels)
    return project_bank(params, cfg, feats, image_pixels.shape[0])


def spliced_embeds(params: Dict, text_ids: torch.Tensor,
                   feat_bank: torch.Tensor, feat_idx: torch.Tensor,
                   is_feat: torch.Tensor, dtype=torch.bfloat16
                   ) -> torch.Tensor:
    tok = embed_tokens(params["llama"], text_ids, dtype)
    return apply_splice(tok, feat_bank, feat_idx, is_feat)


def prefill(params: Dict, cfg: VQALLMConfig, feat_bank: torch.Tensor,
            text_ids: torch.Tensor, feat_idx: torch.Tensor,
            is_feat: torch.Tensor, lens: torch.Tensor, cache: KVCache,
            compute_dtype=torch.bfloat16
            ) -> Tuple[torch.Tensor, torch.Tensor, KVCache]:
    """Spliced prompt through the decoder, filling the cache (in place).
    Returns (last-position logits [B, vocab], hidden [B, S, D], cache)."""
    B, S = text_ids.shape
    h = spliced_embeds(params, text_ids, feat_bank, feat_idx, is_feat,
                       compute_dtype)
    pos = torch.arange(S, device=h.device)[None].expand(B, S)
    hidden, cache = llama_forward(
        params["llama"], cfg.llama, h, pos, lens,
        q_offsets=torch.zeros((B,), dtype=torch.int32, device=h.device),
        cache=cache)
    last = hidden[torch.arange(B, device=h.device), lens.long() - 1]
    return lm_logits(params["llama"], last), hidden, cache


def decode_step(params: Dict, cfg: VQALLMConfig, cache: KVCache,
                tok: torch.Tensor, compute_dtype=torch.bfloat16
                ) -> Tuple[torch.Tensor, torch.Tensor, KVCache]:
    """One decode step. tok [B, 1] -> (logits [B, vocab], hidden [B, D],
    cache)."""
    h = embed_tokens(params["llama"], tok, compute_dtype)
    hidden, cache = llama_forward(
        params["llama"], cfg.llama, h, cache.length[:, None],
        cache.length + 1, q_offsets=cache.length, cache=cache)
    return lm_logits(params["llama"], hidden)[:, 0], hidden[:, 0], cache
