"""The Visual Search Model "seal_vsm_7b" (port of vstar_tpu/models/vsm.py):
LLaVA-7B (CLIP ViT-L/14 + linear projector + Vicuna-7B) plus the OWL-ViT
B/16 tower with class/box heads (detection) and the SAM prompt encoder and
mask decoder (segmentation heatmap), both driven by the hidden state that
produced a [LOC] token: the first [LOC] for detection, the last for the
mask.

The towers run in the weights' dtype (bf16 at 7B, so the OWL tower's
attention takes kernel K2); the JAX package ran them in f32 on bf16
weights. At f32 (the tests) the two agree.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.config import VSMConfig
from ..core.params import Init
from ..decode.graphs import DecodeGraphs
from ..decode.sampler import greedy_decode
from ..decode.speculative import speculative_decode
from ..kernels.image_ops import normalize_u8_images
from ..multimodal.splicing import apply_splice
from ..nn.basic import dense, init_dense, init_layernorm
from ..nn.llama import (embed_tokens, init_llama_params, kv_heads,
                        llama_forward, lm_logits)
from ..nn.owl_heads import init_owl_head_params, owl_detect
from ..nn.projectors import apply_projector, init_projector_params
from ..nn.sam import (dense_positional_encoding, encode_text_prompt,
                      init_mask_decoder_params, init_prompt_encoder_params,
                      mask_decoder)
from ..nn.vit import (clip_patch_features, init_vit_params,
                      owlvit_feature_map, vit_forward)


def init_vsm_params(seed: int, cfg: VSMConfig, *, device,
                    dtype=torch.float32, quantize_llm=False) -> Dict:
    """Random parameters drawn on `device` (the JAX tree's names and
    shapes); quantize_llm as init_llama_params' `quantize`."""
    init = Init(seed, device, dtype)
    h = cfg.llama.hidden_size
    return {
        "llama": init_llama_params(init, cfg.llama, quantize_llm),
        "vision": init_vit_params(init, cfg.vision),
        "proj": init_projector_params(init, cfg.projector),
        "owl_tower": init_vit_params(init, cfg.owl_vision),
        "owl_merge_ln": init_layernorm(init, cfg.owl_vision.hidden_size),
        "owl_heads": init_owl_head_params(init, cfg.owl_head),
        "visual_projection": {"w": init.normal(
            (cfg.owl_vision.hidden_size, cfg.sam.embed_dim), 0.02)},
        "prompt_encoder": init_prompt_encoder_params(init, cfg.sam),
        "mask_decoder": init_mask_decoder_params(init, cfg.sam),
        "fc_det": {"fc0": init_dense(init, h, h),
                   "fc1": init_dense(init, h, cfg.out_dim)},
        "fc_seg": {"fc0": init_dense(init, h, h),
                   "fc1": init_dense(init, h, cfg.seg_dim)},
    }


def vsm_params_from_torch(sd, cfg: VSMConfig, dtype=torch.float32,
                          strict: bool = False, quantize_llm=False) -> Dict:
    """Import a VSMForCausalLM state_dict (craigwu/seal_vsm_7b; vstar_tpu
    models/vsm.vsm_params_from_torch), on the device its tensors lie on.

    strict=True audits every checkpoint key: unknown (present but never
    consumed) or missing keys raise (core/import_audit.py). quantize_llm
    as llama_params_from_torch's `quantize`."""
    from ..core.hf_import import (_lin, _np, linear_projector_from_torch,
                                  llama_params_from_torch,
                                  vit_params_from_torch)
    from ..nn.owl_heads import owl_head_params_from_torch
    from ..nn.sam import sam_params_from_torch
    if strict:
        from ..core.import_audit import strict_import
        return strict_import(
            sd, lambda s: vsm_params_from_torch(
                s, cfg, dtype, quantize_llm=quantize_llm))
    pe, dec = sam_params_from_torch(sd, cfg.sam, "model.prompt_encoder.",
                                    "model.mask_decoder.", dtype)

    def fc(prefix):
        # Sequential(Linear, ReLU, Linear, Dropout) -> indices 0 and 2
        return {"fc0": {"w": _lin(sd, prefix + ".0.weight").to(dtype),
                        "b": _np(sd[prefix + ".0.bias"]).to(dtype)},
                "fc1": {"w": _lin(sd, prefix + ".2.weight").to(dtype),
                        "b": _np(sd[prefix + ".2.bias"]).to(dtype)}}

    return {
        "llama": llama_params_from_torch(sd, cfg.llama, dtype,
                                         quantize=quantize_llm),
        "vision": vit_params_from_torch(
            sd, cfg.vision,
            prefix="model.vision_tower.vision_tower.vision_model.",
            dtype=dtype),
        "proj": {"proj": linear_projector_from_torch(
            sd, "model.mm_projector", dtype)},
        "owl_tower": vit_params_from_torch(
            sd, cfg.owl_vision, prefix="model.owlvit.vision_model.",
            dtype=dtype),
        "owl_merge_ln": {
            "scale": _np(sd["model.owlvit.layer_norm.weight"]).to(dtype),
            "bias": _np(sd["model.owlvit.layer_norm.bias"]).to(dtype)},
        "owl_heads": owl_head_params_from_torch(sd, prefix="model.owlvit.",
                                                dtype=dtype),
        "visual_projection": {"w": _lin(
            sd, "model.visual_projection.weight").to(dtype)},
        "prompt_encoder": pe,
        "mask_decoder": dec,
        "fc_det": fc("model.text_hidden_fcs_det.0"),
        "fc_seg": fc("model.text_hidden_fcs_seg.0"),
    }


def _tower_input(params: Dict, pixels: torch.Tensor) -> torch.Tensor:
    if pixels.dtype == torch.uint8:
        pixels = normalize_u8_images(pixels)
    return pixels.to(params["patch_embed"]["w"].dtype)


def encode_clip_bank(params: Dict, cfg: VSMConfig,
                     images_clip: torch.Tensor) -> torch.Tensor:
    """CLIP tower + linear projector -> [B, 256, hidden] splice bank."""
    feats = clip_patch_features(params["vision"], cfg.vision,
                                _tower_input(params["vision"], images_clip))
    return apply_projector(params["proj"], cfg.projector, feats)


def owl_features(params: Dict, cfg: VSMConfig,
                 images_owl: torch.Tensor) -> torch.Tensor:
    """OWL-ViT merged-CLS feature map [B, 48, 48, 768]."""
    return owlvit_feature_map(
        params["owl_tower"], cfg.owl_vision, params["owl_merge_ln"],
        _tower_input(params["owl_tower"], images_owl))


def owl_tower_states(params: Dict, cfg: VSMConfig,
                     images_owl: torch.Tensor) -> torch.Tensor:
    """The OWL tower's post-LN states [B, 1 + 48*48, 768] (the merge
    layernorm not applied: training keeps it trainable)."""
    return vit_forward(params["owl_tower"], cfg.owl_vision,
                       _tower_input(params["owl_tower"], images_owl),
                       feature_layer=-1, apply_post_ln=True)


def _text_fc(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return dense(p["fc1"], F.relu(dense(p["fc0"], x)))


def vsm_detection(params: Dict, cfg: VSMConfig, feature_map: torch.Tensor,
                  loc_hidden: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """loc_hidden [B, hidden] -> (logits [B, N], boxes [B, N, 4])."""
    q = _text_fc(params["fc_det"], loc_hidden)[:, None, :]
    logits, boxes = owl_detect(params["owl_heads"], cfg.owl_head,
                               feature_map, q)
    return logits[..., 0], boxes


def vsm_segmentation(params: Dict, cfg: VSMConfig, feature_map: torch.Tensor,
                     loc_hidden: torch.Tensor) -> torch.Tensor:
    """loc_hidden [B, hidden] -> low-res mask logits [B, 4h, 4w]."""
    text = _text_fc(params["fc_seg"], loc_hidden)[:, None, :]
    img = feature_map @ params["visual_projection"]["w"].to(
        feature_map.dtype)
    sparse, dense_emb = encode_text_prompt(params["prompt_encoder"], cfg.sam,
                                           text)
    pe = dense_positional_encoding(params["prompt_encoder"], cfg.sam)
    masks, _ = mask_decoder(params["mask_decoder"], cfg.sam, img, pe,
                            sparse, dense_emb)
    return masks[:, 0]


class VSMOutput(NamedTuple):
    tokens: torch.Tensor         # int32 [B, max_new]
    num_generated: torch.Tensor  # int32 [B]
    det_logits: torch.Tensor     # f32 [B, N] raw
    det_boxes: torch.Tensor      # f32 [B, N, 4] cxcywh normalized
    mask_logits: torch.Tensor    # f32 [B, 4h, 4w] low-res seg logits
    loc_valid: torch.Tensor      # bool [B]: a [LOC] was generated
    # decoder forwards after the prefill (DecodeResult.n_forwards; the
    # port's addition: JAX's VSMOutput does not carry it)
    n_forwards: int = 0


def vsm_generate(params: Dict, cfg: VSMConfig, images_clip: torch.Tensor,
                 images_owl: torch.Tensor, text_ids: torch.Tensor,
                 feat_idx: torch.Tensor, is_feat: torch.Tensor,
                 lens: torch.Tensor, *, graphs: DecodeGraphs,
                 loc_token_id: int,
                 max_new_tokens: int = 100, eos_id: int = 2,
                 cache_len: int = 768,
                 compute_dtype=torch.bfloat16,
                 draft_ids: Optional[torch.Tensor] = None,
                 spec_chunk: int = 8,
                 trace: Optional[List] = None,
                 replay_trace: Optional[List] = None,
                 kv_int8: bool = False) -> VSMOutput:
    """Prefill, decode with hidden capture, [LOC] selection, then the
    detection and segmentation heads (vstar_tpu vsm_generate). Without a
    generated [LOC] the heads still run, on the hidden state of generated
    position 0, and loc_valid is False.

    draft_ids (optional [B, max_new_tokens + spec_chunk]): decode with the
    greedy-equivalent speculative verifier against this draft
    (decode/speculative.py); the search answers are templated ("Sure,
    [LOC].</s>"), so a template draft turns ~7 decode steps into ~2
    verify chunks. The cache then needs spec_chunk entries of room.
    trace: the decoders' logits trace (decode/sampler.greedy_decode).
    graphs: the engine's DecodeGraphs: the prefill fills one of its
    static caches, and on the card the decode replays its captured
    steps;
    replay_trace: the decode's logits trace taken during the replay.
    kv_int8: an int8 KV cache with per-(token, head) scales
    (nn/llama.KVCache)."""
    B, S = text_ids.shape
    dev = text_ids.device
    bank = encode_clip_bank(params, cfg, images_clip).to(compute_dtype)
    h = apply_splice(embed_tokens(params["llama"], text_ids, compute_dtype),
                     bank, feat_idx, is_feat)
    pos = torch.arange(S, device=dev)[None].expand(B, S)
    cache = graphs.cache(cfg.llama, B, cache_len, compute_dtype, dev,
                         kv_int8=kv_int8,
                         heads=kv_heads(params["llama"], cfg.llama))
    hidden, cache = llama_forward(
        params["llama"], cfg.llama, h, pos, lens,
        q_offsets=torch.zeros((B,), dtype=torch.int32, device=dev),
        cache=cache)
    last_hidden = hidden[torch.arange(B, device=dev), lens.long() - 1]
    last_logits = lm_logits(params["llama"], last_hidden[:, None])[:, 0]
    if draft_ids is not None:
        res = speculative_decode(params["llama"], cfg.llama, cache,
                                 last_logits, last_hidden, draft_ids,
                                 max_new_tokens, [eos_id], spec_chunk,
                                 compute_dtype, trace=trace, graphs=graphs,
                                 replay_trace=replay_trace)
    else:
        res = greedy_decode(params["llama"], cfg.llama, cache, last_logits,
                            last_hidden, max_new_tokens, [eos_id],
                            compute_dtype, trace=trace, graphs=graphs,
                            replay_trace=replay_trace)

    pos_ids = torch.arange(max_new_tokens, device=dev)[None]
    is_loc = (res.tokens == loc_token_id) & (pos_ids
                                             < res.num_generated[:, None])
    loc_valid = is_loc.any(dim=1)
    first_loc = is_loc.to(torch.uint8).argmax(dim=1)
    last_loc = (max_new_tokens - 1
                - is_loc.flip(1).to(torch.uint8).argmax(dim=1))
    zero = torch.zeros_like(first_loc)
    first_loc = torch.where(loc_valid, first_loc, zero)
    last_loc = torch.where(loc_valid, last_loc, zero)
    rows = torch.arange(B, device=dev)
    loc_hidden_det = res.hiddens[rows, first_loc].to(compute_dtype)
    loc_hidden_seg = res.hiddens[rows, last_loc].to(compute_dtype)

    fmap = owl_features(params, cfg, images_owl).to(compute_dtype)
    det_logits, det_boxes = vsm_detection(params, cfg, fmap, loc_hidden_det)
    mask_logits = vsm_segmentation(params, cfg, fmap, loc_hidden_seg)
    return VSMOutput(tokens=res.tokens, num_generated=res.num_generated,
                     det_logits=det_logits.float(),
                     det_boxes=det_boxes.float(),
                     mask_logits=mask_logits.float(), loc_valid=loc_valid,
                     n_forwards=res.n_forwards)
