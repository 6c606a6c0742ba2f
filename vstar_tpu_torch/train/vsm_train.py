"""VSM training step: CE + mask (BCE+dice) + detection (DETR) losses
(port of vstar_tpu/train/vsm_train.py).

The reference's DeepSpeed loop (VisualSearch/train.py:123-567 +
VSM.py:201-436) as one step over static shapes (one [LOC] per row,
targets padded to T_max, ground-truth masks at a fixed resolution): LoRA
on the q/v projections, the reference's trainable set, gradient
accumulation over micro-batches, AdamW with the warmup-decay schedule
and optional f32 masters. The frozen CLIP and OWL towers run under
no_grad (JAX stops gradients at their parameters); the decoder layers
are recomputed in the backward (remat).

Loss weights (train.py:74-77 defaults): ce 1.0, dice 0.5, bce 2.0,
det 0.1; inner DETR weights 2/5/2.

On a tree sharded over a mesh (core/mesh.py) each data x fsdp rank
takes its rows of the step's batch (the ranks of a model group the same
rows), and every normaliser is the whole batch's, summed over those
ranks: the CE's valid tokens, the valid masks, the valid boxes and the
rows of the detection CE's batch mean (the matching is per row). A
rank's loss and metrics are its shares of the one-device ones. On a
model axis above 1 the decoder is tensor-parallel and the frozen towers
run on their model split (train/sft.sharded_for_loss).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.config import VSMConfig
from ..core.mesh import (local_leaves, mesh_of, model_local_leaves,
                         unshard)
from ..core.params import leaves_with_path
from ..models.vsm import (encode_clip_bank, owl_tower_states, vsm_detection,
                          vsm_segmentation)
from ..multimodal.splicing import apply_splice
from ..nn.llama import embed_tokens, llama_forward
from ..nn.vit import owl_merge
from . import optim
from .accumulate import accumulated_grads
from .detr_loss import detection_loss
from .master import with_f32_master
from .sft import apply_step, next_token_logprobs, sharded_for_loss


@dataclasses.dataclass(frozen=True)
class VSMLossWeights:
    ce: float = 1.0
    dice: float = 0.5
    bce: float = 2.0
    det: float = 0.1


class VSMTrainState(NamedTuple):
    params: Dict
    opt_state: Any
    step: int


def make_vsm_optimizer(lr: float = 1e-4, warmup_steps: int = 100,
                       total_steps: int = 100000, grad_clip: float = 1.0,
                       trainable_mask=None, master_f32: bool = False
                       ) -> optim.Transformation:
    """AdamW b=(0.9, 0.95) + WarmupDecayLR, matching train.py:282-318, on
    flat parameter dicts (core/params.leaves_with_path).

    trainable_mask: bool tree; AdamW state (and f32 masters) exist ONLY
    for trainable leaves, as optax.masked gives.
    master_f32: f32 master weights for bf16 storage (train/master.py)."""
    schedule = optim.join_schedules(
        [optim.linear_schedule(0.0, lr, warmup_steps),
         optim.linear_schedule(lr, 0.0, max(total_steps - warmup_steps, 1))],
        [warmup_steps])
    adamw = optim.adamw(schedule, b1=0.9, b2=0.95)
    if master_f32:
        adamw = with_f32_master(adamw)
    if trainable_mask is not None:
        adamw = optim.masked(adamw, dict(leaves_with_path(trainable_mask)))
    return optim.chain(optim.clip_by_global_norm(grad_clip), adamw)


def init_train_state(params: Dict, optimizer: optim.Transformation
                     ) -> VSMTrainState:
    """Optimizer state on the leaves (this rank's shards on a sharded
    tree)."""
    return VSMTrainState(params, optimizer.init(local_leaves(dict(
        leaves_with_path(params)))), 0)


def _owl_feature_map_trainable_ln(params: Dict, cfg: VSMConfig,
                                  images_owl: torch.Tensor) -> torch.Tensor:
    """OWL feature map with the tower frozen but the merge layer_norm
    trainable (train.py:236-245 keeps owlvit.layer_norm in the trainable
    set while the vision tower is frozen). The tower runs under no_grad,
    so its attention takes the forward-only kernel K2."""
    with torch.no_grad():
        feats = owl_tower_states(params, cfg, images_owl)
    return owl_merge(params["owl_merge_ln"], cfg.owl_vision, feats)


def _upscale_masks(masks: torch.Tensor, out_hw: Tuple[int, int]
                   ) -> torch.Tensor:
    """Bilinear upsample [B,h,w] -> [B,H,W] in f32 (pred upsampled to the
    ground truth's resolution, as in VSM.py:340-342)."""
    return F.interpolate(masks.float()[:, None], size=tuple(out_hw),
                         mode="bilinear", align_corners=False)[:, 0]


def _loc_hidden(hidden, batch, compute_dtype):
    rows = torch.arange(hidden.shape[0], device=hidden.device)
    return hidden[rows, batch["loc_hidden_pos"].long()].to(compute_dtype)


def _decoder_hidden(params, cfg, batch, compute_dtype, remat):
    """CLIP bank (frozen tower + projector, no grad), splice, decoder."""
    with torch.no_grad():
        bank = encode_clip_bank(params, cfg, batch["images_clip"]).to(
            compute_dtype)
    tok = embed_tokens(params["llama"], batch["text_ids"], compute_dtype)
    h = apply_splice(tok, bank, batch["feat_idx"], batch["is_feat"])
    B, S = batch["text_ids"].shape
    pos = torch.arange(S, device=h.device)[None].expand(B, S)
    hidden, _ = llama_forward(params["llama"], cfg.llama, h, pos,
                              batch["lens"], kv_valid=batch["kv_valid"],
                              remat=remat)
    return hidden


def vsm_loss(params: Dict, cfg: VSMConfig, batch: Dict,
             weights: VSMLossWeights = VSMLossWeights(),
             compute_dtype=torch.bfloat16
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One row = one conversation with exactly one [LOC].

    batch (tensors on the parameters' device, data/vsm_collate):
      images_clip [B,224,224,3], images_owl [B,768,768,3]
      text_ids/feat_idx/is_feat [B,S], lens [B], labels [B,S]
      kv_valid [B,S] bool   (False at invalid [LOC] + padding)
      loc_hidden_pos [B]    position of the hidden state driving the heads
      gt_masks [B,Hm,Wm] float {0,1}, masks_valid [B] bool
      tgt_boxes [B,T,4] cxcywh, tgt_valid [B,T], bboxes_valid [B]
    On a sharded tree the batch is this rank's rows, and the loss and
    metrics its shares of the whole batch's.
    """
    mesh = mesh_of(params)
    total = (lambda x: x) if mesh is None else mesh.batch_sum
    params, vocab = sharded_for_loss(params)
    hidden = _decoder_hidden(params, cfg, batch, compute_dtype, remat=True)

    # --- CE (shifted, IGNORE-masked) ---
    tok_lp, valid = next_token_logprobs(params["llama"], hidden,
                                        batch["labels"], vocab)
    ce_loss = -(tok_lp * valid).sum() / torch.clamp(total(valid.sum()),
                                                    min=1)

    # --- [LOC] hidden -> heads ---
    loc_hidden = _loc_hidden(hidden, batch, compute_dtype)
    fmap = _owl_feature_map_trainable_ln(params, cfg, batch["images_owl"])
    fmap = fmap.to(compute_dtype)

    # --- segmentation (BCE + dice; VSM.py:14-56,402-422) ---
    mask_logits = vsm_segmentation(params, cfg, fmap, loc_hidden)
    gt = batch["gt_masks"].float()
    B = gt.shape[0]
    pred = _upscale_masks(mask_logits, gt.shape[1:3])
    mv = batch["masks_valid"].float()
    n_masks = torch.clamp(total(mv.sum()), min=1e-8)

    bce_el = (torch.clamp(pred, min=0) - pred * gt
              + torch.log1p(torch.exp(-pred.abs())))
    bce_per = bce_el.reshape(B, -1).mean(dim=1)
    mask_bce = (bce_per * mv).sum() / n_masks

    scale = 1000.0
    p_sig = torch.sigmoid(pred).reshape(B, -1)
    g_flat = gt.reshape(B, -1)
    num = 2 * (p_sig / scale * g_flat).sum(-1)
    den = (p_sig / scale).sum(-1) + (g_flat / scale).sum(-1)
    dice_per = 1 - (num + 1e-6) / (den + 1e-6)
    mask_dice = (dice_per * mv).sum() / n_masks

    # --- detection (DETR losses on the grid's candidates) ---
    det_logits, det_boxes = vsm_detection(params, cfg, fmap, loc_hidden)
    det_total, det_parts = detection_loss(
        det_logits[..., None].float(), det_boxes.float(),
        batch["tgt_boxes"], batch["tgt_valid"], batch["bboxes_valid"],
        total=None if mesh is None else total)

    total = (weights.ce * ce_loss
             + weights.bce * mask_bce + weights.dice * mask_dice
             + weights.det * det_total)
    metrics = {"loss": total, "ce_loss": ce_loss,
               "mask_bce_loss": weights.bce * mask_bce,
               "mask_dice_loss": weights.dice * mask_dice,
               "detection_loss": weights.det * det_total,
               "detection_loss_ce": det_parts["loss_ce"],
               "detection_loss_bbox": det_parts["loss_bbox"],
               "detection_loss_giou": det_parts["loss_giou"]}
    return total, metrics


@torch.no_grad()
def vsm_val_forward(params: Dict, cfg: VSMConfig, batch: Dict,
                    compute_dtype=torch.bfloat16):
    """Validation forward: [LOC]-driven head outputs for metric computation
    (train.py:570-644). Returns (mask_logits [B,h,w], det_logits [B,Q],
    det_boxes [B,Q,4]) in f32. A sharded tree is gathered as it is
    used (the towers' model split kept); every rank computes the whole
    batch."""
    params = unshard(params, model_local=model_local_leaves(params))
    hidden = _decoder_hidden(params, cfg, batch, compute_dtype, remat=False)
    loc_hidden = _loc_hidden(hidden, batch, compute_dtype)
    fmap = _owl_feature_map_trainable_ln(params, cfg, batch["images_owl"])
    fmap = fmap.to(compute_dtype)
    mask_logits = vsm_segmentation(params, cfg, fmap, loc_hidden)
    det_logits, det_boxes = vsm_detection(params, cfg, fmap, loc_hidden)
    return mask_logits.float(), det_logits.float(), det_boxes.float()


def vsm_train_step(state: VSMTrainState, batch: Dict, cfg: VSMConfig,
                   optimizer: optim.Transformation,
                   trainable_mask: Optional[Dict] = None,
                   weights: VSMLossWeights = VSMLossWeights(),
                   compute_dtype=torch.bfloat16, grad_accum: int = 1
                   ) -> Tuple[VSMTrainState, Dict[str, torch.Tensor]]:
    """One optimizer step over `batch` (grad_accum micro-batches). Only
    the trainable leaves get gradients (JAX zeroes the others); the new
    state shares every frozen leaf with the old one. On a sharded tree
    every rank passes the same whole batch and takes its rows; the
    metrics are the whole batch's on every rank."""
    mesh = mesh_of(state.params)
    if mesh is not None:
        batch = mesh.local_rows(batch, grad_accum)
    loss, metrics, grads = accumulated_grads(
        lambda p, b: vsm_loss(p, cfg, b, weights, compute_dtype),
        state.params, batch, grad_accum, has_aux=True,
        trainable=trainable_mask)
    if mesh is not None:
        metrics = {k: mesh.batch_sum(v) for k, v in metrics.items()}
    metrics["grad_norm"] = optim.global_norm(grads, local_leaves(dict(
        leaves_with_path(state.params))))
    new_params, new_opt = apply_step(state.params, grads, state.opt_state,
                                     optimizer)
    return VSMTrainState(new_params, new_opt, state.step + 1), metrics
