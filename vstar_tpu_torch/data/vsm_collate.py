"""VSM training collator: per-row samples -> static-shape batch (copy of
vstar_tpu/data/vsm_collate.py, plus `batch_to_torch`).

The reference collate (VisualSearch/utils/dataset.py:30-180) pads to the
longest row and groups rows per image with an offset vector. Here every
row carries its own (host-repeated) image tensors, sequences
are padded to a bucket, targets to T_max, masks to a fixed resolution —
one static batch shape feeding train/vsm_train.vsm_loss.

Semantics preserved: <im_start><image><im_end> token wrapping, instruction
label masking, [LOC] attention masking when bbox labels are invalid
(dataset.py:98-103), and the model_max_length-255 truncation
(dataset.py:154-160) via the sequence bucket.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..multimodal.constants import (DEFAULT_IM_END_TOKEN,
                                    DEFAULT_IM_START_TOKEN,
                                    DEFAULT_IMAGE_TOKEN, IGNORE_INDEX)
from .label_masking import preprocess_v1
from .preprocess import resize_bilinear_torch


@dataclasses.dataclass
class VSMRow:
    """One conversation row (one [LOC])."""

    image_clip: np.ndarray      # [224,224,3] f32 (preprocessed)
    image_owl: np.ndarray       # [768,768,3] f32
    source: List[Dict]          # [{'from','value'}, ...] with <image>
    gt_mask: Optional[np.ndarray]       # [H,W] {0,1} or None
    mask_valid: bool
    tgt_boxes: np.ndarray       # [n,4] cxcywh normalized
    bboxes_valid: bool


def _wrap_image_token(text: str, use_mm_start_end: bool) -> str:
    if not use_mm_start_end:
        return text
    return text.replace(
        DEFAULT_IMAGE_TOKEN,
        DEFAULT_IM_START_TOKEN + DEFAULT_IMAGE_TOKEN + DEFAULT_IM_END_TOKEN)


def collate_vsm_rows(rows: Sequence[VSMRow], tokenizer, loc_token_id: int,
                     n_image_tokens: int = 256, seq_bucket: int = 512,
                     t_max: int = 64, mask_res: int = 768,
                     use_mm_start_end: bool = True) -> Dict[str, np.ndarray]:
    """-> numpy batch matching train/vsm_train.vsm_loss's contract."""
    from ..multimodal.splicing import build_layout

    B = len(rows)
    text_ids = np.zeros((B, seq_bucket), np.int32)
    feat_idx = np.zeros((B, seq_bucket), np.int32)
    is_feat = np.zeros((B, seq_bucket), bool)
    labels = np.full((B, seq_bucket), IGNORE_INDEX, np.int32)
    kv_valid = np.zeros((B, seq_bucket), bool)
    lens = np.zeros((B,), np.int32)
    loc_pos = np.zeros((B,), np.int32)

    images_clip = np.stack([r.image_clip for r in rows])
    images_owl = np.stack([r.image_owl for r in rows])

    gt_masks = np.zeros((B, mask_res, mask_res), np.float32)
    masks_valid = np.zeros((B,), bool)
    tgt_boxes = np.zeros((B, t_max, 4), np.float32)
    tgt_valid = np.zeros((B, t_max), bool)
    bboxes_valid = np.zeros((B,), bool)

    for b, row in enumerate(rows):
        src = [{"from": s["from"],
                "value": _wrap_image_token(s["value"], use_mm_start_end)}
               for s in row.source]
        enc = preprocess_v1(src, tokenizer, has_image=True)
        ids, labs = enc["input_ids"].tolist(), enc["labels"].tolist()
        lay = build_layout(ids, seq_bucket, n_long=n_image_tokens, n_short=0,
                           image_long=True, labels=labs)
        text_ids[b] = lay.text_ids
        feat_idx[b] = lay.feat_idx
        is_feat[b] = lay.is_feat
        labels[b] = lay.labels
        lens[b] = lay.length
        kv_valid[b, :lay.length] = True

        # [LOC] handling in expanded coordinates.
        loc_mask = (lay.text_ids == loc_token_id) & ~lay.is_feat
        loc_mask[lay.length:] = False
        where = np.nonzero(loc_mask)[0]
        if len(where) > 0:
            loc_pos[b] = max(int(where[0]) - 1, 0)  # hidden before [LOC]
        if not row.bboxes_valid:
            kv_valid[b] &= ~loc_mask  # mask invalid [LOC] keys

        if row.gt_mask is not None and row.mask_valid:
            gt_masks[b] = (resize_bilinear_torch(
                row.gt_mask.astype(np.float32), mask_res, mask_res)
                > 0.5).astype(np.float32)
            masks_valid[b] = True
        n = min(len(row.tgt_boxes), t_max)
        if n > 0:
            tgt_boxes[b, :n] = row.tgt_boxes[:n]
            tgt_valid[b, :n] = True
        bboxes_valid[b] = row.bboxes_valid

    return {
        "images_clip": images_clip, "images_owl": images_owl,
        "text_ids": text_ids, "feat_idx": feat_idx, "is_feat": is_feat,
        "lens": lens, "labels": labels, "kv_valid": kv_valid,
        "loc_hidden_pos": loc_pos, "gt_masks": gt_masks,
        "masks_valid": masks_valid, "tgt_boxes": tgt_boxes,
        "tgt_valid": tgt_valid, "bboxes_valid": bboxes_valid,
    }


def batch_to_torch(batch: Dict[str, np.ndarray], device) -> Dict[str,
                                                                torch.Tensor]:
    """A collated numpy batch as tensors on `device` (dtypes kept)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}
