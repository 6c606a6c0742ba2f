"""Validation metrics for VSM training (port of
vstar_tpu/train/validate.py): gIoU / cIoU on masks and det-acc@IoU0.5,
mirroring VisualSearch/train.py:570-644 (which gates best-checkpoint
selection on det-acc). Metrics are reduced on the host; under a mesh
every rank validates the whole set and reaches the same numbers.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np

from ..core.config import VSMConfig
from ..data.preprocess import resize_bilinear_torch
from ..utils.metrics import AverageMeter


def _cxcywh_to_xyxy(box: np.ndarray) -> np.ndarray:
    cx, cy, w, h = box
    return np.asarray([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w,
                       cy + 0.5 * h], np.float32)


def mask_intersection_union(pred: np.ndarray, gt: np.ndarray,
                            thresh: float = 0.0) -> Tuple[float, float]:
    """pred: logits [H,W]; gt {0,1} [H,W] (intersectionAndUnionGPU
    semantics, utils/utils.py:112-124)."""
    p = (pred > thresh).astype(np.float32)
    inter = float((p * gt).sum())
    union = float(p.sum() + gt.sum() - inter)
    return inter, union


def det_top1_correct(det_logits: np.ndarray, det_boxes: np.ndarray,
                     gt_boxes_cxcywh: np.ndarray) -> bool:
    """Top-1 box IoU>0.5 against any gt (train.py:612-633)."""
    top = int(np.argmax(det_logits))
    pb = _cxcywh_to_xyxy(np.asarray(det_boxes[top], np.float32))
    for gt in gt_boxes_cxcywh:
        gb = _cxcywh_to_xyxy(np.asarray(gt, np.float32))
        x1, y1 = max(pb[0], gb[0]), max(pb[1], gb[1])
        x2, y2 = min(pb[2], gb[2]), min(pb[3], gb[3])
        inter = max(0.0, x2 - x1) * max(0.0, y2 - y1)
        a1 = (pb[2] - pb[0]) * (pb[3] - pb[1])
        a2 = (gb[2] - gb[0]) * (gb[3] - gb[1])
        if inter / max(a1 + a2 - inter, 1e-9) > 0.5:
            return True
    return False


def validate(params, cfg: VSMConfig, batches: Iterable[Dict],
             forward_fn) -> Dict[str, float]:
    """forward_fn(params, batch) -> (mask_logits [B,h,w], det_logits,
    det_boxes) per row; batches (numpy) carry gt_masks/masks_valid/
    tgt_boxes/tgt_valid. Returns {'giou', 'ciou', 'det_acc'}."""
    inter_m = AverageMeter("intersection")
    union_m = AverageMeter("union")
    giou_m = AverageMeter("giou")
    acc_m = AverageMeter("det_acc")

    for batch in batches:
        mask_logits, det_logits, det_boxes = (
            np.asarray(x.cpu()) for x in forward_fn(params, batch))
        for b in range(mask_logits.shape[0]):
            if bool(batch["masks_valid"][b]):
                gt = np.asarray(batch["gt_masks"][b])
                # compare at gt resolution
                pred = resize_bilinear_torch(mask_logits[b], gt.shape[0],
                                             gt.shape[1])
                i, u = mask_intersection_union(pred, gt)
                inter_m.update(i)
                union_m.update(u)
                giou_m.update(i / max(u, 1e-9))
            if bool(batch["bboxes_valid"][b]):
                gts = np.asarray(batch["tgt_boxes"][b])[
                    np.asarray(batch["tgt_valid"][b])]
                acc_m.update(float(det_top1_correct(det_logits[b],
                                                    det_boxes[b], gts)))

    ciou = inter_m.sum / max(union_m.sum, 1e-9)
    return {"giou": giou_m.avg, "ciou": ciou, "det_acc": acc_m.avg}
