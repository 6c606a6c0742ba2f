"""DETR-style detection criterion with Hungarian matching, static shapes
(port of vstar_tpu/train/detr_loss.py).

Reimplements the reference SetCriterion + HungarianMatcher
(VisualSearch/model/owlvit/owlvit.py:173-358, matcher.py:52-103):
targets padded to a static T_max with validity masks, costs built on the
device, the assignment solved on the device by the auction algorithm
(train/auction.py) or, with method="callback", exactly on the host (the
native JV solver, scipy as the fallback), as the reference solves it on
the CPU every step. Matching runs without grad. Padded target columns
carry a constant large cost, which cannot change the optimum over valid
columns.

Deviation from the reference, intentional and kept from the JAX package:
the reference's giou masking multiplies a [K] loss by a [K,1] mask
(VSM.py:391), broadcasting to [K,K]; here the intended per-box masking
is used.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

PAD_COST = 1e6


def box_cxcywh_to_xyxy(x: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = x.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w,
                        cy + 0.5 * h], dim=-1)


def generalized_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor
                        ) -> torch.Tensor:
    """Pairwise GIoU for xyxy boxes: [..., N, 4], [..., M, 4] -> [..., N, M]
    (box_ops.py:50-71), with safe divides for padded/degenerate boxes."""
    area1 = (boxes1[..., 2] - boxes1[..., 0]) * (boxes1[..., 3] - boxes1[..., 1])
    area2 = (boxes2[..., 2] - boxes2[..., 0]) * (boxes2[..., 3] - boxes2[..., 1])
    b1, b2 = boxes1[..., :, None, :], boxes2[..., None, :, :]
    wh = (torch.minimum(b1[..., 2:], b2[..., 2:])
          - torch.maximum(b1[..., :2], b2[..., :2])).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    iou = inter / torch.clamp(union, min=1e-9)
    wh2 = (torch.maximum(b1[..., 2:], b2[..., 2:])
           - torch.minimum(b1[..., :2], b2[..., :2])).clamp(min=0)
    hull = wh2[..., 0] * wh2[..., 1]
    return iou - (hull - union) / torch.clamp(hull, min=1e-9)


def _focal_costs(prob: torch.Tensor, alpha=0.25, gamma=2.0):
    neg = (1 - alpha) * prob ** gamma * (-torch.log(1 - prob + 1e-8))
    pos = alpha * (1 - prob) ** gamma * (-torch.log(prob + 1e-8))
    return pos, neg


def match_cost(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
               tgt_boxes: torch.Tensor, tgt_valid: torch.Tensor,
               cost_class=2.0, cost_bbox=5.0, cost_giou=2.0) -> torch.Tensor:
    """Cost matrices [B, Q, T_max] (matcher.py:83-98; single class); the
    JAX function is the same for one row, vmapped."""
    prob = torch.sigmoid(pred_logits[..., 0].float())          # [B, Q]
    pos, neg = _focal_costs(prob)
    c_class = (pos - neg)[..., None]
    c_bbox = (pred_boxes[..., :, None, :].float()
              - tgt_boxes[..., None, :, :].float()).abs().sum(-1)
    c_giou = -generalized_box_iou(box_cxcywh_to_xyxy(pred_boxes),
                                  box_cxcywh_to_xyxy(tgt_boxes))
    C = cost_bbox * c_bbox + cost_class * c_class + cost_giou * c_giou
    return torch.where(tgt_valid[..., None, :], C,
                       torch.full_like(C, PAD_COST))


def _solve_assignment_host(cost: np.ndarray, n_valid: np.ndarray
                           ) -> np.ndarray:
    """[B,Q,T] costs -> matched query per target [B,T], on the host: the
    native C++ JV solver when built, else scipy."""
    from ..native import hungarian_native
    B, Q, T = cost.shape
    out = np.zeros((B, T), np.int64)
    for b in range(B):
        n = int(n_valid[b])
        if n == 0:
            continue
        native = hungarian_native(cost[b, :, :n])
        if native is not None:
            out[b, :n] = native
            continue
        from scipy.optimize import linear_sum_assignment
        rows, cols = linear_sum_assignment(cost[b, :, :n])
        out[b, cols] = rows
    return out


def hungarian_match(cost: torch.Tensor, tgt_valid: torch.Tensor,
                    method: str = "auction") -> torch.Tensor:
    """[B,Q,T] costs + [B,T] validity -> matched query index per target
    [B,T] int64 (undefined where invalid). method "auction" solves on the
    device; "callback" exactly on the host."""
    if method == "auction":
        from .auction import auction_match
        return auction_match(cost, tgt_valid)
    n_valid = tgt_valid.sum(dim=1).cpu().numpy()
    host = cost.detach().float().cpu().numpy()
    return torch.from_numpy(_solve_assignment_host(host, n_valid)).to(
        cost.device)


def optax_sigmoid_ce(logits, labels):
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def detection_criterion(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                        tgt_boxes: torch.Tensor, tgt_valid: torch.Tensor,
                        sample_valid: torch.Tensor,
                        focal_alpha: float = 0.25,
                        match_method: str = "auction", total=None
                        ) -> Dict[str, torch.Tensor]:
    """Full detection loss (owlvit.py:195-254 + VSM.py:366-395 masking).

    pred_logits: [B, Q, 1]; pred_boxes: [B, Q, 4] cxcywh
    tgt_boxes:   [B, T, 4] cxcywh (padded); tgt_valid: [B, T] bool
    sample_valid:[B] bool — rows whose bbox labels are real
    total:       None, or the sum over ranks of a count when the rows are
                 one rank's share of a sharded batch (core/mesh.Mesh.
                 batch_sum): the box count and the batch mean are then
                 the whole batch's, the matching stays per row
    Returns {'loss_ce','loss_bbox','loss_giou'} scalars (already masked and
    normalized; the caller combines them with weights 2/5/2)."""
    B, Q, _ = pred_logits.shape
    tgt_valid = tgt_valid.bool() & sample_valid.bool()[:, None]
    n_valid = tgt_valid.sum().float()
    num_boxes = torch.clamp(n_valid if total is None else total(n_valid),
                            min=1.0)

    with torch.no_grad():
        cost = match_cost(pred_logits, pred_boxes, tgt_boxes, tgt_valid)
        match_q = hungarian_match(cost, tgt_valid, match_method)   # [B, T]

    # --- classification (focal over one class) ---
    valid_f = tgt_valid.float()
    onehot = torch.zeros((B, Q), dtype=torch.float32,
                         device=pred_logits.device)
    onehot = onehot.scatter_add(1, match_q, valid_f).clamp(0, 1)
    logits = pred_logits[..., 0].float()
    prob = torch.sigmoid(logits)
    ce = optax_sigmoid_ce(logits, onehot)
    p_t = prob * onehot + (1 - prob) * (1 - onehot)
    focal = ce * (1 - p_t) ** 2.0
    alpha_t = focal_alpha * onehot + (1 - focal_alpha) * (1 - onehot)
    focal = alpha_t * focal
    # reference: mean over queries, *Q, /num_boxes; per-sample then masked
    # by bboxes_valid and batch-meaned (VSM.py:389)
    loss_ce_per = focal.mean(dim=1) * Q / num_boxes
    if total is None:
        loss_ce = (loss_ce_per * sample_valid.float()).mean()
    else:
        rows = total(torch.tensor(B, dtype=torch.float32,
                                  device=pred_logits.device))
        loss_ce = (loss_ce_per * sample_valid.float()).sum() / rows

    # --- box losses over matched pairs ---
    matched = torch.gather(pred_boxes, 1,
                           match_q[..., None].expand(-1, -1, 4))  # [B, T, 4]
    l1 = (matched.float() - tgt_boxes.float()).abs().sum(-1)
    loss_bbox = (l1 * valid_f).sum() / num_boxes
    giou = torch.diagonal(generalized_box_iou(box_cxcywh_to_xyxy(matched),
                                              box_cxcywh_to_xyxy(tgt_boxes)),
                          dim1=-2, dim2=-1)                       # [B, T]
    loss_giou = ((1.0 - giou) * valid_f).sum() / num_boxes

    return {"loss_ce": loss_ce, "loss_bbox": loss_bbox,
            "loss_giou": loss_giou}


def detection_loss(pred_logits, pred_boxes, tgt_boxes, tgt_valid,
                   sample_valid, weights=(2.0, 5.0, 2.0),
                   match_method: str = "auction", total=None) -> Tuple[
                       torch.Tensor, Dict[str, torch.Tensor]]:
    d = detection_criterion(pred_logits, pred_boxes, tgt_boxes, tgt_valid,
                            sample_valid, match_method=match_method,
                            total=total)
    total = (weights[0] * d["loss_ce"] + weights[1] * d["loss_bbox"]
             + weights[2] * d["loss_giou"])
    return total, d
