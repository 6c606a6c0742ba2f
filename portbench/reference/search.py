"""SEAL's visual search worked out again for the reference, in the branch
the benchmark's mix forces: best-first over a quadtree of patches
(visual_search.py:227-516), every detection kept as a stash and none
accepted (`confidence_high` above any sigmoid score), the target cue's
heatmap always above its threshold, `max_steps` steps, then the best
stashed detection if any, whose box goes back to the image's frame.

`walk` follows one search of the program. The reference's own detection
on each patch the program visited gives that step's heatmap, the
children's ancestor-accumulated scores and the stash; the patch the
reference would visit next is compared with the one the program
visited, and the walk goes on along the program's path, so that one
difference is counted once. Plain numpy and PyTorch; nothing of the
program.
"""

from __future__ import annotations

import heapq
import itertools
import math
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F


def smallest_size(w: int, h: int, scale: float = 4.0,
                  minimum: int = 224) -> int:
    """The patch size at which a search stops expanding
    (vstar_bench_eval.py:207-210)."""
    return max(int(math.ceil(min(w, h) / scale)), minimum)


def expected_steps(w: int, h: int, steps: int) -> int:
    """Detect steps a forced search of a w x h image runs: one where the
    whole image is at or under its smallest size (nothing to expand),
    else `steps` (an expanded root leaves four children, and each later
    step takes one: the heap cannot run dry before step 5)."""
    assert steps <= 5
    return 1 if min(w, h) <= smallest_size(w, h) else steps


def split(bbox) -> tuple:
    ratio = bbox[3] / bbox[2]
    if ratio >= 2:
        return 1, 4
    if ratio <= 0.5:
        return 4, 1
    return 2, 2


def children(bbox) -> List[List[int]]:
    """The sub-patches [x, y, w, h] of a patch, row by row; the last of a
    row or column takes the remainder."""
    nw, nh = split(bbox)
    sw, sh = int(bbox[2] // nw), int(bbox[3] / nh)
    out = []
    for j in range(nh):
        for i in range(nw):
            w = bbox[2] - i * sw if i == nw - 1 else sw
            h = bbox[3] - j * sh if j == nh - 1 else sh
            out.append([bbox[0] + i * sw, bbox[1] + j * sh, w, h])
    return out


def shares(heat: np.ndarray, bbox, subs) -> List[float]:
    """Each sub-patch's share of the heatmap's mass over `bbox`."""
    total = float(heat.sum(dtype=np.float64))
    out = []
    for sp in subs:
        x, y = sp[0] - bbox[0], sp[1] - bbox[1]
        s = float(heat[y:y + sp[3], x:x + sp[2]].sum(dtype=np.float64))
        out.append(s / total if total > 0 else 0.0)
    return out


def heatmap(mask_low: torch.Tensor, h: int, w: int, found: bool
            ) -> np.ndarray:
    """SAM's low-res mask logits at the patch's size (bilinear, half-pixel
    centres), clamped at 0; zeros where the VSM decoded no [LOC]."""
    if not found:
        return np.zeros((h, w), np.float32)
    up = F.interpolate(mask_low.float()[None, None], size=(h, w),
                       mode="bilinear", align_corners=False)[0, 0]
    return up.clamp_min(0.0).cpu().numpy()


def unit(h: np.ndarray) -> np.ndarray:
    lo, hi = float(h.min()), float(h.max())
    return (h - lo) / (hi - lo) if hi != lo else h * 0


def patch_box(boxes: np.ndarray, scores: np.ndarray, w: int, h: int):
    """(top score, [x, y, w, h] in the patch's pixels) of the best box."""
    top = int(np.argmax(scores))
    b = np.asarray(boxes[top], np.float64) * np.array([w, h, w, h])
    b[:2] -= b[2:] / 2
    return float(scores[top]), b


def walk(bboxes: Sequence[Sequence[int]], detect: Callable,
         image_size, steps: int, forced: Dict) -> Dict:
    """The reference's search along the program's visited `bboxes`.

    detect(k) -> (found, det_logits [N], det_boxes [N, 4] cxcywh in the
    patch, mask logits [h, w] low-res): the reference's outputs on the
    program's k-th patch. Returns {'mismatch': differences counted,
    'box': the final box [x, y, w, h] in the image (None where nothing
    was stashed), 'final': the index of its step, 'margin': the least
    relative gap between the chosen patch's score and the next
    candidate's, at the choices where the best score is above 0 (inf if
    none)}."""
    W, H = image_size
    small = smallest_size(W, H)
    high = forced["confidence_high"]
    cue = forced["target_cue_threshold"]
    cue_min = forced["target_cue_threshold_minimum"]
    decay = forced.get("target_cue_threshold_decay", 0.7)
    counter = itertools.count()
    heap: list = []
    path: List[Dict] = []
    step = {"bbox": [0, 0, W, H], "level": 1, "parent": -1}
    mismatch, margin = 0, math.inf
    k = 0
    while True:
        if k >= len(bboxes):
            mismatch += 1                   # the program stopped early
            break
        want = [int(v) for v in bboxes[k]]
        if want != step["bbox"]:
            mismatch += 1
            # go on along the program's path where it took a candidate
            hit = [e for e in heap if e[2]["bbox"] == want]
            if not hit:
                break
            heap.remove(hit[0])
            heapq.heapify(heap)
            step = hit[0][2]
        path.append(step)
        bx = step["bbox"]
        found, logits, boxes, mask = detect(k)
        scores = 1.0 / (1.0 + np.exp(-np.asarray(logits, np.float64)))
        if found and len(scores):
            top, box = patch_box(boxes, scores, bx[2], bx[3])
            if top > high:
                mismatch += 1               # the forced policy accepts none
                break
            step["stash"] = (top, box)
        k += 1
        if min(bx[2], bx[3]) > small:
            heat = heatmap(mask, bx[3], bx[2], found)
            if not float(heat.max()) > max(
                    cue_min, cue * decay ** (step["level"] - 1)):
                mismatch += 1               # the context cue would run
                break
            step["heat"] = unit(heat)
            subs = children(bx)
            acc = [0.0] * len(subs)
            node = step
            while True:
                sc = shares(node["heat"], node["bbox"], subs)
                acc = [a + s / 4 ** node["level"] for a, s in zip(acc, sc)]
                if node["parent"] == -1:
                    break
                node = path[node["parent"]]
            here = len(path) - 1
            for sub, sc in zip(subs, acc):
                heapq.heappush(heap, (-sc, next(counter),
                                      {"bbox": sub, "level": step["level"] + 1,
                                       "parent": here}))
        if not heap or len(path) >= steps:
            break
        best, _, step = heapq.heappop(heap)
        if heap and -best > 0:
            margin = min(margin, (heap[0][0] - best) / -best)
    mismatch += max(0, len(bboxes) - k)     # steps past the reference's end
    best, final = 0.0, None
    for i, s in enumerate(path):
        if "stash" in s and s["stash"][0] > best:
            best, final = s["stash"][0], i
    box = None
    if final is not None:
        box = path[final]["stash"][1].copy()
        box[:2] += path[final]["bbox"][:2]
    return {"mismatch": mismatch, "box": box, "final": final,
            "margin": margin}
