"""Recursive priority-queue-guided visual search policy.

Exact reimplementation of the reference algorithm
(visual_search.py:227-516): best-first search over a quadtree of image
patches, guided by the VSM's target-cue heatmap with a common-sense
context-cue fallback, ancestor-accumulated sub-patch scoring, and a
low-confidence fallback over stashed detections.

The policy is pure host Python over numpy values and talks to the model
through the `VSMClient` protocol — tests drive it with a scripted oracle
(SURVEY.md §4b); production uses the VSM engine (search/engine.py).
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import List, Optional, Protocol, Tuple

import numpy as np


class VSMClient(Protocol):
    """Three inference modes of the VSM (visual_search.py:174-225)."""

    def detect(self, image, name: str):
        """-> (boxes [N,4] cxcywh normalized, logits [N] sigmoid,
        heatmap [h,w] float >= 0 at the patch's resolution)."""

    def vqa(self, image, question: str) -> str:
        ...

    def segment(self, image, phrase: str) -> np.ndarray:
        """-> heatmap [h,w] float >= 0."""


class PatchRef:
    """Lazy patch: source image + absolute pixel bbox [x, y, w, h] (the
    same integer math as PIL crop's ltrb). `pil()` performs the crop —
    the host-preprocessing path; device-preprocessing engines instead use
    `.bbox` against a device-resident copy of `.image` so patch pixels
    never round-trip through the host (SURVEY §7.6 fused image hot path).
    """

    __slots__ = ("image", "bbox", "_pil")

    def __init__(self, image, bbox):
        l, t = int(bbox[0]), int(bbox[1])
        r, b = int(bbox[0] + bbox[2]), int(bbox[1] + bbox[3])
        self.image = image
        self.bbox = [l, t, r - l, b - t]
        self._pil = None

    @property
    def width(self) -> int:
        return self.bbox[2]

    @property
    def height(self) -> int:
        return self.bbox[3]

    def pil(self):
        # memoized: one step can unwrap the same ref for its detect, vqa
        # and segment requests
        if self._pil is None:
            x0, y0, w, h = self.bbox
            self._pil = self.image.crop((x0, y0, x0 + w, y0 + h))
        return self._pil


def unwrap_patch(p):
    return p.pil() if isinstance(p, PatchRef) else p


@dataclasses.dataclass(eq=False)  # identity equality: steps live in a list
class SearchStep:
    bbox: List[int]               # [x, y, w, h] in original image pixels
    scale_level: int
    score: Optional[float]
    parent_index: int
    final_heatmap: Optional[np.ndarray] = None
    context_cue: Optional[str] = None
    detection_result: Optional[np.ndarray] = None     # [x,y,w,h] patch-local
    temp_detection_result: Optional[Tuple[float, np.ndarray]] = None


# ---------------------------------------------------------------------------
# Geometry helpers (visual_search.py:227-283)
# ---------------------------------------------------------------------------

def split_4subpatches(bbox) -> Tuple[int, int]:
    hw_ratio = bbox[3] / bbox[2]
    if hw_ratio >= 2:
        return 1, 4
    if hw_ratio <= 0.5:
        return 4, 1
    return 2, 2


def get_sub_patches(bbox, num_w: int, num_h: int):
    width_stride = int(bbox[2] // num_w)
    height_stride = int(bbox[3] / num_h)
    subs = []
    for j in range(num_h):
        for i in range(num_w):
            w = bbox[2] - i * width_stride if i == num_w - 1 else width_stride
            h = bbox[3] - j * height_stride if j == num_h - 1 else height_stride
            subs.append([bbox[0] + i * width_stride,
                         bbox[1] + j * height_stride, w, h])
    return subs, width_stride, height_stride


def get_subpatch_scores(score_heatmap: np.ndarray, bbox, sub_patches):
    area = bbox[2] * bbox[3]
    total = float((score_heatmap / area).sum())
    out = []
    for sp in sub_patches:
        x = sp[0] - bbox[0]
        y = sp[1] - bbox[1]
        s = float((score_heatmap[y:y + sp[3], x:x + sp[2]] / area).sum())
        out.append(s / total if total > 0 else 0.0)
    return out


def normalize_score(h: np.ndarray) -> np.ndarray:
    mx, mn = h.max(), h.min()
    if mx != mn:
        return (h - mn) / (mx - mn)
    return h * 0


def context_question(name: str) -> str:
    """The common-sense location question (visual_search.py:429-430)."""
    return ("According to the common sense knowledge and possible "
            "visual cues, what is the most likely location of the "
            f"{name} in the image?")


def context_phrase(vqa_answer: str, name: str) -> str:
    """Extract the location phrase to segment from the VSM's answer
    (visual_search.py:431-439): text after 'most likely to appear',
    stripped of the target name, reduced to its noun chunk when unique."""
    phrase = vqa_answer.split("most likely to appear")[-1].strip()
    if phrase.endswith("."):
        phrase = phrase[:-1]
    phrase = phrase.split(name)[-1]
    from .cues import extract_noun_chunks
    chunks = extract_noun_chunks(phrase)
    if len(chunks) == 1:
        return chunks[0]
    return f"region {phrase}"


def iou_xywh(b1, b2) -> float:
    x1 = max(b1[0], b2[0])
    y1 = max(b1[1], b2[1])
    x2 = min(b1[0] + b1[2], b2[0] + b2[2])
    y2 = min(b1[1] + b1[3], b2[1] + b2[3])
    inter = max(0, x2 - x1) * max(0, y2 - y1)
    return inter / (b1[2] * b1[3] + b2[2] * b2[3] - inter)


# ---------------------------------------------------------------------------
# The search
# ---------------------------------------------------------------------------

def _process_patch_gen(image, name: str, step: SearchStep,
                       search_path: List[SearchStep], heap, counter,
                       smallest_size, confidence_high, tct, tct_decay,
                       tct_min):
    """One expansion as a coroutine: yields ("detect"|"vqa"|"segment",
    patch, text) requests and receives their results via send(); returns
    (accepted, all_valid_boxes). Enables batching VSM calls across many
    concurrent searches (search/batched.py)."""
    bbox = step.bbox
    patch = PatchRef(image, bbox)
    question_name = name
    boxes, logits, heatmap = yield ("detect", patch, question_name)

    if len(logits) > 0:
        top = int(np.argmax(logits))
        top_logit = float(logits[top])
        scale = np.array([patch.width, patch.height,
                          patch.width, patch.height], np.float32)
        fb = np.asarray(boxes[top], np.float32) * scale
        fb[:2] -= fb[2:] / 2
        if top_logit > confidence_high:
            step.detection_result = fb
            if len(search_path) == 1:
                valid = np.asarray(boxes)[np.asarray(logits) > 0.5].reshape(
                    -1, 4) * scale[None]
                valid[:, :2] -= valid[:, 2:] / 2
                return True, valid
            return True, None
        step.temp_detection_result = (top_logit, fb)

    if min(bbox[2], bbox[3]) <= smallest_size:
        return False, None

    heatmap = np.asarray(heatmap, np.float32).reshape(bbox[3], bbox[2])
    score_max = float(heatmap.max())
    threshold = max(tct_min, tct * tct_decay ** (step.scale_level - 1))
    if score_max > threshold:
        step.final_heatmap = normalize_score(heatmap)
    else:
        vqa_answer = yield ("vqa", patch, context_question(name))
        phrase = context_phrase(vqa_answer, name)
        ctx = yield ("segment", patch, phrase)
        ctx = np.asarray(ctx, np.float32).reshape(bbox[3], bbox[2])
        step.final_heatmap = normalize_score(ctx)
        step.context_cue = vqa_answer + "#" + phrase

    # Children scored by ancestor-accumulated heatmap mass
    # (visual_search.py:451-465).
    current_index = search_path.index(step)
    subs, _, _ = get_sub_patches(bbox, *split_4subpatches(bbox))
    scores = [0.0] * len(subs)
    tmp = step
    while True:
        sub_scores = get_subpatch_scores(tmp.final_heatmap, tmp.bbox, subs)
        scores = [scores[i] + sub_scores[i] / (4 ** tmp.scale_level)
                  for i in range(len(subs))]
        if tmp.parent_index == -1:
            break
        tmp = search_path[tmp.parent_index]

    for sub, sc in zip(subs, scores):
        child = SearchStep(bbox=sub, scale_level=step.scale_level + 1,
                           score=sc, parent_index=current_index)
        heapq.heappush(heap, (-sc, next(counter), child))
    return False, None


def visual_search_gen(image, target_object_name: str,
                      smallest_size: int = 224,
                      confidence_high: float = 0.5,
                      confidence_low: float = 0.3,
                      target_cue_threshold: float = 6.0,
                      target_cue_threshold_decay: float = 0.7,
                      target_cue_threshold_minimum: float = 3.0,
                      max_steps: Optional[int] = None,
                      path_out: Optional[List] = None):
    """Coroutine form of the search: yields VSM requests, returns
    (final_step, path_length, search_successful, all_valid_boxes).

    path_out: caller-owned list filled with the SearchStep path (for
    visualization) — per-generator, so concurrent lockstep searches each
    keep their own path."""
    import itertools
    counter = itertools.count()

    root = SearchStep(bbox=[0, 0, image.width, image.height], scale_level=1,
                      score=None, parent_index=-1)
    search_path: List[SearchStep] = (path_out if path_out is not None
                                     else [])
    search_path[:] = [root]
    heap: list = []

    success = False
    all_valid_boxes = None
    step = root
    while True:
        accepted, all_valid_boxes = yield from _process_patch_gen(
            image, target_object_name, step, search_path, heap, counter,
            smallest_size, confidence_high, target_cue_threshold,
            target_cue_threshold_decay, target_cue_threshold_minimum)
        if accepted:
            success = True
            break
        if not heap or (max_steps is not None
                        and len(search_path) >= max_steps):
            break
        _, _, step = heapq.heappop(heap)
        search_path.append(step)

    path_length = len(search_path)
    final_step: Optional[SearchStep] = search_path[-1]
    if not success:
        # Fallback to the best stashed low-confidence detection
        # (visual_search.py:498-511).
        max_logit = 0.0
        final_step = None
        path_length = 0
        for i, s in enumerate(search_path):
            if s.temp_detection_result is not None \
                    and s.temp_detection_result[0] > max_logit:
                max_logit = s.temp_detection_result[0]
                final_step = s
                path_length = i + 1
        if final_step is not None:
            final_step.detection_result = final_step.temp_detection_result[1]
        if max_logit >= confidence_low:
            success = True
    return final_step, path_length, success, all_valid_boxes


def visual_search(vsm: VSMClient, image, target_object_name: str,
                  target_bbox=None, smallest_size: int = 224,
                  confidence_high: float = 0.5, confidence_low: float = 0.3,
                  target_cue_threshold: float = 6.0,
                  target_cue_threshold_decay: float = 0.7,
                  target_cue_threshold_minimum: float = 3.0,
                  max_steps: Optional[int] = None,
                  visualize: bool = False, save_path: Optional[str] = None,
                  path_out: Optional[List] = None):
    """Best-first guided search (visual_search.py:484-516 semantics).

    Returns (final_step, path_length, search_successful, all_valid_boxes).
    With visualize=True, writes the step/heatmap overlays under save_path
    (visual_search.py:512-514). path_out: caller-owned list filled with
    the visited SearchStep path.
    """
    if visualize:
        assert save_path is not None
    path: List[SearchStep] = path_out if path_out is not None else []
    gen = visual_search_gen(
        image, target_object_name, smallest_size=smallest_size,
        confidence_high=confidence_high, confidence_low=confidence_low,
        target_cue_threshold=target_cue_threshold,
        target_cue_threshold_decay=target_cue_threshold_decay,
        target_cue_threshold_minimum=target_cue_threshold_minimum,
        max_steps=max_steps, path_out=path)
    try:
        kind, patch, text = next(gen)
        while True:
            patch = unwrap_patch(patch)  # VSMClient takes PIL images
            if kind == "detect":
                result = vsm.detect(patch, text)
            elif kind == "vqa":
                result = vsm.vqa(patch, text)
            else:
                result = vsm.segment(patch, text)
            kind, patch, text = gen.send(result)
    except StopIteration as stop:
        final_step, path_length, success, all_valid_boxes = stop.value
        if visualize:
            from .visualize import visualize_search_path
            vis_len = path_length if success else len(path)
            visualize_search_path(image, path, vis_len, target_bbox,
                                  target_object_name, save_path)
        return stop.value
