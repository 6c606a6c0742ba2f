"""Search-path visualization (reference visual_search.py:289-376), with
PIL instead of OpenCV/matplotlib: per-step bbox overlays, JET-style heatmap
blends, final search-result crop, and the context-cue text dump."""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np
from PIL import Image, ImageDraw

BOX_COLOR = (255, 0, 0)
STEP_COLOR = (0, 0, 255)


def draw_bbox(img: Image.Image, bbox: Sequence[float], label: str,
              color=BOX_COLOR, width: int = 2) -> Image.Image:
    """bbox = [x, y, w, h]."""
    out = img.copy()
    d = ImageDraw.Draw(out)
    x, y, w, h = [float(v) for v in bbox]
    d.rectangle([x, y, x + w, y + h], outline=color, width=width)
    tw = max(8 * len(label), 10)
    d.rectangle([x, max(0, y - 12), x + tw, y], fill=color)
    d.text((x + 1, max(0, y - 12)), label, fill=(255, 255, 255))
    return out


def _jet(v: np.ndarray) -> np.ndarray:
    """Minimal JET colormap for v in [0,1] -> float RGB [0,1]."""
    r = np.clip(1.5 - np.abs(4 * v - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * v - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * v - 1), 0, 1)
    return np.stack([r, g, b], -1)


def heatmap_overlay(img: Image.Image, heatmap: np.ndarray,
                    image_weight: float = 0.5) -> Image.Image:
    """normalize + JET blend (visual_search.py:308-337)."""
    hm = np.asarray(heatmap, np.float32)
    mx, mn = hm.max(), hm.min()
    hm = (hm - mn) / (mx - mn) if mx != mn else hm * 0
    base = np.asarray(img.convert("RGB"), np.float32) / 255.0
    if hm.shape != base.shape[:2]:
        from ..data.preprocess import resize_bilinear_torch
        hm = resize_bilinear_torch(hm, base.shape[0], base.shape[1])
    cam = (1 - image_weight) * _jet(np.clip(hm, 0, 1)) + image_weight * base
    cam = cam / max(cam.max(), 1e-9)
    return Image.fromarray((cam * 255).astype(np.uint8))


def visualize_search_path(image: Image.Image, search_path: List,
                          search_length: int, target_bbox, label: str,
                          save_path: str):
    """Write whole_image / step_k / heatmaps / search_result / context cues
    under save_path (visual_search.py:339-376 file contract)."""
    os.makedirs(save_path, exist_ok=True)
    image.save(os.path.join(save_path, "whole_image.jpg"))
    whole = image.copy()
    if target_bbox is not None:
        whole = draw_bbox(whole, target_bbox, "gt: " + label)

    context_lines = []
    for i, step in enumerate(search_path):
        if i + 1 > search_length:
            break
        bbox = step.bbox
        if step.detection_result is not None:
            patch = image.crop((bbox[0], bbox[1], bbox[0] + bbox[2],
                                bbox[1] + bbox[3]))
            patch.save(os.path.join(save_path, "final_patch_image.jpg"))
            draw_bbox(patch, step.detection_result, "search result").save(
                os.path.join(save_path, "search_result.jpg"))
        draw_bbox(whole, bbox, f"step-{i + 1}", STEP_COLOR).save(
            os.path.join(save_path, f"step_{i + 1}.jpg"))
        if step.context_cue is not None:
            context_lines.append(f"step{i + 1}: {step.context_cue}\n")
        if step.final_heatmap is not None:
            patch = image.crop((bbox[0], bbox[1], bbox[0] + bbox[2],
                                bbox[1] + bbox[3]))
            heatmap_overlay(patch, step.final_heatmap).save(
                os.path.join(save_path, f"step_{i + 1}_heatmap.jpg"))
    with open(os.path.join(save_path, "context_cue.txt"), "w") as f:
        f.writelines(context_lines)
