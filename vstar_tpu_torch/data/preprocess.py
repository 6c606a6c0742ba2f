"""Host-side image preprocessing (PIL/numpy), equivalent to the HF
processors the reference uses.

  * expand2square — pad to square with the CLIP mean color, centered
    (vstar_bench_eval.py:25-36). The VSM-side variant pastes top-left
    (VisualSearch/utils/utils.py:28-39) — both provided.
  * clip_preprocess — CLIPImageProcessor semantics: bicubic resize to
    224x224 (input already square), rescale 1/255, normalize.
  * owlvit_preprocess — OwlViTProcessor: bicubic resize to 768x768
    (aspect-distorting), rescale, normalize.
  * resize_bilinear_torch — numpy bilinear with half-pixel centers,
    bit-matching torch F.interpolate(align_corners=False) for heatmaps.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from PIL import Image

from ..multimodal.constants import CLIP_MEAN, CLIP_STD


def expand2square(img: Image.Image, background_color=None,
                  center: bool = True) -> Tuple[Image.Image, int, int]:
    """Pad to square. Returns (image, left_offset, top_offset)."""
    if background_color is None:
        background_color = tuple(int(x * 255) for x in CLIP_MEAN)
    w, h = img.size
    if w == h:
        return img, 0, 0
    side = max(w, h)
    result = Image.new(img.mode, (side, side), background_color)
    if center:
        left, top = (side - w) // 2, (side - h) // 2
    else:
        left, top = 0, 0
    result.paste(img, (left, top))
    return result, left, top


def _normalize(arr: np.ndarray, mean, std) -> np.ndarray:
    arr = arr.astype(np.float32) / 255.0
    return (arr - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def clip_resize_u8(img: Image.Image, size: int = 224) -> np.ndarray:
    """-> [size, size, 3] uint8: clip_preprocess's exact PIL geometry
    WITHOUT the normalize. The engines upload this (4x fewer bytes to
    the device) and normalize on device (kernels/image_ops
    normalize_u8_images) — identical f32 math, so outputs match the
    host-normalized path."""
    if img.size != (size, size):
        # shortest-edge resize + center crop degenerates to a plain resize
        # for square inputs, which is the only case on the SEAL path.
        w, h = img.size
        short = min(w, h)
        nw, nh = round(w * size / short), round(h * size / short)
        img = img.resize((nw, nh), Image.BICUBIC)
        left, top = (nw - size) // 2, (nh - size) // 2
        img = img.crop((left, top, left + size, top + size))
    return np.asarray(img.convert("RGB"), np.uint8)


def clip_preprocess(img: Image.Image, size: int = 224) -> np.ndarray:
    """-> [size, size, 3] float32, CLIP-normalized. Caller squares first
    (the SEAL pipeline always expand2squares before CLIP preprocessing)."""
    return _normalize(clip_resize_u8(img, size), CLIP_MEAN, CLIP_STD)


def owlvit_resize_u8(img: Image.Image, size: int = 768) -> np.ndarray:
    """-> [size, size, 3] uint8 (owlvit_preprocess minus normalize)."""
    return np.asarray(img.convert("RGB").resize((size, size),
                                                Image.BICUBIC), np.uint8)


def owlvit_preprocess(img: Image.Image, size: int = 768) -> np.ndarray:
    """-> [size, size, 3] float32, normalized (aspect-distorting resize)."""
    return _normalize(owlvit_resize_u8(img, size), CLIP_MEAN, CLIP_STD)


def resize_bilinear_torch(x: np.ndarray, out_h: int, out_w: int
                          ) -> np.ndarray:
    """Bilinear resize with half-pixel centers (torch align_corners=False).

    x: [H, W] float; used to upsample the 192x192 mask logits to the patch
    resolution exactly like F.interpolate (VSM.py:534-537).
    """
    in_h, in_w = x.shape
    x = x.astype(np.float32)
    from ..native import bilinear_resize_native
    native = bilinear_resize_native(x, out_h, out_w)
    if native is not None:
        return native

    def axis_coords(out_n, in_n):
        c = (np.arange(out_n, dtype=np.float64) + 0.5) * in_n / out_n - 0.5
        c0 = np.floor(c).astype(np.int64)
        frac = (c - c0).astype(np.float32)
        c0c = np.clip(c0, 0, in_n - 1)
        c1c = np.clip(c0 + 1, 0, in_n - 1)
        return c0c, c1c, frac

    y0, y1, fy = axis_coords(out_h, in_h)
    x0, x1, fx = axis_coords(out_w, in_w)

    top = x[y0][:, x0] * (1 - fx)[None, :] + x[y0][:, x1] * fx[None, :]
    bot = x[y1][:, x0] * (1 - fx)[None, :] + x[y1][:, x1] * fx[None, :]
    return top * (1 - fy)[:, None] + bot * fy[:, None]
