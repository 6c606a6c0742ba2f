"""COCO RLE mask decoding in pure numpy (replaces pycocotools' C ext).

Supports both annotation forms the reference pipeline consumes
(VisualSearch/utils/refer_seg_dataset.py, grefer.py):
  * uncompressed RLE: {'counts': [int, ...], 'size': [h, w]}
  * compressed RLE:   {'counts': bytes/str (LEB128-style), 'size': [h, w]}
  * polygons are rasterized by data/polygon.py (PIL-based).
COCO RLE is column-major (Fortran order).
"""

from __future__ import annotations

from typing import Dict, List, Union

import numpy as np


def _decode_compressed_counts(s: Union[str, bytes]) -> List[int]:
    """pycocotools' modified LEB128 with sign-extension and delta coding."""
    if isinstance(s, str):
        s = s.encode("ascii")
    counts: List[int] = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def rle_decode(rle: Dict) -> np.ndarray:
    """-> uint8 mask [h, w]."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = _decode_compressed_counts(counts)
    counts = np.asarray(counts, np.int64)
    total = int(counts.sum())
    assert total == h * w, f"rle covers {total}, expected {h * w}"
    from ..native import rle_decode_native
    native = rle_decode_native(counts, h, w)
    if native is not None:
        return native
    # runs alternate 0,1 starting with 0; column-major layout
    flat = np.zeros(h * w, np.uint8)
    ends = np.cumsum(counts)
    starts = ends - counts
    for i in range(1, len(counts), 2):
        flat[starts[i]:ends[i]] = 1
    return flat.reshape((w, h)).T  # F-order -> [h, w]


def rle_encode(mask: np.ndarray) -> Dict:
    """uint8 [h, w] -> uncompressed RLE (for tests / preprocessing)."""
    h, w = mask.shape
    flat = np.asarray(mask, np.uint8).T.reshape(-1)  # column-major
    # run-length encode with leading zero-run
    change = np.nonzero(np.diff(flat))[0] + 1
    boundaries = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(boundaries).tolist()
    if flat[0] == 1:
        counts = [0] + counts
    return {"counts": counts, "size": [h, w]}


def polygons_to_mask(polygons: List[List[float]], h: int, w: int
                     ) -> np.ndarray:
    """COCO polygon segmentation -> uint8 mask [h, w] (PIL rasterizer,
    replacing pycocotools.frPyObjects+decode)."""
    from PIL import Image, ImageDraw
    img = Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(img)
    for poly in polygons:
        pts = [(poly[i], poly[i + 1]) for i in range(0, len(poly) - 1, 2)]
        if len(pts) >= 3:
            draw.polygon(pts, outline=1, fill=1)
    return np.asarray(img, np.uint8)
