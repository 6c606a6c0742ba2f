"""Image preprocessing on the device (port of vstar_tpu/kernels/image_ops.py;
plain PyTorch, not a kernel: the JAX functions are plain XLA).

  * `normalize_u8_images` — host-resized uint8 images (exact PIL geometry,
    data/preprocess.py) upload as uint8 and are CLIP-normalized here with
    the host's f32 expression.
  * the canvas path of the batched search (`--device-preprocess`): an
    image uploads once as a uint8 canvas padded to a 512-multiple bucket
    (`u8_canvas`), is normalized on the device with its pad forced to 0
    (`normalize_canvas_device`), and every patch of every wave is a window
    of it resized for both towers (`pair_windows`).

The resampler is `jax.image.scale_and_translate(..., method="cubic",
antialias=True)`: per spatial axis a weight matrix [in, out] from the
Keys cubic kernel (a = -0.5), widened by max(1/scale, 1) when
downscaling, each column divided by its sum (zeroed where the sum is below
1000 f32 eps) and zeroed where the sample lies outside [-0.5, in - 0.5];
then one contraction per axis. It differs from PIL's bicubic (and from
`F.interpolate(mode="bicubic")`, a = -0.75 without antialiasing), so the
exact-parity default of the engines stays on host preprocessing.

Everything is f32. The contractions are `torch.matmul`, which computes
f32 products in full f32 unless the caller enables TF32
(`torch.backends.cuda.matmul.allow_tf32`, off by default), as the JAX
side computes at Precision.HIGHEST.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..multimodal.constants import CLIP_MEAN, CLIP_STD

CANVAS_BUCKET = 512
_F32_EPS = float(np.finfo(np.float32).eps)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    """f32 pixels in [0, 255] -> CLIP-normalized, dividing by tensors (on
    CUDA a Python-scalar divisor is a reciprocal multiply, not the IEEE
    quotient the host computes)."""
    def const(v):
        return torch.tensor(v, dtype=torch.float32, device=x.device)
    return (x / const(255.0) - const(CLIP_MEAN)) / const(CLIP_STD)


def normalize_u8_images(x_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [..., 3] -> CLIP-normalized float32."""
    return _normalize(x_u8.float())


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _weight_mats(in_size: int, out_size: int, inv_scale: torch.Tensor,
                 translation: torch.Tensor) -> torch.Tensor:
    """jax.image's compute_weight_mat (cubic, antialias) for N windows at
    once: inv_scale, translation f32 [N] -> weights f32 [N, in, out]."""
    dev = inv_scale.device
    inv = inv_scale[:, None, None]
    kernel_scale = torch.clamp(inv, min=1.0)
    sample = ((torch.arange(out_size, dtype=torch.float32, device=dev)
               + 0.5) * inv - translation[:, None, None] * inv - 0.5)
    src = torch.arange(in_size, dtype=torch.float32, device=dev)[:, None]
    w = _keys_cubic((sample - src).abs() / kernel_scale)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _F32_EPS,
                    w / torch.where(total != 0, total,
                                    torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside, w, torch.zeros_like(w))


def _as_boxes(boxes, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(boxes, np.float32)
                           if not isinstance(boxes, torch.Tensor) else boxes,
                           dtype=torch.float32, device=dev).reshape(-1, 4)


def _axis_keep(size: int, start: torch.Tensor, length: torch.Tensor,
               dev) -> torch.Tensor:
    """[N, size] 1.0 where start <= i < start + length (f32 compares)."""
    i = torch.arange(size, dtype=torch.float32, device=dev)[None]
    return ((i >= start[:, None]) & (i < (start + length)[:, None])).float()


def _windows(image: torch.Tensor, boxes: torch.Tensor, out_size: int,
             masks: torch.Tensor = None) -> torch.Tensor:
    """N dynamic [x, y, w, h] windows of one f32 [H, W, C] image resized
    to [N, out, out, C] (scale_and_translate with scale out / (h, w) and
    translation -(y, x) * scale). masks [N, 4]: zero the image outside
    each [x, y, w, h] first; the mask is separable, so it multiplies the
    weight rows instead of a copy of the image per window (a product with
    0 or 1 is exact either way)."""
    H, W, C = image.shape
    n = boxes.shape[0]
    x0, y0, w, h = boxes.unbind(1)
    # tensor quotients: a Python number over a tensor is a reciprocal
    # multiply in PyTorch, not the IEEE quotient JAX takes
    out, one = torch.full_like(h, out_size), torch.ones_like(h)
    sy, sx = out / h, out / w
    wy = _weight_mats(H, out_size, one / sy, -y0 * sy)
    wx = _weight_mats(W, out_size, one / sx, -x0 * sx)
    if masks is not None:
        mx, my, mw, mh = masks.unbind(1)
        wy = wy * _axis_keep(H, my, mh, image.device)[:, :, None]
        wx = wx * _axis_keep(W, mx, mw, image.device)[:, :, None]
    # [n, out, H] @ [H, W*C] -> [n, out, W, C]; then over W, as one
    # product per window, [n, out*C, W] @ [n, W, out] (a broadcast of wx
    # over the out rows would copy it out times: 36 GiB at 16 windows)
    t = torch.matmul(wy.transpose(1, 2), image.reshape(H, W * C))
    t = t.view(n, out_size, W, C).transpose(2, 3)     # [n, out, C, W]
    t = torch.matmul(t.reshape(n, out_size * C, W), wx)
    return t.view(n, out_size, C, out_size).transpose(2, 3).contiguous()


def device_preprocess(image_u8: torch.Tensor, out_size: int) -> torch.Tensor:
    """[H, W, 3] uint8 -> [out, out, 3] f32 normalized (aspect-distorting
    cubic resize, OwlViTProcessor semantics; jax.image.resize, which
    leaves an axis whose size does not change as it is)."""
    x = image_u8.float()
    dev = x.device
    for axis in (0, 1):
        n_in = x.shape[axis]
        if n_in == out_size:
            continue
        # jax.image.resize: the scale is a Python float, 1 / scale taken
        # in double and rounded to f32
        inv = torch.tensor([1.0 / (out_size / n_in)], dtype=torch.float32,
                           device=dev)
        wm = _weight_mats(n_in, out_size, inv,
                          torch.zeros(1, dtype=torch.float32, device=dev))[0]
        x = torch.tensordot(x, wm, dims=([axis], [0])).movedim(-1, axis)
    return _normalize(x)


def expand2square_device(image_u8: torch.Tensor, center: bool = True
                         ) -> torch.Tensor:
    """Pad to square with the CLIP mean colour on the device; the side is
    max(H, W)."""
    H, W, _ = image_u8.shape
    side = max(H, W)
    fill = torch.tensor([int(c * 255) for c in CLIP_MEAN], dtype=torch.uint8,
                        device=image_u8.device)
    out = fill.expand(side, side, 3).clone()
    top = (side - H) // 2 if center else 0
    left = (side - W) // 2 if center else 0
    out[top:top + H, left:left + W] = image_u8
    return out


def crop_resize_normalize(image_u8: torch.Tensor, bbox,
                          out_size: int) -> torch.Tensor:
    """Crop [x, y, w, h] (pixels, dynamic) from a device-resident image
    and resize + normalize to [out, out, 3]. Output pixel centres map
    linearly onto the crop window, so the interior equals crop-then-resize;
    at the crop's border the kernel sees pixels just outside it."""
    return batched_crop_preprocess(image_u8, bbox, out_size)[0]


def batched_crop_preprocess(image_u8: torch.Tensor, bboxes,
                            out_size: int) -> torch.Tensor:
    """[N, 4] crops of one image -> [N, out, out, 3]."""
    return _normalize(_windows(image_u8.float(),
                               _as_boxes(bboxes, image_u8.device), out_size))


def window_resize(canvas_norm: torch.Tensor, bbox, out_size: int,
                  mask_bbox=None) -> torch.Tensor:
    """Resize a dynamic [x, y, w, h] window of a normalized canvas to
    [out, out, 3]. Samples outside the canvas are 0, the normalized CLIP
    mean (normalize_canvas_device pads so), as expand2square fills.

    mask_bbox: zero the canvas outside this [x, y, w, h] before sampling,
    so that a window reaching past its crop inside the image sees the mean
    colour there, as expand2square pads, and not the neighbouring
    content."""
    dev = canvas_norm.device
    masks = None if mask_bbox is None else _as_boxes(mask_bbox, dev)
    return _windows(canvas_norm, _as_boxes(bbox, dev), out_size, masks)[0]


def square_window(bbox) -> list:
    """Centred square window [x, y, side, side] around an [x, y, w, h]
    crop: the expand2square geometry (integer paste offsets like PIL)."""
    x0, y0, w, h = bbox
    side = max(w, h)
    return [x0 - (side - w) // 2, y0 - (side - h) // 2, side, side]


def canvas_bucket_hw(h: int, w: int, bucket: int = CANVAS_BUCKET
                     ) -> Tuple[int, int]:
    """The bucketed canvas shape (bH, bW) of an HxW image."""
    return (-(-h // bucket) * bucket, -(-w // bucket) * bucket)


def u8_canvas(image, bucket: int = CANVAS_BUCKET):
    """PIL image -> (uint8 canvas [bH, bW, 3] zero-padded, (H, W)).
    Upload this (a quarter of f32's bytes) and finish with
    `normalize_canvas_device`."""
    arr = np.asarray(image.convert("RGB"), np.uint8)
    H, W = arr.shape[:2]
    bh, bw = canvas_bucket_hw(H, W, bucket)
    canvas = np.zeros((bh, bw, 3), np.uint8)
    canvas[:H, :W] = arr
    return canvas, (H, W)


def normalize_canvas_device(canvas_u8: torch.Tensor, h: int,
                            w: int) -> torch.Tensor:
    """uint8 canvas -> CLIP-normalized f32 with the pad region (rows >= h,
    columns >= w) exactly 0, the normalized mean colour that
    window_resize relies on."""
    norm = normalize_u8_images(canvas_u8)
    bh, bw, _ = canvas_u8.shape
    dev = canvas_u8.device
    keep = ((torch.arange(bh, device=dev)[:, None] < h)
            & (torch.arange(bw, device=dev)[None, :] < w))
    return torch.where(keep[..., None], norm, torch.zeros_like(norm))


def pair_windows(canvas_norm: torch.Tensor, sq_bboxes, crop_bboxes,
                 clip_size: int, owl_size: int):
    """Both tower inputs of N patches of one canvas: the square windows
    [N, 4] -> [N, clip, clip, 3] and the crop windows [N, 4] -> [N, owl,
    owl, 3]. Both mask the canvas outside each crop, so the CLIP square
    window's pad bands match expand2square's fill."""
    dev = canvas_norm.device
    crops = _as_boxes(crop_bboxes, dev)
    clip = _windows(canvas_norm, _as_boxes(sq_bboxes, dev), clip_size, crops)
    owl = _windows(canvas_norm, crops, owl_size, crops)
    return clip, owl
