"""Image normalisation on the device (vstar_tpu/kernels/image_ops.py
`normalize_u8_images`; plain PyTorch, not a kernel). Host-resized uint8
images (exact PIL geometry, data/preprocess.py) upload as uint8
and are CLIP-normalized here with the host's f32 expression."""

from __future__ import annotations

import torch

from ..multimodal.constants import CLIP_MEAN, CLIP_STD


def normalize_u8_images(x_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [..., 3] -> CLIP-normalized float32."""
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=x_u8.device)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=x_u8.device)
    return (x_u8.float() / 255.0 - mean) / std
