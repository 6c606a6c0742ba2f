"""Checkpoint I/O for the port's own state trees (the counterpart of
vstar_tpu/core/checkpoint.py `save_params` / `load_params`).

The JAX package writes Orbax checkpoints; the port writes its state tree
(nested dicts, lists and tuples of tensors and ints) with torch.save and
reads it back with weights_only=True, so a checkpoint never runs code.
The two formats do not read each other (ROADMAP Queue 3). The HF
checkpoint reader (`load_torch_dir`) comes with the HF import slice.
"""

from __future__ import annotations

import os
from typing import Any, Union

import torch


def save_params(tree: Any, path: str) -> None:
    """Write `tree` to the file `path`, replacing it atomically (the
    trainers keep one rolling checkpoint, like the reference's
    rmtree-then-save, VisualSearch/train.py:396-409)."""
    path = os.path.abspath(path)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(tree, tmp)
    os.replace(tmp, path)


def load_params(path: str, device: Union[str, torch.device] = "cpu") -> Any:
    """Read a tree written by save_params, its tensors on `device`."""
    return torch.load(os.path.abspath(path), map_location=device,
                      weights_only=True)
