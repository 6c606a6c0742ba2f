"""The weight bridge from the JAX package to the port.

`from_numpy_tree` takes a vstar_tpu parameter pytree as nested dicts and
lists of numpy arrays (what `jax.device_get` returns; this package never
imports JAX) and returns the port's tree: the same names, the same
layouts, as torch tensors on one device. This is the one place where a
name or a layout would be translated; today none needs to be, because
the port keeps the JAX layouts at every public function (dense (in, out),
conv HWIO, stacked layers).

Quantized entries cross as they are: int8 `{q, s}` (the towers' `{q, s,
b}`) and int4 `{q4, s4}` keep their int8, uint8 and f32 leaves.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

def from_numpy_tree(tree, device: Union[str, torch.device]):
    """numpy pytree -> torch tree on `device`, each leaf keeping its dtype
    (bfloat16 leaves included)."""
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_numpy_tree(v, device) for v in tree)
    arr = np.asarray(tree)
    if str(arr.dtype) == "bfloat16":
        # numpy has no bfloat16 of its own (JAX hands out ml_dtypes'):
        # move the raw 16-bit words and reinterpret them on the device
        return torch.from_numpy(arr.view(np.int16).copy()).to(device).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)   # a writable copy
