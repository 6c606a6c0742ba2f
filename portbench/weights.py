"""Weights as pure functions of (seed, key, shape).

Every leaf of a model's parameter tree is named by its dotted path in the
tree (the JAX package's names, which the port keeps). A leaf's values are
drawn on the device from a generator seeded by a hash of (seed, path) and,
for a layer stack, of the layer index too, so one layer of a stack can be
made again alone. The draw is rounded to the dtype the configuration
serves in (bf16); the plain reference takes that rounded value in f32.

The law of each leaf follows its name: norm scales are ones, biases and
embeddings small normals, dense and conv weights uniform at 1/sqrt(fan-in)
(torch.nn.Linear's bound), the learned tokens and Fourier features unit
normals.
"""

from __future__ import annotations

import hashlib
import math
from typing import Optional, Sequence, Tuple

import torch

UNIT_NORMAL = ("latents", "media_pos_emb", "pe_gaussian", "no_mask_embed",
               "iou_token", "mask_tokens")
DENSE = ("w", "lm_head", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
SMALL_NORMAL = ("embed_tokens", "position_embedding", "class_embedding")

# leaves whose leading axis is the layer axis of a stack (the decoder's,
# the towers' and the perceiver's `layers`; SAM's layers are a list)
STACK_ROOTS = ("llama.layers.", "vision.layers.", "owl_tower.layers.",
               "perceiver.layers.")


def is_stacked(path: str) -> bool:
    return any(root in path for root in STACK_ROOTS)


def law(path: str, shape: Sequence[int]) -> Tuple[str, float]:
    """(kind, parameter) of a leaf: ('ones', 0), ('normal', std) or
    ('uniform', bound). Raises for a name no rule covers."""
    name = path.rsplit(".", 1)[-1]
    if name == "scale":
        return "ones", 0.0
    if name in ("b", "bias"):
        return "normal", 0.02
    if name in SMALL_NORMAL:
        return "normal", 0.02
    if name in UNIT_NORMAL:
        return "normal", 1.0
    if name in DENSE:
        per_layer = tuple(shape[1:]) if is_stacked(path) else tuple(shape)
        if len(per_layer) == 4:                 # HWIO conv
            fan_in = per_layer[0] * per_layer[1] * per_layer[2]
        else:
            fan_in = per_layer[-2]
        return "uniform", 1.0 / math.sqrt(fan_in)
    raise KeyError(f"no weight law for {path!r}")


def key_seed(seed: int, path: str, layer: Optional[int] = None) -> int:
    text = f"{int(seed)}:{path}:{'' if layer is None else int(layer)}"
    digest = hashlib.blake2b(text.encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << 63) - 1)


def draw(seed: int, path: str, shape: Sequence[int], device,
         dtype: torch.dtype, layer: Optional[int] = None) -> torch.Tensor:
    """One leaf (or one layer of a stacked leaf: `shape` without the layer
    axis) in f32 draws rounded to `dtype`."""
    kind, p = law(path, shape if layer is None else (0, *shape))
    if kind == "ones":
        return torch.ones(tuple(shape), dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(
        key_seed(seed, path, layer))
    x = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    if kind == "normal":
        x.normal_(0.0, p, generator=gen)
    else:
        x.uniform_(-p, p, generator=gen)
    return x.to(dtype)


def make_leaf(seed: int, path: str, shape: Sequence[int], device,
              dtype: torch.dtype) -> torch.Tensor:
    """A whole leaf; a stacked leaf is made layer by layer in place."""
    if not is_stacked(path):
        return draw(seed, path, shape, device, dtype)
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    for i in range(shape[0]):
        out[i] = draw(seed, path, shape[1:], device, dtype, layer=i)
    return out


def fill_tree(tree, seed: int, device, dtype: torch.dtype, prefix: str = ""):
    """A copy of a (meta-device) parameter tree with every leaf made by
    make_leaf under its dotted path, prefixed by `prefix`."""
    if isinstance(tree, dict):
        return {k: fill_tree(v, seed, device, dtype, f"{prefix}{k}.")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(fill_tree(v, seed, device, dtype, f"{prefix}{i}.")
                          for i, v in enumerate(tree))
    return make_leaf(seed, prefix.rstrip("."), tree.shape, device, dtype)


class Source:
    """The reference's view of one model's weights: `get(path)` or
    `get(path, layer)` makes the leaf again in f32 from the seed, through
    the same draws and the same rounding as the program's copy."""

    def __init__(self, seed: int, shapes: dict, device, served: torch.dtype,
                 prefix: str = ""):
        self.seed, self.shapes, self.device = seed, shapes, device
        self.served, self.prefix = served, prefix

    def get(self, path: str, layer: Optional[int] = None) -> torch.Tensor:
        full = self.prefix + path
        shape = self.shapes[full]
        if layer is not None:
            shape = shape[1:]
        return draw(self.seed, full, shape, self.device, self.served,
                    layer).float()
