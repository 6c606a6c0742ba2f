"""Seeded parameter initialisation and parameter-tree helpers.

Parameters are nested dicts of tensors with the JAX package's names and
shapes (vstar_tpu/core/params.py): dense weights (in, out), layer stacks
with a leading layer axis. Every random draw comes from one
`torch.Generator` on the target device, so a 7B model is built on the
card without a host copy. The numbers differ from JAX's for the same
seed; the tests feed both sides the same weights through core/convert.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterator, Sequence, Tuple, Union

import torch

Params = Dict[str, Any]


class Init:
    """Draws parameters of one dtype on one device from a seeded
    generator. On the meta device (shape-only builds) nothing is drawn."""

    def __init__(self, seed: int, device: Union[str, torch.device],
                 dtype: torch.dtype = torch.float32):
        self.device = torch.device(device)
        self.dtype = dtype
        self.gen = None
        if self.device.type != "meta":
            self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def empty(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.empty(tuple(shape), dtype=self.dtype, device=self.device)

    def uniform(self, shape: Sequence[int], bound: float) -> torch.Tensor:
        return self.empty(shape).uniform_(-bound, bound, generator=self.gen)

    def normal(self, shape: Sequence[int], std: float = 1.0) -> torch.Tensor:
        return self.empty(shape).normal_(0.0, std, generator=self.gen)

    def ones(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.ones(tuple(shape), dtype=self.dtype, device=self.device)

    def zeros(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.zeros(tuple(shape), dtype=self.dtype, device=self.device)


def dense_init(init: Init, in_dim: int, out_dim: int,
               lead=()) -> torch.Tensor:
    """Kaiming-uniform (torch.nn.Linear's bound 1/sqrt(in)), stored
    (in, out); `lead` prepends stack axes such as the layer axis."""
    return init.uniform((*lead, in_dim, out_dim), 1.0 / math.sqrt(in_dim))


def embed_init(init: Init, vocab: int, dim: int) -> torch.Tensor:
    return init.normal((vocab, dim), 0.02)


class _SinkRead(torch.autograd.Function):
    """x[i], whose gradient goes to `sink.add(i, g)` as the backward
    produces it, and not back into x."""

    @staticmethod
    def forward(ctx, x, i, sink):
        ctx.set_materialize_grads(False)
        ctx.i, ctx.sink = i, sink
        return x[i]

    @staticmethod
    def backward(ctx, g):
        ctx.sink.add(ctx.i, g)
        return None, None, None


def read_layer(x: torch.Tensor, i: int, sink=None) -> torch.Tensor:
    """x[i] of a stacked leaf (a view). With a `sink` (a layer-gradient
    sink of train/accumulate.py, whose `tensor` x is) and grad enabled,
    the read is recorded (`sink.read(i)`) and its gradient is handed to
    `sink.add(i, g)` when the backward reaches it, so that a stack's
    layer gradients need not all be alive until the backward ends."""
    if sink is None or not torch.is_grad_enabled():
        return x[i]
    sink.read(i)
    return _SinkRead.apply(x, i, sink)


# A leaf of more elements than this goes through a training step's update
# (train/sft.apply_step) and the global norm's sum of squares
# (train/optim.global_norm) in blocks of its flattened elements, so that
# their temporaries are a block's: XLA fuses the update into one
# elementwise pass and the squares into the reduction, and holds
# neither. The update is elementwise: the blocks give it the same bits.
BLOCK = 1 << 26


def blocks(x: torch.Tensor) -> list:
    """The blocks of a leaf: [None] (the whole leaf) for a leaf of at most
    BLOCK elements or one not contiguous, else slices of its flattened
    elements."""
    n = x.numel()
    if n <= BLOCK or not x.is_contiguous():
        return [None]
    return [slice(i, min(i + BLOCK, n)) for i in range(0, n, BLOCK)]


def at(x: torch.Tensor, index) -> torch.Tensor:
    """x's elements at `index`, a slice of its flattened elements (a
    view); x itself for None."""
    return x if index is None else x.view(-1)[index]


def sum_squares(x: torch.Tensor) -> torch.Tensor:
    """sum(x * x) in x's dtype: (x * x).sum() for a leaf of one block;
    a larger leaf's blocks' sums added in order, one block's squares
    alive at a time."""
    total = None
    for index in blocks(x):
        b = at(x, index)
        part = (b * b).sum()
        total = part if total is None else total + part
    return total


def layer(tree: Params, i: int) -> Params:
    """Layer i of a stacked layer tree (views, no copies); a leaf carrying
    a `layer_grad_sink` attribute is read through read_layer."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return read_layer(tree, i, getattr(tree, "layer_grad_sink", None))


def map_with_path(fn: Callable[[str, Any], Any], tree: Params,
                  prefix: str = "") -> Params:
    """Map fn(dotted path, leaf) over a tree of dicts, lists and tuples
    (vstar_tpu map_with_path; the paths name the trainable set)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}{k}.")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, f"{prefix}{i}.")
                          for i, v in enumerate(tree))
    return fn(prefix.rstrip("."), tree)


def leaves_with_path(tree: Params, prefix: str = ""
                     ) -> Iterator[Tuple[str, Any]]:
    """(dotted path, leaf) in JAX's leaf order (dict keys sorted at each
    level), so sums over leaves add in the order JAX adds them."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, f"{prefix}{i}.")
    else:
        yield prefix.rstrip("."), tree


def replace_leaves(tree: Params, new: Dict[str, Any],
                   prefix: str = "") -> Params:
    """A copy of the tree's containers with the leaves at the paths of
    `new` replaced; every other leaf is the same object."""
    if isinstance(tree, dict):
        return {k: replace_leaves(v, new, f"{prefix}{k}.")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replace_leaves(v, new, f"{prefix}{i}.")
                          for i, v in enumerate(tree))
    return new.get(prefix.rstrip("."), tree)
