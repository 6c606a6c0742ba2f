"""Gradient accumulation over micro-batches (port of
vstar_tpu/train/accumulate.py).

The reference accumulates through DeepSpeed (grad_accumulation_steps=2
for the VSM, VisualSearch/train.py:67-70). A batch whose leading dim is
(micro * micro_bs) is run in `micro` slices, each slice's gradients
divided by `micro` and summed into float32 buffers, as the JAX scan
does: the memory of a small batch, the update of a big one. Gradients
are taken only for the chosen leaves; the others need none (they are
frozen).

With more than one micro-batch, each gradient is added into its buffer
as the backward produces it, and dropped: the f32 buffers exist before
the first backward, and no micro-batch's gradients are all alive at
once.
  * A leaf's gradient is added by a post-accumulate-grad hook on the
    leaf (it fires once, after every use of the leaf has contributed),
    which then drops `leaf.grad`.
  * A stacked leaf read one layer at a time (core/params.layer,
    core/mesh.layer_source) completes its gradient only when the
    backward reaches layer 0, so a hook on the leaf would hold every
    layer's gradient of every stack until the end. Such a leaf carries
    a `layer_grad_sink` (_LayerSink): each layer's gradient is added into
    its slice of the buffer when that layer's backward ends, and never
    reaches the leaf. A layer read twice in one forward has its two
    gradients summed in their dtype first, as autograd sums them.
The adds are the ones of a whole-tree gradient, g / n into one buffer
per leaf, so the buffers hold the same bits.

A DTensor leaf (a tree sharded by core/mesh.shard_params) is
differentiated through its local shard: the loss sees the DTensor, the
gradient is this rank's shard of the whole batch's gradient (the
gathers' backward sums the ranks), and the buffers are local.
"""

from __future__ import annotations

from collections import Counter
from typing import Callable, Dict, Optional

import torch
from torch.distributed.tensor import DTensor

from ..core.mesh import with_local
from ..core.params import leaves_with_path, replace_leaves


def _live(x: torch.Tensor) -> torch.Tensor:
    """A plain tensor to differentiate: the leaf, or a DTensor's shard."""
    x = x.to_local() if isinstance(x, DTensor) else x
    return x.detach().requires_grad_()


def _as_leaf(like: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    return with_local(like, live) if isinstance(like, DTensor) else live


def _detach(tree):
    if tree is None:
        return None
    return {k: v.detach() for k, v in tree.items()}


class _LayerSink:
    """The layer gradients of one stacked leaf (core/params.read_layer),
    added into `buf` (its f32 buffer, shaped as the leaf or its local
    shard) divided by n as each layer's backward ends. `tensor` is the
    plain tensor the layers are read from: the live leaf, or a DTensor
    leaf's live local shard, so that no read passes through DTensor's
    to_local (whose backward hands the leaf a zero gradient of the whole
    stack where the reads return none). `read` counts a layer's reads
    in the forward (not the recomputation that remat runs inside the
    backward); the gradients of a layer read more than once are summed
    in arrival order before the add, and `flush` adds what is left once
    the backward is over."""

    def __init__(self, buf: torch.Tensor, n: int, tensor: torch.Tensor):
        self.buf, self.n, self.tensor = buf, n, tensor
        self.reads: Counter = Counter()
        self.pending: Dict[int, torch.Tensor] = {}

    def read(self, i: int) -> None:
        if torch._C._current_graph_task_id() == -1:
            self.reads[i] += 1

    def add(self, i: int, g: Optional[torch.Tensor]) -> None:
        if g is not None:
            self.pending[i] = g if i not in self.pending \
                else self.pending[i] + g
        self.reads[i] -= 1
        if self.reads[i] <= 0:
            self._add(i)

    def _add(self, i: int) -> None:
        g = self.pending.pop(i, None)
        if g is not None:
            self.buf[i] += g / self.n

    def flush(self) -> None:
        for i in list(self.pending):
            self._add(i)
        self.reads.clear()

    def close(self, leaf: torch.Tensor) -> None:
        """Detach from `leaf` (which holds it as `layer_grad_sink`) and drop
        the tensors: a plain leaf and its sink refer to each other, and
        that cycle would keep the buffers alive after the step."""
        del leaf.layer_grad_sink
        self.buf = self.tensor = None
        self.pending.clear()


def accumulated_grads(loss_fn: Callable, params, batch: Dict,
                      num_micro: int, has_aux: bool = False,
                      trainable: Optional[Dict] = None):
    """loss_fn(params, micro_batch) -> loss (or (loss, aux dict)).

    Every leaf of `batch` must have a leading dim divisible by num_micro.
    trainable: bool tree of params' shape naming the leaves to
    differentiate (vsm_trainable_mask); None takes every float leaf.
    Returns (loss, aux or None, grads {dotted path: tensor}) averaged over
    micro-batches: float32 buffers when num_micro > 1, the leaves' dtype
    otherwise (as in JAX). A leaf the loss does not reach gets zeros."""
    mask = None if trainable is None else dict(leaves_with_path(trainable))
    leaves = dict(leaves_with_path(params))
    paths = [p for p, x in leaves.items()
             if (x.is_floating_point() if mask is None else mask[p])]
    n = max(num_micro, 1)
    rows = next(iter(batch.values())).shape[0]
    if rows % n:
        raise ValueError(f"batch of {rows} rows is not {n} micro-batches")
    m = rows // n
    if n == 1:
        live = {p: _live(leaves[p]) for p in paths}
        out = loss_fn(replace_leaves(params, {
            p: _as_leaf(leaves[p], x) for p, x in live.items()}), batch)
        loss, aux = out if has_aux else (out, None)
        gs = torch.autograd.grad(loss, [live[p] for p in paths],
                                 allow_unused=True)
        gs = [torch.zeros_like(live[p]) if g is None else g
              for p, g in zip(paths, gs)]
        return loss.detach(), _detach(aux), dict(zip(paths, gs))
    grads = {}
    for p in paths:
        local = _live(leaves[p])
        grads[p] = torch.zeros(local.shape, dtype=torch.float32,
                               device=local.device)
    loss_acc = aux_acc = None
    for i in range(n):
        micro = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
        live = {p: _live(leaves[p]) for p in paths}
        as_leaves, sinks, handles = {}, {}, []
        for p, x in live.items():
            as_leaves[p] = _as_leaf(leaves[p], x)
            if x.dim() > 0:
                sinks[p] = as_leaves[p].layer_grad_sink = \
                    _LayerSink(grads[p], n, x)
        try:
            out = loss_fn(replace_leaves(params, as_leaves), micro)
            loss, aux = out if has_aux else (out, None)
            for p, x in live.items():
                handles.append(x.register_post_accumulate_grad_hook(
                    lambda leaf, buf=grads[p]: _drain(leaf, buf, n)))
            loss.backward(inputs=list(live.values()))
            for sink in sinks.values():
                sink.flush()
        finally:
            for h in handles:
                h.remove()
            for p, sink in sinks.items():
                sink.close(as_leaves[p])
        if loss_acc is None:
            loss_acc = torch.zeros((), dtype=torch.float32,
                                   device=loss.device)
            if has_aux:
                aux_acc = {k: torch.zeros((), dtype=torch.float32,
                                          device=loss.device) for k in aux}
        loss_acc = loss_acc + loss.detach() / n
        if has_aux:
            aux_acc = {k: aux_acc[k] + aux[k].detach() / n for k in aux}
        del out, loss, aux, live, as_leaves, sinks
    return loss_acc, aux_acc, grads


def _drain(leaf: torch.Tensor, buf: torch.Tensor, n: int) -> None:
    """A leaf's post-accumulate-grad hook: its gradient / n into its
    buffer, then the gradient dropped. It also fires for a stacked leaf
    whose layers all went to its sink, with no gradient."""
    if leaf.grad is not None:
        buf += leaf.grad / n
        leaf.grad = None
