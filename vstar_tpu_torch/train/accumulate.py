"""Gradient accumulation over micro-batches (port of
vstar_tpu/train/accumulate.py).

The reference accumulates through DeepSpeed (grad_accumulation_steps=2
for the VSM, VisualSearch/train.py:67-70). A batch whose leading dim is
(micro * micro_bs) is run in `micro` slices, each slice's gradients
(torch.autograd.grad, one graph at a time) divided by `micro` and summed
into float32 buffers, as the JAX scan does: the memory of a small batch,
the update of a big one. Gradients are taken only for the chosen leaves;
the others need none (they are frozen).

A DTensor leaf (a tree sharded by core/mesh.shard_params) is
differentiated through its local shard: the loss sees the DTensor, the
gradient is this rank's shard of the whole batch's gradient (the
gathers' backward sums the ranks), and the buffers are local.
"""

from __future__ import annotations

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
    loss_acc = aux_acc = grads = None
    for i in range(n):
        micro = batch if n == 1 else {k: v[i * m:(i + 1) * m]
                                      for k, v in batch.items()}
        live = {p: _live(leaves[p]) for p in paths}
        out = loss_fn(replace_leaves(params, {
            p: _as_leaf(leaves[p], x) for p, x in live.items()}), micro)
        loss, aux = out if has_aux else (out, None)
        gs = torch.autograd.grad(loss, [live[p] for p in paths],
                                 allow_unused=True)
        gs = [torch.zeros_like(live[p]) if g is None else g
              for p, g in zip(paths, gs)]
        if n == 1:
            return loss.detach(), _detach(aux), dict(zip(paths, gs))
        if grads is None:
            grads = {p: torch.zeros(live[p].shape, dtype=torch.float32,
                                    device=live[p].device) for p in paths}
            loss_acc = torch.zeros((), dtype=torch.float32,
                                   device=loss.device)
            if has_aux:
                aux_acc = {k: torch.zeros((), dtype=torch.float32,
                                          device=loss.device) for k in aux}
        for p, g in zip(paths, gs):
            grads[p] += g / n
        gs = g = None     # this micro-batch's gradients, before the next
        loss_acc = loss_acc + loss.detach() / n
        if has_aux:
            aux_acc = {k: aux_acc[k] + aux[k].detach() / n for k in aux}
    return loss_acc, aux_acc, grads
