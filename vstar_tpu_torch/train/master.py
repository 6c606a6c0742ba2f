"""f32 master weights for bf16 parameter storage (port of
vstar_tpu/train/master.py; DeepSpeed's bf16 + fp32-optimizer mode, which
the reference uses: VisualSearch/train.py:282-318).

Wraps a transformation of train/optim.py: the inner optimizer sees f32
master copies of every sub-f32 leaf (kept in the optimizer state),
gradients are cast to f32 before the update, and the emitted update
moves the stored parameter to cast(new master), so the authoritative
accumulation happens in f32 and bf16 storage is a rounded view. On a
sharded tree (core/mesh.py) it sees each rank's local shards, so the
masters are sharded as their leaves. A master the state owns (the f32
copy of a sub-f32 leaf) is updated in place, as train/optim.py updates
its moments. Leaf by leaf (optim.Transformation's start): a leaf's f32
gradient and emitted update exist only while that leaf is updated.
"""

from __future__ import annotations

import torch

from ..core.params import at
from .optim import Transformation, apply_updates


def _needs_master(p: torch.Tensor) -> bool:
    return p.is_floating_point() and p.element_size() < 4


def with_f32_master(inner: Transformation) -> Transformation:
    def init(params):
        master = {p: x.float() if _needs_master(x) else x
                  for p, x in params.items()}
        return {"master": master, "inner": inner.init(master)}

    def start(grads, state, params=None):
        masters = state["master"]
        inner_leaf, new_inner = inner.start(grads, state["inner"], masters)
        new_master, made = dict(masters), set()

        def leaf(p, g, index=None):
            u = inner_leaf(p, g.float() if g.is_floating_point() else g,
                           index)
            m, stored = at(masters[p], index), at(params[p], index)
            if _needs_master(params[p]) and \
                    torch.promote_types(m.dtype, u.dtype) == m.dtype:
                new = m.add_(u)     # the state's own f32 copy
            else:                   # p + u in p's dtype, a new tensor
                if p not in made:
                    made.add(p)
                    new_master[p] = torch.empty(
                        masters[p].shape, dtype=m.dtype, device=m.device)
                new = at(new_master[p], index)
                new.copy_(apply_updates({p: m}, {p: u})[p])
            del u
            # emitted update = cast(new master) - stored param, in its dtype
            if _needs_master(params[p]):
                return new.to(stored.dtype) - stored
            return (new - stored).to(stored.dtype)
        return leaf, {"master": new_master, "inner": new_inner}

    return Transformation(init, start)
