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
its moments.
"""

from __future__ import annotations

import torch

from .optim import Transformation, apply_updates


def _needs_master(p: torch.Tensor) -> bool:
    return p.is_floating_point() and p.element_size() < 4


def with_f32_master(inner: Transformation) -> Transformation:
    def init(params):
        master = {p: x.float() if _needs_master(x) else x
                  for p, x in params.items()}
        return {"master": master, "inner": inner.init(master)}

    def update(grads, state, params=None):
        g32 = {p: g.float() if g.is_floating_point() else g
               for p, g in grads.items()}
        updates, new_inner = inner.update(g32, state["inner"],
                                          state["master"])
        new_master = dict(state["master"])
        for p, u in updates.items():
            m = state["master"][p]
            if _needs_master(params[p]) and \
                    torch.promote_types(m.dtype, u.dtype) == m.dtype:
                new_master[p] = m.add_(u)     # the state's own f32 copy
            else:
                new_master.update(apply_updates({p: m}, {p: u}))
        # emitted update = cast(new master) - stored param, in its dtype
        out = {p: (new_master[p].to(params[p].dtype) - params[p])
               if _needs_master(params[p])
               else (new_master[p] - params[p]).to(params[p].dtype)
               for p in updates}
        return out, {"master": new_master, "inner": new_inner}

    return Transformation(init, update)
