"""The optax pieces the trainers use, with optax's semantics, over
flat parameter dicts ({dotted path: tensor}, core/params.leaves_with_path).

The JAX package builds its optimizers from optax (vstar_tpu/train/
vsm_train.py:45-67, train/sft.py:35-57): clip_by_global_norm, then adamw
on the trainable leaves only (optax.masked), optionally over f32 masters
(train/master.py), on a warmup-decay or a warmup-cosine schedule.
What optax does, and torch.optim does not, is kept exactly:
  * the clip scales by max_norm / norm only when norm >= max_norm, with no
    epsilon (torch's clip_grad_norm_ adds 1e-6);
  * the schedule is evaluated at the step count BEFORE its increment, so a
    warmup starts at learning rate 0;
  * Adam's eps sits outside the square root (eps_root 0), bias corrections
    divide in the moment's dtype, moments start in the parameter's dtype
    and follow JAX's type promotion; both trainers' weight decay is 0,
    so adamw's decayed-weights term (u + 0 * p) is left out;
  * a leaf outside the mask gets no state and its (zero) gradient passes
    through.
A transformation is (init(params) -> state, update(grads, state, params)
-> (updates, state)), as in optax; states are dicts, lists and ints, so a
checkpoint stores them with torch.save.

Like JAX's trainers, which jit their step with the state donated, an
update consumes what it is given: the clip scales the gradients in
place, Adam's moments (and train/master.py's f32 masters) are updated in
place and Adam writes its update into the gradient's buffer, with the
arithmetic of the functional form (the same bits). Only a leaf whose
result JAX would promote to another dtype gets a new tensor. A 7B
finetune's state then needs no second copy of its moments and masters
during the update.

Under a mesh (core/mesh.py) the optimizer runs on each rank's local
shards, where every update but the clip is elementwise; the clip's
global norm is the root of the sum of squares over all shards
(`global_norm(tree, like)`, `like` the parameters' core/mesh.Shards:
each leaf's local sum divided by the number of ranks holding the same
shard, which its DTensor placements give, summed over the ranks).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Sequence

import numpy as np
import torch

Flat = Dict[str, torch.Tensor]


class Transformation(NamedTuple):
    init: Callable
    update: Callable


def apply_updates(params: Flat, updates: Flat) -> Flat:
    """p + u in p's dtype, for every path of `updates`."""
    return {p: (params[p] + u).to(params[p].dtype) for p, u in updates.items()}


def global_norm(tree: Flat, like=None) -> torch.Tensor:
    """sqrt(sum of squares), leaves added in the dict's order (JAX's leaf
    order when the dict comes from leaves_with_path). `like`: the
    parameters' local leaves (core/mesh.local_leaves); where they are the
    shards of a sharded tree, `tree` holds this rank's shards of it and
    the sum is the whole tree's (core/mesh.Mesh.sum_squares)."""
    mesh = getattr(like, "mesh", None)
    if mesh is not None:
        return torch.sqrt(mesh.sum_squares(tree, like.replicas))
    return torch.sqrt(sum((x * x).sum() for x in tree.values()))


def chain(*transforms: Transformation) -> Transformation:
    def init(params):
        return [t.init(params) for t in transforms]

    def update(updates, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, new_state

    return Transformation(init, update)


def clip_by_global_norm(max_norm: float) -> Transformation:
    """optax.clip_by_global_norm, scaling the updates in place (one host
    read of the norm); on the shards of a sharded tree (`params` its
    core/mesh.Shards), over the shards of all ranks."""
    def update(updates, state, params=None):
        g_norm = global_norm(updates, params)
        if not bool(g_norm < max_norm):
            for t in updates.values():
                t.div_(g_norm.to(t.dtype)).mul_(max_norm)
        return updates, state

    return Transformation(lambda params: {}, update)


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Callable[[int], np.float32]:
    """optax.linear_schedule in float32 (constant when transition_steps
    <= 0)."""
    if transition_steps <= 0:
        return lambda count: np.float32(init_value)

    def schedule(count):
        c = np.float32(min(max(count, 0), transition_steps))
        frac = np.float32(1) - c / np.float32(transition_steps)
        return np.float32(init_value - end_value) * frac + np.float32(end_value)
    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0, exponent: float = 1.0
                          ) -> Callable[[int], np.float32]:
    """optax.cosine_decay_schedule in float32, evaluated as XLA evaluates
    the jitted optax one: the angle as count * (pi / decay_steps) (XLA
    folds the constant division), the cosine correctly rounded (XLA's
    float32 cos agrees with it to within one ulp)."""
    if not decay_steps > 0:
        raise ValueError("cosine_decay_schedule needs positive decay_steps,"
                         f" got {decay_steps}")
    step = np.float32(np.pi) / np.float32(decay_steps)

    def schedule(count):
        angle = np.float32(min(max(count, 0), decay_steps)) * step
        cos = np.float32(np.cos(np.float64(angle)))
        decay = np.float32(0.5) * (np.float32(1) + cos)
        decayed = (np.float32(1 - alpha) * decay ** np.float32(exponent)
                   + np.float32(alpha))
        return np.float32(init_value) * decayed
    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0
                                 ) -> Callable[[int], np.float32]:
    """optax.warmup_cosine_decay_schedule: a linear warmup to peak_value,
    then a cosine decay to end_value over decay_steps - warmup_steps
    (decay_steps counts the warmup)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    return join_schedules(
        [linear_schedule(init_value, peak_value, warmup_steps),
         cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                               alpha, exponent)], [warmup_steps])


def join_schedules(schedules: Sequence[Callable], boundaries: Sequence[int]
                   ) -> Callable[[int], np.float32]:
    def schedule(step):
        out = schedules[0](step)
        for boundary, s in zip(boundaries, schedules[1:]):
            out = out if step < boundary else s(step - boundary)
        return out
    return schedule


def scale_by_adam(b1: float, b2: float, eps: float = 1e-8) -> Transformation:
    def init(params):
        return {"count": 0,
                "mu": {p: torch.zeros_like(x) for p, x in params.items()},
                "nu": {p: torch.zeros_like(x) for p, x in params.items()}}

    def update(updates, state, params=None):
        count = state["count"] + 1
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** count
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** count
        mu, nu, out = {}, {}, {}
        for p, g in updates.items():
            m = mu[p] = _ema(state["mu"][p], g, b1)
            v = nu[p] = _ema(state["nu"][p], g * g, b2)
            m_hat = m / bc1.to(m.dtype).to(m.device)
            # sqrt(v_hat) + eps, in v_hat's buffer
            denom = (v / bc2.to(v.dtype).to(v.device)).sqrt_().add_(eps)
            if torch.promote_types(m_hat.dtype, denom.dtype) == g.dtype:
                out[p] = torch.div(m_hat, denom, out=g)
            else:
                out[p] = m_hat / denom
            # before the next leaf's moments: held over, this leaf's two
            # temporaries doubled the update's peak on the largest leaves
            del m_hat, denom
        return out, {"count": count, "mu": mu, "nu": nu}

    return Transformation(init, update)


def _ema(m: torch.Tensor, x: torch.Tensor, decay: float) -> torch.Tensor:
    """(1 - decay) x + decay m, into m where the sum keeps m's dtype; where
    JAX's promotion changes it (a bf16 moment of an f32 gradient), a new
    tensor of the promoted dtype."""
    a = (1 - decay) * x
    if torch.promote_types(a.dtype, m.dtype) != m.dtype:
        return a + decay * m
    return m.mul_(decay).add_(a)


def scale_by_schedule(step_size_fn: Callable[[int], np.float32]
                      ) -> Transformation:
    def update(updates, state, params=None):
        step = float(step_size_fn(state["count"]))
        return {p: g.mul_(step) for p, g in updates.items()}, \
            {"count": state["count"] + 1}

    return Transformation(lambda params: {"count": 0}, update)


def adamw(schedule: Callable[[int], np.float32], b1: float, b2: float,
          eps: float = 1e-8) -> Transformation:
    """optax.adamw with a schedule and weight decay 0: adam, then
    -lr(count)."""
    return chain(scale_by_adam(b1, b2, eps),
                 scale_by_schedule(lambda count: -schedule(count)))


def masked(inner: Transformation, mask: Dict[str, bool]) -> Transformation:
    """inner on the paths whose mask is True; the others pass through."""
    def init(params):
        return inner.init({p: x for p, x in params.items() if mask[p]})

    def update(updates, state, params=None):
        sub = {p: u for p, u in updates.items() if mask[p]}
        sub_params = None if params is None else \
            {p: params[p] for p in sub}
        new, state = inner.update(sub, state, sub_params)
        return {p: new.get(p, u) for p, u in updates.items()}, state

    return Transformation(init, update)
