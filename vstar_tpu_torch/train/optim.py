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
A transformation is init(params) -> state and start(updates, state,
params) -> (leaf, state): `start` does what needs the whole tree (the
clip's global norm, the step's counts and constants), and leaf(path, u,
index=None) -> u' updates one leaf, or with `index` the block of its
flattened elements that `u` is (core/params.blocks, at); the new state
is whole once every element of every path of `updates` has passed
through `leaf`. Only a chain's first start reads the updates' values
(the clip); the others read their paths. optax's update(grads, state,
params) -> (updates, state) is the same over the whole tree
(`Transformation.update`). States are dicts, lists and ints, so a
checkpoint stores them with torch.save.

Like JAX's trainers, which jit their step with the state donated (XLA
fuses each leaf's clip, moments, master and parameter into one pass and
holds no whole tree of updates), a step applies its update one leaf at
a time, a large leaf block by block (train/sft.apply_step: each leaf's
temporaries and gradient dropped before the next leaf), and consumes
what it is given: the clip scales the gradients in place, Adam's
moments (and train/master.py's f32 masters) are updated in place and
Adam writes its bias-corrected first moment, then its update, into the
gradient's buffer, with the arithmetic of the functional form (the same
bits). Only a leaf whose result JAX would promote to another dtype gets
a new tensor. A 7B finetune's state then needs no second copy of its
moments, masters or updates during the update. The global norm sums a
leaf's squares by the same blocks (core/params.sum_squares): a leaf of
one block, every leaf of the tests, gives the sum it always gave; a
larger one's is its blocks' sums added in order.

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

from ..core.params import at, sum_squares

Flat = Dict[str, torch.Tensor]


class Transformation(NamedTuple):
    init: Callable
    start: Callable

    def update(self, updates: Flat, state, params=None):
        """optax's update: every leaf of `updates` through start's `leaf`
        -> (the updates, the new state)."""
        leaf, state = self.start(updates, state, params)
        return {p: leaf(p, u) for p, u in updates.items()}, state


def _keep(path: str, u: torch.Tensor, index=None) -> torch.Tensor:
    return u


class _OnDevice:
    """A step's scalar tensor cast to each (dtype, device) it meets, once
    (the same value the per-leaf `.to(dtype).to(device)` gives)."""

    def __init__(self, x: torch.Tensor):
        self.x, self.cast = x, {}

    def like(self, t: torch.Tensor) -> torch.Tensor:
        key = (t.dtype, t.device)
        if key not in self.cast:
            self.cast[key] = self.x.to(t.dtype).to(t.device)
        return self.cast[key]


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
    return torch.sqrt(sum(sum_squares(x) for x in tree.values()))


def chain(*transforms: Transformation) -> Transformation:
    """Each leaf through the transformations in turn (every start reads
    `updates` as given: only the first may read its values)."""
    def init(params):
        return [t.init(params) for t in transforms]

    def start(updates, state, params=None):
        leaves, new_state = [], []
        for t, s in zip(transforms, state):
            leaf, s = t.start(updates, s, params)
            leaves.append(leaf)
            new_state.append(s)

        def leaf(path, u, index=None):
            for f in leaves:
                u = f(path, u, index)
            return u
        return leaf, new_state

    return Transformation(init, start)


def clip_by_global_norm(max_norm: float) -> Transformation:
    """optax.clip_by_global_norm, scaling each leaf in place (one host
    read of the norm, at the start); on the shards of a sharded tree
    (`params` its core/mesh.Shards), over the shards of all ranks."""
    def start(updates, state, params=None):
        g_norm = global_norm(updates, params)
        if bool(g_norm < max_norm):
            return _keep, state
        norm = _OnDevice(g_norm)
        return (lambda path, t, index=None:
                t.div_(norm.like(t)).mul_(max_norm)), state

    return Transformation(lambda params: {}, start)


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

    def start(updates, state, params=None):
        count = state["count"] + 1
        bc1 = _OnDevice(1 - torch.tensor(b1, dtype=torch.float32) ** count)
        bc2 = _OnDevice(1 - torch.tensor(b2, dtype=torch.float32) ** count)
        mu, nu = {}, {}

        def leaf(p, g, index=None):
            m = _ema(state["mu"], mu, p, g, b1, index)
            v = _ema(state["nu"], nu, p, g * g, b2, index, scratch=True)
            # the moments keep the gradient's dtype exactly where the
            # update goes into its buffer (mu and nu share their dtype):
            # m_hat there first, then m_hat / (sqrt(v_hat) + eps)
            into = m.dtype == g.dtype
            m_hat = torch.div(m, bc1.like(m), out=g) if into \
                else m / bc1.like(m)
            # sqrt(v_hat) + eps, in v_hat's buffer
            denom = (v / bc2.like(v)).sqrt_().add_(eps)
            return m_hat.div_(denom) if into else m_hat / denom
        return leaf, {"count": count, "mu": mu, "nu": nu}

    return Transformation(init, start)


def _ema(old: Flat, new: Flat, p: str, x: torch.Tensor, decay: float,
         index=None, scratch: bool = False) -> torch.Tensor:
    """(1 - decay) x + decay m for the moment m = old[p] (its block at
    `index`), into m where the sum keeps m's dtype (new[p] is old[p]);
    where JAX's promotion changes it (a bf16 moment of an f32 gradient),
    into new[p], a new tensor of the promoted dtype. -> the block's new
    moment. scratch: x is a temporary, scaled in its own buffer."""
    m = at(old[p], index)
    a = x.mul_(1 - decay) if scratch else (1 - decay) * x
    dtype = torch.promote_types(a.dtype, m.dtype)
    if dtype != m.dtype:
        if p not in new:
            new[p] = torch.empty(old[p].shape, dtype=dtype, device=m.device)
        return torch.add(a, decay * m, out=at(new[p], index))
    new[p] = old[p]
    return m.mul_(decay).add_(a)


def scale_by_schedule(step_size_fn: Callable[[int], np.float32]
                      ) -> Transformation:
    def start(updates, state, params=None):
        step = float(step_size_fn(state["count"]))
        return (lambda p, g, index=None: g.mul_(step)), \
            {"count": state["count"] + 1}

    return Transformation(lambda params: {"count": 0}, start)


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

    def start(updates, state, params=None):
        sub = {p: u for p, u in updates.items() if mask[p]}
        sub_params = None if params is None else \
            {p: params[p] for p in sub}
        inner_leaf, state = inner.start(sub, state, sub_params)
        return (lambda p, u, index=None:
                inner_leaf(p, u, index) if mask[p] else u), state

    return Transformation(init, start)
