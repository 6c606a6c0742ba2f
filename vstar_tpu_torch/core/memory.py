"""Per-device memory accounting for sharded training (port of
vstar_tpu/core/memory.py, the "7B memory plan").

Parameters, f32 masters, AdamW moments and one gradient tree are placed
by the partition rules of core/mesh.py, and each leaf's bytes are
divided by its shard factor (the product of the mesh axes that shard
it after clipping), with JAX's integer arithmetic, so the port's plan is
JAX's to the byte on every mesh. Without a mesh every factor is 1: the
whole model on one device. The trainers print the plan and refuse one
that cannot fit before they allocate a byte of it: the plan reads only
shapes and dtypes, so a tree on the meta device (core/params.Init on
"meta") plans a model that is never built.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from .mesh import (AXES, DEFAULT_RULES, FSDP_AXIS, HIDDEN_RULES,
                   LAYER_STACK, MODEL_AXIS, TOWER_MATRICES, TP_BLOCKS,
                   _clip_spec_to_leaf, spec_for, takes_hidden_split)
from .params import leaves_with_path


@dataclass
class MemoryPlan:
    params_bytes: int          # parameter storage
    master_bytes: int          # f32 master copies (trainable leaves)
    moments_bytes: int         # AdamW mu+nu (f32, trainable leaves)
    grads_bytes: int           # one gradient tree (parameter dtype)
    n_params: int              # total parameter count

    @property
    def total_bytes(self) -> int:
        return (self.params_bytes + self.master_bytes + self.moments_bytes
                + self.grads_bytes)

    def summary(self) -> str:
        gb = 1024 ** 3
        return (f"params {self.params_bytes / gb:.2f} GB/chip, "
                f"masters {self.master_bytes / gb:.2f}, "
                f"moments {self.moments_bytes / gb:.2f}, "
                f"grads {self.grads_bytes / gb:.2f} "
                f"=> {self.total_bytes / gb:.2f} GB/chip "
                f"({self.n_params / 1e9:.2f}B params)")


def mesh_shape(mesh) -> Dict[str, int]:
    """None (one device), a (D, F, M) tuple, or anything with a `.shape`
    dict of axis sizes (core/mesh.Mesh) -> axis name -> size."""
    if mesh is None:
        return dict.fromkeys(AXES, 1)
    if isinstance(mesh, (tuple, list)):
        return dict(zip(AXES, mesh))
    return dict(mesh.shape)


def _shard_factor(spec, mesh_sizes: Dict[str, int]) -> int:
    f = 1
    for ax in spec:
        if ax is not None:
            f *= mesh_sizes[ax]
    return f


def plan_train_memory(params: Dict, mesh=None,
                      trainable_mask: Optional[Dict] = None,
                      master_f32: bool = True,
                      rules=DEFAULT_RULES) -> MemoryPlan:
    """Parameter + optimizer + gradient bytes per device under the rules
    core/mesh.shard_params applies, as JAX's plan counts them. `mesh`:
    None (one device), a (D, F, M) shape or a Mesh. `params` may live on
    the meta device."""
    sizes = mesh_shape(mesh)
    mask = (None if trainable_mask is None
            else dict(leaves_with_path(trainable_mask)))
    p_bytes = m_bytes = mom_bytes = g_bytes = n_params = 0
    for path, leaf in leaves_with_path(params):
        spec = _clip_spec_to_leaf(spec_for(path, rules), leaf.shape, sizes)
        factor = _shard_factor(spec, sizes)
        size = leaf.numel()
        itemsize = leaf.element_size()
        n_params += size
        p_bytes += size * itemsize // factor
        if mask is None or mask[path]:
            if master_f32 and itemsize < 4:
                m_bytes += size * 4 // factor
            mom_bytes += 2 * size * 4 // factor
            g_bytes += size * itemsize // factor  # grads in the param dtype
    return MemoryPlan(p_bytes, m_bytes, mom_bytes, g_bytes, n_params)


@dataclass
class EngineMemory:
    """What a rank holds of an engine's tree as core/mesh.serving_params
    places it: the decoder's layer stack (`stack_bytes`: on an fsdp axis
    above 1 on the hidden axis, 1/F, and 1/M of the blocks the model
    axis splits: the 1/(F M) of JAX's plan of the same tree) and every
    other leaf (`other_bytes`: gathered once, but for the towers'
    matrices the model axis splits)."""
    stack_bytes: int
    other_bytes: int

    @property
    def total_bytes(self) -> int:
        return self.stack_bytes + self.other_bytes

    def summary(self) -> str:
        gb = 1024 ** 3
        return (f"decoder stack {self.stack_bytes / gb:.2f} GB/chip, the "
                f"rest {self.other_bytes / gb:.2f} => "
                f"{self.total_bytes / gb:.2f} GB/chip")


def plan_engine_memory(params: Dict, mesh=None,
                       hidden_size: Optional[int] = None) -> EngineMemory:
    """EngineMemory of an engine's tree on `mesh` (as plan_train_memory
    takes it; `hidden_size`: the decoder's, default the embedding's
    width); `params` may live on the meta device."""
    sizes = mesh_shape(mesh)
    if hidden_size is None:
        hidden_size = params["llama"]["embed_tokens"].shape[-1]
    rules = DEFAULT_RULES
    if takes_hidden_split(params, sizes, hidden_size):
        rules = HIDDEN_RULES + DEFAULT_RULES
    stack = other = 0
    for path, leaf in leaves_with_path(params):
        spec = _clip_spec_to_leaf(spec_for(path, rules), leaf.shape, sizes)
        nbytes = leaf.numel() * leaf.element_size()
        if path.startswith(LAYER_STACK + "."):
            stack += nbytes // _shard_factor(spec, sizes)
        elif TOWER_MATRICES.fullmatch(path) and MODEL_AXIS in spec:
            other += nbytes // sizes[MODEL_AXIS]
        else:
            other += nbytes
    return EngineMemory(stack, other)


@dataclass
class StepMemory:
    """What the port's training step holds per device on top of JAX's
    plan (MemoryPlan, which counts one gradient tree in the parameters'
    dtype): with more than one micro-batch, the f32 accumulation buffers
    of train/accumulate.py and the largest gradient alive at once while
    they fill (a leaf's, or one layer's for a stacked leaf read layer by
    layer), else nothing of these (its gradient tree is the plan's); and
    the decoder layer the step gathers at a time (`layer_bytes`: every
    leaf of one layer whole but on the model axis, where a block the
    rules split keeps 1/M of its matrices, H/M heads); and beside it the
    next layer's slices in flight from their fsdp owners
    (`prefetch_bytes`: those of its leaves whose layer axis an fsdp axis
    above 1 shards, core/mesh.layer_source)."""
    accum_bytes: int
    largest_grad_bytes: int
    layer_bytes: int = 0
    prefetch_bytes: int = 0

    def summary(self) -> str:
        gb = 1024 ** 3
        return (f"the step adds f32 accumulation buffers "
                f"{self.accum_bytes / gb:.2f} GB/chip, largest gradient "
                f"{self.largest_grad_bytes / gb:.2f} GB, one gathered "
                f"decoder layer {self.layer_bytes / gb:.2f} GB and the next "
                f"in flight {self.prefetch_bytes / gb:.2f} GB")


def _is_layer_stack(path: str) -> bool:
    """A leaf of a stacked layer tree (`...layers.<name>`, leading layer
    axis), as opposed to a list of layers (`...layers.<i>....`)."""
    parts = path.split(".")
    if "layers" not in parts[:-1]:
        return False
    return not any(p.isdigit() for p in parts[parts.index("layers") + 1:])


def _gathered_layer_bytes(params: Dict, sizes: Dict[str, int],
                          rules) -> Tuple[int, int]:
    """One layer of the decoder's stack as core/mesh.layer_source hands it
    out: whole, but for the blocks whose matrices the (clipped) rules all
    split on a model axis above 1 (core/mesh.model_split), 1/M of those;
    and the part of it that its fsdp owners broadcast (the leaves whose
    layer axis an fsdp axis above 1 shards), which the training step
    fetches one layer ahead."""
    prefix = LAYER_STACK + "."
    stack = {p[len(prefix):]: x for p, x in leaves_with_path(params)
             if p.startswith(prefix)}
    M = sizes[MODEL_AXIS]
    local = set()
    for name, cols, rows in TP_BLOCKS:
        paths = [f"{name}.{k}" for k in cols + (rows,)]
        if M > 1 and all(p in stack and MODEL_AXIS in _clip_spec_to_leaf(
                spec_for(prefix + p, rules), stack[p].shape, sizes)
                for p in paths):
            local.update(paths)
    layer = prefetch = 0
    for p, x in stack.items():
        nbytes = x[0].numel() * x.element_size() // (M if p in local else 1)
        layer += nbytes
        spec = _clip_spec_to_leaf(spec_for(prefix + p, rules), x.shape,
                                  sizes)
        if sizes[FSDP_AXIS] > 1 and spec[:1] == (FSDP_AXIS,):
            prefetch += nbytes
    return layer, prefetch


def step_memory(params: Dict, mesh=None,
                trainable_mask: Optional[Dict] = None, num_micro: int = 1,
                rules=DEFAULT_RULES) -> StepMemory:
    """StepMemory of a step over `num_micro` micro-batches on `mesh` (as
    plan_train_memory takes it); `params` may live on the meta device."""
    sizes = mesh_shape(mesh)
    layer_bytes, prefetch = _gathered_layer_bytes(params, sizes, rules)
    if num_micro <= 1:
        return StepMemory(0, 0, layer_bytes, prefetch)
    mask = (None if trainable_mask is None
            else dict(leaves_with_path(trainable_mask)))
    accum = largest = 0
    for path, leaf in leaves_with_path(params):
        if not (leaf.is_floating_point() if mask is None else mask[path]):
            continue
        spec = _clip_spec_to_leaf(spec_for(path, rules), leaf.shape, sizes)
        local = [d // sizes[ax] if ax is not None else d
                 for d, ax in zip(leaf.shape, tuple(spec)
                                  + (None,) * leaf.dim())]
        numel = int(np.prod(local, dtype=np.int64))
        accum += 4 * numel
        if _is_layer_stack(path) and local:
            numel //= local[0]
        largest = max(largest, numel * leaf.element_size())
    return StepMemory(accum, largest, layer_bytes, prefetch)


def device_memory_gb(device: Union[str, torch.device]) -> Optional[float]:
    """The card's memory in GiB (torch.cuda.get_device_properties), None
    for a device without a fixed memory (the CPU)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_properties(device).total_memory / 1024 ** 3


def check_memory(plan: MemoryPlan, hbm_gb: Optional[float],
                 headroom: float = 0.75, what: str = "training",
                 step: Optional[StepMemory] = None) -> None:
    """Print the plan, and beside it `step` (what the port's step holds on
    top of it); raise MemoryError if the plan's static footprint exceeds
    `headroom` of the device's `hbm_gb` (the rest is activations and
    workspace): the refusal is JAX's, `step` only prints. hbm_gb None
    (the CPU) prints only."""
    extra = "" if step is None else f"; {step.summary()}"
    if hbm_gb is None:
        print(f"[memory] {what}: {plan.summary()}{extra} (no device "
              f"budget)", flush=True)
        return
    budget = hbm_gb * headroom * 1024 ** 3
    print(f"[memory] {what}: {plan.summary()}{extra} "
          f"(budget {budget / 1024**3:.1f} GB/chip)", flush=True)
    if plan.total_bytes > budget:
        raise MemoryError(
            f"{what} needs {plan.total_bytes / 1024**3:.2f} GB/chip of "
            f"static state but the budget is {budget / 1024**3:.1f} GB "
            f"({headroom:.0%} of {hbm_gb:.1f} GB device memory). Increase "
            f"the fsdp mesh axis (--mesh DxFxM under torchrun), use "
            f"--param_dtype bf16, or train fewer parameters (LoRA).")


def parse_mesh_arg(mesh_arg: Optional[str], n_devices: int,
                   default_fsdp: bool = True) -> Tuple[int, int, int]:
    """'DxFxM' -> mesh shape tuple, checked against the world size (one
    rank per device); None -> vstar_tpu's default (every device on the
    fsdp axis when there is more than one)."""
    if mesh_arg:
        parts = tuple(int(x) for x in mesh_arg.lower().split("x"))
        if len(parts) != 3:
            raise ValueError("--mesh must be DxFxM, e.g. 2x4x1")
        if int(np.prod(parts)) != n_devices:
            raise ValueError(
                f"--mesh {mesh_arg} needs {np.prod(parts)} devices (one "
                f"rank each), the world has {n_devices}; start "
                f"{np.prod(parts)} ranks with torchrun --nproc-per-node")
        return parts
    if n_devices > 1 and default_fsdp:
        return (1, n_devices, 1)
    return (n_devices, 1, 1)
