"""Device-memory accounting for training (port of vstar_tpu/core/memory.py,
the "7B memory plan") on one device.

The JAX package shards parameters and optimizer state over its mesh's
fsdp axis and divides each leaf's bytes by its shard factor. The port
trains on one device, so every factor is 1: the plan is what the whole
model, its f32 masters, its AdamW moments and one gradient tree take on
the card. The sharded factors come with the mesh (ROADMAP Queue 1
item 12). The trainers print the plan and refuse one that cannot fit
before they allocate a byte of it: the plan reads only shapes and dtypes,
so a tree on the meta device (core/params.Init on "meta") plans a model
that is never built.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

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


def plan_train_memory(params: Dict, trainable_mask: Optional[Dict] = None,
                      master_f32: bool = True) -> MemoryPlan:
    """Parameter + optimizer + gradient bytes on the one device, as the
    JAX plan counts them with every shard factor 1. `params` may live on
    the meta device."""
    mask = (None if trainable_mask is None
            else dict(leaves_with_path(trainable_mask)))
    p_bytes = m_bytes = mom_bytes = g_bytes = n_params = 0
    for path, leaf in leaves_with_path(params):
        size = leaf.numel()
        itemsize = leaf.element_size()
        n_params += size
        p_bytes += size * itemsize
        if mask is None or mask[path]:
            if master_f32 and itemsize < 4:
                m_bytes += size * 4
            mom_bytes += 2 * size * 4
            g_bytes += size * itemsize      # grads in the param dtype
    return MemoryPlan(p_bytes, m_bytes, mom_bytes, g_bytes, n_params)


def device_memory_gb(device: Union[str, torch.device]) -> Optional[float]:
    """The card's memory in GiB (torch.cuda.get_device_properties), None
    for a device without a fixed memory (the CPU)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_properties(device).total_memory / 1024 ** 3


def check_memory(plan: MemoryPlan, hbm_gb: Optional[float],
                 headroom: float = 0.75, what: str = "training") -> None:
    """Print the plan; raise MemoryError if the static footprint exceeds
    `headroom` of the device's `hbm_gb` (the rest is activations and
    workspace). hbm_gb None (the CPU) prints the plan only."""
    if hbm_gb is None:
        print(f"[memory] {what}: {plan.summary()} (no device budget)",
              flush=True)
        return
    budget = hbm_gb * headroom * 1024 ** 3
    print(f"[memory] {what}: {plan.summary()} "
          f"(budget {budget / 1024**3:.1f} GB/chip)", flush=True)
    if plan.total_bytes > budget:
        raise MemoryError(
            f"{what} needs {plan.total_bytes / 1024**3:.2f} GB/chip of "
            f"static state but the budget is {budget / 1024**3:.1f} GB "
            f"({headroom:.0%} of {hbm_gb:.1f} GB device memory). Use "
            f"--param_dtype bf16 or train fewer parameters (LoRA); "
            f"sharding over more devices (--mesh) comes with ROADMAP "
            f"Queue 1 item 12.")


def parse_mesh_arg(mesh_arg: Optional[str], n_devices: int,
                   default_fsdp: bool = True) -> Tuple[int, int, int]:
    """'DxFxM' -> mesh shape tuple; None -> vstar_tpu's default (every
    device on the fsdp axis when there is more than one). The port's
    trainers take one device, (1, 1, 1)."""
    if mesh_arg:
        parts = tuple(int(x) for x in mesh_arg.lower().split("x"))
        if len(parts) != 3:
            raise ValueError("--mesh must be DxFxM, e.g. 2x4x1")
        if int(np.prod(parts)) != n_devices:
            raise ValueError(f"--mesh {mesh_arg} needs {np.prod(parts)} "
                             f"devices, have {n_devices}")
        return parts
    if n_devices > 1 and default_fsdp:
        return (1, n_devices, 1)
    return (n_devices, 1, 1)
