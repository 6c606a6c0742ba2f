"""Device mesh and sharding over torch.distributed (port of
vstar_tpu/core/mesh.py).

The JAX package runs one controller over a (data, fsdp, model) mesh and
lets XLA insert the collectives. The port runs one process per device
(`torchrun --nproc-per-node N`), builds the same named mesh with
torch.distributed.device_mesh.init_device_mesh, and places each leaf by
the JAX package's rules: a parameter tree becomes a dict of DTensors,
each holding on its rank the shard the PartitionSpec names (clipped,
as in JAX, where an axis does not divide the leaf's dimension).

Training follows the ZeRO-3 / FSDP pattern the rules were written for
("gather one layer per scan step"): each rank of the data x fsdp product
takes its own rows of the step's batch, the ranks of one model group
take the same rows, and the fsdp and model axes shard storage
(parameters, f32 masters, AdamW moments). A forward gathers what it is
about to use into plain tensors:
  * `unshard(tree)` gathers every leaf outside the decoder's layer stack
    (embeddings, lm_head, norms, towers, projectors, heads);
  * `layer_source(stack)` gathers decoder layer i alone, from the rank
    of the fsdp axis that holds it, and the layer is dropped after use
    (and gathered again for the recompute under remat). In training the
    next layer's broadcast is in flight while layer i computes (the
    recompute's next is i - 1), as XLA's latency-hiding scheduler moves
    a layer's gather ahead of the previous layer: two layers live at
    most.
Where an axis has one rank nothing is gathered: the gathers hand out a
view of the shard (no copy) and still route its gradient.
Both are autograd functions whose backward sums the ranks' partial
gradients back onto the shards (reduce-scatter along a sharded axis, a
sum over a replicated one, the owner's sum for a layer), so a step on
the sharded tree is the one-device step on the whole batch. The sums
run over the data and fsdp axes only: the ranks of a model group
compute the same rows, and every leaf they hold whole (or gather whole)
gets the whole gradient on each of them, which the model split's
backward makes so (below); on the model axis a gather's backward keeps
its own chunk of that gradient.

The decoder computes the model axis as vstar_tpu's compiled step does,
tensor-parallel (Megatron-style), in training and in serving: where the
rules split a block's matrices on the model axis, each rank keeps its
own columns of wq / wk / wv / w_gate / w_up and rows of wo / w_down
(`model_split`; the layer gather hands them out model-local), computes
its own heads and MLP columns, and the products of wo and w_down are
partial sums that `ModelSplit.reduce` adds over the model group (an
all-reduce in f32, Megatron's g: its backward is the identity). The
block's input enters through `ModelSplit.enter` (Megatron's f: the
identity forward, one all-reduce of the gradients over the model group
backward), and so does what the block uses whole of LoRA (x @ A, B,
the scale): their gradients, partial on each rank, come out whole. The
vision towers' matrices, which VISION_RULES split on the model axis,
stay each rank's shard (`model_local_leaves`; nn/vit.py computes on
them as XLA partitions the tower), and so does a training tree's
lm_head where the rules split its vocabulary (not at 7B, whose 32003
rows divide by nothing): the loss then computes the log-softmax over
the model group (train/sft.next_token_logprobs). An engine's tree
(`serving_params`) gathers every other leaf once; its KV cache holds the
rank's own heads. A block whose matrices the rules do not all split on
model (a quantized block: its leaves' spec is P('fsdp')) is gathered
and computed whole, as XLA computes it.

An engine's decoder computes the fsdp axis as vstar_tpu's compiled
engine programs do: their HLO reshards the layer stack from the layer
axis onto the hidden axis D (all-to-alls in ENTRY, outside every loop)
and carries the residual stream split on D. `serving_params` places the
stack so once, at build (HIDDEN_RULES: each rank keeps its 1/F of D of
every layer matrix and norm scale, beside the model split), and
`hidden_split` gives llama_forward a ModelSplit over the fsdp group: a
layer's rmsnorm moments and its q / k / v and gate / up products are
f32 partial sums all-reduced over that group, wo and w_down give the
rank's own columns of D, and `layer_source` hands out the rank's share
with no collective; quantized entries split so too (their products are
summed as their kernels return them; under act-int8 each product
group's row max is all-reduced first, and the int8 entries' partial
products are summed in int32, as XLA computes vstar_tpu's _w8a8_dot on
the split). Training keeps the owner's
broadcast, and so does a stack this split does not take (a hidden size,
or int4 groups, that F does not divide).

Collectives are plain torch.distributed calls on the axes' process
groups: NCCL on cards, gloo on the CPU. `collectives` counts them by
operation and axis.
"""

from __future__ import annotations

import math
import os
import re
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..kernels import _build
from .params import (Params, layer, leaves_with_path, map_with_path,
                     read_layer, sum_squares)

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, FSDP_AXIS, MODEL_AXIS)

# The decoder's layer stack: gathered one layer at a time, never whole.
LAYER_STACK = "llama.layers"

# ---------------------------------------------------------------------------
# Partition rules: dotted-param-path regex -> spec (vstar_tpu's, as tuples;
# entry d names the mesh axis that shards tensor dim d, None replicates)
# ---------------------------------------------------------------------------

LLAMA_RULES: Tuple[Tuple[str, tuple], ...] = (
    # vocab (32003) divides nothing; shard the hidden dim over fsdp.
    (r".*embed_tokens$", (MODEL_AXIS, FSDP_AXIS)),
    (r".*lm_head$", (FSDP_AXIS, MODEL_AXIS)),
    # attention: q/k/v project hidden->heads*dim; shard heads (out) on model
    (r".*\b(wq|wk|wv)$", (FSDP_AXIS, None, MODEL_AXIS)),
    (r".*\bwo$", (FSDP_AXIS, MODEL_AXIS, None)),
    # MLP: gate/up shard hidden_out over model, down shards hidden_in
    (r".*\b(w_gate|w_up)$", (FSDP_AXIS, None, MODEL_AXIS)),
    (r".*\bw_down$", (FSDP_AXIS, MODEL_AXIS, None)),
    # stacked per-layer norm scales [L, D]: shard the layer stack
    (r".*layers\..*(norm|ln)[^.]*\.(scale|bias)$", (FSDP_AXIS,)),
    (r".*(norm|ln)([^.]*|[^.]*\.(scale|bias))$", ()),
)

# Vision towers: stacked [L, in, out] weights, fsdp on the layer stack,
# model inside the MLP; everything else falls through to the default.
VISION_RULES: Tuple[Tuple[str, tuple], ...] = (
    (r".*\bfc1\.w$", (FSDP_AXIS, None, MODEL_AXIS)),
    (r".*\bfc2\.w$", (FSDP_AXIS, MODEL_AXIS, None)),
    (r".*\b(wq|wk|wv|wo)\.w$", (FSDP_AXIS, None, MODEL_AXIS)),
)

DEFAULT_RULES = LLAMA_RULES + VISION_RULES

# ZeRO-3-style default: shard the leading dim over fsdp whenever it
# divides (clipping drops it otherwise).
_FALLBACK = (FSDP_AXIS,)

# An engine's decoder stack on the hidden axis D (module docstring): the
# split the HLO of vstar_tpu's engine programs reshards the stack onto
# (tests/test_torch_mesh.py reads it), with the model axis where
# LLAMA_RULES put it. Ahead of DEFAULT_RULES in serving_params only.
HIDDEN_RULES: Tuple[Tuple[str, tuple], ...] = (
    (r"llama\.layers\.(attn\.(wq|wk|wv)|mlp\.(w_gate|w_up))$",
     (None, FSDP_AXIS, MODEL_AXIS)),
    (r"llama\.layers\.(attn\.wo|mlp\.w_down)$",
     (None, MODEL_AXIS, FSDP_AXIS)),
    (r"llama\.layers\.(input_norm|post_norm)\.scale$", (None, FSDP_AXIS)),
    # LoRA: A on the hidden axis (x @ A is a partial sum), B and the scale
    # whole on every rank
    (r"llama\.layers\.attn\.lora\.\w+_a$", (None, FSDP_AXIS)),
    (r"llama\.layers\.attn\.lora(\.\w+_b|_scale)$", ()),
    # quantized entries (nn/quant.py; whole on the model axis, as their
    # P('fsdp') leaves are in JAX): the int8 / int4 weights and the int4
    # group scales on the rows or columns of D; the int8 per-column scales
    # of the column-split matrices whole
    (r"llama\.layers\.(attn\.(wq|wk|wv)|mlp\.(w_gate|w_up))\.(q|q4|s4)$",
     (None, FSDP_AXIS)),
    (r"llama\.layers\.(attn\.(wq|wk|wv)|mlp\.(w_gate|w_up))\.s$", ()),
    (r"llama\.layers\.(attn\.wo|mlp\.w_down)\.(q|s|q4|s4)$",
     (None, None, FSDP_AXIS)),
)


def spec_for(path: str, rules=DEFAULT_RULES) -> tuple:
    for pattern, spec in rules:
        if re.match(pattern, path):
            return spec
    return _FALLBACK


def partition_specs(params: Params, rules=DEFAULT_RULES) -> Params:
    """Spec tree mirroring `params`, clipped to each leaf's rank."""
    return map_with_path(
        lambda path, leaf: tuple(spec_for(path, rules))[:leaf.dim()], params)


def _clip_spec_to_leaf(spec: tuple, shape: Sequence[int],
                       mesh_shape: Dict[str, int]) -> tuple:
    """Drop sharding on axes that do not divide the leaf's dimension
    (keeps tiny configs valid on wide meshes) and clip to the leaf's
    rank. `mesh_shape`: axis name -> size (a Mesh's `.shape`)."""
    return tuple(None if ax is None or shape[i] % mesh_shape[ax] else ax
                 for i, ax in enumerate(tuple(spec)[:len(shape)]))


# ---------------------------------------------------------------------------
# Ranks, devices, the mesh
# ---------------------------------------------------------------------------

def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """Rank 0 (or a process without a process group): the one that writes
    logs, metrics and outputs."""
    return rank() == 0


def init_distributed(device) -> int:
    """The world size, joining the process group that torchrun describes
    (WORLD_SIZE, MASTER_ADDR, ...) when the process has none yet: NCCL
    for a card, gloo for the CPU. A process started without torchrun and
    without a group is a world of one."""
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ \
            and "MASTER_ADDR" in os.environ:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
        if backend == "nccl":
            torch.cuda.set_device(rank_device(device))
        dist.init_process_group(backend)
    return world_size()


def rank_device(device) -> torch.device:
    """A bare "cuda" is this rank's card, cuda:{LOCAL_RANK}; any other
    device is kept."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


class Mesh:
    """A (data, fsdp, model) DeviceMesh over the world of ranks.

    `shape` maps axis name -> size (as a jax Mesh's), `groups` each axis
    to its process group, `coord` each axis to this rank's index on it."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.shape = {a: device_mesh.size(i) for i, a in enumerate(AXES)}
        self.groups = {a: device_mesh.get_group(a) for a in AXES}
        self.coord = {a: device_mesh.get_local_rank(a) for a in AXES}
        self.size = device_mesh.size()
        device_mesh._vstar_mesh = self

    @staticmethod
    def of(device_mesh) -> "Mesh":
        return getattr(device_mesh, "_vstar_mesh", None) or Mesh(device_mesh)

    @property
    def dims(self) -> Tuple[int, int, int]:
        return tuple(self.shape[a] for a in AXES)

    @property
    def coords(self) -> Tuple[int, int, int]:
        """This rank's coordinate on each axis, in AXES order."""
        return tuple(self.coord[a] for a in AXES)

    def placements(self, spec: tuple) -> tuple:
        """A clipped spec -> one DTensor placement per mesh axis."""
        return tuple(Shard(spec.index(a)) if a in spec else Replicate()
                     for a in AXES)

    def replicated(self) -> tuple:
        """JAX's `replicated(mesh)`: the placements of a leaf every rank
        holds whole."""
        return self.placements(())

    def data_sharding(self, ndim: int = 1) -> tuple:
        """JAX's `data_sharding(mesh, ndim)`: the leading (batch) dim over
        the data axis. The port's steps split rows over the data x fsdp
        ranks instead (`local_rows`); this is the layout of a data-only
        split."""
        return self.placements((DATA_AXIS,) + (None,) * (ndim - 1))

    def __repr__(self) -> str:
        return f"Mesh({'x'.join(str(n) for n in self.dims)})"

    # --- the batch: each data x fsdp rank takes its own rows ----------------

    @property
    def row_ranks(self) -> int:
        """The ranks that take rows of their own: data x fsdp (the ranks of
        one model group take the same rows)."""
        return self.shape[DATA_AXIS] * self.shape[FSDP_AXIS]

    def local_rows(self, batch: Dict[str, torch.Tensor], num_micro: int = 1
                   ) -> Dict[str, torch.Tensor]:
        """This rank's rows of a step's batch: micro-batch i of the global
        batch (rows [i m, (i + 1) m)) is split over the data x fsdp ranks
        in their order, so that the local micro-batch i is this rank's
        share of the global one and every normaliser can be summed over
        those ranks (`batch_sum`); the ranks of a model group take the
        same share."""
        n = max(num_micro, 1)
        w = self.row_ranks
        r = self.coord[DATA_AXIS] * self.shape[FSDP_AXIS] \
            + self.coord[FSDP_AXIS]
        out = {}
        for k, v in batch.items():
            rows = v.shape[0]
            if rows % (n * w):
                raise ValueError(
                    f"{k}: {rows} rows in {n} micro-batches do not split "
                    f"over the mesh's {w} data x fsdp ranks")
            m = rows // n
            out[k] = v.reshape(n, m, *v.shape[1:])[
                :, r * m // w:(r + 1) * m // w].reshape(-1, *v.shape[1:])
        return out

    def batch_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the data x fsdp ranks' rows (a count, a partial
        loss), each row once; no gradient flows through it."""
        x = x.detach().clone()
        for ax in (DATA_AXIS, FSDP_AXIS):
            if self.shape[ax] > 1:
                _count("all_reduce", ax)
                _all_reduce(x, self.groups[ax])
        return x

    def sum_squares(self, tree: Dict[str, torch.Tensor],
                    replicas: Dict[str, int]) -> torch.Tensor:
        """sum over leaves of sum(x * x) of the whole (unsharded) tree, from
        the local shards of `tree` (path -> tensor): each leaf's local sum
        (core/params.sum_squares)
        divided by `replicas[path]`, the number of ranks holding the same
        shard (1 where absent), all leaves reduced at once (in f32), then
        added in the tree's order in the leaves' dtypes, as
        optim.global_norm adds them on one device."""
        dtypes = [x.dtype for x in tree.values()]
        parts = torch.stack([sum_squares(x).float() for x in tree.values()])
        reps = [replicas.get(p, 1) for p in tree]
        if any(r != 1 for r in reps):
            parts = parts / torch.tensor(reps, dtype=parts.dtype,
                                         device=parts.device)
        if self.size > 1:
            _count("all_reduce", "world")
            _all_reduce(parts, None)
        total = parts[0].to(dtypes[0])
        for x, dtype in zip(parts[1:], dtypes[1:]):
            total = total + x.to(dtype)
        return total


def make_mesh(shape: Optional[Tuple[int, int, int]] = None,
              device_type: str = "cuda") -> Mesh:
    """The (data, fsdp, model) mesh over the world of ranks; the default
    is (world, 1, 1). The product must be the world size."""
    from torch.distributed.device_mesh import init_device_mesh
    n = world_size()
    shape = tuple(shape) if shape is not None else (n, 1, 1)
    if len(shape) != 3 or math.prod(shape) != n:
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, the "
                         f"world has {n}")
    return Mesh(init_device_mesh(device_type, shape, mesh_dim_names=AXES))


def resolve_mesh(mesh_arg, device) -> Optional[Mesh]:
    """--mesh ('DxFxM', None, or a Mesh) -> the Mesh of this world, or
    None for a process without a process group (a world of one, where
    only None and 1x1x1 are valid: the one-device path). A shape whose
    product is not the world size raises, naming both numbers."""
    if isinstance(mesh_arg, Mesh):
        return mesh_arg
    from .memory import parse_mesh_arg
    n = init_distributed(device)
    shape = parse_mesh_arg(mesh_arg, n)
    if not dist.is_initialized():
        return None
    return make_mesh(shape, torch.device(device).type)


# ---------------------------------------------------------------------------
# Sharding a tree
# ---------------------------------------------------------------------------

def global_slice(shape: Sequence[int], placements, sizes: Sequence[int],
                 coord: Sequence[int]) -> Tuple[Tuple[int, ...],
                                                Tuple[int, ...]]:
    """(offset, extent) in a leaf of global `shape` of the block that the
    rank at mesh coordinate `coord` (one index per mesh axis, of `sizes`)
    holds under `placements` (one per mesh axis): each Shard(d) cuts dim
    d as torch.chunk and DTensor do, axis after axis (chunks of ceil(n /
    k), the last one short, ranks past the end empty); Replicate keeps
    it. The one source of a shard's offsets: shard_params, and the
    sharded checkpoints' writer and reader (core/checkpoint.py), take
    theirs from it."""
    offset, extent = [0] * len(shape), list(shape)
    for pl, k, i in zip(placements, sizes, coord):
        if isinstance(pl, Shard):
            n = extent[pl.dim]
            step = -(-n // k)
            lo = min(i * step, n)
            offset[pl.dim] += lo
            extent[pl.dim] = min(lo + step, n) - lo
        elif not isinstance(pl, Replicate):
            raise ValueError(f"placement {pl}: only Shard and Replicate "
                             "leaves have a global slice")
    return tuple(offset), tuple(extent)


def local_slice(x: DTensor) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(offset, extent) of this rank's shard of `x` in the whole leaf."""
    dm = x.device_mesh
    return global_slice(x.shape, x.placements, dm.shape,
                        dm.get_coordinate())


def slices(offset: Sequence[int], extent: Sequence[int]) -> tuple:
    """The index of the block (offset, extent)."""
    return tuple(slice(o, o + e) for o, e in zip(offset, extent))


def _local_chunk(x: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    return x[slices(*global_slice(x.shape, mesh.placements(spec),
                                  mesh.dims, mesh.coords))]


def shard_params(params: Params, mesh: Mesh, rules=DEFAULT_RULES) -> Params:
    """The tree as DTensors placed by the rules: each rank keeps (a copy
    of) its own shard of the full tensor it was given, with no
    communication (every rank builds or loads the same full tree)."""
    def _put(path, leaf):
        spec = _clip_spec_to_leaf(spec_for(path, rules), leaf.shape,
                                  mesh.shape)
        placements = mesh.placements(spec)
        local = _local_chunk(leaf.detach(), spec, mesh).clone(
            memory_format=torch.contiguous_format)
        return DTensor.from_local(local, mesh.device_mesh, placements,
                                  run_check=False)
    return map_with_path(_put, params)


def mesh_of(tree: Params) -> Optional[Mesh]:
    """The Mesh of the first DTensor leaf of `tree`, None if it has none."""
    for _, x in leaves_with_path(tree):
        if isinstance(x, DTensor):
            return Mesh.of(x.device_mesh)
    return None


def with_local(like: DTensor, local: torch.Tensor) -> DTensor:
    """`local` as the shard of a DTensor placed as `like`."""
    return DTensor.from_local(local, like.device_mesh, like.placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride())


def replica_count(x: DTensor) -> int:
    """How many ranks hold the same shard of `x` as this one: the product
    of the sizes of the mesh axes that do not shard it."""
    return math.prod(x.device_mesh.size(i)
                     for i, pl in enumerate(x.placements)
                     if not isinstance(pl, Shard))


class Shards(dict):
    """path -> this rank's shard (a plain tensor) of each leaf of a flat
    tree, with what a sum over the whole tree needs: `mesh` (the tree's
    Mesh, None for a tree without DTensors) and `replicas` (path -> the
    replica_count of each DTensor leaf, read from its placements)."""

    def __init__(self, flat: Dict[str, torch.Tensor]):
        super().__init__((p, x.to_local() if isinstance(x, DTensor) else x)
                         for p, x in flat.items())
        self.mesh = mesh_of(flat)
        self.replicas = {p: replica_count(x) for p, x in flat.items()
                         if isinstance(x, DTensor)}


def local_leaves(flat: Dict[str, torch.Tensor]) -> Shards:
    """path -> this rank's shard (a plain tensor) of each DTensor leaf."""
    return Shards(flat)


# ---------------------------------------------------------------------------
# Collectives and the differentiable gathers
# ---------------------------------------------------------------------------

# the names of newer torch releases (the older ones warn there)
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


# Collective calls by (operation, axis): operation "all_reduce",
# "all_gather", "reduce_scatter" or "broadcast", axis a mesh axis or
# "world". A launch counter (kernels/_build.COUNTERS), so that the decode
# graphs replay what a capture counted.
collectives: Dict[Tuple[str, str], int] = {}
_build.register_counters(__name__, "collectives")


# The collectives that fetch decoder layers (layer_source: a broadcast
# from the fsdp owner, a gather inside the layer) by (operation, axis),
# counted in `collectives` too; an engine's stack on the hidden axis
# runs none.
fetch_collectives: Dict[Tuple[str, str], int] = {}
_build.register_counters(__name__, "fetch_collectives")


def _count(op: str, axis: str, fetch: bool = False) -> None:
    key = (op, axis)
    collectives[key] = collectives.get(key, 0) + 1
    if fetch:
        fetch_collectives[key] = fetch_collectives.get(key, 0) + 1


def _all_reduce(x: torch.Tensor, group) -> None:
    dist.all_reduce(x, group=group)


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Concatenate the group's shards along `dim`, in group rank order."""
    n = dist.get_world_size(group)
    x = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _ALL_GATHER(out, x, group=group)
    return out.movedim(0, dim).contiguous()


def _reduce_scatter(g: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's sum of `g`, this rank's chunk along `dim`."""
    n = dist.get_world_size(group)
    g = g.movedim(dim, 0).contiguous()
    out = torch.empty((g.shape[0] // n, *g.shape[1:]), dtype=g.dtype,
                      device=g.device)
    _REDUCE_SCATTER(out, g, group=group)
    return out.movedim(0, dim).contiguous()


def _reduce_replicated(g: torch.Tensor, mesh: Mesh, placements,
                       skip: Tuple[str, ...] = ()) -> torch.Tensor:
    """Sum a gradient over the data and fsdp axes on which its leaf is
    replicated (the ranks there computed partial gradients of the same
    shard, from their own rows); never over the model axis, whose ranks
    computed the same rows and hold the same gradient."""
    for ax, pl in zip(AXES, placements):
        if ax != MODEL_AXIS and ax not in skip \
                and isinstance(pl, Replicate) and mesh.shape[ax] > 1:
            g = g.contiguous()
            _count("all_reduce", ax)
            _all_reduce(g, mesh.groups[ax])
    return g


def _own_chunk(g: torch.Tensor, mesh: Mesh, placements,
               offset: int = 0) -> torch.Tensor:
    """A gradient that every rank of the model group computed whole (the
    same rows, the same leaf) -> this rank's chunk of it on the model
    axis where the leaf is sharded there (dim - `offset` of `g`), with no
    communication."""
    pl = placements[AXES.index(MODEL_AXIS)]
    if isinstance(pl, Shard) and mesh.shape[MODEL_AXIS] > 1:
        g = g.chunk(mesh.shape[MODEL_AXIS], pl.dim - offset)[
            mesh.coord[MODEL_AXIS]]
    return g


class _Gather(torch.autograd.Function):
    """local shard -> the whole leaf (with `model_local`, still this rank's
    shard on the model axis); backward: the data x fsdp ranks' summed
    gradient, this rank's shard of it."""

    @staticmethod
    def forward(ctx, local, mesh, placements, model_local):
        ctx.mesh, ctx.placements = mesh, placements
        ctx.model_local = model_local
        out = local
        for ax, pl in zip(AXES, placements):
            if isinstance(pl, Shard) and mesh.shape[ax] > 1 and \
                    not (model_local and ax == MODEL_AXIS):
                _count("all_gather", ax)
                out = _all_gather(out, pl.dim, mesh.groups[ax])
        return out.view_as(out) if out is local else out

    @staticmethod
    def backward(ctx, g):
        mesh, placements = ctx.mesh, ctx.placements
        if not ctx.model_local:
            g = _own_chunk(g, mesh, placements)
        for ax, pl in zip(AXES, placements):
            if isinstance(pl, Shard) and ax != MODEL_AXIS and \
                    mesh.shape[ax] > 1:
                _count("reduce_scatter", ax)
                g = _reduce_scatter(g, pl.dim, mesh.groups[ax])
        return _reduce_replicated(g, mesh, placements), None, None, None


def _from_owner(part: torch.Tensor, mesh: Mesh, owner: int,
                async_op: bool = False):
    """Layer slice `part` of fsdp rank `owner`, broadcast over the fsdp
    group (the other ranks' `part` only gives shape and dtype): (the
    layer, the broadcast's work while it is in flight (`async_op`), else
    None). The owner broadcasts a copy of `part`: gloo's CUDA broadcast
    writes its result back on every rank, the source's too, and `part`
    is a view of a parameter."""
    group = mesh.groups[FSDP_AXIS]
    if mesh.coord[FSDP_AXIS] == owner:
        out = part.clone(memory_format=torch.contiguous_format)
    else:
        out = torch.empty_like(part, memory_format=torch.contiguous_format)
    _count("broadcast", FSDP_AXIS, fetch=True)
    return out, dist.broadcast(out, src=dist.get_global_rank(group, owner),
                               group=group, async_op=async_op)


class _GatherLayer(torch.autograd.Function):
    """Layer i of a stack (dim 0 the layer axis), the other axes gathered
    inside the layer (with `model_local`, all but the model axis).
    `owner` is the fsdp rank holding layer i when fsdp shards the layer
    axis: `fetched` is its slice as broadcast over the fsdp group
    (`_from_owner`; `part` is this rank's slice j of its local stack,
    which the owner hands out itself). `owner` None: this rank holds the
    layer. Nothing gathered: a view of `part`. Backward: the data x fsdp
    ranks' summed gradient, which on a sharded layer axis only the owner
    keeps (the other ranks' slices get none from it)."""

    @staticmethod
    def forward(ctx, part, mesh, placements, owner, model_local, fetched):
        ctx.mesh, ctx.placements, ctx.owner = mesh, placements, owner
        ctx.model_local = model_local
        ctx.keep = owner is None or mesh.coord[FSDP_AXIS] == owner
        out = part if ctx.keep else fetched
        for ax, pl in zip(AXES, placements):
            if isinstance(pl, Shard) and mesh.shape[ax] > 1 and \
                    not (ax == FSDP_AXIS and owner is not None) \
                    and not (ax == MODEL_AXIS and model_local):
                _count("all_gather", ax, fetch=True)
                out = _all_gather(out, pl.dim - 1, mesh.groups[ax])
        return out.view_as(out) if out is part else out

    @staticmethod
    def backward(ctx, g):
        mesh, placements, owner = ctx.mesh, ctx.placements, ctx.owner
        stacked = (FSDP_AXIS,) if owner is not None else ()
        if not ctx.model_local:
            g = _own_chunk(g, mesh, placements, offset=1)
        for ax, pl in zip(AXES, placements):
            if isinstance(pl, Shard) and mesh.shape[ax] > 1 and \
                    ax not in stacked + (MODEL_AXIS,):
                _count("reduce_scatter", ax)
                g = _reduce_scatter(g, pl.dim - 1, mesh.groups[ax])
        g = g.contiguous()
        if owner is not None and mesh.shape[FSDP_AXIS] > 1:
            _count("all_reduce", FSDP_AXIS)
            _all_reduce(g, mesh.groups[FSDP_AXIS])
        g = _reduce_replicated(g, mesh, placements, skip=stacked)
        return (g if ctx.keep else None), None, None, None, None, None


def _moves_nothing(mesh: Mesh, placements, model_local: bool) -> bool:
    """Whether gathering a leaf placed `placements` runs no collective and
    touches no value either way: the data and fsdp axes have one rank,
    and on the model axis the leaf is whole, or kept as this rank's
    shard (`model_local`), or the axis has one rank too (a 1x1x1 mesh
    always). Its gather is then the shard itself, as on one device."""
    if mesh.shape[DATA_AXIS] > 1 or mesh.shape[FSDP_AXIS] > 1:
        return False
    return mesh.shape[MODEL_AXIS] == 1 or model_local or \
        not isinstance(placements[AXES.index(MODEL_AXIS)], Shard)


def full(x, split: Optional["ModelSplit"] = None):
    """A DTensor leaf as the whole plain tensor, or with a model `split`
    its shard on the model axis (whole on the others), which then
    carries the split as its `model_split` attribute; differentiable:
    the backward sums the ranks' gradients onto the shards. Where that
    moves nothing (`_moves_nothing`), a view of the shard. Other leaves
    unchanged."""
    if not isinstance(x, DTensor):
        return x
    mesh, placements = Mesh.of(x.device_mesh), tuple(x.placements)
    local = x.to_local()
    if _moves_nothing(mesh, placements, split is not None):
        out = local.view_as(local)
    else:
        out = _Gather.apply(local, mesh, placements, split is not None)
    if split is not None:
        out.model_split = split
    return out


def unshard(tree: Params, keep: Optional[str] = LAYER_STACK,
            model_local: Optional[Dict[str, "ModelSplit"]] = None
            ) -> Params:
    """Every DTensor leaf gathered whole, except those under the path
    prefix `keep` (the decoder's layer stack, which `layer_source`
    gathers one layer at a time); the leaves at the paths of
    `model_local` (`model_local_leaves`) keep this rank's shard on the
    model axis and carry their split. A tree without DTensors comes back
    as it is."""
    if mesh_of(tree) is None:
        return tree
    prefix = None if keep is None else keep + "."
    local = model_local or {}
    return map_with_path(
        lambda path, x: x if prefix and path.startswith(prefix)
        else full(x, local.get(path)), tree)


class _SideWork:
    """A layer's broadcast issued on a side stream: wait() makes the
    current stream wait for it and marks the layer's buffer as used
    there (so that its memory is not handed out again before that
    use)."""

    def __init__(self, done: torch.cuda.Event, buf: torch.Tensor):
        self.done, self.buf = done, buf

    def wait(self) -> None:
        stream = torch.cuda.current_stream(self.buf.device)
        stream.wait_event(self.done)
        self.buf.record_stream(stream)


def _layer_owner(pl: tuple, mesh: Mesh, n_layers: int, i: int
                 ) -> Tuple[Optional[int], int]:
    """(the fsdp rank holding layer i of a stack leaf placed `pl`, or None
    where the layer axis is not sharded on fsdp; i's index in that rank's
    local stack)."""
    fs = pl[AXES.index(FSDP_AXIS)]
    if isinstance(fs, Shard) and fs.dim == 0:
        per = n_layers // mesh.shape[FSDP_AXIS]
        return i // per, i % per
    return None, i


def layer_source(stack: Params, prefetch: bool = False):
    """i -> layer i of a stacked layer tree as plain tensors. For a stack
    of DTensors the layer is gathered from its owner on the fsdp axis and
    the other axes (the whole stack is never gathered), except on the
    model axis for the matrices of the blocks the model axis splits
    (`model_split`), which keep this rank's shard; an engine's stack on
    the hidden axis (HIDDEN_RULES) is this rank's share as it lies, with
    no collective; otherwise it is core/params.layer's view.

    prefetch (training: the forward and its recompute under remat): the
    owners' broadcasts of the next layer go out before layer i is handed
    over (on a card on a side stream, so that they run beside layer i's
    compute), and that layer waits on them only when it is fetched; the
    next is i + 1 in the forward and i - 1 in the backward's recompute,
    which walks the layers down. At most one layer is in flight ahead
    (core/memory.step_memory counts it). Without, each layer's
    broadcasts complete before it is handed over."""
    flat = dict(leaves_with_path(stack))
    if not any(isinstance(x, DTensor) for x in flat.values()):
        return lambda i: layer(stack, i)
    local_paths = {f"{name}.{k}" for name, cols, rows in TP_BLOCKS
                   if name in _split_blocks(stack)[1]
                   for k in cols + (rows,)}
    parts = {}
    for path, x in flat.items():
        mesh = Mesh.of(x.device_mesh)
        pl = tuple(x.placements)
        # a leaf with a layer-gradient sink (train/accumulate.py) hands
        # each local slice's gradient to it, read from the sink's plain
        # local tensor; the others unbind their local shard once
        sink = getattr(x, "layer_grad_sink", None)
        local = x.to_local() if sink is None else sink.tensor
        slices = local.unbind(0) if sink is None else None
        parts[path] = (mesh, pl, local, slices, sink, x.shape[0],
                       path in local_paths)
    n_layers = next(iter(parts.values()))[5]
    pending: Dict[int, Dict[str, tuple]] = {}
    side = []      # the card's side stream of the prefetched broadcasts

    def issue(i: int, ahead: bool) -> Dict[str, tuple]:
        """Layer i's slices broadcast from their owners: path -> (layer,
        work to wait on, or None) for each leaf whose layer axis an fsdp
        axis above 1 shards. `ahead`: left in flight, on a card on a
        side stream (as FSDP's unshard stream) that starts where the
        current stream stands, on the CPU as gloo's asynchronous
        broadcasts."""
        todo = {}
        for path, (mesh, pl, local, _, _, n, _) in parts.items():
            owner, j = _layer_owner(pl, mesh, n, i)
            if owner is not None and mesh.shape[FSDP_AXIS] > 1:
                todo[path] = (local.detach()[j], mesh, owner)
        device = next(iter(todo.values()))[0].device if todo else None
        if not ahead or device is None or device.type != "cuda":
            return {path: _from_owner(*args, async_op=ahead)
                    for path, args in todo.items()}
        if not side:
            side.append(torch.cuda.Stream(device))
        side[0].wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side[0]):
            out = {path: _from_owner(*args)[0]
                   for path, args in todo.items()}
            done = torch.cuda.Event()
            done.record(side[0])
        return {path: (buf, _SideWork(done, buf))
                for path, buf in out.items()}

    def fetch(i: int):
        fetched = pending.pop(i, None)
        if fetched is None:
            fetched = issue(i, ahead=False)
        if prefetch:
            nxt = i + 1 if _phase() == "forward" else i - 1
            if 0 <= nxt < n_layers and nxt not in pending:
                pending[nxt] = issue(nxt, ahead=True)
        got = {}
        for path, (mesh, pl, local, slices, sink, n,
                   model_local) in parts.items():
            owner, j = _layer_owner(pl, mesh, n, i)
            part = slices[j] if sink is None else read_layer(local, j, sink)
            buf = None
            if path in fetched:
                buf, work = fetched[path]
                if work is not None:
                    work.wait()
            fs = pl[AXES.index(FSDP_AXIS)]
            if isinstance(fs, Shard) and fs.dim > 0:
                got[path] = part                # on the hidden axis
            elif _moves_nothing(mesh, pl, model_local):
                got[path] = part                # as on one device
            elif model_local and not torch.is_grad_enabled():
                got[path] = part if buf is None else buf
            else:
                got[path] = _GatherLayer.apply(part, mesh, pl, owner,
                                               model_local, buf)
        return _unflatten(got)
    return fetch


def _unflatten(flat: Dict[str, torch.Tensor]) -> Params:
    out: Dict = {}
    for path, x in flat.items():
        node = out
        *head, last = path.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = x
    return out


@torch.no_grad()
def full_tree(tree: Params) -> Params:
    """Every leaf whole as a plain tensor, leaf by leaf: the export and
    comparison path. Every rank of the mesh must call it."""
    return map_with_path(lambda _, x: full(x), tree)


# The decoder's tensor-parallel blocks: (block, the matrices split on
# their output columns, the matrix split on its input rows).
TP_BLOCKS = (("attn", ("wq", "wk", "wv"), "wo"),
             ("mlp", ("w_gate", "w_up"), "w_down"))

# The model group's collectives of the model splits, by (site, operation,
# phase): site "layer" (a decoder block's reduce and enter), "vocab" (the
# loss's vocabulary split, train/sft.next_token_logprobs) or "tower" (a
# vision tower's layers, nn/vit.py); operation "all_reduce" or
# "all_gather"; phase "forward", "recompute" (a forward that the
# backward runs again, under remat) or "backward". Each is counted in
# `collectives` too.
model_collectives: Dict[Tuple[str, str, str], int] = {}
# The same for an engine's split on the hidden axis (`hidden_split`), over
# the fsdp group: site "layer" (a decoder layer's moments and f32 partial
# products), "residual" (the residual stream gathered whole after the
# last layer), and under act-int8 (nn/llama.py) "act_max" (a product
# group's row max, MAX) and "act_int32" (its int8 entries' int32 partial
# products).
hidden_collectives: Dict[Tuple[str, str, str], int] = {}
_build.register_counters(__name__, "model_collectives", "hidden_collectives")


def _phase() -> str:
    return "forward" if torch._C._current_graph_task_id() == -1 \
        else "recompute"


class _Reduce(torch.autograd.Function):
    """Megatron's g: the sum over the model group forward, the identity
    backward (every rank of the group gets the same gradient)."""

    @staticmethod
    def forward(ctx, partial, split):
        out = partial.contiguous().clone()
        split._all_reduce(out, _phase())
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Enter(torch.autograd.Function):
    """Megatron's f over several tensors: the identity forward; backward,
    the rank's partial gradients of all of them summed over the model
    group in one all-reduce (in f32), each cast back to its dtype."""

    @staticmethod
    def forward(ctx, split, *xs):
        ctx.split = split
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        flat = torch.cat([g.reshape(-1).float() for g in gs])
        ctx.split._all_reduce(flat, "backward")
        out, at = [], 0
        for g in gs:
            out.append(flat[at:at + g.numel()].view(g.shape).to(g.dtype))
            at += g.numel()
        return (None, *out)


class ModelSplit:
    """A model split (module docstring) on this rank: `site` is where its
    collectives are counted ("layer": the decoder's layers, whose blocks
    `blocks` ("attn", "mlp") each rank computes on its own shard; "vocab":
    the loss; "tower": a vision tower); `size`, `index`: the size of the
    split's mesh axis `axis` and this rank's coordinate on it. On the
    fsdp axis it is an engine's split of the hidden axis (`hidden_split`),
    counted in `hidden_collectives`."""

    def __init__(self, mesh: Mesh, site: str,
                 blocks: Tuple[str, ...] = (), axis: str = MODEL_AXIS):
        self.blocks, self.site, self.axis = blocks, site, axis
        self.group = mesh.groups[axis]
        self.size = mesh.shape[axis]
        self.index = mesh.coord[axis]

    def _note(self, op: str, phase: str, site: Optional[str] = None
              ) -> None:
        _count(op, self.axis)
        counts = model_collectives if self.axis == MODEL_AXIS \
            else hidden_collectives
        key = (site or self.site, op, phase)
        counts[key] = counts.get(key, 0) + 1

    def _all_reduce(self, x: torch.Tensor, phase: str, op=None,
                    site: Optional[str] = None) -> None:
        self._note("all_reduce", phase, site)
        if op is None:
            _all_reduce(x, self.group)
        else:
            dist.all_reduce(x, op=op, group=self.group)

    def reduce(self, partial: torch.Tensor) -> torch.Tensor:
        """A partial product or sum (f32: this rank's heads, MLP columns
        or vocabulary) -> the sum over the model group (Megatron's g)."""
        if torch.is_grad_enabled() and partial.requires_grad:
            return _Reduce.apply(partial, self)
        partial = partial.contiguous()
        self._all_reduce(partial, _phase())
        return partial

    def reduce_many(self, *partials: torch.Tensor,
                    site: Optional[str] = None) -> Tuple[torch.Tensor, ...]:
        """Several partial sums of one dtype (f32; int32: exact integer
        products) summed over the group in one all-reduce (XLA's combined
        all-reduce of a tuple), outside autograd, counted at `site`
        (default the split's)."""
        flat = torch.cat([p.reshape(-1) for p in partials])
        self._all_reduce(flat, _phase(), site=site)
        parts = flat.split([p.numel() for p in partials])
        return tuple(y.view(p.shape) for y, p in zip(parts, partials))

    def enter(self, *xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """The tensors a split computation uses whole (its input, and
        leaves such as LoRA's): themselves, whose gradients the backward
        sums over the model group (Megatron's f); as they are outside
        autograd."""
        if not torch.is_grad_enabled() or \
                not any(x.requires_grad for x in xs):
            return xs
        return _Enter.apply(self, *xs)

    def max(self, x: torch.Tensor, site: Optional[str] = None
            ) -> torch.Tensor:
        """The elementwise max over the group (no gradient), counted at
        `site` (default the split's)."""
        x = x.detach().contiguous().clone()
        self._all_reduce(x, _phase(), dist.ReduceOp.MAX, site)
        return x

    def gather(self, x: torch.Tensor, dim: int = -1,
               site: Optional[str] = None) -> torch.Tensor:
        """The group's shards of dim `dim` concatenated, in rank order
        (outside autograd: the frozen towers, an engine's residual),
        counted at `site` (default the split's)."""
        self._note("all_gather", _phase(), site)
        return _all_gather(x, dim % x.dim(), self.group)

    def columns(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's share of the last dim of a whole tensor (the
        columns its split matrices hold)."""
        return x.chunk(self.size, -1)[self.index]


def _split_blocks(stack: Params) -> Tuple[Optional[Mesh], Tuple[str, ...]]:
    """(the mesh, the blocks of `stack` whose matrices are all DTensors
    sharded on a model axis above 1)."""
    model = AXES.index(MODEL_AXIS)
    blocks, mesh = [], None
    for name, cols, rows in TP_BLOCKS:
        leaves = [stack.get(name, {}).get(k) for k in cols + (rows,)]
        if all(isinstance(x, DTensor) and x.device_mesh.size(model) > 1
               and isinstance(x.placements[model], Shard) for x in leaves):
            blocks.append(name)
            mesh = Mesh.of(leaves[0].device_mesh)
    return mesh, tuple(blocks)


def model_split(stack: Params, cfg=None) -> Optional[ModelSplit]:
    """The ModelSplit of a decoder layer stack, None for a stack that
    computes whole on the model axis (a quantized engine, a mesh whose
    model axis is 1, no mesh). With the decoder's config `cfg`, a split
    that would cut the attention's heads raises."""
    mesh, blocks = _split_blocks(stack)
    if mesh is None:
        return None
    M = mesh.shape[MODEL_AXIS]
    if cfg is not None and "attn" in blocks:
        for what, heads in (("heads", cfg.num_heads),
                            ("KV heads", cfg.num_kv_heads)):
            if heads % M:
                raise ValueError(
                    f"mesh {mesh}: the model axis M={M} would cut the "
                    f"decoder's {what} H={heads} (H*head_dim divides by "
                    f"M, H does not); pick an M that divides {heads}")
    return ModelSplit(mesh, "layer", blocks)


def hidden_split(stack: Params) -> Optional[ModelSplit]:
    """The split of an engine's decoder stack on the hidden axis (module
    docstring; serving_params places it by HIDDEN_RULES): a ModelSplit
    over the fsdp group, None for a stack that keeps its layers whole on
    the hidden axis."""
    x = stack.get("input_norm", {}).get("scale")
    if not isinstance(x, DTensor):
        return None
    fs = x.placements[AXES.index(FSDP_AXIS)]
    if not (isinstance(fs, Shard) and fs.dim == 1):
        return None
    return ModelSplit(Mesh.of(x.device_mesh), "layer", axis=FSDP_AXIS)


def takes_hidden_split(params: Params, mesh_sizes: Dict[str, int],
                       hidden_size: int) -> bool:
    """Whether an engine's decoder stack goes on the hidden axis on a mesh
    of `mesh_sizes` (axis -> size): an fsdp axis above 1 that divides the
    hidden size and every leaf HIDDEN_RULES split on it (an int4 entry's
    groups; a single group is a per-column scale, kept whole)."""
    if mesh_sizes[FSDP_AXIS] == 1 or hidden_size % mesh_sizes[FSDP_AXIS]:
        return False
    for path, x in leaves_with_path(params):
        if not path.startswith(LAYER_STACK + "."):
            continue
        spec = spec_for(path, HIDDEN_RULES)
        clipped = _clip_spec_to_leaf(spec, x.shape, mesh_sizes)
        if FSDP_AXIS in spec and FSDP_AXIS not in clipped and \
                not (path.endswith(".s4") and x.shape[1] == 1):
            return False
    return True


# The vision towers' matrices, which VISION_RULES split on the model axis
# (fc2 on its rows, the others on their columns): each rank computes its
# shard (nn/vit.py), as XLA partitions the towers.
TOWER_MATRICES = re.compile(
    r"(vision|owl_tower)\.layers\.(attn\.(wq|wk|wv|wo)|mlp\.(fc1|fc2))\.w")


def _model_sharded(x) -> bool:
    model = AXES.index(MODEL_AXIS)
    return isinstance(x, DTensor) and x.device_mesh.size(model) > 1 and \
        isinstance(x.placements[model], Shard)


def model_local_leaves(tree: Params, vocab: bool = False
                       ) -> Dict[str, ModelSplit]:
    """path -> ModelSplit of the leaves outside the decoder's layer stack
    that a rank keeps and computes on its shard of the model axis: the
    towers' matrices the rules split there (one split a tower, site
    "tower"), and with `vocab` a training tree's lm_head where the rules
    split its vocabulary (site "vocab"; the tiny configs: 7B's 32003
    rows divide by nothing, and an engine computes it whole)."""
    out, towers = {}, {}
    for path, x in leaves_with_path(tree):
        if not _model_sharded(x):
            continue
        m = TOWER_MATRICES.fullmatch(path)
        if m:
            if m.group(1) not in towers:
                towers[m.group(1)] = ModelSplit(Mesh.of(x.device_mesh),
                                                "tower")
            out[path] = towers[m.group(1)]
        elif vocab and path == "llama.lm_head" and \
                x.placements[AXES.index(MODEL_AXIS)] == Shard(1):
            out[path] = ModelSplit(Mesh.of(x.device_mesh), "vocab")
    return out


def warm_group(mesh: Mesh, axis: str, device) -> None:
    """One all_reduce over the axis's group on `device`: NCCL builds a
    communicator at its first collective, which a CUDA graph capture
    must not be."""
    x = torch.zeros(1, device=device)
    _count("all_reduce", axis)
    _all_reduce(x, mesh.groups[axis])


def serving_params(params: Params, mesh: Mesh, llama_cfg) -> Params:
    """An engine's tree under a mesh: the decoder's layer stack sharded by
    the rules, every other leaf gathered once into a plain tensor
    (embeddings, lm_head, towers, heads: a few percent of a 7B model).
    On an fsdp axis above 1 the stack lies on the hidden axis
    (HIDDEN_RULES, `hidden_split`: each rank keeps 1/F of every layer,
    taken from the whole tree every rank was given, so with no
    communication). On a model axis above 1 the decoder's blocks that
    the rules split compute on each rank's own shard (module docstring,
    ModelSplit), and so do the towers' matrices (model_local_leaves;
    their other axes gathered once); a model axis that would cut a
    decoder head (`llama_cfg`'s heads) raises. The groups of the splits
    run a first collective here, before any graph capture. Every rank of
    the mesh must call it."""
    rules = DEFAULT_RULES
    if takes_hidden_split(params, mesh.shape, llama_cfg.hidden_size):
        rules = HIDDEN_RULES + DEFAULT_RULES
    with torch.no_grad():
        tree = shard_params(params, mesh, rules)
        tree = unshard(tree, model_local=model_local_leaves(tree))
    stack = tree["llama"]["layers"]
    device = stack["input_norm"]["scale"].to_local().device
    split = model_split(stack, llama_cfg)
    if split is not None:
        warm_group(mesh, MODEL_AXIS, device)
    if hidden_split(stack) is not None:
        warm_group(mesh, FSDP_AXIS, device)
    return tree
