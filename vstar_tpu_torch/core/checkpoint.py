"""Checkpoint I/O (port of vstar_tpu/core/checkpoint.py).

  * load_torch_dir: an HF checkpoint directory (`*.safetensors` shards,
    with or without `model.safetensors.index.json`, or
    `pytorch_model*.bin` shards) as a flat name -> tensor dict, each
    tensor moved to `device` as its shard is read. The public reference
    checkpoints (craigwu/seal_vqa_7b, craigwu/seal_vsm_7b) use this
    format. Safetensors files are read and written by this module's own
    code (no `safetensors` package): an 8-byte little-endian header
    length, a JSON header ({name: {dtype, shape, data_offsets}} and an
    optional `__metadata__`), then the raw little-endian bytes.
  * save_params / load_params: the port's own state trees (nested dicts,
    lists and tuples of tensors, ints, floats, bools, strings and None),
    with the semantics of the JAX package's Orbax checkpoints: one
    checkpoint of global tensors, read back onto whatever layout the
    caller's template `like` has. The two formats do not read each other
    (ROADMAP Queue 3), and reading one never runs code.
      - A tree without a DTensor leaf is one torch.save file at `path`,
        read with weights_only=True.
      - A tree with DTensor leaves (a state sharded over a mesh,
        core/mesh.py) is a directory at `path` that every rank of the
        world writes at once: `index.json` (the tree's structure, its
        non-tensor leaves, and for each tensor leaf its global shape and
        dtype and the global offset and extent of every piece written,
        taken from the DTensor placements by core/mesh.global_slice) and
        `rank<r>.bin`, the raw bytes of the pieces rank r wrote. Each
        distinct piece is written once, by the lowest rank holding it (a
        replicated leaf by one rank), so the files hold the tree's bytes
        and nothing more.
      - load_params(path, like=..., device=...) reads either form: with
        `like` None the whole tree on `device`; where a leaf of `like`
        is a DTensor on any mesh, this rank's slice of it, placed as
        that DTensor (the bytes of that slice alone are read, through
        memory maps of the files, and no more device memory than the
        slice is taken); where it is a whole tensor, the whole leaf on
        that tensor's device (one process, no process group needed).
    So a state written on one mesh resumes on another or on one device
    (the trainers' load_state, train/train_vsm_main.py), and export_main
    exports a VSM trained on a mesh in one process without torchrun.
    CPU tests: tests/test_torch_checkpoint.py (the format) and
    tests/test_torch_mesh.py (the trainers resumed across meshes, the
    export, the format over 4 ranks).
"""

from __future__ import annotations

import itertools
import json
import math
import os
import shutil
import struct
from typing import Any, Dict, List, Mapping, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from .mesh import global_slice, local_slice, rank, slices, with_local
from .params import leaves_with_path

Device = Union[str, torch.device]

# safetensors dtype names; the rank is the writer's order (descending,
# then by name), as the safetensors package lays out a file
_DTYPES = {"BOOL": torch.bool, "U8": torch.uint8, "I8": torch.int8,
           "I16": torch.int16, "F16": torch.float16, "BF16": torch.bfloat16,
           "I32": torch.int32, "F32": torch.float32, "F64": torch.float64,
           "I64": torch.int64}
_NAMES = {v: k for k, v in _DTYPES.items()}
_RANK = {name: i for i, name in enumerate(_DTYPES)}

INDEX_NAME = "model.safetensors.index.json"


def read_safetensors(path: str, device: Device = "cpu"
                     ) -> Dict[str, torch.Tensor]:
    """Every tensor of one .safetensors file, each read into its own host
    buffer and moved to `device` before the next is read."""
    out: Dict[str, torch.Tensor] = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        base = 8 + n
        for name, e in sorted(header.items(),
                              key=lambda kv: kv[1]["data_offsets"][0]):
            dtype = _DTYPES.get(e["dtype"])
            if dtype is None:
                raise ValueError(f"{path}: {name} has dtype {e['dtype']}, "
                                 f"not one of {sorted(_DTYPES)}")
            start, end = e["data_offsets"]
            raw = torch.empty(end - start, dtype=torch.uint8)
            f.seek(base + start)
            if f.readinto(raw.numpy()) != end - start:
                raise ValueError(f"{path}: {name} is cut short")
            # bf16 and bool have no numpy type: the bytes are viewed as
            # the tensor's dtype in torch
            t = raw.view(dtype).reshape(e["shape"])
            out[name] = t.to(device)
    return out


def write_safetensors(tensors: Mapping[str, torch.Tensor],
                      path: str) -> None:
    """One .safetensors file with the safetensors package's layout (and no
    metadata, as vstar_tpu writes it): data ordered by dtype (widest
    first), then by name; the JSON header compact, padded with spaces to
    a multiple of 8 bytes."""
    order = sorted(tensors, key=lambda k: (-_RANK[_NAMES[tensors[k].dtype]],
                                           k))
    header: Dict[str, Any] = {}
    offset = 0
    for k in order:
        t = tensors[k]
        nbytes = t.numel() * t.element_size()
        header[k] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                     "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    text = json.dumps(header, separators=(",", ":"),
                      ensure_ascii=False).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for k in order:
            t = tensors[k].detach().contiguous().cpu().reshape(-1)
            f.write(memoryview(t.view(torch.uint8).numpy()))


def load_torch_dir(path: str, device: Device = "cpu"
                   ) -> Dict[str, torch.Tensor]:
    """Flat state_dict of an HF checkpoint dir (safetensors shards, with
    the index naming them if it is there, or pytorch_model*.bin shards),
    its tensors on `device`. One shard is on the host at a time."""
    entries = sorted(os.listdir(path))
    index = os.path.join(path, INDEX_NAME)
    if os.path.isfile(index):
        with open(index) as f:
            weight_map = json.load(f)["weight_map"]
        safes = sorted(set(weight_map.values()))
    else:
        weight_map = None
        safes = [e for e in entries if e.endswith(".safetensors")]
    bins = [e for e in entries
            if e.endswith(".bin") and e.startswith("pytorch_model")]
    sd: Dict[str, torch.Tensor] = {}
    if safes:
        for fname in safes:
            part = read_safetensors(os.path.join(path, fname), device)
            if weight_map is not None:
                wrong = [k for k in part if weight_map.get(k) != fname]
                if wrong:
                    raise ValueError(f"{fname} holds {wrong[:5]}, which "
                                     f"{INDEX_NAME} places elsewhere")
            sd.update(part)
        if weight_map is not None and set(weight_map) - set(sd):
            raise KeyError(f"{INDEX_NAME} names tensors no shard holds: "
                           f"{sorted(set(weight_map) - set(sd))[:5]}")
    elif bins:
        for fname in bins:
            part = torch.load(os.path.join(path, fname), map_location="cpu",
                              weights_only=True)
            for k in list(part):
                sd[k] = part.pop(k).to(device)
    else:
        raise FileNotFoundError(f"no checkpoint shards under {path}")
    return sd


# ---------------------------------------------------------------------------
# The port's state trees: one file, or one sharded checkpoint
# ---------------------------------------------------------------------------

INDEX_FILE = "index.json"
SHARDED_FORMAT = "vstar_tpu_torch.sharded/1"


def _replace(tmp: str, path: str) -> None:
    """`tmp` (a file or a directory) into `path`, removing what was there
    (a file or a directory) once the new one is in place."""
    old = None
    if os.path.lexists(path):
        old = f"{path}.old{os.getpid()}"
        os.replace(path, old)
    os.replace(tmp, path)
    if old is not None:
        if os.path.isdir(old):
            shutil.rmtree(old)
        else:
            os.remove(old)


def save_params(tree: Any, path: str) -> None:
    """Write `tree` to `path`, replacing what is there once the new
    checkpoint is complete (the trainers keep one rolling checkpoint, like
    the reference's rmtree-then-save, VisualSearch/train.py:396-409). A
    tree with DTensor leaves is written by every rank of the world
    (module docstring), which must all call this."""
    path = os.path.abspath(path)
    if any(isinstance(x, DTensor) for _, x in leaves_with_path(tree)):
        _save_sharded(tree, path)
        return
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(tree, tmp)
    _replace(tmp, path)


def _skeleton(tree: Any, leaves: List[torch.Tensor]) -> Any:
    """The JSON form of a tree's structure and non-tensor leaves; its
    tensor leaves appended to `leaves`, each named by its index."""
    if isinstance(tree, dict):
        return {"dict": [[k, _skeleton(v, leaves)] for k, v in tree.items()]}
    if isinstance(tree, (list, tuple)):
        return {"tuple" if isinstance(tree, tuple) else "list":
                [_skeleton(v, leaves) for v in tree]}
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return {"leaf": len(leaves) - 1}
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return {"value": tree}
    raise TypeError(f"a checkpoint holds tensors, ints, floats, bools, "
                    f"strings and None, not {type(tree).__name__}")


def _pieces(x: torch.Tensor) -> List[Tuple[int, tuple, tuple]]:
    """(writing rank, global offset, extent) of each distinct non-empty
    block of leaf `x`, by offset: the block of every mesh coordinate from
    its placements (core/mesh.global_slice), written by the lowest rank
    holding it. A plain tensor is one block, rank 0's (every rank holds
    it whole)."""
    if not isinstance(x, DTensor):
        blocks = {((0,) * x.dim(), tuple(x.shape)): 0}
    else:
        dm = x.device_mesh
        ranks = dm.mesh
        blocks = {}
        for coord in itertools.product(*(range(n) for n in dm.shape)):
            block = global_slice(x.shape, x.placements, dm.shape, coord)
            r = int(ranks[coord])
            blocks[block] = min(r, blocks.get(block, r))
    return sorted(((r, o, e) for (o, e), r in blocks.items() if all(e)),
                  key=lambda p: p[1])


def _rank_file(r: int) -> str:
    return f"rank{r}.bin"


def _index(leaves: List[torch.Tensor]) -> List[dict]:
    """Each leaf's global shape, dtype and pieces (file, byte position in
    it, offset, extent); every rank computes the same index from the
    placements alone."""
    at: Dict[str, int] = {}
    out = []
    for x in leaves:
        pieces = []
        for r, offset, extent in _pieces(x):
            name = _rank_file(r)
            pieces.append({"file": name, "at": at.get(name, 0),
                           "offset": list(offset), "extent": list(extent)})
            at[name] = at.get(name, 0) + math.prod(extent) * x.element_size()
        out.append({"dtype": _NAMES[x.dtype], "shape": list(x.shape),
                    "pieces": pieces})
    return out


def _barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def _save_sharded(tree: Any, path: str) -> None:
    leaves: List[torch.Tensor] = []
    skeleton = _skeleton(tree, leaves)
    index = _index(leaves)
    me = rank()
    tmp = f"{path}.tmp"
    if me == 0:
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
    _barrier()
    mine = _rank_file(me)
    if any(p["file"] == mine for e in index for p in e["pieces"]):
        with open(os.path.join(tmp, mine), "wb") as f:
            for x, entry in zip(leaves, index):
                local = x.to_local() if isinstance(x, DTensor) else x
                for p in entry["pieces"]:
                    if p["file"] != mine:
                        continue
                    if list(local.shape) != p["extent"] or f.tell() != p["at"]:
                        raise AssertionError(
                            f"rank {me}: a piece of shape {p['extent']} at "
                            f"{p['at']}, its shard is {tuple(local.shape)} "
                            f"at {f.tell()}")
                    t = local.detach().contiguous().cpu().reshape(-1)
                    f.write(memoryview(t.view(torch.uint8).numpy()))
    _barrier()
    if me == 0:
        with open(os.path.join(tmp, INDEX_FILE), "w") as f:
            json.dump({"format": SHARDED_FORMAT, "tree": skeleton,
                       "leaves": index}, f)
        _replace(tmp, path)
    _barrier()


class _Stored:
    """A tensor leaf of a sharded checkpoint: its shape and dtype, and its
    pieces, read through memory maps of the rank files (`files`, shared
    by the leaves of one load)."""

    def __init__(self, entry: dict, path: str, files: Dict[str, Any]):
        self.shape = tuple(entry["shape"])
        self.dtype = _DTYPES[entry["dtype"]]
        self.pieces = entry["pieces"]
        self.path, self.files = path, files

    def block(self, offset: tuple, extent: tuple) -> torch.Tensor:
        out = torch.empty(extent, dtype=self.dtype)
        for p in self.pieces:
            po, pe = p["offset"], p["extent"]
            lo = [max(a, b) for a, b in zip(offset, po)]
            hi = [min(a + n, b + m) for a, n, b, m in
                  zip(offset, extent, po, pe)]
            if any(a >= b for a, b in zip(lo, hi)):
                continue
            name = p["file"]
            if name not in self.files:
                self.files[name] = np.memmap(os.path.join(self.path, name),
                                             np.uint8, "r")
            size = tuple(b - a for a, b in zip(lo, hi))
            out[slices([a - o for a, o in zip(lo, offset)], size)] = \
                _read_block(self.files[name], p["at"], self.dtype, tuple(pe),
                            tuple(a - b for a, b in zip(lo, po)), size)
        return out


def _read_block(data: np.ndarray, at: int, dtype: torch.dtype,
                extent: tuple, offset: tuple, size: tuple) -> torch.Tensor:
    """The block (offset, size) of a piece of shape `extent` whose bytes
    start at `at` in the memory-mapped file `data`, copied out (only its
    own bytes are read)."""
    isz = torch.empty((), dtype=dtype).element_size()
    raw = data[at:at + math.prod(extent) * isz]
    if not extent:
        return torch.from_numpy(np.array(raw)).view(dtype).reshape(())
    raw = raw.reshape(*extent[:-1], extent[-1] * isz)
    idx = slices(offset[:-1], size[:-1]) + (
        slice(offset[-1] * isz, (offset[-1] + size[-1]) * isz),)
    return torch.from_numpy(np.array(raw[idx])).view(dtype).reshape(size)


def _from_skeleton(node: Any, leaves: List[_Stored]) -> Any:
    if "dict" in node:
        return {k: _from_skeleton(v, leaves) for k, v in node["dict"]}
    if "tuple" in node:
        return tuple(_from_skeleton(v, leaves) for v in node["tuple"])
    if "list" in node:
        return [_from_skeleton(v, leaves) for v in node["list"]]
    if "leaf" in node:
        return leaves[node["leaf"]]
    return node["value"]


def _block(src, offset: tuple, extent: tuple) -> torch.Tensor:
    """The block (offset, extent) of a checkpoint leaf on the host, in
    memory of its own."""
    if isinstance(src, _Stored):
        return src.block(offset, extent)
    return src[slices(offset, extent)].clone(
        memory_format=torch.contiguous_format)


def _restore_leaf(src, like, device, into: bool):
    shape, dtype = tuple(src.shape), src.dtype
    if like is None:
        return _block(src, (0,) * len(shape), shape).to(device)
    if not isinstance(like, torch.Tensor) or tuple(like.shape) != shape \
            or like.dtype != dtype:
        what = (f"{like.dtype} {tuple(like.shape)}"
                if isinstance(like, torch.Tensor) else type(like).__name__)
        raise ValueError(f"checkpoint leaf {dtype} {shape}, template {what}")
    if isinstance(like, DTensor):
        local = like.to_local()
        got = _block(src, *local_slice(like))
        if into:
            local.copy_(got)
            return like
        return with_local(like, got.to(local.device))
    got = _block(src, (0,) * len(shape), shape)
    if into:
        like.copy_(got)
        return like
    return got.to(like.device)


def _restore(src, like, device, into: bool):
    """The checkpoint tree `src` (leaves: tensors or _Stored) onto `like`."""
    if isinstance(src, dict):
        if like is not None and set(like) != set(src):
            raise ValueError(f"checkpoint keys {sorted(map(str, src))[:8]} "
                             f"against template {sorted(map(str, like))[:8]}")
        return {k: _restore(v, None if like is None else like[k], device,
                            into) for k, v in src.items()}
    if isinstance(src, (list, tuple)):
        if like is not None and len(like) != len(src):
            raise ValueError(f"checkpoint sequence of {len(src)}, template "
                             f"of {len(like)}")
        return type(src)(_restore(v, None if like is None else like[i],
                                  device, into) for i, v in enumerate(src))
    if isinstance(src, (torch.Tensor, _Stored)):
        return _restore_leaf(src, like, device, into)
    return src


def load_params(path: str, like: Any = None, device: Device = "cpu",
                into: bool = False) -> Any:
    """Read a tree written by save_params (either form), onto the layout
    of `like` (module docstring): None, the whole tree on `device`; a
    tree of the same structure whose tensor leaves are DTensors (on any
    mesh: this rank's slice of each is read) or whole tensors (the whole
    leaf, on its device). `into`: the template's tensors (a DTensor's
    local shard) receive what is read, in place, and the template's
    leaves are returned (a resume then holds one copy of the state)."""
    path = os.path.abspath(path)
    if os.path.isdir(path):
        with open(os.path.join(path, INDEX_FILE)) as f:
            index = json.load(f)
        if index.get("format") != SHARDED_FORMAT:
            raise ValueError(f"{path}: format {index.get('format')}, not "
                             f"{SHARDED_FORMAT}")
        files: Dict[str, Any] = {}
        stored = [_Stored(e, path, files) for e in index["leaves"]]
        return _restore(_from_skeleton(index["tree"], stored), like, device,
                        into)
    if like is None:
        return torch.load(path, map_location=device, weights_only=True)
    return _restore(torch.load(path, map_location="cpu", weights_only=True,
                               mmap=True), like, device, into)
