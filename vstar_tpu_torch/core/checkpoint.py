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
  * save_params / load_params: the port's own state trees. The JAX
    package writes Orbax checkpoints; the port writes its tree (nested
    dicts, lists and tuples of tensors and ints) with torch.save and
    reads it back with weights_only=True, so a checkpoint never runs
    code. The two formats do not read each other (ROADMAP Queue 3).
  * save_sharded / load_sharded: a tree with DTensor leaves (a state
    sharded over a mesh, core/mesh.py), one file per rank holding that
    rank's shards (`<path>.rank<r>`), read back on the same mesh.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Mapping, Union

import torch
from torch.distributed.tensor import DTensor

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


def save_params(tree: Any, path: str) -> None:
    """Write `tree` to the file `path`, replacing it atomically (the
    trainers keep one rolling checkpoint, like the reference's
    rmtree-then-save, VisualSearch/train.py:396-409)."""
    path = os.path.abspath(path)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(tree, tmp)
    os.replace(tmp, path)


def load_params(path: str, device: Device = "cpu") -> Any:
    """Read a tree written by save_params, its tensors on `device`."""
    return torch.load(os.path.abspath(path), map_location=device,
                      weights_only=True)


def _map_tree(fn, tree, like=None):
    """fn(leaf, like_leaf) over a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, None if like is None else like[k])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v, None if like is None else like[i])
                          for i, v in enumerate(tree))
    return fn(tree, like)


def _rank_path(path: str) -> str:
    from .mesh import rank
    return f"{path}.rank{rank()}"


def save_sharded(tree: Any, path: str) -> None:
    """This rank's part of a sharded tree (each DTensor leaf's local shard,
    every other leaf as it is) to `<path>.rank<r>`, atomically."""
    save_params(_map_tree(
        lambda x, _: x.to_local() if isinstance(x, DTensor) else x, tree),
        _rank_path(path))


def load_sharded(path: str, like: Any, device: Device = "cpu") -> Any:
    """The tree save_sharded wrote for this rank, on `device`, with every
    leaf that is a DTensor in `like` (a tree of the same structure,
    sharded on the same mesh) placed as that DTensor."""
    from .mesh import with_local
    local = load_params(_rank_path(path), device)
    return _map_tree(
        lambda x, ref: with_local(ref, x) if isinstance(ref, DTensor) else x,
        local, like)
