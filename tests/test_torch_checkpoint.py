"""The port's state checkpoints (vstar_tpu_torch/core/checkpoint.py) in one
process, on the CPU.

  * core/mesh.global_slice, the one source of a shard's offsets, against
    DTensor's own layout of the same placements (uneven torch.chunk
    pieces, two mesh axes on one dim, ranks holding nothing);
  * a tree without DTensors: one torch.save file, read whole, onto whole
    tensors (a template of another shape or dtype refused), into the
    template's buffers with `into`;
  * a tree of DTensors in a world of one gloo rank (the 1x1x1 mesh): a
    directory of the index and one rank file holding the tree's bytes and
    nothing more, read whole with no process group use, onto whole
    tensors, onto DTensors, with no torch.load (no code runs on load);
    a one-device file read onto DTensors; each form replacing the other.
The same format over 4 ranks and other meshes, and the trainers resumed
across meshes, are tests/test_torch_mesh.py's."""

import itertools
import json
import os

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor._utils import \
    _compute_local_shape_and_global_offset as dtensor_layout

from tests.test_torch_mesh_world import _same_tree
from vstar_tpu_torch.core import checkpoint as C
from vstar_tpu_torch.core import mesh as M


@pytest.mark.parametrize("shape,sizes,placements", [
    ((5, 3), (2, 2, 1), (Shard(0), Shard(0), Replicate())),
    ((7,), (1, 4, 1), (Replicate(), Shard(0), Replicate())),
    ((6, 10), (2, 2, 2), (Shard(1), Replicate(), Shard(0))),
    ((3, 4, 8), (1, 2, 2), (Replicate(), Shard(0), Shard(2))),
    ((2, 9), (4, 1, 1), (Shard(1), Replicate(), Replicate())),
    ((), (2, 1, 2), (Replicate(), Replicate(), Replicate()))])
def test_global_slice_is_dtensor_layout(shape, sizes, placements):
    """Every coordinate's (offset, extent) equals DTensor's layout of the
    same placements; the blocks of distinct coordinates tile the leaf."""
    seen = {}
    for coord in itertools.product(*(range(n) for n in sizes)):
        offset, extent = M.global_slice(shape, placements, sizes, coord)
        local, off = dtensor_layout(shape, sizes, list(coord), placements)
        assert extent == tuple(local) and (not all(extent) or
                                           offset == tuple(off)), coord
        seen[(offset, extent)] = True
    covered = sum(torch.Size(e).numel() for _, e in seen if all(e))
    assert covered == torch.Size(shape).numel()


def _tree():
    gen = torch.Generator().manual_seed(0)
    return {"w": torch.randn((4, 6), generator=gen),
            "b": torch.randn((6,), generator=gen).to(torch.bfloat16),
            "opt": [{"count": 2, "mu": {"w": torch.randn((4, 6),
                                                         generator=gen)}},
                    {}],
            "step": 5, "name": "run", "none": None}


def test_whole_tree_is_one_file(tmp_path):
    """A tree without DTensors: one file, replaced in place; read whole,
    onto whole tensors, into their buffers; a template of another shape
    or dtype is refused."""
    tree, path = _tree(), str(tmp_path / "state")
    C.save_params(tree, path)
    C.save_params(tree, path)
    assert os.path.isfile(path)
    assert _same_tree(C.load_params(path), tree)
    like = {**_tree(), "w": torch.zeros((4, 6))}
    got = C.load_params(path, like)
    assert _same_tree(got, tree) and got["w"] is not like["w"]
    got = C.load_params(path, like, into=True)
    assert got["w"] is like["w"] and torch.equal(like["w"], tree["w"])
    for bad in (torch.zeros((4, 5)), torch.zeros((4, 6), dtype=torch.int32)):
        with pytest.raises(ValueError, match="template"):
            C.load_params(path, {**_tree(), "w": bad})


@pytest.fixture
def one_rank(tmp_path):
    """A world of one gloo rank and its 1x1x1 mesh."""
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield M.make_mesh((1, 1, 1), "cpu")
    finally:
        dist.destroy_process_group()


def _sharded(tree, mesh):
    """The tensors of `tree` as DTensors (replicated on 1x1x1)."""
    def put(x):
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, list):
            return [put(v) for v in x]
        if isinstance(x, torch.Tensor):
            return DTensor.from_local(x.clone(), mesh.device_mesh,
                                      mesh.replicated(), run_check=False)
        return x
    return put(tree)


def test_sharded_tree_is_a_directory_of_global_pieces(one_rank, tmp_path,
                                                      monkeypatch):
    """A tree of DTensors: the index (JSON) and rank0.bin, whose bytes are
    the tree's; read with no torch.load: whole, onto whole tensors, onto
    the DTensors (into their buffers with `into`)."""
    tree, path = _tree(), str(tmp_path / "state")
    sharded = _sharded(tree, one_rank)
    C.save_params(sharded, path)
    assert sorted(os.listdir(path)) == ["index.json", "rank0.bin"]
    assert os.path.getsize(os.path.join(path, "rank0.bin")) == \
        4 * 6 * 4 + 6 * 2 + 4 * 6 * 4
    with open(os.path.join(path, "index.json")) as f:
        index = json.load(f)
    assert [e["shape"] for e in index["leaves"]] == [[4, 6], [6], [4, 6]]

    def no_code(*a, **kw):
        raise AssertionError("a sharded checkpoint is read without torch.load")
    monkeypatch.setattr(torch, "load", no_code)
    assert _same_tree(C.load_params(path), tree)
    assert _same_tree(C.load_params(path, _tree()), tree)
    like = _sharded({**_tree(), "w": torch.zeros((4, 6))}, one_rank)
    got = C.load_params(path, like, into=True)
    assert isinstance(got["w"], DTensor) and got["w"] is like["w"]
    assert torch.equal(like["w"].to_local(), tree["w"])
    assert torch.equal(got["opt"][0]["mu"]["w"].to_local(),
                       tree["opt"][0]["mu"]["w"])


def test_forms_replace_each_other_and_a_file_reads_onto_dtensors(
        one_rank, tmp_path):
    """A one-device file read onto DTensors (each rank its slice of the
    file), then a sharded save replacing the file with a directory, and
    a one-device save replacing the directory with a file."""
    tree, path = _tree(), str(tmp_path / "state")
    C.save_params(tree, path)
    got = C.load_params(path, _sharded(_tree(), one_rank))
    assert isinstance(got["b"], DTensor) and \
        torch.equal(got["b"].to_local(), tree["b"])
    C.save_params(_sharded(tree, one_rank), path)
    assert os.path.isdir(path)
    C.save_params(tree, path)
    assert os.path.isfile(path) and _same_tree(C.load_params(path), tree)
    assert not [f for f in os.listdir(tmp_path) if f.startswith("state.")]
