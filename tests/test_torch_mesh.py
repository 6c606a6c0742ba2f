"""The mesh (vstar_tpu_torch/core/mesh.py) against the JAX package's, on the
CPU.

Without ranks: the partition rules and their clipping give JAX's axes for
every path of the 7B VQA and VSM (with LoRA) trees and every key of the
committed manifests; the per-device memory plan equals JAX's
plan_train_memory to the byte on 1x1x1, 1x8x1, 2x2x2 and a faked 1x16x1.

Over ranks: one world of 4 gloo ranks (torch.multiprocessing, a file
store in tmp_path; tests/test_torch_mesh_world.py holds the ranks' code)
runs every sharded computation on the 2x2x1, 1x2x2 and 1x1x4 meshes at
the tiny configs, and rank 0 hands back the results gathered whole:
  * the decoder's forward on the sharded tree against JAX's and the
    unsharded port's;
  * an f32 SFT finetune step (8 rows) against JAX's jitted step;
  * the VSM loss's metrics on 8 rows against JAX's jitted loss, its
    gradients against the unsharded port's (an M-fold gradient fails
    them), its validation forward against the unsharded port's, and an
    f32 VSM step over 2 micro-batches against JAX's jitted step and the
    unsharded port's;
  * on 1x2x2 and 1x1x4, where the decoder trains tensor-parallel, the
    steps' model-group collectives per layer in the forward, the remat
    recompute and the backward against the layer body of vstar_tpu's
    SFT step and VSM value_and_grad compiled at 1x1x4, K1 and K7 at H/M
    heads, no layer gather on the model axis, each rank's 1/M of the
    layer matrices;
  * where fsdp shards the layer axis (2x2x1; 1x4x1 on a VQA tree of 4
    layers), the finetune step with each next layer's owner broadcasts
    in flight behind the current layer (the forward's i + 1, the
    recompute's i - 1) against the same step with synchronous fetches:
    the same bits and fetch counts;
  * the VQA and VSM trainer loops written on one layout and resumed on
    another (W.CROSS_LOOPS: 2x2x1 -> 1x2x2, 1x2x2 -> one device, one
    device -> 1x4x1; the one-device runs by rank 0 before the world
    starts or after it ends) against the unsharded loops (the VQA loop
    resumed alike, the VSM loop's two epochs in one go), each last
    checkpoint holding each piece once, the resumed VSM's first moments
    under chip_smoke.py's f32 rule (MESH_TP_GRAD_*); export_main of the VSM's
    ckpt_model/state written at 2x2x1 against the same state written
    on one device and vstar_tpu's vsm_state_dict; the checkpoint format
    over the 4 ranks (uneven pieces, read onto other placements);
  * act-int8 on the engines' hidden split (2x2x1, 1x4x1): the int8
    products bit for bit the unsharded _w8a8_dot's, one MAX and one
    int32 all-reduce a product group, the answers against the unsharded
    port's and vstar_tpu's sharded engine under set_act_int8(True);
    int4 gate / up under the W4A8 gate (a decoder of width 256) through
    K6 on each rank's rows;
  * sharded VQA and VSM engines' answers, choices, boxes, scores and
    heatmaps against the unsharded engines'; on 1x2x2, where the decoder
    and the towers are tensor-parallel, also against vstar_tpu's engines
    sharded on the same mesh shape, with the decoder's collectives in a
    prefill and a decode step counted against those of vstar_tpu's
    compiled step (its HLO), each rank's KV cache heads and K1's query
    heads, and a model axis that would cut a head refused;
  * where fsdp is above 1 (2x2x1, 1x2x2, and 1x4x1 on a VQA tree of 4
    layers, which the world runs for that engine alone), each engine's
    decoder stack on the hidden axis: the engines against vstar_tpu's
    sharded on the same mesh, the fsdp group's collectives a layer in a
    prefill and a decode step against the layer bodies of vstar_tpu's
    compiled engine programs (their HLO), no layer broadcast or
    gathered, each rank's bytes of the stack against the engine plan;
  * on 1x1x4, CLIP-L/14 and OWL-B/16 at their widths split on the model
    axis against the unsharded port and vstar_tpu's compile-only HLO;
  * serving over the mesh (serve/ranks.py): rank 0's SealService (a
    free-form request, one with options, two with a forced search) and
    ContinuousSealService (a wave of 3 with forced searches, a wave
    whose question no prompt bucket holds, one more request) with the
    other ranks following, and the server's checkpoint_engines under
    --mesh answering over HTTP, against the unsharded port's and
    vstar_tpu's services on the same trees.
A world of 2 ranks runs train_vqa_main's 7B finetune at --mesh 1x2x1: its
plan fits an 80 GB card's budget, where the one-device plan is refused.

Tolerances (f32): forward, losses, metrics and parameters within 1e-5
(relative for scalars, absolute for parameters); gradients within 1e-5
of each leaf's largest |value| against the unsharded port (the sums over
ranks add in another order); the served records equal the unsharded
port's exactly (tokens, choices, boxes: every field but the latency);
the sharded engines' answers and choices equal, their arrays within
JAX's sharded-inference tolerance (DET_TOL, MASK_TOL:
tests/test_sharded_inference.py; the decoder on the hidden or the model
axis sums in another order than one device); the
served records equal vstar_tpu's in every field but the boxes, which
agree within BOX_ATOL = 1e-2 pixels, the rule of
tests/test_torch_batched_bench.py (they moved by 1.5e-5 at most). An
updated parameter may differ by more than 1e-5, up to 0.1 lr on at most
0.1 % of a leaf: where a gradient element is near zero, the ranks'
partial gradients summed in another order change it relatively much,
and Adam divides the update by the gradient's own size (one element of
16,384 moved 2.1e-5 apart at lr 1e-3)."""

import dataclasses
import json
import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from torch.distributed.tensor import Replicate, Shard

from tests import test_torch_mesh_world as W
from tests.test_torch_sft import CFG as VQA_CFG
from tests.test_torch_sft import T_CFG as T_VQA_CFG
from tests.test_torch_sft import _pretrain_files, _sft_batch
from tests.test_torch_train import CFG as VSM_CFG
from tests.test_torch_train import T_CFG as T_VSM_CFG
from tests.test_torch_train import make_dataset_dir
from tests.test_train import _make_batch
from vstar_tpu.core import memory as jmem
from vstar_tpu.core import mesh as jmesh
from vstar_tpu.core.config import vqa_llm_7b as j_vqa_7b
from vstar_tpu.core.config import vsm_7b as j_vsm_7b
from vstar_tpu.models.vqa_llm import init_vqa_llm_params as j_vqa_init
from vstar_tpu.models.vsm import init_vsm_params as j_vsm_init
from vstar_tpu.nn.llama import llama_forward as j_llama_forward
from vstar_tpu.train import lora as jl
from vstar_tpu.train import sft as jsft
from vstar_tpu.train import vsm_train as jvsm
from vstar_tpu.train.vsm_train import vsm_loss as j_vsm_loss
from chip_smoke import MESH_TP_GRAD_FLOOR, MESH_TP_GRAD_TOL
from vstar_tpu_torch.core import config as tcfg
from vstar_tpu_torch.core import memory as tmem
from vstar_tpu_torch.core import mesh as tmesh
from vstar_tpu_torch.core.checkpoint import load_params
from vstar_tpu_torch.core.hf_export import (config_json, save_safetensors,
                                            vqa_llm_state_dict,
                                            vsm_state_dict)
from vstar_tpu_torch.core.import_audit import load_manifest
from vstar_tpu_torch.core.params import Init, leaves_with_path
from vstar_tpu_torch.data.vsm_collate import batch_to_torch
from vstar_tpu_torch.eval import synthetic
from vstar_tpu_torch.models.vqa_llm import init_vqa_llm_params as t_vqa_init
from vstar_tpu_torch.models.vsm import init_vsm_params as t_vsm_init
from vstar_tpu_torch.nn.llama import init_llama_params
from vstar_tpu_torch.nn.vit import clip_patch_features
from vstar_tpu_torch.train import lora as tl
from vstar_tpu_torch.train import train_vqa_main as t_main

torch.set_num_threads(1)

TOL = 1e-5
BOX_ATOL = 1e-2
LR = W.LR
SHAPES = ((2, 2, 1), (1, 2, 2), (1, 1, 4))
MESHES = ["x".join(map(str, s)) for s in SHAPES]
# the shape whose model axis splits the decoder beside fsdp, against
# vstar_tpu's engines sharded alike
TP_SHAPE = SHAPES[1]
TP_MESH = MESHES[1]
# the model axis over the whole world (fsdp 1): training against the
# layer body of vstar_tpu's compiled steps
MODEL_SHAPE = SHAPES[2]
MODEL_MESH = MESHES[2]
TRAIN_TP_MESHES = MESHES[1:]
# the trainer loops written on one mesh and resumed on another
# (W.CROSS_LOOPS): written on 2x2x1, resumed on 1x2x2; written on 1x2x2,
# resumed on one device; and written on one device, resumed on 1x4x1
LOOP_MESHES = MESHES[:2]
# the checkpoint format's world check: written on the first, read on the
# second
FORMAT_SHAPES = (MESHES[0], SHAPES[1])
# the engines whose decoder stack lies on the hidden axis (fsdp above 1):
# the tiny trees on 2x2x1 and 1x2x2 (their 2 layers divide fsdp 2), and
# on DEEP_SHAPE trees of DEEP_LAYERS layers, which fsdp 4 divides
DEEP_SHAPE, DEEP_LAYERS = (1, 4, 1), 4
DEEP_MESH = "x".join(map(str, DEEP_SHAPE))
HIDDEN_SHAPES = (SHAPES[0], TP_SHAPE, DEEP_SHAPE)
HIDDEN_MESHES = ["x".join(map(str, s)) for s in HIDDEN_SHAPES]
# the quantized VQA trees the world serves on 2x2x1 (W.vqa_answers)
QUANT_MODES = ("int4mix",)
# act-int8 on the hidden split (W.act_int8_checks): the quantized trees
# served under act-int8, and the meshes each is checked on ("w4a8": a
# decoder of width 256 whose int4 gate / up take W4A8, K6, on the split)
ACT_MODES = ("int8", "int4mix")
ACT_SHAPES = {MESHES[0]: ("int8", "int4mix", "w4a8"), DEEP_MESH: ("int8",)}
ACT_W4A8_TOL = dict(rtol=1e-4, atol=1e-4)
W4A8_CFG = dataclasses.replace(T_VQA_CFG, llama=dataclasses.replace(
    T_VQA_CFG.llama, hidden_size=256, intermediate_size=256, num_heads=4,
    num_kv_heads=4, head_dim=64))
# JAX's sharded-inference tolerance (tests/test_sharded_inference.py)
DET_TOL = dict(rtol=1e-4, atol=1e-4)
MASK_TOL = dict(rtol=1e-4, atol=1e-3)
_HLO_COLLECTIVE = re.compile(
    r"\b(all-reduce|all-gather|reduce-scatter|all-to-all|"
    r"collective-permute)(?:-start)?\(.*?replica_groups="
    r"(\{[\d,{}]*\}|\[[\d,]+\]<=\[[\d,]+\](?:T\([\d,]+\))?)")
FAKE_MESHES = ((1, 1, 1), (1, 8, 1), (2, 2, 2), (1, 16, 1))


def _tree_7b(which, side):
    """The 7B tree's shapes: JAX's eval_shape or the port's meta device,
    the VSM with LoRA r=8."""
    if side == "jax":
        if which == "vqa":
            return jax.eval_shape(lambda: j_vqa_init(
                jax.random.PRNGKey(0), j_vqa_7b(), dtype=jnp.bfloat16))

        def vsm():
            p = j_vsm_init(jax.random.PRNGKey(0), j_vsm_7b(),
                           dtype=jnp.bfloat16)
            p["llama"] = jl.add_lora(p["llama"], jax.random.PRNGKey(1), r=8)
            return p
        return jax.eval_shape(vsm)
    if which == "vqa":
        return t_vqa_init(0, tcfg.vqa_llm_7b(), device="meta",
                          dtype=torch.bfloat16)
    p = t_vsm_init(0, tcfg.vsm_7b(), device="meta", dtype=torch.bfloat16)
    p["llama"] = tl.add_lora(p["llama"], 0, r=8)
    return p


@pytest.mark.parametrize("which", ["vqa", "vsm"])
def test_rules_and_clipping_equal_jax(which):
    """spec_for on every path of the 7B tree and every key of its manifest,
    then the clip on each fake mesh, give JAX's axes."""
    mesh_shapes = [dict(zip(tmesh.AXES, s))
                   for s in FAKE_MESHES]
    leaves = list(leaves_with_path(_tree_7b(which, "torch")))
    j_shapes = dict(leaves_with_path(_tree_7b(which, "jax")))
    assert set(j_shapes) == {p for p, _ in leaves}
    for path, leaf in leaves:
        want = tuple(jmesh.spec_for(path))
        assert tmesh.spec_for(path) == want, path
        for sizes in mesh_shapes:
            fake = types.SimpleNamespace(shape=sizes)
            assert tmesh._clip_spec_to_leaf(want, leaf.shape, sizes) == \
                tuple(jmesh._clip_spec_to_leaf(jmesh.P(*want),
                                               j_shapes[path], fake)), path
    for key in load_manifest(f"seal_{which}_7b"):
        assert tmesh.spec_for(key) == tuple(jmesh.spec_for(key)), key
    want = dict(_dict_leaves(jmesh.partition_specs(_tree_7b(which, "jax"))))
    got = dict(_dict_leaves(tmesh.partition_specs(_tree_7b(which, "torch"))))
    assert got == {k: tuple(v) for k, v in want.items()}


def _dict_leaves(tree, prefix=""):
    """(path, leaf) of a tree whose leaves are specs: tuples of axis names
    and None (a list or tuple of subtrees is a container)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _dict_leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)) and not all(
            x is None or isinstance(x, str) for x in tree):
        for i, v in enumerate(tree):
            yield from _dict_leaves(v, f"{prefix}{i}.")
    else:
        yield prefix.rstrip("."), tree


@pytest.mark.parametrize("which", ["vqa", "vsm"])
def test_memory_plan_equals_jax_on_meshes(which):
    """Per-device bytes of the 7B tree (bf16 with f32 masters; the VQA
    finetune's frozen-tower mask, the VSM's LoRA trainable set) equal
    JAX's field by field on every mesh, the faked 1x16x1 included."""
    t_tree, j_tree = _tree_7b(which, "torch"), _tree_7b(which, "jax")
    if which == "vqa":
        t_mask = t_main.frozen_vision_mask(t_tree)
        j_mask = jsft.make_frozen_vision_mask(j_tree)
    else:
        t_mask = tl.vsm_trainable_mask(t_tree)
        j_mask = jl.vsm_trainable_mask(j_tree)
    for shape in FAKE_MESHES:
        fake = types.SimpleNamespace(shape=dict(zip(tmesh.AXES, shape)))
        want = jmem.plan_train_memory(j_tree, fake, trainable_mask=j_mask)
        for mesh in (shape, fake):
            got = tmem.plan_train_memory(t_tree, mesh, trainable_mask=t_mask)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), shape
            assert got.summary() == want.summary()


@pytest.mark.parametrize("shape", [(1, 4, 1), (1, 2, 2), (1, 1, 4)])
def test_step_memory_gathers_a_model_split_layer_at_1_over_m(shape):
    """step_memory's gathered decoder layer of the 7B VQA (bf16): the
    attention's and the MLP's matrices at 1/M (H/M heads), the norms
    whole; fsdp does not shrink it (a layer is gathered whole on it)."""
    tree = _tree_7b("vqa", "torch")
    cfg = tcfg.vqa_llm_7b().llama
    D, F = cfg.hidden_size, cfg.intermediate_size
    want = 2 * ((2 * cfg.q_dim * D + 2 * cfg.kv_dim * D + 3 * D * F)
                // shape[2] + 2 * D)
    got = tmem.step_memory(tree, shape)
    assert (got.accum_bytes, got.largest_grad_bytes, got.layer_bytes) == \
        (0, 0, want)
    assert "one gathered decoder layer" in got.summary()


def _eight_vsm_rows():
    """tests/test_train.py's batch at 8 rows: rows without valid boxes and
    without a valid mask, so every normaliser differs between ranks."""
    b = dict(_make_batch(B=8))
    b["tgt_valid"] = np.asarray([[1, 1, 0, 0], [1, 0, 0, 0], [1, 1, 1, 0],
                                 [0, 0, 0, 0], [1, 0, 0, 0], [1, 1, 0, 0],
                                 [1, 1, 1, 1], [1, 0, 0, 0]], bool)
    b["bboxes_valid"] = np.asarray([1, 1, 0, 1, 1, 0, 1, 1], bool)
    b["masks_valid"] = np.asarray([1, 0, 1, 1, 0, 1, 1, 1], bool)
    return {k: np.asarray(v) for k, v in b.items()}


def _deep(cfg):
    """A tiny config with DEEP_LAYERS decoder layers."""
    return dataclasses.replace(cfg, llama=dataclasses.replace(
        cfg.llama, num_layers=DEEP_LAYERS))


def _tiny_trees():
    """The tiny VQA tree, and the tiny VSM tree with LoRA (r=2) whose B is
    non-zero, drawn by the port (seeded; JAX's eager init of the same
    trees takes seconds) and handed to both sides."""
    vqa = t_vqa_init(3, T_VQA_CFG, device="cpu")
    vsm = t_vsm_init(5, T_VSM_CFG, device="cpu")
    vsm["llama"] = tl.add_lora(vsm["llama"], 6, r=2, alpha=4)
    gen = torch.Generator().manual_seed(7)
    for name in ("wq_b", "wv_b"):
        lora = vsm["llama"]["layers"]["attn"]["lora"]
        lora[name] = torch.randn(lora[name].shape, generator=gen) * 0.1
    return vqa, vsm


def _jax_tree(tree):
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()), tree)


def _tilted(host):
    """The tiny VSM answering [LOC] (3) at every step, as
    tests/test_torch_slice.py tilts it."""
    host = jax.tree_util.tree_map(torch.clone, host)
    host["llama"]["embed_tokens"][:, 0] += 100.0
    host["llama"]["lm_head"][0, 3] = 10.0
    return host


def _assert_update_close(got, want, msg):
    """Within TOL but for near-zero-gradient elements (module docstring):
    those by at most 0.1 lr, on at most 0.1 % of the leaf."""
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    off = diff > TOL
    assert off.mean() <= 1e-3 and (diff <= 0.1 * LR).all(), \
        f"{msg}: {int(off.sum())} of {diff.size} over {TOL}, max {diff.max()}"


def _spawn(fn, n, *args):
    mp.start_processes(fn, args=(n, *args), nprocs=n, start_method="spawn")


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The 4-rank world's inputs, and its ranks, started on them (joined
    by `world`, so that the references are computed while they run)."""
    work = tmp_path_factory.mktemp("mesh")
    vqa, vsm = _tiny_trees()
    rng = np.random.RandomState(0)
    B, S, D = 4, 24, VQA_CFG.llama.hidden_size
    hidden = rng.randn(B, S, D).astype(np.float32)
    positions = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    kv_lens = np.asarray([24, 17, 9, 24], np.int32)
    vqa_json, vqa_images = _pretrain_files(work / "vqa_data", 8)
    hf_dirs = {"vqa": str(work / "hf_vqa"), "vsm": str(work / "hf_vsm")}
    save_safetensors(vqa_llm_state_dict(vqa), hf_dirs["vqa"])
    save_safetensors(vsm_state_dict(_tilted(vsm)), hf_dirs["vsm"])
    synthetic.make_synthetic_benchmark(str(work / "bench"), n_per_task=1,
                                       seed=0, image_hw=(256, 256), target=3)
    sft_rows = _sft_batch(work, rows=(0, 1, 2, 0, 1, 2, 0, 1))
    make_dataset_dir(work / "vsm_data")
    deep = {"shapes": [DEEP_SHAPE], "vqa_cfg": _deep(T_VQA_CFG),
            "vqa": t_vqa_init(3, _deep(T_VQA_CFG), device="cpu")}
    quantized = {mode: t_vqa_init(3, T_VQA_CFG, device="cpu",
                                  quantize_llm=mode)
                 for mode in QUANT_MODES}
    act_int8 = {mode: (quantized.get(mode) or t_vqa_init(
        3, T_VQA_CFG, device="cpu", quantize_llm=mode), T_VQA_CFG)
        for mode in ACT_MODES}
    act_int8["w4a8"] = ({"llama": init_llama_params(
        Init(9, "cpu"), W4A8_CFG.llama, "int4mix")}, W4A8_CFG)
    job = {"shapes": SHAPES, "deep": deep, "quantized": quantized,
           "prefetch_shapes": (MESHES[0],),
           "act_int8": act_int8, "act_int8_shapes": ACT_SHAPES,
           "format_shapes": FORMAT_SHAPES, "serve_shape": "2x2x1",
           "tower_shape": MODEL_MESH,
           "work": str(work),
           "vqa_cfg": T_VQA_CFG, "vsm_cfg": T_VSM_CFG,
           "vqa": vqa, "vsm": vsm, "tilted_vsm": _tilted(vsm),
           "forward_inputs": tuple(torch.from_numpy(x) for x in
                                   (hidden, positions, kv_lens)),
           "sft_batch": batch_to_torch(sft_rows, "cpu"),
           "vsm_batch": batch_to_torch(_eight_vsm_rows(), "cpu"),
           "vqa_data": {"json": vqa_json, "images": vqa_images},
           "hf_dirs": hf_dirs, "bench": str(work / "bench"),
           "vsm_data": work / "vsm_data"}
    torch.save(job, work / "job.pt")
    job["sft_rows"] = sft_rows
    ranks = mp.start_processes(
        W.world, args=(4, str(work / "store"), str(work / "job.pt"),
                       str(work / "out.pt")),
        nprocs=4, start_method="spawn", join=False)
    return job, work, ranks


@pytest.fixture(scope="module")
def world(started, jax_sft, vsm_refs, jax_vsm_step, jax_serving,
          jax_engines, jax_hidden_engines, jax_quantized, jax_act_int8,
          jax_tp_structure,
          jax_train_layers, jax_towers, plain_towers):
    """The 4-rank world's results, and the inputs it was given."""
    job, work, ranks = started
    while not ranks.join():
        pass
    return torch.load(work / "out.pt", weights_only=False), job, work


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_forward_equals_jax(world, mesh):
    """The decoder's hidden states, every layer gathered from its owner,
    against JAX's and the unsharded port's; the mesh's replicated and
    data-sharded placements are JAX's P() and P('data', None)."""
    out, job, _ = world
    assert out[mesh]["placements"] == (
        (Replicate(),) * 3, (Shard(0), Replicate(), Replicate()))
    hidden, positions, kv_lens = (x.numpy() for x in job["forward_inputs"])
    want, _ = jax.jit(lambda p, h, q, k: j_llama_forward(
        p["llama"], VQA_CFG.llama, h, q, k))(
        _jax_tree(job["vqa"]), hidden, positions, kv_lens)
    got = out[mesh]["forward"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    plain = W.decoder_forward(job["vqa"], T_VQA_CFG,
                              *job["forward_inputs"])
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=TOL, rtol=0)


@pytest.fixture(scope="module")
def jax_sft(started):
    """JAX's f32 finetune step on the same 8 rows."""
    job, _, _ = started
    batch = job["sft_rows"]
    jp = _jax_tree(job["vqa"])
    mask = jsft.make_frozen_vision_mask(jp)
    opt = jsft.make_optimizer(LR, warmup_steps=0, total_steps=4,
                              trainable_mask=mask)
    step = jax.jit(lambda st, b: jsft.sft_train_step(
        st, b, VQA_CFG, opt, mask, compute_dtype=jnp.float32))
    st = jsft.init_train_state(jp, opt)
    losses, norms = [], []
    for _ in range(1):
        st, m = step(st, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    flat = {k: np.asarray(v, np.float32)
            for k, v in leaves_with_path(jax.device_get(st.params))}
    return losses, norms, flat


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_sft_steps_equal_jax(world, jax_sft, mesh):
    out, _, _ = world
    losses, norms, params = out[mesh]["sft"]
    want_l, want_n, want_p = jax_sft
    np.testing.assert_allclose(losses, want_l, rtol=TOL)
    np.testing.assert_allclose(norms, want_n, rtol=TOL)
    assert set(params) == set(want_p)
    for k, v in params.items():
        _assert_update_close(v.numpy(), want_p[k], k)


@pytest.fixture(scope="module")
def vsm_refs(started):
    """JAX's jitted loss on the 8 rows; the unsharded port's gradients and
    step."""
    job, _, _ = started
    _, want_m = jax.jit(lambda p, b: j_vsm_loss(
        p, VSM_CFG, b, compute_dtype=jnp.float32))(
        _jax_tree(job["vsm"]), _eight_vsm_rows())
    grads = W.vsm_grads(job["vsm"], T_VSM_CFG, job["vsm_batch"])
    steps = W.vsm_steps(job["vsm"], T_VSM_CFG, job["vsm_batch"])
    return {k: float(v) for k, v in want_m.items()}, grads, steps


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_vsm_loss_equals_jax_and_grads_the_port(world, vsm_refs,
                                                        mesh):
    """Every metric of the sharded loss (each rank's rows, the whole
    batch's normalisers) equals JAX's; the gradient of every trainable
    leaf equals the unsharded port's (held to JAX's in
    tests/test_torch_train.py)."""
    out, _, _ = world
    metrics, grads = out[mesh]["vsm_grads"]
    want_m, (_, want_g), _ = vsm_refs
    for k, v in want_m.items():
        np.testing.assert_allclose(metrics[k], v, rtol=TOL, err_msg=k)
    assert set(grads) == set(want_g)
    for k, g in grads.items():
        w = want_g[k].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=TOL * float(np.abs(w).max()) + 1e-9,
                                   err_msg=k)


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_vsm_val_forward_equals_unsharded(world, mesh):
    """The trainer's validation forward on the sharded tree (the decoder
    and, on a model axis, the towers split) against the unsharded
    port's: mask logits, detection logits and boxes within TOL."""
    out, job, _ = world
    want = W.vsm_val(job["vsm"], T_VSM_CFG, job["vsm_batch"])
    for got, w in zip(out[mesh]["vsm_val"], want):
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=0,
                                   atol=TOL)


@pytest.mark.parametrize("mesh", MESHES[:2])
def test_sharded_vsm_steps_equal_unsharded(world, vsm_refs, mesh):
    """The sharded f32 VSM step (2 micro-batches) against the unsharded
    port's: metrics within TOL, parameters by _assert_update_close. The
    1x1x4 step is held to JAX's step (test_sharded_vsm_steps_equal_jax,
    0.1 lr) and its gradients to the port's
    (test_sharded_vsm_loss_equals_jax_and_grads_the_port), not here: its
    wq_a holds the near-zero gradient element the JAX comparison
    describes (-3.04e-7 against the leaf's 0.089; the model group's
    partial sums give -3.26e-7), which Adam's first update, scaled by the
    clip near its eps, moves 1.3e-5 to 1.6e-5 apart, one element of 256,
    above the share rule's 0.1 % (the same element is 1.26e-5 apart
    between the unsharded port and JAX)."""
    out, _, _ = world
    metrics, params = out[mesh]["vsm_steps"]
    _, _, (want_m, want_p) = vsm_refs
    for got, want in zip(metrics, want_m):
        for k in ("loss", "ce_loss", "mask_bce_loss", "mask_dice_loss",
                  "detection_loss", "grad_norm"):
            np.testing.assert_allclose(got[k], want[k], rtol=TOL, err_msg=k)
    for k, v in params.items():
        _assert_update_close(v.numpy(), want_p[k].numpy(), k)


@pytest.fixture(scope="module")
def jax_vsm_step(started):
    """JAX's f32 VSM step over 2 micro-batches on the same 8 rows, as
    vsm_train_step computes it (its accumulate's mean of the micro-batch
    gradients and metrics, make_vsm_optimizer's update of the trainable
    leaves; the mask zeroes the others' gradients, which then neither
    move nor add to the norm), with one jitted value_and_grad for both
    micro-batches (a jit of the whole step compiles for 24 s):
    (metrics, the updated tree)."""
    import optax
    job, _, _ = started
    jp = _jax_tree(job["vsm"])
    mask = jl.vsm_trainable_mask(jp)
    rows = _eight_vsm_rows()
    vg = jax.jit(jax.value_and_grad(lambda p, b: j_vsm_loss(
        p, VSM_CFG, b, compute_dtype=jnp.float32), has_aux=True))
    outs = [vg(jp, {k: v[i:i + 4] for k, v in rows.items()})
            for i in (0, 4)]
    train = [p for p, m in leaves_with_path(mask) if m]
    opt = jvsm.make_vsm_optimizer(lr=LR, warmup_steps=0, total_steps=10)

    @jax.jit
    def finish(params, outs):
        grads = {p: jnp.zeros(params[p].shape, jnp.float32) for p in train}
        metrics = None
        for (_, aux), g in outs:
            g = dict(leaves_with_path(g))
            grads = {p: grads[p] + g[p] / 2 for p in train}
            metrics = {k: (0.0 if metrics is None else metrics[k]) + v / 2
                       for k, v in aux.items()}
        sub = {p: params[p] for p in train}
        updates, _ = opt.update(grads, opt.init(sub), sub)
        metrics["grad_norm"] = optax.global_norm(grads)
        return optax.apply_updates(sub, updates), metrics

    flat = {k: np.asarray(v, np.float32) for k, v in leaves_with_path(jp)}
    new, metrics = finish(flat, outs)
    flat.update({k: np.asarray(v, np.float32) for k, v in new.items()})
    return {k: float(v) for k, v in metrics.items()}, flat


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_vsm_steps_equal_jax(world, jax_vsm_step, mesh):
    """The sharded f32 VSM step (2 micro-batches) against JAX's
    single-device step on the same rows: every metric within TOL, every
    leaf of the updated tree within 0.1 lr, the tolerance
    tests/test_torch_train_loop.py holds the unsharded VSM loop to JAX's
    with (LOOP_TOL). The share rule of _assert_update_close admits no
    element of a 256-element LoRA leaf, and one element of
    llama.layers.attn.lora.wq_a moves 1.26e-5 apart from JAX's (a
    near-zero gradient summed in another order)."""
    out, _, _ = world
    (got_m,), params = out[mesh]["vsm_steps"]
    want_m, want_p = jax_vsm_step
    for k in ("loss", "ce_loss", "mask_bce_loss", "mask_dice_loss",
              "detection_loss", "grad_norm"):
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=TOL, err_msg=k)
    assert set(params) == set(want_p)
    for k, v in params.items():
        np.testing.assert_allclose(v.numpy(), want_p[k], rtol=0,
                                   atol=0.1 * LR, err_msg=k)


def _layer_body_collectives(text, shape, act):
    """The collectives over 'model' of the decoder layer body in compiled
    HLO text, by phase: those inside a scan body (op_name .../while/body
    /...) with an operand of the decoder's activation shape `act`
    ([B, S, D] in f32); phase "backward" for the transposed body, and
    "recompute" for its rematted computation, else "forward". A
    combined (tuple) collective counts once."""
    shape_re = re.compile(r"f32\[%s\]" % ",".join(map(str, act)))
    out = {}
    for line in text.splitlines():
        found = _HLO_COLLECTIVE.search(line)
        name = re.search(r'op_name="([^"]*)"', line)
        if not found or found.group(1) not in ("all-reduce", "all-gather") \
                or not name or "while/body" not in name.group(1) or \
                not shape_re.search(line.split(" = ", 1)[1].split(
                    " " + found.group(1))[0]):
            continue
        coords = np.array([np.unravel_index(d, shape) for d in
                           _hlo_groups(found.group(2))[0]])
        if len(set(coords[:, 2])) < 2:
            continue
        op = name.group(1)
        phase = ("forward" if "transpose(" not in op else
                 "recompute" if "rematted_computation" in op
                 else "backward")
        key = (found.group(1).replace("-", "_"), phase)
        out[key] = out.get(key, 0) + 1
    return out


@pytest.fixture(scope="module")
def jax_train_layers(started):
    """vstar_tpu's compiled training on the 1x1x4 mesh of four of the eight
    CPU devices, on the world's f32 trees: the finetune step
    (sft_train_step, the frozen-tower mask, the 8 rows) and the VSM
    loss's value_and_grad on one micro-batch of 4 rows (as
    jax_vsm_step); for each, the model-group collectives of the decoder
    layer body by phase (_layer_body_collectives)."""
    job, _, _ = started
    jm = jmesh.make_mesh(MODEL_SHAPE, devices=jax.devices()[:4])
    D = VQA_CFG.llama.hidden_size
    jp = jmesh.shard_params(_jax_tree(job["vqa"]), jm)
    mask = jsft.make_frozen_vision_mask(jp)
    opt = jsft.make_optimizer(LR, warmup_steps=0, total_steps=4,
                              trainable_mask=mask)
    batch = job["sft_rows"]
    text = jax.jit(lambda st, b: jsft.sft_train_step(
        st, b, VQA_CFG, opt, mask, compute_dtype=jnp.float32)).lower(
        jsft.init_train_state(jp, opt), batch).compile().as_text()
    out = {"sft": _layer_body_collectives(
        text, MODEL_SHAPE, (*batch["text_ids"].shape, D))}
    vp = jmesh.shard_params(_jax_tree(job["vsm"]), jm)
    rows = {k: v[:4] for k, v in _eight_vsm_rows().items()}
    text = jax.jit(jax.value_and_grad(lambda p, b: j_vsm_loss(
        p, VSM_CFG, b, compute_dtype=jnp.float32), has_aux=True)).lower(
        vp, rows).compile().as_text()
    out["vsm"] = _layer_body_collectives(
        text, MODEL_SHAPE, (*rows["text_ids"].shape, D))
    return out


@pytest.mark.parametrize("mesh", TRAIN_TP_MESHES)
@pytest.mark.parametrize("trainer", ["sft", "vsm"])
def test_tensor_parallel_training_equals_jax_layer_body(world,
                                                        jax_train_layers,
                                                        trainer, mesh):
    """A tensor-parallel training step (the finetune step of 8 rows; the
    VSM step of 2 micro-batches, LoRA on q and v): per layer and
    micro-batch, the decoder layer's model-group collectives in the
    forward, the recompute (remat) and the backward equal those of
    vstar_tpu's compiled layer body at 1x1x4: 2 all-reduces forward
    (the f32 partial sums after wo and w_down), 1 recompute (wo's; the
    MLP's output is not needed again), 2 backward (one for each block's
    input, LoRA's gradients in the attention's, as XLA combines them),
    no all-gather; on 1x2x2 the model group runs the same. K1 runs on
    H/M query heads in the forward and the recompute, K7 on H/M; no
    layer gather all-gathers over the model group; each rank holds
    1/M of wq / wk / wv / w_gate / w_up's columns and of wo / w_down's
    rows. Outside the layer body (not compared): the loss's vocabulary
    split (3 all-reduces forward, 1 backward, as XLA's log_softmax and
    target gather), and the tiny embed_tokens, split on its vocabulary,
    which the port all-gathers where XLA reduces a masked lookup."""
    out, _, _ = world
    got = out[mesh][f"{trainer}_structure"]
    cfg = T_VQA_CFG.llama
    L, M = cfg.num_layers, dict(zip(MESHES, SHAPES))[mesh][2]
    micro = 2 if trainer == "vsm" else 1
    per_layer = {(op, phase): n / (L * micro)
                 for (site, op, phase), n in got["collectives"].items()
                 if site == "layer"}
    want = {k: float(n) for k, n in jax_train_layers[trainer].items()}
    assert want == {("all_reduce", "forward"): 2.0,
                    ("all_reduce", "recompute"): 1.0,
                    ("all_reduce", "backward"): 2.0}, want
    assert per_layer == want, got["collectives"]
    vocab = {(op, phase): n for (site, op, phase), n in
             got["collectives"].items() if site == "vocab"}
    assert vocab == {("all_reduce", "forward"): 3 * micro,
                     ("all_reduce", "backward"): micro}, vocab
    assert sorted(set(got["k1"])) == [("forward", cfg.num_heads // M),
                                      ("recompute", cfg.num_heads // M)]
    assert len(got["k1"]) == 2 * L * micro
    assert got["k7"] == [cfg.num_heads // M] * L * micro
    assert got["layer_gathers"] == 0
    D, F, Hq = cfg.hidden_size, cfg.intermediate_size, cfg.q_dim
    want_shapes = {"wq": (L, D, Hq // M), "wk": (L, D, cfg.kv_dim // M),
                   "wv": (L, D, cfg.kv_dim // M), "wo": (L, Hq // M, D),
                   "w_gate": (L, D, F // M), "w_up": (L, D, F // M),
                   "w_down": (L, F // M, D)}
    if mesh == TP_MESH:     # fsdp 2 also shards the 2 layers
        want_shapes = {k: (1, *v[1:]) for k, v in want_shapes.items()}
    assert got["shapes"] == [want_shapes] * 4


@pytest.fixture(scope="module")
def plain_loops(world, tmp_path_factory):
    """The unsharded VQA loop (resumed alike) and VSM loop (two epochs in
    one go) on the world's trees and data."""
    _, job, _ = world
    vqa = W.vqa_loop(job["vqa"], T_VQA_CFG, job["vqa_data"],
                     tmp_path_factory.mktemp("plain_vqa"), None)
    vsm = W.vsm_loop(job["vsm"], T_VSM_CFG, job["vsm_data"], "plain", None,
                     first=False)
    return vqa, vsm


def _state_files(state):
    """A trainer's state checkpoint: "file" (one device's) or the sharded
    directory's files, checked to hold each piece once (the rank files'
    bytes are the global tree's)."""
    if os.path.isfile(state):
        return "file"
    files = sorted(os.listdir(state))
    index = json.loads(open(os.path.join(state, "index.json")).read())
    itemsize = {"F32": 4, "BF16": 2, "I64": 8, "I32": 4, "U8": 1, "I8": 1}
    tree = sum(int(np.prod(e["shape"])) * itemsize[e["dtype"]]
               for e in index["leaves"])
    assert sum(os.path.getsize(os.path.join(state, f)) for f in files
               if f != "index.json") == tree
    return files


# the layout each loop's last checkpoint ends in: the resumes on a mesh
# of 4 write a directory that every rank writes a part of
_DIR_OF_4 = ["index.json"] + [f"rank{r}.bin" for r in range(4)]
_LAST_LAYOUT = {"2x2x1": _DIR_OF_4, "1x2x2": "file", "one": _DIR_OF_4}


@pytest.mark.parametrize("mesh", LOOP_MESHES)
def test_vqa_loop_resumes_sharded_to_the_unsharded_loop(world, plain_loops,
                                                        mesh):
    """run_training's first epoch on `mesh` (2x2x1; 1x2x2, the decoder
    tensor-parallel), then a second invocation resuming from its
    ckpt_latest on another layout (W.CROSS_LOOPS: 1x2x2; one device, rank
    0 alone after the world): the unsharded loop resumed alike (held to
    its run in one go, bit for bit, by tests/test_torch_sft.py) ends in
    the same parameters, with the same logged losses. The last
    checkpoint is one of global tensors, each piece once."""
    _vqa_loop_case(world, plain_loops, mesh)


def _vqa_loop_case(world, plain_loops, name):
    out, job, _ = world
    step, params, logged = out["loops"]["vqa_loop"][name]
    state = os.path.join(job["work"], f"vqa_cross_{name}", "ckpt_latest",
                         "state")
    assert _state_files(state) == _LAST_LAYOUT[name]
    want_step, want_p, want_log = plain_loops[0]
    assert step == want_step == 4
    assert [(r["epoch"], r["step"]) for r in logged] == \
        [(r["epoch"], r["step"]) for r in want_log]
    np.testing.assert_allclose([r["loss"] for r in logged],
                               [r["loss"] for r in want_log], rtol=TOL)
    for k, v in params.items():
        _assert_update_close(v.numpy(), want_p[k].numpy(), k)


def test_vqa_loop_written_on_one_device_resumes_on_1x4x1(world,
                                                         plain_loops):
    """run_training's first epoch on one device (rank 0 before the world
    starts, one file), resumed on 1x4x1 (each rank reads its slices of
    the file): the unsharded loop's parameters and logged losses."""
    _vqa_loop_case(world, plain_loops, "one")


def _vsm_loop_case(world, plain_loops, name):
    out, job, _ = world
    step, params = out["loops"]["vsm_loop"][name]
    run = job["vsm_data"] / "runs" / f"vsm_cross_{name}"
    meta = json.loads((run / "ckpt_latest" / "meta.json").read_text())
    resumed_on = W.CROSS_LOOPS[name][1]
    assert meta["mesh"] == (None if resumed_on is None else
                            [int(x) for x in resumed_on.split("x")]) and \
        meta["epoch"] == 1
    assert _state_files(str(run / "ckpt_latest" / "state")) == \
        _LAST_LAYOUT[name]
    want_step, want_p = plain_loops[1]
    assert step == want_step == 4
    for k, v in params.items():
        _assert_update_close(v.numpy(), want_p[k].numpy(), k)


@pytest.mark.parametrize("mesh", LOOP_MESHES)
def test_vsm_loop_resumes_sharded_to_the_unsharded_loop(world, plain_loops,
                                                        mesh):
    """run_vsm_training (4 rows a step) written on `mesh` and resumed on
    the other layout of W.CROSS_LOOPS, against the unsharded loop's two
    epochs; the meta names the mesh the last checkpoint was written on
    (information only)."""
    _vsm_loop_case(world, plain_loops, mesh)


def test_vsm_loop_written_on_one_device_resumes_on_1x4x1(world,
                                                         plain_loops):
    """run_vsm_training's first epoch on one device, resumed on 1x4x1,
    against the unsharded loop's two epochs."""
    _vsm_loop_case(world, plain_loops, "one")


def _first_moments(state_path):
    """The Adam first moments (path -> whole tensor) of a trainer's state
    checkpoint (either form)."""
    _, opt_state, _ = load_params(state_path)
    adamw = opt_state[1]
    return (adamw["inner"] if isinstance(adamw, dict) else adamw)[0]["mu"]


@pytest.mark.parametrize("name", list(W.CROSS_LOOPS))
def test_resumed_vsm_moments_hold_the_f32_card_rule(world, plain_loops,
                                                    name):
    """The first moments of the VSM loop written on one layout and
    resumed on another (W.CROSS_LOOPS, f32) against the unsharded loop's
    after the same 4 steps, under the rule chip_smoke.py holds its f32
    card reading of part (c) to: each leaf's largest difference within
    MESH_TP_GRAD_TOL of its own largest |value|, for every leaf whose
    largest is at least MESH_TP_GRAD_FLOOR of the tree's."""
    _, job, _ = world
    runs = job["vsm_data"] / "runs"
    got = _first_moments(str(runs / f"vsm_cross_{name}" / "ckpt_latest"
                             / "state"))
    want = _first_moments(str(runs / "plain" / "ckpt_latest" / "state"))
    assert got.keys() == want.keys() and want
    top = max(float(m.abs().max()) for m in want.values())
    held = {p: float((got[p] - m).abs().max() / m.abs().max())
            for p, m in want.items()
            if float(m.abs().max()) >= MESH_TP_GRAD_FLOOR * top}
    assert len(held) > len(want) // 2
    assert max(held.values()) <= MESH_TP_GRAD_TOL, held


@pytest.mark.parametrize("mesh", [MESHES[0], DEEP_MESH])
def test_prefetched_layer_fetch_equals_synchronous(world, mesh):
    """The f32 finetune step on `mesh` (2x2x1: 2 layers over fsdp 2;
    1x4x1: 4 layers, one a rank) with each next layer's owner broadcasts
    issued before the current layer computes, as the trainers run it,
    against the same step with every fetch synchronous: the losses,
    norms and updated leaves equal bit for bit (a broadcast is a copy)
    and so are the fetch counts. In the prefetched run the forward's K1
    call of layer i comes after layer i + 1's broadcasts went out in
    flight, and the recompute's (the backward walks down) after layer
    i - 1's: one layer ahead, never more."""
    out, _, _ = world
    got = out[mesh]["prefetch"]
    (l1, n1, p1), (l2, n2, p2) = got["prefetch"], got["sync"]
    assert l1 == l2 and n1 == n2 and p1.keys() == p2.keys()
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k
    assert got["prefetch_fetches"] == got["sync_fetches"] and \
        got["sync_fetches"].get(("broadcast", "fsdp"))
    layers = DEEP_LAYERS if mesh == DEEP_MESH else T_VQA_CFG.llama.num_layers
    for phase in ("forward", "recompute"):
        seq = [e for e in got["events"] if e[-1] == phase]
        sent = [e for e in seq if e[0] == "broadcast"]
        per_layer = len(sent) // layers
        assert per_layer and len(sent) == per_layer * layers, seq
        k1 = [i for i, e in enumerate(seq) if e[0] == "k1"]
        assert len(k1) == layers, seq
        for j, at in enumerate(k1):
            before = [e for e in seq[:at] if e[0] == "broadcast"]
            ahead = min(j + 2, layers)
            assert len(before) == per_layer * ahead, (phase, j, seq)
            assert sum(e[1] for e in before) == per_layer * (ahead - 1)


def test_export_of_a_mesh_checkpoint_equals_one_device_and_jax(world,
                                                               tmp_path):
    """export_main, one process without torchrun, on the VSM's
    ckpt_model/state written at 2x2x1 (a directory of global pieces)
    gives the same HF dict, bit for bit, as on the same state written on
    one device (one file); its dict equals vstar_tpu's vsm_state_dict of
    the same parameters carried to JAX bit for bit (f32 on both sides,
    LoRA merged)."""
    from vstar_tpu.core import hf_export as jex
    from vstar_tpu_torch.core.checkpoint import load_params, save_params
    from vstar_tpu_torch.train import export_main
    _, job, _ = world
    mesh_ckpt = os.path.join(job["work"], "export_2x2x1")
    assert os.path.isdir(mesh_ckpt)
    state = load_params(mesh_ckpt)
    one = str(tmp_path / "state")
    save_params(state, one)
    sds = [export_main.main(["--ckpt", ckpt, "--version", str(tmp_path),
                             "--save_path", str(tmp_path / name),
                             "--lora_r", "2", "--lora_alpha", "4"])
           for name, ckpt in (("mesh", mesh_ckpt), ("one", one))]
    assert sds[0].keys() == sds[1].keys()
    for k in sds[0]:
        assert sds[0][k].dtype == sds[1][k].dtype and \
            torch.equal(sds[0][k], sds[1][k]), k
    host = jax.tree_util.tree_map(lambda x: x.numpy(), state[0])
    want = jex.vsm_state_dict(host)
    assert sds[0].keys() == want.keys()
    for k in want:
        assert np.array_equal(sds[0][k].float().numpy(), want[k]), k


def test_checkpoint_format_over_ranks(world):
    """save_params of a tree of DTensors on 2x2x1 (uneven torch.chunk
    pieces, two axes on one dim, ranks holding nothing, a leaf the rules
    leave whole, bf16 / int / 0-d and non-tensor leaves), written twice
    (the second replaces the first): the rank files hold the tree's
    bytes and nothing more (each replicated piece once), besides the
    index; read back onto the same leaves placed otherwise on 1x2x2, each
    rank reads as many elements as its own slices hold (no other bytes),
    and every read equals the tree (onto 1x2x2, whole with no template,
    whole onto whole tensors)."""
    out, _, _ = world
    got = out[MESHES[0]]["checkpoint_format"]
    files = got["files"]
    assert set(files) == {"index.json"} | {f"rank{r}.bin" for r in range(4)}
    assert sum(n for f, n in files.items() if f != "index.json") == \
        got["tree_bytes"]
    for r, (reads, own, equal) in enumerate(got["reads"]):
        assert equal == {"mesh": True, "none": True, "whole": True}, r
        want = sum(int(np.prod(e)) for blocks in own.values()
                   for _, e in blocks)
        assert sum(int(np.prod(size)) for _, _, size in reads) == want, r


def _same_engines(got, want):
    """Answers and choices equal; the arrays within JAX's
    sharded-inference tolerance (DET_TOL, MASK_TOL)."""
    assert got["answer"] == want["answer"]
    assert got["choice"] == want["choice"]
    for k in ("boxes", "scores", "heatmap", "segment"):
        np.testing.assert_allclose(
            np.asarray(got[k], np.float64),
            np.asarray(want[k], np.float64), err_msg=k,
            **(MASK_TOL if k in ("heatmap", "segment") else DET_TOL))


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_engines_equal_unsharded(world, mesh):
    """On every mesh the decoder's sums run in another order than on one
    device: on 2x2x1 and 1x2x2 its stack lies on the hidden axis (the
    rmsnorm moments and the q / k / v and gate / up products summed over
    the fsdp group), on 1x2x2 and 1x1x4 it is tensor-parallel (wo and
    w_down summed over the model group); so the answers and choices are
    equal and the arrays agree within JAX's sharded-inference
    tolerance."""
    out, job, _ = world
    got = out[mesh]["engines"]
    want = W.engines(job["vqa"], T_VQA_CFG, job["tilted_vsm"], T_VSM_CFG,
                     None)
    assert len(want["boxes"]) > 0      # the tilted VSM emitted [LOC]
    _same_engines(got, want)


class _Recorded:
    """A jitted function that keeps the arguments of its calls, to lower
    the program it ran again (`hlo`)."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args, **kw):
        self.calls.append((args, kw))
        return self.fn(*args, **kw)

    def hlo(self, i=0):
        args, kw = self.calls[i]
        return self.fn.lower(*args, **kw).compile().as_text()


def _image():
    from PIL import Image
    return Image.fromarray((np.random.RandomState(2).rand(96, 128, 3) * 255)
                           .astype("uint8"))


def _jax_vqa_on(shape, tree, cfg):
    """vstar_tpu's VQA engine sharded on the `shape` mesh of the first CPU
    devices, on the world's settings (W.engines'): the free-form answer,
    the choice, and "bodies": the decoder layer bodies of its compiled
    prefill and decode-chunk programs (_layer_bodies), by program."""
    from vstar_tpu.eval.vqa_engine import VQAEngine as JaxVQAEngine
    from vstar_tpu.multimodal.stub_tokenizer import \
        StubTokenizer as JaxStubTokenizer
    jm = jmesh.make_mesh(shape, devices=jax.devices()[:int(np.prod(shape))])
    vqa = JaxVQAEngine(_jax_tree(tree), cfg,
                       JaxStubTokenizer(cfg.llama.vocab_size),
                       prompt_buckets=(64,), option_bucket=16,
                       compute_dtype=jnp.float32, mesh=jm)
    img = _image()
    out = {"answer": vqa.free_form(img, "what is on the table ?",
                                   max_new_tokens=12),
           "choice": vqa.multiple_choice(img, "what color is the cup ?",
                                         ["red", "blue"])}
    # the keyword-stopped answer runs the prefill and the decode-chunk
    # programs
    vqa._jit_prefill = prefill = _Recorded(vqa._jit_prefill)
    vqa._jit_chunk = chunk = _Recorded(vqa._jit_chunk)
    vqa.free_form(img, "what is on the table ?", max_new_tokens=4,
                  stop_keywords=["zzz"])
    out["bodies"] = {"prefill": _layer_bodies(prefill.hlo(), shape),
                     "decode": _layer_bodies(chunk.hlo(), shape)}
    return out


def _jax_engines_on(shape, vqa_tree, vsm_tree, vqa_cfg, vsm_cfg):
    """_jax_vqa_on, and vstar_tpu's batched VSM engine sharded alike: the
    boxes, scores, heatmap and segment, and the decoder layer bodies of
    its compiled vsm_generate."""
    from vstar_tpu.multimodal.stub_tokenizer import \
        StubTokenizer as JaxStubTokenizer
    from vstar_tpu.search.batched import BatchedVSMEngine as JaxBatchedVSM
    out = _jax_vqa_on(shape, vqa_tree, vqa_cfg)
    jm = jmesh.make_mesh(shape, devices=jax.devices()[:int(np.prod(shape))])
    vsm = JaxBatchedVSM(_jax_tree(vsm_tree), vsm_cfg,
                        JaxStubTokenizer(vsm_cfg.llama.vocab_size),
                        loc_token_id=3, eos_id=2, max_new_tokens=4,
                        prompt_buckets=(64,), compute_dtype=jnp.float32,
                        mesh=jm)
    img = _image()
    vsm._jit_generate = generate = _Recorded(vsm._jit_generate)
    boxes, scores, heatmap = vsm.detect(img, "cat")
    out.update(boxes=np.asarray(boxes), scores=np.asarray(scores),
               heatmap=np.asarray(heatmap),
               segment=np.asarray(vsm.segment(img, "cat")))
    out["bodies"]["vsm_generate"] = _layer_bodies(generate.hlo(), shape)
    return out


@pytest.fixture(scope="module")
def jax_engines(started):
    """vstar_tpu's engines sharded on the 1x2x2 mesh of four of the eight
    CPU devices, on the world's trees (_jax_engines_on)."""
    job, _, _ = started
    return _jax_engines_on(TP_SHAPE, job["vqa"], job["tilted_vsm"], VQA_CFG,
                           VSM_CFG)


def test_tensor_parallel_engines_equal_jax_sharded(world, jax_engines):
    """The port's engines on 1x2x2 (tensor-parallel decoder) against
    vstar_tpu's engines sharded on the same mesh shape."""
    out, _, _ = world
    got = out[TP_MESH]["engines"]
    assert len(got["boxes"]) > 0
    _same_engines(got, jax_engines)


@pytest.fixture(scope="module")
def jax_hidden_engines(started, jax_engines):
    """vstar_tpu's engines on every mesh of HIDDEN_MESHES: both on the
    world's trees on 2x2x1 and 1x2x2 (_jax_engines_on), the VQA engine on
    its DEEP_LAYERS tree on DEEP_SHAPE (_jax_vqa_on)."""
    job, _, _ = started
    return {HIDDEN_MESHES[0]: _jax_engines_on(
                HIDDEN_SHAPES[0], job["vqa"], job["tilted_vsm"], VQA_CFG,
                VSM_CFG),
            TP_MESH: jax_engines,
            DEEP_MESH: _jax_vqa_on(DEEP_SHAPE, job["deep"]["vqa"],
                                   _deep(VQA_CFG))}


@pytest.fixture(scope="module")
def jax_quantized(started):
    """_jax_vqa_on 2x2x1 for each quantized tree of the world (vstar_tpu's
    qdot off the TPU: XLA's dequantized products)."""
    job, _, _ = started
    return {mode: _jax_vqa_on(HIDDEN_SHAPES[0], tree, VQA_CFG)
            for mode, tree in job["quantized"].items()}


@pytest.mark.parametrize("mode", QUANT_MODES)
def test_quantized_engines_on_hidden_axis_equal_jax_sharded(world,
                                                            jax_quantized,
                                                            mode):
    """A quantized VQA engine (`int4mix`: int4 w_gate / w_up, int8 the
    other matrices) on 2x2x1: its stack on the hidden axis too (the int8 / int4 weights and
    the int4 group scales on D, the column-split matrices' int8 scales
    whole, as XLA's dequantized products place them), 4 all-reduces over
    fsdp a layer in a prefill and a decode step, as each layer body of
    vstar_tpu's compiled programs on the same tree, none of them a layer
    fetch; the answer and the choice equal vstar_tpu's engine sharded
    alike and the unsharded port's."""
    out, job, _ = world
    got, structure = out[HIDDEN_MESHES[0]]["quantized"][mode]
    want = jax_quantized[mode]
    assert got == {k: want[k] for k in ("answer", "choice")}
    assert got == W.vqa_answers(job["quantized"][mode], T_VQA_CFG, None)
    for program, bodies in want["bodies"].items():
        assert bodies and all(b == {("all_reduce", ("fsdp",)): 4}
                              for b in bodies), (program, bodies)
    L = T_VQA_CFG.llama.num_layers
    assert structure["hidden_split"] and structure["model_split"] is None
    for name in ("prefill", "decode"):
        counts = structure[name][0]
        assert structure["fetches"][name] == {}
        assert counts == {("all_reduce", "fsdp"): 4 * L,
                          ("all_gather", "fsdp"): 1}, (name, counts)


class _OneRankSplit:
    """A hidden split of one rank (no group): its collectives are the
    identity, counted by site."""

    size = 1

    def __init__(self):
        self.calls = []

    def max(self, x, site=None):
        self.calls.append((site, "max", x.dtype))
        return x

    def reduce_many(self, *parts, site=None):
        self.calls.append((site, "sum", parts[0].dtype))
        return parts


def test_hidden_split_refuses_act_int8_on_quantized_entries():
    """The act-int8 routes scale each row by its largest |value| over the
    whole row; the hidden split no longer refuses them but computes them
    as XLA does (nn/llama._act_int8_dots): on a split of one rank, an
    int8 entry's product (q / k / v), an int4 entry under the W4A8 gate
    (K6's plain version) beside a raw matrix (gate / up), and an int4
    entry outside the gate equal qdot's unsharded products bit for bit,
    with one max and one int32 sum for the int8 group, one max and one
    f32 sum for the W4A8 group, and the f32 sum alone where no product
    quantizes its rows."""
    from vstar_tpu_torch.nn import llama as tllama
    from vstar_tpu_torch.nn import quant as tquant
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((1, 3, 256), generator=gen)
    int8 = [tquant.quantize_weight(torch.randn((256, n), generator=gen))
            for n in (64, 32, 32)]
    int4 = tquant.quantize_weight_int4(torch.randn((256, 128),
                                                   generator=gen))
    raw = torch.randn((256, 128), generator=gen)
    narrow = tquant.quantize_weight_int4(torch.randn((256, 96),
                                                     generator=gen))
    tquant.set_act_int8(True)
    try:
        for ws, want_calls in (
                (int8, [("act_max", "max", torch.float32),
                        ("act_int32", "sum", torch.int32)]),
                ([int4, raw], [("act_max", "max", torch.float32),
                               (None, "sum", torch.float32)]),
                ([narrow, raw], [(None, "sum", torch.float32)])):
            split = _OneRankSplit()
            got = tllama._hidden_dots(x, ws, split)
            want = [tquant.qdot(x, w) for w in ws]
            assert all(torch.equal(g, w) for g, w in zip(got, want))
            assert split.calls == want_calls
    finally:
        tquant.set_act_int8(False)


@pytest.fixture(scope="module")
def jax_act_int8(started):
    """vstar_tpu's int8 VQA engine sharded on 2x2x1 and on 1x4x1 under
    set_act_int8(True) (_jax_vqa_on, a fresh engine so its programs are
    traced with the switch on)."""
    from vstar_tpu.nn import quant as jquant
    job, _, _ = started
    jquant.set_act_int8(True)
    try:
        return {mesh: _jax_vqa_on(shape, job["act_int8"]["int8"][0],
                                  VQA_CFG)
                for mesh, shape in ((MESHES[0], SHAPES[0]),
                                    (DEEP_MESH, DEEP_SHAPE))}
    finally:
        jquant.set_act_int8(False)


def _act_counts(structure, L, per_layer):
    """Each forward's hidden-split collectives: `per_layer` (site ->
    all-reduces a layer) times L, and the residual's one gather; no layer
    fetched."""
    want = {(site, "all_reduce", "forward"): n * L
            for site, n in per_layer.items()}
    want[("residual", "all_gather", "forward")] = 1
    for name in ("prefill", "decode"):
        assert structure["fetches"][name] == {}, name
        assert structure["hidden"][name] == want, name


@pytest.mark.parametrize("mesh,mode", [(MESHES[0], "int8"),
                                       (MESHES[0], "int4mix"),
                                       (DEEP_MESH, "int8")])
def test_act_int8_on_hidden_split_equals_unsharded_and_jax(world,
                                                           jax_act_int8,
                                                           mesh, mode):
    """Under act-int8 the quantized engines on the hidden axis (fsdp 2 at
    2x2x1, each data group a 1x2x1; fsdp 4 at 1x4x1) compute as XLA does:
    every int8 product equals the unsharded _w8a8_dot of the whole rows
    bit for bit; each product group runs one MAX all-reduce (the rows'
    max) and, for int8 entries, one int32 all-reduce of the partial
    products (int4mix's gate / up, W4A16 at the tiny width: their f32
    partial sums), beside the rmsnorm moments; the VQA engine's answer
    and choice equal the unsharded port's under act-int8 and, for the
    int8 tree, vstar_tpu's engine sharded on the same mesh under
    set_act_int8(True), whose compiled layer bodies all-reduce over fsdp
    as often as the port."""
    out, job, _ = world
    answers, (structure, held, equal) = out[mesh]["act_int8"][mode]
    L = T_VQA_CFG.llama.num_layers
    assert equal and held == 2 * L * (5 if mode == "int8" else 3)
    per_layer = ({"layer": 2, "act_max": 2, "act_int32": 2}
                 if mode == "int8" else
                 {"layer": 3, "act_max": 1, "act_int32": 1})
    _act_counts(structure, L, per_layer)
    assert answers == W.act_int8_answers(*job["act_int8"][mode], None)
    if mode == "int8":
        want = jax_act_int8[mesh]
        assert answers == {k: want[k] for k in ("answer", "choice")}
        for program, bodies in want["bodies"].items():
            assert bodies and all(
                b == {("all_reduce", ("fsdp",)): sum(per_layer.values())}
                for b in bodies), (program, bodies)


def test_act_int8_w4a8_on_hidden_split(world):
    """A decoder of width 256 (int4mix: int4 gate / up under the W4A8
    gate, int8 q / k / v / wo / w_down) on 2x2x1 under act-int8: gate /
    up run K6 (its plain version here) on each rank's rows with the
    whole rows' quantization (quantize_rows given the group's max), one
    MAX and one f32 all-reduce for that group; the int8 products equal
    the unsharded _w8a8_dot bit for bit; the hidden states agree with
    the unsharded act-int8 decoder's within ACT_W4A8_TOL (K6's f32 group
    sums and the rmsnorm moments add over ranks in another order)."""
    out, job, _ = world
    structure, held, equal = out[MESHES[0]]["act_int8"]["w4a8"][1]
    L = W4A8_CFG.llama.num_layers
    assert equal and held == 2 * L * 3
    _act_counts(structure, L, {"layer": 3, "act_max": 2, "act_int32": 1})
    assert structure["w4a8_routes"] == 2 * 2 * L
    want = W.act_int8_reference(*job["act_int8"]["w4a8"])
    for name in ("prefill", "decode"):
        np.testing.assert_allclose(structure[name][2].numpy(),
                                   want[name].numpy(), **ACT_W4A8_TOL)


@pytest.mark.parametrize("mesh", [HIDDEN_MESHES[0], DEEP_MESH])
def test_hidden_split_engines_equal_jax_sharded(world, jax_hidden_engines,
                                                mesh):
    """The port's engines with each decoder's stack on the hidden axis
    against vstar_tpu's engines sharded on the same mesh: on 2x2x1 (the
    world's trees) both engines, within DET_TOL / MASK_TOL; on 1x4x1 (a
    VQA tree of 4 layers, which fsdp 4 divides) the VQA engine's answer
    and choice, also against the unsharded port's. 1x2x2, where the
    model axis splits the stack too, is
    test_tensor_parallel_engines_equal_jax_sharded."""
    out, job, _ = world
    want = jax_hidden_engines[mesh]
    if mesh == DEEP_MESH:
        d = job["deep"]
        got = out[mesh]["vqa_answers"]
        assert got == {k: want[k] for k in ("answer", "choice")}
        assert got == W.vqa_answers(d["vqa"], d["vqa_cfg"], None)
    else:
        got = out[mesh]["engines"]
        assert len(got["boxes"]) > 0
        _same_engines(got, want)


@pytest.mark.parametrize("mesh", HIDDEN_MESHES)
def test_hidden_split_structure_equals_jax_engine_hlo(world,
                                                      jax_hidden_engines,
                                                      mesh):
    """Where fsdp is above 1 an engine's decoder computes as the layer body
    of vstar_tpu's compiled engine programs (the VQA engine's prefill and
    decode chunk, and on 2x2x1 and 1x2x2 the VSM's vsm_generate, each
    layer body of each read apart): 4 all-reduces
    over the fsdp group a layer, in a prefill and in a decode step (the
    two rmsnorm moments, the q / k / v partial sums and the gate / up
    ones), and on 1x2x2 beside them the model split's 2; no layer is
    broadcast or gathered (core/mesh.fetch_collectives). The one difference,
    outside the layer body: the port gathers the residual stream once a
    forward after the last layer (one all-gather over fsdp), where XLA
    all-reduces the final norm's moment and the lm_head's partial
    product, because the port's engines hold lm_head and the heads whole
    (ROADMAP Queue 3). K1 runs on H/M heads; each rank's KV cache holds
    H_kv/M heads (all of them on fsdp); each rank holds the layer stack's
    bytes that core/memory.plan_engine_memory plans, 1/F of the stack
    where the model axis is 1."""
    out, job, _ = world
    got = out[mesh]["tp_structure"]
    shape = dict(zip(HIDDEN_MESHES, HIDDEN_SHAPES))[mesh]
    F, M = shape[1], shape[2]
    tree = job["deep"]["vqa"] if mesh == DEEP_MESH else job["vqa"]
    cfg = (job["deep"]["vqa_cfg"] if mesh == DEEP_MESH else T_VQA_CFG).llama
    L = cfg.num_layers
    want = {("all_reduce", ("fsdp",)): 4}
    if M > 1:
        want[("all_reduce", ("model",))] = 2
    for program, bodies in jax_hidden_engines[mesh]["bodies"].items():
        assert bodies and all(b == want for b in bodies), (program, bodies)
    assert got["hidden_split"]
    for name in ("prefill", "decode"):
        counts, heads, _ = got[name]
        assert got["fetches"][name] == {}, name
        assert got["hidden"][name] == {
            ("layer", "all_reduce", "forward"): 4 * L,
            ("residual", "all_gather", "forward"): 1}, name
        assert {(op, (ax,)): n / L for (op, ax), n in counts.items()
                if op == "all_reduce"} == want, (name, counts)
        assert {k: n for k, n in counts.items() if k[0] != "all_reduce"} \
            == {("all_gather", "fsdp"): 1}, (name, counts)
        assert heads == [cfg.num_heads // M] * L
    assert got["cache_heads"] == [(cfg.num_kv_heads // M, cfg.head_dim)] * 4
    stack = sum(x.nbytes for _, x in
                leaves_with_path(tree["llama"]["layers"]))
    plan = tmem.plan_engine_memory(tree, shape)
    assert got["stack_bytes"] == [plan.stack_bytes] * 4
    if M == 1:
        assert plan.stack_bytes * F == stack


@pytest.mark.parametrize("shape", [(1, 4, 1), (1, 2, 2), (2, 2, 1)])
@pytest.mark.parametrize("which", ["vqa", "vsm"])
def test_engine_memory_stack_equals_jax_plan(which, shape):
    """core/memory.plan_engine_memory of the 7B tree (the VSM with LoRA
    r=8): its decoder stack on the hidden axis takes a rank the bytes
    JAX's plan gives the stack on its layer axis, but for LoRA's B and
    scale, which every rank holds whole (JAX shards them on the layer
    axis); every other leaf is whole, but for the towers' matrices the
    model axis splits."""
    t_tree, j_tree = _tree_7b(which, "torch"), _tree_7b(which, "jax")
    fake = types.SimpleNamespace(shape=dict(zip(tmesh.AXES, shape)))
    j_stack = {"llama": {"layers": j_tree["llama"]["layers"]}}
    want = jmem.plan_train_memory(j_stack, fake, trainable_mask=jax.tree.map(
        lambda _: False, j_stack)).params_bytes
    got = tmem.plan_engine_memory(t_tree, shape)
    lora = t_tree["llama"]["layers"]["attn"].get("lora", {})
    whole = sum(x.numel() * x.element_size() for k, x in lora.items()
                if k.endswith("_b"))
    if lora:
        whole += t_tree["llama"]["layers"]["attn"]["lora_scale"].numel() * 4
    F = shape[1]
    assert got.stack_bytes == want + whole - whole // F
    one = tmem.plan_engine_memory(t_tree, None)
    assert one.total_bytes == sum(x.numel() * x.element_size()
                                  for _, x in leaves_with_path(t_tree))
    assert got.other_bytes <= one.other_bytes and "GB/chip" in got.summary()


def _hlo_groups(spec):
    """An HLO replica_groups attribute -> its groups of partition ids (the
    explicit {{..},..} form and the iota [G,S]<=[dims]T(perm) form)."""
    if spec.startswith("{"):
        return [[int(d) for d in g.split(",") if d]
                for g in re.findall(r"\{([\d,]*)\}", spec[1:-1])]
    shape, dims, perm = re.fullmatch(
        r"\[([\d,]+)\]<=\[([\d,]+)\](?:T\(([\d,]+)\))?", spec).groups()
    ids = np.arange(int(np.prod([int(d) for d in dims.split(",")])))
    ids = ids.reshape([int(d) for d in dims.split(",")])
    if perm:
        ids = ids.transpose([int(d) for d in perm.split(",")])
    return ids.reshape([int(d) for d in shape.split(",")]).tolist()


def _layer_bodies(text, shape):
    """The decoder layer bodies of compiled HLO text: each computation that
    holds the decoder's rmsnorm moment all-reduce (a 2-D f32 [B, S] of
    op_name .../closed_call/reduce_sum; the towers' LayerNorm reduces
    under jit(_var), their softmax sums are 3-D), as its collectives by
    (operation, the mesh axes its groups span), a combined (tuple)
    collective once. Partition p is mesh coordinate
    unravel_index(p, shape)."""
    bodies, cur, marked = [], {}, False
    for line in text.splitlines() + ["}"]:
        if not line.startswith(" "):
            if marked:
                bodies.append(cur)
            cur, marked = {}, False
            continue
        found = _HLO_COLLECTIVE.search(line)
        if not found:
            continue
        coords = np.array([np.unravel_index(d, shape)
                           for d in _hlo_groups(found.group(2))[0]])
        axes = tuple(a for i, a in enumerate(tmesh.AXES)
                     if len(set(coords[:, i])) > 1)
        key = (found.group(1).replace("-", "_"), axes)
        cur[key] = cur.get(key, 0) + 1
        marked |= bool(re.search(r'op_name="[^"]*closed_call/reduce_sum"',
                                 line)) and \
            bool(re.search(r"= f32\[\d+,\d+\]\{", line))
    return bodies


def _hlo_collectives(text, shape):
    """(operation, the mesh axes its groups span) -> the number of such
    collectives in compiled HLO text (a collective inside the layer
    scan's body appears once and runs once a layer). Partition p is mesh
    coordinate unravel_index(p, shape)."""
    out = {}
    for op, spec in _HLO_COLLECTIVE.findall(text):
        coords = np.array([np.unravel_index(d, shape)
                           for d in _hlo_groups(spec)[0]])
        axes = tuple(a for i, a in enumerate(tmesh.AXES)
                     if len(set(coords[:, i])) > 1)
        key = (op.replace("-", "_"), axes)
        out[key] = out.get(key, 0) + 1
    return out


@pytest.fixture(scope="module")
def jax_tp_structure(started):
    """vstar_tpu's llama_forward compiled on the 1x2x2 mesh (plain
    attention) for W.tp_structure's prefill and decode step on the VQA
    tree: (the collectives of each compiled step by operation and axes,
    the hidden states of each, the returned cache's spec and per-device
    shard shape)."""
    from vstar_tpu.nn.llama import init_cache as j_init_cache
    job, _, _ = started
    cfg = VQA_CFG.llama
    jm = jmesh.make_mesh(TP_SHAPE, devices=jax.devices()[:4])
    params = jmesh.shard_params(_jax_tree(job["vqa"]), jm)["llama"]
    h = torch.randn((1, W.TP_PREFILL + 1, cfg.hidden_size),
                    generator=torch.Generator().manual_seed(11)).numpy()
    cache = j_init_cache(cfg, 1, W.TP_CACHE, jnp.float32)
    step = jax.jit(lambda p, h, q, k, o, c: j_llama_forward(
        p, cfg, h, q, k, q_offsets=o, cache=c, use_pallas=False))
    out = {}
    for name, lo, hi in (("prefill", 0, W.TP_PREFILL),
                         ("decode", W.TP_PREFILL, W.TP_PREFILL + 1)):
        args = (params, h[:, lo:hi], np.arange(lo, hi, dtype=np.int32)[None],
                np.asarray([hi], np.int32), np.asarray([lo], np.int32),
                cache)
        text = step.lower(*args).compile().as_text()
        hidden, cache = step(*args)
        out[name] = (_hlo_collectives(text, TP_SHAPE), np.asarray(hidden))
    shard = cache.k.sharding
    return out, tuple(shard.spec), shard.shard_shape(cache.k.shape)


def test_tensor_parallel_structure_equals_jax_hlo(world, jax_tp_structure):
    """On 1x2x2, in a prefill and a decode step: the port's model group
    runs 2 all-reduces a layer and no gather, as vstar_tpu's compiled
    step does (2 all-reduces over 'model' in the layer body, no gather
    on 'model'); each rank's cache holds Hkv/2 heads, as JAX's returned
    cache is sharded on its heads; K1 (the attention call) runs on H/2
    heads; the hidden states equal JAX's."""
    out, _, _ = world
    got = out[TP_MESH]["tp_structure"]
    want, spec, shard_shape = jax_tp_structure
    cfg = T_VQA_CFG.llama
    L, M = cfg.num_layers, TP_SHAPE[2]
    assert got["model_split"] == ("attn", "mlp")
    for name in ("prefill", "decode"):
        counts, heads, hidden = got[name]
        hlo, j_hidden = want[name]
        model = {op: n for (op, ax), n in counts.items() if ax == "model"}
        assert model == {"all_reduce": 2 * L}, (name, counts)
        assert hlo[("all_reduce", ("model",))] == model["all_reduce"] // L
        assert not any("model" in ax for (op, ax) in hlo
                       if op != "all_reduce"), (name, hlo)
        assert heads == [cfg.num_heads // M] * L
        np.testing.assert_allclose(hidden.numpy(), j_hidden, atol=TOL,
                                   rtol=0, err_msg=name)
    assert spec == (None, None, None, "model")
    assert got["cache_heads"] == [(shard_shape[3], cfg.head_dim)] * 4
    assert shard_shape[3] == cfg.num_kv_heads // M


@pytest.fixture(scope="module")
def plain_towers(started):
    """The unsharded port's towers on W.tower_tree (W.tower_outputs)."""
    return W.tower_outputs(W.tower_tree())


@pytest.fixture(scope="module")
def jax_towers(started):
    """vstar_tpu's vit_forward at W.tower_cfgs' widths, its parameters
    placed by the rules on the 1x1x4 mesh of four CPU devices, compiled
    only (abstract f32 inputs, one image): per tower, the all-reduces
    and all-gathers over 'model' in the layer scan's body and outside
    it ({("all_reduce" / "all_gather", "layer" / "outside"): n})."""
    from jax.sharding import NamedSharding
    from vstar_tpu.core.params import map_with_path as j_map
    from vstar_tpu.nn.vit import init_vit_params as j_vit_init
    from vstar_tpu.nn.vit import vit_forward as j_vit_forward
    jm = jmesh.make_mesh(MODEL_SHAPE, devices=jax.devices()[:4])
    out = {}
    for name, tcfg_ in W.tower_cfgs().items():
        cfg = j_vsm_7b().vision if name == "vision" else \
            j_vsm_7b().owl_vision
        cfg = dataclasses.replace(cfg, num_layers=tcfg_.num_layers)
        shapes = jax.eval_shape(lambda: j_vit_init(jax.random.PRNGKey(0),
                                                   cfg))

        def abstract(path, leaf, name=name):
            spec = jmesh._clip_spec_to_leaf(
                jmesh.spec_for(f"{name}.{path}"), leaf, jm)
            return jax.ShapeDtypeStruct(leaf.shape, leaf.dtype,
                                        sharding=NamedSharding(jm, spec))
        img = jax.ShapeDtypeStruct(
            (1, cfg.image_size, cfg.image_size, 3), jnp.float32,
            sharding=NamedSharding(jm, jmesh.P()))
        owl = name == "owl_tower"
        text = jax.jit(lambda p, x, cfg=cfg, owl=owl: j_vit_forward(
            p, cfg, x, feature_layer=-1 if owl else None,
            apply_post_ln=owl)).lower(
            j_map(abstract, shapes), img).compile().as_text()
        counts = {}
        for line in text.splitlines():
            found = _HLO_COLLECTIVE.search(line)
            if not found or found.group(1) not in ("all-reduce",
                                                   "all-gather"):
                continue
            coords = np.array([np.unravel_index(d, MODEL_SHAPE) for d in
                               _hlo_groups(found.group(2))[0]])
            if len(set(coords[:, 2])) < 2:
                continue
            key = (found.group(1).replace("-", "_"),
                   "layer" if "while/body" in line else "outside")
            counts[key] = counts.get(key, 0) + 1
        out[name] = counts
    return out


def test_towers_split_as_jax_hlo_at_real_widths(world, jax_towers,
                                                plain_towers):
    """CLIP-L/14 (257 tokens, 16 heads, one layer used) and OWL-B/16 (2305
    tokens, 12 heads, one layer) at their widths on 1x1x4, held as an
    engine or a trainer holds them: the features equal the unsharded
    port's (DET_TOL); each tower's model-group collectives equal those of
    vstar_tpu's compiled tower: in a layer 5 all-reduces (each
    layernorm's two moments, fc2's partial products) and 3 all-gathers
    (the normed states before q / k / v and before fc1, the attention's
    output before wo); outside the layers the pre-LN's (and OWL's
    post-LN's) two all-reduces, and the port's one more all-gather, of
    the output at the tower's end (XLA leaves it split on its features
    into the projectors and heads). Attention runs on H/M heads: CLIP's
    plain attention on 4, OWL's K2 on 3. A tiny tower of 2 heads, which
    M = 4 would cut, gathers its matrices and computes whole: its
    features equal the unsharded port's too."""
    out, _, _ = world
    got, trace, cut = out[MODEL_MESH]["towers"]
    M = MODEL_SHAPE[2]
    cfg, tree, img = W.cut_tower()
    with torch.no_grad():
        want = clip_patch_features(tree["vision"], cfg, img)
    np.testing.assert_allclose(cut.numpy(), want.numpy(), **DET_TOL)
    for name, cfg in W.tower_cfgs().items():
        np.testing.assert_allclose(got[name].numpy(),
                                   plain_towers[name].numpy(),
                                   err_msg=name, **DET_TOL)
        counts, calls = trace[name]
        used = 1
        hlo = jax_towers[name]
        assert hlo[("all_reduce", "layer")] == 5 * used, (name, hlo)
        assert hlo[("all_gather", "layer")] == 3 * used, (name, hlo)
        assert hlo.get(("all_gather", "outside"), 0) == 0, (name, hlo)
        port = {op: n for (site, op, phase), n in counts.items()
                if site == "tower" and phase == "forward"}
        assert set(counts) <= {("tower", op, "forward") for op in port}
        assert port == {
            "all_reduce": hlo[("all_reduce", "layer")]
            + hlo[("all_reduce", "outside")],
            "all_gather": hlo[("all_gather", "layer")] + 1}, (name, port)
        k2 = name == "owl_tower"
        assert calls == [(k2, cfg.num_heads // M)] * used, (name, calls)


def test_model_split_refuses_to_cut_a_head(world):
    """serving_params on 1x2x2 refuses a decoder of 3 heads (3 x 16
    columns divide by 2, 3 heads do not), naming H and M."""
    out, _, _ = world
    msg = out[TP_MESH]["tp_structure"]["refusal"]
    assert msg is not None and "M=2" in msg and "H=3" in msg, msg


def test_evaluation_mains_under_mesh_equal_unsharded(world, tmp_path):
    """vstar_bench main and search_eval main with --mesh 2x2x1 (the loaders
    shard both models) give the unsharded mains' records, correctness
    and search scores; only rank 0 wrote the result file."""
    out, job, work = world
    results, correct, search = out["2x2x1"]["eval_mains"]
    want = W.eval_mains(job["hf_dirs"], job["bench"],
                        str(tmp_path / "plain.json"), None, T_VQA_CFG,
                        T_VSM_CFG)
    assert (results, correct, search) == want
    assert json.loads((work / "eval_2x2x1.json").read_text()) == \
        json.loads((tmp_path / "plain.json").read_text())


def test_7b_finetune_fits_on_two_ranks_refused_on_one(tmp_path):
    """train_vqa_main finetune at 7B (config.json only) with an 80 GB
    card's budget: on a world of 2 at --mesh 1x2x1 the plan fits and the
    run goes on to read the checkpoint (which is not there); in a process
    without ranks the one-device plan is refused, and --mesh 1x2x1 names
    the two world sizes."""
    model = tmp_path / "model"
    model.mkdir()
    (model / "config.json").write_text(json.dumps(config_json(
        tcfg.vqa_llm_7b())))
    _spawn(W.finetune_7b_plan, 2, str(tmp_path / "store"), str(model),
           str(tmp_path / "out.pt"))
    outcome = torch.load(tmp_path / "out.pt")
    assert outcome.startswith("FileNotFoundError: no checkpoint shards"), \
        outcome
    argv = ["finetune", "--model_path", str(model), "--data_path",
            str(model / "none"), "--image_folder", str(model), "--hbm_gb",
            "79.1"]
    with pytest.raises(MemoryError, match="102.41 GB/chip"):
        t_main.main(argv, tokenizer=object(), device="cpu")
    with pytest.raises(ValueError, match="needs 2 devices .* the world has 1"):
        t_main.main(argv + ["--mesh", "1x2x1"], tokenizer=object(),
                    device="cpu")


@pytest.fixture(scope="module")
def jax_serving(started):
    """vstar_tpu's SealService and ContinuousSealService on the world's
    serving engines' trees and settings (f32, W.Forced over the VQA):
    (the single records, (the wave's records, the last record))."""
    import threading
    from vstar_tpu.eval.vqa_engine import VQAEngine as JaxVQAEngine
    from vstar_tpu.multimodal.stub_tokenizer import \
        StubTokenizer as JaxStubTokenizer
    from vstar_tpu.search.batched import BatchedVSMEngine as JaxBatchedVSM
    from vstar_tpu.serve.continuous import \
        ContinuousSealService as JaxContinuousSealService
    from vstar_tpu.serve.server import SealService as JaxSealService
    job, _, _ = started
    cfg = dataclasses.replace(VQA_CFG, max_objects=12)
    tok = JaxStubTokenizer(cfg.llama.vocab_size)
    vqa = W.Forced(JaxVQAEngine(_jax_tree(job["vqa"]), cfg, tok,
                                prompt_buckets=(64, 128, 256),
                                option_bucket=16,
                                compute_dtype=jnp.float32))
    vsm = JaxBatchedVSM(_jax_tree(job["tilted_vsm"]), VSM_CFG, tok,
                        loc_token_id=3, eos_id=2, max_new_tokens=4,
                        prompt_buckets=(64, 128), compute_dtype=jnp.float32)
    svc = JaxSealService(vqa, vsm, max_search_steps=2)
    single = [W._no_latency(svc.answer(W.serve_image(i), q, o))
              for i, (q, o) in enumerate(W.SERVE_REQUESTS)]
    svc = JaxContinuousSealService(vqa, vsm, missing_parser=W.forced_missing,
                                   **W.CONTINUOUS_KW)
    recs = [None] * len(W.WAVE_REQUESTS)

    def go(i):
        recs[i] = W._no_latency(svc.answer(W.serve_image(10 + i),
                                           *W.WAVE_REQUESTS[i]))
    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(recs))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
            assert not t.is_alive()
        after = W._no_latency(svc.answer(W.serve_image(21),
                                         *W.AFTER_REQUEST))
    finally:
        svc.close()
    return single, (recs, after)


def _same_records(got, want):
    """Every field equal, box coordinates within BOX_ATOL."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        strip = ("search_result",)
        assert {k: v for k, v in g.items() if k not in strip} == \
            {k: v for k, v in w.items() if k not in strip}
        assert [r["name"] for r in g["search_result"]] == \
            [r["name"] for r in w["search_result"]]
        for a, b in zip(g["search_result"], w["search_result"]):
            np.testing.assert_allclose(a["bbox"], b["bbox"], rtol=0,
                                       atol=BOX_ATOL)


def test_served_records_equal_unsharded_and_jax(world, jax_serving):
    """SealService on 2x2x1, rank 0 answering and three ranks following:
    the free-form, options and forced-search records equal the unsharded
    port's and vstar_tpu's SealService's."""
    out, job, _ = world
    got = out["2x2x1"]["serve_single"]
    want = W.serve_single(job, None)
    assert got == want
    assert [r["missing_objects"] for r in got] == [[], [], ["red cup"],
                                                   ["red cup"]]
    assert got[2]["search_result"] and got[3]["search_result"]
    _same_records(got, jax_serving[0])


def test_continuous_under_mesh_equals_unsharded_and_jax(world,
                                                        jax_serving):
    """ContinuousSealService on 2x2x1: the three concurrent requests form
    one wave whose records (forced searches) equal the unsharded port's
    and vstar_tpu's; a wave whose prompt no bucket holds fails with its
    error on every rank alike, and the next wave answers."""
    out, job, _ = world
    recs, error, after, stats = out["2x2x1"]["serve_continuous"]
    w_recs, w_error, w_after, _ = W.serve_continuous(job, None)
    assert (recs, error, after) == (w_recs, w_error, w_after)
    assert error.startswith("ValueError: prompt too long")
    assert stats["waves"] == 3 and stats["max_wave"] == 3
    assert all(r["missing_objects"] == ["red cup"] and r["search_result"]
               for r in recs + [after])
    _same_records(recs + [after], jax_serving[1][0] + [jax_serving[1][1]])


def test_server_checkpoint_engines_under_mesh_answer_http(world):
    """checkpoint_engines with --mesh 2x2x1 loads both HF directories onto
    one Mesh (decoder stacks sharded); rank 0's make_server answers a
    request over HTTP as the unsharded server does."""
    out, job, _ = world
    status, rec, one_mesh = out["2x2x1"]["serve_http"]
    assert status == 200 and one_mesh
    want_status, want, unsharded = W.serve_http(job, None)
    assert (status, rec) == (want_status, want) and not unsharded
