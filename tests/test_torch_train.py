"""The port's training modules against the JAX package's, on the CPU, at
tiny widths: the same numpy-seeded inputs and the same weights (carried
across by core.convert) through both. LoRA (attach, merge, forward), the
DETR pieces (GIoU, match cost, auction and host matching, the criterion),
gradient accumulation, the mask upscale, the whole VSM loss and its
gradients, the optimizer against optax, the host data pipeline (datasets,
collate), validation helpers and checkpoints.

Tolerances (f32): 1e-5 for losses, metrics, costs and optimizer updates
(relative where stated); gradients within 1e-4 of each leaf's largest
|value|, plus 1e-9 absolute for leaves whose exact gradient is zero (a
key bias under softmax), where both sides hold rounding noise."""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_data import WordTokenizer
from tests.test_train import _make_batch
from vstar_tpu.core.config import _tiny_llama, vsm_tiny
from vstar_tpu.data import vsm_collate as jcollate
from vstar_tpu.data.vsm_datasets import (HybridDataset as JHybrid,
                                         SegDetDataset as JSegDet,
                                         VQADataset as JVQA)
from vstar_tpu.models.vsm import init_vsm_params
from vstar_tpu.nn.llama import init_llama_params, llama_forward as j_llama
from vstar_tpu.train import detr_loss as jd
from vstar_tpu.train import lora as jl
from vstar_tpu.train import validate as jv
from vstar_tpu.train.accumulate import accumulated_grads as j_accum
from vstar_tpu.train.auction import auction_match as j_auction
from vstar_tpu.train.vsm_train import _upscale_masks as j_upscale
from vstar_tpu.train.vsm_train import make_vsm_optimizer as j_make_opt
from vstar_tpu.train.vsm_train import vsm_loss as j_vsm_loss
from vstar_tpu_torch.core import config as tcfg
from vstar_tpu_torch.core.checkpoint import load_params, save_params
from vstar_tpu_torch.core.convert import from_numpy_tree
from vstar_tpu_torch.core.params import leaves_with_path
from vstar_tpu_torch.data import vsm_collate as tcollate
from vstar_tpu_torch.data.vsm_datasets import (HybridDataset, SegDetDataset,
                                               VQADataset)
from vstar_tpu_torch.nn.llama import llama_forward
from vstar_tpu_torch.train import detr_loss as td
from vstar_tpu_torch.train import lora as tl
from vstar_tpu_torch.train import validate as tv
from vstar_tpu_torch.train.accumulate import accumulated_grads
from vstar_tpu_torch.train.auction import auction_match
from vstar_tpu_torch.train.optim import apply_updates
from vstar_tpu_torch.train.vsm_train import (_upscale_masks,
                                             make_vsm_optimizer, vsm_loss)

torch.set_num_threads(1)

TOL = 1e-5
GRAD_TOL = 1e-4
GRAD_ZERO_ATOL = 1e-9
CFG = vsm_tiny()
T_CFG = tcfg.vsm_tiny()


def t(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def tiny_vsm_host(seed=5, lora_seed=6, b_std=0.1):
    """A tiny JAX VSM tree with LoRA (r=2) whose B is non-zero, as numpy
    (cached: callers copy it, through from_numpy_tree or jnp.asarray)."""
    p = init_vsm_params(jax.random.PRNGKey(seed), CFG)
    p["llama"] = jl.add_lora(p["llama"], jax.random.PRNGKey(lora_seed),
                             r=2, alpha=4)
    lora = p["llama"]["layers"]["attn"]["lora"]
    for i, name in enumerate(("wq_b", "wv_b")):
        lora[name] = jax.random.normal(jax.random.PRNGKey(lora_seed + 1 + i),
                                       lora[name].shape) * b_std
    return jax.device_get(p)


def torch_batch(batch):
    return {k: t(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# LoRA
# ---------------------------------------------------------------------------

def test_lora_forward_and_merge_match_jax():
    cfg = _tiny_llama()
    p = jl.add_lora(init_llama_params(jax.random.PRNGKey(0), cfg),
                    jax.random.PRNGKey(1), r=4, alpha=8)
    p["layers"]["attn"]["lora"]["wv_b"] = jax.random.normal(
        jax.random.PRNGKey(3), p["layers"]["attn"]["lora"]["wv_b"].shape) * .05
    p["layers"]["attn"]["lora"]["wq_b"] = jax.random.normal(
        jax.random.PRNGKey(4), p["layers"]["attn"]["lora"]["wq_b"].shape) * .05
    rng = np.random.RandomState(0)
    h = rng.randn(2, 12, cfg.hidden_size).astype(np.float32)
    pos = np.broadcast_to(np.arange(12), (2, 12)).astype(np.int32)
    lens = np.array([12, 9], np.int32)
    valid = rng.rand(2, 12) > 0.2
    valid[:, 0] = True
    want, _ = j_llama(p, cfg, jnp.asarray(h), jnp.asarray(pos),
                      jnp.asarray(lens), kv_valid=jnp.asarray(valid))
    tp = from_numpy_tree(jax.device_get(p), "cpu")
    t_cfg = tcfg._tiny_llama()
    got, _ = llama_forward(tp, t_cfg, t(h), t(pos), t(lens), kv_valid=t(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    merged = tl.merge_lora(tp)
    want_merged = jax.device_get(jl.merge_lora(p))
    for name in ("wq", "wv"):
        np.testing.assert_allclose(merged["layers"]["attn"][name].numpy(),
                                   want_merged["layers"]["attn"][name],
                                   atol=1e-6, rtol=0)
    assert "lora" not in merged["layers"]["attn"]
    out_merged, _ = llama_forward(merged, t_cfg, t(h), t(pos), t(lens),
                                  kv_valid=t(valid))
    np.testing.assert_allclose(out_merged.numpy(), got.numpy(), atol=2e-5,
                               rtol=0)


def test_add_lora_init_and_trainable_mask():
    tp = from_numpy_tree(tiny_vsm_host(), "cpu")
    tp["llama"] = tl.add_lora(tp["llama"], 3, r=8, alpha=16)
    lora = tp["llama"]["layers"]["attn"]["lora"]
    L, D = CFG.llama.num_layers, CFG.llama.hidden_size
    assert lora["wq_a"].shape == (L, D, 8) and lora["wq_a"].dtype == \
        torch.float32
    assert float(lora["wq_a"].std()) == pytest.approx(1 / 8, rel=0.3)
    assert not lora["wv_b"].any()
    assert torch.equal(tp["llama"]["layers"]["attn"]["lora_scale"],
                       torch.full((L, 1, 1), 2.0))
    assert torch.equal(tl.add_lora(tp["llama"], 3)["layers"]["attn"]["lora"]
                       ["wq_a"], tl.add_lora(tp["llama"], 3)["layers"]["attn"]
                       ["lora"]["wq_a"])
    # the same trainable set as JAX's, lora_scale included
    host = tiny_vsm_host()
    want = dict(leaves_with_path(jl.vsm_trainable_mask(host)))
    got = dict(leaves_with_path(tl.vsm_trainable_mask(
        from_numpy_tree(host, "cpu"))))
    assert got == want
    assert got["llama.layers.attn.lora_scale"]


# ---------------------------------------------------------------------------
# Detection: GIoU, match cost, matching, criterion
# ---------------------------------------------------------------------------

def _det_inputs(seed, B=3, Q=200, T=6):
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, Q, 1).astype(np.float32) * 2
    boxes = np.concatenate([rng.uniform(0.1, 0.9, (B, Q, 2)),
                            rng.uniform(0.02, 0.4, (B, Q, 2))],
                           -1).astype(np.float32)
    tgt = np.concatenate([rng.uniform(0.2, 0.8, (B, T, 2)),
                          rng.uniform(0.05, 0.3, (B, T, 2))],
                         -1).astype(np.float32)
    tvalid = np.zeros((B, T), bool)
    for b, n in enumerate((T, 2, 4)[:B]):
        tvalid[b, :n] = True
    return logits, boxes, tgt, tvalid


def test_giou_and_match_cost_match_jax():
    logits, boxes, tgt, tvalid = _det_inputs(0)
    xyxy = jd.box_cxcywh_to_xyxy(jnp.asarray(boxes[0]))
    want = jd.generalized_box_iou(xyxy, jd.box_cxcywh_to_xyxy(
        jnp.asarray(tgt[0])))
    got = td.generalized_box_iou(td.box_cxcywh_to_xyxy(t(boxes[0])),
                                 td.box_cxcywh_to_xyxy(t(tgt[0])))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    want = jax.vmap(jd.match_cost)(*(jnp.asarray(x) for x in
                                     (logits, boxes, tgt, tvalid)))
    got = td.match_cost(t(logits), t(boxes), t(tgt), t(tvalid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("ties", [False, True])
def test_auction_matches_jax_and_scipy(ties):
    """Identical assignments to JAX's auction (first-index ties included)
    and, on these untied costs, to scipy's optimum."""
    from scipy.optimize import linear_sum_assignment
    logits, boxes, tgt, tvalid = _det_inputs(1)
    cost = np.asarray(jax.vmap(jd.match_cost)(
        *(jnp.asarray(x) for x in (logits, boxes, tgt, tvalid))))
    if ties:   # integer costs: many exact ties between queries
        cost = np.where(cost < 1e5, np.round(cost), cost).astype(np.float32)
    want = np.asarray(j_auction(jnp.asarray(cost), jnp.asarray(tvalid)))
    got = auction_match(t(cost), t(tvalid)).numpy()
    for b in range(cost.shape[0]):
        n = int(tvalid[b].sum())
        np.testing.assert_array_equal(got[b, :n], want[b, :n])
        if not ties:
            rows, cols = linear_sum_assignment(cost[b, :, :n])
            np.testing.assert_array_equal(got[b, cols], rows)
    host = td.hungarian_match(t(cost), t(tvalid), method="callback").numpy()
    for b in range(cost.shape[0]):
        n = int(tvalid[b].sum())
        assert cost[b, host[b, :n], np.arange(n)].sum() == pytest.approx(
            cost[b, got[b, :n], np.arange(n)].sum(), rel=1e-6)


def test_detection_criterion_matches_jax():
    logits, boxes, tgt, tvalid = _det_inputs(2)
    sample_valid = np.array([True, True, False])
    want = jd.detection_criterion(*(jnp.asarray(x) for x in (
        logits, boxes, tgt, tvalid, sample_valid)))
    got = td.detection_criterion(*(t(x) for x in (
        logits, boxes, tgt, tvalid, sample_valid)))
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=TOL,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# Accumulation, mask upscale, the VSM loss
# ---------------------------------------------------------------------------

def test_accumulated_grads_four_micro_equal_full_batch_and_jax():
    rng = np.random.RandomState(0)
    w0 = (rng.randn(4, 4) * 0.5).astype(np.float32)
    x = rng.randn(8, 4).astype(np.float32)
    y = rng.randn(8, 4).astype(np.float32)

    def j_loss(p, b):
        out = b["x"] @ p["w"]
        return jnp.mean((out - b["t"]) ** 2), {"m": jnp.mean(out)}

    def t_loss(p, b):
        out = b["x"] @ p["w"]
        return torch.mean((out - b["t"]) ** 2), {"m": torch.mean(out)}

    jb = {"x": jnp.asarray(x), "t": jnp.asarray(y)}
    l4j, a4j, g4j = j_accum(j_loss, {"w": jnp.asarray(w0)}, jb, 4,
                            has_aux=True)
    tb = {"x": t(x), "t": t(y)}
    l1, a1, g1 = accumulated_grads(t_loss, {"w": t(w0)}, tb, 1, has_aux=True)
    l4, a4, g4 = accumulated_grads(t_loss, {"w": t(w0)}, tb, 4, has_aux=True)
    assert g4["w"].dtype == torch.float32
    np.testing.assert_allclose(float(l4), float(l1), rtol=1e-6)
    np.testing.assert_allclose(g4["w"].numpy(), g1["w"].numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(a4["m"]), float(a1["m"]), rtol=1e-6)
    np.testing.assert_allclose(float(l4), float(l4j), rtol=1e-6)
    np.testing.assert_allclose(g4["w"].numpy(), np.asarray(g4j["w"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(a4["m"]), float(a4j["m"]), rtol=1e-6)


@pytest.mark.parametrize("src,dst", [((12, 12), (48, 48)),
                                     ((7, 9), (20, 31))])
def test_upscale_masks_matches_jax_image_resize(src, dst):
    m = np.random.RandomState(sum(src)).randn(2, *src).astype(np.float32)
    want = j_upscale(jnp.asarray(m), dst)
    got = _upscale_masks(t(m), dst)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


def _assert_grads_close(got, want_tree):
    want = dict(leaves_with_path(jax.device_get(want_tree)))
    assert got, "no gradients"
    for k, g in got.items():
        w = np.asarray(want[k], np.float32)
        tol = GRAD_TOL * float(np.abs(w).max()) + GRAD_ZERO_ATOL
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0, atol=tol,
                                   err_msg=k)


def test_vsm_loss_and_grads_match_jax():
    """vsm_loss at vsm_tiny in f32: the total and every metric within 1e-5
    relative; the gradient of every trainable leaf within 1e-4 of its
    largest |value|."""
    host = tiny_vsm_host()
    batch = _make_batch()
    jp = jax.tree_util.tree_map(jnp.asarray, host)
    (want, want_m), want_g = jax.jit(jax.value_and_grad(
        lambda p, b: j_vsm_loss(p, CFG, b, compute_dtype=jnp.float32),
        has_aux=True))(jp, batch)
    tp = from_numpy_tree(host, "cpu")
    loss, metrics, grads = accumulated_grads(
        lambda p, b: vsm_loss(p, T_CFG, b, compute_dtype=torch.float32), tp,
        torch_batch(batch), 1, has_aux=True,
        trainable=tl.vsm_trainable_mask(tp))
    np.testing.assert_allclose(float(loss), float(want), rtol=TOL)
    for k in want_m:
        np.testing.assert_allclose(float(metrics[k]), float(want_m[k]),
                                   rtol=TOL, err_msg=k)
    assert len(grads) == sum(dict(leaves_with_path(
        tl.vsm_trainable_mask(tp))).values())
    _assert_grads_close(grads, want_g)


# ---------------------------------------------------------------------------
# The optimizer against optax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warmup,master,dtype", [
    (0, False, "float32"), (1, False, "float32"), (0, True, "bfloat16"),
    (1, True, "bfloat16"), (2, False, "bfloat16")])
def test_optimizer_matches_optax(warmup, master, dtype):
    """Three updates of make_vsm_optimizer (clip, masked AdamW with the
    warmup-decay schedule, optional f32 masters) against the JAX package's
    optax chain, with the clip active on the first update only."""
    import optax
    rng = np.random.RandomState(warmup + 3 * master)
    jd_ = jnp.float32 if dtype == "float32" else jnp.bfloat16
    shapes = {"a": (3, 5), "b": (7,), "frozen": (4, 2)}
    params = {k: np.asarray(jnp.asarray(rng.randn(*s) * 0.3, jd_))
              for k, s in shapes.items()}
    mask = {"a": True, "b": True, "frozen": False}
    j_opt = j_make_opt(lr=1e-2, warmup_steps=warmup, total_steps=10,
                       trainable_mask=mask, master_f32=master)
    t_opt = make_vsm_optimizer(lr=1e-2, warmup_steps=warmup, total_steps=10,
                               trainable_mask=mask, master_f32=master)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    j_state = j_opt.init(jp)
    tp = from_numpy_tree(params, "cpu")
    t_state = t_opt.init(dict(tp))
    for step, g_scale in enumerate((3.0, 0.1, 0.2)):
        grads = {k: (rng.randn(*s) * g_scale).astype(np.float32)
                 for k, s in shapes.items() if mask[k]}
        jg = {k: jnp.asarray(grads.get(k, np.zeros(shapes[k])),
                             jnp.float32) for k in shapes}
        upd, j_state = j_opt.update(jg, j_state, jp)
        jp = optax.apply_updates(jp, upd)
        tu, t_state = t_opt.update({k: t(v) for k, v in grads.items()},
                                   t_state, tp)
        tp = dict(tp, **apply_updates(tp, tu))
        for k in shapes:
            np.testing.assert_allclose(
                tp[k].float().numpy(), np.asarray(jp[k], np.float32),
                atol=1e-6, rtol=0, err_msg=f"step {step} {k}")
    assert torch.equal(tp["frozen"], from_numpy_tree(params, "cpu")
                       ["frozen"])


# ---------------------------------------------------------------------------
# Host data pipeline, validation helpers, checkpoints
# ---------------------------------------------------------------------------

def make_dataset_dir(base):
    """Synthetic vqa_data + cocostuff files, as tests/test_data.py builds
    them."""
    rng = np.random.RandomState(1)
    os.makedirs(base / "vqa_data" / "coco_images", exist_ok=True)
    Image.fromarray((rng.rand(40, 52, 3) * 255).astype("uint8")).save(
        base / "vqa_data" / "coco_images" / "img0.jpg")
    json.dump([{"image": "img0.jpg", "conversations": [
        {"from": "human", "value": "<image>\nwhere is the cup?"},
        {"from": "gpt", "value": "on the table"}]}],
        open(base / "vqa_data" / "possible_locations_conv_86k.json", "w"))
    os.makedirs(base / "coco" / "train2017", exist_ok=True)
    Image.fromarray((rng.rand(40, 60, 3) * 255).astype("uint8")).save(
        base / "coco" / "train2017" / "000001.jpg")
    json.dump({"000001": {
        "cat": {"bboxes": [[5, 5, 20, 20], [30, 10, 50, 30]], "cat_id": 7},
        "dog": {"bboxes": [[2, 20, 25, 38]], "cat_id": 9}}},
        open(base / "cocostuff_image2bboxes.json", "w"))
    os.makedirs(base / "cocostuff" / "train2017", exist_ok=True)
    sem = np.full((40, 60), 255, np.uint8)
    sem[5:20, 5:20] = 7
    sem[22:38, 2:25] = 9
    Image.fromarray(sem).save(base / "cocostuff" / "train2017"
                              / "000001.png")


def test_datasets_and_collate_match_jax(tmp_path):
    make_dataset_dir(tmp_path)
    tok = WordTokenizer()
    kw = dict(clip_size=CFG.vision.image_size,
              owl_size=CFG.owl_vision.image_size)
    j_h = JHybrid([JSegDet(str(tmp_path), seed=0, **kw),
                   JVQA(str(tmp_path), seed=1, **kw)], [1, 1],
                  samples_per_epoch=4, seed=2)
    t_h = HybridDataset([SegDetDataset(str(tmp_path), seed=0, **kw),
                         VQADataset(str(tmp_path), seed=1, **kw)], [1, 1],
                        samples_per_epoch=4, seed=2)
    n = 0
    for jrows, trows in zip(j_h.batches(2, epoch=0), t_h.batches(2, epoch=0)):
        want = jcollate.collate_vsm_rows(jrows, tok, 3, n_image_tokens=4,
                                         seq_bucket=64, t_max=4, mask_res=12)
        got = tcollate.collate_vsm_rows(trows, tok, 3, n_image_tokens=4,
                                        seq_bucket=64, t_max=4, mask_res=12)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        n += 1
    assert n >= 2


def test_validate_helpers_match_jax():
    rng = np.random.RandomState(4)
    pred, gt = rng.randn(16, 16), (rng.rand(16, 16) > 0.5).astype(np.float32)
    assert tv.mask_intersection_union(pred, gt) == \
        jv.mask_intersection_union(pred, gt)
    for seed in range(6):
        r = np.random.RandomState(seed)
        logits = r.randn(9).astype(np.float32)
        boxes = np.concatenate([r.uniform(0.2, 0.8, (9, 2)),
                                r.uniform(0.1, 0.5, (9, 2))], -1)
        gts = boxes[np.argmax(logits)][None] + r.uniform(-0.1, 0.1, (2, 4))
        assert tv.det_top1_correct(logits, boxes, gts) == \
            jv.det_top1_correct(logits, boxes, gts)


def test_checkpoint_roundtrip(tmp_path):
    tree = ({"w": torch.randn(3, 4).to(torch.bfloat16),
             "nest": [torch.arange(5), {"b": torch.ones(2)}]},
            [{"count": 3, "mu": {"w": torch.zeros(2)}}], 7)
    path = str(tmp_path / "state")
    save_params(tree, path)
    save_params(tree, path)             # overwrites in place
    back = load_params(path)
    assert back[2] == 7 and back[1][0]["count"] == 3
    assert torch.equal(back[0]["w"], tree[0]["w"])
    assert torch.equal(back[0]["nest"][0], tree[0]["nest"][0])
    assert os.listdir(tmp_path) == ["state"]
