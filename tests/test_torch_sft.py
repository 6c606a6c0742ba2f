"""The port's VQA trainer against the JAX package's, on the CPU, at tiny
widths: the same numpy-seeded inputs and weights (carried across by
core.convert) through both. The datasets and collates (exactly equal),
the warmup-cosine schedule and the SFT optimizer against optax, sft_loss
and its gradients, pretrain and finetune steps, run_training with a
resume, both train_vqa_main subcommands, the one-device memory plan
against JAX's on a 1x1x1 mesh (and the trainers' refusal of a plan over
the device's memory), and refer_convert.

Tolerances (f32): losses and updated parameters within 1e-5; gradients
within 1e-4 of each leaf's largest |value| (plus 1e-9 absolute where the
exact gradient is zero); schedules within one ulp of the cosine (XLA's
float32 cos is its own polynomial); logged losses of the trainer loop
within 1e-4 relative, as the VSM loop test holds them."""

import dataclasses
import functools
import json
import os
import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

import vstar_tpu.train.train_vqa_main as j_main
import vstar_tpu_torch.train.train_vqa_main as t_main
from tests.test_data import WordTokenizer
from tests.test_vqa_sft_data import _fixture
from vstar_tpu.core.config import vqa_llm_7b as j_vqa_7b
from vstar_tpu.core.config import vqa_llm_tiny
from vstar_tpu.core.memory import (check_memory as j_check,
                                   plan_train_memory as j_plan)
from vstar_tpu.data import pretrain_dataset as jpre
from vstar_tpu.data import refer_convert as jrefer
from vstar_tpu.data import vqa_sft_dataset as jsft_data
from vstar_tpu.models.vqa_llm import init_vqa_llm_params
from vstar_tpu.train import sft as jsft
from vstar_tpu_torch.core import config as tcfg
from vstar_tpu_torch.core import memory as tmem
from vstar_tpu_torch.core.convert import from_numpy_tree
from vstar_tpu_torch.core.params import leaves_with_path
from vstar_tpu_torch.data import pretrain_dataset as tpre
from vstar_tpu_torch.data import refer_convert as trefer
from vstar_tpu_torch.data import vqa_sft_dataset as tsft_data
from vstar_tpu_torch.data.vsm_collate import batch_to_torch
from vstar_tpu_torch.models.vqa_llm import init_vqa_llm_params as t_init
from vstar_tpu_torch.train import optim
from vstar_tpu_torch.train import sft as tsft
from vstar_tpu_torch.train.accumulate import accumulated_grads

torch.set_num_threads(1)

TOL = 1e-5
GRAD_TOL = 1e-4
LOOP_TOL = 1e-4
CFG = vqa_llm_tiny()
T_CFG = tcfg.vqa_llm_tiny()
NL, NS = CFG.image_tokens_long, CFG.image_tokens_short


@functools.lru_cache(maxsize=None)
def tiny_vqa_host(seed=3):
    return jax.device_get(init_vqa_llm_params(jax.random.PRNGKey(seed), CFG))


def _flat(tree):
    return {k: np.asarray(v, np.float32)
            for k, v in leaves_with_path(jax.device_get(tree))}


def _sft_instances(tmp_path):
    """JAX's and the port's SearchInstructionDataset over one fixture (a
    search row with one object, a plain image row, a text-only row) at
    the tiny tower's 28 pixels."""
    j_ds = _fixture(tmp_path)
    t_ds = tsft_data.SearchInstructionDataset(
        str(tmp_path), str(tmp_path / "images"),
        image_size=CFG.vision.image_size)
    return j_ds, t_ds


def _sft_batch(tmp_path, rows=(0, 1, 2, 0)):
    j_ds, _ = _sft_instances(tmp_path)
    return jsft_data.collate_vqa_sft([j_ds[i] for i in rows],
                                     WordTokenizer(), n_long=NL,
                                     n_short=NS, seq_bucket=64)


def test_datasets_and_collates_equal_jax(tmp_path):
    """SearchInstructionDataset rows, collate_vqa_sft and the pretrain
    dataset's collate_pretrain equal JAX's exactly."""
    j_ds, t_ds = _sft_instances(tmp_path / "sft")
    assert len(j_ds) == len(t_ds) == 3
    tok = WordTokenizer()
    for i in range(3):
        a, b = j_ds[i], t_ds[i]
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)
            else:
                assert b[k] == a[k], k
    want = jsft_data.collate_vqa_sft([j_ds[i] for i in range(3)], tok,
                                     n_long=NL, n_short=NS, seq_bucket=64)
    got = tsft_data.collate_vqa_sft([t_ds[i] for i in range(3)], tok,
                                    n_long=NL, n_short=NS, seq_bucket=64)
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    src = [{"from": "human", "value": "<image>\nwhere <object> ?"},
           {"from": "gpt", "value": "here"}]
    assert tsft_data.rewrite_conversations(src, ["cup <object> at x"]) == \
        jsft_data.rewrite_conversations(src, ["cup <object> at x"])

    data_path, img_dir = _pretrain_files(tmp_path / "pre", 3)
    j_pre = jpre.PretrainCaptionDataset(data_path, img_dir, image_size=28)
    t_pre = tpre.PretrainCaptionDataset(data_path, img_dir, image_size=28)
    for image_long in (True, False):
        want = jpre.collate_pretrain([j_pre[i] for i in range(3)], tok,
                                     n_long=NL, n_short=NS,
                                     image_long=image_long, seq_bucket=32)
        got = tpre.collate_pretrain([t_pre[i] for i in range(3)], tok,
                                    n_long=NL, n_short=NS,
                                    image_long=image_long, seq_bucket=32)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("lr,warmup,total", [(2e-5, 100, 1000),
                                             (2e-3, 2, 9), (1e-2, 0, 4)])
def test_cosine_schedule_equals_optax(lr, warmup, total):
    """warmup_cosine_decay_schedule against optax's, jitted as the JAX
    optimizer evaluates it, at every count through the end and past it."""
    want = jax.jit(optax.warmup_cosine_decay_schedule(
        0.0, lr, warmup, max(total, warmup + 1)))
    got = optim.warmup_cosine_decay_schedule(0.0, lr, warmup,
                                             max(total, warmup + 1))
    for count in range(total + 3):
        w = float(want(jnp.int32(count)))
        g = float(got(count))
        assert abs(g - w) <= lr * 2 ** -23, (count, g, w)


@pytest.mark.parametrize("warmup,master,dtype", [
    (0, False, "float32"), (1, True, "bfloat16")])
def test_sft_optimizer_matches_optax(warmup, master, dtype):
    """Three updates of make_optimizer (clip, masked AdamW b=(0.9, 0.999)
    on the warmup-cosine schedule, optional f32 masters) against the JAX
    package's, with the clip active on the first update only."""
    rng = np.random.RandomState(warmup)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    shapes = {"a": (3, 5), "b": (7,), "frozen": (4, 2)}
    params = {k: np.asarray(jnp.asarray(rng.randn(*s) * 0.3, jd))
              for k, s in shapes.items()}
    mask = {"a": True, "b": True, "frozen": False}
    j_opt = jsft.make_optimizer(1e-2, warmup_steps=warmup, total_steps=6,
                                trainable_mask=mask, master_f32=master)
    t_opt = tsft.make_optimizer(1e-2, warmup_steps=warmup, total_steps=6,
                                trainable_mask=mask, master_f32=master)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    j_state = j_opt.init(jp)
    tp = from_numpy_tree(params, "cpu")
    t_state = t_opt.init(dict(tp))
    for step, g_scale in enumerate((3.0, 0.1, 0.2)):
        grads = {k: (rng.randn(*s) * g_scale).astype(np.float32)
                 for k, s in shapes.items() if mask[k]}
        jg = {k: jnp.asarray(grads.get(k, np.zeros(shapes[k])), jnp.float32)
              for k in shapes}
        upd, j_state = j_opt.update(jg, j_state, jp)
        jp = optax.apply_updates(jp, upd)
        tu, t_state = t_opt.update({k: torch.from_numpy(v)
                                    for k, v in grads.items()}, t_state, tp)
        tp = dict(tp, **optim.apply_updates(tp, tu))
        for k in shapes:
            np.testing.assert_allclose(
                tp[k].float().numpy(), np.asarray(jp[k], np.float32),
                atol=1e-6, rtol=0, err_msg=f"step {step} {k}")


def test_sft_loss_and_grads_match_jax(tmp_path):
    """sft_loss on a collated search/plain/text-only batch (kv_valid holes
    at the padded object slots) in f32: the loss within 1e-5, the
    gradient of every leaf but the frozen tower's within 1e-4 of its
    largest |value|; the tower gets none."""
    host = tiny_vqa_host()
    batch = _sft_batch(tmp_path)
    jp = jax.tree_util.tree_map(jnp.asarray, host)
    want, want_g = jax.jit(jax.value_and_grad(
        lambda p, b: jsft.sft_loss(p, CFG, b, compute_dtype=jnp.float32)))(
        jp, batch)
    tp = from_numpy_tree(host, "cpu")
    mask = tsft.make_frozen_vision_mask(tp)
    loss, _, grads = accumulated_grads(
        lambda p, b: tsft.sft_loss(p, T_CFG, b, compute_dtype=torch.float32),
        tp, batch_to_torch(batch, "cpu"), 1, trainable=mask)
    np.testing.assert_allclose(float(loss), float(want), rtol=TOL)
    want_g = dict(leaves_with_path(jax.device_get(want_g)))
    assert set(grads) == {k for k, m in leaves_with_path(mask) if m}
    for k, g in grads.items():
        w = np.asarray(want_g[k], np.float32)
        tol = GRAD_TOL * float(np.abs(w).max()) + 1e-9
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol,
                                   err_msg=k)
    assert all(float(np.abs(v).max()) == 0 for k, v in want_g.items()
               if k.startswith("vision."))


@pytest.mark.parametrize("stage", ["pretrain", "finetune"])
def test_sft_train_steps_match_jax(tmp_path, stage):
    """Two sft_train_steps (pretrain: the linear projector alone, 2
    micro-batches; finetune: everything but the tower) at learning rate
    1e-3 (a first step at 0) against JAX's jitted step in f32: losses and
    every parameter within 1e-5, frozen leaves unchanged."""
    host = tiny_vqa_host()
    batch = _sft_batch(tmp_path)
    jp = jax.tree_util.tree_map(jnp.asarray, host)
    tp = from_numpy_tree(host, "cpu")
    if stage == "pretrain":
        j_mask = j_main.projector_only_mask(jp, "linear")
        t_mask = t_main.projector_only_mask(tp, "linear")
        accum = 2
    else:
        j_mask = j_main.frozen_vision_mask(jp)
        t_mask = t_main.frozen_vision_mask(tp)
        accum = 1
    j_opt = jsft.make_optimizer(1e-3, warmup_steps=1, total_steps=4,
                                trainable_mask=j_mask)
    t_opt = tsft.make_optimizer(1e-3, warmup_steps=1, total_steps=4,
                                trainable_mask=t_mask)
    j_step = jax.jit(lambda st, b: jsft.sft_train_step(
        st, b, CFG, j_opt, j_mask, compute_dtype=jnp.float32,
        grad_accum=accum))
    j_state = jsft.init_train_state(jp, j_opt)
    t_state = tsft.init_train_state(tp, t_opt)
    tb = batch_to_torch(batch, "cpu")
    for step in range(2):
        j_state, jm = j_step(j_state, batch)
        t_state, tm = tsft.sft_train_step(t_state, tb, T_CFG, t_opt, t_mask,
                                          compute_dtype=torch.float32,
                                          grad_accum=accum)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=TOL, err_msg=f"step {step}")
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    assert t_state.step == int(j_state.step) == 2
    want = _flat(j_state.params)
    start = dict(leaves_with_path(from_numpy_tree(host, "cpu")))
    flat_mask = dict(leaves_with_path(t_mask))
    for k, v in leaves_with_path(t_state.params):
        np.testing.assert_allclose(v.numpy(), want[k], atol=TOL, rtol=0,
                                   err_msg=k)
        if not flat_mask[k]:
            assert torch.equal(v, start[k]), k


def _pretrain_files(base, n):
    os.makedirs(base / "imgs")
    rng = np.random.RandomState(0)
    items = []
    for i in range(n):
        fname = f"im{i}.jpg"
        Image.fromarray((rng.rand(40, 52, 3) * 255).astype("uint8")).save(
            base / "imgs" / fname)
        items.append({"image": fname, "conversations": [
            {"from": "human", "value": "<image>\ndescribe"},
            {"from": "gpt", "value": f"a photo number {i}"}]})
    with open(base / "pretrain.json", "w") as f:
        json.dump(items, f)
    return str(base / "pretrain.json"), str(base / "imgs")


def _loop_args(out, mesh, save_steps=0, epochs=2):
    return types.SimpleNamespace(
        stage="pretrain", mesh=mesh, param_dtype="f32", hbm_gb=16.0,
        per_device_batch_size=2, num_train_epochs=epochs, log_every=1,
        output_dir=str(out), data_workers=2, prefetch_depth=2,
        auto_resume=True, save_steps=save_steps)


def test_run_training_steps_and_resumes(tmp_path, monkeypatch):
    """run_training (pretrain, 6 rows shuffled by (data_seed, epoch) as
    vstar_tpu shuffles them, 2 epochs of 3 steps) in f32 compute: its
    logged losses and final state are those of sft_train_step over the
    same batches (the step itself is held to JAX's above); then a run
    that crashes in epoch 1 resumes from its rolling save into the same
    final state bit for bit."""
    import random
    data_path, img_dir = _pretrain_files(tmp_path, 6)
    step = functools.partial(tsft.sft_train_step,
                             compute_dtype=torch.float32)
    monkeypatch.setattr(t_main, "sft_train_step", step)
    tok = WordTokenizer()
    ds = tpre.PretrainCaptionDataset(data_path, img_dir, image_size=28)

    def collate(instances, tk):
        return tpre.collate_pretrain(instances, tk, n_long=NL, n_short=NS,
                                     image_long=True, seq_bucket=32)

    def run(args, params):
        mask = t_main.projector_only_mask(params, "linear")
        return t_main.run_training(args, T_CFG, params, ds, collate, tok,
                                   mask, lr=1e-3)

    host = tiny_vqa_host()
    t_state = run(_loop_args(tmp_path / "port", None),
                  from_numpy_tree(host, "cpu"))
    assert t_state.step == 6

    params = from_numpy_tree(host, "cpu")
    mask = t_main.projector_only_mask(params, "linear")
    opt = tsft.make_optimizer(1e-3, warmup_steps=0, total_steps=6,
                              trainable_mask=mask)
    state = tsft.init_train_state(params, opt)
    losses = []
    for epoch in range(2):
        idx = list(range(6))
        random.Random(hash((0, epoch))).shuffle(idx)
        for a in range(3):
            batch = batch_to_torch(collate([ds[j] for j in idx[2 * a:
                                                               2 * a + 2]],
                                           tok), "cpu")
            state, m = step(state, batch, T_CFG, opt, mask)
            losses.append(float(m["loss"]))
    lines = (tmp_path / "port" / "metrics.jsonl").read_text().splitlines()
    logged = [json.loads(x) for x in lines]
    assert [(r["epoch"], r["step"]) for r in logged] == \
        [(e, i) for e in range(2) for i in range(3 * e, 3 * e + 3)]
    np.testing.assert_allclose([r["loss"] for r in logged],
                               [np.mean(losses[:i + 1]) for i in range(6)],
                               rtol=1e-6)
    for (k, a), (_, b) in zip(leaves_with_path(t_state.params),
                              leaves_with_path(state.params)):
        assert torch.equal(a, b), k

    # a run that crashes in epoch 1 (after epoch 0's closing save)
    # resumes, from other initial weights, into the same final state
    class Bomb(t_main.StepTimer):
        calls = 0

        def step_done(self):
            super().step_done()
            Bomb.calls += 1
            if Bomb.calls == 5:
                raise RuntimeError("simulated crash")

    monkeypatch.setattr(t_main, "StepTimer", Bomb)
    with pytest.raises(RuntimeError, match="simulated crash"):
        run(_loop_args(tmp_path / "resume", None, save_steps=2),
            from_numpy_tree(host, "cpu"))
    meta = json.loads((tmp_path / "resume" / "ckpt_latest" / "meta.json")
                      .read_text())
    assert (meta["epoch"], meta["step"]) == (0, 2)
    other = from_numpy_tree(jax.device_get(init_vqa_llm_params(
        jax.random.PRNGKey(9), CFG)), "cpu")
    resumed = run(_loop_args(tmp_path / "resume", None, save_steps=2),
                  other)
    assert resumed.step == 6
    for (k, a), (_, b) in zip(leaves_with_path(resumed.params),
                              leaves_with_path(t_state.params)):
        assert torch.equal(a, b), k


def test_train_vqa_main_subcommands(tmp_path, monkeypatch, capsys):
    """Both subcommands on the CPU at the tiny config: pretrain writes the
    projector adapter (only it moved), finetune loads an HF directory
    (written by core.hf_export), trains and writes the parameters (the
    tower unchanged). On an 80 GB card, finetune at the full 7B is
    refused by the memory check before the checkpoint is read: the
    directory holds only its config.json."""
    from vstar_tpu_torch.core import hf_config
    from vstar_tpu_torch.core.checkpoint import load_params
    from vstar_tpu_torch.core.hf_export import config_json, save_hf_dir, \
        vqa_llm_state_dict
    monkeypatch.setattr(tcfg, "vqa_llm_7b", tcfg.vqa_llm_tiny)
    tok = WordTokenizer()
    data_path, img_dir = _pretrain_files(tmp_path / "pre", 4)
    common = ["--image_folder", img_dir, "--per_device_batch_size", "2",
              "--seq_bucket", "32", "--param_dtype", "f32",
              "--data_workers", "1", "--log_every", "1"]
    state = t_main.main(["pretrain", "--data_path", data_path,
                         "--output_dir", str(tmp_path / "out_pre")]
                        + common, tokenizer=tok, device="cpu")
    assert state.step == 2
    adapter = load_params(str(tmp_path / "out_pre" / "proj_image_adapter"))
    assert torch.equal(adapter["proj"]["w"], state.params["proj_image"]
                       ["proj"]["w"])
    start = t_init(0, T_CFG, device="cpu")
    assert not torch.equal(adapter["proj"]["w"],
                           start["proj_image"]["proj"]["w"])
    assert torch.equal(state.params["proj_object"]["perceiver"]["latents"],
                       start["proj_object"]["perceiver"]["latents"])

    model_dir = tmp_path / "model"
    save_hf_dir(vqa_llm_state_dict(start), T_CFG, str(model_dir))
    monkeypatch.setattr(hf_config, "vqa_llm_config_for",
                        lambda path: T_CFG)
    sft_dir = tmp_path / "sft"
    _fixture(sft_dir)
    state = t_main.main(["finetune", "--model_path", str(model_dir),
                         "--data_path", str(sft_dir),
                         "--output_dir", str(tmp_path / "out_ft"),
                         "--image_folder", str(sft_dir / "images"),
                         "--per_device_batch_size", "1",
                         "--seq_bucket", "64", "--param_dtype", "f32",
                         "--data_workers", "1"], tokenizer=tok,
                        device="cpu")
    assert state.step == 3
    saved = load_params(str(tmp_path / "out_ft" / "params"))
    assert torch.equal(saved["vision"]["patch_embed"]["w"],
                       start["vision"]["patch_embed"]["w"])
    assert not torch.equal(saved["llama"]["lm_head"],
                           start["llama"]["lm_head"])

    monkeypatch.undo()
    full = tmp_path / "full"
    os.makedirs(full)
    with open(full / "config.json", "w") as f:
        json.dump(config_json(tcfg.vqa_llm_7b()), f)
    with pytest.raises(MemoryError, match="GB/chip of static state"):
        t_main.main(["finetune", "--model_path", str(full), "--data_path",
                     str(tmp_path / "none"), "--image_folder", "none",
                     "--hbm_gb", "79.1"], tokenizer=tok, device="meta")
    assert "finetune (one device)" in capsys.readouterr().out


def _memory_fields(plan):
    return dataclasses.astuple(plan)


def test_memory_plan_equals_jax_on_one_device():
    """plan_train_memory at the 7B widths (shapes only: JAX's eval_shape,
    the port's meta device), bf16 with f32 masters and the frozen-tower
    mask, and f32 without masters, equals JAX's on a 1x1x1 mesh field by
    field; check_memory passes and refuses as JAX's does."""
    mesh1 = types.SimpleNamespace(shape={"data": 1, "fsdp": 1, "model": 1})
    for jd, td, master in ((jnp.bfloat16, torch.bfloat16, True),
                           (jnp.float32, torch.float32, False)):
        abstract = jax.eval_shape(lambda: init_vqa_llm_params(
            jax.random.PRNGKey(0), j_vqa_7b(), dtype=jd))
        meta = t_init(0, tcfg.vqa_llm_7b(), device="meta", dtype=td)
        j_mask = jsft.make_frozen_vision_mask(abstract)
        t_mask = tsft.make_frozen_vision_mask(meta)
        want = j_plan(abstract, mesh1, trainable_mask=j_mask,
                      master_f32=master)
        got = tmem.plan_train_memory(meta, trainable_mask=t_mask,
                                     master_f32=master)
        assert _memory_fields(got) == _memory_fields(want)
        assert got.summary() == want.summary()
        proj = tmem.plan_train_memory(
            meta, trainable_mask=t_main.projector_only_mask(meta, "linear"),
            master_f32=master)
        assert _memory_fields(proj) == _memory_fields(j_plan(
            abstract, mesh1, trainable_mask=j_main.projector_only_mask(
                abstract, "linear"), master_f32=master))
        for hbm in (16.0, 80.0, 400.0):
            raised = []
            for check, plan in ((j_check, want), (tmem.check_memory, got)):
                try:
                    check(plan, hbm_gb=hbm, what="7B full SFT")
                    raised.append(False)
                except MemoryError:
                    raised.append(True)
            assert raised[0] == raised[1], hbm
    assert tmem.parse_mesh_arg("1x1x1", 1) == (1, 1, 1)
    assert tmem.parse_mesh_arg(None, 8) == (1, 8, 1)
    with pytest.raises(ValueError, match="needs 4 devices"):
        tmem.parse_mesh_arg("2x2x1", 1)
    tmem.check_memory(got, hbm_gb=None)      # the CPU: no budget


def test_vsm_trainer_refuses_plan_over_memory(tmp_path):
    """run_vsm_training checks its one-device plan before it builds the
    optimizer: over the given memory it raises MemoryError and writes no
    checkpoint."""
    from tests.test_torch_train_loop import _loop_args as vsm_args
    from vstar_tpu_torch.models.vsm import init_vsm_params
    from vstar_tpu_torch.train.train_vsm_main import run_vsm_training
    cfg = tcfg.vsm_tiny()
    args = vsm_args(tmp_path, "mem", 1, None)
    args.hbm_gb = 1e-4
    with pytest.raises(MemoryError, match="VSM train"):
        run_vsm_training(args, cfg, init_vsm_params(0, cfg, device="cpu"),
                         WordTokenizer(), 3)
    assert not (tmp_path / "runs" / "mem" / "ckpt_model").exists()


def test_refer_convert_equals_jax(tmp_path):
    """refer_convert on a small REFER distribution (train and val refs, a
    ref whose annotation is missing) writes JAX's JSON files byte for
    byte."""
    for side in ("jax", "port"):
        base = tmp_path / side / "refcoco"
        os.makedirs(base)
        refs = [{"ann_id": 1, "image_id": 10, "split": "train",
                 "sentences": [{"sent": "the cup"}, {"sent": "red cup"}]},
                {"ann_id": 2, "image_id": 11, "split": "val",
                 "sentences": [{"sent": "a dog"}]},
                {"ann_id": 9, "image_id": 10, "split": "train",
                 "sentences": [{"sent": "gone"}]}]
        with open(base / "refs(unc).p", "wb") as f:
            pickle.dump(refs, f)
        inst = {"annotations": [
            {"id": 1, "bbox": [1, 2, 3, 4], "segmentation": [[0, 0, 1, 1]]},
            {"id": 2, "bbox": [5, 6, 7, 8], "segmentation": [[2, 2, 3, 3]]}],
            "images": [{"id": 10, "file_name": "a.jpg"},
                       {"id": 11, "file_name": "b.jpg"}]}
        with open(base / "instances.json", "w") as f:
            json.dump(inst, f)
    want = jrefer.convert(str(tmp_path / "jax"), "refcoco", "unc")
    got = trefer.convert(str(tmp_path / "port"), "refcoco", "unc")
    assert got == want == (1, 1)
    for name in ("refcoco.json", "refcoco_val.json"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()
