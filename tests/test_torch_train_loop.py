"""The ported VSM trainer's loop, run_vsm_training, against the JAX
trainer's at tiny widths on the CPU: the same synthetic vqa + cocostuff
dataset files, the same initial weights (through core.convert), f32
compute on both sides. Step counts, the logged metrics and the trained
parameters within 1e-4 of JAX's run; then the port's auto-resume from its
checkpoint, and its refusal of a mesh larger than the world of ranks (a
process without torchrun is a world of one; the sharded loop is in
tests/test_torch_mesh.py)."""

import functools
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vstar_tpu.train.train_vsm_main as j_main
import vstar_tpu_torch.train.train_vsm_main as t_main
from tests.test_data import WordTokenizer
from tests.test_torch_train import CFG, T_CFG, make_dataset_dir
from vstar_tpu.models.vsm import init_vsm_params
from vstar_tpu.train.vsm_train import vsm_train_step as j_step
from vstar_tpu_torch.core.convert import from_numpy_tree
from vstar_tpu_torch.core.params import leaves_with_path

torch.set_num_threads(1)

LOOP_TOL = 1e-4


def _flat(tree):
    return {k: np.asarray(v, np.float32)
            for k, v in leaves_with_path(jax.device_get(tree))}


def _loop_args(tmp_path, exp_name, epochs, mesh):
    return types.SimpleNamespace(
        dataset_dir=str(tmp_path), log_base_dir=str(tmp_path / "runs"),
        exp_name=exp_name, epochs=epochs, steps_per_epoch=2,
        batch_size=1, grad_accumulation_steps=1, lr=1e-3,
        ce_loss_weight=1.0, dice_loss_weight=0.5, bce_loss_weight=2.0,
        det_loss_weight=0.1, warmup_steps=1, seq_bucket=64,
        prefetch_depth=2, mask_res=12, mesh=mesh, param_dtype="f32",
        hbm_gb=16.0, auto_resume=True, no_eval=True,
        dataset="general_segdet||vqa", sample_rates="1,1", save_steps=0)


def test_run_vsm_training_matches_jax_and_resumes(tmp_path, monkeypatch):
    """Both trainers in f32 compute (their steps default to bf16, which
    the two frameworks round at different places)."""
    make_dataset_dir(tmp_path)
    monkeypatch.setattr(j_main, "vsm_train_step",
                        functools.partial(j_step, compute_dtype=jnp.float32))
    monkeypatch.setattr(t_main, "vsm_train_step",
                        functools.partial(t_main.vsm_train_step,
                                          compute_dtype=torch.float32))
    tok = WordTokenizer()
    loc = tok._word_id("[LOC]")
    host = jax.device_get(init_vsm_params(jax.random.PRNGKey(0), CFG))
    j_state = j_main.run_vsm_training(
        _loop_args(tmp_path, "jax", 1, "4x2x1"), CFG,
        jax.tree_util.tree_map(jnp.asarray, host), tok, loc)
    t_state = t_main.run_vsm_training(
        _loop_args(tmp_path, "port", 1, None), T_CFG,
        from_numpy_tree(host, "cpu"), tok, loc)
    assert int(j_state.step) == t_state.step == 2

    def log(name):
        lines = (tmp_path / "runs" / name / "metrics.jsonl").read_text()
        return [json.loads(x) for x in lines.splitlines()]

    want, got = log("jax"), log("port")
    assert [(r["epoch"], r["step"]) for r in got] == \
        [(r["epoch"], r["step"]) for r in want]
    for w, g in zip(want, got):
        for k in ("loss", "ce_loss", "mask_bce_loss", "mask_dice_loss",
                  "detection_loss"):
            np.testing.assert_allclose(g[k], w[k], rtol=LOOP_TOL, err_msg=k)
    want_p = _flat(j_state.params)
    for k, v in leaves_with_path(t_state.params):
        np.testing.assert_allclose(v.numpy(), want_p[k], atol=LOOP_TOL,
                                   rtol=0, err_msg=k)

    # a second invocation resumes from the checkpoint and trains epoch 1
    resumed = t_main.run_vsm_training(
        _loop_args(tmp_path, "port", 2, "1x1x1"), T_CFG,
        from_numpy_tree(jax.device_get(init_vsm_params(
            jax.random.PRNGKey(7), CFG)), "cpu"), tok, loc)
    assert resumed.step == 4
    meta = json.loads((tmp_path / "runs" / "port" / "ckpt_model"
                       / "meta.json").read_text())
    assert meta["epoch"] == 1
    with pytest.raises(ValueError, match="needs 2 devices .* the world has 1"):
        t_main.run_vsm_training(_loop_args(tmp_path, "x", 1, "1x2x1"),
                                T_CFG, from_numpy_tree(host, "cpu"), tok,
                                loc)
