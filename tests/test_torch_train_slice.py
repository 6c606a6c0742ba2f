"""The ported VSM training slice against the JAX trainer at tiny widths
(f32 compute on the CPU, the same weights through core.convert, the same
batches and dataset files on both sides):

two vsm_train_steps with gradient accumulation over 2 micro-batches, on
bf16 parameter storage, warmup 0 without f32 masters and warmup 1 (a
first step at learning rate 0) with them: updated parameters within 1e-5
of JAX's, grad_norm and the loss within 1e-5 relative, frozen leaves
bit-identical. The trainer's loop is in tests/test_torch_train_loop.py.

The frozen towers stay f32 in the step test: the port runs a tower in its
weights' dtype, the JAX package in f32 (ROADMAP Queue 3), and the test is
about the update, not the towers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train import CFG, T_CFG, tiny_vsm_host, torch_batch
from tests.test_train import _make_batch
from vstar_tpu.train.lora import vsm_trainable_mask as j_mask
from vstar_tpu.train.vsm_train import VSMTrainState as JState
from vstar_tpu.train.vsm_train import make_vsm_optimizer as j_make_opt
from vstar_tpu.train.vsm_train import vsm_train_step as j_step
from vstar_tpu_torch.core.convert import from_numpy_tree
from vstar_tpu_torch.core.params import leaves_with_path
from vstar_tpu_torch.train.lora import vsm_trainable_mask
from vstar_tpu_torch.train.vsm_train import (init_train_state,
                                             make_vsm_optimizer,
                                             vsm_train_step)

torch.set_num_threads(1)

STEP_TOL = 1e-5


def _bf16_storage(host):
    """Every leaf in bf16 except the frozen towers'."""
    out = {k: v for k, v in host.items()}
    for k, v in host.items():
        if k not in ("vision", "owl_tower"):
            out[k] = jax.device_get(jax.tree_util.tree_map(
                lambda x: jnp.asarray(x, jnp.bfloat16), v))
    return out


def _four_row_batch():
    """tests/test_train.py's batch at 4 rows, one row without valid boxes
    and one without a valid mask, so every loss term is live."""
    batch = dict(_make_batch(B=4))
    batch["tgt_valid"] = jnp.asarray([[1, 1, 0, 0], [1, 0, 0, 0],
                                      [1, 1, 1, 0], [1, 0, 0, 0]], bool)
    batch["bboxes_valid"] = jnp.asarray([True, True, False, True])
    batch["masks_valid"] = jnp.asarray([True, False, True, True])
    return batch


def _assert_update_close(got, want, msg):
    """Within 1e-5 of JAX's. A bf16 leaf is stored as round(p + u): where
    the two frameworks' f32 p + u (equal to ~1e-9) straddle a bf16
    rounding boundary, the stored values differ by one bf16 step, which
    may exceed 1e-5; that is allowed on at most 0.1 % of a leaf."""
    g = got.float().numpy()
    diff = np.abs(g - want)
    off = diff > STEP_TOL
    if got.dtype == torch.bfloat16 and off.any():
        one_step = _bf16_ulp(np.maximum(np.abs(g), np.abs(want))) + STEP_TOL
        assert (diff[off] <= one_step[off]).all(), msg
        assert off.mean() <= 1e-3, msg
        return
    np.testing.assert_allclose(g, want, atol=STEP_TOL, rtol=0, err_msg=msg)


def _bf16_ulp(x):
    """The spacing of bf16 values at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(x, 1e-30)))
    return np.exp2(e - 7).astype(np.float32)


def _flat(tree):
    return {k: np.asarray(v, np.float32)
            for k, v in leaves_with_path(jax.device_get(tree))}


@pytest.mark.parametrize("warmup,master", [(0, False), (1, True)])
def test_vsm_train_steps_match_jax(warmup, master):
    host = _bf16_storage(tiny_vsm_host())
    batch = _four_row_batch()
    mask = j_mask(host)
    j_opt = j_make_opt(lr=1e-3, warmup_steps=warmup, total_steps=10,
                       trainable_mask=mask, master_f32=master)
    jp = jax.tree_util.tree_map(jnp.asarray, host)
    j_state = JState(jp, j_opt.init(jp), jnp.zeros((), jnp.int32))
    step = jax.jit(lambda st, b: j_step(st, b, CFG, j_opt, mask,
                                        compute_dtype=jnp.float32,
                                        grad_accum=2))

    tp = from_numpy_tree(host, "cpu")
    t_mask = vsm_trainable_mask(tp)
    t_opt = make_vsm_optimizer(lr=1e-3, warmup_steps=warmup, total_steps=10,
                               trainable_mask=t_mask, master_f32=master)
    t_state = init_train_state(tp, t_opt)
    before = dict(leaves_with_path(tp))
    frozen = {k: v for k, v in before.items()
              if not dict(leaves_with_path(t_mask))[k]}
    tb = torch_batch(batch)
    for i in range(2):
        j_state, jm = step(j_state, batch)
        t_state, tm = vsm_train_step(t_state, tb, T_CFG, t_opt, t_mask,
                                     compute_dtype=torch.float32,
                                     grad_accum=2)
        for k in ("loss", "ce_loss", "detection_loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=STEP_TOL, err_msg=f"{i} {k}")
        want = _flat(j_state.params)
        got = dict(leaves_with_path(t_state.params))
        for k, v in got.items():
            assert v.dtype == before[k].dtype
            _assert_update_close(v, want[k], f"step {i} {k}")
    assert t_state.step == 2
    for k, v in frozen.items():
        assert torch.equal(dict(leaves_with_path(t_state.params))[k], v), k
    lora_b = t_state.params["llama"]["layers"]["attn"]["lora"]["wq_b"]
    assert not torch.equal(lora_b, tp["llama"]["layers"]["attn"]["lora"]
                           ["wq_b"])
