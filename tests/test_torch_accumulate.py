"""Gradient accumulation (vstar_tpu_torch/train/accumulate.py) on the CPU:
each gradient added into its f32 buffer as the backward produces it.

  * With 2 and 4 micro-batches the buffers, the loss and the metrics
    equal, bit for bit, those of the earlier implementation (one
    torch.autograd.grad a micro-batch, then the adds), kept below as
    `previous_accumulated_grads`: on the tiny VSM loss with LoRA (f32),
    the tiny VQA SFT loss (f32, and bf16 storage with bf16 compute), and
    a stacked toy decoder that reads each layer twice under remat.
  * The toy's gradients equal vstar_tpu's accumulated_grads within 1e-6
    of each leaf's largest |value| (f32).
  * A stacked leaf's layer gradients reach the buffer layer by layer:
    the last layer's slice is filled before the backward reaches layer 0.
  * After the call, and after a backward that raises, no live leaf holds
    a gradient, a hook or its sink (a leaf and its sink refer to each
    other: the cycle would keep the step's buffers alive).
  * core/memory.step_memory: the f32 buffers and the largest gradient
    held at once, for the tiny configs, from the trees' shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_sft import T_CFG as T_VQA_CFG
from tests.test_torch_sft import _sft_batch
from tests.test_torch_train import T_CFG as T_VSM_CFG
from tests.test_train import _make_batch
from vstar_tpu.train.accumulate import accumulated_grads as j_accum
from vstar_tpu_torch.core import memory as tmem
from vstar_tpu_torch.core import mesh as tmesh
from vstar_tpu_torch.core.mesh import layer_source, unshard
from vstar_tpu_torch.core.params import (leaves_with_path, map_with_path,
                                         replace_leaves)
from vstar_tpu_torch.data.vsm_collate import batch_to_torch
from vstar_tpu_torch.models.vqa_llm import init_vqa_llm_params
from vstar_tpu_torch.models.vsm import init_vsm_params
from vstar_tpu_torch.train import accumulate
from vstar_tpu_torch.train import lora as tl
from vstar_tpu_torch.train.accumulate import accumulated_grads
from vstar_tpu_torch.train.sft import sft_loss
from vstar_tpu_torch.train.train_vqa_main import frozen_vision_mask
from vstar_tpu_torch.train.vsm_train import vsm_loss

torch.set_num_threads(1)


def previous_accumulated_grads(loss_fn, params, batch, num_micro,
                               has_aux=False, trainable=None):
    """accumulated_grads as it was before the gradients were added during
    the backward (plain leaves only)."""
    mask = None if trainable is None else dict(leaves_with_path(trainable))
    leaves = dict(leaves_with_path(params))
    paths = [p for p, x in leaves.items()
             if (x.is_floating_point() if mask is None else mask[p])]
    n = max(num_micro, 1)
    rows = next(iter(batch.values())).shape[0]
    m = rows // n
    loss_acc = aux_acc = grads = None
    for i in range(n):
        micro = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
        live = {p: leaves[p].detach().requires_grad_() for p in paths}
        out = loss_fn(replace_leaves(params, live), micro)
        loss, aux = out if has_aux else (out, None)
        gs = torch.autograd.grad(loss, [live[p] for p in paths],
                                 allow_unused=True)
        gs = [torch.zeros_like(live[p]) if g is None else g
              for p, g in zip(paths, gs)]
        if grads is None:
            grads = {p: torch.zeros(live[p].shape, dtype=torch.float32)
                     for p in paths}
            loss_acc = torch.zeros((), dtype=torch.float32)
            if has_aux:
                aux_acc = {k: torch.zeros((), dtype=torch.float32)
                           for k in aux}
        for p, g in zip(paths, gs):
            grads[p] += g / n
        loss_acc = loss_acc + loss.detach() / n
        if has_aux:
            aux_acc = {k: aux_acc[k] + aux[k].detach() / n for k in aux}
    return loss_acc, aux_acc, grads


# --- the toy: a stacked decoder, each layer read twice under remat --------

L, D = 4, 8


def _toy_params():
    rng = np.random.RandomState(0)
    return {"layers": {"w": (rng.randn(L, D, D) * 0.4).astype(np.float32),
                       "b": (rng.randn(L, D) * 0.1).astype(np.float32)},
            "head": (rng.randn(D) * 0.5).astype(np.float32)}


def _toy_batch(rows=8):
    rng = np.random.RandomState(1)
    return {"x": rng.randn(rows, D).astype(np.float32),
            "y": rng.randn(rows).astype(np.float32)}


def _toy_loss(p, b, on_layer0=None):
    p = unshard(p, keep="layers")
    fetch = layer_source(p["layers"])

    def one(x, i):
        lp = fetch(i)
        h = torch.tanh(x @ lp["w"] + lp["b"])
        return h + 0.5 * torch.tanh(h @ fetch(i)["w"])

    x = b["x"]
    for i in range(L):
        x = torch.utils.checkpoint.checkpoint(
            lambda x, i=i: one(x, i), x, use_reentrant=False)
        if i == 0 and on_layer0 is not None:
            x.register_hook(on_layer0)
    out = x @ p["head"]
    return torch.mean((out - b["y"]) ** 2), {"m": torch.mean(out)}


def _j_toy_loss(p, b):
    x = b["x"]
    for i in range(L):
        w, bias = p["layers"]["w"][i], p["layers"]["b"][i]
        h = jnp.tanh(x @ w + bias)
        x = h + 0.5 * jnp.tanh(h @ w)
    out = x @ p["head"]
    return jnp.mean((out - b["y"]) ** 2), {"m": jnp.mean(out)}


def _torch_tree(tree, dtype=None):
    def conv(_, x):
        x = torch.from_numpy(np.array(x)) if not isinstance(x, torch.Tensor) \
            else x.detach().clone()
        return x.to(dtype) if dtype is not None and x.is_floating_point() \
            else x
    return map_with_path(conv, tree)


def _vsm_case():
    params = init_vsm_params(5, T_VSM_CFG, device="cpu")
    params["llama"] = tl.add_lora(params["llama"], 6, r=2, alpha=4)
    gen = torch.Generator().manual_seed(7)
    lora = params["llama"]["layers"]["attn"]["lora"]
    for name in ("wq_b", "wv_b"):
        lora[name] = torch.randn(lora[name].shape, generator=gen) * 0.1
    rows = {k: np.asarray(v) for k, v in _make_batch(B=4).items()}
    rows["tgt_valid"] = np.asarray([[1, 1, 0, 0], [1, 0, 0, 0],
                                    [0, 0, 0, 0], [1, 1, 1, 0]], bool)
    rows["masks_valid"] = np.asarray([1, 0, 1, 1], bool)
    batch = batch_to_torch(rows, "cpu")
    return (lambda p, b: vsm_loss(p, T_VSM_CFG, b,
                                  compute_dtype=torch.float32),
            params, batch, True, tl.vsm_trainable_mask(params))


def _sft_case(tmp_path, dtype):
    params = init_vqa_llm_params(3, T_VQA_CFG, device="cpu")
    params = _torch_tree(params, dtype)
    batch = batch_to_torch(_sft_batch(tmp_path), "cpu")
    return (lambda p, b: sft_loss(p, T_VQA_CFG, b, compute_dtype=dtype),
            params, batch, False, frozen_vision_mask(params))


def _case(name, tmp_path):
    if name == "vsm_f32":
        return _vsm_case()
    if name == "sft_f32":
        return _sft_case(tmp_path, torch.float32)
    if name == "sft_bf16":
        return _sft_case(tmp_path, torch.bfloat16)
    return (_toy_loss, _torch_tree(_toy_params()),
            _torch_tree(_toy_batch()), True, None)


@pytest.mark.parametrize("num_micro", [2, 4])
@pytest.mark.parametrize("name", ["vsm_f32", "sft_f32", "sft_bf16",
                                  "toy_twice"])
def test_bits_equal_the_previous_implementation(name, num_micro, tmp_path):
    loss_fn, params, batch, has_aux, mask = _case(name, tmp_path)
    want = previous_accumulated_grads(loss_fn, params, batch, num_micro,
                                      has_aux=has_aux, trainable=mask)
    got = accumulated_grads(loss_fn, params, batch, num_micro,
                            has_aux=has_aux, trainable=mask)
    assert torch.equal(got[0], want[0])
    if has_aux:
        assert set(got[1]) == set(want[1])
        for k in want[1]:
            assert torch.equal(got[1][k], want[1][k]), k
    assert set(got[2]) == set(want[2]) and got[2]
    for k, g in want[2].items():
        assert got[2][k].dtype == torch.float32
        assert torch.equal(got[2][k], g), k


@pytest.mark.parametrize("num_micro", [2, 4])
def test_toy_equals_jax(num_micro):
    """The toy over 2 and 4 micro-batches against vstar_tpu's
    accumulated_grads: loss and metric within 1e-6 relative, every
    gradient within 1e-6 of its leaf's largest |value|."""
    host, batch = _toy_params(), _toy_batch()
    jl_, ja, jg = j_accum(_j_toy_loss, jax.tree_util.tree_map(
        jnp.asarray, host), {k: jnp.asarray(v) for k, v in batch.items()},
        num_micro, has_aux=True)
    loss, aux, grads = accumulated_grads(_toy_loss, _torch_tree(host),
                                         _torch_tree(batch), num_micro,
                                         has_aux=True)
    np.testing.assert_allclose(float(loss), float(jl_), rtol=1e-6)
    np.testing.assert_allclose(float(aux["m"]), float(ja["m"]), rtol=1e-6)
    want = dict(leaves_with_path(jax.device_get(jg)))
    assert set(grads) == set(want)
    for k, g in grads.items():
        w = np.asarray(want[k])
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-6 * float(np.abs(w).max()),
                                   err_msg=k)


def test_layers_reach_the_buffer_one_at_a_time():
    """When layer 0's output gradient arrives (before layer 0's own
    backward), the last layer's slice of the buffer already holds its
    share, and the stacked leaf holds no gradient."""
    seen = []

    def loss_fn(p, b):
        stack = p["layers"]["w"]

        def on_layer0(g):
            seen.append((float(stack.layer_grad_sink.buf[L - 1].abs().sum()),
                         float(stack.layer_grad_sink.buf[0].abs().sum()),
                         stack.grad))
        return _toy_loss(p, b, on_layer0)

    accumulated_grads(loss_fn, _torch_tree(_toy_params()),
                      _torch_tree(_toy_batch()), 2, has_aux=True)
    assert len(seen) == 2
    first_last, first_zero, grad = seen[0]
    assert first_last > 0 and first_zero == 0 and grad is None
    # the second micro-batch adds onto the first's full buffer
    assert seen[1][1] > 0


def test_sharded_stacks_reach_their_buffers_by_layer(tmp_path,
                                                    monkeypatch):
    """The toy sharded over a one-rank 1x1x1 mesh (gloo), its stack read
    by core/mesh.layer_source: no stacked leaf receives a gradient of its
    own (the sink reads the live local shard, never through DTensor's
    to_local), and the buffers hold the unsharded previous
    implementation's bits."""
    import torch.distributed as dist
    drained = []
    drain = accumulate._drain

    def record(leaf, buf, n):
        if leaf.grad is not None:
            drained.append(tuple(leaf.shape))
        drain(leaf, buf, n)
    monkeypatch.setattr(accumulate, "_drain", record)
    host, batch = _torch_tree(_toy_params()), _torch_tree(_toy_batch())
    want = previous_accumulated_grads(_toy_loss, host, batch, 2,
                                      has_aux=True)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        sharded = tmesh.shard_params(host, tmesh.make_mesh((1, 1, 1), "cpu"))
        got = accumulated_grads(_toy_loss, sharded, batch, 2, has_aux=True)
    finally:
        dist.destroy_process_group()
    assert drained and all(s[0] != L for s in drained), drained
    assert torch.equal(got[0], want[0])
    for k, g in want[2].items():
        assert torch.equal(got[2][k], g), k


class _Boom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError("boom")


@pytest.mark.parametrize("fail", [False, True], ids=["clean", "raises"])
def test_no_gradient_or_hook_outlives_the_call(fail, monkeypatch):
    made = []
    live = accumulate._live

    def record(x):
        out = live(x)
        made.append(out)
        return out
    monkeypatch.setattr(accumulate, "_live", record)

    def loss_fn(p, b):
        loss, aux = _toy_loss(p, b)
        return (_Boom.apply(loss) if fail else loss), aux

    if fail:
        with pytest.raises(RuntimeError, match="boom"):
            accumulated_grads(loss_fn, _torch_tree(_toy_params()),
                              _torch_tree(_toy_batch()), 2, has_aux=True)
    else:
        accumulated_grads(loss_fn, _torch_tree(_toy_params()),
                          _torch_tree(_toy_batch()), 2, has_aux=True)
    assert made
    for x in made:
        assert x.grad is None
        assert not getattr(x, "_post_accumulate_grad_hooks", None)
        assert not hasattr(x, "layer_grad_sink")   # no leaf <-> sink cycle


def _want_step(params, mask, num_micro):
    """step_memory by hand: nothing with one micro-batch; else 4 bytes a
    trainable element and the largest of the trainable leaves'
    gradients, one layer's for a leaf of a layer stack."""
    if num_micro == 1:
        return 0, 0
    trainable = dict(leaves_with_path(mask))
    n_train, largest = 0, 0
    for path, x in leaves_with_path(params):
        if not trainable[path]:
            continue
        n_train += x.numel()
        parts = path.split(".")
        stacked = "layers" in parts[:-1] and not any(
            s.isdigit() for s in parts[parts.index("layers") + 1:])
        size = x[0].numel() if stacked else x.numel()
        largest = max(largest, size * x.element_size())
    return 4 * n_train, largest


@pytest.mark.parametrize("num_micro", [1, 2])
@pytest.mark.parametrize("which", ["vqa", "vsm"])
def test_step_memory_of_the_tiny_configs(which, num_micro):
    if which == "vqa":
        params = init_vqa_llm_params(3, T_VQA_CFG, device="meta",
                                     dtype=torch.bfloat16)
        mask = frozen_vision_mask(params)
    else:
        params = init_vsm_params(5, T_VSM_CFG, device="meta")
        params["llama"] = tl.add_lora(params["llama"], 6, r=2, alpha=4)
        mask = tl.vsm_trainable_mask(params)
    got = tmem.step_memory(params, None, trainable_mask=mask,
                           num_micro=num_micro)
    assert (got.accum_bytes, got.largest_grad_bytes) == \
        _want_step(params, mask, num_micro)
    assert (got.largest_grad_bytes > 0) == (num_micro > 1)
    # on a (1, 2, 1) mesh the buffers halve where fsdp shards the leaf
    sharded = tmem.step_memory(params, (1, 2, 1), trainable_mask=mask,
                               num_micro=num_micro)
    assert sharded.accum_bytes <= got.accum_bytes
    assert "f32 accumulation" in got.summary()
