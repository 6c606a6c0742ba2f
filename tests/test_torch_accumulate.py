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
    held at once, for the tiny configs, from the trees' shapes; and on an
    fsdp axis above 1 the next layer in flight beside the gathered one.
  * On a one-rank 1x1x1 mesh the layer fetch and the leaf gather copy
    nothing (the shards' own storage), and the gradients are the
    unsharded ones bit for bit.
  * The optimizer's update applied leaf by leaf (train/sft.apply_step,
    both trainers' optimizers, with and without f32 masters and the
    mask, gradients in f32 or in the leaves' dtype) equals, bit for bit,
    the earlier whole-tree update, kept below as `previous_optimizer` /
    `previous_apply_step`; its temporaries alive at once stay within a
    few copies of one leaf (counted by a TorchDispatchMode), and each
    leaf's gradient is gone before the next leaf's is taken.
"""

import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from tests.test_torch_sft import T_CFG as T_VQA_CFG
from tests.test_torch_sft import _sft_batch
from tests.test_torch_train import T_CFG as T_VSM_CFG
from tests.test_train import _make_batch
from vstar_tpu.train.accumulate import accumulated_grads as j_accum
from vstar_tpu_torch.core import memory as tmem
from vstar_tpu_torch.core import mesh as tmesh
from vstar_tpu_torch.core import params as tparams
from vstar_tpu_torch.core.mesh import layer_source, unshard
from vstar_tpu_torch.core.params import (leaves_with_path, map_with_path,
                                         replace_leaves)
from vstar_tpu_torch.data.vsm_collate import batch_to_torch
from vstar_tpu_torch.models.vqa_llm import init_vqa_llm_params
from vstar_tpu_torch.models.vsm import init_vsm_params
from vstar_tpu_torch.train import accumulate
from vstar_tpu_torch.train import lora as tl
from vstar_tpu_torch.train import optim
from vstar_tpu_torch.train import sft as tsft
from vstar_tpu_torch.train import vsm_train as tvsm
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


@pytest.mark.parametrize("fsdp", [1, 2])
def test_step_memory_counts_the_prefetched_layer(fsdp):
    """step_memory's next layer in flight: on an fsdp axis above 1 the
    bytes of one layer of every stack leaf whose layer axis fsdp shards
    (the tiny VQA's 2 layers split over 2 ranks: all of them), none on
    fsdp 1."""
    params = init_vqa_llm_params(3, T_VQA_CFG, device="meta",
                                 dtype=torch.bfloat16)
    got = tmem.step_memory(params, (1, fsdp, 1),
                           trainable_mask=frozen_vision_mask(params),
                           num_micro=2)
    assert got.layer_bytes > 0
    assert got.prefetch_bytes == (got.layer_bytes if fsdp > 1 else 0)
    assert "in flight" in got.summary()


def test_one_rank_mesh_gathers_copy_nothing(tmp_path):
    """The toy on a one-rank 1x1x1 mesh (gloo): every layer
    core/mesh.layer_source hands out, with and without the prefetch, and
    the leaf core/mesh.full gathers lie at their shard's data pointer (no
    copy, as XLA emits none for an axis of one device), and the
    accumulated gradients over 1 and 2 micro-batches equal the unsharded
    previous implementation's bit for bit, the shards unchanged."""
    import torch.distributed as dist
    host, batch = _torch_tree(_toy_params()), _torch_tree(_toy_batch())
    want = {n: previous_accumulated_grads(_toy_loss, host, batch, n,
                                          has_aux=True) for n in (1, 2)}
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        sharded = tmesh.shard_params(host, tmesh.make_mesh((1, 1, 1), "cpu"))
        local = {p: x.to_local() for p, x in leaves_with_path(sharded)}
        for prefetch in (False, True):
            fetch = layer_source(sharded["layers"], prefetch=prefetch)
            for i in range(L):
                for k, x in leaves_with_path(fetch(i)):
                    assert x.data_ptr() == \
                        local["layers." + k][i].data_ptr(), (k, i)
        whole = tmesh.full(sharded["head"])
        assert whole.data_ptr() == local["head"].data_ptr()
        assert whole is not local["head"]
        got = {n: accumulated_grads(_toy_loss, sharded, batch, n,
                                    has_aux=True) for n in (1, 2)}
        kept = {p: x.to_local() for p, x in leaves_with_path(sharded)}
    finally:
        dist.destroy_process_group()
    for n in (1, 2):
        assert torch.equal(got[n][0], want[n][0])
        for k, g in want[n][2].items():
            assert torch.equal(got[n][2][k], g), (n, k)
    for p, x in leaves_with_path(host):
        assert torch.equal(kept[p], x), p


# --- the optimizer's update over the whole tree, as it was before it was
# applied leaf by leaf: (init, update) pairs with optax's update(updates,
# state, params) -> (updates, state) over the whole tree ---------------

def _prev_clip(max_norm):
    def update(updates, state, params=None):
        g_norm = optim.global_norm(updates, params)
        if not bool(g_norm < max_norm):
            for t in updates.values():
                t.div_(g_norm.to(t.dtype)).mul_(max_norm)
        return updates, state
    return (lambda params: {}), update


def _prev_ema(m, x, decay):
    a = (1 - decay) * x
    if torch.promote_types(a.dtype, m.dtype) != m.dtype:
        return a + decay * m
    return m.mul_(decay).add_(a)


def _prev_adam(b1, b2, eps=1e-8):
    def init(params):
        return {"count": 0,
                "mu": {p: torch.zeros_like(x) for p, x in params.items()},
                "nu": {p: torch.zeros_like(x) for p, x in params.items()}}

    def update(updates, state, params=None):
        count = state["count"] + 1
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** count
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** count
        mu, nu, out = {}, {}, {}
        for p, g in updates.items():
            m = mu[p] = _prev_ema(state["mu"][p], g, b1)
            v = nu[p] = _prev_ema(state["nu"][p], g * g, b2)
            m_hat = m / bc1.to(m.dtype).to(m.device)
            denom = (v / bc2.to(v.dtype).to(v.device)).sqrt_().add_(eps)
            if torch.promote_types(m_hat.dtype, denom.dtype) == g.dtype:
                out[p] = torch.div(m_hat, denom, out=g)
            else:
                out[p] = m_hat / denom
            del m_hat, denom
        return out, {"count": count, "mu": mu, "nu": nu}
    return init, update


def _prev_schedule(step_size_fn):
    def update(updates, state, params=None):
        step = float(step_size_fn(state["count"]))
        return {p: g.mul_(step) for p, g in updates.items()}, \
            {"count": state["count"] + 1}
    return (lambda params: {"count": 0}), update


def _prev_chain(*transforms):
    def init(params):
        return [t[0](params) for t in transforms]

    def update(updates, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t[1](updates, s, params)
            new_state.append(s)
        return updates, new_state
    return init, update


def _prev_master(inner):
    def needs(p):
        return p.is_floating_point() and p.element_size() < 4

    def init(params):
        master = {p: x.float() if needs(x) else x
                  for p, x in params.items()}
        return {"master": master, "inner": inner[0](master)}

    def update(grads, state, params=None):
        g32 = {p: g.float() if g.is_floating_point() else g
               for p, g in grads.items()}
        updates, new_inner = inner[1](g32, state["inner"], state["master"])
        new_master = dict(state["master"])
        for p, u in updates.items():
            m = state["master"][p]
            if needs(params[p]) and \
                    torch.promote_types(m.dtype, u.dtype) == m.dtype:
                new_master[p] = m.add_(u)
            else:
                new_master.update(optim.apply_updates({p: m}, {p: u}))
        out = {p: (new_master[p].to(params[p].dtype) - params[p])
               if needs(params[p])
               else (new_master[p] - params[p]).to(params[p].dtype)
               for p in updates}
        return out, {"master": new_master, "inner": new_inner}
    return init, update


def _prev_masked(inner, mask):
    def init(params):
        return inner[0]({p: x for p, x in params.items() if mask[p]})

    def update(updates, state, params=None):
        sub = {p: u for p, u in updates.items() if mask[p]}
        sub_params = None if params is None else \
            {p: params[p] for p in sub}
        new, state = inner[1](sub, state, sub_params)
        return {p: new.get(p, u) for p, u in updates.items()}, state
    return init, update


def previous_optimizer(kind, lr, warmup_steps, total_steps, mask, master):
    """make_optimizer ("sft") or make_vsm_optimizer ("vsm") as it was:
    clip, then AdamW on their schedules, optionally over f32 masters,
    masked."""
    if kind == "sft":
        schedule, b2 = optim.warmup_cosine_decay_schedule(
            0.0, lr, warmup_steps, max(total_steps, warmup_steps + 1)), 0.999
    else:
        schedule, b2 = optim.join_schedules(
            [optim.linear_schedule(0.0, lr, warmup_steps),
             optim.linear_schedule(lr, 0.0,
                                   max(total_steps - warmup_steps, 1))],
            [warmup_steps]), 0.95
    adamw = _prev_chain(_prev_adam(0.9, b2),
                        _prev_schedule(lambda count: -schedule(count)))
    if master:
        adamw = _prev_master(adamw)
    if mask is not None:
        adamw = _prev_masked(adamw, dict(leaves_with_path(mask)))
    return _prev_chain(_prev_clip(1.0), adamw)


def previous_apply_step(params, grads, opt_state, update):
    """train/sft.apply_step as it was: the whole tree's update, then each
    emitted update applied (plain leaves only)."""
    flat = dict(leaves_with_path(params))
    local = tmesh.local_leaves(flat)
    updates, new_opt = update(grads, opt_state, local)
    new = {}
    while updates:
        new.update(optim.apply_updates(local, dict([updates.popitem()])))
    return replace_leaves(params, new), new_opt


N_LEAVES, LEAF = 12, (48, 40)


def _opt_case(storage, masked, seed=0):
    """(params tree, mask tree or None): N_LEAVES equal matrices, a bias
    and a leaf the mask freezes, stored in f32 or bf16."""
    rng = np.random.RandomState(seed)
    dtype = torch.float32 if storage == "f32" else torch.bfloat16
    tree = {"blocks": {f"w{i:02d}": rng.randn(*LEAF) * 0.3
                       for i in range(N_LEAVES)},
            "bias": rng.randn(LEAF[1]) * 0.1,
            "frozen": rng.randn(LEAF[1])}
    params = map_with_path(
        lambda _, x: torch.from_numpy(x.astype(np.float32)).to(dtype), tree)
    mask = map_with_path(lambda p, _: p != "frozen", tree) if masked \
        else None
    return params, mask


def _opt_grads(params, mask, scale, f32, seed):
    """A gradient of every trainable leaf (as accumulated_grads gives
    them): f32 (f32 buffers, more than one micro-batch) or in the leaf's
    dtype (one micro-batch)."""
    gen = torch.Generator().manual_seed(seed)
    trainable = None if mask is None else dict(leaves_with_path(mask))
    return {p: (torch.randn(x.shape, generator=gen) * scale).to(
                torch.float32 if f32 else x.dtype)
            for p, x in leaves_with_path(params)
            if trainable is None or trainable[p]}


def _same(a, b, where=""):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def _make_opt(kind, mask, master):
    if kind == "sft":
        return tsft.make_optimizer(1e-2, warmup_steps=1, total_steps=6,
                                   trainable_mask=mask, master_f32=master)
    return tvsm.make_vsm_optimizer(lr=1e-2, warmup_steps=1, total_steps=6,
                                   trainable_mask=mask, master_f32=master)


# core/params.BLOCK: the default (each test leaf whole), and blocks of 500 of a
# leaf's 1920 elements (the last one short)
BLOCKS = {"whole": tparams.BLOCK, "blocks": 500}


@pytest.mark.parametrize("block", list(BLOCKS))
@pytest.mark.parametrize("grads_f32", [True, False],
                         ids=["f32_grads", "leaf_dtype_grads"])
@pytest.mark.parametrize("masked", [True, False], ids=["masked", "all"])
@pytest.mark.parametrize("storage", ["f32", "bf16", "bf16_master"])
@pytest.mark.parametrize("kind", ["sft", "vsm"])
def test_leaf_by_leaf_update_equals_the_previous_whole_tree_update(
        kind, storage, masked, grads_f32, block, monkeypatch):
    """Three steps of each trainer's optimizer (the clip active on the
    first) through train/sft.apply_step, which both trainers' steps call,
    each leaf whole or in blocks of its elements, against
    previous_apply_step over previous_optimizer on copies of the same
    leaves and gradients: every parameter, master, moment and count
    equal bit for bit after each step."""
    monkeypatch.setattr(tparams, "BLOCK", BLOCKS[block])
    master = storage == "bf16_master"
    params, mask = _opt_case(storage, masked)
    opt = _make_opt(kind, mask, master)
    prev = previous_optimizer(kind, 1e-2, 1, 6, mask, master)
    clone = lambda t: map_with_path(lambda _, x: x.clone(), t)  # noqa: E731
    got, want = clone(params), clone(params)
    got_state = opt.init(dict(leaves_with_path(got)))
    want_state = prev[0](dict(leaves_with_path(want)))
    for step, scale in enumerate((3.0, 0.1, 0.2)):
        grads = _opt_grads(params, mask, scale, grads_f32, seed=step)
        got, got_state = tsft.apply_step(got, clone(grads), got_state, opt)
        want, want_state = previous_apply_step(want, clone(grads),
                                               want_state, prev[1])
        _same(got, want, f"step {step} params")
        _same(got_state, want_state, f"step {step} state")


class _Temporaries(TorchDispatchMode):
    """The storage each op makes (an output that is not a scalar and
    shares no argument's storage), with a finalizer on the tensor that
    returns it: `peak()` is the most bytes alive at once of those that
    died before the mode was left, the temporaries."""

    def __init__(self):
        super().__init__()
        self.events, self.dead = [], set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        seen = {t.untyped_storage().data_ptr()
                for t in tree_leaves((args, kwargs))
                if isinstance(t, torch.Tensor)}
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.dim() and \
                    t.untyped_storage().data_ptr() not in seen:
                i = len(self.events)
                self.events.append((i, t.untyped_storage().nbytes()))
                weakref.finalize(t, self._free, i)
        return out

    def _free(self, i):
        self.events.append((i, None))
        self.dead.add(i)

    def peak(self):
        size, live, top = {}, 0, 0
        for i, nbytes in self.events:
            if i not in self.dead:
                continue
            if nbytes is not None:
                size[i] = nbytes
                live += nbytes
            else:
                live -= size[i]
            top = max(top, live)
        return top


class _Watched(dict):
    """A gradient dict whose pop checks that every gradient popped before
    is gone (no reference left anywhere)."""

    def __init__(self, *a):
        super().__init__(*a)
        self.popped = []

    def pop(self, key):
        alive = [k for k, r in self.popped if r() is not None]
        assert not alive, f"gradients alive when {key} is taken: {alive}"
        out = super().pop(key)
        self.popped.append((key, weakref.ref(out)))
        return out


@pytest.mark.parametrize("block", list(BLOCKS))
@pytest.mark.parametrize("grads_f32", [True, False],
                         ids=["f32_grads", "leaf_dtype_grads"])
def test_leaf_by_leaf_update_holds_one_leaf_at_a_time(grads_f32, block,
                                                      monkeypatch):
    """apply_step with f32 masters over N_LEAVES bf16 leaves: the
    temporaries alive at once never exceed two f32 copies of one leaf
    (in blocks of 500 elements, two f32 copies of a block), where the
    previous whole-tree update held every leaf's emitted update (and
    with gradients in the leaves' dtype every f32 gradient) at once;
    each leaf's gradient is gone before the next is taken."""
    monkeypatch.setattr(tparams, "BLOCK", BLOCKS[block])
    params, mask = _opt_case("bf16_master", masked=True)
    leaf_f32 = 4 * min(LEAF[0] * LEAF[1], BLOCKS[block])
    peaks = {}
    for name in ("leaf_by_leaf", "previous"):
        opt = _make_opt("sft", mask, True) if name == "leaf_by_leaf" else \
            previous_optimizer("sft", 1e-2, 1, 6, mask, True)
        state = opt.init(dict(leaves_with_path(params))) \
            if name == "leaf_by_leaf" else \
            opt[0](dict(leaves_with_path(params)))
        grads = _Watched(_opt_grads(params, mask, 3.0, grads_f32, seed=0))
        with _Temporaries() as mode:
            if name == "leaf_by_leaf":
                new = tsft.apply_step(params, grads, state, opt)
            else:
                new = previous_apply_step(params, grads, state, opt[1])
        peaks[name] = mode.peak()
        assert new[0]["blocks"]["w00"].dtype == torch.bfloat16
        assert not grads or name == "previous"
    assert peaks["leaf_by_leaf"] <= 2 * leaf_f32 < peaks["previous"], peaks
