"""The ranks of tests/test_torch_mesh.py's spawned gloo worlds.

Kept apart from the test file so that a spawned rank imports torch and
the port only (the test file imports JAX for its references). It holds
no tests. `world` runs every sharded computation of the mesh tests in
one world of ranks on each mesh shape it is given, and rank 0 writes
the results (plain tensors, gathered whole) with torch.save."""

from __future__ import annotations

import copy
import sys
import types

import numpy as np
import torch
import torch.distributed as dist

from vstar_tpu_torch.core import mesh as M
from vstar_tpu_torch.core.params import Init, leaves_with_path

LR = 1e-3


def _flat_full(tree):
    return {k: v.detach().clone() for k, v in leaves_with_path(
        M.full_tree(tree))}


def decoder_forward(params, cfg, hidden, positions, kv_lens):
    """The decoder's hidden states on a (possibly sharded) VQA tree."""
    from vstar_tpu_torch.nn.llama import llama_forward
    with torch.no_grad():
        p = M.unshard(params)
        out, _ = llama_forward(p["llama"], cfg.llama, hidden, positions,
                               kv_lens)
    return out


def sft_steps(params, cfg, batch, stage, steps=1):
    """`steps` f32 sft_train_steps at lr 1e-3 (no warmup): (losses, grad
    norms, the final tree whole)."""
    from vstar_tpu_torch.train import sft
    from vstar_tpu_torch.train import train_vqa_main as tm
    mask = (tm.projector_only_mask(params, "linear") if stage == "pretrain"
            else tm.frozen_vision_mask(params))
    accum = 2 if stage == "pretrain" else 1
    opt = sft.make_optimizer(LR, warmup_steps=0, total_steps=4,
                             trainable_mask=mask)
    st = sft.init_train_state(params, opt)
    losses, norms = [], []
    for _ in range(steps):
        st, m = sft.sft_train_step(st, batch, cfg, opt, mask,
                                   compute_dtype=torch.float32,
                                   grad_accum=accum)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, _flat_full(st.params)


def prefetch_check(params, cfg, batch):
    """The finetune's sft_steps with the layer fetch as it trains (each
    next layer's owner broadcasts in flight behind the current layer,
    core/mesh.layer_source's prefetch) and with every fetch synchronous:
    {"prefetch", "sync": their (losses, norms, final tree), and
    "<run>_fetches": each run's core/mesh.fetch_collectives;
    "events": the prefetched run's broadcasts (in flight or not, phase)
    and K1 calls (phase), in order}."""
    from vstar_tpu_torch.nn import llama as L
    source, fa, from_owner = L.layer_source, L.flash_attention, \
        M._from_owner
    events, out = [], {}

    def k1(q, *a, **kw):
        events.append(("k1", M._phase()))
        return fa(q, *a, **kw)

    def owner(part, mesh, o, async_op=False):
        events.append(("broadcast", async_op, M._phase()))
        return from_owner(part, mesh, o, async_op)

    for run in ("prefetch", "sync"):
        before = dict(M.fetch_collectives)
        if run == "prefetch":
            L.flash_attention, M._from_owner = k1, owner
        else:
            L.layer_source = lambda stack, prefetch=False: source(stack)
        try:
            out[run] = sft_steps(params, cfg, batch, "finetune")
        finally:
            L.layer_source, L.flash_attention, M._from_owner = \
                source, fa, from_owner
        out[run + "_fetches"] = {k: n - before.get(k, 0) for k, n in
                                 M.fetch_collectives.items()}
    out["events"] = events
    return out


def vsm_grads(params, cfg, batch):
    """vsm_loss's metrics and the trainable gradients (whole) of one
    micro-batch in f32: on a sharded tree each rank differentiates its
    rows, the normalisers are the whole batch's."""
    from vstar_tpu_torch.train.accumulate import accumulated_grads
    from vstar_tpu_torch.train.lora import vsm_trainable_mask
    from vstar_tpu_torch.train.vsm_train import vsm_loss
    mesh = M.mesh_of(params)
    local = batch if mesh is None else mesh.local_rows(batch)
    loss, metrics, grads = accumulated_grads(
        lambda p, b: vsm_loss(p, cfg, b, compute_dtype=torch.float32),
        params, local, 1, has_aux=True, trainable=vsm_trainable_mask(params))
    if mesh is not None:
        metrics = {k: mesh.batch_sum(v) for k, v in metrics.items()}
        flat = dict(leaves_with_path(params))
        with torch.no_grad():
            grads = {p: M.full(M.with_local(flat[p], g))
                     for p, g in grads.items()}
    return {k: float(v) for k, v in metrics.items()}, grads


def vsm_val(params, cfg, batch):
    """vsm_val_forward in f32 on the whole batch (every rank computes it):
    (mask logits, detection logits, boxes)."""
    from vstar_tpu_torch.train.vsm_train import vsm_val_forward
    return vsm_val_forward(params, cfg, batch, compute_dtype=torch.float32)


def vsm_steps(params, cfg, batch, steps=1):
    """`steps` f32 vsm_train_steps over 2 micro-batches at lr 1e-3 (no
    warmup): (metrics per step, the final tree whole)."""
    from vstar_tpu_torch.train.lora import vsm_trainable_mask
    from vstar_tpu_torch.train.vsm_train import (init_train_state,
                                                 make_vsm_optimizer,
                                                 vsm_train_step)
    mask = vsm_trainable_mask(params)
    opt = make_vsm_optimizer(lr=LR, warmup_steps=0, total_steps=10,
                             trainable_mask=mask)
    st = init_train_state(params, opt)
    out = []
    for _ in range(steps):
        st, m = vsm_train_step(st, batch, cfg, opt, mask,
                               compute_dtype=torch.float32, grad_accum=2)
        out.append({k: float(v) for k, v in m.items()})
    return out, _flat_full(st.params)


class Recorder:
    """While active on a rank of `mesh`: the model splits' collectives
    (core/mesh.model_collectives, by (site, operation, phase)), the query
    heads of each K1 call by phase ("forward", or "recompute" under
    remat), the heads of each K7 call, the all-gathers a layer gather
    runs on the model group, and the local shapes of the layer stack's
    matrices on every rank (`shapes`, on leaving)."""

    def __init__(self, mesh, stack):
        self.mesh, self.stack = mesh, stack

    def __enter__(self):
        from vstar_tpu_torch.kernels import flash_attention as FA
        from vstar_tpu_torch.nn import llama as L
        self.k1, self.k7, self.layer_gathers = [], [], 0
        M.model_collectives.clear()
        self.saved = (L.flash_attention, FA.flash_attention_bwd,
                      M._all_gather)
        fa, bwd, gather = self.saved
        group = self.mesh.groups[M.MODEL_AXIS]

        def k1(q, *a, **kw):
            self.k1.append((M._phase(), q.shape[2]))
            return fa(q, *a, **kw)

        def k7(q, *a, **kw):
            self.k7.append(q.shape[2])
            return bwd(q, *a, **kw)

        def all_gather(x, dim, g):
            if g is group and sys._getframe(1).f_code.co_qualname == \
                    "_GatherLayer.forward":
                self.layer_gathers += 1
            return gather(x, dim, g)

        L.flash_attention, FA.flash_attention_bwd, M._all_gather = \
            k1, k7, all_gather
        return self

    def __exit__(self, *exc):
        from vstar_tpu_torch.kernels import flash_attention as FA
        from vstar_tpu_torch.nn import llama as L
        L.flash_attention, FA.flash_attention_bwd, M._all_gather = \
            self.saved
        self.collectives = dict(M.model_collectives)
        local = {k: tuple(self.stack[b][k].to_local().shape)
                 for b, cols, rows in M.TP_BLOCKS for k in cols + (rows,)}
        every = [None] * M.world_size()
        dist.all_gather_object(every, local)
        self.shapes = every

    def result(self):
        return {"collectives": self.collectives, "k1": self.k1,
                "k7": self.k7, "layer_gathers": self.layer_gathers,
                "shapes": self.shapes}


def recorded(mesh, stack, fn, *args):
    """fn(*args) under a Recorder where the mesh's model axis is above 1:
    (its result, the Recorder's result or None)."""
    if mesh.shape[M.MODEL_AXIS] == 1:
        return fn(*args), None
    with Recorder(mesh, stack) as rec:
        out = fn(*args)
    return out, rec.result()


def vqa_loop_args(out, mesh, epochs):
    return types.SimpleNamespace(
        stage="pretrain", mesh=mesh, param_dtype="f32", hbm_gb=16.0,
        per_device_batch_size=4, num_train_epochs=epochs, log_every=1,
        output_dir=str(out), data_workers=1, prefetch_depth=2,
        auto_resume=True, save_steps=1)


def vqa_loop(params, cfg, data, out, mesh, first=True, second=True):
    """run_training (pretrain, f32 compute, 2 steps an epoch) into `out`
    on `mesh` (None: one device): with `first` one epoch (its
    ckpt_latest written), with `second` a second invocation of two
    epochs resuming from the ckpt_latest it finds there (written on any
    mesh) into epoch 1; `first` without `second` returns None. ->
    (steps, final tree whole, logged losses)."""
    import functools
    import json
    from vstar_tpu_torch.data.pretrain_dataset import (
        PretrainCaptionDataset, collate_pretrain)
    from vstar_tpu_torch.multimodal.stub_tokenizer import StubTokenizer
    from vstar_tpu_torch.train import sft
    from vstar_tpu_torch.train import train_vqa_main as tm
    tok = StubTokenizer(cfg.llama.vocab_size)
    ds = PretrainCaptionDataset(data["json"], data["images"],
                                image_size=cfg.vision.image_size)

    def collate(instances, t):
        return collate_pretrain(instances, t, n_long=cfg.image_tokens_long,
                                n_short=cfg.image_tokens_short,
                                image_long=True, seq_bucket=64)

    mask = tm.projector_only_mask(params, "linear")
    step = tm.sft_train_step
    tm.sft_train_step = functools.partial(sft.sft_train_step,
                                          compute_dtype=torch.float32)
    try:
        for epochs in (1,) * first + (2,) * second:
            state = tm.run_training(vqa_loop_args(out, mesh, epochs), cfg,
                                    copy.copy(params), ds, collate, tok,
                                    mask, LR)
    finally:
        tm.sft_train_step = step
    if not second:
        return None
    logged = []
    if M.is_main_process():
        with open(f"{out}/metrics.jsonl") as f:
            logged = [json.loads(x) for x in f.read().splitlines()]
    return state.step, _flat_full(state.params), logged


def vsm_loop_args(base, name, epochs, mesh):
    return types.SimpleNamespace(
        dataset_dir=str(base), log_base_dir=str(base / "runs"),
        exp_name=name, epochs=epochs, steps_per_epoch=2, batch_size=4,
        grad_accumulation_steps=1, lr=LR, ce_loss_weight=1.0,
        dice_loss_weight=0.5, bce_loss_weight=2.0, det_loss_weight=0.1,
        warmup_steps=1, seq_bucket=64, prefetch_depth=2, mask_res=12,
        mesh=mesh, param_dtype="f32", hbm_gb=16.0, auto_resume=True,
        no_eval=True, dataset="general_segdet||vqa", sample_rates="1,1",
        save_steps=1)


def vsm_loop(params, cfg, base, name, mesh, first=True, second=True):
    """run_vsm_training in f32 compute, as vqa_loop (`first`: one epoch;
    `second`: two epochs, resuming from what it finds; the two in one go
    where no checkpoint is there): -> (steps, final tree whole), None
    without `second`."""
    import functools
    from vstar_tpu_torch.multimodal.stub_tokenizer import StubTokenizer
    from vstar_tpu_torch.train import train_vsm_main as tm
    tok = StubTokenizer(cfg.llama.vocab_size)
    step = tm.vsm_train_step
    tm.vsm_train_step = functools.partial(step, compute_dtype=torch.float32)
    try:
        for epochs in (1,) * first + (2,) * second:
            state = tm.run_vsm_training(vsm_loop_args(base, name, epochs,
                                                      mesh), cfg,
                                        copy.copy(params), tok, 3)
    finally:
        tm.vsm_train_step = step
    if not second:
        return None
    return state.step, _flat_full(state.params)


# The trainer loops resumed across meshes (tests/test_torch_mesh.py): each
# run's name -> (the mesh its first epoch is written on, the mesh its
# second invocation resumes on); None is one device (a process without a
# process group: rank 0 before the world starts, or after it ends).
CROSS_LOOPS = {"2x2x1": ("2x2x1", "1x2x2"), "1x2x2": ("1x2x2", None),
               "one": (None, "1x4x1")}


def _loops_on(job, mesh_arg, out, phase):
    """The cross-mesh loops' epochs that run on `mesh_arg`: the first
    epochs written there (phase "first") or the resumes (phase
    "second"); into out["vqa_loop"] / out["vsm_loop"][name] (the second
    invocations' results). After a 2x2x1 first epoch rank 0 keeps a copy
    of the VSM's ckpt_model/state (the export test's)."""
    import os
    import shutil
    for name, meshes in CROSS_LOOPS.items():
        i = 0 if phase == "first" else 1
        if meshes[i] != mesh_arg:
            continue
        kw = {"first": i == 0, "second": i == 1}
        vqa = vqa_loop(job["vqa"], job["vqa_cfg"], job["vqa_data"],
                       f"{job['work']}/vqa_cross_{name}", mesh_arg, **kw)
        vsm = vsm_loop(job["vsm"], job["vsm_cfg"], job["vsm_data"],
                       f"vsm_cross_{name}", mesh_arg, **kw)
        if i == 1:
            out.setdefault("vqa_loop", {})[name] = vqa
            out.setdefault("vsm_loop", {})[name] = vsm
        elif name == "2x2x1" and M.is_main_process():
            shutil.copytree(os.path.join(
                job["vsm_data"], "runs", "vsm_cross_2x2x1", "ckpt_model",
                "state"), os.path.join(job["work"], "export_2x2x1"))


def engines(vqa_params, vqa_cfg, vsm_params, vsm_cfg, mesh):
    """A VQA free-form answer and a VSM detection and heatmap of the tiny
    engines (f32), sharded over `mesh` (None: unsharded)."""
    from PIL import Image
    from vstar_tpu_torch.eval.vqa_engine import VQAEngine
    from vstar_tpu_torch.multimodal.stub_tokenizer import StubTokenizer
    from vstar_tpu_torch.search.batched import BatchedVSMEngine
    tok = StubTokenizer(vqa_cfg.llama.vocab_size)
    vqa = VQAEngine(vqa_params, vqa_cfg, tok, device="cpu",
                    prompt_buckets=(64,), option_bucket=16,
                    compute_dtype=torch.float32, mesh=mesh)
    vsm = BatchedVSMEngine(vsm_params, vsm_cfg, tok, loc_token_id=3,
                           device="cpu", max_new_tokens=4,
                           prompt_buckets=(64,), compute_dtype=torch.float32,
                           mesh=mesh)
    img = Image.fromarray((np.random.RandomState(2).rand(96, 128, 3) * 255)
                          .astype("uint8"))
    boxes, scores, heatmap = vsm.detect(img, "cat")
    return {"answer": vqa.free_form(img, "what is on the table ?",
                                    max_new_tokens=12),
            "choice": vqa.multiple_choice(img, "what color is the cup ?",
                                          ["red", "blue"]),
            "boxes": boxes, "scores": scores, "heatmap": heatmap,
            "segment": np.asarray(vsm.segment(img, "cat"))}


def vqa_answers(params, cfg, mesh):
    """The tiny VQA engine's free-form answer and choice (f32), sharded
    over `mesh` (None: unsharded): the check of a quantized tree and of
    a deeper one."""
    from PIL import Image
    from vstar_tpu_torch.eval.vqa_engine import VQAEngine
    from vstar_tpu_torch.multimodal.stub_tokenizer import StubTokenizer
    vqa = VQAEngine(params, cfg, StubTokenizer(cfg.llama.vocab_size),
                    device="cpu", prompt_buckets=(64,), option_bucket=16,
                    compute_dtype=torch.float32, mesh=mesh)
    img = Image.fromarray((np.random.RandomState(2).rand(96, 128, 3) * 255)
                          .astype("uint8"))
    return {"answer": vqa.free_form(img, "what is on the table ?",
                                    max_new_tokens=12),
            "choice": vqa.multiple_choice(img, "what color is the cup ?",
                                          ["red", "blue"])}


# the model split's structure: a prefill of TP_PREFILL tokens, then one
# decode step, into a cache of TP_CACHE slots
TP_PREFILL, TP_CACHE = 8, 128


def tp_structure(params, cfg, mesh):
    """The decoder of `params` (a VQA tree) as an engine holds it on
    `mesh` (core/mesh.serving_params): a prefill of TP_PREFILL tokens and
    one decode step through llama_forward into the rank's cache (its
    heads from nn/llama.kv_heads). -> {"prefill" / "decode": (the
    collectives each ran, by (operation, axis); the query heads of each
    attention call; the hidden states), "fetches" / "hidden": per step
    the collectives that fetched layers (core/mesh.fetch_collectives) and
    the hidden split's (core/mesh.hidden_collectives), "cache_heads":
    every rank's (cache KV heads, the cache's head dim), "model_split":
    the blocks split (None: no model split), "hidden_split": whether the
    stack lies on the hidden axis, "stack_bytes": every rank's bytes of
    the layer stack}, whole on rank 0. A decoder whose 3 heads the model
    axis would cut: "refusal", the error serving_params raises."""
    import dataclasses
    from vstar_tpu_torch.nn import llama as L
    lcfg = cfg.llama
    tree = M.serving_params(params, mesh, lcfg)
    llama = tree["llama"]
    heads = L.kv_heads(llama, lcfg)
    cache = L.init_cache(lcfg, 1, TP_CACHE, torch.float32, device="cpu",
                         heads=heads)
    gen = torch.Generator().manual_seed(11)
    h = torch.randn((1, TP_PREFILL + 1, lcfg.hidden_size), generator=gen)
    attention, calls = L.flash_attention, []

    def recorded(q, *a, **kw):
        calls.append(q.shape[2])
        return attention(q, *a, **kw)

    split = M.model_split(llama["layers"])
    out = {"model_split": None if split is None else split.blocks,
           "hidden_split": M.hidden_split(llama["layers"]) is not None,
           "fetches": {}, "hidden": {}}
    L.flash_attention = recorded
    try:
        with torch.no_grad():
            for name, lo, hi in (("prefill", 0, TP_PREFILL),
                                 ("decode", TP_PREFILL, TP_PREFILL + 1)):
                for counts in (M.collectives, M.fetch_collectives,
                               M.hidden_collectives):
                    counts.clear()
                del calls[:]
                pos = torch.arange(lo, hi)[None]
                hidden, cache = L.llama_forward(
                    llama, lcfg, h[:, lo:hi], pos,
                    torch.tensor([hi], dtype=torch.int32),
                    q_offsets=torch.tensor([lo], dtype=torch.int32),
                    cache=cache)
                out[name] = (dict(M.collectives), list(calls), hidden)
                out["fetches"][name] = dict(M.fetch_collectives)
                out["hidden"][name] = dict(M.hidden_collectives)
    finally:
        L.flash_attention = attention
    every = [None] * M.world_size()
    dist.all_gather_object(every, (cache.k.shape[3], cache.k.shape[4]))
    out["cache_heads"] = every
    stack = sum(x.to_local().nbytes for _, x in leaves_with_path(
        llama["layers"]))
    every = [None] * M.world_size()
    dist.all_gather_object(every, stack)
    out["stack_bytes"] = every
    cut = dataclasses.replace(lcfg, hidden_size=48, num_heads=3,
                              num_kv_heads=3, head_dim=16)
    try:
        M.serving_params({"llama": L.init_llama_params(Init(0, "cpu"),
                                                       cut)}, mesh, cut)
        out["refusal"] = None
    except ValueError as e:
        out["refusal"] = str(e)
    return out


def act_int8_split(params, cfg, mesh):
    """tp_structure of `params` on `mesh` under act-int8 (the decoder's
    stack on the hidden axis), with every product of an int8 entry that
    _act_int8_dots computes held to the unsharded _w8a8_dot of the whole
    rows (the ranks' columns gathered) on the whole weights. -> (the
    structure, the products held, whether each equals bit for bit)."""
    from vstar_tpu_torch.nn import llama as L
    from vstar_tpu_torch.nn import quant as Q
    calls, dots = [], L._act_int8_dots

    def recorded(x, ws, hidden):
        out = dots(x, ws, hidden)
        calls.append((x, out))
        return out

    L._act_int8_dots = recorded
    Q.set_act_int8(True)
    routes = Q.int4_routes["w4a8"]
    try:
        structure = tp_structure(params, cfg, mesh)
    finally:
        L._act_int8_dots = dots
        Q.set_act_int8(False)
    structure["w4a8_routes"] = Q.int4_routes["w4a8"] - routes
    layers, n = params["llama"]["layers"], cfg.llama.num_layers
    held, equal = 0, True
    for j, (x, out) in enumerate(calls):
        whole = M._all_gather(x, x.dim() - 1, mesh.groups[M.FSDP_AXIS])
        block, names = (("attn", ("wq", "wk", "wv")) if j % 2 == 0
                        else ("mlp", ("w_gate", "w_up")))
        for name, y in zip(names, out):
            w = layers[block][name]
            if isinstance(w, dict) and "q" in w:
                entry = {k: v[(j // 2) % n] for k, v in w.items()}
                equal = equal and torch.equal(y, Q._w8a8_dot(whole, entry))
                held += 1
    return structure, held, equal


def act_int8_reference(params, cfg):
    """tp_structure's prefill and decode step through the unsharded
    decoder under act-int8: {"prefill" / "decode": the hidden states}."""
    from vstar_tpu_torch.nn import llama as L
    from vstar_tpu_torch.nn import quant as Q
    lcfg = cfg.llama
    cache = L.init_cache(lcfg, 1, TP_CACHE, torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(11)
    h = torch.randn((1, TP_PREFILL + 1, lcfg.hidden_size), generator=gen)
    out = {}
    Q.set_act_int8(True)
    try:
        with torch.no_grad():
            for name, lo, hi in (("prefill", 0, TP_PREFILL),
                                 ("decode", TP_PREFILL, TP_PREFILL + 1)):
                out[name], cache = L.llama_forward(
                    params["llama"], lcfg, h[:, lo:hi],
                    torch.arange(lo, hi)[None],
                    torch.tensor([hi], dtype=torch.int32),
                    q_offsets=torch.tensor([lo], dtype=torch.int32),
                    cache=cache)
    finally:
        Q.set_act_int8(False)
    return out


def act_int8_answers(params, cfg, mesh):
    """vqa_answers under act-int8."""
    from vstar_tpu_torch.nn import quant as Q
    Q.set_act_int8(True)
    try:
        return vqa_answers(params, cfg, mesh)
    finally:
        Q.set_act_int8(False)


def act_int8_checks(job, key, mesh):
    """The act-int8 checks of mesh `key`: for each of its trees of
    job["act_int8"] (mode -> (tree, config)), (act_int8_answers, None for
    a decoder without the rest of the model; act_int8_split)."""
    out = {}
    for mode in job["act_int8_shapes"][key]:
        tree, cfg = job["act_int8"][mode]
        out[mode] = (act_int8_answers(tree, cfg, mesh) if "vision" in tree
                     else None, act_int8_split(tree, cfg, mesh))
    return out


# the towers at their widths: vsm_7b's CLIP-L/14 with 2 layers (the
# penultimate, 1, used) and OWL-B/16 with 1, one image each
TOWER_LAYERS = {"vision": 2, "owl_tower": 1}


def tower_cfgs():
    """{tower: its ViTConfig at 7B widths, cut to TOWER_LAYERS}."""
    import dataclasses
    from vstar_tpu_torch.core.config import vsm_7b
    cfg = vsm_7b()
    return {"vision": dataclasses.replace(cfg.vision, num_layers=2),
            "owl_tower": dataclasses.replace(cfg.owl_vision, num_layers=1)}


def tower_outputs(tree, trace=None):
    """Each tower of `tree` (plain tensors, or an engine's tree with the
    model split kept) on its seeded image: CLIP's patch features, OWL's
    post-LN states. trace: a dict that receives, per tower, the model
    group's collectives (core/mesh.model_collectives, site "tower") and
    the heads of each attention call, (whether K2 took it, heads)."""
    from vstar_tpu_torch.nn import vit as V
    out = {}
    attention = V.tower_attention, V._plain_attention
    calls = []

    def k2(q, *a, **kw):
        calls.append((True, q.shape[2]))
        return attention[0](q, *a, **kw)

    def plain(q, *a, **kw):
        calls.append((False, q.shape[2]))
        return attention[1](q, *a, **kw)

    V.tower_attention, V._plain_attention = k2, plain
    try:
        for name, cfg in tower_cfgs().items():
            img = torch.randn((1, cfg.image_size, cfg.image_size, 3),
                              generator=torch.Generator().manual_seed(21))
            M.model_collectives.clear()
            del calls[:]
            with torch.no_grad():
                if name == "vision":
                    out[name] = V.clip_patch_features(tree[name], cfg, img)
                else:
                    out[name] = V.vit_forward(tree[name], cfg, img,
                                              feature_layer=-1,
                                              apply_post_ln=True)
            if trace is not None:
                trace[name] = (dict(M.model_collectives), list(calls))
    finally:
        V.tower_attention, V._plain_attention = attention
    return out


def tower_tree():
    """The towers' f32 random weights (seeded) at tower_cfgs' widths."""
    from vstar_tpu_torch.nn.vit import init_vit_params
    return {name: init_vit_params(Init(31 + i, "cpu"), cfg)
            for i, (name, cfg) in enumerate(tower_cfgs().items())}


def cut_tower():
    """A tiny CLIP tower (hidden 32) of 2 heads, which a model axis of 4
    would cut: (its config, its f32 random weights, an image)."""
    import dataclasses
    from vstar_tpu_torch.core.config import vqa_llm_tiny
    from vstar_tpu_torch.nn.vit import init_vit_params
    cfg = dataclasses.replace(vqa_llm_tiny().vision, num_heads=2)
    img = torch.randn((2, cfg.image_size, cfg.image_size, 3),
                      generator=torch.Generator().manual_seed(22))
    return cfg, {"vision": init_vit_params(Init(41, "cpu"), cfg)}, img


def tower_structure(mesh):
    """tower_tree held as an engine holds it on `mesh` (core/mesh
    .serving_params' way: sharded, then gathered but for the model
    split of model_local_leaves): (tower_outputs, its trace, cut_tower's
    patch features held alike)."""
    from vstar_tpu_torch.nn.vit import clip_patch_features
    tree = M.shard_params(tower_tree(), mesh)
    tree = M.unshard(tree, model_local=M.model_local_leaves(tree))
    trace = {}
    out = tower_outputs(tree, trace)
    cfg, cut, img = cut_tower()
    cut = M.shard_params(cut, mesh)
    cut = M.unshard(cut, model_local=M.model_local_leaves(cut))
    with torch.no_grad():
        return out, trace, clip_patch_features(cut["vision"], cfg, img)


def eval_mains(dirs, bench, out_json, mesh, vqa_cfg, vsm_cfg):
    """eval/vstar_bench main (the SEAL loop, 12-token free-form answers)
    and eval/search_eval main from HF directories of the tiny models, with
    --mesh when `mesh` is given. config.json cannot name the tiny towers
    and the directories hold no tokenizer: the tiny configs and the stub
    are patched in, as tests/test_torch_loaders.py does. -> (results by
    task, correctness by task, (top-1, path length))."""
    from vstar_tpu_torch.core import hf_config
    from vstar_tpu_torch.eval import search_eval, vstar_bench
    from vstar_tpu_torch.eval.vqa_engine import VQAEngine
    from vstar_tpu_torch.multimodal import tokenizer as tok_mod
    from vstar_tpu_torch.multimodal.stub_tokenizer import StubTokenizer
    saved = (hf_config.vqa_llm_config_for, hf_config.vsm_config_for,
             tok_mod.load_tokenizer, VQAEngine.free_form)
    free_form = VQAEngine.free_form

    def budget(self, *a, **kw):
        kw.setdefault("max_new_tokens", 12)
        return free_form(self, *a, **kw)

    hf_config.vqa_llm_config_for = lambda p: vqa_cfg
    hf_config.vsm_config_for = lambda p: vsm_cfg
    tok_mod.load_tokenizer = lambda path, **kw: StubTokenizer(
        vqa_cfg.llama.vocab_size)
    VQAEngine.free_form = budget
    flag = [] if mesh is None else ["--mesh", mesh]
    try:
        results, correct, _ = vstar_bench.main(
            ["--vqa-model-path", dirs["vqa"], "--vsm-model-path",
             dirs["vsm"], "--benchmark-folder", bench, "--output-path",
             out_json] + flag, device="cpu")
        search = search_eval.main(["--version", dirs["vsm"],
                                   "--benchmark-folder", bench,
                                   "--minimum_size", "300"] + flag,
                                  device="cpu")
    finally:
        (hf_config.vqa_llm_config_for, hf_config.vsm_config_for,
         tok_mod.load_tokenizer, VQAEngine.free_form) = saved
    return results, correct, search


# --- serving over the mesh (serve/ranks.py) ------------------------------

SERVE_REQUESTS = (("what is on the table ?", None),
                  ("what color is the cup ?", ["red", "blue"]),
                  ("what color is the cup ? (search)", None),
                  ("what color is the cup ? (search)", ["red", "blue"]))
WAVE_REQUESTS = (("what color is object 0 ?", ["red", "blue"]),
                 ("what color is object 1 ?", None),
                 ("what color is object 2 ?", ["red", "blue"]))
# a question longer than the VQA's largest prompt bucket: the trigger
# stage raises on every rank alike
LONG_QUESTION = "what is " + "the colour of " * 100 + "the cup ?"
AFTER_REQUEST = ("what color is object 3 ?", None)
FORCED = dict(confidence_high=2.0, target_cue_threshold=-1.0,
              target_cue_threshold_minimum=-1.0)
CONTINUOUS_KW = dict(max_batch=3, window_ms=3000.0, max_search_steps=2,
                     search_kwargs=FORCED)
SERVE_TOKENS = 12


def serve_image(seed):
    from PIL import Image
    return Image.fromarray((np.random.RandomState(100 + seed).rand(
        230, 250, 3) * 255).astype("uint8"))


def forced_missing(prediction):
    """The continuous services' missing_parser: every request searches."""
    return ["red cup"]


class Forced:
    """A VQA engine (the port's or vstar_tpu's) whose first answer to a
    question marked '(search)' is the search trigger for 'red cup' (random
    weights never emit it); every free-form decode stops at SERVE_TOKENS
    new tokens. The focused re-answer is the engine's own."""

    def __init__(self, engine):
        self.engine = engine

    def __getattr__(self, name):
        return getattr(self.engine, name)

    @staticmethod
    def _trigger(question, answer):
        from vstar_tpu_torch.eval.seal import MISSING_OBJECTS_MSG
        if "(search)" in question and "Additional visual" not in question:
            return MISSING_OBJECTS_MSG + " red cup."
        return answer

    def free_form(self, image, question, **kw):
        kw.setdefault("max_new_tokens", SERVE_TOKENS)
        return self._trigger(question, self.engine.free_form(
            image, question, **kw))

    def free_form_many(self, images, questions, **kw):
        kw.setdefault("max_new_tokens", SERVE_TOKENS)
        return [self._trigger(q, a) for q, a in zip(
            questions, self.engine.free_form_many(images, questions, **kw))]


def serving_engines(job, mesh):
    """The f32 tiny engines the services run, sharded over `mesh` (None:
    unsharded): the VQA with 12 object slots (vstar_tpu's bank reads past
    its slots when a search keeps more boxes; ROADMAP Queue 3), the tilted
    VSM (answers [LOC] at every step)."""
    import dataclasses
    from vstar_tpu_torch.eval.vqa_engine import VQAEngine
    from vstar_tpu_torch.multimodal.stub_tokenizer import StubTokenizer
    from vstar_tpu_torch.search.batched import BatchedVSMEngine
    vqa_cfg = dataclasses.replace(job["vqa_cfg"], max_objects=12)
    tok = StubTokenizer(vqa_cfg.llama.vocab_size)
    vqa = VQAEngine(job["vqa"], vqa_cfg, tok, device="cpu",
                    prompt_buckets=(64, 128, 256), option_bucket=16,
                    compute_dtype=torch.float32, mesh=mesh)
    vsm = BatchedVSMEngine(job["tilted_vsm"], job["vsm_cfg"], tok,
                           loc_token_id=3, eos_id=2, device="cpu",
                           max_new_tokens=4, prompt_buckets=(64, 128),
                           compute_dtype=torch.float32, mesh=mesh)
    return vqa, vsm


def _no_latency(rec):
    return {k: v for k, v in rec.items() if k != "latency_s"}


def serve_single(job, mesh):
    """SERVE_REQUESTS through SealService (2 search steps) on the serving
    engines: on a mesh rank 0 answers them and the other ranks follow.
    -> the records (rank 0 or unsharded), None on a follower."""
    from vstar_tpu_torch.serve import ranks as R
    from vstar_tpu_torch.serve.server import SealService
    vqa, vsm = serving_engines(job, mesh)
    ranks = R.for_engines(vqa, vsm)
    svc = SealService(Forced(vqa), vsm, max_search_steps=2, ranks=ranks)
    if ranks is not None and not ranks.leader:
        R.follow(svc, ranks)
        return None
    try:
        return [_no_latency(svc.answer(serve_image(i), q, o))
                for i, (q, o) in enumerate(SERVE_REQUESTS)]
    finally:
        if ranks is not None:
            ranks.stop()


def serve_continuous(job, mesh):
    """ContinuousSealService (searches forced by its missing_parser) on the
    serving engines: WAVE_REQUESTS at once (one wave of 3), then a wave
    whose question is too long (it fails on every rank alike), then
    AFTER_REQUEST. -> (the wave's records, the failing wave's error, the
    last record, stats) on rank 0 or unsharded, None on a follower."""
    import threading
    from vstar_tpu_torch.serve import ranks as R
    from vstar_tpu_torch.serve.continuous import ContinuousSealService
    vqa, vsm = serving_engines(job, mesh)
    ranks = R.for_engines(vqa, vsm)
    svc = ContinuousSealService(Forced(vqa), vsm, ranks=ranks,
                                missing_parser=forced_missing,
                                **CONTINUOUS_KW)
    if ranks is not None and not ranks.leader:
        R.follow(svc, ranks)
        return None
    try:
        recs = [None] * len(WAVE_REQUESTS)

        def go(i):
            recs[i] = _no_latency(svc.answer(serve_image(10 + i),
                                             *WAVE_REQUESTS[i]))
        threads = [threading.Thread(target=go, args=(i,))
                   for i in range(len(WAVE_REQUESTS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
            assert not t.is_alive()
        try:
            svc.answer(serve_image(20), LONG_QUESTION)
            error = None
        except Exception as e:
            error = f"{type(e).__name__}: {e}"
        after = _no_latency(svc.answer(serve_image(21), *AFTER_REQUEST))
        return recs, error, after, svc.stats()
    finally:
        svc.close()
        if ranks is not None:
            ranks.stop()


def serve_http(job, mesh_arg):
    """The server's own path: add_engine_flags' arguments with --mesh
    (None: unsharded) -> checkpoint_engines on the world's HF directories
    (the tiny configs and the stub tokenizer patched in, as eval_mains
    does), one free-form request over HTTP on port 0 to rank 0's
    make_server, the other ranks following. -> (status, record, whether
    both engines share one Mesh with a sharded decoder stack), None on a
    follower."""
    import argparse
    import base64
    import io
    import json
    import threading
    import urllib.request
    from torch.distributed.tensor import DTensor
    from vstar_tpu_torch.core import hf_config
    from vstar_tpu_torch.multimodal.stub_tokenizer import StubTokenizer
    from vstar_tpu_torch.serve import ranks as R
    from vstar_tpu_torch.serve import server
    p = argparse.ArgumentParser()
    server.add_engine_flags(p)
    args = p.parse_args(["--vqa-model-path", job["hf_dirs"]["vqa"],
                         "--vsm-model-path", job["hf_dirs"]["vsm"],
                         "--device", "cpu"]
                        + ([] if mesh_arg is None else ["--mesh", mesh_arg]))
    saved = (hf_config.vqa_llm_config_for, hf_config.vsm_config_for)
    hf_config.vqa_llm_config_for = lambda path: job["vqa_cfg"]
    hf_config.vsm_config_for = lambda path: job["vsm_cfg"]
    try:
        vqa, vsm = server.checkpoint_engines(
            args, tokenizer=StubTokenizer(job["vqa_cfg"].llama.vocab_size))
    finally:
        hf_config.vqa_llm_config_for, hf_config.vsm_config_for = saved
    one_mesh = vqa.mesh is not None and vqa.mesh is vsm.mesh and all(
        isinstance(e.params["llama"]["layers"]["attn"]["wq"], DTensor)
        for e in (vqa, vsm))
    ranks = R.for_engines(vqa, vsm)
    svc = server.SealService(Forced(vqa), vsm, ranks=ranks)
    if ranks is not None and not ranks.leader:
        R.follow(svc, ranks)
        return None
    httpd = server.make_server(svc, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        buf = io.BytesIO()
        serve_image(30).save(buf, format="PNG")
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/v1/answer",
            data=json.dumps({"image": base64.b64encode(
                buf.getvalue()).decode(),
                "question": SERVE_REQUESTS[0][0]}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            status, rec = r.status, json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
        if ranks is not None:
            ranks.stop()
    return status, _no_latency(rec), one_mesh


# --- checkpoints of a sharded state (core/checkpoint.py) ------------------

def _format_tree(mesh):
    """A tree of DTensors on `mesh` whose pieces are uneven (torch.chunk's
    short last chunks, two axes on one dim, ranks holding nothing), a
    leaf the rules leave whole on an axis that does not divide it, bf16,
    int and 0-d leaves, and non-tensor leaves; and the same tree whole."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from vstar_tpu_torch.core.params import Init
    gen = torch.Generator().manual_seed(41)
    whole = {
        "uneven": torch.randn((5, 3), generator=gen),
        "tail": torch.randn((7,), generator=gen),
        "bf16": torch.randn((4, 6), generator=gen).to(torch.bfloat16),
        "ids": torch.arange(12, dtype=torch.int64).reshape(3, 4),
        "scalar": torch.tensor(2.5),
        "layers": {"wq": torch.randn((3, 4, 8), generator=gen)}}
    S, R = Shard, Replicate()
    placements = {"uneven": (S(0), S(0), R), "tail": (R, S(0), R),
                  "bf16": (S(0), S(1), R), "ids": (R, R, S(1)),
                  "scalar": (R, R, R)}
    tree = {k: _placed(whole[k], mesh, pl) for k, pl in placements.items()}
    # the rules' own placing, clipped where the layer axis (3) does not
    # divide by fsdp
    tree["layers"] = M.shard_params({"llama": {"layers": whole["layers"]}},
                                    mesh)["llama"]["layers"]
    assert isinstance(tree["layers"]["wq"], DTensor)
    del Init
    meta = {"step": 3, "name": "run", "none": None, "mix": [1, 2.5, True]}
    return {"tensors": tree, "meta": meta}, {"tensors": whole, "meta": meta}


def _placed(x, mesh, placements):
    """The DTensor of whole `x` placed by `placements` on `mesh`, this
    rank's block taken by core/mesh.global_slice (no communication)."""
    from torch.distributed.tensor import DTensor
    local = x[M.slices(*M.global_slice(x.shape, placements, mesh.dims,
                                       mesh.coords))].clone()
    return DTensor.from_local(local, mesh.device_mesh, placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def checkpoint_format(work, write_shape, read_shape):
    """save_params of _format_tree on `write_shape` into `work`, then
    load_params of it onto the same leaves placed otherwise on
    `read_shape`, whole (like None) and onto whole tensors. -> on rank 0:
    {"files": name -> bytes, "tree_bytes": the tree's bytes, "reads":
    every rank's (blocks read: (piece extent, block offset in the piece,
    block size); its own slices: leaf shape -> [(offset, extent)];
    whether each read equals the tree: "mesh", "none", "whole")}."""
    import os
    from torch.distributed.tensor import Replicate, Shard
    from vstar_tpu_torch.core import checkpoint as C
    mesh = M.make_mesh(write_shape, "cpu")
    tree, whole = _format_tree(mesh)
    path = os.path.join(work, "format_ckpt")
    C.save_params(tree, path)
    C.save_params(tree, path)         # replaces the first in place
    other = M.make_mesh(read_shape, "cpu")
    S, R = Shard, Replicate()
    again = {"uneven": (R, S(1), S(0)), "tail": (S(0), R, S(0)),
             "bf16": (R, R, S(0)), "ids": (S(0), S(0), R),
             "scalar": (R, R, R)}
    like = {k: _placed(whole["tensors"][k], other, pl)
            for k, pl in again.items()}
    like["layers"] = M.shard_params(
        {"llama": {"layers": whole["tensors"]["layers"]}},
        other)["llama"]["layers"]
    reads, read_block = [], C._read_block

    def recorded(data, at, dtype, extent, offset, size):
        reads.append((tuple(extent), tuple(offset), tuple(size)))
        return read_block(data, at, dtype, extent, offset, size)
    C._read_block = recorded
    try:
        got = C.load_params(path, {"tensors": like, "meta": whole["meta"]})
    finally:
        C._read_block = read_block
    own = {}
    for _, x in leaves_with_path(like):
        own.setdefault(tuple(x.shape), []).append(M.local_slice(x))
    flat = dict(leaves_with_path(whole["tensors"]))
    like_flat = dict(leaves_with_path(like))
    equal = {
        "mesh": all(torch.equal(x.to_local(),
                                flat[p][M.slices(*M.local_slice(x))])
                    and x.placements == like_flat[p].placements
                    for p, x in leaves_with_path(got["tensors"]))
        and got["meta"] == whole["meta"],
        "none": _same_tree(C.load_params(path), whole),
        "whole": _same_tree(C.load_params(path, whole), whole)}
    every = [None] * M.world_size()
    dist.all_gather_object(every, (reads, own, equal))
    if M.rank() != 0:
        return None
    return {"files": {f: os.path.getsize(os.path.join(path, f))
                      for f in sorted(os.listdir(path))},
            "tree_bytes": sum(x.numel() * x.element_size()
                              for x in flat.values()),
            "reads": every}


def _same_tree(a, b):
    if isinstance(b, dict):
        return set(a) == set(b) and all(_same_tree(a[k], b[k]) for k in b)
    if isinstance(b, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and \
            all(_same_tree(x, y) for x, y in zip(a, b))
    if isinstance(b, torch.Tensor):
        return isinstance(a, torch.Tensor) and a.dtype == b.dtype and \
            torch.equal(a, b)
    return a == b


def world(rank, n, store, job_path, out_path):
    """One rank: every sharded computation of the job on each of its mesh
    shapes; rank 0 saves {shape: {check: result}}."""
    torch.set_num_threads(1)
    job = torch.load(job_path, weights_only=False)
    out = {"loops": {}}
    if rank == 0:   # one device: no process group yet
        _loops_on(job, None, out["loops"], "first")
    dist.init_process_group("gloo", store=dist.FileStore(store, n),
                            rank=rank, world_size=n)
    try:
        for shape in job["shapes"]:
            mesh = M.make_mesh(shape, "cpu")
            key = "x".join(map(str, shape))
            res = out[key] = {"placements": (mesh.replicated(),
                                             mesh.data_sharding(2))}
            vqa = M.shard_params(job["vqa"], mesh)
            res["forward"] = decoder_forward(vqa, job["vqa_cfg"],
                                             *job["forward_inputs"])
            res["sft"], res["sft_structure"] = recorded(
                mesh, vqa["llama"]["layers"], sft_steps, vqa,
                job["vqa_cfg"], job["sft_batch"], "finetune")
            if key in job["prefetch_shapes"]:
                res["prefetch"] = prefetch_check(vqa, job["vqa_cfg"],
                                                 job["sft_batch"])
            vsm = M.shard_params(job["vsm"], mesh)
            res["vsm_grads"] = vsm_grads(vsm, job["vsm_cfg"],
                                         job["vsm_batch"])
            res["vsm_val"] = vsm_val(vsm, job["vsm_cfg"], job["vsm_batch"])
            res["vsm_steps"], res["vsm_structure"] = recorded(
                mesh, vsm["llama"]["layers"], vsm_steps, vsm,
                job["vsm_cfg"], job["vsm_batch"])
            res["engines"] = engines(job["vqa"], job["vqa_cfg"],
                                     job["tilted_vsm"], job["vsm_cfg"], mesh)
            if mesh.shape[M.MODEL_AXIS] > 1 or mesh.shape[M.FSDP_AXIS] > 1:
                res["tp_structure"] = tp_structure(job["vqa"],
                                                   job["vqa_cfg"], mesh)
            if key == job["tower_shape"]:
                res["towers"] = tower_structure(mesh)
            _loops_on(job, key, out["loops"], "second")
            _loops_on(job, key, out["loops"], "first")
            if key == job["format_shapes"][0]:
                res["checkpoint_format"] = checkpoint_format(
                    job["work"], shape, job["format_shapes"][1])
            if key == job["serve_shape"]:
                res["quantized"] = {
                    mode: (vqa_answers(tree, job["vqa_cfg"], mesh),
                           tp_structure(tree, job["vqa_cfg"], mesh))
                    for mode, tree in job["quantized"].items()}
                res["act_int8"] = act_int8_checks(job, key, mesh)
                res["eval_mains"] = eval_mains(
                    job["hf_dirs"], job["bench"],
                    f"{job['work']}/eval_{key}.json", key, job["vqa_cfg"],
                    job["vsm_cfg"])
                res["serve_single"] = serve_single(job, mesh)
                res["serve_continuous"] = serve_continuous(job, mesh)
                res["serve_http"] = serve_http(job, key)
        deep = job["deep"]
        for shape in deep["shapes"]:
            # the VQA engine alone, on a stack of 4 layers (which fsdp 4
            # divides)
            mesh = M.make_mesh(shape, "cpu")
            key = "x".join(map(str, shape))
            out[key] = {
                "vqa_answers": vqa_answers(deep["vqa"], deep["vqa_cfg"],
                                           mesh),
                "tp_structure": tp_structure(deep["vqa"], deep["vqa_cfg"],
                                             mesh)}
            out[key]["act_int8"] = act_int8_checks(job, key, mesh)
            out[key]["prefetch"] = prefetch_check(
                M.shard_params(deep["vqa"], mesh), deep["vqa_cfg"],
                job["sft_batch"])
            _loops_on(job, key, out["loops"], "second")
    finally:
        dist.destroy_process_group()
    if rank == 0:   # one device again: the group is gone
        _loops_on(job, None, out["loops"], "second")
        torch.save(out, out_path)


def finetune_7b_plan(rank, n, store, model_dir, out_path):
    """train_vqa_main finetune of the 7B config (config.json only) at
    --mesh 1xNx1 on N ranks with an 80 GB card's budget: the plan passes,
    and the run stops at the missing checkpoint shards."""
    from vstar_tpu_torch.multimodal.stub_tokenizer import StubTokenizer
    from vstar_tpu_torch.train import train_vqa_main as tm
    dist.init_process_group("gloo", store=dist.FileStore(store, n),
                            rank=rank, world_size=n)
    try:
        try:
            tm.main(["finetune", "--model_path", model_dir, "--data_path",
                     model_dir + "/none", "--image_folder", model_dir,
                     "--mesh", f"1x{n}x1", "--hbm_gb", "79.1"],
                    tokenizer=StubTokenizer(32000), device="cpu")
            outcome = "ran"
        except FileNotFoundError as e:
            outcome = f"FileNotFoundError: {e}"
        except MemoryError as e:
            outcome = f"MemoryError: {e}"
        if rank == 0:
            torch.save(outcome, out_path)
    finally:
        dist.destroy_process_group()
