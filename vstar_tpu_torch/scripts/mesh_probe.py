"""The mesh (core/mesh.py) on cards: sharded VQA training steps against the
one-device step, the 7B finetune's per-card plans, and the full 7B
finetune across cards.

One card (`chip_smoke.py`'s mesh phase calls these):
  * `one_rank_mesh`: a world of one NCCL rank and the 1x1x1 mesh, every
    leaf a DTensor; steps of the VQA pretrain at full 7B against the
    one-device steps on the same weights and rows (bit for bit), with
    the K1 / K7 launches of each;
  * `finetune_plans`: the 7B VQA finetune's plan per card at 1x1x1,
    1x2x1, 1x4x1 against the card's budget;
  * `gloo_split`: two ranks over gloo on one card (NCCL takes one rank a
    device), 7B widths with 2 decoder layers on a 1x2x1 mesh, finetune
    steps against the one-device steps; at 1x1x2 (the decoder and the
    towers tensor-parallel) also a VSM step, with each rank's counts;
    with `resume`, the VSM trainer's checkpoint written at 1x2x1,
    resumed at 1x1x2 and on one device, and exported.

Serving over the mesh (`chip_smoke.py`'s mesh phase, part (d)): the
helpers that load a checkpoint pair through the server's
checkpoint_engines with --mesh, answer requests over HTTP and through
the continuous service, and `gloo_serve`, two ranks over gloo on one
card where rank 0 serves over HTTP and rank 1 follows (serve/ranks.py),
at 1x2x1 (part (d3)) or, the decoder tensor-parallel, 1x1x2 (part (d4));
each rank reports K1's launches by heads, its collectives and its KV
slabs.

Several cards, one process each:
    torchrun --nproc-per-node 4 -m vstar_tpu_torch.scripts.mesh_probe \\
        --mesh 1x4x1 --steps 3
runs the full 7B VQA finetune (random weights, 32 layers, bf16 with f32
masters, the tower frozen) on synthetic rows: the plan, the step times,
each card's allocated and peak memory; with --engine also a sharded
VQA engine's greedy answer against the unsharded engine's on every rank.
Rank 0 prints one JSON line and writes chiprun_out/mesh_probe_<mesh>.json.
With --checkpoint 1x2x2,1x1x4 the state after the steps is written as
the trainers write it (one checkpoint of global tensors, every rank its
pieces; core/checkpoint.py) and read back on each of those meshes (each
rank its slices, into a template of that mesh): GB written, seconds and
GB/s of the write and of each read, each read's peak device memory
beside the step's, and every leaf's sum against the written one's:
    torchrun --nproc-per-node 4 -m vstar_tpu_torch.scripts.mesh_probe \\
        --mesh 1x4x1 --steps 1 --checkpoint 1x2x2,1x1x4
`torchrun --nproc-per-node 1 ... --mesh 1x1x1 --layers 16` holds on one
card the state a card of the full model's 1x2x1 mesh holds (--micro 1:
one micro-batch, the gradients in the leaves' dtype). Without torchrun,
`python -m vstar_tpu_torch.scripts.mesh_probe --one-rank --trace` runs
part (a) alone: the pretrain steps on the one-rank 1x1x1 mesh against
one device, and one more step of each traced (device and host time by
operation; the traces in chiprun_out/one_rank_*_step.json.gz). At --mesh
1x1x4 or 1x2x2 the decoder and the towers are tensor-parallel; each
rank reports its last step's counts (collectives by axis and by model
split, K1 / K7 / K2 launches by heads), and with --trace one more step
runs under torch.profiler (device time by kernel; rank 0 writes the
chrome trace to chiprun_out/mesh_probe_<mesh>_step.json.gz). With
--serve-only there is no finetune, only the engine check: the 7B VQA
engine's --engine-tokens greedy tokens by graph on the mesh (on a model
axis above 1 tensor-parallel) against one device, with ms a token,
memory and KV slab bytes a card, K1's heads and the collectives; on an
fsdp axis above 1 the decoder's stack lies on the hidden axis
(core/mesh.hidden_split: the layer fetches stay at 0), and with --trace
rank 0 writes the sharded engine's traced decode to
chiprun_out/mesh_probe_<mesh>_decode.json.gz:
    torchrun --nproc-per-node 4 -m vstar_tpu_torch.scripts.mesh_probe \
        --mesh 1x2x2 --serve-only --trace
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import json
import os
import shutil
import socket
import sys
import tempfile
import time
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

SEED = 0
ROWS, SEQ, MICRO = 8, 512, 2


def _caption(rng) -> str:
    words = ["a", "photo", "of", "the", "red", "mug", "on", "wooden",
             "table", "near", "window", "with", "green", "bottle"]
    return " ".join(rng.choice(words, 40))


def pretrain_rows(cfg, tok, rows: int = ROWS, seq: int = SEQ):
    """Caption rows on noise images (the pretrain collate)."""
    from ..data.pretrain_dataset import collate_pretrain
    rng = np.random.RandomState(SEED)
    size = cfg.vision.image_size
    instances = [{"image": rng.randn(size, size, 3).astype(np.float32),
                  "caption": _caption(rng)} for _ in range(rows)]
    return collate_pretrain(instances, tok, n_long=cfg.image_tokens_long,
                            n_short=cfg.image_tokens_short, image_long=True,
                            seq_bucket=seq)


def finetune_rows(cfg, tok, rows: int = ROWS, seq: int = SEQ):
    """Search-instruction rows: an object crop on even rows, plain image
    rows on odd ones (the SFT collate, padded object slots masked)."""
    from ..data.vqa_sft_dataset import collate_vqa_sft
    rng = np.random.RandomState(SEED + 1)
    size, m = cfg.vision.image_size, cfg.max_objects
    instances = []
    for i in range(rows):
        search = i % 2 == 0
        objects = np.zeros((m, size, size, 3), np.float32)
        q = "What is the color of the mug?"
        if search:
            objects[-1] = rng.randn(size, size, 3)
            q = ("What is the color of the red mug <object> at location "
                 "[0.120,0.300,0.250,0.410]?")
        instances.append({
            "source": [{"from": "human", "value": "<image>\n" + q},
                       {"from": "gpt", "value": _caption(rng)}],
            "has_image": True, "is_search": search,
            "image": rng.randn(size, size, 3).astype(np.float32),
            "objects": objects, "images_long": not search,
            "objects_long": [False] * (m - 1) + [search]})
    return collate_vqa_sft(instances, tok, n_long=cfg.image_tokens_long,
                           n_short=cfg.image_tokens_short, seq_bucket=seq)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _steps(state, batch, cfg, opt, mask, n, dev, count=None,
           micro: int = MICRO):
    """n sft_train_steps; (state, [(loss, grad_norm, seconds)], counts of
    the last step from `count` (zeroed before it, read after))."""
    from ..train.sft import sft_train_step
    out, counts = [], None
    for i in range(n):
        if count is not None and i == n - 1:
            count[0]()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, m = sft_train_step(state, batch, cfg, opt, mask,
                                  grad_accum=micro)
        torch.cuda.synchronize(dev)
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    time.perf_counter() - t0))
        if count is not None and i == n - 1:
            counts = count[1]()
    return state, out, counts


class phase_peaks:
    """A context recording, for each training step, the peak allocated
    bytes of its gradient phase (train/sft's accumulated_grads) in
    `grads` and of the rest of the step, the update, in `update`
    (read_update() after each step)."""

    def __init__(self, dev):
        self.dev, self.grads, self.update = dev, [], []

    def __enter__(self):
        from ..train import sft
        self._orig = sft.accumulated_grads

        def wrapped(*args, **kwargs):
            torch.cuda.synchronize(self.dev)
            torch.cuda.reset_peak_memory_stats(self.dev)
            out = self._orig(*args, **kwargs)
            torch.cuda.synchronize(self.dev)
            self.grads.append(torch.cuda.max_memory_allocated(self.dev))
            torch.cuda.reset_peak_memory_stats(self.dev)
            return out
        sft.accumulated_grads = wrapped
        return self

    def read_update(self):
        torch.cuda.synchronize(self.dev)
        self.update.append(torch.cuda.max_memory_allocated(self.dev))

    def __exit__(self, *exc):
        from ..train import sft
        sft.accumulated_grads = self._orig


def _traced_step(state, batch, cfg, opt, mask, dev, name):
    """One more sft_train_step under torch.profiler: (state, the device
    breakdown (_device_breakdown) with the host's (_host_breakdown)
    beside it); the chrome trace to chiprun_out/<name>.json.gz."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, one, _ = _steps(state, batch, cfg, opt, mask, 1, dev)
    out = _device_breakdown(prof, one[0][2])
    out["host"] = _host_breakdown(prof)
    os.makedirs("chiprun_out", exist_ok=True)
    out["file"] = f"chiprun_out/{name}.json.gz"
    prof.export_chrome_trace(out["file"])
    return state, out


def one_rank_mesh(dev, count=None, steps: int = 2,
                  trace: bool = False) -> dict:
    """Part (a): the VQA pretrain at full 7B on a world of one NCCL rank,
    the 1x1x1 mesh, every leaf a DTensor, against the one-device steps on
    the same weights and rows. Loss, grad norm and every updated leaf
    must be equal bit for bit; `count` = (zero, read) of the launch
    counters, read around the last step of each run. The peaks are each
    run's, with the other copy of the weights resident. trace: one more
    step of each run under torch.profiler (_traced_step; the traces
    chiprun_out/one_rank_{one_device,mesh}_step.json.gz), whose
    breakdowns are "trace_one_device" and "trace_mesh"."""
    from ..core import mesh as M
    from ..core.config import vqa_llm_7b
    from ..core.params import leaves_with_path, map_with_path
    from ..data.vsm_collate import batch_to_torch
    from ..models.vqa_llm import init_vqa_llm_params
    from ..multimodal.stub_tokenizer import StubTokenizer
    from ..train.sft import init_train_state, make_optimizer
    from ..train.train_vqa_main import projector_only_mask
    cfg = vqa_llm_7b()
    tok = StubTokenizer(cfg.llama.vocab_size)
    batch = batch_to_torch(pretrain_rows(cfg, tok), dev)
    params = init_vqa_llm_params(SEED, cfg, device=dev, dtype=torch.bfloat16)
    params["proj_image"] = map_with_path(lambda _, x: x.float(),
                                         params["proj_image"])
    mask = projector_only_mask(params, "linear")
    opt = make_optimizer(2e-3, warmup_steps=1, total_steps=4,
                         trainable_mask=mask, master_f32=True)
    torch.cuda.reset_peak_memory_stats(dev)
    one, one_m, one_counts = _steps(init_train_state(params, opt), batch,
                                    cfg, opt, mask, steps, dev, count)
    one_peak = torch.cuda.max_memory_allocated(dev)
    traces = {}
    if trace:
        one, traces["trace_one_device"] = _traced_step(
            one, batch, cfg, opt, mask, dev, "one_rank_one_device_step")
    one_flat = {p: x for p, x in leaves_with_path(one.params)
                if p.startswith("proj_image.")}
    del one
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = M.make_mesh((1, 1, 1), "cuda")
        sharded = M.shard_params(params, mesh)
        del params
        kinds = {type(x).__name__ for _, x in leaves_with_path(sharded)}
        torch.cuda.reset_peak_memory_stats(dev)
        st, mesh_m, mesh_counts = _steps(init_train_state(sharded, opt),
                                         batch, cfg, opt, mask, steps, dev,
                                         count)
        mesh_peak = torch.cuda.max_memory_allocated(dev)
        if trace:
            st, traces["trace_mesh"] = _traced_step(
                st, batch, cfg, opt, mask, dev, "one_rank_mesh_step")
        flat = dict(leaves_with_path(st.params))
        same = {p: bool(torch.equal(flat[p].to_local(), x))
                for p, x in one_flat.items()}
    finally:
        dist.destroy_process_group()
    return {**traces, "leaf_types": sorted(kinds),
            "one_device": one_m, "mesh": mesh_m,
            "equal_loss_and_norm": [a[:2] == b[:2]
                                    for a, b in zip(one_m, mesh_m)],
            "equal_trainable_leaves": same,
            "counts_one_device": one_counts, "counts_mesh": mesh_counts,
            "peak_bytes_one_device": one_peak, "peak_bytes_mesh": mesh_peak}


def one_rank_engine(dev, count=None) -> dict:
    """Part (a), serving: the random-init VSM at 7B widths with 2 decoder
    layers as a BatchedVSMEngine on the one-rank NCCL 1x1x1 mesh (its
    decoder stack DTensors, its decode captured into CUDA graphs with the
    mesh's collectives in them) against the unsharded engine on the same
    weights: one detection's tokens, boxes, logits and heatmap logits
    bit for bit, with the sharded run's launches (`count` around it)."""
    from PIL import Image
    from ..core import mesh as M
    from ..core.config import vsm_7b
    from ..models.vsm import init_vsm_params
    from ..multimodal.stub_tokenizer import StubTokenizer
    from ..search.batched import BatchedVSMEngine
    full = vsm_7b()
    cfg = dataclasses.replace(full, llama=dataclasses.replace(
        full.llama, num_layers=2))
    tok = StubTokenizer(cfg.llama.vocab_size)
    params = init_vsm_params(SEED + 1, cfg, device=dev, dtype=torch.bfloat16)
    img = Image.fromarray((np.random.RandomState(1).rand(480, 640, 3)
                           * 255).astype("uint8"))
    prompt = "Please locate the cup in this image."

    def engine(mesh=None):
        return BatchedVSMEngine(params, cfg, tok, loc_token_id=3, device=dev,
                                max_new_tokens=16, prompt_buckets=(384,),
                                mesh=mesh)

    plain = engine()
    want = plain._run(img, prompt)[0]
    del plain
    torch.cuda.empty_cache()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        sharded = engine(M.make_mesh((1, 1, 1), "cuda"))
        stack = type(sharded.params["llama"]["layers"]["attn"]["wq"])
        if count is not None:
            count[0]()
        got = sharded._run(img, prompt)[0]
        torch.cuda.synchronize(dev)
        counts = None if count is None else count[1]()
        same = {f: bool(torch.equal(getattr(got, f), getattr(want, f)))
                for f in ("tokens", "num_generated", "det_logits",
                          "det_boxes", "mask_logits", "loc_valid")}
        captured = sharded.graphs.captures
    finally:
        dist.destroy_process_group()
    return {"stack_type": stack.__name__, "equal": same,
            "graphs_captured": captured, "counts": counts}


def finetune_plans(hbm_gb, meshes=((1, 1, 1), (1, 2, 1), (1, 4, 1)),
                   headroom: float = 0.75) -> dict:
    """Part (b): the 7B VQA finetune's plan per card (bf16 with f32
    masters, the tower frozen) on each mesh, against `headroom` of
    `hbm_gb`."""
    from ..core.config import vqa_llm_7b
    from ..core.memory import plan_train_memory
    from ..models.vqa_llm import init_vqa_llm_params
    from ..train.train_vqa_main import frozen_vision_mask
    meta = init_vqa_llm_params(0, vqa_llm_7b(), device="meta",
                               dtype=torch.bfloat16)
    mask = frozen_vision_mask(meta)
    budget = hbm_gb * headroom * 1024 ** 3
    out = {}
    for shape in meshes:
        plan = plan_train_memory(meta, shape, trainable_mask=mask)
        out["x".join(map(str, shape))] = {
            "params": plan.params_bytes, "masters": plan.master_bytes,
            "moments": plan.moments_bytes, "grads": plan.grads_bytes,
            "total": plan.total_bytes, "budget": int(budget),
            "fits": plan.total_bytes <= budget}
    return out


def _gloo_cuda_collectives():
    """gloo takes only broadcast and all_reduce on CUDA tensors, so in part
    (c)'s ranks the mesh's gathers become broadcasts and its
    reduce-scatters all_reduces (core/mesh runs NCCL's, and CPU gloo's,
    all_gather / reduce_scatter)."""
    from ..core import mesh as M

    def all_gather(x, dim, group):
        n, me = dist.get_world_size(group), dist.get_rank(group)
        x = x.movedim(dim, 0).contiguous()
        out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        for i, part in enumerate(out.chunk(n)):
            if i == me:
                part.copy_(x)
            dist.broadcast(part, src=dist.get_global_rank(group, i),
                           group=group)
        return out.movedim(0, dim).contiguous()

    def reduce_scatter(g, dim, group):
        n, me = dist.get_world_size(group), dist.get_rank(group)
        g = g.contiguous().clone()
        dist.all_reduce(g, group=group)
        return g.chunk(n, dim)[me].contiguous()

    M._all_gather, M._reduce_scatter = all_gather, reduce_scatter


def _update_stats(got, want, lr):
    """One leaf of f32 masters: the largest |difference| and the share of
    elements apart by more than lr / 100 and by more than lr / 10."""
    d = (got - want).abs()
    return {"max": float(d.max()),
            "over_lr_100": float((d > lr / 100).float().mean()),
            "over_lr_10": float((d > lr / 10).float().mean()),
            "numel": want.numel()}


VSM_NAMES = ("red mug", "bicycle", "street sign", "dog", "window",
             "green bottle", "person", "clock")


def vsm_rows(cfg, tok, rows: int = 4, seq: int = SEQ, seed: int = SEED + 2):
    """VSM training rows (the VSM collate) of `cfg`'s widths, drawn from
    `seed`: noise images at the towers' sizes, a rectangle mask and 1-4
    target boxes, row i asking for VSM_NAMES[i]; row 1 has no valid mask
    and row 2 no valid boxes, so every loss term is live."""
    from ..data.vsm_collate import VSMRow, collate_vsm_rows
    rng = np.random.RandomState(seed)
    size, owl = cfg.vision.image_size, cfg.owl_vision.image_size
    out = []
    for i in range(rows):
        mask = np.zeros((480, 640), np.float32)
        y0, x0 = rng.randint(0, 300), rng.randint(0, 400)
        mask[y0:y0 + 150, x0:x0 + 200] = 1.0
        nb = 1 + i % 4
        boxes = np.concatenate([rng.uniform(0.2, 0.8, (nb, 2)),
                                rng.uniform(0.05, 0.3, (nb, 2))], 1)
        out.append(VSMRow(
            image_clip=rng.randn(size, size, 3).astype(np.float32),
            image_owl=rng.randn(owl, owl, 3).astype(np.float32),
            source=[{"from": "human", "value": "<image>\nPlease locate the "
                     f"{VSM_NAMES[i % len(VSM_NAMES)]} in this image."},
                    {"from": "gpt", "value": "Sure, [LOC]."}],
            gt_mask=mask, mask_valid=i != 1,
            tgt_boxes=boxes.astype(np.float32), bboxes_valid=i != 2))
    return collate_vsm_rows(out, tok, 3, n_image_tokens=cfg.image_tokens,
                            seq_bucket=seq, mask_res=owl)


def _two_layers(cfg):
    return dataclasses.replace(cfg, llama=dataclasses.replace(
        cfg.llama, num_layers=2))


def _finetune_case(dev, lr):
    """The VQA finetune at 7B widths with 2 decoder layers: (cfg, params,
    mask, optimizer, rows, step function, init_train_state)."""
    from ..core.config import vqa_llm_7b
    from ..models.vqa_llm import init_vqa_llm_params
    from ..multimodal.stub_tokenizer import StubTokenizer
    from ..train import sft
    from ..train.train_vqa_main import frozen_vision_mask
    cfg = _two_layers(vqa_llm_7b())
    params = init_vqa_llm_params(SEED, cfg, device=dev, dtype=torch.bfloat16)
    mask = frozen_vision_mask(params)
    opt = sft.make_optimizer(lr, warmup_steps=0, total_steps=4,
                             trainable_mask=mask, master_f32=True)
    rows = finetune_rows(cfg, StubTokenizer(cfg.llama.vocab_size))
    return (cfg, params, mask, opt, rows, sft.sft_train_step,
            sft.init_train_state)


def _vsm_case(dev, lr, dtype=torch.bfloat16):
    """The VSM step at 7B widths with 2 decoder layers, LoRA r=8 on q and
    v, the reference's trainable set, as _finetune_case; weights and
    compute in `dtype` (f32 masters for bf16 weights)."""
    from ..core.config import vsm_7b
    from ..models.vsm import init_vsm_params
    from ..multimodal.stub_tokenizer import StubTokenizer
    from ..train import vsm_train
    from ..train.lora import add_lora, vsm_trainable_mask
    cfg = _two_layers(vsm_7b())
    params = init_vsm_params(SEED, cfg, device=dev, dtype=dtype)
    params["llama"] = add_lora(params["llama"], SEED + 1, r=8, alpha=16)
    mask = vsm_trainable_mask(params)
    opt = vsm_train.make_vsm_optimizer(lr=lr, warmup_steps=0,
                                       total_steps=4, trainable_mask=mask,
                                       master_f32=dtype != torch.float32)
    rows = vsm_rows(cfg, StubTokenizer(cfg.llama.vocab_size))
    return (cfg, params, mask, opt, rows,
            functools.partial(vsm_train.vsm_train_step, compute_dtype=dtype),
            vsm_train.init_train_state)


@contextlib.contextmanager
def plain_f32_attention():
    """K1, K7 and K2 take bf16 only: an f32 reference run (part (c)'s
    f32 resume) computes its attention by their plain versions, the
    kernels' arithmetic step by step in f32, on the one-device and the
    sharded steps alike. Every other run launches the kernels."""
    from ..kernels import flash_attention as fa
    from ..kernels.tower_attention import tower_attention_reference
    from ..nn import vit
    saved = fa.flash_attention_lse, fa.flash_attention_bwd, \
        vit.tower_attention
    fa.flash_attention_lse, fa.flash_attention_bwd = \
        fa.mha_forward_lse, fa.mha_backward
    vit.tower_attention = tower_attention_reference
    try:
        yield
    finally:
        fa.flash_attention_lse, fa.flash_attention_bwd, \
            vit.tower_attention = saved


def _first_moments(state):
    """A VSM or finetune TrainState's Adam first moments (inside train/
    master.with_f32_master where the weights have masters), path -> this
    rank's tensor."""
    adamw = state.opt_state[1]
    return (adamw["inner"] if isinstance(adamw, dict) else adamw)[0]["mu"]


@torch.no_grad()
def _moment_stats(state, want, rank) -> dict:
    """Each first moment of a sharded `state`, gathered whole, against
    `want` (rank 0's one-device moments): on rank 0 {path: {"moment_max":
    the largest |value| on one device, "moment_diff": the largest
    |difference|}}. Every rank calls it."""
    from ..core import mesh as M
    from ..core.params import leaves_with_path
    like = dict(leaves_with_path(state.params))
    out = {}
    for p, x in _first_moments(state).items():
        m = M.full(M.with_local(like[p], x))
        if rank == 0:
            out[p] = {"moment_max": float(want[p].abs().max()),
                      "moment_diff": float((m - want[p]).abs().max())}
        del m
    return out


def _split_against_one(rank, dev, mesh, case, lr, steps, micro):
    """`steps` steps of one case (_finetune_case, _vsm_case) on one device
    (rank 0) and on `mesh`: rank 0's report of each run's (loss, grad
    norm, seconds) a step, each master's differences (_update_stats) and
    its first moment's (the largest |value| on one device, the largest
    |difference|),
    whether every frozen leaf kept its values on every rank; every rank's
    counts of the sharded run's last step (_rank_counts: K1 / K7 / K2 by
    heads, collectives by axis and by model split)."""
    from ..core import mesh as M
    from ..core.params import leaves_with_path
    from ..data.vsm_collate import batch_to_torch
    cfg, params, mask, opt, rows, step_fn, init = case
    batch = batch_to_torch(rows, dev)
    frozen = [p for p, m in leaves_with_path(mask) if not m]

    def run(state):
        out, counts = [], None
        for i in range(steps):
            if i == steps - 1:
                before = _rank_counts()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            state, m = step_fn(state, batch, cfg, opt, mask,
                               grad_accum=micro)
            torch.cuda.synchronize(dev)
            out.append((float(m["loss"]), float(m["grad_norm"]),
                        time.perf_counter() - t0))
        counts = _counts_delta(before, _rank_counts())
        return state, out, counts

    result = {}
    t0 = time.perf_counter()
    if rank == 0:
        one, result["one_device"], _ = run(init(params, opt))
        master = one.opt_state[1]["master"]
        mu = one.opt_state[1]["inner"][0]["mu"]
        del one
    dist.barrier()
    t1 = time.perf_counter()
    sharded = M.shard_params(params, mesh)
    del params
    before = dict(leaves_with_path(sharded))
    before = {p: before[p].to_local().clone() for p in frozen}
    st, mesh_m, counts = run(init(sharded, opt))
    t2 = time.perf_counter()
    like = dict(leaves_with_path(st.params))
    same = torch.tensor([all(torch.equal(like[p].to_local(), x)
                             for p, x in before.items())], device=dev,
                        dtype=torch.int32)
    dist.all_reduce(same, op=dist.ReduceOp.MIN)
    stats = {}
    mesh_mu = st.opt_state[1]["inner"][0]["mu"]
    with torch.no_grad():
        for p, x in st.opt_state[1]["master"].items():
            whole = M.full(M.with_local(like[p], x))
            m = M.full(M.with_local(like[p], mesh_mu[p]))
            if rank == 0:
                stats[p] = _update_stats(whole, master[p], lr)
                # Adam's first moment: after one step (1 - b1) times the
                # clipped gradient
                stats[p].update(moment_max=float(mu[p].abs().max()),
                                moment_diff=float((m - mu[p]).abs().max()))
            del whole, m
    every = [None] * M.world_size()
    dist.all_gather_object(every, counts)
    result.update(mesh=mesh_m, masters=stats, frozen_equal=bool(same.item()),
                  counts=every,
                  seconds={"one_device": t1 - t0, "mesh": t2 - t1,
                           "compare": time.perf_counter() - t2})
    return result


@torch.no_grad()
def _same_state(a, b) -> bool:
    """Whether TrainState `b` holds the leaves of `a` bit for bit (the
    global trees of train_vsm_main.global_state: parameters, masters,
    moments, counts), each gathered whole. Every rank of `a`'s mesh
    calls it; `b` may be a one-device state that rank 0 alone holds (None
    on the others); the answer is rank 0's."""
    from torch.distributed.tensor import DTensor
    from ..core import mesh as M
    from ..core.params import leaves_with_path
    from ..train.train_vsm_main import global_state

    def flat(state):
        return dict(leaves_with_path({"t": list(global_state(state))}))
    mine, theirs = flat(a), None if b is None else flat(b)
    same = theirs is None or len(theirs) == len(mine)
    for p, x in mine.items():
        x = M.full(x) if isinstance(x, DTensor) else x
        if theirs is None:
            continue
        y = theirs.get(p)
        y = M.full(y) if isinstance(y, DTensor) else y
        same = same and (torch.equal(x, y) if isinstance(x, torch.Tensor)
                         else x == y)
    return bool(same)


def _resume_against_one(rank, dev, case, lr, micro, work, f32=False):
    """Part (c)'s checkpoint: the VSM case (_vsm_case) one step at 1x2x1,
    its TrainState written by both ranks (train_vsm_main.save_state: one
    checkpoint of global tensors), read back at 1x1x2 (both ranks, each
    its slices) and on one device (rank 0, whole), each read held to the
    written state bit for bit (_same_state), then one more step from each
    against the two one-device steps (loss and grad norm a step); the
    resumed 1x1x2 step's counts on every rank (K1 / K7 / K2 launches);
    rank 0's export of the checkpoint (export_main, the directory)
    against the export of the same state written on one device (one
    file). -> rank 0's report {"one_device": the two one-device steps,
    "mesh": step 1 at 1x2x1 and step 2 at 1x1x2, "resumed_one_device":
    step 1 at 1x2x1 and step 2 on one device, each (loss, grad norm,
    seconds); "read_equal": {"mesh", "one_device"}; "export"; "counts":
    every rank's; "seconds"}.

    f32 (a case in f32, its attention by plain_f32_attention): the
    one-device read, its step and the export are left out, and the first
    moments after step 1 (1x2x1) and after step 2 (resumed at 1x1x2) are
    held against the one-device steps' (_moment_stats: "moments_step1",
    "moments_step2")."""
    with plain_f32_attention() if f32 else contextlib.nullcontext():
        return _resume_steps(rank, dev, case, micro, work, f32)


def _resume_steps(rank, dev, case, micro, work, f32):
    from ..core import mesh as M
    from ..core.checkpoint import load_params, save_params
    from ..data.vsm_collate import batch_to_torch
    from ..train import export_main
    from ..train.train_vsm_main import load_state, save_state
    from ..train.vsm_train import VSMTrainState
    cfg, params, mask, opt, rows, step_fn, init = case
    batch = batch_to_torch(rows, dev)

    def step(state):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, m = step_fn(state, batch, cfg, opt, mask, grad_accum=micro)
        torch.cuda.synchronize(dev)
        return state, (float(m["loss"]), float(m["grad_norm"]),
                       time.perf_counter() - t0)

    t0 = time.perf_counter()
    out, want = {}, [None, None]
    if rank == 0:
        one, s1 = step(init(params, opt))
        if f32:
            want[0] = {p: x.clone() for p, x in _first_moments(one).items()}
        one, s2 = step(one)
        want[1] = _first_moments(one)
        out["one_device"] = [s1, s2]
        del one
    dist.barrier()
    path = os.path.join(work, "ckpt_model", "state")
    written, s1 = step(init(M.shard_params(
        params, M.make_mesh((1, 2, 1), dev.type)), opt))
    if f32:
        out["moments_step1"] = _moment_stats(written, want[0], rank)
    t1 = time.perf_counter()
    save_state(written, path, M.mesh_of(written.params))
    save_s = time.perf_counter() - t1
    mesh = M.make_mesh((1, 1, 2), dev.type)
    like = init(M.shard_params(params, mesh), opt)
    t1 = time.perf_counter()
    st = load_state(VSMTrainState, path, like, dev, mesh)
    load_s = time.perf_counter() - t1
    del like
    out["read_equal"] = {"mesh": _same_state(written, st)}
    del written
    one = None
    if not f32:
        one = load_state(VSMTrainState, path, init(params, opt), dev,
                         None) if rank == 0 else None
        out["read_equal"]["one_device"] = _same_state(st, one)
    before = _rank_counts()
    st, s2 = step(st)
    counts = _counts_delta(before, _rank_counts())
    if f32:
        out["moments_step2"] = _moment_stats(st, want[1], rank)
    del st
    every = [None] * M.world_size()
    dist.all_gather_object(every, counts)
    if rank == 0:
        out["mesh"] = [s1, s2]
        if not f32:
            one, s2 = step(one)
            out["resumed_one_device"] = [s1, s2]
            del one
            file = os.path.join(work, "one_device_state")
            save_params(load_params(path), file)
            sds = [export_main.main(["--ckpt", ckpt, "--version", work,
                                     "--save_path", os.path.join(work, name)])
                   for name, ckpt in (("export_mesh", path),
                                      ("export_one", file))]
            out["export"] = {
                "tensors": len(sds[0]),
                "equal": sds[0].keys() == sds[1].keys() and all(
                    sds[0][k].dtype == sds[1][k].dtype
                    and torch.equal(sds[0][k], sds[1][k]) for k in sds[0]),
                "checkpoint_files": sorted(os.listdir(path))}
        out.update(counts=every, save_s=save_s, load_s=load_s,
                   seconds=time.perf_counter() - t0)
    dist.barrier()
    return out


def _gloo_rank(rank, world, store, out_path, lr, steps, micro, device,
               shape, vsm, resume, resume_f32):
    """One rank of part (c)."""
    from ..core import mesh as M
    dev = torch.device(device)
    torch.cuda.set_device(dev)
    _gloo_cuda_collectives()
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    result = {}
    try:
        mesh = M.make_mesh(shape, dev.type)
        result["finetune"] = _split_against_one(
            rank, dev, mesh, _finetune_case(dev, lr), lr, steps, micro)
        if vsm:
            gc.collect()
            torch.cuda.empty_cache()
            result["vsm"] = _split_against_one(
                rank, dev, mesh, _vsm_case(dev, lr), lr, 1, micro)
        if resume:
            gc.collect()
            torch.cuda.empty_cache()
            result["resume"] = _resume_against_one(
                rank, dev, _vsm_case(dev, lr), lr, micro,
                os.path.dirname(out_path))
        if resume_f32:
            gc.collect()
            torch.cuda.empty_cache()
            work = os.path.join(os.path.dirname(out_path), "f32")
            result["resume_f32"] = _resume_against_one(
                rank, dev, _vsm_case(dev, lr, torch.float32), lr, micro,
                work, f32=True)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(result, f)


def gloo_split(lr: float = 1e-3, steps: int = 2, micro: int = MICRO,
               device: str = "cuda:0", shape=(1, 2, 1),
               vsm: bool = False, resume: bool = False,
               resume_f32: bool = False) -> dict:
    """Part (c): two ranks over gloo on one card (spawned processes), 7B
    widths with 2 decoder layers, on the mesh `shape` (1x2x1: the layers
    fsdp-sharded; 1x1x2: the decoder and the towers tensor-parallel):
    `steps` finetune steps (bf16 with f32 masters, no warmup, the 8 rows
    in `micro` micro-batches, so f32 gradient buffers for micro > 1) and,
    with `vsm`, one VSM step (LoRA, 4 rows in `micro` micro-batches),
    against the one-device steps on rank 0 (_split_against_one:
    {"finetune": ..., "vsm": ...}); with `resume`, the VSM checkpoint
    written at 1x2x1 and resumed at 1x1x2 and on one device
    (_resume_against_one: "resume"); with `resume_f32` the same in f32
    with the first moments held ("resume_f32"). Any failure of a rank
    fails the call."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as work:
        out = os.path.join(work, "result.json")
        mp.start_processes(_gloo_rank, args=(2, os.path.join(work, "store"),
                                             out, lr, steps, micro, device,
                                             tuple(shape), vsm, resume,
                                             resume_f32),
                           nprocs=2, start_method="spawn")
        with open(out) as f:
            return json.load(f)


# ---------------------------------------------------------------------------
# Serving over the mesh
# ---------------------------------------------------------------------------

SERVE_TOKENS = 4
SERVE_QUESTION = "What is the color of the mug?"
SERVE_OPTIONS = ["The mug is red.", "The mug is blue.", "The mug is green.",
                 "There is no mug."]
# (image, question, options): free-form, with options, and a forced
# search (the one gloo_serve's ranks answer); the continuous wave's
# searches are all forced, by its missing_parser
SERVE_REQUESTS = ((0, SERVE_QUESTION, None),
                  (1, SERVE_QUESTION, SERVE_OPTIONS),
                  (2, SERVE_QUESTION + " (search)", None))
WAVE_REQUESTS = ((SERVE_QUESTION + " (wave 0)", SERVE_OPTIONS),
                 (SERVE_QUESTION + " (wave 1)", None),
                 (SERVE_QUESTION + " (wave 2)", SERVE_OPTIONS))
FORCED_SEARCH = dict(confidence_high=2.0, target_cue_threshold=-1.0,
                     target_cue_threshold_minimum=-1.0)


def serve_image(i: int, size=(768, 1024)):
    """Request i's image: seeded noise over colour ramps."""
    from PIL import Image
    h, w = size
    rng = np.random.RandomState(SEED + 200 + i)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([xx / w, yy / h, 0.5 + 0.5 * np.sin(xx / 97.0)], -1)
    img = 200 * base + 55 * rng.rand(h, w, 3)
    return Image.fromarray(img.clip(0, 255).astype(np.uint8))


class MarkedTrigger:
    """A VQA engine whose first answer to a question marked '(search)' is
    the search trigger for 'red mug' (random weights never emit it), and
    whose free-form decodes stop at SERVE_TOKENS new tokens. The focused
    re-answer is the engine's own.
    events: a list that receives ("decode", {"texts", "n", "trace"}) for
    each free_form, its decode traced on the host (the engine's
    decode_trace, eager loop; the trace's tensors on the CPU)."""

    def __init__(self, engine, events=None):
        self.engine = engine
        self.events = events

    def __getattr__(self, name):
        return getattr(self.engine, name)

    @staticmethod
    def _trigger(question, answer):
        from ..eval.seal import FOCUS_MSG, MISSING_OBJECTS_MSG
        if "(search)" in question and FOCUS_MSG not in question:
            return MISSING_OBJECTS_MSG + " red mug."
        return answer

    def free_form(self, image, question, **kw):
        kw.setdefault("max_new_tokens", SERVE_TOKENS)
        if self.events is None:
            return self._trigger(question, self.engine.free_form(
                image, question, **kw))
        self.engine.decode_trace = []
        answer = self.engine.free_form(image, question, **kw)
        trace = [(s.cpu(), lg.cpu()) for s, lg in self.engine.decode_trace]
        self.engine.decode_trace = []
        self.events.append(("decode", {
            "texts": [answer], "trace": trace,
            "n": [self.engine.last_decode_stats["tokens"]]}))
        return self._trigger(question, answer)

    def free_form_many(self, images, questions, **kw):
        kw.setdefault("max_new_tokens", SERVE_TOKENS)
        return [self._trigger(q, a) for q, a in zip(
            questions, self.engine.free_form_many(images, questions, **kw))]


class forced_searches:
    """A context in which every search of the SEAL paths (eval/seal's
    seal_answer, eval/batched_bench's run_search_phase) runs FORCED_SEARCH
    for 3 steps: on random weights a root patch can hold hundreds of
    boxes, whose crops no prompt bucket holds.
    events: a list that receives ("search", the visited steps) for each
    search, in task order."""

    def __init__(self, events=None):
        self.events = events

    def __enter__(self):
        from ..eval import batched_bench, seal
        self._mods = [(m, m.run_grouped_searches)
                      for m in (batched_bench, seal)]
        orig = self._mods[0][1]

        def run(engine, tasks, **kw):
            if self.events is not None:
                tasks = [dict(t, path_out=[]) for t in tasks]
            out = orig(engine, tasks, **{**kw, **FORCED_SEARCH,
                                         "max_steps": 3})
            if self.events is not None:
                self.events.extend(("search", t["path_out"]) for t in tasks)
            return out
        for m, _ in self._mods:
            m.run_grouped_searches = run
        return self

    def __exit__(self, *exc):
        for m, f in self._mods:
            m.run_grouped_searches = f


def serving_pair(dirs, mesh, device, vocab_size, configs=None, flags=()):
    """The server's checkpoint_engines on HF directories dirs["vqa"],
    dirs["vsm"] with --mesh `mesh` (None: unsharded) on `device` and the
    server's engine `flags` (e.g. --int4mix), the stub tokenizer, the
    VSM's searches decoding SERVE_TOKENS; `configs` (vqa, vsm) in place
    of the configs config.json names (the tiny models' CPU rehearsal)."""
    import argparse
    from ..core import hf_config
    from ..multimodal.stub_tokenizer import StubTokenizer
    from ..serve import server
    p = argparse.ArgumentParser()
    server.add_engine_flags(p)
    args = p.parse_args(["--vqa-model-path", dirs["vqa"],
                         "--vsm-model-path", dirs["vsm"],
                         "--device", str(device), *flags]
                        + ([] if mesh is None else ["--mesh", mesh]))
    saved = (hf_config.vqa_llm_config_for, hf_config.vsm_config_for)
    if configs is not None:
        hf_config.vqa_llm_config_for = lambda path: configs[0]
        hf_config.vsm_config_for = lambda path: configs[1]
    try:
        vqa, vsm = server.checkpoint_engines(
            args, tokenizer=StubTokenizer(vocab_size))
    finally:
        hf_config.vqa_llm_config_for, hf_config.vsm_config_for = saved
    vsm.max_new_tokens = SERVE_TOKENS
    return vqa, vsm


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def http_records(service, device, requests=SERVE_REQUESTS):
    """The (image index, question, options) requests one after another
    over HTTP to make_server(service) on port 0: (records without
    latency_s, client seconds each)."""
    import base64
    import io
    import threading
    import urllib.error
    import urllib.request
    from ..serve.server import make_server
    httpd = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    recs, secs = [], []
    try:
        for i, question, options in requests:
            buf = io.BytesIO()
            serve_image(i).save(buf, format="PNG")
            body = json.dumps({"image": base64.b64encode(
                buf.getvalue()).decode(), "question": question,
                "options": options}).encode()
            req = urllib.request.Request(
                f"http://127.0.0.1:{httpd.server_address[1]}/v1/answer",
                data=body, headers={"Content-Type": "application/json"})
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(req, timeout=600) as r:
                    status, rec = r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                status, rec = e.code, e.read().decode(errors="replace")
            _sync(device)
            secs.append(time.perf_counter() - t0)
            if status != 200:
                raise RuntimeError(f"request {i}: HTTP {status}: {rec}")
            rec.pop("latency_s", None)
            recs.append(rec)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    return recs, secs


def continuous_records(vqa, vsm, ranks, device, requests=WAVE_REQUESTS,
                       stagger_s: float = 0.05):
    """The requests to a ContinuousSealService (searches forced by its
    missing_parser, 3 steps) at once, one thread each started stagger_s
    apart inside one window, so that they form one wave in this order:
    (records without latency_s, seconds each, the service's stats)."""
    import threading
    from ..serve.continuous import ContinuousSealService
    svc = ContinuousSealService(MarkedTrigger(vqa), vsm, ranks=ranks,
                                max_search_steps=3,
                                max_batch=len(requests), window_ms=3000.0,
                                missing_parser=lambda p: ["red mug"],
                                search_kwargs=FORCED_SEARCH)
    recs, secs, errors = [None] * len(requests), [None] * len(requests), []

    def go(i):
        t0 = time.perf_counter()
        try:
            rec = svc.answer(serve_image(10 + i), *requests[i])
            rec.pop("latency_s", None)
            recs[i] = rec
        except Exception as e:   # reported below
            errors.append(f"request {i}: {type(e).__name__}: {e}")
        secs[i] = time.perf_counter() - t0

    threads = []
    try:
        for i in range(len(requests)):
            threads.append(threading.Thread(target=go, args=(i,)))
            threads[-1].start()
            time.sleep(stagger_s)
        for t in threads:
            t.join(timeout=600)
        _sync(device)
        stats = svc.stats()
    finally:
        svc.close()
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"continuous requests failed or hang: {errors}")
    return recs, secs, stats


def _kernel_counts():
    from ..kernels import flash_attention as fa
    from ..kernels import tower_attention as ta
    return {"flash_attention": (fa.launches, fa.plain_calls_cuda),
            "tower_attention": (ta.launches, ta.plain_calls_cuda)}


def _quant_kernel_counts():
    """K3's and K5's (launches, plain-version calls on CUDA)."""
    from ..kernels import int4_matmul as i4
    from ..kernels import int8_matmul as i8
    return {"int8_matvec": (i8.launches, i8.plain_calls_cuda),
            "int4_matmul": (i4.launches["int4_matmul"],
                            i4.plain_calls_cuda["int4_matmul"])}


def _w4a8_kernel_counts():
    """K6's and its row quantization's (launches, plain-version calls on
    CUDA): the act-int8 route of int4 entries."""
    from ..kernels import int4_matmul as i4
    return {k: (i4.launches[k], i4.plain_calls_cuda[k])
            for k in ("int4_matmul_w4a8", "quantize_rows")}


def _rank_counts():
    """This process's counts a rank reports: K1 / K2 (launches,
    plain-version calls on CUDA), K1's launches by query heads, K7's
    calls and K2's launches by heads, K3 / K5 and K6 / its row
    quantization (launches, plain calls on CUDA), the mesh's collectives by
    (operation, axis), those of them that fetched decoder layers
    (core/mesh.fetch_collectives), and the model splits' and the hidden
    split's by (site, operation, phase)."""
    from ..core import mesh as M
    from ..kernels import flash_attention as fa
    from ..kernels import tower_attention as ta
    return {"kernels": _kernel_counts(),
            "quant_kernels": _quant_kernel_counts(),
            "w4a8_kernels": _w4a8_kernel_counts(),
            "k1_heads": dict(fa.launches_by_heads),
            "k7_heads": dict(fa.bwd_launches_by_heads),
            "k2_heads": dict(ta.launches_by_heads),
            "collectives": {f"{op} {ax}": n for (op, ax), n in
                            M.collectives.items()},
            "fetch_collectives": {f"{op} {ax}": n for (op, ax), n in
                              M.fetch_collectives.items()},
            "model_collectives": {" ".join(k): n for k, n in
                                  M.model_collectives.items()},
            "hidden_collectives": {" ".join(k): n for k, n in
                                   M.hidden_collectives.items()}}


def _counts_delta(before, after):
    """What the _rank_counts grew by (the dicts' unchanged keys left
    out)."""
    k = {kind: {name: [after[kind][name][i] - before[kind][name][i]
                       for i in range(2)] for name in after[kind]}
         for kind in ("kernels", "quant_kernels", "w4a8_kernels")}
    d = {key: {name: n - before[key].get(name, 0)
               for name, n in after[key].items()
               if n != before[key].get(name, 0)}
         for key in ("k1_heads", "k7_heads", "k2_heads", "collectives",
                     "fetch_collectives", "model_collectives",
                     "hidden_collectives")}
    return {**k, **d}


def _cache_report(engine) -> dict:
    """An engine's KV caches: the bytes of all its slabs, of each slab,
    the caches' KV heads and the largest cache's shape."""
    caches = engine.graphs._caches.values()
    return {"slab_bytes": engine.graphs.cache_bytes(),
            "slabs": sorted(engine.graphs._bytes(t)
                            for t in engine.graphs._slabs.values()),
            "kv_heads": sorted({c.k.shape[3] for c in caches}),
            "largest_cache": max((list(c.k.shape) for c in caches),
                                 key=lambda s: int(np.prod(s)),
                                 default=None)}


def _serve_rank(rank, world, store, out_path, dirs, device, vocab_size,
                configs, requests, mesh, flags, act_int8):
    """One rank of gloo_serve."""
    from ..nn.quant import set_act_int8
    from ..serve import ranks as R
    from ..serve.server import SealService
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        _gloo_cuda_collectives()
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        t0 = time.perf_counter()
        vqa, vsm = serving_pair(dirs, mesh, dev, vocab_size, configs,
                                flags)
        load_s = time.perf_counter() - t0
        # gloo's collectives on CUDA tensors go through the host, which a
        # CUDA graph cannot capture: decode by the engines' traced loop
        for e in (vqa, vsm):
            e.decode_trace = []
        set_act_int8(act_int8)
        ranks = R.for_engines(vqa, vsm)
        events = [] if ranks.leader else None
        svc = SealService(MarkedTrigger(vqa, events), vsm, ranks=ranks)
        before = _rank_counts()
        if not ranks.leader:
            with forced_searches():
                R.follow(svc, ranks)
        else:
            try:
                with forced_searches(events):
                    recs, secs = http_records(svc, dev, requests)
            finally:
                ranks.stop()
        report = {"rank": rank, "load_s": load_s,
                  "counts": _counts_delta(before, _rank_counts()),
                  "caches": {"vqa": _cache_report(vqa),
                             "vsm": _cache_report(vsm)}}
        if ranks.leader:
            report.update(
                records=recs, seconds=secs, events=events,
                stack_sharded=type(vqa.params["llama"]["layers"][
                    "input_norm"]["scale"]).__name__)
        torch.save(report, f"{out_path}.rank{rank}")
    finally:
        set_act_int8(False)
        dist.destroy_process_group()


def gloo_serve(dirs, vocab_size: int, device: str = "cuda:0",
               configs=None, world: int = 2,
               requests=SERVE_REQUESTS[2:], mesh=None, flags=(),
               act_int8: bool = False) -> dict:
    """Parts (d3) and (d4): `world` ranks over gloo on one device (spawned
    processes) load the pair from `dirs` with --mesh `mesh` (default
    1x{world}x1) and the server's engine `flags` (serving_pair), with the
    act-int8 switch set to `act_int8` on every rank; rank 0
    answers `requests` (by default the forced
    search: gloo carries each collective through the host) over HTTP and
    the others follow. -> rank 0's records, client seconds, load seconds,
    K1 / K2 launches and plain-version calls on CUDA over the requests
    ("counts"), its decodes and searches in order ("events":
    MarkedTrigger's and forced_searches'), and "ranks": every rank's
    counts (K1's launches by heads, K3's and K5's launches, K6's and its
    row quantization's, the collectives by operation and axis) and KV
    caches (_cache_report). Any
    failure of a rank fails the call."""
    import torch.multiprocessing as mp
    mesh = mesh or f"1x{world}x1"
    with tempfile.TemporaryDirectory() as work:
        out = os.path.join(work, "result")
        mp.start_processes(_serve_rank, args=(world, os.path.join(
            work, "store"), out, dirs, device, vocab_size, configs,
            requests, mesh, tuple(flags), act_int8),
            nprocs=world, start_method="spawn")
        ranks = [torch.load(f"{out}.rank{r}", weights_only=False)
                 for r in range(world)]
    lead = ranks[0]
    return {"records": lead["records"], "seconds": lead["seconds"],
            "load_s": lead["load_s"], "events": lead["events"],
            "stack_sharded": lead["stack_sharded"],
            "counts": lead["counts"]["kernels"],
            "ranks": [{k: r[k] for k in ("rank", "counts", "caches")}
                      for r in ranks]}


def _tree_bytes(tree) -> int:
    """The bytes a rank holds of a tree (a DTensor's local shard)."""
    from torch.distributed.tensor import DTensor
    from ..core.params import leaves_with_path
    return sum((x.to_local() if isinstance(x, DTensor) else x).nbytes
               for _, x in leaves_with_path(tree))


def _device_breakdown(prof, wall_s: float, top: int = 12) -> dict:
    """Device time of a profiled call by kernel (torch.profiler's CUDA
    activity, graph replays included where CUPTI reports them; the
    "nccl:..." annotations, ranges over NCCL's kernels, left out): the
    total, the busy share of the call's wall time, the sums of NCCL's
    kernels, of the matmuls (cuBLAS's nvjet / gemv kernels, its split-K
    reductions) and of K1, and the `top` kernels by their own device
    time (ms, calls)."""
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.self_device_time_total > 0 and e.device_type is not None
            and "CUDA" in str(e.device_type)
            and not e.key.startswith("nccl:")]
    total = sum(ms for _, ms, _ in rows)

    def share(*words):
        return sum(ms for k, ms, _ in rows
                   if any(w in k.lower() for w in words))
    rows.sort(key=lambda r: -r[1])
    return {"device_ms": total, "wall_ms": wall_s * 1e3,
            "busy": total / (wall_s * 1e3) if wall_s else None,
            "nccl_ms": share("nccl"),
            "matmul_ms": share("nvjet", "gemm", "gemv", "splitkreduce"),
            "copy_ms": share("memcpy"),
            "k1_ms": share("flash_split", "flash_tile", "flash_combine"),
            "top": [[k, ms, n] for k, ms, n in rows[:top]]}


def kernel_overlap(trace_file: str, op: str = "broadcast") -> dict:
    """From a chrome trace of torch.profiler: the device time of NCCL's
    `op` kernels and the part of it during which a kernel that is not
    NCCL's ran too (on another stream: the layer's compute behind a
    fetch in flight): {"kernels", "ms", "overlapped_ms", "share"}."""
    import bisect
    import gzip
    opener = gzip.open if trace_file.endswith(".gz") else open
    with opener(trace_file, "rt") as f:
        events = json.load(f)["traceEvents"]
    kernels = [(e["ts"], e["ts"] + e["dur"], e["name"].lower())
               for e in events if e.get("cat") == "kernel" and "dur" in e]
    comm = [(a, b) for a, b, n in kernels if "nccl" in n and op in n]
    merged = []
    for a, b, _ in sorted(k for k in kernels if "nccl" not in k[2]):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    starts = [m[0] for m in merged]
    total = over = 0.0
    for a, b in comm:
        total += b - a
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(merged) and merged[i][0] < b:
            over += max(0.0, min(b, merged[i][1]) - max(a, merged[i][0]))
            i += 1
    return {"kernels": len(comm), "ms": total / 1e3,
            "overlapped_ms": over / 1e3,
            "share": over / total if total else None}


def _host_breakdown(prof, top: int = 20) -> list:
    """The `top` host operations of a profiled call by their own host
    time: [name, ms, calls] (where the host's time goes between the
    device's kernels: dispatch, copies enqueued, synchronisations)."""
    rows = [(e.key, e.self_cpu_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.self_cpu_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    return [[k, ms, n] for k, ms, n in rows[:top]]


def _engine_check(mesh, dev, tokens: int, trace: bool = False) -> dict:
    """A sharded random-init 7B VQA engine's greedy free-form answer of
    `tokens` new tokens (graph decode) against the one-device engine's,
    on every rank: whether they are equal; per engine the first call's
    seconds (it captures the graphs), a replayed call's seconds, the
    decode's ms per token by graph replay (the `tokens` call less the
    1-token call, over tokens - 1), its forwards; for the sharded engine
    the bytes of its weights on this rank and of its KV slabs, K1's
    launches by query heads and the mesh's collectives in the replayed
    call (those that fetched layers, and the hidden split's by site), the
    plan of its bytes (core/memory.plan_engine_memory) and the card's
    allocated and peak bytes. trace: each engine's replayed call once
    more under torch.profiler (`_device_breakdown`; rank 0 writes the
    sharded engine's chrome trace)."""
    from PIL import Image
    from ..core import mesh as M
    from ..core.config import vqa_llm_7b
    from ..core.memory import plan_engine_memory
    from ..eval.vqa_engine import VQAEngine
    from ..models.vqa_llm import init_vqa_llm_params
    from ..multimodal.stub_tokenizer import StubTokenizer
    cfg = vqa_llm_7b()
    tok = StubTokenizer(cfg.llama.vocab_size)
    params = init_vqa_llm_params(SEED, cfg, device=dev, dtype=torch.bfloat16)
    plan = plan_engine_memory(params, mesh, cfg.llama.hidden_size)
    img = Image.fromarray((np.random.RandomState(0).rand(336, 336, 3)
                           * 255).astype("uint8"))
    q = "What is on the table?"
    sharded = VQAEngine(params, cfg, tok, device=dev,
                        prompt_buckets=(512, 768), mesh=mesh)
    one = VQAEngine(params, cfg, tok, device=dev, prompt_buckets=(512, 768))
    del params

    def timed(e, n):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        answer = e.free_form(img, q, max_new_tokens=n)
        torch.cuda.synchronize(dev)
        return answer, time.perf_counter() - t0

    out = {"tokens": tokens}
    answers = []
    for name, e in (("one_device", one), ("sharded", sharded)):
        e._spec_template = None     # plain greedy
        _, first_s = timed(e, tokens)
        timed(e, 1)                 # captures the 1-token decode
        before = _rank_counts()
        answer, s = timed(e, tokens)
        stats = dict(e.last_decode_stats)
        delta = _counts_delta(before, _rank_counts())
        _, one_s = timed(e, 1)
        answers.append(answer)
        if trace:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                _, traced_s = timed(e, tokens)
            breakdown = _device_breakdown(prof, traced_s)
            if e is sharded and M.is_main_process():
                os.makedirs("chiprun_out", exist_ok=True)
                breakdown["file"] = ("chiprun_out/mesh_probe_" + "x".join(
                    map(str, mesh.dims)) + "_decode.json.gz")
                prof.export_chrome_trace(breakdown["file"])
        out[name] = {"first_s": first_s, "seconds": s,
                     "decode_ms_per_token": (s - one_s) / (tokens - 1) * 1e3,
                     "one_token_s": one_s, "forwards": stats["forwards"],
                     "generated": stats["tokens"],
                     "graphs_captured": e.graphs.captures}
        if trace:
            out[name]["trace"] = breakdown
        if e is sharded:
            out[name].update(
                weight_bytes=_tree_bytes(e.params),
                kv=_cache_report(e),
                plan_bytes={"stack": plan.stack_bytes,
                            "other": plan.other_bytes},
                k1_heads=delta["k1_heads"],
                collectives=delta["collectives"],
                fetch_collectives=delta["fetch_collectives"],
                hidden_collectives=delta["hidden_collectives"],
                allocated_bytes=torch.cuda.memory_allocated(dev),
                peak_bytes=torch.cuda.max_memory_allocated(dev))
    out["equal"] = answers[0] == answers[1]
    out["answers"] = answers
    return out


def _state_sums(state) -> Dict[str, float]:
    """Each leaf of a TrainState's global tree (train_vsm_main's
    global_state: parameters, masters and moments as the mesh places
    them) -> the sum of its whole tensor in f64, from the ranks' shards
    (each divided by the number of ranks holding it), on every rank: a
    check that a read gave back what was written."""
    from torch.distributed.tensor import DTensor
    from ..core import mesh as M
    from ..core.params import leaves_with_path
    from ..train.train_vsm_main import global_state
    flat = [(p, x) for p, x in leaves_with_path(
        {"t": list(global_state(state))}) if isinstance(x, torch.Tensor)]
    parts = torch.stack([
        x.to_local().double().sum() / M.replica_count(x)
        if isinstance(x, DTensor) else x.double().sum() / M.world_size()
        for _, x in flat])
    dist.all_reduce(parts)
    return {p: float(v) for (p, _), v in zip(flat, parts.tolist())}


def _empty_state(meta, mesh, opt, dev):
    """The finetune's TrainState on `mesh` with uninitialised parameters
    (each rank allocates its shards only): a checkpoint's template."""
    from torch.distributed.tensor import DTensor
    from ..core import mesh as M
    from ..core.params import map_with_path
    from ..train.sft import init_train_state
    params = map_with_path(
        lambda _, x: M.with_local(x, torch.empty(
            x.to_local().shape, dtype=x.dtype, device=dev))
        if isinstance(x, DTensor) else x, M.shard_params(meta, mesh))
    return init_train_state(params, opt)


def checkpoint_check(held, opt, meta, mesh, dev, read_meshes, work
                     ) -> dict:
    """The finetune's TrainState (the one item of `held`, taken out so
    that the state is freed before the reads) written on `mesh`
    (train_vsm_main.save_state, every rank its pieces, into `work`) and
    read back on each of `read_meshes` (load_state into a template of
    that mesh): GB
    written, seconds and GB/s of each direction, each read's peak device
    memory, and whether every leaf's sum equals the written one's (f64
    sums of the same elements over other shards: within 1e-9
    relative)."""
    from ..core import mesh as M
    from ..train.sft import TrainState
    from ..train.train_vsm_main import load_state, save_state
    path = os.path.join(work, "state")
    state = held.pop()
    written = _state_sums(state)
    torch.cuda.synchronize(dev)
    dist.barrier()
    t0 = time.perf_counter()
    save_state(state, path, mesh)
    seconds = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(path, f))
                 for f in os.listdir(path))
    out = {"write": {"mesh": list(mesh.dims), "bytes": nbytes,
                     "seconds": seconds, "gb_per_s": nbytes / seconds / 1e9}}
    del state
    gc.collect()
    torch.cuda.empty_cache()
    out["reads"] = []
    for shape in read_meshes:
        other = M.make_mesh(shape, dev.type)
        like = _empty_state(meta, other, opt, dev)
        torch.cuda.synchronize(dev)
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        dist.barrier()
        t0 = time.perf_counter()
        got = load_state(TrainState, path, like, dev, other)
        torch.cuda.synchronize(dev)
        dist.barrier()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        del like
        sums = _state_sums(got)
        far = max(abs(sums[p] - v) / max(abs(v), 1e-30)
                  for p, v in written.items())
        out["reads"].append({
            "mesh": list(shape), "seconds": seconds,
            "gb_per_s": nbytes / seconds / 1e9,
            "state_bytes": before, "peak_bytes": peak,
            "equal": sums.keys() == written.keys() and far <= 1e-9,
            "largest_relative_sum_difference": far})
        del got
        gc.collect()
        torch.cuda.empty_cache()
    return out


def main() -> int:
    p = argparse.ArgumentParser(__doc__.split("\n")[0])
    p.add_argument("--mesh", default=None)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--layers", type=int, default=None,
                   help="decoder layers (default: the 7B config's 32); "
                        "16 on one card holds a 1x2x1 card's state")
    p.add_argument("--engine", action="store_true")
    p.add_argument("--engine-tokens", type=int, default=32)
    p.add_argument("--serve-only", action="store_true",
                   help="no finetune: the engine check alone")
    p.add_argument("--checkpoint", default=None, metavar="MESHES",
                   help="after the steps, write the TrainState (one "
                        "checkpoint of global tensors, in a temporary "
                        "directory under --checkpoint-dir) and read it "
                        "back on each of these meshes (comma-separated "
                        "DxFxM), with bytes, seconds, GB/s and the read's "
                        "peak memory")
    p.add_argument("--checkpoint-dir", default=None,
                   help="where the checkpoint is written (default: the "
                        "system's temporary directory)")
    p.add_argument("--trace", action="store_true",
                   help="the engine check's calls once more, or one more "
                        "training step, under torch.profiler: device time "
                        "by kernel (rank 0 writes the step's trace, and "
                        "reads from it how much of the layer broadcasts' "
                        "device time overlapped compute)")
    p.add_argument("--one-rank", action="store_true",
                   help="no torchrun: chip_smoke.py's part (a) alone, the "
                        "7B VQA pretrain on a world of one NCCL rank "
                        "(1x1x1) against one device, --steps steps each "
                        "(with --trace one more, traced)")
    p.add_argument("--micro", type=int, default=MICRO,
                   help="micro-batches a step (1: the gradients in the "
                        "leaves' dtype, no f32 buffers)")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("mesh_probe: no CUDA device", file=sys.stderr)
        return 1
    if args.one_rank:
        a = one_rank_mesh(torch.device("cuda", 0), steps=args.steps,
                          trace=args.trace)
        a["device"] = torch.cuda.get_device_name(0)
        line = json.dumps({"one_rank_mesh": a})
        print(line, flush=True)
        os.makedirs("chiprun_out", exist_ok=True)
        with open("chiprun_out/mesh_probe_one_rank.json", "w") as f:
            f.write(line + "\n")
        same = all(a["equal_loss_and_norm"]) and \
            all(a["equal_trainable_leaves"].values())
        return 0 if same else 1
    from ..core import mesh as M
    from ..core.config import vqa_llm_7b
    from ..core.memory import check_memory, device_memory_gb, \
        plan_train_memory, step_memory
    from ..data.vsm_collate import batch_to_torch
    from ..models.vqa_llm import init_vqa_llm_params
    from ..multimodal.stub_tokenizer import StubTokenizer
    from ..train.sft import init_train_state, make_optimizer
    from ..train.train_vqa_main import frozen_vision_mask
    dev = M.rank_device("cuda")
    mesh = M.resolve_mesh(args.mesh, dev)
    if mesh is None:
        print("mesh_probe: start it with torchrun", file=sys.stderr)
        return 1
    main_rank = M.is_main_process()
    if args.serve_only:
        report = {"mesh": list(mesh.dims), "rank": M.rank(),
                  "device": torch.cuda.get_device_name(dev)}
        try:
            report["engine"] = _engine_check(mesh, dev, args.engine_tokens,
                                             args.trace)
        except Exception as e:  # recorded, and the run fails below
            report["engine"] = {"error": f"{type(e).__name__}: {e}"}
        return _report(_gather_reports(report), main_rank)
    cfg = vqa_llm_7b()
    if args.layers:
        cfg = dataclasses.replace(cfg, llama=dataclasses.replace(
            cfg.llama, num_layers=args.layers))
    tok = StubTokenizer(cfg.llama.vocab_size)
    meta = init_vqa_llm_params(0, cfg, device="meta", dtype=torch.bfloat16)
    mask = frozen_vision_mask(meta)
    plan = plan_train_memory(meta, mesh, trainable_mask=mask)
    step = step_memory(meta, mesh, trainable_mask=mask,
                       num_micro=args.micro)
    check_memory(plan, device_memory_gb(dev), step=step,
                 what=f"7B VQA finetune (mesh {mesh})")
    t0 = time.perf_counter()
    params = M.shard_params(init_vqa_llm_params(SEED, cfg, device=dev,
                                                dtype=torch.bfloat16), mesh)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    opt = make_optimizer(2e-5, warmup_steps=1, total_steps=args.steps + 1,
                         trainable_mask=mask, master_f32=True)
    state = init_train_state(params, opt)
    del params
    torch.cuda.synchronize(dev)
    state_bytes = torch.cuda.memory_allocated(dev)
    batch = batch_to_torch(finetune_rows(cfg, tok), dev)
    with phase_peaks(dev) as peaks:
        steps = []
        for _ in range(args.steps):
            before = _rank_counts()
            state, one, _ = _steps(state, batch, cfg, opt, mask, 1, dev,
                                   micro=args.micro)
            step_counts = _counts_delta(before, _rank_counts())
            peaks.read_update()
            steps += one
    peak = max(peaks.grads + peaks.update)
    trace = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state, one, _ = _steps(state, batch, cfg, opt, mask, 1, dev,
                                   micro=args.micro)
        trace = _device_breakdown(prof, one[0][2])
        if main_rank:
            os.makedirs("chiprun_out", exist_ok=True)
            name = "x".join(map(str, mesh.dims))
            trace["file"] = f"chiprun_out/mesh_probe_{name}_step.json.gz"
            prof.export_chrome_trace(trace["file"])
            trace["broadcast_overlap"] = kernel_overlap(trace["file"])
    report = {"mesh": list(mesh.dims), "rank": M.rank(),
              "layers": cfg.llama.num_layers,
              "device": torch.cuda.get_device_name(dev),
              "plan_bytes": plan.total_bytes,
              "plan_state_bytes": plan.params_bytes + plan.master_bytes
              + plan.moments_bytes, "step_accum_bytes": step.accum_bytes,
              "step_largest_grad_bytes": step.largest_grad_bytes,
              "step_prefetch_bytes": getattr(step, "prefetch_bytes", None),
              "state_bytes": state_bytes,
              "peak_bytes": peak, "grads_peak_bytes": peaks.grads,
              "update_peak_bytes": peaks.update,
              "alloc_conf": os.environ.get("PYTORCH_CUDA_ALLOC_CONF"),
              "init_s": init_s, "steps": steps,
              "step_counts": step_counts, "trace": trace,
              "rows": ROWS, "seq": SEQ, "micro": args.micro}
    if args.checkpoint:
        from ..core.memory import parse_mesh_arg
        shapes = [parse_mesh_arg(m, M.world_size())
                  for m in args.checkpoint.split(",")]
        work = tempfile.mkdtemp(dir=args.checkpoint_dir) \
            if main_rank else None
        shared = [work]
        dist.broadcast_object_list(shared)
        try:
            held, state = [state], None
            report["checkpoint"] = checkpoint_check(
                held, opt, meta, mesh, dev, shapes, shared[0])
        finally:
            dist.barrier()
            if main_rank:
                shutil.rmtree(shared[0], ignore_errors=True)
    if args.engine:
        del state, opt
        torch.cuda.empty_cache()
        try:
            report["engine"] = _engine_check(mesh, dev, args.engine_tokens)
        except Exception as e:  # recorded, and the run fails below
            report["engine"] = {"error": f"{type(e).__name__}: {e}"}
    return _report(_gather_reports(report), main_rank)


def _gather_reports(report) -> list:
    """Every rank's report, on every rank; then leaves the group."""
    from ..core import mesh as M
    reports = [None] * M.world_size()
    dist.all_gather_object(reports, report)
    dist.destroy_process_group()
    return reports


def _report(reports, main_rank) -> int:
    """Rank 0 prints the reports as one JSON line and writes them to a
    file per mesh (module docstring); 1 if an engine check failed, or
    on a mesh whose fsdp and model axes are 1 answered otherwise than
    the one-device engine (a bf16 engine split on the hidden or the model
    axis sums its products in another order: its answer is recorded)."""
    if main_rank:
        line = json.dumps({"mesh_probe": reports})
        print(line, flush=True)
        os.makedirs("chiprun_out", exist_ok=True)
        name = "x".join(map(str, reports[0]["mesh"]))
        with open(f"chiprun_out/mesh_probe_{name}.json", "w") as f:
            f.write(line + "\n")
    ok = all("error" not in r.get("engine", {}) and (
        r.get("engine", {"equal": True}).get("equal", False)
        or r["mesh"][1] > 1 or r["mesh"][2] > 1) for r in reports)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
