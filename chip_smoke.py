"""Chip smoke for the PyTorch / H100 port (vstar_tpu_torch).

Runs on one CUDA card, in phases; any failure exits non-zero:
  1. card and versions;
  2. build the CUDA kernels from vstar_tpu_torch/csrc (one nvcc per
     source, in parallel), and log every K1/K7/K2 instantiation's, K3's,
     K5's (decode rows and tiles), K6's and P2-P4's registers, local
     (spill) bytes, shared memory and resident blocks per SM; the weight
     and activation quantizers on the card give numpy's bits;
  3. every kernel against its plain PyTorch version at the 7B shapes of
     the path: K1 flash attention (the verify chunk also at the lockstep
     wave batches 4 and 16), K2 tower attention (OWL-ViT at batches 1, 4,
     8 and 16, the wave buckets), the int8 matvec
     (K3/K4) at R in {1, 8, 16} and at R=1 on 4096x4096 and 11008x4096,
     with one launch per call; K5 (W4A16) at R in {1, 8, 16} (decode rows)
     and {17, 384, 768} (tiles), K6 (W4A8) at R in {1, 8, 16} on
     4096x11008 and at R=1 on 11008x4096 and 4096x4096 (the shapes the
     W4A8 gate sends it), with one launch and no workspace a call; K6's
     qdot on bf16 x (its row quantization bit-equal to
     quantize_activations, at most two kernels a call, read from its CUDA
     graph) and the row quantization alone; K5 also against its own
     arithmetic (bf16 weights above 16 rows) within its output's rounding,
     with one launch per call and its factor against tinygemm at R=1;
     each case is timed by device time (one CUDA
     graph of N launches over weight copies that exceed the L2 cache) and
     by CUDA events around single calls, beside its plain version, its
     bound and, where one PyTorch call computes the same function, that
     call timed the same two ways (a yardstick the port never calls); the act-int8 route of the
     int8 entries is timed beside the int8 kernel (log only);
  4. the bf16 path: the random-init 7B SEAL pair (both engines drafting
     from their templates) answers two requests through
     SealService.answer, one over HTTP, and one forced-search sample
     (free-form, 3-step guided search, focused option scoring); then the
     decode slice on the same resident pair, its counts read on their
     own: a free-form request over HTTP without options and a
     forced-search free-form flow; greedy, template, oracle (greedy's own
     tokens) and prompt-lookup decodes of one 2048x1536 free-form answer
     (200 tokens) and detection (100), each as the eager traced loop and
     by CUDA graph replay (decode/graphs.py; the replay's logits written
     on the device), the two held to each other (the same tokens and
     forwards, or a near-tie by the rule below), with decoder forwards,
     tokens per forward and ms per answer of both (the replay's after
     its capturing call), the oracle within ceil((n - 1) / 7) + 1
     forwards, and each drafted decode held to greedy by the card's
     equivalence rule (tokens equal up to a first difference, which must
     be a near-tie: its margin in greedy's logits below the largest
     |logit difference| of the two paths; every one logged);
     free_form_many at B = 4 against each row's free_form under the same
     rule (64 tokens a row); the synthetic V*Bench (one 1024x1024 image a task) through
     eval_model at the disclosed budgets 32/16; then the lockstep search
     on the same pair (the server's BatchedVSMEngine), its counts read
     after each part: (a) four forced 3-step searches on four 2048x1536
     noise images through run_batched_searches (waves of 4 rows) and
     through serial visual_search, the visited patches equal or parting
     first at a near-tie (the two patches' score margin below the largest
     difference of the two runs' values of those scores; every one
     logged), with wall times, waves and rows per wave; (b) a
     device-preprocess engine on the same weights: canvas windows against
     host preprocessing within JAX's content tolerances, detect_many on
     PatchRefs beside host patches, one prefetched forced search; (c) one
     sample with three missing objects through run_search_phase and the
     focused option scoring; (d) the synthetic V*Bench (two images a
     task) through eval_model_batched at image_batch 2, with images/s;
     after each part K1 and K2 launched at the wave's batch bucket
     (launches logged by shape); then the compiled search
     (search/compiled.CompiledVSMSearch) on a device-preprocess engine
     with the tilted VSM: warmup_compiled at the 2048x1536 canvas bucket
     (timed), four forced 3-step searches through `search` and through
     `search_many` at B = 4 against the lockstep path on the same engine
     (the compiled run's queued scores standing in for its heatmaps in
     the near-tie rule), and one untilted search whose weak heatmaps take
     the context cue inside its steps (no engine wave), with host reads
     per search; each decode-graph capture and static cache logged with
     its memory ("[graphs]"); then continuous serving on the same pair
     (serve/continuous.ContinuousSealService): eight concurrent HTTP
     requests on 2048x1536 noise, four with options and four free-form
     (16-token answers), the search forced through the service's
     missing_parser (3 steps) on the tilted device-preprocess VSM, by
     fresh engines without warmup (graphs captured live while the handler
     threads prefetch canvases), by engines warmed at this traffic's
     budgets (whose live requests must capture nothing) from the
     scheduler thread and with pipeline=True; every record held to serial
     SealService's on the same engines (the search path by the lockstep
     rule, the focused answer by the equivalence rule, the option by its
     losses' margin against their largest difference), with waves, mean
     and max wave, and wall and per-request latency p50 and max; then the
     int8 KV cache on the same weights: a greedy 200-token free-form
     answer and a forced 3-step search (tilted VSM), each by graph replay
     and eagerly, held to each other, each in a count window of its own;
     the answer against the bf16 cache's, decoded before any count is
     zeroed (its first differing token and margin logged), the cache
     slabs (the int8 one at most 0.55x the bf16 one), ms per token, and
     the plain dequantization's ms a decode step; then eval/phased.py's
     eval_model_phased on the synthetic V*Bench (one 1024x1024 image a
     task, force_missing, forced 3-step searches), swapped, co-resident
     and parked, the same records from all three, memory_allocated around
     every free_engine falling by at least the freed engine's weights,
     with the swap and phase timings and images/s;
  5. the quantized path (--int4mix: int8 VQA decoder, int4mix VSM decoder,
     int8 towers), after the bf16 pair is freed: one answer on 2048x1536,
     one forced-search sample, and one more with the act-int8 switch on;
     then the decode slice of 4, part (a) of the lockstep search, the
     compiled searches (without the context-cue search) and continuous
     serving (warmed engines only) on the --int4mix pair;
  6. after each path, every kernel it runs launched, and no plain version
     ran on a CUDA tensor; K1's launches by route (tile above 16 query
     rows, split at decode and verify, with its combine): the bf16 path
     takes both routes, training the tile route only, the decode slice
     the split route at 8 query rows (the verify chunks); K5's launches
     by route (decode rows, tiles) logged for every path;
  7. P1-P4, the int4 profile's kernels, against their plain versions at
     the 7B shapes: P1 (the lo-nibble unpack probe, both candidates,
     exact) on the packed w_gate [2048, 11008]; P2 (every lo-nibble
     unpack) and P4 (transposed storage) at R in {1, 8} on 4096x11008 and
     the 4096x32000 lm_head, P2 also at R=16 on 4096x11008 and at 512
     columns per block on 11008x4096; P3 (row blocks) at R in {1, 16} on
     11008x4096; P3 and P4 also held to K6 on the same product; timed as
     in 3, with the bound of the JAX CostEstimate's bytes;
  8. K1 with its log-sum-exp and the K7 backward at the training shape
     [4, 512, 32, 128] (ragged kv_lens, key holes, a row that sees no key)
     against their plain versions, timed as above (K7's library yardstick
     is SDPA's backward: by events, and by device time as one graph of
     forward + backward less one of the forward; K7's factor against it
     logged), K7 bit-identical from one launch to the next;
  9. the int4 profile path (vstar_tpu_torch.scripts.int4_profile, in
     process): --probe, a short --matmul (W4A8 off, rows and transposed at
     every 7B shape) and the full-7B --decode ablation (eight rows, ms per
     token by CUDA graph and by events), with exact launches per token
     for each row's route (under act-int8 the 32003-wide int4 lm_head
     takes K5, as the W4A8 gate sends it);
  10. the training path: the random-init seal_vsm_7b in bf16 with LoRA
     r=8, three vsm_train_steps of 8 rows (2 micro-batches of 4, 512-token
     bucket, 768 masks), with exact K1 / K7 / K2 launch counts per step,
     frozen leaves bit-identical and trainable ones moved; then
     run_vsm_training at the tiny config (decoder heads widened to the
     kernels' 128) over synthetic dataset files, with a resume;
  11. checkpoints in the HF layout: both random-init models at 7B widths
     with 2 decoder layers (the VSM tilted to answer [LOC]) exported in
     bf16 with config.json in shards of at most 1 GiB (seconds, GB/s),
     loaded by load_engines onto the card in bf16 and with
     int4='int4mix' (seconds, GB/s): the tensors equal the exported ones
     bit for bit (quantized: equal to quantizing them in memory), a
     free-form answer and a detection equal the in-memory pair's on the
     same weights and [LOC] id, K1 and K2 (and K3/K5/K6 under int4mix,
     K6 with act-int8) launched in each window; eval_model from the
     directories on two synthetic images, serial and
     --single-chip-phased without factories;
  12. the VQA trainer: three pretrain sft_train_steps of the random-init
     seal_vqa_7b at full depth (bf16, the f32 linear projector the only
     trainable leaf) on 8 rows (2 micro-batches of 4) at a 512-token
     bucket, and three finetune steps at 7B widths with 2 decoder layers
     (the tower frozen), with exact K1 (with its log-sum-exp) and K7
     launches per step, frozen leaves bit-identical, trainable ones
     moved, step times and peak memory; train_vqa_main refusing the full
     7B finetune by its memory check before allocating; run_training at
     tiny kernel widths with a resume;
  13. the mesh (core/mesh.py through scripts/mesh_probe.py): a world of
     one NCCL rank and the 1x1x1 mesh, every leaf a DTensor, two VQA
     pretrain steps at full 7B equal to the one-device steps bit for bit
     with the same K1 / K7 launches, and a sharded VSM engine's detection
     (7B widths, 2 decoder layers; decode graphs holding the mesh's
     collectives) equal to the unsharded engine's; the 7B finetune's
     plan per card at 1x1x1, 1x2x1, 1x4x1; two ranks over gloo on the
     card (7B widths, 2 decoder layers, 1x2x1): two finetune steps
     against the one-device steps, the second step's loss read after
     the first update; serving over the mesh (serve/ranks.py): the pair
     at 7B widths with 2 decoder layers exported to HF directories and
     loaded by the server's checkpoint_engines, served by one NCCL rank
     at 1x1x1 over HTTP and in a continuous wave of 3, then by two gloo
     ranks at 1x2x1 (rank 0 over HTTP, rank 1 following), every record
     equal to the unsharded server's, K1 and K2 counted per path; then
     two gloo ranks at 1x1x2, the decoder tensor-parallel (each rank's
     K1 on 16 of the 32 heads, half the KV slab, two all-reduces a
     layer over the model group) and the towers split (K2 on 6 of OWL's
     12 heads), the forced search's record against the unsharded
     server's by the near-tie rules; and before serving, training on the
     model axis: two gloo ranks at 1x1x2, finetune steps and a VSM step
     at 7B widths with 2 decoder layers against the one-device steps, K1
     and K7 at 16 heads, the model group's all-reduces per layer 2
     forward, 1 in the recompute, 2 backward.
Prints a JSON line of kernel results, then the card's name and power
limit, then (last line) the device record.

    python3 chip_smoke.py
"""

from __future__ import annotations

import base64
import dataclasses
import gc
import io
import json
import logging
import math
import os
import sys
import tempfile
import threading
import time
import types
import urllib.request

import numpy as np
import torch

from vstar_tpu_torch.utils.timing import (card_line, events_ms, graph_kernels,
                                          graph_ms)

TOL = 2e-2          # bf16 attention vs plain version (tests/test_vision.py:288)
LSE_TOL = 1e-3      # K1's log-sum-exp (f32) against the plain version
BF16_REL_TOL = 1e-2  # quantized matmuls, bf16 out: of the largest |output|
F32_REL_TOL = 1e-5   # K6, f32 out (exact integer group dots on both sides)
# K5 against its own arithmetic (int4_matmul_kernel_math): the error beyond
# the rounding of its bf16 output, of the largest |output|
K5_MATH_TOL = 1e-3
SEED = 0
# H100 SXM: HBM bytes/s and dense peak operations/s by operand type
# (NVIDIA data sheet, 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12}
L2_BYTES = 50 * 2**20
# Forced 3-step search regime (scripts/bench_common.py:16-17): accepts
# disabled, the target-cue split path pinned.
FORCED_SEARCH = dict(confidence_high=2.0, target_cue_threshold=-1.0,
                     target_cue_threshold_minimum=-1.0)


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, ops: float, kind: str):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[kind]
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


# ---------------------------------------------------------------------------
# Phases 1-2
# ---------------------------------------------------------------------------

def phase_device() -> str:
    smi = card_line()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} "
        f"device {torch.cuda.get_device_name(0)}")
    return smi


KERNEL_INFO = []


def log_kernel_info(tag, prefix):
    """Logs the build facts of the kernels whose names start with
    `prefix` (from phase_build's query)."""
    for i in KERNEL_INFO:
        if i["kernel"].startswith(prefix):
            log(f"[{tag}] {i['kernel']}: {i['registers']} registers, "
                f"{i['local_bytes']} local (spill) bytes, dynamic smem "
                f"{i['dynamic_smem']} B, {i['threads']} threads, "
                f"{i['blocks_per_sm']} resident blocks per SM")


def phase_build():
    from vstar_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    so = _build.build()
    _build.library()
    log(f"[build] {so.name} in {time.perf_counter() - t0:.1f} s")
    report = so.with_suffix(".log").read_text() \
        if so.with_suffix(".log").exists() else ""
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[build] {line.strip()}")
    from vstar_tpu_torch.kernels.flash_attention import attention_kernel_info
    from vstar_tpu_torch.kernels.int4_matmul import (int4_kernel_info,
                                                     w4a8_kernel_info)
    from vstar_tpu_torch.kernels.int4_variants import (variants_kernel_info,
                                                       w4a8_t_kernel_info)
    from vstar_tpu_torch.kernels.int8_matmul import int8_kernel_info
    info = (attention_kernel_info() + int8_kernel_info() + int4_kernel_info()
            + w4a8_kernel_info() + variants_kernel_info()
            + w4a8_t_kernel_info())
    for i in info:
        log(f"[build] {i['kernel']}: {i['registers']} registers, "
            f"{i['local_bytes']} local (spill) bytes, static smem "
            f"{i['static_smem']} B, dynamic smem {i['dynamic_smem']} B, "
            f"{i['threads']} threads, {i['blocks_per_sm']} resident blocks "
            f"per SM")
    KERNEL_INFO[:] = info
    return info


def phase_quantizers(dev):
    """The quantizers that run on the card when the server quantizes its
    weights there (quantize_weight, quantize_weight_int4) and _w8a8_dot's
    row quantization give numpy's bits (IEEE division, as JAX divides):
    a 4096x11008 weight and a [256, 4096] activation from the seed."""
    from vstar_tpu_torch.nn import quant
    rng = np.random.RandomState(SEED + 9)
    w = (rng.randn(4096, 11008) * 0.02).astype(np.float32)
    wd = torch.from_numpy(w).to(dev)
    pairs = [("quantize_weight", quant.quantize_weight(wd),
              quant.quantize_weight_np(w)),
             ("quantize_weight_int4", quant.quantize_weight_int4(wd),
              quant.quantize_weight_int4_np(w))]
    x = rng.randn(256, 4096).astype(np.float32)
    xq, sx = quant.w8a8_quantize(torch.from_numpy(x).to(dev))
    s_np = np.maximum(np.abs(x).max(axis=-1, keepdims=True) / 127.0,
                      np.float32(1e-8)).astype(np.float32)
    pairs.append(("w8a8_quantize", {"q": xq, "s": sx},
                  {"q": np.clip(np.round(x / s_np), -127, 127)
                   .astype(np.int8), "s": s_np}))
    for name, got, want in pairs:
        for k, v in want.items():
            diff = int((got[k].cpu().numpy() != v).sum())
            log(f"[quantizers] {name} {k}: {diff} of {v.size} differ from "
                "numpy's bits")
            if diff:
                raise AssertionError(f"{name} {k}: {diff} values off numpy")


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _k1_cases(gen, dev):
    H, D = 32, 128

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=torch.float32).to(torch.bfloat16)

    def ints(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    cases = []
    # prefill: bucket 512 over a 768-slot cache, 300 valid tokens
    cases.append(("prefill", dict(q=rnd(1, 512, H, D), k=rnd(1, 768, H, D),
                                  v=rnd(1, 768, H, D), kv_lens=ints([300]),
                                  q_offsets=ints([0]))))
    # decode: one token at position 300, K/V read in place from one layer
    # of a [L, B, S_max, H, D] cache
    ck, cv = rnd(2, 1, 768, H, D), rnd(2, 1, 768, H, D)
    cases.append(("decode", dict(q=rnd(1, 1, H, D), k=ck[1], v=cv[1],
                                 kv_lens=ints([301]), q_offsets=ints([300]))))
    # verify-width chunk, ragged offsets; q is a strided slice of a fused
    # [B, S, 3, H, D] projection
    qkv = rnd(2, 8, 3, H, D)
    cases.append(("verify", dict(q=qkv[:, :, 0], k=rnd(2, 512, H, D),
                                 v=rnd(2, 512, H, D),
                                 kv_lens=ints([145, 298]),
                                 q_offsets=ints([137, 290]))))
    # the verify chunk of a lockstep wave of B searches: the VSM's 512-slot
    # cache, prompts of 300-383 tokens, 0-15 tokens decoded
    for B in (4, 16):
        qkv = rnd(B, 8, 3, H, D)
        offs = [300 + (37 * b) % 84 for b in range(B)]
        cases.append((f"verify_b{B}", dict(
            q=qkv[:, :, 0], k=rnd(B, 512, H, D), v=rnd(B, 512, H, D),
            kv_lens=ints([o + 8 for o in offs]),
            q_offsets=ints(offs))))
    # option chunk over a shared prefix: q_offsets = prefix lengths
    offs = [300, 301, 420, 511]
    cases.append(("option", dict(q=rnd(4, 64, H, D), k=rnd(4, 576, H, D),
                                 v=rnd(4, 576, H, D),
                                 kv_lens=ints([o + n for o, n in
                                               zip(offs, [5, 12, 64, 30])]),
                                 q_offsets=ints(offs))))
    # kv_valid: random key holes; row 0 of batch 1 sees only key 0, which
    # is masked, so that row must come out exactly 0
    valid = torch.rand(2, 256, generator=gen, device=dev) > 0.3
    valid[1, 0] = False
    cases.append(("kv_valid", dict(q=rnd(2, 128, H, D), k=rnd(2, 256, H, D),
                                   v=rnd(2, 256, H, D),
                                   kv_lens=ints([256, 200]),
                                   q_offsets=ints([0, 0]), kv_valid=valid)))
    # a rank's heads under a model split of the decoder (H/2 at 1x1x2,
    # H/4 at 1x1x4): the training bucket on the tile route, a decode step
    # on the split route
    for h in (H // 2, H // 4):
        cases.append((f"train_h{h}", dict(
            q=rnd(4, 512, h, D), k=rnd(4, 512, h, D), v=rnd(4, 512, h, D),
            kv_lens=ints([512, 300, 512, 512]), q_offsets=ints([0] * 4))))
        ck, cv = rnd(1, 768, h, D), rnd(1, 768, h, D)
        cases.append((f"decode_h{h}", dict(
            q=rnd(1, 1, h, D), k=ck, v=cv, kv_lens=ints([301]),
            q_offsets=ints([300]))))
    return cases


def _rel_err(out, ref) -> float:
    return float((out.float() - ref.float()).abs().max()
                 / ref.float().abs().max())


def _abs_err(out, ref) -> float:
    return float((out.float() - ref.float()).abs().max())


def _beyond_rounding(out, ref) -> float:
    """Largest |out - ref| beyond the rounding of out to bf16 (half an
    ulp, at most 2**-8 |ref|), relative to the largest |ref|."""
    ref = ref.float()
    excess = ((out.float() - ref).abs() - 2.0 ** -8 * ref.abs()).clamp(min=0)
    return float(excess.max() / ref.abs().max())


def _measure(name, kernel, plain, args, rotate, nbytes, ops, kind, tol,
             err_fn=_abs_err, library=None):
    """Checks one case against the plain version (err_fn(out, ref) <=
    tol; the record keeps the absolute and the relative error) and times
    it. `rotate` names the large inputs that the device-time graph cycles
    through copies of (at least twice the L2 in all), as the path reads
    them cold. `library` builds, from one copy of the inputs, a closure of
    one PyTorch call computing the same function (a yardstick, timed as
    the kernel is: device time over the same copies, and events), or is
    None."""
    out = kernel(**args)
    ref = plain(**args)
    torch.cuda.synchronize()
    err = err_fn(out, ref)
    finite = bool(torch.isfinite(out.float()).all())
    case_bytes = sum(args[k].numel() * args[k].element_size()
                     for k in rotate)
    n = min(max(math.ceil(2 * L2_BYTES / case_bytes), 2), 16)
    variants = [args] + [dict(args, **{k: args[k].clone() for k in rotate})
                         for _ in range(n - 1)]
    ms = graph_ms([(lambda a=a: kernel(**a)) for a in variants])
    library_ms = library_events = None
    if library is not None:
        calls = [library(a) for a in variants]
        library_ms = graph_ms(calls)
        library_events = events_ms(calls[0])
        del calls
    del variants
    ms_events = events_ms(lambda: kernel(**args))
    plain_ms = events_ms(lambda: plain(**args))
    bound_ms, bound_by = bound(nbytes, ops, kind)
    ok = finite and err <= tol
    lib = "none" if library_ms is None else \
        f"{library_ms:.4f} (events {library_events:.4f})"
    log(f"[{name}] err {err:.3e} (tol {tol}) device {ms:.4f} ms "
        f"(events {ms_events:.4f}) plain {plain_ms:.4f} library {lib} "
        f"bound {bound_ms:.4f} ms ({bound_by}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: err {err} finite {finite}")
    return out, {"max_abs_err": _abs_err(out, ref),
                 "max_rel_err": _rel_err(out, ref), "ms": ms,
                 "ms_events": ms_events,
                 "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": library_ms,
                 "library_ms_events": library_events, "copies": n}


def _sdpa_mask(Sq, Skv, dev, kv_lens, q_offsets, kv_valid=None):
    """The boolean mask [B, 1, Sq, Skv] of K1's causal ragged attention."""
    ki = torch.arange(Skv, device=dev)[None, None, None, :]
    row = (q_offsets[:, None, None, None]
           + torch.arange(Sq, device=dev)[None, None, :, None])
    mask = (ki < kv_lens[:, None, None, None]) & (ki <= row)
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, None, :].bool()
    return mask


def phase_k1(dev):
    import torch.nn.functional as F
    from vstar_tpu_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(SEED)
    res = []
    for case, args in _k1_cases(gen, dev):
        q, k = args["q"], args["k"]
        B, Sq, H, D = q.shape
        Skv = k.shape[1]
        mask = _sdpa_mask(Sq, Skv, dev, args["kv_lens"], args["q_offsets"],
                          args.get("kv_valid"))
        pairs = int(mask.sum())
        kv_read = int(args["kv_lens"].clamp(max=Skv).sum())
        nbytes = 2 * (2 * B * Sq * H * D + 2 * kv_read * H * D)

        def library(a, mask=mask):
            qt, kt, vt = (a[n].transpose(1, 2) for n in ("q", "k", "v"))
            return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                          attn_mask=mask)

        out, rec = _measure(f"K1 {case}", fa.flash_attention,
                            fa.mha_reference, args, ("k", "v"), nbytes,
                            4 * pairs * H * D, "bf16", TOL,
                            library=library)
        if case == "kv_valid" and float(out[1, 0].float().abs().max()) != 0:
            raise AssertionError("K1: fully masked row is not zero")
        res.append({"case": case, "shape": f"q{tuple(q.shape)} "
                    f"k{tuple(k.shape)}", **rec})
    return res


def phase_k2(dev):
    import torch.nn.functional as F
    from vstar_tpu_torch.kernels import tower_attention as ta
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    res = []
    # B = 4: training, and lockstep waves of 3-4 searches; 8 and 16: the
    # larger wave buckets
    # h6 / h3: a rank's heads under a model split of the tower (1x1x2,
    # 1x1x4)
    for case, shape in (("owl_768", (1, 2305, 12, 64)),
                        ("s600", (2, 600, 12, 64)),
                        ("owl_768_b4", (4, 2305, 12, 64)),
                        ("owl_768_b8", (8, 2305, 12, 64)),
                        ("owl_768_b16", (16, 2305, 12, 64)),
                        ("owl_768_h6", (1, 2305, 6, 64)),
                        ("owl_768_b4_h3", (4, 2305, 3, 64))):
        q, k, v = (torch.randn(*shape, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        B, S, H, D = shape

        def library(a):
            qt, kt, vt = (a[n].transpose(1, 2) for n in ("q", "k", "v"))
            return lambda: F.scaled_dot_product_attention(qt, kt, vt)

        _, rec = _measure(f"K2 {case}", ta.tower_attention,
                          ta.tower_attention_reference, dict(q=q, k=k, v=v),
                          ("q", "k", "v"), 4 * 2 * B * S * H * D,
                          4 * B * H * S * S * D, "bf16", TOL,
                          library=library)
        res.append({"case": case, "shape": f"q{shape}", **rec})
    return res


def _rand(gen, dev, *shape, scale=1.0):
    return torch.randn(*shape, generator=gen, device=dev) * scale


def phase_int8(dev):
    """K3/K4 at decode rows: gate/up (4096 -> 11008), down (11008 -> 4096),
    the VQA lm_head (4096 -> 32003) and wq/wk/wv/wo (4096 -> 4096), int8
    per-channel; one launch per call."""
    from vstar_tpu_torch.kernels import int8_matmul as k8
    from vstar_tpu_torch.nn.quant import quantize_weight
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    res = []
    for rows, IN, OUT in ((1, 4096, 11008), (8, 11008, 4096),
                          (16, 4096, 32003), (1, 4096, 4096),
                          (1, 11008, 4096)):
        e = quantize_weight(_rand(gen, dev, IN, OUT, scale=IN ** -0.5))
        x = _rand(gen, dev, rows, IN).to(torch.bfloat16)
        args = dict(x=x, q=e["q"], s=e["s"])
        nbytes = IN * OUT + 4 * OUT + 2 * rows * (IN + OUT)
        library = _int8pack_library(x, e["q"], e["s"], k8)
        _, rec = _measure(f"int8 R={rows} {IN}x{OUT}", k8.int8_matmul,
                          k8.int8_matmul_reference, args, ("q",), nbytes,
                          2 * rows * IN * OUT, "bf16", BF16_REL_TOL,
                          _rel_err, library)
        before = k8.launches
        k8.int8_matmul(x, e["q"], e["s"])
        if k8.launches != before + 1:
            raise AssertionError(f"int8 R={rows}: not one launch per call")
        res.append({"case": f"R{rows}_{IN}x{OUT}", **rec})
        _w8a8_note(x, e, k8)
    log_kernel_info("K3", "int8_decode")
    return res


def _w8a8_note(x, e, k8):
    """Logs (only) the act-int8 route of the same int8 entry, _w8a8_dot
    (int8 activations, torch._int_mm on zero-padded operands), beside the
    int8 kernel; for the 32003-wide lm_head also the exact f64 product
    that took that shape before the padding."""
    from vstar_tpu_torch.nn.quant import _w8a8_dot
    rows, IN = x.shape
    OUT = e["q"].shape[1]
    w8a8 = events_ms(lambda: _w8a8_dot(x, e))
    kernel = events_ms(lambda: k8.int8_matmul(x, e["q"], e["s"]))
    msg = (f"[w8a8 R={rows} {IN}x{OUT}] _w8a8_dot {w8a8:.4f} ms, int8 "
           f"kernel {kernel:.4f} ms (events)")
    if OUT % 8:
        xq = torch.randint(-127, 128, (rows, IN), device=x.device,
                           dtype=torch.int32).to(torch.int8)
        f64 = events_ms(lambda: (xq.double() @ e["q"].double())
                      .to(torch.int32))
        msg += f"; its f64 integer product {f64:.4f} ms"
    log(msg)


def _int8pack_library(x, q, s, k8):
    """torch._weight_int8pack_mm computes the same function from the
    transposed weight (made once per copy, outside the timing): a builder
    of its closure over one copy of the inputs, or None where the card's
    torch has no CUDA version of it or it disagrees."""
    try:
        got = torch._weight_int8pack_mm(x, q.t().contiguous(),
                                        s.reshape(-1).to(x.dtype))
        want = k8.int8_matmul_reference(x, q, s)
        torch.cuda.synchronize()
        if _rel_err(got, want) > BF16_REL_TOL:
            log("[int8] torch._weight_int8pack_mm disagrees; no library "
                "time")
            return None
    except (RuntimeError, NotImplementedError) as exc:
        log(f"[int8] torch._weight_int8pack_mm unavailable: "
            f"{str(exc).splitlines()[0][:160]}")
        return None

    def build(a):
        qt = a["q"].t().contiguous()
        sc = a["s"].reshape(-1).to(a["x"].dtype)
        return lambda: torch._weight_int8pack_mm(a["x"], qt, sc)
    return build


def _int4pack_library(x, q4, s4, k4):
    """torch._weight_int4pack_mm (tinygemm's int4 kernel) computes K5's
    function: it dequantizes (u - 8) * scale + zero per group, so the
    unsigned nibbles u = n + 8 with zeros of 0 and the scales cast to bf16
    give n * s4. A builder of its closure over one copy of the inputs (the
    packed layout made outside the timing), or None where OUT % 8 (the
    32003-wide lm_head, which it does not take), where the card's torch
    lacks it, or where it disagrees. The byte order of its input packing
    is found by agreement."""
    if q4.shape[1] % 8:
        return None
    from vstar_tpu_torch.scripts.int4_profile import tinygemm_pack
    want = k4.int4_matmul_reference(x, q4, s4)
    for even_high in (True, False):
        order = "even input high" if even_high else "even input low"
        try:
            w, sz, group = tinygemm_pack(q4, s4, even_high)
            got = torch._weight_int4pack_mm(x, w, group, sz)
            torch.cuda.synchronize()
        except (RuntimeError, NotImplementedError, AttributeError) as exc:
            log(f"[K5] torch._weight_int4pack_mm unavailable: "
                f"{str(exc).splitlines()[0][:160]}")
            return None
        err = _rel_err(got, want)
        if err <= BF16_REL_TOL:
            log(f"[K5] library torch._weight_int4pack_mm ({order}) agrees: "
                f"{err:.3e} of the largest |output|")

            def build(a, even_high=even_high):
                w, sz, group = tinygemm_pack(a["q4"], a["s4"], even_high)
                return lambda: torch._weight_int4pack_mm(a["x"], w, group,
                                                         sz)
            return build
        log(f"[K5] torch._weight_int4pack_mm ({order}) disagrees: {err:.3e}")
    log("[K5] no library time")
    return None


def phase_int4(dev):
    """K5 (W4A16) at decode, lm_head and prefill rows, and K6 (W4A8) at
    decode and verify rows, group-128 int4."""
    from vstar_tpu_torch.kernels import int4_matmul as k4
    from vstar_tpu_torch.nn.quant import quantize_weight_int4
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    weights = {}

    def entry(IN, OUT):
        if (IN, OUT) not in weights:
            weights[(IN, OUT)] = quantize_weight_int4(
                _rand(gen, dev, IN, OUT, scale=IN ** -0.5))
        return weights[(IN, OUT)]

    k5, k6 = [], []
    for rows, IN, OUT in ((1, 4096, 11008), (16, 4096, 32003),
                          (8, 4096, 11008), (384, 4096, 11008),
                          (17, 4096, 11008), (768, 4096, 11008)):
        e = entry(IN, OUT)
        x = _rand(gen, dev, rows, IN).to(torch.bfloat16)
        nbytes = (IN // 2 * OUT + 4 * e["s4"].shape[0] * OUT
                  + 2 * rows * (IN + OUT))
        library = _int4pack_library(x, e["q4"], e["s4"], k4)
        out, rec = _measure(f"K5 R={rows} {IN}x{OUT}", k4.int4_matmul,
                            k4.int4_matmul_reference,
                            dict(x=x, q4=e["q4"], s4=e["s4"]), ("q4", "s4"),
                            nbytes, 2 * rows * IN * OUT, "bf16",
                            BF16_REL_TOL, _rel_err, library)
        # second check: the kernel's own arithmetic (bf16 weights in the
        # tensor-core tiles above 16 rows), within its output's rounding
        math_err = _beyond_rounding(
            out, k4.int4_matmul_kernel_math(x, e["q4"], e["s4"]))
        log(f"[K5 R={rows} {IN}x{OUT}] against its own arithmetic: "
            f"{math_err:.3e} beyond the bf16 rounding (tol {K5_MATH_TOL})")
        if not math_err <= K5_MATH_TOL:
            raise AssertionError(f"K5 R={rows}: {math_err} beyond rounding")
        rec["kernel_math_err"] = math_err
        before = k4.launches["int4_matmul"]
        k4.int4_matmul(x, e["q4"], e["s4"])
        if k4.launches["int4_matmul"] != before + 1:
            raise AssertionError(f"K5 R={rows}: not one launch per call")
        k5.append({"case": f"R{rows}_{IN}x{OUT}", **rec})
    if k5[0]["library_ms"]:
        log(f"[K5 R=1 4096x11008] device {k5[0]['ms']:.4f} ms, "
            f"{k5[0]['ms'] / k5[0]['library_ms']:.2f}x tinygemm's "
            f"{k5[0]['library_ms']:.4f}")
    log_kernel_info("K5", "int4_")
    for rows, IN, OUT in ((1, 4096, 11008), (8, 4096, 11008),
                          (16, 4096, 11008), (1, 11008, 4096),
                          (1, 4096, 4096)):
        e = entry(IN, OUT)
        xq = torch.randint(-127, 128, (rows, IN), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.int8)
        NG = e["s4"].shape[0]
        _, rec = _measure(f"K6 R={rows} {IN}x{OUT}", k4.int4_matmul_w4a8,
                          k4.int4_matmul_w4a8_reference,
                          dict(xq=xq, q4=e["q4"], s4=e["s4"]), ("q4", "s4"),
                          _w4a8_bytes(rows, IN, OUT, NG), 2 * rows * IN * OUT,
                          "int8", F32_REL_TOL, _rel_err)
        rec["launches_per_call"], rec["allocations_per_call"] = _one_call(
            lambda: k4.int4_matmul_w4a8(xq, e["q4"], e["s4"]),
            k4.launches, "int4_matmul_w4a8", dev)
        if rec["launches_per_call"] != 1 or rec["allocations_per_call"] != 1:
            raise AssertionError(f"K6 R={rows}: {rec['launches_per_call']} "
                                 f"launches, {rec['allocations_per_call']} "
                                 "allocations a call (want 1, 1: no "
                                 "workspace)")
        k6.append({"case": f"R{rows}_{IN}x{OUT}", **rec})
    log_kernel_info("K6", "w4a8_decode")
    quant = []
    for rows, IN, OUT in ((1, 4096, 11008), (16, 4096, 11008)):
        e = entry(IN, OUT)
        x = _rand(gen, dev, rows, IN).to(torch.bfloat16)
        xq, sx = k4.quantize_rows(x)
        want_xq, want_sx = k4.quantize_activations(x.float())
        if not (torch.equal(xq, want_xq) and torch.equal(sx, want_sx)):
            raise AssertionError(f"quantize_rows R={rows}: xq / sx differ "
                                 "from quantize_activations")
        # xq held here (sx above, bit for bit); one launch gives both
        _, rec = _measure(f"quantize_rows R={rows} {IN}",
                          lambda x: k4.quantize_rows(x)[0],
                          lambda x: k4.quantize_activations(x.float())[0],
                          dict(x=x), ("x",), 2 * rows * IN + rows * (IN + 4),
                          0, "int8", 0.0, _abs_err)
        rec["bit_equal"] = True
        quant.append({"case": f"R{rows}_{IN}", **rec})
        # a rank of a 1x2x1 hidden split: half of each row, its max given
        # (the row's, larger than the half's), x read once
        half = x[:, :IN // 2].contiguous()
        amax = x.float().abs().amax(dim=-1, keepdim=True) * 1.5
        xq, sx = k4.quantize_rows(half, amax)
        want_xq, want_sx = k4.quantize_activations(half.float(), amax)
        if not (torch.equal(xq, want_xq) and torch.equal(sx, want_sx)):
            raise AssertionError(f"quantize_rows R={rows} given the max: "
                                 "xq / sx differ from quantize_activations")
        _, rec = _measure(
            f"quantize_rows R={rows} {IN // 2} given the max",
            lambda x, amax: k4.quantize_rows(x, amax)[0],
            lambda x, amax: k4.quantize_activations(x.float(), amax)[0],
            dict(x=half, amax=amax), ("x",),
            rows * IN // 2 * 3 + rows * 8, 0, "int8", 0.0, _abs_err)
        rec["bit_equal"] = True
        quant.append({"case": f"R{rows}_{IN // 2}_given_max", **rec})
        NG = e["s4"].shape[0]
        _, rec = _measure(
            f"K6 qdot R={rows} {IN}x{OUT}",
            lambda x, q4, s4: k4.qdot4_w4a8(x, {"q4": q4, "s4": s4}),
            _plain_qdot_w4a8, dict(x=x, q4=e["q4"], s4=e["s4"]),
            ("q4", "s4"), IN // 2 * OUT + 4 * NG * OUT + 2 * rows * (IN + OUT),
            2 * rows * IN * OUT, "int8", F32_REL_TOL, _beyond_rounding)
        rec["kernels_per_call"] = graph_kernels(
            lambda: k4.qdot4_w4a8(x, e))[0]
        log(f"[K6 qdot R={rows} {IN}x{OUT}] {rec['kernels_per_call']} "
            f"kernels a call (K6 alone {k6[0 if rows == 1 else 2]['ms']:.4f}"
            f" ms)")
        if rec["kernels_per_call"] > 2:
            raise AssertionError(f"K6 qdot R={rows}: "
                                 f"{rec['kernels_per_call']} kernels a call")
        k6.append({"case": f"qdot_R{rows}_{IN}x{OUT}", **rec})
    return k5, k6, quant


def _one_call(fn, counter, key, dev):
    """(launches of counter[key], allocations) of one call of fn."""
    before = counter[key]
    allocs = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
    fn()
    return (counter[key] - before,
            torch.cuda.memory_stats(dev)["allocation.all.allocated"] - allocs)


def _plain_qdot_w4a8(x, q4, s4):
    """K6's qdot by its plain versions: quantize_activations, K6's plain
    version, times sx, in f32 (the kernel's output rounds it to bf16)."""
    from vstar_tpu_torch.kernels import int4_matmul as k4
    xq, sx = k4.quantize_activations(x.float())
    return k4.int4_matmul_w4a8_reference(xq, q4, s4) * sx


def _w4a8_bytes(R, IN, OUT, NG):
    """Bytes of a W4A8 product (the JAX CostEstimate, int4_profile.py
    :310-311): packed weights, scales, int8 activations, f32 output."""
    return IN // 2 * OUT + 4 * NG * OUT + R * (IN + 4 * OUT)


def phase_p(dev):
    """P1-P4 against their plain versions at the 7B shapes: P1 both
    candidates on w_gate (exact; library: one uint8 shift), P2 every
    unpack at 256 columns and P4 at R in {1, 8} on 4096x11008 and
    4096x32000, P2 every unpack at R=16 on 4096x11008 and at 512 columns
    on 11008x4096 (32000 and 11008 are no multiples of 512), P3 at R in
    {1, 16} on 11008x4096 (its default blocks); P3 and P4 also held to K6
    on the same product."""
    from vstar_tpu_torch.kernels import int4_matmul as k4
    from vstar_tpu_torch.kernels import int4_variants as kv
    from vstar_tpu_torch.nn.quant import quantize_weight_int4
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    q = torch.randint(0, 256, (2048, 11008), generator=gen, device=dev,
                      dtype=torch.int32).to(torch.uint8)
    shift = torch.bitwise_left_shift(q, 4).view(torch.int8)
    if not torch.equal(shift, kv.want_lo(q)):
        raise AssertionError("P1 library yardstick disagrees")
    res = {n: [] for n in kv.NAMES}
    for how in kv.PROBES:
        _, rec = _measure(
            f"P1 {how} w_gate [2048,11008]",
            lambda q, how=how: kv.unpack_probe(q, how),
            lambda q, how=how: kv.unpack_probe_reference(q, how), dict(q=q),
            ("q",), 2 * q.numel(), 0, "int8", 0.0, _abs_err,
            lambda a: (lambda: torch.bitwise_left_shift(a["q"], 4)))
        res["unpack_probe"].append({"case": f"{how}_w_gate", **rec})
    weights = {}

    def case(R, IN, OUT):
        if (IN, OUT) not in weights:
            weights[(IN, OUT)] = quantize_weight_int4(
                _rand(gen, dev, IN, OUT, scale=IN ** -0.5))
        e = weights[(IN, OUT)]
        xq, _ = k4.quantize_activations(_rand(gen, dev, R, IN))
        NG = e["s4"].shape[0]
        return (e, xq, _w4a8_bytes(R, IN, OUT, NG), 2 * R * IN * OUT)

    def variant(unpack, block_o):
        return (lambda xq, q4, s4: kv.w4a8_variant(xq, q4, s4, unpack,
                                                   block_o),
                lambda xq, q4, s4: kv.w4a8_variant_reference(
                    xq, q4, s4, unpack, block_o))

    def against_k6(tag, out, xq, e, rec):
        rec["rel_err_vs_k6"] = _rel_err(
            out, k4.int4_matmul_w4a8(xq, e["q4"], e["s4"]))
        log(f"[{tag}] against K6: {rec['rel_err_vs_k6']:.3e} "
            f"(tol {F32_REL_TOL})")
        if not rec["rel_err_vs_k6"] <= F32_REL_TOL:
            raise AssertionError(f"{tag}: {rec['rel_err_vs_k6']} off K6")

    def p2(R, IN, OUT, block_o):
        e, xq, nbytes, ops = case(R, IN, OUT)
        for unpack in kv.UNPACKS:
            _, rec = _measure(f"P2 {unpack} block_o={block_o} R={R} "
                              f"{IN}x{OUT}", *variant(unpack, block_o),
                              dict(xq=xq, q4=e["q4"], s4=e["s4"]),
                              ("q4", "s4"), nbytes, ops, "int8", F32_REL_TOL,
                              _rel_err)
            tag = "" if block_o == 256 else f"_bo{block_o}"
            res["w4a8_variant"].append(
                {"case": f"{unpack}{tag}_R{R}_{IN}x{OUT}", **rec})
        return e, xq, nbytes, ops

    for R, IN, OUT in ((1, 4096, 11008), (8, 4096, 11008), (1, 4096, 32000),
                       (8, 4096, 32000)):
        e, xq, nbytes, ops = p2(R, IN, OUT, 256)
        out, rec = _measure(f"P4 R={R} {IN}x{OUT}", kv.w4a8_t,
                            kv.w4a8_t_reference,
                            dict(xq=xq, q4t=e["q4"].t().contiguous(),
                                 s4t=e["s4"].t().contiguous()),
                            ("q4t", "s4t"), nbytes, ops, "int8", F32_REL_TOL,
                            _rel_err)
        # the same product on K6 (untransposed storage)
        against_k6(f"P4 R={R} {IN}x{OUT}", out, xq, e, rec)
        res["w4a8_t"].append({"case": f"R{R}_{IN}x{OUT}", **rec})
    p2(16, 4096, 11008, 256)
    p2(1, 11008, 4096, 512)
    for R in (1, 16):
        e, xq, nbytes, ops = case(R, 11008, 4096)
        out, rec = _measure(f"P3 R={R} 11008x4096", kv.w4a8_rows,
                            kv.w4a8_rows_reference,
                            dict(xq=xq, q4=e["q4"], s4=e["s4"]),
                            ("q4", "s4"), nbytes, ops, "int8", F32_REL_TOL,
                            _rel_err)
        against_k6(f"P3 R={R} 11008x4096", out, xq, e, rec)
        res["w4a8_rows"].append({"case": f"R{R}_11008x4096", **rec})
    return res


def phase_k7(dev):
    """K1 with its log-sum-exp and the K7 backward at the training shape
    [4, 512, 32, 128] bf16: row 1 ragged at 300 keys, ~10 % of keys
    invalid, and row 0 of batch 2 sees no key (lse -inf, zero output and
    gradient). Returns (K1's record, K7's record)."""
    import torch.nn.functional as F
    from vstar_tpu_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    B, S, H, D = 4, 512, 32, 128
    q, k, v, do = (torch.randn(B, S, H, D, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    kv_lens = torch.tensor([512, 300, 512, 512], dtype=torch.int32,
                           device=dev)
    q_off = torch.zeros(B, dtype=torch.int32, device=dev)
    valid = torch.rand(B, S, generator=gen, device=dev) > 0.1
    valid[2, 0] = False
    valid = valid.to(torch.uint8)       # the kernels' own mask type
    masks = dict(kv_lens=kv_lens, q_offsets=q_off, kv_valid=valid)

    out, lse = fa.flash_attention_lse(q, k, v, **masks)
    ref_out, ref_lse = fa.mha_forward_lse(q, k, v, **masks)
    delta = (do.float() * out.float()).sum(-1)
    grads = fa.flash_attention_bwd(q, k, v, do, lse, delta, **masks)
    again = fa.flash_attention_bwd(q, k, v, do, lse, delta, **masks)
    want = fa.mha_backward(q, k, v, do, ref_lse, delta, **masks)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
        raise AssertionError("K7: two launches on the same inputs differ")
    del again
    finite = torch.isfinite(ref_lse)
    lse_err = float((lse - ref_lse)[finite].abs().max())
    out_err = _abs_err(out, ref_out)
    grad_errs = {n: _rel_err(g, w) for n, g, w in zip(("dq", "dk", "dv"),
                                                      grads, want)}
    ok = (torch.equal(finite, torch.isfinite(lse)) and lse_err <= LSE_TOL
          and out_err <= TOL and all(e <= TOL for e in grad_errs.values())
          and all(bool(torch.isfinite(g.float()).all()) for g in grads)
          and bool(torch.isfinite(out.float()).all())
          and float(out[2, 0].float().abs().max()) == 0.0
          and bool(torch.isinf(lse[2, 0]).all())
          and float(grads[0][2, 0].float().abs().max()) == 0.0)
    log(f"[K1 lse train] lse err {lse_err:.3e} (tol {LSE_TOL}), out err "
        f"{out_err:.3e} (tol {TOL}); [K7] dq/dk/dv err of the largest "
        f"|value| {grad_errs} (tol {TOL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"K1 lse / K7 disagree: lse {lse_err}, out "
                             f"{out_err}, grads {grad_errs}")

    # a rank's heads under a model split of the decoder (1x1x2, 1x1x4):
    # K1 with lse and K7 against the plain versions, same masks
    for h in (H // 2, H // 4):
        qh, kh, vh, doh = (x[:, :, :h].contiguous() for x in (q, k, v, do))
        o_h, lse_h = fa.flash_attention_lse(qh, kh, vh, **masks)
        ro_h, rlse_h = fa.mha_forward_lse(qh, kh, vh, **masks)
        delta_h = (doh.float() * o_h.float()).sum(-1)
        got = fa.flash_attention_bwd(qh, kh, vh, doh, lse_h, delta_h, **masks)
        want_h = fa.mha_backward(qh, kh, vh, doh, rlse_h, delta_h, **masks)
        fin = torch.isfinite(rlse_h)
        errs = {"out": _abs_err(o_h, ro_h),
                "lse": float((lse_h - rlse_h)[fin].abs().max()),
                **{n: _rel_err(g, w) for n, g, w in
                   zip(("dq", "dk", "dv"), got, want_h)}}
        ok_h = errs["lse"] <= LSE_TOL and all(
            e <= TOL for n, e in errs.items() if n != "lse")
        log(f"[K1 lse / K7 at {h} heads] errors {errs} (tol {TOL}, lse "
            f"{LSE_TOL}) {'ok' if ok_h else 'FAIL'}")
        if not ok_h:
            raise AssertionError(f"K1 lse / K7 at {h} heads: {errs}")
        del qh, kh, vh, doh, o_h, got, want_h

    mask = _sdpa_mask(S, S, dev, kv_lens, q_off, valid)
    pairs = int(mask.sum()) * H
    elem = B * S * H * D
    copies = [dict(q=q, k=k, v=v, do=do)] + [
        dict(q=q.clone(), k=k.clone(), v=v.clone(), do=do.clone())]
    # K1 with lse: q, k, v read, out and lse written
    fwd_ms = graph_ms([lambda a=a: fa.flash_attention_lse(
        a["q"], a["k"], a["v"], **masks) for a in copies])
    fwd_events = events_ms(lambda: fa.flash_attention_lse(q, k, v, **masks))
    fwd_plain = events_ms(lambda: fa.mha_forward_lse(q, k, v, **masks))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa_fwd = graph_ms([lambda a=a: F.scaled_dot_product_attention(
        a["q"].transpose(1, 2), a["k"].transpose(1, 2),
        a["v"].transpose(1, 2), attn_mask=mask) for a in copies])
    sdpa_fwd_events = events_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask))
    fwd_bound, fwd_by = bound(2 * 4 * elem + 4 * B * S * H, 4 * pairs * D,
                              "bf16")
    # K7: q, k, v, dO, lse, delta read; dq, dk, dv written
    bwd_ms = graph_ms([lambda a=a: fa.flash_attention_bwd(
        a["q"], a["k"], a["v"], a["do"], lse, delta, **masks)
        for a in copies])
    bwd_events = events_ms(lambda: fa.flash_attention_bwd(
        q, k, v, do, lse, delta, **masks))
    bwd_plain = events_ms(lambda: fa.mha_backward(q, k, v, do, ref_lse, delta,
                                                **masks), iters=5)
    leaves = [x.detach().clone().requires_grad_() for x in (qt, kt, vt)]
    sdpa_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
    do_t = do.transpose(1, 2)
    sdpa_bwd = events_ms(lambda: torch.autograd.grad(
        sdpa_out, leaves, do_t, retain_graph=True))
    del sdpa_out, leaves

    def sdpa_train(a, backward):
        lv = [a[n].transpose(1, 2).detach().requires_grad_()
              for n in ("q", "k", "v")]
        d = a["do"].transpose(1, 2)

        def call():
            o = F.scaled_dot_product_attention(*lv, attn_mask=mask)
            if backward:
                torch.autograd.grad(o, lv, d)
        return call

    # SDPA's backward by device time: one graph of forward + backward
    # (autograd captured whole) less one of the forward with grad on
    try:
        sdpa_bwd_graph = (graph_ms([sdpa_train(a, True) for a in copies])
                          - graph_ms([sdpa_train(a, False) for a in copies]))
    except RuntimeError as e:      # a yardstick only; the port is not in it
        log(f"[K7 train] SDPA backward not capturable: {e}")
        sdpa_bwd_graph = None
    del copies
    bwd_bound, bwd_by = bound(2 * 7 * elem + 2 * 4 * B * S * H,
                              10 * pairs * D, "bf16")
    log(f"[K1 lse train] device {fwd_ms:.4f} ms (events {fwd_events:.4f}) "
        f"plain {fwd_plain:.4f} library {sdpa_fwd:.4f} (events "
        f"{sdpa_fwd_events:.4f}) bound {fwd_bound:.4f} ms ({fwd_by})")
    log(f"[K7 train] device {bwd_ms:.4f} ms (events {bwd_events:.4f}) "
        f"plain {bwd_plain:.4f} library {sdpa_bwd_graph} (events "
        f"{sdpa_bwd:.4f}; SDPA backward) bound {bwd_bound:.4f} ms ({bwd_by})")
    if sdpa_bwd_graph:
        log(f"[K7 train] {bwd_ms / sdpa_bwd_graph:.2f}x SDPA's backward by "
            f"device time")
    log_kernel_info("K7", "flash_bwd")
    shape = f"q{(B, S, H, D)} kv_lens {kv_lens.tolist()} kv_valid 90%"
    k1 = {"case": "train_lse", "shape": shape, "max_abs_err": out_err,
          "max_rel_err": _rel_err(out, ref_out), "lse_max_abs_err": lse_err,
          "ms": fwd_ms, "ms_events": fwd_events, "plain_ms": fwd_plain,
          "bound_ms": fwd_bound, "bound_by": fwd_by, "library_ms": sdpa_fwd,
          "library_ms_events": sdpa_fwd_events, "copies": 2}
    k7 = {"case": "train", "shape": shape,
          "max_abs_err": max(_abs_err(g, w) for g, w in zip(grads, want)),
          "max_rel_err": max(grad_errs.values()), "ms": bwd_ms,
          "ms_events": bwd_events, "plain_ms": bwd_plain,
          "bound_ms": bwd_bound, "bound_by": bwd_by,
          "library_ms": sdpa_bwd_graph, "library_ms_events": sdpa_bwd,
          "library_timing": "graph of forward + backward less forward",
          "copies": 2}
    return k1, k7


# ---------------------------------------------------------------------------
# Phase 5: the main path
# ---------------------------------------------------------------------------

def _image(h, w, seed):
    """A seeded synthetic photo stand-in: smooth colour ramps plus noise."""
    from PIL import Image
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([xx / w, yy / h, 0.5 + 0.5 * np.sin(xx / 97.0)], -1)
    img = 200 * base + 55 * rng.rand(h, w, 3)
    return Image.fromarray(img.clip(0, 255).astype(np.uint8))


def _check_record(rec, n_opts):
    if not isinstance(rec.get("option_chosen"), int) \
            or not 0 <= rec["option_chosen"] < n_opts:
        raise AssertionError(f"bad option_chosen in {rec}")
    for key in ("prediction_freeform", "missing_objects", "search_result"):
        if key not in rec:
            raise AssertionError(f"record lacks {key}: {rec}")


def _http_answer(service, image, question, options):
    """One request through the port's HTTP server on an ephemeral port."""
    from vstar_tpu_torch.serve.server import make_server
    httpd = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        buf = io.BytesIO()
        image.save(buf, format="PNG")
        body = json.dumps({"image": base64.b64encode(buf.getvalue()).decode(),
                           "question": question,
                           "options": options}).encode()
        url = f"http://127.0.0.1:{httpd.server_address[1]}/v1/answer"
        req = urllib.request.Request(
            url, data=body, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, json.loads(resp.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)


def _forced_search_sample(vqa, vsm, image, question, options):
    """One SEAL sample with the search forced, as the benchmarks force it
    (random weights never emit the trigger): free-form answer, then a
    3-step guided search for 'red mug' under the forced thresholds, then
    the focused option scoring."""
    from vstar_tpu_torch.eval import seal
    from vstar_tpu_torch.search.batched import run_grouped_searches
    squared = seal.expand2square(image)[0]
    t0 = time.perf_counter()
    prediction = vqa.free_form(squared, question)
    missing = ["red mug"]
    tasks = seal.search_tasks(image, missing)
    path = []
    tasks[0]["path_out"] = path
    outs = run_grouped_searches(vsm, tasks, max_steps=3, **FORCED_SEARCH)
    search_result = seal.collect_search_results(missing, outs)
    squared, q, crops, il, ol = seal.focus_inputs(vqa, image, question,
                                                  search_result)
    chosen = vqa.multiple_choice(squared, q, options, crops,
                                 images_long=il, objects_long=ol)
    torch.cuda.synchronize()
    return {"latency_s": time.perf_counter() - t0, "path": path,
            "path_length": outs[0][1], "prediction": prediction,
            "search_result": search_result, "option_chosen": chosen}


class CountingVSM:
    """Counts the VSM detect calls the policy makes."""

    def __init__(self, engine):
        self.engine, self.detects = engine, 0

    def detect(self, image, name):
        self.detects += 1
        return self.engine.detect(image, name)

    def vqa(self, image, question):
        return self.engine.vqa(image, question)

    def segment(self, image, phrase):
        return self.engine.segment(image, phrase)


# name -> (module, attribute of its launches, attribute of its plain-
# version calls on CUDA tensors, key into dict counters or None for ints)
def _counter_modules():
    from vstar_tpu_torch.kernels import flash_attention as fa
    from vstar_tpu_torch.kernels import int4_matmul as k4
    from vstar_tpu_torch.kernels import int4_variants as kv
    from vstar_tpu_torch.kernels import int8_matmul as k8
    from vstar_tpu_torch.kernels import tower_attention as ta
    plain = ("launches", "plain_calls_cuda")
    return {**{n: (kv, *plain, n) for n in P_KERNELS},
            "flash_attention": (fa, *plain, None),
            "flash_attention_bwd_dq": (fa, "bwd_launches",
                                       "bwd_plain_calls_cuda", "dq"),
            "flash_attention_bwd_dkv": (fa, "bwd_launches",
                                        "bwd_plain_calls_cuda", "dkv"),
            "tower_attention": (ta, *plain, None),
            "int8_matvec": (k8, *plain, None),
            "int4_matmul": (k4, *plain, "int4_matmul"),
            "int4_matmul_w4a8": (k4, *plain, "int4_matmul_w4a8"),
            "quantize_rows": (k4, *plain, "quantize_rows")}


def _counter(mod, attr, key):
    value = getattr(mod, attr)
    return value if key is None or not isinstance(value, dict) \
        else value[key]


def _read_counts():
    """name -> (kernel launches, plain-version calls on CUDA tensors)."""
    return {name: (_counter(mod, la, key), _counter(mod, pa, key))
            for name, (mod, la, pa, key) in _counter_modules().items()}


def _routes():
    """K1's launches by route since the last _zero_counts."""
    from vstar_tpu_torch.kernels import flash_attention as fa
    return dict(fa.route_launches)


def _zero_counts():
    from vstar_tpu_torch.kernels import flash_attention as fa
    from vstar_tpu_torch.kernels import int4_matmul as k4
    from vstar_tpu_torch.kernels import tower_attention as ta
    fa.route_launches.update(tile=0, split=0, combine=0)
    fa.split_launches_by_rows.clear()
    fa.launches_by_shape.clear()
    fa.launches_by_heads.clear()
    ta.launches_by_batch.clear()
    k4.route_launches.update(decode=0, tile=0)
    for mod, la, pa, key in _counter_modules().values():
        for attr in (la, pa):
            if key is not None and isinstance(getattr(mod, attr), dict):
                getattr(mod, attr)[key] = 0
            else:
                setattr(mod, attr, 0)


def _check_path(path, kernels):
    """Reads the counts after a path: every kernel in `kernels` launched,
    and no plain version ran on a CUDA tensor."""
    counts = _read_counts()
    launches = {k: counts[k][0] for k in counts}
    plain = {k: counts[k][1] for k in counts}
    from vstar_tpu_torch.kernels import int4_matmul as k4
    k5_routes = dict(k4.route_launches)
    log(f"[{path} path] kernel launches {launches}, K1 routes {_routes()}, "
        f"K5 routes {k5_routes}, plain-version calls on CUDA {plain}")
    missing = [k for k in kernels if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{path} path: {missing} never launched")
    if any(plain.values()):
        raise AssertionError(f"{path} path: plain versions ran on CUDA "
                             f"tensors: {plain}")
    if sum(k5_routes.values()) != launches["int4_matmul"]:
        raise AssertionError(f"{path} path: K5 routes {k5_routes} do not add "
                             f"up to its {launches['int4_matmul']} launches")
    counts = {k: launches[k] for k in kernels}
    counts["int4_matmul_routes"] = k5_routes
    return counts


def _check_routes(path, want):
    """K1's routes after a path: {"tile": n, "split": n, "combine": n}, each
    route in `want` taken (want[r] None) or taken exactly want[r] times."""
    routes = _routes()
    for r, n in want.items():
        if (routes[r] <= 0) if n is None else (routes[r] != n):
            raise AssertionError(f"{path} path: K1 routes {routes}, wanted "
                                 f"{want}")
    return routes


P_KERNELS = ("unpack_probe", "w4a8_variant", "w4a8_rows", "w4a8_t")
SERVING_KERNELS = ("flash_attention", "tower_attention", "int8_matvec",
                   "int4_matmul", "int4_matmul_w4a8", "quantize_rows")

OPTIONS = ["The mug is red.", "The mug is blue.", "The mug is green.",
           "There is no mug."]
QUESTION = "What is the color of the mug?"


def _log_forced(label, forced, vsm):
    log(f"[{label}] latency {forced['latency_s']:.3f} s patches visited "
        f"{len(forced['path'])} detect calls {vsm.detects} path_length "
        f"{forced['path_length']} search_result {forced['search_result']} "
        f"option {forced['option_chosen']}")
    if len(forced["path"]) != 3 or vsm.detects != 3:
        raise AssertionError(f"{label}: forced search did not visit 3 "
                             "patches")
    if forced["option_chosen"] not in range(len(OPTIONS)):
        raise AssertionError(f"{label}: forced sample chose no option")


# ---------------------------------------------------------------------------
# Phase 5b: the decode slice (drafts, the free-form flow, the V*Bench loop)
# ---------------------------------------------------------------------------

FREE_FORM_TOKENS, DETECT_TOKENS = 200, 100
# free_form_many's rows against their free_form answers: the near-ties of
# batched rows came at tokens 2-28 on the card, so 64 tokens a row
MANY_TOKENS = 64
# bench.py's disclosed decode budgets: free-form 32, search 16 new tokens
SYNTHETIC_BUDGETS = (32, 16)
FREEFORM_KEYS = {"freeform", "answer", "missing_objects", "failed_objects",
                 "search_result", "latency_s"}
MANY_QUESTIONS = [QUESTION, "What is on the table?", "Where is the bicycle?",
                  "How many windows are there?"]


class ForcedTrigger:
    """A VQA engine whose first free-form answer is decoded and then
    replaced by the trigger for 'red mug' (random weights never emit it),
    so the free-form flow searches; the focused re-answer is the
    engine's own."""

    def __init__(self, engine):
        self.engine = engine

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def free_form(self, image, question, **kw):
        from vstar_tpu_torch.eval.seal import MISSING_OBJECTS_MSG
        text = self.engine.free_form(image, question, **kw)
        if "Additional visual information" in question:
            return text
        return MISSING_OBJECTS_MSG + " red mug."


class Budget:
    """A VQA engine whose free_form and free_form_many decode at most n
    tokens by default."""

    def __init__(self, engine, n):
        self.engine, self.n = engine, n

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def free_form(self, *args, **kwargs):
        kwargs.setdefault("max_new_tokens", self.n)
        return self.engine.free_form(*args, **kwargs)

    def free_form_many(self, *args, **kwargs):
        kwargs.setdefault("max_new_tokens", self.n)
        return self.engine.free_form_many(*args, **kwargs)


def _trace_reader(trace, row):
    """(locate, token) over a decode's logits trace (greedy_decode's
    `trace`): locate(p) is the (forward, column) whose logits decided
    generated position p of `row`, the last forward starting at or
    before p; token(p) the argmax there."""
    starts = np.stack([s.cpu().numpy() for s, _ in trace])[:, row]
    args = [lg[row].argmax(-1).cpu().numpy() for _, lg in trace]

    def locate(p):
        e = int(np.nonzero(starts <= p)[0][-1])
        col = p - int(starts[e])
        if col >= len(args[e]):
            raise AssertionError(f"no forward decided position {p}")
        return e, col

    def token(p):
        e, col = locate(p)
        return int(args[e][col])

    return locate, token


def _first_difference(ref, run, row=0, ref_row=0):
    """The first generated position where `run`'s token differs from
    `ref`'s, within ref's tokens; None if there is none."""
    _, rtok = _trace_reader(ref["trace"], ref_row)
    _, tok = _trace_reader(run["trace"], row)
    return next((p for p in range(ref["n"][ref_row])
                 if rtok(p) != tok(p)), None)


def _equivalent(label, ref, run, row=0, ref_row=0):
    """The card's equivalence rule for a drafted decode (`run`) against
    greedy (`ref`) on the same prompt: the tokens agree up to the first
    difference p; at p the two tokens' logits in greedy's step are closer
    than the largest |logit difference| between the two paths there (a
    near-tie that rounding decided: the K-row verify forward and the
    1-row step round differently). A difference at a larger margin fails.
    Returns the difference, or None."""
    p = _first_difference(ref, run, row, ref_row)
    if p is None:
        if ("n" in run and run["n"][row] != ref["n"][ref_row]) \
                or run["texts"][row] != ref["texts"][ref_row]:
            raise AssertionError(f"{label}: greedy's tokens, but another "
                                 "length or text")
        return None
    rloc, rtok = _trace_reader(ref["trace"], ref_row)
    loc, tok = _trace_reader(run["trace"], row)
    a, b = rtok(p), tok(p)
    e, col = rloc(p)
    lg = ref["trace"][e][1][ref_row, col].float()
    e, col = loc(p)
    ls = run["trace"][e][1][row, col].float()
    diff = {"position": p, "greedy_token": a, "token": b,
            "margin": float(lg[a] - lg[b]),
            "max_logit_diff": float((lg - ls).abs().max())}
    log(f"[{label}] first difference from greedy at token {p}: {a} "
        f"against {b}, margin {diff['margin']:.6g}, largest |logit "
        f"difference| {diff['max_logit_diff']:.6g}")
    if not diff["margin"] < diff["max_logit_diff"]:
        raise AssertionError(f"{label}: differs from greedy at token {p} "
                             f"beyond rounding: {diff}")
    return diff


def _timed_decode(engine, call, replay=False):
    """Run `call` with the engine's logits trace on: its result, decode
    stats, trace and wall ms. The decode runs as the eager traced loop
    (`decode_trace`), or with replay by graph replay, its logits written
    on the device (`replay_trace`)."""
    attr = "replay_trace" if replay else "decode_trace"
    setattr(engine, attr, [])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        out = call()
        torch.cuda.synchronize()
    finally:
        trace = getattr(engine, attr)
        setattr(engine, attr, None)
    return out, dict(engine.last_decode_stats), trace, \
        (time.perf_counter() - t0) * 1e3


def _graph_runs(label, part, engine, call, name, runs):
    """The decode of `call` by graph replay beside its eager run
    runs[name]: twice (the first call captures, the second only
    replays), stored as runs[name + "_graph"] with the second's ms and
    the first's as capture_ms."""
    out = []
    for _ in range(2):
        res, st, trace, ms = _timed_decode(engine, call, replay=True)
        out.append({"texts": [res if isinstance(res, str) else None],
                    "n": [st["tokens"]], "stats": st, "trace": trace,
                    "ms": ms})
    run = out[1]
    run["capture_ms"] = out[0]["ms"]
    runs[name + "_graph"] = run
    _log_run(label, f"{part} {name} graph", run)


def _graph_vs_eager(label, runs):
    """Each decode by graph replay against its eager run: the same tokens
    and forwards, or a near-tie difference (_equivalent). Returns {name:
    difference or None}."""
    out = {}
    for name in [n for n in runs if not n.endswith("_graph")]:
        eager, graph = runs[name], runs[name + "_graph"]
        d = _equivalent(f"{label} {name} graph against eager", eager, graph)
        if d is None and graph["stats"]["forwards"] != \
                eager["stats"]["forwards"]:
            raise AssertionError(
                f"{label} {name}: graph replay took "
                f"{graph['stats']['forwards']} forwards, eager "
                f"{eager['stats']['forwards']}")
        out[name] = d
    return out


def _row_tokens(run, row=0):
    """The generated tokens of one traced decode row (n of them)."""
    _, tok = _trace_reader(run["trace"], row)
    return [tok(p) for p in range(run["n"][row])]


def _oracle_row(tokens, width, eos):
    row = np.full(width, eos, np.int32)
    row[:len(tokens)] = tokens
    return row


def _log_run(label, name, run):
    st = run["stats"]
    log(f"[{label} {name}] {st['forwards']} forwards, {st['tokens']} "
        f"tokens, {st['tokens_per_forward']:.4f} tokens per forward after "
        f"the first, {run['ms']:.1f} ms per answer")


def _free_form_variants(label, vqa, image):
    """Greedy, template, oracle and prompt-lookup free-form answers of one
    image, FREE_FORM_TOKENS at most."""
    from vstar_tpu_torch.data.preprocess import expand2square
    squared = expand2square(image)[0]
    runs = {}

    def run(name):
        def call():
            return vqa.free_form(squared, QUESTION,
                                 max_new_tokens=FREE_FORM_TOKENS)
        text, st, trace, ms = _timed_decode(vqa, call)
        runs[name] = {"texts": [text], "n": [st["tokens"]], "stats": st,
                      "trace": trace, "ms": ms}
        _log_run(label, f"free-form {name}", runs[name])
        _graph_runs(label, "free-form", vqa, call, name, runs)

    template = vqa._spec_template
    vqa._spec_template = None
    try:
        run("greedy")
    finally:
        vqa._spec_template = template
    run("template")
    # oracles: greedy's own tokens, and the template run's (the verify
    # path's own rounding, which a near-tie can part from greedy's)
    for name, source in (("oracle", "greedy"), ("oracle_verify", "template")):
        row = _oracle_row(_row_tokens(runs[source]),
                          FREE_FORM_TOKENS + vqa.spec_chunk, vqa.eos_id)
        vqa._template_draft = lambda max_new_tokens, row=row: row
        try:
            run(name)
        finally:
            del vqa._template_draft
    vqa.prompt_lookup = True
    try:
        run("lookup")
    finally:
        vqa.prompt_lookup = False
    return runs


def _detect_variants(label, vsm_engine, image):
    """Greedy, template and oracle detections of one image, on a VSM
    engine sharing the resident one's weights with DETECT_TOKENS new
    tokens."""
    from vstar_tpu_torch.search.engine import VSMEngine
    eng = VSMEngine(vsm_engine.params, vsm_engine.cfg, vsm_engine.tokenizer,
                    loc_token_id=vsm_engine.loc_token_id,
                    device=vsm_engine.device, eos_id=vsm_engine.eos_id,
                    max_new_tokens=DETECT_TOKENS,
                    prompt_buckets=vsm_engine.prompt_buckets,
                    compute_dtype=vsm_engine.compute_dtype)
    template = eng._draft_row
    runs = {}

    def run(name, draft):
        eng._draft_row = draft

        def call():
            out = eng.detect(image, "red mug")
            if not all(np.isfinite(x).all() for x in out):
                raise AssertionError(f"{label} detect {name}: non-finite "
                                     "output")
            return None
        _, st, trace, ms = _timed_decode(eng, call)
        runs[name] = {"texts": [None], "n": [st["tokens"]], "stats": st,
                      "trace": trace, "ms": ms}
        _log_run(label, f"detect {name}", runs[name])
        _graph_runs(label, "detect", eng, call, name, runs)

    run("greedy", None)
    run("template", template)
    for name, source in (("oracle", "greedy"), ("oracle_verify", "template")):
        run(name, _oracle_row(_row_tokens(runs[source]),
                              DETECT_TOKENS + eng.spec_chunk, eng.eos_id))
    return runs


def _check_oracle(label, source, oracle, chunk):
    """An oracle draft (the tokens of `source`, unshifted) is accepted:
    the forwards that decided its first p tokens are at most
    ceil((p - 1) / (chunk - 1)) + 1, p being all its tokens or, where the
    oracle's decode left the draft at a near-tie (the equivalence rule),
    the position where it did. Returns (p, those forwards, the bound)."""
    n = source["n"][0]
    p = _first_difference(source, oracle)
    p = n if p is None else p
    starts = [int(s[0]) for s, _ in oracle["trace"][1:]]  # [0]: prefill
    used = sum(s < p for s in starts)
    most = math.ceil((p - 1) / (chunk - 1)) + 1
    log(f"[{label}] {used} forwards decided the first {p} of {n} tokens "
        f"(at most {most}); {oracle['stats']['forwards']} in all")
    if used > most:
        raise AssertionError(f"{label}: the oracle draft took {used} "
                             f"forwards for {p} tokens, more than {most}")
    return {"accepted_tokens": p, "forwards": used, "bound": most}


def _summary(runs, differences):
    return {name: {"forwards": r["stats"]["forwards"],
                   "tokens": r["stats"]["tokens"],
                   "tokens_per_forward": r["stats"]["tokens_per_forward"],
                   "ms": r["ms"], "difference": differences.get(name)}
            for name, r in runs.items()}


def _many_check(label, vqa, images):
    """free_form_many at B = 4 against each row's free_form (template),
    MANY_TOKENS a row, under the equivalence rule."""
    from vstar_tpu_torch.data.preprocess import expand2square
    squared = [expand2square(im)[0] for im in images]
    texts, st, trace, ms = _timed_decode(vqa, lambda: vqa.free_form_many(
        squared, MANY_QUESTIONS, max_new_tokens=MANY_TOKENS))
    batch = {"texts": texts, "trace": trace, "stats": st, "ms": ms}
    log(f"[{label} free_form_many B=4] {st['forwards']} forwards, "
        f"{st['tokens']} tokens, {ms:.1f} ms")
    differences = []
    for b in range(len(images)):
        text, sst, strace, _ = _timed_decode(vqa, lambda: vqa.free_form(
            squared[b], MANY_QUESTIONS[b], max_new_tokens=MANY_TOKENS))
        single = {"texts": [text], "n": [sst["tokens"]], "trace": strace}
        differences.append(_equivalent(f"{label} free_form_many row {b}",
                                       single, batch, row=b))
    return {"forwards": st["forwards"], "tokens": st["tokens"], "ms": ms,
            "differences": differences}


def _synthetic_eval(label, vqa, vsm_engine, image_batch=None,
                    n_per_task=1):
    """The synthetic V*Bench (1024x1024 images, n_per_task a task) through
    the port's eval_model at the disclosed budgets: a record per image and
    the accuracy lines (random weights decide nothing). image_batch > 1
    runs the batched loop (eval_model_batched), which prints images/s
    without per-image latencies; images/s is then images over wall time."""
    import contextlib
    import re
    from vstar_tpu_torch.eval import synthetic, vstar_bench
    ff_budget, search_budget = SYNTHETIC_BUDGETS
    if vsm_engine.max_new_tokens != search_budget:
        raise AssertionError(f"the VSM decodes {vsm_engine.max_new_tokens} "
                             f"tokens, not the search budget {search_budget}")
    tag = f"{label} synthetic eval_model" + (
        f" image_batch={image_batch}" if image_batch else "")
    with tempfile.TemporaryDirectory() as work:
        bench = os.path.join(work, "bench")
        specs = synthetic.make_synthetic_benchmark(bench,
                                                   n_per_task=n_per_task)
        out_path = os.path.join(work, "eval_result.json")
        argv = ["--benchmark-folder", bench, "--output-path", out_path]
        if image_batch:
            argv += ["--image-batch", str(image_batch)]
        args = vstar_bench.build_parser().parse_args(argv)
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            results, per_type, latencies = vstar_bench.eval_model(
                args, Budget(vqa, ff_budget), vsm_engine)
        wall = time.perf_counter() - t0
        with open(out_path) as f:
            written = json.load(f)
    lines = printed.getvalue().strip().splitlines()
    for line in lines:
        log(f"[{tag}] {line}")
    recs = [r for task in written.values() for r in task]
    if len(recs) != len(specs) or any(
            "option_chosen" not in r or "image" not in r for r in recs):
        raise AssertionError(f"{label}: eval_model wrote {written}")
    printed_rate = [float(m) for m in re.findall(r"([0-9.]+) images/s",
                                                 printed.getvalue())]
    if len(printed_rate) != 1 or len(lines) < 4:
        raise AssertionError(f"{label}: no accuracy lines: {lines}")
    if latencies is None:
        report = {"images": len(recs), "images_per_s": len(recs) / wall,
                  "printed_images_per_s": printed_rate[0],
                  "image_batch": image_batch}
    else:
        report = {"images": len(recs),
                  "images_per_s": 1.0 / float(np.mean(latencies)),
                  "p50_s": float(np.percentile(latencies, 50)),
                  "latencies_s": latencies}
    log(f"[{tag}] {len(recs)} images in {wall:.2f} s, "
        f"{report['images_per_s']:.4f} images/s")
    return report


def phase_decode_slice(label, vqa, vsm_engine, kernels):
    """The slice on resident engines, its counts zeroed before it and read
    after: a free-form request over HTTP (no options) and a forced-search
    free-form flow; greedy, template, oracle and prompt-lookup decodes of
    one 2048x1536 free-form answer and detection, each drafted one held
    to greedy by the card's equivalence rule; free_form_many at B = 4;
    the synthetic V*Bench through eval_model. K1's split route takes the
    8-row verify chunks."""
    from vstar_tpu_torch.kernels import flash_attention as fa
    from vstar_tpu_torch.serve.server import SealService
    t_phase = time.perf_counter()
    img_2k = _image(1536, 2048, SEED + 1)
    vsm = CountingVSM(vsm_engine)
    _zero_counts()
    report = {}

    t0 = time.perf_counter()
    status, rec = _http_answer(SealService(vqa, vsm), img_2k, QUESTION, None)
    ms = (time.perf_counter() - t0) * 1e3
    if status != 200 or set(rec) != FREEFORM_KEYS:
        raise AssertionError(f"{label}: free-form HTTP {status}: {rec}")
    log(f"[{label} free-form http] {ms:.1f} ms, answer "
        f"{len(rec['answer'].split())} words, server latency "
        f"{rec['latency_s']} s")
    report["http_free_form_ms"] = ms
    t0 = time.perf_counter()
    rec = SealService(ForcedTrigger(vqa), vsm, max_search_steps=3).answer(
        img_2k, QUESTION)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if set(rec) != FREEFORM_KEYS or rec["missing_objects"] != ["red mug"]:
        raise AssertionError(f"{label}: forced free-form flow gave {rec}")
    log(f"[{label} forced-search free-form flow] {ms:.1f} ms, failed "
        f"{rec['failed_objects']}, search_result {rec['search_result']}")
    report["forced_free_form_flow_ms"] = ms

    for part, variants in (("free_form", _free_form_variants),
                           ("detect", _detect_variants)):
        both = variants(label, vqa if part == "free_form" else vsm_engine,
                        img_2k)
        tag = f"{label} {part.replace('_', '-')}"
        graph_diffs = _graph_vs_eager(tag, both)
        runs = {n: r for n, r in both.items() if not n.endswith("_graph")}
        diffs = {name: _equivalent(f"{tag} {name}", runs["greedy"], run)
                 for name, run in runs.items() if name != "greedy"}
        report[part] = _summary(runs, diffs)
        report[part + "_graph"] = {
            name: {"forwards": both[name + "_graph"]["stats"]["forwards"],
                   "tokens": both[name + "_graph"]["stats"]["tokens"],
                   "ms": both[name + "_graph"]["ms"],
                   "capture_ms": both[name + "_graph"]["capture_ms"],
                   "eager_ms": runs[name]["ms"],
                   "ms_per_forward": both[name + "_graph"]["ms"] / max(
                       both[name + "_graph"]["stats"]["forwards"], 1),
                   "eager_ms_per_forward": runs[name]["ms"] / max(
                       runs[name]["stats"]["forwards"], 1),
                   "difference": graph_diffs[name]}
            for name in runs}
        for name, r in report[part + "_graph"].items():
            log(f"[{tag} {name}] graph {r['ms']:.1f} ms ("
                f"{r['ms_per_forward']:.2f} ms a forward; the capturing "
                f"call {r['capture_ms']:.1f} ms) against eager "
                f"{r['eager_ms']:.1f} ms ({r['eager_ms_per_forward']:.2f} "
                f"ms a forward), {r['forwards']} forwards")
        for name, source in (("oracle", "greedy"),
                             ("oracle_verify", "template")):
            report[part][name]["acceptance"] = _check_oracle(
                f"{tag} {name}", runs[source], runs[name], 8)
    del runs, both
    images = [img_2k] + [_image(1536, 2048, SEED + 10 + i) for i in range(3)]
    report["free_form_many"] = _many_check(label, vqa, images)
    report["synthetic"] = _synthetic_eval(label, vqa, vsm_engine)

    counts = _check_path(f"{label} slice", kernels)
    counts["flash_attention_routes"] = _check_routes(
        f"{label} slice", {"split": None, "combine": None})
    by_rows = dict(fa.split_launches_by_rows)
    if by_rows.get(8, 0) <= 0 or \
            counts["flash_attention_routes"]["split"] != \
            counts["flash_attention_routes"]["combine"]:
        raise AssertionError(f"{label} slice: K1 split launches by rows "
                             f"{by_rows}, routes "
                             f"{counts['flash_attention_routes']}")
    counts["flash_attention_split_by_rows"] = by_rows
    log(f"[{label} slice] K1 split launches by query rows {by_rows}")
    log(f"[{label} slice] decode graphs: VQA {vqa.graphs.captures} "
        f"captured, {vqa.graphs.replays} replays, caches "
        f"{vqa.graphs.cache_bytes() / 2**20:.0f} MiB; VSM "
        f"{vsm_engine.graphs.captures} captured, caches "
        f"{vsm_engine.graphs.cache_bytes() / 2**20:.0f} MiB; reserved "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB")
    log(f"[time] {label} decode slice {time.perf_counter() - t_phase:.1f} s")
    report["differences_near_tie"] = sum(
        d is not None for part in ("free_form", "detect", "free_form_graph",
                                   "detect_graph")
        for d in (v["difference"] for v in report[part].values())) + sum(
        d is not None for d in report["free_form_many"]["differences"])
    return counts, report


# ---------------------------------------------------------------------------
# Phase 5c: the lockstep search (BatchedVSMEngine, run_batched_searches)
# ---------------------------------------------------------------------------

LOCKSTEP_NAMES = ["red mug", "bicycle", "street sign", "dog"]
# JAX's content tolerances of device against host preprocessing
# (tests/test_batched_search.py:163-166): (mean, max) |difference|
CANVAS_TOL = {"clip": (0.04, 0.6), "owl": (0.03, 0.5)}


def _noise(h, w, seed):
    from PIL import Image
    return Image.fromarray((np.random.RandomState(seed).rand(h, w, 3)
                            * 255).astype(np.uint8))


def _candidate_scores(path, k):
    """{bbox: score} of the patches the search could visit as its step k:
    the unvisited children of path[:k], scored as visual_search_gen
    pushes them (ancestor-accumulated heatmap mass)."""
    from vstar_tpu_torch.search.policy import (get_sub_patches,
                                               get_subpatch_scores,
                                               split_4subpatches)
    out = {}
    for step in path[:k]:
        subs, _, _ = get_sub_patches(step.bbox,
                                     *split_4subpatches(step.bbox))
        scores = [0.0] * len(subs)
        tmp = step
        while True:
            sub = get_subpatch_scores(tmp.final_heatmap, tmp.bbox, subs)
            scores = [sc + s_ / 4 ** tmp.scale_level
                      for sc, s_ in zip(scores, sub)]
            if tmp.parent_index == -1:
                break
            tmp = path[tmp.parent_index]
        out.update({tuple(b): sc for b, sc in zip(subs, scores)})
    for step in path[1:k]:
        out.pop(tuple(step.bbox))
    return out


def _same_search(label, serial, lockstep, lockstep_scores=None):
    """The lockstep search visits the serial search's patches, or parts
    from it first at a near-tie: at the first differing step k the two
    chosen patches' scores in the serial run are closer (margin) than
    the largest difference between the two runs' values of those two
    scores. lockstep_scores: {bbox: score} of every patch the `lockstep`
    run queued, where its path holds no heatmaps (the compiled search's
    queue). Returns the difference, or None."""
    k = next((i for i, (a, b) in enumerate(zip(serial, lockstep))
              if a.bbox != b.bbox), None)
    if k is None:
        if len(serial) != len(lockstep):
            raise AssertionError(f"{label}: paths of {len(serial)} and "
                                 f"{len(lockstep)} steps")
        return None
    cs = _candidate_scores(serial, k)
    cl = _candidate_scores(lockstep, k) if lockstep_scores is None \
        else lockstep_scores
    a, b = tuple(serial[k].bbox), tuple(lockstep[k].bbox)
    if cs[a] != serial[k].score or (lockstep_scores is None
                                    and cl[b] != lockstep[k].score):
        raise AssertionError(f"{label}: candidate scores {cs[a]}, {cl[b]} "
                             f"are not the policy's {serial[k].score}, "
                             f"{lockstep[k].score}")
    diff = {"step": k, "serial_patch": list(a), "lockstep_patch": list(b),
            "margin": cs[a] - cs[b],
            "max_score_diff": max(abs(cs[a] - cl[a]), abs(cs[b] - cl[b]))}
    log(f"[{label}] first difference at step {k}: serial {a} against "
        f"lockstep {b}, margin {diff['margin']:.6g}, largest score "
        f"difference {diff['max_score_diff']:.6g}")
    if not diff["margin"] < diff["max_score_diff"]:
        raise AssertionError(f"{label}: lockstep differs from serial beyond "
                             f"rounding: {diff}")
    return diff


class WaveLog:
    """Records the rows of every BatchedVSMEngine wave (_run_many)."""

    def __init__(self, engine):
        self.engine, self.rows = engine, []
        self._orig = engine._run_many

    def __enter__(self):
        def run_many(patches, questions):
            self.rows.append(len(patches))
            return self._orig(patches, questions)
        self.engine._run_many = run_many
        return self

    def __exit__(self, *exc):
        del self.engine._run_many


def _engine_like(e, params=None, device_preprocess=False, kv_int8=False):
    """A BatchedVSMEngine like e, on e's weights or on params."""
    from vstar_tpu_torch.search.batched import BatchedVSMEngine
    return BatchedVSMEngine(e.params if params is None else params, e.cfg,
                            e.tokenizer, loc_token_id=e.loc_token_id,
                            device=e.device, eos_id=e.eos_id,
                            max_new_tokens=e.max_new_tokens,
                            prompt_buckets=e.prompt_buckets,
                            compute_dtype=e.compute_dtype,
                            device_preprocess=device_preprocess,
                            kv_int8=kv_int8)


def _tilted_engine(e):
    """A BatchedVSMEngine on e's weights with its embedding and lm_head
    tilted, as tests/test_torch_slice.py tilts the tiny VSM, so that the
    random model answers [LOC] at every step and the heads and heatmaps
    run on every patch: +100 on embedding channel 0 keeps channel 0 of
    the final hidden state large, and lm_head[0, [LOC]] = 10 reads it
    (copies of the two tensors). An int4 lm_head gets the same weight
    through its packing: column [LOC] of the first group becomes (10, 0,
    ..., 0), row 0's low nibble 7 at scale 10 / 7."""
    loc = e.loc_token_id
    llama = dict(e.params["llama"])
    llama["embed_tokens"] = llama["embed_tokens"].clone()
    llama["embed_tokens"][:, 0] += 100
    head = llama["lm_head"]
    if isinstance(head, torch.Tensor):
        head = head.clone()
        head[0, loc] = 10
    else:
        q4, s4 = head["q4"].clone(), head["s4"].clone()
        q4[:q4.shape[0] // s4.shape[0], loc] = 0
        q4[0, loc] = 7
        s4[0, loc] = 10 / 7
        head = {"q4": q4, "s4": s4}
    llama["lm_head"] = head
    return _engine_like(e, dict(e.params, llama=llama))


def _shapes():
    """K1's launches by (batch, query rows) and K2's by batch."""
    from vstar_tpu_torch.kernels import flash_attention as fa
    from vstar_tpu_torch.kernels import tower_attention as ta
    return ({f"{b}x{q}": n for (b, q), n in sorted(fa.launches_by_shape
                                                   .items())},
            dict(sorted(ta.launches_by_batch.items())))


def _batch_bucket(n):
    from vstar_tpu_torch.search.batched import _batch_bucket
    return _batch_bucket(n)


def _check_lockstep_path(path, kernels, batch):
    """_check_path, and K1 and K2 launched at the wave's batch bucket."""
    counts = _check_path(path, kernels)
    k1, k2 = _shapes()
    log(f"[{path}] K1 launches by (batch x query rows) {k1}, K2 launches "
        f"by batch {k2}, K1 routes {_routes()}")
    if k2.get(batch, 0) <= 0 or not any(
            key.startswith(f"{batch}x") for key in k1):
        raise AssertionError(f"{path}: K1 / K2 did not launch at batch "
                             f"{batch}: {k1}, {k2}")
    counts["flash_attention_by_shape"] = k1
    counts["tower_attention_by_batch"] = k2
    counts["flash_attention_routes"] = _routes()
    return counts


def _lockstep_vs_serial(label, vsm_engine, kernels):
    """Part (a): four forced 3-step searches on four seeded 2048x1536
    noise images through run_batched_searches (waves of 4 rows) and one
    serial visual_search each, on the same engine; the paths held to each
    other by _same_search."""
    from vstar_tpu_torch.search.batched import run_batched_searches
    from vstar_tpu_torch.search.policy import visual_search
    images = [_noise(1536, 2048, SEED + 20 + i)
              for i in range(len(LOCKSTEP_NAMES))]
    kw = dict(smallest_size=224, max_steps=3, **FORCED_SEARCH)
    # the first 4-row wave pays cuBLAS's and the allocator's set-up
    vsm_engine.detect_many(images, LOCKSTEP_NAMES)
    _zero_counts()
    paths = [[] for _ in images]
    with WaveLog(vsm_engine) as waves:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lock = run_batched_searches(vsm_engine, images, LOCKSTEP_NAMES,
                                    path_outs=paths, **kw)
        torch.cuda.synchronize()
        lock_s = time.perf_counter() - t0
    serial_paths = [[] for _ in images]
    t0 = time.perf_counter()
    serial = [visual_search(vsm_engine, im, name, path_out=p, **kw)
              for im, name, p in zip(images, LOCKSTEP_NAMES, serial_paths)]
    torch.cuda.synchronize()
    serial_s = time.perf_counter() - t0
    counts = _check_lockstep_path(f"{label} lockstep (a)", kernels,
                                  _batch_bucket(len(images)))
    differences = []
    for i, name in enumerate(LOCKSTEP_NAMES):
        if len(paths[i]) != 3:
            raise AssertionError(f"{label} lockstep {name}: {paths[i]}")
        differences.append(_same_search(f"{label} lockstep {name}",
                                        serial_paths[i], paths[i]))
        log(f"[{label} lockstep {name}] patches {[s.bbox for s in paths[i]]}"
            f", serial {[s.bbox for s in serial_paths[i]]}; (path length, "
            f"success) {lock[i][1:3]}, serial {serial[i][1:3]}")
    log(f"[{label} lockstep (a)] 4 forced 3-step searches: lockstep "
        f"{lock_s:.3f} s in {len(waves.rows)} waves of {waves.rows} rows, "
        f"serial {serial_s:.3f} s ({serial_s / lock_s:.2f}x)")
    if waves.rows != [len(images)] * 3:
        raise AssertionError(f"{label}: lockstep waves {waves.rows}")
    return counts, {"lockstep_s": lock_s, "serial_s": serial_s,
                    "waves": waves.rows, "differences": differences}


def _device_preprocess_part(label, vsm_engine, kernels):
    """Part (b): a device-preprocess engine on vsm_engine's weights. Its
    tower inputs (a 2048x1536 image's canvas, the CLIP square window and
    the OWL-ViT crop of four patches) against the host's, within JAX's
    content tolerances where the window shrinks; detect_many on the
    PatchRefs beside the host patches; one forced search end to end after
    prefetch_canvas."""
    from vstar_tpu_torch.data.preprocess import (clip_preprocess,
                                                 expand2square,
                                                 owlvit_preprocess)
    from vstar_tpu_torch.kernels import image_ops
    from vstar_tpu_torch.search.batched import run_batched_searches
    from vstar_tpu_torch.search.policy import PatchRef
    e = vsm_engine
    dev = _engine_like(e, device_preprocess=True)
    img = _image(1536, 2048, SEED + 30)
    # the first three windows shrink for both towers, as the window of
    # JAX's bounds does; the fourth (a step-3 patch) grows for OWL-ViT,
    # where the cubic kernel reads the mask's mean colour past the crop's
    # edge and PIL's crop replicates the edge (logged, not bounded)
    refs = [PatchRef(img, b) for b in ([0, 0, 2048, 1536],
                                       [1024, 0, 1024, 768],
                                       [400, 300, 900, 800],
                                       [300, 900, 512, 384])]
    _zero_counts()
    canvas = dev._canvas(img)
    clip, owl = image_ops.pair_windows(
        canvas, [image_ops.square_window(r.bbox) for r in refs],
        [r.bbox for r in refs], e.cfg.vision.image_size,
        e.cfg.owl_vision.image_size)
    content = []
    for j, r in enumerate(refs):
        crop = r.pil()
        for tower, got, want in (
                ("clip", clip[j], clip_preprocess(expand2square(crop)[0],
                                                  e.cfg.vision.image_size)),
                ("owl", owl[j], owlvit_preprocess(
                    crop, e.cfg.owl_vision.image_size))):
            d = np.abs(got.cpu().numpy() - want)
            mean_tol, max_tol = CANVAS_TOL[tower]
            bounded = j < 3
            content.append({"patch": r.bbox, "tower": tower,
                            "mean": float(d.mean()), "max": float(d.max()),
                            "bounded": bounded})
            log(f"[{label} device preprocess] {tower} {r.bbox}: mean "
                f"{d.mean():.4g}, max {d.max():.4g}" + (
                    f" (tol {mean_tol}, {max_tol})" if bounded else
                    " (upscaled: not bounded)"))
            if bounded and not (d.mean() < mean_tol and d.max() < max_tol):
                raise AssertionError(f"{label}: device {tower} input of "
                                     f"{r.bbox} off the host's")
    names = LOCKSTEP_NAMES[:len(refs)]
    got = dev.detect_many(refs, names)
    want = e.detect_many([r.pil() for r in refs], names)
    heads = []
    for (gb, gl, gh), (wb, wl, wh) in zip(got, want):
        if gb.shape != wb.shape or gh.shape != wh.shape or not all(
                np.isfinite(x).all() for x in (gb, gl, gh)):
            raise AssertionError(f"{label}: device detect_many gave "
                                 f"{gb.shape} {gh.shape} against host "
                                 f"{wb.shape} {wh.shape}")
        heads.append({"scores": float(np.abs(gl - wl).max(initial=0)),
                      "boxes": float(np.abs(gb - wb).max(initial=0)),
                      "heatmap": float(np.abs(gh - wh).max(initial=0))})
    log(f"[{label} device preprocess] detect_many device against host "
        f"patches, largest |difference|: {heads}")
    search_img = _image(1536, 2048, SEED + 31)
    dev.prefetch_canvas(search_img)
    path = []
    t0 = time.perf_counter()
    res = run_batched_searches(dev, [search_img], ["red mug"],
                               path_outs=[path], smallest_size=224,
                               max_steps=3, **FORCED_SEARCH)
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    if len(path) != 3 or dev._canvas_inflight \
            or id(search_img) not in dev._canvas_cache:
        raise AssertionError(f"{label}: device search visited {path}, "
                             f"inflight {dev._canvas_inflight}")
    log(f"[{label} device preprocess] prefetched forced search: "
        f"{search_s:.3f} s, patches {[s.bbox for s in path]}, result "
        f"{res[0][1:3]}")
    counts = _check_lockstep_path(f"{label} lockstep (b)", kernels,
                                  _batch_bucket(len(refs)))
    return counts, {"content": content, "heads": heads,
                    "search_s": search_s}


def _three_objects(label, vqa, vsm_engine, kernels):
    """Part (c): one sample with three missing objects: their forced
    3-step searches through run_search_phase (three waves of 3 rows) and
    the focused option scoring with the three crops."""
    from vstar_tpu_torch.eval.batched_bench import (build_focus_inputs,
                                                    run_search_phase)
    img = _image(1536, 2048, SEED + 40)
    missing = LOCKSTEP_NAMES[:3]
    _zero_counts()
    with WaveLog(vsm_engine) as waves:
        t0 = time.perf_counter()
        srs, failed = run_search_phase(vsm_engine, [img], [missing],
                                       max_search_steps=3, **FORCED_SEARCH)
        squared, q, crops, il, ol = build_focus_inputs(vqa, img, QUESTION,
                                                       srs[0])
        chosen = vqa.multiple_choice(squared, q, OPTIONS, crops,
                                     images_long=il, objects_long=ol)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    log(f"[{label} three missing objects] {ms:.1f} ms, waves {waves.rows}, "
        f"search_result {srs[0]}, failed {failed[0]}, option {chosen}")
    if waves.rows != [3, 3, 3] or chosen not in range(len(OPTIONS)):
        raise AssertionError(f"{label}: three-object sample: waves "
                             f"{waves.rows}, option {chosen}")
    counts = _check_lockstep_path(f"{label} lockstep (c)", kernels,
                                  _batch_bucket(len(missing)))
    return counts, {"ms": ms, "waves": waves.rows,
                    "boxes": len(srs[0]), "option_chosen": chosen}


def phase_lockstep(label, vqa, vsm_engine, kernels, full):
    """The lockstep search on resident engines, each part's counts zeroed
    before it and read after: (a) lockstep against serial forced searches;
    with full, also (b) the device canvas path, (c) a sample with three
    missing objects and (d) the synthetic V*Bench through
    eval_model_batched at image_batch 2. Parts (a)-(c) run on the VSM
    tilted to answer [LOC] (_tilted_engine), so that the heatmaps, and
    with them the search's choices, are not all zero."""
    t0 = time.perf_counter()
    by_part, report = {}, {}
    tilted = _tilted_engine(vsm_engine)
    by_part["a"], report["lockstep_vs_serial"] = _lockstep_vs_serial(
        label, tilted, kernels)
    if full:
        by_part["b"], report["device_preprocess"] = \
            _device_preprocess_part(label, tilted, kernels)
        by_part["c"], report["three_objects"] = _three_objects(
            label, vqa, tilted, kernels)
        del tilted
        # random weights ask for no search here: K1 only
        _zero_counts()
        report["synthetic_batched"] = _synthetic_eval(
            label, vqa, vsm_engine, image_batch=2, n_per_task=2)
        by_part["d"] = _check_path(f"{label} lockstep (d)",
                                   ("flash_attention",))
    log(f"[time] {label} lockstep phase {time.perf_counter() - t0:.1f} s")
    return by_part, report


# ---------------------------------------------------------------------------
# Phase 5d: the compiled search (search/compiled.CompiledVSMSearch)
# ---------------------------------------------------------------------------

class QueueLog:
    """The compiled search's queued scores: every state whose path record
    is packed (pack_record), read as {bbox: score} per row."""

    def __init__(self):
        from vstar_tpu_torch.search import compiled
        self.mod, self.states = compiled, []
        self._orig = compiled.pack_record

    def __enter__(self):
        def pack(state):
            self.states.append(state)
            return self._orig(state)
        self.mod.pack_record = pack
        return self

    def __exit__(self, *exc):
        self.mod.pack_record = self._orig

    def scores(self, row=0, state=-1):
        st = self.states[state]
        if st.n_path.dim() == 0:
            st = type(st)(*(a[None] for a in st))
        n = int(st.counter[row])
        boxes = st.q_bbox[row, :n].tolist()
        return {tuple(b): float(v)
                for b, v in zip(boxes, st.q_score[row, :n].tolist())}


def phase_compiled(label, vsm_engine, kernels, full):
    """The compiled search at the full widths on a device-preprocess
    engine with the VSM tilted to answer [LOC] (_tilted_engine):
    warmup_compiled at the 2048x1536 canvas bucket (timed) and the
    lockstep reference runs, then four forced 3-step searches on 2K noise
    through `search` one at a time and through `search_many` at B = 4,
    each held to the lockstep path by _same_search; with full, one search
    on the untilted VSM whose weak heatmaps take the context cue in its
    steps (no engine wave). The counts are zeroed just before each of
    these three and read just after, so each part's launches are its
    own. Logs each search's host reads."""
    from vstar_tpu_torch.search.batched import run_batched_searches
    from vstar_tpu_torch.search.compiled import (CompiledVSMSearch,
                                                 warmup_compiled)
    t_phase = time.perf_counter()
    tilted = _engine_like(_tilted_engine(vsm_engine),
                          device_preprocess=True)
    comp = CompiledVSMSearch(tilted)
    images = [_noise(1536, 2048, SEED + 20 + i)
              for i in range(len(LOCKSTEP_NAMES))]
    kw = dict(max_steps=3, **FORCED_SEARCH)
    report, by_part = {}, {}
    t0 = time.perf_counter()
    warm = []
    warmup_compiled(comp, canvas_sizes=((1536, 2048),),
                    batch_buckets=comp.BATCH_BUCKETS, log=warm.append)
    torch.cuda.synchronize()
    report["warmup_s"] = time.perf_counter() - t0
    for line in warm:
        log(f"[{label} compiled] {line}")
    log(f"[{label} compiled] warmup_compiled at 2048x1536, batch buckets "
        f"{comp.BATCH_BUCKETS}: {report['warmup_s']:.3f} s, "
        f"{tilted.graphs.captures} decode graphs captured, static caches "
        f"{tilted.graphs.cache_bytes() / 2**20:.0f} MiB, reserved "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB")

    lock_paths = [[] for _ in images]
    run_batched_searches(tilted, images, LOCKSTEP_NAMES,
                         path_outs=lock_paths, smallest_size=224, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_batched_searches(tilted, images, LOCKSTEP_NAMES, smallest_size=224,
                         **kw)
    torch.cuda.synchronize()
    report["lockstep_s"] = time.perf_counter() - t0

    from vstar_tpu_torch.kernels.int8_matmul import MAX_ROWS

    def window(part, batch):
        # K3 serves decode rows only (R <= 16): the 8-row verify chunks
        # of B = 4 searches have 32, whose int8 matrices take the
        # dequantized product, as JAX's int8 path above its row limit
        want = kernels if batch * tilted.spec_chunk <= MAX_ROWS else tuple(
            k for k in kernels if k != "int8_matvec")
        counts = _check_lockstep_path(f"{label} compiled {part}", want,
                                      batch)
        counts["flash_attention_routes"] = _check_routes(
            f"{label} compiled {part}", {"split": None, "combine": None})
        by_part[part] = counts

    serial_paths, serial_reads = [[] for _ in images], []
    with QueueLog() as queues:
        _zero_counts()
        t0 = time.perf_counter()
        for im, name, p in zip(images, LOCKSTEP_NAMES, serial_paths):
            comp.search(im, name, smallest_size=224, path_out=p, **kw)
            serial_reads.append(comp.last_host_reads)
        torch.cuda.synchronize()
        report["search_s"] = time.perf_counter() - t0
        window("search", 1)
    serial_scores = [queues.scores(0, i) for i in range(len(images))]
    many_paths = [[] for _ in images]
    with QueueLog() as queues:
        _zero_counts()
        t0 = time.perf_counter()
        comp.search_many(images, LOCKSTEP_NAMES, [224] * len(images),
                         path_outs=many_paths, **kw)
        torch.cuda.synchronize()
        report["search_many_s"] = time.perf_counter() - t0
        window("search_many", _batch_bucket(len(images)))
    many_scores = [queues.scores(b) for b in range(len(images))]
    report["search_host_reads"] = serial_reads
    report["search_many_host_reads"] = comp.last_host_reads
    differences = []
    for i, name in enumerate(LOCKSTEP_NAMES):
        for how, paths, scores in (("search", serial_paths, serial_scores),
                                   ("search_many", many_paths, many_scores)):
            if len(paths[i]) != 3:
                raise AssertionError(f"{label} compiled {how} {name}: "
                                     f"{[s.bbox for s in paths[i]]}")
            differences.append(_same_search(
                f"{label} compiled {how} {name}", lock_paths[i], paths[i],
                scores[i]))
        log(f"[{label} compiled {name}] patches "
            f"{[s.bbox for s in serial_paths[i]]} (search), "
            f"{[s.bbox for s in many_paths[i]]} (search_many), lockstep "
            f"{[s.bbox for s in lock_paths[i]]}")
    report["differences"] = differences
    log(f"[{label} compiled] 4 forced 3-step searches: search "
        f"{report['search_s']:.3f} s ({serial_reads} host reads), "
        f"search_many B=4 {report['search_many_s']:.3f} s "
        f"({report['search_many_host_reads']} host reads), lockstep "
        f"{report['lockstep_s']:.3f} s")
    if full:
        plain = _engine_like(vsm_engine, device_preprocess=True)
        pcomp = CompiledVSMSearch(plain)
        img = _noise(1536, 2048, SEED + 50)
        path = []
        with WaveLog(plain) as waves:
            _zero_counts()
            t0 = time.perf_counter()
            res = pcomp.search(img, "red mug", smallest_size=224,
                               max_steps=2, path_out=path)
            torch.cuda.synchronize()
            ctx_s = time.perf_counter() - t0
            window("context_cue", 1)
        cues = [s.context_cue for s in path]
        log(f"[{label} compiled context cue] {ctx_s:.3f} s, path "
            f"{[s.bbox for s in path]}, cues {cues}, engine waves "
            f"{waves.rows}, {pcomp.last_host_reads} host reads, result "
            f"{res[1:3]}")
        if waves.rows or not any(cues):
            raise AssertionError(f"{label}: the context cue did not run in "
                                 f"the steps: waves {waves.rows}, cues "
                                 f"{cues}")
        report["context_cue"] = {"s": ctx_s, "cues": cues,
                                 "host_reads": pcomp.last_host_reads}
        del plain, pcomp
    log(f"[time] {label} compiled phase {time.perf_counter() - t_phase:.1f} "
        "s")
    return by_part, report


# ---------------------------------------------------------------------------
# Phase 5d: continuous serving (serve/continuous.py)
# ---------------------------------------------------------------------------

CONTINUOUS_REQUESTS = 8
# the decode budget of the continuous phase's answers (trigger and
# focused): on the card batched and single rows of the random 7B part at
# near-ties from token 2 on, so a short budget keeps the comparison short
CONTINUOUS_TOKENS = 16
CONTINUOUS_WINDOW_MS = 500.0


def _digest(image):
    import hashlib
    return hashlib.sha1(np.asarray(image)[::37, ::41].tobytes()).hexdigest()


class TracedTrigger:
    """A VQA engine for the continuous comparison: free_form and
    free_form_many decode CONTINUOUS_TOKENS at most; a first answer is
    replaced by the trigger for 'red mug' (as ForcedTrigger does), so that
    the serial SealService searches what the continuous service's
    missing_parser forces; every decode runs with a replay trace
    (decode/graphs.py: by graph replay, its logits written on the
    device), kept per question and row for the equivalence rule; option
    losses are kept per question for the options' near-tie rule."""

    def __init__(self, engine):
        self.engine, self.runs, self.losses = engine, {}, {}

    def __getattr__(self, name):
        return getattr(self.engine, name)

    @staticmethod
    def trigger():
        from vstar_tpu_torch.eval.seal import MISSING_OBJECTS_MSG
        return MISSING_OBJECTS_MSG + " red mug."

    def _decode(self, fn, questions):
        self.engine.replay_trace = []
        try:
            texts = fn()
        finally:
            trace, self.engine.replay_trace = self.engine.replay_trace, []
        many = isinstance(texts, list)
        texts = texts if many else [texts]
        for b, q in enumerate(questions):
            run = {"texts": texts, "trace": trace, "row": b}
            if not many:
                run["n"] = [self.engine.last_decode_stats["tokens"]]
            self.runs.setdefault(q, []).append(run)
        return [t if "Additional visual information" in q
                else self.trigger() for t, q in zip(texts, questions)]

    def free_form(self, image, question, **kw):
        kw.setdefault("max_new_tokens", CONTINUOUS_TOKENS)
        return self._decode(lambda: self.engine.free_form(
            image, question, **kw), [question])[0]

    def free_form_many(self, images, questions, **kw):
        kw.setdefault("max_new_tokens", CONTINUOUS_TOKENS)
        return self._decode(lambda: self.engine.free_form_many(
            images, questions, **kw), questions)

    def multiple_choice_many(self, images, questions, options_list, *a,
                             **kw):
        from vstar_tpu_torch.eval import vqa_engine as mod
        got, orig = [], mod.score_options

        def keep(*args, **kwargs):
            out = orig(*args, **kwargs)
            got.append(out[0].float().cpu())
            return out
        mod.score_options = keep
        try:
            chosen = self.engine.multiple_choice_many(
                images, questions, options_list, *a, **kw)
        finally:
            mod.score_options = orig
        for q, row in zip(questions, got[0]):
            self.losses[q] = row
        return chosen

    def multiple_choice(self, image, question, options, object_crops=None,
                        images_long=None, objects_long=None):
        return self.multiple_choice_many(
            [image], [question], [options],
            None if object_crops is None else [object_crops],
            None if images_long is None else [images_long],
            None if objects_long is None else [objects_long])[0]


class PathLog:
    """Forces every search of the SEAL paths (FORCED_SEARCH, 3 steps) and
    records each task's visited patches by its image's content: the
    searches of eval/seal.seal_answer and of eval/batched_bench.
    run_search_phase (the free-form flow and the continuous service)."""

    def __init__(self):
        self.paths = {}

    def __enter__(self):
        from vstar_tpu_torch.eval import batched_bench, seal
        self._mods = [(m, m.run_grouped_searches)
                      for m in (batched_bench, seal)]
        orig = self._mods[0][1]

        def run(engine, tasks, **kw):
            for t in tasks:
                t["path_out"] = self.paths.setdefault(
                    (_digest(t["image"]), t["name"]), [])
                t["path_out"].clear()
            return orig(engine, tasks, **{**kw, **FORCED_SEARCH,
                                          "max_steps": 3})
        for m, _ in self._mods:
            m.run_grouped_searches = run
        return self

    def __exit__(self, *exc):
        for m, f in self._mods:
            m.run_grouped_searches = f


def _continuous_requests():
    """CONTINUOUS_REQUESTS (JPEG bytes, decoded image, question, options)
    on 2048x1536 noise: the even ones with options, the odd ones
    free-form; every question names its request."""
    from PIL import Image
    out = []
    for i in range(CONTINUOUS_REQUESTS):
        buf = io.BytesIO()
        _noise(1536, 2048, SEED + 60 + i).save(buf, format="JPEG",
                                               quality=90)
        data = buf.getvalue()
        out.append((data, Image.open(io.BytesIO(data)).convert("RGB"),
                    f"{QUESTION} (request {i})",
                    OPTIONS if i % 2 == 0 else None))
    return out


def _post_all(port, requests):
    """The requests over HTTP at once, one client thread each: (records,
    client latencies in s)."""
    recs, lat = [None] * len(requests), [None] * len(requests)
    errors = []

    def go(i):
        data, _, question, options = requests[i]
        body = json.dumps({"image": base64.b64encode(data).decode(),
                           "question": question,
                           "options": options}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/answer", data=body,
            headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=600) as resp:
                recs[i] = (resp.status, json.loads(resp.read()))
        except Exception as e:   # reported below, and the phase fails
            errors.append(f"request {i}: {type(e).__name__}: {e}")
        lat[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"continuous requests failed: {errors}")
    for i, (status, rec) in enumerate(recs):
        if status != 200:
            raise AssertionError(f"request {i}: HTTP {status}: {rec}")
    return [rec for _, rec in recs], lat


def _focus_run(vqa, question):
    """The traced decode of `question`'s focused re-answer."""
    keys = [q for q in vqa.runs if question in q
            and "Additional visual information" in q]
    if len(keys) != 1 or len(vqa.runs[keys[0]]) != 1:
        raise AssertionError(f"focused answers of {question!r}: "
                             f"{[(k, len(vqa.runs[k])) for k in keys]}")
    return vqa.runs[keys[0]][0]


def _option_losses(vqa, question):
    keys = [q for q in vqa.losses if question in q]
    if len(keys) != 1:
        raise AssertionError(f"option losses of {question!r}: {keys}")
    return vqa.losses[keys[0]]


def _same_record_rules(label, i, request, want, got, serial_vqa, vqa,
                       serial_paths, paths):
    """Request i's continuous record against the serial one: every field
    equal, or parting at a near-tie (the lockstep rule for the search
    path, the equivalence rule for the focused answer, and for the
    option the serial losses' margin below the largest |loss
    difference|). Returns the near-ties found."""
    _, image, question, options = request
    ties = []
    if set(got) != set(want):
        raise AssertionError(f"{label} request {i}: keys {sorted(got)} "
                             f"against {sorted(want)}")
    key = (_digest(image), "red mug")
    d = _same_search(f"{label} request {i}", serial_paths[key], paths[key])
    if d is not None:
        ties.append(("search", d))
    if [r["name"] for r in got["search_result"]] != \
            [r["name"] for r in want["search_result"]]:
        raise AssertionError(f"{label} request {i}: search results "
                             f"{got['search_result']} against "
                             f"{want['search_result']}")
    box = max((float(np.abs(np.subtract(g["bbox"], w["bbox"])).max())
               for g, w in zip(got["search_result"], want["search_result"])),
              default=0.0)
    same = {"missing_objects", "search_result", "answer", "option_chosen",
            "correct", "failed_objects"}
    for k in set(want) - same:
        if got[k] != want[k]:
            raise AssertionError(f"{label} request {i}: {k} {got[k]!r} "
                                 f"against {want[k]!r}")
    if got["missing_objects"] != ["red mug"] or \
            want["missing_objects"] != ["red mug"]:
        raise AssertionError(f"{label} request {i}: missing objects "
                             f"{got['missing_objects']}")
    if options is None:
        if got["failed_objects"] != want["failed_objects"] and d is None:
            raise AssertionError(f"{label} request {i}: failed objects "
                                 f"{got['failed_objects']} against "
                                 f"{want['failed_objects']}")
        ref, run = _focus_run(serial_vqa, question), _focus_run(vqa, question)
        d = _equivalent(f"{label} request {i} focused answer", ref, run,
                        row=run["row"])
        if d is None and got["answer"] != want["answer"]:
            raise AssertionError(f"{label} request {i}: answers differ "
                                 "without a differing token")
        if d is not None:
            ties.append(("answer", d))
    elif got["option_chosen"] != want["option_chosen"]:
        ls = _option_losses(serial_vqa, question)
        lc = _option_losses(vqa, question)
        a, b = want["option_chosen"], got["option_chosen"]
        d = {"serial_option": a, "option": b,
             "margin": float(ls[b] - ls[a]),
             "max_loss_diff": float((ls - lc).abs().max())}
        log(f"[{label} request {i}] option {b} against serial {a}: margin "
            f"{d['margin']:.6g}, largest |loss difference| "
            f"{d['max_loss_diff']:.6g}")
        if not d["margin"] < d["max_loss_diff"]:
            raise AssertionError(f"{label} request {i}: option differs "
                                 f"beyond rounding: {d}")
        ties.append(("option", d))
    log(f"[{label} request {i}] {'options' if options else 'free-form'}: "
        f"option {got.get('option_chosen')} (serial "
        f"{want.get('option_chosen')}), answer {got.get('answer')!r} "
        f"(serial {want.get('answer')!r}), boxes "
        f"{len(got['search_result'])}, largest |box difference| {box:.4g} "
        f"px, near-ties {[t for t, _ in ties]}")
    return ties


def _serve_continuous(label, vqa, vsm, requests, pipeline, kernels,
                      counts_exact):
    """One burst of the requests over HTTP to a ContinuousSealService on
    (vqa, vsm): records, client latencies, the service's stats, the
    kernel counts of the burst and its wall time."""
    from vstar_tpu_torch.serve.continuous import ContinuousSealService
    from vstar_tpu_torch.serve.server import make_server
    svc = ContinuousSealService(vqa, vsm, max_search_steps=3,
                                max_batch=CONTINUOUS_REQUESTS,
                                window_ms=CONTINUOUS_WINDOW_MS,
                                missing_parser=lambda p: ["red mug"],
                                search_kwargs=FORCED_SEARCH,
                                pipeline=pipeline)
    httpd = make_server(svc, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        _zero_counts()
        t0 = time.perf_counter()
        recs, lat = _post_all(httpd.server_address[1], requests)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = svc.stats()
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
        svc.close()
    mode = "pipeline" if pipeline else "scheduler"
    # K3 serves decode rows only (R <= 16): every decode of a wave runs
    # 8-row verify chunks for 2 rows or more, whose int8 matrices take
    # the dequantized product, as JAX's int8 path above its row limit
    counts = _check_path(f"{label} continuous {mode}",
                         tuple(k for k in kernels if k != "int8_matvec"))
    if counts_exact:
        counts["flash_attention_routes"] = _check_routes(
            f"{label} continuous {mode}", {"tile": None, "split": None,
                                           "combine": None})
    server_lat = [r["latency_s"] for r in recs]
    report = {"wall_s": wall, "waves": stats["waves"],
              "mean_wave": stats["mean_wave"],
              "max_wave": stats["max_wave"], "oom_splits":
              stats["oom_splits"], "latency_p50_s": float(np.median(lat)),
              "latency_max_s": float(np.max(lat)),
              "server_latency_p50_s": float(np.median(server_lat)),
              "server_latency_max_s": float(np.max(server_lat))}
    log(f"[{label} continuous {mode}] {len(requests)} concurrent HTTP "
        f"requests in {wall:.3f} s: {stats['waves']} waves, mean wave "
        f"{stats['mean_wave']:.2f}, max wave {stats['max_wave']}, OOM "
        f"splits {stats['oom_splits']}; latency p50 "
        f"{report['latency_p50_s']:.3f} s, max "
        f"{report['latency_max_s']:.3f} s (server p50 "
        f"{report['server_latency_p50_s']:.3f}, max "
        f"{report['server_latency_max_s']:.3f})")
    if not stats["mean_wave"] > 1:
        raise AssertionError(f"{label} continuous {mode}: no co-batching: "
                             f"{stats}")
    return recs, report, counts


def phase_continuous(label, vqa, vsm_engine, kernels, full):
    """Continuous serving at the full widths: CONTINUOUS_REQUESTS
    concurrent HTTP requests on 2048x1536 noise (half with options, half
    free-form) to ContinuousSealService, the search forced through its
    missing_parser (3 steps, FORCED_SEARCH), on the resident VQA weights
    and the tilted device-preprocess VSM; the records held to serial
    SealService's on the same engines (TracedTrigger forces the serial
    flow's search) by _same_record_rules. Runs, each with its own count
    window: engines warmed at this traffic's budgets (warmup_vqa_engine,
    warmup_vsm_engine), whose live requests must capture nothing, by the
    scheduler thread; with full, also fresh engines without warmup
    (decode graphs captured live while the handler threads prefetch
    canvases) and the warmed engines with pipeline=True (two stage
    workers; counts only checked to be non-zero)."""
    from vstar_tpu_torch.eval.vqa_engine import VQAEngine, warmup_vqa_engine
    from vstar_tpu_torch.search.batched import warmup_vsm_engine
    from vstar_tpu_torch.serve.server import SealService
    t_phase = time.perf_counter()
    requests = _continuous_requests()

    def engines():
        v = VQAEngine(vqa.params, vqa.cfg, vqa.tokenizer, device=vqa.device,
                      prompt_buckets=vqa.prompt_buckets,
                      option_bucket=vqa.option_bucket,
                      compute_dtype=vqa.compute_dtype)
        v.replay_trace = []
        return v, _engine_like(_tilted_engine(vsm_engine),
                               device_preprocess=True)

    report, by_part, ties = {}, {}, []
    with PathLog() as paths:
        if full:
            v, s = engines()
            cold = TracedTrigger(v)
            cold_recs, report["cold"], by_part["cold"] = _serve_continuous(
                label, cold, s, requests, False, kernels, True)
            report["cold"]["captures"] = {"vqa": v.graphs.captures,
                                          "vsm": s.graphs.captures}
            cold_paths = dict(paths.paths)
            del s
        v, s = engines()
        t0 = time.perf_counter()
        warmup_vqa_engine(v, batch_buckets=(1, 2, 4, 8),
                          max_new_tokens=CONTINUOUS_TOKENS, log=None)
        warmup_vsm_engine(s, canvas_sizes=((1536, 2048),),
                          batch_buckets=(1, 2, 4, 8), log=None)
        torch.cuda.synchronize()
        v.replay_trace = []
        report["warmup_s"] = time.perf_counter() - t0
        captured = (v.graphs.captures, s.graphs.captures)
        log(f"[{label} continuous] warmup at {CONTINUOUS_TOKENS} tokens and "
            f"the 2048x1536 canvas, batch buckets 1-8: "
            f"{report['warmup_s']:.3f} s, decode graphs VQA {captured[0]}, "
            f"VSM {captured[1]}")
        warm = TracedTrigger(v)
        warm_recs, report["warm"], by_part["warm"] = _serve_continuous(
            label, warm, s, requests, False, kernels, True)
        warm_paths = dict(paths.paths)
        if full:
            pipe = TracedTrigger(v)
            pipe_recs, report["pipeline"], by_part["pipeline"] = \
                _serve_continuous(label, pipe, s, requests, True, kernels,
                                  False)
            pipe_paths = dict(paths.paths)
        live = (v.graphs.captures - captured[0],
                s.graphs.captures - captured[1])
        if live != (0, 0):
            raise AssertionError(f"{label} continuous: live requests on the "
                                 f"warmed engines captured {live} decode "
                                 "graphs")
        serial = TracedTrigger(v)
        service = SealService(serial, s, max_search_steps=3)
        t0 = time.perf_counter()
        serial_recs = [service.answer(image, question, options)
                       for _, image, question, options in requests]
        torch.cuda.synchronize()
        report["serial_s"] = time.perf_counter() - t0
        serial_paths = dict(paths.paths)
    log(f"[{label} continuous] serial SealService: {len(requests)} requests "
        f"in {report['serial_s']:.3f} s; latency p50 "
        f"{np.median([r['latency_s'] for r in serial_recs]):.3f} s")
    runs = [("warm", warm, warm_recs, warm_paths)]
    if full:
        runs = [("cold", cold, cold_recs, cold_paths)] + runs + [
            ("pipeline", pipe, pipe_recs, pipe_paths)]
    for mode, traced, recs, run_paths in runs:
        for i, (request, got, want) in enumerate(zip(requests, recs,
                                                     serial_recs)):
            strip = {k: v for k, v in got.items() if k != "latency_s"}
            ties += _same_record_rules(
                f"{label} continuous {mode}", i, request,
                {k: v for k, v in want.items() if k != "latency_s"}, strip,
                serial, traced, serial_paths, run_paths)
    report["near_ties"] = len(ties)
    log(f"[time] {label} continuous phase {time.perf_counter() - t_phase:.1f}"
        " s")
    return by_part, report


# ---------------------------------------------------------------------------
# Phase 5e: the int8 KV cache (--kv-int8)
# ---------------------------------------------------------------------------

def _dequant_ms(cfg, cache_len, dev):
    """Events ms of the plain dequantization a decode step runs: every
    layer's k and v of one row, cache_len slots, int8 with f32 scales to
    bf16 (nn/llama._dequantize_kv)."""
    from vstar_tpu_torch.nn.llama import _dequantize_kv
    shape = (1, cache_len, cfg.num_kv_heads, cfg.head_dim)
    q = torch.randint(-127, 128, shape, dtype=torch.int8, device=dev)
    s = torch.rand(shape[:-1], device=dev)

    def step():
        for _ in range(2 * cfg.num_layers):
            _dequantize_kv(q, s, torch.bfloat16)
    return events_ms(step, iters=10)


def phase_kv_int8(label, vqa, vsm_engine, kernels):
    """The int8 KV cache on the resident weights: a FREE_FORM_TOKENS
    greedy free-form decode of one 2048x1536 image on a kv_int8 VQA
    engine and a forced 3-step search on a kv_int8 tilted VSM, each by
    graph replay and as the eager traced loop, held to each other (the
    same tokens and forwards, or a near-tie; the same patches, or the
    lockstep rule); the int8 decode against a bf16-cache engine's on the
    same weights (the first differing token and its margin logged: int8
    KV is not bitwise); the two engines' cache slabs (the int8 one at
    most 0.55x), ms per token by graph, and the plain dequantization's
    ms per decode step. The bf16-cache decode runs before any count is
    zeroed; the int8 free-form decode and the int8 search each have a
    count window of their own ("free_form": K1 on its tile and split
    routes; "search": `kernels` on both routes)."""
    from vstar_tpu_torch.data.preprocess import expand2square
    from vstar_tpu_torch.eval.vqa_engine import VQAEngine
    from vstar_tpu_torch.search.policy import visual_search
    t_phase = time.perf_counter()
    squared = expand2square(_image(1536, 2048, SEED + 1))[0]

    def vqa_engine(kv_int8):
        e = VQAEngine(vqa.params, vqa.cfg, vqa.tokenizer, device=vqa.device,
                      prompt_buckets=vqa.prompt_buckets,
                      option_bucket=vqa.option_bucket,
                      compute_dtype=vqa.compute_dtype, kv_int8=kv_int8)
        e._spec_template = None           # greedy
        return e

    def free_form(e):
        return lambda: e.free_form(squared, QUESTION,
                                   max_new_tokens=FREE_FORM_TOKENS)

    def window(part, want, want_routes):
        counts = _check_path(f"{label} kv-int8 {part}", want)
        counts["flash_attention_routes"] = _check_routes(
            f"{label} kv-int8 {part}", want_routes)
        by_part[part] = counts

    report, runs, by_part = {}, {}, {}
    # the bf16-cache reference, outside every count window
    e16 = vqa_engine(False)
    _graph_runs(f"{label} kv-int8", "free-form bf16 cache", e16,
                free_form(e16), "bf16", runs)
    e8 = vqa_engine(True)
    _zero_counts()
    text, st, trace, ms = _timed_decode(e8, free_form(e8))
    runs["int8"] = {"texts": [text], "n": [st["tokens"]], "stats": st,
                    "trace": trace, "ms": ms}
    _log_run(f"{label} kv-int8", "free-form eager", runs["int8"])
    _graph_runs(f"{label} kv-int8", "free-form", e8, free_form(e8), "int8",
                runs)
    torch.cuda.synchronize()
    # prefill on the tile route, decode on the split route; the CLIP
    # tower at 224 (257 tokens) takes the plain attention, as in JAX
    window("free_form", ("flash_attention",),
           {"tile": None, "split": None, "combine": None})
    graph_diff = _graph_vs_eager(f"{label} kv-int8 free-form",
                                 {"int8": runs["int8"],
                                  "int8_graph": runs["int8_graph"]})
    p = _first_difference(runs["bf16_graph"], runs["int8_graph"])
    vs_bf16 = None
    if p is not None:
        rloc, rtok = _trace_reader(runs["bf16_graph"]["trace"], 0)
        loc, tok = _trace_reader(runs["int8_graph"]["trace"], 0)
        a, b = rtok(p), tok(p)
        e, col = rloc(p)
        lg = runs["bf16_graph"]["trace"][e][1][0, col].float()
        e, col = loc(p)
        l8 = runs["int8_graph"]["trace"][e][1][0, col].float()
        vs_bf16 = {"position": p, "bf16_token": a, "int8_token": b,
                   "margin": float(lg[a] - lg[b]),
                   "max_logit_diff": float((lg - l8).abs().max())}
    log(f"[{label} kv-int8] against the bf16 cache: first differing token "
        f"{vs_bf16} of {runs['bf16_graph']['n'][0]}")
    cfg = vqa.cfg.llama
    per_tok = {n: runs[n + "_graph"]["ms"] / max(
        runs[n + "_graph"]["stats"]["forwards"], 1) for n in ("int8",
                                                               "bf16")}
    slabs = {"int8": e8.graphs.cache_bytes(), "bf16": e16.graphs.cache_bytes()}
    ratio = slabs["int8"] / slabs["bf16"]
    cache_len = max(k[4] for k in e8.graphs._caches)   # (..., rows, len, ...)
    deq = _dequant_ms(cfg, cache_len, vqa.device)
    log(f"[{label} kv-int8] greedy free-form {FREE_FORM_TOKENS} tokens by "
        f"graph: int8 {runs['int8_graph']['ms']:.1f} ms "
        f"({per_tok['int8']:.3f} ms a token; eager "
        f"{runs['int8']['ms']:.1f} ms), bf16 cache "
        f"{runs['bf16_graph']['ms']:.1f} ms ({per_tok['bf16']:.3f} ms a "
        f"token); cache slabs int8 {slabs['int8'] / 2**20:.1f} MiB, bf16 "
        f"{slabs['bf16'] / 2**20:.1f} MiB ({ratio:.4f}x); the plain "
        f"dequantization of one decode step (2 x {cfg.num_layers} layers, "
        f"{cache_len} slots) {deq:.4f} ms by events")
    if ratio > 0.55:
        raise AssertionError(f"{label} kv-int8: slabs {slabs}, {ratio:.4f}x")

    # a forced 3-step search on an int8-cache tilted VSM: graph and eager
    tilted = _tilted_engine(vsm_engine)
    s8 = _engine_like(tilted, kv_int8=True)
    img = _noise(1536, 2048, SEED + 20)
    paths = {}
    _zero_counts()
    for how in ("graph", "eager"):
        path = []
        s8.decode_trace = [] if how == "eager" else None
        try:
            t0 = time.perf_counter()
            out = visual_search(s8, img, "red mug", smallest_size=224,
                                max_steps=3, path_out=path, **FORCED_SEARCH)
            torch.cuda.synchronize()
            report[f"search_{how}_s"] = time.perf_counter() - t0
        finally:
            s8.decode_trace = None
        if len(path) != 3:
            raise AssertionError(f"{label} kv-int8 search {how}: "
                                 f"{[st.bbox for st in path]}")
        paths[how] = (path, out)
    window("search", kernels, {"tile": None, "split": None,
                               "combine": None})
    search_diff = _same_search(f"{label} kv-int8 search graph against eager",
                               paths["eager"][0], paths["graph"][0])
    log(f"[{label} kv-int8 search] patches {[st.bbox for st in paths['graph'][0]]}"
        f" by graph ({report['search_graph_s']:.3f} s), eager "
        f"{[st.bbox for st in paths['eager'][0]]} "
        f"({report['search_eager_s']:.3f} s); (path length, success) "
        f"{paths['graph'][1][1:3]}, eager {paths['eager'][1][1:3]}; "
        f"VSM slabs {s8.graphs.cache_bytes() / 2**20:.1f} MiB")
    report.update({
        "free_form_ms": {n: runs[n + "_graph"]["ms"] for n in ("int8",
                                                               "bf16")},
        "free_form_eager_ms": runs["int8"]["ms"],
        "ms_per_token": per_tok, "slab_bytes": slabs, "slab_ratio": ratio,
        "dequant_step_ms": deq, "dequant_cache_len": cache_len,
        "graph_vs_eager": graph_diff["int8"], "vs_bf16": vs_bf16,
        "search_difference": search_diff})
    del e8, e16, s8, tilted
    log(f"[time] {label} kv-int8 phase {time.perf_counter() - t_phase:.1f} s")
    return by_part, report


# ---------------------------------------------------------------------------
# Phase 5f: the phase-swapped evaluation (eval/phased.py)
# ---------------------------------------------------------------------------

def _tree_bytes(tree):
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone_tree(v) for v in tree)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def phase_phased(label, vqa, vsm_engine, kernels):
    """eval_model_phased on the synthetic V*Bench (one 1024x1024 image a
    task) with force_missing ('red mug'), 3-step forced searches and the
    disclosed budgets, swapped, co-resident and parked: the same records
    from all three. Each factory builds a fresh engine on a device copy
    of the resident weights (the VSM tilted); memory_allocated is logged
    around every free_engine, and must fall by at least the freed
    engine's parameter bytes. Logs the swap and phase timings and
    images/s."""
    from vstar_tpu_torch.eval import phased, synthetic
    from vstar_tpu_torch.eval.vqa_engine import VQAEngine
    t_phase = time.perf_counter()
    tilted = _tilted_engine(vsm_engine)
    frees = []
    free_engine = phased.free_engine

    def logged_free(engine):
        if engine is None:
            return free_engine(engine)
        inner = getattr(engine, "engine", engine)
        nbytes = _tree_bytes(inner.params)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        free_engine(engine)
        after = torch.cuda.memory_allocated()
        frees.append({"engine": type(inner).__name__, "params": nbytes,
                      "before": before, "after": after})
        log(f"[{label} phased] free_engine({type(inner).__name__}): "
            f"memory_allocated {before / 2**30:.3f} -> {after / 2**30:.3f} "
            f"GiB (params {nbytes / 2**30:.3f} GiB)")
        if before - after < nbytes:
            raise AssertionError(f"{label} phased: free_engine released "
                                 f"{before - after} bytes of {nbytes}")

    def vqa_factory():
        return VQAEngine(_clone_tree(vqa.params), vqa.cfg, vqa.tokenizer,
                         device=vqa.device, prompt_buckets=vqa.prompt_buckets,
                         option_bucket=vqa.option_bucket,
                         compute_dtype=vqa.compute_dtype)

    def vsm_factory():
        return _engine_like(tilted, _clone_tree(tilted.params),
                            device_preprocess=True)

    report, results, by_part = {}, {}, {}
    phased.free_engine = logged_free
    try:
        with tempfile.TemporaryDirectory() as work:
            bench = os.path.join(work, "bench")
            synthetic.make_synthetic_benchmark(bench, n_per_task=1)
            kw = dict(batch=2, free_form_max_new_tokens=SYNTHETIC_BUDGETS[0],
                      max_search_steps=3, search_kwargs=FORCED_SEARCH,
                      force_missing=lambda s: ["red mug"], log=None)
            for mode in ("swapped", "coresident", "parked"):
                factories = (vqa_factory, vsm_factory)
                if mode == "parked":
                    factories = tuple(phased.parked_factory(f)
                                      for f in factories)
                _zero_counts()
                t0 = time.perf_counter()
                results[mode], _, t = phased.eval_model_phased(
                    bench, *factories, coresident=mode == "coresident", **kw)
                torch.cuda.synchronize()
                t["wall_s"] = time.perf_counter() - t0
                by_part[mode] = _check_path(f"{label} phased {mode}",
                                            kernels)
                report[mode] = t
                log(f"[{label} phased {mode}] {t['n_images']} images, "
                    f"{t['n_searches']} searches: phases "
                    f"{t['phase1_s']:.3f} / {t['phase2_s']:.3f} / "
                    f"{t['phase3_s']:.3f} s, loads VQA "
                    f"{t['load_vqa_s']:.3f} s, VSM {t['load_vsm_s']:.3f} s, "
                    f"frees {t['free_vqa_s']:.3f} / {t['free_vsm_s']:.3f} s, "
                    f"reload VQA {t['reload_vqa_s']:.3f} s, swaps "
                    f"{t['swap_total_s']:.3f} s; "
                    f"{t['images_per_s_steady']:.4f} images/s steady, "
                    f"{t['images_per_s_amortized']:.4f} amortized; wall "
                    f"{t['wall_s']:.3f} s")
                del factories
                gc.collect()
    finally:
        phased.free_engine = free_engine
    for mode in ("coresident", "parked"):
        if results[mode] != results["swapped"]:
            raise AssertionError(f"{label} phased: {mode} records "
                                 f"{results[mode]} against swapped "
                                 f"{results['swapped']}")
    recs = [r for task in results["swapped"].values() for r in task]
    if len(recs) != 2 or any(r["missing_objects"] != ["red mug"]
                             or not r["search_result"] for r in recs):
        raise AssertionError(f"{label} phased: records {recs}")
    report["frees"] = frees
    report["records_equal"] = True
    log(f"[{label} phased] swapped, co-resident and parked records equal; "
        f"{len(frees)} frees, each released its parameters")
    del tilted
    log(f"[time] {label} phased phase {time.perf_counter() - t_phase:.1f} s")
    return by_part, report


def phase_bf16_path(dev):
    """The PR 1 path: the bf16 7B pair, two answers, one over HTTP, one
    forced-search sample."""
    from vstar_tpu_torch.serve.server import SealService, random_init_engines
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    vqa, vsm_engine = random_init_engines("7b", dev)
    torch.cuda.synchronize()
    log(f"[init] random 7B pair (vqa_llm_7b + vsm_7b, bf16) on {dev} in "
        f"{time.perf_counter() - t0:.1f} s; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    vsm = CountingVSM(vsm_engine)
    service = SealService(vqa, vsm)
    img_1k, img_2k = _image(768, 1024, SEED), _image(1536, 2048, SEED + 1)

    # warm-up: the first calls of each library kernel pay their set-up
    vqa.multiple_choice(img_1k, QUESTION, OPTIONS)

    _zero_counts()
    results = {}
    for name, img in (("1024x768", img_1k), ("2048x1536", img_2k)):
        t0 = time.perf_counter()
        rec = service.answer(img, QUESTION, OPTIONS)
        torch.cuda.synchronize()
        _check_record(rec, len(OPTIONS))
        results[name] = rec
        log(f"[answer {name}] latency {time.perf_counter() - t0:.3f} s "
            f"option {rec['option_chosen']} missing "
            f"{rec['missing_objects']} freeform "
            f"{len(rec['prediction_freeform'].split())} words")
    t0 = time.perf_counter()
    status, rec = _http_answer(service, img_1k, QUESTION, OPTIONS)
    if status != 200:
        raise AssertionError(f"HTTP {status}: {rec}")
    _check_record(rec, len(OPTIONS))
    log(f"[answer http] latency {time.perf_counter() - t0:.3f} s "
        f"option {rec['option_chosen']}")
    if rec["option_chosen"] != results["1024x768"]["option_chosen"]:
        raise AssertionError("HTTP answer differs from the direct answer "
                             "on the same image")
    forced = _forced_search_sample(vqa, vsm, img_2k, QUESTION, OPTIONS)
    _log_forced("forced search 2048x1536", forced, vsm)
    counts = _check_path("bf16", ("flash_attention", "tower_attention"))
    # prefill on the tile route, decode on the split route
    counts["flash_attention_routes"] = _check_routes(
        "bf16", {"tile": None, "split": None, "combine": None})
    if counts["flash_attention_routes"]["split"] != \
            counts["flash_attention_routes"]["combine"]:
        raise AssertionError("bf16 path: K1 split launches without their "
                             "combine")
    slice_counts, report = phase_decode_slice(
        "bf16", vqa, vsm_engine, ("flash_attention", "tower_attention"))
    report["lockstep_by_part"], report["lockstep"] = phase_lockstep(
        "bf16", vqa, vsm_engine, ("flash_attention", "tower_attention"),
        full=True)
    report["compiled_by_part"], report["compiled"] = phase_compiled(
        "bf16", vsm_engine, ("flash_attention", "tower_attention"),
        full=True)
    kernels = ("flash_attention", "tower_attention")
    for name, phase in (("continuous", lambda: phase_continuous(
            "bf16", vqa, vsm_engine, kernels, full=True)),
                        ("kv_int8", lambda: phase_kv_int8(
                            "bf16", vqa, vsm_engine, kernels)),
                        ("phased", lambda: phase_phased(
                            "bf16", vqa, vsm_engine, kernels))):
        gc.collect()
        torch.cuda.empty_cache()
        report[name + "_by_part"], report[name] = phase()
    return counts, slice_counts, report


def phase_quantized_path(dev):
    """The --int4mix pair: int8 VQA decoder, int4mix VSM decoder (int4
    gate/up/lm_head, int8 qkvo/down), int8 towers. One answer, one forced
    search sample, then one more with the act-int8 switch on (W4A8 for
    the int4 matrices, int8 x int8 products for the int8 ones)."""
    from vstar_tpu_torch.nn.quant import set_act_int8
    from vstar_tpu_torch.serve.server import SealService, random_init_engines
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    vqa, vsm_engine = random_init_engines("7b", dev, int4mix=True)
    torch.cuda.synchronize()
    log(f"[init] random 7B --int4mix pair on {dev} in "
        f"{time.perf_counter() - t0:.1f} s; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB, "
        f"allocated {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")
    vsm = CountingVSM(vsm_engine)
    service = SealService(vqa, vsm)
    img_2k = _image(1536, 2048, SEED + 1)

    _zero_counts()
    t0 = time.perf_counter()
    rec = service.answer(img_2k, QUESTION, OPTIONS)
    torch.cuda.synchronize()
    _check_record(rec, len(OPTIONS))
    log(f"[int4mix answer 2048x1536] latency {time.perf_counter() - t0:.3f}"
        f" s option {rec['option_chosen']} freeform "
        f"{len(rec['prediction_freeform'].split())} words")
    forced = _forced_search_sample(vqa, vsm, img_2k, QUESTION, OPTIONS)
    _log_forced("int4mix forced search 2048x1536", forced, vsm)
    vsm.detects = 0
    set_act_int8(True)
    try:
        forced = _forced_search_sample(vqa, vsm, img_2k, QUESTION, OPTIONS)
    finally:
        set_act_int8(False)
    _log_forced("int4mix act-int8 forced search 2048x1536", forced, vsm)
    log(f"[int4mix] max_memory_allocated over the path "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    counts = _check_path("int4mix", SERVING_KERNELS)
    counts["flash_attention_routes"] = _routes()
    kernels = ("flash_attention", "tower_attention", "int8_matvec",
               "int4_matmul")
    slice_counts, report = phase_decode_slice("int4mix", vqa, vsm_engine,
                                              kernels)
    report["lockstep_by_part"], report["lockstep"] = phase_lockstep(
        "int4mix", vqa, vsm_engine, kernels, full=False)
    report["compiled_by_part"], report["compiled"] = phase_compiled(
        "int4mix", vsm_engine, kernels, full=False)
    gc.collect()
    torch.cuda.empty_cache()
    report["continuous_by_part"], report["continuous"] = phase_continuous(
        "int4mix", vqa, vsm_engine, kernels, full=False)
    return counts, slice_counts, report


# ---------------------------------------------------------------------------
# Phase 9: the int4 profile path
# ---------------------------------------------------------------------------

def _decode_route(kind, headless, act8, cfg):
    """Launches per token that a decode row's route implies, and qdot's
    int4 routes: K1 per layer, and per quantized matrix (7 per layer, the
    lm_head unless headless) K3 or _w8a8_dot for int8, and for int4 K5
    (W4A16) or, under act-int8 where the W4A8 gate holds (OUT % 128 ==
    0), K6 and its row quantization. Every 7B layer matrix passes the gate
    at one row; the 32003-wide lm_head does not, so under act-int8 it
    takes K5, as the JAX package takes W4A16 there."""
    quant = {"int8": ("int8", "int8"), "int4": ("int4", "int4"),
             "bf16": (None, None), "int4_head8": ("int4", "int8"),
             "int8_head4": ("int8", "int4")}[kind]
    layers = cfg.num_layers
    counts = dict.fromkeys(("K1", "K3", "K5", "K6", "quantize_rows",
                            "_w8a8_dot", "qdot_w4a8", "qdot_w4a16"), 0)
    counts["K1"] = layers
    layer_outs = (cfg.hidden_size, cfg.intermediate_size)
    for mode, n, w4a8 in (
            (quant[0], 7 * layers, all(o % 128 == 0 for o in layer_outs)),
            (quant[1], 0 if headless else 1, cfg.vocab_size % 128 == 0)):
        if mode == "int8":
            counts["_w8a8_dot" if act8 else "K3"] += n
        elif mode == "int4" and act8 and w4a8:
            for k in ("K6", "quantize_rows", "qdot_w4a8"):
                counts[k] += n
        elif mode == "int4":
            counts["K5"] += n
            counts["qdot_w4a16"] += n
    return counts


def phase_int4_profile(dev):
    """The int4 profile's main path, as `python3 -m
    vstar_tpu_torch.scripts.int4_profile --probe --matmul --decode` runs
    it (a shorter --matmul: W4A8 off, rows and transposed at every 7B
    shape): both probe candidates right, every candidate held to K6, and
    every decode row's launches per token exactly its route's, with no
    plain version on a CUDA tensor. Returns (launches by kernel, the
    stages' records)."""
    from vstar_tpu_torch.core.config import vsm_7b
    from vstar_tpu_torch.scripts import int4_profile as ip
    _zero_counts()
    probe = ip.probe(dev)
    if not all(r["correct"] and r["exact_7b"] for r in probe.values()):
        raise AssertionError(f"int4 profile probe failed: {probe}")
    matmul = ip.bench_matmuls(("w4a8_off", "w4a8_rows", "w4a8_t"), dev)
    rows = ip.bench_decode(dev)
    cfg = vsm_7b().llama
    for r in rows:
        want = _decode_route(r["params"], r["headless"], r["act_int8"], cfg)
        ok = (r["launches_per_token"] == want and r["plain_on_cuda"] == 0
              and math.isfinite(r["value"]) and r["ms_graph"] > 0)
        if not ok:
            raise AssertionError(f"decode row {r['name']}: launches per "
                                 f"token {r['launches_per_token']} (route "
                                 f"{want}), plain on CUDA "
                                 f"{r['plain_on_cuda']}, out {r['value']}")
        if r["params"] == "int4" and r["act_int8"] and not r["headless"]:
            log(f"[int4 profile] W4A8 decode row: {r['ms_graph']:.3f} ms a "
                f"token by graph, {r['ms_eager']:.3f} eager; per token "
                f"{want}")
    launches = _check_path("int4_profile", P_KERNELS + (
        "flash_attention", "int8_matvec", "int4_matmul", "int4_matmul_w4a8",
        "quantize_rows"))
    launches["flash_attention_routes"] = _routes()
    return launches, {
        "probe": probe, "decode": rows,
        "matmul": {f"{IN}x{OUT} {mode}": rec
                   for (IN, OUT, mode), rec in matmul.items()}}


# ---------------------------------------------------------------------------
# Phase 10: the training path
# ---------------------------------------------------------------------------

def _step_flops(cfg, rows, seq, pairs):
    """Model FLOPs of one training step: the decoder's and lm_head's
    matmuls over every position of the bucket, run forward, again in the
    remat recompute and backward to the activations (3x), plus the
    lm_head's weight gradient; attention as K1 twice (4 ops per attended
    pair and head dim) and K7 once (10)."""
    c = cfg.llama
    tokens = rows * seq
    dense = 2 * tokens * c.num_layers * (
        c.hidden_size * (2 * c.q_dim + 2 * c.kv_dim)
        + 3 * c.hidden_size * c.intermediate_size)
    head = 2 * tokens * c.hidden_size * c.vocab_size
    attn = (2 * 4 + 10) * pairs * c.head_dim * c.num_heads * c.num_layers
    return 3 * dense + 3 * head + attn


def phase_train(dev):
    """Three vsm_train_steps of the random-init seal_vsm_7b (bf16, LoRA r=8
    alpha=16, f32 masters, warmup 1) on 8 collated rows: exact launch
    counts per step, finite losses, frozen leaves bit-identical, LoRA B and
    fc_seg moved."""
    from vstar_tpu_torch.core.config import vsm_7b
    from vstar_tpu_torch.core.params import leaves_with_path
    from vstar_tpu_torch.data.vsm_collate import batch_to_torch
    from vstar_tpu_torch.models.vsm import init_vsm_params
    from vstar_tpu_torch.multimodal.constants import IGNORE_INDEX
    from vstar_tpu_torch.multimodal.stub_tokenizer import StubTokenizer
    from vstar_tpu_torch.scripts import mesh_probe
    from vstar_tpu_torch.train import auction
    from vstar_tpu_torch.train.lora import add_lora, vsm_trainable_mask
    from vstar_tpu_torch.train.vsm_train import (init_train_state,
                                                 make_vsm_optimizer,
                                                 vsm_train_step)
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = vsm_7b()
    t0 = time.perf_counter()
    params = init_vsm_params(SEED, cfg, device=dev, dtype=torch.bfloat16)
    params["llama"] = add_lora(params["llama"], SEED + 1, r=8, alpha=16)
    mask = vsm_trainable_mask(params)
    opt = make_vsm_optimizer(lr=1e-4, warmup_steps=1, trainable_mask=mask,
                             master_f32=True)
    state = init_train_state(params, opt)
    torch.cuda.synchronize()
    flat_mask = dict(leaves_with_path(mask))
    n_train = sum(x.numel() for p, x in leaves_with_path(params)
                  if flat_mask[p])
    log(f"[train init] seal_vsm_7b bf16 + LoRA r=8 + AdamW state in "
        f"{time.perf_counter() - t0:.1f} s; {n_train / 1e6:.1f} M trainable;"
        f" allocated {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")
    frozen = {"llama.layers.attn.wq[0]":
              params["llama"]["layers"]["attn"]["wq"][0].clone(),
              "vision.patch_embed.w":
              params["vision"]["patch_embed"]["w"].clone()}
    moved = {"llama.layers.attn.lora.wq_b":
             params["llama"]["layers"]["attn"]["lora"]["wq_b"].clone(),
             "fc_seg.fc0.w": params["fc_seg"]["fc0"]["w"].clone()}
    del params

    t0 = time.perf_counter()
    host = mesh_probe.vsm_rows(cfg, StubTokenizer(cfg.llama.vocab_size),
                               8, 512, seed=SEED)
    batch = batch_to_torch(host, dev)
    labelled = int((host["labels"] != IGNORE_INDEX).sum())
    log(f"[train batch] 8 rows collated in {time.perf_counter() - t0:.1f} s:"
        f" lens {host['lens'].tolist()}, {labelled} labelled tokens, "
        f"{int((~host['kv_valid']).sum())} masked keys")
    if labelled == 0:
        raise AssertionError("train batch has no CE labels")
    L = cfg.llama.num_layers
    expect = {"flash_attention": L * 2 * 2, "flash_attention_bwd_dq": L * 2,
              "flash_attention_bwd_dkv": L * 2,
              "tower_attention": cfg.owl_vision.num_layers * 2,
              "int8_matvec": 0, "int4_matmul": 0, "int4_matmul_w4a8": 0,
              "quantize_rows": 0, **{n: 0 for n in P_KERNELS}}
    kmask = _sdpa_mask(512, 512, dev, batch["lens"],
                       torch.zeros(8, dtype=torch.int32, device=dev),
                       batch["kv_valid"])
    flops = _step_flops(cfg, 8, 512, int(kmask.sum()))
    steps, totals = [], {k: 0 for k in expect}
    route_totals = {"tile": 0, "split": 0, "combine": 0}
    for i in range(3):
        _zero_counts()
        auction.stats.update(calls=0, rounds=0, seconds=0.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = vsm_train_step(state, batch, cfg, opt, mask,
                                  grad_accum=2)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        metrics = {k: float(v) for k, v in m.items()}
        counts = _read_counts()
        launches = {k: c[0] for k, c in counts.items()}
        plain = {k: c[1] for k, c in counts.items()}
        log(f"[train step {i}] {dt:.3f} s loss {metrics['loss']:.4f} ce "
            f"{metrics['ce_loss']:.4f} bce {metrics['mask_bce_loss']:.4f} "
            f"dice {metrics['mask_dice_loss']:.4f} det "
            f"{metrics['detection_loss']:.4f} grad_norm "
            f"{metrics['grad_norm']:.4f}; auction {auction.stats['calls']} "
            f"calls {auction.stats['rounds']} rounds "
            f"{auction.stats['seconds'] * 1e3:.1f} ms; launches {launches}")
        if not all(math.isfinite(x) for x in metrics.values()):
            raise AssertionError(f"train step {i}: non-finite {metrics}")
        if launches != expect or any(plain.values()):
            raise AssertionError(f"train step {i}: launches {launches} "
                                 f"(expected {expect}), plain {plain}")
        # every decoder attention of a step is a 512-row tile-route launch
        routes = _check_routes(f"train step {i}", {
            "tile": expect["flash_attention"], "split": 0, "combine": 0})
        steps.append({"seconds": dt, "auction_rounds":
                      auction.stats["rounds"], "auction_ms":
                      auction.stats["seconds"] * 1e3, **metrics})
        for k in totals:
            totals[k] += launches[k]
        for r, n in routes.items():
            route_totals[r] += n
    flat = dict(leaves_with_path(state.params))
    now = {"llama.layers.attn.wq[0]": flat["llama.layers.attn.wq"][0],
           **{k: flat[k] for k in ("vision.patch_embed.w",
                                   "llama.layers.attn.lora.wq_b",
                                   "fc_seg.fc0.w")}}
    for k, v in frozen.items():
        if not torch.equal(now[k], v):
            raise AssertionError(f"frozen {k} changed")
    for k, v in moved.items():
        if torch.equal(now[k], v):
            raise AssertionError(f"trainable {k} did not move")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    steady = float(np.mean([s["seconds"] for s in steps[1:]]))
    mfu = flops / steady / PEAK_OPS_PER_S["bf16"]
    log(f"[train] steps 2-3 {steady:.3f} s each; model FLOPs per step "
        f"{flops:.3e} -> {flops / steady / 1e12:.1f} TFLOP/s, {mfu:.1%} of "
        f"989 TFLOP/s; peak memory {peak:.2f} GiB; frozen leaves "
        f"bit-identical, LoRA B and fc_seg moved")
    del state, batch
    totals["flash_attention_routes"] = route_totals
    return totals, {"steps": steps, "steady_step_s": steady,
                    "step_flops": flops, "mfu": mfu, "peak_gib": peak,
                    "trainable_params": n_train}


def _tiny_kernel_cfg():
    """vsm_tiny with the decoder's heads at the kernels' width (2 x 128)."""
    from vstar_tpu_torch.core.config import vsm_tiny
    cfg = vsm_tiny()
    llama = dataclasses.replace(cfg.llama, hidden_size=256, num_heads=2,
                                num_kv_heads=2, head_dim=128)
    return dataclasses.replace(cfg, llama=llama, projector=dataclasses
                               .replace(cfg.projector, out_dim=256))


def _dataset_files(base):
    """Synthetic vqa_data + cocostuff files (tests/test_data.py's)."""
    from PIL import Image
    rng = np.random.RandomState(SEED)
    os.makedirs(os.path.join(base, "vqa_data", "coco_images"))
    Image.fromarray((rng.rand(40, 52, 3) * 255).astype("uint8")).save(
        os.path.join(base, "vqa_data", "coco_images", "img0.jpg"))
    json.dump([{"image": "img0.jpg", "conversations": [
        {"from": "human", "value": "<image>\nwhere is the cup?"},
        {"from": "gpt", "value": "on the table"}]}],
        open(os.path.join(base, "vqa_data",
                          "possible_locations_conv_86k.json"), "w"))
    os.makedirs(os.path.join(base, "coco", "train2017"))
    Image.fromarray((rng.rand(40, 60, 3) * 255).astype("uint8")).save(
        os.path.join(base, "coco", "train2017", "000001.jpg"))
    json.dump({"000001": {"cat": {"bboxes": [[5, 5, 20, 20],
                                             [30, 10, 50, 30]],
                                  "cat_id": 7}}},
              open(os.path.join(base, "cocostuff_image2bboxes.json"), "w"))
    os.makedirs(os.path.join(base, "cocostuff", "train2017"))
    sem = np.full((40, 60), 255, np.uint8)
    sem[5:20, 5:20] = 7
    Image.fromarray(sem).save(os.path.join(base, "cocostuff", "train2017",
                                           "000001.png"))


def phase_train_loop(dev):
    """run_vsm_training at the tiny config on the card: 2 steps with a
    checkpoint, then a second run that resumes and trains 2 more."""
    from vstar_tpu_torch.models.vsm import init_vsm_params
    from vstar_tpu_torch.multimodal.stub_tokenizer import StubTokenizer
    from vstar_tpu_torch.train.train_vsm_main import run_vsm_training
    cfg = _tiny_kernel_cfg()
    tok = StubTokenizer(cfg.llama.vocab_size)
    with tempfile.TemporaryDirectory() as base:
        _dataset_files(base)

        def args(epochs):
            return types.SimpleNamespace(
                dataset_dir=base, log_base_dir=os.path.join(base, "runs"),
                exp_name="vsm_tiny", epochs=epochs, steps_per_epoch=2,
                batch_size=2, grad_accumulation_steps=2, lr=1e-3,
                ce_loss_weight=1.0, dice_loss_weight=0.5,
                bce_loss_weight=2.0, det_loss_weight=0.1, warmup_steps=1,
                seq_bucket=64, prefetch_depth=2, mask_res=12, mesh=None,
                param_dtype="bf16", auto_resume=True, no_eval=True,
                dataset="general_segdet||vqa", sample_rates="1,1",
                save_steps=0)

        _zero_counts()
        t0 = time.perf_counter()
        state = run_vsm_training(args(1), cfg, init_vsm_params(
            SEED, cfg, device=dev, dtype=torch.bfloat16), tok, 3)
        resumed = run_vsm_training(args(2), cfg, init_vsm_params(
            SEED + 1, cfg, device=dev, dtype=torch.bfloat16), tok, 3)
        torch.cuda.synchronize()
        lines = open(os.path.join(base, "runs", "vsm_tiny",
                                  "metrics.jsonl")).read().splitlines()
        losses = [json.loads(x)["loss"] for x in lines]
        meta = json.load(open(os.path.join(base, "runs", "vsm_tiny",
                                           "ckpt_model", "meta.json")))
    launches = {k: c[0] for k, c in _read_counts().items()}
    log(f"[train loop tiny] steps {state.step} then {resumed.step} after "
        f"resume in {time.perf_counter() - t0:.1f} s; logged losses "
        f"{losses}; checkpoint epoch {meta['epoch']}; launches {launches}")
    if (state.step, resumed.step, meta["epoch"]) != (2, 4, 1) or \
            not all(math.isfinite(x) for x in losses) or \
            min(launches["flash_attention"],
                launches["flash_attention_bwd_dq"]) <= 0:
        raise AssertionError("tiny run_vsm_training on CUDA failed")
    _check_path("train loop", ("flash_attention", "flash_attention_bwd_dq",
                               "flash_attention_bwd_dkv"))


# ---------------------------------------------------------------------------
# Phase 11: checkpoints in the HF layout
# ---------------------------------------------------------------------------

HF_SHARD_BYTES = 1 << 30


def _hf_cfgs():
    """seal_vqa_7b and seal_vsm_7b at their widths, the decoder cut to 2
    layers (towers, OWL head and SAM decoder full)."""
    from vstar_tpu_torch.core.config import vqa_llm_7b, vsm_7b
    return tuple(dataclasses.replace(c, llama=dataclasses.replace(
        c.llama, num_layers=2)) for c in (vqa_llm_7b(), vsm_7b()))


def _quantize_like_loader(params, mode):
    """What the loaders build under `mode` from a bf16 checkpoint of
    `params`, made in memory on the card: each decoder matrix quantized
    per layer, the towers int8."""
    from vstar_tpu_torch.nn.quant import (quantize_model_towers,
                                          quantize_weight,
                                          quantize_weight_int4,
                                          resolve_matrix_quant)

    def quant(name, w):
        q = resolve_matrix_quant(mode, name)
        return (quantize_weight_int4 if q == "int4" else quantize_weight)(w)

    llama = dict(params["llama"])
    layers = {g: dict(v) for g, v in llama["layers"].items()}
    for grp in ("attn", "mlp"):
        for name, w in layers[grp].items():
            parts = [quant(name, w[i].float()) for i in range(w.shape[0])]
            layers[grp][name] = {k: torch.stack([e[k] for e in parts])
                                 for k in parts[0]}
    llama["layers"] = layers
    llama["lm_head"] = quant("lm_head", llama["lm_head"].float())
    return quantize_model_towers(dict(params, llama=llama))


def _same_tree(label, got, want):
    from vstar_tpu_torch.core.params import leaves_with_path
    got, want = dict(leaves_with_path(got)), dict(leaves_with_path(want))
    if got.keys() != want.keys():
        raise AssertionError(f"{label}: leaves {sorted(got.keys() ^ want)}")
    bad = [k for k in want if got[k].dtype != want[k].dtype
           or not torch.equal(got[k], want[k])]
    if bad:
        raise AssertionError(f"{label}: {len(bad)} leaves differ: {bad[:5]}")
    return sum(v.numel() * v.element_size() for v in got.values())


def _same_outputs(label, loaded, memory, img):
    """A free-form answer (the same tokens) and a detection on the tilted
    VSM (the same boxes, scores and heatmap) from the loaded and the
    in-memory engine pair. The in-memory pair runs first, outside the
    count window; the loaded pair's launches are checked by the caller."""
    outs = []
    for vqa, vsm in (memory, loaded):
        if vqa is loaded[0]:
            _zero_counts()
        t0 = time.perf_counter()
        answer = vqa.free_form(img, QUESTION, max_new_tokens=32)
        det = vsm.detect(img, "red mug")
        torch.cuda.synchronize()
        outs.append((answer, det, time.perf_counter() - t0))
    (a0, d0, t_mem), (a1, d1, t_load) = outs
    if a0 != a1:
        raise AssertionError(f"{label}: free-form {a1!r} != in-memory {a0!r}")
    if len(d1[0]) == 0:
        raise AssertionError(f"{label}: the tilted VSM gave no [LOC]")
    for name, x, y in zip(("boxes", "scores", "heatmap"), d0, d1):
        if not np.array_equal(np.asarray(x), np.asarray(y)):
            raise AssertionError(f"{label}: {name} differ from the in-memory "
                                 f"engine's (max |diff| "
                                 f"{np.abs(np.asarray(x) - np.asarray(y)).max()})")
    log(f"[{label}] free-form {len(a1.split())} words and a detection "
        f"({len(d1[0])} boxes, top score {float(np.max(d1[1])):.4f}, heatmap "
        f"sum {float(np.sum(d1[2])):.2f}) equal the in-memory engines'; "
        f"{t_load:.2f} s loaded, {t_mem:.2f} s in memory")


def _hf_eval(label, dirs, extra, tok, dev):
    """eval_model from the checkpoint directories (the loaders build the
    engines), on the synthetic V*Bench at one 1024x1024 image a task."""
    import contextlib
    from vstar_tpu_torch.eval import synthetic, vstar_bench
    with tempfile.TemporaryDirectory() as work:
        bench = os.path.join(work, "bench")
        synthetic.make_synthetic_benchmark(bench, n_per_task=1)
        argv = ["--vqa-model-path", dirs["vqa"], "--vsm-model-path",
                dirs["vsm"], "--benchmark-folder", bench, "--output-path",
                os.path.join(work, "out.json")] + extra
        printed = io.StringIO()
        _zero_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            results = vstar_bench.main(argv, device=dev, tokenizer=tok)[0]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    recs = [r for task in results.values() for r in task]
    if len(recs) != 2 or any("option_chosen" not in r for r in recs):
        raise AssertionError(f"{label}: eval_model gave {results}")
    log(f"[{label}] {len(recs)} images in {wall:.2f} s (loads included); "
        + "; ".join(printed.getvalue().strip().splitlines()[-3:]))
    return _check_path(label, ("flash_attention",)), wall


def phase_hf(dev):
    """Export the two random-init models (7B widths, 2 decoder layers, the
    VSM's embedding and lm_head tilted to answer [LOC]) in bf16 with their
    config.json, in shards of at most 1 GiB, then load them with
    load_engines in bf16 and with int4='int4mix': the tensors equal the
    exported ones (bit for bit; quantized, equal to quantizing them in
    memory), and the loaded pair answers and detects as the in-memory
    pair on the same weights and [LOC] id; then eval_model from the
    directories, serial and --single-chip-phased without factories."""
    from vstar_tpu_torch.core.hf_export import (save_hf_dir,
                                                vqa_llm_state_dict,
                                                vsm_state_dict)
    from vstar_tpu_torch.eval.vqa_engine import VQAEngine
    from vstar_tpu_torch.eval.vstar_bench import load_engines
    from vstar_tpu_torch.models.vqa_llm import init_vqa_llm_params
    from vstar_tpu_torch.models.vsm import init_vsm_params
    from vstar_tpu_torch.multimodal.stub_tokenizer import StubTokenizer
    from vstar_tpu_torch.nn.quant import set_act_int8
    from vstar_tpu_torch.search.batched import BatchedVSMEngine
    vqa_cfg, vsm_cfg = _hf_cfgs()
    tok = StubTokenizer(vsm_cfg.llama.vocab_size)
    params = {"vqa": init_vqa_llm_params(SEED, vqa_cfg, device=dev,
                                         dtype=torch.bfloat16),
              "vsm": init_vsm_params(SEED + 1, vsm_cfg, device=dev,
                                     dtype=torch.bfloat16)}
    llama = params["vsm"]["llama"]
    llama["embed_tokens"][:, 0] += 100     # _tilted_engine's tilt
    llama["lm_head"][0, 3] = 10
    img = _image(768, 1024, SEED + 7)
    report, counts = {}, {}
    with tempfile.TemporaryDirectory() as work:
        dirs = {k: os.path.join(work, k) for k in params}
        t0 = time.perf_counter()
        nbytes = 0
        for key, cfg, export in (("vqa", vqa_cfg, vqa_llm_state_dict),
                                 ("vsm", vsm_cfg, vsm_state_dict)):
            sd = export(params[key], dtype=torch.bfloat16)
            nbytes += sum(v.numel() * v.element_size() for v in sd.values())
            save_hf_dir(sd, cfg, dirs[key], shard_bytes=HF_SHARD_BYTES)
            del sd
        export_s = time.perf_counter() - t0
        files = {k: sorted(os.listdir(d)) for k, d in dirs.items()}
        if not all("model.safetensors.index.json" in f
                   for f in files.values()):
            raise AssertionError(f"no sharded export: {files}")
        report["export"] = {"seconds": export_s, "gb": nbytes / 1e9,
                            "gb_per_s": nbytes / 1e9 / export_s,
                            "files": files}
        log(f"[hf export] {nbytes / 1e9:.3f} GB in bf16 in {export_s:.2f} s "
            f"({nbytes / 1e9 / export_s:.3f} GB/s): {files}")

        for label, quant in (("hf_bf16", False), ("hf_int4mix", "int4mix")):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loaded = load_engines(dirs["vqa"], dirs["vsm"], device=dev,
                                  int4=quant, tokenizer=tok)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            want = {k: _quantize_like_loader(v, quant) if quant else v
                    for k, v in params.items()}
            loaded_bytes = sum(_same_tree(f"{label} {k}", e.params, want[k])
                               for k, e in zip(("vqa", "vsm"), loaded))
            if loaded[1].loc_token_id != 3:
                raise AssertionError(f"{label}: [LOC] id "
                                     f"{loaded[1].loc_token_id}")
            report[label] = {"load_seconds": load_s,
                             "load_gb_per_s": nbytes / 1e9 / load_s,
                             "resident_gb": loaded_bytes / 1e9}
            log(f"[{label} load] {nbytes / 1e9:.3f} GB of shards onto "
                f"{dev} in {load_s:.2f} s ({nbytes / 1e9 / load_s:.3f} "
                f"GB/s), {loaded_bytes / 1e9:.3f} GB resident; tensors "
                f"equal the {'quantized ' if quant else ''}exported ones")
            memory = (VQAEngine(want["vqa"], vqa_cfg, tok, device=dev),
                      BatchedVSMEngine(want["vsm"], vsm_cfg, tok,
                                       loc_token_id=3, device=dev))
            _same_outputs(label, loaded, memory, img)
            kernels = ("flash_attention", "tower_attention")
            if quant:
                set_act_int8(True)
                try:
                    loaded[0].free_form(img, QUESTION, max_new_tokens=8)
                    loaded[1].detect(img, "red mug")
                    torch.cuda.synchronize()
                finally:
                    set_act_int8(False)
                kernels += ("int8_matvec", "int4_matmul",
                            "int4_matmul_w4a8", "quantize_rows")
            counts[label] = _check_path(label, kernels)
            del loaded, memory, want
        gc.collect()
        torch.cuda.empty_cache()
        counts["hf_eval"], report["eval_s"] = _hf_eval(
            "hf eval_model", dirs, [], tok, dev)
        counts["hf_phased"], report["phased_s"] = _hf_eval(
            "hf --single-chip-phased", dirs,
            ["--single-chip-phased", "--image-batch", "2"], tok, dev)
    del params
    return counts, report


# ---------------------------------------------------------------------------
# Phase 12: the VQA trainer
# ---------------------------------------------------------------------------

def _caption(i):
    rng = np.random.RandomState(SEED + i)
    words = ["a", "photo", "of", "the", "red", "mug", "on", "wooden",
             "table", "near", "window", "with", "green", "bottle"]
    return " ".join(rng.choice(words, 40 + 10 * (i % 4)))


def _pretrain_batch(cfg, tok, rows, seq):
    from vstar_tpu_torch.data.pretrain_dataset import collate_pretrain
    rng = np.random.RandomState(SEED)
    size = cfg.vision.image_size
    instances = [{"image": rng.randn(size, size, 3).astype(np.float32),
                  "caption": _caption(i)} for i in range(rows)]
    return collate_pretrain(instances, tok, n_long=cfg.image_tokens_long,
                            n_short=cfg.image_tokens_short, image_long=True,
                            seq_bucket=seq)


def _sft_batch(cfg, tok, rows, seq):
    """Search-instruction rows: one object crop in the long slot (the image
    short) on even rows, plain image rows on odd ones; the padded object
    slots masked off (kv_valid)."""
    from vstar_tpu_torch.data.vqa_sft_dataset import collate_vqa_sft
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
                       {"from": "gpt", "value": _caption(i)}],
            "has_image": True, "is_search": search,
            "image": rng.randn(size, size, 3).astype(np.float32),
            "objects": objects, "images_long": not search,
            "objects_long": [False] * (m - 1) + [search]})
    return collate_vqa_sft(instances, tok, n_long=cfg.image_tokens_long,
                           n_short=cfg.image_tokens_short, seq_bucket=seq)


def _sft_steps(label, cfg, params, mask, host, lr, dev, steps=3):
    """`steps` sft_train_steps of 8 rows (2 micro-batches of 4): exact K1 /
    K7 launches per step (K1 with its log-sum-exp, twice a layer and
    micro-batch: the forward and the remat recompute), finite losses,
    frozen leaves bit-identical and trainable ones moved."""
    from vstar_tpu_torch.core.params import leaves_with_path
    from vstar_tpu_torch.data.vsm_collate import batch_to_torch
    from vstar_tpu_torch.kernels import flash_attention as fa
    from vstar_tpu_torch.train.sft import (init_train_state, make_optimizer,
                                           sft_train_step)
    opt = make_optimizer(lr, warmup_steps=1, total_steps=steps,
                         trainable_mask=mask, master_f32=True)
    state = init_train_state(params, opt)
    flat_mask = dict(leaves_with_path(mask))
    flat = dict(leaves_with_path(params))
    frozen = {k: flat[k].clone() for k in ("llama.layers.attn.wq",
                                           "vision.patch_embed.w",
                                           "proj_object.perceiver.latents")
              if not flat_mask[k]}
    moved = {k: flat[k].clone() for k in ("proj_image.proj.w",
                                          "llama.lm_head") if flat_mask[k]}
    n_train = sum(x.numel() for p, x in flat.items() if flat_mask[p])
    del flat
    batch = batch_to_torch(host, dev)
    L = cfg.llama.num_layers
    expect = {"flash_attention": L * 2 * 2, "flash_attention_bwd_dq": L * 2,
              "flash_attention_bwd_dkv": L * 2, "tower_attention": 0,
              "int8_matvec": 0, "int4_matmul": 0, "int4_matmul_w4a8": 0,
              "quantize_rows": 0, **{n: 0 for n in P_KERNELS}}
    seq = host["text_ids"].shape[1]
    times, totals = [], {k: 0 for k in expect}
    for i in range(steps):
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = sft_train_step(state, batch, cfg, opt, mask, grad_accum=2)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        counts = _read_counts()
        launches = {k: c[0] for k, c in counts.items()}
        plain = {k: c[1] for k, c in counts.items()}
        shapes = dict(fa.launches_by_shape)
        log(f"[{label} step {i}] {dt:.3f} s loss {loss:.4f} grad_norm "
            f"{gnorm:.4f}; K1 (with lse) {launches['flash_attention']} "
            f"launches by shape {shapes}, K7 dq "
            f"{launches['flash_attention_bwd_dq']} dkv "
            f"{launches['flash_attention_bwd_dkv']}")
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise AssertionError(f"{label} step {i}: loss {loss} grad_norm "
                                 f"{gnorm}")
        if launches != expect or any(plain.values()) or \
                shapes != {(4, seq): L * 2 * 2}:
            raise AssertionError(f"{label} step {i}: launches {launches} "
                                 f"(expected {expect}), K1 by shape {shapes},"
                                 f" plain {plain}")
        _check_routes(f"{label} step {i}", {
            "tile": expect["flash_attention"], "split": 0, "combine": 0})
        times.append(dt)
        for k in totals:
            totals[k] += launches[k]
    flat = dict(leaves_with_path(state.params))
    for k, v in frozen.items():
        if not torch.equal(flat[k], v):
            raise AssertionError(f"{label}: frozen {k} changed")
    for k, v in moved.items():
        if torch.equal(flat[k], v):
            raise AssertionError(f"{label}: trainable {k} did not move")
    steady = float(np.mean(times[1:]))
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"[{label}] {n_train / 1e6:.1f} M trainable; steps 2-{steps} "
        f"{steady:.3f} s each; peak memory {peak:.2f} GiB; frozen leaves "
        f"bit-identical, {sorted(moved)} moved")
    return totals, {"steps_s": times, "steady_step_s": steady,
                    "peak_gib": peak, "trainable_params": n_train,
                    "rows": 8, "seq_bucket": seq}


def _tiny_vqa_kernel_cfg():
    """vqa_llm_tiny with the decoder's heads at the kernels' width."""
    from vstar_tpu_torch.core.config import vqa_llm_tiny
    cfg = vqa_llm_tiny()
    llama = dataclasses.replace(cfg.llama, hidden_size=256, num_heads=2,
                                num_kv_heads=2, head_dim=128)
    return dataclasses.replace(
        cfg, llama=llama,
        projector_image=dataclasses.replace(cfg.projector_image, out_dim=256),
        projector_object=dataclasses.replace(cfg.projector_object,
                                             out_dim=256))


def _vqa_train_loop(dev):
    """run_training (pretrain) at the tiny kernel widths over synthetic
    caption files: a run that stops after epoch 0's rolling save, then one
    that resumes it and trains epoch 1."""
    from PIL import Image
    from vstar_tpu_torch.data.pretrain_dataset import (PretrainCaptionDataset,
                                                       collate_pretrain)
    from vstar_tpu_torch.models.vqa_llm import init_vqa_llm_params
    from vstar_tpu_torch.multimodal.stub_tokenizer import StubTokenizer
    from vstar_tpu_torch.train.train_vqa_main import (projector_only_mask,
                                                      run_training)
    cfg = _tiny_vqa_kernel_cfg()
    tok = StubTokenizer(cfg.llama.vocab_size)
    rng = np.random.RandomState(SEED)
    with tempfile.TemporaryDirectory() as base:
        items = []
        for i in range(8):
            Image.fromarray((rng.rand(40, 52, 3) * 255).astype("uint8")).save(
                os.path.join(base, f"im{i}.jpg"))
            items.append({"image": f"im{i}.jpg", "conversations": [
                {"from": "human", "value": "<image>\ndescribe"},
                {"from": "gpt", "value": _caption(i)[:60]}]})
        with open(os.path.join(base, "pretrain.json"), "w") as f:
            json.dump(items, f)
        ds = PretrainCaptionDataset(os.path.join(base, "pretrain.json"),
                                    base, image_size=cfg.vision.image_size)

        def collate(instances, tk):
            return collate_pretrain(instances, tk,
                                    n_long=cfg.image_tokens_long,
                                    n_short=cfg.image_tokens_short,
                                    image_long=True, seq_bucket=64)

        def run(epochs, seed):
            args = types.SimpleNamespace(
                stage="pretrain", mesh=None, param_dtype="bf16",
                per_device_batch_size=2, num_train_epochs=epochs,
                log_every=1, output_dir=os.path.join(base, "out"),
                data_workers=2, prefetch_depth=2, auto_resume=True,
                save_steps=2)
            params = init_vqa_llm_params(seed, cfg, device=dev,
                                         dtype=torch.bfloat16)
            return run_training(args, cfg, params, ds, collate, tok,
                                projector_only_mask(params, "linear"), 2e-3)

        _zero_counts()
        t0 = time.perf_counter()
        first = run(1, SEED)
        resumed = run(2, SEED + 1)
        torch.cuda.synchronize()
        lines = open(os.path.join(base, "out", "metrics.jsonl")).read()
        losses = [json.loads(x)["loss"] for x in lines.splitlines()]
    log(f"[train_vqa loop tiny] steps {first.step} then {resumed.step} after "
        f"resume in {time.perf_counter() - t0:.1f} s; logged losses {losses}")
    if (first.step, resumed.step) != (4, 8) or len(losses) != 8 or \
            not all(math.isfinite(x) for x in losses):
        raise AssertionError("tiny run_training on CUDA failed")
    _check_path("train_vqa loop", ("flash_attention",
                                   "flash_attention_bwd_dq",
                                   "flash_attention_bwd_dkv"))


def phase_train_vqa(dev):
    """The VQA trainer on the card: three pretrain steps of the random-init
    seal_vqa_7b at full depth (bf16, the f32 linear projector trainable
    alone) at a 512-token bucket, three finetune steps at 7B widths with
    2 decoder layers (everything but the frozen tower trainable), the
    memory check refusing the full 7B finetune before anything is
    allocated, and run_training at tiny kernel widths with a resume."""
    from vstar_tpu_torch.core.config import vqa_llm_7b
    from vstar_tpu_torch.core.hf_export import config_json
    from vstar_tpu_torch.core.params import map_with_path
    from vstar_tpu_torch.models.vqa_llm import init_vqa_llm_params
    from vstar_tpu_torch.multimodal.stub_tokenizer import StubTokenizer
    from vstar_tpu_torch.train import train_vqa_main
    cfg = vqa_llm_7b()
    tok = StubTokenizer(cfg.llama.vocab_size)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = init_vqa_llm_params(SEED, cfg, device=dev, dtype=torch.bfloat16)
    params["proj_image"] = map_with_path(lambda _, x: x.float(),
                                         params["proj_image"])
    torch.cuda.synchronize()
    log(f"[train_vqa init] seal_vqa_7b bf16 (f32 linear projector) in "
        f"{time.perf_counter() - t0:.1f} s; allocated "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")
    counts, report = {}, {}
    counts["train_vqa"], report["pretrain"] = _sft_steps(
        "train_vqa pretrain", cfg, params,
        train_vqa_main.projector_only_mask(params, "linear"),
        _pretrain_batch(cfg, tok, 8, 512), 2e-3, dev)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    cut = dataclasses.replace(cfg, llama=dataclasses.replace(
        cfg.llama, num_layers=2))
    params = init_vqa_llm_params(SEED, cut, device=dev, dtype=torch.bfloat16)
    counts["train_vqa_finetune"], report["finetune"] = _sft_steps(
        "train_vqa finetune", cut, params,
        train_vqa_main.frozen_vision_mask(params),
        _sft_batch(cut, tok, 8, 512), 2e-5, dev)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    before = torch.cuda.memory_allocated(dev)
    with tempfile.TemporaryDirectory() as work:
        with open(os.path.join(work, "config.json"), "w") as f:
            json.dump(config_json(cfg), f)
        try:
            train_vqa_main.main(
                ["finetune", "--model_path", work, "--data_path",
                 os.path.join(work, "none"), "--image_folder", work],
                tokenizer=tok, device=dev)
        except MemoryError as e:
            refusal = str(e)
        else:
            raise AssertionError("the full 7B finetune was not refused")
    if torch.cuda.memory_allocated(dev) != before:
        raise AssertionError("the refused finetune allocated device memory")
    log(f"[train_vqa full 7B finetune] refused before allocating: "
        f"{refusal}")
    report["full_finetune_refusal"] = refusal
    _vqa_train_loop(dev)
    return counts, report


# ---------------------------------------------------------------------------

# Part (c)'s bounds: two gloo ranks against one device, 2 steps of 2
# micro-batches (bf16 compute, f32 gradient buffers and masters), set
# from my chip runs 8 and 9 of the change that introduced them (H100
# 80GB HBM3, 700 W). Each rank's bf16 partial gradients round apart from
# one device's, and Adam's first steps move an element by about
# lr sign(g), so where a gradient is near zero (attention's wq / wk, the
# perceiver's queries and norms) an element may move the other way.
# Readings (run 9, deterministic: run 8 gave the same losses and norms)
# and bounds: step 1's loss 1.7e-6 relative, 1e-5; its grad norm 1.9e-5,
# 1e-4; step 2's loss, read after step 1's update, 2.0e-4, 2e-3; its
# grad norm 8.5e-4, 5e-3; per leaf of masters, the share of elements
# apart by more than lr / 10: 1.27 % (13 of the 1024 of
# proj_object.perceiver.pre_ln.scale; 1.56 % after 3 steps, at most
# 0.98 % in leaves over 10^5 elements), 3 %. A wrong or missing update
# of a shard moves about half of its elements by lr, and step 2's loss
# with it (10.65 -> 3.85 for the right one). Frozen leaves keep their
# values. Part (c2)'s finetune at 1x1x2 (tensor-parallel: the forward no
# longer equal bit for bit) holds to the same rules; readings (measured
# on one H100 80GB HBM3 with the change that made it tensor-parallel):
# step 1 2.8e-6 /
# 9.0e-6, step 2 1.1e-4 / 1.2e-3, masters 2.05 % (the same perceiver
# leaf).
MESH_SPLIT_LR = 1e-3
MESH_SPLIT_STEPS = 2
MESH_SPLIT_BOUNDS = {"loss": (1e-5, 2e-3), "grad_norm": (1e-4, 5e-3)}
MESH_SPLIT_SHARE = 0.03
# Part (c2)'s VSM step (two gloo ranks at 1x1x2, tensor-parallel, one
# step) is not held by the masters: its bf16 forward is not the one
# device's bit for bit (the partial products, and the towers' layernorm
# moments, summed in f32 over the model group), and Adam's first step
# moves each master by about lr sign(g), so every gradient element near
# the noise flips. It is held by its loss and grad norm within step 2's
# MESH_SPLIT_BOUNDS, and by each leaf's gradient (Adam's first moment,
# (1 - b1) times the clipped gradient) within MESH_TP_GRAD_TOL of the
# leaf's largest |value| on one device, for leaves whose largest |value|
# is at least MESH_TP_GRAD_FLOOR of the tree's. Readings (measured on
# one H100 80GB HBM3 with the change that introduced it): loss 3.1e-4
# and norm 1.0e-3 apart;
# the largest gradient difference 0.254 of its leaf's (fc_det.fc0.b: the
# detection loss matches boxes, a discrete choice; the finetune's largest
# 0.0148); SAM's attention key biases, whose gradient softmax makes zero,
# hold 2e-9 to 4e-7 of the tree's largest and differ by 0.97-2.7 of their
# own. A leaf's missing or doubled gradient at M = 2 differs by 1.0.
MESH_TP_GRAD_TOL = 0.5
MESH_TP_GRAD_FLOOR = 1e-6
# Part (c)'s resume in f32 holds the first moments by the same rule (its
# steps at 1x2x1 and, resumed, at 1x1x2): measured on one H100 80GB HBM3
# (700 W), at most 1.8e-5 of a leaf's largest after step 1 and 1.8e-4
# after step 2, where the bf16 resume's SAM leaves were 0.77 apart.
# Part (a)'s steps: the last one's seconds compare the two runs warm.
MESH_ONE_RANK_STEPS = 3


def _mesh_counts():
    counts = _read_counts()
    return ({k: c[0] for k, c in counts.items()},
            {k: c[1] for k, c in counts.items()})


def phase_mesh(dev):
    """The mesh (core/mesh.py, scripts/mesh_probe.py) on the card:
    (a) a world of one NCCL rank and the 1x1x1 mesh, every leaf a DTensor:
    MESH_ONE_RANK_STEPS VQA pretrain steps at full 7B equal to the
    one-device steps bit for bit with the same K1 / K7 launches (32
    layers x 2 micro-batches x 2: 128 K1, 64 + 64 K7), the last step's
    seconds and each run's peak logged side by side (the mesh's gathers
    copy nothing there), and a sharded VSM engine's detection (7B
    widths, 2 decoder layers; its decode graphs hold the mesh's
    collectives) equal to the unsharded engine's, K1 and K2 launched;
    (b) the 7B VQA finetune's plan per card at 1x1x1 (over the budget),
    1x2x1 and 1x4x1 (under);
    (c) two ranks over gloo on this card, 7B widths with 2 decoder layers
    on a 1x2x1 mesh, MESH_SPLIT_STEPS finetune steps against the
    one-device steps within MESH_SPLIT_BOUNDS and MESH_SPLIT_SHARE; then
    the VSM trainer's checkpoint written by both ranks at 1x2x1 after a
    step, read back bit for bit at 1x1x2 and on one device, a second
    step from each, and exported (_resume_rules; path mesh_resume); the
    same two steps in f32 with the first moments held
    (_resume_f32_rules);
    (c2) the same ranks at 1x1x2, the decoder and the towers
    tensor-parallel: the finetune steps and one VSM step (_tp_train);
    (d) serving over the mesh (_mesh_serve).
    Each part logs its seconds."""
    from vstar_tpu_torch.core.memory import device_memory_gb
    from vstar_tpu_torch.scripts import mesh_probe
    t0 = time.perf_counter()
    count = (_zero_counts, _mesh_counts)
    report, by_path = {}, {}

    def mark(part):
        log(f"[time] mesh {part} done at {time.perf_counter() - t0:.1f} s")

    a = mesh_probe.one_rank_mesh(dev, count, steps=MESH_ONE_RANK_STEPS)
    one_s, mesh_s = a["one_device"][-1][2], a["mesh"][-1][2]
    log(f"[mesh (a) pretrain 1x1x1] leaves {a['leaf_types']}; one device "
        f"{a['one_device']}; mesh {a['mesh']}; equal loss and norm "
        f"{a['equal_loss_and_norm']}, trainable leaves "
        f"{a['equal_trainable_leaves']}; step {MESH_ONE_RANK_STEPS}: mesh "
        f"{mesh_s:.4f} s against one device {one_s:.4f} s "
        f"({mesh_s / one_s:.3f}x); peak "
        f"{a['peak_bytes_mesh'] / 2**30:.2f} GiB on the mesh against "
        f"{a['peak_bytes_one_device'] / 2**30:.2f} GiB on one device")
    (one_l, one_p), (mesh_l, mesh_p) = a["counts_one_device"], \
        a["counts_mesh"]
    L = 32
    want = {"flash_attention": L * 2 * 2, "flash_attention_bwd_dq": L * 2,
            "flash_attention_bwd_dkv": L * 2}
    log(f"[mesh (a) pretrain 1x1x1] launches one device {one_l}, mesh "
        f"{mesh_l}; peak {a['peak_bytes_one_device'] / 2**30:.2f} GiB one "
        f"device, {a['peak_bytes_mesh'] / 2**30:.2f} GiB on the mesh")
    if a["leaf_types"] != ["DTensor"] or not all(a["equal_loss_and_norm"]) \
            or not all(a["equal_trainable_leaves"].values()):
        raise AssertionError(f"mesh (a): the 1x1x1 step differs: {a}")
    if mesh_l != one_l or any(mesh_p.values()) or any(one_p.values()) or \
            any(mesh_l[k] != n for k, n in want.items()):
        raise AssertionError(f"mesh (a): launches {mesh_l} (one device "
                             f"{one_l}, expected {want}), plain {mesh_p}")
    by_path["mesh_pretrain"] = dict(mesh_l)
    report["one_rank_pretrain"] = a
    mark("(a) pretrain")
    gc.collect()
    torch.cuda.empty_cache()
    e = mesh_probe.one_rank_engine(dev, count)
    log(f"[mesh (a) VSM engine 1x1x1, 2 layers] decoder stack "
        f"{e['stack_type']}, "
        f"{e['graphs_captured']} decode graphs captured; equal {e['equal']}"
        f"; launches {e['counts'][0]}")
    if e["stack_type"] != "DTensor" or not all(e["equal"].values()) or \
            any(e["counts"][1].values()) or \
            not e["counts"][0]["flash_attention"] or \
            not e["counts"][0]["tower_attention"]:
        raise AssertionError(f"mesh (a): the sharded VSM engine differs "
                             f"or skipped a kernel: {e}")
    by_path["mesh_vsm_engine"] = dict(e["counts"][0])
    report["one_rank_vsm_engine"] = e
    mark("(a) VSM engine")
    gc.collect()
    torch.cuda.empty_cache()
    hbm = device_memory_gb(dev)
    plans = mesh_probe.finetune_plans(hbm)
    for name, pl in plans.items():
        log(f"[mesh (b) 7B VQA finetune plan {name}] "
            f"{pl['total'] / 2**30:.2f} GiB a card (params "
            f"{pl['params'] / 2**30:.2f}, masters {pl['masters'] / 2**30:.2f}"
            f", moments {pl['moments'] / 2**30:.2f}, grads "
            f"{pl['grads'] / 2**30:.2f}) against {pl['budget'] / 2**30:.2f}"
            f": {'fits' if pl['fits'] else 'refused'}")
    if plans["1x1x1"]["fits"] or not plans["1x2x1"]["fits"] or \
            not plans["1x4x1"]["fits"]:
        raise AssertionError(f"mesh (b): plans {plans}")
    report["finetune_plans"] = plans
    c = mesh_probe.gloo_split(lr=MESH_SPLIT_LR, steps=MESH_SPLIT_STEPS,
                              resume=True, resume_f32=True)
    _split_rules("mesh (c) gloo 1x2x1 on one card", c["finetune"],
                 MESH_SPLIT_STEPS)
    by_path["mesh_resume"] = _resume_rules(c["resume"])
    _resume_f32_rules(c["resume_f32"])
    mark("(c)")
    report["gloo_split"] = c
    gc.collect()
    torch.cuda.empty_cache()
    by_path["mesh_train_tp"], report["gloo_tp"] = _tp_train(dev)
    mark("(c2)")
    gc.collect()
    torch.cuda.empty_cache()
    serve_counts, report["serve"] = _mesh_serve(dev, mark)
    by_path.update(serve_counts)
    report["seconds"] = time.perf_counter() - t0
    log(f"[mesh] phase {report['seconds']:.1f} s")
    return by_path, report


def _split_rules(label, c, steps, gradients=False):
    """A gloo part's run against the one-device steps
    (mesh_probe._split_against_one) under MESH_SPLIT_BOUNDS (the loss and
    grad norm of each step) and MESH_SPLIT_SHARE (each master's share of
    elements apart by over lr / 10); frozen leaves kept. With
    `gradients` (one tensor-parallel bf16 step): the loss and norm within
    step 2's bounds, and each leaf's gradient by MESH_TP_GRAD_TOL and
    MESH_TP_GRAD_FLOOR in place of the masters' share."""
    masters = c["masters"]
    worst = max(masters, key=lambda p: masters[p]["over_lr_10"])
    top = max(m["moment_max"] for m in masters.values())
    held = {p: m["moment_diff"] / m["moment_max"] for p, m in masters.items()
            if m["moment_max"] >= MESH_TP_GRAD_FLOOR * top}
    far = max(held, key=held.get)
    log(f"[{label}] one device {c['one_device']}; mesh {c['mesh']}; "
        f"masters: the most apart by over lr/10 {worst} "
        f"{masters[worst]['over_lr_10']:.4%} (over lr/100 "
        f"{max(m['over_lr_100'] for m in masters.values()):.4%} at most), "
        f"max |diff| {max(m['max'] for m in masters.values()):.3g}; "
        f"gradients (first moments): the most apart {far} {held[far]:.3g} "
        f"of its largest, {len(masters) - len(held)} leaves under "
        f"{MESH_TP_GRAD_FLOOR:g} of the tree's largest; frozen equal "
        f"{c['frozen_equal']}; seconds {c['seconds']}")
    for i, (one, mesh) in enumerate(zip(c["one_device"], c["mesh"])):
        for j, key in enumerate(("loss", "grad_norm")):
            bound = MESH_SPLIT_BOUNDS[key][1 if gradients else min(i, 1)]
            if abs(mesh[j] - one[j]) > bound * abs(one[j]):
                raise AssertionError(f"{label}: step {i + 1}'s {key} "
                                     f"{mesh[j]} against {one[j]}: {c}")
    if gradients:
        if held[far] > MESH_TP_GRAD_TOL:
            raise AssertionError(f"{label}: {far}'s gradient {held[far]} "
                                 f"of its largest apart: {c}")
    elif masters[worst]["over_lr_10"] > MESH_SPLIT_SHARE:
        raise AssertionError(f"{label}: {c}")
    if not c["frozen_equal"] or len(c["mesh"]) != steps:
        raise AssertionError(f"{label}: {c}")


def _resume_f32_rules(r):
    """Part (c)'s checkpoint in f32 (mesh_probe._resume_against_one with
    f32: the VSM case's weights and compute in f32, its attention by the
    kernels' plain versions, which K1, K7 and K2 take bf16 only): the
    read at 1x1x2 equal to the written state bit for bit, both steps'
    losses and norms within step 1's MESH_SPLIT_BOUNDS, and the first
    moments after step 1 (1x2x1) and after step 2 (resumed at 1x1x2)
    each within MESH_TP_GRAD_TOL of its leaf's largest |value| on one
    device, for leaves whose largest is at least MESH_TP_GRAD_FLOOR of
    the tree's: the rule the bf16 resume cannot meet (ROADMAP Queue 3,
    "Deliberate, kept")."""
    label = "mesh (c) VSM checkpoint of 1x2x1, f32"
    held = {}
    for step in ("moments_step1", "moments_step2"):
        m = r[step]
        top = max(v["moment_max"] for v in m.values())
        held[step] = {p: v["moment_diff"] / v["moment_max"]
                      for p, v in m.items()
                      if v["moment_max"] >= MESH_TP_GRAD_FLOOR * top}
    far = {k: max(h, key=h.get) for k, h in held.items()}
    log(f"[{label}] one device {r['one_device']}; 1x2x1 then resumed at "
        f"1x1x2 {r['mesh']}; read equal {r['read_equal']}; first moments: "
        + "; ".join(f"{k} {len(held[k])} leaves, the most apart {far[k]} "
                    f"{held[k][far[k]]:.3g} of its largest"
                    for k in held) + f"; part {r['seconds']:.1f} s")
    for i, (got, want) in enumerate(zip(r["mesh"], r["one_device"])):
        for j, key in enumerate(("loss", "grad_norm")):
            if abs(got[j] - want[j]) > \
                    MESH_SPLIT_BOUNDS[key][0] * abs(want[j]):
                raise AssertionError(f"{label}: step {i + 1}'s {key} "
                                     f"{got[j]} against {want[j]}")
    if not r["read_equal"]["mesh"] or len(r["mesh"]) != 2 or \
            any(held[k][far[k]] > MESH_TP_GRAD_TOL for k in held):
        raise AssertionError(f"{label}: {far}, {r['read_equal']}")


def _resume_rules(r):
    """Part (c)'s checkpoint (mesh_probe._resume_against_one): the VSM
    step at 1x2x1, its TrainState written by both ranks and read back at
    1x1x2 and on one device, each read equal to the written state bit for
    bit (parameters, f32 masters, moments, counts); a second step from
    each, every step's loss and grad norm against the one-device steps'
    within step 2's MESH_SPLIT_BOUNDS (as (c2)'s VSM step: the VSM's loss
    matches boxes). The masters are not held: the bf16 step before the
    checkpoint already moves SAM's near-zero-gradient leaves by lr
    sign(noise) under Adam (87 % of one attention bias over lr / 10 on
    the card), and the reads' bit-equality holds the checkpoint itself.
    export_main of the checkpoint (its directory) equals the export of
    the same state written on one device bit for bit; the resumed 1x1x2
    step launched K1, K7 and K2 on each rank and no plain version on
    CUDA. -> rank 0's launches of that step."""
    label = "mesh (c) VSM checkpoint of 1x2x1"
    log(f"[{label}] one device {r['one_device']}; resumed at 1x1x2 "
        f"{r['mesh']}; resumed on one device {r['resumed_one_device']}; "
        f"reads equal to the written state {r['read_equal']}; files "
        f"{r['export']['checkpoint_files']}, written in {r['save_s']:.2f} "
        f"s, read at 1x1x2 in {r['load_s']:.2f} s; export of "
        f"{r['export']['tensors']} tensors equal to the one-device export "
        f"{r['export']['equal']}; part {r['seconds']:.1f} s")
    for name in ("mesh", "resumed_one_device"):
        for i, (got, want) in enumerate(zip(r[name], r["one_device"])):
            for j, key in enumerate(("loss", "grad_norm")):
                if abs(got[j] - want[j]) > \
                        MESH_SPLIT_BOUNDS[key][1] * abs(want[j]):
                    raise AssertionError(f"{label} {name}: step {i + 1}'s "
                                         f"{key} {got[j]} against "
                                         f"{want[j]}: {r}")
    if not all(r["read_equal"].values()) or not r["export"]["equal"] or \
            len(r["mesh"]) != 2 or len(r["resumed_one_device"]) != 2:
        raise AssertionError(f"{label}: {r}")
    launched = None
    for rank, c in enumerate(r["counts"]):
        kernels = c["kernels"]
        k7 = sum(c["k7_heads"].values())
        log(f"[{label}, the step resumed at 1x1x2, rank {rank}] K1 / K2 "
            f"(launches, plain calls on CUDA) {kernels}; K7 {k7}")
        if not all(n[0] for n in kernels.values()) or \
                any(n[1] for n in kernels.values()) or not k7:
            raise AssertionError(f"{label} rank {rank}: the resumed step "
                                 f"skipped a kernel: {c}")
        if rank == 0:
            launched = {k: n[0] for k, n in kernels.items()}
            launched["flash_attention_bwd"] = k7
    return launched


def _tp_train(dev):
    """Part (c2): two gloo ranks on this card at 1x1x2, 7B widths with 2
    decoder layers, the decoder and the towers tensor-parallel:
    MESH_SPLIT_STEPS finetune steps and one VSM step (LoRA) against the
    one-device steps, the finetune under the MESH_SPLIT_* rules, the VSM
    step under MESH_TP_GRAD_* (_split_rules). Each
    rank logs its last step's K1 / K7 launches by heads (all at H/2 =
    16), K2's (OWL's 12 / 2 = 6, the VSM's frozen tower) and the model
    group's collectives by site and phase: per layer and micro-batch 2
    all-reduces forward, 1 in the recompute, 2 backward; no plain version
    runs on CUDA. -> (rank 0's launches of the VSM step, the report)."""
    from vstar_tpu_torch.core.config import vsm_7b
    from vstar_tpu_torch.scripts import mesh_probe
    t0 = time.perf_counter()
    c = mesh_probe.gloo_split(lr=MESH_SPLIT_LR, steps=MESH_SPLIT_STEPS,
                              shape=(1, 1, 2), vsm=True)
    cfg = vsm_7b()
    M, L = 2, 2
    heads = cfg.llama.num_heads // M
    micro = mesh_probe.MICRO
    launched = None
    for case in ("finetune", "vsm"):
        label = f"mesh (c2) gloo 1x1x2 on one card, tensor-parallel {case}"
        _split_rules(label, c[case], MESH_SPLIT_STEPS
                     if case == "finetune" else 1, gradients=case == "vsm")
        for r, counts in enumerate(c[case]["counts"]):
            split = counts["model_collectives"]
            kernels = counts["kernels"]
            log(f"[{label} rank {r}] last step: K1 launches by heads "
                f"{counts['k1_heads']}, K7 by heads {counts['k7_heads']}, "
                f"K2 by heads {counts['k2_heads']}; model-group "
                f"collectives {split}; all {counts['collectives']}; K1 / K2 "
                f"(launches, plain calls on CUDA) {kernels}")
            per_layer = {ph: split.get(f"layer all_reduce {ph}", 0)
                         / (L * micro)
                         for ph in ("forward", "recompute", "backward")}
            # (JSON keys: the heads as strings)
            k2 = counts["k2_heads"]
            if counts["k1_heads"] != {str(heads): 2 * L * micro} or \
                    counts["k7_heads"] != {str(heads): L * micro} or \
                    per_layer != {"forward": 2, "recompute": 1,
                                  "backward": 2} or \
                    any(n[1] for n in kernels.values()) or \
                    (case == "vsm" and set(k2) !=
                     {str(cfg.owl_vision.num_heads // M)}):
                raise AssertionError(f"{label} rank {r}: {counts}")
            if case == "vsm" and r == 0:
                launched = {k: n[0] for k, n in kernels.items()}
                launched["flash_attention_bwd"] = sum(
                    counts["k7_heads"].values())
    c["part_s"] = time.perf_counter() - t0
    log(f"[mesh (c2)] {c['part_s']:.1f} s")
    return launched, c


def _same_served(label, got, want, got_s, want_s):
    """Served records against the unsharded server's on the same weights:
    every field equal (the sharded engines compute the same tokens, boxes
    and choices bit for bit); logs each request's seconds beside the
    unsharded one's."""
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} records, {len(want)} "
                             "unsharded")
    for i, (g, w) in enumerate(zip(got, want)):
        diff = {k: (g.get(k), w.get(k)) for k in set(g) | set(w)
                if g.get(k) != w.get(k)}
        if diff:
            raise AssertionError(f"{label} request {i}: fields differ "
                                 f"(sharded, unsharded): {diff}")
    log(f"[{label}] {len(got)} records equal the unsharded server's; "
        f"seconds sharded {[round(x, 3) for x in got_s]} against unsharded "
        f"{[round(x, 3) for x in want_s]}; searched "
        f"{[len(r['search_result']) for r in got]} boxes")


def _mesh_serve(dev, mark):
    """Part (d), serving over the mesh (serve/ranks.py): the random-init
    pair at 7B widths with 2 decoder layers (the VSM tilted to answer
    [LOC]) exported to HF directories and loaded by the server's
    checkpoint_engines, every search forced (3 steps,
    mesh_probe.forced_searches and the continuous service's
    search_kwargs); the unsharded server's records first, outside every
    count window (mesh_probe.SERVE_REQUESTS over HTTP: free-form, with
    options, a forced search; mesh_probe.WAVE_REQUESTS as one wave of 3
    through ContinuousSealService), then
    (d1) a world of one NCCL rank, --mesh 1x1x1: SealService with its
    Ranks over HTTP (path mesh_serve);
    (d2) the same engines, ContinuousSealService with its Ranks, the
    wave of 3 (path mesh_serve_continuous);
    (d3) two gloo ranks on this card, --mesh 1x2x1: each decoder's layer
    stack on the hidden axis (core/mesh.hidden_split); rank 0 serves a
    free-form request and the forced search over HTTP and rank 1
    follows (mesh_probe.gloo_serve; path mesh_serve_gloo, _fsdp_serve);
    then the --int4mix pair's forced search so (path
    mesh_serve_gloo_int4mix), and once more under act-int8 (path
    mesh_serve_gloo_act_int8: the int8 entries' W8A8 products and gate /
    up's K6 at decode rows on each rank's share, the rows' max and the
    int8 products all-reduced over fsdp);
    (d4) the forced search at --mesh 1x1x2: the decoder tensor-parallel
    over the model axis (path mesh_serve_tp, _tp_serve).
    Every record of (d1) and (d2) equals the unsharded one; (d3)'s and
    (d4)'s hold to it by the near-tie rules; K1 and K2 launch on each
    path and no plain version runs on CUDA."""
    import torch.distributed as dist
    from vstar_tpu_torch.core.hf_export import (save_hf_dir,
                                                vqa_llm_state_dict,
                                                vsm_state_dict)
    from vstar_tpu_torch.models.vqa_llm import init_vqa_llm_params
    from vstar_tpu_torch.models.vsm import init_vsm_params
    from vstar_tpu_torch.nn.quant import set_act_int8
    from vstar_tpu_torch.scripts import mesh_probe as mp
    from vstar_tpu_torch.serve import ranks as R
    from vstar_tpu_torch.serve.server import SealService
    t0 = time.perf_counter()
    kernels = ("flash_attention", "tower_attention")
    vqa_cfg, vsm_cfg = _hf_cfgs()
    vocab = vsm_cfg.llama.vocab_size
    report, counts = {}, {}
    with tempfile.TemporaryDirectory() as work:
        dirs = {k: os.path.join(work, k) for k in ("vqa", "vsm")}
        params = init_vqa_llm_params(SEED, vqa_cfg, device=dev,
                                     dtype=torch.bfloat16)
        save_hf_dir(vqa_llm_state_dict(params, dtype=torch.bfloat16),
                    vqa_cfg, dirs["vqa"], shard_bytes=HF_SHARD_BYTES)
        params = init_vsm_params(SEED + 1, vsm_cfg, device=dev,
                                 dtype=torch.bfloat16)
        params["llama"]["embed_tokens"][:, 0] += 100   # answers [LOC]
        params["llama"]["lm_head"][0, 3] = 10
        save_hf_dir(vsm_state_dict(params, dtype=torch.bfloat16), vsm_cfg,
                    dirs["vsm"], shard_bytes=HF_SHARD_BYTES)
        del params
        report["export_s"] = time.perf_counter() - t0
        mark("(d) export")

        vqa, vsm = mp.serving_pair(dirs, None, dev, vocab)
        with mp.forced_searches():
            ref, ref_s = mp.http_records(
                SealService(mp.MarkedTrigger(vqa), vsm), dev)
        wave_ref, wave_ref_s, _ = mp.continuous_records(vqa, vsm, None, dev)
        # (d3)'s and (d4)'s reference: the free-form request and the
        # forced search, their decodes traced and the search path kept
        split_ref = {"events": []}
        with mp.forced_searches(split_ref["events"]):
            split_ref["records"], split_ref["seconds"] = mp.http_records(
                SealService(mp.MarkedTrigger(vqa, split_ref["events"]),
                            vsm), dev,
                [mp.SERVE_REQUESTS[i] for i in FSDP_REQUESTS])
        # the free-form request traces one decode; the search's follow
        tp_ref = {k: v[1:] for k, v in split_ref.items()}
        del vqa, vsm
        gc.collect()
        torch.cuda.empty_cache()
        # (d3)'s quantized reference: the --int4mix pair's forced search,
        # and the same under act-int8
        vqa, vsm = mp.serving_pair(dirs, None, dev, vocab,
                                   flags=FSDP_QUANT_FLAGS)
        quant_ref = {"events": []}
        with mp.forced_searches(quant_ref["events"]):
            quant_ref["records"], quant_ref["seconds"] = mp.http_records(
                SealService(mp.MarkedTrigger(vqa, quant_ref["events"]),
                            vsm), dev, mp.SERVE_REQUESTS[2:])
        act_ref = {"events": []}
        set_act_int8(True)
        try:
            with mp.forced_searches(act_ref["events"]):
                act_ref["records"], act_ref["seconds"] = mp.http_records(
                    SealService(mp.MarkedTrigger(vqa, act_ref["events"]),
                                vsm), dev, mp.SERVE_REQUESTS[2:])
        finally:
            set_act_int8(False)
        del vqa, vsm
        gc.collect()
        torch.cuda.empty_cache()
        if not ref[2]["search_result"]:
            raise AssertionError(f"mesh (d): the forced search found "
                                 f"nothing: {ref[2]}")
        mark("(d) unsharded")

        t1 = time.perf_counter()
        dist.init_process_group(
            "nccl", init_method=f"tcp://127.0.0.1:{mp._free_port()}",
            rank=0, world_size=1)
        try:
            vqa, vsm = mp.serving_pair(dirs, "1x1x1", dev, vocab)
            if vqa.mesh is None or vqa.mesh is not vsm.mesh:
                raise AssertionError("mesh (d1): the engines are not on one "
                                     "Mesh")
            ranks = R.for_engines(vqa, vsm)
            svc = SealService(mp.MarkedTrigger(vqa), vsm, ranks=ranks)
            _zero_counts()
            try:
                with mp.forced_searches():
                    got, got_s = mp.http_records(svc, dev)
            finally:
                ranks.stop()
            counts["mesh_serve"] = _check_path("mesh serve (d1)", kernels)
            _same_served("mesh (d1) SealService 1x1x1 NCCL", got, ref,
                         got_s, ref_s)
            report["d1"] = {"seconds": got_s, "unsharded_seconds": ref_s,
                            "part_s": time.perf_counter() - t1}
            mark("(d1)")
            t1 = time.perf_counter()
            ranks = R.for_engines(vqa, vsm)
            _zero_counts()
            try:
                wave, wave_s, stats = mp.continuous_records(vqa, vsm, ranks,
                                                            dev)
            finally:
                ranks.stop()
            counts["mesh_serve_continuous"] = _check_path(
                "mesh serve (d2)", kernels)
            if stats["waves"] != 1 or stats["max_wave"] != 3:
                raise AssertionError(f"mesh (d2): not one wave of 3: "
                                     f"{stats}")
            _same_served("mesh (d2) ContinuousSealService wave of 3",
                         wave, wave_ref, wave_s, wave_ref_s)
            report["d2"] = {"seconds": wave_s, "unsharded_seconds":
                            wave_ref_s, "part_s": time.perf_counter() - t1}
            mark("(d2)")
        finally:
            vqa = vsm = svc = None
            dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()

        counts["mesh_serve_gloo"], report["d3"] = _fsdp_serve(
            dirs, vocab, dev, split_ref, vsm_cfg)
        mark("(d3)")
        gc.collect()
        torch.cuda.empty_cache()
        counts["mesh_serve_gloo_int4mix"], report["d3_int4mix"] = \
            _fsdp_serve(dirs, vocab, dev, quant_ref, vsm_cfg, requests=(2,),
                        flags=FSDP_QUANT_FLAGS)
        mark("(d3) --int4mix")
        gc.collect()
        torch.cuda.empty_cache()
        counts["mesh_serve_gloo_act_int8"], report["d3_act_int8"] = \
            _fsdp_serve(dirs, vocab, dev, act_ref, vsm_cfg, requests=(2,),
                        flags=FSDP_QUANT_FLAGS, act_int8=True)
        mark("(d3) --int4mix act-int8")
        gc.collect()
        torch.cuda.empty_cache()
        counts["mesh_serve_tp"], report["d4"] = _tp_serve(
            dirs, vocab, dev, tp_ref, vsm_cfg)
        mark("(d4)")
    report["seconds"] = time.perf_counter() - t0
    log(f"[mesh serve] part (d) {report['seconds']:.1f} s")
    return counts, report


# Part (d3): the fsdp axis of two gloo ranks on this card: a free-form
# request and the forced search (mesh_probe.SERVE_REQUESTS 0 and 2)
FSDP_MESH = "1x2x1"
FSDP_REQUESTS = (0, 2)
# and the forced search of the quantized pair: K3 and K5 on each rank's
# share of the layers
FSDP_QUANT_FLAGS = ("--int4mix",)


def _free_form_rules(label, want, got, ref_event, event):
    """A split server's record of a free-form request (no search) against
    the unsharded server's: the answer equals greedy's tokens or parts
    at a near-tie (_equivalent on the traced decodes), every other field
    equal. Returns the near-tie, or None."""
    if set(got) != set(want):
        raise AssertionError(f"{label}: keys {sorted(got)} against "
                             f"{sorted(want)}")
    for k in set(want) - {"answer"}:
        if got[k] != want[k]:
            raise AssertionError(f"{label}: {k} {got[k]!r} against "
                                 f"{want[k]!r}")
    if ref_event[0] != "decode" or event[0] != "decode":
        raise AssertionError(f"{label}: events {event[0]}, {ref_event[0]}")
    tie = _equivalent(f"{label} answer", ref_event[1], event[1])
    if tie is None and got["answer"] != want["answer"]:
        raise AssertionError(f"{label}: answers differ without a differing "
                             "token")
    log(f"[{label}] answer {got['answer']!r} (unsharded "
        f"{want['answer']!r}); near-tie {tie}")
    return tie


def _fsdp_serve(dirs, vocab, dev, ref, cfg, requests=FSDP_REQUESTS,
                flags=(), act_int8=False):
    """Part (d3): two gloo ranks on this card at --mesh 1x2x1 load the pair
    through checkpoint_engines with the server's `flags`, each decoder's
    layer stack on the hidden axis (core/mesh.hidden_split); rank 0
    answers `requests` (indices into mesh_probe.SERVE_REQUESTS: 0 the
    free-form request, 2 the forced search) over HTTP and rank 1 follows
    (mesh_probe.gloo_serve). The records hold to the unsharded server's
    (`ref`: records and events of the same requests, same flags) by
    _free_form_rules and _tp_record_rules. Each rank logs and checks: no
    decoder layer fetched (0 broadcasts and all-gathers of a layer a
    token), 4 all-reduces over the fsdp group a layer and forward (two
    rmsnorm moments, q / k / v, gate / up: K1 launches once a layer and
    forward) and one gather of the residual a forward, no other fsdp
    collective, K1 on all of `cfg`'s heads, KV caches of all its KV
    heads; with --int4mix also K3 and K5 on the rank's share of each
    layer. With `act_int8` (the switch on in every rank; `ref` the
    unsharded server's under it; --int4mix: an int8 VQA decoder, an
    int4mix VSM decoder): the int8 entries take W8A8, not K3; each layer
    and forward runs the two moments' f32 all-reduces, one int32
    all-reduce of q / k / v's partial products, gate / up's sum in int32
    (int8) or f32 (int4), one MAX of the rows' max for each int32 sum and
    for each group that takes K6 (the VSM's gate / up at decode rows); K6
    and its row quantization (quantize_rows, given the max) launch once
    a product and once a group on each rank, no plain version on CUDA. ->
    (rank 0's kernel launches, the report)."""
    from vstar_tpu_torch.scripts import mesh_probe as mp
    t0 = time.perf_counter()
    g = mp.gloo_serve(dirs, vocab, str(dev), mesh=FSDP_MESH, requests=[
        mp.SERVE_REQUESTS[i] for i in requests], flags=flags,
        act_int8=act_int8)
    counts = dict(g["counts"])
    if flags:
        counts.update(g["ranks"][0]["counts"]["quant_kernels"])
    if act_int8:
        del counts["int8_matvec"]
        counts.update(g["ranks"][0]["counts"]["w4a8_kernels"])
    plain = {k: c[1] for k, c in counts.items()}
    launched = {k: c[0] for k, c in counts.items()}
    label = (f"mesh serve (d3) gloo {' '.join((FSDP_MESH, *flags))}"
             f"{' act-int8' if act_int8 else ''}, hidden axis split")
    log(f"[{label}] decoder stack {g['stack_sharded']}, loaded in "
        f"{g['load_s']:.2f} s; kernel launches {launched}, plain-version "
        f"calls on CUDA {plain}; seconds {g['seconds']} (unsharded "
        f"{ref['seconds']})")
    if any(plain.values()) or not all(launched.values()) or \
            g["stack_sharded"] != "DTensor":
        raise AssertionError(f"mesh (d3): {counts}")
    lcfg = cfg.llama
    per_rank = []
    for r in g["ranks"]:
        c, caches = r["counts"], r["caches"]
        k1 = c["kernels"]["flash_attention"][0]
        forwards = k1 // lcfg.num_layers
        tokens = sum(e[1]["n"][0] for e in g["events"] if e[0] == "decode")
        fsdp = {k: n for k, n in c["collectives"].items()
                if k.endswith(" fsdp")}
        split = c["hidden_collectives"]
        ar = split.get("layer all_reduce forward", 0)
        gathers = split.get("residual all_gather forward", 0)
        act_max = split.get("act_max all_reduce forward", 0)
        act_int32 = split.get("act_int32 all_reduce forward", 0)
        k6, q = (c["w4a8_kernels"][k] for k in ("int4_matmul_w4a8",
                                                "quantize_rows"))
        log(f"[{label} rank {r['rank']}] layer broadcasts and all-gathers "
            f"{c['fetch_collectives'] or 0} over {tokens} decoded tokens "
            f"and {forwards} decoder forwards (0 a token); fsdp all-reduces a "
            f"layer and forward {ar / max(k1, 1):g} of f32 sums, "
            f"{act_int32 / max(k1, 1):g} int32, {act_max / max(k1, 1):g} "
            f"MAX; residual gathers a "
            f"forward {gathers / max(forwards, 1):g}; fsdp collectives "
            f"{fsdp}; K1 launches by heads {c['k1_heads']}; K3 / K5 "
            f"{c['quant_kernels']}; K6 / quantize_rows (launches, plain "
            f"calls on CUDA) {k6} / {q}; KV caches "
            + "; ".join(f"{n} {v['kv_heads']} heads, largest "
                        f"{v['largest_cache']}" for n, v in caches.items()))
        if act_int8:
            # each layer and forward: two moments and q / k / v's int32
            # sum; gate / up's sum in int32 (the VQA's int8 decoder) or in
            # f32 (the VSM's int4 gate / up); a MAX for each int32 sum and
            # each K6 group
            if ar + act_int32 != 4 * k1 or ar < 2 * k1 or \
                    act_int32 < k1 or act_max != act_int32 + k6[0] // 2 \
                    or not k6[0] or k6[0] != 2 * q[0] or k6[1] or q[1]:
                raise AssertionError(
                    f"mesh (d3) act-int8 rank {r['rank']}: f32 / int32 / "
                    f"MAX all-reduces {(ar, act_int32, act_max)} over "
                    f"{k1} layer forwards; K6 {k6}, quantize_rows {q}")
        elif act_max or act_int32 or k6[0] or q[0]:
            raise AssertionError(f"mesh (d3) rank {r['rank']}: act-int8 "
                                 f"collectives or kernels with the switch "
                                 f"off: {split}, K6 {k6}, quantize_rows {q}")
        if c["fetch_collectives"] or not k1 or \
                ar + act_int32 != 4 * k1 or \
                gathers != forwards or k1 % lcfg.num_layers or \
                fsdp != {"all_reduce fsdp": ar + act_max + act_int32,
                         "all_gather fsdp": gathers}:
            raise AssertionError(f"mesh (d3) rank {r['rank']}: layer "
                                 f"fetches {c['fetch_collectives']}, fsdp "
                                 f"collectives {fsdp}, hidden split {split}"
                                 f", K1 launches {k1}")
        if c["k1_heads"] != {lcfg.num_heads: k1}:
            raise AssertionError(f"mesh (d3) rank {r['rank']}: K1 heads "
                                 f"{c['k1_heads']}, expected "
                                 f"{lcfg.num_heads}")
        for name, v in caches.items():
            if v["kv_heads"] != [lcfg.num_kv_heads]:
                raise AssertionError(f"mesh (d3) rank {r['rank']} {name}: "
                                     f"KV heads {v['kv_heads']}")
        per_rank.append({"k1_heads": c["k1_heads"], "k1_launches": k1,
                         "quant_kernels": c["quant_kernels"],
                         "w4a8_kernels": c["w4a8_kernels"],
                         "fetch_collectives": c["fetch_collectives"],
                         "fsdp_collectives": fsdp, "hidden_split": split,
                         "decoded_tokens": tokens, "forwards": forwards,
                         "kv": caches})
    # a free-form request traces one decode; a forced search three (the
    # trigger, the search, the focused answer)
    ties, at = [], 0
    for i, want, got in zip(requests, ref["records"], g["records"]):
        if i == 0:
            ties.append(_free_form_rules(
                f"{label} free-form, rank 1 following", want, got,
                ref["events"][at], g["events"][at]))
            at += 1
        else:
            ties += _tp_record_rules(
                f"{label} forced search, rank 1 following", want, got,
                ref["events"][at:at + 3], g["events"][at:at + 3])
            at += 3
    seconds = time.perf_counter() - t0
    log(f"[{label}] part {seconds:.1f} s")
    return launched, {"seconds": g["seconds"],
                      "unsharded_seconds": ref["seconds"],
                      "load_s": g["load_s"], "near_ties": ties,
                      "ranks": per_rank, "part_s": seconds}


# Part (d4): the model axis of two gloo ranks on this card
TP_MESH = "1x1x2"
TP_RECORD_FIELDS = {"missing_objects", "search_result", "answer",
                    "option_chosen", "correct", "failed_objects"}


def _tp_record_rules(label, want, got, ref_events, events):
    """A split server's record of the forced search (the model axis of
    (d4), the hidden axis of (d3)) against the unsharded server's: the
    same fields, equal but for those a near-tie moves. Its bf16 split
    products round otherwise than the whole ones, so the search path
    equals or parts at a near-tie (_same_search), the focused answer
    equals greedy's tokens or parts at a near-tie (_equivalent on the
    traced decodes), the boxes' names equal (their coordinates logged),
    the other fields equal. Returns the near-ties found."""
    ties = []
    if set(got) != set(want):
        raise AssertionError(f"{label}: keys {sorted(got)} against "
                             f"{sorted(want)}")
    kinds = [k for k, _ in ref_events]
    if [k for k, _ in events] != kinds or kinds.count("search") != 1 or \
            kinds[-1] != "decode":
        raise AssertionError(f"{label}: events {[k for k, _ in events]} "
                             f"against {kinds}")
    searched = kinds.index("search")
    d = _same_search(f"{label} search", ref_events[searched][1],
                     events[searched][1])
    if d is not None:
        ties.append(("search", d))
    for i in range(len(kinds)):
        if kinds[i] == "decode" and i != len(kinds) - 1:
            # an answer the trigger replaces: logged, not held
            _equivalent(f"{label} decode {i}", ref_events[i][1],
                        events[i][1])
    if got["missing_objects"] != ["red mug"] or \
            want["missing_objects"] != ["red mug"]:
        raise AssertionError(f"{label}: missing objects "
                             f"{got['missing_objects']}")
    if [r["name"] for r in got["search_result"]] != \
            [r["name"] for r in want["search_result"]] and d is None:
        raise AssertionError(f"{label}: search results "
                             f"{got['search_result']} against "
                             f"{want['search_result']}")
    box = max((float(np.abs(np.subtract(g["bbox"], w["bbox"])).max())
               for g, w in zip(got["search_result"], want["search_result"])),
              default=0.0)
    for k in set(want) - TP_RECORD_FIELDS:
        if got[k] != want[k]:
            raise AssertionError(f"{label}: {k} {got[k]!r} against "
                                 f"{want[k]!r}")
    if d is None:
        if got["failed_objects"] != want["failed_objects"]:
            raise AssertionError(f"{label}: failed objects "
                                 f"{got['failed_objects']} against "
                                 f"{want['failed_objects']}")
        a = _equivalent(f"{label} focused answer", ref_events[-1][1],
                        events[-1][1])
        if a is None and got["answer"] != want["answer"]:
            raise AssertionError(f"{label}: answers differ without a "
                                 "differing token")
        if a is not None:
            ties.append(("answer", a))
    log(f"[{label}] answer {got['answer']!r} (unsharded "
        f"{want['answer']!r}), boxes {len(got['search_result'])} "
        f"(unsharded {len(want['search_result'])}), largest |box "
        f"difference| {box:.4g} px; near-ties {ties}")
    return ties


def _tp_serve(dirs, vocab, dev, ref, cfg):
    """Part (d4): two gloo ranks on this card at --mesh 1x1x2 load the
    pair through checkpoint_engines, every decoder tensor-parallel on the
    model axis; rank 0 serves the forced search over HTTP and rank 1
    follows (mesh_probe.gloo_serve). The record holds to the unsharded
    server's (`ref`: records and events of the same request) by
    _tp_record_rules. Each rank logs K1's launches by query heads (all
    at H/2), its collectives (two all-reduces a layer and forward over
    the model group, no gather on the model axis after loading) and its
    KV slabs (H_kv/2 heads, half the bytes an unsharded slab of the same
    caches takes); the towers split too (`cfg`'s OWL tower: K2 on H/2
    heads, every other model-axis collective a tower's). -> (rank 0's
    K1 / K2 launches, the report)."""
    from vstar_tpu_torch.scripts import mesh_probe as mp
    t0 = time.perf_counter()
    g = mp.gloo_serve(dirs, vocab, str(dev), mesh=TP_MESH)
    plain = {k: c[1] for k, c in g["counts"].items()}
    launched = {k: c[0] for k, c in g["counts"].items()}
    label = f"mesh serve (d4) gloo {TP_MESH}, tensor-parallel"
    log(f"[{label}] decoder stack {g['stack_sharded']}, loaded in "
        f"{g['load_s']:.2f} s; kernel launches {launched}, plain-version "
        f"calls on CUDA {plain}; seconds {g['seconds']} (unsharded "
        f"{ref['seconds']})")
    if any(plain.values()) or not all(launched.values()) or \
            g["stack_sharded"] != "DTensor":
        raise AssertionError(f"mesh (d4): {g['counts']}")
    M = int(TP_MESH.split("x")[2])
    lcfg, owl_heads = cfg.llama, cfg.owl_vision.num_heads
    heads, kv_heads = lcfg.num_heads // M, lcfg.num_kv_heads // M
    per_rank = []
    for r in g["ranks"]:
        c, caches = r["counts"], r["caches"]
        model = {k: n for k, n in c["collectives"].items()
                 if k.endswith(" model")}
        for v in caches.values():
            # the newest slab holds the largest cache's k and v (bf16),
            # a power of two of elements: half the unsharded one
            n = 2 * int(np.prod(v["largest_cache"]))
            v["expected_slab_bytes"] = (1 << (n - 1).bit_length()) * 2
            v["unsharded_slab_bytes"] = M * v["expected_slab_bytes"]
        log(f"[{label} rank {r['rank']}] K1 launches by heads "
            f"{c['k1_heads']}, K2 launches by heads {c['k2_heads']}, K1 / "
            f"K2 launches {c['kernels']}; collectives {c['collectives']}, "
            f"by model split {c['model_collectives']}; KV caches "
            + "; ".join(f"{n} {v['kv_heads']} heads, largest "
                        f"{v['largest_cache']}, slabs {v['slabs']} B "
                        f"(unsharded {v['unsharded_slab_bytes']} B)"
                        for n, v in caches.items()))
        if set(c["k1_heads"]) != {heads} or \
                c["k1_heads"][heads] != c["kernels"]["flash_attention"][0]:
            raise AssertionError(f"mesh (d4) rank {r['rank']}: K1 heads "
                                 f"{c['k1_heads']}, expected {heads}")
        # one attention call (a K1 launch) a layer and forward, and two
        # all-reduces beside it; every other collective on the model axis
        # is a tower's (its layers split as XLA splits them: K2 on H/2 of
        # OWL's heads)
        split = c["model_collectives"]
        ar = split.get("layer all_reduce forward", 0)
        tower = {op: split.get(f"tower {op} forward", 0)
                 for op in ("all_reduce", "all_gather")}
        k2_heads = owl_heads // M
        if set(model) - {"all_reduce model", "all_gather model"} or \
                ar != 2 * c["kernels"]["flash_attention"][0] or \
                model.get("all_reduce model", 0) != ar + tower["all_reduce"] \
                or model.get("all_gather model", 0) != tower["all_gather"] \
                or not tower["all_gather"] or \
                set(c["k2_heads"]) != {k2_heads}:
            raise AssertionError(f"mesh (d4) rank {r['rank']}: model-axis "
                                 f"collectives {model}, by split {split}, "
                                 f"K2 heads {c['k2_heads']} (expected "
                                 f"{k2_heads})")
        for name, v in caches.items():
            if v["kv_heads"] != [kv_heads] or \
                    max(v["slabs"]) != v["expected_slab_bytes"]:
                raise AssertionError(
                    f"mesh (d4) rank {r['rank']} {name}: KV heads "
                    f"{v['kv_heads']}, slabs {v['slabs']} B, expected "
                    f"{kv_heads} heads in {v['expected_slab_bytes']} B")
        per_rank.append({"k1_heads": c["k1_heads"],
                         "k2_heads": c["k2_heads"],
                         "k1_launches": c["kernels"]["flash_attention"][0],
                         "model_all_reduces": ar, "tower_collectives": tower,
                         "kv": caches})
    ties = _tp_record_rules(f"{label}, rank 1 following", ref["records"][0],
                            g["records"][0], ref["events"], g["events"])
    return launched, {"seconds": g["seconds"],
                      "unsharded_seconds": ref["seconds"],
                      "load_s": g["load_s"], "near_ties": ties,
                      "ranks": per_rank,
                      "part_s": time.perf_counter() - t0}


# ---------------------------------------------------------------------------

def _kernel_entry(name, source, replaces, launches, cases):
    """The JSON record of one kernel; the top-level numbers are its first
    (main) case's; `launches` counts the path that brought the kernel in
    (`path`), `launches_by_path` every path."""
    main = cases[0]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "path": launches["path"],
            "launches": launches["own"],
            "launches_by_path": launches["by_path"],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "max_rel_err": max(c["max_rel_err"] for c in cases),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "timed_case": main["case"],
            "cases": cases}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on the card",
              file=sys.stderr)
        return 1
    # plain references in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    t_start = time.perf_counter()

    def mark(phase):
        log(f"[time] {phase} done at {time.perf_counter() - t_start:.1f} s")

    smi = phase_device()
    # each decode-graph capture and static cache, with the memory it takes
    graphs_log = logging.getLogger("vstar_tpu_torch.decode.graphs")
    graphs_log.setLevel(logging.INFO)
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter("[graphs] %(message)s"))
    graphs_log.addHandler(handler)
    kernel_info = phase_build()
    phase_quantizers(dev)
    mark("quantizers")
    cases = {"flash_attention": phase_k1(dev),
             "tower_attention": phase_k2(dev),
             "int8_matvec": phase_int8(dev)}
    (cases["int4_matmul"], cases["int4_matmul_w4a8"],
     cases["quantize_rows"]) = phase_int4(dev)
    cases.update(phase_p(dev))
    k1_lse, k7 = phase_k7(dev)
    cases["flash_attention"].append(k1_lse)
    cases["flash_attention_bwd"] = [k7]
    mark("kernels")
    gc.collect()
    torch.cuda.empty_cache()
    by_path, decode_slice = {}, {}
    by_path["bf16"], by_path["bf16_slice"], decode_slice["bf16"] = \
        phase_bf16_path(dev)
    mark("bf16_path")
    gc.collect()
    torch.cuda.empty_cache()
    by_path["int4mix"], by_path["int4mix_slice"], \
        decode_slice["int4mix"] = phase_quantized_path(dev)
    mark("quantized_path")
    for label in ("bf16", "int4mix"):
        for key in [k for k in decode_slice[label] if k.endswith("_by_part")]:
            for part, counts in decode_slice[label].pop(key).items():
                by_path[f"{label}_{key[:-len('_by_part')]}_{part}"] = counts
    gc.collect()
    torch.cuda.empty_cache()
    by_path["int4_profile"], profile = phase_int4_profile(dev)
    mark("int4_profile")
    gc.collect()
    torch.cuda.empty_cache()
    by_path["train"], train = phase_train(dev)
    mark("train")
    by_path["train"]["flash_attention_bwd"] = \
        by_path["train"]["flash_attention_bwd_dq"]
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_loop(dev)
    mark("train_loop")
    gc.collect()
    torch.cuda.empty_cache()
    hf_counts, hf = phase_hf(dev)
    by_path.update(hf_counts)
    mark("hf")
    gc.collect()
    torch.cuda.empty_cache()
    vqa_counts, train_vqa = phase_train_vqa(dev)
    for counts in vqa_counts.values():
        counts["flash_attention_bwd"] = counts["flash_attention_bwd_dq"]
    by_path.update(vqa_counts)
    mark("train_vqa")
    gc.collect()
    torch.cuda.empty_cache()
    mesh_counts, mesh = phase_mesh(dev)
    mesh_counts["mesh_pretrain"]["flash_attention_bwd"] = \
        mesh_counts["mesh_pretrain"]["flash_attention_bwd_dq"]
    by_path.update(mesh_counts)
    mark("mesh")
    if "jax" in sys.modules or "vstar_tpu" in sys.modules:
        raise AssertionError("JAX or the JAX package was imported")
    sources = {
        "flash_attention": ("flash_attention.cu",
                            "vstar_tpu/kernels/flash_attention.py:82", "bf16"),
        "flash_attention_bwd": ("flash_attention_bwd.cu",
                                "vstar_tpu/kernels/flash_attention.py:194, "
                                ":244", "train"),
        "tower_attention": ("tower_attention.cu",
                            "vstar_tpu/kernels/tower_attention.py:39", "bf16"),
        "int8_matvec": ("int8_matvec.cu",
                        "vstar_tpu/kernels/int8_matmul.py:26, "
                        "vstar_tpu/kernels/stream_matvec.py:28", "int4mix"),
        "int4_matmul": ("int4_matmul.cu",
                        "vstar_tpu/kernels/int4_matmul.py:41", "int4mix"),
        "int4_matmul_w4a8": ("int4_matmul.cu",
                             "vstar_tpu/kernels/int4_matmul.py:126",
                             "int4mix"),
        # no Pallas kernel: XLA fuses qdot4_w4a8's quantization around K6
        "quantize_rows": ("int4_matmul.cu",
                          "vstar_tpu/kernels/int4_matmul.py:255", "int4mix"),
        "unpack_probe": ("int4_variants.cu", "scripts/int4_profile.py:90",
                         "int4_profile"),
        "w4a8_variant": ("int4_variants.cu", "scripts/int4_profile.py:324",
                         "int4_profile"),
        "w4a8_rows": ("int4_variants.cu", "scripts/int4_profile.py:298",
                      "int4_profile"),
        "w4a8_t": ("int4_variants.cu", "scripts/int4_profile.py:265",
                   "int4_profile"),
    }
    kernels = []
    for name, (src, replaces, own) in sources.items():
        launches = {"path": own, "own": by_path[own][name],
                    "by_path": {p: n[name] for p, n in by_path.items()
                                if name in n}}
        kernels.append(_kernel_entry(name, f"vstar_tpu_torch/csrc/{src}",
                                     replaces, launches, cases[name]))
    k1_entry = next(k for k in kernels if k["name"] == "flash_attention")
    k1_entry["routes_by_path"] = {p: n["flash_attention_routes"]
                                  for p, n in by_path.items()
                                  if "flash_attention_routes" in n}
    k5_entry = next(k for k in kernels if k["name"] == "int4_matmul")
    k5_entry["routes_by_path"] = {p: n["int4_matmul_routes"]
                                  for p, n in by_path.items()
                                  if "int4_matmul_routes" in n}
    k7_entry = next(k for k in kernels if k["name"] == "flash_attention_bwd")
    k7_entry["launches_by_kernel"] = {
        k: by_path["train"][f"flash_attention_bwd_{k}"] for k in ("dq", "dkv")}
    k1_entry["split_by_rows_by_path"] = {
        p: n["flash_attention_split_by_rows"] for p, n in by_path.items()
        if "flash_attention_split_by_rows" in n}
    print(json.dumps({"kernels": kernels, "kernel_info": kernel_info,
                      "train": train, "int4_profile": profile,
                      "decode_slice": decode_slice, "hf": hf,
                      "train_vqa": train_vqa, "mesh": mesh}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
