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
     its memory ("[graphs]");
  5. the quantized path (--int4mix: int8 VQA decoder, int4mix VSM decoder,
     int8 towers), after the bf16 pair is freed: one answer on 2048x1536,
     one forced-search sample, and one more with the act-int8 switch on;
     then the decode slice of 4, part (a) of the lockstep search and the
     compiled searches (without the context-cue search) on the
     --int4mix pair;
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
     kernels' 128) over synthetic dataset files, with a resume.
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
    for case, shape in (("owl_768", (1, 2305, 12, 64)),
                        ("s600", (2, 600, 12, 64)),
                        ("owl_768_b4", (4, 2305, 12, 64)),
                        ("owl_768_b8", (8, 2305, 12, 64)),
                        ("owl_768_b16", (16, 2305, 12, 64))):
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


def _engine_like(e, params=None, device_preprocess=False):
    """A BatchedVSMEngine like e, on e's weights or on params."""
    from vstar_tpu_torch.search.batched import BatchedVSMEngine
    return BatchedVSMEngine(e.params if params is None else params, e.cfg,
                            e.tokenizer, loc_token_id=e.loc_token_id,
                            device=e.device, eos_id=e.eos_id,
                            max_new_tokens=e.max_new_tokens,
                            prompt_buckets=e.prompt_buckets,
                            compute_dtype=e.compute_dtype,
                            device_preprocess=device_preprocess)


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

TRAIN_NAMES = ["red mug", "bicycle", "street sign", "dog", "window",
               "green bottle", "person", "clock"]


def _train_rows(n, seed):
    """n synthetic VSM rows: preprocessed-like CLIP (224) and OWL (768)
    images, a rectangle mask, 1-4 target boxes; row 1 has no valid mask
    and row 2 no valid boxes, so every loss term is live."""
    from vstar_tpu_torch.data.vsm_collate import VSMRow
    rng = np.random.RandomState(seed)
    rows = []
    for i in range(n):
        mask = np.zeros((480, 640), np.float32)
        y0, x0 = rng.randint(0, 300), rng.randint(0, 400)
        mask[y0:y0 + 150, x0:x0 + 200] = 1.0
        nb = 1 + i % 4
        boxes = np.concatenate([rng.uniform(0.2, 0.8, (nb, 2)),
                                rng.uniform(0.05, 0.3, (nb, 2))], 1)
        rows.append(VSMRow(
            image_clip=rng.randn(224, 224, 3).astype(np.float32),
            image_owl=rng.randn(768, 768, 3).astype(np.float32),
            source=[{"from": "human", "value": "<image>\nPlease locate the "
                     f"{TRAIN_NAMES[i % len(TRAIN_NAMES)]} in this image."},
                    {"from": "gpt", "value": "Sure, [LOC]."}],
            gt_mask=mask, mask_valid=i != 1,
            tgt_boxes=boxes.astype(np.float32), bboxes_valid=i != 2))
    return rows


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
    from vstar_tpu_torch.data.vsm_collate import (batch_to_torch,
                                                  collate_vsm_rows)
    from vstar_tpu_torch.models.vsm import init_vsm_params
    from vstar_tpu_torch.multimodal.constants import IGNORE_INDEX
    from vstar_tpu_torch.multimodal.stub_tokenizer import StubTokenizer
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
    host = collate_vsm_rows(_train_rows(8, SEED), StubTokenizer(
        cfg.llama.vocab_size), 3, n_image_tokens=cfg.image_tokens,
        seq_bucket=512, mask_res=768)
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
        for part, counts in decode_slice[label].pop(
                "lockstep_by_part").items():
            by_path[f"{label}_lockstep_{part}"] = counts
        for part, counts in decode_slice[label].pop(
                "compiled_by_part").items():
            by_path[f"{label}_compiled_{part}"] = counts
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
                      "decode_slice": decode_slice}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
