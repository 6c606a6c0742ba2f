"""Chip smoke for the PyTorch / H100 port (vstar_tpu_torch).

Runs on one CUDA card, in phases; any failure exits non-zero:
  1. card and versions;
  2. build the CUDA kernels from vstar_tpu_torch/csrc (one nvcc per
     source, in parallel);
  3. every kernel against its plain PyTorch version at the 7B shapes of
     the path: K1 flash attention, K2 tower attention, the int8 matvec
     (K3/K4) at R in {1, 8, 16}, K5 (W4A16) at R in {1, 16, 384} and K6
     (W4A8) at R in {1, 8}; K5 also against its own arithmetic (bf16
     weights above 16 rows) within its output's rounding; each case is timed by device time (one CUDA
     graph of N launches over weight copies that exceed the L2 cache) and
     by CUDA events around single calls, beside its plain version, its
     bound and, where one PyTorch call computes the same function, that
     call timed the same two ways (a yardstick the port never calls); the act-int8 route of the
     int8 entries is timed beside the int8 kernel (log only);
  4. the bf16 path: the random-init 7B SEAL pair answers two requests
     through SealService.answer, one over HTTP, and one forced-search
     sample (free-form, 3-step guided search, focused option scoring);
  5. the quantized path (--int4mix: int8 VQA decoder, int4mix VSM decoder,
     int8 towers), after the bf16 pair is freed: one answer on 2048x1536,
     one forced-search sample, and one more with the act-int8 switch on;
  6. after each path, every kernel it runs launched, and no plain version
     ran on a CUDA tensor.
Prints a JSON line of kernel results, then the card's name and power
limit, then (last line) the device record.

    python3 chip_smoke.py
"""

from __future__ import annotations

import base64
import gc
import io
import json
import math
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

TOL = 2e-2          # bf16 attention vs plain version (tests/test_vision.py:288)
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


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median time of one call of fn, from CUDA events around the call
    (host launch gaps included)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def graph_ms(calls, reps: int = 7) -> float:
    """Device time of one call: the closures `calls` (each on its own
    weight copy, so the weights come from HBM as on the path) are
    captured into one CUDA graph; the median replay time over reps,
    divided by len(calls)."""
    for c in calls:
        c()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for c in calls:
            c()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for c in calls:
            c()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / len(calls))
    del graph
    return float(np.median(times))


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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} "
        f"device {torch.cuda.get_device_name(0)}")
    return smi


def phase_build() -> None:
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
        library_events = cuda_ms(calls[0])
        del calls
    del variants
    ms_events = cuda_ms(lambda: kernel(**args))
    plain_ms = cuda_ms(lambda: plain(**args))
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
    for case, shape in (("owl_768", (1, 2305, 12, 64)),
                        ("s600", (2, 600, 12, 64))):
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
    """K3/K4 at decode rows: gate/up (4096 -> 11008), down (11008 -> 4096)
    and the VQA lm_head (4096 -> 32003), int8 per-channel."""
    from vstar_tpu_torch.kernels import int8_matmul as k8
    from vstar_tpu_torch.nn.quant import quantize_weight
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    res = []
    for rows, IN, OUT in ((1, 4096, 11008), (8, 11008, 4096),
                          (16, 4096, 32003)):
        e = quantize_weight(_rand(gen, dev, IN, OUT, scale=IN ** -0.5))
        x = _rand(gen, dev, rows, IN).to(torch.bfloat16)
        args = dict(x=x, q=e["q"], s=e["s"])
        nbytes = IN * OUT + 4 * OUT + 2 * rows * (IN + OUT)
        library = _int8pack_library(x, e["q"], e["s"], k8)
        _, rec = _measure(f"int8 R={rows} {IN}x{OUT}", k8.int8_matmul,
                          k8.int8_matmul_reference, args, ("q",), nbytes,
                          2 * rows * IN * OUT, "bf16", BF16_REL_TOL,
                          _rel_err, library)
        res.append({"case": f"R{rows}_{IN}x{OUT}", **rec})
        _w8a8_note(x, e, k8)
    return res


def _w8a8_note(x, e, k8):
    """Logs (only) the act-int8 route of the same int8 entry, _w8a8_dot
    (int8 activations, torch._int_mm on zero-padded operands), beside the
    int8 kernel; for the 32003-wide lm_head also the exact f64 product
    that took that shape before the padding."""
    from vstar_tpu_torch.nn.quant import _w8a8_dot
    rows, IN = x.shape
    OUT = e["q"].shape[1]
    w8a8 = cuda_ms(lambda: _w8a8_dot(x, e))
    kernel = cuda_ms(lambda: k8.int8_matmul(x, e["q"], e["s"]))
    msg = (f"[w8a8 R={rows} {IN}x{OUT}] _w8a8_dot {w8a8:.4f} ms, int8 "
           f"kernel {kernel:.4f} ms (events)")
    if OUT % 8:
        xq = torch.randint(-127, 128, (rows, IN), device=x.device,
                           dtype=torch.int32).to(torch.int8)
        f64 = cuda_ms(lambda: (xq.double() @ e["q"].double())
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


def _int4pack(q4, s4, k4, even_high):
    """q4, s4 -> tinygemm's packed weight, its bf16 (scale, zero) pairs
    and the group size."""
    u = (k4.unpack_int4(q4).to(torch.int32) + 8).t().contiguous()
    even, odd = u[:, 0::2], u[:, 1::2]
    packed = ((even << 4) | odd) if even_high else (even | (odd << 4))
    w = torch._convert_weight_to_int4pack(packed.to(torch.uint8)
                                          .contiguous(), 8)
    sz = torch.stack([s4, torch.zeros_like(s4)], -1).to(torch.bfloat16)
    return w, sz.contiguous(), 2 * q4.shape[0] // s4.shape[0]


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
    want = k4.int4_matmul_reference(x, q4, s4)
    for even_high in (True, False):
        order = "even input high" if even_high else "even input low"
        try:
            w, sz, group = _int4pack(q4, s4, k4, even_high)
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
                w, sz, group = _int4pack(a["q4"], a["s4"], k4, even_high)
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
                          (384, 4096, 11008)):
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
        k5.append({"case": f"R{rows}_{IN}x{OUT}", **rec})
    for rows, IN, OUT in ((1, 4096, 11008), (8, 4096, 32003)):
        e = entry(IN, OUT)
        xq, _ = k4.quantize_activations(_rand(gen, dev, rows, IN))
        nbytes = (IN // 2 * OUT + 4 * e["s4"].shape[0] * OUT + rows * IN
                  + 4 * rows * OUT)
        _, rec = _measure(f"K6 R={rows} {IN}x{OUT}", k4.int4_matmul_w4a8,
                          k4.int4_matmul_w4a8_reference,
                          dict(xq=xq, q4=e["q4"], s4=e["s4"]), ("q4", "s4"),
                          nbytes, 2 * rows * IN * OUT, "int8", F32_REL_TOL,
                          _rel_err)
        k6.append({"case": f"R{rows}_{IN}x{OUT}", **rec})
    return k5, k6


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
    squared = seal.expand2square(image)[0]
    t0 = time.perf_counter()
    prediction = vqa.free_form(squared, question)
    missing = ["red mug"]
    tasks = seal.search_tasks(image, missing)
    path = []
    tasks[0]["path_out"] = path
    outs = seal.run_searches(vsm, tasks, max_steps=3, **FORCED_SEARCH)
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


# name -> (module, key of the wrapper's counters or None for plain ints)
def _counter_modules():
    from vstar_tpu_torch.kernels import flash_attention as fa
    from vstar_tpu_torch.kernels import int4_matmul as k4
    from vstar_tpu_torch.kernels import int8_matmul as k8
    from vstar_tpu_torch.kernels import tower_attention as ta
    return {"flash_attention": (fa, None), "tower_attention": (ta, None),
            "int8_matvec": (k8, None), "int4_matmul": (k4, "int4_matmul"),
            "int4_matmul_w4a8": (k4, "int4_matmul_w4a8")}


def _read_counts():
    """name -> (kernel launches, plain-version calls on CUDA tensors)."""
    out = {}
    for name, (mod, key) in _counter_modules().items():
        if key is None:
            out[name] = (mod.launches, mod.plain_calls_cuda)
        else:
            out[name] = (mod.launches[key], mod.plain_calls_cuda[key])
    return out


def _zero_counts():
    for mod, key in _counter_modules().values():
        if key is None:
            mod.launches = mod.plain_calls_cuda = 0
        else:
            mod.launches[key] = mod.plain_calls_cuda[key] = 0


def _check_path(path, kernels):
    """Reads the counts after a path: every kernel in `kernels` launched,
    and no plain version ran on a CUDA tensor."""
    counts = _read_counts()
    launches = {k: counts[k][0] for k in counts}
    plain = {k: counts[k][1] for k in counts}
    log(f"[{path} path] kernel launches {launches}, plain-version calls on "
        f"CUDA {plain}")
    missing = [k for k in kernels if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{path} path: {missing} never launched")
    if any(plain.values()):
        raise AssertionError(f"{path} path: plain versions ran on CUDA "
                             f"tensors: {plain}")
    return {k: launches[k] for k in kernels}


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
    return _check_path("bf16", ("flash_attention", "tower_attention"))


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
    return _check_path("int4mix", tuple(_counter_modules()))


# ---------------------------------------------------------------------------

def _kernel_entry(name, source, replaces, launches, cases):
    """The JSON record of one kernel; the top-level numbers are its first
    (main) case's; `launches` counts the path that brought the kernel in,
    `launches_by_path` every path."""
    main = cases[0]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches["own"],
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

    smi = phase_device()
    phase_build()
    cases = {"flash_attention": phase_k1(dev),
             "tower_attention": phase_k2(dev),
             "int8_matvec": phase_int8(dev)}
    cases["int4_matmul"], cases["int4_matmul_w4a8"] = phase_int4(dev)
    gc.collect()
    torch.cuda.empty_cache()
    by_path = {"bf16": phase_bf16_path(dev)}
    gc.collect()
    torch.cuda.empty_cache()
    by_path["int4mix"] = phase_quantized_path(dev)
    if "jax" in sys.modules or "vstar_tpu" in sys.modules:
        raise AssertionError("JAX or the JAX package was imported")
    sources = {
        "flash_attention": ("flash_attention.cu",
                            "vstar_tpu/kernels/flash_attention.py:82", "bf16"),
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
    }
    kernels = []
    for name, (src, replaces, own) in sources.items():
        launches = {"own": by_path[own][name],
                    "by_path": {p: n[name] for p, n in by_path.items()
                                if name in n}}
        kernels.append(_kernel_entry(name, f"vstar_tpu_torch/csrc/{src}",
                                     replaces, launches, cases[name]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
