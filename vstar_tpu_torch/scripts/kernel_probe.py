"""K7 (flash-attention backward), K3/K4 (int8 decode rows), K5 (decode
rows and tiles), K6 (W4A8 decode rows) with its qdot, and P2-P4, measured
on the H100.

  --ab        device ms (one CUDA graph over input copies that exceed the
              L2 cache, median of 7 replays) of K7 at the training case
              ([4, 512, 32, 128], kv_lens 512/300, ~10 % key holes, a row
              that sees no key) and at the shapes of the `gpu` test
              `test_flash_bwd_kernel_on_card`, beside SDPA's backward (one
              graph of forward + backward less one of the forward); of K3
              at 1, 2, 3, 8 and 16 rows on 4096x4096, 4096x11008,
              11008x4096 and the 32003-wide lm_head; of K5's decode rows at
              1, 3, 8 and 16 rows on 4096x11008, 11008x4096 and the lm_head,
              beside torch._weight_int4pack_mm (tinygemm) where it takes the
              shape; and of K5's tiles at 17, 64, 128, 384 and 768 rows on
              4096x11008 and 11008x4096 (with, at 384 rows, one bf16
              torch.matmul on the dequantized weights as context: not the
              same function). Each case is held to its plain version first.
              `--root DIR` measures the checkout at DIR instead (run this
              file by its path, so that DIR's vstar_tpu_torch is imported),
              which compares two trees on one card, in turns:
                python3 vstar_tpu_torch/scripts/kernel_probe.py --ab --root ../parent
              --ab also runs --w4a8-ab.
  --w4a8-ab   K6 at 1, 2, 8 and 16 rows on 4096x11008, 11008x4096 and
              4096x4096 (and 8 rows on the 32003-wide lm_head), its whole
              qdot on bf16 x at the same cases (device ms, and the kernels
              one call launches, read from its CUDA graph), and P4 at 1
              and 8 rows on 4096x11008 and 4096x32000 beside K6 on the same
              product (the layout's verdict); each held to its plain
              version first. Takes --root as --ab does.
  --k7-tiles  K7's dQ and dK/dV kernels at other tiles (DQ_VARIANTS,
              DKV_VARIANTS; kernel_probe.cu instantiates them and is built
              beside the kernel library): registers, spills, resident
              blocks, and device ms and error against the plain backward
              at the training case. The shipped tile is the first variant.
  --k5-shapes K5's decode rows at other ring shapes (K5_VARIANTS: packed
              rows per stage, stages, warps side by side along the
              columns, k-splits per block, L2 prefetch size of the weight
              copies, and the shipped shape with parts of its work left
              out, which splits its time; int4_probe.cu) and cluster sizes
              (the plan's, 1, 2, 4, 8): build facts, device ms and error
              against the plain version at R = 1 and 16 on 4096x11008,
              11008x4096 and the 32003-wide lm_head, beside tinygemm. The
              shipped shape is the first variant.
  --k3-shapes K3's decode rows at other shapes (K3_VARIANTS: ring rows
              per stage, stages, warps along the columns, k-splits per
              block, and the shipped shape with parts of its work left
              out; k3_probe.cu) and cluster sizes (the plan's, 1,
              2, 4, 8): build facts, device ms and error at R = 1, 8 and 16
              on 4096x4096, 4096x11008, 11008x4096 and the lm_head. The
              shipped shape is the first variant.
  --calibrate the device-time method's own cost on this card: a graph of
              1 to 16 one-element adds (the replay's fixed cost spread over
              its launches) and torch.sum over three 45 MB weight copies.
  --k5-tiles  K5's tiles at each (BM, BN, stages, k-splits, order) of
              K5_TILE_VARIANTS (int4_probe.cu): build facts, device ms and
              error against the plain version at R = 17, 64, 128, 384 and
              768 on 4096x11008 and 11008x4096, beside the plan's choice.
  --k6-shapes K6's and P4's decode rows at each K6_VARIANT (format, ring
              shape, and parts of the work left out; int4_probe.cu): build
              facts, device ms and error against the plain version at R =
              1 and 16 on 4096x11008, 11008x4096 and 4096x4096.
  --p23-ab    P2 (every unpack, block_o 256 and 512 where OUT allows
              it) and P3 (its default blocks) at 1, 8 and 16 rows on
              4096x11008, 4096x32000 and 11008x4096, beside K6 (and P4)
              on the same products: device ms, bound, kernels and
              allocations a call, each held to its plain version and to
              K6 first. Takes --root as --ab does, so that the parent's
              design is timed in the same call.
  --p23-shapes P3's decode rows at other strip widths and ring shapes, and
              P2's at 512 columns (P23_VARIANTS, int4_probe.cu), each with
              parts of its work left out (the time's breakdown): build
              facts, device ms and error at R = 1 and 16 on 11008x4096
              (P3 also on 4096x11008 and 4096x32000) at the plan's
              cluster (P3's shapes and P2's at 512 columns also at 2, 4,
              8, 16).
  --sass      whether nvcc emitted the same SASS for P2's mul unpack as
              for ship (cuobjdump -sass of the kernel library).
  --sass-vs DIR  whether this tree and the checkout at DIR compiled each
              decode-row instantiation they share (K3-K6, P4, by format
              and shape) to the same SASS: a change to the shared template
              that leaves a kernel's SASS as it was leaves its time too.
  --w4a8-quant where K6's qdot quantizes its rows, at R = 1 and 16 on
              4096x11008 and 11008x4096: the shipped two launches
              (quantize_rows, then K6 dependent on it), the same without
              the programmatic dependent launch, and K6 quantizing its
              bf16 rows itself in one launch (K6_VARIANTS[1], every block
              reading its rows whole); beside the quantization and K6
              alone. Device ms, launches from the CUDA graph, and the
              one-launch result bit-equal to the shipped one.

    python3 -m vstar_tpu_torch.scripts.kernel_probe --ab --k3-shapes --k5-tiles

The JSON result is printed and, with --out FILE, written there too.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import torch

# (query rows, key tile, stages) of the dQ kernel; (keys, query tile,
# stages) of the dK/dV kernel; kernel_probe.cu's order
DQ_VARIANTS = [(64, 64, 2), (64, 32, 2), (64, 32, 3), (64, 64, 3)]
DKV_VARIANTS = [(64, 64, 2), (64, 32, 2), (64, 32, 3), (64, 32, 4)]
# (packed rows per stage, stages, warps along the 128-column slices of a
# block's strip, k-splits per block, L2 prefetch: 0 none, 1 128 B, 2 256
# B; + 4 no products, + 8 no weight copies, + 16 nothing, + 32 no split
# reduction: the time's breakdown, with wrong results); int4_probe.cu's
# order
K5_VARIANTS = [(32, 3, 1, 4, 0), (32, 4, 1, 4, 0), (32, 3, 2, 2, 0), (16, 6, 1, 4, 0),
               (32, 3, 1, 4, 2), (32, 3, 1, 4, 4), (32, 3, 1, 4, 8), (32, 3, 1, 4, 12),
               (32, 3, 1, 4, 44), (32, 3, 1, 4, 16)]
# (weight rows per ring stage, stages, warps along the columns, k-splits
# per block, PF bits of decode_rows.cuh: + 4 no products, + 8 no weight
# copies, + 16 nothing, + 32 no split reduction, + 128 unpack without mma,
# + 256 mma without unpack); k3_probe.cu's order
K3_VARIANTS = [(32, 3, 1, 2, 0), (32, 4, 1, 2, 0), (32, 3, 1, 4, 0), (32, 3, 1, 1, 0),
               (64, 3, 1, 2, 0), (32, 3, 2, 1, 0), (32, 3, 1, 2, 128), (32, 3, 1, 2, 256),
               (32, 3, 1, 2, 4), (32, 3, 1, 2, 8), (32, 3, 1, 2, 16), (32, 3, 1, 2, 32)]
# (BM, BN, stages, k-splits, PF bits of int4_tile_kernel: + 2 no
# dequantization, + 4 no products, + 8 no global copies) of K5's tiles;
# int4_probe.cu's order
K5_TILE_VARIANTS = [(64, 128, 3, 1, 0), (128, 256, 3, 1, 0), (128, 128, 3, 1, 0),
                    (64, 128, 3, 2, 0), (64, 128, 3, 4, 0), (128, 256, 3, 2, 0),
                    (128, 256, 3, 4, 0), (128, 256, 4, 1, 0), (128, 256, 3, 1, 2),
                    (128, 256, 3, 1, 4), (128, 256, 3, 1, 8), (128, 256, 3, 1, 6)]
K3_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32003))
# (format, packed rows per stage, stages, warps along the columns, k-splits
# per block, PF bits of decode_rows.cuh: + 4 no products, + 8 no weight
# copies, + 16 nothing); int4_probe.cu's order. Formats: "w4a8" (K6, the
# first is shipped), "w4a8q" (K6 quantizing its bf16 rows itself),
# "w4a8t" (P4's transposed storage, P4_SHIPPED first of them)
K6_VARIANTS = [("w4a8", 64, 3, 2, 1, 0), ("w4a8q", 64, 3, 2, 1, 0), ("w4a8", 32, 3, 1, 4, 0),
               ("w4a8", 32, 4, 1, 4, 0), ("w4a8", 32, 3, 1, 2, 0), ("w4a8", 64, 3, 1, 2, 0),
               ("w4a8", 32, 3, 2, 2, 0), ("w4a8", 64, 4, 1, 2, 0), ("w4a8", 64, 3, 1, 4, 0),
               ("w4a8", 64, 4, 1, 1, 0), ("w4a8", 64, 3, 2, 1, 4), ("w4a8", 64, 3, 2, 1, 8),
               ("w4a8", 64, 3, 2, 1, 16), ("w4a8t", 64, 3, 1, 2, 0), ("w4a8t", 32, 3, 1, 4, 0),
               ("w4a8t", 32, 4, 1, 4, 0), ("w4a8t", 64, 4, 1, 2, 0), ("w4a8t", 64, 3, 1, 4, 0),
               ("w4a8t", 64, 3, 2, 1, 0), ("w4a8t", 64, 3, 1, 2, 4)]
K6_SHIPPED, P4_SHIPPED = 0, 13   # their cluster sizes are swept too
# (format, packed rows per stage, stages, warps along the columns, k-splits
# per block, PF bits as K6_VARIANTS'); int4_probe.cu's order. "w4a8r": P3
# (the first, K6's shape, is shipped; 512 and 1024 columns (the parent's
# width) follow), "w4a8": P2 at 512 columns (ship; P2_512 first)
P23_VARIANTS = [("w4a8r", 64, 3, 2, 1, 0), ("w4a8r", 32, 3, 4, 1, 0), ("w4a8r", 32, 3, 8, 1, 0),
                ("w4a8r", 64, 4, 2, 1, 0), ("w4a8r", 64, 3, 2, 1, 4), ("w4a8r", 64, 3, 2, 1, 8),
                ("w4a8r", 64, 3, 2, 1, 12), ("w4a8r", 64, 3, 2, 1, 16), ("w4a8", 64, 3, 4, 1, 0),
                ("w4a8", 32, 3, 4, 1, 0), ("w4a8", 64, 3, 4, 1, 4), ("w4a8", 64, 3, 4, 1, 8),
                ("w4a8", 64, 3, 4, 1, 16)]
P3_SHIPPED, P2_512 = 0, 8
# P2's unpacks and strips, P3's cases (R, IN, OUT) of --p23-ab
P23_UNPACKS = ("ship", "mul", "2and", "off")
P23_SHAPES = ((4096, 11008), (4096, 32000), (11008, 4096))
K6_SHAPES = ((4096, 11008), (11008, 4096), (4096, 4096))
HBM = 3.35e12
TILE_ROWS = (17, 64, 128, 384, 768)
HERE = Path(__file__).resolve().parent
L2_BYTES = 50 * 2**20


def _bf16(gen, dev, *shape):
    return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)


def _i32(x, dev):
    return torch.tensor(x, dtype=torch.int32, device=dev)


def _rel(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def _copies(args, rotate):
    """args and enough copies of its `rotate` entries to pass twice the
    L2 cache in all (2 to 16 sets)."""
    nbytes = sum(args[k].numel() * args[k].element_size() for k in rotate)
    n = min(max(math.ceil(2 * L2_BYTES / nbytes), 2), 16)
    return [args] + [dict(args, **{k: args[k].clone() for k in rotate})
                     for _ in range(n - 1)]


def bwd_cases(dev):
    """(name, q, k, v, do, kv_lens, q_offsets, kv_valid): the training case
    first, then the `gpu` test's shapes (8 heads)."""
    gen = torch.Generator(device=dev).manual_seed(4)
    B, S, H, D = 4, 512, 32, 128
    q, k, v, do = (_bf16(gen, dev, B, S, H, D) for _ in range(4))
    valid = torch.rand(B, S, generator=gen, device=dev) > 0.1
    valid[2, 0] = False
    cases = [("train [4,512,32,128]", q, k, v, do, _i32([512, 300, 512, 512], dev),
              _i32([0] * 4, dev), valid.to(torch.uint8))]
    for B, Sq, Skv, offs, lens, masked in [
            (2, 256, 256, (0, 0), (256, 256), 0),
            (2, 130, 130, (0, 0), (130, 77), 1),
            (3, 64, 200, (0, 17, 136), (64, 81, 200), 1),
            (4, 512, 512, (0, 0, 0, 0), (512, 300, 512, 512), 1),
            (3, 77, 93, (0, 5, 16), (93, 40, 93), 5)]:
        q, k, v, do = (_bf16(gen, dev, B, s, 8, D) for s in (Sq, Skv, Skv, Sq))
        kv_valid = None
        if masked:
            kv_valid = torch.rand(B, Skv, generator=gen, device=dev) > 0.1
            kv_valid[0, :masked] = False
            kv_valid = kv_valid.to(torch.uint8)
        cases.append((f"test [{B},{Sq},{Skv}] x 8 heads", q, k, v, do,
                      _i32(lens, dev), _i32(offs, dev), kv_valid))
    return cases


def _sdpa_mask(q, k, kv_lens, q_offsets, kv_valid):
    Sq, Skv = q.shape[1], k.shape[1]
    dev = q.device
    ki = torch.arange(Skv, device=dev)[None, None, None, :]
    row = q_offsets[:, None, None, None] + torch.arange(Sq, device=dev)[None, None, :, None]
    mask = (ki < kv_lens[:, None, None, None]) & (ki <= row)
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, None, :].bool()
    return mask


def ab_k7(dev):
    from vstar_tpu_torch.kernels import flash_attention as fa
    from vstar_tpu_torch.utils.timing import graph_ms
    import torch.nn.functional as F
    res = []
    for name, q, k, v, do, kl, qo, kvv in bwd_cases(dev):
        masks = dict(kv_lens=kl, q_offsets=qo, kv_valid=kvv)
        out, lse = fa.flash_attention_lse(q, k, v, **masks)
        delta = (do.float() * out.float()).sum(-1)
        got = fa.flash_attention_bwd(q, k, v, do, lse, delta, **masks)
        want = fa.mha_backward(q, k, v, do, lse, delta, **masks)
        err = max(_rel(a, b) for a, b in zip(got, want))
        variants = _copies(dict(q=q, k=k, v=v, do=do), ("q", "k", "v", "do"))
        ms = graph_ms([lambda a=a: fa.flash_attention_bwd(
            a["q"], a["k"], a["v"], a["do"], lse, delta, **masks) for a in variants])
        mask = _sdpa_mask(q, k, kl, qo, kvv)

        def sdpa(a, backward):
            lv = [a[n].transpose(1, 2).detach().requires_grad_() for n in "qkv"]
            d = a["do"].transpose(1, 2)

            def call():
                o = F.scaled_dot_product_attention(*lv, attn_mask=mask)
                if backward:
                    torch.autograd.grad(o, lv, d)
            return call
        try:
            lib = (graph_ms([sdpa(a, True) for a in variants])
                   - graph_ms([sdpa(a, False) for a in variants]))
        except RuntimeError as e:
            lib = f"not capturable: {str(e)[:100]}"
        res.append({"case": name, "ms": ms, "sdpa_bwd_ms": lib,
                    "max_rel_err": err, "copies": len(variants)})
        del variants
    return res


def ab_k5(dev):
    from vstar_tpu_torch.kernels import int4_matmul as k4
    from vstar_tpu_torch.nn.quant import quantize_weight_int4
    from vstar_tpu_torch.scripts.int4_profile import tinygemm_pack
    from vstar_tpu_torch.utils.timing import graph_ms
    gen = torch.Generator(device=dev).manual_seed(3)
    res = []
    for IN, OUT in ((4096, 11008), (11008, 4096), (4096, 32003)):
        e = quantize_weight_int4(torch.randn(IN, OUT, generator=gen, device=dev) * IN ** -0.5)
        for rows in (1, 3, 8, 16):
            x = _bf16(gen, dev, rows, IN)
            before = k4.launches["int4_matmul"]
            got = k4.int4_matmul(x, e["q4"], e["s4"])
            launches = k4.launches["int4_matmul"] - before
            err = _rel(got, k4.int4_matmul_reference(x, e["q4"], e["s4"]))
            variants = _copies(dict(x=x, q4=e["q4"], s4=e["s4"]), ("q4", "s4"))
            ms = graph_ms([lambda a=a: k4.int4_matmul(a["x"], a["q4"], a["s4"])
                           for a in variants])
            lib = None
            if OUT % 8 == 0:
                packed = [(a["x"], *tinygemm_pack(a["q4"], a["s4"], True)) for a in variants]
                y = torch._weight_int4pack_mm(packed[0][0], packed[0][1], packed[0][3],
                                              packed[0][2])
                if _rel(y, got) <= 1e-2:
                    lib = graph_ms([lambda p=p: torch._weight_int4pack_mm(p[0], p[1], p[3], p[2])
                                    for p in packed])
                del packed
            nbytes = IN // 2 * OUT + 4 * e["s4"].shape[0] * OUT + 2 * rows * (IN + OUT)
            res.append({"case": f"R={rows} {IN}x{OUT}", "ms": ms, "tinygemm_ms": lib,
                        "bound_ms": nbytes / 3.35e12 * 1e3, "max_rel_err": err,
                        "launches_per_call": launches, "copies": len(variants)})
            del variants
    return res


def _probe_library():
    """kernel_probe.cu, int4_probe.cu and k3_probe.cu built into one
    library (one nvcc per source, in parallel)."""
    from vstar_tpu_torch.kernels import _build
    so = _build.BUILD_DIR / "kernel_probe.so"
    if not so.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        names = ("kernel_probe", "int4_probe", "k3_probe")
        objs = [_build.BUILD_DIR / f"{n}.o" for n in names]
        jobs = [subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                                  "-c", str(HERE / f"{n}.cu"), "-o", str(o)],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for n, o in zip(names, objs)]
        for job in jobs:
            out = job.communicate()[0]
            if job.returncode != 0:
                raise RuntimeError(f"nvcc failed on {job.args[-3]}:\n{out[-4000:]}")
        subprocess.run([_build._nvcc(), "-shared", "-o", str(so), *map(str, objs)],
                       check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(so))


def k5_shapes(dev):
    """Each K5_VARIANT's build facts, and per case and cluster size its
    device ms and error against the plain version."""
    from vstar_tpu_torch.kernels import _build
    from vstar_tpu_torch.kernels import int4_matmul as k4
    from vstar_tpu_torch.nn.quant import quantize_weight_int4
    from vstar_tpu_torch.utils.timing import graph_ms
    lib = _probe_library()
    ll, p = ctypes.c_longlong, ctypes.c_void_p
    lib.probe_k5.argtypes = [ctypes.c_int] + [p] * 4 + [ll] * 6 + [p]
    lib.probe_k5.restype = ctypes.c_int
    lib.probe_k5_info.argtypes = [ctypes.c_int, ll, ll, ctypes.POINTER(ll)]
    lib.probe_k5_info.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(3)
    res = {"build": {}, "cases": {}}
    for vi, shape in enumerate(K5_VARIANTS):
        for rows, aligned in ((1, 1), (16, 1), (1, 0), (16, 0)):
            info = (ll * 6)()
            _build.check(_build.library(), lib.probe_k5_info(vi, rows, aligned, info),
                         f"k5 info {vi}")
            res["build"][f"{shape} R{rows} aligned {aligned}"] = {
                "registers": info[0], "local_bytes": info[1], "dynamic_smem": info[3],
                "blocks_per_sm": info[4]}
    for IN, OUT in ((4096, 11008), (11008, 4096), (4096, 32003)):
        e = quantize_weight_int4(torch.randn(IN, OUT, generator=gen, device=dev) * IN ** -0.5)
        NG = e["s4"].shape[0]
        for rows in (1, 16):
            x = _bf16(gen, dev, rows, IN)
            want = k4.int4_matmul_reference(x, e["q4"], e["s4"])
            variants = _copies(dict(x=x, q4=e["q4"], s4=e["s4"]), ("q4", "s4"))
            aligned = int(OUT % 16 == 0)
            row = {}
            if OUT % 8 == 0:
                from vstar_tpu_torch.scripts.int4_profile import tinygemm_pack
                packed = [(a["x"], *tinygemm_pack(a["q4"], a["s4"], True))
                          for a in variants]
                row["tinygemm"] = {
                    "ms": graph_ms([lambda p=p: torch._weight_int4pack_mm(
                        p[0], p[1], p[3], p[2]) for p in packed]),
                    "max_rel_err": _rel(torch._weight_int4pack_mm(
                        x, packed[0][1], packed[0][3], packed[0][2]), want)}
                del packed
            for vi, shape in enumerate(K5_VARIANTS):
                info = (ll * 6)()
                lib.probe_k5_info(vi, rows, aligned, info)
                wc, wk = shape[2:4]
                plan = k4.decode_plan(NG, OUT, info[4] * sms, 128 * wc, wk)
                for cl in sorted({plan, 1, 2, 4, 8, 16}):
                    if -(-NG // wk) < cl:
                        continue
                    ys = [torch.empty(rows, OUT, dtype=torch.bfloat16, device=dev)
                          for _ in variants]

                    def call(a, y, vi=vi, cl=cl):
                        code = lib.probe_k5(vi, a["x"].data_ptr(), a["q4"].data_ptr(),
                                            a["s4"].data_ptr(), y.data_ptr(), rows, IN,
                                            OUT, IN // NG, cl, aligned,
                                            torch.cuda.current_stream(dev).cuda_stream)
                        _build.check(_build.library(), code, f"k5 variant {vi}")
                    call(variants[0], ys[0])
                    torch.cuda.synchronize()
                    row[f"{shape} cluster {cl}{' (plan)' if cl == plan else ''}"] = {
                        "ms": graph_ms([lambda a=a, y=y: call(a, y)
                                        for a, y in zip(variants, ys)]),
                        "max_rel_err": _rel(ys[0], want)}
            res["cases"][f"R={rows} {IN}x{OUT}"] = row
            del variants
    return res


def _int8_entry(gen, dev, IN, OUT):
    from vstar_tpu_torch.nn.quant import quantize_weight
    return quantize_weight(torch.randn(IN, OUT, generator=gen, device=dev) * IN ** -0.5)


def ab_k3(dev):
    """K3 at 1, 2, 3, 8 and 16 rows on K3_SHAPES, through the wrapper."""
    from vstar_tpu_torch.kernels import int8_matmul as k8
    from vstar_tpu_torch.utils.timing import graph_ms
    gen = torch.Generator(device=dev).manual_seed(2)
    res = []
    for IN, OUT in K3_SHAPES:
        e = _int8_entry(gen, dev, IN, OUT)
        for rows in (1, 2, 3, 8, 16):
            x = _bf16(gen, dev, rows, IN)
            before = k8.launches
            got = k8.int8_matmul(x, e["q"], e["s"])
            launches = k8.launches - before
            err = _rel(got, k8.int8_matmul_reference(x, e["q"], e["s"]))
            variants = _copies(dict(x=x, q=e["q"], s=e["s"]), ("q",))
            ms = graph_ms([lambda a=a: k8.int8_matmul(a["x"], a["q"], a["s"])
                           for a in variants])
            nbytes = IN * OUT + 4 * OUT + 2 * rows * (IN + OUT)
            res.append({"case": f"R={rows} {IN}x{OUT}", "ms": ms,
                        "bound_ms": nbytes / 3.35e12 * 1e3, "max_rel_err": err,
                        "launches_per_call": launches, "copies": len(variants)})
            del variants
    return res


def _int4_entry(gen, dev, IN, OUT):
    from vstar_tpu_torch.nn.quant import quantize_weight_int4
    return quantize_weight_int4(torch.randn(IN, OUT, generator=gen, device=dev) * IN ** -0.5)


def _beyond_rounding(out, ref):
    ref = ref.float()
    excess = ((out.float() - ref).abs() - 2.0 ** -8 * ref.abs()).clamp(min=0)
    return float(excess.max() / ref.abs().max())


def ab_k5_tiles(dev):
    """K5's tiles at TILE_ROWS on 4096x11008 and 11008x4096, through the
    wrapper; at 384 rows also one bf16 torch.matmul on the dequantized
    weights (context, not the same function)."""
    from vstar_tpu_torch.kernels import int4_matmul as k4
    from vstar_tpu_torch.utils.timing import graph_ms
    gen = torch.Generator(device=dev).manual_seed(5)
    res = []
    for IN, OUT in ((4096, 11008), (11008, 4096)):
        e = _int4_entry(gen, dev, IN, OUT)
        for rows in TILE_ROWS:
            x = _bf16(gen, dev, rows, IN)
            before = k4.launches["int4_matmul"]
            got = k4.int4_matmul(x, e["q4"], e["s4"])
            launches = k4.launches["int4_matmul"] - before
            err = _rel(got, k4.int4_matmul_reference(x, e["q4"], e["s4"]))
            math_err = _beyond_rounding(got, k4.int4_matmul_kernel_math(x, e["q4"], e["s4"]))
            variants = _copies(dict(x=x, q4=e["q4"], s4=e["s4"]), ("q4", "s4"))
            ms = graph_ms([lambda a=a: k4.int4_matmul(a["x"], a["q4"], a["s4"])
                           for a in variants])
            rec = {"case": f"R={rows} {IN}x{OUT}", "ms": ms,
                   "bound_ms": max(2 * rows * IN * OUT / 989e12,
                                   (IN // 2 * OUT + 4 * e["s4"].shape[0] * OUT
                                    + 2 * rows * (IN + OUT)) / 3.35e12) * 1e3,
                   "max_rel_err": err, "kernel_math_err": math_err,
                   "launches_per_call": launches, "copies": len(variants)}
            if rows == 384:
                ws = [k4.dequantize_int4(a["q4"], a["s4"]).to(torch.bfloat16)
                      for a in variants]
                rec["bf16_matmul_ms"] = graph_ms([lambda w=w: torch.matmul(x, w) for w in ws])
                del ws
            res.append(rec)
            del variants
    return res


def _timed_variant(call, variants, ys, want):
    from vstar_tpu_torch.utils.timing import graph_ms
    call(variants[0], ys[0])
    torch.cuda.synchronize()
    return {"ms": graph_ms([lambda a=a, y=y: call(a, y) for a, y in zip(variants, ys)]),
            "max_rel_err": _rel(ys[0], want)}


def k3_shapes(dev):
    """Each K3_VARIANT's build facts, and per case and cluster size its
    device ms and error against the plain version."""
    from vstar_tpu_torch.kernels import _build
    from vstar_tpu_torch.kernels import int8_matmul as k8
    lib = _probe_library()
    ll, p = ctypes.c_longlong, ctypes.c_void_p
    lib.probe_k3.argtypes = [ctypes.c_int] + [p] * 4 + [ll] * 6 + [p]
    lib.probe_k3.restype = ctypes.c_int
    lib.probe_k3_info.argtypes = [ctypes.c_int, ll, ll, ctypes.POINTER(ll)]
    lib.probe_k3_info.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(2)
    res = {"build": {}, "cases": {}}
    for vi, shape in enumerate(K3_VARIANTS):
        for rows, aligned in ((1, 1), (16, 1), (1, 0), (16, 0)):
            info = (ll * 6)()
            _build.check(_build.library(), lib.probe_k3_info(vi, rows, aligned, info),
                         f"k3 info {vi}")
            res["build"][f"{shape} R{rows} aligned {aligned}"] = {
                "registers": info[0], "local_bytes": info[1], "dynamic_smem": info[3],
                "blocks_per_sm": info[4]}
    for IN, OUT in K3_SHAPES:
        e = _int8_entry(gen, dev, IN, OUT)
        aligned = int(OUT % 16 == 0)
        for rows in (1, 8, 16):
            x = _bf16(gen, dev, rows, IN)
            want = k8.int8_matmul_reference(x, e["q"], e["s"])
            variants = _copies(dict(x=x, q=e["q"], s=e["s"]), ("q",))
            ys = [torch.empty(rows, OUT, dtype=torch.bfloat16, device=dev) for _ in variants]
            row = {}
            for vi, shape in enumerate(K3_VARIANTS):
                info = (ll * 6)()
                lib.probe_k3_info(vi, rows, aligned, info)
                srows, wc, wk = shape[0], shape[2], shape[3]
                plan = k8.decode_plan(-(-IN // srows), OUT, info[4] * sms, 128 * wc, wk,
                                      k8.K3_MAX_CLUSTER)
                for cl in sorted({plan, 1, 2, 4, 8, 16}):
                    if -(-IN // srows) < wk * cl:
                        continue

                    def call(a, y, vi=vi, cl=cl):
                        code = lib.probe_k3(vi, a["x"].data_ptr(), a["q"].data_ptr(),
                                            a["s"].data_ptr(), y.data_ptr(), rows, IN, OUT,
                                            IN, cl, aligned,
                                            torch.cuda.current_stream(dev).cuda_stream)
                        _build.check(_build.library(), code, f"k3 variant {vi}")
                    row[f"{shape} cluster {cl}{' (plan)' if cl == plan else ''}"] = \
                        _timed_variant(call, variants, ys, want)
            res["cases"][f"R={rows} {IN}x{OUT}"] = row
            del variants, ys
    return res


def k5_tiles(dev):
    """Each K5_TILE_VARIANT's build facts, and per case its device ms and
    error against the plain version, beside the wrapper (the plan's)."""
    from vstar_tpu_torch.kernels import _build
    from vstar_tpu_torch.kernels import int4_matmul as k4
    from vstar_tpu_torch.utils.timing import graph_ms
    lib = _probe_library()
    ll, p = ctypes.c_longlong, ctypes.c_void_p
    lib.probe_tile.argtypes = [ctypes.c_int] + [p] * 4 + [ll] * 4 + [p]
    lib.probe_tile.restype = ctypes.c_int
    lib.probe_tile_info.argtypes = [ctypes.c_int, ctypes.POINTER(ll)]
    lib.probe_tile_info.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(5)
    res = {"build": {}, "cases": {}}
    for vi, shape in enumerate(K5_TILE_VARIANTS):
        info = (ll * 6)()
        _build.check(_build.library(), lib.probe_tile_info(vi, info), f"tile info {vi}")
        res["build"][str(shape)] = {"registers": info[0], "local_bytes": info[1],
                                    "dynamic_smem": info[3], "blocks_per_sm": info[4]}
    for IN, OUT in ((4096, 11008), (11008, 4096)):
        e = _int4_entry(gen, dev, IN, OUT)
        NG = e["s4"].shape[0]
        for rows in TILE_ROWS:
            x = _bf16(gen, dev, rows, IN)
            want = k4.int4_matmul_reference(x, e["q4"], e["s4"])
            variants = _copies(dict(x=x, q4=e["q4"], s4=e["s4"]), ("q4", "s4"))
            ys = [torch.empty(rows, OUT, dtype=torch.bfloat16, device=dev) for _ in variants]
            tile, ks = k4.tile_plan(rows, OUT, IN // k4.TILE_K, sms, lambda t, k: _tile_occ(
                lib, t, k))
            row = {"plan": {"tile": k4.TILE_SHAPES[tile], "k_splits": ks, "ms": graph_ms(
                [lambda a=a: k4.int4_matmul(a["x"], a["q4"], a["s4"]) for a in variants])}}
            for vi, shape in enumerate(K5_TILE_VARIANTS):
                if -(-IN // k4.TILE_K) < 4 * shape[3]:
                    continue

                def call(a, y, vi=vi):
                    code = lib.probe_tile(vi, a["x"].data_ptr(), a["q4"].data_ptr(),
                                          a["s4"].data_ptr(), y.data_ptr(), rows, IN, OUT,
                                          IN // NG, torch.cuda.current_stream(dev).cuda_stream)
                    _build.check(_build.library(), code, f"tile variant {vi}")
                row[str(shape)] = _timed_variant(call, variants, ys, want)
            res["cases"][f"R={rows} {IN}x{OUT}"] = row
            del variants, ys
    return res


def _tile_occ(lib, tile, ks):
    """Resident blocks of the shipped tile `tile` at `ks` k-splits, from
    K5_TILE_VARIANTS' build facts (the shipped ones are among them)."""
    from vstar_tpu_torch.kernels import int4_matmul as k4
    vi = K5_TILE_VARIANTS.index((*k4.TILE_SHAPES[tile], 3, ks, 0))
    info = (ctypes.c_longlong * 6)()
    lib.probe_tile_info(vi, info)
    return info[4]


def calibrate(dev):
    """What the device-time method itself costs on this card: graph_ms of
    a one-element add captured 1 to 16 times (the replay's fixed cost,
    spread over the graph's launches), and of torch.sum over int32 views of
    three 45 MB weight copies (a library read of K3's 4096x11008 bytes)."""
    from vstar_tpu_torch.utils.timing import graph_ms
    t = torch.zeros(1, device=dev)
    res = {"tiny_kernel_ms": {n: graph_ms([lambda: t.add_(1)] * n) for n in (1, 2, 4, 8, 16)}}
    ws = [torch.randint(-127, 128, (4096, 11008), dtype=torch.int8, device=dev)
          for _ in range(3)]
    outs = [torch.empty((), dtype=torch.int64, device=dev) for _ in ws]
    res["sum_45MB_ms"] = graph_ms([lambda w=w, o=o: torch.sum(w.view(torch.int32), (0, 1), out=o)
                                   for w, o in zip(ws, outs)])
    return res


def k7_tiles(dev):
    """Each DQ / DKV variant's build facts, and its device ms and error
    against the plain backward at the training case."""
    from vstar_tpu_torch.kernels import _build
    from vstar_tpu_torch.kernels import flash_attention as fa
    from vstar_tpu_torch.utils.timing import graph_ms
    lib = _probe_library()
    fn = lib.probe_bwd
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + _build._SIGNATURES["vstar_flash_attention_bwd_dq"]
    fn.restype = ctypes.c_int
    lib.probe_bwd_info.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
    lib.probe_bwd_info.restype = ctypes.c_int
    name, q, k, v, do, kl, qo, kvv = bwd_cases(dev)[0]
    masks = dict(kv_lens=kl, q_offsets=qo, kv_valid=kvv)
    out, lse = fa.flash_attention_lse(q, k, v, **masks)
    delta = (do.float() * out.float()).sum(-1)
    want = fa.mha_backward(q, k, v, do, lse, delta, **masks)
    kl32, qo32, kvv8 = fa._validate(q, k, v, kl, qo, kvv)
    B, Sq, H, D = q.shape
    res = {"case": name, "dq": {}, "dkv": {}}
    for which, variants in ((0, DQ_VARIANTS), (1, DKV_VARIANTS)):
        key = ("dq", "dkv")[which]
        for vi, tile in enumerate(variants):
            info = (ctypes.c_longlong * 6)()
            code = lib.probe_bwd_info(which, vi, info)
            if code != 0:
                raise RuntimeError(f"{key} {tile}: no kernel attributes ({code})")
            grads = [torch.empty_like(t) for t in (q, k, v)]

            def call(vi=vi, grads=grads, which=which):
                code = fn(which, vi, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                          *(g.data_ptr() for g in grads), kl32.data_ptr(),
                          qo32.data_ptr(), None if kvv8 is None else kvv8.data_ptr(),
                          B, Sq, k.shape[1], H, *q.stride()[:3], *k.stride()[:3],
                          *v.stride()[:3], *do.stride()[:3], *grads[0].stride()[:3],
                          *grads[1].stride()[:3], *grads[2].stride()[:3],
                          *lse.stride(), 0 if kvv8 is None else kvv8.stride(0),
                          D ** -0.5, torch.cuda.current_stream(dev).cuda_stream)
                _build.check(_build.library(), code, f"{key} {tile}")
            call()
            torch.cuda.synchronize()
            outs = grads[:1] if which == 0 else grads[1:]
            refs = want[:1] if which == 0 else want[1:]
            res[key][str(tile)] = {
                "registers": info[0], "local_bytes": info[1], "dynamic_smem": info[3],
                "blocks_per_sm": info[4], "ms": graph_ms([call] * 8),
                "max_rel_err": max(_rel(a, b) for a, b in zip(outs, refs))}
    return res


def _w4a8_bound(rows, IN, OUT, NG, x_bytes, out_bytes):
    """The byte bound of a W4A8 product: packed weights, scales, x (int8,
    or bf16 for a qdot), the output."""
    return (IN // 2 * OUT + 4 * NG * OUT + x_bytes * rows * IN
            + out_bytes * rows * OUT) / HBM * 1e3


def _graph_launches(fn):
    """Kernels one call of fn launches, read from its CUDA graph
    (graph_info.cu, built into the probe library, so that it serves any
    checkout)."""
    lib = _probe_library()
    lib.vstar_graph_kernel_nodes.argtypes = [ctypes.c_void_p] * 3
    lib.vstar_graph_kernel_nodes.restype = ctypes.c_int
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    k, n = ctypes.c_longlong(), ctypes.c_longlong()
    code = lib.vstar_graph_kernel_nodes(ctypes.c_void_p(graph.raw_cuda_graph()),
                                        ctypes.byref(k), ctypes.byref(n))
    if code != 0:
        raise RuntimeError(f"vstar_graph_kernel_nodes: CUDA error {code}")
    del graph
    return k.value


def ab_w4a8(dev):
    """K6, its qdot and P4 through the checkout's wrappers (--w4a8-ab)."""
    from vstar_tpu_torch.kernels import int4_matmul as k4
    from vstar_tpu_torch.kernels import int4_variants as kv
    from vstar_tpu_torch.utils.timing import graph_ms
    gen = torch.Generator(device=dev).manual_seed(6)
    res = {"k6": [], "qdot": [], "p4": []}
    cases = [(r, IN, OUT) for IN, OUT in K6_SHAPES for r in (1, 2, 8, 16)]
    for rows, IN, OUT in cases + [(8, 4096, 32003)]:
        e = _int4_entry(gen, dev, IN, OUT)
        NG = e["s4"].shape[0]
        xq = torch.randint(-127, 128, (rows, IN), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.int8)
        before = k4.launches["int4_matmul_w4a8"]
        got = k4.int4_matmul_w4a8(xq, e["q4"], e["s4"])
        launches = k4.launches["int4_matmul_w4a8"] - before
        err = _rel(got, k4.int4_matmul_w4a8_reference(xq, e["q4"], e["s4"]))
        variants = _copies(dict(xq=xq, q4=e["q4"], s4=e["s4"]), ("q4", "s4"))
        ms = graph_ms([lambda a=a: k4.int4_matmul_w4a8(a["xq"], a["q4"], a["s4"])
                       for a in variants])
        res["k6"].append({"case": f"R={rows} {IN}x{OUT}", "ms": ms,
                          "bound_ms": _w4a8_bound(rows, IN, OUT, NG, 1, 4), "max_rel_err": err,
                          "launches_per_call": launches, "copies": len(variants)})
        if OUT % 128 == 0:   # the qdot: the W4A8 gate's shapes only
            x = _bf16(gen, dev, rows, IN)
            want_xq, want_sx = k4.quantize_activations(x.float())
            want = k4.int4_matmul_w4a8_reference(want_xq, e["q4"], e["s4"]) * want_sx
            q = k4.qdot4_w4a8(x, e)
            err = float(((q.float() - want).abs() - 2.0 ** -8 * want.abs()).clamp(min=0).max()
                        / want.abs().max())
            qms = graph_ms([lambda a=a: k4.qdot4_w4a8(x, {"q4": a["q4"], "s4": a["s4"]})
                            for a in variants])
            res["qdot"].append({"case": f"R={rows} {IN}x{OUT}", "ms": qms, "kernel_ms": ms,
                                "bound_ms": _w4a8_bound(rows, IN, OUT, NG, 2, 2),
                                "err_beyond_bf16": err,
                                "kernels_per_call": _graph_launches(
                                    lambda: k4.qdot4_w4a8(x, e))})
        del variants
    for rows, IN, OUT in ((1, 4096, 11008), (8, 4096, 11008), (1, 4096, 32000),
                          (8, 4096, 32000)):
        e = _int4_entry(gen, dev, IN, OUT)
        NG = e["s4"].shape[0]
        xq = torch.randint(-127, 128, (rows, IN), generator=gen, device=dev,
                           dtype=torch.int32).to(torch.int8)
        q4t, s4t = e["q4"].t().contiguous(), e["s4"].t().contiguous()
        k6 = k4.int4_matmul_w4a8(xq, e["q4"], e["s4"])
        got = kv.w4a8_t(xq, q4t, s4t, 256)
        err = _rel(got, kv.w4a8_t_reference(xq, q4t, s4t, 256))
        variants = _copies(dict(xq=xq, q4t=q4t, s4t=s4t, q4=e["q4"], s4=e["s4"]),
                           ("q4t", "s4t", "q4", "s4"))
        p4_ms = graph_ms([lambda a=a: kv.w4a8_t(a["xq"], a["q4t"], a["s4t"], 256)
                          for a in variants])
        k6_ms = graph_ms([lambda a=a: k4.int4_matmul_w4a8(a["xq"], a["q4"], a["s4"])
                          for a in variants])
        res["p4"].append({"case": f"R={rows} {IN}x{OUT}", "ms": p4_ms, "k6_ms": k6_ms,
                          "bound_ms": _w4a8_bound(rows, IN, OUT, NG, 1, 4), "max_rel_err": err,
                          "rel_err_vs_k6": _rel(got, k6), "copies": len(variants)})
        del variants
    return res


def _k6_lib():
    lib = _probe_library()
    ll, p = ctypes.c_longlong, ctypes.c_void_p
    lib.probe_k6.argtypes = [ctypes.c_int] + [p] * 5 + [ll] * 8 + [p]
    lib.probe_k6.restype = ctypes.c_int
    lib.probe_k6_info.argtypes = [ctypes.c_int, ll, ll, ctypes.POINTER(ll)]
    lib.probe_k6_info.restype = ctypes.c_int
    return lib


def _k6_call(lib, vi, dev, x, q, s, sx, y, rows, IN, OUT, group, cluster):
    from vstar_tpu_torch.kernels import _build
    code = lib.probe_k6(vi, x.data_ptr(), q.data_ptr(), s.data_ptr(),
                        None if sx is None else sx.data_ptr(), y.data_ptr(), rows, IN, OUT,
                        group, cluster, int(OUT % 16 == 0), int(y.dtype == torch.float32),
                        0, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(_build.library(), code, f"k6 variant {vi}")


def _k6_cluster(lib, vi, rows, NG, OUT, sms):
    """The plan's cluster size for K6_VARIANTS[vi] (K6's own for the
    shipped shape, decode_plan's at K6's largest cluster for the others),
    and the variant's build facts."""
    from vstar_tpu_torch.kernels import int4_matmul as k4
    info = (ctypes.c_longlong * 6)()
    lib.probe_k6_info(vi, rows, int(OUT % 16 == 0), info)
    if vi == K6_SHIPPED:
        return k4.w4a8_plan(NG, OUT, info[4] * sms, sms), info
    wc, wk = K6_VARIANTS[vi][3:5]
    return k4.decode_plan(NG, OUT, info[4] * sms, 128 * wc, wk,
                          k4.W4A8_MAX_CLUSTER), info


def k6_shapes(dev):
    """Each K6_VARIANT's build facts, and its device ms and error against
    the plain version at R = 1 and 16 on K6_SHAPES (the plan's cluster)."""
    from vstar_tpu_torch.kernels import int4_matmul as k4
    lib = _k6_lib()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(7)
    res = {"build": {}, "cases": {}}
    for vi, shape in enumerate(K6_VARIANTS):
        for rows in (1, 16):
            _, info = _k6_cluster(lib, vi, rows, 32, 11008, sms)
            res["build"][f"{shape} R{rows}"] = {
                "registers": info[0], "local_bytes": info[1], "dynamic_smem": info[3],
                "blocks_per_sm": info[4]}
    for IN, OUT in K6_SHAPES:
        e = _int4_entry(gen, dev, IN, OUT)
        NG = e["s4"].shape[0]
        for rows in (1, 16):
            xq = torch.randint(-127, 128, (rows, IN), generator=gen, device=dev,
                               dtype=torch.int32).to(torch.int8)
            x = _bf16(gen, dev, rows, IN)
            want = k4.int4_matmul_w4a8_reference(xq, e["q4"], e["s4"])
            qxq, qsx = k4.quantize_activations(x.float())
            want_q = (k4.int4_matmul_w4a8_reference(qxq, e["q4"], e["s4"]) * qsx)
            variants = _copies(dict(q4=e["q4"], s4=e["s4"], q4t=e["q4"].t().contiguous(),
                                    s4t=e["s4"].t().contiguous()), ("q4", "s4", "q4t", "s4t"))
            row = {}
            for vi, shape in enumerate(K6_VARIANTS):
                fmt, wk = shape[0], shape[4]
                plan, _ = _k6_cluster(lib, vi, rows, NG, OUT, sms)
                clusters = {plan}
                if vi in (K6_SHIPPED, P4_SHIPPED):   # and the plan at 16
                    clusters |= {c for c in (2, 4, 8, 16) if -(-NG // wk) >= c}
                qk, sk = ("q4t", "s4t") if fmt == "w4a8t" else ("q4", "s4")
                xin = x if fmt == "w4a8q" else xq
                ydt = torch.bfloat16 if fmt == "w4a8q" else torch.float32
                ys = [torch.empty(rows, OUT, dtype=ydt, device=dev) for _ in variants]
                ref = want_q if fmt == "w4a8q" else want
                for cl in sorted(clusters):
                    def call(a, y, vi=vi, cl=cl, qk=qk, sk=sk, xin=xin):
                        _k6_call(lib, vi, dev, xin, a[qk], a[sk], None, y, rows, IN, OUT,
                                 IN // NG, cl)
                    tag = " (plan)" if cl == plan else ""
                    row[f"{shape} cluster {cl}{tag}"] = _timed_variant(call, variants, ys, ref)
            res["cases"][f"R={rows} {IN}x{OUT}"] = row
            del variants
    return res


def w4a8_quant(dev):
    """Where K6's qdot quantizes its rows (--w4a8-quant)."""
    from vstar_tpu_torch.kernels import int4_matmul as k4
    from vstar_tpu_torch.utils.timing import graph_ms
    lib = _k6_lib()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(8)
    res = []
    for IN, OUT in ((4096, 11008), (11008, 4096)):
        e = _int4_entry(gen, dev, IN, OUT)
        NG = e["s4"].shape[0]
        for rows in (1, 16):
            x = _bf16(gen, dev, rows, IN)
            variants = _copies(dict(q4=e["q4"], s4=e["s4"]), ("q4", "s4"))
            # its own plan (more shared memory: maybe fewer blocks), and the
            # shipped one's, under which the sums are the shipped ones
            cl, _ = _k6_cluster(lib, 1, rows, NG, OUT, sms)
            cl0, _ = _k6_cluster(lib, 0, rows, NG, OUT, sms)
            ys = [torch.empty(rows, OUT, dtype=torch.bfloat16, device=dev) for _ in variants]

            def one_launch(a, y, cl=cl):
                _k6_call(lib, 1, dev, x, a["q4"], a["s4"], None, y, rows, IN, OUT,
                         IN // NG, cl)

            def shipped(a):
                return k4.qdot4_w4a8(x, a)

            def no_pdl(a):   # the shipped qdot without the dependent launch
                xq, sx = k4.quantize_rows(x)
                y = torch.empty((rows, OUT), dtype=x.dtype, device=dev)
                return k4._launch_w4a8(xq, a["q4"], a["s4"], sx, y, pdl=False)
            one_launch(variants[0], ys[0], cl0)
            ref = shipped(variants[0])
            torch.cuda.synchronize()
            xq, sx = k4.quantize_rows(x)
            rec = {"case": f"R={rows} {IN}x{OUT}", "clusters": [cl, cl0],
                   "one_launch_bit_equal": bool(torch.equal(ys[0], ref)),
                   "shipped_ms": graph_ms([lambda a=a: shipped(a) for a in variants]),
                   "no_pdl_ms": graph_ms([lambda a=a: no_pdl(a) for a in variants]),
                   "one_launch_ms": graph_ms([lambda a=a, y=y: one_launch(a, y)
                                              for a, y in zip(variants, ys)]),
                   "quantize_ms": graph_ms([lambda: k4.quantize_rows(x)] * len(variants)),
                   "k6_ms": graph_ms([lambda a=a: k4.int4_matmul_w4a8(xq, a["q4"], a["s4"])
                                      for a in variants]),
                   "kernels": {"shipped": _graph_launches(lambda: shipped(variants[0])),
                               "one_launch": _graph_launches(
                                   lambda: one_launch(variants[0], ys[0]))}}
            res.append(rec)
            del variants, ys
    return res


def ab_p23(dev):
    """P2 (every unpack, both block_o where OUT allows it) and P3 at 1, 8
    and 16 rows on P23_SHAPES through the checkout's wrappers, beside K6
    and P4 on the same products (kernels this tree leaves as they were:
    their spread between the checkouts is the noise floor); each held to
    its plain version first, with its kernels and allocations a call
    (--p23-ab)."""
    from vstar_tpu_torch.kernels import int4_matmul as k4
    from vstar_tpu_torch.kernels import int4_variants as kv
    from vstar_tpu_torch.utils.timing import graph_kernels, graph_ms
    gen = torch.Generator(device=dev).manual_seed(9)
    res = {"k6": [], "p4": [], "p2": [], "p3": []}

    def one(fn):
        allocs = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
        fn()
        return torch.cuda.memory_stats(dev)["allocation.all.allocated"] - allocs

    for IN, OUT in P23_SHAPES:
        e = _int4_entry(gen, dev, IN, OUT)
        NG = e["s4"].shape[0]
        for rows in (1, 8, 16):
            xq = torch.randint(-127, 128, (rows, IN), generator=gen, device=dev,
                               dtype=torch.int32).to(torch.int8)
            variants = _copies(dict(xq=xq, q4=e["q4"], s4=e["s4"]), ("q4", "s4"))
            bound = _w4a8_bound(rows, IN, OUT, NG, 1, 4)
            case = f"R={rows} {IN}x{OUT}"
            k6 = k4.int4_matmul_w4a8(xq, e["q4"], e["s4"])
            res["k6"].append({"case": case, "bound_ms": bound, "ms": graph_ms(
                [lambda a=a: k4.int4_matmul_w4a8(a["xq"], a["q4"], a["s4"])
                 for a in variants])})
            if rows == 1 and OUT != 4096:
                t4 = [dict(xq=a["xq"], q4t=a["q4"].t().contiguous(),
                           s4t=a["s4"].t().contiguous()) for a in variants]
                res["p4"].append({"case": case, "bound_ms": bound, "ms": graph_ms(
                    [lambda a=a: kv.w4a8_t(a["xq"], a["q4t"], a["s4t"]) for a in t4])})
                del t4
            calls = [(f"{u} block_o={bo}", "p2",
                      lambda a, u=u, bo=bo: kv.w4a8_variant(a["xq"], a["q4"], a["s4"], u, bo),
                      lambda u=u, bo=bo: kv.w4a8_variant_reference(xq, e["q4"], e["s4"], u, bo))
                     for bo in (256, 512) if OUT % bo == 0 for u in P23_UNPACKS]
            calls.append(("default blocks", "p3",
                          lambda a: kv.w4a8_rows(a["xq"], a["q4"], a["s4"]),
                          lambda: kv.w4a8_rows_reference(xq, e["q4"], e["s4"])))
            for name, key, fn, plain in calls:
                got = fn(variants[0])
                rec = {"case": f"{name} {case}", "bound_ms": bound,
                       "max_rel_err": _rel(got, plain()), "rel_err_vs_k6": _rel(got, k6),
                       "kernels_per_call": graph_kernels(lambda: fn(variants[0]))[0],
                       "allocations_per_call": one(lambda: fn(variants[0])),
                       "ms": graph_ms([lambda a=a: fn(a) for a in variants]),
                       "copies": len(variants)}
                res[key].append(rec)
            del variants
    return res


def _p23_plan(lib, vi, rows, NG, blocks, OUT, sms):
    """The plan's cluster for P23_VARIANTS[vi] (w4a8_plan at the variant's
    strip and occupancy; P3 no more k-splits than blocks, as w4a8_rows
    plans), and the variant's build facts."""
    from vstar_tpu_torch.kernels import int4_matmul as k4
    info = (ctypes.c_longlong * 6)()
    code = lib.probe_p23_info(vi, rows, info)
    if code != 0:
        return None, info
    fmt, _, _, wc, _, _ = P23_VARIANTS[vi]
    plan = k4.w4a8_plan(NG, OUT, info[4] * sms, sms, 128 * wc)
    while fmt == "w4a8r" and plan > blocks:
        plan //= 2
    return plan, info


def p23_shapes(dev):
    """Each P23_VARIANT's build facts, and its device ms and error against
    the plain version at R = 1 and 16 on 11008x4096 (P3's also on
    4096x11008 and 4096x32000), at the plan's cluster (and P3's shapes and
    P2's at 512 columns at 2, 4, 8 and 16) (--p23-shapes)."""
    from vstar_tpu_torch.kernels import _build
    from vstar_tpu_torch.kernels import int4_variants as kv
    lib = _probe_library()
    ll, p = ctypes.c_longlong, ctypes.c_void_p
    lib.probe_p23.argtypes = [ctypes.c_int] + [p] * 4 + [ll] * 6 + [p]
    lib.probe_p23.restype = ctypes.c_int
    lib.probe_p23_info.argtypes = [ctypes.c_int, ll, ctypes.POINTER(ll)]
    lib.probe_p23_info.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(10)
    res = {"build": {}, "cases": {}}
    for vi, shape in enumerate(P23_VARIANTS):
        for rows in (1, 16):
            _, info = _p23_plan(lib, vi, rows, 86, 43, 4096, sms)
            res["build"][f"{shape} R{rows}"] = {
                "registers": info[0], "local_bytes": info[1], "dynamic_smem": info[3],
                "blocks_per_sm": info[4]}
    for IN, OUT in ((11008, 4096), (4096, 11008), (4096, 32000)):
        e = _int4_entry(gen, dev, IN, OUT)
        NG = e["s4"].shape[0]
        block_i = kv.default_block_i(IN // 2, OUT, NG)
        blk = block_i // (IN // 2 // NG)
        for rows in (1, 16):
            xq = torch.randint(-127, 128, (rows, IN), generator=gen, device=dev,
                               dtype=torch.int32).to(torch.int8)
            want = {"w4a8r": kv.w4a8_rows_reference(xq, e["q4"], e["s4"], block_i),
                    "w4a8": kv.w4a8_variant_reference(xq, e["q4"], e["s4"])}
            variants = _copies(dict(q4=e["q4"], s4=e["s4"]), ("q4", "s4"))
            ys = [torch.empty(rows, OUT, dtype=torch.float32, device=dev) for _ in variants]
            row = {}
            for vi, shape in enumerate(P23_VARIANTS):
                fmt, wc = shape[0], shape[3]
                if fmt == "w4a8" and (OUT % (128 * wc) or IN != 11008):
                    continue
                plan, _ = _p23_plan(lib, vi, rows, NG, NG // blk, OUT, sms)
                if plan is None:
                    continue
                units = NG // blk if fmt == "w4a8r" else NG
                sweep = vi == P2_512 or (fmt == "w4a8r" and shape[5] == 0)
                clusters = {plan} | ({c for c in (2, 4, 8, 16) if units >= c * shape[4]}
                                     if sweep else set())
                for cl in sorted(clusters):
                    def call(a, y, vi=vi, cl=cl, b=blk if fmt == "w4a8r" else 1):
                        code = lib.probe_p23(vi, xq.data_ptr(), a["q4"].data_ptr(),
                                             a["s4"].data_ptr(), y.data_ptr(), rows, IN, OUT,
                                             IN // NG, b, cl,
                                             torch.cuda.current_stream(dev).cuda_stream)
                        _build.check(_build.library(), code, f"p23 variant {vi}")
                    tag = " (plan)" if cl == plan else ""
                    try:
                        row[f"{shape} cluster {cl}{tag}"] = _timed_variant(
                            call, variants, ys, want[fmt])
                    except RuntimeError as err:   # e.g. a cluster no GPC holds
                        row[f"{shape} cluster {cl}{tag}"] = {"error": str(err)[:200]}
            res["cases"][f"R={rows} {IN}x{OUT}"] = row
            del variants, ys
    return res


def sass_unpacks():
    """Whether nvcc emitted the same SASS for P2's mul as for ship (the
    kernel library's decode_rows_kernel instantiations that differ only in
    their unpack), from `cuobjdump -sass`: per (rows, warps) the
    instruction counts and whether the streams are equal (--sass)."""
    import re
    from vstar_tpu_torch.kernels import _build
    funcs = _sass_functions(_build.build())
    # decode_rows_kernel<kFmtW4A8, RB, true, 64, 3, WC, 1, 0, LO>
    pat = re.compile(r"decode_rows_kernelILi2ELi(\d+)ELb1ELi64ELi3ELi(\d)ELi1ELi0ELi(\d)E")
    by = {}
    for fn, ins in funcs.items():
        m = pat.search(fn)
        if m:
            by[(int(m.group(1)), int(m.group(2)), int(m.group(3)))] = ins
    res = []
    for (rb, wc, lo), ins in sorted(by.items()):
        if lo != 1 or (rb, wc, 0) not in by:
            continue
        ship = by[(rb, wc, 0)]
        res.append({"rows": rb, "warps": wc, "ship_instructions": len(ship),
                    "mul_instructions": len(ins), "identical": ship == ins,
                    "other_counts": {P23_UNPACKS[k[2]]: len(v) for k, v in by.items()
                                     if k[:2] == (rb, wc)}})
    return res


def _sass_functions(so):
    """{function name: [instructions]} of a library, from cuobjdump -sass
    (the addresses dropped)."""
    import re
    from vstar_tpu_torch.kernels import _build
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name is not None:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
            if m:
                funcs[name].append(m.group(1))
    return funcs


def sass_vs(root):
    """The decode-row instantiations that this tree's kernel library and
    the one of the checkout at `root` (built there by its own _build)
    share, keyed by their template arguments up to PF (the trailing
    low-nibble unpack, where there is one, must be ship): for each, both
    instruction counts and whether the SASS is identical (--sass-vs)."""
    import re
    from vstar_tpu_torch.kernels import _build
    other = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from vstar_tpu_torch.kernels import _build; print(_build.build())",
         os.path.abspath(root)], capture_output=True, text=True, check=True,
        cwd=os.path.abspath(root)).stdout.strip().splitlines()[-1]
    pat = re.compile(r"decode_rows_kernelI((?:L[ib]\d+E){8})(?:Li(\d+)E)?E")

    def by_key(so):
        out = {}
        for fn, ins in _sass_functions(so).items():
            m = pat.search(fn)
            if m and (m.group(2) or "0") == "0":
                out[m.group(1)] = ins
        return out

    mine, theirs = by_key(_build.build()), by_key(other)
    res = []
    for key in sorted(set(mine) & set(theirs)):
        args = [int(a) for a in re.findall(r"L[ib](\d+)E", key)]
        res.append({"format_rows_aligned_srows_stages_wc_wk_pf": args,
                    "instructions": len(mine[key]), "other_instructions": len(theirs[key]),
                    "identical": mine[key] == theirs[key]})
    return {"other_library": other, "shared": res,
            "only_here": len(set(mine) - set(theirs)),
            "only_there": len(set(theirs) - set(mine))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ab", action="store_true")
    ap.add_argument("--k7-tiles", action="store_true")
    ap.add_argument("--k5-shapes", action="store_true")
    ap.add_argument("--k3-shapes", action="store_true")
    ap.add_argument("--k5-tiles", action="store_true")
    ap.add_argument("--w4a8-ab", action="store_true")
    ap.add_argument("--k6-shapes", action="store_true")
    ap.add_argument("--w4a8-quant", action="store_true")
    ap.add_argument("--p23-ab", action="store_true")
    ap.add_argument("--p23-shapes", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--sass-vs", default=None, metavar="DIR")
    ap.add_argument("--calibrate", action="store_true")
    ap.add_argument("--root", default=None,
                    help="checkout whose vstar_tpu_torch --ab measures")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device; it measures the card", file=sys.stderr)
        return 1
    if args.root is not None:
        sys.path.insert(0, os.path.abspath(args.root))
    torch.backends.cuda.matmul.allow_tf32 = False
    from vstar_tpu_torch.utils.timing import card_line
    import vstar_tpu_torch
    dev = torch.device("cuda:0")
    out = {"card": card_line(), "package": os.path.dirname(vstar_tpu_torch.__file__)}
    if args.ab:
        out["k7"] = ab_k7(dev)
        out["k3"] = ab_k3(dev)
        out["k5"] = ab_k5(dev)
        out["k5_tile"] = ab_k5_tiles(dev)
    if args.ab or args.w4a8_ab:
        out["w4a8"] = ab_w4a8(dev)
    if args.k7_tiles:
        out["k7_tiles"] = k7_tiles(dev)
    if args.k5_shapes:
        out["k5_shapes"] = k5_shapes(dev)
    if args.calibrate:
        out["calibrate"] = calibrate(dev)
    if args.k3_shapes:
        out["k3_shapes"] = k3_shapes(dev)
    if args.k5_tiles:
        out["k5_tile_sweep"] = k5_tiles(dev)
    if args.k6_shapes:
        out["k6_shapes"] = k6_shapes(dev)
    if args.w4a8_quant:
        out["w4a8_quant"] = w4a8_quant(dev)
    if args.p23_ab:
        out["p23"] = ab_p23(dev)
    if args.p23_shapes:
        out["p23_shapes"] = p23_shapes(dev)
    if args.sass:
        out["sass_unpacks"] = sass_unpacks()
    if args.sass_vs:
        out["sass_vs"] = sass_vs(args.sass_vs)
    text = json.dumps(out)
    print(text, flush=True)
    if args.out:
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
