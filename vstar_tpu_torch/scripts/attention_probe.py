"""K1's launch path and tile shape, measured on the H100.

  --gap    K1 at decode (q [1,1,32,128] over one layer of a 768-slot
           cache, 301 keys) and at the verify chunk (q [2,8] as a strided
           slice of a fused projection, 145 / 298 keys): device ms (one
           CUDA graph of 8 calls), ms per call by CUDA events (host launch
           path included), their difference (the host gap), and ms per
           call of 2000 eager calls in a row, as a decode loop makes them.
           `--root DIR` measures the checkout at DIR instead (run this
           file by its path, so that DIR's vstar_tpu_torch is imported),
           which compares two trees on one card, in turns:
             python3 vstar_tpu_torch/scripts/attention_probe.py --gap --root ../parent
  --tiles  K1's tile route at other shapes (VARIANTS: query rows BQ, key
           tile BK, cp.async stages, a register cap through the minimum
           resident blocks), each held to mha_reference and timed by CUDA
           graph at chip_smoke.py's tile-route cases and the training
           shape; attention_probe.cu instantiates them and is built beside
           the kernel library. The shipped kernel is the first variant.

    python3 -m vstar_tpu_torch.scripts.attention_probe --gap --tiles
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

# (name, BQ, BK, stages, minimum resident blocks), attention_probe.cu's order
VARIANTS = [("BQ64 BK64 st2", 64, 64, 2, 1),
            ("BQ128 BK64 st2", 128, 64, 2, 1),
            ("BQ64 BK64 st3", 64, 64, 3, 1),
            ("BQ64 BK32 st2", 64, 32, 2, 1),
            ("BQ64 BK32 st3", 64, 32, 3, 1),
            ("BQ64 BK32 st4 min2", 64, 32, 4, 2),
            ("BQ64 BK128 st2", 64, 128, 2, 1),
            ("BQ64 BK64 st2 min3", 64, 64, 2, 3)]
HERE = Path(__file__).resolve().parent


def _bf16(gen, dev, *shape):
    return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)


def _i32(x, dev):
    return torch.tensor(x, dtype=torch.int32, device=dev)


def gap(dev):
    """Device, events and eager ms per call of K1 at decode and verify."""
    from vstar_tpu_torch.kernels import _build
    from vstar_tpu_torch.kernels import flash_attention as fa
    from vstar_tpu_torch.utils.timing import events_ms, graph_ms
    _build.library()
    gen = torch.Generator(device=dev).manual_seed(0)
    H, D = 32, 128
    ck, cv = _bf16(gen, dev, 2, 1, 768, H, D), _bf16(gen, dev, 2, 1, 768, H, D)
    qkv = _bf16(gen, dev, 2, 8, 3, H, D)
    cases = {"decode": dict(q=_bf16(gen, dev, 1, 1, H, D), k=ck[1], v=cv[1],
                            kv_lens=_i32([301], dev), q_offsets=_i32([300], dev)),
             "verify": dict(q=qkv[:, :, 0], k=_bf16(gen, dev, 2, 512, H, D),
                            v=_bf16(gen, dev, 2, 512, H, D),
                            kv_lens=_i32([145, 298], dev),
                            q_offsets=_i32([137, 290], dev))}
    res = {}
    for name, a in cases.items():
        def call(a=a):
            return fa.flash_attention(**a)
        call()
        device = graph_ms([call] * 8)
        events = events_ms(call, iters=200)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            call()
        torch.cuda.synchronize()
        res[name] = {"device_ms": device, "events_ms": events,
                     "gap_ms": events - device,
                     "eager_ms_per_call": (time.perf_counter() - t0) / 2}
    return res


def _tile_cases(dev):
    """chip_smoke.py's K1 cases of more than 16 query rows (prefill,
    option chunks, key holes) and the training shape with its lse."""
    gen = torch.Generator(device=dev).manual_seed(0)
    H, D = 32, 128
    offs = [300, 301, 420, 511]
    valid = torch.rand(2, 256, generator=gen, device=dev) > 0.3
    valid[1, 0] = False
    train_valid = torch.rand(4, 512, generator=gen, device=dev) > 0.1
    return [
        ("prefill", False, dict(q=_bf16(gen, dev, 1, 512, H, D),
                                k=_bf16(gen, dev, 1, 768, H, D),
                                v=_bf16(gen, dev, 1, 768, H, D),
                                kv_lens=_i32([300], dev), q_offsets=_i32([0], dev))),
        ("option", False, dict(q=_bf16(gen, dev, 4, 64, H, D),
                               k=_bf16(gen, dev, 4, 576, H, D),
                               v=_bf16(gen, dev, 4, 576, H, D),
                               kv_lens=_i32([o + n for o, n in zip(offs, [5, 12, 64, 30])], dev),
                               q_offsets=_i32(offs, dev))),
        ("kv_valid", False, dict(q=_bf16(gen, dev, 2, 128, H, D),
                                 k=_bf16(gen, dev, 2, 256, H, D),
                                 v=_bf16(gen, dev, 2, 256, H, D),
                                 kv_lens=_i32([256, 200], dev),
                                 q_offsets=_i32([0, 0], dev), kv_valid=valid)),
        ("train_lse", True, dict(q=_bf16(gen, dev, 4, 512, H, D),
                                 k=_bf16(gen, dev, 4, 512, H, D),
                                 v=_bf16(gen, dev, 4, 512, H, D),
                                 kv_lens=_i32([512, 300, 512, 512], dev),
                                 q_offsets=_i32([0, 0, 0, 0], dev),
                                 kv_valid=train_valid))]


def tiles(dev):
    """Each VARIANT's registers, spills, resident blocks, and device ms
    and max |error| against mha_reference at each tile-route case."""
    from vstar_tpu_torch.kernels import _build
    from vstar_tpu_torch.kernels import flash_attention as fa
    from vstar_tpu_torch.utils.timing import graph_ms
    so = _build.BUILD_DIR / "attention_probe.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
                    str(_build.CSRC), "-o", str(so),
                    str(HERE / "attention_probe.cu")], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    fn = lib.probe_tile
    fn.argtypes = _build._SIGNATURES["vstar_flash_attention_fwd"]
    fn.restype = ctypes.c_int
    info = (ctypes.c_int * 3)()
    res = {"build": {}, "cases": {}}
    for i, (name, *_) in enumerate(VARIANTS):
        if lib.probe_info(i, info) != 0:
            raise RuntimeError(f"{name}: no kernel attributes")
        res["build"][name] = {"registers": info[0], "local_bytes": info[1],
                              "blocks_per_sm": info[2]}
    for case, with_lse, a in _tile_cases(dev):
        kl, qo, kvv = fa._validate(a["q"], a["k"], a["v"], a["kv_lens"],
                                   a["q_offsets"], a.get("kv_valid"))
        q, k, v = a["q"], a["k"], a["v"]
        B, Sq, H, D = q.shape
        want = fa.mha_reference(q, k, v, kl, qo, kvv).float()
        row = {}
        for i, (name, *_) in enumerate(VARIANTS):
            out = torch.empty_like(q)
            lse = torch.empty((B, Sq, H), dtype=torch.float32, device=dev) \
                if with_lse else None

            def call(i=i, out=out, lse=lse):
                code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), kl.data_ptr(), qo.data_ptr(),
                          None if kvv is None else kvv.data_ptr(),
                          None if lse is None else lse.data_ptr(), None, None,
                          i, B, Sq, k.shape[1], H, *q.stride()[:3],
                          *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
                          0 if kvv is None else kvv.stride(0),
                          *((0, 0, 0) if lse is None else lse.stride()),
                          D ** -0.5, torch.cuda.current_stream(dev).cuda_stream)
                _build.check(lib, code, name)
            call()
            torch.cuda.synchronize()
            row[name] = {"ms": graph_ms([call] * 8),
                         "max_abs_err": float((out.float() - want).abs().max())}
        res["cases"][case] = row
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gap", action="store_true")
    ap.add_argument("--tiles", action="store_true")
    ap.add_argument("--root", default=None,
                    help="checkout whose vstar_tpu_torch --gap measures")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attention_probe: no CUDA device; it measures the card",
              file=sys.stderr)
        return 1
    if args.root is not None:
        sys.path.insert(0, os.path.abspath(args.root))
    from vstar_tpu_torch.utils.timing import card_line
    dev = torch.device("cuda:0")
    out = {"card": card_line()}
    if args.gap:
        out["gap"] = gap(dev)
    if args.tiles:
        out["tiles"] = tiles(dev)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
