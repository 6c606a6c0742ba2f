"""Where does an int4 7B decode token's time go on the H100?

The port of the JAX package's int4 profile (scripts/int4_profile.py): the
experiment that decides the W4A8 (K6) design. Stages (flags):

  --probe         P1 (kernels/int4_variants.unpack_probe): do the two lo
                  nibble unpack candidates, a per-byte int8 multiply by 16
                  and four doublings, give (q & 0xF) << 4? On the card also
                  their device time on a packed 7B w_gate [2048, 11008].
  --matmul        per-matmul timings at every 7B decode shape (SHAPES) over
                  L distinct weights: int8 (K3), W4A16 (K5), W4A8 (K6, also
                  with one group), and the candidate W4A8 kernels P2 (lo
                  unpack ship / mul / 2and / off, 256 or 512 columns per
                  block), P3 (row blocks) and P4 (transposed storage), each
                  first held to K6 on one weight. Reports the kernel's
                  device ms, the ms of the whole qdot (activation
                  quantization and scale inside the timing, as the decode
                  runs it: K6's qdot4_w4a8 in its two launches, a
                  candidate after quantize_rows and times sx) and GB/s on
                  the weight bytes.
  --library-int4  the library question (the JAX script's --xla-int4), on the
                  first shape only: tinygemm (torch._weight_int4pack_mm), a
                  bf16 dequantize then torch.matmul, and torch._int_mm on the
                  nibbles upcast to int8. Yardsticks only; the port never
                  calls them.
  --decode        decode ablations at full 7B width (vsm_7b().llama, a cache
                  of 512 positions filled to 384, 8 tokens per timing): int8,
                  headless int8, W4A16, W4A8, headless W4A8, int4 layers with
                  an int8 lm_head, int8 layers with an int4 lm_head, and the
                  unquantized bf16 decoder. Per row: ms per token from one
                  CUDA graph of the 8-token loop (device), ms per token of
                  the eager loop (CUDA events), and kernel launches and
                  qdot's int4 routes (W4A8, W4A16) per token.

Device time comes from CUDA graphs: one graph over the L distinct weight
copies (more than the 50 MB L2 in all, so weights come from HBM, as in
decode), replayed; no call can be hoisted out of a graph, so the JAX
script's carry-chained fori/scan loops have no counterpart here.

    python3 -m vstar_tpu_torch.scripts.int4_profile --probe --matmul --decode

--device cpu runs the plain versions on the CPU (checks only, no times;
small shapes only: the 7B stages need the card).
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional

import torch

from ..core.config import LlamaConfig, vsm_7b
from ..core.params import Init
from ..kernels import flash_attention as fa
from ..kernels import int4_matmul as k4
from ..kernels import int4_variants as kv
from ..kernels import int8_matmul as k8
from ..nn import quant
from ..nn.llama import (embed_tokens, init_cache, init_llama_params,
                        llama_forward, lm_logits)
from ..utils.timing import card_line, events_ms, graph_ms

K_DECODE = 8          # decode tokens per timing (the JAX script's K_DECODE)
F32_REL_TOL = 1e-5    # a W4A8 candidate against K6, of the largest |output|

SHAPES = ((4096, 4096, 16), (4096, 11008, 12), (11008, 4096, 12),
          (4096, 32000, 8))
DEFAULT_MODES = ("int8", "w4a16", "w4a8", "w4a8_pc", "w4a8_bo512")
MODES = DEFAULT_MODES + (
    "w4a8_mul", "w4a8_mul_bo512", "w4a8_2and", "w4a8_2and_bo512",
    "w4a8_off", "w4a8_off_bo512", "w4a8_rows", "w4a8_t", "w4a8_t512")

PROBE_NAMES = {"mul": "i8 mul by 16", "add": "i8 add x4"}


def log(msg: str) -> None:
    print(msg, flush=True)


def _rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


# ---------------------------------------------------------------------------
# --probe
# ---------------------------------------------------------------------------

def probe(device="cuda", seed: int = 0) -> Dict[str, Dict]:
    """P1 on a [256, 256] u8 array: one `probe <name>: compiles,
    correct=<bool>` line per candidate (the JAX probe_mosaic's); on the
    card also each candidate's device ms on a packed 7B w_gate [2048,
    11008] u8, over copies that exceed the L2."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randint(0, 256, (256, 256), generator=g,
                      dtype=torch.int32).to(torch.uint8).to(device)
    want = kv.want_lo(q)
    results = {}
    for how, name in PROBE_NAMES.items():
        try:
            ok = bool(torch.equal(kv.unpack_probe(q, how), want))
            log(f"probe {name:16s}: compiles, correct={ok}")
        except (RuntimeError, ValueError) as err:
            log(f"probe {name:16s}: FAILS ({type(err).__name__}: "
                f"{str(err)[:120]})")
            ok = None
        results[how] = {"correct": ok}
    if torch.device(device).type != "cuda":
        return results
    w = torch.randint(0, 256, (2048, 11008), generator=g,
                      dtype=torch.int32).to(torch.uint8).to(device)
    copies = [w] + [w.clone() for _ in range(8)]    # 9 x 22.5 MB
    for how, name in PROBE_NAMES.items():
        if not results[how]["correct"]:
            continue
        exact = bool(torch.equal(kv.unpack_probe(w, how), kv.want_lo(w)))
        ms = graph_ms([lambda c=c: kv.unpack_probe(c, how) for c in copies])
        gbs = 2 * w.numel() / (ms * 1e-3) / 1e9
        results[how].update(ms=ms, gbs=gbs, exact_7b=exact)
        log(f"probe {name:16s}: w_gate [2048, 11008] u8 -> int8 {ms:.4f} ms "
            f"device ({gbs:.1f} GB/s read + written), correct={exact}")
    return results


# ---------------------------------------------------------------------------
# --matmul
# ---------------------------------------------------------------------------

def _stacked(mode: str, IN: int, OUT: int, L: int, gen, device) -> List:
    """L distinct weights of the mode's format (random codes, scales
    1e-2, as the JAX script's _stacked)."""
    def codes(shape, lo, hi, dtype):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32,
                             device=device).to(dtype)

    ng = 1 if mode.endswith("pc") else IN // 128
    out = []
    for _ in range(L):
        if mode == "int8":
            e = {"q": codes((IN, OUT), -127, 128, torch.int8),
                 "s": torch.full((1, OUT), 1e-2, device=device)}
        elif mode.startswith("w4a8_t"):
            e = {"q4t": codes((OUT, IN // 2), 0, 256, torch.uint8),
                 "s4t": torch.full((OUT, ng), 1e-2, device=device)}
        else:
            e = {"q4": codes((IN // 2, OUT), 0, 256, torch.uint8),
                 "s4": torch.full((ng, OUT), 1e-2, device=device)}
        out.append(e)
    return out


def _variant(mode: str):
    """A P2 mode -> (unpack, block_o): 'w4a8_bo512' is K6's unpack at 512
    columns, 'w4a8_2and_bo512' the 2and unpack at 512."""
    rest = mode[len("w4a8"):]
    block_o = 512 if rest.endswith("_bo512") else 256
    return rest.removesuffix("_bo512").lstrip("_") or "ship", block_o


def kernel_call(mode: str, e: Dict, x, xq):
    """The mode's kernel alone: x bf16 [R, IN] for int8 / w4a16, xq int8
    for the W4A8 modes."""
    if mode == "int8":
        return k8.int8_matmul(x, e["q"], e["s"])
    if mode == "w4a16":
        return k4.int4_matmul(x, e["q4"], e["s4"])
    if mode in ("w4a8", "w4a8_pc"):
        return k4.int4_matmul_w4a8(xq, e["q4"], e["s4"])
    if mode == "w4a8_rows":
        return kv.w4a8_rows(xq, e["q4"], e["s4"])
    if mode.startswith("w4a8_t"):
        return kv.w4a8_t(xq, e["q4t"], e["s4t"],
                         512 if mode.endswith("512") else 256)
    unpack, block_o = _variant(mode)
    return kv.w4a8_variant(xq, e["q4"], e["s4"], unpack, block_o)


def apply(mode: str, e: Dict, x):
    """The whole qdot of the mode on bf16 x: for W4A8 the per-row int8
    activation quantization, the kernel and the activation scale (the
    decode's work per matrix): K6's own qdot4_w4a8, or a candidate after
    quantize_rows."""
    if mode == "int8":
        return quant.qdot(x, e)
    if mode == "w4a16":
        return k4.qdot4(x, e)
    if mode in ("w4a8", "w4a8_pc"):
        return k4.qdot4_w4a8(x, e)
    xq, sx = k4.quantize_rows(x)
    return (kernel_call(mode, e, None, xq) * sx).to(x.dtype)


def _against_k6(mode: str, e: Dict, xq) -> float:
    """A candidate on one weight against K6 on the same (untransposed)
    weight: the error of the largest |output|."""
    got = kernel_call(mode, e, None, xq)
    if mode.startswith("w4a8_t"):
        e = {"q4": e["q4t"].t().contiguous(), "s4": e["s4t"].t().contiguous()}
    want = k4.int4_matmul_w4a8(xq, e["q4"], e["s4"])
    return _rel_err(got, want)


def bench_matmuls(modes=DEFAULT_MODES, device="cuda", shapes=SHAPES,
                  seed: int = 0) -> Dict:
    """Every (shape, mode): the candidate held to K6 (W4A8 candidates),
    then on the card its device ms, the qdot's device ms and GB/s on the
    packed weight bytes. Returns {(IN, OUT, mode): record}."""
    on_card = torch.device(device).type == "cuda"
    quant.set_act_int8(False)
    gen = torch.Generator(device=device).manual_seed(seed)
    results = {}
    for IN, OUT, L in shapes:
        for mode in modes:
            if mode not in MODES:
                raise ValueError(f"unknown mode {mode!r}; modes: {MODES}")
            if mode.endswith("512") and OUT % 512:
                log(f"[{IN:5d}x{OUT:5d}] {mode:15s} skipped (OUT % 512)")
                continue
            stack = _stacked(mode, IN, OUT, L, gen, device)
            x = torch.randn(1, IN, generator=gen, device=device).to(
                torch.bfloat16)
            xq, _ = k4.quantize_rows(x)
            rec = {}
            if mode.startswith("w4a8_") and mode != "w4a8_pc":
                xq1 = torch.randint(-127, 128, (1, IN), generator=gen,
                                    dtype=torch.int32, device=device).to(
                                        torch.int8)
                rec["err_vs_k6"] = err = _against_k6(mode, stack[0], xq1)
                if not err <= F32_REL_TOL:
                    raise AssertionError(f"{mode} at {IN}x{OUT}: {err:.3e} "
                                         f"of the largest |output| off K6")
            if not on_card:
                kernel_call(mode, stack[0], x, xq)
                apply(mode, stack[0], x)
                results[(IN, OUT, mode)] = rec
                log(f"[{IN:5d}x{OUT:5d}] {mode:15s} ran on {device} "
                    f"(plain versions; not timed)")
                continue
            ms = graph_ms([lambda e=e: kernel_call(mode, e, x, xq)
                           for e in stack])
            qdot_ms = graph_ms([lambda e=e: apply(mode, e, x) for e in stack])
            bytes_w = IN * OUT if mode == "int8" else IN * OUT // 2
            rec.update(ms=ms, qdot_ms=qdot_ms,
                       gbs=bytes_w / (ms * 1e-3) / 1e9,
                       qdot_gbs=bytes_w / (qdot_ms * 1e-3) / 1e9)
            results[(IN, OUT, mode)] = rec
            check = (f" (K6 err {rec['err_vs_k6']:.1e})"
                     if "err_vs_k6" in rec else "")
            log(f"[{IN:5d}x{OUT:5d}] {mode:15s} {ms:7.4f} ms kernel "
                f"({rec['gbs']:6.1f} GB/s), {qdot_ms:7.4f} ms qdot "
                f"({rec['qdot_gbs']:6.1f} GB/s) on weight bytes{check}")
            del stack
    return results


# ---------------------------------------------------------------------------
# --library-int4
# ---------------------------------------------------------------------------

def tinygemm_pack(q4, s4, even_high: bool):
    """q4, s4 -> torch._weight_int4pack_mm's packed weight, its bf16
    (scale, zero) pairs and group size: unsigned nibbles n + 8 with zeros
    of 0 give n * s4."""
    u = (k4.unpack_int4(q4).to(torch.int32) + 8).t().contiguous()
    even, odd = u[:, 0::2], u[:, 1::2]
    packed = ((even << 4) | odd) if even_high else (even | (odd << 4))
    w = torch._convert_weight_to_int4pack(packed.to(torch.uint8)
                                          .contiguous(), 8)
    sz = torch.stack([s4, torch.zeros_like(s4)], -1).to(torch.bfloat16)
    return w, sz.contiguous(), 2 * q4.shape[0] // s4.shape[0]


def bench_library_int4(device="cuda", seed: int = 0) -> Dict[str, Dict]:
    """The first shape (4096 x 4096, 16 distinct weights), R = 1:
    tinygemm on the group-128 weights, bf16 dequantize + matmul on the
    same, torch._int_mm on the nibbles upcast to int8 with one scale per
    column (the JAX script's xla_i4_i8dot). Each is checked, then timed by
    device time; GB/s on the packed bytes."""
    if torch.device(device).type != "cuda":
        raise RuntimeError("--library-int4 times library calls on the card")
    IN, OUT, L = SHAPES[0]
    gen = torch.Generator(device=device).manual_seed(seed)
    stack = _stacked("w4a16", IN, OUT, L, gen, device)
    x = torch.randn(1, IN, generator=gen, device=device).to(torch.bfloat16)
    want = k4.int4_matmul_reference(x, stack[0]["q4"], stack[0]["s4"])
    results = {}

    def record(name, calls, err):
        ms = graph_ms(calls)
        gbs = IN * OUT // 2 / (ms * 1e-3) / 1e9
        results[name] = {"ms": ms, "gbs": gbs, "err": err}
        log(f"[{IN:5d}x{OUT:5d}] {name:22s} {ms:7.4f} ms ({gbs:6.1f} GB/s "
            f"on the packed bytes), err {err:.1e} of the largest |output|")

    for even_high in (True, False):
        try:
            w, sz, group = tinygemm_pack(stack[0]["q4"], stack[0]["s4"],
                                     even_high)
            err = _rel_err(torch._weight_int4pack_mm(x, w, group, sz), want)
        except (RuntimeError, NotImplementedError, AttributeError) as exc:
            log(f"tinygemm unavailable: {str(exc).splitlines()[0][:160]}")
            break
        if err <= 1e-2:
            packs = [tinygemm_pack(e["q4"], e["s4"], even_high) for e in stack]
            record("tinygemm (group 128)", [
                lambda p=p: torch._weight_int4pack_mm(x, p[0], p[2], p[1])
                for p in packs], err)
            del packs
            break
    record("bf16 dequant + matmul", [
        lambda e=e: x @ k4.dequantize_int4(e["q4"], e["s4"], torch.bfloat16)
        for e in stack],
        _rel_err(x @ k4.dequantize_int4(stack[0]["q4"], stack[0]["s4"],
                                        torch.bfloat16), want))
    # int8 activations (rows padded to the 32 that cuBLASLt takes) against
    # the upcast nibbles, int32, one scale per column
    xq = torch.clamp(torch.round(x.float() * 127), -127, 127).to(torch.int8)
    xpad = torch.nn.functional.pad(xq, (0, 0, 0, 31))

    def int_mm(e):
        acc = torch._int_mm(xpad, k4.unpack_int4(e["q4"]))[:1]
        return acc.float() * e["s4"][0] / 127.0

    exact = (xq.double() @ k4.unpack_int4(stack[0]["q4"]).double()).float() \
        * stack[0]["s4"][0] / 127.0
    record("_int_mm on upcast nibbles", [lambda e=e: int_mm(e) for e in stack],
           _rel_err(int_mm(stack[0]), exact))
    return results


# ---------------------------------------------------------------------------
# --decode
# ---------------------------------------------------------------------------

def make_decode(cfg: LlamaConfig, headless: bool = False,
                act_dtype=torch.bfloat16):
    """decode_t(params, seed): K_DECODE greedy-shaped decode steps of token
    17 from a cache of 512 positions filled to 384 (JAX make_decode);
    returns the last step's mean logit (or mean hidden state, headless) in
    seed's dtype. Each step's input is embed + seed-derived carry * 1e-9.
    JAX adds the f32 carry to the bf16 embedding and so runs the decoder
    on f32 activations; the port's kernels take bf16, so on the card
    act_dtype is bf16 (the tests run f32 against JAX)."""
    def decode_t(params: Dict, seed: torch.Tensor) -> torch.Tensor:
        dev = seed.device
        cache = init_cache(cfg, 1, 512, torch.bfloat16, device=dev)
        cache.length = torch.full((1,), 384, dtype=torch.int32, device=dev)
        tok = torch.full((1, 1), 17, dtype=torch.int64, device=dev)
        x = seed
        for _ in range(K_DECODE):
            h = (embed_tokens(params, tok, torch.bfloat16).to(act_dtype)
                 + (x * 1e-9).to(act_dtype))
            hidden, cache = llama_forward(
                params, cfg, h, cache.length[:, None], cache.length + 1,
                q_offsets=cache.length, cache=cache)
            out = (hidden.mean() if headless
                   else lm_logits(params, hidden).mean())
            x = out.to(seed.dtype)
        return x

    return decode_t


# (name, params, headless, act-int8), the JAX script's rows and order, then
# the unquantized decoder (the port's serving default)
DECODE_ROWS = (
    ("int8 (K3)", "int8", False, False),
    ("int8, headless (no lm_head)", "int8", True, False),
    ("int4 W4A16", "int4", False, False),
    ("int4 W4A8 (act-int8)", "int4", False, True),
    ("int4 W4A8, headless", "int4", True, True),
    ("int4 layers + int8 lm_head (W4A8)", "int4_head8", False, True),
    ("int8 layers + int4 lm_head (W4A8)", "int8_head4", False, True),
    ("bf16 (unquantized)", "bf16", False, False),
)


def decode_params(cfg: LlamaConfig, device, seed: int = 0) -> Dict:
    """The decoders of DECODE_ROWS, random from `seed` (int8 and int4 from
    the same draws, as the JAX script's PRNGKey(0) for both)."""
    def init(quantize):
        return init_llama_params(Init(seed, device, torch.bfloat16), cfg,
                                 quantize=quantize)

    p8, p4 = init(True), init("int4")
    return {"int8": p8, "int4": p4, "bf16": init(False),
            "int4_head8": dict(p4, lm_head=p8["lm_head"]),
            "int8_head4": dict(p8, lm_head=p4["lm_head"])}


COUNTED = {"K1": (fa, "launches", None), "K3": (k8, "launches", None),
           "K5": (k4, "launches", "int4_matmul"),
           "K6": (k4, "launches", "int4_matmul_w4a8"),
           "quantize_rows": (k4, "launches", "quantize_rows"),
           "_w8a8_dot": (quant, "w8a8_calls", None),
           "qdot_w4a8": (quant, "int4_routes", "w4a8"),
           "qdot_w4a16": (quant, "int4_routes", "w4a16")}


def _counts() -> Dict[str, int]:
    out = {}
    for name, (mod, attr, key) in COUNTED.items():
        v = getattr(mod, attr)
        out[name] = v[key] if key else v
    return out


def _plain_on_cuda() -> int:
    return (fa.plain_calls_cuda + k8.plain_calls_cuda
            + sum(k4.plain_calls_cuda.values()))


def bench_decode(device="cuda", cfg: Optional[LlamaConfig] = None,
                 params: Optional[Dict] = None, act_dtype=torch.bfloat16,
                 rows=DECODE_ROWS, seed: int = 0) -> List[Dict]:
    """Each row's decode: its output, launches per token (K1, K3, K5, K6
    and its row quantization, _w8a8_dot), qdot's int4 routes per token
    (counted on every device) and plain-version calls on CUDA tensors; on
    the card also ms per token by CUDA graph (device) and by events
    (eager)."""
    cfg = cfg or vsm_7b().llama
    on_card = torch.device(device).type == "cuda"
    if params is None:
        log(f"init the decoders ({cfg.num_layers} layers, hidden "
            f"{cfg.hidden_size}, vocab {cfg.vocab_size}) on {device}")
        params = decode_params(cfg, device, seed)
    seed_t = torch.ones((), dtype=torch.float32, device=device)
    results = []
    for name, kind, headless, act8 in rows:
        fn = make_decode(cfg, headless, act_dtype)
        quant.set_act_int8(act8)
        try:
            before, plain0 = _counts(), _plain_on_cuda()
            value = float(fn(params[kind], seed_t))
            per_token = {k: (v - before[k]) / K_DECODE
                         for k, v in _counts().items()}
            rec = {"name": name, "params": kind, "headless": headless,
                   "act_int8": act8, "value": value,
                   "launches_per_token": per_token,
                   "plain_on_cuda": _plain_on_cuda() - plain0}
            if on_card:
                rec["ms_eager"] = events_ms(
                    lambda: fn(params[kind], seed_t), iters=5) / K_DECODE
                rec["ms_graph"] = graph_ms(
                    [lambda: fn(params[kind], seed_t)]) / K_DECODE
        finally:
            quant.set_act_int8(False)
        results.append(rec)
        times = (f"{rec['ms_graph']:7.3f} ms/tok graph, "
                 f"{rec['ms_eager']:7.3f} eager; " if on_card else "")
        launches = ", ".join(f"{k} {v:g}" for k, v in per_token.items() if v)
        log(f"{name:36s} {times}per token {launches}; out {value:.6g}")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--matmul", action="store_true")
    ap.add_argument("--library-int4", action="store_true")
    ap.add_argument("--decode", action="store_true")
    ap.add_argument("--modes", nargs="*", default=list(DEFAULT_MODES),
                    choices=MODES)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("int4_profile: no CUDA device (--device cpu runs the plain "
                  "versions)", file=sys.stderr)
            return 1
        log(f"device: {torch.cuda.get_device_name(device)} ({card_line()})")
    else:
        log(f"device: {device} (plain versions, no times)")
    if args.probe:
        probe(device)
    if args.matmul:
        bench_matmuls(args.modes, device)
    if args.library_int4:
        bench_library_int4(device)
    if args.decode:
        bench_decode(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
