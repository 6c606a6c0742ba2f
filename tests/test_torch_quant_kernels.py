"""The arithmetic and host plans of the quantized-weight CUDA kernels (K3/K4
int8 decode rows, K5 decode rows and tiles), held on the CPU.

The kernels run only on the card (the `gpu` tests in test_torch_kernels.py
and chip_smoke.py); what they do with bits and indices is emulated here in
numpy, instruction by instruction where it matters:
  * the int8 -> bf16 unpack of K3 (csrc/decode_rows.cuh `byte_f32` with
    `pack_bf16`): exact for all 256 byte values;
  * the mma.sync fragments of the decode rows: which weight rows and
    columns each thread pairs into its A registers, against which x
    pairs in B, and where each accumulator lands, for int4 (K5) and int8
    (K3): the emulated warp computes the exact product;
  * K5's tile dequantization (`nibbles_xor8`, `nibble_f32`, times the f32
    scale, rounded to bf16), bit for bit equal to
    dequantize_int4(...).to(torch.bfloat16);
  * the host plans (`decode_plan` for K3 and K5, `tile_plan` for K5's
    tiles) at every 7B shape and at ragged ones.
"""

import numpy as np
import pytest
import torch

from vstar_tpu_torch.kernels import int4_matmul as k4
from vstar_tpu_torch.kernels import int8_matmul as k8
from vstar_tpu_torch.nn.quant import quantize_weight_int4

U32 = np.uint32


# --- PTX instructions, on numpy uint32 arrays --------------------------------

def prmt(a, b, sel):
    """__byte_perm(a, b, sel): result byte i is byte (sel >> 4i) & 7 of
    the eight bytes of {b, a}."""
    a, b = np.asarray(a, np.uint64), np.asarray(b, np.uint64)
    both = a | (b << np.uint64(32))
    out = np.zeros(np.broadcast(a, b).shape, np.uint64)
    for i in range(4):
        src = np.uint64((sel >> (4 * i)) & 7)
        out |= ((both >> (np.uint64(8) * src)) & np.uint64(0xFF)) << np.uint64(8 * i)
    return out.astype(U32)


def f32_bits(f):
    return np.asarray(f, np.float32).view(U32)


def bits_f32(u):
    return np.asarray(u, U32).view(np.float32)


def bf16_rne(f):
    """f32 -> bf16 bits, round to nearest even (cvt.rn.bf16.f32)."""
    b = f32_bits(f).astype(np.uint64)
    return ((b + 0x7FFF + ((b >> 16) & 1)) >> 16).astype(U32)


def bf16_value(h):
    return bits_f32(np.asarray(h, U32) << U32(16))


def pack_bf16(lo, hi):
    return bf16_rne(lo) | (bf16_rne(hi) << U32(16))


def halves(v):
    v = np.asarray(v, U32)
    return bf16_value(v & U32(0xFFFF)), bf16_value(v >> U32(16))


def fma_bf16x2(v, mul, add):
    """fma.rn.bf16x2 where every operand and result is exact in bf16."""
    lo, hi = halves(v)
    return pack_bf16(lo * mul + add, hi * mul + add)


def nibbles_bf16x2(v):
    """decode_rows.cuh: signed nibbles at bits 0-3 and 16-19."""
    r = (np.asarray(v, U32) & U32(0x000F000F)) ^ U32(0x43084308)
    return fma_bf16x2(r, np.float32(1), np.float32(-136))


def byte_f32(u, k):
    """decode_rows.cuh: byte k of u (int8 bytes ^ 0x80) as f32."""
    return bits_f32(prmt(u, 0x4B000000, 0x7440 | k)) - np.float32(8388736)


def nibbles_xor8(v):
    return (np.asarray(v, U32) & U32(0x0F0F0F0F)) ^ U32(0x08080808)


def nibble_f32(u, k):
    """int4_matmul.cu: nibble k of u (nibbles ^ 8) as f32."""
    return bits_f32(prmt(u, 0x4B000000, 0x7440 | k)) - np.float32(8388616)


def words(byte_rows):
    """uint8 [..., 4n] -> little-endian uint32 [..., n]."""
    b = np.ascontiguousarray(byte_rows, np.uint8)
    return b.view("<u4").astype(U32)


# --- the int8 unpack ---------------------------------------------------------

def test_int8_magic_unpack_is_exact_for_every_byte():
    b = np.arange(-128, 128, dtype=np.int32)
    w = words(b.astype(np.int8).view(np.uint8))     # [64] words
    u = w ^ U32(0x80808080)
    got = np.stack([byte_f32(u, k) for k in range(4)], axis=1).reshape(-1)
    np.testing.assert_array_equal(got, b.astype(np.float32))
    # the pair packed for mma is the same two values in bf16
    lo, hi = halves(pack_bf16(byte_f32(u, 0), byte_f32(u, 1)))
    np.testing.assert_array_equal(lo, b[0::4].astype(np.float32))
    np.testing.assert_array_equal(hi, b[1::4].astype(np.float32))


# --- the decode rows' mma fragments -----------------------------------------

def _mma(a, b):
    """One warp's mma.sync.m16n8k16 from its registers: a [32][4], b
    [32][2] bf16x2 words; returns C [16, 8] in f64."""
    A = np.zeros((16, 16))
    B = np.zeros((16, 8))
    for lane in range(32):
        g, t4 = lane >> 2, lane & 3
        for r, (m, k) in enumerate(((g, 2 * t4), (g + 8, 2 * t4),
                                    (g, 2 * t4 + 8), (g + 8, 2 * t4 + 8))):
            A[m, k], A[m, k + 1] = halves(a[lane][r])
        for r, k in enumerate((2 * t4, 2 * t4 + 8)):
            B[k, g], B[k + 1, g] = halves(b[lane][r])
    return A @ B


def _warp_k_step(fmt, w_rows, x):
    """One warp, one k-step of 16 inputs, 8 activation rows: the output
    [8, 128] the decode-row kernel accumulates, from its weight rows
    (int4: 8 packed rows; int8: 16 rows; each [128] bytes) and x [8, 16]
    bf16 bits, emulated as decode_rows.cuh issues it."""
    bx = []
    for lane in range(32):
        g, t4 = lane >> 2, lane & 3
        xw = words(x[g].astype("<u2").view(np.uint8))     # 8 pair words
        x0, x1 = xw[t4], xw[4 + t4]                       # chunks 0 and 1
        bx.append((prmt(x0, x1, 0x5410), prmt(x0, x1, 0x7632)))
    regs = {}   # m-tile -> [32][4] A words
    for lane in range(32):
        g, t4 = lane >> 2, lane & 3
        row = lambda r: words(w_rows[r][16 * g:16 * g + 16])   # noqa: E731
        for j in range(4):
            if fmt == "int4":
                wa, wb = row(t4)[j], row(4 + t4)[j]
                for h, sel in enumerate((0x5410, 0x7632)):
                    v = prmt(wa, wb, sel)
                    regs.setdefault(2 * j + h, []).append(
                        [nibbles_bf16x2(v), nibbles_bf16x2(v >> U32(8)),
                         nibbles_bf16x2(v >> U32(4)), nibbles_bf16x2(v >> U32(12))])
                continue
            A, B = row(2 * t4)[j], row(8 + 2 * t4)[j]
            C, D = row(2 * t4 + 1)[j], row(9 + 2 * t4)[j]
            for h in range(2):
                ua, ub, uc, ud = (v ^ U32(0x80808080) for v in (A, B, C, D))
                regs.setdefault(2 * j + h, []).append([
                    pack_bf16(byte_f32(ua, 2 * h), byte_f32(ub, 2 * h)),
                    pack_bf16(byte_f32(ua, 2 * h + 1), byte_f32(ub, 2 * h + 1)),
                    pack_bf16(byte_f32(uc, 2 * h), byte_f32(ud, 2 * h)),
                    pack_bf16(byte_f32(uc, 2 * h + 1), byte_f32(ud, 2 * h + 1))])
    y = np.zeros((8, 128))
    for t, a in regs.items():
        c = _mma(a, bx)                       # [16 M rows, 8 activation rows]
        for m in range(16):                   # M row m of tile t: column
            y[:, 16 * (m % 8) + 2 * t + m // 8] += c[m]
    return y


@pytest.mark.parametrize("fmt", ["int4", "int8"])
def test_decode_row_fragments_compute_the_product(fmt):
    rng = np.random.RandomState(7)
    x = bf16_rne(rng.randn(8, 16).astype(np.float32))
    xf = bf16_value(x).astype(np.float64)
    if fmt == "int4":
        q = rng.randint(0, 256, size=(8, 128)).astype(np.uint8)
        nib = ((q.astype(np.int32)[:, None, :] >> np.array([0, 4])[None, :, None]) & 15)
        w = ((nib ^ 8) - 8).reshape(16, 128)    # inputs 2p (lo), 2p + 1 (hi)
    else:
        w8 = rng.randint(-128, 128, size=(16, 128)).astype(np.int8)
        q, w = w8.view(np.uint8), w8.astype(np.int32)
    got = _warp_k_step(fmt, q, x)
    np.testing.assert_array_equal(got, xf @ w)


# --- K5's tile dequantization ------------------------------------------------

@pytest.mark.parametrize("IN,OUT,group", [(256, 96, 64), (512, 40, 128),
                                          (128, 33, 128)])
def test_tile_dequant_equals_dequantize_int4_in_bf16(IN, OUT, group):
    rng = np.random.RandomState(IN + OUT)
    w = torch.from_numpy(rng.randn(IN, OUT).astype(np.float32) * 0.05)
    e = quantize_weight_int4(w, group)
    # scales across the f32 range the weights of a model take
    s4 = e["s4"] * torch.from_numpy(
        np.exp2(rng.randint(-20, 20, size=e["s4"].shape)).astype(np.float32))
    q4 = e["q4"].numpy()
    want = k4.dequantize_int4(e["q4"], s4).to(torch.bfloat16)
    want = want.view(torch.int16).numpy().astype(np.int64) & 0xFFFF
    # a thread's 8 columns of a packed row: two words, low and high nibbles
    pad = (-OUT) % 4
    qw = words(np.pad(q4, ((0, 0), (0, pad))))            # [IN/2, ceil(OUT/4)]
    s = np.repeat(s4.numpy(), group // 2, axis=0)          # [IN/2, OUT]
    got = np.zeros((IN, OUT), np.int64)
    for h, shift in ((0, 0), (1, 4)):                      # rows 2p, 2p + 1
        u = nibbles_xor8(qw >> U32(shift))
        vals = np.stack([nibble_f32(u, k) for k in range(4)], axis=-1)
        vals = vals.reshape(IN // 2, -1)[:, :OUT]
        got[h::2] = bf16_rne(vals * s)                     # f32 product, RNE
    np.testing.assert_array_equal(got, want)


# --- host plans --------------------------------------------------------------

SHAPES_7B = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32003),
             (4096, 32000)]
RAGGED = [(100, 300), (40, 64), (11008, 512), (4104, 1000), (33, 17)]


def _split_ranges(units, splits):
    per = -(-units // splits)
    return [(min(units, s * per), min(units, s * per + per)) for s in range(splits)]


@pytest.mark.parametrize("IN,OUT", SHAPES_7B + RAGGED)
@pytest.mark.parametrize("resident", [132, 264, 396, 528])
def test_k3_plan_covers_every_input_and_column_once(IN, OUT, resident):
    units = -(-IN // k8.K3_STAGE_ROWS)
    c = k8.k3_plan(IN, OUT, resident)
    cols = k8.DECODE_COLS * k8.K3_WARP_COLS
    strips = -(-OUT // cols)
    assert c in (1, 2, 4, 8, 16) and c <= k8.K3_MAX_CLUSTER
    assert c == 1 or strips * c <= resident          # one wave
    covered = np.zeros(IN, np.int32)
    for u0, u1 in _split_ranges(units, k8.K3_SPLITS * c):
        lo, hi = u0 * k8.K3_STAGE_ROWS, min(IN, u1 * k8.K3_STAGE_ROWS)
        covered[lo:hi] += 1
    assert (covered == 1).all()
    col_cover = np.zeros(OUT, np.int32)
    for st in range(strips):
        col_cover[st * cols:(st + 1) * cols] += 1
    assert (col_cover == 1).all()
    # the largest power of two the limits let it be
    limit = min(k8.K3_MAX_CLUSTER, max(1, resident // strips),
                -(-units // k8.K3_SPLITS))
    assert c <= limit < 2 * c


@pytest.mark.parametrize("rows", [17, 33, 64, 128, 129, 300, 384, 768])
@pytest.mark.parametrize("IN,OUT", SHAPES_7B + [(128, 1000), (256, 40)])
@pytest.mark.parametrize("slots_per_sm", [1, 2])
def test_tile_plan_covers_the_product_once(rows, IN, OUT, slots_per_sm):
    k_tiles = IN // k4.TILE_K
    tile, ks = k4.tile_plan(rows, OUT, k_tiles, 132, lambda t, k: slots_per_sm)
    bm, bn = k4.TILE_SHAPES[tile]
    assert (bm, bn) == ((64, 128) if rows <= 128 else (128, 256))
    assert ks in k4.TILE_SPLITS and (ks == 1 or k_tiles >= 4 * ks)
    covered = np.zeros(k_tiles, np.int32)
    for a, b in _split_ranges(k_tiles, ks):
        assert b > a                                   # no empty k-split
        covered[a:b] += 1
    assert (covered == 1).all()
    tiles = -(-rows // bm) * -(-OUT // bn)
    assert -(-rows // bm) * bm >= rows and -(-OUT // bn) * bn >= OUT
    # one wave with the splits, or no splits
    assert ks == 1 or tiles * ks <= 132 * slots_per_sm
    assert ks == k4.TILE_SPLITS[-1] or 2 * ks * tiles > 132 * slots_per_sm \
        or k_tiles < 8 * ks


def test_decode_plans_of_k3_and_k5_are_one_rule():
    for args in [(32, 11008, 264), (86, 4096, 396), (1, 512, 264)]:
        assert k4.decode_plan(*args) == k8.decode_plan(*args, splits=4)
    assert k4.DECODE_COLS == k8.DECODE_COLS == 128


def test_wrappers_keep_cpu_tensors_on_the_plain_versions():
    before = (k8.launches, dict(k4.launches), dict(k4.route_launches))
    x = torch.randn(3, 100)
    q = torch.randint(-127, 128, (100, 30), dtype=torch.int8)
    s = torch.rand(1, 30)
    torch.testing.assert_close(k8.int8_matmul(x, q, s),
                               (x @ (q.float() * s)), rtol=0, atol=0)
    e = quantize_weight_int4(torch.randn(128, 24), 64)
    k4.int4_matmul(torch.randn(20, 128), e["q4"], e["s4"])
    assert (k8.launches, dict(k4.launches), dict(k4.route_launches)) == before
