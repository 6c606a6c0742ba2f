"""The port's int4 profile (vstar_tpu_torch/scripts/int4_profile.py and its
kernels P1-P4, kernels/int4_variants.py) on the CPU against the JAX
package's scripts/int4_profile.py, whose Pallas kernels run in interpret
mode (pltpu.force_tpu_interpret_mode). The script is loaded from its file
(importing it has no side effects). Inputs come from numpy with fixed
seeds; shapes are small.

  * P1: the port's --probe prints JAX probe_mosaic's lines; the plain
    versions give want_lo's bytes;
  * P2, P4: the plain versions are bit-equal to `_w4a8_call(kernel, ...)`
    (every unpack, block_o 256 and 512) and `_w4a8_call_t`;
  * P3: bit-equal to `_w4a8_call_rows` (explicit block_i of 2-4 blocks and
    the default heuristic), and within 1e-5 of the largest |output| of K6's
    plain version (the block order is another f32 order);
  * K6's, P2's and P4's tensor-core arithmetic (csrc/decode_rows.cuh,
    formats W4A8 and W4A8T): a warp's s8 mma fragments emulated in numpy,
    instruction by instruction (K6: the 4 x 4 byte transpose, then the two
    masks; P2: the same with each low-nibble unpack, 2and and off with
    their own low accumulator and off's sums of x; P4: the two masks on
    the words of one output's row), give the exact int32 group dots of
    `_w4a8_kernel`, `_w4a8_kernel_mul / _2and / _off` and `_w4a8_kernel_t`
    bit for bit, over the permuted input order of their B fragments; P3's
    blocking (whole row blocks a k-split, block order, then rank order)
    gives `_w4a8_kernel_rows`' group dots and holds its output to 1e-5;
  * the wrappers' domain checks;
  * the decode ablation at a tiny width (all eight rows) against JAX
    make_decode on the same weights, act-int8 off and on, to 1e-5 (f32;
    rows with int8 activations to 1e-2 of the value, ACT8_REL_TOL); and
    its W4A8 rows at a vocab that 128 does not divide, where JAX's W4A8
    kernel declines the int4 lm_head: qdot takes it W4A16 (one call a
    token) and the layers W4A8 (7 a layer).
"""

import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vstar_tpu.core.config import vsm_tiny as jax_vsm_tiny
from vstar_tpu.kernels import int4_matmul as jk4
from vstar_tpu.nn import quant as jq
from vstar_tpu.nn.llama import init_llama_params as jax_init_llama
from vstar_tpu_torch.core.config import vsm_tiny
from vstar_tpu_torch.core.convert import from_numpy_tree
from vstar_tpu_torch.kernels import int4_matmul as k4
from vstar_tpu_torch.kernels import int4_variants as kv
from vstar_tpu_torch.nn import quant as tq
from vstar_tpu_torch.scripts import int4_profile as ip

torch.set_num_threads(1)

F32_TOL = 1e-5
# act-int8 decode rows: the per-row int8 activations round xf / sx, and
# where JAX's and the port's f32 sums differ in the last bit a value on a
# rounding boundary lands one step apart, which later tokens carry (the
# int8-layers row moves 8e-5 at the 8th token, 0.8 % of its value, after
# agreeing to 6e-9 for 4 tokens); 1e-2 of the value, as test_torch_quant's
# bf16 tolerance
ACT8_REL_TOL = 1e-2

_SPEC = importlib.util.spec_from_file_location(
    "jax_int4_profile", pathlib.Path(__file__).resolve().parent.parent
    / "scripts" / "int4_profile.py")
jip = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(jip)

JAX_KERNELS = {"ship": jk4._w4a8_kernel, "mul": jip._w4a8_kernel_mul,
               "2and": jip._w4a8_kernel_2and, "off": jip._w4a8_kernel_off}
SHAPES = [(1, 512, 512), (3, 1024, 768), (8, 1024, 512)]


def t(x):
    return torch.from_numpy(np.array(x))


def _inputs(R, IN, OUT, seed):
    rng = np.random.RandomState(seed)
    e = jq.quantize_weight_int4_np(rng.randn(IN, OUT).astype(np.float32)
                                   * 0.05)
    xq = rng.randint(-127, 128, size=(R, IN)).astype(np.int8)
    return xq, e["q4"], e["s4"]


# ---------------------------------------------------------------------------
# P1
# ---------------------------------------------------------------------------

def test_probe_prints_jax_lines_and_want_lo(capsys):
    with pltpu.force_tpu_interpret_mode():
        jip.probe_mosaic()
    want = [x for x in capsys.readouterr().out.splitlines()
            if x.startswith("probe")]
    results = ip.probe("cpu")
    got = [x for x in capsys.readouterr().out.splitlines()
           if x.startswith("probe")]
    assert len(want) == 2 and all("correct=True" in x for x in want)
    assert got == want
    assert all(r["correct"] for r in results.values())
    q = t(np.random.RandomState(0).randint(0, 256, (64, 96)).astype(np.uint8))
    expect = ((q.numpy().astype(np.int32) << 4) & 0xF0).astype(np.int8)
    for how in kv.PROBES:
        np.testing.assert_array_equal(kv.unpack_probe(q, how).numpy(), expect)
    np.testing.assert_array_equal(kv.want_lo(q).numpy(), expect)


# ---------------------------------------------------------------------------
# P2, P4
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block_o", [256, 512])
@pytest.mark.parametrize("R,IN,OUT", SHAPES)
@pytest.mark.parametrize("unpack", kv.UNPACKS)
def test_w4a8_variant_bit_equal_to_jax(unpack, R, IN, OUT, block_o):
    if OUT % block_o:
        with pytest.raises(ValueError, match="block_o"):
            kv.w4a8_variant(*map(t, _inputs(R, IN, OUT, 0)), unpack, block_o)
        return
    xq, q4, s4 = _inputs(R, IN, OUT, R + IN + OUT)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jip._w4a8_call(JAX_KERNELS[unpack], jnp.asarray(xq),
                                         jnp.asarray(q4), jnp.asarray(s4),
                                         block_o))
    got = kv.w4a8_variant(t(xq), t(q4), t(s4), unpack, block_o).numpy()
    assert got.dtype == np.float32 and got.shape == (R, OUT)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("block_o", [256, 512])
@pytest.mark.parametrize("R,IN,OUT", SHAPES)
def test_w4a8_t_bit_equal_to_jax(R, IN, OUT, block_o):
    xq, q4, s4 = _inputs(R, IN, OUT, 7 * R + OUT)
    q4t, s4t = np.ascontiguousarray(q4.T), np.ascontiguousarray(s4.T)
    if OUT % block_o:
        with pytest.raises(ValueError, match="block_o"):
            kv.w4a8_t(t(xq), t(q4t), t(s4t), block_o)
        return
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jip._w4a8_call_t(jnp.asarray(xq), jnp.asarray(q4t),
                                           jnp.asarray(s4t), block_o))
    got = kv.w4a8_t(t(xq), t(q4t), t(s4t), block_o).numpy()
    assert got.shape == (R, OUT)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# P3
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("R,IN,OUT,block_i,blocks", [
    (3, 1024, 768, 128, 4), (3, 1024, 768, 256, 2), (8, 1024, 512, 256, 2),
    (1, 512, 512, 64, 4), (2, 4096, 512, None, 2)])
def test_w4a8_rows_bit_equal_to_jax(R, IN, OUT, block_i, blocks):
    xq, q4, s4 = _inputs(R, IN, OUT, 3 * R + IN)
    assert IN // 2 // kv._block_i(IN // 2, OUT, s4.shape[0], block_i) == blocks
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jip._w4a8_call_rows(jnp.asarray(xq), jnp.asarray(q4),
                                              jnp.asarray(s4), block_i))
    got = kv.w4a8_rows(t(xq), t(q4), t(s4), block_i).numpy()
    np.testing.assert_array_equal(got, want)
    k6 = k4.int4_matmul_w4a8_reference(t(xq), t(q4), t(s4)).numpy()
    assert np.abs(got - k6).max() <= F32_TOL * np.abs(k6).max()


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

# --- K6's and P4's m16n8k32 fragments, emulated ----------------------------

U32 = np.uint32


def _prmt(a, b, sel):
    """__byte_perm(a, b, sel) on uint32 scalars."""
    both = int(a) | (int(b) << 32)
    return U32(sum(((both >> (8 * ((sel >> (4 * i)) & 7))) & 0xFF) << (8 * i)
                   for i in range(4)))


def _lo16(w):
    return U32((int(w) << 4) & 0xF0F0F0F0)


def _hi16(w):
    return U32(int(w) & 0xF0F0F0F0)


def _s8(w):
    """The four bytes of a word as int8, lowest first."""
    return np.array([int(w)], "<u4").view(np.int8).astype(np.int64)


def _word(byte_row, k):
    """Little-endian word k of a uint8 row."""
    return U32(np.ascontiguousarray(byte_row[4 * k:4 * k + 4]).view("<u4")[0])


def _mma_s8(a, b):
    """mma.sync.m16n8k32.row.col.s32.s8.s8.s32 from a warp's registers:
    a [32][4], b [32][2] words; C [16, 8] (exact)."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for lane in range(32):
        g, t4 = lane >> 2, lane & 3
        for r, (m, k) in enumerate(((g, 4 * t4), (g + 8, 4 * t4),
                                    (g, 16 + 4 * t4), (g + 8, 16 + 4 * t4))):
            A[m, k:k + 4] = _s8(a[lane][r])
        for r, k in enumerate((4 * t4, 16 + 4 * t4)):
            B[k:k + 4, g] = _s8(b[lane][r])
    return A @ B


def _u8(w):
    """The four bytes of a word as uint8, lowest first."""
    return np.array([int(w)], "<u4").view(np.uint8).astype(np.int64)


def _mma_s8_k16(a, b, a_type=_s8):
    """mma.sync.m16n8k16.row.col.s32.s8.s8.s32 (a_type _u8: .u8.s8): a
    [32][2] words (rows g, g + 8 at k-slots 4t4 ..), b [32] words (k-slots
    4t4 .. of column g); C [16, 8] (exact)."""
    A = np.zeros((16, 16), np.int64)
    B = np.zeros((16, 8), np.int64)
    for lane in range(32):
        g, t4 = lane >> 2, lane & 3
        A[g, 4 * t4:4 * t4 + 4] = a_type(a[lane][0])
        A[g + 8, 4 * t4:4 * t4 + 4] = a_type(a[lane][1])
        B[4 * t4:4 * t4 + 4, g] = _s8(b[lane])
    return A @ B


def _mul16(w):
    """P2 mul's unpack: each byte as int8 times 16, wrapped to a byte."""
    return U32(sum(((int(b) * 16) & 0xFF) << (8 * i)
                   for i, b in enumerate(_s8(w))))


def _off16(w):
    """off's unpack, (b ^ 8) & 0xF = lo + 8, times 16 in its byte (a uint8
    A operand)."""
    return U32(((int(w) ^ 0x08080808) & 0x0F0F0F0F) << 4)


def _and16(w, mask):
    """One of 2and's masks (7 or 8 a byte), times 16 in its byte: 16 (b &
    8) is 0x80, -128 as int8."""
    return U32((int(w) & mask) << 4)


def _warp_group_dots(layout, q, xq, unpack="ship"):
    """One warp, one group of 128 inputs, 8 activation rows: the int32
    dots [8, 128] that the W4A8 decode rows sum, from their fragments.
    q4: q uint8 [64 packed rows, 128 columns], with P2's low-nibble
    `unpack`, all into one accumulator (ship and mul: one m16n8k32 a
    k-step; 2and: 16 (b & 7) beside the high nibbles on that m16n8k32 and
    16 (b & 8) on an m16n8k16 against the even inputs; off: 16 (lo + 8) as
    uint8 on an m16n8k16 against the even inputs, the high nibbles on one
    against the odd inputs, its sum(xe) from an m16n8k16 of A = 1, and
    128 sum(xe) subtracted at the group's end); q4t: q uint8 [128
    outputs, 64 packed bytes], read as two ring stages of 32 bytes; xq
    int8 [8, 128]."""
    xb = xq.view(np.uint8)
    y = np.zeros((8, 128), np.int64)
    if layout == "q4":
        d = {t: np.zeros((16, 8), np.int64) for t in range(8)}
        xsum = np.zeros((16, 8), np.int64)
        for ks in range(4):                      # k-steps of 32 inputs
            bx = []
            for lane in range(32):
                g, t4 = lane >> 2, lane & 3
                off = 32 * ks + 8 * t4
                x0, x1 = _word(xb[g], off // 4), _word(xb[g], off // 4 + 1)
                bx.append((_prmt(x0, x1, 0x6420), _prmt(x0, x1, 0x7531)))
            regs = {}
            for lane in range(32):
                g, t4 = lane >> 2, lane & 3
                for j in range(4):
                    w = [_word(q[16 * ks + 4 * t4 + i, 16 * g:16 * g + 16], j)
                         for i in range(4)]
                    t0, t1 = _prmt(w[0], w[1], 0x5140), _prmt(w[0], w[1], 0x7362)
                    t2, t3 = _prmt(w[2], w[3], 0x5140), _prmt(w[2], w[3], 0x7362)
                    c = [_prmt(t0, t2, 0x5410), _prmt(t0, t2, 0x7632),
                         _prmt(t1, t3, 0x5410), _prmt(t1, t3, 0x7632)]
                    for h in range(2):
                        regs.setdefault(2 * j + h, []).append(
                            (c[2 * h], c[2 * h + 1]))
            even, odd = [b[0] for b in bx], [b[1] for b in bx]
            for t, cs in regs.items():
                if unpack in ("ship", "mul"):
                    lo = _lo16 if unpack == "ship" else _mul16
                    d[t] += _mma_s8([[lo(ca), lo(cb), _hi16(ca), _hi16(cb)]
                                     for ca, cb in cs], bx)
                elif unpack == "2and":
                    d[t] += _mma_s8([[_and16(ca, 0x07070707),
                                      _and16(cb, 0x07070707), _hi16(ca),
                                      _hi16(cb)] for ca, cb in cs], bx)
                    d[t] += _mma_s8_k16([[_and16(ca, 0x08080808),
                                          _and16(cb, 0x08080808)]
                                         for ca, cb in cs], even)
                else:
                    d[t] += _mma_s8_k16([[_off16(ca), _off16(cb)]
                                         for ca, cb in cs], even, _u8)
                    d[t] += _mma_s8_k16([[_hi16(ca), _hi16(cb)]
                                         for ca, cb in cs], odd)
            if unpack == "off":
                xsum += _mma_s8_k16([[U32(0x01010101)] * 2] * 32, even)
        for t in range(8):
            cm = d[t] - (128 * xsum if unpack == "off" else 0)
            for m in range(16):                  # M row m: column 16g + 2t (+ 1)
                y[:, 16 * (m % 8) + 2 * t + m // 8] += cm[m]
        return y
    for st in range(2):                          # ring stages of 32 bytes
        stage = q[:, 32 * st:32 * st + 32]
        for ks in range(2):
            bx = []
            for lane in range(32):
                g, t4 = lane >> 2, lane & 3
                off = 64 * st + 8 * (2 * t4 + ks)
                x0, x1 = _word(xb[g], off // 4), _word(xb[g], off // 4 + 1)
                bx.append((_prmt(x0, x1, 0x6420), _prmt(x0, x1, 0x7531)))
            for t in range(8):
                a = []
                for lane in range(32):
                    g, t4 = lane >> 2, lane & 3
                    wa = _word(stage[16 * t + g], 2 * t4 + ks)
                    wb = _word(stage[16 * t + 8 + g], 2 * t4 + ks)
                    a.append([_lo16(wa), _lo16(wb), _hi16(wa), _hi16(wb)])
                cm = _mma_s8(a, bx)
                y[:, 16 * t:16 * t + 16] += cm.T     # M row m: output 16t + m
    return y


@pytest.mark.parametrize("layout", ["q4", "q4t", "mul", "2and", "off"])
@pytest.mark.parametrize("group", [0, 1])
def test_w4a8_fragments_give_the_kernels_group_dots(layout, group):
    """K6's and P4's fragments, and P2's unpacks (layouts mul, 2and, off:
    q4 with that low-nibble unpack), against the JAX kernel of each."""
    rng = np.random.RandomState(11 + group)
    R, IN, OUT = 8, 256, 128
    q4 = rng.randint(0, 256, size=(IN // 2, OUT)).astype(np.uint8)
    # -128 too: x is never negated (2and's -128 is the weights' 16 (b & 8))
    xq = rng.randint(-128, 128, size=(R, IN)).astype(np.int8)
    # s4 / 16 = 1 on this group, 0 on the other: the kernels' f32 output is
    # the group's int32 dot, exactly
    s4 = np.zeros((2, OUT), np.float32)
    s4[group] = 16.0
    with pltpu.force_tpu_interpret_mode():
        if layout == "q4":
            want = jk4.int4_matmul_w4a8(jnp.asarray(xq), jnp.asarray(q4),
                                        jnp.asarray(s4), interpret=True)
        elif layout == "q4t":
            want = jip._w4a8_call_t(jnp.asarray(xq),
                                    jnp.asarray(np.ascontiguousarray(q4.T)),
                                    jnp.asarray(np.ascontiguousarray(s4.T)),
                                    block_o=OUT)
        else:
            want = jip._w4a8_call(JAX_KERNELS[layout], jnp.asarray(xq),
                                  jnp.asarray(q4), jnp.asarray(s4),
                                  block_o=OUT)
    rows = slice(64 * group, 64 * group + 64)
    q = np.ascontiguousarray(q4[rows].T) if layout == "q4t" else q4[rows]
    got = _warp_group_dots("q4t" if layout == "q4t" else "q4", q,
                           np.ascontiguousarray(
                               xq[:, 128 * group:128 * group + 128]),
                           "ship" if layout in ("q4", "q4t") else layout)
    np.testing.assert_array_equal(got.astype(np.float32), np.asarray(want))
    # and the exact dot of x with the nibbles, times 16
    nib = k4.unpack_int4(torch.from_numpy(q4[rows])).numpy().astype(np.int64)
    np.testing.assert_array_equal(
        got, 16 * xq[:, 128 * group:128 * group + 128].astype(np.int64) @ nib)


def _p3_emulate(xq, q4, s4, block_i, splits):
    """P3's decode rows in numpy: each 128-column slice's group dots from
    its warp fragments; the k-splits take whole blocks of block_i packed
    rows (`per` groups each, as launch_decode plans them), a split sums a
    block's groups as fmaf(d, s4 / 16, acc) in f32 and adds the block's
    sum to its total, and the splits' totals are added in rank order.
    Returns (the group dots [NG, R, OUT], the f32 output [R, OUT])."""
    R, IN = xq.shape
    OUT = q4.shape[1]
    NG = s4.shape[0]
    gh = IN // 2 // NG
    blk = block_i // gh
    per = blk * -(-(NG // blk) // splits)
    dots = np.zeros((NG, R, OUT), np.int64)
    xp = np.zeros((8, IN), np.int8)
    xp[:R] = xq
    for gi in range(NG):
        for c in range(0, OUT, 128):
            dots[gi, :, c:c + 128] = _warp_group_dots(
                "q4", q4[gh * gi:gh * gi + gh, c:c + 128],
                np.ascontiguousarray(xp[:, 2 * gh * gi:2 * gh * (gi + 1)]))[:R]
    sc = (s4 * np.float32(1 / 16)).astype(np.float32)
    out = np.zeros((R, OUT), np.float32)
    for rank in range(splits):
        total = np.zeros((R, OUT), np.float32)
        acc = np.zeros((R, OUT), np.float32)
        for gi in range(min(NG, rank * per), min(NG, rank * per + per)):
            # fmaf: the exact product (< 2^48) plus acc, rounded once (the
            # f64 sum is exact here: every term is a multiple of 2^-24 and
            # far below 2^29)
            acc = (dots[gi].astype(np.float64) * sc[gi].astype(np.float64)
                   + acc.astype(np.float64)).astype(np.float32)
            if (gi + 1) % blk == 0:
                total = total + acc
                acc = np.zeros_like(acc)
        out = out + total
    return dots, out


@pytest.mark.parametrize("R,IN,OUT,block_i,splits", [
    (3, 1024, 256, 128, 2), (8, 1024, 128, 64, 3), (1, 512, 384, 256, 1)])
def test_w4a8_rows_blocking_gives_the_kernels_group_dots(R, IN, OUT, block_i,
                                                         splits):
    """P3's group dots (K6's fragments) equal `_w4a8_kernel_rows`'s, group
    by group, and its blocked f32 sums (whole blocks a k-split, block order
    inside a split, rank order across) hold the JAX kernel to 1e-5 of the
    largest |output|."""
    xq, q4, s4 = _inputs(R, IN, OUT, 5 * R + OUT)
    NG = s4.shape[0]
    dots, out = _p3_emulate(xq, q4, s4, block_i, splits)
    with pltpu.force_tpu_interpret_mode():
        for gi in range(NG):
            one = np.zeros_like(s4)
            one[gi] = 16.0
            want = np.asarray(jip._w4a8_call_rows(
                jnp.asarray(xq), jnp.asarray(q4), jnp.asarray(one), block_i))
            np.testing.assert_array_equal(dots[gi].astype(np.float32), want)
        want = np.asarray(jip._w4a8_call_rows(
            jnp.asarray(xq), jnp.asarray(q4), jnp.asarray(s4), block_i))
    assert np.abs(out - want).max() <= F32_TOL * np.abs(want).max()


def test_wrappers_check_their_domain_and_take_plain_version_on_cpu():
    xq, q4, s4 = map(t, _inputs(2, 512, 768, 1))
    before = (dict(kv.launches), dict(kv.plain_calls_cuda))
    kv.w4a8_variant(xq, q4, s4, "off", 256)
    kv.w4a8_rows(xq, q4, s4)
    kv.w4a8_t(xq, q4.t().contiguous(), s4.t().contiguous(), 256)
    kv.unpack_probe(q4, "add")
    assert (kv.launches, kv.plain_calls_cuda) == before
    with pytest.raises(ValueError, match="block_o"):       # 768 % 512
        kv.w4a8_variant(xq, q4, s4, "ship", 512)
    with pytest.raises(ValueError, match="block_o"):
        kv.w4a8_variant(xq, q4, s4, "ship", 128)
    with pytest.raises(ValueError, match="block_o"):
        kv.w4a8_t(xq, q4.t().contiguous(), s4.t().contiguous(), 512)
    big = t(np.zeros((17, 512), np.int8))
    for call in (lambda: kv.w4a8_variant(big, q4, s4),
                 lambda: kv.w4a8_rows(big, q4, s4),
                 lambda: kv.w4a8_t(big, q4.t(), s4.t())):
        with pytest.raises(ValueError, match="xq must be"):
            call()
    with pytest.raises(ValueError, match="block_i"):
        kv.w4a8_rows(xq, q4, s4, block_i=96)
    with pytest.raises(ValueError, match="unpack"):
        kv.w4a8_variant(xq, q4, s4, "shift")
    with pytest.raises(ValueError, match="how"):
        kv.unpack_probe(q4, "shift")
    with pytest.raises(ValueError, match="unsupported device"):
        kv.w4a8_variant(xq.to("meta"), q4.to("meta"), s4.to("meta"))
    # the decode rows' domain on CUDA (_check_cuda, called directly here):
    # a group of 64 inputs, IN % 32 != 0, q4 or s4 off 16 bytes; the CPU
    # path keeps the JAX domain and takes those shapes
    x64, q64, s64 = map(t, _inputs(2, 512, 768, 2))
    s64 = s64.repeat_interleave(2, dim=0).contiguous()     # groups of 64
    assert kv.w4a8_variant(x64, q64, s64, "2and").shape == (2, 768)
    assert kv.w4a8_rows(x64, q64, s64, block_i=32).shape == (2, 768)
    with pytest.raises(ValueError, match="multiple of 128"):
        kv._check_cuda("w4a8_variant", x64, q64, s64, (256, 768), (8, 768),
                       64)
    x48, q48 = t(np.zeros((1, 48), np.int8)), t(np.zeros((24, 768), np.uint8))
    s48 = t(np.ones((1, 768), np.float32))
    assert kv.w4a8_variant(x48, q48, s48, "off").shape == (1, 768)
    with pytest.raises(ValueError, match="of 32"):
        kv._check_cuda("w4a8_rows", x48, q48, s48, (24, 768), (1, 768), 48)
    base = t(np.zeros(256 * 768 + 4, np.uint8))
    with pytest.raises(ValueError, match="16-byte aligned"):
        kv._check_cuda("w4a8_variant", xq, base[4:].view(256, 768), s4,
                       (256, 768), (4, 768), 128)
    odd = t(np.zeros(4 * 768 + 1, np.float32))[1:].view(4, 768)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kv._check_cuda("w4a8_rows", xq, q4, odd, (256, 768), (4, 768), 128)
    xoff = t(np.zeros(2 * 512 + 8, np.int8))[8:].view(2, 512)
    assert kv._check_cuda("w4a8_t", xoff, q4.t().contiguous(),
                          s4.t().contiguous(), (768, 256), (768, 4),
                          128).data_ptr() % 16 == 0      # cloned
    assert kv.default_block_i(2048, 512, 32) == 1024      # IN 4096, OUT 512
    assert kv.default_block_i(5504, 4096, 86) == 128      # 11008 x 4096
    assert ip._variant("w4a8_bo512") == ("ship", 512)
    assert ip._variant("w4a8_2and") == ("2and", 256)
    assert ip._variant("w4a8_off_bo512") == ("off", 512)


def test_matmul_stage_runs_every_mode_on_cpu():
    res = ip.bench_matmuls(ip.MODES, "cpu", shapes=((512, 512, 2),
                                                    (1024, 768, 2)))
    assert len(res) == 2 * len(ip.MODES) - 5   # the five 512s skip 768
    assert all(r["err_vs_k6"] <= F32_TOL for r in res.values()
               if "err_vs_k6" in r)


# ---------------------------------------------------------------------------
# The decode ablation against JAX make_decode
# ---------------------------------------------------------------------------

def _tiny(cfg):
    """The tiny decoder widened so that W4A8 applies (IN % 256 == 0) and
    JAX's W4A8 kernel takes the lm_head (OUT % 128 == 0)."""
    return dataclasses.replace(cfg, hidden_size=256, intermediate_size=512,
                               vocab_size=512, num_heads=4, num_kv_heads=4,
                               head_dim=64)


def _jax_qdot4_w4a8(x, entry):
    """vstar_tpu qdot4_w4a8 with its Pallas kernel in interpret mode (the
    JAX package sends W4A8 to the kernel on a TPU only)."""
    q4, s4 = entry["q4"], entry["s4"]
    lead, IN = x.shape[:-1], x.shape[-1]
    rows = int(np.prod(lead))
    if rows > 16 or IN % 256:
        return None
    xf = x.reshape(rows, IN).astype(jnp.float32)
    sx = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True),
                     1e-8) / 127.0
    xq = jnp.clip(jnp.round(xf / sx), -127, 127).astype(jnp.int8)
    y = jk4.int4_matmul_w4a8(xq, q4, s4.astype(jnp.float32), interpret=True)
    if y is None:
        return None
    return (y * sx).astype(x.dtype).reshape(*lead, q4.shape[1])


@pytest.fixture(scope="module")
def decoders():
    jcfg = _tiny(jax_vsm_tiny().llama)
    key = jax.random.PRNGKey(3)
    host = {k: jax.device_get(jax_init_llama(key, jcfg, jnp.bfloat16,
                                             quantize=q))
            for k, q in (("int8", True), ("int4", "int4"), ("bf16", False))}
    host["int4_head8"] = dict(host["int4"], lm_head=host["int8"]["lm_head"])
    host["int8_head4"] = dict(host["int8"], lm_head=host["int4"]["lm_head"])
    return jcfg, host


def _decode_row(jcfg, host, cfg, row, monkeypatch):
    """(the port's record, JAX make_decode's value) of one decode row."""
    name, kind, headless, act8 = row
    monkeypatch.setattr(jk4, "qdot4_w4a8", _jax_qdot4_w4a8)
    jq.set_act_int8(act8)
    try:
        want = float(jip.make_decode(jcfg, headless)(
            jax.tree_util.tree_map(jnp.asarray, host[kind]),
            jnp.float32(1.0)))
    finally:
        jq.set_act_int8(False)
    rec, = ip.bench_decode("cpu", cfg=cfg,
                           params={kind: from_numpy_tree(host[kind], "cpu")},
                           act_dtype=torch.float32, rows=[row])
    assert rec["plain_on_cuda"] == 0
    tol = ACT8_REL_TOL * abs(want) if act8 else F32_TOL
    assert abs(rec["value"] - want) <= tol, (name, rec["value"], want)
    assert not tq._ACT_INT8
    return rec, want


@pytest.mark.parametrize("row", ip.DECODE_ROWS, ids=lambda r: r[1] + (
    "_headless" if r[2] else "") + ("_act8" if r[3] else ""))
def test_decode_row_matches_jax(decoders, row, monkeypatch):
    name, kind, headless, act8 = row
    jcfg, host = decoders
    rec, _ = _decode_row(jcfg, host, _tiny(vsm_tiny().llama), row,
                         monkeypatch)
    if act8 and kind != "int4":
        # the int8 matrices take _w8a8_dot under act-int8
        assert rec["launches_per_token"]["_w8a8_dot"] == \
            (1 if kind == "int4_head8" else 14)


RAGGED_VOCAB = 500      # no multiple of 128 (the 7B lm_head: 32003)


@pytest.fixture(scope="module")
def ragged_decoders():
    jcfg = dataclasses.replace(_tiny(jax_vsm_tiny().llama),
                               vocab_size=RAGGED_VOCAB)
    key = jax.random.PRNGKey(3)      # the decoders fixture's
    host = {k: jax.device_get(jax_init_llama(key, jcfg, jnp.bfloat16,
                                             quantize=q))
            for k, q in (("int8", True), ("int4", "int4"))}
    host["int8_head4"] = dict(host["int8"], lm_head=host["int4"]["lm_head"])
    return jcfg, host


@pytest.mark.parametrize("row", [r for r in ip.DECODE_ROWS
                                 if r[3] and r[1] in ("int4", "int8_head4")],
                         ids=lambda r: r[1] + ("_headless" if r[2] else ""))
def test_decode_row_ragged_vocab_takes_w4a16_for_the_head(ragged_decoders,
                                                          row, monkeypatch):
    """The W4A8 rows with an int4 lm_head at a vocab of 500: the values
    match JAX make_decode, whose W4A8 kernel declines that lm_head; per
    token qdot sends the int4 layers to W4A8 (7 matrices a layer) and the
    int4 lm_head to W4A16 (one call)."""
    name, kind, headless, act8 = row
    jcfg, host = ragged_decoders
    assert jk4.int4_matmul_w4a8(
        jnp.zeros((1, jcfg.hidden_size), jnp.int8),
        jnp.asarray(host["int4"]["lm_head"]["q4"]),
        jnp.asarray(host["int4"]["lm_head"]["s4"]), interpret=True) is None
    cfg = dataclasses.replace(_tiny(vsm_tiny().llama),
                              vocab_size=RAGGED_VOCAB)
    rec, _ = _decode_row(jcfg, host, cfg, row, monkeypatch)
    per = rec["launches_per_token"]
    layers = cfg.num_layers
    assert per["qdot_w4a8"] == (7 * layers if kind == "int4" else 0)
    assert per["qdot_w4a16"] == (0 if headless else 1)
