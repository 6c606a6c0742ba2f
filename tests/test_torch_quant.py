"""The port's quantization (nn/quant.py) and quantized-matmul wrappers on
the CPU against the JAX package, on numpy-seeded inputs.

  * quantizers: bit-identical q / s / q4 / s4 (both round half to even);
  * K3/K4 int8 matvec: the plain version against JAX `qdot` on an int8
    entry (the kernels themselves cannot run off a TPU) to 1e-5 in f32;
  * K5: the plain version against the Pallas `int4_matmul` in interpret
    mode, to 1e-2 of the output's largest magnitude (the TPU kernel rounds
    x and the dequantized weights to bf16, the plain version keeps f32),
    and against JAX's f32 dequantize-and-matmul to 1e-5;
  * K6: the plain version against the Pallas `int4_matmul_w4a8` in
    interpret mode, to 1e-5 of the largest magnitude (exact integer group
    dots on both sides; only the f32 sums differ in order);
  * `qdot`, `dense` and `_w8a8_dot` against their JAX twins, act-int8 off
    and on.
The CUDA kernels run only on the card (tests marked `gpu` in
test_torch_kernels.py, and chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vstar_tpu.kernels.int4_matmul import int4_matmul as jax_int4_matmul
from vstar_tpu.kernels.int4_matmul import \
    int4_matmul_w4a8 as jax_int4_matmul_w4a8
from vstar_tpu.nn import basic as jbasic
from vstar_tpu.nn import quant as jq
from vstar_tpu_torch.kernels import int4_matmul as k4
from vstar_tpu_torch.kernels import int8_matmul as k8
from vstar_tpu_torch.nn import basic as tbasic
from vstar_tpu_torch.nn import quant as tq

torch.set_num_threads(1)

F32_TOL = 1e-5
BF16_REL_TOL = 1e-2


def t(x):
    return torch.from_numpy(np.array(x))


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture
def act_int8():
    """Turns the act-int8 switch on on both sides, and off afterwards."""
    jq.set_act_int8(True)
    tq.set_act_int8(True)
    yield
    jq.set_act_int8(False)
    tq.set_act_int8(False)


# ---------------------------------------------------------------------------
# Quantizers
# ---------------------------------------------------------------------------

def _weights(seed, shape):
    w = np.random.RandomState(seed).randn(*shape).astype(np.float32) * 0.05
    # values on the rounding boundaries: a column whose max is 127 (int8)
    # or 7 (int4) times a step, with entries at k + 0.5 steps
    w[..., :16, 0] = np.arange(-8, 8, dtype=np.float32) + 0.5
    w[..., 16, 0] = 127.0
    return w


@pytest.mark.parametrize("shape", [(256, 96), (2, 64, 40), (3, 384, 24)])
def test_int8_quantizers_bit_identical(shape):
    w = _weights(0, shape)
    want = jq.quantize_weight(jnp.asarray(w))
    got = tq.quantize_weight(t(w))
    got_np = tq.quantize_weight_np(w)
    for key in ("q", "s"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
        np.testing.assert_array_equal(got_np[key], np.asarray(want[key]))
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32


@pytest.mark.parametrize("shape,group", [((256, 96), 128), ((2, 64, 40), 128),
                                         ((512, 24), 64), ((3, 384, 8), 128)])
def test_int4_quantizers_bit_identical(shape, group):
    w = _weights(1, shape)
    w[..., 16, 0] = 7.0
    want = jq.quantize_weight_int4(jnp.asarray(w), group=group)
    got = tq.quantize_weight_int4(t(w), group=group)
    got_np = tq.quantize_weight_int4_np(w, group=group)
    want_np = jq.quantize_weight_int4_np(w, group=group)
    for key in ("q4", "s4"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
        np.testing.assert_array_equal(got_np[key], np.asarray(want_np[key]))
    assert got["q4"].dtype == torch.uint8 and got["s4"].dtype == torch.float32
    # the unpacked nibbles and the dequantized weight
    np.testing.assert_array_equal(
        tq.dequantize_weight(got).numpy(),
        np.asarray(jq.dequantize_weight(want, jnp.float32)))


def test_resolve_matrix_quant_and_keys():
    assert tq.INT4MIX_INT4_KEYS == jq.INT4MIX_INT4_KEYS
    assert tq.GROUP4 == jq.GROUP4
    for mode in (False, True, "int8", "int4", "int4mix"):
        for name in ("wq", "w_gate", "w_down", "lm_head"):
            assert tq.resolve_matrix_quant(mode, name) == \
                jq.resolve_matrix_quant(mode, name)


# ---------------------------------------------------------------------------
# K3/K4: int8 matvec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,IN,OUT", [(1, 256, 384), (8, 512, 200),
                                         (16, 384, 96), (40, 256, 128)])
def test_int8_qdot_matches_jax(rows, IN, OUT):
    """At <= 16 rows qdot takes the int8_matmul wrapper (its plain version
    on the CPU), above it the dequantize-and-matmul; both hold to JAX's
    qdot on the same entry."""
    rng = np.random.RandomState(rows)
    e = jq.quantize_weight_np(rng.randn(IN, OUT).astype(np.float32) * 0.05)
    x = rng.randn(2, rows // 2, IN) if rows > 1 else rng.randn(1, IN)
    x = x.astype(np.float32)
    want = np.asarray(jq.qdot(jnp.asarray(x), jax.tree_util.tree_map(
        jnp.asarray, e)))
    before = (k8.launches, k8.plain_calls_cuda)
    got = tq.qdot(t(x), {k: t(v) for k, v in e.items()})
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=0)
    assert (k8.launches, k8.plain_calls_cuda) == before
    if rows <= k8.MAX_ROWS:
        direct = k8.int8_matmul(t(x).reshape(rows, IN), t(e["q"]), t(e["s"]))
        np.testing.assert_allclose(direct.numpy(), want.reshape(rows, OUT),
                                   atol=F32_TOL, rtol=0)


# ---------------------------------------------------------------------------
# K5 / K6: int4
# ---------------------------------------------------------------------------

def _int4_entry(rng, IN, OUT, group=128):
    return jq.quantize_weight_int4_np(
        rng.randn(IN, OUT).astype(np.float32) * 0.05, group=group)


@pytest.mark.parametrize("rows,IN,OUT,group", [
    (1, 512, 256, 128), (16, 512, 384, 128), (40, 256, 512, 128),
    (3, 512, 256, 512)])
def test_int4_matmul_matches_pallas_interpret(rows, IN, OUT, group):
    rng = np.random.RandomState(rows + IN)
    e = _int4_entry(rng, IN, OUT, group)
    x = rng.randn(rows, IN).astype(np.float32)
    want = np.asarray(jax_int4_matmul(jnp.asarray(x), jnp.asarray(e["q4"]),
                                      jnp.asarray(e["s4"]), interpret=True))
    got = k4.int4_matmul(t(x), t(e["q4"]), t(e["s4"])).numpy()
    assert got.shape == (rows, OUT)
    assert rel_err(got, want) <= BF16_REL_TOL
    # the f32 function itself: JAX's dequantize-and-matmul
    exact = np.asarray(jnp.asarray(x) @ jq._deq4(
        jax.tree_util.tree_map(jnp.asarray, e), jnp.float32))
    np.testing.assert_allclose(got, exact, atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("OUT", [200, 333])
def test_int4_matmul_ragged_out(OUT):
    """OUT that no TPU block divides (the 32003-wide lm_head's case): JAX
    sends it to its dequantize-and-matmul; the port's K5 takes it."""
    rng = np.random.RandomState(OUT)
    e = _int4_entry(rng, 256, OUT)
    x = rng.randn(2, 256).astype(np.float32)
    assert jax_int4_matmul(jnp.asarray(x), jnp.asarray(e["q4"]),
                           jnp.asarray(e["s4"]), interpret=True) is None
    want = np.asarray(jq.qdot(jnp.asarray(x),
                              jax.tree_util.tree_map(jnp.asarray, e)))
    got = k4.int4_matmul(t(x), t(e["q4"]), t(e["s4"])).numpy()
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("rows,IN,OUT,group", [
    (1, 512, 256, 128), (8, 512, 384, 128), (16, 256, 512, 128),
    (4, 512, 256, 256)])
def test_int4_w4a8_matches_pallas_interpret(rows, IN, OUT, group):
    rng = np.random.RandomState(rows * 7 + OUT)
    e = _int4_entry(rng, IN, OUT, group)
    xq = rng.randint(-127, 128, size=(rows, IN)).astype(np.int8)
    want = np.asarray(jax_int4_matmul_w4a8(
        jnp.asarray(xq), jnp.asarray(e["q4"]), jnp.asarray(e["s4"]),
        interpret=True))
    got = k4.int4_matmul_w4a8(t(xq), t(e["q4"]), t(e["s4"])).numpy()
    assert got.dtype == np.float32 and got.shape == (rows, OUT)
    assert rel_err(got, want) <= F32_TOL


def test_qdot4_w4a8_matches_jax_composition(act_int8):
    """qdot under act-int8 on a W4A8-eligible shape: the port's activation
    quantization + K6 plain version + activation scale, against JAX's
    qdot4_w4a8 steps with the Pallas kernel in interpret mode."""
    rng = np.random.RandomState(5)
    e = _int4_entry(rng, 512, 256)
    x = rng.randn(1, 3, 512).astype(np.float32)
    xf = jnp.asarray(x.reshape(3, 512))
    sx = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True),
                     1e-8) / 127.0
    xq = jnp.clip(jnp.round(xf / sx), -127, 127).astype(jnp.int8)
    want = np.asarray(jax_int4_matmul_w4a8(
        xq, jnp.asarray(e["q4"]), jnp.asarray(e["s4"]), interpret=True) * sx)
    txq, tsx = k4.quantize_activations(t(x.reshape(3, 512)))
    np.testing.assert_array_equal(txq.numpy(), np.asarray(xq))
    np.testing.assert_array_equal(tsx.numpy(), np.asarray(sx))
    got = tq.qdot(t(x), {k: t(v) for k, v in e.items()})
    assert got.shape == (1, 3, 256)
    assert rel_err(got.numpy().reshape(3, 256), want) <= F32_TOL
    # the row quantization of the fused qdot (quantize_rows: its plain
    # version here, which the kernel matches bit for bit on the card) at 16
    # rows with values on rounding boundaries: x / sx at k + 0.5 (ties to
    # even), a row of zeros (sx = 1e-8 / 127) and a row of one value
    xb = rng.randn(16, 512).astype(np.float32)
    xb[0, :16] = (np.arange(-8, 8) + 0.5).astype(np.float32)
    xb[0, 16] = 127.0                       # sx = 1: the ties stay ties
    xb[1] = 0.0
    xb[2] = -3.0
    xf = jnp.asarray(xb)
    sx = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True),
                     1e-8) / 127.0
    xq = jnp.clip(jnp.round(xf / sx), -127, 127).astype(jnp.int8)
    for txq, tsx in (k4.quantize_activations(t(xb)), k4.quantize_rows(t(xb))):
        np.testing.assert_array_equal(txq.numpy(), np.asarray(xq))
        np.testing.assert_array_equal(tsx.numpy(), np.asarray(sx))
    assert np.asarray(xq)[0, :16].tolist() == [
        -8, -6, -6, -4, -4, -2, -2, 0, 0, 2, 2, 4, 4, 6, 6, 8]


@pytest.mark.parametrize("IN,rows", [(64, 2), (512, 20)])
def test_int4_qdot_gate_falls_to_w4a16(act_int8, IN, rows):
    """Where the W4A8 gate fails (IN % 256, or more than 16 rows) qdot
    takes W4A16 even under act-int8, as the JAX dispatch does."""
    rng = np.random.RandomState(IN)
    e = _int4_entry(rng, IN, 128)
    x = rng.randn(rows, IN).astype(np.float32)
    entry = {k: t(v) for k, v in e.items()}
    assert not k4.w4a8_applies(t(x), entry)
    want = np.asarray(jq.qdot(jnp.asarray(x),
                              jax.tree_util.tree_map(jnp.asarray, e)))
    np.testing.assert_allclose(tq.qdot(t(x), entry).numpy(), want,
                               atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("rows,OUT", [(1, 200), (3, 333), (16, 200)])
def test_int4_qdot_gate_ragged_out_takes_w4a16(act_int8, rows, OUT):
    """Where 128 does not divide OUT (the 32003-wide lm_head) JAX's W4A8
    kernel declines, so qdot takes W4A16 even under act-int8, with rows <=
    16 and IN % 256 == 0; the port's gate names that condition too."""
    rng = np.random.RandomState(OUT + rows)
    e = _int4_entry(rng, 512, OUT)
    x = rng.randn(rows, 512).astype(np.float32)
    xq = rng.randint(-127, 128, size=(rows, 512)).astype(np.int8)
    assert jax_int4_matmul_w4a8(jnp.asarray(xq), jnp.asarray(e["q4"]),
                                jnp.asarray(e["s4"]), interpret=True) is None
    entry = {k: t(v) for k, v in e.items()}
    assert not k4.w4a8_applies(t(x), entry)
    want = np.asarray(jq.qdot(jnp.asarray(x),
                              jax.tree_util.tree_map(jnp.asarray, e)))
    got = tq.qdot(t(x), entry).numpy()
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)
    routes = dict(tq.int4_routes)
    tq.qdot(t(x), entry)
    assert tq.int4_routes == dict(routes, w4a16=routes["w4a16"] + 1)


@pytest.mark.parametrize("rows,OUT", [(3, 96), (20, 203)])
def test_w8a8_dot_matches_jax(act_int8, rows, OUT):
    rng = np.random.RandomState(rows)
    e = jq.quantize_weight_np(rng.randn(128, OUT).astype(np.float32) * 0.05)
    x = rng.randn(rows, 128).astype(np.float32)
    want = np.asarray(jq.qdot(jnp.asarray(x),
                              jax.tree_util.tree_map(jnp.asarray, e)))
    got = tq.qdot(t(x), {k: t(v) for k, v in e.items()}).numpy()
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)
    xq = rng.randint(-127, 128, size=(rows, 128)).astype(np.int8)
    np.testing.assert_array_equal(
        tq._int32_matmul(t(xq), t(e["q"])).numpy(),
        xq.astype(np.int64) @ e["q"].astype(np.int64))


@pytest.mark.parametrize("act", [False, True])
def test_dense_tower_int8_entry(act, request):
    if act:
        request.getfixturevalue("act_int8")
    rng = np.random.RandomState(9)
    jp = jbasic.init_dense(jax.random.PRNGKey(1), 32, 48)
    jp["b"] = jnp.asarray(rng.randn(48).astype(np.float32))
    qe = jq.quantize_weight(jp["w"])
    jent = {"q": qe["q"], "s": qe["s"], "b": jp["b"]}
    x = rng.randn(2, 5, 32).astype(np.float32)
    want = np.asarray(jbasic.dense(jent, jnp.asarray(x)))
    tent = {k: t(v) for k, v in jax.device_get(jent).items()}
    np.testing.assert_allclose(tbasic.dense(tent, t(x)).numpy(), want,
                               atol=F32_TOL, rtol=0)


# ---------------------------------------------------------------------------
# Wrappers: plain version on the CPU only, the kernel or an error elsewhere
# ---------------------------------------------------------------------------

def test_split_plan_fills_the_card_and_covers_the_reduction():
    """K6's split plan (w4a8_plan over its groups in 256-column strips,
    W4A8_SPLITS k-splits a block, csrc/decode_rows.cuh): every group of a
    strip is summed by exactly one k-split of its cluster, in order; the
    clusters stay in one wave of the card's resident blocks; a block
    streams at least W4A8_MIN_GROUPS groups unless that would leave SMs
    without a block; and the 7B shapes get the sizes measured best."""
    for units, out, cap in [
            (32, 11008, 528), (32, 4096, 264), (86, 4096, 396),
            (32, 32000, 264), (86, 4096, 132), (1, 4096, 132),
            (3, 256, 528)]:
        cols = k4.DECODE_COLS * k4.W4A8_WARP_COLS
        c = k4.w4a8_plan(units, out, cap, 132)
        strips = -(-out // cols)
        splits = c * k4.W4A8_SPLITS
        per = -(-units // splits)          # launch_decode's units a split
        covered = []
        for k in range(splits):            # rank * WK + wk
            g0 = min(units, k * per)
            covered += range(g0, min(units, g0 + per))
        assert covered == list(range(units))
        assert c == 1 or strips * c <= cap
        assert per >= k4.W4A8_MIN_GROUPS or strips * (c // 2) < 132 \
            or c == 1
        full = k4.decode_plan(units, out, cap, cols, k4.W4A8_SPLITS,
                              k4.W4A8_MAX_CLUSTER)
        assert c <= full and (c == full or strips * c >= 132)
    # one row at 3 blocks an SM (vstar_w4a8_decode_occupancy on the H100)
    assert [k4.w4a8_plan(ng, out, 396, 132) for ng, out in (
        (32, 11008), (86, 4096), (32, 4096))] == [4, 8, 8]
    assert [k8.row_bucket(r) for r in (1, 2, 3, 5, 8, 9, 16)] == \
        [1, 2, 4, 8, 8, 16, 16]


@pytest.mark.parametrize("groups,out,resident", [
    (32, 11008, 264), (32, 32003, 264), (86, 4096, 264), (32, 4096, 396),
    (1, 512, 264), (32, 11008, 40), (3, 64, 1000)])
def test_decode_plan_fills_the_card_in_one_wave(groups, out, resident):
    """K5's decode rows: one cluster of 1, 2, 4 or 8 blocks per strip of
    DECODE_COLS columns, every block holding DECODE_SPLITS splits of whole
    groups; one wave of the card's resident blocks where the strips allow
    it, and no cluster larger than the groups can feed."""
    c = k4.decode_plan(groups, out, resident)
    strips = -(-out // k4.DECODE_COLS)
    assert c in (1, 2, 4, 8) and c <= k4.DECODE_MAX_CLUSTER
    assert c == 1 or strips * c <= resident
    assert c == 1 or k4.DECODE_SPLITS * (c - 1) < groups
    # the largest power of two those three limits let it be
    limit = min(k4.DECODE_MAX_CLUSTER, max(1, resident // strips),
                -(-groups // k4.DECODE_SPLITS))
    assert c <= limit < 2 * c


def test_wrappers_take_plain_version_on_cpu_only():
    counts = (k8.launches, dict(k4.launches), k8.plain_calls_cuda,
              dict(k4.plain_calls_cuda))
    x = torch.zeros(2, 256)
    q, s = torch.zeros(256, 64, dtype=torch.int8), torch.ones(1, 64)
    q4, s4 = torch.zeros(128, 64, dtype=torch.uint8), torch.ones(2, 64)
    k8.int8_matmul(x, q, s)
    k4.int4_matmul(x, q4, s4)
    k4.int4_matmul_w4a8(x.to(torch.int8), q4, s4)
    assert (k8.launches, k4.launches, k8.plain_calls_cuda,
            k4.plain_calls_cuda) == counts
    meta = [a.to("meta") for a in (x, q, s, q4, s4)]
    with pytest.raises(ValueError, match="unsupported device"):
        k8.int8_matmul(*meta[:3])
    with pytest.raises(ValueError, match="unsupported device"):
        k4.int4_matmul(meta[0], *meta[3:])
    with pytest.raises(ValueError, match="unsupported device"):
        k4.int4_matmul_w4a8(meta[0].to(torch.int8), *meta[3:])


def _w8a8_quantize_np(xf):
    """JAX _w8a8_dot's activation rule in numpy: divide, then clamp."""
    sx = np.maximum(np.max(np.abs(xf), axis=-1, keepdims=True) / 127.0,
                    np.float32(1e-8)).astype(np.float32)
    return np.clip(np.round(xf / sx), -127, 127).astype(np.int8), sx


def test_w8a8_quantize_gives_numpy_bits():
    x = np.random.RandomState(4).randn(64, 512).astype(np.float32)
    x[0] = 0.0                                  # the 1e-8 floor
    xq, sx = tq.w8a8_quantize(t(x))
    want_q, want_s = _w8a8_quantize_np(x)
    np.testing.assert_array_equal(sx.numpy(), want_s)
    np.testing.assert_array_equal(xq.numpy(), want_q)


@pytest.mark.gpu
def test_quantizers_on_card_give_numpy_bits():
    """On CUDA, quantize_weight, quantize_weight_int4 and _w8a8_dot's row
    quantization divide as IEEE does (PyTorch divides by a Python scalar
    through its reciprocal there): their scales and codes are numpy's
    bits on a 4096x11008 weight and a [256, 4096] activation."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.RandomState(2024)
    w = (rng.randn(4096, 11008) * 0.02).astype(np.float32)
    wd = t(w).cuda()
    for got, want in ((tq.quantize_weight(wd), tq.quantize_weight_np(w)),
                      (tq.quantize_weight_int4(wd),
                       tq.quantize_weight_int4_np(w))):
        for k in want:
            np.testing.assert_array_equal(got[k].cpu().numpy(), want[k],
                                          err_msg=k)
    x = rng.randn(256, 4096).astype(np.float32)
    xq, sx = tq.w8a8_quantize(t(x).cuda())
    want_q, want_s = _w8a8_quantize_np(x)
    np.testing.assert_array_equal(sx.cpu().numpy(), want_s)
    np.testing.assert_array_equal(xq.cpu().numpy(), want_q)
