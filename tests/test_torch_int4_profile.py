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
  * the wrappers' domain checks;
  * the decode ablation at a tiny width (all eight rows) against JAX
    make_decode on the same weights, act-int8 off and on, to 1e-5 (f32;
    rows with int8 activations to 1e-2 of the value, ACT8_REL_TOL).
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


@pytest.mark.parametrize("row", ip.DECODE_ROWS, ids=lambda r: r[1] + (
    "_headless" if r[2] else "") + ("_act8" if r[3] else ""))
def test_decode_row_matches_jax(decoders, row, monkeypatch):
    name, kind, headless, act8 = row
    jcfg, host = decoders
    monkeypatch.setattr(jk4, "qdot4_w4a8", _jax_qdot4_w4a8)
    jq.set_act_int8(act8)
    try:
        want = float(jip.make_decode(jcfg, headless)(
            jax.tree_util.tree_map(jnp.asarray, host[kind]),
            jnp.float32(1.0)))
    finally:
        jq.set_act_int8(False)
    rec, = ip.bench_decode("cpu", cfg=_tiny(vsm_tiny().llama),
                           params={kind: from_numpy_tree(host[kind], "cpu")},
                           act_dtype=torch.float32, rows=[row])
    assert rec["plain_on_cuda"] == 0
    tol = ACT8_REL_TOL * abs(want) if act8 else F32_TOL
    assert abs(rec["value"] - want) <= tol, (name, rec["value"], want)
    if act8 and kind != "int4":
        # the int8 matrices take _w8a8_dot under act-int8
        assert rec["launches_per_token"]["_w8a8_dot"] == \
            (1 if kind == "int4_head8" else 14)
    assert not tq._ACT_INT8
