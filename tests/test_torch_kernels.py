"""The port's attention wrappers on the CPU against the JAX kernels.

On a CPU tensor each wrapper takes its plain PyTorch version; these tests
hold that version to the Pallas kernel run in interpret mode (K1 at
Pallas-eligible shapes, K1's log-sum-exp and the K7 backward at the
cases of tests/test_flash.py, K2 at ragged tower lengths) and to the JAX
plain version at the decoder's other shapes. The CUDA kernels themselves run
only on the card (chip_smoke.py compares them with the same plain
versions there, and so do the tests marked `gpu`, which skip without a
card). Tolerances: 1e-5 in f32, 2e-2 in bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vstar_tpu.kernels.flash_attention import _fwd as jax_flash_fwd
from vstar_tpu.kernels.flash_attention import flash_attention as jax_flash
from vstar_tpu.kernels.flash_attention import mha_reference as jax_mha
from vstar_tpu.kernels.tower_attention import tower_attention as jax_tower
from vstar_tpu_torch.kernels import flash_attention as fa
from vstar_tpu_torch.kernels import tower_attention as ta

torch.set_num_threads(1)

F32_TOL = 1e-5
BF16_TOL = 2e-2
BWD_TOL = 5e-5      # f32 forward/backward against the Pallas kernels
LSE_TOL = 1e-3      # K1's log-sum-exp on the card (bf16 inputs)


def _qkv(rng, B, Sq, Skv, H, D):
    return (rng.randn(B, Sq, H, D).astype(np.float32),
            rng.randn(B, Skv, H, D).astype(np.float32),
            rng.randn(B, Skv, H, D).astype(np.float32))


def test_flash_cpu_matches_pallas_interpret():
    """B=2, Sq=128, Skv=256, H=2, D=128 with ragged kv_lens, q_offsets and
    a kv_valid mask that empties one row entirely."""
    rng = np.random.RandomState(0)
    q, k, v = _qkv(rng, 2, 128, 256, 2, 128)
    kv_lens = np.array([256, 190], np.int32)
    q_off = np.array([0, 60], np.int32)
    valid = rng.rand(2, 256) > 0.2
    valid[0, 0] = False                 # batch 0, row 0 sees only key 0
    want = np.asarray(jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_lens=jnp.asarray(kv_lens), q_offsets=jnp.asarray(q_off),
        kv_valid=jnp.asarray(valid), interpret=True))
    got = fa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        kv_lens=torch.from_numpy(kv_lens), q_offsets=torch.from_numpy(q_off),
        kv_valid=torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)
    assert np.all(got[0, 0] == 0.0)


@pytest.mark.parametrize("B,Sq,Skv,offs", [
    (2, 1, 96, (40, 77)),      # decode
    (2, 8, 96, (13, 70)),      # verify-width chunk
    (3, 64, 160, (0, 37, 96)),  # option chunk over a prefix
])
def test_flash_cpu_matches_reference_ragged(B, Sq, Skv, offs):
    rng = np.random.RandomState(Sq)
    q, k, v = _qkv(rng, B, Sq, Skv, 4, 16)
    q_off = np.array(offs, np.int32)
    kv_lens = np.minimum(q_off + Sq - rng.randint(0, Sq, B), Skv) \
        .astype(np.int32)
    want = np.asarray(jax_mha(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), jnp.asarray(kv_lens),
                              jnp.asarray(q_off)))
    got = fa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        kv_lens=torch.from_numpy(kv_lens),
        q_offsets=torch.from_numpy(q_off)).numpy()
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)


# The cases of tests/test_flash.py (D = 128, Sq = Skv = 256) in the port's
# causal form: (kv_lens, q_offsets, Sq, key holes, fully masked row 0).
_BWD_CASES = {
    "causal": (None, None, 256, False, False),
    "ragged_kv_lens": ((256, 130), None, 256, False, False),
    "q_offsets": ((192, 228), (64, 100), 128, False, False),
    "kv_valid_holes": ((256, 200), None, 256, True, False),
    "fully_masked_row": (None, None, 256, True, True),
}


@pytest.mark.parametrize("case", sorted(_BWD_CASES))
def test_flash_lse_and_backward_match_pallas_interpret(case):
    """mha_forward_lse and mha_backward against the Pallas forward (its
    lse output) and jax.grad of sum(sin(out)) through the Pallas
    backward, both in interpret mode; atol = rtol = 5e-5 in f32."""
    kv_lens, q_off, sq, holes, empty_row = _BWD_CASES[case]
    B, Skv, H, D = 2, 256, 2, 128
    rng = np.random.RandomState(len(case))
    q, k, v = _qkv(rng, B, sq, Skv, H, D)
    kv_lens = np.array(kv_lens or (Skv, Skv), np.int32)
    q_off = np.array(q_off or (0, 0), np.int32)
    valid = np.ones((B, Skv), bool)
    if holes:
        valid[0, rng.choice(Skv, 40, replace=False)] = False
        valid[1, rng.choice(Skv, 25, replace=False)] = False
    if empty_row:
        valid[1, 0] = False          # batch 1, row 0 sees only key 0
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    jl, jo, jval = (jnp.asarray(x) for x in (kv_lens, q_off, valid))
    want_out, want_lse = jax_flash_fwd(
        jq, jk, jv, jl, jo, jval.astype(jnp.int32)[:, None, :], True,
        D ** -0.5, 128, 128, interpret=True)

    def loss(q, k, v):
        return jnp.sum(jnp.sin(jax_flash(q, k, v, kv_lens=jl, q_offsets=jo,
                                         kv_valid=jval, interpret=True)))

    want_grads = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)

    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    masks = (torch.from_numpy(kv_lens), torch.from_numpy(q_off),
             torch.from_numpy(valid))
    out, lse = fa.mha_forward_lse(tq, tk, tv, *masks)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                               atol=BWD_TOL, rtol=BWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               atol=BWD_TOL, rtol=BWD_TOL)
    do = torch.cos(out)
    delta = (do * out).sum(-1)
    grads = fa.mha_backward(tq, tk, tv, do, lse, delta, *masks)
    for got, want, name in zip(grads, want_grads, "qkv"):
        assert torch.isfinite(got).all(), name
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=BWD_TOL, rtol=BWD_TOL,
                                   err_msg=f"d{name}")
    if empty_row:
        assert lse[1, 0].isinf().all() and (grads[0][1, 0] == 0).all()


def test_flash_autograd_cpu_matches_reference_autograd():
    """flash_attention under grad (the autograd.Function over the plain
    forward-with-lse and backward) against torch autograd through
    mha_reference, with ragged lengths, offsets and key holes."""
    rng = np.random.RandomState(7)
    q, k, v = _qkv(rng, 2, 40, 72, 3, 16)
    kv_lens = torch.tensor([72, 50])
    q_off = torch.tensor([32, 5])
    valid = torch.from_numpy(rng.rand(2, 72) > 0.2)
    valid[1, :6] = False               # batch 1, row 0 sees no key
    dout = torch.from_numpy(rng.randn(2, 40, 3, 16).astype(np.float32))
    grads = []
    for fn in (fa.flash_attention, fa.mha_reference):
        leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        out = fn(*leaves, kv_lens, q_off, valid)
        grads.append(torch.autograd.grad(out, leaves, dout))
    assert fa.flash_attention(*leaves, kv_lens, q_off, valid).grad_fn \
        .name() == "_FlashAttentionBackward"
    for got, want in zip(*grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=F32_TOL,
                                   rtol=0)


def test_tower_attention_refuses_grad():
    x = torch.zeros(1, 8, 2, 64, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ta.tower_attention(x, x, x)
    with torch.no_grad():
        assert ta.tower_attention(x, x, x).shape == x.shape


@pytest.mark.parametrize("S,dtype", [(257, "float32"), (600, "float32"),
                                     (257, "bfloat16")])
def test_tower_cpu_matches_pallas_interpret(S, dtype):
    rng = np.random.RandomState(S)
    q, k, v = (rng.randn(1, S, 2, 64).astype(np.float32) for _ in range(3))
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    want = np.asarray(jax_tower(jnp.asarray(q, jd), jnp.asarray(k, jd),
                                jnp.asarray(v, jd), interpret=True)
                      .astype(jnp.float32))
    got = ta.tower_attention(*(torch.from_numpy(x).to(td)
                               for x in (q, k, v))).float().numpy()
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def _counts():
    return (fa.launches, ta.launches, fa.plain_calls_cuda,
            ta.plain_calls_cuda, dict(fa.bwd_launches),
            fa.bwd_plain_calls_cuda)


def test_wrappers_take_plain_version_on_cpu_only():
    before = _counts()
    x = torch.zeros(1, 4, 2, 128)
    fa.flash_attention(x, x, x)
    out, lse = fa.flash_attention_lse(x, x, x)
    fa.flash_attention_bwd(x, x, x, x, lse, lse)
    xg = x.clone().requires_grad_()
    fa.flash_attention(xg, x, x).sum().backward()
    y = torch.zeros(1, 4, 2, 64)
    ta.tower_attention(y, y, y)
    assert _counts() == before
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention(x.to("meta"), x.to("meta"), x.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention_bwd(*(t.to("meta") for t in (x, x, x, x, lse,
                                                       lse)))
    with pytest.raises(ValueError, match="unsupported device"):
        ta.tower_attention(y.to("meta"), y.to("meta"), y.to("meta"))


def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


def test_flash_argument_checks():
    q, k = _bf16(2, 8, 4, 128), _bf16(2, 32, 4, 128)
    kv_lens, offs, valid = fa._validate(q, k, k, None,
                                        torch.tensor([1, 2]), None)
    assert kv_lens.tolist() == [32, 32] and offs.dtype == torch.int32
    assert valid is None
    with pytest.raises(TypeError, match="bfloat16"):
        fa._validate(q.float(), k, k, None, None, None)
    with pytest.raises(TypeError, match="bfloat16"):
        fa._validate(q, k.half(), k, None, None, None)
    with pytest.raises(ValueError, match="head_dim"):
        fa._validate(_bf16(2, 8, 4, 64), _bf16(2, 32, 4, 64),
                     _bf16(2, 32, 4, 64), None, None, None)
    with pytest.raises(ValueError, match="shape"):
        fa._validate(q, k, _bf16(2, 31, 4, 128), None, None, None)
    with pytest.raises(ValueError, match="shape"):
        fa._validate(q, _bf16(1, 32, 4, 128), _bf16(1, 32, 4, 128), None,
                     None, None)
    with pytest.raises(ValueError, match="contiguous"):
        fa._validate(_bf16(2, 8, 128, 4).transpose(2, 3), k, k, None, None,
                     None)
    with pytest.raises(ValueError, match="aligned"):
        fa._validate(_bf16(2, 8, 4, 130)[..., 1:129], k, k, None, None,
                     None)
    with pytest.raises(ValueError, match="kv_lens"):
        fa._validate(q, k, k, torch.tensor([1, 2, 3]), None, None)
    with pytest.raises(ValueError, match="kv_valid"):
        fa._validate(q, k, k, None, None, torch.ones(2, 31, dtype=bool))
    _, _, valid = fa._validate(q, k, k, None, None,
                               torch.ones(2, 32, dtype=bool))
    assert valid.dtype == torch.uint8 and valid.is_contiguous()


def test_tower_argument_checks():
    x = _bf16(1, 600, 12, 64)
    ta._validate(x, x, x)
    with pytest.raises(TypeError, match="bfloat16"):
        ta._validate(x.float(), x, x)
    with pytest.raises(ValueError, match="head_dim"):
        y = _bf16(1, 600, 12, 32)
        ta._validate(y, y, y)
    with pytest.raises(ValueError, match="shape"):
        ta._validate(x, _bf16(1, 599, 12, 64), x)
    with pytest.raises(ValueError, match="q: expected"):
        ta._validate(_bf16(600, 12, 64), x, x)


# ---------------------------------------------------------------------------
# On the card: the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,Sq,Skv,offs,masked", [
    (1, 1, 300, (200,), False),         # decode (split route)
    (2, 8, 130, (3, 100), False),       # verify chunk, ragged
    (3, 64, 200, (0, 17, 120), True),   # option chunk + key holes
    (2, 130, 130, (0, 0), True),        # prefill, ragged q tiles
])
def test_flash_kernel_on_card(cuda, B, Sq, Skv, offs, masked):
    g = torch.Generator(device=cuda).manual_seed(Sq)
    q, k, v = (torch.randn(B, s, 8, 128, generator=g, device=cuda)
               .to(torch.bfloat16) for s in (Sq, Skv, Skv))
    q_off = torch.tensor(offs, dtype=torch.int32, device=cuda)
    kv_lens = torch.clamp(q_off + Sq, max=Skv).to(torch.int32)
    valid = None
    if masked:
        valid = torch.rand(B, Skv, generator=g, device=cuda) > 0.25
        valid[:, 0] = False          # row 0 at offset 0 sees nothing
    before = fa.launches
    got = fa.flash_attention(q, k, v, kv_lens=kv_lens, q_offsets=q_off,
                             kv_valid=valid)
    want = fa.mha_reference(q, k, v, kv_lens, q_off, valid)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert float((got.float() - want.float()).abs().max()) <= BF16_TOL
    if masked:
        assert float(got[0, 0].float().abs().max()) == 0.0
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_attention(q.float(), k.float(), v.float())


@pytest.mark.gpu
@pytest.mark.parametrize("B,Sq,Skv,offs,lens,masked", [
    (2, 256, 256, (0, 0), (256, 256), 0),       # causal, full tiles
    (2, 130, 130, (0, 0), (130, 77), 1),        # ragged tiles, holes
    (3, 64, 200, (0, 17, 136), (64, 81, 200), 1),  # offsets
    (4, 512, 512, (0, 0, 0, 0), (512, 300, 512, 512), 1),  # training
    # Sq, Skv no multiple of any tile; holes; rows 0-4 of batch 0 see no key
    (3, 77, 93, (0, 5, 16), (93, 40, 93), 5),
])
def test_flash_bwd_kernel_on_card(cuda, B, Sq, Skv, offs, lens, masked):
    """K1's lse (abs 1e-3) and K7's dq, dk, dv (2e-2 of each one's largest
    |value|) against the plain versions, directly and through autograd,
    with ragged lengths, key holes and `masked` leading rows of batch 0
    that see no key (their dq exactly 0); a second launch on the same
    inputs gives bit-identical dq, dk and dv."""
    g = torch.Generator(device=cuda).manual_seed(Sq + B)
    q, k, v, do = (torch.randn(B, s, 8, 128, generator=g, device=cuda)
                   .to(torch.bfloat16) for s in (Sq, Skv, Skv, Sq))
    q_off = torch.tensor(offs, dtype=torch.int32, device=cuda)
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    valid = None
    if masked:
        valid = torch.rand(B, Skv, generator=g, device=cuda) > 0.1
        valid[0, :masked] = False    # batch 0, rows < masked see no key
    masks = (kv_lens, q_off, valid)
    before = (fa.launches, dict(fa.bwd_launches))
    out, lse = fa.flash_attention_lse(q, k, v, *masks)
    ref_out, ref_lse = fa.mha_forward_lse(q, k, v, *masks)
    delta = (do.float() * out.float()).sum(-1)
    got = fa.flash_attention_bwd(q, k, v, do, lse, delta, *masks)
    want = fa.mha_backward(q, k, v, do, ref_lse, delta, *masks)
    torch.cuda.synchronize()
    assert fa.launches == before[0] + 1
    assert fa.bwd_launches == {n: c + 1 for n, c in before[1].items()}
    finite = torch.isfinite(ref_lse)
    assert torch.equal(finite, torch.isfinite(lse))
    assert float((lse - ref_lse)[finite].abs().max()) <= LSE_TOL
    assert float((out.float() - ref_out.float()).abs().max()) <= BF16_TOL
    for a, b in zip(got, want):
        assert torch.isfinite(a.float()).all()
        assert _rel(a, b) <= BF16_TOL
    if masked:
        assert torch.isinf(lse[0, :masked]).all()
        assert float(got[0][0, :masked].float().abs().max()) == 0.0
    again = fa.flash_attention_bwd(q, k, v, do, lse, delta, *masks)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.flash_attention(*leaves, *masks).backward(do)
    for leaf, b in zip(leaves, want):
        assert _rel(leaf.grad, b) <= BF16_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("S", [257, 600])
def test_tower_kernel_on_card(cuda, S):
    g = torch.Generator(device=cuda).manual_seed(S)
    q, k, v = (torch.randn(2, S, 4, 64, generator=g, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    before = ta.launches
    got = ta.tower_attention(q, k, v)
    want = ta.tower_attention_reference(q, k, v)
    torch.cuda.synchronize()
    assert ta.launches == before + 1
    assert float((got.float() - want.float()).abs().max()) <= BF16_TOL


# The quantized-weight kernels (K3/K4 int8 matvec, K5 W4A16, K6 W4A8) at
# shapes that cover their paths: the 16-byte vector loads and the ragged
# byte-load tail, every row bucket, the split reduction, the tensor-core
# tiles above 16 rows. Tolerance: relative to the output's largest
# magnitude, 1e-2 for bf16 outputs and 1e-5 for K6's f32.

def _rel(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def _beyond_rounding(got, want):
    """Largest |got - want| beyond the rounding of got to bf16 (half an
    ulp, at most 2**-8 |want|), relative to the largest |want|."""
    want = want.float()
    excess = ((got.float() - want).abs() - 2.0 ** -8 * want.abs()).clamp(min=0)
    return float(excess.max() / want.abs().max())


def _int4(g, IN, OUT, dev, group=128):
    from vstar_tpu_torch.nn.quant import quantize_weight_int4
    w = torch.randn(IN, OUT, generator=g, device=dev) * 0.05
    return quantize_weight_int4(w, group)


SHAPES_7B = ((4096, 4096), (11008, 4096), (4096, 11008), (4096, 32003))


@pytest.mark.gpu
@pytest.mark.parametrize("rows,IN,OUT", [
    (1, 4096, 4096), (3, 4096, 2048), (8, 1024, 3000), (16, 11008, 512),
    (5, 512, 32003), (3, 100, 300), (16, 40, 64), (9, 4104, 1000)] + [
        (rows, IN, OUT) for IN, OUT in SHAPES_7B
        for rows in (1, 2, 3, 5, 8, 9, 16)])
def test_int8_kernel_on_card(cuda, rows, IN, OUT):
    from vstar_tpu_torch.kernels import int8_matmul as k8
    from vstar_tpu_torch.nn.quant import quantize_weight
    g = torch.Generator(device=cuda).manual_seed(rows)
    e = quantize_weight(torch.randn(IN, OUT, generator=g, device=cuda) * 0.05)
    x = torch.randn(rows, IN, generator=g, device=cuda).to(torch.bfloat16)
    before = k8.launches
    got = k8.int8_matmul(x, e["q"], e["s"])
    want = k8.int8_matmul_reference(x, e["q"], e["s"])
    torch.cuda.synchronize()
    assert k8.launches == before + 1
    assert _rel(got, want) <= 1e-2
    with pytest.raises(ValueError, match="rows|x must"):
        k8.int8_matmul(torch.zeros(17, IN, dtype=torch.bfloat16,
                                   device=cuda), e["q"], e["s"])


def _offset_copy(t, offset):
    """A contiguous copy of t whose data starts `offset` bytes past a
    16-byte boundary (an offset view into a larger buffer)."""
    nbytes = t.numel() * t.element_size()
    buf = torch.empty(nbytes + 16, dtype=torch.uint8, device=t.device)
    view = buf[offset:offset + nbytes].view(t.dtype).view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.gpu
@pytest.mark.parametrize("rows,IN,OUT,offset", [
    (1, 4096, 4096, 1), (16, 4096, 11008, 3), (8, 1000, 512, 8)])
def test_int8_kernel_unaligned_q_on_card(cuda, rows, IN, OUT, offset):
    """q and x starting off a 16-byte boundary (offset views)."""
    from vstar_tpu_torch.kernels import int8_matmul as k8
    from vstar_tpu_torch.nn.quant import quantize_weight
    g = torch.Generator(device=cuda).manual_seed(rows + offset)
    e = quantize_weight(torch.randn(IN, OUT, generator=g, device=cuda) * 0.05)
    x = torch.randn(rows, IN, generator=g, device=cuda).to(torch.bfloat16)
    q = _offset_copy(e["q"], offset)
    assert q.data_ptr() % 16 == offset % 16
    got = k8.int8_matmul(_offset_copy(x, 2), q, e["s"])
    torch.cuda.synchronize()
    assert _rel(got, k8.int8_matmul_reference(x, e["q"], e["s"])) <= 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("rows,IN,OUT", [
    (1, 4096, 11008), (3, 4096, 11008), (8, 4096, 11008), (16, 4096, 11008),
    (1, 4096, 32003), (3, 4096, 32003), (8, 4096, 32003), (16, 4096, 32003),
    (2, 4096, 4096), (16, 11008, 4096), (4, 4096, 32003),
    (40, 4096, 1000), (384, 4096, 11008), (20, 256, 40)] + [
        (rows, IN, OUT) for IN, OUT in SHAPES_7B
        for rows in (17, 33, 64, 300, 384, 768)])
def test_int4_kernel_on_card(cuda, rows, IN, OUT):
    from vstar_tpu_torch.kernels import int4_matmul as k4
    g = torch.Generator(device=cuda).manual_seed(rows + 1)
    e = _int4(g, IN, OUT, cuda)
    x = torch.randn(rows, IN, generator=g, device=cuda).to(torch.bfloat16)
    before = k4.launches["int4_matmul"]
    routes = dict(k4.route_launches)
    got = k4.int4_matmul(x, e["q4"], e["s4"])
    want = k4.int4_matmul_reference(x, e["q4"], e["s4"])
    torch.cuda.synchronize()
    assert k4.launches["int4_matmul"] == before + 1
    route = "decode" if rows <= 16 else "tile"
    assert k4.route_launches[route] == routes[route] + 1
    assert _rel(got, want) <= 1e-2
    # the kernel's own arithmetic (bf16 weights in the tensor-core tiles
    # above 16 rows), within the rounding of its bf16 output
    math = k4.int4_matmul_kernel_math(x, e["q4"], e["s4"])
    assert _beyond_rounding(got, math) <= 1e-3
    # both routes: whole ring stages / k-tiles per group
    e32 = _int4(g, 256, 64, cuda, group=32)
    with pytest.raises(ValueError, match="multiple of 64"):
        k4.int4_matmul(x[:, :256].contiguous(), e32["q4"], e32["s4"])


@pytest.mark.gpu
@pytest.mark.parametrize("rows,IN,OUT,offset", [
    (1, 4096, 11008, 1), (16, 4096, 4096, 5), (33, 4096, 11008, 3),
    (384, 4096, 4096, 8), (64, 512, 1000, 2)])
def test_int4_kernel_unaligned_q4_on_card(cuda, rows, IN, OUT, offset):
    """q4 (and s4) starting off a 16-byte boundary (offset views)."""
    from vstar_tpu_torch.kernels import int4_matmul as k4
    g = torch.Generator(device=cuda).manual_seed(rows + offset)
    e = _int4(g, IN, OUT, cuda)
    x = torch.randn(rows, IN, generator=g, device=cuda).to(torch.bfloat16)
    q4, s4 = _offset_copy(e["q4"], offset), _offset_copy(e["s4"], 4)
    got = k4.int4_matmul(x, q4, s4)
    torch.cuda.synchronize()
    assert _rel(got, k4.int4_matmul_reference(x, e["q4"], e["s4"])) <= 1e-2
    math = k4.int4_matmul_kernel_math(x, e["q4"], e["s4"])
    assert _beyond_rounding(got, math) <= 1e-3


@pytest.mark.gpu
def test_quant_kernel_info(cuda):
    """Build facts of K3's and K5's instantiations: each one launches at
    least one block per SM."""
    from vstar_tpu_torch.kernels import int4_matmul as k4
    from vstar_tpu_torch.kernels import int8_matmul as k8
    k3, k5 = k8.int8_kernel_info(), k4.int4_kernel_info()
    assert [i["kernel"] for i in k3] == [
        f"int8_decode<{r}, {a}>" for a in ("aligned", "ragged") for r in (8, 16)]
    assert [i["kernel"] for i in k5[4:]] == [
        f"int4_tile<{t}, {a}>" for a in ("aligned", "ragged")
        for t in ("64x128", "128x256")]
    assert all(i["blocks_per_sm"] >= 1 and i["registers"] <= 255 for i in k3 + k5)


@pytest.mark.gpu
def test_w4a8_kernel_info(cuda):
    """Build facts of K6's and P4's decode-row instantiations: no spills,
    at least one resident block per SM."""
    from vstar_tpu_torch.kernels import int4_matmul as k4
    from vstar_tpu_torch.kernels import int4_variants as kv
    k6, p4 = k4.w4a8_kernel_info(), kv.w4a8_t_kernel_info()
    assert [i["kernel"] for i in k6] == [
        f"w4a8_decode<{r}, {a}>" for a in ("aligned", "ragged") for r in (8, 16)]
    assert [i["kernel"] for i in p4] == ["w4a8t_decode<8>", "w4a8t_decode<16>"]
    assert all(i["blocks_per_sm"] >= 1 and i["local_bytes"] == 0 for i in k6 + p4)


def _allocations(dev):
    return torch.cuda.memory_stats(dev)["allocation.all.allocated"]


K6_CASES = [(r, IN, OUT) for IN, OUT in ((4096, 11008), (11008, 4096),
                                         (4096, 4096)) for r in (1, 2, 8, 16)]


@pytest.mark.gpu
@pytest.mark.parametrize("rows,IN,OUT", K6_CASES + [
    (8, 4096, 32003), (3, 512, 300)])
def test_int4_w4a8_kernel_on_card(cuda, rows, IN, OUT):
    """K6 (the W4A8 decode rows) against its plain version within 1e-5 of
    the largest |output|; one launch and one allocation (the output) a
    call: no workspace."""
    from vstar_tpu_torch.kernels import int4_matmul as k4
    g = torch.Generator(device=cuda).manual_seed(rows + 2)
    e = _int4(g, IN, OUT, cuda)
    xq = torch.randint(-127, 128, (rows, IN), generator=g, device=cuda,
                       dtype=torch.int32).to(torch.int8)
    before = k4.launches["int4_matmul_w4a8"]
    allocs = _allocations(cuda)
    got = k4.int4_matmul_w4a8(xq, e["q4"], e["s4"])
    assert _allocations(cuda) == allocs + 1
    want = k4.int4_matmul_w4a8_reference(xq, e["q4"], e["s4"])
    torch.cuda.synchronize()
    assert k4.launches["int4_matmul_w4a8"] == before + 1
    assert got.dtype == torch.float32 and _rel(got, want) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("rows,IN,OUT", K6_CASES + [(3, 512, 384)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_w4a8_qdot_on_card(cuda, rows, IN, OUT, dtype):
    """K6's qdot on a CUDA tensor: the row quantization gives
    quantize_activations' xq and sx bit for bit; the result is the plain
    composition (quantize, K6's plain version, times sx) within the
    rounding of x's type and 1e-5; two kernel launches, one of each
    counter, and three allocations (xq, sx, y)."""
    from vstar_tpu_torch.kernels import int4_matmul as k4
    from vstar_tpu_torch.utils.timing import graph_kernels
    g = torch.Generator(device=cuda).manual_seed(rows * 3 + OUT)
    e = _int4(g, IN, OUT, cuda)
    x = torch.randn(rows, IN, generator=g, device=cuda).to(dtype)
    xq, sx = k4.quantize_rows(x)
    want_xq, want_sx = k4.quantize_activations(x.float())
    assert torch.equal(xq, want_xq) and torch.equal(sx, want_sx)
    before = dict(k4.launches)
    allocs = _allocations(cuda)
    got = k4.qdot4_w4a8(x, e)
    assert _allocations(cuda) == allocs + 3
    assert k4.launches == dict(
        before, quantize_rows=before["quantize_rows"] + 1,
        int4_matmul_w4a8=before["int4_matmul_w4a8"] + 1)
    want = k4.int4_matmul_w4a8_reference(want_xq, e["q4"], e["s4"]) * want_sx
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (rows, OUT)
    if dtype == torch.float32:
        assert _rel(got, want) <= 1e-5
    else:
        assert _beyond_rounding(got, want) <= 1e-5
    assert graph_kernels(lambda: k4.qdot4_w4a8(x, e))[0] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("rows,IN", [(1, 2048), (16, 2048), (3, 512)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_w4a8_quantize_given_max_on_card(cuda, rows, IN, dtype):
    """The row quantization given each row's max from outside (a rank of
    an engine's hidden split holds part of each row, nn/llama.py): xq and
    sx bit for bit those of quantize_activations with the same max, one
    launch; a max of another shape is refused."""
    from vstar_tpu_torch.kernels import int4_matmul as k4
    g = torch.Generator(device=cuda).manual_seed(rows + IN)
    x = torch.randn(rows, IN, generator=g, device=cuda).to(dtype)
    amax = x.float().abs().amax(dim=-1, keepdim=True) * torch.rand(
        rows, 1, generator=g, device=cuda).add_(1.0)
    before = k4.launches["quantize_rows"]
    xq, sx = k4.quantize_rows(x, amax)
    assert k4.launches["quantize_rows"] == before + 1
    want_xq, want_sx = k4.quantize_activations(x.float(), amax)
    assert torch.equal(xq, want_xq) and torch.equal(sx, want_sx)
    with pytest.raises(ValueError):
        k4.quantize_rows(x, amax[:, 0])


@pytest.mark.gpu
@pytest.mark.parametrize("rows,IN,OUT", [(1, 4096, 4096), (16, 11008, 4096),
                                         (300, 1024, 3072), (2, 4096, 32003),
                                         (3, 1000, 3000), (5, 100, 30)])
def test_int32_matmul_exact_on_card(cuda, rows, IN, OUT):
    """_w8a8_dot's integer product (torch._int_mm on operands padded with
    zeros to the shapes it takes) is exact."""
    from vstar_tpu_torch.nn.quant import _int32_matmul
    g = torch.Generator(device=cuda).manual_seed(rows)
    a = torch.randint(-127, 128, (rows, IN), generator=g, device=cuda,
                      dtype=torch.int32).to(torch.int8)
    b = torch.randint(-127, 128, (IN, OUT), generator=g, device=cuda,
                      dtype=torch.int32).to(torch.int8)
    want = (a.cpu().long() @ b.cpu().long())
    assert torch.equal(_int32_matmul(a, b).cpu().long(), want)


# The int4 profile's kernels (P1 unpack probe, P2 W4A8 unpack variants, P3
# row blocks, P4 transposed storage) against their plain versions: P1
# exact; P2-P4 f32 within 1e-5 of the largest |output| (exact integer group
# dots; the f32 sums split differently), and against K6 on the same inputs.

@pytest.mark.gpu
@pytest.mark.parametrize("how", ["mul", "add"])
@pytest.mark.parametrize("shape,offset", [((2048, 11008), 0), ((257, 33), 3)])
def test_unpack_probe_kernel_on_card(cuda, how, shape, offset):
    from vstar_tpu_torch.kernels import int4_variants as kv
    g = torch.Generator(device=cuda).manual_seed(shape[1])
    base = torch.randint(0, 256, (shape[0] * shape[1] + offset,), generator=g,
                         device=cuda, dtype=torch.int32).to(torch.uint8)
    q = base[offset:].view(shape)          # offset 3: the byte path
    before = kv.launches["unpack_probe"]
    got = kv.unpack_probe(q, how)
    torch.cuda.synchronize()
    assert kv.launches["unpack_probe"] == before + 1
    assert torch.equal(got, kv.want_lo(q))
    assert torch.equal(got, kv.unpack_probe_reference(q, how))


def _w4a8_inputs(cuda, rows, IN, OUT, group=128):
    g = torch.Generator(device=cuda).manual_seed(rows * 31 + OUT)
    e = _int4(g, IN, OUT, cuda, group)
    xq = torch.randint(-127, 128, (rows, IN), generator=g, device=cuda,
                       dtype=torch.int32).to(torch.int8)
    return xq, e["q4"], e["s4"]


@pytest.mark.gpu
@pytest.mark.parametrize("unpack", ["ship", "mul", "2and", "off"])
@pytest.mark.parametrize("rows,IN,OUT,block_o,group", [
    (1, 4096, 11008, 256, 128), (8, 4096, 32000, 256, 128),
    (16, 11008, 4096, 512, 128), (3, 11008, 4096, 512, 11008),
    (16, 4096, 4096, 256, 128), (1, 4096, 4096, 512, 256),
    (8, 11008, 4096, 512, 128)])
def test_w4a8_variant_kernel_on_card(cuda, unpack, rows, IN, OUT, block_o,
                                     group):
    """P2 on K6's decode rows: one launch and no workspace a call, within
    1e-5 of its plain version and of K6; ship at 256 columns is K6's own
    instantiation and plan, so its bits are K6's."""
    from vstar_tpu_torch.kernels import int4_matmul as k4
    from vstar_tpu_torch.kernels import int4_variants as kv
    xq, q4, s4 = _w4a8_inputs(cuda, rows, IN, OUT, group)
    before = kv.launches["w4a8_variant"]
    allocs = _allocations(cuda)
    got = kv.w4a8_variant(xq, q4, s4, unpack, block_o)
    assert _allocations(cuda) == allocs + 1      # the output, no workspace
    want = kv.w4a8_variant_reference(xq, q4, s4, unpack, block_o)
    torch.cuda.synchronize()
    assert kv.launches["w4a8_variant"] == before + 1
    assert got.dtype == torch.float32 and _rel(got, want) <= 1e-5
    assert _rel(got, k4.int4_matmul_w4a8_reference(xq, q4, s4)) <= 1e-5
    k6 = k4.int4_matmul_w4a8(xq, q4, s4)
    assert _rel(got, k6) <= 1e-5
    if unpack == "ship" and block_o == 256:
        assert torch.equal(got, k6)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,IN,OUT,block_i", [
    (1, 11008, 4096, None), (8, 4096, 512, 128), (16, 1024, 768, 64),
    (2, 4096, 32000, None), (16, 11008, 4096, None), (8, 11008, 4096, 5504)])
def test_w4a8_rows_kernel_on_card(cuda, rows, IN, OUT, block_i):
    """P3 on K6's decode rows: one launch and no workspace a call, within
    1e-5 of its plain version (the block-order sum) and of K6."""
    from vstar_tpu_torch.kernels import int4_matmul as k4
    from vstar_tpu_torch.kernels import int4_variants as kv
    xq, q4, s4 = _w4a8_inputs(cuda, rows, IN, OUT)
    before = kv.launches["w4a8_rows"]
    allocs = _allocations(cuda)
    got = kv.w4a8_rows(xq, q4, s4, block_i)
    assert _allocations(cuda) == allocs + 1      # the output, no workspace
    want = kv.w4a8_rows_reference(xq, q4, s4, block_i)
    torch.cuda.synchronize()
    assert kv.launches["w4a8_rows"] == before + 1
    assert _rel(got, want) <= 1e-5
    assert _rel(got, k4.int4_matmul_w4a8(xq, q4, s4)) <= 1e-5


@pytest.mark.gpu
def test_w4a8_variants_raise_outside_their_domain_on_card(cuda):
    """P2 and P3 on CUDA raise ValueError outside the decode rows' domain
    (a group of 64 inputs, OUT % 16 for P3, unaligned weights) and outside
    the JAX functions' (block_o 512 on 32000 columns), with no launch."""
    from vstar_tpu_torch.kernels import int4_variants as kv
    counts = dict(kv.launches)
    xq, q4, s4 = _w4a8_inputs(cuda, 2, 4096, 32000)
    with pytest.raises(ValueError, match="block_o"):
        kv.w4a8_variant(xq, q4, s4, "off", 512)
    x64, q64, s64 = _w4a8_inputs(cuda, 2, 4096, 4096, group=64)
    for unpack in ("ship", "2and"):
        with pytest.raises(ValueError, match="multiple of 128"):
            kv.w4a8_variant(x64, q64, s64, unpack)
    with pytest.raises(ValueError, match="multiple of 128"):
        kv.w4a8_rows(x64, q64, s64)
    x8, q8, s8 = _w4a8_inputs(cuda, 2, 1024, 1000)
    with pytest.raises(ValueError, match="multiple of 16"):
        kv.w4a8_rows(x8, q8, s8)
    xa, qa, sa = _w4a8_inputs(cuda, 2, 1024, 512)
    buf = torch.zeros(qa.numel() + 4, dtype=torch.uint8, device=cuda)
    qoff = buf[4:].view(qa.shape)
    qoff.copy_(qa)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kv.w4a8_variant(xa, qoff, sa, "mul")
    with pytest.raises(ValueError, match="16-byte aligned"):
        kv.w4a8_rows(xa, qoff, sa)
    assert kv.launches == counts


@pytest.mark.gpu
@pytest.mark.parametrize("rows,IN,OUT,block_o", [
    (1, 4096, 11008, 256), (8, 4096, 32000, 256), (16, 11008, 4096, 512),
    (3, 512, 768, 256)])
def test_w4a8_t_kernel_on_card(cuda, rows, IN, OUT, block_o):
    from vstar_tpu_torch.kernels import int4_variants as kv
    xq, q4, s4 = _w4a8_inputs(cuda, rows, IN, OUT)
    q4t, s4t = q4.t().contiguous(), s4.t().contiguous()
    before = kv.launches["w4a8_t"]
    allocs = _allocations(cuda)
    got = kv.w4a8_t(xq, q4t, s4t, block_o)
    assert _allocations(cuda) == allocs + 1      # the output, no workspace
    want = kv.w4a8_t_reference(xq, q4t, s4t, block_o)
    torch.cuda.synchronize()
    assert kv.launches["w4a8_t"] == before + 1
    assert got.shape == (rows, OUT) and _rel(got, want) <= 1e-5
    # P4 and K6 on the same product (the transposed layout's own check)
    from vstar_tpu_torch.kernels import int4_matmul as k4
    assert _rel(got, k4.int4_matmul_w4a8(xq, q4, s4)) <= 1e-5


@pytest.mark.gpu
def test_decode_routes_capture_in_a_cuda_graph(cuda):
    """The decode's quantized routes (K3, K5, K6's qdot with its row
    quantization launched dependent on it, K5 for the ragged int4 lm_head
    under act-int8, _w8a8_dot, a P kernel) and K1 at decode are captured
    into one CUDA graph; a replay gives the eager results."""
    from vstar_tpu_torch.kernels import int4_matmul as k4
    from vstar_tpu_torch.kernels import int4_variants as kv
    from vstar_tpu_torch.nn import quant
    g = torch.Generator(device=cuda).manual_seed(5)
    e4 = _int4(g, 4096, 11008, cuda)
    e8 = quant.quantize_weight(torch.randn(4096, 4096, generator=g,
                                           device=cuda) * 0.05)
    head = _int4(g, 4096, 32003, cuda)
    x = torch.randn(1, 4096, generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = (torch.randn(1, s, 32, 128, generator=g, device=cuda)
               .to(torch.bfloat16) for s in (1, 512, 512))
    lens = torch.tensor([385], dtype=torch.int32, device=cuda)
    offs = torch.tensor([384], dtype=torch.int32, device=cuda)

    def step():
        quant.set_act_int8(True)
        try:
            w8a8 = quant.qdot(x, e8)
            w4a8 = quant.qdot(x, e4)
            ragged = quant.qdot(x, head)         # the gate: K5
        finally:
            quant.set_act_int8(False)
        xq, _ = k4.quantize_rows(x)
        return (quant.qdot(x, e8), k4.qdot4(x, e4), w8a8, w4a8, ragged,
                k4.int4_matmul_w4a8(xq, e4["q4"], e4["s4"]),
                kv.w4a8_variant(xq, e4["q4"], e4["s4"], "off"),
                fa.flash_attention(q, k, v, kv_lens=lens, q_offsets=offs))

    eager = step()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = step()
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(captured, eager):
        assert torch.equal(a, b)
