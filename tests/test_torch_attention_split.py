"""K1's split route and the K1/K2 redesign.

On the CPU: `split_kv_reference`, the split route's algebra in plain
PyTorch (per-split partial m, l and unnormalised O, merged in split
order), against the JAX `mha_reference` (the function JAX runs at these
shapes) and the port's `mha_forward_lse` (held to the Pallas `_fwd` in
interpret mode by tests/test_torch_kernels.py), in f32 at 1e-5; and the
host split planner, which sees shapes and the SM count only.

On the card (marker `gpu`, skipped without one): K2 at the OWL tower's
shapes, K1's split route (empty splits, kv_len = 0, its lse) and its tile
route at a query count that is no multiple of the tile, against the
plain versions (2e-2 abs in bf16; lse 1e-3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vstar_tpu.kernels.flash_attention import mha_reference as jax_mha
from vstar_tpu_torch.kernels import flash_attention as fa
from vstar_tpu_torch.kernels import tower_attention as ta

torch.set_num_threads(1)

F32_TOL = 1e-5
BF16_TOL = 2e-2
LSE_TOL = 1e-3


def _case(B, Sq, Skv, H, D, seed):
    """Ragged rows over a Skv-slot cache: row 0 at a late offset, row 1
    with kv_len = 0, row 2 with key holes and its first query row seeing
    only a masked key."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, Sq, H, D).astype(np.float32)
    k = rng.randn(B, Skv, H, D).astype(np.float32)
    v = rng.randn(B, Skv, H, D).astype(np.float32)
    q_off = np.array([Skv - Sq - 3, 0, 0][:B], np.int32)
    kv_lens = np.array([Skv - 2, 0, Skv // 2][:B], np.int32)
    valid = rng.rand(B, Skv) > 0.25
    valid[2, 0] = False                 # row 0 of batch 2 sees no key
    return q, k, v, kv_lens, q_off, valid


@pytest.mark.parametrize("Sq", [1, 8])
@pytest.mark.parametrize("n_splits", [1, 2, 3, 8])
def test_split_reference_matches_jax_and_lse(Sq, n_splits):
    q, k, v, kv_lens, q_off, valid = _case(3, Sq, 150, 2, 32, 10 * Sq + n_splits)
    want = np.asarray(jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(kv_lens), jnp.asarray(q_off),
                              kv_valid=jnp.asarray(valid)))
    t = [torch.from_numpy(x) for x in (q, k, v, kv_lens, q_off, valid)]
    out, lse = fa.split_kv_reference(*t, n_splits=n_splits)
    np.testing.assert_allclose(out.numpy(), want, atol=F32_TOL, rtol=0)
    _, want_lse = fa.mha_forward_lse(*t)
    assert torch.equal(torch.isinf(lse), torch.isinf(want_lse))
    finite = torch.isfinite(want_lse)
    np.testing.assert_allclose(lse[finite].numpy(), want_lse[finite].numpy(),
                               atol=F32_TOL, rtol=F32_TOL)
    # kv_len = 0 and the row that sees no key: exact zeros, lse -inf
    assert (out[1] == 0).all() and torch.isinf(lse[1]).all()
    assert (out[2, 0] == 0).all() and torch.isinf(lse[2, 0]).all()


def test_split_ranges_leave_late_splits_empty():
    """Equal shares of whole 16-key groups of [0, min(kv_len, q_off + Sq));
    a short row leaves its later splits empty."""
    kv_lens = torch.tensor([300, 20, 0, 768])
    q_off = torch.tensor([299, 19, 0, 100])
    start, end = fa.split_ranges(kv_lens, q_off, 1, 9)
    assert start.shape == end.shape == (4, 9)
    # row 0: 300 keys = 19 groups, 3 per split -> 7 splits, the last short
    assert end[0].tolist() == [48, 96, 144, 192, 240, 288, 300, 300, 300]
    assert (start[0, 1:] == end[0, :-1]).all()
    # row 1: 20 keys = 2 groups -> splits 0 and 1, the rest empty
    assert end[1].tolist()[:2] == [16, 20] and (start[1, 2:] == end[1, 2:]).all()
    assert (start[2] == end[2]).all()                # kv_len = 0
    assert end[3, -1] == 101                         # causal: q_off + Sq


def test_split_plan_from_shapes_and_sm_count_only():
    assert fa.split_plan(1, 1, 32, 768, 132) == 9     # 288 blocks >= 2 x 132
    assert fa.split_plan(2, 8, 32, 512, 132) == 5
    assert fa.split_plan(1, 1, 32, 768, 66) == 5
    assert fa.split_plan(1, 1, 32, 32, 132) == 2      # capped by 16-key groups
    assert fa.split_plan(64, 1, 32, 768, 132) == 1
    assert fa.split_plan(1, 1, 1, 100000, 1000) == fa.SPLIT_MAX
    for args in [(1, 1, 1, 1, 1), (8, 16, 40, 4096, 132), (3, 5, 7, 11, 13)]:
        n = fa.split_plan(*args)
        assert n >= 1 and n == fa.split_plan(*args)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bf16(g, dev, *shape):
    return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("B,fused", [(1, False), (4, False), (2, True)])
def test_tower_kernel_at_owl_shapes(cuda, B, fused):
    """The OWL shapes; `fused` reads q, k, v in place from one [B, S, 3,
    H, 64] projection (the tensor maps take the strides as given)."""
    g = torch.Generator(device=cuda).manual_seed(B)
    if fused:
        q, k, v = _bf16(g, cuda, B, 2305, 3, 12, 64).unbind(2)
    else:
        q, k, v = (_bf16(g, cuda, B, 2305, 12, 64) for _ in range(3))
    before = ta.launches
    got = ta.tower_attention(q, k, v)
    want = ta.tower_attention_reference(q, k, v)
    torch.cuda.synchronize()
    assert ta.launches == before + 1
    assert float((got.float() - want.float()).abs().max()) <= BF16_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("Sq", [1, 8, 16])
def test_flash_split_route_on_card(cuda, Sq):
    """Splits past kv_len (row 0 sees 20 of 768 keys), kv_len = 0 (row 1),
    key holes and a row that sees no key (row 2); out and lse."""
    g = torch.Generator(device=cuda).manual_seed(Sq)
    B, Skv, H = 3, 768, 32
    q, k, v = _bf16(g, cuda, B, Sq, H, 128), _bf16(g, cuda, B, Skv, H, 128), \
        _bf16(g, cuda, B, Skv, H, 128)
    kv_lens = torch.tensor([20, 0, 500], dtype=torch.int32, device=cuda)
    q_off = torch.tensor([20 - Sq, 0, 0], dtype=torch.int32, device=cuda)
    valid = torch.rand(B, Skv, generator=g, device=cuda) > 0.2
    valid[2, 0] = False
    masks = (kv_lens, q_off, valid)
    assert fa.split_plan(B, Sq, H, Skv, fa._sm_count(cuda)) > 2
    before = dict(fa.route_launches)
    by_rows = fa.split_launches_by_rows.get(Sq, 0)
    got = fa.flash_attention(q, k, v, *masks)
    out, lse = fa.flash_attention_lse(q, k, v, *masks)
    want, want_lse = fa.mha_forward_lse(q, k, v, *masks)
    torch.cuda.synchronize()
    assert fa.route_launches == {"tile": before["tile"],
                                 "split": before["split"] + 2,
                                 "combine": before["combine"] + 2}
    assert fa.split_launches_by_rows[Sq] == by_rows + 2
    assert torch.equal(got, out)
    assert float((got.float() - want.float()).abs().max()) <= BF16_TOL
    assert (got[1] == 0).all() and (got[2, 0] == 0).all()
    finite = torch.isfinite(want_lse)
    assert torch.equal(finite, torch.isfinite(lse))
    assert float((lse - want_lse)[finite].abs().max()) <= LSE_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("Sq", [17, 200])
def test_flash_tile_route_ragged_query_tile(cuda, Sq):
    """Sq no multiple of the 64-row query tile, with lse."""
    g = torch.Generator(device=cuda).manual_seed(Sq)
    B, Skv, H = 2, 384, 16
    q, k, v = _bf16(g, cuda, B, Sq, H, 128), _bf16(g, cuda, B, Skv, H, 128), \
        _bf16(g, cuda, B, Skv, H, 128)
    kv_lens = torch.tensor([Sq + 100, Sq], dtype=torch.int32, device=cuda)
    q_off = torch.tensor([100, 0], dtype=torch.int32, device=cuda)
    before = fa.route_launches["tile"]
    out, lse = fa.flash_attention_lse(q, k, v, kv_lens, q_off)
    want, want_lse = fa.mha_forward_lse(q, k, v, kv_lens, q_off)
    torch.cuda.synchronize()
    assert fa.route_launches["tile"] == before + 1
    assert float((out.float() - want.float()).abs().max()) <= BF16_TOL
    assert float((lse - want_lse).abs().max()) <= LSE_TOL


@pytest.mark.gpu
def test_attention_kernel_info(cuda):
    info = fa.attention_kernel_info()
    names = [i["kernel"] for i in info]
    assert "flash_split" in names and "tower_wgmma" in names
    assert all(i["blocks_per_sm"] >= 1 and i["registers"] > 0 for i in info)


def test_attention_probe_lists_the_shipped_tile_first():
    """The probe's first variant is K1's shipped tile (BQ 64, BK 64, two
    stages, no register cap); without a card it refuses to measure."""
    from vstar_tpu_torch.scripts import attention_probe as ap
    assert ap.VARIANTS[0][1:] == (64, 64, 2, 1)
    assert len({v[0] for v in ap.VARIANTS}) == len(ap.VARIANTS)
    if not torch.cuda.is_available():
        assert ap.main(["--gap"]) == 1
