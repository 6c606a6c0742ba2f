"""The port's flag matrix (vstar_tpu_torch/eval/flag_matrix.py) against
the JAX package's on the CPU, at tiny widths in f32 on the same int8 /
int4 weights (tests/test_torch_slice's quantizers, core.convert): the dry
run of every cell, its rows held to JAX's dry run (free-form answer and
its tokens per forward, option, search found / path length / box within
ATOL, the matches-base bits) on the cells that exercise the port's new
paths (base, kv-int8, w8a8); a failing cell isolated as JAX isolates it;
and the residency sweep, whose parked cell always runs (the port has no
relay) and must match the phased base bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_torch_phased import FORCED, _factories, bench, hosts
from tests.test_torch_slice import (T_VQA_CFG, T_VSM_CFG, TOK, VQA_CFG,
                                    VSM_CFG, _quantize_host)
from vstar_tpu.eval import flag_matrix as jfm
from vstar_tpu.eval.vqa_engine import VQAEngine as JaxVQAEngine
from vstar_tpu.models.vqa_llm import init_vqa_llm_params as jax_init_vqa
from vstar_tpu.models.vsm import init_vsm_params as jax_init_vsm
from vstar_tpu.nn import quant as jq
from vstar_tpu.search.batched import BatchedVSMEngine as JaxBatchedVSM
from vstar_tpu.search.compiled import CompiledVSMSearch as JaxCompiled
from vstar_tpu_torch.core.convert import from_numpy_tree
from vstar_tpu_torch.eval import flag_matrix as tfm
from vstar_tpu_torch.eval.vqa_engine import VQAEngine
from vstar_tpu_torch.nn import quant as tq
from vstar_tpu_torch.search.batched import BatchedVSMEngine
from vstar_tpu_torch.search.compiled import CompiledVSMSearch

__all__ = ["bench", "hosts"]   # fixtures of tests/test_torch_phased.py

torch.set_num_threads(1)

ATOL = 1e-4
LOC = 3
IMG = Image.fromarray((np.random.RandomState(0).rand(250, 300, 3)
                       * 255).astype("uint8"))


@pytest.fixture(scope="module")
def weights():
    """{int4: (vqa host, vsm host)} quantized by the JAX quantizers."""
    vqa = jax.device_get(jax_init_vqa(jax.random.PRNGKey(0), VQA_CFG))
    vsm = jax.device_get(jax_init_vsm(jax.random.PRNGKey(1), VSM_CFG))
    return {int4: (_quantize_host(vqa, q), _quantize_host(vsm, q))
            for int4, q in ((False, True), (True, "int4"))}


def _short(cls):
    class Short(cls):
        def free_form(self, image, question, **kw):
            kw.setdefault("max_new_tokens", 6)
            return super().free_form(image, question, **kw)
    return Short


def _make_engines(weights, side):
    """make_engines for run_flag_matrix: tests/test_flag_matrix.py's
    engines, on the JAX side or the port's."""
    def make(kv_int8, prompt_lookup, compiled, int4=False):
        vqa_host, vsm_host = weights[int4]
        vkw = dict(prompt_buckets=(64, 128), option_bucket=16,
                   kv_int8=kv_int8, prompt_lookup=prompt_lookup)
        skw = dict(loc_token_id=LOC, max_new_tokens=4,
                   prompt_buckets=(64, 128), kv_int8=kv_int8,
                   device_preprocess=compiled, speculative_template=None)
        if side == "jax":
            tree = jax.tree_util.tree_map
            vq = _short(JaxVQAEngine)(tree(jnp.asarray, vqa_host), VQA_CFG,
                                      TOK, compute_dtype=jnp.float32, **vkw)
            vs = JaxBatchedVSM(tree(jnp.asarray, vsm_host), VSM_CFG, TOK,
                               compute_dtype=jnp.float32, **skw)
            return vq, (JaxCompiled(vs, P=8) if compiled else vs)
        vq = _short(VQAEngine)(from_numpy_tree(vqa_host, "cpu"), T_VQA_CFG,
                               TOK, device="cpu", compute_dtype=torch.float32,
                               **vkw)
        vs = BatchedVSMEngine(from_numpy_tree(vsm_host, "cpu"), T_VSM_CFG,
                              TOK, device="cpu", compute_dtype=torch.float32,
                              **skw)
        return vq, (CompiledVSMSearch(vs, P=8) if compiled else vs)
    return make


def test_flag_matrix_dry_run(weights):
    """Every cell constructs and runs both surfaces; prompt lookup
    reproduces the base answer; the act-int8 switch is restored after
    the sweep."""
    tq.set_act_int8(False)
    rows = tfm.run_flag_matrix(_make_engines(weights, "port"), IMG,
                               search_name="red thing", log=None)
    assert tq._ACT_INT8 is False
    assert [r["cell"] for r in rows] == [name for name, _ in tfm.CELLS]
    assert tfm.CELLS == jfm.CELLS
    by_cell = {r["cell"]: r for r in rows}
    assert all("error" not in r for r in rows), rows
    assert by_cell["prompt-lookup"]["answer_matches_base"] is True
    assert by_cell["prompt-lookup"]["option_matches_base"] is True
    for r in rows:
        assert r["free_form_s"] > 0 and r["search_s"] > 0
        assert isinstance(r["search_found"], bool)
        assert r["option"] in (0, 1, 2, 3)
    assert by_cell["compiled-search"]["compiled"] is True
    assert by_cell["compiled-search"]["search_plen"] >= 0
    table = tfm.format_table(rows)
    assert "free_form_s" in table and "all-opt-ins" in table


CHECKED = ("base", "kv-int8", "w8a8")


def test_flag_matrix_rows_are_jax(weights, monkeypatch):
    """The cells of CHECKED on both sides: the same rows (times aside)."""
    cells = tuple(c for c in jfm.CELLS if c[0] in CHECKED)
    monkeypatch.setattr(jfm, "CELLS", cells)
    monkeypatch.setattr(tfm, "CELLS", cells)
    want = jfm.run_flag_matrix(_make_engines(weights, "jax"), IMG,
                               search_name="red thing", log=None)
    got = tfm.run_flag_matrix(_make_engines(weights, "port"), IMG,
                              search_name="red thing", log=None)
    assert jq._ACT_INT8 is False and tq._ACT_INT8 is False
    assert [r["cell"] for r in got] == list(CHECKED)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if k.endswith("_s"):
                continue
            if k == "search_bbox" and w[k] is not None:
                np.testing.assert_allclose(g[k], w[k], atol=ATOL, rtol=0)
            else:
                assert g[k] == w[k], (g["cell"], k)


class MiniVQA:
    def free_form(self, image, question, **kw):
        return "an answer"

    def multiple_choice(self, image, question, options, **kw):
        return 1


class MiniVSM:
    def detect(self, patch, name):
        boxes = np.zeros((2, 4), np.float32)
        boxes[0] = [0.2, 0.2, 0.1, 0.1]
        return boxes, np.asarray([0.9, 0.0], np.float32), \
            np.ones((patch.height, patch.width), np.float32)

    def vqa(self, patch, q):
        return "most likely to appear on the table."

    def segment(self, patch, phrase):
        return np.ones((patch.height, patch.width), np.float32)


def test_flag_matrix_cell_isolation():
    """A failing cell records an error row and the sweep goes on, as in
    JAX (the same rows); a failing base cell raises."""
    def make_engines(kv_int8, prompt_lookup, compiled, int4=False):
        if int4:
            raise RuntimeError("int4 importer declined")
        return MiniVQA(), MiniVSM()

    img = Image.fromarray(np.zeros((250, 300, 3), np.uint8))
    rows = tfm.run_flag_matrix(make_engines, img, search_name="red thing",
                               log=None)
    want = jfm.run_flag_matrix(make_engines, img, search_name="red thing",
                               log=None)
    drop = {"free_form_s", "search_s"}
    assert [{k: v for k, v in r.items() if k not in drop} for r in rows] \
        == [{k: v for k, v in r.items() if k not in drop} for r in want]
    by_cell = {r["cell"]: r for r in rows}
    assert "int4 importer declined" in by_cell["int4"]["error"]
    assert "int4 importer declined" in by_cell["int4-all-opt-ins"]["error"]
    assert "error" not in by_cell["compiled-search"]
    assert "error" in tfm.format_table(rows)

    def broken_base(**kw):
        raise RuntimeError("no engines at all")

    with pytest.raises(RuntimeError, match="no engines"):
        tfm.run_flag_matrix(broken_base, img, log=None)


def test_runner_matrix_residency_modes(hosts, bench):
    """phased base, parked (always run), co-resident cells on the same
    benchmark: parked and co-resident match the base bit for bit; a
    failing optional cell keeps its error row."""
    def boom():
        raise RuntimeError("int4 checkpoint missing")

    rows = tfm.run_runner_matrix(
        bench, *_factories(hosts),
        coresident_factories=_factories(hosts),
        mixed_factories=(boom, boom), batch=2, log=None,
        free_form_max_new_tokens=8, max_search_steps=2, search_kwargs=FORCED,
        force_missing=lambda s: ["tiny cup"])
    by = {r["cell"]: r for r in rows}
    assert list(by) == ["phased", "parked", "coresident", "mixed-coresident"]
    assert by["parked"]["records_match_base"] is True
    assert by["coresident"]["records_match_base"] is True
    assert by["coresident"]["swap_s"] == 0.0
    for name in ("phased", "parked", "coresident"):
        r = by[name]
        assert r["images_per_s"] > 0 and r["accuracy"] is not None
        assert len(r["phases_s"]) == 3
    assert by["parked"]["accuracy_vs_base"] == 0.0
    assert "int4 checkpoint missing" in by["mixed-coresident"]["error"]
