"""The port's phase-swapped evaluation (vstar_tpu_torch/eval/phased.py)
against the JAX package's on the CPU, at tiny widths in f32 on the same
weights (core.convert): the tiny VQA LLM (12 object slots, as
tests/test_torch_batched_bench.py builds it) and the tiny VSM tilted to
answer [LOC]. The search is forced as the throughput unit forces it
(`force_missing`: random weights never ask for one) under the forced
thresholds, two steps a search. Records must be JAX's (boxes within
BOX_ATOL); the swapped, co-resident and parked runs of the port must give
the same records as each other, and as the port's serial eval_model."""

import dataclasses
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_torch_batched_bench import _same_record
from tests.test_torch_slice import (BUCKETS, LOC, T_VSM_CFG, TOK, VSM_CFG,
                                    _tilted_vsm_host)
from vstar_tpu.core.config import vqa_llm_tiny
from vstar_tpu.eval import phased as jax_phased
from vstar_tpu.eval.vqa_engine import VQAEngine as JaxVQAEngine
from vstar_tpu.models.vqa_llm import init_vqa_llm_params as jax_init_vqa
from vstar_tpu.search.batched import BatchedVSMEngine as JaxBatchedVSM
from vstar_tpu_torch.core import config as tcfg
from vstar_tpu_torch.core.convert import from_numpy_tree
from vstar_tpu_torch.decode.graphs import DecodeGraphs
from vstar_tpu_torch.eval import phased, vstar_bench
from vstar_tpu_torch.eval.vqa_engine import VQAEngine
from vstar_tpu_torch.search.batched import BatchedVSMEngine
from vstar_tpu_torch.search.compiled import CompiledVSMSearch

torch.set_num_threads(1)

VQA_CFG = dataclasses.replace(vqa_llm_tiny(), max_objects=12)
T_VQA_CFG = dataclasses.replace(tcfg.vqa_llm_tiny(), max_objects=12)
FORCED = dict(confidence_high=2.0, target_cue_threshold=-1.0,
              target_cue_threshold_minimum=-1.0)
RUN_KW = dict(minimum_size_scale=4.0, minimum_size=224, batch=2,
              free_form_max_new_tokens=8, max_search_steps=2,
              search_kwargs=FORCED,
              force_missing=lambda s: ["tiny cup"], log=None)


@pytest.fixture(scope="module")
def hosts():
    return (jax.device_get(jax_init_vqa(jax.random.PRNGKey(3), VQA_CFG)),
            _tilted_vsm_host(11))


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """One 250x300 noise image a task, with JAX's test annotation."""
    root = tmp_path_factory.mktemp("bench")
    rng = np.random.RandomState(0)
    for tt in ("direct_attributes", "relative_position"):
        os.makedirs(root / tt)
        Image.fromarray((rng.rand(250, 300, 3) * 255).astype("uint8")).save(
            root / tt / "s0.jpg")
        json.dump({"question": f"what color is cup {tt[:3]}?",
                   "options": ["red", "blue"]},
                  open(root / tt / "s0.json", "w"))
    return str(root)


VQA_KW = dict(prompt_buckets=(64, 128, 256), option_bucket=16)
VSM_KW = dict(loc_token_id=LOC, eos_id=2, max_new_tokens=4,
              prompt_buckets=BUCKETS, device_preprocess=True)


def _factories(hosts, calls=None, **engine_kw):
    """The port's zero-argument engine factories on the host weights."""
    calls = {} if calls is None else calls

    def vqa():
        calls["vqa"] = calls.get("vqa", 0) + 1
        return VQAEngine(from_numpy_tree(hosts[0], "cpu"), T_VQA_CFG, TOK,
                         device="cpu", compute_dtype=torch.float32,
                         **VQA_KW, **engine_kw)

    def vsm():
        calls["vsm"] = calls.get("vsm", 0) + 1
        return BatchedVSMEngine(from_numpy_tree(hosts[1], "cpu"), T_VSM_CFG,
                                TOK, device="cpu", compute_dtype=torch.float32,
                                **VSM_KW, **engine_kw)
    return vqa, vsm


@pytest.fixture(scope="module")
def swapped(hosts, bench):
    """The port's swapped run: (results, per-type, timings, calls)."""
    calls = {}
    out = phased.eval_model_phased(bench, *_factories(hosts, calls),
                                   **RUN_KW)
    return (*out, calls)


def _same_results(got, want):
    assert list(got) == list(want)
    for tt in want:
        assert [r["image"] for r in got[tt]] == [r["image"] for r in want[tt]]
        for g, w in zip(got[tt], want[tt]):
            _same_record(g, w)


def test_phased_gives_jax_records(hosts, bench, swapped):
    """JAX's eval_model_phased on the same weights and forced searches
    (co-resident: JAX's own tests hold it to its swapped run)."""
    results, per_type, timings, calls = swapped
    want, want_per_type, _ = jax_phased.eval_model_phased(
        bench,
        lambda: JaxVQAEngine(jax.tree_util.tree_map(jnp.asarray, hosts[0]),
                             VQA_CFG, TOK, compute_dtype=jnp.float32,
                             **VQA_KW),
        lambda: JaxBatchedVSM(jax.tree_util.tree_map(jnp.asarray, hosts[1]),
                              VSM_CFG, TOK, compute_dtype=jnp.float32,
                              **VSM_KW),
        coresident=True, **RUN_KW)
    _same_results(results, want)
    assert per_type == want_per_type
    assert all(r["missing_objects"] == ["tiny cup"] and r["search_result"]
               for tt in results for r in results[tt])
    assert calls == {"vqa": 2, "vsm": 1}
    for k in ("phase1_s", "phase2_s", "phase3_s", "swap_total_s",
              "images_per_s_steady", "images_per_s_amortized"):
        assert timings[k] >= 0
    assert timings["n_images"] == 2 and timings["n_searches"] == 2
    assert timings["swap_total_s"] > 0


@pytest.mark.parametrize("mode", ["coresident", "parked", "serial"])
def test_swapped_equals_coresident_parked_and_serial(hosts, bench, swapped,
                                                     mode, tmp_path,
                                                     monkeypatch):
    """The same records, bit for bit, from the co-resident run (one build
    each, no swap time), the parked run (the factories run once; phase 3
    re-uploads the parked VQA weights into the same engine) and the
    serial loop (--single-chip-phased off, the search forced the same
    way)."""
    want = swapped[0]
    calls = {}
    vqa_f, vsm_f = _factories(hosts, calls)
    if mode == "serial":
        from vstar_tpu_torch.eval import seal
        monkeypatch.setattr(seal, "parse_missing_objects",
                            lambda p: ["tiny cup"])
        orig = seal.run_grouped_searches
        monkeypatch.setattr(
            seal, "run_grouped_searches",
            lambda vsm, tasks, **kw: orig(vsm, tasks, **{
                **kw, "max_steps": 2, **FORCED}))
        free_form = VQAEngine.free_form
        monkeypatch.setattr(VQAEngine, "free_form",
                            lambda self, im, q, **kw: free_form(
                                self, im, q, **{**kw, "max_new_tokens": 8}))
        args = types.SimpleNamespace(
            benchmark_folder=bench, output_path=str(tmp_path / "s.json"),
            minimum_size_scale=4.0, minimum_size=224, conv_type="v1")
        got, _, _ = vstar_bench.eval_model(args, vqa_f(), vsm_f())
        for tt in want:
            for g, w in zip(got[tt], want[tt]):
                assert g == w
        return
    if mode == "parked":
        vqa_f, vsm_f = phased.parked_factory(vqa_f), \
            phased.parked_factory(vsm_f)
    got, _, t = phased.eval_model_phased(
        bench, vqa_f, vsm_f, coresident=mode == "coresident", **RUN_KW)
    assert got == want
    assert calls == {"vqa": 1, "vsm": 1}
    if mode == "coresident":
        assert t["swap_total_s"] == 0.0
        assert t["images_per_s_steady"] == t["images_per_s_amortized"]
    else:
        eng = vqa_f()
        assert calls == {"vqa": 1, "vsm": 1} and eng.params is not None


def test_free_engine_drops_params_canvases_and_graphs(hosts):
    """free_engine drops the weights, the canvas cache and the engine's
    DecodeGraphs (its static caches, slabs and graphs) for an empty one;
    through a CompiledVSMSearch too."""
    vqa_f, vsm_f = _factories(hosts)
    eng = vsm_f()
    img = Image.fromarray(np.zeros((64, 64, 3), np.uint8))
    eng._canvas(img)
    eng.detect(img, "cat")
    old = eng.graphs
    assert len(eng._canvas_cache) == 1 and old.cache_bytes() > 0
    phased.free_engine(eng)
    assert eng.params is None and len(eng._canvas_cache) == 0
    assert isinstance(eng.graphs, DecodeGraphs) and eng.graphs is not old
    assert eng.graphs.cache_bytes() == 0 and eng.graphs.kept == 0

    comp = CompiledVSMSearch(vsm_f(), P=4)
    phased.free_engine(comp)
    assert comp.engine.params is None
    vqa = vqa_f()
    vqa.free_form(img, "what is this ?", max_new_tokens=4)
    phased.free_engine(vqa)
    assert vqa.params is None and vqa.graphs.cache_bytes() == 0
    phased.free_engine(None)


def test_parked_factory_round_trip(hosts):
    """The parked copy re-uploads the same values into the same engine
    object, with a fresh DecodeGraphs, and the engine answers as
    before."""
    calls = {}
    vqa_f, _ = _factories(hosts, calls)
    pf = phased.parked_factory(vqa_f)
    eng = pf()
    img = Image.fromarray((np.random.RandomState(1).rand(64, 64, 3)
                           * 255).astype("uint8"))
    want = eng.free_form(img, "what is this ?", max_new_tokens=6)
    before = {k: v.clone() for k, v in eng.params["llama"]["layers"]["attn"]
              .items() if isinstance(v, torch.Tensor)}
    phased.free_engine(eng)
    graphs = eng.graphs
    assert pf() is eng and calls == {"vqa": 1}
    assert eng.graphs is not graphs
    for k, v in before.items():
        assert torch.equal(eng.params["llama"]["layers"]["attn"][k], v)
    assert eng.free_form(img, "what is this ?", max_new_tokens=6) == want


def test_eval_model_single_chip_phased(hosts, bench, swapped, tmp_path,
                                       monkeypatch):
    """--single-chip-phased runs eval_model_phased on the given factories
    (an explicit --image-batch honored, 8 unset; --kv-int8 checked on
    each engine a factory builds); without factories it builds them with
    the loaders (the default model paths are no local directories here),
    with engines it is refused."""
    seen = {}
    real = phased.eval_model_phased

    def spy(*a, **kw):
        seen.update(kw)
        return real(*a, **{**kw, **{k: v for k, v in RUN_KW.items()
                                    if k != "batch"}})
    monkeypatch.setattr(phased, "eval_model_phased", spy)
    args = vstar_bench.build_parser().parse_args(
        ["--single-chip-phased", "--image-batch", "2", "--benchmark-folder",
         bench, "--output-path", str(tmp_path / "out.json")])
    results, _, timings = vstar_bench.eval_model(
        args, factories=_factories(hosts))
    assert seen["batch"] == 2 and seen["coresident"] is False
    assert results == swapped[0]
    assert json.load(open(tmp_path / "out.json")) == swapped[0]
    assert timings["n_images"] == 2

    args.image_batch = None
    args.kv_int8 = True
    with pytest.raises(ValueError, match="kv-int8"):
        vstar_bench.eval_model(args, factories=_factories(hosts))
    assert seen["batch"] == 8
    with pytest.raises(FileNotFoundError, match="craigwu/seal_vqa_7b"):
        vstar_bench.eval_model(args, device="cpu")
    with pytest.raises(ValueError, match="factories"):
        vstar_bench.eval_model(args, *_factories(hosts))
