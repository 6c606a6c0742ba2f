"""The port's evaluation modules against the JAX package's on the CPU:
the synthetic V*Bench with its pixel-scripted engines (accuracy 1.0, the
same records and path lengths, a shifted VSM caught), the search
evaluator (top-1 1.0, visualization written, a shifted VSM caught) and
eval_model's result JSON with the tiny engines on the same weights, at
the decode budgets the benchmark discloses (free-form 32, search 16)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vstar_tpu.core.config import vqa_llm_tiny, vsm_tiny
from vstar_tpu.eval import search_eval as jax_search_eval
from vstar_tpu.eval import synthetic as jax_synthetic
from vstar_tpu.eval import vstar_bench as jax_bench
from vstar_tpu.eval.vqa_engine import VQAEngine as JaxVQAEngine
from vstar_tpu.models.vqa_llm import init_vqa_llm_params as jax_init_vqa
from vstar_tpu.models.vsm import init_vsm_params as jax_init_vsm
from vstar_tpu.multimodal.stub_tokenizer import StubTokenizer
from vstar_tpu.search.engine import VSMEngine as JaxVSMEngine
from vstar_tpu_torch.core import config as tcfg
from vstar_tpu_torch.core.convert import from_numpy_tree
from vstar_tpu_torch.eval import search_eval, synthetic, vstar_bench
from vstar_tpu_torch.eval.seal import MISSING_OBJECTS_MSG
from vstar_tpu_torch.eval.vqa_engine import VQAEngine
from vstar_tpu_torch.search.engine import VSMEngine

torch.set_num_threads(1)

FREE_FORM_BUDGET, SEARCH_BUDGET = 32, 16
BOX_ATOL = 1e-2   # pixels, as tests/test_torch_slice.py's SEAL record


def _shifted(base, dx):
    class Shifted(base):
        def detect(self, patch, name):
            boxes, logits, heat = super().detect(patch, name)
            boxes = boxes.copy()
            boxes[:, 0] += dx          # a systematic x-offset bug
            return boxes, logits, heat
    return Shifted()


def test_synthetic_eval_scores_one_and_matches_jax(tmp_path):
    got = synthetic.run_synthetic_eval(str(tmp_path / "t"), n_per_task=3,
                                       seed=0)
    want = jax_synthetic.run_synthetic_eval(str(tmp_path / "j"),
                                            n_per_task=3, seed=0)
    acc, per_task, path_lengths, results = got
    assert acc == 1.0, (per_task, results)
    assert per_task == {"direct_attributes": 1.0, "relative_position": 1.0}
    assert path_lengths and all(2 <= p <= 12 for p in path_lengths)
    assert got == want


def test_coordinate_regression_is_caught_as_in_jax(tmp_path):
    """tests/test_synthetic_accuracy.py's shifted VSM: accuracy drops
    below 1, sample for sample as in JAX."""
    def run(mod, seal_answer, root):
        specs = mod.make_synthetic_benchmark(str(root), n_per_task=2,
                                             seed=1)
        vqa = mod.ScriptedColorVQA(specs)
        vsm = _shifted(mod.ScriptedColorVSM, 0.15)
        from PIL import Image
        correct = []
        for s in specs:
            img = Image.open(os.path.join(str(root), s["task"], s["image"])
                             ).convert("RGB")
            vqa.set_sample(s["name"])
            rec = seal_answer(vqa, vsm, img,
                              "What is the color of the small marker?",
                              ["a", "b"])
            correct.append(rec["correct"])
        return correct

    from vstar_tpu.eval.seal import seal_answer as jax_seal_answer
    from vstar_tpu_torch.eval.seal import seal_answer
    got = run(synthetic, seal_answer, tmp_path / "t")
    assert np.mean(got) < 1.0
    assert got == run(jax_synthetic, jax_seal_answer, tmp_path / "j")


def _batched(base):
    """The scripted VSM with the *_many interface of a batched engine."""
    class Batched(base):
        def detect_many(self, patches, names):
            return [self.detect(p, n) for p, n in zip(patches, names)]

        def vqa_many(self, patches, qs):
            return [self.vqa(p, q) for p, q in zip(patches, qs)]

        def segment_many(self, patches, phrases):
            return [self.segment(p, ph) for p, ph in zip(patches, phrases)]
    return Batched()


@pytest.mark.parametrize("case", ["scripted", "visualization", "shifted",
                                  "batched"])
def test_evaluate_search_matches_jax(case, tmp_path):
    """Top-1 1.0 with the scripted VSM (and JAX's average path length);
    the visualization writes images; a shifted VSM scores below 1, as in
    JAX; with detect_many and image_batch=3 the searches run in lockstep
    waves on both sides, with JAX's result."""
    seed = {"scripted": 2, "visualization": 4, "shifted": 5,
            "batched": 6}[case]
    bench = tmp_path / "bench"
    synthetic.make_synthetic_benchmark(str(bench), n_per_task=2, seed=seed)
    kw = {}
    if case == "visualization":
        kw = dict(visualization=True, output_path=str(tmp_path / "vis"))
    if case == "shifted":
        vsm, jvsm = (_shifted(synthetic.ScriptedColorVSM, 0.2),
                     _shifted(jax_synthetic.ScriptedColorVSM, 0.2))
    elif case == "batched":
        vsm, jvsm = (_batched(synthetic.ScriptedColorVSM),
                     _batched(jax_synthetic.ScriptedColorVSM))
        kw = dict(image_batch=3)
    else:
        vsm, jvsm = (synthetic.ScriptedColorVSM(),
                     jax_synthetic.ScriptedColorVSM())
    got = search_eval.evaluate_search(vsm, str(bench), **kw)
    if case == "visualization":
        kw["output_path"] = str(tmp_path / "jvis")
    assert got == jax_search_eval.evaluate_search(jvsm, str(bench), **kw)
    if case == "shifted":
        assert got[0] < 1.0
    else:
        assert got[0] == 1.0 and got[1] >= 2.0
    if case == "visualization":
        written = [f for _, _, fs in os.walk(tmp_path / "vis") for f in fs]
        assert any(f.endswith((".png", ".jpg")) for f in written), written


def test_evaluate_search_on_a_compiled_engine(tmp_path):
    """A compiled whole-search engine (search/compiled.CompiledVSMSearch
    on a device-preprocess engine with the tilted tiny VSM) runs the
    search evaluation, with the lockstep waves' result on the same
    engine (512-pixel images at a smallest size of 300: the root and its
    children)."""
    from tests.test_torch_slice import T_VSM_CFG, TOK, _tilted_vsm_host
    from vstar_tpu_torch.search.batched import BatchedVSMEngine
    from vstar_tpu_torch.search.compiled import CompiledVSMSearch

    synthetic.make_synthetic_benchmark(str(tmp_path), n_per_task=1, seed=2,
                                       image_hw=(512, 512))
    eng = BatchedVSMEngine(from_numpy_tree(_tilted_vsm_host(11), "cpu"),
                           T_VSM_CFG, TOK, loc_token_id=3, device="cpu",
                           max_new_tokens=4, prompt_buckets=(64, 128),
                           compute_dtype=torch.float32,
                           device_preprocess=True)
    comp = CompiledVSMSearch(eng)
    calls = []
    orig = comp.search_many
    comp.search_many = lambda *a, **k: calls.append(len(a[0])) or orig(
        *a, **k)
    got = search_eval.evaluate_search(comp, str(tmp_path), minimum_size=300,
                                      image_batch=2)
    assert calls == [2]          # both tasks share one canvas bucket
    assert got == search_eval.evaluate_search(eng, str(tmp_path),
                                              minimum_size=300,
                                              image_batch=2)


class _Budget:
    """An engine whose free_form decodes at most n tokens by default."""

    def __init__(self, engine, n):
        self.engine, self.n = engine, n

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def free_form(self, *args, **kwargs):
        kwargs.setdefault("max_new_tokens", self.n)
        return self.engine.free_form(*args, **kwargs)


def _tiny_engines():
    """(JAX pair, port pair) on the same random weights; both engines
    keep their default template drafts."""
    tok = StubTokenizer(vqa_llm_tiny().llama.vocab_size)
    vqa_host = jax.device_get(jax_init_vqa(jax.random.PRNGKey(3),
                                           vqa_llm_tiny()))
    vsm_host = jax.device_get(jax_init_vsm(jax.random.PRNGKey(4),
                                           vsm_tiny()))
    vqa_kw = dict(prompt_buckets=(64, 128), option_bucket=16)
    vsm_kw = dict(loc_token_id=3, eos_id=2, max_new_tokens=SEARCH_BUDGET,
                  prompt_buckets=(64, 128))
    jax_pair = (
        JaxVQAEngine(jax.tree_util.tree_map(jnp.asarray, vqa_host),
                     vqa_llm_tiny(), tok, compute_dtype=jnp.float32,
                     **vqa_kw),
        JaxVSMEngine(jax.tree_util.tree_map(jnp.asarray, vsm_host),
                     vsm_tiny(), tok, compute_dtype=jnp.float32, **vsm_kw))
    port_pair = (
        VQAEngine(from_numpy_tree(vqa_host, "cpu"), tcfg.vqa_llm_tiny(), tok,
                  device="cpu", compute_dtype=torch.float32, **vqa_kw),
        VSMEngine(from_numpy_tree(vsm_host, "cpu"), tcfg.vsm_tiny(), tok,
                  device="cpu", compute_dtype=torch.float32, **vsm_kw))
    return jax_pair, port_pair


def _same_results(got, want):
    assert got.keys() == want.keys()
    for task in want:
        assert len(got[task]) == len(want[task])
        for g, w in zip(got[task], want[task]):
            assert {k: v for k, v in g.items() if k != "search_result"} \
                == {k: v for k, v in w.items() if k != "search_result"}
            assert [r["name"] for r in g["search_result"]] == \
                [r["name"] for r in w["search_result"]]
            for gr, wr in zip(g["search_result"], w["search_result"]):
                np.testing.assert_allclose(gr["bbox"], wr["bbox"],
                                           atol=BOX_ATOL, rtol=0)


@pytest.mark.parametrize("trigger", [False, True],
                         ids=["free_form", "forced_trigger"])
def test_eval_model_writes_the_jax_result_json(trigger, tmp_path,
                                               monkeypatch, capsys):
    """Two synthetic 256x256 images through both eval_models with the tiny
    engines: the same result JSON. The random VQA never asks for a
    search; the second case scripts its first answer to name the sample's
    marker, and each side's pixel-scripted VSM finds it (one box), so the
    focused re-ask runs on the tiny VQA engine with the object crop."""
    synthetic.make_synthetic_benchmark(str(tmp_path / "bench"), n_per_task=1,
                                       seed=0, image_hw=(256, 256), target=3)
    (jax_vqa, jax_vsm), (vqa, vsm) = _tiny_engines()
    if trigger:
        jax_vsm, vsm = (jax_synthetic.ScriptedColorVSM(),
                        synthetic.ScriptedColorVSM())
        for cls in (JaxVQAEngine, VQAEngine):
            orig = cls.free_form

            def scripted(self, image, question, _orig=orig, **kw):
                if "Additional visual" in question:
                    return _orig(self, image, question, **kw)
                return MISSING_OBJECTS_MSG + " red marker."
            monkeypatch.setattr(cls, "free_form", scripted)
    out = {}
    for name, mod, pair in (("jax", jax_bench, (jax_vqa, jax_vsm)),
                            ("port", vstar_bench, (vqa, vsm))):
        args = mod.build_parser().parse_args(
            ["--benchmark-folder", str(tmp_path / "bench"),
             "--output-path", str(tmp_path / f"{name}.json")])
        results, per_type, latencies = mod.eval_model(
            args, _Budget(pair[0], FREE_FORM_BUDGET), pair[1])
        assert len(latencies) == 2
        with open(tmp_path / f"{name}.json") as f:
            out[name] = json.load(f)
        assert out[name] == json.loads(json.dumps(results))
    printed = capsys.readouterr().out
    assert printed.count("images/s") == 2
    _same_results(out["port"], out["jax"])
    recs = [r for task in out["port"].values() for r in task]
    assert [r["image"] for r in recs] == ["dir_0.png", "rel_0.png"]
    if trigger:
        assert all(r["missing_objects"] == ["red marker"]
                   and len(r["search_result"]) == 1 for r in recs)


def test_eval_model_without_engines_names_the_loaders(tmp_path):
    """Without engines eval_model loads them from the model paths (the
    loaders, tests/test_torch_loaders.py): a path that is not a local
    checkpoint directory is named; one engine alone is refused."""
    args = vstar_bench.build_parser().parse_args(
        ["--benchmark-folder", str(tmp_path)])
    with pytest.raises(FileNotFoundError, match="craigwu/seal_vqa_7b"):
        vstar_bench.eval_model(args, device="cpu")
    with pytest.raises(ValueError, match="both engines or neither"):
        vstar_bench.eval_model(args, object())


def test_eval_model_compiled_wraps_the_vsm(tmp_path, monkeypatch):
    """--compiled: eval_model wraps a device-preprocess VSM engine in
    CompiledVSMSearch and writes the lockstep run's result JSON (the VQA
    scripted to ask for the sample's marker); a host-preprocess engine is
    refused."""
    from vstar_tpu_torch.search.batched import BatchedVSMEngine
    from vstar_tpu_torch.search.compiled import CompiledVSMSearch

    synthetic.make_synthetic_benchmark(str(tmp_path / "bench"), n_per_task=1,
                                       seed=0, image_hw=(256, 256), target=3)
    _, (vqa, host_vsm) = _tiny_engines()
    vsm = BatchedVSMEngine(host_vsm.params, host_vsm.cfg, host_vsm.tokenizer,
                           loc_token_id=3, device="cpu", eos_id=2,
                           max_new_tokens=SEARCH_BUDGET,
                           prompt_buckets=(64, 128),
                           compute_dtype=torch.float32,
                           device_preprocess=True)
    orig = VQAEngine.free_form

    def scripted(self, image, question, **kw):
        if "Additional visual" in question:
            return orig(self, image, question, **kw)
        return MISSING_OBJECTS_MSG + " red marker."
    monkeypatch.setattr(VQAEngine, "free_form", scripted)
    used = []
    search_many = CompiledVSMSearch.search_many
    monkeypatch.setattr(CompiledVSMSearch, "search_many",
                        lambda self, *a, **k: used.append(len(a[0])) or
                        search_many(self, *a, **k))
    out = {}
    for flag in ("--compiled", "--device-preprocess"):
        args = vstar_bench.build_parser().parse_args(
            ["--benchmark-folder", str(tmp_path / "bench"),
             "--output-path", str(tmp_path / f"{flag}.json"), flag])
        results, _, _ = vstar_bench.eval_model(
            args, _Budget(vqa, FREE_FORM_BUDGET), vsm)
        out[flag] = json.loads(json.dumps(results))
    assert used == [1, 1]
    _same_results(out["--compiled"], out["--device-preprocess"])
    args = vstar_bench.build_parser().parse_args(["--compiled"])
    with pytest.raises(ValueError, match="device_preprocess"):
        vstar_bench.eval_model(args, vqa, host_vsm)
