"""The port's batched V*Bench loop (vstar_tpu_torch/eval/batched_bench.py),
its warmups and the server's lockstep engine against the JAX package's on
the CPU, at tiny widths in f32 on the same weights (core.convert): the
tiny VQA LLM, and the VSM tilted to answer [LOC] at every step
(tests/test_torch_slice.py) so that every search finds boxes. Random
weights never ask for a search, so the first answer is scripted to name
the missing objects, as tests/test_seal.py forces it; everything after it
is the engines' own. Records must be JAX's: every field equal, the boxes
within BOX_ATOL = 1e-2 pixels (tests/test_torch_slice.py's SEAL record)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_server import StubVQA, StubVSM
from tests.test_torch_slice import (BUCKETS, LOC, T_VSM_CFG, TOK, VSM_CFG,
                                    _image, _tilted_vsm_host)
from vstar_tpu.core.config import vqa_llm_tiny
from vstar_tpu.eval import batched_bench as jax_bb
from vstar_tpu.eval import vstar_bench as jax_bench
from vstar_tpu.eval.vqa_engine import VQAEngine as JaxVQAEngine
from vstar_tpu.models.vqa_llm import init_vqa_llm_params as jax_init_vqa
from vstar_tpu.search.batched import BatchedVSMEngine as JaxBatchedVSM
from vstar_tpu.serve.server import SealService as JaxSealService
from vstar_tpu_torch.core import config as tcfg
from vstar_tpu_torch.core.convert import from_numpy_tree
from vstar_tpu_torch.eval import batched_bench, synthetic, vstar_bench
from vstar_tpu_torch.eval.seal import MISSING_OBJECTS_MSG, seal_answer
from vstar_tpu_torch.eval.vqa_engine import VQAEngine, warmup_vqa_engine
from vstar_tpu_torch.search.batched import BatchedVSMEngine, warmup_vsm_engine
from vstar_tpu_torch.serve import server

torch.set_num_threads(1)

BOX_ATOL = 1e-2
# the scripted first answers: which objects each question is missing
MISSING = {"what color is object 0 ?": "tiny cat, red cup",
           "what color is object 1 ?": "dog",
           "What is the color of the small marker?": "red marker"}


def _script_trigger(monkeypatch, classes):
    """First answers name MISSING[question]; focused re-asks decode."""
    for cls in classes:
        for name in ("free_form", "free_form_many"):
            orig = getattr(cls, name)

            def scripted(self, images, questions, _orig=orig,
                         _many=name == "free_form_many", **kw):
                qs = questions if _many else [questions]
                if any("Additional visual" in q for q in qs):
                    return _orig(self, images, questions, **kw)
                out = [f"{MISSING_OBJECTS_MSG} {MISSING[q]}." for q in qs]
                return out if _many else out[0]
            monkeypatch.setattr(cls, name, scripted)


def _vsm_pair(device_preprocess=False):
    host = _tilted_vsm_host(11)
    kw = dict(loc_token_id=LOC, eos_id=2, max_new_tokens=4,
              prompt_buckets=BUCKETS, device_preprocess=device_preprocess)
    return (JaxBatchedVSM(jax.tree_util.tree_map(jnp.asarray, host), VSM_CFG,
                          TOK, compute_dtype=jnp.float32, **kw),
            BatchedVSMEngine(from_numpy_tree(host, "cpu"), T_VSM_CFG, TOK,
                             device="cpu", compute_dtype=torch.float32,
                             **kw))


@pytest.fixture(scope="module")
def vqa_pair():
    """Both VQA engines with 12 object slots: a root accept of the tilted
    VSM keeps up to 9 boxes, and vstar_tpu's bank reads past its slots
    (NaN option losses; ROADMAP Queue 3) where the port encodes them."""
    cfg = dataclasses.replace(vqa_llm_tiny(), max_objects=12)
    tcfg_ = dataclasses.replace(tcfg.vqa_llm_tiny(), max_objects=12)
    host = jax.device_get(jax_init_vqa(jax.random.PRNGKey(3), cfg))
    kw = dict(prompt_buckets=(64, 128, 256), option_bucket=16)
    return (JaxVQAEngine(jax.tree_util.tree_map(jnp.asarray, host), cfg, TOK,
                         compute_dtype=jnp.float32, **kw),
            VQAEngine(from_numpy_tree(host, "cpu"), tcfg_, TOK, device="cpu",
                      compute_dtype=torch.float32, **kw))


def _same_record(got, want):
    assert {k: v for k, v in got.items() if k != "search_result"} == \
        {k: v for k, v in want.items() if k != "search_result"}
    assert [r["name"] for r in got["search_result"]] == \
        [r["name"] for r in want["search_result"]]
    for g, w in zip(got["search_result"], want["search_result"]):
        np.testing.assert_allclose(g["bbox"], w["bbox"], atol=BOX_ATOL,
                                   rtol=0)


def test_eval_batch_gives_jax_records(vqa_pair, monkeypatch):
    """Two samples, three missing objects: their searches run as lockstep
    waves of 3 rows; the records are JAX's eval_batch's and the port's
    serial seal_answer's."""
    jax_vqa, vqa = vqa_pair
    jax_vsm, vsm = _vsm_pair()
    _script_trigger(monkeypatch, (JaxVQAEngine, VQAEngine))
    samples = [{"image": _image(230, 250, 7 + i),
                "question": f"what color is object {i} ?",
                "options": ["red", "blue"]} for i in range(2)]
    waves = []
    orig = vsm._run_many
    monkeypatch.setattr(vsm, "_run_many", lambda p, q: waves.append(len(p))
                        or orig(p, q))
    got = batched_bench.eval_batch(vqa, vsm, samples, max_search_steps=3)
    want = jax_bb.eval_batch(jax_vqa, jax_vsm, samples, max_search_steps=3)
    assert waves and waves[0] == 3
    assert [r["missing_objects"] for r in got] == [["tiny cat", "red cup"],
                                                   ["dog"]]
    assert all(r["search_result"] for r in got)
    for g, w in zip(got, want):
        _same_record(g, w)
    monkeypatch.setattr(vsm, "_run_many", orig)
    for g, s in zip(got, samples):
        _same_record(g, seal_answer(vqa, vsm, s["image"], s["question"],
                                    s["options"], max_search_steps=3))


def test_eval_model_batched_writes_the_jax_result_json(vqa_pair, tmp_path,
                                                       monkeypatch, capsys):
    """eval_model with --image-batch 2 on device-preprocess engines: the
    batched loop (each image's canvas prefetched by the loader thread)
    writes JAX's result JSON."""
    jax_vqa, vqa = vqa_pair
    jax_vsm, vsm = _vsm_pair(device_preprocess=True)
    _script_trigger(monkeypatch, (JaxVQAEngine, VQAEngine))
    synthetic.make_synthetic_benchmark(str(tmp_path / "bench"), n_per_task=2,
                                       seed=0, image_hw=(256, 256), target=3)
    prefetched = []
    orig = vsm.prefetch_canvas
    monkeypatch.setattr(vsm, "prefetch_canvas", lambda im: prefetched.append(
        im) or orig(im))
    out = {}
    for name, mod, pair in (("jax", jax_bench, (jax_vqa, jax_vsm)),
                            ("port", vstar_bench, (vqa, vsm))):
        args = mod.build_parser().parse_args(
            ["--benchmark-folder", str(tmp_path / "bench"),
             "--output-path", str(tmp_path / f"{name}.json"),
             "--image-batch", "2", "--device-preprocess"])
        results, per_type, latencies = mod.eval_model(args, *pair)
        assert per_type is None and latencies is None
        with open(tmp_path / f"{name}.json") as f:
            out[name] = json.load(f)
        assert out[name] == json.loads(json.dumps(results))
    assert capsys.readouterr().out.count("images/s") == 2
    assert len(prefetched) == 4 and not vsm._canvas_inflight
    assert out["port"].keys() == out["jax"].keys()
    for task in out["jax"]:
        assert len(out["port"][task]) == len(out["jax"][task]) == 2
        for g, w in zip(out["port"][task], out["jax"][task]):
            _same_record(g, w)
            assert g["missing_objects"] == ["red marker"]


def test_device_preprocess_flag_needs_a_device_engine(vqa_pair, tmp_path):
    args = vstar_bench.build_parser().parse_args(
        ["--benchmark-folder", str(tmp_path), "--device-preprocess"])
    with pytest.raises(ValueError, match="device_preprocess=True"):
        vstar_bench.eval_model(args, vqa_pair[1], _vsm_pair()[1])


def test_warmups_run_every_bucket(vqa_pair):
    """Both warmups at tiny size: every batch bucket and prompt bucket,
    and the device-preprocess canvas sizes, with their log lines."""
    _, vqa = vqa_pair
    lines = []
    calls = []
    orig = vqa.free_form_many

    def counted(images, questions, **kw):
        calls.append(len(images))
        return orig(images, questions, **kw)

    vqa.free_form_many = counted
    try:
        warmup_vqa_engine(vqa, image_size=64, batch_buckets=(1, 2),
                          max_new_tokens=4, log=lines.append)
    finally:
        del vqa.free_form_many
    # three prompt buckets each, the largest bucket first
    assert calls == [2, 2, 2, 1, 1, 1]
    assert lines == [f"[warmup] vqa B={b} (3 prompt buckets) warmed"
                     for b in (2, 1)]
    _, vsm = _vsm_pair(device_preprocess=True)
    waves = []
    orig_run = vsm._run_many
    vsm._run_many = lambda p, q: waves.append(len(p)) or orig_run(p, q)
    lines.clear()
    warmup_vsm_engine(vsm, canvas_sizes=((64, 64), (96, 128)),
                      batch_buckets=(1, 2), log=lines.append)
    assert waves == [2] * 6 + [1] * 6 + [2, 1]
    assert lines[-1] == "[warmup] vsm canvas 96x128 (group buckets 1/2) warmed"
    assert len(lines) == 7


def _torch_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _torch_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_torch_to_numpy(v) for v in tree)
    return tree.numpy()


def test_random_init_request_searches_in_lockstep(monkeypatch):
    """random_init_engines builds a BatchedVSMEngine: a request whose
    answer names two objects runs detect_many with 2 rows, and the record
    is the JAX SealService's on the same weights."""
    vqa, vsm = server.random_init_engines("tiny", "cpu")
    assert isinstance(vsm, BatchedVSMEngine) and not vsm.device_preprocess
    jax_vqa = JaxVQAEngine(
        jax.tree_util.tree_map(jnp.asarray, _torch_to_numpy(vqa.params)),
        vqa_llm_tiny(), vqa.tokenizer, prompt_buckets=(64,), option_bucket=16,
        compute_dtype=jnp.float32)
    jax_vsm = JaxBatchedVSM(
        jax.tree_util.tree_map(jnp.asarray, _torch_to_numpy(vsm.params)),
        VSM_CFG, vsm.tokenizer, loc_token_id=3, eos_id=2, max_new_tokens=4,
        prompt_buckets=(64,), compute_dtype=jnp.float32)
    _script_trigger(monkeypatch, (JaxVQAEngine, type(vqa)))
    rows = []
    orig = vsm.detect_many
    monkeypatch.setattr(vsm, "detect_many", lambda p, n: rows.append(len(p))
                        or orig(p, n))
    img = _image(96, 128, 9)
    q, opts = "what color is object 0 ?", ["red", "blue", "green"]
    got = server.SealService(vqa, vsm).answer(img, q, opts)
    want = JaxSealService(jax_vqa, jax_vsm).answer(img, q, opts)
    assert rows and rows[0] == 2
    assert got["missing_objects"] == ["tiny cat", "red cup"]
    _same_record({k: v for k, v in got.items() if k != "latency_s"},
                 {k: v for k, v in want.items() if k != "latency_s"})


class _ManyStubVSM(StubVSM):
    """tests/test_torch_server.py's stub VSM with the *_many interface."""

    def detect_many(self, patches, names):
        return [self.detect(p, n) for p, n in zip(patches, names)]

    def vqa_many(self, patches, qs):
        return [self.vqa(p, q) for p, q in zip(patches, qs)]

    def segment_many(self, patches, phrases):
        return [self.segment(p, ph) for p, ph in zip(patches, phrases)]


def test_eval_batch_without_batched_vqa_gives_jax_records():
    """A VQA engine without free_form_many / multiple_choice_many takes the
    per-sample phases (_finish_sample): JAX's records."""
    samples = [{"image": _image(500, 600, 1),
                "question": "what color is the tiny cup?",
                "options": ["red", "blue", "x", "y"]},
               {"image": _image(480, 640, 2),
                "question": "where is the tiny cup?",
                "options": ["left", "right", "up", "down"]}]
    got = batched_bench.eval_batch(StubVQA(), _ManyStubVSM(), samples)
    want = jax_bb.eval_batch(StubVQA(), _ManyStubVSM(), samples)
    assert got == want
    assert [r["missing_objects"] for r in got] == [["tiny cup"]] * 2
    assert all(len(r["search_result"]) == 1 and r["option_chosen"] == 1
               for r in got)
