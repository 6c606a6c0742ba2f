"""The port's continuous serving (vstar_tpu_torch/serve/continuous.py, its
MicroBatcher) against the JAX package's on the CPU: the cases of
tests/test_continuous.py on the same stub engines, with records held to
the JAX SealService's, and the OOM stubs raising torch.cuda.OutOfMemoryError
(the only error the port splits a wave on); then the tiny engines behind
the port's and JAX's ContinuousSealService, three concurrent requests in
one wave, the same records (boxes within tests/test_torch_batched_bench's
BOX_ATOL)."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_torch_batched_bench import _same_record, _vsm_pair, vqa_pair
from tests.test_torch_server import StubVQA, StubVSM
from vstar_tpu.serve.continuous import \
    ContinuousSealService as JaxContinuousSealService
from vstar_tpu.serve.server import SealService as JaxSealService
from vstar_tpu_torch.serve.batching import MicroBatcher
from vstar_tpu_torch.serve.continuous import ContinuousSealService
from vstar_tpu_torch.serve.server import SealService

__all__ = ["vqa_pair"]   # the fixture, imported for the tiny-engine case

torch.set_num_threads(1)


def _img(w=600, h=500):
    return Image.fromarray(np.zeros((h, w, 3), np.uint8))


class BatchedStubVSM(StubVSM):
    def detect_many(self, patches, names):
        return [self.detect(p, n) for p, n in zip(patches, names)]

    def vqa_many(self, patches, qs):
        return [self.vqa(p, q) for p, q in zip(patches, qs)]

    def segment_many(self, patches, phrases):
        return [self.segment(p, ph) for p, ph in zip(patches, phrases)]


class RecordingVQA(StubVQA):
    """StubVQA with the batched interfaces + question logging."""

    def __init__(self):
        self.seen_questions = []

    def free_form(self, image, question, **kw):
        self.seen_questions.append(question)
        return super().free_form(image, question, **kw)

    def free_form_many(self, images, questions, **kw):
        return [self.free_form(im, q) for im, q in zip(images, questions)]

    def multiple_choice_many(self, images, questions, options_list, **kw):
        self.seen_questions.extend(questions)
        return [1] * len(images)


class StubVQAWithMany(StubVQA):
    def free_form_many(self, images, questions, **kw):
        return [self.free_form(im, q) for im, q in zip(images, questions)]

    def multiple_choice_many(self, images, questions, options_list, **kw):
        return [1] * len(images)


def _oom(msg="CUDA out of memory. Tried to allocate 2.00 GiB"):
    return torch.cuda.OutOfMemoryError(msg)


@pytest.fixture()
def engines():
    return RecordingVQA(), BatchedStubVSM()


def _strip_latency(rec):
    rec = dict(rec)
    rec.pop("latency_s", None)
    return rec


def _jax_serial(options=None, vsm=StubVSM):
    return _strip_latency(JaxSealService(StubVQA(), vsm()).answer(
        _img(), "what color is it?", options))


def test_microbatcher_groups_by_key():
    calls = []

    def run_batch(key, items):
        calls.append((key, list(items)))
        return [x * 10 for x in items]

    mb = MicroBatcher(run_batch, max_batch=4, window_ms=50)
    try:
        futs = [mb.submit("a", i) for i in range(3)]
        assert [f.result(timeout=5) for f in futs] == [0, 10, 20]
        assert any(len(items) > 1 for _, items in calls)
        fa, fb = mb.submit("a", 1), mb.submit("b", 2)
        assert fa.result(timeout=5) == 10 and fb.result(timeout=5) == 20
        assert all(len({k for k, _ in calls if k == key}) == 1
                   for key in ("a", "b"))
    finally:
        mb.close()


def test_continuous_matches_serial_service(engines):
    vqa, vsm = engines
    want_ff, want_mc = _jax_serial(), _jax_serial(["red", "blue"])
    assert _strip_latency(SealService(StubVQA(), StubVSM()).answer(
        _img(), "what color is it?", ["red", "blue"])) == want_mc
    svc = ContinuousSealService(vqa, vsm, max_batch=8, window_ms=120.0)
    try:
        results = {}

        def go(key, options):
            results[key] = _strip_latency(
                svc.answer(_img(), "what color is it?", options))

        threads = [threading.Thread(target=go, args=("ff%d" % i, None))
                   for i in range(3)]
        threads += [threading.Thread(target=go, args=("mc%d" % i,
                                                      ["red", "blue"]))
                    for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        for i in range(3):
            assert results[f"ff{i}"] == want_ff
            assert results[f"mc{i}"] == want_mc
        st = svc.stats()
        assert st["requests"] == 6
        assert st["max_wave"] > 1, f"no co-batching happened: {st}"
        assert st["mean_wave"] == 6 / st["waves"]
    finally:
        svc.close()


def test_mixed_option_counts_group_separately(engines):
    vqa, vsm = engines
    svc = ContinuousSealService(vqa, vsm, max_batch=8, window_ms=120.0)
    try:
        results = {}

        def go(key, options):
            results[key] = svc.answer(_img(), "what color is it?", options)

        threads = [
            threading.Thread(target=go, args=("a", ["red", "blue"])),
            threading.Thread(target=go, args=("b", ["x", "y", "z"])),
            threading.Thread(target=go, args=("c", ["red", "blue"])),
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert all(r["option_chosen"] == 1 for r in results.values())
        assert results["b"]["options"] == ["x", "y", "z"]
    finally:
        svc.close()


class WeakStubVSM(BatchedStubVSM):
    """Detection never crosses confidence_high; the search ends on the
    <0.3 fallback: search unsuccessful but a weak box exists."""

    def detect(self, patch, name):
        boxes = np.zeros((4, 4), np.float32)
        boxes[0] = [0.5, 0.5, 0.25, 0.25]
        return boxes, np.asarray([0.2, 0, 0, 0], np.float32), \
            np.ones((patch.height, patch.width), np.float32)


@pytest.mark.parametrize("continuous", [False, True])
def test_failed_object_keeps_weak_box_and_focus_clause(continuous):
    """app.py:165-179: an unsuccessful search lands in failed_objects AND
    keeps its fallback box; the focus message carries the 'not existent
    in the image' clause (app.py:215-223); the record is JAX's, served
    serially or continuously."""
    vqa = RecordingVQA()
    svc = (ContinuousSealService(vqa, WeakStubVSM(), max_batch=2,
                                 window_ms=1.0) if continuous
           else SealService(vqa, WeakStubVSM()))
    try:
        rec = svc.answer(_img(120, 80), "what color is the tiny cup?")
    finally:
        if continuous:
            svc.close()
    assert _strip_latency(rec) == _strip_latency(
        JaxSealService(StubVQA(), WeakStubVSM()).answer(
            _img(120, 80), "what color is the tiny cup?"))
    assert rec["failed_objects"] == ["tiny cup"]
    assert len(rec["search_result"]) == 1
    assert rec["answer"] == "it is red"
    focus_qs = [q for q in vqa.seen_questions if "Additional visual" in q]
    assert focus_qs and "tiny cup not existent in the image" in focus_qs[0]


def test_error_in_wave_propagates_and_service_survives(engines):
    _, vsm = engines

    class BoomVQA(RecordingVQA):
        def __init__(self):
            super().__init__()
            self.n = 0

        def free_form_many(self, images, questions, **kw):
            self.n += 1
            if self.n == 1:
                raise RuntimeError("boom")
            return super().free_form_many(images, questions, **kw)

    svc = ContinuousSealService(BoomVQA(), vsm, max_batch=4, window_ms=5.0)
    try:
        with pytest.raises(RuntimeError, match="boom"):
            svc.answer(_img(), "q?")
        rec = svc.answer(_img(), "q?")  # next wave works
        assert "answer" in rec
    finally:
        svc.close()


def test_close_fails_pending_instead_of_hanging(engines):
    class SlowVQA(RecordingVQA):
        def free_form_many(self, images, questions, **kw):
            time.sleep(0.3)
            return super().free_form_many(images, questions, **kw)

    svc = ContinuousSealService(SlowVQA(), engines[1], max_batch=2,
                                window_ms=5.0)
    errs = []

    def go():
        try:
            svc.answer(_img(), "q?")
        except BaseException as e:
            errs.append(e)

    threads = [threading.Thread(target=go) for _ in range(4)]
    for t in threads:
        t.start()
    svc.close()
    for t in threads:
        t.join(timeout=15)
    assert not any(t.is_alive() for t in threads), "caller hung after close"
    with pytest.raises(RuntimeError):
        svc.answer(_img(), "q?")


class NoTriggerVQA(RecordingVQA):
    """Never emits the missing-objects trigger sentence (like random
    weights)."""

    def free_form(self, image, question, **kw):
        self.seen_questions.append(question)
        return "a perfectly ordinary answer"


def test_missing_parser_and_search_kwargs_force_search():
    """missing_parser forces the search path when the trigger sentence
    never appears, and search_kwargs reach the policy
    (confidence_high=2.0: the detection lands in the weak fallback); the
    records are JAX's service's on the same stubs."""
    kw = dict(max_batch=2, window_ms=5.0,
              missing_parser=lambda p: ["forced gadget"],
              search_kwargs=dict(confidence_high=2.0))
    recs = []
    for cls in (ContinuousSealService, JaxContinuousSealService):
        svc = cls(NoTriggerVQA(), BatchedStubVSM(), **kw)
        try:
            recs.append(_strip_latency(
                svc.answer(_img(), "what color is it?", ["red", "blue"])))
        finally:
            svc.close()
    rec, want = recs
    assert rec == want
    assert rec["missing_objects"] == ["forced gadget"]
    assert [r["name"] for r in rec["search_result"]] == ["forced gadget"]

    svc2 = ContinuousSealService(NoTriggerVQA(), BatchedStubVSM(),
                                 max_batch=2, window_ms=5.0)
    try:
        rec2 = svc2.answer(_img(), "what color is it?", ["red", "blue"])
        assert rec2["missing_objects"] == []
        assert rec2["search_result"] == []
    finally:
        svc2.close()


# -- pipeline=True (three-thread stage overlap) ---------------------------


class StageLogVQA(RecordingVQA):
    """Logs stage entries ('trigger'/'finish') and optionally blocks each
    free_form_many call on a gate."""

    def __init__(self, gate=None):
        super().__init__()
        self.stages = []
        self.gate = gate
        self._lock = threading.Lock()

    def free_form_many(self, images, questions, **kw):
        with self._lock:
            self.stages.append("trigger")
        if self.gate is not None:
            assert self.gate.wait(timeout=10), "test gate never released"
        return super().free_form_many(images, questions, **kw)

    def multiple_choice_many(self, images, questions, options_list, **kw):
        with self._lock:
            self.stages.append("finish")
        return super().multiple_choice_many(images, questions,
                                            options_list, **kw)


class GateVSM(BatchedStubVSM):
    """Blocks every detect_many wave on a gate (the search stage)."""

    def __init__(self, gate):
        self.gate = gate
        self.entered = threading.Event()

    def detect_many(self, patches, names):
        self.entered.set()
        assert self.gate.wait(timeout=10), "test gate never released"
        return super().detect_many(patches, names)


def _submit(svc, results, key, options=None):
    def go():
        try:
            results[key] = _strip_latency(
                svc.answer(_img(), "what color is it?", options))
        except BaseException as e:
            results[key] = e
    t = threading.Thread(target=go)
    t.start()
    return t


def test_pipeline_records_match_nonpipeline(engines):
    vqa, vsm = engines
    base = ContinuousSealService(StubVQAWithMany(), BatchedStubVSM(),
                                 max_batch=8, window_ms=60.0)
    pipe = ContinuousSealService(vqa, vsm, max_batch=8, window_ms=60.0,
                                 pipeline=True)
    try:
        want_ff = _strip_latency(base.answer(_img(), "what color is it?"))
        want_mc = _strip_latency(
            base.answer(_img(), "what color is it?", ["red", "blue"]))
        assert (want_ff, want_mc) == (_jax_serial(),
                                      _jax_serial(["red", "blue"]))
        results = {}
        threads = [_submit(pipe, results, f"ff{i}") for i in range(3)]
        threads += [_submit(pipe, results, f"mc{i}", ["red", "blue"])
                    for i in range(3)]
        for t in threads:
            t.join(timeout=30)
        for i in range(3):
            assert results[f"ff{i}"] == want_ff
            assert results[f"mc{i}"] == want_mc
    finally:
        base.close()
        pipe.close()


def test_pipeline_overlaps_trigger_with_search():
    """Wave B's trigger (VQA worker) runs while wave A's search (VSM
    worker) is still in flight."""
    search_gate = threading.Event()
    vqa = StageLogVQA()
    vsm = GateVSM(search_gate)
    svc = ContinuousSealService(vqa, vsm, max_batch=1, window_ms=1.0,
                                pipeline=True)
    results = {}
    try:
        ta = _submit(svc, results, "a", ["red", "blue"])
        assert vsm.entered.wait(timeout=10)
        tb = _submit(svc, results, "b", ["red", "blue"])
        deadline = time.monotonic() + 10
        while vqa.stages.count("trigger") < 2:
            assert time.monotonic() < deadline, \
                f"no overlap: stages={vqa.stages}"
            time.sleep(0.005)
        assert not search_gate.is_set()
        search_gate.set()
        ta.join(timeout=15)
        tb.join(timeout=15)
        assert results["a"]["option_chosen"] == 1
        assert results["b"]["option_chosen"] == 1
    finally:
        search_gate.set()
        svc.close()


def test_pipeline_finish_drains_before_trigger():
    """A finished search and a fresh admission both queued for the VQA
    worker: the finish stage runs first."""
    search_gate = threading.Event()
    vqa_gate = threading.Event()
    vqa = StageLogVQA()
    vsm = GateVSM(search_gate)
    svc = ContinuousSealService(vqa, vsm, max_batch=1, window_ms=1.0,
                                pipeline=True)
    results = {}
    try:
        ta = _submit(svc, results, "a", ["red", "blue"])
        assert vsm.entered.wait(timeout=10)
        vqa.gate = vqa_gate
        tb = _submit(svc, results, "b", ["red", "blue"])
        deadline = time.monotonic() + 10
        while vqa.stages.count("trigger") < 2:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        tc = _submit(svc, results, "c", ["red", "blue"])
        search_gate.set()
        deadline = time.monotonic() + 10
        while not svc._s_finish.qsize():
            assert time.monotonic() < deadline
            time.sleep(0.005)
        vqa.gate = None
        vqa_gate.set()
        for t in (ta, tb, tc):
            t.join(timeout=15)
        fin_a = vqa.stages.index("finish")
        trig_c = len(vqa.stages) - 1 - vqa.stages[::-1].index("trigger")
        assert fin_a < trig_c, f"finish queued behind trigger: {vqa.stages}"
        for k in ("a", "b", "c"):
            assert results[k]["option_chosen"] == 1, results[k]
    finally:
        search_gate.set()
        vqa_gate.set()
        svc.close()


def test_pipeline_stage_error_fails_only_its_wave():
    class BoomOnceVSM(BatchedStubVSM):
        def __init__(self):
            self.n = 0

        def detect_many(self, patches, names):
            self.n += 1
            if self.n == 1:
                raise RuntimeError("search boom")
            return super().detect_many(patches, names)

    svc = ContinuousSealService(StubVQAWithMany(), BoomOnceVSM(),
                                max_batch=1, window_ms=1.0, pipeline=True)
    try:
        with pytest.raises(RuntimeError, match="search boom"):
            svc.answer(_img(), "what color is it?", ["red", "blue"])
        rec = svc.answer(_img(), "what color is it?", ["red", "blue"])
        assert rec["option_chosen"] == 1
    finally:
        svc.close()


def test_pipeline_close_with_inflight_waves_fails_futures():
    """close() while waves sit in stage queues AND inside a stage: every
    caller gets an exception, none hang."""
    search_gate = threading.Event()
    vqa = StageLogVQA()
    vsm = GateVSM(search_gate)
    svc = ContinuousSealService(vqa, vsm, max_batch=1, window_ms=1.0,
                                pipeline=True)
    results = {}
    threads = [_submit(svc, results, "a", ["red", "blue"])]
    assert vsm.entered.wait(timeout=10)
    threads.append(_submit(svc, results, "b", ["red", "blue"]))
    deadline = time.monotonic() + 10
    while vqa.stages.count("trigger") < 2:
        assert time.monotonic() < deadline
        time.sleep(0.005)
    closer = threading.Thread(target=svc.close)
    closer.start()
    time.sleep(0.05)
    search_gate.set()
    closer.join(timeout=20)
    assert not closer.is_alive(), "close() hung"
    for t in threads:
        t.join(timeout=15)
        assert not t.is_alive(), "caller hung after close"
    for k in ("a", "b"):
        assert isinstance(results[k], RuntimeError), results[k]


class OOMAboveTwoVQA(RecordingVQA):
    """The card running out of memory for trigger waves larger than 2."""

    def __init__(self):
        super().__init__()
        self.wave_sizes = []

    def free_form_many(self, images, questions, **kw):
        self.wave_sizes.append(len(images))
        if len(images) > 2:
            raise _oom()
        return super().free_form_many(images, questions, **kw)


@pytest.mark.parametrize("pipeline", [False, True])
def test_oom_wave_splits_instead_of_failing(pipeline):
    """A wave that runs out of device memory is halved and retried, on
    the same engines, transparently to callers: all requests complete
    with JAX's serial records, and stats() counts the splits."""
    want = _jax_serial(["red", "blue"])
    svc = ContinuousSealService(OOMAboveTwoVQA(), BatchedStubVSM(),
                                max_batch=8, window_ms=150.0,
                                pipeline=pipeline)
    try:
        results = {}

        def go(k):
            results[k] = _strip_latency(
                svc.answer(_img(), "what color is it?", ["red", "blue"]))

        threads = [threading.Thread(target=go, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        for i in range(6):
            assert results[i] == want
        assert svc.stats()["oom_splits"] >= 1
        assert max(svc.vqa.wave_sizes) > 2
        assert svc.vqa.wave_sizes[-1] <= 2
    finally:
        svc.close()


@pytest.mark.parametrize("error", [
    _oom("CUDA out of memory. Tried to allocate 1.00 GiB"),
    RuntimeError("RESOURCE_EXHAUSTED: Out of memory")],
    ids=["cuda_oom", "other_error"])
def test_oom_single_request_is_a_real_error(engines, error):
    """Splitting bottoms out at one request: its OOM propagates to the
    caller, and the service survives for the next wave. Any other error,
    whatever its message (vstar_tpu's string match would take this one
    for an OOM), is never split: it fails its whole wave."""
    _, vsm = engines

    class FailingOnceVQA(RecordingVQA):
        def __init__(self):
            super().__init__()
            self.n = 0

        def free_form_many(self, images, questions, **kw):
            self.n += 1
            if self.n == 1:
                raise error
            return super().free_form_many(images, questions, **kw)

    svc = ContinuousSealService(FailingOnceVQA(), vsm, max_batch=4,
                                window_ms=5.0)
    try:
        with pytest.raises(type(error)):
            svc.answer(_img(), "q?")
        assert svc.stats()["oom_splits"] == 0
        rec = svc.answer(_img(), "q?")
        assert "answer" in rec
    finally:
        svc.close()

    calls = []

    def stage(reqs):
        calls.append(len(reqs))
        raise error

    svc = ContinuousSealService(RecordingVQA(), vsm, max_batch=1,
                                window_ms=1.0)
    try:
        with pytest.raises(type(error)):
            svc._split_on_oom(stage, [1, 2, 3, 4])
    finally:
        svc.close()
    is_oom = isinstance(error, torch.cuda.OutOfMemoryError)
    assert calls == ([4, 2, 1] if is_oom else [4])
    assert ContinuousSealService._is_oom(error) == is_oom


def test_split_on_oom_slices_parallel_columns(engines):
    """The splitter slices every per-row column in lockstep with the
    wave."""
    vqa, vsm = engines
    svc = ContinuousSealService(vqa, vsm, max_batch=1, window_ms=1.0)
    try:
        def stage(reqs, colA, colB):
            if len(reqs) > 1:
                raise _oom()
            return ([r * 10 for r in reqs], [a + b for a, b in
                                             zip(colA, colB)])

        out = svc._split_on_oom(stage, [1, 2, 3], [10, 20, 30],
                                [100, 200, 300])
        assert out == ([10, 20, 30], [110, 220, 330])

        def boom(reqs):
            raise ValueError("not an oom")
        with pytest.raises(ValueError):
            svc._split_on_oom(boom, [1, 2])
    finally:
        svc.close()


def test_oom_caps_future_wave_admission():
    """After an OOM split, future waves form at the size that fit, and 32
    clean cap-sized waves regrow the cap one doubling."""
    vqa = OOMAboveTwoVQA()
    svc = ContinuousSealService(vqa, BatchedStubVSM(), max_batch=8,
                                window_ms=150.0)
    try:
        results = {}

        def go(k):
            results[k] = svc.answer(_img(), "q?", ["red", "blue"])

        def burst(keys):
            ts = [threading.Thread(target=go, args=(k,)) for k in keys]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=30)
                assert not t.is_alive()

        burst(range(6))
        assert svc.stats()["wave_cap"] in (2, 3)
        splits_after_first = svc.stats()["oom_splits"]
        n0 = len(vqa.wave_sizes)
        burst(range(10, 16))
        assert max(vqa.wave_sizes[n0:]) <= 3
        assert svc.stats()["oom_splits"] <= splits_after_first + 1
        assert svc.stats()["wave_cap"] == 2
        for i in range(8):
            go(f"trickle{i}")
        assert svc.stats()["wave_cap"] == 2
        for i in range(32):
            burst((f"regrow{i}a", f"regrow{i}b"))
        assert svc.stats()["wave_cap"] == 4
    finally:
        svc.close()


def test_service_bounds_engine_canvas_cache():
    """Serving bounds the VSM engine's retained canvases to two waves
    (vstar_tpu's branch without a relay: the next wave's prefetched
    uploads overlap the current one)."""
    class CapVSM(BatchedStubVSM):
        cap = None

        def set_canvas_capacity(self, n):
            self.cap = n

    vsm = CapVSM()
    ContinuousSealService(RecordingVQA(), vsm, max_batch=8,
                          window_ms=1.0).close()
    assert vsm.cap == 16


def test_engine_canvas_capacity_trims_immediately():
    import collections

    from vstar_tpu_torch.search.batched import BatchedVSMEngine
    eng = BatchedVSMEngine.__new__(BatchedVSMEngine)  # no params needed
    eng._canvas_cache = collections.OrderedDict(
        (i, (None, None, None)) for i in range(12))
    eng._canvas_capacity = 16
    eng._canvas_lock = threading.Lock()
    eng.set_canvas_capacity(3)
    assert list(eng._canvas_cache) == [9, 10, 11]   # LRU kept the newest


def test_tiny_engines_give_jax_records(vqa_pair):
    """The tiny VQA LLM and the tilted tiny VSM behind both services:
    three concurrent requests (two with options, one free-form) form one
    wave of 3 on each side; the forced 2-step searches and every record
    are JAX's."""
    jax_vqa, vqa = vqa_pair
    jax_vsm, vsm = _vsm_pair()
    imgs = [Image.fromarray((np.random.RandomState(s).rand(230, 250, 3)
                             * 255).astype("uint8")) for s in range(3)]
    reqs = [("what color is object 0 ?", ["red", "blue"]),
            ("what color is object 1 ?", None),
            ("what color is object 2 ?", ["red", "blue"])]
    kw = dict(max_batch=3, window_ms=5000.0, max_search_steps=2,
              missing_parser=lambda p: ["red cup"],
              search_kwargs=dict(confidence_high=2.0,
                                 target_cue_threshold=-1.0,
                                 target_cue_threshold_minimum=-1.0))
    out = {}
    for side, cls, engines in (("port", ContinuousSealService, (vqa, vsm)),
                               ("jax", JaxContinuousSealService,
                                (jax_vqa, jax_vsm))):
        svc = cls(*engines, **kw)
        recs = [None] * 3

        def go(i, svc=svc, recs=recs):
            recs[i] = _strip_latency(svc.answer(imgs[i], *reqs[i]))

        threads = [threading.Thread(target=go, args=(i,)) for i in range(3)]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
                assert not t.is_alive()
            assert svc.stats()["waves"] == 1
        finally:
            svc.close()
        out[side] = recs
    for got, want in zip(out["port"], out["jax"]):
        assert got["missing_objects"] == ["red cup"]
        assert got["search_result"]
        _same_record(got, want)
