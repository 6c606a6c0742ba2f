"""The port's compiled search (vstar_tpu_torch/search/compiled.py) against
the JAX package's on the CPU.

Policy: `visual_search_device_policy` driven by one scripted oracle on
the scenarios of tests/test_compiled_search.py (growth past P, the
grow-limit warning and a user max_steps included): the same VSM calls,
results, and a packed path record equal to JAX's bit for bit except the
queued scores, whose rect sums and heat totals sum in BLAS / reduction
orders that differ between XLA and PyTorch (held to rel 1e-6; measured
<= 6.7e-7).

Fused: CompiledVSMSearch on a device-preprocess BatchedVSMEngine against
JAX's on the same tiny random weights (core.convert), at the cases of
tests/test_compiled_fused.py: the same path (boxes and levels), success
and final box (1e-4). The rest as that file holds the JAX search: the
context cue runs in the steps (no engine wave), an over-bucket segment
phrase falls back to one wave, search_many equals serial search (custom
and mixed buckets), the grouped dispatch, SealService on a compiled VSM,
warmup_compiled, growth past P, and the reruns of capped rows."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_compiled_fused import CFG, ToyTokenizer, _img
from tests.test_compiled_search import SCENARIOS
from tests.test_ref_search_parity import CoordImage, OurAdapter, ScriptedVSM
from vstar_tpu.models.vsm import init_vsm_params as jax_init_vsm
from vstar_tpu.search import batched as jb
from vstar_tpu.search import compiled as jc
from vstar_tpu_torch.core import config as tcfg
from vstar_tpu_torch.core.convert import from_numpy_tree
from vstar_tpu_torch.search import batched as tb
from vstar_tpu_torch.search import compiled as tc

torch.set_num_threads(1)

T_CFG = tcfg.vsm_tiny()
ATOL = 1e-4


def _policy_run(mod, oracle_kw, size=(896, 896), **kw):
    """(result, packed final record, oracle) of one device-policy search;
    the record is read where the search finalizes."""
    got = {}
    orig = mod._finalize

    def spy(state, *a, **k):
        rec = mod.pack_record(state)
        got["rec"] = np.asarray(rec) if mod is jc else rec.numpy()
        return orig(state, *a, **k)

    oracle = ScriptedVSM(**oracle_kw)
    extra = {} if mod is jc else {"device": "cpu"}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "_finalize", spy)
        res = mod.visual_search_device_policy(
            OurAdapter(oracle), CoordImage(*size), "needle",
            smallest_size=224, **kw, **extra)
    return res, got["rec"], oracle


def _same_result(want, got):
    fw, pw, okw, vw = want
    fg, pg, okg, vg = got
    assert (okg, pg) == (okw, pw)
    assert (fg is None) == (fw is None)
    if fw is not None:
        assert (fg.bbox, fg.scale_level) == (fw.bbox, fw.scale_level)
        np.testing.assert_array_equal(np.asarray(fg.detection_result),
                                      np.asarray(fw.detection_result))
    assert (vg is None) == (vw is None)
    if vw is not None:
        np.testing.assert_array_equal(np.asarray(vg), np.asarray(vw))


def _same_record(want, got):
    assert want.shape == got.shape
    _same_rec_p(want, torch.from_numpy(got), (want.shape[0] - 1) // 13)


def _policy_pair(oracle_kw, size=(896, 896), **kw):
    want, wrec, wo = _policy_run(jc, oracle_kw, size, **kw)
    got, grec, go = _policy_run(tc, oracle_kw, size, **kw)
    assert go.detect_calls == wo.detect_calls
    assert go.vqa_calls == wo.vqa_calls
    assert go.segment_calls == wo.segment_calls
    _same_result(want, got)
    _same_record(wrec, grec)
    return got


@pytest.mark.parametrize("scenario", sorted(SCENARIOS) + ["aspect_split"])
def test_device_policy_matches_jax(scenario):
    if scenario == "aspect_split":
        _policy_pair(dict(target=[1500, 100, 60, 50], sigma=40.0),
                     size=(1800, 400))
    else:
        _policy_pair(SCENARIOS[scenario])


@pytest.mark.parametrize("case", ["grows", "grow_limit", "max_steps"])
def test_device_policy_capacity(case, caplog):
    """Growth past P=4 (logged), the grow-limit warning at P=4 =
    grow_limit, and a user max_steps below P (no capacity log): JAX's
    records and results in each."""
    kw = dict(target=[700, 650, 60, 50], max_logit=0.45)
    skw = {"grows": dict(P=4), "grow_limit": dict(P=4, grow_limit=4),
           "max_steps": dict(max_steps=3)}[case]
    with caplog.at_level(logging.INFO, "vstar_tpu_torch.search.compiled"):
        _policy_pair(kw, **skw)
    msgs = [r.getMessage() for r in caplog.records
            if r.name == "vstar_tpu_torch.search.compiled"]
    if case == "grows":
        assert any("growing" in m for m in msgs)
    elif case == "grow_limit":
        assert any("grow-limit" in m for m in msgs)
    else:
        assert not any("capacity" in m for m in msgs)


def test_transitions_match_jax():
    """injected_step, context_push and grow_and_pop one at a time on the
    same inputs: the same exit codes and next boxes, and the packed
    records (scores to rel 1e-6)."""
    rng = np.random.RandomState(0)
    W, H, Pn = 320, 240, 4
    heat = np.zeros((H, W), np.float32)
    heat[:120, 160:] = rng.rand(120, 160).astype(np.float32) * 9
    logits = rng.rand(8).astype(np.float32) * 0.4
    boxes = rng.rand(8, 4).astype(np.float32)
    kw = dict(smallest_size=100, target_cue_threshold=6.0,
              target_cue_threshold_decay=0.7,
              target_cue_threshold_minimum=3.0, max_steps=None)
    js, jst = jc.policy_state_init(W, H, Pn), jc.chain_store_init(Pn, H, W)
    ts, tst = tc.policy_state_init(W, H, Pn), tc.chain_store_init(Pn, H, W)
    for i in range(3):
        h = np.roll(heat, 37 * i, axis=1)
        js, jst, jcode, jnb = jc.injected_step(
            js, jst, True, jnp.asarray(logits), jnp.asarray(boxes),
            jnp.asarray(h), confidence_high=0.5, **kw)
        ts, tst, tcode, tnb = tc.injected_step(
            ts, tst, True, torch.from_numpy(logits), torch.from_numpy(boxes),
            torch.from_numpy(h), confidence_high=0.5, **kw)
        assert int(tcode) == int(jcode)
        assert tnb.tolist() == np.asarray(jnb).tolist()
        _same_rec_p(jc.pack_record(js), tc.pack_record(ts), Pn)
    js, jst, jcode, jnb = jc.context_push(js, jst, jnp.asarray(heat), **kw)
    ts, tst, tcode, tnb = tc.context_push(ts, tst, torch.from_numpy(heat),
                                          **kw)
    assert int(tcode) == int(jcode) and \
        tnb.tolist() == np.asarray(jnb).tolist()
    _same_rec_p(jc.pack_record(js), tc.pack_record(ts), Pn)
    js, jst, jcode, _ = jc.grow_and_pop(js, jst, P2=8, max_steps=None)
    ts, tst, tcode, _ = tc.grow_and_pop(ts, tst, P2=8, max_steps=None)
    assert int(tcode) == int(jcode) and tst.shape == jst.shape
    _same_rec_p(jc.pack_record(js), tc.pack_record(ts), 8)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), rtol=1e-6,
                               atol=1e-9)


def _same_rec_p(want, got, p):
    """Packed records (pack_record: n, bbox 4P, level P, parent P, score
    P, top logit P, stash P, det box 4P) bit for bit but the scores."""
    want, got = np.asarray(want), got.numpy()
    scores = slice(1 + 6 * p, 1 + 7 * p)
    bits = np.ones(want.shape, bool)
    bits[scores] = False
    np.testing.assert_array_equal(want[bits].view(np.int32),
                                  got[bits].view(np.int32))
    np.testing.assert_allclose(got[scores], want[scores], rtol=1e-6, atol=0)


def test_resize_clip_canvas_matches_jax():
    rng = np.random.RandomState(1)
    low = rng.randn(16, 16).astype(np.float32)
    for bbox in ([10, 20, 100, 60], [0, 0, 200, 150], [37, 5, 13, 90]):
        want = np.asarray(jc.resize_clip_canvas(jnp.asarray(low),
                                                jnp.asarray(bbox), 160, 210))
        got = tc.resize_clip_canvas(torch.from_numpy(low),
                                    torch.tensor(bbox), 160, 210).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    rects = np.array([[0, 0, 50, 40], [50, 0, 60, 40], [0, 40, 50, 30],
                      [50, 40, 60, 30]], np.int32)
    heat = rng.rand(160, 210).astype(np.float32)
    np.testing.assert_allclose(
        tc.rect_sums(torch.from_numpy(heat)[None],
                     torch.from_numpy(rects)[None])[0].numpy(),
        np.asarray(jc.rect_sums(jnp.asarray(heat), jnp.asarray(rects))),
        rtol=1e-6)
    for bbox in ([0, 0, 100, 300], [0, 0, 300, 100], [5, 5, 101, 99]):
        np.testing.assert_array_equal(
            tc.child_rects(torch.tensor([bbox], dtype=torch.int32))[0]
            .numpy(), np.asarray(jc.child_rects(jnp.asarray(bbox))))


# ---------------------------------------------------------------------------
# The fused search on a tiny random VSM
# ---------------------------------------------------------------------------

def _engines_kw():
    return dict(eos_id=2, max_new_tokens=4, prompt_buckets=(64, 128),
                device_preprocess=True, speculative_template=None)


@pytest.fixture(scope="module")
def fused_pair():
    """(JAX CompiledVSMSearch, the port's) over device-preprocess engines
    on the same tiny weights; [LOC] is whatever token the random model
    emits first (as tests/test_compiled_fused.py sets it)."""
    host = jax.device_get(jax_init_vsm(jax.random.PRNGKey(11), CFG))
    tok = ToyTokenizer()
    jeng = jb.BatchedVSMEngine(jax.tree_util.tree_map(jnp.asarray, host),
                               CFG, tok, loc_token_id=0,
                               compute_dtype=jnp.float32, **_engines_kw())
    teng = tb.BatchedVSMEngine(from_numpy_tree(host, "cpu"), T_CFG, tok,
                               loc_token_id=0, device="cpu",
                               compute_dtype=torch.float32, **_engines_kw())
    probe = _img(0, 64, 64)
    out, _ = teng._run_many([probe], ["probe"])
    jeng.loc_token_id = teng.loc_token_id = int(out.tokens[0, 0])
    return jc.CompiledVSMSearch(jeng, P=16), tc.CompiledVSMSearch(teng, P=16)


def _same_search(want, got, want_path=None, got_path=None):
    fw, pw, okw, vw = want
    fg, pg, okg, vg = got
    assert (okg, pg) == (okw, pw)
    assert (fg is None) == (fw is None)
    if fw is not None:
        assert (fg.bbox, fg.scale_level) == (fw.bbox, fw.scale_level)
        if fw.detection_result is not None:
            np.testing.assert_allclose(np.asarray(fg.detection_result),
                                       np.asarray(fw.detection_result),
                                       atol=ATOL, rtol=ATOL)
    assert (vg is None) == (vw is None)
    if vw is not None:
        np.testing.assert_allclose(np.asarray(vg), np.asarray(vw),
                                   atol=ATOL, rtol=ATOL)
    if want_path is not None:
        assert [(s.bbox, s.scale_level, s.parent_index,
                 s.context_cue is None) for s in got_path] == \
            [(s.bbox, s.scale_level, s.parent_index, s.context_cue is None)
             for s in want_path]


@pytest.mark.parametrize("seed,small", [(0, 120), (3, 200)])
def test_fused_matches_jax(fused_pair, seed, small):
    jcomp, tcomp = fused_pair
    img = _img(seed)
    jpath, tpath = [], []
    want = jcomp.search(img, "cat", smallest_size=small, max_steps=8,
                        path_out=jpath)
    got = tcomp.search(img, "cat", smallest_size=small, max_steps=8,
                       path_out=tpath)
    _same_search(want, got, jpath, tpath)
    assert tcomp.last_host_reads >= len(tpath) + 1


def _spy(monkeypatch, eng):
    calls = []
    orig = eng._run_many

    def spy(images, questions):
        calls.append(list(questions))
        return orig(images, questions)

    monkeypatch.setattr(eng, "_run_many", spy)
    return calls


def test_context_cue_runs_in_step(fused_pair, monkeypatch):
    """The context answer, segment and push run in the fused steps: no
    engine wave, and the path records context cues."""
    _, comp = fused_pair
    calls = _spy(monkeypatch, comp.engine)
    path = []
    comp.search(_img(7), "cat", smallest_size=120, max_steps=8,
                path_out=path)
    assert calls == []
    assert any(s.context_cue for s in path)


def test_seg_phrase_overflow_falls_back(fused_pair, monkeypatch):
    _, comp = fused_pair
    calls = _spy(monkeypatch, comp.engine)
    long_phrase = "spot " * 40    # overflows the 64-token bucket
    import vstar_tpu_torch.search.policy as tpol
    monkeypatch.setattr(tpol, "context_phrase",
                        lambda *a, **k: long_phrase)
    comp.search(_img(8), "cat", smallest_size=120, max_steps=8)
    assert len(calls) >= 1
    assert all(long_phrase in q for qs in calls for q in qs)


@pytest.mark.parametrize("buckets", [None, (1, 2, 4, 8)])
def test_search_many_matches_serial(fused_pair, buckets):
    _, comp0 = fused_pair
    comp = tc.CompiledVSMSearch(comp0.engine, P=16, batch_buckets=buckets)
    n = 3 if buckets is None else 5
    imgs = [_img(31 + i) for i in range(n)]
    names = ["cat", "dog", "cup", "hat", "box"][:n]
    smalls = [120, 150, 120, 200, 150][:n]
    outs = comp.search_many(imgs, names, smalls, max_steps=6)
    assert len(outs) == n
    for i in range(n):
        _same_search(comp.search(imgs[i], names[i], smallest_size=smalls[i],
                                 max_steps=6), outs[i])


def test_grouped_dispatch(fused_pair):
    """run_grouped_searches sends a compiled engine through search_many,
    chunked by canvas bucket (mixed buckets here), with each task's
    serial search result; visualize is refused."""
    _, comp = fused_pair
    tasks = [
        {"image": _img(41, 360, 460), "name": "cat", "smallest": 150},
        {"image": _img(42, 360, 460), "name": "dog", "smallest": 150},
        {"image": _img(43, 600, 700), "name": "cup", "smallest": 200},
        {"image": _img(44, 360, 460), "name": "hat", "smallest": 150},
    ]
    sizes = []
    orig = comp.search_many

    def spy(images, *a, **k):
        sizes.append(len(images))
        return orig(images, *a, **k)

    comp.search_many = spy
    try:
        got = tb.run_grouped_searches(comp, tasks, max_steps=3)
    finally:
        del comp.search_many
    assert sizes == [2, 1, 1]
    for t, g in zip(tasks, got):
        _same_search(comp.search(t["image"], t["name"],
                                 smallest_size=t["smallest"], max_steps=3), g)
    with pytest.raises(ValueError, match="visualization"):
        tb.run_grouped_searches(comp, tasks, visualize=True)


def test_seal_service_and_warmup(fused_pair):
    """serve --compiled: SealService's search phase runs on the compiled
    engine; warmup_compiled runs every (batch bucket) once and logs it;
    prefetch_canvas and set_canvas_capacity delegate."""
    from vstar_tpu_torch.serve.server import SealService

    _, comp = fused_pair

    class TriggerVQA:
        def free_form(self, image, question, **kw):
            if "Additional visual" in question:
                return "it is red"
            return ("Sorry, I can not answer the question. Some visual "
                    "information about the following objects is missing "
                    "or unclear: tiny cup.")

        def get_object_crop(self, image, bbox, patch_scale):
            return np.zeros((28, 28, 3), np.uint8)

    rec = SealService(TriggerVQA(), comp, minimum_size=150).answer(
        _img(51), "what color is the tiny cup?")
    assert rec["missing_objects"] == ["tiny cup"]
    assert "search_result" in rec and "answer" in rec
    logs = []
    tc.warmup_compiled(comp, canvas_sizes=((96, 128),), batch_buckets=(1, 2),
                       log=logs.append)
    assert len(logs) == 2
    seen = []
    eng = comp.engine
    orig = eng.prefetch_canvas
    eng.prefetch_canvas = seen.append
    try:
        img = _img(14)
        comp.prefetch_canvas(img)
    finally:
        eng.prefetch_canvas = orig
    assert seen == [img]


def test_grows_past_P_and_reruns_capped_rows(fused_pair, caplog):
    """A search that outgrows P=2 grows on the device and matches the
    lockstep host policy on the same engine; batched rows that outgrow
    the shared P rerun serially with the same results."""
    _, comp0 = fused_pair
    eng = comp0.engine
    comp = tc.CompiledVSMSearch(eng, P=2, grow_limit=64)
    kw = dict(confidence_high=2.0, confidence_low=0.0)
    imgs = [_img(62), _img(63)]
    with caplog.at_level(logging.INFO, "vstar_tpu_torch.search.compiled"):
        one = comp.search(imgs[0], "cat", smallest_size=120, **kw)
        many = comp.search_many(imgs, ["cat", "dog"], [120, 120], **kw)
    msgs = [r.getMessage() for r in caplog.records]
    assert any("growing" in m for m in msgs)
    assert any("re-running serially" in m for m in msgs)
    host = tb.run_batched_searches(eng, imgs, ["cat", "dog"],
                                   smallest_size=120, **kw)
    assert one[1] > 2
    _same_search(host[0], one)
    for h, m in zip(host, many):
        _same_search(h, m)
