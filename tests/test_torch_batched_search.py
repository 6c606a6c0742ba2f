"""The port's lockstep search (vstar_tpu_torch/search/batched.py) against
the JAX package's on the CPU, at tiny widths in f32 on the same weights
(core.convert; the tilted VSM of tests/test_torch_slice.py, which answers
[LOC] at every step). BatchedVSMEngine's three modes at B = 1 and B = 3
(padded to 4): equal tokens and texts, boxes, scores and heatmaps within
ATOL = 1e-4, the tolerance tests/test_torch_slice.py holds vsm_generate
to; run_batched_searches visits JAX's patches and the port's serial
visual_search's; and the wave split, the canvas cache, the prefetch and
the image_batch == 1 routing on the port alone."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_search_policy import FakeImage, OracleVSM
from tests.test_torch_slice import (ATOL, BUCKETS, FORCED, LOC, T_VSM_CFG,
                                    TOK, VSM_CFG, _image, _tilted_vsm_host)
from vstar_tpu.search import batched as jb
from vstar_tpu.search.policy import PatchRef as JaxPatchRef
from vstar_tpu_torch.core.convert import from_numpy_tree
from vstar_tpu_torch.search import batched as tb
from vstar_tpu_torch.search.policy import PatchRef, visual_search

torch.set_num_threads(1)

NAMES = ["cat", "dog", "cup"]


@pytest.fixture(scope="module")
def engines():
    """(JAX BatchedVSMEngine, the port's), host preprocessing, both with
    their template drafts."""
    host = _tilted_vsm_host(11)
    kw = dict(loc_token_id=LOC, eos_id=2, max_new_tokens=4,
              prompt_buckets=BUCKETS)
    return (jb.BatchedVSMEngine(jax.tree_util.tree_map(jnp.asarray, host),
                                VSM_CFG, TOK, compute_dtype=jnp.float32,
                                **kw),
            tb.BatchedVSMEngine(from_numpy_tree(host, "cpu"), T_VSM_CFG, TOK,
                                device="cpu", compute_dtype=torch.float32,
                                **kw))


def _device_engine(eng):
    """A device-preprocess engine on eng's weights."""
    return tb.BatchedVSMEngine(
        eng.params, T_VSM_CFG, TOK, loc_token_id=LOC, eos_id=2,
        max_new_tokens=4, prompt_buckets=BUCKETS, device="cpu",
        compute_dtype=torch.float32, device_preprocess=True)


def _close(got, want):
    for g, w in zip(got, want):
        assert np.shape(g) == np.shape(w)
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


def test_batch_bucket():
    for n in range(1, 40):
        assert tb._batch_bucket(n) == jb._batch_bucket(n)
    assert [tb._batch_bucket(n) for n in (1, 3, 9, 99)] == [1, 4, 16, 16]


@pytest.mark.parametrize("n", [1, 3])
def test_modes_match_jax(engines, n):
    """detect_many / vqa_many / segment_many at B = n: JAX's tokens (the
    padded rows included), texts, boxes, scores and heatmaps; each row
    also equals the port's serial mode on that patch."""
    jax_eng, eng = engines
    patches = [_image(40 + 8 * i, 60, 30 + i) for i in range(n)]
    qs = [f"Please locate the {m} in this image." for m in NAMES[:n]]
    jout, jn = jax_eng._run_many(patches, qs)
    out, got_n = eng._run_many(patches, qs)
    assert got_n == jn == n and out.tokens.shape[0] == tb._batch_bucket(n)
    np.testing.assert_array_equal(out.tokens.numpy(),
                                  np.asarray(jout.tokens))
    np.testing.assert_array_equal(out.num_generated.numpy(),
                                  np.asarray(jout.num_generated))
    assert bool(out.loc_valid.all())

    for got, want in zip(eng.detect_many(patches, NAMES[:n]),
                         jax_eng.detect_many(patches, NAMES[:n])):
        _close(got, want)
    _close(eng.segment_many(patches, NAMES[:n]),
           jax_eng.segment_many(patches, NAMES[:n]))
    qs = ["what is here?"] * n
    texts = eng.vqa_many(patches, qs)
    assert texts == jax_eng.vqa_many(patches, qs)
    assert texts == [eng.vqa(p, q) for p, q in zip(patches, qs)]
    for got, want in zip(eng.detect_many(patches, NAMES[:n]),
                         [eng.detect(p, m) for p, m in zip(patches, NAMES)]):
        _close(got, want)


def test_lockstep_searches_match_jax_and_serial(engines, monkeypatch):
    """Three forced 3-step searches in lockstep: the port visits JAX's
    lockstep patches and its own serial visual_search's, with the same
    scores, path lengths, acceptance and final boxes."""
    jax_eng, eng = engines
    imgs = [_image(300, 520, 3), _image(280, 400, 5), _image(320, 320, 6)]
    kw = dict(smallest_size=100, max_steps=3, **FORCED)
    jax_paths = []
    orig = jb.visual_search_gen

    def recording(*args, path_out=None, **gkw):
        jax_paths.append(path_out)
        return orig(*args, path_out=path_out, **gkw)

    monkeypatch.setattr(jb, "visual_search_gen", recording)
    want = jb.run_batched_searches(jax_eng, imgs, NAMES, **kw)
    paths = [[] for _ in imgs]
    calls = []
    monkeypatch.setattr(eng, "detect_many", lambda p, n: calls.append(
        len(p)) or tb.BatchedVSMEngine.detect_many(eng, p, n))
    got = tb.run_batched_searches(eng, imgs, NAMES, path_outs=paths, **kw)
    assert calls == [3, 3, 3]       # one 3-row wave per step
    serial_paths = [[] for _ in imgs]
    serial = [visual_search(eng, im, m, path_out=sp, **kw)
              for im, m, sp in zip(imgs, NAMES, serial_paths)]
    for i in range(len(imgs)):
        assert len(paths[i]) == 3
        boxes = [s.bbox for s in paths[i]]
        assert boxes == [s.bbox for s in jax_paths[i]]
        assert boxes == [s.bbox for s in serial_paths[i]]
        scores = [s.score or 0.0 for s in paths[i]]
        np.testing.assert_allclose(
            scores, [s.score or 0.0 for s in jax_paths[i]], atol=ATOL)
        np.testing.assert_allclose(
            scores, [s.score or 0.0 for s in serial_paths[i]], atol=ATOL)
        assert got[i][1:3] == want[i][1:3] == serial[i][1:3]
        assert got[i][2] and got[i][0] is not None
        np.testing.assert_allclose(got[i][0].detection_result,
                                   want[i][0].detection_result, atol=1e-2)
        np.testing.assert_allclose(got[i][0].detection_result,
                                   serial[i][0].detection_result, atol=1e-2)


class BatchedOracle(OracleVSM):
    """The scripted oracle of tests/test_search_policy.py with the *_many
    interface."""

    def detect_many(self, patches, names):
        return [self.detect(p, n) for p, n in zip(patches, names)]

    def vqa_many(self, patches, qs):
        return [self.vqa(p, q) for p, q in zip(patches, qs)]

    def segment_many(self, patches, phrases):
        return [self.segment(p, ph) for p, ph in zip(patches, phrases)]


class EarlyOracle(BatchedOracle):
    def detect(self, patch, name):
        boxes, logits, hm = super().detect(patch, name)
        if name == "easy":          # confident at the root
            boxes[0] = [0.5, 0.5, 0.1, 0.1]
            logits[0] = 0.95
        return boxes, logits, hm


def test_mixed_progress_matches_jax():
    """A search that ends at the root does not stall the other, and the
    results are JAX's."""
    got = tb.run_batched_searches(EarlyOracle(), [FakeImage(), FakeImage()],
                                  ["easy", "needle"], smallest_size=224)
    want = jb.run_batched_searches(EarlyOracle(), [FakeImage(), FakeImage()],
                                   ["easy", "needle"], smallest_size=224)
    (f0, p0, ok0, _), (f1, p1, ok1, _) = got
    assert ok0 and p0 == 1 and ok1 and p1 > 1
    for g, w in zip(got, want):
        assert g[1:3] == w[1:3] and g[0].bbox == w[0].bbox
        np.testing.assert_allclose(g[0].detection_result,
                                   w[0].detection_result)


def test_wave_above_largest_bucket_splits(engines, monkeypatch):
    """With the buckets cut to (1, 2), a 3-row wave runs as device
    batches of 2 and 1 whose outputs concatenate to JAX's 3-row wave."""
    jax_eng, eng = engines
    patches = [_image(40 + 8 * i, 60, 30 + i) for i in range(3)]
    want = jax_eng.detect_many(patches, NAMES)
    monkeypatch.setattr(tb, "BATCH_BUCKETS", (1, 2))
    rows = []
    orig = eng._generate

    def generate(clip, owl, lays, bucket, **kw):
        rows.append(len(lays))
        return orig(clip, owl, lays, bucket, **kw)

    monkeypatch.setattr(eng, "_generate", generate)
    out, n = eng._run_many(patches, [f"Please locate the {m} in this image."
                                     for m in NAMES])
    assert rows == [2, 1] and n == 3 and out.tokens.shape[0] == 3
    for got, w in zip(eng.detect_many(patches, NAMES), want):
        _close(got, w)


def test_device_preprocess_matches_jax(engines):
    """detect_many on device-preprocess PatchRefs (two of one canvas, one
    whole-image window of another) and on a mixed wave (a host patch
    among them): JAX's device-preprocess engine's outputs."""
    jax_eng, eng = engines
    dev = _device_engine(eng)
    jax_dev = jb.BatchedVSMEngine(
        jax_eng.params, VSM_CFG, TOK, loc_token_id=LOC, eos_id=2,
        max_new_tokens=4, prompt_buckets=BUCKETS, compute_dtype=jnp.float32,
        device_preprocess=True)
    img, other = _image(200, 260, 3), _image(150, 120, 4)
    windows = [(img, [0, 0, 260, 200]), (img, [30, 20, 90, 70]),
               (other, [0, 0, 120, 150])]
    refs = [PatchRef(*w) for w in windows]
    jax_refs = [JaxPatchRef(*w) for w in windows]
    assert dev.wants_patch_refs and not eng.wants_patch_refs
    for wave, jax_wave in ((refs, jax_refs),
                           ([refs[1].pil()] + refs[:2],
                            [refs[1].pil()] + jax_refs[:2])):
        names = NAMES[:len(wave)]
        for got, want in zip(dev.detect_many(wave, names),
                             jax_dev.detect_many(jax_wave, names)):
            _close(got, want)


def test_canvas_cache_is_lru(engines):
    dev = _device_engine(engines[1])
    imgs = [Image.new("RGB", (40, 30)) for _ in range(18)]
    for im in imgs:
        dev._canvas(im)
    assert len(dev._canvas_cache) == 16
    assert id(imgs[0]) not in dev._canvas_cache
    assert id(imgs[17]) in dev._canvas_cache
    # a touched survivor outlives the next insert
    dev._canvas(imgs[2])
    dev._canvas(Image.new("RGB", (40, 30)))
    assert id(imgs[2]) in dev._canvas_cache
    dev.set_canvas_capacity(4)
    assert len(dev._canvas_cache) == 4


def test_prefetched_canvas_is_the_built_one(engines):
    dev = _device_engine(engines[1])
    img = _image(100, 130, 7)
    dev.prefetch_canvas(img)
    canvas = dev._canvas(img)
    assert canvas.shape == (512, 512, 3)
    assert not dev._canvas_inflight and id(img) in dev._canvas_cache
    assert dev._canvas(img) is canvas


def test_failed_prefetch_raises_at_canvas(engines, monkeypatch):
    """A canvas build that raises on the prefetch thread raises at
    _canvas and at the wave that needs it: no host fallback."""
    dev = _device_engine(engines[1])
    img = _image(100, 130, 8)

    def broken(image, stream=None):
        raise RuntimeError("canvas upload failed")

    monkeypatch.setattr(dev, "_canvas_build", broken)
    dev.prefetch_canvas(img)
    with pytest.raises(RuntimeError, match="canvas upload failed"):
        dev._canvas(img)
    with pytest.raises(RuntimeError, match="canvas upload failed"):
        dev.detect_many([PatchRef(img, [0, 0, 130, 100])], ["cat"])


def test_image_batch_1_keeps_the_device_engine_batched(engines):
    """At image_batch == 1 a device-preprocess engine stays on the
    lockstep loop (waves of one, PatchRefs kept); a host engine runs
    serial visual_search."""
    seen = {"refs": 0, "pil": 0}

    class RefAware(BatchedOracle):
        wants_patch_refs = True

        def detect_many(self, patches, names):
            for p in patches:
                seen["refs" if isinstance(p, PatchRef) else "pil"] += 1
            return [self.detect(p.pil(), n) for p, n in zip(patches, names)]

    tasks = [{"image": FakeImage(), "name": "needle", "smallest": 224}]
    outs = tb.run_grouped_searches(RefAware(), tasks, image_batch=1)
    assert outs[0][2] and seen["refs"] > 0 and seen["pil"] == 0

    class Host(BatchedOracle):
        def detect_many(self, patches, names):
            raise AssertionError("a host engine at image_batch 1 ran a wave")

    assert tb.run_grouped_searches(Host(), tasks, image_batch=1)[0][2]


def test_compiled_engine_is_dispatched(engines):
    """run_grouped_searches runs a compiled engine (CompiledVSMSearch on a
    device-preprocess engine) through search_many, chunked by canvas
    bucket and capped by image_batch, with the lockstep waves' results on
    the same engine; visualize is refused."""
    from vstar_tpu_torch.search.compiled import CompiledVSMSearch

    eng = _device_engine(engines[1])
    comp = CompiledVSMSearch(eng)
    imgs = [_image(300, 520, 3), _image(280, 400, 5), _image(320, 320, 6)]
    tasks = [{"image": im, "name": nm, "smallest": 100}
             for im, nm in zip(imgs, NAMES)]
    sizes = []
    orig = comp.search_many
    comp.search_many = lambda *a, **k: sizes.append(len(a[0])) or orig(
        *a, **k)
    got = tb.run_grouped_searches(comp, tasks, image_batch=2, max_steps=3,
                                  **FORCED)
    assert sizes == [1, 2]        # canvas buckets 512x1024, 512x512
    want = tb.run_grouped_searches(eng, tasks, max_steps=3, **FORCED)
    for (fw, pw, okw, _), (fg, pg, okg, _) in zip(want, got):
        assert (okg, pg) == (okw, pw)
        assert fg.bbox == fw.bbox
    with pytest.raises(ValueError, match="visualization"):
        tb.run_grouped_searches(comp, tasks, visualize=True)
