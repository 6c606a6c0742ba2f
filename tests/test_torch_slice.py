"""The ported SEAL slice against the JAX engines at tiny widths (f32 on
the CPU, same weights through core.convert, the stub tokenizer, each side
built from its own package's configs): free-form text (template drafts,
prompt lookup, stop keywords, batched), option choice, VSM detection,
the guided search path and the whole SEAL record must agree (float
outputs to atol 1e-4), and so must the decoder forwards each decode
took: both engines draft from their templates by default. The quantized
slice repeats the comparison with int8 / int4 / int4mix decoders and
int8 towers, with the act-int8 switch off and on."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vstar_tpu.core.config import vqa_llm_tiny, vsm_tiny
from vstar_tpu.eval.seal import MISSING_OBJECTS_MSG
from vstar_tpu.eval.seal import seal_answer as jax_seal_answer
from vstar_tpu.eval.vqa_engine import VQAEngine as JaxVQAEngine
from vstar_tpu.models.vqa_llm import init_vqa_llm_params as jax_init_vqa
from vstar_tpu.models.vsm import init_vsm_params as jax_init_vsm
from vstar_tpu.multimodal.stub_tokenizer import StubTokenizer
from vstar_tpu.nn import quant as jq
from vstar_tpu.search.engine import VSMEngine as JaxVSMEngine
from vstar_tpu.search.policy import visual_search
from vstar_tpu_torch.core import config as tcfg
from vstar_tpu_torch.core.convert import from_numpy_tree
from vstar_tpu_torch.eval import seal as tseal
from vstar_tpu_torch.eval.vqa_engine import VQAEngine
from vstar_tpu_torch.nn import quant as tq
from vstar_tpu_torch.search.batched import run_grouped_searches
from vstar_tpu_torch.search.engine import VSMEngine

torch.set_num_threads(1)

ATOL = 1e-4
VQA_CFG = vqa_llm_tiny()
VSM_CFG = vsm_tiny()
T_VQA_CFG = tcfg.vqa_llm_tiny()
T_VSM_CFG = tcfg.vsm_tiny()
TOK = StubTokenizer(VQA_CFG.llama.vocab_size)
BUCKETS = (64, 128)
FORCED = dict(confidence_high=2.0, target_cue_threshold=-1.0,
              target_cue_threshold_minimum=-1.0)


def _image(h, w, seed):
    return Image.fromarray((np.random.RandomState(seed).rand(h, w, 3)
                            * 255).astype("uint8"))


@pytest.fixture(scope="module")
def vqa_pair():
    jp = jax_init_vqa(jax.random.PRNGKey(21), VQA_CFG)
    jax_eng = JaxVQAEngine(jp, VQA_CFG, TOK, prompt_buckets=BUCKETS,
                           option_bucket=16, compute_dtype=jnp.float32)
    eng = VQAEngine(from_numpy_tree(jax.device_get(jp), "cpu"), T_VQA_CFG,
                    TOK, device="cpu", prompt_buckets=BUCKETS,
                    option_bucket=16, compute_dtype=torch.float32)
    return jax_eng, eng


LOC = 3   # the stub tokenizer's [LOC] id


def _tilted_vsm_host(seed):
    """A tiny VSM tree tilted so that the random model answers [LOC] at
    every step: a large constant on one embedding channel keeps that
    channel of the final hidden state positive, and the lm_head column of
    [LOC] reads it. The heads, heatmaps and the search's target-cue path
    are then exercised on every patch."""
    host = jax.device_get(jax_init_vsm(jax.random.PRNGKey(seed), VSM_CFG))
    host["llama"]["embed_tokens"] = np.array(host["llama"]["embed_tokens"])
    host["llama"]["embed_tokens"][:, 0] += 100.0
    host["llama"]["lm_head"] = np.array(host["llama"]["lm_head"])
    host["llama"]["lm_head"][0, LOC] = 10.0
    return host


# the n_forwards of each speculative decode of the JAX VSM (its engine
# does not report them), appended by a host callback in its program
JAX_VSM_FORWARDS = []


@pytest.fixture(scope="module")
def jax_vsm_forwards():
    """Counts the JAX VSM's verify chunks: vsm_generate's
    speculative_decode, wrapped for every program traced while the
    module runs."""
    import vstar_tpu.models.vsm as jax_vsm
    orig = jax_vsm.speculative_decode

    def counting(*args, **kwargs):
        res = orig(*args, **kwargs)
        jax.debug.callback(lambda n: JAX_VSM_FORWARDS.append(int(n)),
                           res.n_forwards)
        return res

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_vsm, "speculative_decode", counting)
        yield JAX_VSM_FORWARDS


def _vsm_engines(host):
    """Both engines with their default template draft ("Sure, [LOC].")."""
    jax_eng = JaxVSMEngine(jax.tree_util.tree_map(jnp.asarray, host),
                           VSM_CFG, TOK, loc_token_id=LOC, eos_id=2,
                           max_new_tokens=4, prompt_buckets=BUCKETS,
                           compute_dtype=jnp.float32)
    eng = VSMEngine(from_numpy_tree(host, "cpu"), T_VSM_CFG, TOK,
                    loc_token_id=LOC, device="cpu", max_new_tokens=4,
                    prompt_buckets=BUCKETS, compute_dtype=torch.float32)
    return jax_eng, eng


def _detect_both(jax_eng, eng, img, name):
    """Both detections, and both decodes' forwards equal."""
    JAX_VSM_FORWARDS.clear()
    want = jax_eng.detect(img, name)
    jax.effects_barrier()
    got = eng.detect(img, name)
    assert JAX_VSM_FORWARDS and \
        eng.last_decode_stats["forwards"] == JAX_VSM_FORWARDS[-1]
    return want, got


@pytest.fixture(scope="module")
def vsm_pair(jax_vsm_forwards):
    """Both VSM engines on the same tilted weights."""
    return _vsm_engines(_tilted_vsm_host(11))


def test_free_form_same_text(vqa_pair):
    jax_eng, eng = vqa_pair
    img = _image(96, 96, 1)
    want = jax_eng.free_form(img, "what is in the picture?",
                             max_new_tokens=24)
    assert eng.free_form(img, "what is in the picture?",
                         max_new_tokens=24) == want
    # the template draft: the same verify chunks as JAX's
    assert eng.last_decode_stats == jax_eng.last_decode_stats
    assert eng.last_decode_stats["forwards"] >= 1


def test_free_form_stop_keywords_same_text(vqa_pair):
    """Host-chunked decode with keyword stops: a keyword inside the
    answer cuts it there, one that never appears leaves the answer
    whole."""
    jax_eng, eng = vqa_pair
    img = _image(96, 96, 1)
    q = "what is in the picture?"
    full = jax_eng.free_form(img, q, max_new_tokens=24)
    kw = full.split()[len(full.split()) // 2]
    for stop in ([kw], ["never-a-word"]):
        want = jax_eng.free_form(img, q, max_new_tokens=24,
                                 stop_keywords=stop)
        assert eng.free_form(img, q, max_new_tokens=24,
                             stop_keywords=stop) == want
    assert want == full
    cut = eng.free_form(img, q, max_new_tokens=24, stop_keywords=[kw])
    assert cut == full.split(kw)[0].strip() and len(cut) < len(full)


def test_free_form_prompt_lookup_same_text(vqa_pair):
    """prompt_lookup=True: JAX's text and decode stats, and the same text
    as the template-drafted and plain greedy answers."""
    jax_base, eng_base = vqa_pair
    jax_eng = JaxVQAEngine(jax_base.params, VQA_CFG, TOK,
                           prompt_buckets=BUCKETS, option_bucket=16,
                           compute_dtype=jnp.float32, prompt_lookup=True)
    eng = VQAEngine(eng_base.params, T_VQA_CFG, TOK, device="cpu",
                    prompt_buckets=BUCKETS, option_bucket=16,
                    compute_dtype=torch.float32, prompt_lookup=True)
    img = _image(96, 96, 1)
    q = "what is in the picture?"
    want = jax_eng.free_form(img, q, max_new_tokens=24)
    assert eng.free_form(img, q, max_new_tokens=24) == want
    assert eng.last_decode_stats == jax_eng.last_decode_stats
    assert eng_base.free_form(img, q, max_new_tokens=24) == want
    eng_base._spec_template = None      # plain greedy
    try:
        assert eng_base.free_form(img, q, max_new_tokens=24) == want
        assert eng_base.last_decode_stats["tokens_per_forward"] == 1.0
    finally:
        eng_base._spec_template = VQAEngine.SPEC_TEMPLATE


def test_free_form_many_same_texts(vqa_pair):
    """Three images in one padded batch (bucket 4): JAX's texts and decode
    stats, and each row's free_form text."""
    jax_eng, eng = vqa_pair
    imgs = [_image(96, 96, 1), _image(80, 120, 2), _image(100, 70, 3)]
    qs = ["what is in the picture?", "which one?", "what color is it?"]
    want = jax_eng.free_form_many(imgs, qs, max_new_tokens=16)
    got = eng.free_form_many(imgs, qs, max_new_tokens=16)
    assert got == want
    assert eng.last_decode_stats == jax_eng.last_decode_stats
    assert got == [eng.free_form(im, q, max_new_tokens=16)
                   for im, q in zip(imgs, qs)]


def test_multiple_choice_same_option(vqa_pair):
    jax_eng, eng = vqa_pair
    img = _image(80, 120, 2)
    opts = ["a red cup", "the blue book on the left", "green", "none"]
    assert eng.multiple_choice(img, "which one?", opts) == \
        jax_eng.multiple_choice(img, "which one?", opts)
    crops = [eng.get_object_crop(img, [10, 10, 30, 20])]
    np.testing.assert_array_equal(
        crops[0], jax_eng.get_object_crop(img, [10, 10, 30, 20]))
    q = "focus <object> here; which one?"
    kw = dict(images_long=[False], objects_long=[True])
    assert eng.multiple_choice(img, q, opts, crops, **kw) == \
        jax_eng.multiple_choice(img, q, opts, crops, **kw)


def test_detect_same_boxes_logits_heatmap(vsm_pair):
    jax_eng, eng = vsm_pair
    img = _image(360, 460, 0)
    (jb, jl, jh), (tb, tl, th) = _detect_both(jax_eng, eng, img, "cat")
    assert len(tl) == VSM_CFG.owl_vision.grid_size ** 2   # [LOC] emitted
    np.testing.assert_allclose(tb, jb, atol=ATOL, rtol=0)
    np.testing.assert_allclose(tl, jl, atol=ATOL, rtol=0)
    np.testing.assert_allclose(th, jh, atol=ATOL, rtol=0)
    assert eng.vqa(img, "what is here?") == jax_eng.vqa(img, "what is here?")


def test_forced_search_same_path(vsm_pair):
    jax_eng, eng = vsm_pair
    img = _image(300, 520, 3)
    jpath, tpath = [], []
    want = visual_search(jax_eng, img, "cat", smallest_size=100,
                         max_steps=3, path_out=jpath, **FORCED)
    task = tseal.search_tasks(img, ["cat"], minimum_size=100)[0]
    task["path_out"] = tpath
    got = run_grouped_searches(eng, [task], max_steps=3, **FORCED)[0]
    assert len(tpath) == len(jpath) == 3
    assert want[2] and want[0] is not None     # accepted on the fallback
    assert [s.bbox for s in tpath] == [s.bbox for s in jpath]
    np.testing.assert_allclose([s.score or 0.0 for s in tpath],
                               [s.score or 0.0 for s in jpath], atol=ATOL)
    assert got[1:3] == want[1:3]
    np.testing.assert_allclose(got[0].detection_result,
                               want[0].detection_result, atol=1e-2)


def test_seal_record_with_forced_trigger(vqa_pair, vsm_pair, monkeypatch):
    """The whole loop with a scripted trigger answer (as test_seal.py
    forces it), the real VSM engines and option scoring on both sides."""
    (jax_vqa, vqa), (jax_vsm, vsm) = vqa_pair, vsm_pair
    trigger = MISSING_OBJECTS_MSG + " tiny cat."
    for cls in (type(jax_vqa), type(vqa)):
        monkeypatch.setattr(cls, "free_form",
                            lambda self, img, q, **kw: trigger)
    img = _image(240, 400, 4)
    opts = ["red", "blue", "green", "none"]
    want = jax_seal_answer(jax_vqa, jax_vsm, img, "what color?", opts,
                           max_search_steps=3)
    got = tseal.seal_answer(vqa, vsm, img, "what color?", opts,
                            max_search_steps=3)
    assert got["missing_objects"] == want["missing_objects"] == ["tiny cat"]
    assert len(want["search_result"]) == 1     # the fallback detection
    assert [r["name"] for r in got["search_result"]] == \
        [r["name"] for r in want["search_result"]]
    for g, w in zip(got["search_result"], want["search_result"]):
        np.testing.assert_allclose(g["bbox"], w["bbox"], atol=1e-2)
    assert {k: v for k, v in got.items() if k != "search_result"} == \
        {k: v for k, v in want.items() if k != "search_result"}


# ---------------------------------------------------------------------------
# The quantized slice
# ---------------------------------------------------------------------------

def _quantize_host(host, quantize):
    """The JAX package's quantizers over a host tree: each decoder matrix
    as resolve_matrix_quant(quantize, name) says (as init_llama_params'
    quantize does), then the towers (quantize_model_towers)."""
    llama = dict(host["llama"])
    layers = {k: dict(v) for k, v in llama["layers"].items()}

    def quant(w, name):
        mode = jq.resolve_matrix_quant(quantize, name)
        return (jq.quantize_weight_int4_np(w) if mode == "int4"
                else jq.quantize_weight_np(w))

    for group in ("attn", "mlp"):
        layers[group] = {k: quant(w, k) for k, w in layers[group].items()}
    llama["layers"] = layers
    llama["lm_head"] = quant(llama["lm_head"], "lm_head")
    out = jq.quantize_model_towers(jax.tree_util.tree_map(
        jnp.asarray, dict(host, llama=llama)))
    return jax.device_get(out)


@pytest.fixture
def act_switch(request):
    on = request.param
    jq.set_act_int8(on)
    tq.set_act_int8(on)
    yield on
    jq.set_act_int8(False)
    tq.set_act_int8(False)


@pytest.mark.parametrize("act_switch", [False, True], indirect=True,
                         ids=["act_off", "act_int8"])
@pytest.mark.parametrize("quantize", [True, "int4", "int4mix"],
                         ids=["int8", "int4", "int4mix"])
def test_quantized_slice_same_results(quantize, act_switch, monkeypatch,
                                      jax_vsm_forwards):
    """Engines built after the switch is set (the JAX package reads it
    when it traces): greedy text, option choice, detection outputs, the
    forced search path and the SEAL record agree with JAX's."""
    vqa_host = _quantize_host(jax.device_get(
        jax_init_vqa(jax.random.PRNGKey(21), VQA_CFG)), quantize)
    jax_vqa = JaxVQAEngine(jax.tree_util.tree_map(jnp.asarray, vqa_host),
                           VQA_CFG, TOK, prompt_buckets=BUCKETS,
                           option_bucket=16, compute_dtype=jnp.float32)
    vqa = VQAEngine(from_numpy_tree(vqa_host, "cpu"), T_VQA_CFG, TOK,
                    device="cpu", prompt_buckets=BUCKETS, option_bucket=16,
                    compute_dtype=torch.float32)
    assert "q4" in vqa.params["llama"]["lm_head"] or quantize is True
    img = _image(96, 120, 5)
    assert vqa.free_form(img, "what is here?", max_new_tokens=12) == \
        jax_vqa.free_form(img, "what is here?", max_new_tokens=12)
    assert vqa.last_decode_stats == jax_vqa.last_decode_stats
    opts = ["a red cup", "the blue book", "green", "none"]
    assert vqa.multiple_choice(img, "which one?", opts) == \
        jax_vqa.multiple_choice(img, "which one?", opts)

    jax_vsm, vsm = _vsm_engines(_quantize_host(_tilted_vsm_host(11),
                                               quantize))
    big = _image(300, 520, 3)
    (jb, jl, jh), (tb, tl, th) = _detect_both(jax_vsm, vsm, big, "cat")
    assert len(tl) == VSM_CFG.owl_vision.grid_size ** 2   # [LOC] emitted
    for got, want in ((tb, jb), (tl, jl), (th, jh)):
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    jpath, tpath = [], []
    want = visual_search(jax_vsm, big, "cat", smallest_size=100,
                         max_steps=3, path_out=jpath, **FORCED)
    task = tseal.search_tasks(big, ["cat"], minimum_size=100)[0]
    task["path_out"] = tpath
    got = run_grouped_searches(vsm, [task], max_steps=3, **FORCED)[0]
    assert len(tpath) == len(jpath) == 3
    assert [st.bbox for st in tpath] == [st.bbox for st in jpath]
    assert got[1:3] == want[1:3]

    trigger = MISSING_OBJECTS_MSG + " tiny cat."
    for cls in (type(jax_vqa), type(vqa)):
        monkeypatch.setattr(cls, "free_form",
                            lambda self, img, q, **kw: trigger)
    small = _image(240, 400, 4)
    want = jax_seal_answer(jax_vqa, jax_vsm, small, "what color?", opts,
                           max_search_steps=3)
    got = tseal.seal_answer(vqa, vsm, small, "what color?", opts,
                            max_search_steps=3)
    for g, w in zip(got["search_result"], want["search_result"]):
        np.testing.assert_allclose(g["bbox"], w["bbox"], atol=1e-2)
    assert {k: v for k, v in got.items() if k != "search_result"} == \
        {k: v for k, v in want.items() if k != "search_result"}
    assert len(got["search_result"]) == len(want["search_result"])


def test_more_objects_than_slots_are_all_encoded(vqa_pair):
    """A focus prompt naming more objects than max_objects (a search that
    keeps several boxes): the port encodes one bank slot per crop and
    reads each, where vstar_tpu's 3-slot bank is read past its end (its
    gather fills NaN; ROADMAP Queue 3)."""
    _, eng = vqa_pair
    img = _image(120, 160, 6)
    n = VQA_CFG.max_objects + 2
    crops = [eng.get_object_crop(img, [25 * i, 10, 30, 40]) for i in range(n)]
    q = "focus " + " ".join(["<object>"] * n) + " ; which one?"
    lays, bucket, _ = eng._layouts([q], [[False]], [[False] * n])

    def last_logits(crops):
        with torch.inference_mode():
            return eng._prefill([img], [crops], lays, bucket + 16)[0]

    logits = last_logits(crops)
    assert torch.isfinite(logits).all()
    changed = last_logits(crops[:-1] + [255 - crops[-1]])
    assert not torch.equal(logits, changed)
    opts = ["a red cup", "the blue book", "green", "none"]
    assert eng.multiple_choice(img, q, opts, crops, images_long=[False],
                               objects_long=[False] * n) in range(4)
