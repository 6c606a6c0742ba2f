"""The port's int8 KV cache (nn/llama.KVCache in int8 mode) against the
JAX package's on the CPU: the per-(token, head) quantizer's bits and
scales, the tiny decoder's prefill and decode over an int8 cache, the
cache's bytes, and the tiny engines (free-form answer, option choice,
detection, the compiled search) built with kv_int8 on the same weights
(core.convert).

Tolerances: the quantizer's int8 values equal JAX's and its scales agree
to rel 1e-6; the decoder's outputs over the int8 cache are within rel
0.02 of the f32 cache's, the bound tests/test_kv_int8.py states for JAX,
and within ATOL of JAX's own int8-cache outputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_slice import (BUCKETS, LOC, T_VQA_CFG, T_VSM_CFG, TOK,
                                    VQA_CFG, VSM_CFG, _image,
                                    _tilted_vsm_host)
from vstar_tpu.core.config import _tiny_llama
from vstar_tpu.eval.vqa_engine import VQAEngine as JaxVQAEngine
from vstar_tpu.models.vqa_llm import init_vqa_llm_params as jax_init_vqa
from vstar_tpu.nn import llama as jl
from vstar_tpu.search import batched as jb
from vstar_tpu.search import compiled as jc
from vstar_tpu.search.engine import VSMEngine as JaxVSMEngine
from vstar_tpu_torch.core import config as tcfg
from vstar_tpu_torch.core.convert import from_numpy_tree
from vstar_tpu_torch.decode.graphs import DecodeGraphs
from vstar_tpu_torch.eval.vqa_engine import VQAEngine
from vstar_tpu_torch.nn import llama as tl
from vstar_tpu_torch.search import batched as tb
from vstar_tpu_torch.search import compiled as tc
from vstar_tpu_torch.search.engine import VSMEngine

torch.set_num_threads(1)

ATOL = 1e-4
CFG = _tiny_llama()
T_CFG = tcfg._tiny_llama()
FORCED = dict(confidence_high=2.0, target_cue_threshold=-1.0,
              target_cue_threshold_minimum=-1.0)


@pytest.mark.parametrize("shape,scale", [((2, 5, 3, 16), 3.0),
                                         ((1, 9, 2, 128), 0.02),
                                         ((3, 1, 4, 64), 250.0)])
def test_quantize_kv_gives_jax_bits_and_scales(shape, scale):
    x = (np.random.RandomState(len(shape) + int(scale)).randn(*shape)
         * scale).astype(np.float32)
    x[0, 0, 0] = 0.0                      # an all-zero head: the 1e-10 floor
    jq, js = jl._quantize_kv(jnp.asarray(x))
    tq, ts = tl._quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6,
                               atol=0)
    # absmax / 127: the error of each element is at most half its scale
    deq = tq.numpy().astype(np.float32) * ts.numpy()[..., None]
    assert (np.abs(deq - x) <= ts.numpy()[..., None] / 2 + 1e-6).all()


@pytest.fixture(scope="module")
def decoder():
    host = jax.device_get(jl.init_llama_params(jax.random.PRNGKey(1), CFG))
    return host, from_numpy_tree(host, "cpu")


def _jax_decode(params, ids, S_pre, kv_int8):
    B, S = ids.shape
    h = jl.embed_tokens(params, jnp.asarray(ids), jnp.float32)
    pos = jnp.broadcast_to(jnp.arange(S), (B, S))
    cache = jl.init_cache(CFG, B, 32, dtype=jnp.float32, kv_int8=kv_int8)
    out, cache = jl.llama_forward(
        params, CFG, h[:, :S_pre], pos[:, :S_pre],
        jnp.full((B,), S_pre, jnp.int32),
        q_offsets=jnp.zeros((B,), jnp.int32), cache=cache)
    seq = [out]
    for t in range(S_pre, S):
        step, cache = jl.llama_forward(
            params, CFG, h[:, t:t + 1], pos[:, t:t + 1], cache.length + 1,
            q_offsets=cache.length, cache=cache)
        seq.append(step)
    return np.concatenate([np.asarray(s) for s in seq], axis=1)


def _torch_decode(params, ids, S_pre, kv_int8, cache=None):
    B, S = ids.shape
    h = tl.embed_tokens(params, torch.from_numpy(ids), torch.float32)
    pos = torch.arange(S)[None].expand(B, S)
    if cache is None:
        cache = tl.init_cache(T_CFG, B, 32, dtype=torch.float32,
                              kv_int8=kv_int8, device="cpu")
    with torch.no_grad():
        out, cache = tl.llama_forward(
            params, T_CFG, h[:, :S_pre], pos[:, :S_pre],
            torch.full((B,), S_pre, dtype=torch.int32),
            q_offsets=torch.zeros((B,), dtype=torch.int32), cache=cache)
        seq = [out]
        for t in range(S_pre, S):
            step, cache = tl.llama_forward(
                params, T_CFG, h[:, t:t + 1], pos[:, t:t + 1],
                cache.length + 1, q_offsets=cache.length, cache=cache)
            seq.append(step)
    return torch.cat(seq, dim=1).numpy(), cache


def test_int8_cache_decode_close_to_f32_and_to_jax(decoder):
    """Prefill of 10 tokens and 6 cached decode steps: over the int8 cache
    the port's hidden states are JAX's (ATOL) and within rel 0.02 of the
    f32 cache's; the returned cache is the int8 one, at the rows'
    lengths."""
    host, params = decoder
    ids = np.random.RandomState(3).randint(0, CFG.vocab_size, (2, 16))
    want = _jax_decode(jax.tree_util.tree_map(jnp.asarray, host), ids, 10,
                       True)
    got, cache = _torch_decode(params, ids, 10, True)
    ref, _ = _torch_decode(params, ids, 10, False)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    rel = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9)
    assert rel < 0.02, rel
    assert cache.kv_int8 and cache.k.dtype == torch.int8
    assert cache.length.tolist() == [16, 16]
    assert cache.k_scale.shape == cache.k.shape[:-1]


def test_int8_graph_cache_gives_the_same_decode(decoder):
    """The static int8 cache of DecodeGraphs (views of an int8 slab and a
    scale slab) decodes as a fresh init_cache, and a bf16 cache of the
    same key is another cache."""
    host, params = decoder
    ids = np.random.RandomState(4).randint(0, CFG.vocab_size, (2, 12))
    g = DecodeGraphs()
    c8 = g.cache(T_CFG, 2, 32, torch.float32, "cpu", kv_int8=True)
    assert c8.kv_int8 and c8.k.dtype == torch.int8
    assert c8.k_scale.dtype == torch.float32
    got, _ = _torch_decode(params, ids, 8, True, cache=c8)
    want, _ = _torch_decode(params, ids, 8, True)
    np.testing.assert_array_equal(got, want)
    c32 = g.cache(T_CFG, 2, 32, torch.float32, "cpu")
    assert not c32.kv_int8
    assert c32.k.untyped_storage().data_ptr() \
        != c8.k.untyped_storage().data_ptr()
    assert g.cache(T_CFG, 2, 32, torch.float32, "cpu",
                   kv_int8=True) is c8


def _nbytes(cache):
    return sum(t.numel() * t.element_size() for t in cache.tensors())


def test_int8_cache_halves_bytes():
    """int8 k/v plus f32 scales against bf16: (1 + 4 / Dh) / 2 of the
    bytes, in init_cache and in the slabs of DecodeGraphs, at the tiny
    head_dim 16 and the 7B's 128 (0.516)."""
    for cfg in (T_CFG, tcfg.vqa_llm_7b().llama):
        c8 = tl.init_cache(cfg, 2, 32, kv_int8=True, device="meta")
        c16 = tl.init_cache(cfg, 2, 32, dtype=torch.bfloat16, device="meta")
        want = (0.5 + 2.0 / cfg.head_dim)
        assert _nbytes(c8) == pytest.approx(_nbytes(c16) * want)
        assert _nbytes(c8) < 0.65 * _nbytes(c16)
    g8, g16 = DecodeGraphs(), DecodeGraphs()
    g8.cache(T_CFG, 4, 256, torch.bfloat16, "cpu", kv_int8=True)
    g16.cache(T_CFG, 4, 256, torch.bfloat16, "cpu")
    assert g8.cache_bytes() == pytest.approx(
        g16.cache_bytes() * (0.5 + 2.0 / T_CFG.head_dim))


@pytest.fixture(scope="module")
def vqa_pair():
    host = jax.device_get(jax_init_vqa(jax.random.PRNGKey(21), VQA_CFG))
    kw = dict(prompt_buckets=BUCKETS, option_bucket=16, kv_int8=True)
    return (JaxVQAEngine(jax.tree_util.tree_map(jnp.asarray, host), VQA_CFG,
                         TOK, compute_dtype=jnp.float32, **kw),
            VQAEngine(from_numpy_tree(host, "cpu"), T_VQA_CFG, TOK,
                      device="cpu", compute_dtype=torch.float32, **kw))


@pytest.mark.parametrize("mode", ["greedy", "template", "lookup"])
def test_vqa_engine_kv_int8_gives_jax_text(vqa_pair, mode):
    jax_eng, eng = vqa_pair
    img = _image(96, 128, 5)
    for e in (jax_eng, eng):
        e.prompt_lookup = mode == "lookup"
        e._spec_template = None if mode == "greedy" else e.SPEC_TEMPLATE
    try:
        want = jax_eng.free_form(img, "what is this ?", max_new_tokens=12)
        got = eng.free_form(img, "what is this ?", max_new_tokens=12)
    finally:
        for e in (jax_eng, eng):
            e.prompt_lookup = False
            e._spec_template = e.SPEC_TEMPLATE
    assert got == want
    assert eng.graphs.cache(T_VQA_CFG.llama, 1, 128, torch.float32, "cpu",
                            kv_int8=True).kv_int8


def test_vqa_engine_kv_int8_gives_jax_options(vqa_pair):
    """Option scoring: chunked prefill over an int8 prefix cache."""
    jax_eng, eng = vqa_pair
    imgs = [_image(64, 64, 6), _image(80, 60, 7)]
    qs = ["what is this ?", "which colour ?"]
    opts = [["a red cup", "a blue dog", "green"]] * 2
    assert eng.multiple_choice_many(imgs, qs, opts) == \
        jax_eng.multiple_choice_many(imgs, qs, opts)


@pytest.fixture(scope="module")
def vsm_host():
    return _tilted_vsm_host(11)


def test_vsm_engine_kv_int8_gives_jax_detection(vsm_host):
    kw = dict(loc_token_id=LOC, eos_id=2, max_new_tokens=4,
              prompt_buckets=BUCKETS, kv_int8=True)
    jax_eng = JaxVSMEngine(jax.tree_util.tree_map(jnp.asarray, vsm_host),
                           VSM_CFG, TOK, compute_dtype=jnp.float32, **kw)
    eng = VSMEngine(from_numpy_tree(vsm_host, "cpu"), T_VSM_CFG, TOK,
                    device="cpu", compute_dtype=torch.float32, **kw)
    img = _image(120, 160, 8)
    want = jax_eng.detect(img, "cat")
    got = eng.detect(img, "cat")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=0)
    assert eng.vqa(img, "what is it?") == jax_eng.vqa(img, "what is it?")


def test_compiled_search_kv_int8_gives_jax_path(vsm_host):
    """The compiled search on device-preprocess engines built with
    kv_int8: JAX's forced 3-step path and final box."""
    kw = dict(loc_token_id=LOC, eos_id=2, max_new_tokens=4,
              prompt_buckets=BUCKETS, device_preprocess=True, kv_int8=True)
    jeng = jb.BatchedVSMEngine(jax.tree_util.tree_map(jnp.asarray, vsm_host),
                               VSM_CFG, TOK, compute_dtype=jnp.float32, **kw)
    teng = tb.BatchedVSMEngine(from_numpy_tree(vsm_host, "cpu"), T_VSM_CFG,
                               TOK, device="cpu", compute_dtype=torch.float32,
                               **kw)
    img = _image(300, 400, 9)
    jpath, tpath = [], []
    want = jc.CompiledVSMSearch(jeng, P=16).search(
        img, "red cup", smallest_size=96, max_steps=3, path_out=jpath,
        **FORCED)
    got = tc.CompiledVSMSearch(teng, P=16).search(
        img, "red cup", smallest_size=96, max_steps=3, path_out=tpath,
        **FORCED)
    assert [s.bbox for s in tpath] == [s.bbox for s in jpath]
    assert len(tpath) == 3
    assert got[1:3] == want[1:3]
    if want[0] is not None and want[0].detection_result is not None:
        np.testing.assert_allclose(np.asarray(got[0].detection_result),
                                   np.asarray(want[0].detection_result),
                                   atol=ATOL, rtol=0)


@pytest.mark.gpu
def test_quantize_kv_on_card_gives_the_cpu_bits():
    """On the card the quantizer divides by tensors, so its int8 values
    and scales are the CPU's bit for bit (a Python-scalar divisor would
    be a reciprocal multiply there)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.from_numpy((np.random.RandomState(5).randn(2, 64, 8, 128)
                          * 4).astype(np.float32)).to(torch.bfloat16)
    q, s = tl._quantize_kv(x.cuda())
    want_q, want_s = tl._quantize_kv(x)
    assert torch.equal(q.cpu(), want_q) and torch.equal(s.cpu(), want_s)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["greedy", "spec"])
def test_int8_graph_replay_equals_traced_loop_on_card(kind):
    """A decode over the int8 cache by graph replay (the capture's call
    and a pure replay) equals the traced eager loop bit for bit; the
    bf16 cache of the same rows and length is another cache and another
    graph key."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tests.test_torch_decode_loop import EOS, _cuda_setup, _prompt, _same
    from vstar_tpu_torch.decode.sampler import greedy_decode
    from vstar_tpu_torch.decode.speculative import speculative_decode
    cfg, params = _cuda_setup()
    graphs = DecodeGraphs()
    prompt = torch.from_numpy(_prompt(3, B=2).astype(np.int64)).cuda()
    B, S = prompt.shape
    draft = torch.full((2, 24 + 8), EOS, dtype=torch.int32, device="cuda")

    def run(trace, kv_int8=True):
        cache = graphs.cache(cfg, B, 128, torch.bfloat16, "cuda",
                             kv_int8=kv_int8)
        with torch.inference_mode():
            h = tl.embed_tokens(params, prompt, torch.bfloat16)
            hidden, cache = tl.llama_forward(
                params, cfg, h, torch.arange(S, device="cuda")[None]
                .expand(B, S), torch.full((B,), S, dtype=torch.int32,
                                          device="cuda"),
                q_offsets=torch.zeros((B,), dtype=torch.int32,
                                      device="cuda"), cache=cache)
            logits = tl.lm_logits(params, hidden)[:, -1]
            if kind == "greedy":
                return greedy_decode(params, cfg, cache, logits,
                                     hidden[:, -1], 24, [EOS], trace=trace,
                                     graphs=graphs)
            return speculative_decode(params, cfg, cache, logits,
                                      hidden[:, -1], draft, 24, [EOS],
                                      trace=trace, graphs=graphs)

    ref = run([])
    first, second = run(None), run(None)
    assert graphs.captures == 1
    _same(first, ref)
    _same(second, ref)
    assert first.cache.kv_int8
    run(None, kv_int8=False)
    assert graphs.captures == 2
