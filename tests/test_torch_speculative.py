"""The port's decode (vstar_tpu_torch/decode) against the JAX package's on
the same weights (tiny f32 decoder, numpy seeds through core.convert):
speculative_decode and lookup_decode give JAX's token arrays (stop
padding included), num_generated, n_forwards and cache lengths exactly
and its hiddens to 1e-4, and the port's own greedy_decode's tokens; the
cases are tests/test_speculative.py's. sample_token: temperature 0 is the
argmax, the top-p kept set is JAX's, and a seeded torch.Generator replays
its draws inside that set."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vstar_tpu.core.config import _tiny_llama
from vstar_tpu.decode import sampler as jax_sampler
from vstar_tpu.decode.speculative import lookup_decode as jax_lookup
from vstar_tpu.decode.speculative import speculative_decode as jax_spec
from vstar_tpu.nn import llama as jl
from vstar_tpu_torch.core import config as tcfg
from vstar_tpu_torch.core.convert import from_numpy_tree
from vstar_tpu_torch.decode.sampler import (greedy_decode, sample_token,
                                            top_p_filter)
from vstar_tpu_torch.decode.speculative import (lookup_decode,
                                                speculative_decode)
from vstar_tpu_torch.nn import llama as tl

torch.set_num_threads(1)

CFG = _tiny_llama()
T_CFG = tcfg._tiny_llama()
PARAMS = jl.init_llama_params(jax.random.PRNGKey(7), CFG)
T_PARAMS = from_numpy_tree(jax.device_get(PARAMS), "cpu")
EOS = 2
MAX_NEW = 12
HID_ATOL = 1e-4


def _jax_prefill(prompt, cache_len):
    ids = jnp.asarray(prompt)
    B, S = ids.shape
    cache = jl.init_cache(CFG, B, cache_len, dtype=jnp.float32)
    h = jl.embed_tokens(PARAMS, ids, jnp.float32)
    hidden, cache = jl.llama_forward(
        PARAMS, CFG, h, jnp.broadcast_to(jnp.arange(S), (B, S)),
        jnp.full((B,), S, jnp.int32), q_offsets=jnp.zeros((B,), jnp.int32),
        cache=cache)
    return jl.lm_logits(PARAMS, hidden)[:, -1], hidden[:, -1], cache


def _torch_prefill(prompt, cache_len):
    ids = torch.from_numpy(np.asarray(prompt))
    B, S = ids.shape
    cache = tl.init_cache(T_CFG, B, cache_len, torch.float32, device="cpu")
    h = tl.embed_tokens(T_PARAMS, ids, torch.float32)
    hidden, cache = tl.llama_forward(
        T_PARAMS, T_CFG, h, torch.arange(S)[None].expand(B, S),
        torch.full((B,), S, dtype=torch.int32),
        q_offsets=torch.zeros((B,), dtype=torch.int32), cache=cache)
    return tl.lm_logits(T_PARAMS, hidden)[:, -1], hidden[:, -1], cache


def _run(kind, prompt, *, chunk=4, cache_len=64, draft=None, ctx=None,
         ctx_len=None, rigged=None):
    """(JAX result, port result) of one decode from the same prompt;
    kind is 'spec' or 'lookup'. rigged replaces the first logits."""
    jlog, jhid, jcache = _jax_prefill(prompt, cache_len)
    tlog, thid, tcache = _torch_prefill(prompt, cache_len)
    if rigged is not None:
        jlog, tlog = jnp.asarray(rigged), torch.from_numpy(rigged)
    with torch.inference_mode():
        if kind == "spec":
            want = jax_spec(PARAMS, CFG, jcache, jlog, jhid,
                            jnp.asarray(draft), MAX_NEW, [EOS], chunk=chunk,
                            compute_dtype=jnp.float32)
            got = speculative_decode(T_PARAMS, T_CFG, tcache, tlog, thid,
                                     torch.from_numpy(np.asarray(draft)),
                                     MAX_NEW, [EOS], chunk=chunk,
                                     compute_dtype=torch.float32)
        else:
            if ctx is None:
                ctx = np.asarray(prompt, np.int32)
            if ctx_len is None:
                ctx_len = np.full((ctx.shape[0],), ctx.shape[1], np.int32)
            want = jax_lookup(PARAMS, CFG, jcache, jlog, jhid,
                              jnp.asarray(ctx, jnp.int32),
                              jnp.asarray(ctx_len, jnp.int32), MAX_NEW,
                              [EOS], chunk=chunk, compute_dtype=jnp.float32)
            got = lookup_decode(T_PARAMS, T_CFG, tcache, tlog, thid,
                                torch.from_numpy(np.asarray(ctx, np.int32)),
                                torch.from_numpy(np.asarray(ctx_len,
                                                            np.int32)),
                                MAX_NEW, [EOS], chunk=chunk,
                                compute_dtype=torch.float32)
    return want, got


def _greedy(prompt, cache_len=64, rigged=None):
    logits, hidden, cache = _torch_prefill(prompt, cache_len)
    if rigged is not None:
        logits = torch.from_numpy(rigged)
    with torch.inference_mode():
        return greedy_decode(T_PARAMS, T_CFG, cache, logits, hidden, MAX_NEW,
                             [EOS], torch.float32)


def _check(want, got, ref):
    """got equals JAX's `want` and the port's greedy `ref`."""
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.num_generated.numpy(),
                                  np.asarray(want.num_generated))
    assert got.n_forwards == int(want.n_forwards)
    np.testing.assert_array_equal(got.cache.length.numpy(),
                                  np.asarray(want.cache.length))
    np.testing.assert_allclose(got.hiddens.numpy(), np.asarray(want.hiddens),
                               atol=HID_ATOL, rtol=0)
    np.testing.assert_array_equal(got.tokens.numpy(), ref.tokens.numpy())
    np.testing.assert_array_equal(got.num_generated.numpy(),
                                  ref.num_generated.numpy())
    np.testing.assert_array_equal(got.cache.length.numpy(),
                                  ref.cache.length.numpy())


def _context_with_answer(prompt, ref):
    """[prompt, the row's greedy answer, -1 padding] and its lengths."""
    toks = ref.tokens.numpy()
    C = prompt.shape[1] + MAX_NEW + 2
    ctx = np.full((prompt.shape[0], C), -1, np.int32)
    lens = np.zeros((prompt.shape[0],), np.int32)
    for b in range(prompt.shape[0]):
        row = list(prompt[b]) + toks[b, :int(ref.num_generated[b])].tolist()
        ctx[b, :len(row)] = row
        lens[b] = len(row)
    return ctx, lens


def test_greedy_matches_jax():
    prompt = np.random.RandomState(0).randint(3, CFG.vocab_size, (2, 6))
    logits, hidden, cache = _jax_prefill(prompt, 64)
    want = jax_sampler.greedy_decode(PARAMS, CFG, cache, logits, hidden,
                                     MAX_NEW, [EOS],
                                     compute_dtype=jnp.float32)
    got = _greedy(prompt)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    assert got.n_forwards == int(want.n_forwards)


@pytest.mark.parametrize("case", ["random", "perfect", "forced_stop",
                                  "minimum_capacity"])
def test_speculative_matches_jax_and_greedy(case):
    """Random draft; a perfect draft (the greedy answer, unshifted) with
    the acceptance bound; a first token forced to EOS on row 0; and the
    documented minimum cache (prompt + max_new + chunk - 2) under a draft
    that is never accepted, which pushes the chunk writes to the cache's
    last entry."""
    rng = np.random.RandomState({"random": 0, "perfect": 1,
                                 "forced_stop": 2,
                                 "minimum_capacity": 8}[case])
    prompt = rng.randint(3, CFG.vocab_size, (1 if case == "minimum_capacity"
                                             else 2, 6))
    B = prompt.shape[0]
    ref = _greedy(prompt)
    kw = {}
    draft = rng.randint(3, CFG.vocab_size, (B, MAX_NEW + 4))
    if case == "perfect":
        draft = np.full((B, MAX_NEW + 4), EOS, np.int32)
        draft[:, :MAX_NEW] = ref.tokens.numpy()
    elif case == "forced_stop":
        rigged = _torch_prefill(prompt, 64)[0].numpy().copy()
        rigged[0, :] = -1e9
        rigged[0, EOS] = 1e9
        kw["rigged"] = rigged
        ref = _greedy(prompt, rigged=rigged)
    elif case == "minimum_capacity":
        draft = np.full((B, MAX_NEW + 4), -1, np.int32)
        kw["cache_len"] = prompt.shape[1] + MAX_NEW + 4 - 2
    want, got = _run("spec", prompt, draft=draft, **kw)
    _check(want, got, ref)
    if case == "perfect":
        n_max = int(ref.num_generated.max())
        assert got.n_forwards <= int(np.ceil((n_max - 1) / 4)), \
            (got.n_forwards, n_max)
    if case == "forced_stop":
        assert int(got.num_generated[0]) == 1
        assert (got.tokens[0] == EOS).all()


def test_speculative_refuses_a_narrow_draft():
    prompt = np.random.RandomState(0).randint(3, CFG.vocab_size, (1, 6))
    logits, hidden, cache = _torch_prefill(prompt, 64)
    with pytest.raises(ValueError, match="max_new_tokens \\+ chunk - 1"):
        speculative_decode(T_PARAMS, T_CFG, cache, logits, hidden,
                           torch.zeros((1, MAX_NEW + 2), dtype=torch.int32),
                           MAX_NEW, [EOS], chunk=4,
                           compute_dtype=torch.float32)


@pytest.mark.parametrize("case", ["random_0", "random_1", "random_2",
                                  "answer_in_context", "repetitive",
                                  "masked_context"])
def test_lookup_matches_jax_and_greedy(case):
    """Random prompts at chunks 3-5 (spurious matches, mostly rejected);
    the greedy answer inside the context (high acceptance); a repeating
    prompt (many n-gram ties: the earliest-longest rule); a context that
    is mostly -1 slots, which are never proposed."""
    kw = {}
    if case.startswith("random"):
        trial = int(case[-1])
        prompt = np.random.RandomState(3 + 10 * trial).randint(
            3, CFG.vocab_size, (2, 5 + trial))
        kw["chunk"] = 3 + trial
    elif case == "answer_in_context":
        prompt = np.random.RandomState(4).randint(3, CFG.vocab_size, (2, 6))
        kw["ctx"], kw["ctx_len"] = _context_with_answer(prompt,
                                                        _greedy(prompt))
    elif case == "repetitive":
        base = np.random.RandomState(5).randint(3, CFG.vocab_size, (1, 3))
        prompt = np.tile(base, (2, 3))
    else:
        prompt = np.random.RandomState(6).randint(3, CFG.vocab_size, (2, 6))
        ctx = np.full((2, 24), -1, np.int32)
        ctx[:, 4:10] = prompt
        kw["ctx"], kw["ctx_len"] = ctx, np.full((2,), 10, np.int32)
    want, got = _run("lookup", prompt, **kw)
    _check(want, got, _greedy(prompt))
    if case == "answer_in_context":
        assert got.n_forwards < int(got.num_generated.max()) - 1


def test_n_forwards_counts_acceptance():
    """Greedy takes one forward per token after the first; a draft that is
    never accepted takes as many verify chunks; a lookup whose context
    holds the answer takes under half as many."""
    prompt = np.random.RandomState(7).randint(3, CFG.vocab_size, (2, 6))
    ref = _greedy(prompt)
    assert ref.n_forwards == int(ref.num_generated.max()) - 1
    never = np.full((2, MAX_NEW + 4), -1, np.int32)
    want, got = _run("spec", prompt, draft=never)
    _check(want, got, ref)
    assert got.n_forwards == ref.n_forwards
    ctx, lens = _context_with_answer(prompt, ref)
    want, got = _run("lookup", prompt, ctx=ctx, ctx_len=lens)
    _check(want, got, ref)
    assert got.n_forwards < ref.n_forwards / 2, (got.n_forwards,
                                                 ref.n_forwards)


def test_engine_prompt_lookup_matches_greedy():
    """VQAEngine(prompt_lookup=True): free_form and free_form_many return
    the plain greedy engine's text (the draft changes only the speed), and
    the decode stats are recorded (tests/test_speculative.py's case)."""
    from PIL import Image

    from vstar_tpu_torch.eval.vqa_engine import VQAEngine
    from vstar_tpu_torch.models.vqa_llm import init_vqa_llm_params
    from vstar_tpu_torch.multimodal.stub_tokenizer import StubTokenizer

    cfg = tcfg.vqa_llm_tiny()
    params = init_vqa_llm_params(0, cfg, device="cpu")
    tok = StubTokenizer(cfg.llama.vocab_size)

    def make(**kw):
        return VQAEngine(params, cfg, tok, device="cpu",
                         prompt_buckets=(64, 128), option_bucket=16,
                         compute_dtype=torch.float32, **kw)

    plain = make()
    plain._spec_template = None          # pure greedy
    lk = make(prompt_lookup=True)
    rng = np.random.RandomState(0)
    imgs = [Image.fromarray((rng.rand(64, 80, 3) * 255).astype("uint8"))
            for _ in range(2)]
    qs = ["what color is the cup ?", "where is the dog ?"]
    for im, q in zip(imgs, qs):
        assert lk.free_form(im, q, max_new_tokens=6) == \
            plain.free_form(im, q, max_new_tokens=6)
    assert lk.free_form_many(imgs, qs, max_new_tokens=6) == \
        plain.free_form_many(imgs, qs, max_new_tokens=6)
    st = lk.last_decode_stats
    assert st is not None and st["forwards"] >= 1
    assert 0.0 <= st["tokens_per_forward"] <= 6
    assert plain.last_decode_stats["tokens_per_forward"] == 1.0


# ---------------------------------------------------------------------------
# sample_token
# ---------------------------------------------------------------------------

def _logits(seed, B=3, V=64):
    return np.random.RandomState(seed).randn(B, V).astype(np.float32) * 3


@pytest.mark.parametrize("temperature", [0.0, -1.0, "tensor"])
def test_sample_token_temperature_zero_is_argmax(temperature):
    logits = torch.from_numpy(_logits(0))
    if temperature == "tensor":
        temperature = torch.tensor(0.0)
    got = sample_token(logits, torch.Generator().manual_seed(0),
                       temperature, top_p=0.5)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _logits(0).argmax(-1))


def _jax_kept(logits, temperature, top_p, monkeypatch):
    """JAX's kept set: the logits sample_token hands to
    jax.random.categorical, finite where kept."""
    seen = []

    def categorical(key, scaled, axis=-1):
        seen.append(np.isfinite(np.asarray(scaled)))
        return jnp.argmax(scaled, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", categorical)
    jax_sampler.sample_token(jnp.asarray(logits), jax.random.PRNGKey(0),
                             temperature, top_p)
    return seen[0]


@pytest.mark.parametrize("top_p", [0.3, 0.9, 1.0, "tensor_0.7",
                                   "tensor_1.0"])
def test_top_p_kept_set_matches_jax(top_p, monkeypatch):
    """Static top_p (a float; >= 1 skips the filter) and non-static (a
    traced JAX scalar / a 0-d torch tensor: the filter always runs). The
    sets are equal, except where a token's preceding probability mass is
    top_p to within f32 rounding: there the two cumulative sums (XLA's
    scan and torch's, summed in different orders) may round either way.
    Only a non-static 1.0 reaches that edge (the tail of the vocabulary,
    which a static 1.0 never filters)."""
    logits = _logits(1)
    if isinstance(top_p, str):
        v = float(top_p.split("_")[1])
        j_top, t_top = jnp.float32(v), torch.tensor(v)
    else:
        v = j_top = t_top = top_p
    want = _jax_kept(logits, 0.8, j_top, monkeypatch)
    scaled = torch.from_numpy(logits) / 0.8
    static_skip = isinstance(t_top, float) and t_top >= 1.0
    got = torch.isfinite(scaled if static_skip
                         else top_p_filter(scaled, t_top)).numpy()
    assert got.any(axis=1).all()
    # each token's preceding mass, in f64 and in the token's sorted place
    p64 = np.exp(scaled.double().numpy()
                 - scaled.double().numpy().max(-1, keepdims=True))
    p64 /= p64.sum(-1, keepdims=True)
    order = np.argsort(-p64, axis=-1, kind="stable")
    before = np.zeros_like(p64)
    np.put_along_axis(before, order, np.cumsum(np.take_along_axis(
        p64, order, -1), -1) - np.take_along_axis(p64, order, -1), -1)
    edge = np.abs(before - v) < 1e-5
    np.testing.assert_array_equal(got[~edge], want[~edge])
    if top_p != "tensor_1.0":
        np.testing.assert_array_equal(got, want)


def test_seeded_generator_replays_and_stays_in_the_kept_set():
    logits = torch.from_numpy(_logits(2, B=4, V=128))
    kept = torch.isfinite(top_p_filter(logits.float() / 0.7, 0.8))
    draws = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(123)
        draws.append(torch.stack([sample_token(logits, gen, 0.7, 0.8)
                                  for _ in range(50)]))
    assert torch.equal(draws[0], draws[1])
    rows = torch.arange(4)[None].expand(50, 4)
    assert kept[rows, draws[0].long()].all()
    # more than the argmax is drawn: it samples
    assert len(set(draws[0][:, 0].tolist())) > 1
    other = torch.stack([sample_token(logits, torch.Generator()
                                      .manual_seed(124), 0.7, 0.8)
                         for _ in range(50)])
    assert not torch.equal(other, draws[0])
