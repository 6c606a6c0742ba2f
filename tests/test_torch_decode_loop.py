"""The port's decode loops as steps of device state (decode/graphs.py), k
steps per host read, against the JAX package's while_loops on the same
weights (tiny f32 decoder, numpy seeds through core.convert): for k in
{1, 3, 8}, greedy_decode, speculative_decode and lookup_decode give
JAX's tokens, num_generated and n_forwards exactly, its hiddens to 1e-5
over the whole [B, max_new] array (the tail that JAX writes for rows
already done included), and its cache below each row's length. The steps
past the end that a k > 1 loop runs move nothing. A seeded sampled
decode replays for every k and equals the traced (eager, read-per-step)
loop. The CUDA graph replay of the same steps is held to the traced loop
bit for bit by the `gpu` tests at the end."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_speculative import (CFG, EOS, PARAMS, T_CFG, T_PARAMS,
                                          _jax_prefill, _torch_prefill)
from vstar_tpu.decode import sampler as jax_sampler
from vstar_tpu.decode.speculative import lookup_decode as jax_lookup
from vstar_tpu.decode.speculative import speculative_decode as jax_spec
from vstar_tpu_torch.decode import graphs as tg
from vstar_tpu_torch.decode.sampler import greedy_decode
from vstar_tpu_torch.decode.speculative import (lookup_decode,
                                                speculative_decode)

torch.set_num_threads(1)

KS = (1, 3, 8)
CHUNK = 4
HID_ATOL = 1e-5
CACHE_LEN = 64


def _prompt(seed, B=3, S=6):
    return np.random.RandomState(seed).randint(3, CFG.vocab_size, (B, S))


def _rig_first_stop(logits, row=0):
    """First logits with `row` forced to answer EOS first."""
    out = np.array(logits, np.float32)
    out[row, :] = -1e9
    out[row, EOS] = 1e9
    return out


@functools.lru_cache(maxsize=None)
def _jax_run(kind, case):
    """(prompt, stop ids, JAX's decode, the spec draft) of a case (prompt
    seed 3 greedy, 5 verify): the same for every k, so run once."""
    max_new, rig, staggered = CASES[case]
    prompt = _prompt(3 if kind == "greedy" else 5)
    stops = _stops_at_different_steps(prompt, max_new) if staggered \
        else [EOS]
    jlog, jhid, jcache = _inputs(prompt, rig)[0]
    if kind == "greedy":
        want = jax_sampler.greedy_decode(PARAMS, CFG, jcache, jlog, jhid,
                                         max_new, stops,
                                         compute_dtype=jnp.float32)
    elif kind == "spec":
        draft = _draft(prompt, max_new, CHUNK, 1)
        want = jax_spec(PARAMS, CFG, jcache, jlog, jhid, jnp.asarray(draft),
                        max_new, stops, chunk=CHUNK,
                        compute_dtype=jnp.float32)
    else:
        ctx, lens = _lookup_ctx(prompt)
        want = jax_lookup(PARAMS, CFG, jcache, jlog, jhid, jnp.asarray(ctx),
                          jnp.asarray(lens), max_new, stops, chunk=CHUNK,
                          compute_dtype=jnp.float32)
    return prompt, stops, jax.device_get(want), \
        draft if kind == "spec" else None


def _lookup_ctx(prompt):
    ctx = np.concatenate([prompt, prompt[:, ::-1]], 1).astype(np.int32)
    return ctx, np.full((prompt.shape[0],), ctx.shape[1], np.int32)


def _stops_at_different_steps(prompt, max_new):
    """Stop ids that end the rows of `prompt` at different steps: the
    JAX greedy answer's token at step 2 of row 0 and step 5 of row 1."""
    logits, hidden, cache = _jax_prefill(prompt, CACHE_LEN)
    free = jax_sampler.greedy_decode(PARAMS, CFG, cache, logits, hidden,
                                     max_new, [CFG.vocab_size - 1],
                                     compute_dtype=jnp.float32)
    toks = np.asarray(free.tokens)
    return [EOS, int(toks[0, 2]), int(toks[1, 5])]


def _inputs(prompt, rig):
    jlog, jhid, jcache = _jax_prefill(prompt, CACHE_LEN)
    tlog, thid, tcache = _torch_prefill(prompt, CACHE_LEN)
    if rig:
        r = _rig_first_stop(np.asarray(jlog))
        jlog, tlog = jnp.asarray(r), torch.from_numpy(r)
    return (jlog, jhid, jcache), (tlog, thid, tcache)


def _check(want, got):
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.num_generated.numpy(),
                                  np.asarray(want.num_generated))
    assert got.n_forwards == int(want.n_forwards)
    np.testing.assert_allclose(got.hiddens.numpy(), np.asarray(want.hiddens),
                               atol=HID_ATOL, rtol=0)
    lens = np.asarray(want.cache.length)
    np.testing.assert_array_equal(got.cache.length.numpy(), lens)
    for b, n in enumerate(lens):
        for name in ("k", "v"):
            np.testing.assert_allclose(
                getattr(got.cache, name)[:, b, :n].numpy(),
                np.asarray(getattr(want.cache, name))[:, b, :n],
                atol=HID_ATOL, rtol=0)


# (max_new, rig row 0 to stop on its first token, stops at different
# steps): 11 is no multiple of 3 or 8
CASES = {"budget_11": (11, False, False),
         "first_token_stop": (12, True, False),
         "staggered_stops": (12, False, True)}


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_greedy_steps_match_jax(case, k):
    max_new, rig, staggered = CASES[case]
    prompt, stops, want, _ = _jax_run("greedy", case)
    tlog, thid, tcache = _inputs(prompt, rig)[1]
    with torch.inference_mode():
        got = greedy_decode(T_PARAMS, T_CFG, tcache, tlog, thid, max_new,
                            stops, torch.float32, steps_per_read=k)
    _check(want, got)
    ngen = got.num_generated.tolist()
    if staggered:
        assert len(set(ngen)) == 3, ngen       # three different stops
    if rig:
        assert ngen[0] == 1 and max(ngen) > 1


def _draft(prompt, max_new, chunk, seed):
    """A draft that is right for its first few tokens (the JAX greedy
    answer with every fourth token wrong): some chunks accept, some
    reject."""
    logits, hidden, cache = _jax_prefill(prompt, CACHE_LEN)
    ref = np.asarray(jax_sampler.greedy_decode(
        PARAMS, CFG, cache, logits, hidden, max_new, [EOS],
        compute_dtype=jnp.float32).tokens)
    draft = np.full((prompt.shape[0], max_new + chunk), EOS, np.int32)
    draft[:, :max_new] = ref
    draft[:, 3::4] = np.random.RandomState(seed).randint(
        3, CFG.vocab_size, draft[:, 3::4].shape)
    return draft


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("kind", ["spec", "lookup"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_verify_steps_match_jax(case, kind, k):
    max_new, rig, staggered = CASES[case]
    prompt, stops, want, draft = _jax_run(kind, case)
    tlog, thid, tcache = _inputs(prompt, rig)[1]
    with torch.inference_mode():
        if kind == "spec":
            got = speculative_decode(
                T_PARAMS, T_CFG, tcache, tlog, thid,
                torch.from_numpy(draft),
                max_new, stops, chunk=CHUNK, compute_dtype=torch.float32,
                steps_per_read=k)
        else:
            ctx, lens = _lookup_ctx(prompt)
            got = lookup_decode(T_PARAMS, T_CFG, tcache, tlog, thid,
                                torch.from_numpy(ctx), torch.from_numpy(lens),
                                max_new, stops, chunk=CHUNK,
                                compute_dtype=torch.float32, steps_per_read=k)
    _check(want, got)
    if staggered:
        assert len(set(got.num_generated.tolist())) == 3


def _sampled(prompt, k, trace=None):
    logits, hidden, cache = _torch_prefill(prompt, CACHE_LEN)
    gen = torch.Generator().manual_seed(5)
    with torch.inference_mode():
        return greedy_decode(T_PARAMS, T_CFG, cache, logits, hidden, 12,
                             [EOS], torch.float32, temperature=0.9,
                             top_p=0.95, generator=gen, trace=trace,
                             steps_per_read=k)


def test_sampled_decode_replays_from_its_seed():
    """The same seed gives the same sampled tokens at every k, and the
    traced loop's (which reads the flag before every step); the draws
    are not the argmax's."""
    prompt = _prompt(9)
    runs = [_sampled(prompt, k) for k in KS] + [_sampled(prompt, 1, [])]
    for r in runs[1:]:
        np.testing.assert_array_equal(r.tokens.numpy(),
                                      runs[0].tokens.numpy())
        np.testing.assert_array_equal(r.num_generated.numpy(),
                                      runs[0].num_generated.numpy())
        assert r.n_forwards == runs[0].n_forwards
        np.testing.assert_array_equal(r.hiddens.numpy(),
                                      runs[0].hiddens.numpy())
    logits, hidden, cache = _torch_prefill(prompt, CACHE_LEN)
    with torch.inference_mode():
        greedy = greedy_decode(T_PARAMS, T_CFG, cache, logits, hidden, 12,
                               [EOS], torch.float32)
    assert not torch.equal(greedy.tokens, runs[0].tokens)


@pytest.mark.parametrize("kind", ["greedy", "spec"])
def test_replay_trace_is_the_traced_loops(kind):
    """replay_trace (the logits a k-step loop writes into device buffers)
    holds the traced eager loop's entries: the same starts and logits."""
    prompt = _prompt(3)
    traces = {}
    for name in ("trace", "replay_trace"):
        logits, hidden, cache = _torch_prefill(prompt, CACHE_LEN)
        tr = []
        with torch.inference_mode():
            if kind == "greedy":
                greedy_decode(T_PARAMS, T_CFG, cache, logits, hidden, 12,
                              [EOS], torch.float32, steps_per_read=3,
                              **{name: tr})
            else:
                speculative_decode(
                    T_PARAMS, T_CFG, cache, logits, hidden,
                    torch.from_numpy(_draft(prompt, 12, CHUNK, 1)), 12,
                    [EOS], chunk=CHUNK, compute_dtype=torch.float32,
                    steps_per_read=3, **{name: tr})
        traces[name] = tr
    assert len(traces["trace"]) == len(traces["replay_trace"]) > 2
    for (s0, l0), (s1, l1) in zip(traces["trace"], traces["replay_trace"]):
        assert torch.equal(s0, s1)
        assert torch.equal(l0.float(), l1)


def test_traced_loop_reads_before_each_step():
    """The traced loop runs no step past the end: one trace entry per
    forward plus the prefill's, even when every row stops on its first
    token."""
    prompt = _prompt(3, B=2)
    logits, hidden, cache = _torch_prefill(prompt, CACHE_LEN)
    rig = torch.from_numpy(_rig_first_stop(_rig_first_stop(
        logits.numpy()), 1))
    trace = []
    with torch.inference_mode():
        res = greedy_decode(T_PARAMS, T_CFG, cache, rig, hidden, 12, [EOS],
                            torch.float32, trace=trace)
    assert res.n_forwards == 0 and len(trace) == 1
    trace = []
    with torch.inference_mode():
        res = greedy_decode(T_PARAMS, T_CFG, cache, logits, hidden, 12,
                            [EOS], torch.float32, trace=trace)
    assert len(trace) == res.n_forwards + 1


def test_static_cache_is_reused():
    """DecodeGraphs.cache hands out the same storage for the same key
    (with lengths zeroed). Every cache of one decoder shape is a view of
    the newest slab (k, then v); only a cache larger than the slab gets a
    new one, and the caches made on the old slab keep it."""
    g = tg.DecodeGraphs()
    a = g.cache(T_CFG, 2, 8, torch.float32, "cpu")
    a.length.fill_(3)
    b = g.cache(T_CFG, 2, 8, torch.float32, "cpu")
    assert b.k.data_ptr() == a.k.data_ptr() and int(b.length.sum()) == 0
    n = a.k.numel()
    assert a.v.data_ptr() == a.k.data_ptr() + 4 * n
    slab = 4 * (1 << (2 * n - 1).bit_length())
    assert g.cache_bytes() == slab
    big = g.cache(T_CFG, 4, 16, torch.float32, "cpu")    # 4x: a new slab
    assert big.k.data_ptr() != a.k.data_ptr()
    assert g.cache_bytes() == slab + 4 * slab
    small = g.cache(T_CFG, 1, 16, torch.float32, "cpu")  # fits the slab
    assert small.k.data_ptr() == big.k.data_ptr()
    assert small.k.shape == (T_CFG.num_layers, 1, 16, T_CFG.num_kv_heads,
                             T_CFG.head_dim)
    assert g.cache_bytes() == 5 * slab
    # the largest first: one slab for all
    g = tg.DecodeGraphs()
    for rows, length in ((4, 16), (2, 8), (1, 16), (2, 16)):
        g.cache(T_CFG, rows, length, torch.float32, "cpu")
    assert g.cache_bytes() == 4 * slab


def test_every_counter_is_registered():
    """Every launch counter of the kernel modules and of nn.quant, and the
    mesh's collective counts, are in the registry the decode graphs
    replay (kernels/_build.COUNTERS), and registering a name a module
    lacks raises."""
    from vstar_tpu_torch.core import mesh
    from vstar_tpu_torch.kernels import (_build, flash_attention,
                                         int4_matmul, int4_variants,
                                         int8_matmul, tower_attention)
    from vstar_tpu_torch.nn import quant
    registered = {(m.__name__, a) for m, a in _build.COUNTERS}
    found = set()
    for mod in (flash_attention, int4_matmul, int4_variants, int8_matmul,
                tower_attention, quant, mesh):
        for name, value in vars(mod).items():
            if any(w in name for w in ("launches", "calls", "routes",
                                       "collectives")) \
                    and isinstance(value, (int, dict)) \
                    and not isinstance(value, bool):
                found.add((mod.__name__, name))
    assert len(found) == 26 and found == registered
    with pytest.raises(AttributeError):
        _build.register_counters(quant.__name__, "no_such_counter")


def test_counter_delta_is_replayed():
    """A capture's counter growth is undone and each replay adds it
    back (counters_* on the launch counters of the kernel modules)."""
    from vstar_tpu_torch.kernels import flash_attention as fa
    before = (fa.launches, dict(fa.route_launches))
    snap = tg.counters_snapshot()
    fa.launches += 3
    fa.route_launches["split"] += 2
    delta = tg.counters_delta(snap)
    tg.counters_restore(snap)
    assert (fa.launches, dict(fa.route_launches)) == before
    tg.counters_add(delta, 2)
    assert fa.launches == before[0] + 6
    assert fa.route_launches["split"] == before[1]["split"] + 4
    tg.counters_restore(snap)


# ---------------------------------------------------------------------------
# On the card: graph replay against the traced eager loop
# ---------------------------------------------------------------------------

def _cuda_setup():
    """bf16 tiny-shaped decoder at the kernels' head width (128) on the
    card, with its prefill into a DecodeGraphs cache."""
    from vstar_tpu_torch.core.params import Init
    from vstar_tpu_torch.nn import llama as tl
    cfg = dataclasses.replace(T_CFG, num_heads=2, num_kv_heads=2,
                              head_dim=128, hidden_size=256)
    params = tl.init_llama_params(Init(3, "cuda", torch.bfloat16), cfg)
    return cfg, params


def _cuda_prefill(cfg, params, graphs, prompt, cache_len=128):
    from vstar_tpu_torch.nn import llama as tl
    ids = torch.from_numpy(prompt).cuda()
    B, S = ids.shape
    cache = graphs.cache(cfg, B, cache_len, torch.bfloat16, "cuda")
    h = tl.embed_tokens(params, ids, torch.bfloat16)
    hidden, cache = tl.llama_forward(
        params, cfg, h, torch.arange(S, device="cuda")[None].expand(B, S),
        torch.full((B,), S, dtype=torch.int32, device="cuda"),
        q_offsets=torch.zeros((B,), dtype=torch.int32, device="cuda"),
        cache=cache)
    return tl.lm_logits(params, hidden)[:, -1], hidden[:, -1], cache


def _same(a, b):
    assert torch.equal(a.tokens, b.tokens)
    assert torch.equal(a.num_generated, b.num_generated)
    assert a.n_forwards == b.n_forwards
    assert torch.equal(a.hiddens, b.hiddens)
    assert torch.equal(a.cache.length, b.cache.length)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["greedy", "spec", "lookup", "sampled"])
def test_graph_replay_equals_traced_loop(kind):
    """Each decode by graph replay (twice: the capture's call and a pure
    replay) equals the traced eager loop bit for bit; the sampled one
    from the same seed, as the first decode after seeding."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg, params = _cuda_setup()
    graphs = tg.DecodeGraphs()
    prompt = _prompt(3, B=2).astype(np.int64)
    draft = torch.full((2, 24 + 8), EOS, dtype=torch.int32, device="cuda")

    gen = torch.Generator("cuda")

    def run(trace, replay=None):
        logits, hidden, cache = _cuda_prefill(cfg, params, graphs, prompt)
        kw = dict(trace=trace, graphs=graphs, replay_trace=replay)
        with torch.inference_mode():
            if kind in ("greedy", "sampled"):
                gen.manual_seed(7)
                if kind == "sampled":
                    kw.update(temperature=0.9, top_p=0.95, generator=gen)
                return greedy_decode(params, cfg, cache, logits, hidden, 24,
                                     [EOS], **kw)
            if kind == "spec":
                return speculative_decode(params, cfg, cache, logits, hidden,
                                          draft, 24, [EOS], **kw)
            ctx = torch.from_numpy(prompt.astype(np.int32)).cuda()
            return lookup_decode(params, cfg, cache, logits, hidden, ctx,
                                 torch.full((2,), ctx.shape[1],
                                            dtype=torch.int32, device="cuda"),
                                 24, [EOS], **kw)

    ref_trace, replayed = [], []
    ref = run(ref_trace)
    first, second = run(None), run(None, replayed)
    assert graphs.captures == 2 and graphs.replays > 0   # with the trace
    _same(first, ref)
    _same(second, ref)
    assert len(replayed) == len(ref_trace) == ref.n_forwards + 1
    for (s0, l0), (s1, l1) in zip(ref_trace, replayed):
        assert torch.equal(s0, s1) and torch.equal(l0.float(), l1)
    third = run(None)
    assert graphs.captures == 2
    _same(third, ref)


@pytest.mark.gpu
def test_replay_counts_launches():
    """Under replay the kernel counters grow as eager launches would:
    K1's launches in a replayed decode equal the traced loop's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from vstar_tpu_torch.kernels import flash_attention as fa
    cfg, params = _cuda_setup()
    graphs = tg.DecodeGraphs()
    prompt = _prompt(4, B=2).astype(np.int64)
    counts = []
    for trace in ([], None, None):
        logits, hidden, cache = _cuda_prefill(cfg, params, graphs, prompt)
        n0 = fa.launches
        with torch.inference_mode():
            res = greedy_decode(params, cfg, cache, logits, hidden, 16,
                                [EOS], trace=trace, graphs=graphs,
                                steps_per_read=1)
        counts.append((fa.launches - n0, res.n_forwards))
    # the first replayed call also ran one eager warm-up step before its
    # capture: its launches are real and counted
    assert counts[2] == counts[0], counts
    assert counts[1][0] == counts[0][0] + cfg.num_layers, counts


@pytest.mark.gpu
def test_decode_on_the_card_needs_graphs():
    """On a CUDA tensor a decode replays captured steps: without the
    engine's DecodeGraphs it raises (the traced loop runs eagerly)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg, params = _cuda_setup()
    prompt = _prompt(3, B=2).astype(np.int64)
    logits, hidden, cache = _cuda_prefill(cfg, params, tg.DecodeGraphs(),
                                          prompt)
    with torch.inference_mode(), pytest.raises(ValueError,
                                               match="engine.graphs"):
        greedy_decode(params, cfg, cache, logits, hidden, 8, [EOS])
    with torch.inference_mode():
        res = greedy_decode(params, cfg, cache, logits, hidden, 8, [EOS],
                            trace=[])
    assert res.n_forwards >= 0


@pytest.mark.gpu
def test_failed_capture_raises():
    """A step that syncs with the host cannot be captured: the decode
    raises and does not fall back to eager steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    graphs = tg.DecodeGraphs()
    x = torch.zeros((1,), device="cuda")
    state = {"x": x, "ctl": torch.zeros((2,), dtype=torch.int32,
                                        device="cuda")}

    def step(s):
        if bool(s["x"].sum() > 0):      # a host sync
            s["x"] += 1

    with pytest.raises(RuntimeError):
        tg.run_steps(graphs, ("sync",), state, step, 1)
