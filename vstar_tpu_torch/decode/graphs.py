"""Decode loops as captured device work: the port's counterpart of
`jax.jit`'s program cache for the decode steps of decode/sampler.py and
decode/speculative.py.

A decode is a loop of steps over device state (the step counter, the
token and hidden buffers, the done flags, the forward count, the cache
lengths, the drafts). Each step is gated on the device by the JAX
loop's own condition, so a step past the end changes nothing the
decode returns, and it writes into `ctl` [live, forwards]. The host
reads `ctl` once after every `steps_per_read` steps and stops when
`live` is 0: the only host syncs of a decode.

On a CUDA tensor the step is captured once per key into a CUDA graph
and then only replayed; the key holds everything the capture froze
(rows, the cache's storage, the chunk, max_new_tokens, the dtypes, the
static sampling values, the weights' storage). A `DecodeGraphs` owns
the graphs, one memory pool they share, and the static KV caches the
engines prefill into, so the captured addresses stay valid. A decode
on the card without the engine's DecodeGraphs raises, as does a failed
capture: there is no eager fallback on the card. On the CPU the same
step runs eagerly, `steps_per_read` at a time.

One decode runs at a time, and a cache is read only from its prefill
to the end of the decode that follows it. So every cache of one
decoder shape is a view of one slab, the newest, whatever its rows and
length: the caches cost the largest of them, not their sum. A cache
larger than the slab gets a new slab (a power of two of elements); the
caches and graphs made on the older ones keep them alive, which costs
at most as much again (the warmups go from the largest bucket down, so
that none does). Each new slab and capture is logged with its memory.
The graphs are kept least recently used first out, at most MAX_GRAPHS.

Kernel wrappers count their launches when they are called, which under
a graph is at capture and not at replay. A capture therefore records
the growth of every registered counter (kernels/_build.COUNTERS) and
undoes it, and every replay adds it back, so the counts are what eager
launches would have counted. The counters are plain integers: with two
threads decoding (serve/continuous.py's pipeline), a capture in one can
drop the other's increments made while it ran.

Threads: each engine's DecodeGraphs serves one thread, and other threads
may launch work meanwhile (the continuous service's stage workers, the
canvas uploads). A capture runs in "thread_local" mode, so their calls
do not break it, and one capture runs at a time in the process
(`_CAPTURE_LOCK`): torch.cuda.graph synchronizes the device, empties the
allocator's cache and captures on a stream shared by all its instances,
none of which may overlap another thread's capture.
"""

from __future__ import annotations

import logging
import threading
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..kernels import _build
from ..nn.llama import KVCache

_LOG = logging.getLogger(__name__)

# Graphs kept per DecodeGraphs. `serve.server --warmup --compiled` on
# the 7B pair captures 10 keys for the VQA engine and 5 for the VSM at
# --max-batch 16, 8 and 4 at 8, about 32 MiB of pool each, and live
# requests then capture none (scripts/warmup_probe.py, NVIDIA H100 80GB
# HBM3 at 700 W). The act-int8 switch doubles the keys (it is part of
# the key); the rest is room for keys only other traffic reaches
# (sampling, the keyword decode's chunks, other budgets).
MAX_GRAPHS = 32

# one capture at a time in the process (module docstring)
_CAPTURE_LOCK = threading.Lock()


def counters_snapshot() -> Dict:
    return {(mod, attr): (dict(v) if isinstance(v, dict) else v)
            for mod, attr in _build.COUNTERS
            for v in [getattr(mod, attr)]}


def _old(snap: Dict, mod, attr):
    """A counter's value in `snap`; zero for one registered since."""
    if (mod, attr) in snap:
        return snap[(mod, attr)]
    return {} if isinstance(getattr(mod, attr), dict) else 0


def counters_delta(snap: Dict) -> List:
    """What the counters grew by since `snap`."""
    out = []
    for mod, attr in _build.COUNTERS:
        new, old = getattr(mod, attr), _old(snap, mod, attr)
        if isinstance(new, dict):
            d = {k: v - old.get(k, 0) for k, v in new.items()
                 if v != old.get(k, 0)}
            if d:
                out.append((mod, attr, d))
        elif new != old:
            out.append((mod, attr, new - old))
    return out


def counters_restore(snap: Dict) -> None:
    for mod, attr in _build.COUNTERS:
        cur, old = getattr(mod, attr), _old(snap, mod, attr)
        if isinstance(cur, dict):
            cur.clear()
            cur.update(old)
        else:
            setattr(mod, attr, old)


def counters_add(delta: List, times: int = 1) -> None:
    for mod, attr, d in delta:
        cur = getattr(mod, attr)
        if isinstance(cur, dict):
            for k, v in d.items():
                cur[k] = cur.get(k, 0) + v * times
        else:
            setattr(mod, attr, cur + d * times)


def weights_key(params) -> Tuple:
    """The storage of every tensor of a weight tree: a graph captured on
    them replays only on the same storage."""
    out = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, torch.Tensor):
            out.append(t.data_ptr())
    walk(params)
    return tuple(out)


class _Graph:
    __slots__ = ("graph", "state", "delta", "holds")

    def __init__(self, graph, state, delta, holds):
        self.graph, self.state, self.delta = graph, state, delta
        self.holds = holds


class DecodeGraphs:
    """The captured decode steps and the static KV caches of one engine
    (module docstring). A 7B decoder's cache is 32 layers x 2 x 4096 x
    2 B = 0.5 MiB per token and row: 8 GiB for 16 rows at 1024 slots."""

    def __init__(self):
        self._slabs: Dict[Tuple, torch.Tensor] = {}
        self._caches: Dict[Tuple, KVCache] = {}
        self._graphs: "OrderedDict[Tuple, _Graph]" = OrderedDict()
        self._pool = None
        self.captures = 0
        self.replays = 0
        self.host_reads = 0

    @property
    def kept(self) -> int:
        """The graphs kept now (at most MAX_GRAPHS)."""
        return len(self._graphs)

    # -- static caches ------------------------------------------------------

    def cache(self, cfg, rows: int, cache_len: int, dtype,
              device, kv_int8: bool = False) -> KVCache:
        """The static cache of (rows, cache_len, dtype, kv_int8) on
        `device`: the same storage at every call, its lengths zero, valid
        until the next call of any key (module docstring). kv_int8: int8
        k/v with f32 scales (nn/llama.KVCache), views of an int8 slab and
        a scale slab. The caller's prefill writes it in place; entries at
        or above a row's length hold whatever an earlier call wrote there
        (attention never reads them)."""
        device = torch.device(device)
        key = (cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, rows,
               cache_len, dtype, str(device), kv_int8)
        c = self._caches.get(key)
        if c is None:
            shape = (cfg.num_layers, rows, cache_len, cfg.num_kv_heads,
                     cfg.head_dim)
            n = rows * cache_len * cfg.num_layers * cfg.num_kv_heads \
                * cfg.head_dim
            base = key[:3] + key[6:7]
            with torch.inference_mode(False):
                kv = self._slab(base + ("kv", torch.int8 if kv_int8
                                        else dtype), 2 * n, device,
                                rows, cache_len)
                scales = {}
                if kv_int8:
                    m = n // cfg.head_dim
                    sc = self._slab(base + ("scale", torch.float32), 2 * m,
                                    device, rows, cache_len)
                    scales = dict(k_scale=sc[:m].view(shape[:-1]),
                                  v_scale=sc[m:2 * m].view(shape[:-1]))
                c = KVCache(k=kv[:n].view(shape), v=kv[n:2 * n].view(shape),
                            length=torch.zeros((rows,), dtype=torch.int32,
                                               device=device), **scales)
            self._caches[key] = c
        c.length.zero_()
        return c

    def _slab(self, key, numel: int, device, rows: int,
              cache_len: int) -> torch.Tensor:
        """The newest slab of `key` (..., role, dtype), replaced by a new
        one of a power of two of elements when it holds fewer than
        `numel`."""
        slab = self._slabs.get(key)
        if slab is None or slab.numel() < numel:
            slab = torch.zeros((1 << (numel - 1).bit_length(),),
                               dtype=key[-1], device=device)
            self._slabs[key] = slab
            _LOG.info("decode cache %s slab for rows=%d len=%d %s: %.1f MiB;"
                      " slabs hold %.1f MiB", key[-2], rows, cache_len,
                      key[-1], self._bytes(slab) / 2**20,
                      self.cache_bytes() / 2**20)
        return slab

    @staticmethod
    def _bytes(t: torch.Tensor) -> int:
        return t.untyped_storage().nbytes()

    def cache_bytes(self) -> int:
        """The bytes of every slab a cache or the newest slab holds (the
        int8 caches' scale slabs included)."""
        slabs = {t.untyped_storage().data_ptr(): self._bytes(t)
                 for c in self._caches.values() for t in c.tensors()}
        slabs.update((s.untyped_storage().data_ptr(), self._bytes(s))
                     for s in self._slabs.values())
        return sum(slabs.values())

    # -- the loop -----------------------------------------------------------

    def run(self, key: Tuple, state: Dict[str, torch.Tensor],
            step: Callable, steps_per_read: int, holds=(),
            generator: Optional[torch.Generator] = None
            ) -> Tuple[Dict[str, torch.Tensor], List[int]]:
        """Replay the graph of `step` under `key` (captured on first use)
        from the initial `state`, `steps_per_read` replays per read of
        state["ctl"], until it reads live == 0. Returns the final state
        (the graph's static buffers: read them before the next call) and
        the last `ctl` read.
        holds: what the capture reads besides `state` (the cache, the
        generator), kept alive with the graph, so that no id or address
        in its key is reused while it lives."""
        from ..nn import quant
        # qdot reads the act-int8 switch when it is called: at capture
        key = key + (quant._ACT_INT8,)
        g = self._graphs.pop(key, None)
        if g is None:
            with _CAPTURE_LOCK:
                g = self._capture(key, state, step, holds, generator)
        self._graphs[key] = g
        while len(self._graphs) > MAX_GRAPHS:
            self._graphs.popitem(last=False)
        with torch.no_grad():
            for name, t in state.items():
                g.state[name].copy_(t)
            while True:
                for _ in range(steps_per_read):
                    g.graph.replay()
                    counters_add(g.delta)
                    self.replays += 1
                self.host_reads += 1
                ctl = g.state["ctl"].tolist()
                if not ctl[0]:
                    return g.state, ctl

    def _capture(self, key, state, step, holds, generator) -> _Graph:
        dev = next(iter(state.values())).device
        # the capture empties the allocator's cache: do it first, so that
        # the reserved memory's growth is what the capture took
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved(dev)
        with torch.inference_mode(False), torch.no_grad():
            static = {n: t.clone() for n, t in state.items()}
            # warm up on a side stream (the capture's own stream), then
            # put back what the warm-up step moved
            rng = None if generator is None else generator.get_state()
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                step(static)
            torch.cuda.current_stream(dev).wait_stream(side)
            for n, t in state.items():
                static[n].copy_(t)
            if generator is not None:
                generator.set_state(rng)
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            if generator is not None:
                graph.register_generator_state(generator)
            snap = counters_snapshot()
            try:
                with torch.cuda.graph(graph, pool=self._pool,
                                      capture_error_mode="thread_local"):
                    step(static)
            finally:
                delta = counters_delta(snap)
                counters_restore(snap)
        self.captures += 1
        _LOG.info("decode graph %s captured: %.1f MiB reserved by its "
                  "warm-up, state and pool; %d graphs, cache slabs %.1f MiB",
                  key[0],
                  (torch.cuda.memory_reserved(dev) - before) / 2**20,
                  len(self._graphs) + 1, self.cache_bytes() / 2**20)
        # `step` too: its closure's tensors (stop ids, index ranges) are
        # read by address in every replay
        return _Graph(graph, static, delta, tuple(holds) + (step,))


def run_steps(graphs: Optional[DecodeGraphs], key: Tuple,
              state: Dict[str, torch.Tensor], step: Callable,
              steps_per_read: int, holds=(),
              generator: Optional[torch.Generator] = None,
              check_first: bool = False) -> Tuple[Dict, int, int]:
    """The decode loop: by graph replay on a CUDA tensor, which needs the
    engine's `graphs`; else `step` eagerly.
    check_first (eager on any device): read `ctl` before the first step
    too, so that no step runs past the end (the traced reference loop).
    Returns (final state, forwards = ctl[1], host reads)."""
    dev = state["ctl"].device
    if dev.type == "cuda" and not check_first:
        if graphs is None:
            raise ValueError("a decode on the card replays captured steps: "
                             "pass the engine's DecodeGraphs "
                             "(engine.graphs)")
        reads = graphs.host_reads
        out, ctl = graphs.run(key, state, step, steps_per_read, holds,
                              generator)
        return out, ctl[1], graphs.host_reads - reads
    reads = 0
    with torch.no_grad():
        while True:
            if not check_first or reads:
                for _ in range(steps_per_read):
                    step(state)
            reads += 1
            ctl = state["ctl"].tolist()
            if not ctl[0]:
                if graphs is not None:
                    graphs.host_reads += reads
                return state, ctl[1], reads
