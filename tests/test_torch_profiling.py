"""vstar_tpu_torch/utils/profiling.py against vstar_tpu/utils/profiling.py on
the CPU: PhaseTimer's summary and report equal JAX's on the same phases
under a scripted time.perf_counter (exact: the same floats and strings);
trace writes a Chrome trace of the block it profiles; device_time is the
median of its timed calls after one warm call; scripts/mesh_probe's
kernel_overlap reads from such a trace how much of NCCL's broadcast time
other kernels ran beside."""

import gzip
import json

import numpy as np
import pytest
import torch

from vstar_tpu.utils import profiling as jprof
from vstar_tpu_torch.utils import profiling as tprof


def _clock(monkeypatch, module):
    """time.perf_counter of `module` reading 0.0, 0.013, 0.035, ... (steps
    growing by 9 ms)."""
    ticks = iter([0.013 * i + 0.0045 * i * (i - 1) for i in range(1000)])
    monkeypatch.setattr(module.time, "perf_counter", lambda: next(ticks))


def _phases(timer):
    for name in ("prefill", "decode", "decode", "heads", "decode",
                 "policy", "prefill"):
        with timer.phase(name):
            pass
    try:
        with timer.phase("heads"):
            raise KeyError("a phase that raises still counts")
    except KeyError:
        pass


def test_phase_timer_equals_jax(monkeypatch):
    _clock(monkeypatch, jprof)
    want = jprof.PhaseTimer()
    _phases(want)
    _clock(monkeypatch, tprof)
    got = tprof.PhaseTimer()
    _phases(got)
    assert got.summary() == want.summary()
    assert got.report() == want.report()
    assert dict(got.counts) == {"prefill": 2, "decode": 3, "heads": 2,
                                "policy": 1}
    assert "ms avg (3x)" in got.report()


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with tprof.trace(str(tmp_path / "prof")):
        for _ in range(3):
            x = torch.tanh(x @ x)
    files = list((tmp_path / "prof").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


@pytest.mark.parametrize("iters", [1, 3, 4])
def test_device_time_is_the_median_after_a_warm_call(monkeypatch, iters):
    """The timed calls last 5, 1, 3, 2 s on a scripted clock; the warm call
    is not timed; the output's first tensor is on the CPU (no sync)."""
    calls = []
    reads = iter([0.0, 5.0, 10.0, 11.0, 20.0, 23.0, 30.0, 32.0])
    monkeypatch.setattr(tprof.time, "perf_counter", lambda: next(reads))

    def fn(a, b):
        calls.append((a, b))
        return [None, {"out": torch.zeros(2)}]

    got = tprof.device_time(fn, 1, 2, iters=iters)
    assert calls == [(1, 2)] * (iters + 1)
    assert got == float(np.median([5.0, 1.0, 3.0, 2.0][:iters]))


def test_kernel_overlap_reads_a_chrome_trace(tmp_path):
    """Two broadcast kernels (10 and 20 us) beside compute kernels that
    cover 4 + 5 us of the first and 20 us of the second (two of them
    overlapping each other), an all-reduce and a CPU op left out: 29 of
    30 us overlapped."""
    from vstar_tpu_torch.scripts.mesh_probe import kernel_overlap

    def k(name, ts, dur, cat="kernel"):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "pid": 0, "tid": 7}
    events = [k("ncclDevKernel_Broadcast_RING_LL(x)", 100, 10),
              k("ncclDevKernel_Broadcast_RING_LL(x)", 200, 20),
              k("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 300, 50),
              k("nvjet_tst_192x192", 96, 8), k("flash_tile_fwd", 105, 100),
              k("elementwise", 190, 40), k("aten::mm", 100, 10, "cpu_op")]
    # compute covers 100-104 and 105-230: the broadcasts' 100-110 (9 us)
    # and 200-220 (20 us)
    path = str(tmp_path / "t.json.gz")
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)
    got = kernel_overlap(path)
    assert got["kernels"] == 2
    assert got["ms"] == pytest.approx(0.030)
    assert got["overlapped_ms"] == pytest.approx(0.029)
    assert got["share"] == pytest.approx(29 / 30)
