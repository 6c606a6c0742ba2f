"""Timing on the card, shared by chip_smoke.py and the scripts.

`graph_ms` gives device time: the calls are captured into one CUDA graph
and replayed, so host launch gaps do not count and no call can be hoisted
out. `events_ms` brackets one eager call with CUDA events (host launch
gaps included). `card_line` is the card's name and power limit, which
belong beside every time.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch


def events_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median time of one call of fn, from CUDA events around the call
    (host launch gaps included)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def graph_ms(calls, reps: int = 7) -> float:
    """Device time of one call: the closures `calls` (each on its own
    weight copy, so the weights come from HBM as on the path) are
    captured into one CUDA graph; the median replay time over reps,
    divided by len(calls)."""
    for c in calls:
        c()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for c in calls:
            c()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for c in calls:
            c()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / len(calls))
    del graph
    return float(np.median(times))


def graph_kernels(fn, lib=None) -> tuple:
    """(kernel launches, graph nodes) of one call of fn, read from the
    CUDA graph it is captured into (warmed up on a side stream first, so
    that no first-call set-up is captured). `lib` is a loaded library with
    vstar_graph_kernel_nodes (csrc/graph_info.cu); the kernel library by
    default."""
    import ctypes
    if lib is None:
        from ..kernels import _build
        lib = _build.library()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    kernels, nodes = ctypes.c_longlong(), ctypes.c_longlong()
    code = lib.vstar_graph_kernel_nodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.byref(kernels),
        ctypes.byref(nodes))
    if code != 0:
        raise RuntimeError(f"vstar_graph_kernel_nodes: CUDA error {code}")
    del graph
    return kernels.value, nodes.value


def card_line() -> str:
    """The card's name and power limit, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
