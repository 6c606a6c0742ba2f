"""The traced run's profiler: torch.profiler (CUPTI) over the whole
window, the device's activity only, events kept in memory and reduced
here; no Chrome trace is written.

The host's operators are not recorded: on these host-bound paths the
profiler's per-operator callbacks slowed a window to twice its length
and more. What the host was doing in a gap comes from the
benchmark's own spans around the engines' calls instead (record.py),
timed on the profiler's clock (ns since the epoch).

Reduced to: the profiled span (host clock, synchronised at both ends),
the union of the device's activity intervals (kernels, copies, sets) and
each kernel's time by name, and the longest idle gaps labelled by the
innermost benchmark span that covered them.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Tracer:
    def __init__(self):
        self.prof = None
        self.active = False
        self.done = False
        self.t0 = self.t1 = None
        self.events = []

    def start(self):
        if self.active or self.done:
            return
        from torch.profiler import ProfilerActivity, profile
        _sync()
        self.prof = profile(activities=[ProfilerActivity.CUDA]
                            if torch.cuda.is_available()
                            else [ProfilerActivity.CPU])
        self.prof.__enter__()
        self.active = True
        self.t0 = time.perf_counter()

    def stop(self):
        if not self.active:
            return
        _sync()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.active, self.done = False, True
        self.events = list(self.prof.profiler.kineto_results.events())
        self.prof = None

    # -- reduction ------------------------------------------------------------

    def summary(self, attention_names: List[str],
                host_spans: List[tuple]) -> Dict:
        """busy_s, window_s, attention kernel seconds, the top device
        operations and the longest idle gaps; `host_spans` (start ns,
        end ns, label) name what the host was doing in a gap."""
        from torch.autograd import DeviceType
        dev = []
        for e in self.events:
            if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
                continue
            s = e.start_ns()
            dev.append((s, s + e.duration_ns(), e.name()))
        dev.sort()
        window_ns = (self.t1 - self.t0) * 1e9
        busy, end, gaps = 0, None, []
        by_name: Dict[str, float] = {}
        attn = 0
        for s, e, name in dev:
            by_name[name] = by_name.get(name, 0) + (e - s)
            if any(a in name for a in attention_names):
                attn += e - s
            if end is None or s > end:
                if end is not None:
                    gaps.append((s - end, end, s))
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        gaps.sort(reverse=True)
        labelled = []
        for length, a, b in gaps[:10]:
            mid = (a + b) / 2
            cover = [(hs, n) for hs, he, n in host_spans if hs <= mid <= he]
            label = max(cover)[1] if cover else "between engine calls"
            labelled.append([label, length / 1e9])
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return {"busy_s": min(busy, window_ns) / 1e9,
                "window_s": window_ns / 1e9,
                "attention_s": attn / 1e9,
                "device_ops": [[n, t / 1e9] for n, t in top],
                "idle_gaps": labelled}
