"""Offline V*Bench evaluation: `eval/batched_bench.eval_batch` over groups
of images run back to back, as the eval command line's `--image-batch`
loop runs them (the next group made on a loader thread meanwhile).

The window runs whole groups until `seconds` have passed, and
`seal_images_per_s` is every image answered over the whole time those
groups took. A traced run profiles the whole window.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List

from .. import traffic
from ..record import Recorder, VQAProxy, VSMProxy
from . import common

# groups at the window's start whose VSM outputs are kept for the check
KEPT_GROUPS = 2
# searches of the check's group that the reference walks
WALKED = 3


def _stream(mix: Dict, seed: int, stop: threading.Event, q: queue.Queue):
    groups = traffic.EvalStream(mix, seed)
    while not stop.is_set():
        group = groups.next()
        while not stop.is_set():
            try:
                q.put(group, timeout=0.1)
                break
            except queue.Full:
                continue


class Driver:
    end_to_end = ("seal_images_per_s",)

    def __init__(self, cfg: Dict, mix: Dict, seed: int, vqa, vsm):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.rec = Recorder()
        self.rec.install(vqa, vsm)
        self.forced: Dict[str, List[str]] = {}
        self.vqa = VQAProxy(vqa, self.rec, mix["free_form_tokens"],
                            self.forced)
        self.vsm = VSMProxy(vsm, self.rec)
        self.search_spans: List[tuple] = []
        self.searches: List[Dict] = []
        self.groups: List[Dict] = []

    def _run_group(self, samples):
        from vstar_tpu_torch.eval.batched_bench import eval_batch
        for s in samples:
            self.forced[s["question"]] = s["objects"]
        t0 = time.perf_counter()
        first = len(self.searches)
        with common.forced_search(self.mix["forced_search"],
                                  self.mix["search_steps"],
                                  self.search_spans, self.searches):
            recs = eval_batch(self.vqa, self.vsm, samples,
                              max_search_steps=self.mix["search_steps"])
        return t0, time.perf_counter(), recs, self.searches[first:]

    def warm(self):
        """One group of each kind at the smallest image size: every shape
        the window's groups take (free-form batch 8, search waves of 8
        and 16 rows, option scoring of 4 and 2 options)."""
        small = dict(self.mix, sizes=[min(self.mix["sizes"],
                                          key=lambda s: s[0] * s[1])])
        groups = traffic.EvalStream(small, self.seed, "warm")
        for kind in sorted(set(self.mix["cycle"])):
            self._run_group(groups.next(kind))
        self.rec.calls.clear()
        self.search_spans.clear()
        self.searches.clear()

    def run(self, seconds: float, tracer=None):
        stop = threading.Event()
        q: queue.Queue = queue.Queue(maxsize=1)
        loader = threading.Thread(target=_stream,
                                  args=(self.mix, self.seed, stop, q),
                                  daemon=True)
        loader.start()
        try:
            group = q.get()             # the first group made before
            if tracer is not None:
                tracer.start()
            self.t_start = time.perf_counter()
            g = 0
            while True:
                if g:
                    group = q.get()
                self.vsm.keeping = g < KEPT_GROUPS
                t0, t1, recs, searches = self._run_group(group)
                self.groups.append({"t0": t0, "t1": t1, "n": len(recs),
                                    "records": recs, "samples": group,
                                    "searches": searches})
                g += 1
                if time.perf_counter() - self.t_start >= seconds:
                    break
            self.vsm.keeping = False
            if tracer is not None:
                tracer.stop()
            self.t_end = time.perf_counter()
        finally:
            stop.set()
            loader.join(timeout=30)
        self.rec.uninstall()
        self.rec.to_host()

    def metrics(self) -> Dict[str, float]:
        n = sum(g["n"] for g in self.groups)
        return {"seal_images_per_s": n / (self.t_end - self.t_start)}

    def attempted(self):
        n = sum(g["n"] for g in self.groups)
        return n, 0

    def traced_calls(self):
        return [c for c in self.rec.calls if c["t0"] >= self.t_start]

    def _calls(self, group):
        return [c for c in self.rec.calls
                if group["t0"] <= c["t0"] <= group["t1"]]

    def layer_inputs(self) -> Dict:
        window = self.t_end - self.t_start
        detect = [s for s in self.vsm.spans if s[0] == "detect"
                  and s[1] >= self.t_start]
        return {"window_s": window,
                "search_s": common.union_seconds(
                    [s for s in self.search_spans if s[0] >= self.t_start]),
                "detect_rows": [s[3] for s in detect]}

    def check_sample(self) -> Dict:
        """The rows the check compares: the free-form and option rows of
        one group of the window's first two (the seed's pick), the
        searches of that group that the reference walks (the seed's
        pick), and the count of the window's departures from the forced
        search."""
        rng = traffic.rng_for(self.seed, "sample")
        group = self.groups[int(rng.integers(min(KEPT_GROUPS,
                                                 len(self.groups))))]
        qs = [s["question"] for s in group["samples"]]
        images = {s["question"]: s["image"] for s in group["samples"]}
        results = {s["question"]: (r["search_result"] if r["missing_objects"]
                                   else None)
                   for s, r in zip(group["samples"], group["records"])}
        ff = common.free_form_rows(self.rec.calls, qs, images)
        opts, bad = common.option_rows(
            self.rec.calls, qs, images, results,
            self.cfg["seal"]["vision"]["image_size"])
        steps = self.mix["search_steps"]
        structure, rows = 0, None
        for g in self.groups:
            n, r = common.search_structure(g["samples"], g["searches"],
                                           self._calls(g), steps)
            structure += n
            if g is group:
                rows = r
        walked = common.search_sample(group["samples"], group["records"],
                                      group["searches"], rows, rng, WALKED)
        return {"free_form": ff, "options": opts, "search": walked,
                "prompt_mismatch": bad, "search_structure": structure,
                "forced": self.mix["forced_search"], "steps": steps}
