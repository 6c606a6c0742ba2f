"""What the benchmark hands the program in place of its engines, and what
it keeps of the program's outputs.

`VQAProxy` and `VSMProxy` stand where the SEAL loop expects its two
engines and pass every call through to them. The VQA proxy sets the
free-form budget and forces the searches that random weights would never
ask for (it answers the trigger sentence for the objects the traffic
names); the VSM proxy times each call (the call's outputs are on the host
when it returns) and counts its rows. Both keep, in memory, what the
check after the window compares: the served tokens, the final hidden
states that chose them and the option losses of every call, and the raw detection outputs and patches of the calls the
seed picks.

The recorder reads the outputs where the program produces them by
wrapping the decode and scoring functions that the VQA engine's module
calls, and the VSM engine's `_generate`. A wrapper only keeps a copy of
the result on the device (no host read), so the timed path is unchanged.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence

TRIGGER = ("Sorry, I can not answer the question. Some visual information "
           "about the following objects is missing or unclear:")


class Recorder:
    def __init__(self):
        self._local = threading.local()
        self.calls: List[Dict] = []
        self._undo = []
        self.lock = threading.Lock()

    def current(self) -> Optional[Dict]:
        return getattr(self._local, "ctx", None)

    def enter(self, ctx: Dict):
        """A call begins on this thread: its outputs go to `ctx`, its
        span is timed on the host clock and on the profiler's."""
        ctx["t0"] = time.perf_counter()
        ctx["wall"] = [time.time_ns(), None]     # the profiler's clock
        self._local.ctx = ctx
        with self.lock:
            self.calls.append(ctx)

    def leave(self):
        self._local.ctx["wall"][1] = time.time_ns()
        self._local.ctx = None

    def spans(self):
        """(start, end, label) of every finished call, in the profiler's
        clock (ns since the epoch)."""
        return [(c["wall"][0], c["wall"][1], "portbench." + c["kind"])
                for c in self.calls if c["wall"][1] is not None]

    def _patch(self, owner, name, make):
        orig = getattr(owner, name)
        setattr(owner, name, make(orig))
        self._undo.append((owner, name, orig))

    def install(self, vqa_engine, vsm_engine):
        import vstar_tpu_torch.eval.vqa_engine as vmod

        def keep_decode(fn):
            def run(*a, **k):
                res = fn(*a, **k)
                ctx = self.current()
                if ctx is not None:
                    ctx.setdefault("decodes", []).append(
                        (res.tokens.clone(), res.num_generated.clone(),
                         res.hiddens.clone()))
                return res
            return run

        def keep_losses(fn):
            def run(*a, **k):
                losses, best = fn(*a, **k)
                ctx = self.current()
                if ctx is not None:
                    ctx.setdefault("losses", []).append(losses.clone())
                return losses, best
            return run

        for name in ("speculative_decode", "greedy_decode", "lookup_decode"):
            self._patch(vmod, name, keep_decode)
        self._patch(vmod, "score_options", keep_losses)

        def keep_vsm(fn):
            def run(*a, **k):
                out = fn(*a, **k)
                ctx = self.current()
                if ctx is not None:
                    rows = k.get("rows") or len(a[2])
                    ctx.setdefault("generated", []).extend(
                        int(x) for x in out.num_generated[:rows])
                    if ctx.get("keep"):
                        ctx.setdefault("outs", []).append(out)
                return out
            return run

        vsm_engine._generate = keep_vsm(vsm_engine._generate)
        self._undo.append((vsm_engine, "_generate", None))

    def uninstall(self):
        for owner, name, orig in reversed(self._undo):
            if orig is None:
                delattr(owner, name)
            else:
                setattr(owner, name, orig)
        self._undo.clear()

    def to_host(self):
        """Every kept device tensor read back (after the window)."""
        for ctx in self.calls:
            if "decodes" in ctx:
                ctx["decodes"] = [tuple(x.cpu() for x in d)
                                  for d in ctx["decodes"]]
            if "losses" in ctx:
                ctx["losses"] = [x.cpu() for x in ctx["losses"]]


class VQAProxy:
    """The VQA engine as the SEAL loop sees it: the free-form budget
    fixed, the trigger answered for `forced[question]`, outputs kept."""

    def __init__(self, engine, recorder: Recorder, budget: int,
                 forced: Dict[str, Sequence[str]]):
        self._engine, self._rec = engine, recorder
        self.budget, self.forced = budget, forced

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def free_form_many(self, images, questions, object_crops_list=None,
                       images_long=None, objects_long=None,
                       max_new_tokens=None):
        self._rec.enter({"kind": "free_form", "questions": list(questions),
                         "images_long": images_long,
                         "objects_long": objects_long})
        try:
            texts = self._engine.free_form_many(
                images, questions, object_crops_list, images_long,
                objects_long, max_new_tokens=self.budget)
        finally:
            self._rec.leave()
        return [TRIGGER + " " + ", ".join(self.forced[q]) + "."
                if self.forced.get(q) else t
                for q, t in zip(questions, texts)]

    def multiple_choice_many(self, images, questions, options_list,
                             object_crops_list=None, images_long=None,
                             objects_long=None):
        self._rec.enter({"kind": "options", "questions": list(questions),
                         "options": [list(o) for o in options_list],
                         "images_long": images_long,
                         "objects_long": objects_long})
        try:
            return self._engine.multiple_choice_many(
                images, questions, options_list, object_crops_list,
                images_long, objects_long)
        finally:
            self._rec.leave()


class VSMProxy:
    """The VSM engine as the search sees it: each call timed, its rows
    counted and their names and patch sizes kept; while `keeping` is on,
    each call's raw outputs (on the host already) kept too."""

    def __init__(self, engine, recorder: Recorder):
        self._engine, self._rec = engine, recorder
        self.keeping = False
        self.spans: List[tuple] = []       # (kind, start, end, rows)
        self._n = 0
        self._lock = threading.Lock()

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def _call(self, kind, patches, texts):
        with self._lock:
            number = self._n
            self._n += 1
        ctx = {"kind": kind, "number": number, "keep": self.keeping,
               "texts": list(texts),
               "sizes": [(p.width, p.height) for p in patches]}
        self._rec.enter(ctx)
        t0 = time.perf_counter()
        try:
            return getattr(self._engine, kind + "_many")(patches, texts)
        finally:
            self.spans.append((kind, t0, time.perf_counter(), len(patches)))
            self._rec.leave()

    def detect_many(self, patches, names):
        return self._call("detect", patches, names)

    def vqa_many(self, patches, questions):
        return self._call("vqa", patches, questions)

    def segment_many(self, patches, phrases):
        return self._call("segment", patches, phrases)
