"""Request-level continuous batching for SEAL serving (port of
vstar_tpu/serve/continuous.py).

The reference demo is a blocking batch-1 Gradio queue (app.py:235-255).
Here concurrent requests are admitted continuously: a scheduler thread
drains the request queue into waves (up to `max_batch`, waiting at most
`window_ms` after the first arrival) and drives the phase-batched SEAL
pipeline, so every 7B weight read is shared across all requests in
flight — the same lockstep machinery the batched benchmark uses
(eval/batched_bench.py), applied online. New requests that arrive while a
wave is on-device join the next wave immediately; nothing ever waits for
an idle window.

Both request kinds mix in one wave:
  * options present  -> SEAL multiple-choice record (seal_answer schema),
  * freeform         -> demo-flow record (app.py:130-233 schema:
                        freeform/answer/missing/failed/search_result).
Multiple-choice scoring co-batches rows with the same option count
(counts differ rarely in practice).

Device work runs on the scheduler thread, or with pipeline=True on the
two stage workers (one per engine, so each engine's static caches and
decode graphs, decode/graphs.py, serve one decode at a time). The HTTP
handler threads only prefetch canvases, which upload on the engine's
own stream from its pool thread (search/batched.py).

Under a mesh (`ranks`, serve/ranks.py: engines sharded over torchrun's
ranks) rank 0's scheduler broadcasts each wave after its decode filter
and before the wave runs; the other ranks run no scheduler and run the
same wave through `run_message`. Errors then follow the ranks'
agreement:
  * an error every rank reaches alike, because it comes from the wave's
    inputs (a prompt too long for the buckets, an option count the
    scorer refuses), fails that wave's requests, and the service goes
    on, as on one card;
  * an error only some ranks reach fails the world: every rank raises
    serve/ranks.WorldFailure and exits non-zero within the serving
    group's timeout (a rank left in a collective of the engines, within
    the mesh's). Running out of memory is such an error: one rank's
    allocator fails mid-forward while the others wait in a layer
    gather, so a wave is never split on it (`_split_on_oom` splits on
    one card only).
pipeline=True (two stage workers on one process) has no form under a
mesh and raises ValueError.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import defaultdict
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence

import torch
from PIL import Image

from ..data.preprocess import expand2square
from ..eval.batched_bench import build_focus_inputs, run_search_phase
from ..eval.seal import parse_missing_objects
from .ranks import Ranks, WorldFailure, image_array
from .sanitize import sanitize_text


class _Request:
    __slots__ = ("image", "question", "options", "future", "t_submit")

    def __init__(self, image, question, options):
        self.image = image
        self.question = question
        self.options = options
        self.future: Future = Future()
        self.t_submit = time.perf_counter()


class ContinuousSealService:
    """Drop-in SealService replacement whose .answer() co-batches
    concurrent callers. Thread-safe; device work runs only on the
    scheduler thread (or the stage workers with pipeline=True)."""

    def __init__(self, vqa_engine, vsm_engine, minimum_size_scale: float = 4.0,
                 minimum_size: int = 224,
                 max_search_steps: Optional[int] = None,
                 max_batch: int = 8, window_ms: float = 8.0,
                 missing_parser=None, search_kwargs: Optional[Dict] = None,
                 pipeline: bool = False, ranks: Optional[Ranks] = None):
        if pipeline and ranks is not None:
            raise ValueError("pipeline=True runs two stage workers in one "
                             "process; under a mesh every rank must make "
                             "the same engine calls in the same order, so "
                             "it has no form there")
        self.ranks = ranks
        self.vqa = vqa_engine
        self.vsm = vsm_engine
        self.minimum_size_scale = minimum_size_scale
        self.minimum_size = minimum_size
        self.max_search_steps = max_search_steps
        # prediction -> [object names] to search for. Default is the
        # reference trigger-sentence parse (vstar_bench_eval.py:197-203);
        # injectable for custom trigger formats and for benchmarks that
        # must force the search path under random weights.
        self.missing_parser = missing_parser or parse_missing_objects
        # extra search-policy kwargs (thresholds etc.), forwarded to every
        # search wave — same knob eval_model_phased exposes
        self.search_kwargs = dict(search_kwargs or {})
        self.max_batch = max_batch
        self.window = window_ms / 1000.0
        # serving images are fresh per request: canvases retained past
        # the current wave are pure device-memory pressure (see
        # BatchedVSMEngine.set_canvas_capacity). Admission-time prefetch
        # uploads the NEXT wave's canvases during the current one, so
        # keep two waves' worth
        setcap = getattr(vsm_engine, "set_canvas_capacity", None)
        if setcap is not None:
            setcap(2 * max_batch)
        self._q: "queue.Queue[_Request]" = queue.Queue()
        self._stop = threading.Event()
        self._n_waves = 0
        self._n_requests = 0
        self._max_wave = 0
        self._n_oom_splits = 0
        # bounded-wave admission after running out of device memory: an
        # OOM at wave size n caps future waves at the size that fit; 32
        # clean waves at the cap regrow it one doubling (bounded
        # oscillation: one failed dispatch per ~32 waves while pressure
        # persists)
        self._wave_cap: Optional[int] = None
        self._clean_at_cap = 0
        # pipeline=True overlaps wave k's searches (VSM engine) with wave
        # k+1's trigger answers and wave k-1's focus scoring (VQA engine):
        # the natural mode when the pair sits on two devices, each
        # model busy instead of idling through the other's phase. Three
        # threads: the wave former, a VQA worker (trigger + finish
        # stages, one engine -> one thread), a VSM worker (search stage).
        # On one card the two workers' launches share the device.
        self.pipeline = pipeline
        self._workers: List[threading.Thread] = []
        if pipeline:
            self._s_search: "queue.Queue" = queue.Queue()
            self._s_finish: "queue.Queue" = queue.Queue()
            self._trigger_q: "queue.Queue" = queue.Queue()
            for fn in (self._vqa_worker, self._vsm_worker):
                t = threading.Thread(target=fn, daemon=True)
                t.start()
                self._workers.append(t)
        self._thread = None
        if ranks is None or ranks.leader:   # followers run serve/ranks.follow
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    # -- public API --------------------------------------------------------

    def answer(self, image: Image.Image, question: str,
               options: Optional[Sequence[str]] = None,
               timeout: Optional[float] = None) -> Dict:
        if self._thread is None:
            raise RuntimeError(f"rank {self.ranks.rank} follows rank 0, "
                               "which takes the requests")
        if self._stop.is_set():
            raise RuntimeError("ContinuousSealService is closed")
        question = sanitize_text(question)
        if options:
            options = [sanitize_text(o) for o in options]
        req = _Request(image, question, options or None)
        # admission-time canvas prefetch: the device canvas upload
        # overlaps with queue wait + the current wave instead of
        # serializing in front of this request's first search wave
        prefetch = getattr(self.vsm, "prefetch_canvas", None)
        if prefetch is not None:
            prefetch(image)
        self._q.put(req)
        if self._stop.is_set():  # closed between the check and the put
            self._fail_queued(RuntimeError("ContinuousSealService closed"))
        rec = req.future.result(timeout=timeout)
        rec["latency_s"] = round(time.perf_counter() - req.t_submit, 4)
        return rec

    def stats(self) -> Dict:
        return {"waves": self._n_waves,
                "requests": self._n_requests,
                "max_wave": self._max_wave,
                "mean_wave": (self._n_requests / self._n_waves
                              if self._n_waves else 0.0),
                "oom_splits": self._n_oom_splits,
                "wave_cap": self._wave_cap,
                "queue_depth": self._q.qsize()}

    def close(self):
        """Stop the scheduler; pending/in-flight requests get a
        RuntimeError rather than hanging their caller threads. In
        pipeline mode the stage queues are drained too: a wave parked
        between stages when close() fires must fail its futures, not
        strand its callers (workers exit on the stop flag without
        processing further stages)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        for t in self._workers:
            t.join(timeout=10)
        exc = RuntimeError("ContinuousSealService closed")
        self._fail_queued(exc)
        self._drain_stages(exc)

    def _fail_queued(self, exc: BaseException):
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                return
            if not req.future.done():
                req.future.set_exception(exc)

    def _drain_stages(self, exc: BaseException):
        """Fail every wave parked in a pipeline stage queue (no-op when
        pipeline=False). Items are (wave, ...) tuples except _trigger_q,
        whose items are the bare wave list."""
        if not self.pipeline:
            return
        for q_ in (self._trigger_q, self._s_search, self._s_finish):
            while True:
                try:
                    item = q_.get_nowait()
                except queue.Empty:
                    break
                wave = item if isinstance(item, list) else item[0]
                self._fail_wave(wave, exc)

    # -- scheduler ---------------------------------------------------------

    def _loop(self):
        try:
            while not self._stop.is_set():
                try:
                    first = self._q.get(timeout=0.1)
                except queue.Empty:
                    continue
                wave = [first]
                deadline = time.monotonic() + self.window
                # adaptive admission: after an OOM split, form waves at
                # the size that actually fit (regrows after clean waves)
                cap = min(self.max_batch, self._wave_cap or self.max_batch)
                while len(wave) < cap:
                    remain = deadline - time.monotonic()
                    if remain <= 0:
                        break
                    try:
                        wave.append(self._q.get(timeout=remain))
                    except queue.Empty:
                        break
                self._n_waves += 1
                self._n_requests += len(wave)
                self._max_wave = max(self._max_wave, len(wave))
                # confine bad inputs to their own request: decode each
                # image up front; a corrupt one must not 500 the 7 other
                # requests co-batched in its wave
                ok_wave = []
                for r in wave:
                    try:
                        if hasattr(r.image, "load"):
                            r.image.load()   # force decode; raises here
                        ok_wave.append(r)
                    except Exception as e:
                        if not r.future.done():
                            r.future.set_exception(e)
                wave = ok_wave
                if not wave:
                    continue
                if self.pipeline:
                    # hand to the stage workers; the former immediately
                    # returns to admitting the next wave
                    self._trigger_q.put(wave)
                    continue
                try:
                    recs = self._run_wave(wave)
                    for r, rec in zip(wave, recs):
                        r.future.set_result(rec)
                except WorldFailure as e:
                    self._fail_wave(wave, e)
                    return   # the ranks parted: stop serving
                except BaseException as e:
                    self._fail_wave(wave, e)
                    if not isinstance(e, Exception):
                        raise  # KeyboardInterrupt etc: die, but visibly
        finally:
            # scheduler exiting (close() or fatal error): never leave a
            # caller blocked on a future nobody will complete. Stage
            # queues are swept again by close() after worker join; this
            # sweep covers the fatal-error path where close() never runs.
            self._stop.set()
            exc = RuntimeError("seal scheduler stopped")
            self._fail_queued(exc)
            self._drain_stages(exc)

    def _run_wave(self, wave: List[_Request]) -> List[Dict]:
        """The wave on the engines; under a mesh announced to the
        followers first (images as the uint8 arrays they rebuild), and its
        outcome the ranks' agreement."""
        if self.ranks is None:
            return self._process_wave(wave)
        payload = [(image_array(r.image), r.question, r.options)
                   for r in wave]
        return self.ranks.lead("wave", payload,
                               lambda: self._process_wave(wave))

    def run_message(self, kind: str, payload) -> List[Dict]:
        """A follower's side of rank 0's ("wave", [(image array, question,
        options), ...]) message: the same wave on this rank's engines."""
        if kind != "wave":
            raise ValueError(f"ContinuousSealService follows 'wave' "
                             f"messages, not {kind!r}")
        return self._process_wave([_Request(Image.fromarray(a), q, o)
                                   for a, q, o in payload])

    @staticmethod
    def _fail_wave(wave, exc: BaseException):
        for r in wave:
            if not r.future.done():
                r.future.set_exception(exc)

    # -- pipeline stage workers (pipeline=True) -----------------------------

    def _vqa_worker(self):
        """Both VQA stages on ONE thread (one engine, one thread):
        finish drains before trigger so completed searches never queue
        behind new admissions."""
        while not self._stop.is_set():
            try:
                item = self._s_finish.get(timeout=0.02)
                kind = "finish"
            except queue.Empty:
                try:
                    item = self._trigger_q.get(timeout=0.02)
                    kind = "trigger"
                except queue.Empty:
                    continue
            wave = item if kind == "trigger" else item[0]
            try:
                if self._stop.is_set():
                    # closing: don't hand downstream to a worker that may
                    # already have exited — fail the wave here
                    self._fail_wave(wave, RuntimeError(
                        "ContinuousSealService closed"))
                    continue
                if kind == "trigger":
                    splits0 = self._n_oom_splits
                    squared, predictions, missing = self._split_on_oom(
                        self._stage_trigger, wave)
                    if self._stop.is_set():
                        self._fail_wave(wave, RuntimeError(
                            "ContinuousSealService closed"))
                        continue
                    self._s_search.put((wave, squared, predictions,
                                        missing, splits0))
                else:
                    _, squared, predictions, missing, srs, fls, splits0 \
                        = item
                    (recs,) = self._split_on_oom(
                        self._finish_tuple, wave, squared, predictions,
                        missing, srs, fls)
                    self._note_wave_done(len(wave), splits0)
                    for r, rec in zip(wave, recs):
                        r.future.set_result(rec)
            except BaseException as e:
                self._fail_wave(wave, e)
                if not isinstance(e, Exception):
                    raise

    def _vsm_worker(self):
        while not self._stop.is_set():
            try:
                item = self._s_search.get(timeout=0.05)
            except queue.Empty:
                continue
            wave, squared, predictions, missing, splits0 = item
            try:
                if self._stop.is_set():
                    self._fail_wave(wave, RuntimeError(
                        "ContinuousSealService closed"))
                    continue
                srs, fls = self._split_on_oom(self._stage_search, wave,
                                              missing)
                if self._stop.is_set():
                    self._fail_wave(wave, RuntimeError(
                        "ContinuousSealService closed"))
                    continue
                self._s_finish.put((wave, squared, predictions, missing,
                                    srs, fls, splits0))
            except BaseException as e:
                self._fail_wave(wave, e)
                if not isinstance(e, Exception):
                    raise

    # -- phased pipeline ---------------------------------------------------

    def _free_form_many(self, images, questions, **kw):
        if hasattr(self.vqa, "free_form_many"):
            return self.vqa.free_form_many(images, questions, **kw)
        per_row = [{k: (v[i] if v is not None else None)
                    for k, v in kw.items()}
                   for i in range(len(images))]
        return [self.vqa.free_form(im, q,
                                   **{("object_crops" if k ==
                                       "object_crops_list" else k): v
                                      for k, v in row.items()})
                for im, q, row in zip(images, questions, per_row)]

    @staticmethod
    def _is_oom(e: Exception) -> bool:
        # the caching allocator raises its own type; no message of it
        # names the strings vstar_tpu matches
        return isinstance(e, torch.cuda.OutOfMemoryError)

    def _split_on_oom(self, stage, reqs, *cols):
        """Run stage(reqs, *cols) — cols are per-row parallel lists, the
        stage returns a TUPLE of per-row lists. When the device runs out
        of memory (torch.cuda.OutOfMemoryError) halve the wave and
        merge: a transiently over-committed card (big wave x big
        canvases x co-resident pair) degrades to two smaller
        dispatches instead of failing all co-batched callers; the halves
        run on the same engines. Recursion bottoms out at single
        requests, whose OOM is a real error. Any other error fails the
        wave. Under a mesh nothing is split (see the module docstring)."""
        if self.ranks is not None:
            return stage(reqs, *cols)
        try:
            return stage(reqs, *cols)
        except Exception as e:
            if len(reqs) < 2 or not self._is_oom(e):
                raise
            self._n_oom_splits += 1
            mid = (len(reqs) + 1) // 2
            # admission feedback: form future waves at the size that fit
            self._wave_cap = max(1, min(self._wave_cap or len(reqs), mid))
            self._clean_at_cap = 0
            a = self._split_on_oom(stage, reqs[:mid],
                                   *[c[:mid] for c in cols])
            b = self._split_on_oom(stage, reqs[mid:],
                                   *[c[mid:] for c in cols])
            return tuple(list(x) + list(y) for x, y in zip(a, b))

    def _finish_tuple(self, reqs, *cols):
        return (self._stage_finish(reqs, *cols),)

    def _note_wave_done(self, wave_size: int, splits_before: int):
        """Regrow a post-OOM wave cap after 32 clean CAP-SIZED waves (one
        doubling at a time): transient pressure lifts, sustained pressure
        costs one failed dispatch per ~32 waves. Only waves that (a)
        actually reached the cap size and (b) dispatched without
        splitting are evidence the cap fits — sub-cap waves say nothing
        about it, and the wave whose own OOM set the cap must not count
        as its first clean success."""
        if self._wave_cap is None:
            return
        if wave_size < self._wave_cap or self._n_oom_splits != splits_before:
            return
        self._clean_at_cap += 1
        if self._clean_at_cap >= 32:
            self._clean_at_cap = 0
            cap = self._wave_cap * 2
            self._wave_cap = None if cap >= self.max_batch else cap

    def _process_wave(self, reqs: List[_Request]) -> List[Dict]:
        splits0 = self._n_oom_splits
        squared, predictions, missing = self._split_on_oom(
            self._stage_trigger, reqs)
        search_results, failed = self._split_on_oom(
            self._stage_search, reqs, missing)
        (recs,) = self._split_on_oom(
            self._finish_tuple, reqs, squared, predictions, missing,
            search_results, failed)
        self._note_wave_done(len(reqs), splits0)
        return recs

    def _stage_trigger(self, reqs: List[_Request]):
        """Free-form trigger answers (VQA engine)."""
        squared = [expand2square(r.image)[0] for r in reqs]
        predictions = self._free_form_many(squared,
                                           [r.question for r in reqs])
        missing = [self.missing_parser(p) for p in predictions]
        return squared, predictions, missing

    def _stage_search(self, reqs: List[_Request], missing):
        """All the wave's guided searches (VSM engine)."""
        return run_search_phase(
            self.vsm, [r.image for r in reqs], missing,
            self.minimum_size_scale, self.minimum_size,
            self.max_search_steps, **self.search_kwargs)

    def _stage_finish(self, reqs: List[_Request], squared, predictions,
                      missing, search_results, failed) -> List[Dict]:
        """Focused re-answers / option scoring (VQA engine)."""
        n = len(reqs)
        recs: List[Optional[Dict]] = [None] * n

        # Assemble the finish phases.
        ff_rows = []                       # freeform focused re-answers
        mc_groups = defaultdict(list)      # option-count -> mc rows
        for i, r in enumerate(reqs):
            if r.options is not None:
                if missing[i]:
                    sq, q, crops, il, ol = build_focus_inputs(
                        self.vqa, r.image, r.question, search_results[i])
                else:
                    sq, q, crops, il, ol = (squared[i], r.question,
                                            None, None, None)
                mc_groups[len(r.options)].append(
                    (i, sq, q, list(r.options), crops, il, ol))
            elif missing[i] and search_results[i]:
                sq, q, crops, il, ol = build_focus_inputs(
                    self.vqa, r.image, r.question, search_results[i],
                    failed[i], include_failed=True)
                ff_rows.append((i, sq, q, crops, il, ol))
            else:
                recs[i] = {"freeform": predictions[i],
                           "answer": predictions[i],
                           "missing_objects": missing[i],
                           "failed_objects": failed[i],
                           "search_result": search_results[i]}

        if ff_rows:
            answers = self._free_form_many(
                [r[1] for r in ff_rows], [r[2] for r in ff_rows],
                object_crops_list=[r[3] for r in ff_rows],
                images_long=[r[4] for r in ff_rows],
                objects_long=[r[5] for r in ff_rows])
            for (i, *_), ans in zip(ff_rows, answers):
                recs[i] = {"freeform": predictions[i], "answer": ans,
                           "missing_objects": missing[i],
                           "failed_objects": failed[i],
                           "search_result": search_results[i]}

        for rows in mc_groups.values():
            if hasattr(self.vqa, "multiple_choice_many"):
                chosen = self.vqa.multiple_choice_many(
                    [r[1] for r in rows], [r[2] for r in rows],
                    [r[3] for r in rows],
                    object_crops_list=[r[4] for r in rows],
                    images_long=[r[5] for r in rows],
                    objects_long=[r[6] for r in rows])
            else:
                chosen = [self.vqa.multiple_choice(
                    r[1], r[2], r[3], r[4],
                    images_long=r[5], objects_long=r[6])
                    if r[4] is not None else
                    self.vqa.multiple_choice(r[1], r[2], r[3])
                    for r in rows]
            for (i, _, _, opts, *_), c in zip(rows, chosen):
                recs[i] = {"question": reqs[i].question, "options": opts,
                           "prediction_freeform": predictions[i],
                           "missing_objects": missing[i],
                           "search_result": search_results[i],
                           "option_chosen": int(c),
                           "correct": int(int(c) == 0)}
        return recs
