"""Batched visual search (port of vstar_tpu/search/batched.py): many
searches advance in lockstep, and the VSM calls of one wave run as one
device batch, so B searches share every read of the 7B weights.

Batch sizes are bucketed to powers of two (padded with a repeated row),
as the JAX engine pads them, so the decoder sees the same shapes.
`device_preprocess=True` cuts every patch out of a device-resident canvas
of its image (kernels/image_ops.py) instead of cropping and resizing on
the host. `run_grouped_searches` sends a compiled whole-search engine
(search/compiled.CompiledVSMSearch) through its `search_many`.
"""

from __future__ import annotations

import threading
from collections import OrderedDict, defaultdict
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.preprocess import _normalize
from ..kernels import image_ops
from ..multimodal.constants import CLIP_MEAN, CLIP_STD
from ..multimodal.tokenizer import tokenize_with_image
from .engine import VSMEngine
from .policy import PatchRef, unwrap_patch, visual_search, visual_search_gen

BATCH_BUCKETS = (1, 2, 4, 8, 16)
# retained device canvases at most (~50 MB each for a 2K image in f32)
CANVAS_CAPACITY_MAX = 48

def _batch_bucket(n: int, buckets=None) -> int:
    buckets = BATCH_BUCKETS if buckets is None else buckets
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class BatchedVSMEngine(VSMEngine):
    """VSMEngine whose modes also take lists, run as one device batch.

    device_preprocess=True: each source image uploads once as a canvas
    (uint8, normalized on the device) and every patch of a wave is a pair
    of windows of it (the CLIP square window and the OWL-ViT crop). The
    cubic resampler differs from PIL's bicubic, so host preprocessing
    stays the default, as in the JAX package."""

    def __init__(self, *args, device_preprocess: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.device_preprocess = device_preprocess
        # id(image) -> _canvas_build's entry, LRU. The capacity
        # grows with the widest lockstep group seen (a group wider than a
        # device batch would otherwise evict its own canvases every wave)
        # up to CANVAS_CAPACITY_MAX.
        self._canvas_cache: OrderedDict = OrderedDict()
        self._canvas_capacity = BATCH_BUCKETS[-1]
        self._canvas_lock = threading.Lock()
        self._canvas_inflight: Dict = {}
        self._canvas_pool = self._upload_stream = None
        if device_preprocess:
            self._canvas_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="canvas-prefetch")
            if self.device.type == "cuda":
                self._upload_stream = torch.cuda.Stream(self.device)

    @property
    def wants_patch_refs(self) -> bool:
        return self.device_preprocess

    def set_canvas_capacity(self, n: int):
        """Bound the retained device canvases and trim now."""
        with self._canvas_lock:
            self._canvas_capacity = max(1, int(n))
            while len(self._canvas_cache) > self._canvas_capacity:
                self._canvas_cache.popitem(last=False)

    def _canvas_insert(self, key, entry):
        # the caller holds _canvas_lock; an entry holds its image, so a
        # cached id stays valid
        self._canvas_cache.pop(key, None)
        while len(self._canvas_cache) >= self._canvas_capacity:
            self._canvas_cache.popitem(last=False)
        self._canvas_cache[key] = entry

    def _canvas_build(self, image, stream=None):
        """(normalized device canvas, image, CUDA event or None). With a
        CUDA stream the uint8 canvas uploads from pinned memory and is
        normalized on that stream, and the calling thread waits for it;
        the event marks the end of that work."""
        arr, (h, w) = image_ops.u8_canvas(image)
        host = torch.from_numpy(arr)
        if stream is None:
            return image_ops.normalize_canvas_device(
                host.to(self.device), h, w), image, None
        with torch.cuda.stream(stream):
            canvas = image_ops.normalize_canvas_device(
                host.pin_memory().to(self.device, non_blocking=True), h, w)
            done = torch.cuda.Event()
            done.record(stream)
        done.synchronize()
        return canvas, image, done

    def prefetch_canvas(self, image):
        """Start this image's canvas build on the background thread (on
        the card: its own stream), to overlap the upload with what the
        caller does next. The finished canvas goes into the LRU cache; a
        build that raises raises again at this image's `_canvas`."""
        if not self.device_preprocess:
            return
        key = id(image)
        with self._canvas_lock:
            hit = self._canvas_cache.get(key)
            if (hit is not None and hit[1] is image) \
                    or key in self._canvas_inflight:
                return

            def build(image=image):
                entry = self._canvas_build(image, self._upload_stream)
                with self._canvas_lock:
                    self._canvas_insert(key, entry)
                    self._canvas_inflight.pop(key, None)
                return entry

            self._canvas_inflight[key] = self._canvas_pool.submit(build)

    def _canvas(self, image):
        """The image's normalized canvas, ready to read on the current
        stream: from the cache, from its prefetch, or built now."""
        key = id(image)
        fut = None
        with self._canvas_lock:
            entry = self._canvas_cache.get(key)
            if entry is None or entry[1] is not image:
                entry = None
                fut = self._canvas_inflight.pop(key, None)
        if fut is not None:
            entry = fut.result()            # raises the build's error
            if entry[1] is not image:       # the id was reused since
                entry = None
        if entry is None:
            entry = self._canvas_build(image)
        with self._canvas_lock:
            self._canvas_insert(key, entry)
        canvas, _, done = entry
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            # allocated on the upload stream: keep the block from reuse
            # until this stream's reads are done
            canvas.record_stream(stream)
        return canvas

    def _tower_rows(self, images: Sequence):
        """Per-patch (CLIP, OWL-ViT) inputs: device patches as normalized
        f32 windows of their canvas, one pair_windows call per canvas (its
        rows padded to a batch bucket); the others as uint8 host arrays."""
        clip_size = self.cfg.vision.image_size
        owl_size = self.cfg.owl_vision.image_size
        clips: List = [None] * len(images)
        owls: List = [None] * len(images)
        groups: Dict[int, list] = {}
        for i, img in enumerate(images):
            if self.device_preprocess and isinstance(img, PatchRef):
                g = groups.get(id(img.image))
                if g is None:
                    g = groups[id(img.image)] = [self._canvas(img.image),
                                                 [], [], []]
                g[1].append(i)
                g[2].append(image_ops.square_window(img.bbox))
                g[3].append(img.bbox)
            else:
                clips[i], owls[i] = self._host_towers(unwrap_patch(img))
        for canvas, idxs, sqs, crops in groups.values():
            pad = _batch_bucket(len(idxs)) - len(idxs)
            c, o = image_ops.pair_windows(canvas, sqs + sqs[:1] * pad,
                                          crops + crops[:1] * pad,
                                          clip_size, owl_size)
            for j, i in enumerate(idxs):
                clips[i], owls[i] = c[j], o[j]
        return clips, owls, bool(groups)

    def _stack(self, rows, on_device: bool) -> torch.Tensor:
        """One batch of tower inputs. All-host rows upload as one uint8
        array (vsm_generate normalizes them); with device rows in the wave
        the host rows are normalized on the host first, as JAX does."""
        if not on_device:
            return self._to_device(np.stack(rows))
        return torch.stack([
            self._to_device(_normalize(r, CLIP_MEAN, CLIP_STD))
            if isinstance(r, np.ndarray) else r for r in rows])

    def _run_many(self, images: Sequence, questions: Sequence[str]):
        """vsm_generate over a wave of patches: (outputs on the host, the
        wave's row count). A wave above the largest batch bucket runs as
        bucket-sized device batches whose outputs are concatenated."""
        n = len(images)
        if n == 0:
            raise ValueError("an empty wave")
        if self.device_preprocess:
            distinct = len({id(p.image) for p in images
                            if isinstance(p, PatchRef)})
            with self._canvas_lock:
                self._canvas_capacity = min(
                    max(self._canvas_capacity, distinct + 1),
                    CANVAS_CAPACITY_MAX)
        max_bb = BATCH_BUCKETS[-1]
        if n > max_bb:
            parts = [self._run_many(images[a:a + max_bb],
                                    questions[a:a + max_bb])[0]
                     for a in range(0, n, max_bb)]
            merged = parts[0]._replace(**{
                f: torch.cat([getattr(p, f) for p in parts])
                for f, v in parts[0]._asdict().items()
                if isinstance(v, torch.Tensor)})
            return merged, n
        lays, bucket = self._layouts(questions)
        clips, owls, on_device = self._tower_rows(images)
        pad = _batch_bucket(n) - n
        clips += clips[:1] * pad
        owls += owls[:1] * pad
        lays += lays[:1] * pad
        out = self._generate(self._stack(clips, on_device),
                             self._stack(owls, on_device), lays, bucket,
                             rows=n)
        return out, n

    def detect_many(self, patches: Sequence, names: Sequence[str]):
        out, n = self._run_many(
            patches, [f"Please locate the {m} in this image." for m in names])
        return [self._detection(out, (patches[b].height, patches[b].width),
                                b) for b in range(n)]

    def vqa_many(self, patches: Sequence, questions: Sequence[str]):
        out, n = self._run_many(patches, questions)
        return [self._answer(out, b) for b in range(n)]

    def segment_many(self, patches: Sequence, phrases: Sequence[str]):
        out, n = self._run_many(
            patches, [f"Please locate the {p} in this image." for p in phrases])
        return [self._heatmap(out, (patches[b].height, patches[b].width), b)
                for b in range(n)]


def run_batched_searches(engine: BatchedVSMEngine, images: Sequence,
                         names: Sequence[str], target_bboxes=None,
                         visualize: bool = False, save_paths=None,
                         path_outs=None, **search_kwargs) -> List[Tuple]:
    """len(images) guided searches in lockstep: each wave sends the
    pending VSM requests of one kind as one batch. Each result is
    `visual_search`'s return tuple. With visualize=True each task writes
    its overlays under its save_paths entry; path_outs (the port's
    addition), a list per task or None, receive the visited steps."""
    n = len(images)
    if visualize and (save_paths is None or len(save_paths) != n):
        raise ValueError("visualize needs one save path per search")
    paths: List[List] = [[] for _ in range(n)] if path_outs is None else \
        [[] if p is None else p for p in path_outs]
    gens = [visual_search_gen(images[i], names[i], path_out=paths[i],
                              **search_kwargs) for i in range(n)]
    results: List[Optional[Tuple]] = [None] * n
    pending: Dict[int, Tuple] = {}
    for i, g in enumerate(gens):
        try:
            pending[i] = next(g)
        except StopIteration as stop:
            results[i] = stop.value

    dispatch = {"detect": engine.detect_many, "vqa": engine.vqa_many,
                "segment": engine.segment_many}
    refs = getattr(engine, "wants_patch_refs", False)
    while pending:
        for kind in ("detect", "vqa", "segment"):
            idxs = [i for i, (k, _, _) in pending.items() if k == kind]
            if not idxs:
                continue
            patches = [pending[i][1] for i in idxs]
            if not refs:
                patches = [unwrap_patch(p) for p in patches]
            outs = dispatch[kind](patches, [pending[i][2] for i in idxs])
            for i, out in zip(idxs, outs):
                try:
                    pending[i] = gens[i].send(out)
                except StopIteration as stop:
                    results[i] = stop.value
                    del pending[i]
    if visualize:
        from .visualize import visualize_search_path
        for i in range(n):
            _, plen, ok, _ = results[i]
            visualize_search_path(
                images[i], paths[i], plen if ok else len(paths[i]),
                None if target_bboxes is None else target_bboxes[i],
                names[i], save_paths[i])
    return results


def run_grouped_searches(engine, tasks: Sequence[Dict], image_batch=None,
                         max_steps=None, visualize: bool = False,
                         **policy_kw) -> List[Tuple]:
    """Searches whose smallest size may differ per task, results in task
    order (each visual_search's return tuple).

    tasks: dicts with 'image' (a PIL image, or a zero-argument callable
    that opens it), 'name', 'smallest', optional 'gt_bbox', 'vis_path'
    and (the port's addition) 'path_out', a list that receives the
    visited steps. An engine with detect_many runs the tasks as lockstep
    waves: grouped by smallest size, each group chunked by image_batch
    (None: the whole group in one chunk). An engine without it, or
    image_batch == 1 on a host-preprocess engine, runs one serial
    visual_search per task; a device-preprocess engine stays on the
    lockstep waves at image_batch == 1 (the serial path would crop on
    the host). A compiled whole-search engine (an engine with `search`)
    runs consecutive tasks of one canvas bucket as one search_many,
    image_batch capped by its batch buckets."""
    def img(t):
        return t["image"]() if callable(t["image"]) else t["image"]

    if hasattr(engine, "search") and not hasattr(engine, "detect_many"):
        return _compiled_grouped(engine, tasks, img, image_batch, max_steps,
                                 visualize, policy_kw)
    outs: List[Optional[Tuple]] = [None] * len(tasks)
    serial = not hasattr(engine, "detect_many") or (
        image_batch == 1 and not getattr(engine, "wants_patch_refs", False))
    if serial:
        for i, t in enumerate(tasks):
            outs[i] = visual_search(
                engine, img(t), t["name"], smallest_size=t["smallest"],
                target_bbox=t.get("gt_bbox"), max_steps=max_steps,
                visualize=visualize, save_path=t.get("vis_path"),
                path_out=t.get("path_out"), **policy_kw)
        return outs
    by_small: Dict[int, List[int]] = defaultdict(list)
    for i, t in enumerate(tasks):
        by_small[t["smallest"]].append(i)
    for s_val, idxs in by_small.items():
        step = image_batch or len(idxs)
        for a in range(0, len(idxs), step):
            grp = idxs[a:a + step]
            res = run_batched_searches(
                engine, [img(tasks[i]) for i in grp],
                [tasks[i]["name"] for i in grp],
                target_bboxes=[tasks[i].get("gt_bbox") for i in grp],
                visualize=visualize,
                save_paths=[tasks[i].get("vis_path") for i in grp],
                path_outs=[tasks[i].get("path_out") for i in grp],
                smallest_size=s_val, max_steps=max_steps, **policy_kw)
            for i, r in zip(grp, res):
                outs[i] = r
    return outs


def _compiled_grouped(engine, tasks, img, image_batch, max_steps,
                      visualize, policy_kw) -> List[Tuple]:
    """run_grouped_searches on a CompiledVSMSearch: consecutive tasks
    whose images land in one canvas bucket run as one search_many (the
    7B weight reads shared by the searches), at most the engine's
    largest batch bucket (and image_batch) at a time. Tasks that share
    an image factory share the opened image, so its canvas is cached by
    id."""
    if visualize:
        raise ValueError(
            "compiled search keeps heatmaps on device; use the host "
            "or batched engine for --visualization")
    max_b = engine.BATCH_BUCKETS[-1]
    if image_batch:
        max_b = min(max_b, image_batch)
    outs: List[Optional[Tuple]] = [None] * len(tasks)
    chunk_idx: List[int] = []
    chunk_imgs: List = []

    def flush():
        if not chunk_idx:
            return
        res = engine.search_many(
            chunk_imgs, [tasks[j]["name"] for j in chunk_idx],
            [tasks[j]["smallest"] for j in chunk_idx],
            max_steps=max_steps, **policy_kw)
        for j, r in zip(chunk_idx, res):
            outs[j] = r
        chunk_idx.clear()
        chunk_imgs.clear()

    cur_bucket = None
    prev_factory, prev_img = None, None
    for i, t in enumerate(tasks):
        im = prev_img if t["image"] is prev_factory else img(t)
        prev_factory, prev_img = t["image"], im
        bk = image_ops.canvas_bucket_hw(im.height, im.width)
        if chunk_idx and (bk != cur_bucket or len(chunk_idx) >= max_b):
            flush()
        cur_bucket = bk
        chunk_idx.append(i)
        chunk_imgs.append(im)
    flush()
    return outs


def _filler_for_bucket(length_of, lo: int, hi: int):
    """A filler question whose spliced length lands in (lo, hi]; host
    token counting only. None if no filler reaches it."""
    k = 1
    while k < 20000:
        text = "where is the " + "very " * k + "small object ?"
        n = length_of(text)
        if n > hi:
            return None
        if n > lo:
            return text
        k += max(1, (lo - n) // 2 + 1)
    return None


def warmup_vsm_engine(engine: BatchedVSMEngine,
                      canvas_sizes=((512, 512),),
                      batch_buckets=BATCH_BUCKETS, log=print):
    """Run every (mode x batch bucket x prompt bucket) once before live
    traffic, and for a device-preprocess engine the canvas windows of
    every same-canvas group bucket per extra canvas size. Eager PyTorch
    compiles nothing; on the card this builds the kernels on first use
    and warms cuBLAS and the caching allocator at each shape."""
    from PIL import Image

    def length_of(q):
        ids = tokenize_with_image(engine._build_prompt(q), engine.tokenizer)
        return len(ids) - 1 + engine.cfg.image_tokens

    texts = ["where is the small object ?"]
    lo = engine.prompt_buckets[0]
    for b in engine.prompt_buckets[1:]:
        t = _filler_for_bucket(length_of, lo, b)
        if t is not None:
            texts.append(t)
        elif log:
            log(f"[warmup] vsm prompt bucket {b} unreachable by filler "
                f"text: the first live prompt in ({lo}, {b}] warms it")
        lo = b

    rng = np.random.RandomState(0)

    def make_patch(h, w):
        img = Image.fromarray((rng.rand(h, w, 3) * 255).astype("uint8"))
        return (PatchRef(img, [0, 0, w, h])
                if getattr(engine, "device_preprocess", False) else img)

    h0, w0 = canvas_sizes[0]
    patch = make_patch(h0, w0)
    # the largest caches first: the smaller ones are views of their slab
    # (decode/graphs.py)
    for bb in sorted(batch_buckets, reverse=True):
        for kind, fn in (("detect", engine.detect_many),
                         ("vqa", engine.vqa_many),
                         ("segment", engine.segment_many)):
            for text in reversed(texts):
                fn([patch] * bb, [text] * bb)
            if log:
                log(f"[warmup] vsm {kind} B={bb} ({len(texts)} prompt "
                    f"buckets) warmed")
    group_buckets = tuple(b for b in BATCH_BUCKETS
                          if b <= max(batch_buckets))
    for h, w in canvas_sizes[1:]:
        p = make_patch(h, w)
        for g in reversed(group_buckets):
            engine.detect_many([p] * g, [texts[0]] * g)
        if log:
            log(f"[warmup] vsm canvas {h}x{w} (group buckets "
                f"{'/'.join(str(g) for g in group_buckets)}) warmed")
