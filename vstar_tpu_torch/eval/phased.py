"""Phase-swapped V*Bench evaluation (port of vstar_tpu/eval/phased.py).

The SEAL loop (the reference's vstar_bench_eval.py:168-280) interleaves
two 7B models per image. This runner executes the SAME loop with only ONE
model resident at a time by re-ordering it around weight residency (in
vstar_tpu the int8 pair does not fit one 16 GB TPU chip; an 80 GB card
holds the bf16 pair, so here it is the batched phase order and
`force_missing`, the forced-search hook of the throughput unit, that
matter):

  phase 1  VQA resident:  free-form trigger over ALL images (batched)
  swap     drop the VQA engine, build the VSM engine (ONE swap,
           amortized over the whole dataset — not per image)
  phase 2  VSM resident:  every sample's searches, grouped + batched
           (fused whole-search programs when the factory wraps the
           engine in CompiledVSMSearch)
  swap     drop the VSM engine, rebuild the VQA engine
  phase 3  VQA resident:  focus re-ask / option scoring over ALL samples

Per-sample records are identical to eval_model's serial loop (the phase
pieces are shared with eval/seal.py): the phases only reorder
INDEPENDENT samples, never the data flow within one.

Engines are produced by zero-arg factories so each phase controls weight
residency: with real checkpoints a factory re-reads the checkpoint and
re-uploads; `parked_factory` re-uploads a pinned host copy instead.
`free_engine` drops the engine's weights, canvases, captured decode
graphs and static caches, then returns the freed blocks to the device,
so that the next factory's weights fit.
"""

from __future__ import annotations

import gc
import json
import os
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..decode.graphs import DecodeGraphs
from .seal import (collect_search_results, focus_inputs,
                   parse_missing_objects, seal_record, smallest_size)

TEST_TYPES = ("direct_attributes", "relative_position")


def iter_benchmark(benchmark_folder: str) -> List[Dict]:
    """V*Bench samples in eval_model's walk order: [{test_type, file,
    path, question, options, annotation}]."""
    samples = []
    for test_type in TEST_TYPES:
        folder = os.path.join(benchmark_folder, test_type)
        if not os.path.isdir(folder):
            continue
        for image_file in sorted(os.listdir(folder)):
            if ".json" in image_file:
                continue
            path = os.path.join(folder, image_file)
            ann = json.load(open(path.rsplit(".", 1)[0] + ".json"))
            samples.append({"test_type": test_type, "file": image_file,
                            "path": path, "question": ann["question"],
                            "options": ann["options"],
                            "annotation": ann})
    return samples


def free_engine(engine) -> None:
    """Drop an engine's device residency so the next phase's weights fit:
    its params, its canvas cache, and its DecodeGraphs (decode/graphs.py),
    whose captured graphs hold the weights, the static caches and the
    graph pool alive; the engine gets an empty one, so that it can serve
    again once its params are back (parked_factory). Then the freed
    blocks go back to the device (torch.cuda.empty_cache). The caller
    must also drop its own references."""
    if engine is None:
        return
    inner = getattr(engine, "engine", None)   # CompiledVSMSearch wraps
    if inner is not None:
        free_engine(inner)
    engine.params = None
    cache = getattr(engine, "_canvas_cache", None)
    if cache is not None:
        with engine._canvas_lock:
            cache.clear()
    if getattr(engine, "graphs", None) is not None:
        engine.graphs = DecodeGraphs()
    gc.collect()
    torch.cuda.empty_cache()


def _map(fn, tree):
    """fn over every tensor of a weight tree (dicts, lists, tuples)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A tensor's copy in host memory: pinned where it comes from the
    card, so that the re-upload is one DMA."""
    if not t.is_cuda:
        return t.clone()
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)


def parked_factory(factory: Callable[[], object]):
    """Wrap an engine factory so phase swaps re-upload weights from a
    host-RAM copy instead of re-running the factory's checkpoint read.

    First call: runs `factory()` and copies the engine's param tree to
    host memory (pinned). Later calls: upload the parked copy onto the
    engine's device and wait for it, so that the caller's swap timer
    counts the upload. The engine OBJECT persists; only `params` is
    re-created, matching free_engine's contract. The weights' storage is
    part of every decode graph's key, and the engine gets an empty
    DecodeGraphs with its new weights, so no graph captured on the old
    storage replays."""
    state: Dict = {}

    def wrapped():
        if "engine" not in state:
            eng = factory()
            inner = getattr(eng, "engine", eng)   # CompiledVSMSearch wraps
            state["engine"], state["inner"] = eng, inner
            state["host"] = _map(_to_host, inner.params)
            return eng
        inner = state["inner"]
        params = _map(lambda t: t.to(inner.device, non_blocking=True),
                      state["host"])
        if inner.device.type == "cuda":
            torch.cuda.synchronize(inner.device)
        inner.graphs = DecodeGraphs()
        inner.params = params
        return state["engine"]

    return wrapped


def _chunks(seq, n):
    for a in range(0, len(seq), n):
        yield seq[a:a + n]


def eval_model_phased(benchmark_folder: str,
                      vqa_factory: Callable[[], object],
                      vsm_factory: Callable[[], object],
                      output_path: Optional[str] = None,
                      minimum_size_scale: float = 4.0,
                      minimum_size: int = 224,
                      batch: int = 4,
                      free_form_max_new_tokens: int = 200,
                      max_search_steps: Optional[int] = None,
                      search_kwargs: Optional[Dict] = None,
                      force_missing: Optional[Callable[[Dict],
                                                       List[str]]] = None,
                      coresident: bool = False,
                      log=print):
    """Run the full V*Bench SEAL loop phase-swapped on one device.

    force_missing: optional sample -> object-name list override applied
    AFTER the (still fully executed and timed) free-form phase — the
    throughput benchmark uses it because random weights never emit the
    trigger sentence; real checkpoints leave it None.

    coresident: build BOTH engines up front and skip every swap (on the
    80 GB card the bf16 pair fits). The phases still run batched in the
    same order; only the frees/reloads disappear, so swap_total_s is 0
    and amortized == steady.

    Returns (results, per_type_acc, timings) where timings carries the
    measured per-phase wall clock, the swap costs, and the derived
    images/sec (amortized over this dataset and steady-state excluding
    swaps)."""
    from ..data.preprocess import expand2square
    from ..search.batched import run_grouped_searches

    samples = iter_benchmark(benchmark_folder)
    n = len(samples)
    if n == 0:
        raise FileNotFoundError(f"no samples under {benchmark_folder}")

    # Images are decoded per phase chunk, never held for the whole run:
    # at real V*Bench scale (~191 2K images) eagerly holding every
    # decoded RGB plus its expand2square copy costs multiple GB of host
    # RAM for no benefit — each phase touches a bounded window. The
    # serial loop decodes once per image too; host JPEG decode is noise
    # next to the 7B phases.
    from PIL import Image

    def _open(i):
        return Image.open(samples[i]["path"]).convert("RGB")

    def _dims(i):
        with Image.open(samples[i]["path"]) as im:   # header only
            return im.width, im.height

    timings: Dict[str, float] = {}

    # ---- phase 1: free-form trigger (VQA resident) ---------------------
    t0 = time.perf_counter()
    vqa = vqa_factory()
    timings["load_vqa_s"] = time.perf_counter() - t0
    vsm = None
    if coresident:
        t0 = time.perf_counter()
        vsm = vsm_factory()
        timings["load_vsm_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    predictions: List[str] = []
    if hasattr(vqa, "free_form_many"):
        for idx_chunk in _chunks(list(range(n)), batch):
            predictions.extend(vqa.free_form_many(
                [expand2square(_open(i))[0] for i in idx_chunk],
                [samples[i]["question"] for i in idx_chunk],
                max_new_tokens=free_form_max_new_tokens))
    else:
        predictions = [vqa.free_form(expand2square(_open(i))[0],
                                     samples[i]["question"],
                                     max_new_tokens=(
                                         free_form_max_new_tokens))
                       for i in range(n)]
    timings["phase1_s"] = time.perf_counter() - t0
    missing = [parse_missing_objects(p) for p in predictions]
    if force_missing is not None:
        missing = [force_missing(s) for s in samples]

    # ---- swap 1: VQA out, VSM in (skipped when co-resident) ------------
    if not coresident:
        t0 = time.perf_counter()
        free_engine(vqa)
        vqa = None
        timings["free_vqa_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        vsm = vsm_factory()
        timings["load_vsm_s"] = time.perf_counter() - t0
    else:
        timings["free_vqa_s"] = 0.0

    # ---- phase 2: all searches (VSM resident) --------------------------
    t0 = time.perf_counter()
    tasks = []
    owners = []          # task index -> sample index
    # ONE memoized loader per sample, all sharing a one-slot decode
    # cache: every engine path then sees the SAME decoded object for a
    # sample's consecutive tasks (the serial and lockstep searches call
    # the loader once per TASK, and only the compiled dispatch checks
    # loader identity, so without memoization the id()-keyed canvas
    # cache would never hit for multi-object samples). The
    # one-slot cache keeps host RAM bounded at 191-image scale: a
    # sample's decode dies when the next sample's loader fires, never
    # accumulating in the task closures.
    _slot: Dict = {}

    def _sample_loader(i):
        def load():
            if _slot.get("i") != i:
                _slot["i"], _slot["im"] = i, _open(i)
            return _slot["im"]
        return load

    for i in range(n):
        if not missing[i]:
            continue
        w, h = _dims(i)
        smallest = smallest_size(w, h, minimum_size_scale, minimum_size)
        loader = _sample_loader(i)
        for name in missing[i]:
            tasks.append({"image": loader, "name": name,
                          "smallest": smallest})
            owners.append(i)
    search_results: List[List[Dict]] = [[] for _ in range(n)]
    if tasks:
        outs = run_grouped_searches(vsm, tasks,
                                    max_steps=max_search_steps,
                                    **(search_kwargs or {}))
        per_sample_outs: Dict[int, list] = defaultdict(list)
        per_sample_names: Dict[int, list] = defaultdict(list)
        for t, o, i in zip(tasks, outs, owners):
            per_sample_outs[i].append(o)
            per_sample_names[i].append(t["name"])
        for i in per_sample_outs:
            search_results[i] = collect_search_results(
                per_sample_names[i], per_sample_outs[i])
    _slot.clear()      # drop the last sample's decode with its phase
    timings["phase2_s"] = time.perf_counter() - t0
    timings["n_searches"] = len(tasks)

    # ---- swap 2: VSM out, VQA back (skipped when co-resident) -----------
    if not coresident:
        t0 = time.perf_counter()
        free_engine(vsm)
        vsm = None
        timings["free_vsm_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        vqa = vqa_factory()
        timings["reload_vqa_s"] = time.perf_counter() - t0
    else:
        timings["free_vsm_s"] = timings["reload_vqa_s"] = 0.0

    # ---- phase 3: focus re-ask / option scoring (VQA resident) ---------
    t0 = time.perf_counter()

    def _row(i):
        if missing[i]:
            return focus_inputs(vqa, _open(i), samples[i]["question"],
                                search_results[i])
        return (expand2square(_open(i))[0], samples[i]["question"],
                None, None, None)

    chosen: List[int] = []
    if hasattr(vqa, "multiple_choice_many"):
        for idx_chunk in _chunks(list(range(n)), batch):
            rows = [_row(i) for i in idx_chunk]
            chosen.extend(vqa.multiple_choice_many(
                [r[0] for r in rows],
                [r[1] for r in rows],
                [samples[i]["options"] for i in idx_chunk],
                [r[2] for r in rows],
                [r[3] for r in rows],
                [r[4] for r in rows]))
    else:
        for i in range(n):
            r = _row(i)
            chosen.append(vqa.multiple_choice(r[0], r[1],
                                              samples[i]["options"], r[2],
                                              images_long=r[3],
                                              objects_long=r[4]))
    timings["phase3_s"] = time.perf_counter() - t0
    free_engine(vqa)
    vqa = None
    if coresident:
        free_engine(vsm)
        vsm = None

    # ---- assemble --------------------------------------------------------
    results: Dict[str, list] = {t: [] for t in TEST_TYPES}
    per_type = defaultdict(list)
    for i, s in enumerate(samples):
        rec = seal_record(s["question"], s["options"], predictions[i],
                          missing[i], search_results[i], chosen[i])
        rec["image"] = s["file"]
        results[s["test_type"]].append(rec)
        per_type[s["test_type"]].append(rec["correct"])

    compute = (timings["phase1_s"] + timings["phase2_s"]
               + timings["phase3_s"])
    # co-resident: load_vsm_s is part of the up-front build, not a swap
    swaps = (timings["free_vqa_s"] + timings["free_vsm_s"]
             + timings["reload_vqa_s"]
             + (0.0 if coresident else timings["load_vsm_s"]))
    timings["images_per_s_steady"] = n / compute
    timings["images_per_s_amortized"] = n / (compute + swaps)
    timings["swap_total_s"] = swaps
    timings["n_images"] = n
    if log:
        for t in TEST_TYPES:
            if per_type[t]:
                log(f"{t} {np.mean(per_type[t]):.4f}")
        accs = [c for t in TEST_TYPES for c in per_type[t]]
        log(f"overall {np.mean(accs):.4f}")
        log(f"phased: {n} images; phases "
            f"{timings['phase1_s']:.2f}/{timings['phase2_s']:.2f}/"
            f"{timings['phase3_s']:.2f} s ({timings['n_searches']} "
            f"searches); swaps {swaps:.2f} s; "
            f"{timings['images_per_s_steady']:.3f} images/s steady, "
            f"{timings['images_per_s_amortized']:.3f} amortized")
    if output_path:
        with open(output_path, "w") as f:
            json.dump(results, f, indent=4)
    return results, {t: list(v) for t, v in per_type.items()}, timings
