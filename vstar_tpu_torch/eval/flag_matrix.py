"""Accuracy/latency matrix over the opt-in performance flags (port of
vstar_tpu/eval/flag_matrix.py).

Every throughput lever beyond the reference (int8 KV cache, W8A8
activations, prompt-lookup drafts, int4 weights, the compiled search) is
opt-in pending accuracy validation on the real seal checkpoints. This
module sweeps the whole matrix in one call, so that checkpoint day is one
command producing every gate decision; `run_runner_matrix` sweeps the
residency modes of eval/phased.py the same way.

The gates are the reference's own metrics (vstar_bench_eval.py:275-280,
V*Bench accuracy) against the base cell.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

# (cell name, engine flags). w8a8 is the global act-int8 switch
# (nn/quant.set_act_int8), on for the whole cell and restored after it;
# the rest are engine constructor options.
CELLS = (
    ("base", dict()),
    ("kv-int8", dict(kv_int8=True)),
    ("prompt-lookup", dict(prompt_lookup=True)),
    ("w8a8", dict(w8a8=True)),
    ("int4", dict(int4=True)),
    ("compiled-search", dict(compiled=True)),
    ("all-opt-ins", dict(kv_int8=True, prompt_lookup=True, w8a8=True,
                         compiled=True)),
    ("int4-all-opt-ins", dict(int4=True, kv_int8=True, prompt_lookup=True,
                              compiled=True)),
)


def _run_search(vsm, image, name: str):
    if hasattr(vsm, "search") and not hasattr(vsm, "detect_many"):
        return vsm.search(image, name)
    from ..search.policy import visual_search
    return visual_search(vsm, image, name)


def _iou(a, b) -> float:
    ax1, ay1, ax2, ay2 = a[0], a[1], a[0] + a[2], a[1] + a[3]
    bx1, by1, bx2, by2 = b[0], b[1], b[0] + b[2], b[1] + b[3]
    iw = max(0.0, min(ax2, bx2) - max(ax1, bx1))
    ih = max(0.0, min(ay2, by2) - max(ay1, by1))
    inter = iw * ih
    union = a[2] * a[3] + b[2] * b[3] - inter
    return float(inter / union) if union > 0 else 0.0


def run_flag_matrix(make_engines: Callable, image,
                    question: str = "What is in this image?",
                    options: Sequence[str] = ("(A) red", "(B) blue",
                                              "(C) green", "(D) yellow"),
                    search_name: str = "red rectangle",
                    benchmark_folder: Optional[str] = None,
                    repeats: int = 1, log=print) -> List[Dict]:
    """Sweep CELLS and return one row per cell.

    make_engines(kv_int8=..., prompt_lookup=..., compiled=..., int4=...)
    -> (vqa_engine_or_None, vsm_engine_or_None); fresh engines per cell so
    that each keeps its own captured decode graphs and caches (the
    act-int8 switch is part of every graph's key). Engines may share
    params: the sweep never mutates them.

    Per cell: free-form answer + latency (+ tokens/forward from the
    engine's decode stats), option chosen, one guided search (found,
    path length, IoU of the found bbox vs the base cell), and — when
    benchmark_folder is given — the full V*Bench accuracy via
    eval_model. 'matches_base' columns make the accuracy gate a glance:
    prompt-lookup MUST match (greedy-equivalent by construction);
    kv-int8/w8a8 drift is the measurement being made."""
    from ..nn import quant

    act_int8 = quant._ACT_INT8
    rows: List[Dict] = []
    base: Dict = {}
    for name, cell in CELLS:
        quant.set_act_int8(bool(cell.get("w8a8", False)))
        row = {"cell": name}
        try:
            vqa, vsm = make_engines(
                kv_int8=bool(cell.get("kv_int8", False)),
                prompt_lookup=bool(cell.get("prompt_lookup", False)),
                compiled=bool(cell.get("compiled", False)),
                int4=bool(cell.get("int4", False)))
            for k in ("kv_int8", "prompt_lookup", "w8a8", "compiled",
                      "int4"):
                row[k] = bool(cell.get(k, False))

            if vqa is not None:
                ts = []
                for _ in range(max(repeats, 1)):
                    t0 = time.perf_counter()
                    answer = vqa.free_form(image, question)
                    ts.append(time.perf_counter() - t0)
                row["answer"] = answer
                row["free_form_s"] = round(float(np.min(ts)), 4)
                stats = getattr(vqa, "last_decode_stats", None)
                if stats:
                    row["tok_per_forward"] = round(
                        stats["tokens_per_forward"], 3)
                row["option"] = int(vqa.multiple_choice(
                    image, question, list(options)))
                if "answer" in base:
                    row["answer_matches_base"] = answer == base["answer"]
                    row["option_matches_base"] = \
                        row["option"] == base["option"]

            if vsm is not None:
                ts = []
                for _ in range(max(repeats, 1)):
                    t0 = time.perf_counter()
                    step, plen, found, _ = _run_search(vsm, image,
                                                       search_name)
                    ts.append(time.perf_counter() - t0)
                row["search_s"] = round(float(np.min(ts)), 4)
                row["search_found"] = bool(found)
                row["search_plen"] = int(plen)
                bbox = None
                if step is not None and step.detection_result is not None:
                    local = np.asarray(step.detection_result, np.float64)
                    bbox = [float(local[0] + step.bbox[0]),
                            float(local[1] + step.bbox[1]),
                            float(local[2]), float(local[3])]
                row["search_bbox"] = bbox
                if "search_bbox" in base:
                    if bbox is not None and base["search_bbox"] is not None:
                        row["search_iou_vs_base"] = round(
                            _iou(bbox, base["search_bbox"]), 4)
                    else:
                        row["search_iou_vs_base"] = \
                            None if bbox == base["search_bbox"] else 0.0

            if benchmark_folder and vqa is not None and vsm is not None:
                import types

                from .vstar_bench import eval_model
                ns = types.SimpleNamespace(
                    benchmark_folder=benchmark_folder,
                    output_path=os.path.join(tempfile.gettempdir(),
                                             f"flag_matrix_{name}.json"),
                    minimum_size_scale=4.0, minimum_size=224,
                    conv_type="v1")
                _, per_type, lats = eval_model(ns, vqa, vsm)
                accs = [c for v in per_type.values() for c in v]
                row["vstar_accuracy"] = round(float(np.mean(accs)), 4)
                row["vstar_p50_s"] = round(
                    float(np.percentile(lats, 50)), 3)
                if "vstar_accuracy" in base:
                    row["accuracy_vs_base"] = round(
                        row["vstar_accuracy"] - base["vstar_accuracy"], 4)
        except Exception as e:   # noqa: BLE001 — per-cell isolation
            # One failing cell (importer declines a shape, OOM loading a
            # second engine copy, a flag combination that cannot trace)
            # must not lose the hours of cells already measured: record
            # the error as the row and keep sweeping. The base cell is
            # the exception — without it no *_vs_base gate means anything.
            if name == "base":
                raise
            row["error"] = f"{type(e).__name__}: {e}"
        finally:
            quant.set_act_int8(act_int8)
        if name == "base":
            base = row
        rows.append(row)
        if log:
            log(f"[matrix] {name}: " + "  ".join(
                f"{k}={row[k]}" for k in sorted(row)
                if k not in ("cell", "answer", "search_bbox")))
    return rows


def run_runner_matrix(benchmark_folder: str,
                      vqa_factory: Callable, vsm_factory: Callable,
                      coresident_factories=None, mixed_factories=None,
                      int4mix_factories=None,
                      batch: int = 8, log=print, **phased_kw) -> List[Dict]:
    """Gate over the RESIDENCY modes: the flag matrix covers engine
    opt-ins; this sweeps how the two 7B models share the device:
    phase-swapped (base), parked-swap (host-RAM weight copy), co-resident
    (zero swaps) and mixed-precision co-resident (int8 VQA + int4 VSM),
    through the SAME eval_model_phased loop, so each row carries
    throughput, swap cost, accuracy and a records_match_base bit.

    vqa_factory/vsm_factory: zero-arg engine factories (re-read the
    checkpoint), the phased base cell. coresident_factories /
    mixed_factories: optional (vqa_factory, vsm_factory) pairs for the
    co-resident cells — their engines use different quantization, so
    records_match_base=False there is a finding (the accuracy column is
    the gate), while the parked cell must match bit-for-bit."""
    from .phased import eval_model_phased, parked_factory

    rows: List[Dict] = []
    base: Dict = {}
    base_results = None

    def cell(name, vqa_f, vsm_f, coresident, cell_batch=None):
        nonlocal base_results
        row: Dict = {"cell": name, "coresident": coresident}
        try:
            t0 = time.perf_counter()
            results, per_type, t = eval_model_phased(
                benchmark_folder, vqa_f, vsm_f,
                batch=cell_batch or batch,
                coresident=coresident, log=None, **phased_kw)
            row["total_s"] = round(time.perf_counter() - t0, 3)
            accs = [c for v in per_type.values() for c in v]
            row["images_per_s"] = round(t["images_per_s_steady"], 4)
            row["images_per_s_amortized"] = round(
                t["images_per_s_amortized"], 4)
            row["swap_s"] = round(t["swap_total_s"], 3)
            row["phases_s"] = [round(t["phase1_s"], 3),
                               round(t["phase2_s"], 3),
                               round(t["phase3_s"], 3)]
            row["accuracy"] = (round(float(np.mean(accs)), 4)
                               if accs else None)
            if base_results is None:
                base_results = results
            else:
                row["records_match_base"] = results == base_results
                if row["accuracy"] is not None and \
                        base.get("accuracy") is not None:
                    row["accuracy_vs_base"] = round(
                        row["accuracy"] - base["accuracy"], 4)
        except Exception as e:  # noqa: BLE001 — per-cell isolation
            if name == "phased":
                raise      # no base -> no gate means anything
            row["error"] = f"{type(e).__name__}: {e}"
        rows.append(row)
        if log:
            log(f"[runner] {name}: " + "  ".join(
                f"{k}={row[k]}" for k in sorted(row) if k != "cell"))
        return row

    base = cell("phased", vqa_factory, vsm_factory, False)
    cell("parked", parked_factory(vqa_factory), parked_factory(vsm_factory),
         False)
    if coresident_factories is not None:
        cell("coresident", coresident_factories[0],
             coresident_factories[1], True)
    if mixed_factories is not None:
        cell("mixed-coresident", mixed_factories[0], mixed_factories[1],
             True)
    if int4mix_factories is not None:
        # vstar_tpu's operating point of the mode (its pair overflows a
        # 16 GB chip at B >= 4), kept so that the cells compare
        cell("int4mix-coresident", int4mix_factories[0],
             int4mix_factories[1], True, cell_batch=min(batch, 2))
    return rows


def format_table(rows: List[Dict]) -> str:
    cols = ["cell", "free_form_s", "tok_per_forward", "option",
            "answer_matches_base", "search_s", "search_found",
            "search_plen", "search_iou_vs_base", "vstar_accuracy",
            "vstar_p50_s", "error"]
    cols = [c for c in cols if any(c in r for r in rows)]
    widths = {c: max(len(c), *(len(str(r.get(c, ""))) for r in rows))
              for c in cols}
    out = ["  ".join(c.ljust(widths[c]) for c in cols)]
    for r in rows:
        out.append("  ".join(str(r.get(c, "")).ljust(widths[c])
                             for c in cols))
    return "\n".join(out)
