"""Batched V*Bench evaluation (port of vstar_tpu/eval/batched_bench.py):
the SEAL loop of eval/seal.py over a group of images, with each phase
batched. The free-form answers run as one `free_form_many`, every search
of the group advances in lockstep waves (`run_grouped_searches` on a
BatchedVSMEngine, so the searches share each read of the 7B weights),
and the focused option scoring runs as one `multiple_choice_many`."""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence

import numpy as np
from PIL import Image

from ..data.preprocess import expand2square
from ..search.batched import run_grouped_searches
from .seal import (focus_inputs, parse_missing_objects, seal_record,
                   smallest_size)


def run_search_phase(vsm_engine, images: Sequence,
                     missing: Sequence[List[str]], minimum_size_scale=4.0,
                     minimum_size=224, max_search_steps=None, **policy_kw):
    """Every (image, missing object) search of a batch. Returns
    (search_results, failed) per image: `search_results[i]` is the
    seal_answer box list (weak fallback boxes included, as
    visual_search.py:498-511 and app.py:165-179 keep them) and
    `failed[i]` the names whose search was unsuccessful (app.py:166)."""
    tasks = [(i, name) for i, objs in enumerate(missing) for name in objs]
    search_results: List[List[Dict]] = [[] for _ in images]
    failed: List[List[str]] = [[] for _ in images]
    if not tasks:
        return search_results, failed
    search_tasks = [
        {"image": images[i], "name": name,
         "smallest": smallest_size(images[i].width, images[i].height,
                                   minimum_size_scale, minimum_size)}
        for i, name in tasks]
    outs = run_grouped_searches(vsm_engine, search_tasks,
                                max_steps=max_search_steps, **policy_kw)
    for (i, name), (final_step, _, ok, all_boxes) in zip(tasks, outs):
        if not ok:
            failed[i].append(name)
        if final_step is None or final_step.detection_result is None:
            continue  # the reference would crash here (VSM never stashed)
        boxes = all_boxes if all_boxes is not None \
            else [final_step.detection_result]
        for sb in boxes:
            sb = np.asarray(sb, np.float64).copy()
            sb[0] += final_step.bbox[0]
            sb[1] += final_step.bbox[1]
            search_results[i].append({"bbox": sb.tolist(), "name": name})
    return search_results, failed


def build_focus_inputs(vqa_engine, image, question: str,
                       search_result: Sequence[Dict],
                       failed: Sequence[str] = (),
                       include_failed: bool = False):
    """Focused re-ask inputs for one sample: (squared image, question,
    crops, images_long, objects_long), as seal_answer's tail and
    app.py:183-226 build them; `include_failed` adds app.py's
    failed-objects clause (the free-form serving flow only; the
    benchmark's option prompt never has it)."""
    return focus_inputs(vqa_engine, image, question, search_result,
                        failed if include_failed else ())


def _finish_sample(vqa_engine, image, question, options, missing_objects,
                   search_result, prediction) -> Dict:
    """One sample's focused option scoring (seal_answer's tail) and its
    record, for an engine without multiple_choice_many."""
    if missing_objects:
        squared, q, crops, il, ol = build_focus_inputs(
            vqa_engine, image, question, search_result)
        chosen = vqa_engine.multiple_choice(squared, q, options, crops,
                                            images_long=il, objects_long=ol)
    else:
        chosen = vqa_engine.multiple_choice(expand2square(image)[0],
                                            question, options)
    return seal_record(question, options, prediction, missing_objects,
                       search_result, chosen)


def eval_batch(vqa_engine, vsm_batched, samples: Sequence[Dict],
               minimum_size_scale=4.0, minimum_size=224,
               max_search_steps=None) -> List[Dict]:
    """The SEAL records of samples [{'image': PIL, 'question': str,
    'options': [...]}], each phase batched where the engine can."""
    squared_imgs = [expand2square(s["image"])[0] for s in samples]
    if hasattr(vqa_engine, "free_form_many"):
        predictions = vqa_engine.free_form_many(
            squared_imgs, [s["question"] for s in samples])
    else:
        predictions = [vqa_engine.free_form(img, s["question"])
                       for img, s in zip(squared_imgs, samples)]
    missing = [parse_missing_objects(p) for p in predictions]

    search_results, _ = run_search_phase(
        vsm_batched, [s["image"] for s in samples], missing,
        minimum_size_scale, minimum_size, max_search_steps)

    if not hasattr(vqa_engine, "multiple_choice_many"):
        return [_finish_sample(vqa_engine, s["image"], s["question"],
                               s["options"], missing[i], search_results[i],
                               predictions[i])
                for i, s in enumerate(samples)]
    rows = []
    for i, s in enumerate(samples):
        if missing[i]:
            rows.append(build_focus_inputs(vqa_engine, s["image"],
                                           s["question"], search_results[i]))
        else:
            rows.append((squared_imgs[i], s["question"], None, None, None))
    squared, qs, crops, il, ol = (list(col) for col in zip(*rows))
    chosen = vqa_engine.multiple_choice_many(
        squared, qs, [list(s["options"]) for s in samples],
        object_crops_list=crops, images_long=il, objects_long=ol)
    return [seal_record(s["question"], s["options"], predictions[i],
                        missing[i], search_results[i], chosen[i])
            for i, s in enumerate(samples)]


def eval_model_batched(args, vqa_engine, vsm_batched, image_batch: int = 4):
    """eval/vstar_bench.eval_model over image groups of image_batch.

    While a group's phases run, a background thread opens the next
    group's images and starts their canvas uploads
    (BatchedVSMEngine.prefetch_canvas, which CompiledVSMSearch delegates
    to its engine), so a device-preprocess engine finds them on the
    card. Prints the per-task and overall accuracy and
    images/s, writes the result JSON and returns the results by task."""

    def load_chunk(folder, chunk):
        samples = []
        for f in chunk:
            path = os.path.join(folder, f)
            with open(path.rsplit(".", 1)[0] + ".json") as fh:
                ann = json.load(fh)
            samples.append({"image": Image.open(path).convert("RGB"),
                            "question": ann["question"],
                            "options": ann["options"], "file": f})
        prefetch = getattr(vsm_batched, "prefetch_canvas", None)
        if prefetch is not None:
            for s in samples:
                prefetch(s["image"])
        return samples

    results = {}
    per_type = defaultdict(list)
    all_acc = []
    latencies = []
    with ThreadPoolExecutor(max_workers=1,
                            thread_name_prefix="chunk-loader") as loader:
        for test_type in ["direct_attributes", "relative_position"]:
            results[test_type] = []
            folder = os.path.join(args.benchmark_folder, test_type)
            files = [f for f in sorted(os.listdir(folder))
                     if ".json" not in f]
            chunks = [files[s:s + image_batch]
                      for s in range(0, len(files), image_batch)]
            pending = loader.submit(load_chunk, folder, chunks[0]) \
                if chunks else None
            for ci in range(len(chunks)):
                samples = pending.result()
                pending = loader.submit(load_chunk, folder, chunks[ci + 1]) \
                    if ci + 1 < len(chunks) else None
                t0 = time.perf_counter()
                recs = eval_batch(vqa_engine, vsm_batched, samples,
                                  args.minimum_size_scale, args.minimum_size)
                dt = (time.perf_counter() - t0) / len(samples)
                for s, rec in zip(samples, recs):
                    rec["image"] = s["file"]
                    per_type[test_type].append(rec["correct"])
                    all_acc.append(rec["correct"])
                    latencies.append(dt)
                    results[test_type].append(rec)
            if per_type[test_type]:
                print(test_type, np.mean(per_type[test_type]))
    if all_acc:
        print(np.mean(all_acc))
        print(f"throughput: {1.0 / np.mean(latencies):.3f} images/s")
    with open(args.output_path, "w") as f:
        json.dump(results, f, indent=4)
    return results
