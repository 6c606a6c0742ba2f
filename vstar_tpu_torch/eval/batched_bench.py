"""The search phase and the focused re-ask inputs of the batched V*Bench
evaluation (partial port of vstar_tpu/eval/batched_bench.py): what the
free-form serving flow needs. `eval_batch` and `eval_model_batched` wait
for the lockstep search engine (ROADMAP Queue 1 item 6)."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..search.batched import run_grouped_searches
from .seal import focus_inputs, smallest_size


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
