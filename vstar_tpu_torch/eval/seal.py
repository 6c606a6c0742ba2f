"""SEAL orchestration on the port's engines: answer -> missing objects ->
guided visual search -> focused re-answer (port of vstar_tpu/eval/seal.py,
which mirrors eval_model's inner loop, vstar_bench_eval.py:168-273).

The host helpers are copies of the JAX package's. Searches go through
search/batched.run_grouped_searches: lockstep waves on a
BatchedVSMEngine, one serial visual_search per object otherwise.
"""

from __future__ import annotations

from copy import deepcopy
from typing import Dict, List, Optional, Sequence

import numpy as np
from PIL import Image

from ..data.preprocess import expand2square
from ..search.batched import run_grouped_searches

MISSING_OBJECTS_MSG = ("Sorry, I can not answer the question. Some visual "
                       "information about the following objects is missing "
                       "or unclear:")
FOCUS_MSG = "Additional visual information to focus on: "


def normalize_bbox(bbox, image_width, image_height):
    out = [bbox[0] / image_width, bbox[1] / image_height,
           (bbox[0] + bbox[2]) / image_width,
           (bbox[1] + bbox[3]) / image_height]
    return [float(np.clip(v, 0, 1)) for v in out]


def parse_missing_objects(prediction: str) -> List[str]:
    if MISSING_OBJECTS_MSG not in prediction:
        return []
    tail = prediction.split(MISSING_OBJECTS_MSG)[-1]
    if tail.endswith("."):
        tail = tail[:-1]
    return [o.strip() for o in tail.split(",")]


def focus_prompt(question: str, object_names: Sequence[str],
                 bbox_list: Sequence[Sequence[float]],
                 failed_names: Sequence[str] = ()) -> str:
    """'name <object> at location [x1,y1,x2,y2]; ...' + question
    (vstar_bench_eval.py:249-256).

    failed_names: the serving path's '{name} not existent in the image'
    clause (app.py:215-223; the reference formats the stale loop variable
    `object_name` into every clause — the intended failed name is used
    here)."""
    msg = FOCUS_MSG
    for i, (name, bbox) in enumerate(zip(object_names, bbox_list)):
        msg += "{} <object> at location [{:.3f},{:.3f},{:.3f},{:.3f}]".format(
            name, bbox[0], bbox[1], bbox[2], bbox[3])
        msg += "; " if i != len(bbox_list) - 1 else "."
    if failed_names:
        if object_names:
            msg = msg[:-1] + "; "
        for i, name in enumerate(failed_names):
            msg += "{} not existent in the image".format(name)
            msg += "; " if i != len(failed_names) - 1 else "."
    return msg + "\n" + question


def smallest_size(width: int, height: int,
                  minimum_size_scale: float = 4.0,
                  minimum_size: int = 224) -> int:
    """Search-termination patch size (vstar_bench_eval.py:207-210)."""
    return max(int(np.ceil(min(width, height) / minimum_size_scale)),
               minimum_size)


def search_tasks(image: Image.Image, missing_objects: Sequence[str],
                 minimum_size_scale: float = 4.0,
                 minimum_size: int = 224) -> List[Dict]:
    """Phase-2 task list for run_grouped_searches (one per missing
    object; smallest-size rule of vstar_bench_eval.py:207-210)."""
    smallest = smallest_size(image.width, image.height,
                             minimum_size_scale, minimum_size)
    return [{"image": image, "name": name, "smallest": smallest}
            for name in missing_objects]


def collect_search_results(missing_objects: Sequence[str],
                           outs: Sequence) -> List[Dict]:
    """Search outputs -> search_result records in original-image
    coordinates (vstar_bench_eval.py:214-231: root multi-instance boxes,
    else the final step's detection offset by its patch origin)."""
    search_result: List[Dict] = []
    for object_name, (final_step, _, _, all_valid_boxes) in zip(
            missing_objects, outs):
        if all_valid_boxes is not None:
            for sb in all_valid_boxes:
                sb = np.asarray(sb, np.float64).copy()
                sb[0] += final_step.bbox[0]
                sb[1] += final_step.bbox[1]
                search_result.append({"bbox": sb.tolist(),
                                      "name": object_name})
        elif final_step is not None \
                and final_step.detection_result is not None:
            sb = np.asarray(final_step.detection_result,
                            np.float64).copy()
            sb[0] += final_step.bbox[0]
            sb[1] += final_step.bbox[1]
            search_result.append({"bbox": sb.tolist(),
                                  "name": object_name})
    return search_result


def focus_inputs(vqa_engine, image: Image.Image, question: str,
                 search_result: Sequence[Dict],
                 failed_names: Sequence[str] = ()):
    """Phase-3 inputs after a search: (squared image, focus question,
    object crops, images_long, objects_long) — the ≤2-object long/short
    heuristic, 1.2-scale crops and expand2square bbox shift of
    vstar_bench_eval.py:233-256; failed_names as focus_prompt's."""
    object_names = [r["name"] for r in search_result]
    bboxes = deepcopy([r["bbox"] for r in search_result])
    if len(object_names) <= 2:
        images_long, objects_long = [False], [True] * len(object_names)
    else:
        images_long, objects_long = [False], [False] * len(object_names)
    object_crops = [vqa_engine.get_object_crop(image, bbox,
                                               patch_scale=1.2)
                    for bbox in bboxes]
    squared, left, top = expand2square(image)
    bbox_list = []
    for bbox in bboxes:
        bbox[0] += left
        bbox[1] += top
        bbox_list.append(normalize_bbox(bbox, squared.width,
                                        squared.height))
    question_with_focus = focus_prompt(question, object_names, bbox_list,
                                       failed_names)
    return squared, question_with_focus, object_crops, images_long, \
        objects_long


def seal_record(question: str, options: Sequence[str], prediction: str,
                missing_objects: Sequence[str],
                search_result: Sequence[Dict],
                option_chosen: int) -> Dict:
    """The per-sample eval_result.json record (reference schema)."""
    return {
        "question": question,
        "options": list(options),
        "prediction_freeform": prediction,
        "missing_objects": list(missing_objects),
        "search_result": list(search_result),
        "option_chosen": int(option_chosen),
        "correct": int(option_chosen == 0),
    }


def seal_answer(vqa_engine, vsm_engine, image: Image.Image, question: str,
                options: Sequence[str], minimum_size_scale: float = 4.0,
                minimum_size: int = 224,
                max_search_steps: Optional[int] = None) -> Dict:
    """Full SEAL loop for one sample -> the reference's eval_result.json
    record."""
    squared, _, _ = expand2square(image)
    prediction = vqa_engine.free_form(squared, question)
    missing_objects = parse_missing_objects(prediction)
    if not missing_objects:
        option_chosen = vqa_engine.multiple_choice(squared, question,
                                                   options)
        return seal_record(question, options, prediction, [], [],
                           option_chosen)
    outs = run_grouped_searches(
        vsm_engine, search_tasks(image, missing_objects, minimum_size_scale,
                                 minimum_size),
        max_steps=max_search_steps)
    search_result = collect_search_results(missing_objects, outs)
    squared, question_with_focus, object_crops, images_long, objects_long = \
        focus_inputs(vqa_engine, image, question, search_result)
    option_chosen = vqa_engine.multiple_choice(
        squared, question_with_focus, options, object_crops,
        images_long=images_long, objects_long=objects_long)
    return seal_record(question, options, prediction, missing_objects,
                       search_result, option_chosen)
