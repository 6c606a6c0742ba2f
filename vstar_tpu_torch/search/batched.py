"""Grouped visual-search dispatch (partial port of
vstar_tpu/search/batched.py).

Only `run_grouped_searches`' path for an engine without `detect_many` is
ported: one serial `visual_search` per task, results in task order. The
lockstep waves (`BatchedVSMEngine`, `detect_many`, `run_batched_searches`)
and the compiled whole-search engine (`search`) wait for ROADMAP Queue 1
item 6; an engine that has either is refused rather than run serially.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from .policy import visual_search

BATCHED_NOT_PORTED = (
    "batched and compiled search engines (detect_many / search) are not "
    "ported yet (ROADMAP Queue 1 item 6)")


def run_grouped_searches(engine, tasks: Sequence[Dict], image_batch=None,
                         max_steps=None, visualize: bool = False,
                         **policy_kw) -> List[Tuple]:
    """One `visual_search` per task, in task order.

    tasks: dicts with 'image' (a PIL image, or a zero-argument callable
    that opens it), 'name', 'smallest', optional 'gt_bbox', 'vis_path'
    and (the port's addition) 'path_out', a list that receives the
    visited steps. Each result is visual_search's return tuple. image_batch
    sizes the lockstep waves of a batched engine, which the port does not
    have yet; with the serial engine it changes nothing."""
    if hasattr(engine, "detect_many") or hasattr(engine, "search"):
        raise NotImplementedError(BATCHED_NOT_PORTED)
    outs = []
    for t in tasks:
        image = t["image"]() if callable(t["image"]) else t["image"]
        outs.append(visual_search(
            engine, image, t["name"], smallest_size=t["smallest"],
            target_bbox=t.get("gt_bbox"), max_steps=max_steps,
            visualize=visualize, save_path=t.get("vis_path"),
            path_out=t.get("path_out"), **policy_kw))
    return outs
