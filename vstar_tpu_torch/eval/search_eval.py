"""Standalone visual-search evaluation (partial port of
vstar_tpu/eval/search_eval.py, the reference's `visual_search.py main`,
visual_search.py:520-564): top-1 localization accuracy (IoU > 0.5) and
the average successful path length over V*Bench annotations, with the
optional visualization; with image_batch > 1 and a BatchedVSMEngine the
searches run in lockstep device waves, and on a compiled engine
(search/compiled.CompiledVSMSearch, `--compiled`) as whole searches on
the device. `main` loads the VSM from an HF checkpoint directory
(eval/vstar_bench.load_vsm_engine); --mesh shards the VSM over the
torchrun ranks, every rank runs the same searches and rank 0 writes the
outputs.
"""

from __future__ import annotations

import argparse
import functools
import json
import os

import numpy as np
from PIL import Image

from ..core.mesh import is_main_process
from ..search.batched import run_grouped_searches
from ..search.policy import iou_xywh
from .seal import smallest_size


def _open_rgb(path: str):
    return Image.open(path).convert("RGB")


def _collect_tasks(benchmark_folder: str, minimum_size_scale: float,
                   minimum_size: int, visualization: bool,
                   output_path: str):
    """One search task per (image, target object); images open lazily at
    dispatch, so the benchmark's pixels are never resident at once."""
    tasks = []
    for test_type in ["direct_attributes", "relative_position"]:
        folder = os.path.join(benchmark_folder, test_type)
        image_files = [f for f in sorted(os.listdir(folder))
                       if ".json" not in f]
        for image_file in image_files:
            image_path = os.path.join(folder, image_file)
            with open(image_path.rsplit(".", 1)[0] + ".json") as f:
                ann = json.load(f)
            with Image.open(image_path) as im:      # header only
                width, height = im.size
            smallest = smallest_size(width, height, minimum_size_scale,
                                     minimum_size)
            for i, (gt_bbox, name) in enumerate(zip(ann["bbox"],
                                                    ann["target_object"])):
                vis_path = None
                if visualization:
                    vis_path = os.path.join(
                        output_path, test_type,
                        f"{image_file.rsplit('.', 1)[0]}_{i}")
                tasks.append({"image": functools.partial(_open_rgb,
                                                         image_path),
                              "name": name, "gt_bbox": gt_bbox,
                              "smallest": smallest, "vis_path": vis_path})
    return tasks


def evaluate_search(vsm_engine, benchmark_folder: str,
                    minimum_size_scale: float = 4.0,
                    minimum_size: int = 224,
                    confidence_high: float = 0.5,
                    confidence_low: float = 0.3,
                    target_cue_threshold: float = 6.0,
                    target_cue_threshold_decay: float = 0.7,
                    target_cue_threshold_minimum: float = 3.0,
                    visualization: bool = False, output_path: str = "",
                    image_batch: int = 1):
    """Returns (top-1 accuracy, average successful path length).
    image_batch > 1 runs that many searches at a time in lockstep device
    waves on a BatchedVSMEngine (run_batched_searches); the per-task
    policy and results are the serial search's."""
    policy_kw = dict(
        confidence_high=confidence_high, confidence_low=confidence_low,
        target_cue_threshold=target_cue_threshold,
        target_cue_threshold_decay=target_cue_threshold_decay,
        target_cue_threshold_minimum=target_cue_threshold_minimum)
    tasks = _collect_tasks(benchmark_folder, minimum_size_scale,
                           minimum_size, visualization, output_path)
    outs = run_grouped_searches(vsm_engine, tasks, image_batch=image_batch,
                                visualize=visualization, **policy_kw)
    acc_list = []
    path_lengths = []
    for t, (final_step, plen, ok, _) in zip(tasks, outs):
        if ok:
            sb = np.asarray(final_step.detection_result, np.float64).copy()
            sb[0] += final_step.bbox[0]
            sb[1] += final_step.bbox[1]
            acc_list.append(1.0 if iou_xywh(sb, t["gt_bbox"]) > 0.5
                            else 0.0)
            path_lengths.append(plen)
        else:
            acc_list.append(0.0)
            path_lengths.append(0)
    ok_lengths = [n for n, a in zip(path_lengths, acc_list) if a]
    avg_len = float(np.mean(ok_lengths)) if ok_lengths else 0.0
    top1 = float(np.mean(acc_list)) if acc_list else 0.0
    if is_main_process():
        print("Avg search path length:", avg_len)
        print("Top 1 Acc:", top1)
    return top1, avg_len


def build_parser() -> argparse.ArgumentParser:
    """vstar_tpu search_eval's flags."""
    p = argparse.ArgumentParser(description="Visual Search Evaluation")
    p.add_argument("--version", default="craigwu/seal_vsm_7b")
    p.add_argument("--benchmark-folder", default="vstar_bench", type=str)
    p.add_argument("--confidence_low", default=0.3, type=float)
    p.add_argument("--confidence_high", default=0.5, type=float)
    p.add_argument("--target_cue_threshold", default=6.0, type=float)
    p.add_argument("--target_cue_threshold_decay", default=0.7, type=float)
    p.add_argument("--target_cue_threshold_minimum", default=3.0, type=float)
    p.add_argument("--minimum_size_scale", default=4.0, type=float)
    p.add_argument("--minimum_size", default=224, type=int)
    p.add_argument("--visualization", action="store_true", default=False)
    p.add_argument("--output_path", default="", type=str)
    p.add_argument("--image-batch", default=1, type=int,
                   help=">1: this many searches at a time as lockstep "
                        "device batches (the same results)")
    p.add_argument("--device-preprocess", action="store_true",
                   default=False,
                   help="cut search patches out of a device canvas of the "
                        "image (one upload per image)")
    p.add_argument("--compiled", action="store_true", default=False,
                   help="whole searches as device steps (search/compiled.py;"
                        " implies --device-preprocess, no --visualization)")
    p.add_argument("--kv-int8", dest="kv_int8", action="store_true",
                   default=False,
                   help="int8 KV caches with per-(token, head) scales")
    p.add_argument("--int4", dest="int4", action="store_true",
                   default=False, help="group-128 int4 decoder weights")
    p.add_argument("--mesh", default=None,
                   help="DxFxM device mesh over the torchrun ranks to shard"
                        " the VSM over, e.g. 1x4x1")
    p.add_argument("--int8", dest="int8", action="store_true",
                   default=None, help="weight-only int8 decoder")
    p.add_argument("--no-int8", dest="int8", action="store_false",
                   default=None, help="keep bf16 decoder weights")
    return p


def main(argv=None, device="cuda", tokenizer=None):
    """The command line: the VSM from --version (eval/vstar_bench.
    load_vsm_engine, on the card unless `device` says otherwise), then
    evaluate_search. Returns (top-1 accuracy, average path length)."""
    args = build_parser().parse_args(argv)
    from .vstar_bench import load_vsm_engine
    vsm = load_vsm_engine(
        args.version,
        device_preprocess=args.device_preprocess or args.compiled,
        mesh=args.mesh, int8=args.int8, device=device,
        kv_int8=args.kv_int8, int4=args.int4, tokenizer=tokenizer)
    if args.compiled:
        from ..search.compiled import CompiledVSMSearch
        vsm = CompiledVSMSearch(vsm)
    return evaluate_search(
        vsm, args.benchmark_folder,
        minimum_size_scale=args.minimum_size_scale,
        minimum_size=args.minimum_size,
        confidence_high=args.confidence_high,
        confidence_low=args.confidence_low,
        target_cue_threshold=args.target_cue_threshold,
        target_cue_threshold_decay=args.target_cue_threshold_decay,
        target_cue_threshold_minimum=args.target_cue_threshold_minimum,
        # under a mesh every rank searches alike; rank 0 draws the paths
        visualization=args.visualization and is_main_process(),
        output_path=args.output_path,
        image_batch=args.image_batch)


if __name__ == "__main__":
    main()
