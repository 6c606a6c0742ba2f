"""Deterministic synthetic V*Bench + pixel-scripted engines (a copy of
vstar_tpu/eval/synthetic.py on the port's SEAL loop, get_patch and search
policy).

Real checkpoints are not in the repository, so a shape-level end-to-end
test cannot catch SEMANTIC regressions (a flipped coordinate still gives
a schema-valid record). This module builds a benchmark of images with one uniquely-colored target
rectangle composited at a known bbox, plus engines whose answers are
computed FROM THE PIXELS THEY ARE HANDED (never from the ground truth):

  * ScriptedColorVSM.detect finds the color patch in the crop it
    receives — a wrong crop/coordinate transform anywhere in the policy
    or SEAL loop yields a wrong box and a failed sample;
  * ScriptedColorVQA.multiple_choice answers correctly ONLY if the focus
    bbox region of the squared image and the object crop both actually
    contain the target color.

So `eval_model` accuracy on this benchmark is a real end-to-end semantic
gate (asserted 1.0 in tests/test_torch_eval.py), and `visual_search`
path lengths over it are a measurable distribution.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
from PIL import Image

from .seal import MISSING_OBJECTS_MSG
from .vqa_engine import get_patch

PALETTE = [
    ("red", (235, 20, 20)),
    ("green", (20, 225, 20)),
    ("blue", (30, 30, 240)),
    ("yellow", (235, 225, 20)),
    ("magenta", (230, 25, 230)),
    ("cyan", (25, 230, 230)),
    ("orange", (245, 150, 10)),
    ("purple", (140, 20, 220)),
]
COLOR_TOL = 24
BG_LOW, BG_HIGH = 30, 70      # noisy background range — collides with
                              # neither the palette nor the CLIP pad color


def _color_mask(arr: np.ndarray, rgb: Tuple[int, int, int]) -> np.ndarray:
    return np.all(np.abs(arr.astype(np.int32)
                         - np.asarray(rgb, np.int32)) <= COLOR_TOL, axis=-1)


def make_synthetic_benchmark(out_dir: str, n_per_task: int = 3,
                             seed: int = 0, image_hw=(1024, 1024),
                             target: Optional[int] = None) -> List[Dict]:
    """Write direct_attributes/ + relative_position/ with one colored
    target per image at a known bbox; the correct option is index 0 (the
    V*Bench convention the evaluator scores against).

    Target sizes cycle [56, 36, 28] (unless fixed via `target`): 56^2
    crosses the 1%-of-patch detectability bar at the 512-quadrant (path
    length 2), the smaller ones only at the 256-window (length 3), so the
    guided search exercises multiple depths."""
    rng = np.random.RandomState(seed)
    H, W = image_hw
    sizes = [56, 36, 28]
    specs = []
    idx = 0
    for task in ("direct_attributes", "relative_position"):
        d = os.path.join(out_dir, task)
        os.makedirs(d, exist_ok=True)
        for i in range(n_per_task):
            name, rgb = PALETTE[idx % len(PALETTE)]
            tsize = target if target is not None else sizes[idx % 3]
            idx += 1
            arr = rng.randint(BG_LOW, BG_HIGH,
                              (H, W, 3)).astype(np.uint8)
            # keep the target inside one 256-aligned window with margin so
            # descent terminates with a clean fully-visible accept
            qx, qy = rng.randint(0, 4), rng.randint(0, 4)
            x = qx * (W // 4) + rng.randint(30, W // 4 - 30 - tsize)
            y = qy * (H // 4) + rng.randint(30, H // 4 - 30 - tsize)
            arr[y:y + tsize, x:x + tsize] = rgb
            img = Image.fromarray(arr)
            stem = f"{task[:3]}_{i}"
            img.save(os.path.join(d, stem + ".png"))
            distract = [n for n, _ in PALETTE if n != name]
            bbox = [int(x), int(y), int(tsize), int(tsize)]
            ann = {
                "question": "What is the color of the small marker?",
                "options": [f"the marker is {name}",
                            f"the marker is {distract[i % 3]}"],
                "target_object": [f"{name} marker"],
                # V*Bench schema: one gt box per target object
                "bbox": [bbox],
            }
            with open(os.path.join(d, stem + ".json"), "w") as f:
                json.dump(ann, f)
            specs.append({"task": task, "image": stem + ".png",
                          "name": f"{name} marker", "rgb": rgb,
                          "bbox": bbox})
    return specs


class ScriptedColorVSM:
    """VSMClient computing detection/heatmap from the pixels it is handed.
    `name` must start with a palette color ('red marker')."""

    def __init__(self):
        self.detect_calls = 0

    def _rgb(self, name: str):
        for cname, rgb in PALETTE:
            if name.startswith(cname):
                return rgb
        raise KeyError(name)

    def detect(self, patch: Image.Image, name: str):
        self.detect_calls += 1
        arr = np.asarray(patch.convert("RGB"))
        mask = _color_mask(arr, self._rgb(name))
        h, w = mask.shape
        boxes = np.zeros((16, 4), np.float32)
        logits = np.full(16, 0.01, np.float32)
        heat = mask.astype(np.float32) * 10.0
        ys, xs = np.nonzero(mask)
        if len(ys):
            x0, x1 = xs.min(), xs.max() + 1
            y0, y1 = ys.min(), ys.max() + 1
            boxes[0] = [(x0 + x1) / 2 / w, (y0 + y1) / 2 / h,
                        (x1 - x0) / w, (y1 - y0) / h]
            # fully visible = the color region doesn't touch the crop
            # border (size-independent)
            full = x0 > 0 and y0 > 0 and x1 < w and y1 < h
            frac = len(ys) / (h * w)
            logits[0] = 0.9 if (full and frac > 0.01) else 0.3
        return boxes, logits, heat

    def vqa(self, patch, question):
        return "The object is most likely to appear on the table."

    def segment(self, patch, phrase):
        return np.zeros((patch.height, patch.width), np.float32)


class ScriptedColorVQA:
    """VQA engine whose correctness depends on receiving the RIGHT pixels:
    triggers the search, then answers option 0 only if the focus bbox
    region and the object crop truly contain the target color."""

    def __init__(self, specs: List[Dict]):
        self._by_name = {s["name"]: s for s in specs}
        self.focus_checks: List[bool] = []

    def free_form(self, image, question, **kw):
        # scripted trigger: always ask for the (single) palette object
        # whose color is named by option 0 of the current sample — the
        # evaluator passes the question only, so stash via options in
        # multiple_choice; the name comes from the benchmark convention
        return (MISSING_OBJECTS_MSG + " " + self._current_name + ".")

    def set_sample(self, name: str):
        self._current_name = name

    def get_object_crop(self, image, bbox, patch_scale: float = 1.2):
        box = get_patch(bbox, image.width, image.height,
                        patch_scale=patch_scale)
        crop = image.crop(tuple(box)).resize((224, 224))
        return np.asarray(crop.convert("RGB"), np.float32)

    def multiple_choice(self, image, question, options, object_crops=None,
                        images_long=None, objects_long=None) -> int:
        spec = self._by_name[self._current_name]
        ok = object_crops is not None and len(object_crops) > 0
        if ok:  # the crop must contain the color
            crop_ok = any(_color_mask(c.astype(np.uint8),
                                      spec["rgb"]).sum() > 20
                          for c in object_crops)
            ok = ok and crop_ok
        if ok:  # the focus bbox must cover the color in the squared image
            m = re.search(r"\[([\d.]+),([\d.]+),([\d.]+),([\d.]+)\]",
                          question)
            ok = m is not None
            if ok:
                x1, y1, x2, y2 = (float(v) for v in m.groups())
                arr = np.asarray(image.convert("RGB"))
                Hs, Ws = arr.shape[:2]
                region = arr[int(y1 * Hs):max(int(y2 * Hs), int(y1 * Hs) + 1),
                             int(x1 * Ws):max(int(x2 * Ws), int(x1 * Ws) + 1)]
                ok = _color_mask(region, spec["rgb"]).sum() > 20
        self.focus_checks.append(bool(ok))
        if not ok:
            return 1  # wrong on purpose: the pipeline fed bad pixels
        # correct option names the color
        cname = spec["name"].split()[0]
        for i, opt in enumerate(options):
            if cname in opt:
                return i
        return 1


def run_synthetic_eval(out_dir: str, n_per_task: int = 3, seed: int = 0,
                       target: Optional[int] = None,
                       collect_path_lengths: bool = True):
    """Build the benchmark, drive the real SEAL loop (seal_answer — the
    orchestration eval_model wraps) per sample with the scripted engines,
    and also measure the guided-search path-length distribution.
    Returns (accuracy, per_task_acc, path_lengths, results)."""
    from ..search.policy import visual_search
    from . import seal as seal_mod

    specs = make_synthetic_benchmark(out_dir, n_per_task, seed,
                                     target=target)
    by_image = {(s["task"], s["image"]): s for s in specs}
    vqa = ScriptedColorVQA(specs)
    vsm = ScriptedColorVSM()

    # walk in eval_model's order, telling the scripted VQA which sample is
    # current (the real engines infer it from the pixels/question alone)
    results = {}
    per_task = {}
    path_lengths = []
    import time
    latencies = []
    all_correct = []
    for task in ("direct_attributes", "relative_position"):
        folder = os.path.join(out_dir, task)
        recs = []
        accs = []
        for f in sorted(os.listdir(folder)):
            if f.endswith(".json"):
                continue
            spec = by_image[(task, f)]
            vqa.set_sample(spec["name"])
            with open(os.path.join(
                    folder, f.rsplit(".", 1)[0] + ".json")) as fh:
                ann = json.load(fh)
            image = Image.open(os.path.join(folder, f)).convert("RGB")
            t0 = time.perf_counter()
            rec = seal_mod.seal_answer(vqa, vsm, image, ann["question"],
                                       ann["options"])
            latencies.append(time.perf_counter() - t0)
            rec["image"] = f
            recs.append(rec)
            accs.append(rec["correct"])
            all_correct.append(rec["correct"])
            if collect_path_lengths:
                _, plen, ok, _ = visual_search(
                    vsm, image, spec["name"],
                    smallest_size=max(int(np.ceil(min(image.width,
                                                      image.height) / 4.0)),
                                      224))
                if not ok:
                    raise AssertionError(
                        f"scripted search missed {spec['name']} in {f}")
                path_lengths.append(plen)
        results[task] = recs
        per_task[task] = float(np.mean(accs)) if accs else None
    acc = float(np.mean(all_correct)) if all_correct else None
    return acc, per_task, path_lengths, results
