"""Annotation preprocessing — equivalent of the reference's
VisualSearch/preprocess_data.py:15-93: builds per-image class->bboxes maps
for COCO(-Stuff) and Objects365, and merges goldG grounding files.

Output contract consumed by data/vsm_datasets.SegDetDataset:
  {image_id: {class_name: {"bboxes": [[x1,y1,x2,y2], ...],
                           "cat_id": int}, ...}, ...}
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict


def build_image2bboxes_coco(instances_json: str, out_path: str,
                            max_per_class: int = 100) -> Dict:
    """COCO instances_train2017.json -> cocostuff_image2bboxes.json."""
    data = json.load(open(instances_json))
    cats = {c["id"]: c["name"] for c in data["categories"]}
    img_name = {im["id"]: os.path.splitext(im["file_name"])[0]
                for im in data["images"]}
    out: Dict[str, Dict] = defaultdict(dict)
    for ann in data["annotations"]:
        if ann.get("iscrowd", 0):
            continue
        name = cats[ann["category_id"]]
        x, y, w, h = ann["bbox"]
        entry = out[img_name[ann["image_id"]]].setdefault(
            name, {"bboxes": [], "cat_id": ann["category_id"]})
        if len(entry["bboxes"]) < max_per_class:
            entry["bboxes"].append([x, y, x + w, y + h])
    with open(out_path, "w") as f:
        json.dump(out, f)
    return out


def build_image2bboxes_objects365(anno_json: str, out_path: str,
                                  max_per_class: int = 100) -> Dict:
    """Objects365 zhiyuan_objv2_train.json -> objects365_image2bboxes.json
    (same schema; boxes only, no masks)."""
    return build_image2bboxes_coco(anno_json, out_path, max_per_class)


def merge_goldG(mixed_json: str, flickr_json: str, out_path: str) -> list:
    """final_mixed_train + final_flickr_separateGT -> goldG_train.json
    (preprocess_data.py's merge), normalizing tokens_positive spans into
    {'phrase', 'bboxes'} grounding entries."""
    merged = []
    for path in (mixed_json, flickr_json):
        if not os.path.exists(path):
            continue
        data = json.load(open(path))
        images = {im["id"]: im for im in data["images"]}
        by_img = defaultdict(list)
        for ann in data["annotations"]:
            by_img[ann["image_id"]].append(ann)
        for img_id, anns in by_img.items():
            im = images[img_id]
            caption = im.get("caption", "")
            phrase_boxes = defaultdict(list)
            for ann in anns:
                for span in ann.get("tokens_positive", []):
                    phrase = caption[span[0]:span[1]]
                    x, y, w, h = ann["bbox"]
                    phrase_boxes[phrase].append([x, y, x + w, y + h])
            if phrase_boxes:
                merged.append({
                    "filename": im["file_name"],
                    "caption": caption,
                    "grounding": [{"phrase": p, "bboxes": b}
                                  for p, b in phrase_boxes.items()],
                })
    with open(out_path, "w") as f:
        json.dump(merged, f)
    return merged


def paco_class_key(name: str) -> str:
    """PACO-LVIS category name -> canonical 'obj' or 'obj:part' key
    (general_segdet_dataset.py:92-100: split at ':', each side keeps the
    text before '_(' — 'mug_(cup):handle_(grip)' -> 'mug:handle')."""
    parts = name.strip().split(":")
    if len(parts) == 1:
        return parts[0].split("_(")[0]
    obj, part = parts
    return obj.split("_(")[0] + ":" + part.split("_(")[0]


def render_paco_name(key: str, rng) -> str:
    """Sample-time phrasing of a paco class key: object-part names flip a
    coin between 'obj part' and 'the part of the obj', underscores become
    spaces (general_segdet_dataset.py:221-233 — the flip happens per
    SAMPLE in the reference, so it must not be collapsed at
    preprocessing time)."""
    if ":" not in key:
        return key.replace("_", " ")
    obj, part = key.split(":", 1)
    name = (obj + " " + part) if rng.random() < 0.5 \
        else "the {} of the {}".format(part, obj)
    return name.replace("_", " ")


def build_image2bboxes_paco(paco_json: str, out_path: str,
                            max_per_class: int = 100) -> Dict:
    """PACO-LVIS -> paco_image2bboxes.json. Keys are the images'
    RELATIVE file_name (kept verbatim: paco images resolve under
    base_dir/coco2017/<file_name>, general_segdet_dataset.py:193-194) and
    the CANONICAL class keys ('obj' / 'obj:part'); SegDetDataset renders
    the phrasing per sample (render_paco_name coin flip)."""
    data = json.load(open(paco_json))
    cats = {c["id"]: paco_class_key(c["name"]) for c in data["categories"]}
    img_name = {im["id"]: im["file_name"] for im in data["images"]}
    out: Dict[str, Dict] = defaultdict(dict)
    for ann in data["annotations"]:
        name = cats[ann["category_id"]]
        x, y, w, h = ann["bbox"]
        entry = out[img_name[ann["image_id"]]].setdefault(
            name, {"bboxes": [], "cat_id": ann["category_id"]})
        if len(entry["bboxes"]) < max_per_class:
            entry["bboxes"].append([x, y, x + w, y + h])
    with open(out_path, "w") as f:
        json.dump(out, f)
    return out
