"""Convert REFER-distribution annotations (refs(unc).p + instances.json,
the format VisualSearch/utils/refer.py consumes) into this framework's
pre-merged refer_seg JSON contract (port of
vstar_tpu/data/refer_convert.py, host only):

  train:  refer_seg/<dataset>.json
          [{'image', 'expressions': [...], 'segmentation', 'bbox' xyxy}]
  val:    refer_seg/<dataset>_val.json
          [{'image', 'expression', 'segmentation', 'bbox' xyxy}]

Usage:
  python -m vstar_tpu_torch.data.refer_convert --refer_root refer_seg \\
      --dataset refcoco --split_by unc
"""

from __future__ import annotations

import argparse
import json
import os
import pickle


def convert(refer_root: str, dataset: str = "refcoco",
            split_by: str = "unc", image_prefix: str = "images"):
    base = os.path.join(refer_root, dataset)
    refs = pickle.load(open(os.path.join(base, f"refs({split_by}).p"), "rb"))
    inst = json.load(open(os.path.join(base, "instances.json")))
    anns = {a["id"]: a for a in inst["annotations"]}
    imgs = {i["id"]: i for i in inst["images"]}

    train, val = [], []
    for ref in refs:
        ann = anns.get(ref["ann_id"])
        img = imgs.get(ref["image_id"])
        if ann is None or img is None:
            continue
        x, y, w, h = ann["bbox"]
        item = {
            "image": os.path.join(image_prefix, img["file_name"]),
            "segmentation": ann["segmentation"],
            "bbox": [x, y, x + w, y + h],
        }
        exprs = [s["sent"] for s in ref["sentences"]]
        if ref.get("split") == "val":
            for e in exprs:
                val.append({**item, "expression": e})
        else:
            train.append({**item, "expressions": exprs})

    os.makedirs(refer_root, exist_ok=True)
    with open(os.path.join(refer_root, f"{dataset}.json"), "w") as f:
        json.dump(train, f)
    with open(os.path.join(refer_root, f"{dataset}_val.json"), "w") as f:
        json.dump(val, f)
    return len(train), len(val)


def main():
    p = argparse.ArgumentParser("REFER -> refer_seg json converter")
    p.add_argument("--refer_root", required=True)
    p.add_argument("--dataset", default="refcoco",
                   choices=["refclef", "refcoco", "refcoco+", "refcocog"])
    p.add_argument("--split_by", default="unc")
    p.add_argument("--image_prefix", default="images")
    args = p.parse_args()
    n_train, n_val = convert(args.refer_root, args.dataset, args.split_by,
                             args.image_prefix)
    print(f"{args.dataset}: {n_train} train refs, {n_val} val expressions")


if __name__ == "__main__":
    main()
