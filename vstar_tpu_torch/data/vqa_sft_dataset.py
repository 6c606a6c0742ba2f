"""VQA-LLM stage-2 (search instruction) dataset + collator (port of
vstar_tpu/data/vqa_sft_dataset.py, host only).

Mirrors LLaVA/llava/train/train_search.py:315-343 (object-string rewrite),
:661-803 (LazySupervisedDataset: 6-json mixture, context crops, long/short
flip) and :806-880 (collator: dummy image sentinel for text-only rows,
padding to exactly 3 <object> sentinels with attention masked off) —
re-expressed as static splice layouts + kv_valid masks for the train step.
"""

from __future__ import annotations

import copy
import json
import os
import random
from typing import Dict, List, Sequence

import numpy as np
from PIL import Image

from ..eval.vqa_engine import get_patch
from ..multimodal.constants import (DEFAULT_IM_END_TOKEN,
                                    DEFAULT_IM_START_TOKEN,
                                    DEFAULT_IMAGE_TOKEN,
                                    DEFAULT_OBJECT_TOKEN, IGNORE_INDEX,
                                    IMAGE_TOKEN_INDEX, OBJECT_TOKEN_INDEX)
from .label_masking import preprocess_v1
from .preprocess import clip_preprocess, expand2square

SFT_JSON_FILES = ("llava_instruct_data.json", "GQA_data.json",
                  "vaw_attribute_data.json", "negative_data.json",
                  "llava_focus_data.json", "spatial_relation_data.json")


def _replace_nth(sub: str, repl: str, text: str, nth: int) -> str:
    arr = text.split(sub)
    head = sub.join(arr[:nth])
    tail = sub.join(arr[nth:])
    return head + repl + tail


def normalize_bbox(bbox, w, h):
    out = [bbox[0] / w, bbox[1] / h, (bbox[0] + bbox[2]) / w,
           (bbox[1] + bbox[3]) / h]
    return [float(np.clip(v, 0, 1)) for v in out]


def rewrite_conversations(source: List[Dict], object_str_list=None,
                          use_mm_start_end: bool = False) -> List[Dict]:
    """preprocess_multimodal semantics (train_search.py:315-343): '<image>'
    moved to the front with a newline; each '<object>' occurrence replaced
    by 'name <object> at location [...]'."""
    out = []
    for sentence in copy.deepcopy(source):
        v = sentence["value"]
        if DEFAULT_IMAGE_TOKEN in v:
            v = v.replace(DEFAULT_IMAGE_TOKEN, "").strip()
            v = (DEFAULT_IMAGE_TOKEN + "\n" + v).strip()
        if use_mm_start_end:
            v = v.replace(DEFAULT_IMAGE_TOKEN,
                          DEFAULT_IM_START_TOKEN + DEFAULT_IMAGE_TOKEN
                          + DEFAULT_IM_END_TOKEN)
        if DEFAULT_OBJECT_TOKEN in v and object_str_list is not None:
            for i in range(v.count(DEFAULT_OBJECT_TOKEN)):
                v = _replace_nth(DEFAULT_OBJECT_TOKEN, object_str_list[i],
                                 v, i + 1)
        out.append({"from": sentence["from"], "value": v})
    return out


class SearchInstructionDataset:
    """The 6-json SFT mixture (train_search.py:668-675); spatial data
    duplicated x2. Yields per-sample dicts for `collate_vqa_sft`."""

    def __init__(self, data_path: str, image_folder: str,
                 image_size: int = 224, max_objects: int = 3,
                 seed: int = 0, files: Sequence[str] = SFT_JSON_FILES):
        items: List[Dict] = []
        order = ["vaw_attribute_data.json", "llava_instruct_data.json",
                 "GQA_data.json", "llava_focus_data.json",
                 "spatial_relation_data.json", "negative_data.json"]
        loaded = {}
        for f in files:
            p = os.path.join(data_path, f)
            if os.path.exists(p):
                loaded[f] = json.load(open(p))
        if not loaded:
            raise FileNotFoundError(f"no SFT jsons under {data_path}")
        for f in order:
            if f in loaded:
                items.extend(loaded[f])
                if f == "spatial_relation_data.json":
                    items.extend(copy.deepcopy(loaded[f]))
        self.items = items
        self.image_folder = image_folder
        self.image_size = image_size
        self.max_objects = max_objects
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i: int) -> Dict:
        sample = self.items[i]
        size = self.image_size
        out: Dict = {}
        is_search = "search" in sample
        image_px = np.zeros((size, size, 3), np.float32)
        object_px = np.zeros((self.max_objects, size, size, 3), np.float32)
        images_long = True
        objects_long = [False] * self.max_objects
        object_str_list = None
        has_image = "image" in sample

        if has_image:
            img = Image.open(os.path.join(
                self.image_folder, sample["image"])).convert("RGB")
            n_obj = 0
            bbox_list, name_list = [], []
            if is_search:
                instances = sample["target_instances"][:self.max_objects]
                n_obj = len(instances)
                for j, inst in enumerate(instances):
                    box = get_patch(inst["bbox"], img.width, img.height,
                                    patch_scale=1.2)
                    crop = img.crop(tuple(box)).resize((size, size))
                    # zero pads sit at the FRONT (train_search.py:742-743)
                    object_px[self.max_objects - n_obj + j] = \
                        clip_preprocess(crop, size)
                    bbox_list.append(list(inst["bbox"]))
                    name_list.append(inst["name"])
                if n_obj == 1:
                    objects_long[-1] = True
                    images_long = False
            sq, left, top = expand2square(img)
            if is_search:
                strs = []
                for name, bbox in zip(name_list, bbox_list):
                    bbox = [bbox[0] + left, bbox[1] + top, bbox[2], bbox[3]]
                    nb = normalize_bbox(bbox, sq.width, sq.height)
                    strs.append("{} {} at location [{:.3f},{:.3f},{:.3f},"
                                "{:.3f}]".format(name, DEFAULT_OBJECT_TOKEN,
                                                 *nb))
                object_str_list = strs
            image_px = clip_preprocess(sq, size)

        source = rewrite_conversations(sample["conversations"],
                                       object_str_list)
        out.update(source=source, has_image=has_image, is_search=is_search,
                   image=image_px, objects=object_px,
                   images_long=images_long, objects_long=objects_long)
        return out

    def sample(self) -> Dict:
        return self[self.rng.randrange(len(self.items))]


def collate_vqa_sft(instances: Sequence[Dict], tokenizer,
                    n_long: int = 256, n_short: int = 32,
                    seq_bucket: int = 2048, max_objects: int = 3
                    ) -> Dict[str, np.ndarray]:
    """-> static batch for train/sft.sft_loss.

    Reference collator semantics (train_search.py:806-880): rows without an
    image get a dummy sentinel after BOS (attention-masked); every row is
    padded to exactly `max_objects` object sentinels right after the image
    token (attention-masked); padded sentinels consume the zero crops at
    the front of the object stack.
    """
    from ..multimodal.splicing import build_layout

    B = len(instances)
    img_size = instances[0]["image"].shape[0]
    batch = {
        "image": np.stack([inst["image"] for inst in instances]),
        "objects": np.stack([inst["objects"] for inst in instances]),
        "text_ids": np.zeros((B, seq_bucket), np.int32),
        "feat_idx": np.zeros((B, seq_bucket), np.int32),
        "is_feat": np.zeros((B, seq_bucket), bool),
        "labels": np.full((B, seq_bucket), IGNORE_INDEX, np.int32),
        "kv_valid": np.zeros((B, seq_bucket), bool),
        "lens": np.zeros((B,), np.int32),
    }
    slot = n_long + n_short
    for b, inst in enumerate(instances):
        enc = preprocess_v1(inst["source"], tokenizer,
                            has_image=inst["has_image"],
                            has_object=inst["is_search"])
        ids = enc["input_ids"].tolist()
        labs = enc["labels"].tolist()

        masked_slots = set()
        if IMAGE_TOKEN_INDEX not in ids:
            ids = ids[:1] + [IMAGE_TOKEN_INDEX] + ids[1:]
            labs = labs[:1] + [IGNORE_INDEX] + labs[1:]
            masked_slots.add(0)  # dummy image
        img_pos = ids.index(IMAGE_TOKEN_INDEX)
        n_obj = sum(1 for t in ids if t == OBJECT_TOKEN_INDEX)
        pad_obj = max_objects - n_obj
        if pad_obj > 0:
            ids = (ids[:img_pos + 1] + [OBJECT_TOKEN_INDEX] * pad_obj
                   + ids[img_pos + 1:])
            labs = (labs[:img_pos + 1] + [IGNORE_INDEX] * pad_obj
                    + labs[img_pos + 1:])
            for k in range(pad_obj):
                masked_slots.add(1 + k)  # padded objects use front slots

        lay = build_layout(ids, seq_bucket, n_long=n_long, n_short=n_short,
                           image_long=bool(inst["images_long"]),
                           objects_long=list(inst["objects_long"]),
                           labels=labs)
        batch["text_ids"][b] = lay.text_ids
        batch["feat_idx"][b] = lay.feat_idx
        batch["is_feat"][b] = lay.is_feat
        batch["labels"][b] = lay.labels
        batch["lens"][b] = lay.length
        valid = np.zeros(seq_bucket, bool)
        valid[:lay.length] = True
        if masked_slots:
            slot_of = lay.feat_idx // slot
            for s in masked_slots:
                valid &= ~(lay.is_feat & (slot_of == s))
        batch["kv_valid"][b] = valid
    return batch
