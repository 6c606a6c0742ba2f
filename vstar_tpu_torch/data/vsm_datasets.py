"""VSM training datasets: the reference's hybrid mixture, on the host
(copy of vstar_tpu/data/vsm_datasets.py).

Mirrors VisualSearch/utils/{general_segdet_dataset, refer_seg_dataset,
mixed_grounding_dataset, vqa_dataset, dataset}.py. Every dataset yields
per-conversation `VSMRow`s (one [LOC] per row); `HybridDataset` mixes child
datasets by rate (15,4,4,15 default, dataset.py:183-282). Loaders read the
same directory/JSON contracts the reference documents:

  base_image_dir/
    cocostuff_image2bboxes.json, objects365_image2bboxes.json  (preprocess)
    coco/train2017/*.jpg, cocostuff/train2017/*.png (semantic masks)
    object365/images/train/...
    refer_seg/{images, refclef|refcoco|refcoco+|refcocog}.json
    MixedGrounding/goldG_train.json + OpenSource images
    vqa_data/{possible_locations_conv_86k,llava_instruct_150k}.json
    vqa_data/coco_images

All randomness goes through a passed `random.Random` for reproducibility.
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Optional, Sequence

import numpy as np
from PIL import Image

from ..multimodal.constants import DEFAULT_IMAGE_TOKEN
from .preprocess import clip_preprocess, expand2square, owlvit_preprocess
from .rle import polygons_to_mask, rle_decode
from .vsm_collate import VSMRow

SHORT_QUESTION_LIST = [
    DEFAULT_IMAGE_TOKEN + "\n" + "Please locate the {class_name} in this "
    "image."]
ANSWER_LIST = ["Sure, [LOC]."]


# Fast-forward mode for step-granular resume: sampling replays the exact
# rng stream of a previous run (same code paths, same draws) while the
# expensive IO — image decode, preprocessing, mask decode — returns cheap
# stubs. HybridDataset.batches(skip_batches=...) uses it to reach the
# crash step in seconds instead of replaying an epoch of decodes.
_FAST_FORWARD = False


class fast_forward:
    def __enter__(self):
        global _FAST_FORWARD
        self._saved = _FAST_FORWARD
        _FAST_FORWARD = True

    def __exit__(self, *exc):
        global _FAST_FORWARD
        _FAST_FORWARD = self._saved


def _load_image(path: str) -> Image.Image:
    if _FAST_FORWARD:
        return Image.new("RGB", (32, 32))
    return Image.open(path).convert("RGB")


def _preprocess_pair(img: Image.Image, clip_size: int = 224,
                     owl_size: int = 768):
    """(clip on the top-left-squared image, owl on the raw image) — the
    VSM-side expand2square pastes top-left
    (VisualSearch/utils/utils.py:28-39)."""
    if _FAST_FORWARD:
        return (np.zeros((clip_size, clip_size, 3), np.float32),
                np.zeros((owl_size, owl_size, 3), np.float32))
    sq, _, _ = expand2square(img, center=False)
    return clip_preprocess(sq, clip_size), owlvit_preprocess(img, owl_size)


def _boxes_xyxy_to_cxcywh_norm(boxes: np.ndarray, w: int, h: int
                               ) -> np.ndarray:
    boxes = boxes.astype(np.float32)
    cx = (boxes[:, 0] + boxes[:, 2]) / 2 / w
    cy = (boxes[:, 1] + boxes[:, 3]) / 2 / h
    bw = (boxes[:, 2] - boxes[:, 0]) / w
    bh = (boxes[:, 3] - boxes[:, 1]) / h
    return np.stack([cx, cy, bw, bh], 1)


def _conversation(class_name: str, rng: random.Random) -> List[Dict]:
    q = rng.choice(SHORT_QUESTION_LIST).format(class_name=class_name.lower())
    return [{"from": "human", "value": q},
            {"from": "gpt", "value": rng.choice(ANSWER_LIST)}]


class SegDetDataset:
    """COCO-Stuff semantic masks + Objects365 boxes (+ optional PACO parts);
    general_segdet_dataset.py:106-412. Requires the image2bboxes.json files
    built by data/preprocess_annotations.py."""

    def __init__(self, base_image_dir: str, num_classes_per_sample: int = 3,
                 clip_size: int = 224, owl_size: int = 768,
                 max_boxes: int = 100, seed: int = 0,
                 sources: Sequence[str] = ("cocostuff", "objects365")):
        self.base = base_image_dir
        self.clip_size, self.owl_size = clip_size, owl_size
        self.k = num_classes_per_sample
        self.max_boxes = max_boxes
        self.seed = seed
        self.rng = random.Random(seed)
        self.data: Dict[str, Dict] = {}
        for src in sources:
            path = os.path.join(base_image_dir,
                                f"{src}_image2bboxes.json")
            if os.path.exists(path):
                self.data[src] = json.load(open(path))
        if not self.data:
            raise FileNotFoundError(
                f"no *_image2bboxes.json under {base_image_dir}")
        self.sources = list(self.data.keys())

    def _image_path(self, src: str, image_id: str) -> str:
        if src == "cocostuff":
            return os.path.join(self.base, "coco", "train2017",
                                image_id + ".jpg")
        if src == "paco":
            # PACO-LVIS images are COCO images; the annotation keys keep the
            # relative file_name ('train2017/xxx.jpg'), resolved under
            # coco2017/ (general_segdet_dataset.py:193-194)
            return os.path.join(self.base, "coco2017", image_id)
        return os.path.join(self.base, "object365", "images", "train",
                            image_id)

    def _semantic_mask(self, src: str, image_id: str, cat_id: int
                       ) -> Optional[np.ndarray]:
        if src != "cocostuff":
            return None
        if _FAST_FORWARD:
            return np.zeros((1, 1), np.float32)
        p = os.path.join(self.base, "cocostuff", "train2017",
                         image_id + ".png")
        if not os.path.exists(p):
            return None
        sem = np.asarray(Image.open(p))
        return (sem == cat_id).astype(np.float32)

    def sample_rows(self) -> List[VSMRow]:
        src = self.rng.choice(self.sources)
        image_id = self.rng.choice(list(self.data[src].keys()))
        entry = self.data[src][image_id]   # {class_name: {'bboxes': [...],
        #                                     'cat_id': int}, ...}
        img = _load_image(self._image_path(src, image_id))
        clip_t, owl_t = _preprocess_pair(img, self.clip_size, self.owl_size)
        classes = list(entry.keys())
        chosen = self.rng.sample(classes, min(self.k, len(classes)))
        rows = []
        for cname in chosen:
            info = entry[cname]
            boxes = np.asarray(info["bboxes"], np.float32)[:self.max_boxes]
            boxes = _boxes_xyxy_to_cxcywh_norm(boxes, img.width, img.height)
            mask = self._semantic_mask(src, image_id, info.get("cat_id", -1))
            if src == "paco":
                # canonical 'obj:part' keys phrase per sample (the
                # reference's 50/50 'obj part' vs 'the part of the obj',
                # general_segdet_dataset.py:221-231)
                from .preprocess_annotations import render_paco_name
                cname = render_paco_name(cname, self.rng)
            rows.append(VSMRow(
                image_clip=clip_t, image_owl=owl_t,
                source=_conversation(cname, self.rng),
                gt_mask=mask, mask_valid=mask is not None,
                tgt_boxes=boxes, bboxes_valid=True))
        return rows


class ReferSegDataset:
    """refclef/refcoco/+/g referring expressions
    (refer_seg_dataset.py:19-283); annotations pre-merged to
    refer_seg/<ds>.json: [{'image': path, 'expressions': [...],
    'segmentation': rle|polygons, 'bbox': xyxy}]."""

    def __init__(self, base_image_dir: str, num_per_sample: int = 3,
                 seed: int = 0,
                 datasets: Sequence[str] = ("refclef", "refcoco",
                                            "refcoco+", "refcocog"),
                 clip_size: int = 224, owl_size: int = 768):
        self.base = base_image_dir
        self.clip_size, self.owl_size = clip_size, owl_size
        self.k = num_per_sample
        self.seed = seed
        self.rng = random.Random(seed)
        self.items: List[Dict] = []
        for ds in datasets:
            p = os.path.join(base_image_dir, "refer_seg", ds + ".json")
            if os.path.exists(p):
                self.items.extend(json.load(open(p)))
        if not self.items:
            raise FileNotFoundError("no refer_seg annotations")

    def _mask(self, item: Dict, h: int, w: int) -> np.ndarray:
        if _FAST_FORWARD:
            return np.zeros((1, 1), np.float32)
        seg = item["segmentation"]
        if isinstance(seg, dict):
            return rle_decode(seg).astype(np.float32)
        return polygons_to_mask(seg, h, w).astype(np.float32)

    def sample_rows(self) -> List[VSMRow]:
        item = self.rng.choice(self.items)
        img = _load_image(os.path.join(self.base, "refer_seg",
                                       item["image"]))
        clip_t, owl_t = _preprocess_pair(img, self.clip_size, self.owl_size)
        exprs = item["expressions"]
        # distinct expressions, like the reference's random.sample
        # (refer_seg_dataset.py) — sampling with replacement would skew
        # the mixture with duplicate rows
        chosen = self.rng.sample(exprs, min(self.k, len(exprs)))
        mask = self._mask(item, img.height, img.width)
        boxes = _boxes_xyxy_to_cxcywh_norm(
            np.asarray([item["bbox"]], np.float32), img.width, img.height)
        return [VSMRow(image_clip=clip_t, image_owl=owl_t,
                       source=_conversation(e, self.rng),
                       gt_mask=mask, mask_valid=True,
                       tgt_boxes=boxes, bboxes_valid=True)
                for e in chosen]


class MixedGroundingDataset:
    """goldG phrase grounding (mixed_grounding_dataset.py:21-161): boxes
    only, masks invalid. goldG_train.json: [{'filename', 'caption',
    'grounding': [{'phrase', 'bboxes': xyxy list}]}]."""

    def __init__(self, base_image_dir: str, num_per_sample: int = 3,
                 seed: int = 0, clip_size: int = 224, owl_size: int = 768):
        p = os.path.join(base_image_dir, "MixedGrounding",
                         "goldG_train.json")
        if not os.path.exists(p):
            raise FileNotFoundError(p)
        self.base = base_image_dir
        self.clip_size, self.owl_size = clip_size, owl_size
        self.items = json.load(open(p))
        self.k = num_per_sample
        self.seed = seed
        self.rng = random.Random(seed)

    def sample_rows(self) -> List[VSMRow]:
        item = self.rng.choice(self.items)
        img = _load_image(os.path.join(
            self.base, "MixedGrounding", "OpenSource", item["filename"]))
        clip_t, owl_t = _preprocess_pair(img, self.clip_size, self.owl_size)
        ground = item["grounding"]
        chosen = [self.rng.choice(ground)
                  for _ in range(min(self.k, len(ground)))]
        rows = []
        for g in chosen:
            boxes = _boxes_xyxy_to_cxcywh_norm(
                np.asarray(g["bboxes"], np.float32), img.width, img.height)
            rows.append(VSMRow(image_clip=clip_t, image_owl=owl_t,
                               source=_conversation(g["phrase"], self.rng),
                               gt_mask=None, mask_valid=False,
                               tgt_boxes=boxes, bboxes_valid=True))
        return rows


class VQADataset:
    """LLaVA-style VQA with a dummy [LOC] injected after <image>
    (vqa_dataset.py:19-143): '<image>[LOC]\\nquestion'; dummy box targets
    with bboxes_valid=0 so the [LOC] key is attention-masked."""

    def __init__(self, base_image_dir: str, seed: int = 0,
                 vqa_data: Sequence[str] = ("possible_locations_conv_86k",
                                            "llava_instruct_150k"),
                 sample_rate: Sequence[float] = (2, 1),
                 clip_size: int = 224, owl_size: int = 768):
        self.base = base_image_dir
        self.clip_size, self.owl_size = clip_size, owl_size
        self.seed = seed
        self.rng = random.Random(seed)
        self.datasets = []
        rates = []
        for name, rate in zip(vqa_data, sample_rate):
            p = os.path.join(base_image_dir, "vqa_data", name + ".json")
            if os.path.exists(p):
                self.datasets.append(json.load(open(p)))
                rates.append(rate)
        if not self.datasets:
            raise FileNotFoundError("no vqa_data jsons")
        r = np.asarray(rates, np.float64)
        self.rates = (r / r.sum()).tolist()

    def sample_rows(self) -> List[VSMRow]:
        ds = self.rng.choices(self.datasets, weights=self.rates)[0]
        item = self.rng.choice(ds)
        img = _load_image(os.path.join(self.base, "vqa_data", "coco_images",
                                       item["image"]))
        clip_t, owl_t = _preprocess_pair(img, self.clip_size, self.owl_size)
        source = []
        for s in item["conversations"]:
            v = s["value"]
            if DEFAULT_IMAGE_TOKEN in v:
                v = v.replace(DEFAULT_IMAGE_TOKEN, "").strip()
                v = (DEFAULT_IMAGE_TOKEN + "[LOC]" + "\n" + v).strip()
            source.append({"from": s["from"], "value": v})
        return [VSMRow(image_clip=clip_t, image_owl=owl_t, source=source,
                       gt_mask=None, mask_valid=False,
                       tgt_boxes=np.asarray([[0.5, 0.5, 1.0, 1.0]],
                                            np.float32),
                       bboxes_valid=False)]


class HybridDataset:
    """Rate-weighted mixture (dataset.py:183-282); default
    general_segdet:15, refer_seg:4, mixed_grounding:4, vqa:15.

    Bad samples (missing/corrupt files) are retried with a fresh draw, the
    counterpart of the reference's substitute-index-0 fallback
    (refer_seg_dataset.py:130-131 etc.)."""

    def __init__(self, children: Sequence, rates: Sequence[float],
                 samples_per_epoch: int = 80000, seed: int = 0):
        assert len(children) == len(rates) and children
        self.children = list(children)
        r = np.asarray(rates, np.float64)
        self.rates = (r / r.sum()).tolist()
        self.samples_per_epoch = samples_per_epoch
        self.seed = seed
        self.rng = random.Random(seed)

    def __len__(self):
        return self.samples_per_epoch

    def sample_rows(self) -> List[VSMRow]:
        for _ in range(8):
            child = self.rng.choices(self.children, weights=self.rates)[0]
            try:
                return child.sample_rows()
            except (OSError, KeyError, ValueError) as e:
                print(f"[data] bad sample from {type(child).__name__}: {e};"
                      " resampling")
        raise RuntimeError("8 consecutive bad samples; check dataset_dir")

    def _rng_states(self):
        return (self.rng.getstate(),
                [c.rng.getstate() for c in self.children])

    def _set_rng_states(self, st):
        self.rng.setstate(st[0])
        for c, s in zip(self.children, st[1]):
            c.rng.setstate(s)

    def _reseed_all(self, epoch: int):
        """Reset every sampler rng to a stream derived from (seed, epoch)
        — the DataLoader re-shuffle-per-epoch equivalent. int/tuple-of-int
        hashes are PYTHONHASHSEED-independent, so streams are stable
        across processes and runs."""
        self.rng.seed(hash((self.seed, -1, epoch)))
        for i, c in enumerate(self.children):
            c.rng.seed(hash((getattr(c, "seed", 0), i, epoch)))

    def batches(self, batch_size_rows: int, skip_batches: int = 0,
                epoch: Optional[int] = None):
        """Yield lists of VSMRow of (at least) batch_size_rows, trimmed.

        epoch: when given, all sampler rngs are reseeded from
        (seed, epoch) first, so each epoch's stream is a deterministic
        function of (seed, epoch) alone. Without this, epoch E >= 1
        content would depend on where the previous epoch's generator
        stopped drawing — including prefetch-thread overdraw, which is
        timing-dependent — and a step-granular resume into epoch E would
        replay epoch 0's stream. Callers that never span epochs (tests,
        single-epoch runs) may omit it and consume the construction-seeded
        stream.

        skip_batches: deterministic fast-forward for step-granular resume
        — replays the seeded sampling stream WITHOUT decoding (fast_
        forward stubs), so the generator resumes exactly where a crashed
        run stopped; the sample straddling the boundary is re-drawn for
        real from an rng snapshot. Assumes the skipped prefix hit no
        bad-sample retries (retries re-draw, shifting the stream)."""
        if epoch is not None:
            self._reseed_all(epoch)
        buf: List[VSMRow] = []
        drawn = 0
        to_skip = skip_batches * batch_size_rows
        while to_skip > 0 and drawn < self.samples_per_epoch:
            st = self._rng_states()
            with fast_forward():
                n = len(self.sample_rows())
            drawn += 1
            if n <= to_skip:
                to_skip -= n
                continue
            # boundary sample: part of it belongs to the resumed stream
            self._set_rng_states(st)
            buf = self.sample_rows()[to_skip:]
            to_skip = 0
        # flush batches already complete inside the boundary sample — when
        # the boundary lands inside the epoch's LAST sample the loop below
        # runs zero iterations and these rows would otherwise be dropped
        # (an uninterrupted run yields them)
        while len(buf) >= batch_size_rows:
            yield buf[:batch_size_rows]
            buf = buf[batch_size_rows:]
        for _ in range(drawn, self.samples_per_epoch):
            buf.extend(self.sample_rows())
            while len(buf) >= batch_size_rows:
                yield buf[:batch_size_rows]
                buf = buf[batch_size_rows:]
