"""Validation dataset for VSM training — refcoco|unc|val contract
(reference ValDataset, VisualSearch/utils/dataset.py:285-494; copy of
vstar_tpu/data/val_dataset.py): one
referring expression per item, gIoU/cIoU on the mask and det-acc@0.5 on
the box (train.py:570-644 gates checkpoints on det-acc)."""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List

import numpy as np
from PIL import Image

from ..multimodal.constants import DEFAULT_IMAGE_TOKEN
from .rle import polygons_to_mask, rle_decode
from .vsm_collate import VSMRow, collate_vsm_rows
from .vsm_datasets import _preprocess_pair


class ValDataset:
    """refer_seg/<ds>_val.json: [{'image', 'expression', 'segmentation',
    'bbox' (xyxy)}] — flattened to one expression per item."""

    def __init__(self, base_image_dir: str, val_dataset: str = "refcoco",
                 clip_size: int = 224, owl_size: int = 768):
        p = os.path.join(base_image_dir, "refer_seg",
                         f"{val_dataset}_val.json")
        if not os.path.exists(p):
            raise FileNotFoundError(p)
        self.base = base_image_dir
        self.items: List[Dict] = json.load(open(p))
        self.clip_size = clip_size
        self.owl_size = owl_size

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i: int) -> VSMRow:
        item = self.items[i]
        img = Image.open(os.path.join(self.base, "refer_seg",
                                      item["image"])).convert("RGB")
        clip_t, owl_t = _preprocess_pair(img, self.clip_size,
                                         self.owl_size)
        seg = item["segmentation"]
        if isinstance(seg, dict):
            mask = rle_decode(seg).astype(np.float32)
        else:
            mask = polygons_to_mask(seg, img.height, img.width
                                    ).astype(np.float32)
        x1, y1, x2, y2 = item["bbox"]
        box = np.asarray([[(x1 + x2) / 2 / img.width,
                           (y1 + y2) / 2 / img.height,
                           (x2 - x1) / img.width,
                           (y2 - y1) / img.height]], np.float32)
        q = (DEFAULT_IMAGE_TOKEN + "\n"
             + f"Please locate the {item['expression']} in this image.")
        return VSMRow(image_clip=clip_t, image_owl=owl_t,
                      source=[{"from": "human", "value": q},
                              {"from": "gpt", "value": "Sure, [LOC]."}],
                      gt_mask=mask, mask_valid=True,
                      tgt_boxes=box, bboxes_valid=True)

    def batches(self, tokenizer, loc_token_id: int, batch_size: int = 4,
                rank: int = 0, world: int = 1,
                **collate_kw) -> Iterator[Dict[str, np.ndarray]]:
        """Iterate collated batches over shard `rank` of `world` of the
        val set (the DistributedSampler equivalent, reference
        train.py:355-371; the port's trainers run the whole set on every
        rank of a mesh, so that every rank takes the same checkpoint
        decision, hence the default). Interleaved sharding, drop-last
        within the shard."""
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} not in [0, {world})")
        idx = list(range(rank, len(self), world))
        for start in range(0, len(idx) - batch_size + 1, batch_size):
            rows = [self[idx[start + k]] for k in range(batch_size)]
            yield collate_vsm_rows(rows, tokenizer, loc_token_id,
                                   **collate_kw)
