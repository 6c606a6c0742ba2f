"""Stage-1 projector-alignment dataset (LAION-CC-SBU-558K contract; port
of vstar_tpu/data/pretrain_dataset.py, host only).

Mirrors LLaVA's pretrain path (LLaVA/llava/train/train.py with
--version plain): each sample is one image + one caption; the prompt is
just '<image>\\n' and the target the caption — all instruction tokens
masked, caption tokens supervised.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Sequence

import numpy as np
from PIL import Image

from ..multimodal.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from .preprocess import clip_preprocess, expand2square


class PretrainCaptionDataset:
    """blip_laion_cc_sbu_558k.json: [{'image': path, 'conversations':
    [{'from':'human','value':'<image>...'}, {'from':'gpt','value': cap}]}]"""

    def __init__(self, data_path: str, image_folder: str,
                 image_size: int = 224):
        self.items = json.load(open(data_path))
        self.image_folder = image_folder
        self.image_size = image_size

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i: int) -> Dict:
        item = self.items[i]
        img = Image.open(os.path.join(self.image_folder,
                                      item["image"])).convert("RGB")
        sq, _, _ = expand2square(img)
        caption = [s["value"] for s in item["conversations"]
                   if s["from"] == "gpt"][0]
        return {"image": clip_preprocess(sq, self.image_size),
                "caption": caption}


def collate_pretrain(instances: Sequence[Dict], tokenizer,
                     n_long: int = 256, n_short: int = 32,
                     image_long: bool = True, seq_bucket: int = 512
                     ) -> Dict[str, np.ndarray]:
    """'plain' conversation: [BOS, <image>, caption..., EOS]; loss on the
    caption only (train.py preprocess_plain semantics)."""
    from ..multimodal.splicing import build_layout

    B = len(instances)
    size = instances[0]["image"].shape[0]
    batch = {
        "image": np.stack([x["image"] for x in instances]),
        "objects": np.zeros((B, 3, size, size, 3), np.float32),
        "text_ids": np.zeros((B, seq_bucket), np.int32),
        "feat_idx": np.zeros((B, seq_bucket), np.int32),
        "is_feat": np.zeros((B, seq_bucket), bool),
        "labels": np.full((B, seq_bucket), IGNORE_INDEX, np.int32),
        "lens": np.zeros((B,), np.int32),
    }
    eos = tokenizer.eos_token_id
    for b, inst in enumerate(instances):
        cap_ids = tokenizer(inst["caption"]).input_ids
        if cap_ids and cap_ids[0] == tokenizer.bos_token_id:
            cap_ids = cap_ids[1:]
        ids = [tokenizer.bos_token_id, IMAGE_TOKEN_INDEX] + cap_ids + [eos]
        labels = ([IGNORE_INDEX, IGNORE_INDEX] + cap_ids + [eos])
        lay = build_layout(ids, seq_bucket, n_long=n_long, n_short=n_short,
                           image_long=image_long, labels=labels)
        batch["text_ids"][b] = lay.text_ids
        batch["feat_idx"][b] = lay.feat_idx
        batch["is_feat"][b] = lay.is_feat
        batch["labels"][b] = lay.labels
        batch["lens"][b] = lay.length
    return batch
