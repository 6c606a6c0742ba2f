"""Static-layout multimodal token splicing (port of
vstar_tpu/multimodal/splicing.py).

HOST: `build_layout` walks the sentinel ids once and produces a gather
map padded to a bucketed length (the padded layouts keep the shapes equal
to the JAX side). DEVICE: `apply_splice` gathers the embedding sequence
from a per-row feature bank.

Bank layout per row: slot 0 = the image, slots 1..max_objects = object
crops; each slot holds [long(256); short(32)] projected features.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX, OBJECT_TOKEN_INDEX


@dataclasses.dataclass
class SpliceLayout:
    """Per-row gather map (host numpy, padded to `pad_len`)."""

    text_ids: np.ndarray      # int32 [S]; 0 at feature/pad positions
    feat_idx: np.ndarray      # int32 [S]; bank index at feature positions
    is_feat: np.ndarray       # bool  [S]
    length: int               # valid length
    labels: Optional[np.ndarray] = None  # int32 [S]; IGNORE at features


def bank_slot_size(n_long: int, n_short: int) -> int:
    return n_long + n_short


def build_layout(input_ids: Sequence[int], pad_len: int, *,
                 n_long: int = 256, n_short: int = 32,
                 image_long: bool = True,
                 objects_long: Optional[Sequence[bool]] = None,
                 labels: Optional[Sequence[int]] = None) -> SpliceLayout:
    """Expand sentinel ids into a static gather map: <image> -> n_long
    (image_long) or n_short tokens of slot 0; the i-th <object> -> n_long
    (objects_long[i]) or n_short tokens of slot 1 + i. `labels` (one per
    input id) are laid out alike, IGNORE_INDEX at feature positions."""
    slot = bank_slot_size(n_long, n_short)
    text_ids = np.zeros(pad_len, np.int32)
    feat_idx = np.zeros(pad_len, np.int32)
    is_feat = np.zeros(pad_len, bool)
    out_labels = np.full(pad_len, IGNORE_INDEX, np.int32) \
        if labels is not None else None

    def too_long():
        return ValueError(f"sequence bucket {pad_len} too small")

    p = 0
    obj_i = 0
    for j, tok in enumerate(input_ids):
        if tok in (IMAGE_TOKEN_INDEX, OBJECT_TOKEN_INDEX):
            if tok == IMAGE_TOKEN_INDEX:
                base, long = 0, image_long
            else:
                base = (1 + obj_i) * slot
                long = bool(objects_long[obj_i]) \
                    if objects_long is not None else False
                obj_i += 1
            n = n_long if long else n_short
            off = 0 if long else n_long
            if p + n > pad_len:
                raise too_long()
            feat_idx[p:p + n] = base + off + np.arange(n)
            is_feat[p:p + n] = True
            p += n
        else:
            if p >= pad_len:
                raise too_long()
            text_ids[p] = tok
            if labels is not None:
                out_labels[p] = labels[j]
            p += 1
    return SpliceLayout(text_ids=text_ids, feat_idx=feat_idx,
                        is_feat=is_feat, length=p, labels=out_labels)


def spliced_length(input_ids: Sequence[int], *, n_long: int = 256,
                   n_short: int = 32, image_long: bool = True,
                   objects_long: Optional[Sequence[bool]] = None) -> int:
    """Sequence length after sentinel expansion (for bucket choice)."""
    n = 0
    obj_i = 0
    for tok in input_ids:
        if tok == IMAGE_TOKEN_INDEX:
            n += n_long if image_long else n_short
        elif tok == OBJECT_TOKEN_INDEX:
            long = bool(objects_long[obj_i]) if objects_long is not None \
                else False
            n += n_long if long else n_short
            obj_i += 1
        else:
            n += 1
    return n


def apply_splice(token_embeds: torch.Tensor, feat_bank: torch.Tensor,
                 feat_idx: torch.Tensor, is_feat: torch.Tensor
                 ) -> torch.Tensor:
    """token_embeds [B, S, D], feat_bank [B, F, D], feat_idx [B, S],
    is_feat [B, S] bool -> [B, S, D]: one gather + select."""
    D = feat_bank.shape[-1]
    idx = feat_idx.long()[..., None].expand(-1, -1, D)
    feats = torch.gather(feat_bank, 1, idx).to(token_embeds.dtype)
    return torch.where(is_feat[..., None], feats, token_embeds)
