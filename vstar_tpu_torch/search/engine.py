"""VSMEngine: the host driver that satisfies `VSMClient`
(search/policy.py, the port's copy of the JAX package's policy) over the
port's VSM, so `visual_search` drives it unchanged (port of
vstar_tpu/search/engine.py).

Builds the vicuna-v1 prompt with <im_start><image><im_end>, preprocesses
the patch for both towers on the host (CLIP 224, OWL-ViT 768, uint8),
runs `vsm_generate` and post-processes per mode. Decoding verifies the
template draft "Sure, [LOC]." by default (decode/speculative.py), as the
JAX engine does; its tokens are greedy's.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.config import VSMConfig
from ..data.preprocess import (clip_resize_u8, expand2square,
                               owlvit_resize_u8, resize_bilinear_torch)
from ..decode.sampler import decode_stats
from ..models.vsm import VSMOutput, vsm_generate
from ..multimodal.constants import (DEFAULT_IM_END_TOKEN,
                                    DEFAULT_IM_START_TOKEN,
                                    DEFAULT_IMAGE_TOKEN)
from ..multimodal.conversation import CONV_TEMPLATES
from ..multimodal.splicing import build_layout
from ..multimodal.tokenizer import tokenize_with_image


def _round128(n: int) -> int:
    return ((n + 127) // 128) * 128


class VSMEngine:
    """'detection', 'vqa' and 'segmentation' modes of one VSM."""

    CONV_TYPE = "llava_v1"

    def __init__(self, params, cfg: VSMConfig, tokenizer,
                 loc_token_id: int, *, device, eos_id: int = 2,
                 max_new_tokens: int = 100,
                 prompt_buckets: Tuple[int, ...] = (384, 512),
                 compute_dtype=torch.bfloat16,
                 speculative_template: Optional[str] = "Sure, [LOC]."):
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.loc_token_id = loc_token_id
        self.device = torch.device(device)
        self.eos_id = eos_id
        self.max_new_tokens = max_new_tokens
        self.prompt_buckets = tuple(sorted(prompt_buckets))
        self.compute_dtype = compute_dtype
        self.spec_chunk = 8
        # the template's tokens (no BOS) then eos, in an eos-filled row
        # max_new_tokens + spec_chunk wide; None decodes greedily
        self._draft_row = None
        if speculative_template:
            ids = tokenizer(speculative_template).input_ids
            if ids and ids[0] == tokenizer.bos_token_id:
                ids = ids[1:]
            ids = list(ids) + [eos_id]
            row = np.full(max_new_tokens + self.spec_chunk, eos_id, np.int32)
            row[:min(len(ids), len(row))] = ids[:len(row)]
            self._draft_row = row
        # decode stats of the last call (decode_stats); a list here
        # receives the decoder's logits trace (greedy_decode's `trace`)
        self.last_decode_stats = None
        self.decode_trace: Optional[List] = None

    def _build_prompt(self, question: str) -> str:
        conv = CONV_TEMPLATES[self.CONV_TYPE]()
        prompt = (DEFAULT_IM_START_TOKEN + DEFAULT_IMAGE_TOKEN
                  + DEFAULT_IM_END_TOKEN + "\n" + question)
        conv.append_message(conv.roles[0], prompt)
        conv.append_message(conv.roles[1], None)
        return conv.get_prompt()

    def _bucket(self, n: int) -> int:
        for b in self.prompt_buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt too long: {n} > {self.prompt_buckets[-1]}")

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(arr)).to(self.device)

    def _run(self, image, question: str
             ) -> Tuple[VSMOutput, Tuple[int, int]]:
        ids = tokenize_with_image(self._build_prompt(question),
                                  self.tokenizer)
        n_img = self.cfg.image_tokens
        bucket = self._bucket(len(ids) - 1 + n_img)
        lay = build_layout(ids, bucket, n_long=n_img, n_short=0,
                           image_long=True)
        sq, _, _ = expand2square(image)
        img_clip = clip_resize_u8(sq, self.cfg.vision.image_size)[None]
        img_owl = owlvit_resize_u8(image,
                                   self.cfg.owl_vision.image_size)[None]
        with torch.inference_mode():
            out = vsm_generate(
                self.params, self.cfg, self._to_device(img_clip),
                self._to_device(img_owl), self._to_device(lay.text_ids[None]),
                self._to_device(lay.feat_idx[None]),
                self._to_device(lay.is_feat[None]),
                torch.tensor([lay.length], dtype=torch.int32,
                             device=self.device),
                loc_token_id=self.loc_token_id,
                max_new_tokens=self.max_new_tokens, eos_id=self.eos_id,
                # verify chunks write spec_chunk entries past the frontier
                cache_len=bucket + _round128(self.max_new_tokens
                                             + self.spec_chunk),
                compute_dtype=self.compute_dtype,
                draft_ids=None if self._draft_row is None
                else self._to_device(self._draft_row[None]),
                spec_chunk=self.spec_chunk, trace=self.decode_trace)
        out = out._replace(**{k: v.cpu() for k, v in out._asdict().items()
                              if isinstance(v, torch.Tensor)})
        self.last_decode_stats = decode_stats(
            [int(n) for n in out.num_generated], out.n_forwards)
        return out, (image.height, image.width)

    def _heatmap(self, out: VSMOutput, size: Tuple[int, int]) -> np.ndarray:
        """Low-res mask logits -> patch size (bilinear, half-pixel) ->
        clamp at 0."""
        if not bool(out.loc_valid[0]):
            return np.zeros(size, np.float32)
        low = out.mask_logits[0].numpy().astype(np.float32)
        return np.clip(resize_bilinear_torch(low, size[0], size[1]), 0.0,
                       None)

    # -- VSMClient protocol ------------------------------------------------

    def detect(self, image, name: str):
        out, size = self._run(image,
                              f"Please locate the {name} in this image.")
        if not bool(out.loc_valid[0]):
            return (np.zeros((0, 4), np.float32), np.zeros((0,), np.float32),
                    np.zeros(size, np.float32))
        boxes = out.det_boxes[0].numpy().astype(np.float32)
        logits = 1.0 / (1.0 + np.exp(-out.det_logits[0].numpy()
                                     .astype(np.float32)))
        return boxes, logits, self._heatmap(out, size)

    def vqa(self, image, question: str) -> str:
        out, _ = self._run(image, question)
        n = int(out.num_generated[0])
        toks = [int(t) for t in out.tokens[0, :n]]
        text = self.tokenizer.decode(toks, skip_special_tokens=True)
        return text.replace("\n", "").replace("  ", " ").strip()

    def segment(self, image, phrase: str) -> np.ndarray:
        out, size = self._run(image,
                              f"Please locate the {phrase} in this image.")
        return self._heatmap(out, size)
