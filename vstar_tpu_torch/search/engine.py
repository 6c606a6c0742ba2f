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

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.config import VSMConfig
from ..data.preprocess import (clip_resize_u8, expand2square,
                               owlvit_resize_u8, resize_bilinear_torch)
from ..decode.graphs import DecodeGraphs
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
                 speculative_template: Optional[str] = "Sure, [LOC].",
                 kv_int8: bool = False):
        """kv_int8: int8 KV caches with per-(token, head) scales
        (nn/llama.KVCache)."""
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.loc_token_id = loc_token_id
        self.device = torch.device(device)
        self.eos_id = eos_id
        self.max_new_tokens = max_new_tokens
        self.prompt_buckets = tuple(sorted(prompt_buckets))
        self.compute_dtype = compute_dtype
        self.kv_int8 = kv_int8
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
        # the static caches and captured decode steps (decode/graphs.py);
        # a list here receives the logits trace of the replayed decode
        self.graphs = DecodeGraphs()
        self.replay_trace: Optional[List] = None

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

    def _layouts(self, questions: Sequence[str]):
        """The questions' prompt layouts, padded to one prompt bucket:
        (layouts, bucket)."""
        ids_list = [tokenize_with_image(self._build_prompt(q),
                                        self.tokenizer) for q in questions]
        n_img = self.cfg.image_tokens
        bucket = self._bucket(max(len(ids) - 1 + n_img for ids in ids_list))
        return [build_layout(ids, bucket, n_long=n_img, n_short=0,
                             image_long=True) for ids in ids_list], bucket

    def _host_towers(self, image) -> Tuple[np.ndarray, np.ndarray]:
        """One patch's tower inputs preprocessed on the host, uint8 (CLIP
        [224, 224, 3] of its expand2square, OWL-ViT [768, 768, 3])."""
        sq, _, _ = expand2square(image)
        return (clip_resize_u8(sq, self.cfg.vision.image_size),
                owlvit_resize_u8(image, self.cfg.owl_vision.image_size))

    def _generate(self, images_clip: torch.Tensor, images_owl: torch.Tensor,
                  lays, bucket: int, rows: Optional[int] = None
                  ) -> VSMOutput:
        """vsm_generate over the B rows of `lays` (tower inputs on the
        device, uint8 or normalized f32), the engine's draft row tiled
        over them; the outputs on the host. The decode stats count the
        first `rows` rows (all by default; the rest pad a batch)."""
        B = len(lays)

        def stack(name):
            return self._to_device(np.stack([getattr(l, name)
                                             for l in lays]))

        draft = None if self._draft_row is None else \
            self._to_device(np.tile(self._draft_row[None], (B, 1)))
        with torch.inference_mode():
            out = vsm_generate(
                self.params, self.cfg, images_clip, images_owl,
                stack("text_ids"), stack("feat_idx"), stack("is_feat"),
                torch.tensor([l.length for l in lays], dtype=torch.int32,
                             device=self.device),
                loc_token_id=self.loc_token_id,
                max_new_tokens=self.max_new_tokens, eos_id=self.eos_id,
                # verify chunks write spec_chunk entries past the frontier
                cache_len=bucket + _round128(self.max_new_tokens
                                             + self.spec_chunk),
                compute_dtype=self.compute_dtype, draft_ids=draft,
                spec_chunk=self.spec_chunk, trace=self.decode_trace,
                graphs=self.graphs, replay_trace=self.replay_trace,
                kv_int8=self.kv_int8)
        out = out._replace(**{k: v.cpu() for k, v in out._asdict().items()
                              if isinstance(v, torch.Tensor)})
        self.last_decode_stats = decode_stats(
            [int(n) for n in out.num_generated[:rows]], out.n_forwards)
        return out

    def _run(self, image, question: str
             ) -> Tuple[VSMOutput, Tuple[int, int]]:
        lays, bucket = self._layouts([question])
        clip, owl = self._host_towers(image)
        out = self._generate(self._to_device(clip[None]),
                             self._to_device(owl[None]), lays, bucket)
        return out, (image.height, image.width)

    def _heatmap(self, out: VSMOutput, size: Tuple[int, int],
                 b: int = 0) -> np.ndarray:
        """Row b's low-res mask logits -> patch size (bilinear,
        half-pixel) -> clamp at 0."""
        if not bool(out.loc_valid[b]):
            return np.zeros(size, np.float32)
        low = out.mask_logits[b].numpy().astype(np.float32)
        return np.clip(resize_bilinear_torch(low, size[0], size[1]), 0.0,
                       None)

    def _detection(self, out: VSMOutput, size: Tuple[int, int], b: int = 0):
        """Row b's (boxes, sigmoid scores, heatmap); empty without [LOC]."""
        if not bool(out.loc_valid[b]):
            return (np.zeros((0, 4), np.float32), np.zeros((0,), np.float32),
                    np.zeros(size, np.float32))
        boxes = out.det_boxes[b].numpy().astype(np.float32)
        logits = 1.0 / (1.0 + np.exp(-out.det_logits[b].numpy()
                                     .astype(np.float32)))
        return boxes, logits, self._heatmap(out, size, b)

    def _answer(self, out: VSMOutput, b: int = 0) -> str:
        n = int(out.num_generated[b])
        toks = [int(t) for t in out.tokens[b, :n]]
        text = self.tokenizer.decode(toks, skip_special_tokens=True)
        return text.replace("\n", "").replace("  ", " ").strip()

    # -- VSMClient protocol ------------------------------------------------

    def detect(self, image, name: str):
        out, size = self._run(image,
                              f"Please locate the {name} in this image.")
        return self._detection(out, size)

    def vqa(self, image, question: str) -> str:
        return self._answer(self._run(image, question)[0])

    def segment(self, image, phrase: str) -> np.ndarray:
        out, size = self._run(image,
                              f"Please locate the {phrase} in this image.")
        return self._heatmap(out, size)
