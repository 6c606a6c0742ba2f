"""VQAEngine: host driver for the dual-projector VQA LLM (port of
vstar_tpu/eval/vqa_engine.py).

  * free_form       greedy generation, stopping at '</s>'
  * multiple_choice option with the least mean CE over a shared prefix
  * get_object_crop context-expanded crop preprocessing

Prompts are padded to the same buckets as the JAX engine, so the shapes
the decoder sees match it. Eager PyTorch compiles nothing per shape, so
batches and option counts are not padded to buckets. Free-form decoding
is greedy: the JAX engine's template draft is greedy-equivalent and gives
the same tokens; sampling, stop keywords and prompt lookup are not ported
yet.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from PIL import Image

from ..core.config import VQALLMConfig
from ..data.preprocess import clip_resize_u8
from ..decode.sampler import greedy_decode
from ..decode.scorer import score_options
from ..models.vqa_llm import encode_feature_bank, prefill
from ..multimodal.constants import DEFAULT_IMAGE_TOKEN
from ..multimodal.conversation import CONV_TEMPLATES
from ..multimodal.splicing import build_layout, spliced_length
from ..multimodal.tokenizer import (tokenize_with_image,
                                    tokenize_with_image_and_objects)
from ..nn.llama import init_cache


def get_patch(bbox, image_width, image_height, patch_size=224,
              patch_scale=None):
    """Context-expanded crop box (vstar_bench_eval.py:49-69)."""
    ow = int(np.ceil(bbox[2]))
    oh = int(np.ceil(bbox[3]))
    cx = int(bbox[0] + bbox[2] / 2)
    cy = int(bbox[1] + bbox[3] / 2)
    if patch_scale is None:
        pw, ph = max(ow, patch_size), max(oh, patch_size)
    else:
        pw, ph = int(ow * patch_scale), int(oh * patch_scale)
    left = max(0, cx - pw // 2)
    right = min(left + pw, image_width)
    top = max(0, cy - ph // 2)
    bottom = min(top + ph, image_height)
    return [left, top, right, bottom]


def _round128(n: int) -> int:
    return ((n + 127) // 128) * 128


class VQAEngine:
    CONV_TYPE = "v1"

    def __init__(self, params, cfg: VQALLMConfig, tokenizer, *, device,
                 eos_id: int = 2,
                 prompt_buckets: Tuple[int, ...] = (512, 768, 1024),
                 option_bucket: int = 64, compute_dtype=torch.bfloat16):
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.device = torch.device(device)
        self.eos_id = eos_id
        self.prompt_buckets = tuple(sorted(prompt_buckets))
        self.option_bucket = option_bucket
        self.compute_dtype = compute_dtype

    # -- prompt helpers ------------------------------------------------------

    def _prompt(self, question: str, answer: Optional[str] = None) -> str:
        conv = CONV_TEMPLATES[self.CONV_TYPE]()
        conv.append_message(conv.roles[0],
                            DEFAULT_IMAGE_TOKEN + "\n" + question)
        conv.append_message(conv.roles[1], answer)
        return conv.get_prompt()

    def _tokenize(self, prompt: str) -> List[int]:
        if "<object>" in prompt:
            return tokenize_with_image_and_objects(prompt, self.tokenizer)
        return tokenize_with_image(prompt, self.tokenizer)

    def _bucket(self, n: int) -> int:
        for b in self.prompt_buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt too long: {n}")

    def _layouts(self, questions, images_long, objects_long):
        """Per-row layouts padded to one bucket; returns (layouts, bucket,
        question ids)."""
        rows = []
        for i, q in enumerate(questions):
            il = True if images_long is None or images_long[i] is None \
                else bool(images_long[i][0])
            ol = None if objects_long is None else objects_long[i]
            rows.append((self._tokenize(self._prompt(q)), il, ol))
        bucket = self._bucket(max(
            spliced_length(ids, n_long=self.cfg.image_tokens_long,
                           n_short=self.cfg.image_tokens_short,
                           image_long=il, objects_long=ol)
            for ids, il, ol in rows))
        lays = [build_layout(ids, bucket, n_long=self.cfg.image_tokens_long,
                             n_short=self.cfg.image_tokens_short,
                             image_long=il, objects_long=ol)
                for ids, il, ol in rows]
        return lays, bucket, [ids for ids, _, _ in rows]

    # -- preprocessing -------------------------------------------------------

    def preprocess_image(self, image: Image.Image) -> np.ndarray:
        """-> [S, S, 3] uint8 (exact CLIP PIL geometry; normalized on the
        device)."""
        return clip_resize_u8(image, self.cfg.vision.image_size)

    def get_object_crop(self, image: Image.Image, bbox,
                        patch_scale: float = 1.2) -> np.ndarray:
        """Crop + resize + CLIP geometry (vstar_bench_eval.py:71-76)."""
        box = get_patch(bbox, image.width, image.height,
                        patch_scale=patch_scale)
        size = self.cfg.vision.image_size
        crop = image.crop(tuple(box)).resize((size, size))
        return clip_resize_u8(crop, size)

    def _object_stack(self, object_crops) -> np.ndarray:
        """uint8 crops (get_object_crop) in max_objects slots; empty slots
        are black and never gathered by the layout."""
        M = self.cfg.max_objects
        size = self.cfg.vision.image_size
        out = np.zeros((M, size, size, 3), np.uint8)
        if object_crops is not None:
            for i, c in enumerate(object_crops[:M]):
                out[i] = c
        return out

    def _prefill(self, images, object_crops_list, lays, cache_len):
        """Bank + prefill for rows of equal bucket. Returns (last logits,
        last hidden, cache)."""
        dev = self.device
        img = torch.from_numpy(np.stack(
            [self.preprocess_image(im) for im in images])).to(dev)
        objs = torch.from_numpy(np.stack(
            [self._object_stack(None if object_crops_list is None
                                else object_crops_list[i])
             for i in range(len(images))])).to(dev)
        bank = encode_feature_bank(self.params, self.cfg, img, objs)
        bank = bank.to(self.compute_dtype)
        cache = init_cache(self.cfg.llama, len(lays), cache_len,
                           self.compute_dtype, device=dev)
        lens = torch.tensor([lay.length for lay in lays], dtype=torch.int32,
                            device=dev)

        def stack(name):
            return torch.from_numpy(np.stack(
                [getattr(lay, name) for lay in lays])).to(dev)

        logits, hidden, cache = prefill(
            self.params, self.cfg, bank, stack("text_ids"),
            stack("feat_idx"), stack("is_feat"), lens, cache,
            self.compute_dtype)
        last = hidden[torch.arange(len(lays), device=dev), lens.long() - 1]
        return logits, last, cache

    # -- public API ----------------------------------------------------------

    def free_form(self, image: Image.Image, question: str,
                  object_crops=None, images_long=None, objects_long=None,
                  max_new_tokens: int = 200) -> str:
        """Greedy free-form answer (vstar_bench_eval.py:78-114); `image`
        is already expand2square'd by the caller."""
        lays, bucket, _ = self._layouts(
            [question], None if images_long is None else [images_long],
            None if objects_long is None else [objects_long])
        with torch.inference_mode():
            logits, last, cache = self._prefill(
                [image], None if object_crops is None else [object_crops],
                lays, bucket + _round128(max_new_tokens))
            res = greedy_decode(self.params["llama"], self.cfg.llama, cache,
                                logits, last, max_new_tokens, [self.eos_id],
                                self.compute_dtype)
            n = int(res.num_generated[0])
            toks = [int(t) for t in res.tokens[0, :n].cpu()]
        return self.tokenizer.decode(toks, skip_special_tokens=True).strip()

    def _opt_room(self, max_len: int) -> int:
        """Option chunk width: the option bucket, grown in 16-token steps
        for long options."""
        if max_len <= self.option_bucket:
            return self.option_bucket
        return ((max_len + 15) // 16) * 16

    def multiple_choice_many(self, images, questions, options_list,
                             object_crops_list=None, images_long=None,
                             objects_long=None) -> List[int]:
        """Option scoring across images (rows share the option count)."""
        n_opts = len(options_list[0])
        if any(len(o) != n_opts for o in options_list):
            raise ValueError("every row needs the same number of options")
        lays, bucket, q_ids = self._layouts(questions, images_long,
                                            objects_long)
        opt_ids = [[self._tokenize(self._prompt(questions[b], opt))
                    [len(q_ids[b]):] for opt in options_list[b]]
                   for b in range(len(images))]
        O = self._opt_room(max(len(o) for row in opt_ids for o in row))
        opt_arr = np.zeros((len(images), n_opts, O), np.int32)
        opt_lens = np.ones((len(images), n_opts), np.int32)
        for b, row in enumerate(opt_ids):
            for oi, ids in enumerate(row):
                opt_arr[b, oi, :len(ids)] = ids
                opt_lens[b, oi] = len(ids)
        with torch.inference_mode():
            logits, _, cache = self._prefill(images, object_crops_list,
                                             lays, bucket + O)
            losses, best = score_options(
                self.params["llama"], self.cfg.llama, cache, logits,
                torch.from_numpy(opt_arr).to(self.device),
                torch.from_numpy(opt_lens).to(self.device),
                self.compute_dtype)
        return [int(b) for b in best.cpu()]

    def multiple_choice(self, image: Image.Image, question: str,
                        options: Sequence[str], object_crops=None,
                        images_long=None, objects_long=None) -> int:
        """Option with the least mean CE (vstar_bench_eval.py:116-165)."""
        return self.multiple_choice_many(
            [image], [question], [options],
            None if object_crops is None else [object_crops],
            None if images_long is None else [images_long],
            None if objects_long is None else [objects_long])[0]
