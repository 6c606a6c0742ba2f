"""VQAEngine: host driver for the dual-projector VQA LLM (port of
vstar_tpu/eval/vqa_engine.py).

  * free_form       generation stopping at '</s>' (and optional stop
                    keywords): prompt-lookup or template-speculative
                    decode at temperature 0, else greedy or sampled
  * free_form_many  free_form over a batch of images
  * multiple_choice option with the least mean CE over a shared prefix
  * get_object_crop context-expanded crop preprocessing

Prompts are padded to the same buckets as the JAX engine, and free-form
batches to its batch buckets, so the shapes the decoder sees match it.
Eager PyTorch compiles nothing per shape, so option scoring does not pad
batches or option counts. The drafts change the number of decoder
forwards, never the tokens (decode/speculative.py).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from PIL import Image

from ..core.config import VQALLMConfig
from ..data.preprocess import clip_resize_u8
from ..decode.graphs import DecodeGraphs
from ..decode.sampler import decode_stats, greedy_decode
from ..decode.scorer import score_options
from ..decode.speculative import lookup_decode, speculative_decode
from ..models.vqa_llm import decode_step, encode_feature_bank, prefill
from ..multimodal.constants import DEFAULT_IMAGE_TOKEN
from ..multimodal.conversation import CONV_TEMPLATES
from ..multimodal.splicing import build_layout, spliced_length
from ..multimodal.tokenizer import (tokenize_with_image,
                                    tokenize_with_image_and_objects)


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
    # The trigger sentence is a fixed training template
    # (vstar_bench_eval.py:180): the default free-form draft.
    SPEC_TEMPLATE = ("Sorry, I can not answer the question. Some visual "
                     "information about the following objects is missing "
                     "or unclear:")
    BATCH_BUCKETS = (1, 2, 4, 8, 16)

    def __init__(self, params, cfg: VQALLMConfig, tokenizer, *, device,
                 eos_id: int = 2,
                 prompt_buckets: Tuple[int, ...] = (512, 768, 1024),
                 option_bucket: int = 64, compute_dtype=torch.bfloat16,
                 speculative_template: Optional[str] = None,
                 prompt_lookup: bool = False, kv_int8: bool = False):
        """speculative_template None takes SPEC_TEMPLATE, as the JAX
        engine does (set `_spec_template = None` for plain greedy).
        prompt_lookup: n-gram drafts from the prompt and the answer so far
        (decode/speculative.lookup_decode) in place of the template, at
        temperature 0. Sampling draws from the engine's own generator,
        seeded 0 at construction (vstar_tpu's PRNGKey(0)).
        kv_int8: int8 KV caches with per-(token, head) scales
        (nn/llama.KVCache), for free-form decode and option scoring."""
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.device = torch.device(device)
        self.eos_id = eos_id
        self.prompt_buckets = tuple(sorted(prompt_buckets))
        self.option_bucket = option_bucket
        self.compute_dtype = compute_dtype
        self._spec_template = (self.SPEC_TEMPLATE
                               if speculative_template is None
                               else speculative_template)
        self.spec_chunk = 8
        self.prompt_lookup = prompt_lookup
        self.kv_int8 = kv_int8
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(0)
        # decode stats of the last free-form call (decode_stats), None
        # before the first; a list here receives the decoder's logits
        # trace (greedy_decode's `trace`)
        self.last_decode_stats = None
        self.decode_trace: Optional[List] = None
        # the static caches and captured decode steps (decode/graphs.py);
        # a list here receives the logits trace of the replayed decode
        self.graphs = DecodeGraphs()
        self.replay_trace: Optional[List] = None

    def _record_decode_stats(self, ngen_rows, n_forwards: int):
        self.last_decode_stats = decode_stats(ngen_rows, n_forwards)

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

    def _object_stack(self, object_crops, slots: int) -> np.ndarray:
        """uint8 crops (get_object_crop) in `slots` slots; empty slots are
        black and never gathered by the layout."""
        size = self.cfg.vision.image_size
        out = np.zeros((slots, size, size, 3), np.uint8)
        if object_crops is not None:
            for i, c in enumerate(object_crops):
                out[i] = c
        return out

    def _prefill(self, images, object_crops_list, lays, cache_len):
        """Bank + prefill for rows of equal bucket. Returns (last logits,
        last hidden, cache)."""
        dev = self.device
        img = torch.from_numpy(np.stack(
            [self.preprocess_image(im) for im in images])).to(dev)
        crops = [None] * len(images) if object_crops_list is None \
            else object_crops_list
        # max_objects slots, or one per crop when a focus prompt names
        # more objects (vstar_tpu keeps max_objects: its gather then reads
        # past the bank and splices NaN; ROADMAP Queue 3)
        slots = max([self.cfg.max_objects]
                    + [len(c) for c in crops if c is not None])
        objs = torch.from_numpy(np.stack(
            [self._object_stack(c, slots) for c in crops])).to(dev)
        bank = encode_feature_bank(self.params, self.cfg, img, objs)
        bank = bank.to(self.compute_dtype)
        cache = self.graphs.cache(self.cfg.llama, len(lays), cache_len,
                                  self.compute_dtype, dev,
                                  kv_int8=self.kv_int8)
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

    # -- free-form decoding --------------------------------------------------

    def _template_draft(self, max_new_tokens: int) -> np.ndarray:
        """The template's tokens (no BOS) in an eos-filled draft row
        max_new_tokens + spec_chunk wide."""
        ids = self.tokenizer(self._spec_template).input_ids
        if ids and ids[0] == self.tokenizer.bos_token_id:
            ids = ids[1:]
        row = np.full(max_new_tokens + self.spec_chunk, self.eos_id,
                      np.int32)
        row[:min(len(ids), len(row))] = ids[:len(row)]
        return row

    def _free_form_rows(self, images, object_crops_list, lays, bucket: int,
                        max_new_tokens: int, n: int, temperature=0.0,
                        top_p=None, use_lookup: bool = False,
                        use_spec: bool = False) -> List[str]:
        """Prefill and decode rows of one bucket; the texts of the first n
        (the rest pad a batch bucket)."""
        dev = self.device
        sampling = temperature > 0.0
        # verify chunks write spec_chunk KV entries past the frontier, so
        # the room grows by the chunk before rounding
        room = max_new_tokens + (self.spec_chunk
                                 if use_lookup or use_spec else 0)
        with torch.inference_mode():
            logits, last, cache = self._prefill(
                images, object_crops_list, lays, bucket + _round128(room))
            args = (self.params["llama"], self.cfg.llama, cache, logits,
                    last)
            if use_lookup:
                # the prompt's text tokens; image-feature slots can never
                # match
                ctx = np.stack([np.where(lay.is_feat, -1, lay.text_ids)
                                for lay in lays]).astype(np.int32)
                res = lookup_decode(
                    *args, torch.from_numpy(ctx).to(dev),
                    torch.tensor([lay.length for lay in lays],
                                 dtype=torch.int32, device=dev),
                    max_new_tokens, [self.eos_id], self.spec_chunk,
                    self.compute_dtype, trace=self.decode_trace,
                    graphs=self.graphs, replay_trace=self.replay_trace)
            elif use_spec:
                draft = np.tile(self._template_draft(max_new_tokens)[None],
                                (len(lays), 1))
                res = speculative_decode(
                    *args, torch.from_numpy(draft).to(dev), max_new_tokens,
                    [self.eos_id], self.spec_chunk, self.compute_dtype,
                    trace=self.decode_trace, graphs=self.graphs,
                    replay_trace=self.replay_trace)
            else:
                res = greedy_decode(
                    *args, max_new_tokens, [self.eos_id], self.compute_dtype,
                    temperature=temperature if sampling else 0.0,
                    top_p=top_p if sampling else None,
                    generator=self.generator, trace=self.decode_trace,
                    graphs=self.graphs, replay_trace=self.replay_trace)
            ngen = res.num_generated[:n].tolist()
            tokens = res.tokens[:n].tolist()
        self._record_decode_stats(ngen, res.n_forwards)
        return [self.tokenizer.decode(row[:k], skip_special_tokens=True)
                .strip() for row, k in zip(tokens, ngen)]

    def _free_form_keywords(self, image, question, object_crops,
                            images_long, objects_long, max_new_tokens,
                            stop_keywords, chunk: int = 8,
                            temperature: float = 0.0, top_p=None) -> str:
        """Decode (greedy, or sampled when temperature > 0) in chunks of
        `chunk` tokens, check the decoded text on the host after each,
        stop at the first keyword and strip it
        (KeywordsStoppingCriteria, mm_utils.py:123-148;
        vstar_bench_eval.py:104-113)."""
        lays, bucket, _ = self._layouts(
            [question], None if images_long is None else [images_long],
            None if objects_long is None else [objects_long])
        sampling = temperature > 0.0
        toks: List[int] = []

        def text():
            return self.tokenizer.decode(
                [t for t in toks if t != self.eos_id],
                skip_special_tokens=True).strip()

        with torch.inference_mode():
            logits, hidden, cache = self._prefill(
                [image], None if object_crops is None else [object_crops],
                lays, bucket + _round128(max_new_tokens + chunk))
            while len(toks) < max_new_tokens:
                k = min(chunk, max_new_tokens - len(toks))
                res = greedy_decode(
                    self.params["llama"], self.cfg.llama, cache, logits,
                    hidden, k, [self.eos_id], self.compute_dtype,
                    temperature=temperature if sampling else 0.0,
                    top_p=top_p if sampling else None,
                    generator=self.generator, graphs=self.graphs)
                # the continuation: logits and cache after the k-th token
                logits, hidden, cache = decode_step(
                    self.params, self.cfg, res.cache,
                    res.tokens[:, k - 1:k], self.compute_dtype)
                got = res.tokens[0, :int(res.num_generated[0])].tolist()
                toks.extend(got)
                stop_kw = next((kw for kw in stop_keywords
                                if kw in text()), None)
                if stop_kw is not None:
                    return text().split(stop_kw)[0].strip()
                if got and got[-1] == self.eos_id:
                    return text()
        return text()

    # -- public API ----------------------------------------------------------

    def free_form(self, image: Image.Image, question: str,
                  object_crops=None, images_long=None, objects_long=None,
                  max_new_tokens: int = 200, temperature: float = 0.0,
                  top_p=None, stop_keywords: Optional[Sequence[str]] = None
                  ) -> str:
        """Free-form answer (vstar_bench_eval.py:78-114); `image` is
        already expand2square'd by the caller. At temperature 0 it drafts
        by prompt lookup when enabled, else from the template (greedy
        tokens either way); above 0 it samples. stop_keywords: decoded-
        text stop strings beyond eos."""
        if stop_keywords:
            return self._free_form_keywords(
                image, question, object_crops, images_long, objects_long,
                max_new_tokens, stop_keywords, temperature=temperature,
                top_p=top_p)
        lays, bucket, _ = self._layouts(
            [question], None if images_long is None else [images_long],
            None if objects_long is None else [objects_long])
        use_lookup = temperature <= 0.0 and self.prompt_lookup
        use_spec = (not use_lookup and temperature <= 0.0
                    and self._spec_template is not None)
        return self._free_form_rows(
            [image], None if object_crops is None else [object_crops], lays,
            bucket, max_new_tokens, 1, temperature, top_p, use_lookup,
            use_spec)[0]

    def _batch_bucket(self, n: int) -> int:
        return next((b for b in self.BATCH_BUCKETS if n <= b),
                    self.BATCH_BUCKETS[-1])

    def free_form_many(self, images, questions, object_crops_list=None,
                       images_long=None, objects_long=None,
                       max_new_tokens: int = 200) -> List[str]:
        """free_form (temperature 0) over many images in one batch, padded
        with copies of the first row to a batch bucket; waves above the
        largest bucket are split. object_crops_list / images_long /
        objects_long are per-row lists (None entries take the
        defaults)."""
        n = len(images)
        max_bb = self.BATCH_BUCKETS[-1]
        if n > max_bb:
            def part(x, a, b):
                return None if x is None else x[a:b]
            out = []
            for a in range(0, n, max_bb):
                b = min(a + max_bb, n)
                out.extend(self.free_form_many(
                    images[a:b], questions[a:b],
                    part(object_crops_list, a, b), part(images_long, a, b),
                    part(objects_long, a, b), max_new_tokens))
            return out
        lays, bucket, _ = self._layouts(questions, images_long, objects_long)
        crops = [None] * n if object_crops_list is None \
            else list(object_crops_list)
        pad = self._batch_bucket(n) - n
        images = list(images) + [images[0]] * pad
        lays = lays + [lays[0]] * pad
        crops = crops + [crops[0]] * pad
        use_spec = not self.prompt_lookup and self._spec_template is not None
        return self._free_form_rows(images, crops, lays, bucket,
                                    max_new_tokens, n,
                                    use_lookup=self.prompt_lookup,
                                    use_spec=use_spec)

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


def warmup_vqa_engine(engine: VQAEngine, image_size: int = 256,
                      batch_buckets=(1, 2, 4, 8),
                      max_new_tokens: int = 200, log=print,
                      sampling: bool = False):
    """Run free-form and option scoring once per (batch bucket x prompt
    bucket) before live traffic (serve.server --warmup), at the
    max_new_tokens live traffic passes (free_form's default 200).
    Eager PyTorch compiles nothing; on the card this builds the kernels
    on first use and warms cuBLAS and the caching allocator at each
    shape. sampling: one sampled free-form answer as well."""
    from ..search.batched import _filler_for_bucket

    def length_of(q):
        return spliced_length(engine._tokenize(engine._prompt(q)),
                              n_long=engine.cfg.image_tokens_long,
                              n_short=engine.cfg.image_tokens_short,
                              image_long=True)

    texts = ["what is this ?"]
    lo = engine.prompt_buckets[0]
    for b in engine.prompt_buckets[1:]:
        t = _filler_for_bucket(length_of, lo, b)
        if t is not None:
            texts.append(t)
        elif log:
            log(f"[warmup] vqa prompt bucket {b} unreachable by filler "
                f"text: the first live prompt in ({lo}, {b}] warms it")
        lo = b

    rng = np.random.RandomState(0)
    img = Image.fromarray((rng.rand(image_size, image_size, 3)
                           * 255).astype("uint8"))
    opts = ["a thing", "another"]
    # the largest caches first: the smaller ones are views of their slab
    # (decode/graphs.py)
    for bb in sorted(batch_buckets, reverse=True):
        for q in reversed(texts):
            engine.free_form_many([img] * bb, [q] * bb,
                                  max_new_tokens=max_new_tokens)
            engine.multiple_choice_many([img] * bb, [q] * bb, [opts] * bb)
        if log:
            log(f"[warmup] vqa B={bb} ({len(texts)} prompt buckets) "
                f"warmed")
    if sampling:
        engine.free_form(img, texts[0], max_new_tokens=max_new_tokens,
                         temperature=0.7, top_p=0.9)
        if log:
            log("[warmup] vqa sampled decode warmed")
