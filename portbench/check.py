"""Whether what the timed path produced is correct: the plain reference
(reference/, f32, TF32 off) run again over a sample of the window's
outputs, once the window has closed and the program's state is freed.

Compared, each against its limit in portbench/limits/<workload>.json:
  vqa_logit_err   the logits behind the served free-form tokens (prefill
                  and decode of the VQA decoder): the reference's lm_head
                  on the program's final hidden states against the
                  reference's logits, largest |difference| over the
                  largest |reference logit| of the row
  vqa_logit_gap   the widest gap by which a served free-form token's
                  logit lies below the reference's best, over the
                  sampled rows
  option_loss_err the largest |program - reference| mean cross-entropy
                  of an option (the focused option scoring)
  vsm_logit_gap   the same gap for the VSM's decoded tokens at every
                  step of the walked searches
  det_logit_err   the detection head's logits: largest |difference| over
                  the largest |reference logit| of the row
  det_box_err     the boxes (cxcywh in [0, 1] of their patch): largest
                  |difference|, over the detect rows and over each walked
                  search's final box in the image's frame, put back into
                  the frame of the reference's final patch
  mask_err        SAM's low-res mask logits: largest |difference| over
                  the largest |reference logit| of the row
  prompt_mismatch focused prompts the program built that differ from
                  the reference's (exact: 0)
  search_mismatch departures from the forced search (exact: 0): over the
                  whole window, a search for each object of each group,
                  each of its expected number of steps, a detect row for
                  each step and no other VSM call; over the walked
                  searches, each visited patch against the one the
                  reference's own heatmaps choose (reference/search.py)
                  and the number of final boxes

The control (`control.py`) computes the same reference in fp8 and reads
each number of the fp8 outputs against the f32 ones: for a gap, the
f32 gap of the token that fp8 puts first.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from .reference import search, text
from .reference.model import Ref, fp8_rows, plain_precision
from .reference.shapes import shapes
from .weights import Source

NAMES = ("vqa_logit_err", "vqa_logit_gap", "option_loss_err", "vsm_logit_gap",
         "det_logit_err", "det_box_err", "mask_err", "prompt_mismatch",
         "search_mismatch")


def _pixels(arrs: List[np.ndarray], device) -> torch.Tensor:
    return torch.from_numpy(np.stack([text.normalize(a) for a in arrs])
                            ).to(device)


def gap(logits: List[torch.Tensor], tokens: List[List[int]]) -> float:
    """The widest (best - logit of the token) over every row's positions."""
    out = 0.0
    for lg, toks in zip(logits, tokens):
        n = len(toks)
        got = lg[torch.arange(n), torch.tensor(toks, device=lg.device)]
        out = max(out, float((lg.max(-1).values - got).max()))
    return out


def gap_stats(logits: List[torch.Tensor], tokens: List[List[int]],
              name: str) -> Dict[str, float]:
    """Beside a widest gap, for the record (not compared): the mean gap
    and the share of positions whose token is not the reference's best."""
    gaps = []
    for lg, toks in zip(logits, tokens):
        n = len(toks)
        got = lg[torch.arange(n), torch.tensor(toks, device=lg.device)]
        gaps.append(lg.max(-1).values - got)
    g = torch.cat(gaps) if gaps else torch.zeros(1)
    return {f"{name}_mean": float(g.mean()),
            f"{name}_flips": float((g > 0).float().mean())}


def rel_err(a, b) -> float:
    """largest |a - b| over the largest |b|."""
    a, b = torch.as_tensor(a).float().cpu(), torch.as_tensor(b).float().cpu()
    return float((a - b).abs().max() / b.abs().max())


class Checker:
    def __init__(self, cfg: Dict, seed: int, device, control: bool = False,
                 served=torch.bfloat16):
        plain_precision()
        self.cfg, self.device = cfg, device
        self.vocab = cfg["vocab_size"] + cfg["added_tokens"]
        self.clip_size = cfg["seal"]["vision"]["image_size"]
        self.owl_size = cfg["seal"]["owl_vision"]["image_size"]
        sh = shapes(cfg)
        q = fp8_rows if control else None
        self.vqa = Ref(Source(seed, sh, device, served, "vqa."), cfg, q)
        self.vsm = Ref(Source(seed, sh, device, served, "vsm."), cfg, q)

    # -- VQA --------------------------------------------------------------

    def _vqa_embeds(self, image, question: str, answer_ids=(),
                    image_long=True, crops=(), objects_long=()):
        """The spliced input of one VQA row: prompt embeddings with the
        image (and object) features at the sentinels, then answer ids."""
        r = self.vqa
        sq, _, _ = text.square(image)
        px = [text.clip_pixels(sq, self.clip_size)] + list(crops)
        feats = r.clip_features(_pixels(px, self.device))
        banks = []
        for j in range(feats.shape[0]):
            long = image_long if j == 0 else bool(objects_long[j - 1])
            f = feats[j:j + 1]
            banks.append(r.dense(f, "proj_image.proj")[0] if long else
                         r.perceiver("proj_object.perceiver", f)[0])
        ids = text.with_sentinels(text.vqa_prompt(question), self.vocab)
        parts, slot = [], 0
        run: List[int] = []
        for t in ids + list(answer_ids):
            if t in (text.IMAGE, text.OBJECT):
                if run:
                    parts.append(r.embed(run))
                    run = []
                parts.append(banks[slot])
                slot += 1
            else:
                run.append(t)
        if run:
            parts.append(r.embed(run))
        return torch.cat(parts)

    def free_form_hiddens(self, rows: List[Dict]) -> List[torch.Tensor]:
        """rows: {'image', 'question', 'tokens'} -> per row the final
        hidden states [n, D] of the positions that chose its n served
        tokens."""
        seqs, spans = [], []
        for r in rows:
            toks = list(r["tokens"])
            e = self._vqa_embeds(r["image"], r["question"], toks)
            seqs.append(e)
            spans.append((e.shape[0] - len(toks) - 1, len(toks)))
        hid = self.vqa.decoder(seqs)
        return [h[s:s + n] for h, (s, n) in zip(hid, spans)]

    def free_form_logits(self, rows: List[Dict]) -> List[torch.Tensor]:
        """rows: {'image', 'question', 'tokens'} -> per row the logits
        [n, V] of the positions that chose its n served tokens."""
        return [self.vqa.logits(h) for h in self.free_form_hiddens(rows)]

    def head_err(self, hiddens: List[torch.Tensor],
                 logits: List[torch.Tensor]) -> float:
        """vqa_logit_err of final hidden states against the reference's
        `logits` of the same positions, both through this lm_head."""
        return max(rel_err(self.vqa.logits(h.float().to(lg.device)), lg)
                   for h, lg in zip(hiddens, logits))

    def option_losses(self, rows: List[Dict]) -> List[float]:
        """rows: {'image', 'question', 'options', 'image_long', 'crops',
        'objects_long'} -> each option's mean cross-entropy, row by row."""
        seqs, spans = [], []
        for r in rows:
            q_ids = text.token_ids(text.vqa_prompt(r["question"]),
                                   self.vocab)
            for opt in r["options"]:
                o_ids = text.token_ids(text.vqa_prompt(r["question"], opt),
                                       self.vocab)[len(q_ids):]
                e = self._vqa_embeds(r["image"], r["question"], o_ids,
                                     r.get("image_long", True),
                                     r.get("crops", ()),
                                     r.get("objects_long", ()))
                seqs.append(e)
                spans.append((e.shape[0] - len(o_ids) - 1, o_ids))
        hid = self.vqa.decoder(seqs)
        out = []
        for h, (s, o_ids) in zip(hid, spans):
            lp = torch.log_softmax(self.vqa.logits(h[s:s + len(o_ids)]), -1)
            out.append(-float(lp[torch.arange(len(o_ids)),
                                 torch.tensor(o_ids)].mean()))
        return out

    # -- VSM --------------------------------------------------------------

    def detect_outputs(self, rows: List[Dict]) -> List[Dict]:
        """rows: {'patch', 'name', 'tokens'} -> per row the decoder's
        logits at the served tokens' positions and the heads' outputs on
        the [LOC] state (generated position 0 where no [LOC] came)."""
        if not rows:
            return []
        r = self.vsm
        seqs, meta = [], []
        for row in rows:
            sq, _, _ = text.square(row["patch"])
            f = r.clip_features(_pixels([text.clip_pixels(sq, self.clip_size)],
                                        self.device))
            bank = r.dense(f, "proj.proj")[0]
            q = f"Please locate the {row['name']} in this image."
            ids = text.with_sentinels(text.vsm_prompt(q), self.vocab)
            k = ids.index(text.IMAGE)
            toks = list(row["tokens"])
            e = torch.cat([r.embed(ids[:k]), bank,
                           r.embed(ids[k + 1:] + toks)])
            seqs.append(e)
            meta.append((e.shape[0] - len(toks) - 1, toks))
        hid = r.decoder(seqs)
        out = []
        for row, h, (s, toks) in zip(rows, hid, meta):
            locs = [i for i, t in enumerate(toks) if t == 3]
            h_det = h[s + (locs[0] if locs else 0)]
            h_seg = h[s + (locs[-1] if locs else 0)]
            fmap = r.owl_feature_map(_pixels(
                [text.owl_pixels(row["patch"], self.owl_size)], self.device))
            logits, boxes = r.owl_heads(fmap, r.text_fc("fc_det",
                                                        h_det[None]))
            mask = r.sam_mask(fmap, r.text_fc("fc_seg", h_seg[None]))
            out.append({"logits": r.logits(h[s:s + len(toks)]),
                        "det_logits": logits[0].cpu(),
                        "det_boxes": boxes[0].cpu(),
                        "mask_logits": mask[0].cpu()})
        return out


def detect_numbers(got: List[Dict], ref: List[Dict],
                   tokens: List[List[int]]) -> Dict[str, float]:
    """The VSM's numbers of outputs `got` against the reference's (none
    read where there are no rows)."""
    if not got:
        return {k: None for k in ("vsm_logit_gap", "det_logit_err",
                                  "det_box_err", "mask_err")}
    return {
        "vsm_logit_gap": gap([r["logits"] for r in ref], tokens),
        **gap_stats([r["logits"] for r in ref], tokens, "vsm_gap"),
        "det_logit_err": max(rel_err(g["det_logits"], r["det_logits"])
                             for g, r in zip(got, ref)),
        "det_box_err": max(float((torch.as_tensor(g["det_boxes"]).float()
                                  - r["det_boxes"]).abs().max())
                           for g, r in zip(got, ref)),
        "mask_err": max(rel_err(g["mask_logits"], r["mask_logits"])
                        for g, r in zip(got, ref)),
    }


def _patch_frame(box, patch) -> np.ndarray:
    """A box [x, y, w, h] in the image as cxcywh in [0, 1] of `patch`."""
    x, y, w, h = (float(v) for v in box)
    px, py, pw, ph = patch
    return np.array([(x - px + w / 2) / pw, (y - py + h / 2) / ph,
                     w / pw, h / ph])


def search_rows(walked: List[Dict]) -> List[Dict]:
    """Every step of the walked searches as a detect row: the patch the
    program visited, cut from the image again, with the program's
    outputs."""
    rows = []
    for s in walked:
        for (x, y, w, h), r in zip(s["path"], s["rows"]):
            rows.append(dict(r, name=s["name"],
                             patch=s["image"].crop((x, y, x + w, y + h))))
    return rows


def walk_searches(walked: List[Dict], ref: List[Dict], forced: Dict,
                  steps: int) -> tuple:
    """The reference's walks of the program's searches on its own
    outputs `ref` (in search_rows' order): (mismatches, final-box
    errors, least margin, share of steps that found a [LOC])."""
    bad, errs, margin, found, n = 0, [], math.inf, 0, 0
    for s in walked:
        mine = ref[n:n + len(s["rows"])]
        n += len(s["rows"])
        loc = [3 in r["tokens"] for r in s["rows"]]
        found += sum(loc)

        def detect(k, mine=mine, loc=loc):
            return (loc[k], mine[k]["det_logits"].numpy(),
                    mine[k]["det_boxes"].numpy(), mine[k]["mask_logits"])
        w = search.walk(s["path"], detect, s["image"].size, steps, forced)
        bad += w["mismatch"] + (not s["complete"])
        margin = min(margin, w["margin"])
        want = [] if w["box"] is None else [w["box"]]
        bad += len(s["boxes"]) != len(want)
        if s["boxes"] and want:
            patch = s["path"][w["final"]]
            errs.append(float(np.abs(_patch_frame(s["boxes"][0], patch)
                                     - _patch_frame(want[0], patch)).max()))
    return bad, errs, margin, found / max(1, n)


def check(checker: Checker, sample: Dict) -> Dict[str, float]:
    """Every number of a driver's sample: {'free_form': rows, 'options':
    rows (with the program's 'losses'), 'search': the walked searches
    (with the program's outputs), 'prompt_mismatch' and
    'search_structure': counts}."""
    values = {"prompt_mismatch": float(sample["prompt_mismatch"])}
    ff = sample["free_form"]
    logits = checker.free_form_logits(ff)
    values["vqa_logit_err"] = checker.head_err([r["hiddens"] for r in ff],
                                               logits)
    values["vqa_logit_gap"] = gap(logits, [r["tokens"] for r in ff])
    values.update(gap_stats(logits, [r["tokens"] for r in ff], "vqa_gap"))
    del logits
    torch.cuda.empty_cache() if torch.cuda.is_available() else None
    opts = sample["options"]
    ref = checker.option_losses(opts)
    got = [float(x) for r in opts for x in r["losses"]]
    values["option_loss_err"] = max(abs(a - b) for a, b in zip(got, ref))
    det = search_rows(sample["search"])
    out = checker.detect_outputs(det)
    values.update(detect_numbers(det, out, [r["tokens"] for r in det]))
    bad, errs, margin, found = walk_searches(
        sample["search"], out, sample["forced"], sample["steps"])
    if values["det_box_err"] is not None:
        values["det_box_err"] = max([values["det_box_err"]] + errs)
    values["search_mismatch"] = float(sample["search_structure"] + bad)
    values["search_found"] = found
    values["search_margin"] = margin if math.isfinite(margin) else None
    return values


def control(cfg: Dict, seed: int, device, sample: Dict,
            served=torch.bfloat16) -> Dict[str, float]:
    """The control's readings of every number: the reference computed in
    fp8 (weights and matmul inputs, one scale a row or column) read
    against the f32 reference on the same prompts and served tokens; a
    gap is the f32 gap of the token fp8 puts first, and vqa_logit_err
    reads fp8's final hidden states through the f32 lm_head, as the
    program's are read."""
    ref = Checker(cfg, seed, device, served=served)
    low = Checker(cfg, seed, device, control=True, served=served)
    ff = sample["free_form"]
    low_ff = [x.argmax(-1).tolist() for x in low.free_form_logits(ff)]
    ref_ff = ref.free_form_logits(ff)
    values = {"vqa_logit_err": ref.head_err(low.free_form_hiddens(ff),
                                            ref_ff),
              "vqa_logit_gap": gap(ref_ff, low_ff), "prompt_mismatch": 0.0,
              "search_mismatch": 0.0,
              **gap_stats(ref_ff, low_ff, "vqa_gap")}
    opts = sample["options"]
    values["option_loss_err"] = max(
        abs(a - b) for a, b in zip(low.option_losses(opts),
                                   ref.option_losses(opts)))
    det = search_rows(sample["search"])
    lo, ro = low.detect_outputs(det), ref.detect_outputs(det)
    values.update(detect_numbers(lo, ro, [x["logits"].argmax(-1).tolist()
                                          for x in lo]))
    return values


def judge(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every limited number read and at or under its limit."""
    return all(values.get(k) is not None and not math.isnan(values[k])
               and values[k] <= limits[k] for k in limits)


def compared(values: Dict[str, float], limits: Dict[str, float]) -> Dict:
    """{name: {'value', 'limit'}} in NAMES order, for the result line."""
    return {k: {"value": values.get(k), "limit": limits[k]}
            for k in NAMES if k in limits}
