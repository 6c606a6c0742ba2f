"""What the drivers share: the forced search and its records, the work of
recorded calls, spans, and the rows the check compares."""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterable, List, Optional, Sequence

from .. import flops
from ..reference import text


@contextlib.contextmanager
def forced_search(forced: Dict, steps: int, spans: List[tuple],
                  searches: List[Dict]):
    """Every search of the SEAL loop run with the mix's forced policy
    (accepts off, the target-cue split pinned) for `steps` steps, by
    wrapping run_grouped_searches where eval/batched_bench calls it. Each
    search phase's (start, end) goes to `spans`, and each search, with
    the patches it visited (the tasks' `path_out`) and its result, to
    `searches`. A search phase that does not pass through here leaves
    its searches unrecorded, which the check counts against the run."""
    import time
    from vstar_tpu_torch.eval import batched_bench
    orig = batched_bench.run_grouped_searches

    def run(engine, tasks, **kw):
        t0 = time.perf_counter()
        paths = [[] for _ in tasks]
        outs = None
        try:
            outs = orig(engine, [dict(t, path_out=p)
                                 for t, p in zip(tasks, paths)],
                        **{**kw, **forced, "max_steps": steps})
            return outs
        finally:
            spans.append((t0, time.perf_counter()))
            for i, t in enumerate(tasks):
                searches.append({"image": t["image"], "name": t["name"],
                                 "path": [[int(v) for v in s.bbox]
                                          for s in paths[i]],
                                 "done": outs is not None})
    batched_bench.run_grouped_searches = run
    try:
        yield
    finally:
        batched_bench.run_grouped_searches = orig


def tokens_long(cfg: Dict) -> int:
    """An image's tokens through the linear projector: CLIP's patches."""
    v = cfg["seal"]["vision"]
    return (v["image_size"] // v["patch_size"]) ** 2


def tokens_short(cfg: Dict) -> int:
    return cfg["seal"]["perceiver"]["num_latents"]


def vqa_length(cfg: Dict, prompt: str, image_long=True,
               objects_long: Optional[Sequence[bool]] = None) -> int:
    """The spliced length of a VQA prompt."""
    vocab = cfg["vocab_size"] + cfg["added_tokens"]
    ids = text.with_sentinels(prompt, vocab)
    n, obj = 0, 0
    for t in ids:
        if t == text.IMAGE:
            n += tokens_long(cfg) if image_long else tokens_short(cfg)
        elif t == text.OBJECT:
            long = bool(objects_long[obj]) if objects_long else False
            n += tokens_long(cfg) if long else tokens_short(cfg)
            obj += 1
        else:
            n += 1
    return n


def option_tokens(cfg: Dict, question: str, option: str) -> int:
    vocab = cfg["vocab_size"] + cfg["added_tokens"]
    return len(text.token_ids(text.vqa_prompt(question, option), vocab)) \
        - len(text.token_ids(text.vqa_prompt(question), vocab))


def _row_flags(ctx, i):
    il = ctx.get("images_long")
    ol = ctx.get("objects_long")
    image_long = True if il is None or il[i] is None else bool(il[i][0])
    objs = None if ol is None else ol[i]
    return image_long, objs


def _towers(work, cfg, image_long, objs):
    n_obj = len(objs or ())
    flops.clip(work, cfg, 1 + n_obj)
    longs = int(image_long) + sum(bool(o) for o in (objs or ()))
    flops.linear_projector(work, cfg, longs)
    flops.perceiver(work, cfg, 1 + n_obj - longs)


def vsm_question(kind: str, t: str) -> str:
    return t if kind == "vqa" else f"Please locate the {t} in this image."


def calls_work(cfg: Dict, calls: Iterable[Dict]) -> flops.Work:
    """The work that the recorded calls' real rows needed."""
    work = flops.Work()
    vocab = cfg["vocab_size"] + cfg["added_tokens"]
    for ctx in calls:
        kind = ctx["kind"]
        if kind == "free_form":
            _, ngen, _ = ctx["decodes"][-1]
            for i, q in enumerate(ctx["questions"]):
                il, objs = _row_flags(ctx, i)
                _towers(work, cfg, il, objs)
                S = vqa_length(cfg, text.vqa_prompt(q), il, objs)
                flops.generate(work, cfg, S, int(ngen[i]))
        elif kind == "options":
            for i, q in enumerate(ctx["questions"]):
                il, objs = _row_flags(ctx, i)
                _towers(work, cfg, il, objs)
                S = vqa_length(cfg, text.vqa_prompt(q), il, objs)
                flops.decoder(work, cfg, 0, S, 1)
                for opt in ctx["options"][i]:
                    O = option_tokens(cfg, q, opt)
                    flops.decoder(work, cfg, S, O, O - 1)
        else:
            for i, t in enumerate(ctx["texts"]):
                flops.clip(work, cfg, 1)
                flops.linear_projector(work, cfg, 1)
                ids = text.with_sentinels(
                    text.vsm_prompt(vsm_question(kind, t)), vocab)
                S = len(ids) - 1 + tokens_long(cfg)
                flops.generate(work, cfg, S, int(ctx["generated"][i]))
                flops.owl_detect(work, cfg)
    return work


def union_seconds(spans: List[tuple]) -> float:
    """Seconds covered by the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for s, e in sorted(spans):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def original(question: str) -> str:
    """The traffic's question inside a focused one (its last line)."""
    return question.split("\n")[-1]


def focus(image, question: str, search_result: List[Dict], size: int):
    """The reference's focused re-ask of a searched row, as
    vstar_bench_eval.py builds it: (question, object crops, image_long,
    objects_long)."""
    names = [r["name"] for r in search_result]
    boxes = [list(r["bbox"]) for r in search_result]
    crops = [text.object_crop(image, b, size) for b in boxes]
    sq, left, top = text.square(image)
    W, H = sq.size
    norm = [[min(max(v, 0.0), 1.0) for v in
             ((b[0] + left) / W, (b[1] + top) / H,
              (b[0] + left + b[2]) / W, (b[1] + top + b[3]) / H)]
            for b in boxes]
    return (text.focus_question(question, names, norm), crops, False,
            [len(names) <= 2] * len(names))


def free_form_rows(calls: List[Dict], questions, images: Dict) -> List[Dict]:
    """The served tokens of the free-form rows asking `questions`, with
    the program's final hidden states that chose them."""
    want, rows = set(questions), []
    for ctx in calls:
        if ctx["kind"] != "free_form":
            continue
        toks, ngen, hid = ctx["decodes"][-1]
        for i, q in enumerate(ctx["questions"]):
            if q in want:
                n = int(ngen[i])
                rows.append({"image": images[q], "question": q,
                             "tokens": toks[i, :n].tolist(),
                             "hiddens": hid[i, :n]})
    return rows


def option_rows(calls: List[Dict], questions, images: Dict,
                results: Dict, size: int) -> tuple:
    """(rows, mismatches): the option rows of the traffic's `questions`,
    each with the program's losses and the reference's own focused
    prompt; `results[q]` is the search_result the record gave (None for
    a row that was not searched)."""
    want, rows, bad = set(questions), [], 0
    for ctx in calls:
        if ctx["kind"] != "options":
            continue
        for i, q in enumerate(ctx["questions"]):
            base = original(q)
            if base not in want:
                continue
            row = {"image": images[base], "options": ctx["options"][i],
                   "losses": ctx["losses"][-1][i].tolist()}
            if results.get(base) is None:
                row.update(question=base)
            else:
                fq, crops, il, ol = focus(images[base], base, results[base],
                                          size)
                row.update(question=fq, crops=crops, image_long=il,
                           objects_long=ol)
            bad += row["question"] != q
            rows.append(row)
    return rows, bad


def _flat(ctx) -> List[tuple]:
    """(output, row) of a kept detect call's real rows, in the call's
    order (a wave above the largest batch runs as several outputs, each
    padded to its batch after its real rows)."""
    flat, left = [], len(ctx["texts"])
    for o in ctx.get("outs", ()):
        k = min(o.tokens.shape[0], left)
        flat += [(o, b) for b in range(k)]
        left -= k
    return flat


def assign_rows(searches: List[Dict], calls: List[Dict]) -> tuple:
    """Which detect row ran which step of which search: (rows, unmatched),
    rows[(search, step)] = (call, row). The searches of a phase advance
    in lockstep, so a call's rows are steps of distinct searches in task
    order; each row is matched, scanning forward, to the next search
    whose next step asks for that name at that patch size. Rows and
    steps left without a partner are counted in `unmatched`."""
    nxt = [0] * len(searches)
    rows, unmatched = {}, 0
    for ctx in calls:
        j = 0
        for r, (name, size) in enumerate(zip(ctx["texts"], ctx["sizes"])):
            while j < len(searches):
                s = searches[j]
                k = nxt[j]
                j += 1
                if k < len(s["path"]) and s["name"] == name and \
                        tuple(s["path"][k][2:]) == tuple(size):
                    rows[(j - 1, k)] = (ctx, r)
                    nxt[j - 1] += 1
                    break
            else:
                unmatched += 1
    unmatched += sum(len(s["path"]) - n for s, n in zip(searches, nxt))
    return rows, unmatched


def search_structure(samples: List[Dict], searches: List[Dict],
                     calls: List[Dict], steps: int) -> tuple:
    """The differences from the forced policy that need no reference,
    over one group: (count, rows). A search for every object the group
    names, each finished with its expected number of detect steps, a
    detect row of the group's calls for each step and no other VSM
    call."""
    from ..reference.search import expected_steps
    want = sorted(o for s in samples for o in s["objects"])
    bad = int(sorted(s["name"] for s in searches) != want)
    for s in searches:
        w, h = s["image"].size
        bad += (not s["done"]) + (len(s["path"]) != expected_steps(w, h,
                                                                   steps))
    detects = [c for c in calls if c["kind"] == "detect"]
    bad += len([c for c in calls if c["kind"] in ("vqa", "segment")])
    rows, unmatched = assign_rows(searches, detects)
    return bad + unmatched, rows


def search_sample(samples: List[Dict], records: List[Dict],
                  searches: List[Dict], rows: Dict, rng, n: int
                  ) -> List[Dict]:
    """`n` searches of a group drawn from `rng`, each with its image, its
    visited patches, each step's detect row (served tokens and raw
    outputs) and the final boxes the program reported for its object."""
    by_image = {id(s["image"]): r for s, r in zip(samples, records)}
    out = []
    for i in sorted(rng.permutation(len(searches))[:n].tolist()):
        s = searches[i]
        steps = []
        for k in range(len(s["path"])):
            if (i, k) not in rows:
                break
            ctx, r = rows[(i, k)]
            flat = _flat(ctx)
            if r >= len(flat):
                break
            o, b = flat[r]
            g = int(o.num_generated[b])
            steps.append({"tokens": o.tokens[b, :g].tolist(),
                          "det_logits": o.det_logits[b],
                          "det_boxes": o.det_boxes[b],
                          "mask_logits": o.mask_logits[b]})
        rec = by_image.get(id(s["image"]))
        boxes = [list(x["bbox"]) for x in (rec or {}).get(
            "search_result") or () if x["name"] == s["name"]]
        out.append({"image": s["image"], "name": s["name"],
                    "path": s["path"][:len(steps)], "rows": steps,
                    "boxes": boxes, "complete": len(steps) == len(s["path"])
                    and rec is not None})
    return out
