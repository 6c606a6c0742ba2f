"""What `serve.server --warmup` captures on the card, and whether live
requests then capture anything more.

Builds the random-init 7B pair (bf16; --int4mix for that pair), wraps
the VSM in CompiledVSMSearch with --compiled, and runs warmup_engines at
--max-batch. Then per engine: the decode graphs kept and captured (one
per key, decode/graphs.py), the bytes of its cache slabs, the memory
reserved and allocated, and the warmup's seconds. Then live requests of
every kind the server answers, on 2048x1536 images: an option answer,
a free-form answer, and the search phase of two missing objects in one
image and of one object in each of two images (the compiled search
when --compiled, else the lockstep waves); each logs the captures it
caused, 0 when the warmup covered it. Prints one JSON line and writes
it to chiprun_out/warmup_probe_<max-batch>.json.

    python3 -m vstar_tpu_torch.scripts.warmup_probe --max-batch 16 --compiled
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

import numpy as np
import torch
from PIL import Image


def _memory(dev) -> dict:
    torch.cuda.synchronize(dev)
    return {"reserved_mib": torch.cuda.memory_reserved(dev) / 2**20,
            "allocated_mib": torch.cuda.memory_allocated(dev) / 2**20,
            "max_allocated_mib": torch.cuda.max_memory_allocated(dev)
            / 2**20}


def _graphs(engines) -> dict:
    return {name: {"kept": e.graphs.kept, "captured": e.graphs.captures,
                   "replays": e.graphs.replays,
                   "cache_slabs_mib": e.graphs.cache_bytes() / 2**20}
            for name, e in engines.items()}


def main() -> int:
    p = argparse.ArgumentParser(__doc__.split("\n")[0])
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--compiled", action="store_true")
    p.add_argument("--int4mix", action="store_true")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("warmup_probe: no CUDA device", file=sys.stderr)
        return 1
    from ..eval.batched_bench import run_search_phase
    from ..search.compiled import CompiledVSMSearch
    from ..serve.server import (SealService, random_init_engines,
                                warmup_engines)
    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format="[%(name)s] %(message)s")
    dev = torch.device("cuda:0")
    t0 = time.perf_counter()
    vqa, vsm = random_init_engines("7b", dev, int4mix=args.int4mix,
                                   device_preprocess=args.compiled)
    init_s = time.perf_counter() - t0
    client = CompiledVSMSearch(vsm) if args.compiled else vsm
    engines = {"vqa": vqa, "vsm": vsm}
    out = {"max_batch": args.max_batch, "compiled": args.compiled,
           "int4mix": args.int4mix, "init_s": init_s,
           "after_init": _memory(dev)}
    t0 = time.perf_counter()
    warmup_engines(vqa, client, args.max_batch)
    out["warmup_s"] = time.perf_counter() - t0
    out["graphs"] = _graphs(engines)
    out["after_warmup"] = _memory(dev)
    print(f"[probe] warmup at --max-batch {args.max_batch}: "
          f"{out['warmup_s']:.1f} s, {out['graphs']}, {out['after_warmup']}",
          flush=True)

    rng = np.random.RandomState(0)
    images = [Image.fromarray(rng.randint(0, 255, (1536, 2048, 3),
                                          dtype=np.uint8)) for _ in range(2)]
    service = SealService(vqa, client)
    question = "What is the color of the mug?"
    live = {
        "options": lambda: service.answer(images[0], question,
                                          ["red", "blue", "green"]),
        "free_form": lambda: service.answer(images[0], question),
        "search_two_objects": lambda: run_search_phase(
            client, images[:1], [["red mug", "bicycle"]],
            max_search_steps=3),
        "search_two_images": lambda: run_search_phase(
            client, images, [["red mug"], ["bicycle"]],
            max_search_steps=3)}
    out["live"] = {}
    for name, call in live.items():
        before = {n: e.graphs.captures for n, e in engines.items()}
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize(dev)
        s = time.perf_counter() - t0
        new = {n: e.graphs.captures - before[n] for n, e in engines.items()}
        out["live"][name] = {"s": s, "new_captures": new}
        print(f"[probe] live {name}: {s:.3f} s, new captures {new}",
              flush=True)
    out["graphs_after_live"] = _graphs(engines)
    out["after_live"] = _memory(dev)
    line = json.dumps(out)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(f"chiprun_out/warmup_probe_{args.max_batch}.json", "w") as f:
        f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
