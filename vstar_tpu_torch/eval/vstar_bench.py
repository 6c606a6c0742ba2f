"""V*Bench evaluation loop on the port's engines (partial port of
vstar_tpu/eval/vstar_bench.py, the equivalent of the reference's
vstar_bench_eval.py).

Walks direct_attributes/ and relative_position/, runs the SEAL loop per
image, prints the per-task and overall accuracy with the p50 latency and
images/s, and writes the result JSON in the reference schema. Ported:
`eval_model` (serial, or with --image-batch > 1 the batched loop of
eval/batched_bench.py; --compiled wraps the VSM engine in
search/compiled.CompiledVSMSearch), the phase-swapped run
(--single-chip-phased, eval/phased.py) on engine factories, and
`build_parser`. Not yet: the checkpoint loaders (so the command line and
--single-chip-phased without factories; ROADMAP Queue 1 item 10) and the
mesh (item 12).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from collections import defaultdict

import numpy as np
from PIL import Image

from .seal import seal_answer

LOADERS_NOT_PORTED = (
    "eval_model needs engines: the checkpoint loaders are not ported yet "
    "(ROADMAP Queue 1 item 10); build them with "
    "serve.server.random_init_engines or VQAEngine / VSMEngine")


PHASED_NEEDS_FACTORIES = (
    "--single-chip-phased builds its engines per phase with the checkpoint "
    "loaders, which are not ported yet (ROADMAP Queue 1 item 10); pass "
    "factories=(vqa_factory, vsm_factory) to eval_model")


def _refuse_unported(args) -> None:
    if getattr(args, "mesh", None):
        raise NotImplementedError(
            "--mesh is not ported yet (ROADMAP Queue 1 item 12)")


def _check_engine_flags(args, vqa_engine=None, vsm_engine=None) -> None:
    """--device-preprocess / --compiled / --kv-int8 ask for engines built
    so (the loaders would build them)."""
    engines = [] if vqa_engine is None else [vqa_engine]
    if vsm_engine is not None:
        base = getattr(vsm_engine, "engine", vsm_engine)
        engines.append(base)
        if (getattr(args, "device_preprocess", False)
                or getattr(args, "compiled", False)) \
                and not getattr(base, "device_preprocess", False):
            raise ValueError("--device-preprocess / --compiled: the VSM "
                             "engine was not built with "
                             "device_preprocess=True")
    if getattr(args, "kv_int8", False) and not all(
            getattr(e, "kv_int8", False) for e in engines):
        raise ValueError("--kv-int8: the engines were not built with "
                         "kv_int8=True")


def _eval_phased(args, factories):
    """--single-chip-phased on zero-argument engine factories
    (eval/phased.eval_model_phased), as vstar_tpu runs it on its loaders;
    --compiled wraps each VSM the factory builds."""
    from .phased import eval_model_phased
    vqa_factory, vsm_factory = factories

    def vqa_checked():
        eng = vqa_factory()
        _check_engine_flags(args, vqa_engine=eng)
        return eng

    def vsm_wrapped():
        eng = vsm_factory()
        _check_engine_flags(args, vsm_engine=eng)
        if getattr(args, "compiled", False) and not hasattr(eng, "search"):
            from ..search.compiled import CompiledVSMSearch
            return CompiledVSMSearch(eng)
        return eng

    return eval_model_phased(
        args.benchmark_folder, vqa_checked, vsm_wrapped,
        output_path=args.output_path,
        minimum_size_scale=args.minimum_size_scale,
        minimum_size=args.minimum_size,
        # an explicit --image-batch is honored; unset, vstar_tpu's wave
        batch=getattr(args, "image_batch", None) or 8,
        coresident=getattr(args, "coresident", False))


def eval_model(args, vqa_engine=None, vsm_engine=None, factories=None):
    """The SEAL loop over a V*Bench folder. Returns (results by task,
    per-task correctness lists, per-image latencies in seconds); with
    --image-batch > 1 eval/batched_bench.eval_model_batched runs it, and
    the return is (results by task, None, None), as in vstar_tpu.
    --device-preprocess (and --compiled, which implies it) asks for a
    VSM engine built with device_preprocess=True (the loaders would build
    one), --kv-int8 for engines built with kv_int8=True; --compiled wraps
    the VSM in CompiledVSMSearch, as vstar_tpu wraps its loaded engine.
    --single-chip-phased (with --coresident) runs eval/phased.py on
    `factories` = (vqa_factory, vsm_factory), zero-argument functions
    that build an engine, and returns its (results, per-task correctness, timings)."""
    _refuse_unported(args)
    if getattr(args, "single_chip_phased", False):
        if vqa_engine is not None or vsm_engine is not None:
            raise ValueError("--single-chip-phased builds its own engines "
                             "per phase: pass factories, not engines")
        if factories is None:
            raise NotImplementedError(PHASED_NEEDS_FACTORIES)
        return _eval_phased(args, factories)
    if vqa_engine is None or vsm_engine is None:
        raise NotImplementedError(LOADERS_NOT_PORTED)
    _check_engine_flags(args, vqa_engine, vsm_engine)
    compiled = getattr(args, "compiled", False)
    if compiled and not hasattr(vsm_engine, "search"):
        from ..search.compiled import CompiledVSMSearch
        vsm_engine = CompiledVSMSearch(vsm_engine)
    if (getattr(args, "image_batch", None) or 1) > 1:
        from .batched_bench import eval_model_batched
        return eval_model_batched(args, vqa_engine, vsm_engine,
                                  image_batch=args.image_batch), None, None
    results = {}
    per_type_acc = defaultdict(list)
    all_acc = []
    latencies = []
    for test_type in ["direct_attributes", "relative_position"]:
        results[test_type] = []
        folder = os.path.join(args.benchmark_folder, test_type)
        image_files = [f for f in sorted(os.listdir(folder))
                       if ".json" not in f]
        for image_file in image_files:
            image_path = os.path.join(folder, image_file)
            with open(image_path.rsplit(".", 1)[0] + ".json") as f:
                annotation = json.load(f)
            image = Image.open(image_path).convert("RGB")
            t0 = time.perf_counter()
            record = seal_answer(
                vqa_engine, vsm_engine, image, annotation["question"],
                annotation["options"],
                minimum_size_scale=args.minimum_size_scale,
                minimum_size=args.minimum_size)
            latencies.append(time.perf_counter() - t0)
            record["image"] = image_file
            per_type_acc[test_type].append(record["correct"])
            all_acc.append(record["correct"])
            results[test_type].append(record)
        if per_type_acc[test_type]:
            print(test_type, np.mean(per_type_acc[test_type]))

    if all_acc:
        print(np.mean(all_acc))
        print(f"p50 latency: {np.percentile(latencies, 50):.3f}s  "
              f"throughput: {1.0 / np.mean(latencies):.3f} images/s")

    with open(args.output_path, "w") as f:
        json.dump(results, f, indent=4)
    return results, dict(per_type_acc), latencies


def build_parser() -> argparse.ArgumentParser:
    """vstar_tpu's evaluation flags; those of unported modes are refused
    by eval_model."""
    p = argparse.ArgumentParser(description="V*Bench SEAL evaluation")
    p.add_argument("--vqa-model-path", type=str,
                   default="craigwu/seal_vqa_7b")
    p.add_argument("--vsm-model-path", type=str,
                   default="craigwu/seal_vsm_7b")
    p.add_argument("--conv_type", default="v1", type=str)
    p.add_argument("--benchmark-folder", type=str, default="vstar_bench")
    p.add_argument("--output-path", type=str, default="eval_result.json")
    p.add_argument("--minimum_size_scale", default=4.0, type=float)
    p.add_argument("--minimum_size", default=224, type=int)
    p.add_argument("--mesh", default=None,
                   help="DxFxM device mesh (not ported yet)")
    p.add_argument("--int8", dest="int8", action="store_true",
                   default=None, help="weight-only int8 decoders")
    p.add_argument("--no-int8", dest="int8", action="store_false",
                   default=None, help="keep bf16 decoder weights")
    p.add_argument("--device-preprocess", action="store_true",
                   default=False,
                   help="extract search patches on the device (one canvas "
                        "upload per image)")
    p.add_argument("--image-batch", dest="image_batch", default=None,
                   type=int,
                   help=">1: image groups of this size, their searches in "
                        "lockstep device batches (a BatchedVSMEngine)")
    p.add_argument("--compiled", action="store_true", default=False,
                   help="whole searches as device steps "
                        "(search/compiled.py; implies --device-preprocess, "
                        "no --visualization)")
    p.add_argument("--kv-int8", dest="kv_int8", action="store_true",
                   default=False,
                   help="int8 KV caches with per-(token, head) scales "
                        "(engines built with kv_int8=True)")
    p.add_argument("--int4", dest="int4", action="store_true",
                   default=False, help="group-128 int4 decoders")
    p.add_argument("--int4mix", dest="int4mix", action="store_true",
                   default=False,
                   help="int4 gate/up/lm_head, int8 qkvo/down on the int4 "
                        "side; alone it implies --mixed")
    p.add_argument("--prompt-lookup", dest="prompt_lookup",
                   action="store_true", default=False,
                   help="prompt-lookup drafts for the free-form phase (the "
                        "same tokens)")
    p.add_argument("--single-chip-phased", dest="single_chip_phased",
                   action="store_true", default=False,
                   help="one model resident at a time: free-form over all "
                        "images, one swap to the VSM, all searches, swap "
                        "back, all focus re-asks (eval/phased.py; needs "
                        "engine factories until the loaders are ported)")
    p.add_argument("--coresident", action="store_true", default=False,
                   help="with --single-chip-phased: build both engines up "
                        "front and skip the swaps")
    p.add_argument("--mixed", action="store_true", default=False,
                   help="int8 VQA decoder, int4 VSM decoder, int8 towers")
    return p
