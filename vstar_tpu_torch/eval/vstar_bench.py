"""V*Bench evaluation on the port's engines (port of
vstar_tpu/eval/vstar_bench.py, the equivalent of the reference's
vstar_bench_eval.py).

    python -m vstar_tpu_torch.eval.vstar_bench \\
        --vqa-model-path <hf dir> --vsm-model-path <hf dir> \\
        --benchmark-folder vstar_bench --output-path eval_result.json

The loaders build the engines from HF checkpoint directories
(core/checkpoint.load_torch_dir, the importers, the tokenizer through
multimodal/tokenizer.load_tokenizer unless one is given) on a device, in
bf16 unless --int8 / --int4 / --int4mix ask for quantized decoders (int8
towers then). vstar_tpu defaults to int8 on one TPU chip, because the
bf16 pair does not fit its 16 GB; the 80 GB card holds it.

`eval_model` walks direct_attributes/ and relative_position/, runs the
SEAL loop per image, prints the per-task and overall accuracy with the
p50 latency and images/s, and writes the result JSON in the reference
schema; with --image-batch > 1 eval/batched_bench.py runs the loop,
--compiled wraps the VSM in search/compiled.CompiledVSMSearch, and
--single-chip-phased runs eval/phased.py on engine factories (the
loaders' unless given).

--mesh DxFxM (under torchrun, one rank per card) shards both models over
a core/mesh.Mesh: each engine keeps its decoder's layer stack split on
the hidden axis over fsdp (activations all-reduced) and tensor-parallel
on the model axis (core/mesh.serving_params). Every
rank runs the same loop over the same images and computes the same
answers; rank 0 alone prints and writes the result file.

    torchrun --nproc-per-node 2 -m vstar_tpu_torch.eval.vstar_bench \
        --vqa-model-path <dir> --vsm-model-path <dir> --mesh 1x2x1
"""

from __future__ import annotations

import argparse
import json
import os
import time
from collections import defaultdict

import numpy as np
import torch
from PIL import Image

from ..core.mesh import is_main_process, rank_device
from .seal import seal_answer


def resolve_mesh(mesh, device="cuda"):
    """None | 'DxFxM' | Mesh -> None | Mesh of this world
    (core/mesh.resolve_mesh: the shape's product must be the world size;
    a process without torchrun has a world of one)."""
    if mesh is None:
        return None
    from ..core.mesh import resolve_mesh as _resolve
    return _resolve(mesh, rank_device(device))


def _quantize_llm(int8, int4):
    """The importers' quantize_llm for the loaders' flags: int4 (True, or
    the string 'int4mix') over int8; None and False keep bf16."""
    if int4:
        return int4 if isinstance(int4, str) else "int4"
    return bool(int8)


def _checkpoint_dir(path: str) -> str:
    if not os.path.isdir(path):
        raise FileNotFoundError(f"{path}: no such checkpoint directory (the "
                                "port reads local HF directories only)")
    return path


def _load_params(path, importer, cfg, device, int8, int4):
    from ..core.checkpoint import load_torch_dir
    from ..nn.quant import quantize_model_towers
    quant = _quantize_llm(int8, int4)
    # the state_dict is read onto the device shard by shard and dropped
    # once imported
    params = importer(load_torch_dir(path, device), cfg,
                      dtype=torch.bfloat16, quantize_llm=quant)
    return quantize_model_towers(params) if quant else params


def load_vqa_engine(vqa_model_path: str, conv_type: str = "v1", mesh=None,
                    int8=None, device="cuda", kv_int8: bool = False,
                    prompt_lookup: bool = False, int4=False,
                    tokenizer=None):
    """The VQA LLM from an HF checkpoint directory; its shape follows the
    directory's config.json (7B without one), as the reference's
    from_pretrained path does (builder.py:26-151). int8: per-channel int8
    decoder; int4: group-128 int4 (kernels K5/K6), or the string
    'int4mix' for the per-matrix int4/int8 split; either also int8s the
    tower. tokenizer None loads the directory's. mesh: None, 'DxFxM' or
    a Mesh to shard the model over (the engine's mesh=); the device is
    then this rank's card."""
    from ..core.hf_config import vqa_llm_config_for
    from ..models.vqa_llm import vqa_llm_params_from_torch
    from ..multimodal.tokenizer import load_tokenizer
    from .vqa_engine import VQAEngine
    device = rank_device(device)
    mesh = resolve_mesh(mesh, device)
    cfg = vqa_llm_config_for(_checkpoint_dir(vqa_model_path))
    tok = tokenizer if tokenizer is not None else \
        load_tokenizer(vqa_model_path)
    params = _load_params(vqa_model_path, vqa_llm_params_from_torch, cfg,
                          device, int8, int4)
    return VQAEngine(params, cfg, tok, device=device, conv_type=conv_type,
                     kv_int8=kv_int8, prompt_lookup=prompt_lookup, mesh=mesh)


def load_vsm_engine(vsm_model_path: str, device_preprocess: bool = False,
                    mesh=None, int8=None, device="cuda",
                    kv_int8: bool = False, int4=False, tokenizer=None):
    """The VSM from an HF checkpoint directory, as the lockstep
    search/batched.BatchedVSMEngine (the search-mechanism evaluation needs
    only this half, visual_search.py:142); its [LOC] id is the
    tokenizer's. device_preprocess: search patches cut from a device
    canvas of the image. Quantization and mesh as load_vqa_engine."""
    from ..core.hf_config import vsm_config_for
    from ..models.vsm import vsm_params_from_torch
    from ..multimodal.tokenizer import load_tokenizer
    from ..search.batched import BatchedVSMEngine
    device = rank_device(device)
    mesh = resolve_mesh(mesh, device)
    cfg = vsm_config_for(_checkpoint_dir(vsm_model_path))
    tok = tokenizer if tokenizer is not None else \
        load_tokenizer(vsm_model_path)
    loc_id = tok("[LOC]", add_special_tokens=False).input_ids[0]
    params = _load_params(vsm_model_path, vsm_params_from_torch, cfg,
                          device, int8, int4)
    return BatchedVSMEngine(params, cfg, tok, loc_token_id=loc_id,
                            device=device,
                            device_preprocess=device_preprocess,
                            kv_int8=kv_int8, mesh=mesh)


def load_engines(vqa_model_path: str, vsm_model_path: str,
                 conv_type: str = "v1", mesh=None, int8=None,
                 device_preprocess: bool = False, kv_int8: bool = False,
                 prompt_lookup: bool = False, int4=False, device="cuda",
                 tokenizer=None):
    """Both models from HF checkpoint directories, on one device (the
    80 GB card holds the bf16 pair, so vstar_tpu's two-chip split has no
    counterpart), or sharded over `mesh` (both on one Mesh)."""
    mesh = resolve_mesh(mesh, device)
    return (load_vqa_engine(vqa_model_path, conv_type, mesh=mesh, int8=int8,
                            device=device, kv_int8=kv_int8,
                            prompt_lookup=prompt_lookup, int4=int4,
                            tokenizer=tokenizer),
            load_vsm_engine(vsm_model_path, mesh=mesh, int8=int8,
                            device_preprocess=device_preprocess,
                            device=device, kv_int8=kv_int8, int4=int4,
                            tokenizer=tokenizer))


def _phased_factories(args, device="cuda", tokenizer=None):
    """--single-chip-phased's engine factories on the loaders, with
    vstar_tpu's flag resolution: --int4mix alone implies --mixed (an int8
    VQA decoder, the int4mix VSM decoder); --int4 quantizes both."""
    int4 = getattr(args, "int4", False)
    int4mix = getattr(args, "int4mix", False)
    mixed = getattr(args, "mixed", False) or (int4mix and not int4)
    int4mode = "int4mix" if int4mix else True
    kv_int8 = getattr(args, "kv_int8", False)

    def vqa_factory():
        return load_vqa_engine(
            args.vqa_model_path, args.conv_type,
            int8=True if mixed else getattr(args, "int8", None),
            device=device, kv_int8=kv_int8,
            prompt_lookup=getattr(args, "prompt_lookup", False),
            int4=int4mode if (int4 and not mixed) else False,
            tokenizer=tokenizer)

    def vsm_factory():
        return load_vsm_engine(
            args.vsm_model_path,
            device_preprocess=getattr(args, "device_preprocess", False)
            or getattr(args, "compiled", False),
            int8=getattr(args, "int8", None), device=device,
            kv_int8=kv_int8,
            int4=int4mode if (int4 or mixed) else False,
            tokenizer=tokenizer)

    return vqa_factory, vsm_factory


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


def eval_model(args, vqa_engine=None, vsm_engine=None, factories=None,
               device="cuda", tokenizer=None):
    """The SEAL loop over a V*Bench folder. Returns (results by task,
    per-task correctness lists, per-image latencies in seconds); with
    --image-batch > 1 eval/batched_bench.eval_model_batched runs it, and
    the return is (results by task, None, None), as in vstar_tpu.

    Without engines it loads both from --vqa-model-path / --vsm-model-path
    on `device` (load_engines with the flags; `tokenizer` None loads each
    directory's). Given engines must have been built as the flags ask:
    --device-preprocess (and --compiled, which implies it) a VSM engine
    with device_preprocess=True, --kv-int8 engines with kv_int8=True;
    --compiled wraps the VSM in CompiledVSMSearch, as vstar_tpu wraps its
    loaded engine. --single-chip-phased (with --coresident) runs
    eval/phased.py on `factories` = (vqa_factory, vsm_factory),
    zero-argument functions that build an engine (the loaders'
    loaders unless given), and returns its (results, per-task
    correctness, timings)."""
    mesh = getattr(args, "mesh", None)
    if getattr(args, "single_chip_phased", False):
        if mesh:
            raise ValueError("--single-chip-phased keeps one model on one "
                             "card at a time; it takes no --mesh")
        if vqa_engine is not None or vsm_engine is not None:
            raise ValueError("--single-chip-phased builds its own engines "
                             "per phase: pass factories, not engines")
        if factories is None:
            factories = _phased_factories(args, device, tokenizer)
        return _eval_phased(args, factories)
    if (vqa_engine is None) != (vsm_engine is None):
        raise ValueError("eval_model takes both engines or neither")
    if vqa_engine is None:
        int4 = getattr(args, "int4", False)
        int4mix = getattr(args, "int4mix", False)
        vqa_engine, vsm_engine = load_engines(
            args.vqa_model_path, args.vsm_model_path, args.conv_type,
            mesh=mesh, int8=getattr(args, "int8", None),
            device_preprocess=getattr(args, "device_preprocess", False)
            or getattr(args, "compiled", False),
            kv_int8=getattr(args, "kv_int8", False),
            prompt_lookup=getattr(args, "prompt_lookup", False),
            int4=("int4mix" if int4mix else True) if (int4 or int4mix)
            else False, device=device, tokenizer=tokenizer)
    elif mesh:
        raise ValueError("--mesh: given engines are built with their own "
                         "mesh= (or none)")
    _check_engine_flags(args, vqa_engine, vsm_engine)
    main_rank = is_main_process()
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
        if per_type_acc[test_type] and main_rank:
            print(test_type, np.mean(per_type_acc[test_type]))

    if all_acc and main_rank:
        print(np.mean(all_acc))
        print(f"p50 latency: {np.percentile(latencies, 50):.3f}s  "
              f"throughput: {1.0 / np.mean(latencies):.3f} images/s")

    if main_rank:
        with open(args.output_path, "w") as f:
            json.dump(results, f, indent=4)
    return results, dict(per_type_acc), latencies


def build_parser() -> argparse.ArgumentParser:
    """vstar_tpu's evaluation flags."""
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
                   help="DxFxM device mesh over the torchrun ranks to shard"
                        " both models over, e.g. 1x2x1")
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
                        "back, all focus re-asks (eval/phased.py)")
    p.add_argument("--coresident", action="store_true", default=False,
                   help="with --single-chip-phased: build both engines up "
                        "front and skip the swaps")
    p.add_argument("--mixed", action="store_true", default=False,
                   help="int8 VQA decoder, int4 VSM decoder, int8 towers")
    return p


def main(argv=None, device="cuda", tokenizer=None):
    """The command line: eval_model on the loaded pair (on the card unless
    `device` says otherwise)."""
    return eval_model(build_parser().parse_args(argv), device=device,
                      tokenizer=tokenizer)


if __name__ == "__main__":
    main()
