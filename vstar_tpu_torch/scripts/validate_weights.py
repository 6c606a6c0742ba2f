"""One command for real seal checkpoints, the day they arrive (port of the
JAX package's scripts/validate_weights.py, step for step).

Given HF checkpoint directories of seal_vqa_7b and / or seal_vsm_7b:
  1. the strict key audit of each state dict through the importers (every
     present key consumed or skippable by design, nothing missing); a
     32-layer decoder whose import stopped or missed keys is also audited
     against the committed 7B manifest, with the full lists;
  2. both engines loaded (shapes from the directory's config.json), and
     every inference surface on a synthetic 640x480 image: VQA free-form,
     multiple choice and the prompt-lookup rerun (the same answer), VSM
     detect and vqa, one guided search, and the compiled search on a
     device-preprocess engine that shares the loaded engine's tensors;
  3. --sweep: eval/flag_matrix.run_flag_matrix over every opt-in
     (flag_matrix.json);
  4. --runner-sweep: eval/flag_matrix.run_runner_matrix over the
     residency modes, after the smoke pair is freed (runner_matrix.json);
  5. otherwise, with --benchmark-folder and both paths, eval_model on the
     loaded pair (eval_result.json).
The JSON files go to the working directory.

    python -m vstar_tpu_torch.scripts.validate_weights \\
        --vqa-model-path <dir> --vsm-model-path <dir> [--int8 --sweep] \\
        [--runner-sweep --benchmark-folder <dir>]

Exit code 0: every key accounted for and every surface live on the card.
Accuracy needs the benchmark folder. Where the port differs from the JAX
script: the loaders' default stays bf16 (--int8 asks for int8 decoders and
towers; the JAX default of int8 is its 16 GB chip's); the runner sweep's
mixed and int4mix cells load their VQA in int8 explicitly (the JAX
factories got int8 from that default); act-int8 acts only on quantized
entries, so the w8a8 cells equal base on bf16 weights (run --int8 --sweep
to measure what the JAX single-chip sweep measures); --runner-sweep's
arguments are checked before the audit. A surface that raises fails the
command, and so does a sweep's cell that raised (or, in the runner sweep,
measured no accuracy): the sweeps keep going past it, as in the JAX
script, but the verdict is FAILED.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from typing import Dict, Optional

import numpy as np
import torch
from PIL import Image

FREE_FORM_QUESTION = "What is in this image?"
MC_QUESTION = "What color is the rectangle?"
MC_OPTIONS = ["(A) red", "(B) blue", "(C) green", "(D) yellow"]
TARGET = "red rectangle"
CONTEXT_QUESTION = ("According to the common sense knowledge, where is the "
                    "red rectangle most likely to appear in this image?")
RUNNER_SWEEP_NEEDS = ("--runner-sweep needs --benchmark-folder and both "
                      "model paths")


def synthetic_image(w=640, h=480):
    rng = np.random.RandomState(0)
    arr = rng.randint(0, 255, (h, w, 3), np.uint8)
    arr[200:260, 300:380] = (250, 30, 30)  # a "red thing" to find
    return Image.fromarray(arr)


def audit(model_dir: str, which: str, device="cuda") -> Dict:
    """The strict key audit of one checkpoint directory through the
    importer of `which` ('vqa' or 'vsm'), printed; returns its record
    ('ok' when nothing is unknown or missing). On the card the state dict
    and the imported tree are freed before returning, and 'peak_bytes'
    is what the audit allocated at most."""
    from ..core import hf_config
    from ..core.checkpoint import load_torch_dir
    from ..core.import_audit import audit_import, audit_key_list
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    sd = load_torch_dir(model_dir, dev)
    if which == "vqa":
        from ..models.vqa_llm import vqa_llm_params_from_torch as importer
        cfg = hf_config.vqa_llm_config_for(model_dir)
    else:
        from ..models.vsm import vsm_params_from_torch as importer
        cfg = hf_config.vsm_config_for(model_dir)
    # the loaders' dtype: the accounting does not depend on it
    aud = audit_import(sd, lambda s: importer(s, cfg, dtype=torch.bfloat16))
    rec = {"summary": aud.summary(), "consumed": len(aud.consumed),
           "skipped": len(aud.skipped), "unknown": aud.unknown,
           "missing": aud.missing, "aborted": aud.aborted,
           "ok": not (aud.unknown or aud.missing), "manifest": None}
    print(f"[{which}] key audit: {aud.summary()}")
    if aud.unknown:
        print(f"[{which}] UNKNOWN keys: {aud.unknown[:20]}")
    if aud.missing:
        print(f"[{which}] MISSING keys: {aud.missing[:20]}")
    if (aud.aborted or aud.missing) and cfg.llama.num_layers == 32:
        # the importer stops at its first missing key; the committed 7B
        # manifest gives the complete lists
        man = audit_key_list(sd.keys(), f"seal_{which}_7b")
        rec["manifest"] = {"summary": man.summary(), "missing": man.missing,
                           "unknown": man.unknown}
        print(f"[{which}] manifest audit: {man.summary()}")
        if man.missing:
            print(f"[{which}] manifest MISSING: {man.missing}")
        if man.unknown:
            print(f"[{which}] manifest UNKNOWN: {man.unknown}")
    del sd
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev) - before
        torch.cuda.empty_cache()
        print(f"[{which}] key audit peak allocated "
              f"{rec['peak_bytes'] / 1e9:.3f} GB, freed before the engines "
              "load")
    return rec


def _search_record(result, path) -> Dict:
    step, n, found, _ = result
    return {"found": bool(found), "path_len": int(n),
            "bbox": None if step is None else step.bbox, "path": path}


def _smoke_vqa(vqa, img) -> Dict:
    ans = vqa.free_form(img, FREE_FORM_QUESTION)
    print(f"[vqa] free_form: {ans!r}")
    opt = vqa.multiple_choice(img, MC_QUESTION, MC_OPTIONS)
    print(f"[vqa] multiple_choice -> option {opt}")
    # tokens per forward of the real weights' prompt-lookup drafts
    vqa.prompt_lookup = True
    try:
        ans2 = vqa.free_form(img, FREE_FORM_QUESTION)
    finally:
        vqa.prompt_lookup = False
    if ans2 != ans:
        raise AssertionError("prompt-lookup must be greedy-equivalent: "
                             f"{ans2!r} != {ans!r}")
    rec = {"free_form": ans, "option": int(opt), "prompt_lookup_equal": True,
           "tokens_per_forward": None, "tokens": None}
    acc = vqa.last_decode_stats
    if acc is not None:
        rec.update(tokens_per_forward=float(acc["tokens_per_forward"]),
                   tokens=int(acc["tokens"]))
        print(f"[vqa] prompt-lookup acceptance: "
              f"{acc['tokens_per_forward']:.2f} tok/forward over "
              f"{acc['tokens']} tokens (greedy = 1.0)")
    return rec


def _like(vsm, **kw):
    """A BatchedVSMEngine on `vsm`'s tensors (no copy), as `vsm` was built
    but for `kw`."""
    from ..search.batched import BatchedVSMEngine
    return BatchedVSMEngine(
        vsm.params, vsm.cfg, vsm.tokenizer, loc_token_id=vsm.loc_token_id,
        device=vsm.device, eos_id=vsm.eos_id,
        max_new_tokens=vsm.max_new_tokens, prompt_buckets=vsm.prompt_buckets,
        compute_dtype=vsm.compute_dtype, **kw)


def _smoke_vsm(vsm, img, report) -> None:
    from ..eval.phased import free_engine
    from ..search.compiled import CompiledVSMSearch
    from ..search.policy import visual_search
    boxes, logits, heat = vsm.detect(img, TARGET)
    logits, heat = np.asarray(logits), np.asarray(heat)
    top = float(logits.max()) if logits.size else float("nan")
    report["vsm"] = {"candidates": len(boxes), "top_sigmoid": top,
                     "heatmap_max": float(heat.max())}
    print(f"[vsm] detect: {len(boxes)} candidates, top sigmoid "
          f"{top:.3f}, heatmap max {float(heat.max()):.2f}")
    txt = vsm.vqa(img, CONTEXT_QUESTION)
    report["vsm"]["vqa"] = txt
    print(f"[vsm] vqa: {txt!r}")
    path = []
    rec = _search_record(visual_search(vsm, img, TARGET, path_out=path),
                         path)
    report["search"] = rec
    print(f"[search] found={rec['found']} path_len={rec['path_len']} "
          f"bbox={rec['bbox']}")
    # the compiled search on a device-preprocess engine over the loaded
    # tensors must reach the same accept / fallback verdict (the cubic
    # canvas resampler differs from PIL's bicubic)
    vsm_dp = _like(vsm, device_preprocess=True)
    path = []
    rec = _search_record(CompiledVSMSearch(vsm_dp).search(
        img, TARGET, path_out=path), path)
    report["search_compiled"] = rec
    print(f"[search/compiled] found={rec['found']} "
          f"path_len={rec['path_len']} bbox={rec['bbox']}")
    # drops vsm_dp's reference to the shared tensors, its canvases and
    # its captured graphs; the loaded engine keeps the tensors
    free_engine(vsm_dp)


def _failed_cells(rows, what, need=()) -> bool:
    """Print each row of a sweep that raised or lacks a value in `need`;
    True when there is one."""
    bad = [r for r in rows
           if "error" in r or any(r.get(k) is None for k in need)]
    for r in bad:
        print(f"{what} FAILED in cell {r['cell']}: "
              f"{r.get('error', 'no ' + ', '.join(need))}")
    return bool(bad)


def _sweep(args, vqa, vsm, img, device, tokenizer, report) -> bool:
    """The flag matrix on the loaded pair; True when a cell failed."""
    from ..eval.flag_matrix import format_table, run_flag_matrix
    from ..eval.vqa_engine import VQAEngine
    from ..eval.vstar_bench import load_vqa_engine, load_vsm_engine

    def make_engines(kv_int8, prompt_lookup, compiled, int4=False):
        if int4:
            # int4 is another quantization of the checkpoint: reload
            vq = load_vqa_engine(args.vqa_model_path, int4=True,
                                 kv_int8=kv_int8,
                                 prompt_lookup=prompt_lookup, device=device,
                                 tokenizer=tokenizer)
            vs = load_vsm_engine(args.vsm_model_path, int4=True,
                                 kv_int8=kv_int8, device_preprocess=compiled,
                                 device=device, tokenizer=tokenizer)
        else:
            vq = VQAEngine(vqa.params, vqa.cfg, vqa.tokenizer,
                           device=vqa.device, conv_type=vqa.CONV_TYPE,
                           prompt_buckets=vqa.prompt_buckets,
                           compute_dtype=vqa.compute_dtype, kv_int8=kv_int8,
                           prompt_lookup=prompt_lookup)
            vs = _like(vsm, kv_int8=kv_int8, device_preprocess=compiled)
        if compiled:
            from ..search.compiled import CompiledVSMSearch
            vs = CompiledVSMSearch(vs)
        return vq, vs

    rows = run_flag_matrix(make_engines, img, search_name=TARGET,
                           benchmark_folder=args.benchmark_folder)
    report["flag_matrix"] = rows
    print(format_table(rows))
    with open("flag_matrix.json", "w") as f:
        json.dump(rows, f, indent=2)
    print("flag matrix -> flag_matrix.json")
    return _failed_cells(rows, "SWEEP")


def _runner_sweep(args, device, tokenizer, report) -> bool:
    """The residency matrix on loader factories; True when a cell
    failed."""
    from ..eval.flag_matrix import run_runner_matrix
    from ..eval.vstar_bench import load_vqa_engine, load_vsm_engine

    # zero-argument factories that re-read the checkpoint: what a phase
    # swap pays (the parked cell measures the host-RAM copy against it)
    def vqa_loader(**kw):
        return lambda: load_vqa_engine(args.vqa_model_path, device=device,
                                       tokenizer=tokenizer, **kw)

    def vsm_loader(**kw):
        return lambda: load_vsm_engine(args.vsm_model_path, device=device,
                                       tokenizer=tokenizer,
                                       device_preprocess=True, **kw)

    vqa8_f = vqa_loader(int8=True)
    vsm4_f = vsm_loader(int4=True)
    rows = run_runner_matrix(
        args.benchmark_folder, vqa_loader(), vsm_loader(),
        coresident_factories=(vqa_loader(int4=True), vsm4_f),
        # mixed: int8 VQA (the free-form and option phases at int8 speed)
        # + int4 VSM (only the searches pay int4)
        mixed_factories=(vqa8_f, vsm4_f),
        # int4mix VSM: per-matrix int4 / int8, at its own B <= 2
        int4mix_factories=(vqa8_f, vsm_loader(int4="int4mix")))
    report["runner_matrix"] = rows
    with open("runner_matrix.json", "w") as f:
        json.dump(rows, f, indent=2)
    print("runner matrix -> runner_matrix.json")
    return _failed_cells(rows, "RUNNER SWEEP", need=("accuracy",))


def build_parser() -> argparse.ArgumentParser:
    """The JAX script's flags, and --device."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--vqa-model-path")
    p.add_argument("--vsm-model-path")
    p.add_argument("--benchmark-folder",
                   help="optional: also run the V*Bench eval")
    p.add_argument("--skip-audit", action="store_true")
    p.add_argument("--sweep", action="store_true",
                   help="flag-matrix sweep: accuracy and latency of every "
                        "opt-in (int8 KV, W8A8, prompt lookup, int4, the "
                        "compiled search) in one run, the gate table "
                        "(eval/flag_matrix.py); with --benchmark-folder "
                        "V*Bench accuracy per cell")
    p.add_argument("--runner-sweep", action="store_true",
                   help="residency-mode sweep (needs --benchmark-folder "
                        "and both model paths): phased swap (base), parked "
                        "host-RAM swap, int4 co-resident, mixed int8-VQA / "
                        "int4-VSM and int4mix co-resident, one row per "
                        "mode with throughput, swap cost, accuracy and "
                        "records_match_base "
                        "(eval/flag_matrix.run_runner_matrix)")
    p.add_argument("--int8", dest="int8", action="store_true",
                   default=None,
                   help="weight-only int8 decoders (and int8 towers)")
    p.add_argument("--no-int8", dest="int8", action="store_false",
                   default=None,
                   help="bf16 decoders (the default on the card)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    return p


def main(argv=None, device="cuda", tokenizer=None,
         report: Optional[Dict] = None) -> int:
    """The command; returns its exit code. `device` is used unless
    --device names one; `tokenizer` None loads each directory's. `report`
    (a dict) receives each step's values: 'audit' {which: audit()'s
    record}, 'vqa', 'vsm', 'search', 'search_compiled' (each search's
    found, path_len, bbox and visited path), 'flag_matrix',
    'runner_matrix', 'eval' and 'passed'. The verdict names what failed:
    the audit, the sweep or the runner sweep."""
    from ..eval.phased import free_engine
    from ..eval.vstar_bench import load_vqa_engine, load_vsm_engine
    p = build_parser()
    args = p.parse_args(argv)
    if not (args.vqa_model_path or args.vsm_model_path):
        p.error("need --vqa-model-path and/or --vsm-model-path")
    if args.runner_sweep and not (args.benchmark_folder and
                                  args.vqa_model_path and
                                  args.vsm_model_path):
        sys.exit(RUNNER_SWEEP_NEEDS)
    device = args.device or device
    report = {} if report is None else report

    failed = []
    if not args.skip_audit:
        report["audit"] = {}
        for which, path in (("vqa", args.vqa_model_path),
                            ("vsm", args.vsm_model_path)):
            if path:
                report["audit"][which] = audit(path, which, device)
        if not all(a["ok"] for a in report["audit"].values()):
            failed.append("audit")
            print("KEY AUDIT FAILED — fix the import schema before "
                  "trusting any numbers below.")

    img = synthetic_image()
    vqa = vsm = None
    if args.vqa_model_path:
        vqa = load_vqa_engine(args.vqa_model_path, int8=args.int8,
                              device=device, tokenizer=tokenizer)
        report["vqa"] = _smoke_vqa(vqa, img)
    if args.vsm_model_path:
        vsm = load_vsm_engine(args.vsm_model_path, int8=args.int8,
                              device=device, tokenizer=tokenizer)
        _smoke_vsm(vsm, img, report)

    if args.sweep and vqa is not None and vsm is not None and \
            _sweep(args, vqa, vsm, img, device, tokenizer, report):
        failed.append("sweep")
    if args.runner_sweep:
        # the smoke pair goes first: the residency cells need the card
        free_engine(vqa)
        free_engine(vsm)
        vqa = vsm = None
        if _runner_sweep(args, device, tokenizer, report):
            failed.append("runner sweep")
    elif args.benchmark_folder and vqa is not None and vsm is not None \
            and not args.sweep:
        from ..eval.vstar_bench import eval_model
        ns = argparse.Namespace(
            vqa_model_path=args.vqa_model_path,
            vsm_model_path=args.vsm_model_path, conv_type="v1",
            benchmark_folder=args.benchmark_folder,
            output_path="eval_result.json", minimum_size_scale=4.0,
            minimum_size=224, image_batch=1)
        results, per_type, latencies = eval_model(ns, vqa, vsm)
        report["eval"] = {"results": results, "per_type": per_type,
                          "latencies": latencies}

    report["passed"] = not failed
    print("VALIDATION", f"FAILED (see {', '.join(failed)})" if failed
          else "PASSED")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
