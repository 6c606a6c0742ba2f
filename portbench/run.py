"""Run one cell of BENCHMARK.json once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (imports, the port's CUDA library, both models' weights made on
the card from the seed, the cell's warm-up) is `setup_s`, from the
process's start. Then the window: the cell's driver runs its traffic for
`--seconds`. With `--trace 0` the line carries the cell's end-to-end
metrics, with `--trace 1` its per-layer metrics and the device's busy
time from a profile of the whole window. Then the program's
state is freed and the plain reference checks a sample of what the
window produced (check.py); `correct` is whether every number is within
its limit (limits/<workload>.json). The numbers compared, each beside
its limit, are the last lines of standard error and the last key of the
result. No card, or fewer than the cell asks for, and the run exits 3
with no result; a JAX module loaded at the start or the end, exit 4.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
# run as a script, Python puts portbench/ first on the path, where its
# modules would shadow the standard library's; the package root instead
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CACHE = ROOT / ".portbench_cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_TF"] = "0"

FORBIDDEN = ("jax", "jaxlib", "flax", "vstar_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is a JAX one."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def log(msg):
    print(f"[portbench {time.perf_counter() - T_PROCESS:8.2f}s] {msg}",
          file=sys.stderr, flush=True)


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def cell(bench: dict, name: str):
    """(workload, config file dict, mix dict) of a cell by name."""
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise SystemExit(f"unknown workload {name!r}")
    c = next(c for c in bench["configs"] if c["name"] == w["config"])
    return w, load_json(ROOT / c["file"]), \
        load_json(HERE / "traffic" / f"{w['traffic']}.json")


def reader(name: str):
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"),
        HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def attention_names():
    names = []
    for f in sorted((HERE / "attention").glob("*.txt")):
        names += [ln.strip() for ln in f.read_text().splitlines()
                  if ln.strip()]
    return names


def applies(metric: dict, workload: str, reported=None) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return reported is None or metric.get("moves") in reported


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20).stdout.split()
        return float(out[0]) if out else None
    except (OSError, subprocess.SubprocessError, ValueError):
        return None


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device, cfg=None, mix=None, limits=None,
             engine_kw=None, with_control: bool = False):
    """One run of a cell: (result dict, compared numbers). `cfg`, `mix`,
    `limits` and `engine_kw` replace the cell's own (the CPU tests run a
    tiny configuration through here)."""
    import torch
    from portbench import check, system
    from portbench.drivers.common import calls_work

    w, cfg0, mix0 = cell(bench, workload)
    cfg, mix = cfg or cfg0, mix or mix0
    if limits is None:
        limits = load_json(HERE / "limits" / f"{workload}.json")["limits"]
    cuda = torch.device(device).type == "cuda"
    driver_mod = importlib.import_module(f"portbench.drivers.{mix['driver']}")
    log(f"building the engines of {w['config']} (seed {seed})")
    vqa, vsm = system.build_engines(cfg, seed, device, **(engine_kw or {}))
    driver = driver_mod.Driver(cfg, mix, seed, vqa, vsm)
    log("warming up")
    driver.warm()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_PROCESS
    log(f"set-up done: {setup_s:.2f} s; window of {seconds} s")
    tracer = None
    if trace:
        from portbench.devtrace import Tracer
        tracer = Tracer()
    driver.run(seconds, tracer)
    if tracer is not None:
        tracer.stop()
    log("window closed")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    attempted, failed = driver.attempted()

    metrics = {}
    device_rec = {"platform": "gpu" if cuda else "cpu",
                  "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                  "count": 1, "memory_peak_bytes": int(peak),
                  "power_limit_w": power_limit() if cuda else None}
    breakdown = None
    if not trace:
        values = dict(driver.metrics(), setup_s=setup_s)
        for m in bench["end_to_end"]:
            if m["name"] in values and applies(m, workload):
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        summary = tracer.summary(attention_names(), driver.rec.spans())
        ctx = {"layer": driver.layer_inputs(), "trace": summary,
               "work": calls_work(cfg, driver.traced_calls()),
               "peaks": load_json(HERE / "peaks.json")}
        reported = set(driver.end_to_end)
        for m in bench["per_layer"]:
            if applies(m, workload, reported):
                v = reader(m["name"])(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_rec.update(busy_s=summary["busy_s"],
                          window_s=summary["window_s"])
        breakdown = {"device_ops": summary["device_ops"],
                     "idle_gaps": summary["idle_gaps"]}
        del tracer

    log("checking against the plain reference")
    sample = driver.check_sample()
    driver = vqa = vsm = None           # the program's state, freed
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    served = (engine_kw or {}).get("dtype", system.SERVED_DTYPE)
    checker = check.Checker(cfg, seed, device, served=served)
    values = check.check(checker, sample)
    log("checked")
    if with_control:
        del checker
        control_values = check.control(cfg, seed, device, sample, served)
        log("control read")
    correct = check.judge(values, limits) and failed == 0
    numbers = check.compared(values, limits)
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device_rec}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["values"] = values               # every reading, for the record
    if with_control:
        result["control"] = control_values
    result["compared"] = numbers            # last: the numbers and limits
    return result, numbers


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bad = forbidden_modules()
    if bad:
        print(f"refused: {bad} loaded at start", file=sys.stderr)
        return 4
    bench = load_json(ROOT / "BENCHMARK.json")
    w = next((w for w in bench["workloads"]
              if w["name"] == args.workload), None)
    if w is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < w["chips"]:
        print(f"no result: the cell needs {w['chips']} CUDA device(s), "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 3
    result, numbers = run_cell(bench, args.workload, args.seed,
                               args.seconds, bool(args.trace), "cuda")
    bad = forbidden_modules()
    if bad:
        print(f"refused: {bad} loaded by the end of the run",
              file=sys.stderr)
        return 4
    log(f"done; correct={result['correct']}")
    for k, v in numbers.items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
