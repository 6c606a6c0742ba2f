"""The control of the check, and the readings its limits are set from.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 \
        --seconds 10

For each seed, in one process: one run of the cell (a short window at the
cell's own load), its numbers as the check reads them, then the control's
readings of the same sample (check.control: the reference in fp8 against
the reference in f32). One JSON line a seed on standard output and in
portbench_out/control_<workload>.jsonl. The benchmark's own runs never run
this; the limits in limits/<workload>.json are set from its lines.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
sys.path.insert(0, str(HERE.parent))

from portbench import run as R  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default="portbench_out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    bench = R.load_json(R.ROOT / "BENCHMARK.json")
    from portbench.check import NAMES
    limits = {k: float("inf") for k in NAMES}
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        res, _ = R.run_cell(bench, args.workload, seed, args.seconds, False,
                            "cuda", limits=limits, with_control=True)
        line = {"workload": args.workload, "seed": seed,
                "program": res["values"], "control": res["control"],
                "metrics": res["metrics"], "attempted": res["attempted"],
                "failed": res["failed"], "device": res["device"]}
        print(json.dumps(line), flush=True)
        with open(out / f"control_{args.workload}.jsonl", "a") as f:
            f.write(json.dumps(line) + "\n")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
