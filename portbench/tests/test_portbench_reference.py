"""The plain reference: against itself under its blocking, against the
program in f32 at a tiny size on the CPU (where the two must agree to
rounding), and its fp8 control failing the cell's limits there."""

import json

import pytest
import torch

from portbench import run as R
from portbench.check import NAMES, judge
from portbench.reference.model import Ref
from portbench.reference.shapes import shapes
from portbench.weights import Source


BENCH = R.load_json(R.ROOT / "BENCHMARK.json")
TINY = json.load(open(R.HERE / "tests" / "tiny.json"))
SEED = 2**31 + 977


def tiny_mix(workload):
    _, _, mix = R.cell(BENCH, workload)
    # images whose searches expand the root and the next patch, as the
    # cell's do (the smallest patch is 224 px)
    return dict(mix, sizes=[[960, 640], [640, 960], [1200, 800]],
                free_form_tokens=4, group_size=2)


def tiny_run(workload, seconds=2.0, **kw):
    limits = R.load_json(R.HERE / "limits" / f"{workload}.json")["limits"]
    return R.run_cell(BENCH, workload, SEED, seconds, False, "cpu",
                      cfg=TINY, mix=tiny_mix(workload), limits=limits,
                      engine_kw=dict(dtype=torch.float32), **kw)


def test_blocking_does_not_change_the_reference():
    torch.manual_seed(0)
    src = Source(SEED, shapes(TINY), "cpu", torch.float32, "vqa.")
    r = Ref(src, TINY)
    a = torch.randn(7, 64)
    b = torch.randn(5, 64)
    both = r.decoder([a, b])
    alone = r.decoder([a])[0], r.decoder([b])[0]
    assert torch.equal(both[0], alone[0]) and torch.equal(both[1], alone[1])
    # a product of fewer rows may take another BLAS kernel: f32 rounding
    whole = r.logits(both[0], block=1000)
    torch.testing.assert_close(r.logits(both[0], block=2), whole,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_program_agrees_and_the_control_fails(workload):
    res, _ = tiny_run(workload, with_control=True)
    assert res["correct"] and res["failed"] == 0
    for k in NAMES:
        assert res["values"][k] <= 1e-5, (k, res["values"][k])
    limits = R.load_json(R.HERE / "limits" / f"{workload}.json")["limits"]
    assert not judge(res["control"], limits), res["control"]


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_traced_run_reads_its_layer_metrics(workload):
    """--trace 1 on the CPU: the spans' and counters' metrics are read,
    the device's are left out (no device activity to read), and the line
    carries the profiled span."""
    limits = R.load_json(R.HERE / "limits" / f"{workload}.json")["limits"]
    res, _ = R.run_cell(BENCH, workload, SEED, 3.0, True, "cpu", cfg=TINY,
                        mix=tiny_mix(workload), limits=limits,
                        engine_kw=dict(dtype=torch.float32))
    names = set(res["metrics"])
    assert names and all(not n.startswith(("device_idle", "attn_roofline"))
                         for n in names)
    assert {"search_share.eval", "rows_per_wave.eval"} <= names
    assert res["device"]["window_s"] > 0 and res["correct"]
    assert len(res["breakdown"]["idle_gaps"]) <= 10


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_control_on_the_card(workload, tmp_path):
    """The control at the cell's own size on the card: it fails the
    cell's limits where the program passes them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench import control
    assert control.main(["--workload", workload, "--seeds", "17",
                         "--seconds", "10", "--out", str(tmp_path)]) == 0
    line = json.loads((tmp_path / f"control_{workload}.jsonl")
                      .read_text().splitlines()[0])
    limits = R.load_json(R.HERE / "limits" / f"{workload}.json")["limits"]
    assert judge(line["program"], limits)
    assert not judge(line["control"], limits)
