"""The checkpoint-day command (vstar_tpu_torch/scripts/validate_weights.py)
against the JAX package's scripts/validate_weights.py on the CPU, on tiny
HF directories written by the port's exporter (random f32 models, the VSM
tilted to answer [LOC]). In the test only, both sides read the tiny
configs (config.json names only CLIP-L towers), the stub tokenizer, f32
importers and f32 engines, free-form answers capped at FREE_FORM_BUDGET
tokens and VSM answers at VSM_BUDGET; nothing of either package is
edited. The two runs must print the same lines (the detection's sigmoid
and heatmap maxima held within REL from the raw values), give the same
exit, and fail the same way on a broken directory; the engines and the
factories that each script hands to its flag and runner matrices must be
JAX's, cell by cell (flags, quantization, shared tensors); the 32-layer
manifest audit must agree; the sweeps run on the port alone
(tests/test_torch_flag_matrix.py holds the matrix to JAX's), and a cell
that raises fails the command; the compiled search's engine shares the
loaded tensors."""

import dataclasses
import json
import os
import re
import runpy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vstar_tpu.core.hf_config as j_hf_config
import vstar_tpu.eval.flag_matrix as j_flag_matrix
import vstar_tpu.eval.vqa_engine as j_vqa_engine
import vstar_tpu.eval.vstar_bench as j_vstar_bench
import vstar_tpu.models.vqa_llm as j_vqa_llm
import vstar_tpu.models.vsm as j_vsm
import vstar_tpu.search.batched as j_batched
from vstar_tpu.core.config import vqa_llm_tiny, vsm_tiny
from vstar_tpu.core.import_audit import audit_key_list as j_audit_key_list
from vstar_tpu.multimodal.stub_tokenizer import StubTokenizer as JaxStub
from vstar_tpu_torch.core import config as tcfg
from vstar_tpu_torch.core import hf_config as t_hf_config
from vstar_tpu_torch.core.hf_export import (save_safetensors,
                                            vqa_llm_state_dict,
                                            vsm_state_dict)
from vstar_tpu_torch.core.params import leaves_with_path
from vstar_tpu_torch.eval import flag_matrix as tfm
from vstar_tpu_torch.eval import synthetic
from vstar_tpu_torch.eval import vqa_engine as t_vqa_engine
from vstar_tpu_torch.eval import vstar_bench as t_vstar_bench
from vstar_tpu_torch.models import vqa_llm as t_vqa_llm
from vstar_tpu_torch.models import vsm as t_vsm
from vstar_tpu_torch.models.vqa_llm import init_vqa_llm_params
from vstar_tpu_torch.models.vsm import init_vsm_params
from vstar_tpu_torch.multimodal.stub_tokenizer import StubTokenizer
from vstar_tpu_torch.nn import quant
from vstar_tpu_torch.scripts import validate_weights as vw
from vstar_tpu_torch.search import batched as t_batched

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPT = os.path.join(ROOT, "scripts", "validate_weights.py")
REL = 1e-4              # the f32 parity tests' tolerance
FREE_FORM_BUDGET = 12
VSM_BUDGET = 8
LOC = 3                 # the stub tokenizer's [LOC] id
CFGS = {"jax": (vqa_llm_tiny(), vsm_tiny()),
        "port": (tcfg.vqa_llm_tiny(), tcfg.vsm_tiny())}
DTYPES = {"vstar_tpu": jnp.float32, "vstar_tpu_torch": torch.float32}
ENGINES = []      # every engine built under the hooks, in order
DETECTS = []      # the JAX engines' detections, raw
RUNNER_CELLS = ("phased", "parked", "coresident", "mixed-coresident",
                "int4mix-coresident")


def _deep(cfg):
    """The tiny VQA config with a 32-layer decoder (the manifest audit's
    trigger)."""
    return dataclasses.replace(cfg, llama=dataclasses.replace(
        cfg.llama, num_layers=32))


def _tiny_state_dicts(vqa_cfg=None):
    """The port's random tiny models exported as state dicts (f32); the
    VSM tilted as tests/test_torch_slice.py tilts it."""
    vqa_cfg = vqa_cfg or CFGS["port"][0]
    vqa = init_vqa_llm_params(0, vqa_cfg, device="cpu")
    vsm = init_vsm_params(1, CFGS["port"][1], device="cpu")
    vsm["llama"]["embed_tokens"][:, 0] += 100.0
    vsm["llama"]["lm_head"][0, LOC] = 10.0
    return vqa_llm_state_dict(vqa), vsm_state_dict(vsm)


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """{name: {'vqa': dir, 'vsm': dir}}: 'good' as exported, 'unknown' with
    one key the importers never read, 'broken' also with one decoder key
    removed, 'deep' the same break of a 32-layer VQA decoder."""
    base = tmp_path_factory.mktemp("hf")
    vqa_sd, vsm_sd = _tiny_state_dicts()
    drop = "model.layers.0.mlp.down_proj.weight"
    extra = {"model.mystery_adapter.weight": torch.zeros(4, 4)}
    variants = {
        "good": (vqa_sd, vsm_sd),
        "unknown": (dict(vqa_sd, **extra), vsm_sd),
        "broken": ({k: v for k, v in dict(vqa_sd, **extra).items()
                    if k != drop}, vsm_sd),
    }
    deep = _tiny_state_dicts(_deep(CFGS["port"][0]))[0]
    variants["deep"] = ({k: v for k, v in dict(deep, **extra).items()
                         if k != drop}, None)
    dirs = {}
    for name, (vq, vs) in variants.items():
        dirs[name] = {}
        for key, sd in (("vqa", vq), ("vsm", vs)):
            if sd is not None:
                dirs[name][key] = str(base / name / key)
                save_safetensors(sd, dirs[name][key])
    return dirs


def _hooked(cls, vqa=False):
    """`cls` with f32 compute and the answer budgets as defaults, each
    instance recorded in ENGINES (the port's with its tensors'
    data_ptr at construction)."""
    dtype = DTYPES[cls.__module__.split(".")[0]]

    class Capped(cls):
        def __init__(self, *args, **kw):
            kw.setdefault("compute_dtype", dtype)
            if not vqa:
                kw.setdefault("max_new_tokens", VSM_BUDGET)
            super().__init__(*args, **kw)
            if dtype is torch.float32 and isinstance(self.params, dict):
                self.shared_ptrs = {k: v.data_ptr() for k, v in
                                    leaves_with_path(self.params)}
            ENGINES.append(self)

    def free_form(self, *args, **kw):
        kw.setdefault("max_new_tokens", FREE_FORM_BUDGET)
        return cls.free_form(self, *args, **kw)

    if vqa:
        Capped.free_form = free_form
    Capped.__name__ = cls.__name__
    return Capped


def _f32_importer(mod, name, dtype):
    orig = getattr(mod, name)

    def importer(sd, cfg, _dtype=None, *rest, **kw):
        kw.pop("dtype", None)
        return orig(sd, cfg, dtype, *rest, **kw)
    return importer


@pytest.fixture
def hooks(monkeypatch):
    """The test-only hooks of both sides (see the module docstring); the
    JAX detections are recorded raw in DETECTS. Yields a function that
    switches the VQA config to the 32-layer one."""

    def set_vqa_cfg(deep):
        for side, mod in (("jax", j_hf_config), ("port", t_hf_config)):
            cfg = _deep(CFGS[side][0]) if deep else CFGS[side][0]
            monkeypatch.setattr(mod, "vqa_llm_config_for",
                                lambda p, c=cfg: c)

    set_vqa_cfg(False)
    for side, mod in (("jax", j_hf_config), ("port", t_hf_config)):
        monkeypatch.setattr(mod, "vsm_config_for",
                            lambda p, c=CFGS[side][1]: c)
    import transformers
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        lambda *a, **k: JaxStub(CFGS["jax"][0]
                                                .llama.vocab_size))
    for mod, name, dtype in ((j_vqa_llm, "vqa_llm_params_from_torch",
                              jnp.float32),
                             (j_vsm, "vsm_params_from_torch", jnp.float32),
                             (t_vqa_llm, "vqa_llm_params_from_torch",
                              torch.float32),
                             (t_vsm, "vsm_params_from_torch",
                              torch.float32)):
        monkeypatch.setattr(mod, name, _f32_importer(mod, name, dtype))
    monkeypatch.setattr(j_vqa_engine, "VQAEngine",
                        _hooked(j_vqa_engine.VQAEngine, vqa=True))
    monkeypatch.setattr(t_vqa_engine, "VQAEngine",
                        _hooked(t_vqa_engine.VQAEngine, vqa=True))
    jax_vsm = _hooked(j_batched.BatchedVSMEngine)

    class RecordingVSM(jax_vsm):
        def detect(self, image, name):
            out = super().detect(image, name)
            DETECTS.append(out)
            return out
    RecordingVSM.__name__ = jax_vsm.__name__
    monkeypatch.setattr(j_batched, "BatchedVSMEngine", RecordingVSM)
    monkeypatch.setattr(t_batched, "BatchedVSMEngine",
                        _hooked(t_batched.BatchedVSMEngine))
    yield set_vqa_cfg
    ENGINES.clear()
    DETECTS.clear()


def _paths(dirs, which=("vqa", "vsm")):
    out = []
    for key in which:
        if key in dirs:
            out += [f"--{key}-model-path", dirs[key]]
    return out


def _run_jax(argv, capsys, monkeypatch):
    """JAX's script as `python scripts/validate_weights.py argv`: (exit
    code or the exception raised, stdout lines)."""
    main = runpy.run_path(JAX_SCRIPT)["main"]
    monkeypatch.setattr("sys.argv", [JAX_SCRIPT] + argv)
    capsys.readouterr()
    try:
        main()
        code = 0
    except SystemExit as e:
        code = e.code
    except Exception as e:   # noqa: BLE001 — the process would exit 1
        code = e
    return code, capsys.readouterr().out.splitlines()


def _run_port(argv, capsys):
    """The port's main on the CPU: (exit code or the exception raised,
    stdout lines, report)."""
    report = {}
    capsys.readouterr()
    tok = StubTokenizer(CFGS["port"][0].llama.vocab_size)
    try:
        code = vw.main(argv + ["--device", "cpu"], tokenizer=tok,
                       report=report)
    except Exception as e:   # noqa: BLE001 — the process would exit 1
        code = e
    return code, capsys.readouterr().out.splitlines(), report


DETECT_LINE = re.compile(r"\[vsm\] detect: (\d+) candidates, top sigmoid "
                         r"(\S+), heatmap max (\S+)")


def _same_lines(port, jax_):
    """The same printed lines; the detection's by its candidate count
    (the callers hold its rounded numbers raw, within REL)."""
    assert len(port) == len(jax_), (port, jax_)
    for a, b in zip(port, jax_):
        ma, mb = DETECT_LINE.fullmatch(a), DETECT_LINE.fullmatch(b)
        if mb:
            assert ma and ma.group(1) == mb.group(1), (a, b)
        else:
            assert a == b


def _quantized(tree):
    """(int8 entries, int4 entries) in a weight tree of either side."""
    if isinstance(tree, dict):
        if tree.keys() == {"q", "s"}:
            return 1, 0
        if tree.keys() == {"q4", "s4"}:
            return 0, 1
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        counts = [_quantized(t) for t in tree]
        return sum(c[0] for c in counts), sum(c[1] for c in counts)
    return 0, 0


def _engine(e, loaded=None):
    """What a sweep's engine is: its flags, whether the compiled search
    wraps it, its quantized entries by top-level key, and whether it
    holds the loaded engine's tensors."""
    compiled = type(e).__name__ == "CompiledVSMSearch"
    e = e.engine if compiled else e
    return {"compiled": compiled, "kv_int8": e.kv_int8,
            "prompt_lookup": getattr(e, "prompt_lookup", None),
            "device_preprocess": getattr(e, "device_preprocess", None),
            "quantized": {k: _quantized(v) for k, v in e.params.items()},
            "shares_loaded": None if loaded is None
            else e.params is loaded.params}


def _recorders(cells, record):
    """Stand-ins for run_flag_matrix and run_runner_matrix that build every
    cell's engines through the script's own make_engines and factories
    and record them in `record` (measuring nothing), the loaded pair
    being the first two engines built after `record['start']`."""

    def flag_matrix(make_engines, image, **kw):
        loaded = ENGINES[record["start"]:record["start"] + 2]
        record["flag_args"] = kw
        record["flag"] = []
        for name, cell in cells:
            vq, vs = make_engines(
                kv_int8=bool(cell.get("kv_int8", False)),
                prompt_lookup=bool(cell.get("prompt_lookup", False)),
                compiled=bool(cell.get("compiled", False)),
                int4=bool(cell.get("int4", False)))
            record["flag"].append((name, _engine(vq, loaded[0]),
                                   _engine(vs, loaded[1])))
        return [{"cell": name} for name, _ in cells]

    def runner_matrix(benchmark_folder, vqa_factory, vsm_factory, **kw):
        factories = {k: kw.pop(k) for k in ("coresident_factories",
                                            "mixed_factories",
                                            "int4mix_factories")}
        record["runner_args"] = (benchmark_folder, kw)
        record["runner"] = []
        for name, (vq_f, vs_f) in zip(
                ("phased", "coresident", "mixed-coresident",
                 "int4mix-coresident"),
                [(vqa_factory, vsm_factory)] + list(factories.values())):
            record["runner"].append((name, _engine(vq_f()),
                                     _engine(vs_f())))
        return [{"cell": name, "accuracy": 1.0} for name in RUNNER_CELLS]

    return flag_matrix, runner_matrix


def test_script_against_jax(hf_dirs, hooks, capsys, monkeypatch, tmp_path):
    """--no-int8 --sweep --runner-sweep on the good directories: the
    audits, every surface's printed value, the verdict and the exit code
    are JAX's; the report holds what was printed; the compiled search's
    engine shares the loaded engine's tensors (data_ptr), leaf for leaf.
    The matrices themselves are replaced on both sides by recorders of
    the engines that each script's make_engines and runner factories
    build (the port's matrices run in test_sweeps_on_the_port): cell by
    cell they are JAX's, flags, quantization and shared tensors, JAX's
    factories at their single-chip default (int8 where no format is
    asked for), which the port's runner cells ask for explicitly but in
    the base cell, which keeps the port's default (bf16)."""
    monkeypatch.chdir(tmp_path)
    bench = str(tmp_path / "bench")
    argv = _paths(hf_dirs["good"]) + ["--no-int8", "--sweep",
                                      "--runner-sweep", "--benchmark-folder",
                                      bench]
    sweeps = {"jax": {}, "port": {}}
    for side, mod in (("jax", j_flag_matrix), ("port", tfm)):
        flag, runner = _recorders(mod.CELLS, sweeps[side])
        monkeypatch.setattr(mod, "run_flag_matrix", flag)
        monkeypatch.setattr(mod, "run_runner_matrix", runner)
    monkeypatch.setattr(j_vstar_bench, "_auto_int8",
                        lambda int8, mesh: mesh is None if int8 is None
                        else int8)
    sweeps["jax"]["start"] = len(ENGINES)
    j_code, j_lines = _run_jax(argv, capsys, monkeypatch)
    j_detect = DETECTS[0]
    n_jax = sweeps["port"]["start"] = len(ENGINES)
    code, lines, rep = _run_port(argv, capsys)
    assert j_code == 0 and code == 0, (j_code, code, j_lines, lines)
    _same_lines(lines, j_lines)
    assert lines[-1] == "VALIDATION PASSED"

    boxes, logits, heat = j_detect
    assert rep["vsm"]["candidates"] == len(boxes) > 0
    np.testing.assert_allclose(rep["vsm"]["top_sigmoid"],
                               float(np.max(logits)), rtol=REL)
    np.testing.assert_allclose(rep["vsm"]["heatmap_max"],
                               float(np.max(heat)), rtol=REL)
    for which in ("vqa", "vsm"):
        a = rep["audit"][which]
        assert a["ok"] and not a["aborted"] and a["manifest"] is None
        assert f"[{which}] key audit: {a['summary']}" in j_lines
    assert f"[vqa] free_form: {rep['vqa']['free_form']!r}" in j_lines
    assert f"[vqa] multiple_choice -> option {rep['vqa']['option']}" \
        in j_lines
    assert rep["vqa"]["prompt_lookup_equal"] is True
    assert f"[vsm] vqa: {rep['vsm']['vqa']!r}" in j_lines
    for key, tag in (("search", "search"),
                     ("search_compiled", "search/compiled")):
        s = rep[key]
        assert (f"[{tag}] found={s['found']} path_len={s['path_len']} "
                f"bbox={s['bbox']}") in j_lines
        assert len(s["path"]) == s["path_len"]
    assert rep["passed"] is True

    # the port's engines: loaded VQA, loaded VSM, the compiled search's
    port = ENGINES[n_jax:n_jax + 3]
    assert [type(e).__name__ for e in port] == \
        ["VQAEngine", "BatchedVSMEngine", "BatchedVSMEngine"]
    loaded, dp = port[1], port[2]
    assert dp.device_preprocess and not loaded.device_preprocess
    assert dp.params is None             # dropped after the search
    assert dp.shared_ptrs == loaded.shared_ptrs

    # the sweeps' engines, cell by cell
    j_sw, t_sw = sweeps["jax"], sweeps["port"]
    assert t_sw["flag_args"] == j_sw["flag_args"] == {
        "search_name": vw.TARGET, "benchmark_folder": bench}
    assert t_sw["flag"] == j_sw["flag"]
    assert [c for c, _, _ in t_sw["flag"]] == [c for c, _ in tfm.CELLS]
    for cell, vq, vs in t_sw["flag"]:
        int4 = "int4" in cell
        assert vq["shares_loaded"] is vs["shares_loaded"] is (not int4)
        assert (vq["quantized"]["llama"][1] > 0) is int4
    assert t_sw["runner_args"] == j_sw["runner_args"] == (bench, {})
    runner, want = dict((c, r) for c, *r in t_sw["runner"]), \
        dict((c, r) for c, *r in j_sw["runner"])
    assert runner.keys() == want.keys()
    for cell, pair in runner.items():
        for got, exp in zip(pair, want[cell]):
            if cell == "phased":    # the port's default weight format
                assert all(q == (0, 0) for q in got["quantized"].values())
                assert exp["quantized"]["llama"][0] > 0
                got = dict(got, quantized=exp["quantized"])
            assert got == exp, cell
    assert runner["mixed-coresident"][0]["quantized"]["llama"] == \
        runner["int4mix-coresident"][0]["quantized"]["llama"] != (0, 0)


@pytest.mark.parametrize("variant,j_fails", [("unknown", 1),
                                              ("broken", KeyError)])
def test_failing_audit_against_jax(hf_dirs, hooks, capsys, monkeypatch,
                                   variant, j_fails):
    """A directory with a key the importer never reads: the same UNKNOWN
    line and exit 1 on both sides (after the smoke). With a decoder key
    removed too, the importer stops at it: the same MISSING line, the
    unknown suppressed as JAX suppresses it, then the loader's KeyError on
    both sides (exit 1 as a process)."""
    argv = _paths(hf_dirs[variant], ("vqa",)) + ["--no-int8"]
    j_code, j_lines = _run_jax(argv, capsys, monkeypatch)
    code, lines, rep = _run_port(argv, capsys)
    audit = rep["audit"]["vqa"]
    assert not audit["ok"]
    if j_fails == 1:
        assert j_code == code == 1
        _same_lines(lines, j_lines)
        assert lines[-1] == "VALIDATION FAILED (see audit)"
        assert audit["unknown"] == ["model.mystery_adapter.weight"]
        assert "[vqa] UNKNOWN keys: ['model.mystery_adapter.weight']" \
            in lines
        assert rep["passed"] is False
    else:
        assert isinstance(j_code, KeyError) and isinstance(code, KeyError)
        assert lines == j_lines
        assert audit["aborted"] and audit["unknown"] == []
        assert audit["missing"] == ["model.layers.0.mlp.down_proj.weight"]
        assert "[vqa] MISSING keys: ['model.layers.0.mlp.down_proj.weight']" \
            in lines
    assert ("KEY AUDIT FAILED — fix the import schema before trusting any "
            "numbers below.") in lines


def test_manifest_audit_against_jax(hf_dirs, hooks, capsys, monkeypatch):
    """A 32-layer decoder at tiny widths with a key removed: both sides
    audit the keys against their 7B manifest (the port's copy); the
    summaries and the first 40 of each list are JAX's printed ones, the
    port's full lists JAX's audit_key_list's."""
    hooks(True)
    argv = _paths(hf_dirs["deep"]) + ["--no-int8"]
    j_code, j_lines = _run_jax(argv, capsys, monkeypatch)
    code, lines, rep = _run_port(argv, capsys)
    assert isinstance(j_code, KeyError) and isinstance(code, KeyError)
    man = rep["audit"]["vqa"]["manifest"]
    from vstar_tpu.core.checkpoint import load_torch_dir
    want = j_audit_key_list(load_torch_dir(hf_dirs["deep"]["vqa"]).keys(),
                            "seal_vqa_7b")
    assert man["missing"] == want.missing and man["unknown"] == want.unknown
    assert man["missing"] and man["unknown"]
    assert f"[vqa] manifest audit: {want.summary()}" in j_lines
    assert man["summary"] == want.summary()
    assert f"[vqa] manifest MISSING: {man['missing'][:40]}" in j_lines
    assert f"[vqa] manifest UNKNOWN: {man['unknown'][:40]}" in j_lines
    assert f"[vqa] manifest MISSING: {man['missing']}" in lines
    assert f"[vqa] manifest UNKNOWN: {man['unknown']}" in lines
    common = [l for l in j_lines if "manifest MISSING" not in l
              and "manifest UNKNOWN" not in l]
    assert [l for l in lines if "manifest MISSING" not in l
            and "manifest UNKNOWN" not in l] == common


def _bench(tmp_path):
    bench = str(tmp_path / "bench")
    synthetic.make_synthetic_benchmark(bench, n_per_task=1, seed=0,
                                       image_hw=(256, 256), target=3)
    return bench


def test_sweeps_on_the_port(hf_dirs, hooks, capsys, tmp_path, monkeypatch):
    """--sweep --runner-sweep --benchmark-folder (one synthetic image a
    task) exits 0: flag_matrix.json holds the 8 cells, the report's rows;
    on the f32 weights the cells whose engines compute what base computes
    answer as base (w8a8: act-int8 acts on quantized entries only;
    compiled-search leaves the VQA alone; prompt lookup is greedy), the
    w8a8 search too; runner_matrix.json the five residency rows, the
    parked one equal to the phased base. (Which engines each cell gets is
    held to JAX's script in test_script_against_jax.)"""
    monkeypatch.chdir(tmp_path)
    bench = _bench(tmp_path)
    argv = _paths(hf_dirs["good"]) + ["--sweep", "--runner-sweep",
                                      "--benchmark-folder", bench,
                                      "--skip-audit"]
    code, lines, rep = _run_port(argv, capsys)
    assert code == 0, lines
    rows = json.loads((tmp_path / "flag_matrix.json").read_text())
    assert [r["cell"] for r in rows] == [c for c, _ in tfm.CELLS]
    assert all("error" not in r for r in rows), rows
    assert rows == json.loads(json.dumps(rep["flag_matrix"]))
    by = {r["cell"]: r for r in rows}
    for cell in ("prompt-lookup", "w8a8", "compiled-search"):
        assert by[cell]["answer_matches_base"] is True, by[cell]
        assert by[cell]["option_matches_base"] is True, by[cell]
    for key in ("search_found", "search_plen", "search_bbox"):
        assert by["w8a8"][key] == by["base"][key]
    assert all("vstar_accuracy" in r for r in rows)
    assert quant._ACT_INT8 is False

    runner = json.loads((tmp_path / "runner_matrix.json").read_text())
    assert [r["cell"] for r in runner] == list(RUNNER_CELLS)
    assert all("error" not in r for r in runner), runner
    assert runner[1]["records_match_base"] is True
    assert all(r["accuracy"] is not None for r in runner)
    assert lines[-1] == "VALIDATION PASSED"


@pytest.mark.parametrize("sweep", ["sweep", "runner-sweep"])
def test_a_cell_that_raises_fails_the_command(hf_dirs, hooks, capsys,
                                              tmp_path, monkeypatch, sweep):
    """An int4 load that raises (as a kernel would on the card): the
    matrix records the error in the int4 cells and sweeps on, as in the
    JAX script, but the command prints each failed cell and exits 1 with
    the sweep named in its verdict. The flag matrix is cut to base and
    int4 here."""
    monkeypatch.chdir(tmp_path)

    def raising(load):
        def loader(*args, **kw):
            if kw.get("int4"):
                raise RuntimeError("int4 kernel failed")
            return load(*args, **kw)
        return loader
    for name in ("load_vqa_engine", "load_vsm_engine"):
        monkeypatch.setattr(t_vstar_bench, name,
                            raising(getattr(t_vstar_bench, name)))
    monkeypatch.setattr(tfm, "CELLS", (tfm.CELLS[0], tfm.CELLS[4]))
    argv = _paths(hf_dirs["good"]) + ["--skip-audit", f"--{sweep}"]
    if sweep == "runner-sweep":
        argv += ["--benchmark-folder", _bench(tmp_path)]
    code, lines, rep = _run_port(argv, capsys)
    assert code == 1 and rep["passed"] is False, lines
    if sweep == "sweep":
        failed, what = ["int4"], "SWEEP"
        assert [r["cell"] for r in rep["flag_matrix"]] == ["base", "int4"]
    else:
        failed = ["coresident", "mixed-coresident", "int4mix-coresident"]
        what = "RUNNER SWEEP"
        assert rep["runner_matrix"][1]["records_match_base"] is True
    assert [l for l in lines if "FAILED in cell" in l] == [
        f"{what} FAILED in cell {c}: RuntimeError: int4 kernel failed"
        for c in failed]
    assert lines[-1] == f"VALIDATION FAILED (see {sweep.replace('-', ' ')})"


def test_parser_against_jax(capsys, monkeypatch):
    """The JAX script's flags (and --device); no path is p.error's exit 2
    with JAX's message on both sides; --runner-sweep without a folder
    exits with JAX's message, before any audit."""
    main = runpy.run_path(JAX_SCRIPT)["main"]
    monkeypatch.setattr("sys.argv", [JAX_SCRIPT, "--help"])
    with pytest.raises(SystemExit):
        main()
    j_flags = set(re.findall(r"--[a-z][a-z0-9-]+", capsys.readouterr().out))
    with pytest.raises(SystemExit):
        vw.build_parser().parse_args(["--help"])
    flags = set(re.findall(r"--[a-z][a-z0-9-]+", capsys.readouterr().out))
    assert flags == j_flags | {"--device"}

    monkeypatch.setattr("sys.argv", [JAX_SCRIPT])
    with pytest.raises(SystemExit) as j_exit:
        main()
    j_err = capsys.readouterr().err.splitlines()[-1]
    with pytest.raises(SystemExit) as exit_:
        vw.main(["--device", "cpu"])
    assert exit_.value.code == j_exit.value.code == 2
    err = capsys.readouterr().err.splitlines()[-1]
    assert err.split(": ", 1)[1] == j_err.split(": ", 1)[1] == \
        "error: need --vqa-model-path and/or --vsm-model-path"

    with pytest.raises(SystemExit) as exit_:
        vw.main(["--vqa-model-path", "x", "--vsm-model-path", "y",
                 "--runner-sweep", "--device", "cpu"])
    assert exit_.value.code == vw.RUNNER_SWEEP_NEEDS
    with open(JAX_SCRIPT) as f:
        src = " ".join(f.read().split()).replace('" "', "")
    assert f'sys.exit("{vw.RUNNER_SWEEP_NEEDS}")' in src
