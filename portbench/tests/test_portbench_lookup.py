"""Everything the manifest names is found by its name."""

import json
import sys

import pytest

from portbench import run as R

BENCH = R.load_json(R.ROOT / "BENCHMARK.json")


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files(w):
    wl, cfg, mix = R.cell(BENCH, w["name"])
    assert cfg["hidden_size"] > 0 and mix["driver"] == "eval"
    __import__(f"portbench.drivers.{mix['driver']}")
    limits = R.load_json(R.HERE / "limits" / f"{w['name']}.json")["limits"]
    assert set(limits) <= set(__import__("portbench.check").check.NAMES)


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_readers(m):
    assert callable(R.reader(m["name"]))
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_configs_and_attention_names():
    for c in BENCH["configs"]:
        assert (R.ROOT / c["file"]).is_file()
        assert json.load(open(R.ROOT / c["file"]))["source"] == c["source"]
    names = R.attention_names()
    assert "flash_tile_kernel" in names and "tower_attention_kernel" in names


def test_every_cell_reports_setup_and_a_layer_metric():
    for w in BENCH["workloads"]:
        e2e = [m for m in BENCH["end_to_end"] if R.applies(m, w["name"])]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert any(R.applies(m, w["name"]) for m in BENCH["per_layer"])


def test_guard_compares_whole_top_level_names(monkeypatch):
    assert R.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "vstar_tpu_torch_like", sys)
    assert R.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert R.forbidden_modules() == ["jax"]


def test_no_card_means_no_result(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = R.main(["--workload", BENCH["workloads"][0]["name"], "--seed", "1",
                 "--seconds", "1"])
    assert rc == 3 and capsys.readouterr().out == ""
