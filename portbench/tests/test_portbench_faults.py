"""A run whose timed path is broken underneath comes out not correct: a
served token, an option's loss and the detection's boxes altered where
they are produced; a search that ends a step early, one that visits
another patch than its heatmaps choose, a final box left in its patch's
frame, and a search phase that no longer runs the forced policy. (The
faults of training and of the exchange between chips have no place in
this one-chip cell.) The run is a whole one at a tiny size on the CPU,
the look for a card skipped, held to the cell's own limits."""

import importlib

import pytest
import torch

from test_portbench_reference import BENCH, tiny_run

CELLS = [w["name"] for w in BENCH["workloads"]]
LOC = 3


def bump_token(fn):
    def run(*a, **k):
        res = fn(*a, **k)
        res.tokens[:, 1] = (res.tokens[:, 1] + 1) % 300 + 4
        return res
    return run


def bump_losses(fn):
    def run(*a, **k):
        losses, best = fn(*a, **k)
        return losses + 0.5, best
    return run


def shift_boxes(fn):
    def run(*a, **k):
        logits, boxes = fn(*a, **k)
        return logits, boxes + 0.05
    return run


def one_step_less(fn):
    def run(*a, max_steps=None, **k):
        return fn(*a, max_steps=max_steps - 1, **k)
    return run


def children_reversed(fn):
    def run(*a, **k):
        subs, sw, sh = fn(*a, **k)
        return subs[::-1], sw, sh
    return run


def search_bypassed(fn):
    """eval_batch's search phase calling the lockstep searches by another
    route than the one the benchmark forces."""
    def run(vsm, images, missing, minimum_size_scale=4.0, minimum_size=224,
            max_search_steps=None, **kw):
        import vstar_tpu_torch.eval.batched_bench as BB
        import vstar_tpu_torch.search.batched as B
        saved = BB.run_grouped_searches
        BB.run_grouped_searches = B.run_grouped_searches
        try:
            return fn(vsm, images, missing, minimum_size_scale,
                      minimum_size, max_search_steps, **kw)
        finally:
            BB.run_grouped_searches = saved
    return run


FAULTS = {
    "vqa_token": ("vstar_tpu_torch.eval.vqa_engine", "speculative_decode",
                  bump_token),
    "option_loss": ("vstar_tpu_torch.eval.vqa_engine", "score_options",
                    bump_losses),
    "detection": ("vstar_tpu_torch.models.vsm", "vsm_detection",
                  shift_boxes),
    "search_ends_early": ("vstar_tpu_torch.search.batched",
                          "run_batched_searches", one_step_less),
    "another_patch": ("vstar_tpu_torch.search.policy", "get_sub_patches",
                      children_reversed),
    "search_bypassed": ("vstar_tpu_torch.eval.batched_bench",
                        "run_search_phase", search_bypassed),
}


def first_token_loc(fn):
    """The VSM's first served token made [LOC] (and no later one), so
    every detection has boxes and a heatmap: the state the heads read is
    the last prompt position's, which the token does not change."""
    def run(*a, **k):
        res = fn(*a, **k)
        later = res.tokens[:, 1:]
        later[later == LOC] = LOC + 1
        res.tokens[:, 0] = LOC
        return res
    return run


@pytest.fixture
def found(monkeypatch):
    import vstar_tpu_torch.models.vsm as m
    for name in ("speculative_decode", "greedy_decode"):
        monkeypatch.setattr(m, name, first_token_loc(getattr(m, name)))


def offset_dropped(fn):
    def run(*a, **k):
        results, failed = fn(*a, **k)
        for boxes in results:
            for b in boxes:
                b["bbox"][0] -= 37.0
        return results, failed
    return run


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_not_correct(workload, fault, monkeypatch):
    mod, name, wrap = FAULTS[fault]
    m = importlib.import_module(mod)
    monkeypatch.setattr(m, name, wrap(getattr(m, name)))
    res, _ = tiny_run(workload)
    assert res["correct"] is False


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    res, _ = tiny_run(workload)
    assert res["correct"] is True
    assert res["values"]["search_mismatch"] == 0


@pytest.mark.parametrize("workload", CELLS)
def test_found_objects_sound_and_offset_fault(workload, found, monkeypatch):
    """With a [LOC] in every VSM row the heatmaps steer the searches and
    each search reports a box: a sound run walks every patch as the
    reference does and is correct; with each final box left in its
    patch's frame it is not."""
    res, _ = tiny_run(workload)
    v = res["values"]
    assert res["correct"] is True and v["search_found"] == 1.0
    assert v["search_mismatch"] == 0 and v["search_margin"] is not None
    import vstar_tpu_torch.eval.batched_bench as BB
    monkeypatch.setattr(BB, "run_search_phase",
                        offset_dropped(BB.run_search_phase))
    res, _ = tiny_run(workload)
    assert res["correct"] is False
    assert res["values"]["det_box_err"] > 1e-3
    assert torch.isfinite(torch.tensor(res["values"]["det_box_err"]))
