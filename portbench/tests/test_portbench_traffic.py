"""The traffic generator's schedule, the span arithmetic, and the plain
copy of the forced search's geometry."""

import json

import pytest

from portbench import traffic
from portbench.drivers import common
from portbench.reference import search
from portbench.run import HERE

EVAL = json.load(open(HERE / "traffic" / "vstar_forced.json"))


def small(mix):
    return dict(mix, sizes=[[64, 48], [48, 64], [80, 40]])


def test_eval_groups_follow_the_cycle():
    s = traffic.EvalStream(small(EVAL), 5)
    kinds = [s.next()[0]["kind"] for _ in range(len(EVAL["cycle"]))]
    assert sorted(kinds) == sorted(EVAL["cycle"])
    g = s.next()
    assert len(g) == EVAL["group_size"]
    assert all(len(x["options"]) == (4 if x["kind"] == "attribute" else 2)
               for x in g)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**40 + 3])
def test_same_work_any_seed(seed):
    """Every seed asks the same kinds at the same sizes in the same order;
    only pixels and words differ."""
    a, b = traffic.EvalStream(small(EVAL), seed), \
        traffic.EvalStream(small(EVAL), 1)
    for _ in range(3):
        ga, gb = a.next(), b.next()
        assert [(x["kind"], x["image"].size, len(x["objects"]))
                for x in ga] == [(x["kind"], x["image"].size,
                                  len(x["objects"])) for x in gb]


def test_same_seed_same_inputs():
    a = traffic.EvalStream(small(EVAL), 11).next()
    b = traffic.EvalStream(small(EVAL), 11).next()
    assert [x["question"] for x in a] == [x["question"] for x in b]
    assert a[0]["image"].tobytes() == b[0]["image"].tobytes()


def test_union_of_spans():
    assert common.union_seconds([(0, 2), (1, 3), (5, 6)]) == 4
    assert common.union_seconds([(0, 5), (1, 2)]) == 5


@pytest.mark.parametrize("size", [(2246, 1582), (1024, 768), (3840, 2160),
                                  (1536, 2048), (700, 250), (4000, 900)])
def test_children_tile_their_patch(size):
    """The sub-patches cover the patch once, by hand: 2 x 2, or 4 in a
    row or a column for a long patch, the remainder in the last."""
    w, h = size
    subs = search.children([10, 20, w, h])
    assert len(subs) == 4
    assert sum(s[2] * s[3] for s in subs) == w * h
    assert min(s[0] for s in subs) == 10 and min(s[1] for s in subs) == 20
    assert max(s[0] + s[2] for s in subs) == 10 + w
    assert max(s[1] + s[3] for s in subs) == 20 + h


def test_expected_steps_by_hand():
    # 1024 x 768: the smallest patch 224; the root and its 512 x 384
    # children expand
    assert search.smallest_size(1024, 768) == 224
    assert search.expected_steps(1024, 768, 3) == 3
    assert search.smallest_size(3840, 2160) == 540
    assert search.expected_steps(200, 300, 3) == 1


def _flat_detect(k):
    import numpy as np
    import torch
    return False, np.zeros(0), np.zeros((0, 4)), torch.zeros(4, 4)


def test_walk_of_a_search_that_finds_nothing():
    """No [LOC]: the heatmaps are nought, every child scores 0, the heap
    takes them in the order they were pushed: the root, its first child,
    its second."""
    forced = EVAL["forced_search"]
    w, h = 1024, 768
    first, second = search.children([0, 0, w, h])[:2]
    good = [[0, 0, w, h], first, second]
    out = search.walk(good, _flat_detect, (w, h), 3, forced)
    assert out["mismatch"] == 0 and out["box"] is None
    wrong = [[0, 0, w, h], search.children([0, 0, w, h])[3], second]
    assert search.walk(wrong, _flat_detect, (w, h), 3, forced)[
        "mismatch"] == 1
    assert search.walk(good[:2], _flat_detect, (w, h), 3, forced)[
        "mismatch"] >= 1
    assert search.walk(good + [first], _flat_detect, (w, h), 3, forced)[
        "mismatch"] >= 1


def test_assign_rows_in_lockstep_order():
    s = [{"name": "cat", "path": [[0, 0, 8, 6], [0, 0, 4, 3]]},
         {"name": "dog", "path": [[0, 0, 10, 6], [0, 0, 5, 3]]},
         {"name": "cat", "path": [[0, 0, 8, 6], [4, 0, 4, 3]]}]
    calls = [{"texts": ["cat", "dog", "cat"],
              "sizes": [(8, 6), (10, 6), (8, 6)]},
             {"texts": ["cat", "dog", "cat"],
              "sizes": [(4, 3), (5, 3), (4, 3)]}]
    rows, unmatched = common.assign_rows(s, calls)
    assert unmatched == 0
    assert rows[(2, 1)] == (calls[1], 2) and rows[(1, 0)] == (calls[0], 1)
    rows, unmatched = common.assign_rows(s, calls[:1])
    assert unmatched == 3
