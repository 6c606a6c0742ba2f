"""The one traffic generator: images, questions and options from a mix
file's parameters and --seed.

The schedule (the order of image sizes and question kinds) comes from
the mix's own `schedule_seed`, so every --seed does the same work in the
same order. --seed draws the pixels, the question words and the
options. Images are smooth noise: a low-resolution random field resized
up (bilinear), then fine grain, in uint8 RGB.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
from PIL import Image


def rng_for(seed: int, stream: str) -> np.random.Generator:
    """A generator of its own for each named stream of one seed."""
    return np.random.default_rng([int(seed) & ((1 << 64) - 1),
                                  sum(map(ord, stream)), len(stream)])


def make_image(rng: np.random.Generator, w: int, h: int) -> Image.Image:
    low = rng.integers(0, 256, (max(2, h // 32), max(2, w // 32), 3),
                       dtype=np.uint8)
    img = Image.fromarray(low).resize((w, h), Image.BILINEAR)
    arr = np.asarray(img, np.int16) + rng.integers(-12, 13, (h, w, 1),
                                                   dtype=np.int16)
    return Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8))


def question(mix: Dict, kind: str, rng: np.random.Generator, tag: str):
    """(question, options, object names) of one kind; `tag` makes the
    question unique (the harness maps records back by it)."""
    objs = mix["objects"]
    if kind == "relative":
        a, b = rng.choice(len(objs), 2, replace=False)
        a, b = objs[a], objs[b]
        q = f"Is the {a} on the left or right side of the {b}? ({tag})"
        return q, ["The {} is on the left side of the {}.".format(a, b),
                   "The {} is on the right side of the {}.".format(a, b)], \
            [a, b]
    o = objs[int(rng.integers(len(objs)))]
    attr = mix["attributes"][int(rng.integers(len(mix["attributes"])))]
    vals = list(rng.choice(mix["values"][attr], mix["options"], replace=False))
    q = f"What is the {attr} of the {o}? ({tag})"
    return q, [f"The {attr} of the {o} is {v}." for v in vals], [o]


class EvalStream:
    """Groups of `group_size` samples, one after another. Group kinds
    follow the mix's `cycle` in its order (attribute / relative, V*Bench's
    split), image sizes from `sizes` in the schedule's order (two groups
    of 8 take the 16 sizes once)."""

    def __init__(self, mix: Dict, seed: int, stream: str = "eval"):
        self.mix, self.rng = mix, rng_for(seed, stream)
        self.order = rng_for(mix["schedule_seed"], "schedule")
        self.kinds: List[str] = []
        self.pool: List[tuple] = []
        self.g = 0

    def next(self, kind: str = None) -> List[Dict]:
        mix, rng = self.mix, self.rng
        if kind is None:
            if not self.kinds:
                self.kinds = list(reversed(mix["cycle"]))
            kind = self.kinds.pop()
        samples = []
        for i in range(mix["group_size"]):
            if not self.pool:
                sizes = [tuple(x) for x in mix["sizes"]]
                self.pool = [sizes[j]
                             for j in self.order.permutation(len(sizes))]
            w, h = self.pool.pop()
            q, opts, names = question(mix, kind, rng, f"image {self.g}.{i}")
            samples.append({"image": make_image(rng, w, h), "question": q,
                            "options": opts, "objects": names, "kind": kind})
        self.g += 1
        return samples
