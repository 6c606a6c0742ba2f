"""Training metrics & meters (copy of vstar_tpu/utils/metrics.py).

Counterpart of VisualSearch/utils/utils.py:47-146: AverageMeter and
ProgressMeter. The JAX package's cross-host `all_reduce` is left out:
under a mesh the port's steps return metrics that are already the whole
batch's on every rank (core/mesh.Mesh.batch_sum).
"""

from __future__ import annotations

import enum
import time
from typing import List


class Summary(enum.Enum):
    NONE = 0
    AVERAGE = 1
    SUM = 2
    COUNT = 3


class AverageMeter:
    """Running value/avg/sum/count (utils/utils.py:47-110)."""

    def __init__(self, name: str, fmt: str = ":f",
                 summary_type: Summary = Summary.AVERAGE):
        self.name = name
        self.fmt = fmt
        self.summary_type = summary_type
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)

    def __str__(self):
        return f"{self.name} {self.val:.4f} ({self.avg:.4f})"


class ProgressMeter:
    def __init__(self, num_batches: int, meters: List[AverageMeter],
                 prefix: str = ""):
        self.num_batches = num_batches
        self.meters = meters
        self.prefix = prefix

    def display(self, batch: int) -> str:
        entries = [f"{self.prefix}[{batch}/{self.num_batches}]"]
        entries += [str(m) for m in self.meters]
        line = "\t".join(entries)
        print(line, flush=True)
        return line


class StepTimer:
    """batch_time / data_time bookkeeping (train.py:424-425,464,501-503)."""

    def __init__(self):
        self.batch_time = AverageMeter("batch_time", ":.3f")
        self.data_time = AverageMeter("data_time", ":.3f")
        self._t = time.perf_counter()

    def data_loaded(self):
        now = time.perf_counter()
        self.data_time.update(now - self._t)

    def step_done(self):
        now = time.perf_counter()
        self.batch_time.update(now - self._t)
        self._t = now
