"""Micro-batching for serving (port of vstar_tpu/serve/batching.py, host
only): the continuous-batching capability the reference lacks (its
Gradio demo is blocking batch-1, app.py:235-255).

Requests arriving within a window are grouped by key (the program shape,
e.g. the prompt bucket) and executed as one device batch; the engines
take [B, ...] inputs already.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, List, Tuple


class MicroBatcher:
    """Groups (key, item) submissions and calls
    `run_batch(key, items) -> list[results]` on batches.

    key = anything hashable that must match for co-batching (e.g. the
    prompt bucket / program shape)."""

    def __init__(self, run_batch: Callable[[Any, List[Any]], List[Any]],
                 max_batch: int = 8, window_ms: float = 5.0):
        self.run_batch = run_batch
        self.max_batch = max_batch
        self.window = window_ms / 1000.0
        self._q: "queue.Queue[Tuple[Any, Any, Future]]" = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, key: Any, item: Any) -> Future:
        fut: Future = Future()
        self._q.put((key, item, fut))
        return fut

    def __call__(self, key: Any, item: Any):
        return self.submit(key, item).result()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)

    def _loop(self):
        while not self._stop.is_set():
            try:
                key, item, fut = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [(item, fut)]
            deadline = time.monotonic() + self.window
            while len(batch) < self.max_batch:
                remain = deadline - time.monotonic()
                if remain <= 0:
                    break
                try:
                    k2, item2, fut2 = self._q.get(timeout=remain)
                except queue.Empty:
                    break
                if k2 != key:
                    # different program shape: push back for the next round
                    self._q.put((k2, item2, fut2))
                    break
                batch.append((item2, fut2))
            items = [b[0] for b in batch]
            try:
                results = self.run_batch(key, items)
                for (_, fut_i), res in zip(batch, results):
                    fut_i.set_result(res)
            except Exception as e:  # pragma: no cover
                for _, fut_i in batch:
                    if not fut_i.done():
                        fut_i.set_exception(e)
