"""Input-pipeline prefetching: overlap host-side data work with device steps.

The reference overlaps sampling/decode/collate with the train step through
`DataLoader(num_workers=2, pin_memory=True)` worker processes
(VisualSearch/train.py:70-75). The equivalent here is thread-based: the
expensive per-sample work (JPEG decode, PIL resizes, numpy mask decode)
happens in C extensions that release the GIL, so background threads overlap
both the remaining Python collate work and the jitted device step without
process-spawn/serialization overhead.

Two shapes:
  * `prefetch(iterator, depth)` — run an (inherently serial, e.g. seeded
    sampling) iterator in one background thread with a bounded queue.
  * `prefetch_map(fn, items, workers, depth)` — ordered parallel map for
    index-addressable work (the VQA SFT `dataset[i]` + collate path).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")
U = TypeVar("U")

_SENTINEL = object()


class PrefetchIterator:
    """Iterate `src` in a daemon thread, keeping up to `depth` finished
    items queued. Exceptions from the producer re-raise at the consuming
    `next()`; `close()` releases the thread without draining `src`."""

    def __init__(self, src: Iterable[T], depth: int = 2):
        assert depth >= 1
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(iter(src),),
                                        daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Blocking put that gives up when close() is requested; True if
        the item was enqueued."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, it: Iterator[T]):
        try:
            for item in it:
                if not self._put(item):
                    return
            self._put(_SENTINEL)
        except BaseException as e:  # propagate to the consumer
            self._put(e)

    def __iter__(self):
        return self

    def __next__(self) -> T:
        if self._stop.is_set():
            raise StopIteration
        item = self._q.get()
        if item is _SENTINEL:
            self._stop.set()
            raise StopIteration
        if isinstance(item, BaseException):
            self._stop.set()
            raise item
        return item

    def close(self):
        """Stop producing; safe to call mid-iteration (epoch cut short)."""
        self._stop.set()
        # unblock a producer waiting on a full queue
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)


def prefetch(src: Iterable[T], depth: int = 2) -> PrefetchIterator:
    return PrefetchIterator(src, depth)


def prefetch_map(fn: Callable[[T], U], items: Iterable[T],
                 workers: int = 2, depth: int = 4) -> Iterator[U]:
    """Ordered `map(fn, items)` with up to `workers` threads and at most
    `depth` results in flight. Results yield in submission order, so
    deterministic pipelines stay deterministic."""
    assert workers >= 1 and depth >= 1
    it = iter(items)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        pending = []
        try:
            for item in it:
                pending.append(pool.submit(fn, item))
                if len(pending) >= depth:
                    yield pending.pop(0).result()
            while pending:
                yield pending.pop(0).result()
        finally:
            for f in pending:
                f.cancel()
