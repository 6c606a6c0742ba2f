"""Serving over a mesh: rank 0's front end and the ranks that follow it.

This module has no counterpart in vstar_tpu. JAX serves a mesh from one
controller that issues every device program itself. Under torch every
rank is a process (`torchrun --nproc-per-node N`), and a sharded engine
(core/mesh.serving_params) runs collectives in every forward, so every
rank must make the same engine calls, in the same order, on the same
inputs. Rank 0 binds the HTTP server (or runs the demo's front end) and,
before each engine call, broadcasts what it is about to run; the other
ranks run `follow` in place of a front end, make the same call and drop
its records.

Messages, each a (kind, payload) pair broadcast by rank 0:
  * ("answer", (image, question, options)): one SealService request;
  * ("wave", [(image, question, options), ...]): one wave of
    ContinuousSealService, after its decode filter;
  * ("tick", None): rank 0 is idle (sent when nothing was sent for a
    quarter of the group's timeout, so that a follower waiting for work
    does not reach it);
  * ("stop", None): the front end closed; the followers return.
Images travel as decoded uint8 arrays [H, W, 3], after rank 0 has
decoded them and sanitised the text, so that a corrupt upload fails on
rank 0 alone, before any collective. The messages go over a gloo group
made for host objects (dist.new_group(backend="gloo")), never over NCCL.

After each engine call the ranks agree on its outcome (`agreed`):
  * it succeeded everywhere: rank 0 answers;
  * it raised on every rank (an error of the request's inputs, which
    every rank reaches alike): the request or wave fails with that
    error on rank 0, and serving goes on;
  * it raised on some ranks only (one rank out of memory, a rank that
    died): the world fails. Every rank raises WorldFailure and exits
    non-zero. The agreement itself is bounded by the serving group's
    timeout; a rank left waiting in a collective of the engines ends at
    the mesh's process group timeout.
"""

from __future__ import annotations

import datetime
import threading
import time
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from PIL import Image

TIMEOUT_S = 600.0


class WorldFailure(RuntimeError):
    """The ranks parted: an engine call failed on some ranks and not on
    the others, or a rank stopped answering the serving group."""


def image_array(image: Image.Image) -> np.ndarray:
    """An image as the uint8 [H, W, 3] array the messages carry."""
    return np.asarray(image.convert("RGB"), dtype=np.uint8)


class Ranks:
    """This process's place in a world of serving ranks: `rank`, `world`,
    and the gloo group the messages and agreements go over, whose
    collectives time out after `timeout_s`. All ranks must construct it
    together (dist.new_group is collective). On rank 0, `lock` orders
    every message with the engine calls it announces."""

    def __init__(self, timeout_s: float = TIMEOUT_S):
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.timeout_s = timeout_s
        self.heartbeat_s = timeout_s / 4
        self.group = dist.new_group(
            backend="gloo", timeout=datetime.timedelta(seconds=timeout_s))
        self.lock = threading.RLock()
        self.failure: Optional[WorldFailure] = None
        self._on_failure: List[Callable[[], None]] = []
        self._last_send = time.monotonic()
        self._stopped = threading.Event()

    @property
    def leader(self) -> bool:
        return self.rank == 0

    # -- messages ------------------------------------------------------------

    def _send(self, kind: str, payload=None) -> None:
        dist.broadcast_object_list([(kind, payload)], src=0,
                                   group=self.group)
        self._last_send = time.monotonic()

    def receive(self):
        """A follower: the next (kind, payload) from rank 0. A rank 0 that
        sends nothing within the timeout fails the world."""
        box = [None]
        try:
            dist.broadcast_object_list(box, src=0, group=self.group)
        except Exception as e:
            raise self.fail(WorldFailure(
                f"rank {self.rank}: no message from rank 0: {e}")) from e
        return box[0]

    def lead(self, kind: str, payload, run: Callable):
        """Rank 0: announce (kind, payload), then run() as every rank runs
        it, and return its result as the ranks agree on it."""
        with self.lock:
            if self.failure is not None:
                raise self.failure
            try:
                self._send(kind, payload)
            except Exception as e:
                raise self.fail(WorldFailure(
                    f"rank 0: a follower did not take the message: {e}")
                ) from e
            return self.agreed(run)

    def agreed(self, run: Callable):
        """run() on this rank, then the outcome the ranks agree on: the
        result when it succeeded everywhere, its error when it raised on
        every rank, WorldFailure when it raised on some only."""
        try:
            out, err = run(), None
        except Exception as e:
            out, err = None, e
        flag = torch.tensor([0 if err is None else 1], dtype=torch.int64)
        try:
            dist.all_reduce(flag, group=self.group)
        except Exception as e:
            raise self.fail(WorldFailure(
                f"rank {self.rank}: the ranks did not agree within "
                f"{self.timeout_s:g} s (a rank died, or waits in a "
                f"collective of the engines): {e}")) from (err or e)
        failed = int(flag.item())
        if failed == 0:
            return out
        if failed == self.world:
            raise err
        raise self.fail(WorldFailure(
            f"{failed} of {self.world} ranks failed an engine call "
            f"(rank {self.rank}: {err!r})")) from err

    # -- rank 0's lifetime ---------------------------------------------------

    def on_failure(self, fn: Callable[[], None]) -> None:
        """Call fn (once) when the world fails, e.g. to stop a server."""
        self._on_failure.append(fn)
        if self.failure is not None:
            fn()

    def fail(self, failure: WorldFailure) -> WorldFailure:
        if self.failure is None:
            self.failure = failure
            for fn in self._on_failure:
                fn()
        return self.failure

    def start_heartbeat(self) -> None:
        """Rank 0: send a tick whenever nothing was sent for heartbeat_s
        (a quarter of the timeout)."""
        def beat():
            while not self._stopped.wait(self.heartbeat_s / 2):
                with self.lock:
                    if self._stopped.is_set() or self.failure is not None:
                        return
                    if time.monotonic() - self._last_send < \
                            self.heartbeat_s:
                        continue
                    try:
                        self._send("tick")
                    except Exception as e:
                        self.fail(WorldFailure(
                            f"rank 0: a follower did not take a tick: {e}"))
                        return
        threading.Thread(target=beat, daemon=True).start()

    def stop(self) -> None:
        """Rank 0: tell the followers to return (once; nothing after a
        world failure, whose ranks are already failing)."""
        with self.lock:
            if self._stopped.is_set():
                return
            self._stopped.set()
            if self.failure is None:
                self._send("stop")


def for_engines(*engines) -> Optional[Ranks]:
    """The serving Ranks when an engine is sharded over a mesh in a
    process group (collective: every rank calls it), else None."""
    def mesh(e):
        return getattr(getattr(e, "engine", e), "mesh", None)
    if not dist.is_initialized() or all(mesh(e) is None for e in engines):
        return None
    return Ranks()


def follow(service, ranks: Ranks) -> None:
    """A follower rank in place of a front end: each message's engine calls
    (service.run_message), in rank 0's order, records dropped, until
    rank 0 stops. An error every rank reaches is rank 0's to report;
    WorldFailure raises."""
    while True:
        kind, payload = ranks.receive()
        if kind == "stop":
            return
        if kind == "tick":
            continue
        try:
            ranks.agreed(lambda: service.run_message(kind, payload))
        except WorldFailure:
            raise
        except Exception:
            continue
