"""Host data pipeline — the port of ``repro/data/pipeline.py``: per-host
sharding and a background prefetcher.

- Each process reads only its shard: ``host_shard_info`` is (rank, world
  size) of ``torch.distributed`` when a process group is initialized, else
  (0, 1).
- ``Prefetcher`` keeps ``depth`` batches ready on a thread, so making the
  next host batch overlaps the device's step.
- Stateless resume: the stream's position is the step counter, which the
  checkpoint stores; a restart makes batches from that step on.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import torch


class Prefetcher:
    """Yields ``(step, make_batch(step))`` for ``start_step``,
    ``start_step + 1``, ... in order, made ``depth`` ahead on a thread;
    ``close`` stops it. A batch is made once (the reference makes it again
    at each retry of a full queue), and an exception of ``make_batch``
    reaches the consumer instead of stopping the thread silently."""

    def __init__(self, make_batch: Callable[[int], dict], start_step: int,
                 depth: int = 2):
        self._make = make_batch
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        item = None
        while not self._stop.is_set():
            if item is None:
                try:
                    item = (step, self._make(step))
                except Exception as e:           # raised by __iter__
                    item = (step, e)
            try:
                self._q.put(item, timeout=0.5)
            except queue.Full:
                continue
            if isinstance(item[1], Exception):
                return
            item = None
            step += 1

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        while True:
            step, batch = self._q.get()
            if isinstance(batch, Exception):
                raise batch
            yield step, batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)


def host_shard_info() -> tuple[int, int]:
    """(this process's rank, the world size) of the initialized
    ``torch.distributed`` process group, else (0, 1)."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank(), torch.distributed.get_world_size()
    return 0, 1
