"""Ring-buffered structured event recorder — the event half of
``repro_torch.obs``, a copy of the reference's ``obs/trace.py``.

The recorder is pure host-side Python: emitters call ``trace.emit(kind,
**fields)`` from the engine's step loop, the scheduler and the train
driver, never from inside a device step, so an attached recorder issues no
device work and a detached one costs a single ``is None`` check at the call
site. tests/test_torch_obs.py asserts it: a decode step dispatches the same
ATen calls with a recorder attached as without one.

Events are tiny and flat — ``Event(ts, kind, fields)`` with JSON-scalar
fields only — and live in a ``deque(maxlen=capacity)`` ring, so a long
serve run keeps the newest ``capacity`` events and counts what it dropped
(``dropped``). Export (JSONL, Chrome trace) lives in ``export.py``; span
reconstruction (per-request admit→retire trees) in ``spans.py``.

Event kinds emitted by the stack (the trace schema; fields beyond ``ts`` /
``kind`` are per-kind):

====================  =====================================================
kind                  fields
====================  =====================================================
``submit``            rid, prompt_len, max_new
``admit``             rid, slot, pages (pages allocated at admit)
``prefill_chunk``     rid, slot, start, len (one bucketed chunk)
``prefill``           rid, slot, len, dur (whole-prompt wall time)
``first_token``       rid, slot
``decode_step``       step, n_active, free_pages, dur
``preempt``           rid, slot, gen_len (generated tokens folded back)
``retire``            rid, slot, new_tokens, reason ("eos"|"max_new")
``page_alloc``        slot, page, pos (lazy growth in ``ensure_page``)
``page_free``         slot, n (pages released at retire/preempt)
``cache_hit``         rid, slot, hit_tokens, prompt_len (prefix cache)
``cow_fork``          rid, slot, src_page, dst_page, tokens (mid-page hit)
``prefix_evict``      pages, tokens (one LRU leaf freed under pressure)
``state_snapshot``    slot, nbytes
``state_restore``     slot, nbytes
``train_step``        step, loss, dur (train driver loop)
====================  =====================================================
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator


@dataclass(frozen=True)
class Event:
    ts: float                       # recorder-clock seconds
    kind: str
    fields: dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> dict[str, Any]:
        return {"ts": self.ts, "kind": self.kind, **self.fields}


class TraceRecorder:
    """Host-side ring buffer of structured events.

    ``clock`` is injectable (tests drive a deterministic counter, matching
    the ``ServeMetrics`` convention); ``capacity`` bounds memory — overflow
    silently evicts the OLDEST events and bumps ``dropped``. ``enabled``
    gates ``emit`` so a recorder can be muted without detaching it.
    """

    def __init__(self, capacity: int = 65536,
                 clock: Callable[[], float] = time.monotonic):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.clock = clock
        self.enabled = True
        self.dropped = 0
        self._ring: deque[Event] = deque(maxlen=capacity)

    def emit(self, kind: str, **fields: Any) -> None:
        if not self.enabled:
            return
        if len(self._ring) == self.capacity:
            self.dropped += 1
        self._ring.append(Event(self.clock(), kind, fields))

    def events(self, kind: str | None = None) -> list[Event]:
        """Snapshot of buffered events, oldest first (optionally one kind)."""
        if kind is None:
            return list(self._ring)
        return [e for e in self._ring if e.kind == kind]

    def __len__(self) -> int:
        return len(self._ring)

    def __iter__(self) -> Iterator[Event]:
        return iter(list(self._ring))

    def clear(self) -> None:
        self._ring.clear()
        self.dropped = 0
