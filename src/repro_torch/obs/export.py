"""Trace export: JSONL for machines, Chrome trace format for Perfetto — a
copy of the reference's ``obs/export.py``; for the same events both write
the same bytes.

JSONL is the archival form — one event per line, ``{"ts", "kind",
**fields}`` — written by the train drivers' ``--trace-out`` flags.
``chrome_trace`` converts the same events into the Chrome Trace Event
format (https://ui.perfetto.dev loads it directly):

- events carrying ``dur`` (prefill, decode_step, train_step) become
  complete slices (ph "X") on a per-kind track;
- the request lifecycle (admit → preempt/retire) becomes async begin/end
  pairs (ph "b"/"e", cat "request", id=rid) so each request renders as one
  horizontal bar spanning its residencies;
- everything else becomes instant events (ph "i").

Timestamps are recorder-clock seconds converted to µs (the format's unit),
rebased to the first event so traces start at t=0.
"""
from __future__ import annotations

import json
from typing import Any, Iterable

from .trace import Event

# stable track ids (tid) so Perfetto groups slices sensibly
_TRACKS = {"decode_step": 1, "prefill": 2, "prefill_chunk": 2,
           "train_step": 1}
_PID = 1


def write_jsonl(events: Iterable[Event], path: str) -> int:
    """Write one JSON object per line; returns the number written."""
    n = 0
    with open(path, "w") as f:
        for e in events:
            f.write(json.dumps(e.to_json()) + "\n")
            n += 1
    return n


def read_jsonl(path: str) -> list[Event]:
    out = []
    with open(path) as f:
        for line in f:
            d = json.loads(line)
            out.append(Event(d.pop("ts"), d.pop("kind"), d))
    return out


def chrome_trace(events: Iterable[Event]) -> dict[str, Any]:
    """Chrome Trace Event JSON for the given events (see module doc)."""
    evs = list(events)
    t0 = evs[0].ts if evs else 0.0

    def us(t: float) -> float:
        return (t - t0) * 1e6

    out: list[dict[str, Any]] = []
    for e in evs:
        args = {k: v for k, v in e.fields.items()}
        dur = e.fields.get("dur")
        if dur is not None:
            out.append({"name": e.kind, "ph": "X", "pid": _PID,
                        "tid": _TRACKS.get(e.kind, 3),
                        "ts": us(e.ts) - dur * 1e6, "dur": dur * 1e6,
                        "args": args})
        elif e.kind == "admit":
            out.append({"name": f"req {e.fields.get('rid')}", "ph": "b",
                        "cat": "request", "id": e.fields.get("rid"),
                        "pid": _PID, "tid": 0, "ts": us(e.ts),
                        "args": args})
        elif e.kind in ("retire", "preempt"):
            out.append({"name": f"req {e.fields.get('rid')}", "ph": "e",
                        "cat": "request", "id": e.fields.get("rid"),
                        "pid": _PID, "tid": 0, "ts": us(e.ts),
                        "args": args})
        else:
            out.append({"name": e.kind, "ph": "i", "pid": _PID,
                        "tid": _TRACKS.get(e.kind, 3), "ts": us(e.ts),
                        "s": "t", "args": args})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome_trace(events: Iterable[Event], path: str) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(events), f)
