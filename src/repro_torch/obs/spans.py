"""Per-request span reconstruction from a flat event stream.

The recorder stores flat events; spans are derived on demand — a request
span runs submit→retire and contains one "scheduled" child per residency
(admit→preempt or admit→retire; a preempted request is re-admitted later,
so it can have several), and each residency contains its prefill-chunk
spans. Deriving instead of recording spans keeps the emit path trivial and
makes the nesting a pure function of the event log — the lifecycle test
(admit→preempt→resume→retire) asserts on exactly this structure.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterable

from .trace import Event


@dataclass
class Span:
    name: str
    start: float
    end: float | None = None            # None: still open at end of log
    fields: dict[str, Any] = field(default_factory=dict)
    children: list["Span"] = field(default_factory=list)

    @property
    def dur(self) -> float | None:
        return None if self.end is None else self.end - self.start


def request_spans(events: Iterable[Event]) -> dict[Any, Span]:
    """{rid: request span} with scheduled-residency children.

    Events must be in emit order (the recorder guarantees it). Requests
    still in flight at the end of the log yield open spans (end=None).
    """
    spans: dict[Any, Span] = {}
    open_res: dict[Any, Span] = {}      # rid -> current residency span

    def req(rid, ts) -> Span:
        if rid not in spans:
            spans[rid] = Span("request", ts, fields={"rid": rid})
        return spans[rid]

    for e in events:
        rid = e.fields.get("rid")
        if e.kind == "submit":
            spans[rid] = Span("request", e.ts, fields=dict(e.fields))
        elif e.kind == "admit":
            res = Span("scheduled", e.ts, fields=dict(e.fields))
            req(rid, e.ts).children.append(res)
            open_res[rid] = res
        elif e.kind in ("prefill_chunk", "prefill"):
            res = open_res.get(rid)
            if res is not None:
                dur = e.fields.get("dur", 0.0) or 0.0
                res.children.append(Span(e.kind, e.ts - dur, e.ts,
                                         fields=dict(e.fields)))
        elif e.kind == "preempt":
            res = open_res.pop(rid, None)
            if res is not None:
                res.end = e.ts
                res.fields["outcome"] = "preempted"
        elif e.kind == "retire":
            res = open_res.pop(rid, None)
            if res is not None:
                res.end = e.ts
                res.fields["outcome"] = "retired"
            r = req(rid, e.ts)
            r.end = e.ts
            r.fields.setdefault("reason", e.fields.get("reason"))
    return spans


def check_nesting(span: Span) -> bool:
    """True iff every child interval sits inside its parent (closed spans
    only) and children are in start order — the structural invariant the
    lifecycle test asserts."""
    prev = span.start
    for c in span.children:
        if c.start < span.start - 1e-9 or c.start < prev - 1e-9:
            return False
        if span.end is not None and c.end is not None \
                and c.end > span.end + 1e-9:
            return False
        prev = c.start
        if not check_nesting(c):
            return False
    return True
