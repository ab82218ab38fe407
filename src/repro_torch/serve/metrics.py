"""Serving telemetry — the port of ``repro/serve/metrics.py``: throughput,
time-to-first-token, request latency percentiles, cache-pool byte
accounting, a per-step timeline and per-site quant-health aggregates.

The engine calls the ``request_*`` hooks as requests move through their
lifecycle and ``decode_step`` once per batched step; ``summary()`` folds
everything into a JSON-friendly dict (the schema the throughput benchmark
emits). The clock is injectable for deterministic tests.

The timeline is the aggregate's raw material: one row per decode step
(batch fill, free pages, step duration), kept in a bounded ring buffer
(like ``TraceRecorder``) so a long-running engine cannot grow host memory
without bound — the aggregates (``batch_fill_mean``, ``free_pages_min``)
are maintained as exact running values, so ``summary()`` is unaffected by
rows the ring dropped (``timeline_dropped`` counts them). TTFT is
attributed into queue wait (submitted→admitted) and compute
(admitted→first token) — the split that tells an operator whether to add
capacity or speed up prefill.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable

import numpy as np


@dataclass
class _ReqTiming:
    submitted: float
    admitted: float | None = None
    first_token: float | None = None
    finished: float | None = None
    prompt_len: int = 0
    gen_len: int = 0


def _pct(xs: list[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if xs else 0.0


def _mean(xs) -> float:
    return float(np.mean(np.asarray(xs))) if len(xs) else 0.0


@dataclass
class _SiteHealth:
    clipped: int = 0
    total: int = 0
    drift_sum: float = 0.0
    drift_n: float = 0.0

    def as_dict(self) -> dict:
        return {
            "clipped": self.clipped,
            "total": self.total,
            "clip_fraction": self.clipped / self.total if self.total else 0.0,
            "scale_drift_log2": (self.drift_sum / self.drift_n
                                 if self.drift_n else 0.0),
        }


@dataclass
class ServeMetrics:
    clock: Callable[[], float] = time.monotonic
    _req: dict[int, _ReqTiming] = field(default_factory=dict)
    _t0: float | None = None
    _t_end: float | None = None
    decode_steps: int = 0
    decode_tokens: int = 0      # tokens produced by batched decode steps
    prefill_tokens: int = 0     # prompt tokens actually COMPUTED by prefill
    prompt_tokens: int = 0      # prompt tokens submitted through prefill
                                # (computed + prefix-cache hits); equals
                                # prefill_tokens when no cache is attached
    preemptions: int = 0
    # speculative-decoding counters (engine-maintained; see spec_step)
    spec_steps: int = 0         # batched verify steps run
    spec_slots: int = 0         # slot-steps verified (slots x steps)
    spec_proposed: int = 0      # draft tokens proposed to the target
    spec_accepted: int = 0      # draft tokens that passed rejection
    spec_emitted: int = 0       # tokens emitted by spec steps (post-trunc)
    # prefix-cache counters (serve/prefix.py; engine-maintained)
    prefix_hit_tokens: int = 0  # prompt tokens served from cached pages
    cow_forks: int = 0          # copy-on-write page copies (mid-page hits)
    prefix_evictions: int = 0   # LRU leaf evictions under page pressure
    pages_saved: int = 0        # physical pages NOT allocated thanks to
                                # sharing (sum of shared spans at admission)
    # one (prompt_len, hit_tokens) per prefill, in order: what each prefill
    # computed, so a caller can count its chunk steps
    prefills: list = field(default_factory=list)
    num_slots: int = 0          # pool width (set by the engine; 0: unknown)
    cache_bytes: int = 0        # resident KV pool bytes (set by the engine)
    cache_bytes_fp32: int = 0   # what the same pool would cost unquantized
    state_bytes: int = 0        # resident recurrent-state pool bytes
                                # (SSM/RWKV sublayers; 0 for attn-only archs)
    state_bytes_fp32: int = 0   # fp32 cost of the same state pool
    # one row per decode step: {"t", "step", "n_active", "free_pages", "dur"}
    # — a bounded ring (oldest rows dropped past capacity; aggregates stay
    # exact via the running values below)
    timeline_capacity: int = 65536
    timeline: deque = None  # type: ignore[assignment]
    timeline_dropped: int = 0
    _free_min: int | None = None
    # surfaced by the engine before summary(): trace-ring drops and the
    # process CounterRegistry snapshot
    trace_dropped: int = 0
    counter_totals: dict = field(default_factory=dict)
    _health: dict[str, _SiteHealth] = field(default_factory=dict)

    def __post_init__(self):
        if self.timeline is None:
            self.timeline = deque(maxlen=self.timeline_capacity)

    # ---- lifecycle hooks ----------------------------------------------
    def _timing(self, rid: int) -> _ReqTiming:
        # robust to hooks firing out of order (a caller driving the engine
        # directly may admit/finish a request it never "submitted")
        t = self._req.get(rid)
        if t is None:
            t = self._req[rid] = _ReqTiming(submitted=self.clock())
        return t

    def request_submitted(self, rid: int) -> None:
        self._req[rid] = _ReqTiming(submitted=self.clock())

    def request_admitted(self, rid: int, prompt_len: int) -> None:
        t = self._timing(rid)
        # a re-admitted (preempted) request keeps its original timings
        if t.admitted is None:
            t.admitted = self.clock()
            t.prompt_len = prompt_len
        if self._t0 is None:
            self._t0 = self.clock()

    def request_first_token(self, rid: int) -> None:
        t = self._timing(rid)
        if t.first_token is None:
            t.first_token = self.clock()

    def request_finished(self, rid: int, gen_len: int) -> None:
        t = self._timing(rid)
        t.finished = self.clock()
        t.gen_len = gen_len
        self._t_end = t.finished

    def decode_step(self, n_active: int, free_pages: int | None = None,
                    dur: float | None = None) -> None:
        self.decode_steps += 1
        self.decode_tokens += n_active
        if free_pages is not None:
            self._free_min = free_pages if self._free_min is None \
                else min(self._free_min, free_pages)
        if self.timeline.maxlen is not None \
                and len(self.timeline) == self.timeline.maxlen:
            self.timeline_dropped += 1
        self.timeline.append({
            "t": self.clock(), "step": self.decode_steps,
            "n_active": n_active, "free_pages": free_pages, "dur": dur})

    def prefill(self, n_tokens: int, computed: int | None = None) -> None:
        """One request prefilled: ``n_tokens`` prompt positions, of which
        ``computed`` were actually run through the model (the rest were
        served from the prefix cache; default: all of them)."""
        computed = n_tokens if computed is None else computed
        self.prompt_tokens += n_tokens
        self.prefill_tokens += computed
        self.prefills.append((n_tokens, n_tokens - computed))

    def prefix_hit(self, hit_tokens: int, pages: int) -> None:
        self.prefix_hit_tokens += hit_tokens
        self.pages_saved += pages

    def cow_forked(self) -> None:
        self.cow_forks += 1

    def preempted(self) -> None:
        self.preemptions += 1

    def spec_step(self, n_slots: int, proposed: int, accepted: int,
                  emitted: int) -> None:
        """One speculative verify step: ``n_slots`` slots verified
        ``proposed`` draft tokens total, of which ``accepted`` passed the
        rejection test; ``emitted`` tokens actually left the engine
        (accepted + the bonus/replacement token per slot, truncated by
        max_new/eos)."""
        self.spec_steps += 1
        self.spec_slots += n_slots
        self.spec_proposed += proposed
        self.spec_accepted += accepted
        self.spec_emitted += emitted

    # ---- quant health ---------------------------------------------------
    def record_health(self, site: str, clipped: int, total: int,
                      drift_sum: float = 0.0, drift_n: float = 0.0) -> None:
        """Accumulate one step's (clipped, total) counts — host ints, the
        engine converts the device aggregates — and optional scale-drift
        (|Δlog2| sum, count) for sites that re-choose scales."""
        h = self._health.setdefault(site, _SiteHealth())
        h.clipped += int(clipped)
        h.total += int(total)
        h.drift_sum += float(drift_sum)
        h.drift_n += float(drift_n)

    # ---- summary -------------------------------------------------------
    def summary(self) -> dict:
        done = [t for t in self._req.values() if t.finished is not None]
        ttft = [t.first_token - t.submitted for t in done
                if t.first_token is not None]
        ttft_queue = [t.admitted - t.submitted for t in done
                      if t.admitted is not None]
        ttft_compute = [t.first_token - t.admitted for t in done
                        if t.first_token is not None and t.admitted is not None]
        lat = [t.finished - t.submitted for t in done]
        # wall clock must include still-running requests — using the last
        # *finished* time while work is in flight inflates tokens_per_s
        running = any(t.admitted is not None and t.finished is None
                      for t in self._req.values())
        t_end = self.clock() if (running or self._t_end is None) \
            else self._t_end
        wall = (t_end - self._t0) if self._t0 is not None else 0.0
        total_gen = sum(t.gen_len for t in done)
        # exact running aggregates — independent of timeline-ring drops:
        # every decode_step added n_active to decode_tokens, so the mean
        # fill is decode_tokens / decode_steps
        fill_mean = (self.decode_tokens / self.decode_steps
                     if self.decode_steps else 0.0)
        return {
            "requests_completed": len(done),
            "generated_tokens": total_gen,
            "prefill_tokens": self.prefill_tokens,
            "prompt_tokens": self.prompt_tokens,
            "decode_steps": self.decode_steps,
            "preemptions": self.preemptions,
            # prefix cache: hit rate over submitted prompt tokens, plus the
            # raw counters (PR 6 span schema: flat keys, JSON scalars)
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prefix_hit_rate": (self.prefix_hit_tokens / self.prompt_tokens
                                if self.prompt_tokens else 0.0),
            "cow_forks": self.cow_forks,
            "prefix_evictions": self.prefix_evictions,
            "pages_saved": self.pages_saved,
            "wall_s": wall,
            "tokens_per_s": total_gen / wall if wall > 0 else 0.0,
            "ttft_p50_s": _pct(ttft, 50), "ttft_p95_s": _pct(ttft, 95),
            "ttft_p99_s": _pct(ttft, 99),
            "ttft_queue_p50_s": _pct(ttft_queue, 50),
            "ttft_compute_p50_s": _pct(ttft_compute, 50),
            "latency_p50_s": _pct(lat, 50), "latency_p95_s": _pct(lat, 95),
            "batch_fill_mean": fill_mean,
            "batch_fill_frac": (fill_mean / self.num_slots
                                if self.num_slots else 0.0),
            "free_pages_min": int(self._free_min)
                              if self._free_min is not None else 0,
            "timeline_dropped": self.timeline_dropped,
            "trace_dropped": self.trace_dropped,
            "counter_totals": dict(self.counter_totals),
            "cache_bytes": self.cache_bytes,
            "cache_bytes_fp32": self.cache_bytes_fp32,
            "cache_reduction": (self.cache_bytes_fp32 / self.cache_bytes
                                if self.cache_bytes else 0.0),
            "state_bytes": self.state_bytes,
            "state_bytes_fp32": self.state_bytes_fp32,
            "state_reduction": (self.state_bytes_fp32 / self.state_bytes
                                if self.state_bytes else 0.0),
            "quant_health": {s: h.as_dict()
                             for s, h in sorted(self._health.items())},
            # speculative decoding: acceptance rate over proposed draft
            # tokens and mean tokens emitted per verified slot-step (the
            # >1.0 figure is the whole point of drafting)
            "spec": {
                "steps": self.spec_steps,
                "proposed": self.spec_proposed,
                "accepted": self.spec_accepted,
                "emitted": self.spec_emitted,
                "acceptance_rate": (self.spec_accepted / self.spec_proposed
                                    if self.spec_proposed else 0.0),
                "tokens_per_step": (self.spec_emitted / self.spec_slots
                                    if self.spec_slots else 0.0),
            },
        }
