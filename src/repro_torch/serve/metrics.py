"""Serving telemetry — the port of ``repro/serve/metrics.py`` trimmed to
the port's serving path: throughput, time-to-first-token (split into queue
wait and compute), request latency percentiles, batch fill, cache-pool
bytes and recurrent-state pool bytes, the prefix-cache counters and the speculative-decoding counters.
The clock is injectable for deterministic tests; host-side only."""
from __future__ import annotations

import time
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
                                # (computed + prefix-cache hits)
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
    num_slots: int = 0          # pool width (set by the engine)
    cache_bytes: int = 0        # resident KV pool bytes (set by the engine)
    cache_bytes_fp32: int = 0   # what the same pool would cost unquantized
    state_bytes: int = 0        # resident recurrent-state pool bytes
    state_bytes_fp32: int = 0   # fp32 cost of the same state pool
    _free_min: int | None = None

    def _timing(self, rid: int) -> _ReqTiming:
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

    def decode_step(self, n_active: int, free_pages: int | None) -> None:
        """One decode step of ``n_active`` slots; ``free_pages`` is None
        for an unpaged (pure-SSM) engine."""
        self.decode_steps += 1
        self.decode_tokens += n_active
        if free_pages is not None:
            self._free_min = free_pages if self._free_min is None \
                else min(self._free_min, free_pages)

    def prefill(self, n_tokens: int, computed: int | None = None) -> None:
        """One request prefilled: ``n_tokens`` prompt positions, of which
        ``computed`` were run through the model (the rest were served from
        the prefix cache; default: all of them)."""
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
        ``proposed`` draft tokens, ``accepted`` of them passed the
        rejection test, and ``emitted`` tokens left the engine (the
        accepted prefix plus the next token per slot, cut at eos or
        max_new_tokens)."""
        self.spec_steps += 1
        self.spec_slots += n_slots
        self.spec_proposed += proposed
        self.spec_accepted += accepted
        self.spec_emitted += emitted

    def summary(self) -> dict:
        done = [t for t in self._req.values() if t.finished is not None]
        ttft = [t.first_token - t.submitted for t in done
                if t.first_token is not None]
        ttft_queue = [t.admitted - t.submitted for t in done
                      if t.admitted is not None]
        ttft_compute = [t.first_token - t.admitted for t in done
                        if t.first_token is not None and t.admitted is not None]
        lat = [t.finished - t.submitted for t in done]
        running = any(t.admitted is not None and t.finished is None
                      for t in self._req.values())
        t_end = self.clock() if (running or self._t_end is None) \
            else self._t_end
        wall = (t_end - self._t0) if self._t0 is not None else 0.0
        total_gen = sum(t.gen_len for t in done)
        fill_mean = (self.decode_tokens / self.decode_steps
                     if self.decode_steps else 0.0)
        return {
            "requests_completed": len(done),
            "generated_tokens": total_gen,
            "prefill_tokens": self.prefill_tokens,
            "prompt_tokens": self.prompt_tokens,
            "decode_steps": self.decode_steps,
            "preemptions": self.preemptions,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prefix_hit_rate": (self.prefix_hit_tokens / self.prompt_tokens
                                if self.prompt_tokens else 0.0),
            "cow_forks": self.cow_forks,
            "prefix_evictions": self.prefix_evictions,
            "pages_saved": self.pages_saved,
            "wall_s": wall,
            "tokens_per_s": total_gen / wall if wall > 0 else 0.0,
            "ttft_p50_s": _pct(ttft, 50), "ttft_p95_s": _pct(ttft, 95),
            "ttft_queue_p50_s": _pct(ttft_queue, 50),
            "ttft_compute_p50_s": _pct(ttft_compute, 50),
            "latency_p50_s": _pct(lat, 50), "latency_p95_s": _pct(lat, 95),
            "batch_fill_mean": fill_mean,
            "batch_fill_frac": (fill_mean / self.num_slots
                                if self.num_slots else 0.0),
            "free_pages_min": int(self._free_min)
                              if self._free_min is not None else 0,
            "cache_bytes": self.cache_bytes,
            "cache_bytes_fp32": self.cache_bytes_fp32,
            "cache_reduction": (self.cache_bytes_fp32 / self.cache_bytes
                                if self.cache_bytes else 0.0),
            "state_bytes": self.state_bytes,
            "state_bytes_fp32": self.state_bytes_fp32,
            "state_reduction": (self.state_bytes_fp32 / self.state_bytes
                                if self.state_bytes else 0.0),
            # acceptance over proposed draft tokens, and tokens emitted per
            # verified slot-step
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
