"""repro_torch.obs — the port's telemetry, a copy of ``repro.obs`` in
PyTorch: counters, event traces, spans, export and the memory ledger.

- ``counters``: host ``CounterRegistry`` + the quant-health aggregates
  (clip / saturation counts, scale drift) as plain torch functions, integer
  for integer the reference's; on the card the serving and training paths
  take the same counts from the kernels that encode the values.
- ``trace``: host-side ring-buffered ``TraceRecorder`` — engine, scheduler
  and train-driver structured events, no device work.
- ``ledger``: byte-accurate live ``MemoryLedger`` — every allocation site
  (params, moments, residuals, KV/state pools, prefix pages) reports in;
  per-phase peak watermarks, a reconcile against the CUDA allocator, the
  live reduction-vs-fp32 figure.
- ``spans``: per-request span trees derived from the flat event log.
- ``export``: JSONL + Chrome-trace (Perfetto) writers.
"""
from .counters import (CounterRegistry, fraction, kernel_costs,
                       pow2_clip_stats, record_kernel_call, registry,
                       saturation_counts, scale_drift_stats, tree_sat_stats)
from .export import (chrome_trace, read_jsonl, write_chrome_trace,
                     write_jsonl)
from .ledger import PHASES, MemoryLedger, device_breakdown, tensor_bytes
from .spans import Span, check_nesting, request_spans
from .trace import Event, TraceRecorder

__all__ = [
    "CounterRegistry", "registry", "record_kernel_call", "kernel_costs",
    "pow2_clip_stats", "saturation_counts", "scale_drift_stats",
    "tree_sat_stats", "fraction",
    "Event", "TraceRecorder",
    "MemoryLedger", "device_breakdown", "tensor_bytes", "PHASES",
    "Span", "request_spans", "check_nesting",
    "write_jsonl", "read_jsonl", "chrome_trace", "write_chrome_trace",
]
