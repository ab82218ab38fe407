"""Counter registry + quant-health aggregates — the counter half of
``repro_torch.obs``, the port of the reference's ``obs/counters.py``.

Two kinds of counter live here, matching where the information exists:

- **Host counters** (``CounterRegistry``): plain named integers incremented
  from Python, snapshotted into ``ServeMetrics.summary()["counter_totals"]``.
  The reference's kernel wrappers report ``kernel.<name>.calls`` here, one
  per *traced* call of a jitted body (once per compiled specialization); an
  eager program has no traced call, so the port's kernel wrappers do not
  report into the registry. Their launches are counted where they happen,
  in ``kernels.build.LAUNCHES`` (one per launch, exact), which is what the
  card checks read. ``record_kernel_call`` / ``kernel_costs`` are kept for
  callers that want a modelled (kernel, shape) cost table.

- **Device aggregates** (``pow2_clip_stats`` & friends): plain torch
  reductions computed next to a quantization site — clip and saturation
  counts and scale-drift sums. They are integer-exact (int32 counts over
  the f32 quotient ``x.float() / 2**s``), so they agree with the
  reference's integer for integer. On the serving and training paths the
  same counts come out of the kernels that encode the values (the paged
  KV append, the state encode group and the grad edge's fake-quant group
  take an optional counter buffer); these functions are those kernels'
  plain versions and the tests' oracle. Everything is off by default: a
  step only counts when its policy asks for health (``NumericsPolicy.
  health``).

Interpretation: ``clip_fraction`` is the fraction of pre-quant values
outside the representable range (persistent > ~1e-2 on the KV site means
decode amplitudes outgrew the prefill-frozen scale), ``sat_fraction`` the
fraction of *codes* pinned at the grid edge (the post-hoc view of the same
failure), ``scale_drift`` the mean |Δlog2| of re-chosen per-tensor scales
(state-cache amplitude dynamics).
"""
from __future__ import annotations

import threading

import torch

from ..numerics.codecs import _bcast, unpack_int4
from ..numerics.spec import QTensor, QuantSpec, qrange

# ---------------------------------------------------------------------------
# Host counter registry
# ---------------------------------------------------------------------------


class CounterRegistry:
    """Named monotonic host counters. Thread-safe, cheap, process-local.

    Names are dotted paths (``kernel.pe1.calls``); ``snapshot()`` returns a
    plain dict for JSON emission.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._c: dict[str, int] = {}

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._c[name] = self._c.get(name, 0) + n

    def get(self, name: str) -> int:
        return self._c.get(name, 0)

    def reset(self, name: str | None = None) -> None:
        """Reset one counter, or every counter when ``name`` is None."""
        with self._lock:
            if name is None:
                self._c.clear()
            else:
                self._c.pop(name, None)

    def snapshot(self, prefix: str = "") -> dict[str, int]:
        with self._lock:
            return {k: v for k, v in sorted(self._c.items())
                    if k.startswith(prefix)}


#: Process-default registry.
registry = CounterRegistry()


def record_kernel_call(name: str, *, bytes_moved: int = 0,
                       flops: int = 0) -> None:
    """Note one call of a kernel with its modelled cost (the reference's
    per-(kernel, shape) cost table, read back by ``kernel_costs()``)."""
    registry.inc(f"kernel.{name}.calls")
    if bytes_moved:
        registry.inc(f"kernel.{name}.bytes", bytes_moved)
    if flops:
        registry.inc(f"kernel.{name}.flops", flops)


def kernel_costs() -> dict[str, dict[str, int]]:
    """Per-kernel cost table: {kernel: {calls, bytes, flops}}."""
    out: dict[str, dict[str, int]] = {}
    for k, v in registry.snapshot("kernel.").items():
        name, field = k[len("kernel."):].rsplit(".", 1)
        out.setdefault(name, {})[field] = v
    return out


# ---------------------------------------------------------------------------
# Device aggregates (integer-exact)
# ---------------------------------------------------------------------------

def _i32(n, device) -> torch.Tensor:
    return torch.as_tensor(n, dtype=torch.int32, device=device)


def pow2_clip_stats(x: torch.Tensor, scale_log2, bits: int,
                    valid: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(clipped, total) int32 counts of ``x`` against the pow-2 grid at
    ``scale_log2`` (leading-dim broadcast, the codec ``_bcast`` convention).

    ``clipped`` counts pre-quant values strictly outside the representable
    code range — the elements an encode would saturate. ``valid``
    (optional, broadcastable bool) restricts both counts to real rows
    (active slots; padding never counts)."""
    lo, hi = qrange(bits)
    step = torch.exp2(_bcast(scale_log2, x.dim(), x.device).float())
    r = x.float() / step
    outside = (r < lo) | (r > hi)
    if valid is None:
        return (outside.sum(dtype=torch.int32), _i32(x.numel(), x.device))
    v = torch.broadcast_to(valid.bool(), outside.shape)
    return ((outside & v).sum(dtype=torch.int32), v.sum(dtype=torch.int32))


def saturation_counts(qt: QTensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(saturated, total) int32 counts of codes pinned at the grid edge of
    an encoded ``QTensor`` — the post-hoc view of ``pow2_clip_stats``
    (saturated >= clipped: a value exactly at the edge rounds onto it
    without having been clipped). Packed int4x2 codes are unpacked first so
    the count is over logical codes, not stored bytes."""
    spec = qt.spec
    codes = qt.codes
    if spec.kind == "pow2" and spec.packed:
        codes = unpack_int4(codes, qt.shape[-1] if qt.shape else 1)
    if spec.kind == "pow2":
        lo, hi = qrange(spec.bits)
    else:   # blockwise: symmetric ±qmax
        lo, hi = -spec.qmax, spec.qmax
    c = codes.to(torch.int32)
    sat = ((c <= int(lo)) | (c >= int(hi))).sum(dtype=torch.int32)
    return sat, _i32(c.numel(), c.device)


def scale_drift_stats(old_log2: torch.Tensor, new_log2: torch.Tensor,
                      valid: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(|Δlog2| sum, count) of a re-chosen per-tensor scale array — the
    state-cache drift statistic (how fast recurrent-state amplitude moves
    across the pow-2 grid). f32 sum over ``valid`` entries."""
    d = torch.abs(new_log2.float() - old_log2.float())
    if valid is None:
        return d.sum(), torch.tensor(float(d.numel()), device=d.device)
    v = torch.broadcast_to(valid, d.shape).float()
    return (d * v).sum(), v.sum()


def tree_sat_stats(leaves, spec: QuantSpec,
                   scale_for=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(saturated, total) over every floating tensor of ``leaves`` (an
    iterable) encoded under ``spec`` — the grad_edge / dp_wire health
    aggregate. ``scale_for(leaf)`` supplies the pow2 scale per leaf
    (default: per-tensor-max, the clip-free scale the step uses). The
    reference's leaves are stacked over layers: pass the port's per-layer
    tensors of one stacked leaf as one (concatenated) tensor to match."""
    from ..numerics.codecs import encode, per_tensor_max_scale_log2
    sat = tot = None
    for leaf in leaves:
        if not (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()):
            continue
        if spec.kind == "pow2":
            step = (per_tensor_max_scale_log2(leaf, spec)
                    if scale_for is None else scale_for(leaf))
            qt = encode(leaf, spec, step)
        else:
            qt = encode(leaf.reshape(-1), spec)
        s, t = saturation_counts(qt)
        sat = s if sat is None else sat + s
        tot = t if tot is None else tot + t
    if sat is None:
        return _i32(0, None), _i32(0, None)
    return sat, tot


def fraction(count, total) -> torch.Tensor:
    """count / total as f32, 0 when total == 0."""
    t = torch.as_tensor(total, dtype=torch.float32)
    c = torch.as_tensor(count, dtype=torch.float32, device=t.device)
    return torch.where(t > 0, c / torch.clamp(t, min=1.0),
                       torch.zeros((), device=t.device))
