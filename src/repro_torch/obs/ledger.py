"""Live memory ledger: byte-accurate accounting every allocation site
reports into, with per-phase peak watermarks and a reconcile check against
the bytes the process really holds — the port of the reference's
``obs/ledger.py``.

The paper's headline claim is memory (Table 1: ultra memory reduction vs
full-size fp32 training). The ledger makes the byte budget observable
live: the serve engine and the train driver register every resident
allocation site —

==================  =====================================================
site                what it accounts
==================  =====================================================
params              model parameters (TT cores / embeddings) as resident
tt_factor           packed int4x2 TT-factor deploy bytes (train wire)
activation          activation edges under the policy's activation spec
optimizer_moment    int8-blockwise Adam moments (``QTensor.nbytes``)
grad_residual       error-feedback residual of the int8 gradient wire
dp_wire             encoded bytes of one gradient all-reduce
scale_state         managed scale-state tree (log2 exponents)
kv_pool             the paged int8 KV pool (codes + per-slot scales)
state_pool          the recurrent-state pool (mamba/rwkv6 mixers)
draft_*             the speculative draft's params and KV pool
prefix_*            logical vs physical mapped KV pages (uncounted
                    overlay of ``kv_pool`` — see below)
==================  =====================================================

(The reference's ``compile_cache`` site counts bucketed jitted prefill
executables; eager PyTorch compiles none, so the port has no such site.)

Two accounting rules keep the totals honest:

- **No double counting.** Overlay sites describe bytes already counted by
  another site (prefix pages live *inside* the KV pool) and register with
  ``counted=False``: they appear in the summary and in watermark snapshots
  but never in ``total()``.
- **One-sided reconcile.** The ledger tracks the sites the program owns;
  the process also holds batches, workspaces and temporaries. So the
  invariant is subset-shaped: ``total() <= live bytes * (1 + tol)``. On
  the card the live figure is ``torch.cuda.memory_allocated`` of the
  ledger's device (the caching allocator's bytes in live tensors); on the
  CPU no allocator counts live tensors, so the caller passes the figure,
  or the tensors it holds (``reconcile(tensors=...)``: each storage counted
  once). With neither it raises: a reconcile that passes by default would
  check nothing.

Phases and watermarks: ``set_phase`` names the current phase (``init`` /
``prefill`` / ``decode`` / ``train_step``) and every ``set`` updates that
phase's peak watermark (counted total + a per-site byte snapshot at the
peak). Each site also tracks its own all-time ``peak_bytes``.

Host-side Python over sizes only: no ledger call issues device work.
"""
from __future__ import annotations

import torch

PHASES = ("init", "prefill", "decode", "train_step")


class MemoryLedger:
    """Byte ledger over named allocation sites with per-phase watermarks.

    ``device``: where the sites live (``reconcile`` reads the CUDA
    allocator of a CUDA device); None is the CPU."""

    def __init__(self, device=None):
        # site -> {"bytes", "fp32_bytes", "counted", "peak_bytes", "meta"}
        self._sites: dict[str, dict] = {}
        self.phase: str = "init"
        # phase -> {"total_bytes": int, "sites": {name: bytes}}
        self._watermarks: dict[str, dict] = {}
        self.device = None if device is None else torch.device(device)

    # ---- recording ------------------------------------------------------
    def set(self, site: str, nbytes: int, fp32: int | None = None,
            counted: bool = True, **meta) -> None:
        """Report ``site``'s current resident bytes (idempotent overwrite).

        ``fp32`` is the site's fp32-dense shadow — what the same state would
        cost uncompressed (defaults to ``nbytes`` in the reduction figure).
        ``counted=False`` marks an overlay site whose bytes are already
        counted elsewhere (kept out of ``total()``/reconcile)."""
        nbytes = int(nbytes)
        prev = self._sites.get(site)
        peak = max(nbytes, prev["peak_bytes"]) if prev else nbytes
        self._sites[site] = {
            "bytes": nbytes,
            "fp32_bytes": None if fp32 is None else int(fp32),
            "counted": bool(counted),
            "peak_bytes": peak,
            "meta": dict(meta),
        }
        self._touch_watermark()

    def drop(self, site: str) -> None:
        self._sites.pop(site, None)
        self._touch_watermark()

    def set_phase(self, phase: str) -> None:
        """Enter a phase; its watermark starts from the current totals so a
        phase with no subsequent ``set`` still records one."""
        self.phase = str(phase)
        self._touch_watermark()

    def _touch_watermark(self) -> None:
        total = self.total()
        wm = self._watermarks.get(self.phase)
        if wm is None or total > wm["total_bytes"]:
            self._watermarks[self.phase] = {
                "total_bytes": total,
                "sites": {n: s["bytes"] for n, s in self._sites.items()},
            }

    # ---- totals ---------------------------------------------------------
    def get(self, site: str) -> int:
        s = self._sites.get(site)
        return 0 if s is None else s["bytes"]

    def total(self, sites=None) -> int:
        """Counted resident bytes (optionally restricted to ``sites``)."""
        return sum(s["bytes"] for n, s in self._sites.items()
                   if s["counted"] and (sites is None or n in sites))

    def fp32_total(self, sites=None) -> int:
        """fp32-dense shadow of the counted sites (shadow defaults to the
        site's own bytes where none was declared)."""
        return sum(s["fp32_bytes"] if s["fp32_bytes"] is not None
                   else s["bytes"]
                   for n, s in self._sites.items()
                   if s["counted"] and (sites is None or n in sites))

    def reduction_vs_fp32(self, sites=None) -> float:
        """Live "reduction vs fp32-dense baseline" figure (Table 1 shape):
        shadow bytes / resident bytes over the counted sites."""
        t = self.total(sites)
        return float(self.fp32_total(sites)) / t if t else 0.0

    def watermark(self, phase: str) -> dict | None:
        return self._watermarks.get(phase)

    # ---- reconcile ------------------------------------------------------
    def live_bytes(self, tensors=None) -> int:
        """The bytes the ledger is checked against: the CUDA allocator's
        allocated bytes on a CUDA ledger; on the CPU the distinct storages
        of ``tensors`` (raises without them)."""
        if self.device is not None and self.device.type == "cuda":
            return int(torch.cuda.memory_allocated(self.device))
        if tensors is None:
            raise ValueError(
                "reconcile on the CPU needs live_bytes= or tensors=: no "
                "allocator counts the process's live CPU tensors")
        return tensor_bytes(tensors)

    def reconcile(self, tolerance: float = 0.02,
                  live_bytes: int | None = None, tensors=None) -> dict:
        """Check the counted total against the live bytes (see the module
        docstring; ``live_bytes`` given wins, then the card's allocator,
        then ``tensors``). One-sided by design: the ledger must not claim
        more resident bytes than actually live, modulo ``tolerance``."""
        if live_bytes is None:
            live_bytes = self.live_bytes(tensors)
        total = self.total()
        ok = total <= live_bytes * (1.0 + tolerance)
        return {
            "ledger_bytes": int(total),
            "live_bytes": int(live_bytes),
            "tolerance": float(tolerance),
            "coverage_frac": (total / live_bytes) if live_bytes else 0.0,
            "ok": bool(ok),
        }

    # ---- summary --------------------------------------------------------
    def summary(self) -> dict:
        """JSON-friendly snapshot: sites, totals, the live reduction figure
        and per-phase watermarks. (The reference's ``per_device`` comes with
        a mesh, which the port does not have yet: ``device_breakdown`` is
        its figure.)"""
        sites = {}
        for name, s in self._sites.items():
            row = {"bytes": s["bytes"], "peak_bytes": s["peak_bytes"],
                   "counted": s["counted"]}
            if s["fp32_bytes"] is not None:
                row["fp32_bytes"] = s["fp32_bytes"]
            row.update(s["meta"])
            sites[name] = row
        out = {
            "phase": self.phase,
            "sites": sites,
            "total_bytes": self.total(),
            "fp32_total_bytes": self.fp32_total(),
            "reduction_vs_fp32_x": self.reduction_vs_fp32(),
            "watermarks": {p: dict(w) for p, w in self._watermarks.items()},
        }
        return out


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif hasattr(tree, "codes"):            # a QTensor
        yield from _tensors([tree.codes, tree.scale])


def tensor_bytes(*trees) -> int:
    """Bytes of the distinct storages under ``trees`` (a storage that
    several views share counts once)."""
    seen: dict[tuple, int] = {}
    for tree in trees:
        for t in _tensors(tree):
            st = t.untyped_storage()
            seen[(t.device.type, t.device.index, st.data_ptr())] = st.nbytes()
    return sum(seen.values())


def device_breakdown(*trees) -> dict[str, int]:
    """Resident bytes per device (``str(t.device)``) across ``trees``
    (nested dicts, lists and tuples of tensors), each tensor its own
    bytes."""
    out: dict[str, int] = {}
    for tree in trees:
        for t in _tensors(tree):
            key = str(t.device)
            out[key] = out.get(key, 0) + t.numel() * t.element_size()
    return out
