"""End-to-end training driver of the zoo LM — the port of
``repro/launch/train.py``'s single-host loop: seeded init, the train step
of ``launch/steps.py`` (TT weight sites, the policy's quant sites, f32 or
int8 moments, the int8 gradient wire), ``lm_batch`` batches from the
prefetching pipeline, per-step logging with the straggler monitor, the
fault-tolerance loop (asynchronous checkpoints, resume from the newest
one, the SIGTERM emergency save) and the final parameter counts.

    PYTHONPATH=src python -m repro_torch.launch.train --arch lm100m --tt \\
        --quantize --steps 3 --batch 2 --seq 32 --device cpu \\
        --ckpt-dir /tmp/lm100m_ckpt --ckpt-every 2

It runs on the card unless ``--device cpu`` is given. ``--trace-out
PATH`` writes one ``train_step`` event a step as JSONL and turns the
policy's quant health on (with ``--quantize``), as the reference's
driver does. Checkpoints are the reference's files (``steps.stack_state``
gives its layout), so either package resumes the other's. Left out:
meshes (ROADMAP queue 1 item 8, refused where asked for).
"""
from __future__ import annotations

import argparse
import dataclasses
import signal
import time

import numpy as np
import torch

from .. import configs as C
from ..ckpt import (AsyncCheckpointer, install_preemption_handler,
                    latest_step, step_path)
from ..configs.base import ModelConfig, TrainConfig
from ..data import Prefetcher, host_shard_info, lm_batch
from ..device import resolve_device
from ..models.lm import build_lm, init_lm, lm_param_counts
from ..obs import MemoryLedger, TraceRecorder, write_jsonl
from .steps import (init_train_state, load_state, make_train_step,
                    stack_state, train_state_sites)

# a ~100M-param dense config for the end-to-end example driver
LM100M = ModelConfig(name="lm100m", num_layers=12, d_model=768, num_heads=12,
                     num_kv_heads=12, d_ff=3072, vocab_size=32768,
                     remat="none", dtype="float32")


class StragglerMonitor:
    """EWMA step-time monitor; flags steps slower than ``factor``x the
    mean. Here it logs; at fleet scale the flag would feed the
    orchestration layer."""

    def __init__(self, factor: float = 2.0, decay: float = 0.95):
        self.mean = None
        self.factor = factor
        self.decay = decay
        self.flagged = 0

    def observe(self, dt: float) -> bool:
        slow = self.mean is not None and dt > self.factor * self.mean
        self.mean = dt if self.mean is None else \
            self.decay * self.mean + (1 - self.decay) * dt
        self.flagged += int(slow)
        return slow


def get_model_cfg(name: str, reduced: bool) -> tuple[ModelConfig, str]:
    if name == "lm100m":
        return LM100M, "tp"
    cfg = C.get_reduced(name) if reduced else C.get_config(name)
    if reduced:
        cfg = cfg.replace(dtype="float32", remat="none")
    return cfg, C.get_strategy(name)


def make_batch_fn(cfg: ModelConfig, batch: int, seq: int, seed: int):
    """``fn(step) -> {"tokens", "labels"}`` numpy batches of ``lm_batch``
    (this process's shard, ``host_shard_info``), the reference's arrays
    exactly. An audio config takes ``{"frames", "labels"}``: frames of (B,
    seq, d_model) standard normals from ``default_rng(step)``, labels mod
    the vocabulary; a vision config ``{"patches", "tokens", "labels"}``
    with ``max(4, seq // 4)`` patches drawn alike."""
    shard, num_shards = host_shard_info()

    def fn(step: int) -> dict:
        b = lm_batch(step, batch=batch, seq=seq, vocab=cfg.vocab_size,
                     shard=shard, num_shards=num_shards, seed=seed)
        if cfg.frontend == "audio":
            rng = np.random.default_rng(step)
            frames = rng.normal(size=(b["tokens"].shape[0], seq,
                                      cfg.d_model)).astype(np.float32)
            return {"frames": frames, "labels": b["labels"] % cfg.vocab_size}
        if cfg.frontend == "vision":
            npatch = max(4, seq // 4)
            rng = np.random.default_rng(step)
            patches = rng.normal(size=(b["tokens"].shape[0], npatch,
                                       cfg.d_model)).astype(np.float32)
            return {"patches": patches, "tokens": b["tokens"],
                    "labels": b["labels"]}
        return b
    return fn


def _to_device(np_batch: dict, device: torch.device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in np_batch.items()}


def _record_train_state(ledger, state) -> None:
    """Fold one TrainState into the memory ledger (host-side, between
    steps: sizes only, no device work)."""
    for site, row in train_state_sites(state).items():
        ledger.set(site, row["bytes"], fp32=row["fp32_bytes"])


def _state_tensors(state) -> list:
    """The tensors a TrainState holds (params, moments, residual, scales,
    step): what a CPU reconcile counts as live."""
    return [state.params, list(state.opt), state.residual, state.scales,
            state.step]


def train(cfg: ModelConfig, strategy: str, tcfg: TrainConfig, *,
          batch: int, seq: int, mesh=None, verbose: bool = True,
          trace=None, ledger=None, device=None, on_step=None):
    """Train to ``tcfg.total_steps`` steps from a seeded init
    (``torch.Generator(device).manual_seed(tcfg.seed)``) or from the newest
    checkpoint in ``tcfg.ckpt_dir``. Returns ``(state, losses)``;
    ``losses`` are host floats, one per step this call ran (CE plus the
    rank prior). ``on_step(step, metrics)``, when given, sees each step's
    metrics (device scalars) right after the step.

    Checkpoints, as the reference's loop: an ``AsyncCheckpointer`` on
    ``tcfg.ckpt_dir`` (the newest 3 ``step_N.ckpt`` kept) in the
    reference's layout (``steps.stack_state``). A newest file there is
    resumed (``[train] resumed from step N``): the run goes on from batch
    ``meta["step"]``. A periodic save, after loop step ``step > 0`` with
    ``step % tcfg.ckpt_every == 0``, stores ``step`` beside a state that
    has taken ``step + 1`` steps, so a resume from it runs batch ``step``
    again (the reference's rule, kept); the final save (``int(state.step)``,
    meta ``final``) and the SIGTERM emergency save (``int(state.step)``,
    meta ``emergency``, then exit code 143) resume exactly. The SIGTERM
    handler is put back as it was when the call returns. Batches come from
    a ``Prefetcher`` from the start step. The device is resolved before
    anything reads ``tcfg.ckpt_dir``.

    ``trace``: an optional ``obs.TraceRecorder`` — the loop emits one
    ``train_step`` event a step (step, loss, dur, and with the policy's
    health on ``grad_sat_fraction``, ``act_scale_log2`` and
    ``act_in_band``). ``ledger``: an optional ``obs.MemoryLedger`` (one is
    made when None) — the TrainState's sites (params, moments, wire
    residual, scale state) at init (the resumed state's, after a resume)
    and after every step, so the ``init`` and ``train_step`` watermarks
    cover the run; the closing ``[train] memory`` line reconciles it
    against the CUDA allocator on the card, or against the state's own
    tensors on the CPU. Neither adds device work to a step.

    Not ported, and refused where asked for: ``mesh`` (ROADMAP queue 1 item
    8)."""
    if mesh is not None:
        raise NotImplementedError("meshes are not ported: ROADMAP queue 1 "
                                  "item 8")
    del strategy                 # the sharding strategy needs a mesh
    device = resolve_device(device)
    lm = build_lm(cfg)
    params = init_lm(torch.Generator(device=device).manual_seed(tcfg.seed),
                     lm, device=device)
    state = init_train_state(params, tcfg, policy=cfg.quant.policy())
    del params
    step_fn = make_train_step(lm, None, tcfg)

    start = 0
    resume = latest_step(tcfg.ckpt_dir)
    if resume is not None:
        state, meta = load_state(step_path(tcfg.ckpt_dir, resume), state)
        start = int(meta.get("step", resume))
        if verbose:
            print(f"[train] resumed from step {start}", flush=True)
    ckpt = AsyncCheckpointer(tcfg.ckpt_dir)    # after a load that may raise
    if ledger is None:
        ledger = MemoryLedger(device)
    _record_train_state(ledger, state)     # the "init" watermark

    def emergency():
        ckpt.save(int(state.step), stack_state(state), {"emergency": True})
        ckpt.wait()

    previous = install_preemption_handler(emergency)
    prefetch = Prefetcher(make_batch_fn(cfg, batch, seq, tcfg.seed), start)
    monitor = StragglerMonitor()
    losses = []
    t_start = time.time()
    try:
        for step, np_batch in prefetch:
            if step >= tcfg.total_steps:
                break
            t0 = time.time()
            state, metrics = step_fn(state, _to_device(np_batch, device))
            loss = float(metrics["loss"])
            losses.append(loss)
            if on_step is not None:
                on_step(step, metrics)
            dt = time.time() - t0
            ledger.set_phase("train_step")
            _record_train_state(ledger, state)
            slow = monitor.observe(dt)
            if trace is not None:
                ev = {"step": step, "loss": loss, "dur": dt}
                if "health" in metrics:
                    h = metrics["health"]
                    ev["grad_sat_fraction"] = float(
                        h["grad_edge"]["sat_fraction"])
                    if "activation" in h:
                        ev["act_scale_log2"] = float(
                            h["activation"]["scale_log2"])
                        ev["act_in_band"] = float(
                            h["activation"]["in_band"])
                trace.emit("train_step", **ev)
            if verbose and (step % tcfg.log_every == 0 or slow):
                extra = "  [STRAGGLER]" if slow else ""
                print(f"[train] step {step} loss {loss:.4f} "
                      f"ce {float(metrics['ce']):.4f} {dt*1e3:.0f}ms{extra}",
                      flush=True)
            if tcfg.ckpt_every and step > 0 and step % tcfg.ckpt_every == 0:
                ckpt.save(step, stack_state(state), {"loss": loss})
        ckpt.save(int(state.step), stack_state(state), {"final": True})
        ckpt.wait()
    finally:
        prefetch.close()
        ckpt.close()
        signal.signal(signal.SIGTERM, previous)
    if verbose and losses:
        counts = lm_param_counts(state.params, lm)
        print(f"[train] done: {len(losses)} steps in "
              f"{time.time()-t_start:.1f}s  first-loss {losses[0]:.4f} "
              f"last-loss {losses[-1]:.4f}")
        print(f"[train] params dense-equiv {counts['dense']:.3e} "
              f"live {counts['live']:.3e} "
              f"compression {counts['compression']:.1f}x", flush=True)
        rec = ledger.reconcile(tensors=_state_tensors(state))
        wm = ledger.watermark("train_step") or ledger.watermark("init")
        print(f"[train] memory {ledger.total()/1e6:.2f} MB live "
              f"({ledger.reduction_vs_fp32():.1f}x vs same-shape f32), "
              f"train-step watermark {wm['total_bytes']/1e6:.2f} MB, "
              f"reconcile {'ok' if rec['ok'] else 'FAILED'} "
              f"(ledger covers {rec['coverage_frac']:.0%} of "
              f"{rec['live_bytes']/1e6:.2f} MB live tensors)", flush=True)
    return state, losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="lm100m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--tt", action="store_true")
    ap.add_argument("--quantize", action="store_true",
                    help="with --tt: the paper's 4/8/16-bit quantization")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=200)
    ap.add_argument("--grad-compress", action="store_true",
                    help="int8 + error-feedback gradient wire (dp_wire)")
    ap.add_argument("--opt-state-dtype", default="float32",
                    choices=("float32", "int8"))
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain versions)")
    ap.add_argument("--trace-out", default=None,
                    help="write per-step train_step trace events (JSONL)")
    args = ap.parse_args(argv)

    cfg, strategy = get_model_cfg(args.arch, args.reduced)
    if args.tt:
        cfg = C.with_tt(cfg, max_rank=32, quantize=args.quantize)
    if args.trace_out and cfg.quant.enable:
        # a trace run also switches on the step's quant-health aggregates
        cfg = cfg.replace(quant=dataclasses.replace(cfg.quant, health=True))
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       warmup_steps=max(5, args.steps // 20),
                       ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                       grad_compress=args.grad_compress,
                       opt_state_dtype=args.opt_state_dtype)
    trace = TraceRecorder() if args.trace_out else None
    train(cfg, strategy, tcfg, batch=args.batch, seq=args.seq,
          device=args.device, trace=trace)
    if trace is not None:
        n = write_jsonl(trace, args.trace_out)
        print(f"[train] wrote {n} trace events to {args.trace_out}")


if __name__ == "__main__":
    main()
