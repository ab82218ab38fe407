"""The paper's experiment end to end (Appendix B) on the port: the
two-layer tensorized MLP, rank-adaptive prior, 4/8/16-bit quantized
training with automatic scale selection and BinaryConnect, on the
synthetic FashionMNIST drop-in — the port of
``examples/train_fmnist_tt.py``. Prints the Table-1 row, and with
``--deploy-out`` writes the packed-int4 deploy export there.

    PYTHONPATH=src python -m repro_torch.launch.train_fmnist [--steps 600]
        [--device cpu] [--no-prior] [--no-quant] [--deploy-out PATH]
        [--trace-out PATH]

``--trace-out`` writes one ``train_step`` event a step (step, loss, dur:
the step's host wall to its loss on the host) as JSONL.

It runs on the card unless ``--device cpu`` is given. On the card every
TT contraction and every fake-quant of the step is a hand-written CUDA
kernel: PE1/PE2 for the TT chains (forward, scale-manager forward, the
transposed dx chains), PE3 for the full-weight gradients, the group
fake-quant for each layer's cores and the activation/gradient edges; with
int8 Adam moments and the gradient wire (``make_step(..., compress=True)``,
``launch/train_wire.py``) the blockwise encode/decode kernels too, and the
deploy export runs the packed int4 encode kernel.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs.base import TrainConfig
from ..data import fashion_like
from ..device import resolve_device
from ..kernels import grouped as G
from ..models import mlp_tt as MLP
from ..obs import TraceRecorder, write_jsonl
from ..optim import adam as A
from ..optim.binaryconnect import quantize_for_deploy
from ..optim.grad_compress import WIRE_SPEC, compress_decompress
from ..tree import flatten_with_path, unflatten

BATCH = 64


def loss_and_grads(params, batch: dict, d: MLP.MLPDef, wire: bool = False):
    """``(loss, grads)``: ``grads`` mirrors ``params``, with the gradient of
    every leaf that gets Adam moments and ``None`` elsewhere (integer
    leaves, λ, ``wscale_log2``) and for the ``mean_abs`` leaves the loss
    does not reach (``repro``'s zero gradient, a no-op update).

    With ``wire`` every floating leaf gets a gradient, zeros where the loss
    does not reach it (λ, which the loss sees only through stop-gradients,
    and the ``mean_abs`` leaves): the leaf set of JAX's
    ``value_and_grad(..., allow_int=True)``, which the gradient wire
    round-trips."""
    paths = set(A.adam_leaf_paths(params))
    flat = flatten_with_path(params)
    live = [leaf.detach().requires_grad_() if p in paths else leaf
            for p, leaf in flat]
    loss = MLP.mlp_loss(unflatten(params, live), batch, d)
    wanted = [t for (p, _), t in zip(flat, live) if p in paths]
    got = iter(torch.autograd.grad(loss, wanted, allow_unused=True))
    grads = [next(got) if p in paths else None for p, _ in flat]
    if wire:
        grads = [torch.zeros_like(leaf) if g is None
                 and leaf.is_floating_point() else g
                 for g, (_, leaf) in zip(grads, flat)]
    return loss.detach(), unflatten(params, grads)


def train_step(params, opt, batch: dict, residual, d: MLP.MLPDef,
               tcfg: TrainConfig, compress: bool = False,
               wire_spec=WIRE_SPEC):
    """One step in ``repro``'s order: loss and gradients, the int8
    gradient wire with error feedback (``compress``), AdamW (f32 or int8
    moments, ``tcfg.opt_state_dtype``), the Eq. (4) λ update, the §3.3
    scale update — on the compressed gradients, as in ``repro``.
    Returns ``(params, opt, loss, grads, residual)``."""
    loss, grads = loss_and_grads(params, batch, d, wire=compress)
    if compress:
        grads, residual = compress_decompress(grads, residual, wire_spec)
    params, opt = A.adam_update(params, grads, opt, tcfg.learning_rate, tcfg)
    if d.tt.rank_adapt:
        params = MLP.mlp_lambda_update(params, d)               # Eq. (4)
    if d.qc.enable:
        params = MLP.mlp_scale_update(params, batch, grads, d)  # §3.3
    return params, opt, loss, grads, residual


def make_step(d: MLP.MLPDef, tcfg: TrainConfig, compress: bool = False):
    """One training step, as the example's jitted ``step``: loss and its
    gradients, AdamW, the Eq. (4) λ update, the §3.3 scale update.

    ``step(params, opt, batch) -> (params, opt, loss)`` with ``batch``
    ``{"x": (B, 896) f32, "y": (B,) int}`` on the params' device. The
    returned loss is a device scalar (reading it waits for the card).

    With ``compress`` the step carries the gradient wire's residual, as
    ``benchmarks/train_wire.py``'s step does: ``step(params, opt, batch,
    residual) -> (params, opt, loss, grads, residual)`` (``residual=None``
    starts it at zero; ``grads`` are the compressed gradients)."""
    if compress:
        spec = d.qc.policy().spec_for("dp_wire")

        def wire_step(params, opt, batch, residual):
            return train_step(params, opt, batch, residual, d, tcfg, True,
                              spec)
        return wire_step

    def step(params, opt, batch):
        return train_step(params, opt, batch, None, d, tcfg)[:3]
    return step


def launches_per_step(d: MLP.MLPDef, tcfg: TrainConfig | None = None,
                      compress: bool = False) -> dict[str, int]:
    """Kernel launches of one ``make_step(d, tcfg, compress)`` step on the
    card, from the code:

    - ``p2_fake_quant``: one group launch for each layer's cores in the
      loss forward and again in the scale manager's forward
      (``mlp_scale_update``), the three edges' 8-bit forwards, and the
      16-bit backwards of ``q_h`` and ``q_out`` (``q_in``'s input is the
      batch, which takes no gradient, so its backward only forms the probe
      statistic).
    - ``pe1``/``pe2``: one forward chain per layer in the loss and in the
      scale manager's forward (one PE1, d-1 PE2 each), and one transposed
      dx chain per layer (layer 1's dx is what ``q_in``'s probe reads).
    - ``pe3``: one full-weight gradient per layer.
    - ``bw_enc`` (int8 moments): one group launch over m and v of every
      Adam leaf whose gradient is not None (``grouped.BW_CAP`` leaves a
      launch). Without the wire those are the cores, biases and probes
      (the ``mean_abs`` leaves get None and keep their state); with it,
      every Adam leaf (the wire hands ``mean_abs`` a zero gradient).
      ``bw_dec``: one group launch over the same moments, decoded before
      the update.
    - ``bw_enc`` (the wire): one group launch over every floating gradient
      leaf, λ and ``mean_abs`` included; ``bw_dec``: one over the same
      leaves."""
    if not (d.qc.enable and d.tt.enable):
        raise ValueError("counted for the quantized TT step only")
    specs = (d.spec1, d.spec2)
    out = {"p2_fake_quant": 2 * len(specs) + 3 + 2,
           "pe1": 3 * len(specs),
           "pe2": 3 * sum(s.d - 1 for s in specs),
           "pe3": len(specs)}
    layer_leaves = sum(s.d + 1 for s in specs)       # cores and a bias
    edges = 3                                        # q_in, q_h, q_out
    adam_leaves = layer_leaves + 3 * edges           # + probe, 2 mean_abs
    lambdas = sum(s.d - 1 for s in specs) if d.tt.rank_adapt else 0
    enc = dec = 0
    if tcfg is not None and tcfg.opt_state_dtype == "int8":
        moments = 2 * (adam_leaves if compress else layer_leaves + edges)
        enc += len(G.chunks(moments, G.BW_CAP))
        dec += len(G.chunks(moments, G.BW_CAP))
    if compress:
        enc += len(G.chunks(adam_leaves + lambdas, G.BW_CAP))
        dec += len(G.chunks(adam_leaves + lambdas, G.BW_CAP))
    if dec:
        out["bw_enc"], out["bw_dec"] = enc, dec
    return out


def batch_at(xs: torch.Tensor, ys: torch.Tensor, i: int) -> dict:
    """The example's batch order: step i takes rows lo..lo+64 with
    lo = (i * 64) % (n - 64)."""
    lo = (i * BATCH) % (len(ys) - BATCH)
    return {"x": xs[lo:lo + BATCH], "y": ys[lo:lo + BATCH]}


@torch.no_grad()
def accuracy(params, x: torch.Tensor, y: torch.Tensor,
             d: MLP.MLPDef) -> float:
    logits = MLP.mlp_forward(params, x, d)
    return float((torch.argmax(logits, -1) == y).float().mean())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain versions)")
    ap.add_argument("--no-prior", action="store_true")
    ap.add_argument("--no-quant", action="store_true")
    ap.add_argument("--deploy-out", default=None,
                    help="write the packed int4 deploy export here")
    ap.add_argument("--trace-out", default=None,
                    help="write per-step train_step trace events (JSONL)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    d = MLP.make_mlp(prior=not args.no_prior, quantize=not args.no_quant)
    gen = torch.Generator(device=device).manual_seed(0)
    params = MLP.init_mlp(gen, d, device=device)
    tcfg = TrainConfig(learning_rate=3e-3, weight_decay=0.0)
    opt = A.init_adam(params, tcfg)
    xs, ys = (torch.from_numpy(a).to(device) for a in fashion_like(8192,
                                                                   seed=1))
    xt, yt = (torch.from_numpy(a).to(device) for a in fashion_like(2048,
                                                                   seed=2))
    step = make_step(d, tcfg)

    trace = TraceRecorder() if args.trace_out else None
    t0 = time.time()
    for i in range(args.steps):
        ts = time.time()
        params, opt, loss = step(params, opt, batch_at(xs, ys, i))
        if trace is not None:
            lv = float(loss)
            trace.emit("train_step", step=i, loss=lv, dur=time.time() - ts)
        if i % 100 == 0:
            acc = accuracy(params, xt, yt, d)
            print(f"step {i:4d}  loss {float(loss):.4f}  test acc {acc:.3f}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = (time.time() - t0) / max(args.steps, 1)
    print_table1(params, d, accuracy(params, xt, yt, d), dt, device)
    deploy = quantize_for_deploy(params, d.qc)   # 4-bit cores for inference
    _ = deploy
    if d.qc.enable and args.deploy_out:
        # packed int4x2 deploy artifact: two codes per byte on disk
        from ..ckpt import export_tt_deploy
        stats = export_tt_deploy(args.deploy_out, params)
        print(f"deploy export: {stats['packed_bytes']:,} B packed int4 "
              f"cores ({stats['reduction_x']:.1f}x vs fp32) "
              f"-> {args.deploy_out}")
    if trace is not None:
        n = write_jsonl(trace, args.trace_out)
        print(f"wrote {n} trace events to {args.trace_out}")


def print_table1(params, d: MLP.MLPDef, acc: float, dt: float,
                 device: torch.device) -> None:
    """The example's closing lines: effective ranks and the Table-1 row."""
    if d.tt.rank_adapt:
        eff1, eff2 = MLP.effective_ranks(params, d)
        c = MLP.param_counts(d, eff1, eff2)
        print(f"\neffective ranks: L1 {eff1}  L2 {eff2}")
    else:
        c = MLP.param_counts(d)
    bits = c["fixed_bits"] if d.qc.enable else c["float_bits"]
    where = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "this CPU"
    print(f"test acc {acc:.3f}   params {c['tt_params']:,}   "
          f"memory {bits:,} bits   "
          f"reduction {c['dense_bits']/bits:.0f}x vs dense "
          f"(paper: 292x, 84.86% on real FMNIST)")
    print(f"{dt*1e3:.1f} ms/batch-64 on {where} "
          f"(paper: 90 ms on the FPGA, 5340 ms on a Pi 3B)")


if __name__ == "__main__":
    main()
