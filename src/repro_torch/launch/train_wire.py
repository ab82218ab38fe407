"""The paper's full Table-1 wire on the port: the FMNIST TT MLP stepped
with 4-bit cores, 8/16-bit activation and gradient edges, blockwise-int8
Adam moments and the blockwise-int8 gradient wire with error feedback,
and the per-site byte table with the packed-int4 deploy export — the
port's counterpart of the step construction and byte accounting of
``benchmarks/train_wire.py`` (``fmnist_low_precision_step``,
``fmnist_site_table``). No timing harness.

    PYTHONPATH=src python -m repro_torch.launch.train_wire [--steps 300]
        [--device cpu] [--deploy-out PATH]

It runs on the card unless ``--device cpu`` is given; there the moments
and the wire go through the blockwise encode/decode kernels and the
deploy export through the packed int4 encode kernel.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from ..ckpt import export_tt_deploy
from ..configs.base import TrainConfig
from ..data import fashion_like
from ..device import resolve_device
from ..models import mlp_tt as MLP
from ..numerics import QTensor, encode
from ..optim import adam as A
from ..tree import leaves
from . import train_fmnist as TF

BATCH = 64
# the four sites of the paper's Table-1 comparison
TABLE1_SITES = ("tt_factor", "activation", "optimizer_moment", "dp_wire")


def act_shapes(batch: int) -> list[tuple[int, int]]:
    """The MLP's three activation quant-edge sites (input/hidden/output)."""
    return [(batch, 896), (batch, 512), (batch, 16)]


def wire_config(opt_dtype: str = "int8") -> TrainConfig:
    return TrainConfig(learning_rate=3e-3, weight_decay=0.0,
                       opt_state_dtype=opt_dtype)


def low_precision_step(batch: int = BATCH, opt_dtype: str = "int8",
                       compress: bool = True, device=None,
                       params=None) -> dict:
    """Build and run ONE low-precision FMNIST step the way
    ``fmnist_low_precision_step`` does: ``init_mlp`` (from a torch
    generator seeded 0 unless ``params`` is given — pass params converted
    from JAX for parity) and the ``np.random.RandomState(0)`` normal batch.
    Returns everything the accounting needs."""
    device = resolve_device(device)
    d = MLP.make_mlp(prior=True, quantize=True)
    if params is None:
        params = MLP.init_mlp(torch.Generator(device=device).manual_seed(0),
                              d, device=device)
    policy = d.qc.policy()
    tcfg = wire_config(opt_dtype)
    opt = A.init_adam(params, tcfg)
    rng = np.random.RandomState(0)
    b = {"x": torch.from_numpy(np.asarray(rng.normal(size=(batch, 896)),
                                          np.float32)).to(device),
         "y": torch.from_numpy(np.asarray(rng.randint(0, 10, batch),
                                          np.int32)).to(device)}
    new_params, new_opt, loss, grads, residual = TF.train_step(
        params, opt, b, None, d, tcfg, compress, policy.spec_for("dp_wire"))
    return {"d": d, "params": params, "new_params": new_params,
            "opt": new_opt, "loss": loss, "grads": grads,
            "residual": residual, "policy": policy, "tcfg": tcfg,
            "batch_arrays": b, "batch": batch}


def site_table(result: dict, deploy_path: str) -> tuple[dict, dict, dict]:
    """Per-site bytes of one low-precision step, from its live tensors,
    against the fp32 dense baseline (the paper's Table-1 comparison).
    Writes the deploy export of ``result["new_params"]`` to
    ``deploy_path``. Returns (sites, baseline, deploy stats)."""
    policy = result["policy"]
    wire_spec = policy.spec_for("dp_wire")
    deploy = export_tt_deploy(deploy_path, result["new_params"],
                              policy=policy)
    shapes = act_shapes(result["batch"])
    opt = result["opt"]
    sites = {
        # tt_factor: the packed int4x2 deploy export (two codes per byte)
        "tt_factor": deploy["packed_bytes"],
        # activation: the quant-edge sites at 8 bits, via policy.nbytes
        "activation": sum(policy.nbytes("activation", s) for s in shapes),
        # optimizer_moment: resident bytes of the int8 m/v QTensors
        "optimizer_moment": sum(m.nbytes() for m in (*opt.m, *opt.v)
                                if isinstance(m, QTensor)),
        # dp_wire: int8 codes + block scales of each float gradient leaf
        "dp_wire": sum(encode(g.reshape(-1), wire_spec,
                              backend="cuda").nbytes()
                       for g in leaves(result["grads"])
                       if isinstance(g, torch.Tensor)
                       and g.is_floating_point()),
    }
    dense_w = (896 * 512 + 512 * 16 + 512 + 16) * 4
    baseline = {
        "tt_factor": dense_w,
        "activation": sum(int(np.prod(s)) * 4 for s in shapes),
        "optimizer_moment": 2 * dense_w,
        "dp_wire": dense_w,
    }
    return sites, baseline, deploy


def live_memory_ledger(result: dict, deploy: dict, baseline: dict):
    """A ``MemoryLedger`` of the step just run, from its live tensors —
    the port's twin of the reference's ``live_memory_ledger``
    (``benchmarks/train_wire.py``): the four Table-1 sites (the deploy
    export's packed bytes, the activation edges at the policy's bits, the
    int8 moments' resident bytes, one gradient wire's encoded bytes) plus
    the wire's error-feedback residual, each beside the analytic dense
    baseline (``site_table``'s). Its ``reduction_vs_fp32(TABLE1_SITES)`` is
    the paper's memory figure, measured live."""
    from ..obs import MemoryLedger
    from ..optim.adam import moment_nbytes
    from ..optim.grad_compress import residual_nbytes, wire_nbytes
    policy = result["policy"]
    led = MemoryLedger()
    led.set_phase("train_step")
    led.set("tt_factor", deploy["packed_bytes"], fp32=baseline["tt_factor"])
    led.set("activation",
            sum(policy.nbytes("activation", s)
                for s in act_shapes(result["batch"])),
            fp32=baseline["activation"])
    led.set("optimizer_moment", moment_nbytes(result["opt"])[0],
            fp32=baseline["optimizer_moment"])
    enc, _ = wire_nbytes(result["grads"], policy.spec_for("dp_wire"))
    led.set("dp_wire", enc, fp32=baseline["dp_wire"])
    res = residual_nbytes(result["residual"])
    if res:
        led.set("grad_residual", res)
    return led


def print_site_table(sites: dict, baseline: dict, deploy: dict) -> None:
    print(f"{'site':18s} {'bytes':>10s} {'fp32 bytes':>12s} {'ratio':>8s}")
    for k in TABLE1_SITES:
        print(f"{k:18s} {sites[k]:10,d} {baseline[k]:12,d} "
              f"{baseline[k] / sites[k]:7.2f}x")
    low, base = sum(sites.values()), sum(baseline.values())
    print(f"{'total':18s} {low:10,d} {base:12,d} {base / low:7.2f}x")
    print(f"deploy export: {deploy['packed_bytes']:,} B packed int4 cores "
          f"({deploy['reduction_x']:.2f}x vs fp32)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain versions)")
    ap.add_argument("--deploy-out", default=None,
                    help="write the deploy export here (default: a "
                         "temporary directory, removed at exit)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    d = MLP.make_mlp(prior=True, quantize=True)
    params = MLP.init_mlp(torch.Generator(device=device).manual_seed(0), d,
                          device=device)
    tcfg = wire_config()
    opt = A.init_adam(params, tcfg)
    xs, ys = (torch.from_numpy(a).to(device)
              for a in fashion_like(8192, seed=1))
    xt, yt = (torch.from_numpy(a).to(device)
              for a in fashion_like(2048, seed=2))
    step = TF.make_step(d, tcfg, compress=True)
    residual = grads = None

    t0 = time.time()
    for i in range(args.steps):
        params, opt, loss, grads, residual = step(
            params, opt, TF.batch_at(xs, ys, i), residual)
        if i % 100 == 0:
            acc = TF.accuracy(params, xt, yt, d)
            print(f"step {i:4d}  loss {float(loss):.4f}  test acc {acc:.3f}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = (time.time() - t0) / max(args.steps, 1)
    TF.print_table1(params, d, TF.accuracy(params, xt, yt, d), dt, device)
    if grads is None:
        return
    result = {"new_params": params, "opt": opt, "grads": grads,
              "residual": residual, "policy": d.qc.policy(), "batch": BATCH}
    with tempfile.TemporaryDirectory() as tmp:
        path = args.deploy_out or os.path.join(tmp, "deploy.ckpt")
        print()
        sites, baseline, deploy = site_table(result, path)
        print_site_table(sites, baseline, deploy)
    led = live_memory_ledger(result, deploy, baseline)
    print(f"live ledger: {led.total(TABLE1_SITES):,} B over the Table-1 "
          f"sites ({led.reduction_vs_fp32(TABLE1_SITES):.2f}x vs fp32), "
          f"{led.total():,} B with the wire residual")


if __name__ == "__main__":
    main()
