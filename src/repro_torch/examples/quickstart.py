"""Quickstart: the paper's technique in a few lines, on the port.

Builds a TT-factorized, rank-adaptive, 4-bit-quantized linear layer, trains
it on a synthetic regression task, and shows the rank shrinking while the
quantized forward stays accurate.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

import torch

from repro_torch.configs.base import QuantConfig, TTConfig
from repro_torch.core import rank_adapt as RA
from repro_torch.core import tt_layer as TL
from repro_torch.core import ttm
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=801)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    tt = TTConfig(enable=True, d=3, max_rank=12, rank_adapt=True,
                  prune_threshold=1e-2)
    qc = QuantConfig(enable=True, weight_bits=4, act_bits=8, grad_bits=16)

    # a true low-TT-rank target to recover
    true_spec = ttm.make_spec(128, 256, 3, 3)
    true_cores = ttm.init_cores(gen(42), true_spec, scale=1.0, device=device)
    x = torch.randn((512, 256), generator=gen(1), device=device)
    y = ttm.ttm_matvec(true_cores, x, true_spec)

    params, spec = TL.tt_linear_init(gen(0), 128, 256, tt, device=device)
    print(f"dense params: {spec.dense_params:,}  TT params: "
          f"{spec.num_params:,} ({spec.compression:.1f}x smaller)")

    def loss_fn(p):
        pred = TL.tt_linear_apply(p, x, spec, tt, qc)
        return (torch.mean(torch.square(pred - y))
                + 0.003 * TL.tt_prior_loss(p, spec, tt))

    lr = 0.02
    for step in range(args.steps):
        floats = [k for k, v in params.items() if v.is_floating_point()]
        live = dict(params, **{k: params[k].detach().requires_grad_()
                               for k in floats})
        grads = torch.autograd.grad(loss_fn(live), [live[k] for k in floats],
                                    allow_unused=True)
        params = dict(params, **{k: live[k].detach() - lr * g
                                 for k, g in zip(floats, grads)
                                 if g is not None})
        params = TL.tt_lambda_update(params, spec, tt)   # closed-form Eq. (4)
        if step % 200 == 0 or step == args.steps - 1:
            n_live, total = TL.tt_param_count(params, spec, tt)
            eff = RA.effective_ranks(TL.get_lambdas(params, spec),
                                     tt.prune_threshold)
            with torch.no_grad():
                loss = float(loss_fn(params))
            print(f"step {step:4d}  loss {loss:.5f}  effective ranks {eff}  "
                  f"live params {n_live}/{total}")

    print("\nrank-adaptive 4-bit TT training: ranks shrank one-shot, "
          "no rank search (paper §3).")


if __name__ == "__main__":
    main()
