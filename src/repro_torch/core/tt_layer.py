"""TT-factorized linear layer: TTM algebra + rank adaptation + QAT composed
— the port of ``repro/core/tt_layer.py``.

Params are plain dicts of tensors, specs are static. The matvec is
``ttm.tt_matvec`` (PE1/PE2 kernels forward, PE3 + Appendix A.2 backward)
and the cores' 4-bit fake-quant is one launch of the group fake-quant
kernel for the layer's cores, so a layer on the card runs only
hand-written kernels for its TT work.

Stacked params (an MoE layer's E experts, the reference's vmapped
``init_site``: cores ``(E, R, J, I, R)``, λ ``(E, R)``, ``wscale_log2``
``(E, d)``, a bias ``(E, out)``) are E sites in one: rank masks per
expert, each core fake-quantized under its E steps in one launch of the
row kernel (``p2_fq_rows``), the matvec the grouped chain on x (E, C,
in).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..configs.base import QuantConfig, TTConfig
from ..device import resolve_device
from ..numerics import QuantSpec, fake_quant, fake_quant_many
from . import rank_adapt as RA
from .ttm import TTMSpec, core_sigma, init_cores, make_spec, tt_matvec

Params = dict[str, Any]


def weight_scale_log2(sigma: float, bits: int) -> int:
    """Fixed pow-2 *step* for TT factors: cover ~4 sigma with 2^{bits-1}
    levels."""
    full = 4.0 * max(sigma, 1e-8)
    return int(np.ceil(np.log2(full / 2 ** (bits - 1))))


def tt_linear_init(generator: torch.Generator, out_dim: int, in_dim: int,
                   tt: TTConfig, dtype=torch.float32, use_bias: bool = True,
                   j_dims=None, i_dims=None, ranks=None,
                   device=None) -> tuple[Params, TTMSpec]:
    device = resolve_device(device)
    spec = make_spec(out_dim, in_dim, tt.d, tt.max_rank,
                     j_dims=j_dims, i_dims=i_dims, ranks=ranks)
    cores = init_cores(generator, spec, dtype=dtype, device=device)
    params: Params = {f"core_{n}": c for n, c in enumerate(cores)}
    if use_bias:
        params["bias"] = torch.zeros((out_dim,), dtype=dtype, device=device)
    if tt.rank_adapt:
        for n, lam in enumerate(RA.init_lambdas(spec, device)):
            params[f"lambda_{n}"] = lam
    # fixed per-core quant step (paper: TT-factor scales are fixed), from
    # the analytic init sigma
    params["wscale_log2"] = torch.tensor(
        [weight_scale_log2(core_sigma(spec), 4)] * spec.d, dtype=torch.int32,
        device=device)
    return params, spec


def get_cores(params: Params, spec: TTMSpec) -> list[torch.Tensor]:
    return [params[f"core_{n}"] for n in range(spec.d)]


def get_lambdas(params: Params, spec: TTMSpec) -> list[torch.Tensor] | None:
    if "lambda_0" not in params and spec.d > 1:
        return None
    return [params[f"lambda_{n}"] for n in range(spec.d - 1)]


def effective_cores(params: Params, spec: TTMSpec, tt: TTConfig,
                    qc: QuantConfig) -> list[torch.Tensor]:
    """Cores as seen by the forward pass: rank-masked then fake-quantized
    (the ``tt_factor`` site: pow-2 codec, fixed per-core scales, §3.2), all
    d cores in one call, their steps read on the device; stacked cores one
    row-kernel call a core, a step a group (the reference's vmap of a
    scalar-step fake-quant), with the same clipped STE."""
    cores = get_cores(params, spec)
    if tt.rank_adapt and spec.d > 1:
        masks = RA.rank_masks([lam.detach()
                               for lam in get_lambdas(params, spec)],
                              tt.prune_threshold)
        cores = RA.apply_masks(cores, masks)
    if qc.enable:
        qspec = QuantSpec("pow2", qc.weight_bits, 0, "int8", "fixed")
        steps = params["wscale_log2"].float()
        if steps.dim() > 1:
            cores = [fake_quant(c, qspec, steps[:, n], backend="cuda")
                     for n, c in enumerate(cores)]
        else:
            cores = fake_quant_many(cores, qspec, steps, backend="cuda")
    return cores


def tt_linear_apply(params: Params, x: torch.Tensor, spec: TTMSpec,
                    tt: TTConfig, qc: QuantConfig) -> torch.Tensor:
    """y = W x + bias; stacked params take x (E, C, in) -> (E, C, out)."""
    cores = effective_cores(params, spec, tt, qc)
    y = tt_matvec([c.to(x.dtype) for c in cores], x, spec)
    if "bias" in params:
        bias = params["bias"]
        if bias.dim() > 1:                  # (E, out): each group's rows
            bias = bias[:, None, :]
        y = y + bias.to(y.dtype)
    return y


def tt_prior_loss(params: Params, spec: TTMSpec,
                  tt: TTConfig) -> torch.Tensor:
    """g(θ, λ) contribution of this layer (0 if rank adaptation is off)."""
    if not tt.rank_adapt or spec.d < 2:
        return torch.zeros((), dtype=torch.float32,
                           device=params["core_0"].device)
    return tt.gamma * RA.prior_loss(get_cores(params, spec),
                                    get_lambdas(params, spec), spec)


def tt_lambda_update(params: Params, spec: TTMSpec, tt: TTConfig) -> Params:
    """Closed-form Eq.(4) update of the λ entries (applied post-step)."""
    if not tt.rank_adapt or spec.d < 2:
        return params
    new = dict(params)
    for n, lam in enumerate(RA.update_lambdas(get_cores(params, spec), spec)):
        new[f"lambda_{n}"] = lam
    return new


def tt_param_count(params: Params, spec: TTMSpec,
                   tt: TTConfig) -> tuple[int, int]:
    """(live_params, total_params) after rank pruning by current λ."""
    lambdas = get_lambdas(params, spec)
    if lambdas is None:
        return spec.num_params, spec.num_params
    ranks = [1] + RA.effective_ranks(lambdas, tt.prune_threshold) + [1]
    live = sum(ranks[n] * spec.j_dims[n] * spec.i_dims[n] * ranks[n + 1]
               for n in range(spec.d))
    return live, spec.num_params
