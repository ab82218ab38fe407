"""The paper's exact experimental model (Appendix B): a two-layer tensorized
MLP for (Fashion)MNIST — the port of ``repro/models/mlp_tt.py``.

- input zero-padded 28×32 = 896, factorized (7,4,2,16)
- hidden 512, factorized (4,4,2,16); ReLU
- output 16 (10 classes + padding), factorized (1,16); layer-2 input (32,16)
- initial TT-rank 16 everywhere → 14,794 params incl. biases (paper: 1.48e4)
- rank-adaptive prior (Eq. 2) + closed-form λ update (Eq. 4)
- low-precision: 4-bit cores (fixed pow-2 scales), 8-bit activations/bias,
  16-bit gradients, dynamic scale manager (§3.3), BinaryConnect + STE (§3.2)

Params: ``{"l1": {...}, "l2": {...}, "q_in"|"q_h"|"q_out": ActQuant}``,
the same tree as ``repro``'s (``convert.mlp_params_from_jax`` carries one
across).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..configs.base import QuantConfig, TTConfig
from ..core import quant as Q
from ..core import rank_adapt as RA
from ..core import tt_layer as TL
from ..core.ttm import TTMSpec, make_spec
from ..device import resolve_device

L1_J = (4, 4, 2, 16)       # hidden 512
L1_I = (7, 4, 2, 16)       # input 896
L2_J = (1, 16)             # output 16 (10 used)
L2_I = (32, 16)            # hidden 512
INIT_RANK = 16
NUM_CLASSES = 10
DATASET_SIZE = 60000.0     # the prior is scaled by 1/|D| per batch (Eq. 1)


@dataclass(frozen=True)
class MLPDef:
    spec1: TTMSpec
    spec2: TTMSpec
    tt: TTConfig
    qc: QuantConfig


def make_mlp(prior: bool = True, quantize: bool = True) -> MLPDef:
    tt = TTConfig(enable=True, d=4, max_rank=INIT_RANK, rank_adapt=prior,
                  prune_threshold=1e-2)
    qc = QuantConfig(enable=quantize)
    spec1 = make_spec(512, 896, 4, INIT_RANK, j_dims=L1_J, i_dims=L1_I)
    spec2 = make_spec(16, 512, 2, INIT_RANK, j_dims=L2_J, i_dims=L2_I)
    return MLPDef(spec1, spec2, tt, qc)


def init_mlp(generator: torch.Generator, d: MLPDef, device=None) -> dict:
    """Random params from ``generator`` (which must live on ``device``;
    default ``"cuda"``)."""
    device = resolve_device(device)
    p1, _ = TL.tt_linear_init(generator, 512, 896, d.tt, j_dims=L1_J,
                              i_dims=L1_I, device=device)
    p2, _ = TL.tt_linear_init(generator, 16, 512, d.tt, j_dims=L2_J,
                              i_dims=L2_I, device=device)
    return {
        "l1": p1, "l2": p2,
        # activation/gradient quant sites (paper §3.3: per-tensor scales)
        "q_in": Q.init_act_quant(device),
        "q_h": Q.init_act_quant(device),
        "q_out": Q.init_act_quant(device),
    }


def mlp_forward(params: dict, x: torch.Tensor, d: MLPDef) -> torch.Tensor:
    """x: (B, 896) -> logits (B, 10)."""
    qc = d.qc
    if qc.enable:
        x = Q.quant_edge(x, params["q_in"], qc.act_bits, qc.grad_bits)
    h = torch.relu(TL.tt_linear_apply(params["l1"], x, d.spec1, d.tt, qc))
    if qc.enable:
        h = Q.quant_edge(h, params["q_h"], qc.act_bits, qc.grad_bits)
    out = TL.tt_linear_apply(params["l2"], h, d.spec2, d.tt, qc)
    if qc.enable:
        out = Q.quant_edge(out, params["q_out"], qc.act_bits, qc.grad_bits)
    return out[:, :NUM_CLASSES]


def mlp_loss(params: dict, batch: dict, d: MLPDef) -> torch.Tensor:
    """Mean cross-entropy + the rank-adaptive prior scaled by 1/|D|."""
    logits = mlp_forward(params, batch["x"], d)
    ce = -torch.mean(torch.sum(
        torch.nn.functional.one_hot(batch["y"].long(), NUM_CLASSES)
        * torch.log_softmax(logits.float(), dim=-1), dim=-1))
    if not d.tt.rank_adapt:
        return ce
    prior = (TL.tt_prior_loss(params["l1"], d.spec1, d.tt)
             + TL.tt_prior_loss(params["l2"], d.spec2, d.tt)) / DATASET_SIZE
    return ce + prior


def mlp_lambda_update(params: dict, d: MLPDef) -> dict:
    new = dict(params)
    new["l1"] = TL.tt_lambda_update(params["l1"], d.spec1, d.tt)
    new["l2"] = TL.tt_lambda_update(params["l2"], d.spec2, d.tt)
    return new


@torch.no_grad()
def mlp_scale_update(params: dict, batch: dict, grads: dict,
                     d: MLPDef) -> dict:
    """§3.3 scale-manager step: activation stats from a forward of the
    current params (edges off, as in ``repro``), gradient stats from the
    probe gradients in ``grads``."""
    if not d.qc.enable:
        return params
    qc = d.qc
    x = batch["x"]
    h = torch.relu(TL.tt_linear_apply(params["l1"], x, d.spec1, d.tt, qc))
    out = TL.tt_linear_apply(params["l2"], h, d.spec2, d.tt, qc)
    new = dict(params)
    for name, val in (("q_in", x), ("q_h", h), ("q_out", out)):
        gstat = grads[name].probe if name in grads else None
        new[name] = Q.update_act_quant(params[name], val, gstat,
                                       qc.target_lo, qc.target_hi, qc.ema)
    return new


# ---------------------------------------------------------------------------
# Table-1 accounting (analytic)
# ---------------------------------------------------------------------------

def param_counts(d: MLPDef, eff1: list[int] | None = None,
                 eff2: list[int] | None = None) -> dict:
    """Parameters + memory bits for the Table-1 rows."""
    r1 = list(d.spec1.ranks) if eff1 is None else [1] + eff1 + [1]
    r2 = list(d.spec2.ranks) if eff2 is None else [1] + eff2 + [1]

    def count(spec, ranks):
        return sum(ranks[n] * spec.j_dims[n] * spec.i_dims[n] * ranks[n + 1]
                   for n in range(spec.d))

    tt_params = count(d.spec1, r1) + count(d.spec2, r2)
    biases = 512 + NUM_CLASSES
    dense_params = 896 * 512 + 512 * 10 + biases
    return {
        "tt_params": tt_params + biases,
        "dense_params": dense_params,
        "float_bits": (tt_params + biases) * 32,
        "fixed_bits": tt_params * 4 + biases * 8,
        "dense_bits": dense_params * 32,
    }


def effective_ranks(params: dict, d: MLPDef) -> tuple[list[int], list[int]]:
    th = d.tt.prune_threshold
    l1 = [params["l1"][f"lambda_{n}"] for n in range(d.spec1.d - 1)]
    l2 = [params["l2"][f"lambda_{n}"] for n in range(d.spec2.d - 1)]
    return (RA.effective_ranks(l1, th), RA.effective_ranks(l2, th))
