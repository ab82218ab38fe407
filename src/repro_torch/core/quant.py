"""Low-precision training numerics (paper §3.2-3.3) — the QAT-facing layer
over ``repro_torch.numerics``; the port of ``repro/core/quant.py``.

- Power-of-2-scaled symmetric fixed point:
  q = clip(round(x / 2^k), -2^{b-1}, 2^{b-1}-1).
- ``quant_edge``: an (8-bit forward, 16-bit backward) quantization point on
  an activation, with the clipped STE and a ``probe`` whose gradient is the
  scale manager's statistic mean|g|/2^k of the backward gradient.
- ``quant_edge_shared``: the zoo LM's edge, on the policy's shared
  managed scales (no probe); ``quant_act``: an activation's fake-quant at
  its managed scale.
- ``update_act_quant``: the §3.3 manager step for one such site.

Both quantizations of an edge run the scalar fake-quant kernel
(``numerics.cuda_backend.fake_quant_scalar``; its plain version on CPU
tensors).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..numerics import codecs
from ..numerics import cuda_backend as CB
from ..numerics.policy import (ScaleState, init_scale, step_log2,  # noqa: F401
                               update_from_stat, update_scale)
from ..numerics.spec import QuantSpec, qrange  # noqa: F401


def quantize_store(x: torch.Tensor, scale_log2, bits: int) -> torch.Tensor:
    """Pure quantize (no STE) — the Q(.) of paper Eq. (3); used on the
    BinaryConnect buffer at export. Runs the codec's encode→decode: each
    core and bias has one step, so on the card that is the scalar-scale
    kernels ``p2_enc`` / ``p2_dec``."""
    return codecs.roundtrip(x, QuantSpec("pow2", bits), scale_log2, "cuda")


def quantize_store_many(xs: list[torch.Tensor], scales_log2: list,
                        bits: int) -> list[torch.Tensor]:
    """``quantize_store`` of each tensor under its own step (``scales_log2[n]``
    for ``xs[n]``), bit for bit: on the card one grouped round-trip launch
    (``p2_fq_group`` in its round-trip mode) for the lot."""
    return CB.roundtrip_many(xs, scales_log2, bits,
                             QuantSpec("pow2", bits).torch_storage)


class ActQuant(NamedTuple):
    """A forward-activation + backward-gradient quantization site: 8-bit
    activations forward, 16-bit gradients backward, independently managed
    scales."""
    act: ScaleState
    grad: ScaleState
    probe: torch.Tensor  # 0-valued scalar; its *gradient* carries mean|g|


def init_act_quant(device=None) -> ActQuant:
    return ActQuant(init_scale(0, device), init_scale(0, device),
                    torch.zeros((), dtype=torch.float32, device=device))


class _QuantEdge(torch.autograd.Function):
    """forward: ``act_bits`` fake-quant of x at step k_act - (act_bits-1);
    backward: ``grad_bits`` fake-quant of g at step k_grad - (grad_bits-1),
    zeroed outside the forward's representable range (clipped STE), and
    the statistic mean|g| / 2^k_grad returned as the probe's gradient."""

    @staticmethod
    def forward(ctx, x, act_log2, grad_log2, probe, act_bits, grad_bits):
        step = act_log2.float() - (act_bits - 1)
        inside = codecs.pow2_inside(x, step, act_bits) \
            if ctx.needs_input_grad[0] else None
        ctx.save_for_backward(inside, grad_log2)
        ctx.grad_bits = grad_bits
        return CB.fake_quant_scalar(x, step, act_bits)

    @staticmethod
    def backward(ctx, g):
        inside, grad_log2 = ctx.saved_tensors
        gq = None
        if ctx.needs_input_grad[0]:
            step = grad_log2.float() - (ctx.grad_bits - 1)
            gq = torch.where(inside,
                             CB.fake_quant_scalar(g, step, ctx.grad_bits),
                             torch.zeros((), dtype=g.dtype, device=g.device))
        stat = None
        if ctx.needs_input_grad[3]:
            stat = torch.mean(torch.abs(g.float())) \
                / torch.exp2(grad_log2.float())
        return gq, None, None, stat, None, None


def quant_edge(x: torch.Tensor, site: ActQuant, act_bits: int,
               grad_bits: int) -> torch.Tensor:
    """Insert an (act_bits fwd, grad_bits bwd) quantization point on ``x``.
    The gradient of ``site.probe`` is the backward-gradient magnitude
    statistic ``update_act_quant`` reads. The backward quantizes g only
    when x itself needs a gradient."""
    return _QuantEdge.apply(x, site.act.log2, site.grad.log2, site.probe,
                            act_bits, grad_bits)


def quant_act(x: torch.Tensor, state: ScaleState, bits: int) -> torch.Tensor:
    """Fake-quant an activation with its managed scale, at step
    ``step_log2(state, bits)`` = k - (bits - 1), with the clipped STE."""
    return codecs.fake_quant(x, QuantSpec("pow2", bits),
                             step_log2(state, bits), backend="cuda")


def quant_edge_shared(x: torch.Tensor, act: ScaleState, grad: ScaleState,
                      act_bits: int, grad_bits: int) -> torch.Tensor:
    """The zoo-LM form of ``quant_edge``: an (act_bits fwd, grad_bits bwd)
    point driven by the policy's shared managed scales (one ``ScaleState``
    owner per site across the whole stack). No probe: the step observes
    the statistic itself (``launch/steps.py``)."""
    return _QuantEdge.apply(x, act.log2, grad.log2,
                            torch.zeros((), dtype=torch.float32,
                                        device=x.device),
                            act_bits, grad_bits)


def update_act_quant(site: ActQuant, x: torch.Tensor,
                     grad_stat: torch.Tensor | None, lo: float, hi: float,
                     ema: float) -> ActQuant:
    """Scale-manager update for one site. ``grad_stat`` is the gradient of
    ``site.probe`` (mean |g|/2^k observed on the backward pass)."""
    act = update_scale(site.act, x, lo=lo, hi=hi, ema=ema)
    grad = site.grad
    if grad_stat is not None:
        grad = update_from_stat(grad, grad_stat, lo=lo, hi=hi, ema=ema)
    return ActQuant(act, grad, site.probe)
