"""BinaryConnect deploy quantization (paper Eq. 3) — the port of
``repro/optim/binaryconnect.py``.

The full-precision buffer is the params tree itself; the forward pass sees
fake-quantized cores (``core.tt_layer.effective_cores``) and the optimizer
updates the buffer with gradients taken through the STE. At export the
cores are hard-quantized to ``weight_bits`` on their fixed per-core steps
and the biases to ``act_bits``, through the codec's encode→decode (one
step per leaf: the scalar-scale kernels ``p2_enc`` / ``p2_dec`` on the
card).
"""
from __future__ import annotations

import torch

from ..configs.base import QuantConfig
from ..core import quant as Q


def quantize_for_deploy(params, qc: QuantConfig):
    """Hard-quantize TT cores (and biases) for inference export."""
    def visit(tree):
        if not isinstance(tree, dict):
            return tree
        out = {}
        steps = tree.get("wscale_log2")
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = visit(v)
            elif k.startswith("core_") and steps is not None:
                n = int(k.split("_")[1])
                out[k] = Q.quantize_store(v, steps[n].float(),
                                          qc.weight_bits)
            elif k in ("bias", "b"):
                out[k] = Q.quantize_store(
                    v, torch.tensor(-(qc.act_bits - 1.0), device=v.device),
                    qc.act_bits)
            else:
                out[k] = v
        return out

    return visit(params)
