"""BinaryConnect deploy quantization (paper Eq. 3) — the port of
``repro/optim/binaryconnect.py``.

The full-precision buffer is the params tree itself; the forward pass sees
fake-quantized cores (``core.tt_layer.effective_cores``) and the optimizer
updates the buffer with gradients taken through the STE. At export the
cores are hard-quantized to ``weight_bits`` on their fixed per-core steps
and the biases to ``act_bits`` under one constant step, through the codec's
encode→decode. On the card the leaves of one bit width go through one
grouped round-trip launch (``core.quant.quantize_store_many``): two an
export, where the reference encodes and decodes leaf by leaf.
"""
from __future__ import annotations

import torch

from ..configs.base import QuantConfig
from ..core import quant as Q


def deploy_leaves(params, qc: QuantConfig) -> dict:
    """The leaves the export quantizes, by (bits, dtype): lists of (the
    dict holding the leaf, its key, the leaf, its step as a one-element
    f32 tensor on the leaf's device). Pure bookkeeping: the plan of the
    export's launches (one per key)."""
    groups: dict = {}

    def visit(tree):
        if not isinstance(tree, dict):
            return
        steps = tree.get("wscale_log2")
        fsteps = None if steps is None else steps.float()
        for k, v in tree.items():
            if isinstance(v, dict):
                visit(v)
            elif k.startswith("core_") and fsteps is not None:
                groups.setdefault((qc.weight_bits, v.dtype), []).append(
                    (tree, k, v, fsteps[int(k.split("_")[1])]))
            elif k in ("bias", "b"):
                step = torch.tensor(-(qc.act_bits - 1.0), device=v.device)
                groups.setdefault((qc.act_bits, v.dtype), []).append(
                    (tree, k, v, step))

    visit(params)
    return groups


def quantize_for_deploy(params, qc: QuantConfig):
    """Hard-quantize TT cores (and biases) for inference export."""
    def copy(tree):
        return {k: copy(v) for k, v in tree.items()} \
            if isinstance(tree, dict) else tree

    out = copy(params)
    for (bits, _), leaves in deploy_leaves(out, qc).items():
        ys = Q.quantize_store_many([v for _, _, v, _ in leaves],
                                   [s for _, _, _, s in leaves], bits)
        for (tree, k, _, _), y in zip(leaves, ys):
            tree[k] = y
    return out
