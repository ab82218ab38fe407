"""Gradient compression for the data-parallel wire: int8 block-quantized
gradients with error feedback (the residual is carried to the next step) —
the port of ``repro/optim/grad_compress.py``'s single-program path.

The quantizer is the ``dp_wire`` site: each gradient leaf is flattened and
round-tripped through the blockwise int8 codec at block 1024 (one f32 scale
per KiB of payload), on the card every leaf encoded by one group launch of
the ``bw_enc`` kernel and decoded by one of the ``bw_dec`` kernel.
``psum_int8``, the collective that puts the codes themselves on the wire,
comes with the multi-device slice (ROADMAP queue 1).

Usage, before the optimizer:
    grads_c, residual = compress_decompress(grads, residual)
"""
from __future__ import annotations

import torch

from ..numerics import QuantSpec, decode_many, encode_many, spec_nbytes
from ..tree import leaves, unflatten

WIRE_SPEC = QuantSpec("blockwise", 8, 1024, "int8", "per_tensor_max")


def _is_float(g) -> bool:
    return isinstance(g, torch.Tensor) and g.is_floating_point()


def residual_nbytes(residual) -> int:
    """Resident bytes of an error-feedback residual tuple (None entries are
    non-float leaves that carry no residual)."""
    if residual is None:
        return 0
    return sum(r.numel() * r.element_size() for r in residual
               if r is not None)


def wire_nbytes(grads, spec: QuantSpec = WIRE_SPEC) -> tuple[int, int]:
    """(encoded, fp32) bytes of one gradient payload: each float leaf
    flattens and encodes blockwise (codes padded to a block multiple + one
    f32 scale per block)."""
    enc = fp32 = 0
    for g in leaves(grads):
        if _is_float(g):
            enc += spec_nbytes(spec, (g.numel(),))
            fp32 += 4 * g.numel()
    return enc, fp32


def compress_decompress(grads, residual, spec: QuantSpec = WIRE_SPEC):
    """Returns (compressed grads, new residual): every floating leaf of
    ``grads`` plus its residual, flattened, encoded and decoded; the new
    residual is what the round trip lost. ``residual=None`` initializes
    zeros; it is a tuple aligned with the flattened leaves (None for the
    non-float ones)."""
    flat = leaves(grads)
    if residual is None:
        residual = tuple(torch.zeros_like(g, dtype=torch.float32)
                         if _is_float(g) else None for g in flat)
    out, new_res = list(flat), list(residual)
    live = [i for i, (g, r) in enumerate(zip(flat, residual))
            if r is not None and _is_float(g)]
    corrected = [flat[i].float() + residual[i] for i in live]
    qts = encode_many([c.reshape(-1) for c in corrected], spec,
                      backend="cuda")
    deqs = decode_many(qts, torch.float32, backend="cuda")
    for i, c, deq in zip(live, corrected, deqs):
        deq = deq.reshape(c.shape)
        out[i] = deq.to(flat[i].dtype)
        new_res[i] = c - deq
    return unflatten(grads, out), tuple(new_res)
