"""Gradient compression for the data-parallel wire: int8 block-quantized
gradients with error feedback (the residual is carried to the next step) —
the port of ``repro/optim/grad_compress.py``'s single-program path.

The quantizer is the ``dp_wire`` site: each gradient leaf is flattened and
round-tripped through the blockwise int8 codec at block 1024 (one f32 scale
per KiB of payload), on the card every leaf encoded by one group launch of
the ``bw_enc`` kernel and decoded by one of the ``bw_dec`` kernel. A leaf
is the reference's: the per-layer tensors of a stacked leaf (``layers/<l>/
...``, ``tree.stacked_groups``) are flattened together in layer order, so
the blocks fall where the reference's do.
``psum_int8``, the collective that puts the codes themselves on the wire,
comes with the multi-device slice (ROADMAP queue 1).

Usage, before the optimizer:
    grads_c, residual = compress_decompress(grads, residual)
"""
from __future__ import annotations

import torch

from ..numerics import QuantSpec, decode_many, encode_many, spec_nbytes
from ..tree import flatten_with_path, stacked_groups, unflatten
from .adam import _is_float

WIRE_SPEC = QuantSpec("blockwise", 8, 1024, "int8", "per_tensor_max")


def residual_nbytes(residual) -> int:
    """Resident bytes of an error-feedback residual tuple (None entries are
    non-float leaves that carry no residual)."""
    if residual is None:
        return 0
    return sum(r.numel() * r.element_size() for r in residual
               if r is not None)


def _wire_groups(flat: list) -> list[list[int]]:
    """Flat positions of the floating leaves, grouped as the reference's
    leaves (``tree.stacked_groups``)."""
    live = [i for i, (_, g) in enumerate(flat) if _is_float(g)]
    return [[live[k] for k in group]
            for group in stacked_groups([flat[i][0] for i in live])]


def wire_nbytes(grads, spec: QuantSpec = WIRE_SPEC) -> tuple[int, int]:
    """(encoded, fp32) bytes of one gradient payload: each float leaf
    (the reference's: a stacked leaf's per-layer tensors together)
    flattens and encodes blockwise (codes padded to a block multiple + one
    f32 scale per block)."""
    flat = flatten_with_path(grads)
    enc = fp32 = 0
    for group in _wire_groups(flat):
        n = sum(flat[i][1].numel() for i in group)
        enc += spec_nbytes(spec, (n,))
        fp32 += 4 * n
    return enc, fp32


def compress_decompress(grads, residual, spec: QuantSpec = WIRE_SPEC):
    """Returns (compressed grads, new residual): every floating leaf of
    ``grads`` plus its residual, flattened (a stacked leaf's per-layer
    tensors together), encoded and decoded; the new residual is what the
    round trip lost. ``residual=None`` initializes zeros; it is a tuple
    aligned with the flattened leaves (None for the non-float ones)."""
    pflat = flatten_with_path(grads)
    flat = [g for _, g in pflat]
    if residual is None:
        residual = tuple(torch.zeros_like(g, dtype=torch.float32)
                         if _is_float(g) else None for g in flat)
    out, new_res = list(flat), list(residual)
    groups = [[i for i in group if residual[i] is not None]
              for group in _wire_groups(pflat)]
    groups = [group for group in groups if group]
    corrected = [torch.cat([(flat[i].float() + residual[i]).reshape(-1)
                            for i in group]) if len(group) > 1
                 else (flat[group[0]].float()
                       + residual[group[0]]).reshape(-1)
                 for group in groups]
    qts = encode_many(corrected, spec, backend="cuda")
    deqs = decode_many(qts, torch.float32, backend="cuda")
    for group, c, deq in zip(groups, corrected, deqs):
        lost = c - deq
        at = 0
        for i in group:
            n = flat[i].numel()
            out[i] = deq[at:at + n].reshape(flat[i].shape).to(flat[i].dtype)
            new_res[i] = lost[at:at + n].reshape(flat[i].shape)
            at += n
    return unflatten(grads, out), tuple(new_res)
