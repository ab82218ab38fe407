"""Quantization descriptors: ``QuantSpec`` (how to quantize) and ``QTensor``
(a quantized tensor: codes + scale metadata) — the port of
``repro/numerics/spec.py``.

- ``kind="pow2"``: symmetric fixed point on a power-of-2 grid,
  ``x ≈ q * 2^scale_log2`` with ``q ∈ [-2^{b-1}, 2^{b-1}-1]`` (paper §3.2).
- ``kind="blockwise"``: per-block absmax along the last axis,
  ``q ∈ [-(2^{b-1}-1), 2^{b-1}-1]``, one f32 scale per block of ``block``
  elements (the optimizer moments and the gradient wire).

Specs are frozen dataclasses, hashable and JSON-round-trippable.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

KINDS = ("pow2", "blockwise")
SCALE_POLICIES = ("fixed", "managed", "per_tensor_max")
# "int4x2": two 4-bit codes per int8 byte along the trailing axis
STORAGE_DTYPES = ("int8", "int16", "int32", "float32", "int4x2")

_TORCH_STORAGE = {"int8": torch.int8, "int16": torch.int16,
                  "int32": torch.int32, "float32": torch.float32,
                  "int4x2": torch.int8}


def packed_trailing(last: int) -> int:
    """Packed trailing dim of an int4x2 code array: two codes per byte."""
    return -(-last // 2)


def qrange(bits: int) -> tuple[float, float]:
    """Representable code range of a ``bits``-bit pow2 grid: the full
    asymmetric two's-complement range (``qrange(8) == (-128, 127)``)."""
    return -(2.0 ** (bits - 1)), 2.0 ** (bits - 1) - 1.0


@dataclass(frozen=True)
class QuantSpec:
    """Frozen description of one quantization scheme."""
    kind: str = "pow2"              # "pow2" | "blockwise"
    bits: int = 8
    block: int = 0                  # blockwise: elements per scale (0 for pow2)
    storage_dtype: str = "int8"     # dtype codes are materialized in
    scale_policy: str = "fixed"     # "fixed" | "managed" | "per_tensor_max"

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown kind {self.kind!r}; one of {KINDS}")
        if self.scale_policy not in SCALE_POLICIES:
            raise ValueError(f"unknown scale_policy {self.scale_policy!r}")
        if self.kind == "blockwise" and self.block <= 0:
            raise ValueError("blockwise spec needs block > 0")
        if self.storage_dtype not in STORAGE_DTYPES:
            raise ValueError(f"unknown storage_dtype {self.storage_dtype!r}; "
                             f"one of {STORAGE_DTYPES}")
        if self.packed and (self.kind != "pow2" or self.bits > 4):
            raise ValueError("int4x2 packed storage holds one nibble per "
                             "code: pow2 kind with bits <= 4 only")

    @property
    def packed(self) -> bool:
        """Two codes per stored byte (``storage_dtype="int4x2"``)."""
        return self.storage_dtype == "int4x2"

    @property
    def qmin(self) -> float:
        lo, hi = qrange(self.bits)
        return -hi if self.kind == "blockwise" else lo

    @property
    def qmax(self) -> float:
        return qrange(self.bits)[1]

    @property
    def torch_storage(self) -> torch.dtype:
        """Storage dtype of the codes (packed int4 codes are int8 bytes)."""
        return _TORCH_STORAGE[self.storage_dtype]

    def to_json_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json_dict(cls, d: dict) -> "QuantSpec":
        return cls(**d)


class QTensor:
    """A quantized tensor: integer ``codes`` + ``scale`` metadata.

    - pow2: ``scale`` is the ``scale_log2`` (a number or a tensor: scalar,
      or one value per leading index — see ``codecs._bcast``); value =
      codes * 2^scale. With packed ``int4x2`` storage ``codes`` is
      ``shape[:-1] + (ceil(last/2),)`` int8 bytes, two nibbles each.
    - blockwise: ``codes`` is ``shape[:-1] + (nb*block,)`` (last axis
      padded to a block multiple), ``scale`` is ``shape[:-1] + (nb,)`` f32;
      value = codes * scale per block, sliced back to ``shape``."""

    __slots__ = ("codes", "scale", "spec", "shape")

    def __init__(self, codes: torch.Tensor, scale, spec: QuantSpec,
                 shape: tuple[int, ...] | None = None):
        self.codes = codes
        self.scale = scale
        self.spec = spec
        self.shape = tuple(shape) if shape is not None \
            else tuple(codes.shape)

    def nbytes(self) -> int:
        """Resident bytes of the quantized representation. A scale given
        as a Python number counts as the 4-byte scalar ``repro`` stores it
        as (its codecs wrap every scale in an array)."""
        n = self.codes.numel() * self.codes.element_size()
        if isinstance(self.scale, torch.Tensor):
            n += self.scale.numel() * self.scale.element_size()
        elif self.scale is not None:
            n += 4
        return n

    def __repr__(self):
        return (f"QTensor(kind={self.spec.kind!r}, bits={self.spec.bits}, "
                f"shape={self.shape}, nbytes={self.nbytes()})")


def spec_nbytes(spec: QuantSpec, shape: tuple[int, ...]) -> int:
    """Analytic resident bytes of quantizing ``shape`` under ``spec``
    (without materializing): codes + scale metadata."""
    n = math.prod(shape) if shape else 1
    itemsize = torch.empty((), dtype=spec.torch_storage).element_size()
    last = shape[-1] if shape else 1
    lead = n // max(last, 1)
    if spec.kind == "pow2":
        if spec.packed:
            return lead * packed_trailing(last) * itemsize + 4
        return n * itemsize + 4
    b = min(spec.block, max(1, last))
    nb = -(-last // b)
    return lead * nb * b * itemsize + lead * nb * 4
