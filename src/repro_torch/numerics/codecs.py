"""Codec registry: ``encode / decode`` for the pow-2 QuantSpec, with
selectable backends — the port of ``repro/numerics/codecs.py`` as far as
the serving slice needs it.

- ``"reference"``: plain PyTorch — the numerics oracle, runs everywhere.
- ``"cuda"``: the hand-written row-scale kernels of
  ``kernels/csrc/pow2_rows.cu`` (``numerics/cuda_backend.py``), codes
  bit-identical to the reference. On a CPU tensor it runs the kernel's
  plain version.

Numerics contract (``repro``'s, unchanged): pow2 encode/decode compute in
f32, ``round`` is half-to-even, codes clip to ``qrange(bits)``, and a
non-scalar scale broadcasts against the LEADING dims of the data
(``_bcast``: one scale per (layer, slot) of the KV pool).

Not yet ported (ROADMAP): ``fake_quant`` with the clipped STE, the
``epilogue`` shared with PE1, int4x2 packing, and the blockwise codec.
"""
from __future__ import annotations

import torch

from .spec import QTensor, QuantSpec, qrange


def _bcast(scale, ndim: int, device=None) -> torch.Tensor:
    """Right-pad ``scale``'s shape with 1s so it broadcasts against the
    *leading* dims of an ndim-D tensor (the kv-cache layout: one scale per
    (layer, slot), data (L, S, *feat))."""
    scale = torch.as_tensor(scale, dtype=torch.float32, device=device)
    return scale.reshape(tuple(scale.shape) + (1,) * (ndim - scale.dim()))


class Pow2Reference:
    """Reference pow-2 codec in plain PyTorch."""
    kind = "pow2"
    backend = "reference"

    def encode(self, x: torch.Tensor, spec: QuantSpec, scale) -> QTensor:
        if spec.packed:
            raise NotImplementedError(
                "int4x2 packed codes come with the packed-codec slice "
                "(ROADMAP queue 2)")
        lo, hi = qrange(spec.bits)
        step = torch.exp2(_bcast(scale, x.dim(), x.device))
        q = torch.clamp(torch.round(x.float() / step), lo, hi)
        return QTensor(q.to(spec.torch_storage), scale, spec, tuple(x.shape))

    def decode(self, qt: QTensor, dtype=torch.float32) -> torch.Tensor:
        if qt.spec.packed:
            raise NotImplementedError(
                "int4x2 packed codes come with the packed-codec slice "
                "(ROADMAP queue 2)")
        step = torch.exp2(_bcast(qt.scale, qt.codes.dim(), qt.codes.device))
        return (qt.codes.float() * step).to(dtype)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_CODECS: dict[tuple[str, str], object] = {
    ("pow2", "reference"): Pow2Reference(),
}

BACKENDS = ("reference", "cuda")


def register_codec(kind: str, backend: str, codec) -> None:
    _CODECS[(kind, backend)] = codec


def get_codec(spec: QuantSpec | str, backend: str = "reference"):
    """Codec for ``spec`` on ``backend``. The CUDA backend registers on
    first request (its kernels build at first launch, never at import)."""
    kind = spec if isinstance(spec, str) else spec.kind
    key = (kind, backend)
    if key not in _CODECS and backend == "cuda":
        from . import cuda_backend  # noqa: F401  (registers on import)
    if key not in _CODECS:
        raise KeyError(f"no codec for kind={kind!r} backend={backend!r}; "
                       f"registered: {sorted(_CODECS)}")
    return _CODECS[key]


def encode(x: torch.Tensor, spec: QuantSpec, scale=None,
           backend: str = "reference") -> QTensor:
    return get_codec(spec, backend).encode(x, spec, scale)


def decode(qt: QTensor, dtype=torch.float32,
           backend: str = "reference") -> torch.Tensor:
    return get_codec(qt.spec, backend).decode(qt, dtype)


def per_tensor_max_scale_log2(x: torch.Tensor, spec: QuantSpec,
                              valid=None, reduce_axes=None) -> torch.Tensor:
    """``scale_policy="per_tensor_max"``: smallest pow-2 step whose ±qmax
    range covers max|x| (the KV pool's prefill scale choice).

    ``valid``: optional bool mask broadcastable against x (rows to include).
    ``reduce_axes``: axes folded into the max (default: all).
    """
    a = torch.abs(x.float())
    if valid is not None:
        a = a * valid
    maxabs = torch.amax(a) if reduce_axes is None \
        else torch.amax(a, dim=tuple(reduce_axes))
    return torch.ceil(torch.log2(torch.clamp(maxabs, min=1e-8) / spec.qmax))
