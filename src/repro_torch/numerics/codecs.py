"""Codec registry: ``encode / decode / fake_quant`` for every QuantSpec,
with selectable backends — the port of ``repro/numerics/codecs.py``.

- ``"reference"``: plain PyTorch — the numerics oracle, runs everywhere.
- ``"cuda"``: the hand-written kernels (``numerics/cuda_backend.py``): the
  scalar-scale encode/decode of ``kernels/csrc/pow2_scalar.cu``, the
  row-scale encode/decode of ``kernels/csrc/pow2_rows.cu``, the scalar- and
  row-scale fake-quant of ``kernels/csrc/pow2_fq.cu``, the int4x2 packed
  encode/decode of ``kernels/csrc/pow2_packed.cu`` and the blockwise
  encode/decode of ``kernels/csrc/blockwise.cu``, bit-identical to the
  reference. On a CPU tensor it runs the kernels' plain versions.

Numerics contract (``repro``'s, unchanged): pow2 encode/decode compute in
f32; pow2 fake_quant computes in ``x.dtype`` with ``scale = exp2(k)`` cast
to ``x.dtype`` and the clip bounds in ``x.dtype`` too (as JAX's
weak-typed ``jnp.clip`` does: a bf16 16-bit ``hi`` of 32767 is 32768);
``round`` is half-to-even, codes clip to ``qrange(bits)`` and saturate to
their storage type (``to_storage``), and a
non-scalar scale broadcasts against the LEADING dims of the data
(``_bcast``: one scale per (layer, slot) of the KV pool). Packed int4x2
codes pair nibbles along the trailing axis, the low nibble holding the
even index. Blockwise uses symmetric ±(2^{b-1}-1) codes with ``scale =
absmax/qmax`` (an IEEE division) and ``codes = rint(x / max(scale,
1e-20))``.
"""
from __future__ import annotations

import torch

from .spec import QTensor, QuantSpec, qrange


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int4 codes (values in [-8, 7]) two per byte along the trailing
    axis: the low nibble holds the even index. An odd trailing dim gets one
    zero pad nibble (the high nibble of the last byte). Returns int8 of
    shape ``q.shape[:-1] + (ceil(last/2),)``."""
    v = q.to(torch.int32)
    if v.shape[-1] % 2:
        v = torch.cat([v, v.new_zeros(v.shape[:-1] + (1,))], dim=-1)
    lo = v[..., 0::2] & 0xF
    hi = v[..., 1::2] & 0xF
    return (lo | (hi << 4)).to(torch.int8)


def unpack_int4(packed: torch.Tensor, last: int) -> torch.Tensor:
    """Inverse of ``pack_int4``: int8 bytes -> int32 codes in [-8, 7] of
    trailing dim ``last`` (the pad nibble, if any, is sliced away)."""
    v = packed.to(torch.int32) & 0xFF
    lo = ((v & 0xF) ^ 8) - 8                 # sign-extend each nibble
    hi = ((v >> 4) ^ 8) - 8
    q = torch.stack([lo, hi], dim=-1).reshape(
        tuple(packed.shape[:-1]) + (packed.shape[-1] * 2,))
    return q[..., :last]


def to_storage(q: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Integer-valued codes ``q`` in the storage ``dtype``, saturated to an
    integer type's range as JAX's float-to-int conversion saturates (a
    32-bit grid's top, 2^31 - 1, is 2^31 in f32; a grid wider than its
    storage keeps the type's ends)."""
    if dtype.is_floating_point:
        return q.to(dtype)
    info = torch.iinfo(dtype)
    if dtype == torch.int32 and q.dtype != torch.float64:
        # INT32_MAX is no f32: clamp to the largest f32 below 2^31, then
        # put the values at or past 2^31 at the top
        low = torch.clamp(q, info.min, 2147483520.0).to(dtype)
        return torch.where(q >= 2.0 ** 31, info.max, low)
    return torch.clamp(q, info.min, info.max).to(dtype)


def _bcast(scale, ndim: int, device=None) -> torch.Tensor:
    """Right-pad ``scale``'s shape with 1s so it broadcasts against the
    *leading* dims of an ndim-D tensor (the kv-cache layout: one scale per
    (layer, slot), data (L, S, *feat))."""
    scale = torch.as_tensor(scale, dtype=torch.float32, device=device)
    return scale.reshape(tuple(scale.shape) + (1,) * (ndim - scale.dim()))


def _bounds(bits: int, dtype: torch.dtype) -> tuple[float, float]:
    """``qrange(bits)`` rounded to ``dtype`` — the bounds JAX's ``jnp.clip``
    applies to an array of that dtype (a bf16 16-bit grid clips at 32768,
    not 32767). Rounded on the host, they compare the same in any
    precision, and a call on the card copies nothing to the device."""
    lo, hi = torch.tensor(qrange(bits), dtype=dtype).tolist()
    return lo, hi


def pow2_qdq(x: torch.Tensor, scale_log2, bits: int) -> torch.Tensor:
    """Raw quantize-dequantize on the pow-2 grid in ``x.dtype`` — the Q(.)
    of paper Eq. (3), no gradient rule attached. ``scale_log2`` is a
    scalar or a tensor that broadcasts against ``x``."""
    scale = torch.exp2(torch.as_tensor(scale_log2, dtype=torch.float32,
                                       device=x.device)).to(x.dtype)
    lo, hi = _bounds(bits, x.dtype)
    return torch.clamp(torch.round(x / scale), lo, hi) * scale


def pow2_inside(x: torch.Tensor, scale_log2, bits: int) -> torch.Tensor:
    """The clipped STE's mask: where ``x / 2^k`` (in ``x.dtype``) lies in
    the representable range."""
    scale = torch.exp2(torch.as_tensor(scale_log2, dtype=torch.float32,
                                       device=x.device)).to(x.dtype)
    lo, hi = _bounds(bits, x.dtype)
    v = x / scale
    return (v >= lo) & (v <= hi)


class _Pow2STE(torch.autograd.Function):
    """Quantize-dequantize with the clipped straight-through estimator:
    the gradient passes where the pre-quant value was representable, zero
    outside (the paper's "clipped ReLU" STE). ``qdq`` computes the value
    (the plain ``pow2_qdq`` or a kernel); the mask is plain PyTorch, kept
    outside any kernel as in ``repro``'s Pallas backend."""

    @staticmethod
    def forward(ctx, x, scale_log2, bits, qdq):
        if ctx.needs_input_grad[0]:
            ctx.save_for_backward(pow2_inside(x, scale_log2, bits))
        return qdq(x, scale_log2, bits)

    @staticmethod
    def backward(ctx, g):
        inside, = ctx.saved_tensors
        return (torch.where(inside, g, torch.zeros((), dtype=g.dtype,
                                                   device=g.device)),
                None, None, None)


def pow2_fake_quant(x: torch.Tensor, scale_log2, bits: int,
                    qdq=pow2_qdq) -> torch.Tensor:
    """``pow2_qdq`` with the clipped STE backward (``repro``'s
    ``pow2_fake_quant`` custom_vjp)."""
    return _Pow2STE.apply(x, scale_log2, bits, qdq)


class _Pow2STEMany(torch.autograd.Function):
    """``_Pow2STE`` over a list of tensors, each with its own scalar step:
    ``qdq_many(xs, steps, bits)`` computes every value at once (a group
    kernel), and the backward of each tensor is ``_Pow2STE``'s, its own
    mask's ``where(inside, g, 0)``."""

    @staticmethod
    def forward(ctx, steps_log2, bits, qdq_many, *xs):
        if any(ctx.needs_input_grad[3:]):
            ctx.save_for_backward(*[pow2_inside(x, steps_log2[n], bits)
                                    for n, x in enumerate(xs)])
        return tuple(qdq_many(list(xs), steps_log2, bits))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, None) + tuple(
            torch.where(inside, g, torch.zeros((), dtype=g.dtype,
                                               device=g.device))
            for inside, g in zip(ctx.saved_tensors, gs))


def pow2_fake_quant_many(xs: list[torch.Tensor], steps_log2: torch.Tensor,
                         bits: int, qdq_many) -> list[torch.Tensor]:
    """``pow2_fake_quant(xs[n], steps_log2[n], bits)`` for every n, the
    values from one call of ``qdq_many`` (a group kernel on the card), the
    gradient of each tensor exactly ``pow2_fake_quant``'s."""
    if not xs:
        return []
    steps = torch.as_tensor(steps_log2, dtype=torch.float32,
                            device=xs[0].device).reshape(-1)
    return list(_Pow2STEMany.apply(steps, bits, qdq_many, *xs))


class Pow2Reference:
    """Reference pow-2 codec in plain PyTorch."""
    kind = "pow2"
    backend = "reference"

    def encode(self, x: torch.Tensor, spec: QuantSpec, scale) -> QTensor:
        lo, hi = qrange(spec.bits)
        step = torch.exp2(_bcast(scale, x.dim(), x.device))
        q = torch.clamp(torch.round(x.float() / step), lo, hi)
        if spec.packed:
            # 0-d: one (1,)-code row (one nibble + one pad nibble); decode's
            # `shape or (1,)` mirrors this
            return QTensor(pack_int4(q[None] if q.dim() == 0 else q), scale,
                           spec, tuple(x.shape))
        return QTensor(to_storage(q, spec.torch_storage), scale, spec,
                       tuple(x.shape))

    def decode(self, qt: QTensor, dtype=torch.float32) -> torch.Tensor:
        codes = qt.codes
        if qt.spec.packed:
            codes = unpack_int4(codes, qt.shape[-1] if qt.shape else 1)
        step = torch.exp2(_bcast(qt.scale, codes.dim(), codes.device))
        out = codes.float() * step
        return out.reshape(qt.shape).to(dtype) if qt.spec.packed \
            else out.to(dtype)

    def epilogue(self, acc: torch.Tensor, spec: QuantSpec,
                 scale_log2) -> torch.Tensor:
        """Requantize-on-writeback in f32: the FPGA PE's fused epilogue,
        the same round/clip/scale as encode→decode (PE1's plain version
        calls it; the CUDA kernel's epilogue is held to it bit for bit)."""
        scale = torch.exp2(torch.as_tensor(scale_log2, dtype=torch.float32,
                                           device=acc.device))
        lo, hi = qrange(spec.bits)
        return torch.clamp(torch.round(acc / scale), lo, hi) * scale

    def fake_quant(self, x: torch.Tensor, spec: QuantSpec,
                   scale) -> torch.Tensor:
        # non-scalar scales broadcast against x's LEADING dims (_bcast),
        # the codec API's one scale convention
        return pow2_fake_quant(x, _bcast(scale, x.dim(), x.device),
                               spec.bits)

    def fake_quant_many(self, xs: list[torch.Tensor], spec: QuantSpec,
                        scales) -> list[torch.Tensor]:
        """``fake_quant(xs[n], spec, scales[n])`` for every n (one scalar
        scale per tensor)."""
        return [self.fake_quant(x, spec, scales[n]) for n, x in enumerate(xs)]


# ---------------------------------------------------------------------------
# blockwise: per-block absmax along the last axis
# ---------------------------------------------------------------------------

def blockwise_geometry(spec: QuantSpec, last: int) -> tuple[int, int, int]:
    """(block, num_blocks, pad) along a last axis of size ``last``. The block
    clamps to the axis so the codes keep the leading shape of the input."""
    b = min(spec.block, max(1, last))
    nb = -(-last // b)
    return b, nb, nb * b - last


class BlockwiseReference:
    """Reference blockwise-absmax codec in plain PyTorch (Dettmers-style)."""
    kind = "blockwise"
    backend = "reference"

    def encode(self, x: torch.Tensor, spec: QuantSpec, scale=None) -> QTensor:
        v = x.float()
        if v.dim() == 0:
            v = v[None]
        shape = tuple(v.shape)
        b, nb, pad = blockwise_geometry(spec, shape[-1])
        if pad:
            v = torch.cat([v, v.new_zeros(shape[:-1] + (pad,))], dim=-1)
        blocks = v.reshape(shape[:-1] + (nb, b))
        qmax = spec.qmax
        # divide by a tensor on the data's device: PyTorch's CUDA division
        # by a Python number multiplies by its f32 reciprocal instead,
        # which can leave the scale an ulp off max|x| / qmax
        sc = torch.amax(torch.abs(blocks), dim=-1) / blocks.new_full((),
                                                                     qmax)
        q = torch.round(blocks / torch.clamp(sc, min=1e-20)[..., None])
        codes = to_storage(torch.clamp(q, -qmax, qmax), spec.torch_storage)
        return QTensor(codes.reshape(shape[:-1] + (nb * b,)), sc, spec, shape)

    def encode_many(self, xs: list[torch.Tensor],
                    spec: QuantSpec) -> list[QTensor]:
        return [self.encode(x, spec) for x in xs]

    def decode(self, qt: QTensor, dtype=torch.float32) -> torch.Tensor:
        nb = qt.scale.shape[-1]
        b = qt.codes.shape[-1] // nb
        lead = tuple(qt.codes.shape[:-1])
        blocks = qt.codes.float().reshape(lead + (nb, b)) * qt.scale[..., None]
        flat = blocks.reshape(lead + (nb * b,))
        out = flat[..., :qt.shape[-1]] if qt.shape else flat[..., :1]
        return out.reshape(qt.shape).to(dtype)

    def decode_many(self, qts: list[QTensor],
                    dtype=torch.float32) -> list[torch.Tensor]:
        return [self.decode(qt, dtype) for qt in qts]

    def fake_quant(self, x: torch.Tensor, spec: QuantSpec,
                   scale=None) -> torch.Tensor:
        # plain STE: identity gradient (blockwise sites sit outside autograd)
        y = self.decode(self.encode(x, spec), x.dtype)
        return x + (y - x).detach()


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_CODECS: dict[tuple[str, str], object] = {
    ("pow2", "reference"): Pow2Reference(),
    ("blockwise", "reference"): BlockwiseReference(),
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


def encode_many(xs: list[torch.Tensor], spec: QuantSpec,
                backend: str = "reference") -> list[QTensor]:
    """``encode(x, spec)`` of every tensor of ``xs`` (a blockwise spec: no
    scale to pass); the ``cuda`` backend encodes them in one group
    launch."""
    return get_codec(spec, backend).encode_many(xs, spec)


def decode(qt: QTensor, dtype=torch.float32,
           backend: str = "reference") -> torch.Tensor:
    return get_codec(qt.spec, backend).decode(qt, dtype)


def decode_many(qts: list[QTensor], dtype=torch.float32,
                backend: str = "reference") -> list[torch.Tensor]:
    """``decode(qt, dtype)`` of every blockwise ``QTensor`` of ``qts``; the
    ``cuda`` backend decodes them in one group launch."""
    if not qts:
        return []
    return get_codec(qts[0].spec, backend).decode_many(qts, dtype)


def fake_quant(x: torch.Tensor, spec: QuantSpec, scale=None,
               backend: str = "reference") -> torch.Tensor:
    """Quantize-dequantize with the clipped STE (the §3.2 Q(.))."""
    return get_codec(spec, backend).fake_quant(x, spec, scale)


def fake_quant_many(xs: list[torch.Tensor], spec: QuantSpec, scales,
                    backend: str = "reference") -> list[torch.Tensor]:
    """``fake_quant(xs[n], spec, scales[n])`` for every n, one scalar scale
    per tensor; the ``cuda`` pow2 codec runs one group launch."""
    return get_codec(spec, backend).fake_quant_many(xs, spec, scales)


def fake_quant_stats(x: torch.Tensor, spec: QuantSpec, scale=None,
                     backend: str = "reference"
                     ) -> tuple[torch.Tensor, tuple[torch.Tensor,
                                                    torch.Tensor]]:
    """``fake_quant`` with a quant-health aux output: ``(y, (clipped,
    total))`` int32 counts of values outside the representable range
    (``obs.pow2_clip_stats``). For blockwise specs the scale is data-derived
    (absmax covers the range), so the aux reports saturated codes instead —
    the same "pinned at the grid edge" health signal."""
    from ..obs.counters import pow2_clip_stats, saturation_counts
    y = fake_quant(x, spec, scale, backend)
    if spec.kind == "pow2":
        return y, pow2_clip_stats(x.detach(), scale, spec.bits)
    return y, saturation_counts(get_codec(spec, backend).encode(
        x.detach(), spec, scale))


def roundtrip(x: torch.Tensor, spec: QuantSpec, scale=None,
              backend: str = "reference") -> torch.Tensor:
    """decode(encode(x)) without STE — pure value quantization (the
    optimizer moments and the gradient wire, where no gradient flows)."""
    codec = get_codec(spec, backend)
    return codec.decode(codec.encode(x, spec, scale), x.dtype)


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
