"""repro_torch.numerics against repro.numerics (the JAX reference).

The row-scale pow-2 codec is the KV pool's write and read path. Its codes
must be BIT-identical to ``repro``'s ``Pow2Reference`` and to the Pallas
row-scale kernels (interpret mode on the CPU), for every pool-shaped
scale layout, f32 and bf16 inputs, exact .5 ties (half-to-even) and
clipping at both ends of [-128, 127]. On CPU tensors the port's ``cuda``
codec runs its kernels' plain versions, so these tests hold the plain
versions — the oracle the CUDA kernels meet on the card — to the
reference.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import numerics as JN  # noqa: E402
from repro_torch import numerics as TN  # noqa: E402
from repro_torch.numerics import cuda_backend as CB  # noqa: E402

SPEC_J = JN.QuantSpec("pow2", 8, 0, "int8", "per_tensor_max")
SPEC_T = TN.QuantSpec("pow2", 8, 0, "int8", "per_tensor_max")


def _to_torch(a) -> "torch.Tensor":
    """Same bits on both sides (bf16 via its uint16 pattern)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(a) -> np.ndarray:
    """Raw bit patterns of a numpy array or tensor (16-bit floats as
    int16), so equality is bit equality."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16) if a.element_size() == 2 else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a


def _data(shape, scale_shape, seed):
    """Values on and around the pow-2 grid: random, exact .5 ties, and far
    outside the int8 range at both ends."""
    rng = np.random.RandomState(seed)
    s = rng.randint(-8, 3, scale_shape).astype(np.float32)
    step = np.exp2(s).reshape(scale_shape + (1,) * (len(shape)
                                                   - len(scale_shape)))
    n = int(np.prod(shape))
    kind = rng.randint(0, 4, n).reshape(shape)
    codes = rng.randint(-140, 140, shape)
    x = np.where(kind == 0, rng.randn(*shape) * 40,           # random
        np.where(kind == 1, codes + 0.5,                       # .5 ties
        np.where(kind == 2, codes, rng.randn(*shape) * 400)))  # grid, clip
    return (x * step).astype(np.float32), s


# (data shape, scale shape): prefill write (L, S, Hkv, Dh) with (L, 1),
# decode append (B, Hkv, Dh) with (B, 1, 1), gather read (B, T, Hkv, Dh)
# with (B, 1, 1, 1), a non-multiple-of-4 row (the kernel's scalar path),
# and a one-layer prefill / one-slot append (a one-element scale)
POOL_LAYOUTS = [((3, 9, 2, 8), (3, 1)), ((4, 2, 8), (4, 1, 1)),
                ((2, 12, 2, 8), (2, 1, 1, 1)), ((5, 7, 3), (5,)),
                ((1, 9, 2, 8), (1, 1)), ((1, 2, 8), (1, 1, 1))]


@pytest.mark.parametrize("shape,sshape", POOL_LAYOUTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_scale_encode_codes_bit_identical(shape, sshape, dtype):
    x, s = _data(shape, sshape, seed=len(shape) + len(sshape))
    xj = jnp.asarray(x, dtype)
    ref = np.asarray(JN.encode(xj, SPEC_J, jnp.asarray(s)).codes)
    pal = np.asarray(JN.encode(xj, SPEC_J, jnp.asarray(s),
                               backend="pallas").codes)
    xt = _to_torch(np.asarray(xj))
    port_ref = TN.encode(xt, SPEC_T, torch.from_numpy(s)).codes
    port = TN.encode(xt, SPEC_T, torch.from_numpy(s), backend="cuda").codes
    assert port.dtype == torch.int8 and tuple(port.shape) == shape
    np.testing.assert_array_equal(ref, pal)
    np.testing.assert_array_equal(port.numpy(), ref)
    np.testing.assert_array_equal(port_ref.numpy(), ref)
    # the data really exercised ties and both clip ends
    assert ref.min() == -128 and ref.max() == 127


@pytest.mark.parametrize("shape,sshape", POOL_LAYOUTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_scale_decode_bit_identical(shape, sshape, dtype):
    rng = np.random.RandomState(11)
    q = rng.randint(-128, 128, shape).astype(np.int8)
    s = rng.randint(-8, 3, sshape).astype(np.float32)
    qt_j = JN.QTensor(jnp.asarray(q), jnp.asarray(s), SPEC_J)
    ref = np.asarray(JN.decode(qt_j, jnp.dtype(dtype)))
    pal = np.asarray(JN.decode(qt_j, jnp.dtype(dtype), backend="pallas"))
    tdt = getattr(torch, dtype)
    qt_t = TN.QTensor(torch.from_numpy(q), torch.from_numpy(s), SPEC_T)
    port = TN.decode(qt_t, tdt, backend="cuda")
    np.testing.assert_array_equal(_bits(ref), _bits(pal))
    np.testing.assert_array_equal(_bits(port), _bits(ref))
    np.testing.assert_array_equal(_bits(TN.decode(qt_t, tdt)), _bits(ref))


def test_half_to_even_ties_and_clip_ends_exact():
    """Hand-picked values: rint(±0.5, ±1.5, ±2.5) = (0, ±2, ±2) and the
    asymmetric two's-complement range qrange(8) = (-128, 127)."""
    assert TN.qrange(8) == JN.qrange(8) == (-128.0, 127.0)
    x = np.array([[0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 127.5, -128.5, 1e9, -1e9]],
                 np.float32) * np.array([[4.0], [0.125]], np.float32)
    s = np.array([2.0, -3.0], np.float32)
    ref = np.asarray(JN.encode(jnp.asarray(x), SPEC_J, jnp.asarray(s)).codes)
    port = TN.encode(torch.from_numpy(x), SPEC_T, torch.from_numpy(s),
                     backend="cuda").codes.numpy()
    np.testing.assert_array_equal(port, ref)
    for row in port:
        np.testing.assert_array_equal(row, [0, 0, 2, -2, 2, -2, 127, -128,
                                            127, -128])


def test_per_tensor_max_scale_matches_reference():
    rng = np.random.RandomState(3)
    x = (rng.randn(4, 10, 2, 8) * np.array([0.01, 1, 30, 900])[:, None,
                                                               None, None]
         ).astype(np.float32)
    valid = np.arange(10) < 7
    mask = valid.reshape(1, -1, 1, 1)
    ref = JN.per_tensor_max_scale_log2(jnp.asarray(x), SPEC_J,
                                       valid=jnp.asarray(mask),
                                       reduce_axes=(1, 2, 3))
    port = TN.per_tensor_max_scale_log2(torch.from_numpy(x), SPEC_T,
                                        valid=torch.from_numpy(mask),
                                        reduce_axes=(1, 2, 3))
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def test_rowwise_view_and_rejections():
    x = torch.zeros(3, 4, 5)
    x2d, srow = CB._rowwise(x, torch.tensor([1.0, 2.0, 3.0]).reshape(3, 1))
    assert tuple(x2d.shape) == (3, 20) and srow.tolist() == [1.0, 2.0, 3.0]
    x2d, srow = CB._rowwise(x, torch.ones(1, 4))    # broadcast leading dim
    assert tuple(x2d.shape) == (12, 5) and tuple(srow.shape) == (12,)
    assert CB._rowwise(x, torch.ones(3, 2)) is None
    # a one-element scale (scalar, one layer, one slot) is no row layout,
    # as in the reference: the scalar-scale kernels take it
    assert CB._rowwise(x, torch.ones(1, 1)) is None
    assert CB.Pow2Cuda._scalar(torch.ones(1, 1)) and \
        not CB.Pow2Cuda._scalar(torch.ones(3, 1))
    # the cuda codec takes leading-index scales only — no silent fallback
    with pytest.raises(NotImplementedError):
        TN.encode(x, SPEC_T, torch.ones(2, 4), backend="cuda")
    # int4x2: one scale per leading index packs along the trailing dim;
    # a scale that is not one per leading index still raises
    packed = TN.QuantSpec("pow2", 4, 0, "int4x2")
    qt = TN.encode(x, packed, torch.ones(3), backend="cuda")
    assert tuple(qt.codes.shape) == (3, 4, 3) and qt.codes.dtype == torch.int8
    with pytest.raises(NotImplementedError):
        TN.encode(x, packed, torch.ones(2, 4), backend="cuda")


def test_quant_spec_matches_reference_json():
    for kw in ({}, dict(kind="blockwise", block=64, scale_policy="managed"),
               dict(bits=4, storage_dtype="int4x2")):
        j, t = JN.QuantSpec(**kw), TN.QuantSpec(**kw)
        assert j.to_json_dict() == t.to_json_dict()
        assert TN.QuantSpec.from_json_dict(j.to_json_dict()) == t
        assert (t.qmin, t.qmax) == (j.qmin, j.qmax)
    assert TN.packed_trailing(7) == 4
    with pytest.raises(ValueError):
        TN.QuantSpec(kind="nope")


# ---------------------------------------------------------------------------
# The training slice: scalar fake-quant with the clipped STE, the quant
# edge, and the §3.3 scale manager
# ---------------------------------------------------------------------------

import jax  # noqa: E402

from repro.core import quant as JQ  # noqa: E402
from repro_torch.core import quant as TQ  # noqa: E402
from repro_torch.numerics import codecs as TC  # noqa: E402


def _fq_values(n, bits, seed):
    """Values on, between (exact .5 ties) and far outside a bits-bit grid
    of step 2^-3, in f32."""
    rng = np.random.RandomState(seed)
    hi = 2 ** (bits - 1)
    codes = rng.randint(-hi - 20, hi + 20, n).astype(np.float64)
    kind = rng.randint(0, 3, n)
    x = np.where(kind == 0, codes + 0.5,
                 np.where(kind == 1, codes, rng.randn(n) * hi))
    return (x * 2.0 ** -3).astype(np.float32)


@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fake_quant_bit_identical_to_pallas_with_ste(bits, dtype):
    """The kernel's plain version (the ``cuda`` codec on a CPU tensor), the
    port's reference codec and JAX's Pallas kernel (interpret mode): the
    same bits out, and the same clipped-STE gradient. Tolerance: none."""
    x = jnp.asarray(_fq_values(1000, bits, seed=bits), dtype)
    step = jnp.asarray(-3.0)
    spec_j, spec_t = JN.QuantSpec("pow2", bits), TN.QuantSpec("pow2", bits)
    ref = JN.fake_quant(x, spec_j, step, backend="pallas")
    gref = jax.grad(lambda v: jnp.sum(JN.fake_quant(
        v, spec_j, step, backend="pallas").astype(jnp.float32)))(x)
    for backend in ("cuda", "reference"):
        xt = _to_torch(np.asarray(x)).requires_grad_()
        y = TN.fake_quant(xt, spec_t, torch.tensor(-3.0), backend=backend)
        np.testing.assert_array_equal(_bits(y.detach()), _bits(ref))
        y.float().sum().backward()
        np.testing.assert_array_equal(_bits(xt.grad), _bits(gref))
    q = np.asarray(ref, np.float32) * 8
    assert q.min() == -2 ** (bits - 1) and q.max() >= 2 ** (bits - 1) - 1
    assert 0 < float(jnp.sum(gref == 0)) < x.size


def test_bf16_16bit_grid_clips_where_jax_clips():
    """JAX's weak-typed ``jnp.clip`` rounds the 16-bit hi bound 32767 to
    bf16's 32768; the port clips there too (f32 keeps 32767)."""
    x = np.array([40000.0, 32767.0, -40000.0], np.float32)
    spec_j, spec_t = JN.QuantSpec("pow2", 16), TN.QuantSpec("pow2", 16)
    for dtype, top in (("bfloat16", 32768.0), ("float32", 32767.0)):
        ref = JN.fake_quant(jnp.asarray(x, dtype), spec_j, jnp.asarray(0.0),
                            backend="pallas")
        got = TN.fake_quant(_to_torch(np.asarray(jnp.asarray(x, dtype))),
                            spec_t, torch.tensor(0.0), backend="cuda")
        np.testing.assert_array_equal(_bits(got), _bits(ref))
        assert float(got[0]) == top and float(got[2]) == -32768.0


def test_cuda_fake_quant_refuses_a_scale_per_leading_index():
    """A scale per leading index is the row fake-quant's (``p2_fq_rows``,
    its plain twin here): the same values as the reference codec. A scale
    outside the leading-dim convention is still refused — the Pallas
    backend falls back to the reference there, the port does not."""
    x = torch.arange(12.0).reshape(3, 4) - 5.5
    got = TN.fake_quant(x, TN.QuantSpec("pow2", 8), torch.tensor([-1.0, 0.0,
                                                                  1.0]),
                        backend="cuda")
    want = TN.fake_quant(x, TN.QuantSpec("pow2", 8), torch.tensor([-1.0, 0.0,
                                                                   1.0]))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    with pytest.raises(NotImplementedError, match="not one scale per leading"):
        TN.fake_quant(x, TN.QuantSpec("pow2", 8), torch.zeros(2),
                      backend="cuda")


def test_quantize_fused_and_roundtrip_match_reference():
    x = _fq_values(257, 8, seed=3)
    spec_j, spec_t = JN.QuantSpec("pow2", 8), TN.QuantSpec("pow2", 8)
    want = np.asarray(JN.roundtrip(jnp.asarray(x), spec_j, jnp.asarray(-3.0)))
    for backend in ("reference", "cuda"):
        got = TN.roundtrip(torch.from_numpy(x), spec_t, torch.tensor(-3.0),
                           backend=backend)
        np.testing.assert_array_equal(got.numpy(), want)
    from repro_torch.kernels import ops as TOPS
    np.testing.assert_array_equal(
        TOPS.quantize_fused(torch.from_numpy(x), -3.0, 8).numpy(),
        np.asarray(JN.fake_quant(jnp.asarray(x), spec_j, jnp.asarray(-3.0),
                                 backend="pallas")))


def _site_pair(act_log2, grad_log2):
    j = JQ.ActQuant(JN.ScaleState(jnp.asarray(act_log2, jnp.int32),
                                  jnp.asarray(0.2, jnp.float32)),
                    JN.ScaleState(jnp.asarray(grad_log2, jnp.int32),
                                  jnp.asarray(0.2, jnp.float32)),
                    jnp.zeros((), jnp.float32))
    t = TQ.ActQuant(TN.ScaleState(torch.tensor(act_log2, dtype=torch.int32),
                                  torch.tensor(0.2)),
                    TN.ScaleState(torch.tensor(grad_log2, dtype=torch.int32),
                                  torch.tensor(0.2)),
                    torch.zeros((), requires_grad=True))
    return j, t


def test_quant_edge_forward_bit_identical_backward_and_probe_1e6():
    """``quant_edge``: 8-bit forward bit-identical to JAX; the backward's
    16-bit gradient and the probe statistic mean|g|/2^k within 1e-6."""
    rng = np.random.RandomState(0)
    x = (rng.randn(64, 512) * 1.5).astype(np.float32)
    g = (rng.randn(64, 512) * 3e-3).astype(np.float32)
    js, ts = _site_pair(1, -6)

    def jf(xx, site):
        return jnp.sum(JQ.quant_edge(xx, site, 8, 16) * jnp.asarray(g))
    y_j = JQ.quant_edge(jnp.asarray(x), js, 8, 16)
    gx_j, gs_j = jax.grad(jf, argnums=(0, 1), allow_int=True)(
        jnp.asarray(x), js)
    xt = torch.from_numpy(x).requires_grad_()
    y_t = TQ.quant_edge(xt, ts, 8, 16)
    np.testing.assert_array_equal(y_t.detach().numpy(), np.asarray(y_j))
    (y_t * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(float(ts.probe.grad), float(gs_j.probe),
                               rtol=1e-6, atol=1e-6)
    # some values clipped (zero gradient), the rest passed quantized
    assert 0 < int((xt.grad == 0).sum()) < x.size


def test_scale_manager_matches_reference():
    """``update_scale`` / ``update_act_quant`` over a few steps: the same
    exponents and tracked means (1e-6) as JAX's."""
    rng = np.random.RandomState(1)
    js, ts = _site_pair(0, 0)
    for i in range(6):
        x = (rng.randn(32, 16) * 2.0 ** (i - 2)).astype(np.float32)
        stat = float(rng.rand() * 0.6)
        js = JQ.update_act_quant(js, jnp.asarray(x), jnp.asarray(stat),
                                 0.1, 0.3, 0.9)
        ts = TQ.update_act_quant(ts, torch.from_numpy(x), torch.tensor(stat),
                                 0.1, 0.3, 0.9)
        for a, b in ((js.act, ts.act), (js.grad, ts.grad)):
            assert int(a.log2) == int(b.log2)
            np.testing.assert_allclose(float(b.mean_abs), float(a.mean_abs),
                                       rtol=1e-6)
    assert float(TN.step_log2(ts.act, 8)) == float(JN.step_log2(js.act, 8))
