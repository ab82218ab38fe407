"""Codes in every storage type a QuantSpec names (int8, int16, int32,
float32) against repro.numerics (the JAX reference).

The port's CUDA codec kernels are templated over the code type; on CPU
tensors its ``cuda`` codec runs their plain versions, so these tests hold
the plain versions — the oracle the kernels meet on the card
(``tests/test_torch_cuda.py``) — to JAX's ``reference`` and ``pallas``
(interpret mode) backends, bit for bit in codes, their dtype and the
decoded values:

(a) the twin of ``test_numerics.py::test_pow2_backends_bit_identical``
    over its shapes at 4/8/16 bits, int8 and int16 storage, one scale (the
    scalar kernels) and one scale per leading index (the row kernels);
(b) int32 and float32 storage, up to a 32-bit grid whose top (2^31 - 1)
    rounds to 2^31 in f32 and saturates to INT32_MAX, and a grid wider
    than its storage (16 bits in int8) saturating at the type's ends, as
    JAX's float-to-int conversion does;
(c) the blockwise codec with int16 (and int32, float32) storage;
(d) the bf16 16-bit top code: a bf16 tensor at 16 bits in int16 stores
    32767 (the encode clips in f32), where a plain cast of 32768 wraps;
(e) the bit range follows the storage type.

Data are made with numpy from a seed. Exponents avoid the points where
XLA's CPU ``exp2`` is an ulp off (ROADMAP queue 3).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import numerics as JN  # noqa: E402
from repro_torch import numerics as TN  # noqa: E402
from repro_torch.numerics import cuda_backend as CB  # noqa: E402

POW2_SHAPES = [(7,), (37, 130), (3, 5, 33)]
STORE = {"int8": np.int8, "int16": np.int16, "int32": np.int32,
         "float32": np.float32}


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    monkeypatch.setenv("JAX_PALLAS_INTERPRET", "1")


def _to_torch(a) -> "torch.Tensor":
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return (a.view(torch.int16) if a.element_size() == 2 else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a


def _values(shape, bits, seed, s=-3.0):
    """Values on, between (exact .5 ties) and outside a ``bits``-bit grid
    of step 2^s, with normal noise, in f32."""
    rng = np.random.RandomState(seed)
    hi = 2.0 ** (bits - 1)
    n = int(np.prod(shape))
    codes = np.floor(rng.uniform(-hi * 1.1, hi * 1.1, n))
    kind = rng.randint(0, 4, n)
    x = np.where(kind == 0, codes + 0.5,
                 np.where(kind == 1, codes,
                          np.where(kind == 2, rng.randn(n) * 5 * 2.0 ** -s,
                                   rng.randn(n) * hi)))
    return (x * 2.0 ** s).astype(np.float32).reshape(shape)


def _check_pow2(x, bits, storage, scale):
    """JAX reference and Pallas, the port's reference, its cuda codec (the
    kernels' twins here) and the twin wrappers: the same codes (and dtype)
    and the same decoded values. Returns the codes."""
    spec_j = JN.QuantSpec("pow2", bits, 0, storage, "fixed")
    spec_t = TN.QuantSpec("pow2", bits, 0, storage, "fixed")
    sj, st = jnp.asarray(scale), torch.from_numpy(np.asarray(scale))
    ref = JN.encode(x, spec_j, sj)
    pal = JN.encode(x, spec_j, sj, backend="pallas")
    want = np.asarray(ref.codes)
    assert want.dtype == STORE[storage]
    np.testing.assert_array_equal(np.asarray(pal.codes), want)
    dec = np.asarray(JN.decode(ref))
    np.testing.assert_array_equal(np.asarray(JN.decode(pal, backend="pallas")),
                                  dec)
    xt = _to_torch(np.asarray(x))
    for backend in ("reference", "cuda"):
        qt = TN.encode(xt, spec_t, st, backend=backend)
        assert qt.codes.dtype == spec_t.torch_storage
        np.testing.assert_array_equal(qt.codes.numpy(), want)
        np.testing.assert_array_equal(
            TN.decode(qt, backend=backend).numpy(), dec)
    return want


# ---------------------------------------------------------------------------
# (a) the twin of test_pow2_backends_bit_identical, int8 and int16 storage
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", POW2_SHAPES)
@pytest.mark.parametrize("bits,storage", [(4, "int8"), (8, "int8"),
                                          (4, "int16"), (8, "int16"),
                                          (16, "int16")])
def test_pow2_storage_bit_identical_to_jax(shape, bits, storage):
    x = jnp.asarray(_values(shape, bits, seed=bits + len(shape)))
    codes = _check_pow2(x, bits, storage, np.float32(-3.0))
    if codes.size > 100:                      # both clip ends reached
        assert codes.min() == -2 ** (bits - 1)
        assert codes.max() == 2 ** (bits - 1) - 1


@pytest.mark.parametrize("shape,sshape", [((3, 5, 33), (3, 1)),
                                          ((4, 2, 8), (4, 1, 1)),
                                          ((3, 5, 2, 8, 4), (3, 5))])
@pytest.mark.parametrize("storage", ["int16", "int32", "float32"])
def test_pow2_row_scales_wider_storage(shape, sshape, storage):
    """One scale per leading index: the row kernels' twins."""
    rng = np.random.RandomState(len(shape))
    s = rng.randint(-6, 3, sshape).astype(np.float32)
    x = jnp.asarray(_values(shape, 16, seed=7, s=0.0)
                    * np.exp2(s).reshape(sshape + (1,) * (len(shape)
                                                          - len(sshape))))
    _check_pow2(x, 16, storage, s)


# ---------------------------------------------------------------------------
# (b) int32 and float32 storage; saturation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits,storage", [(16, "int32"), (24, "int32"),
                                          (32, "int32"), (12, "float32"),
                                          (32, "float32")])
def test_pow2_int32_and_float32_storage(bits, storage):
    x = _values((37, 130), min(bits, 20), seed=bits)
    top = np.float32(2.0 ** (bits - 1)) * 8     # past the grid at step 2^-3
    x.reshape(-1)[:4] = [top, -top, 3e9, -3e9]
    codes = _check_pow2(jnp.asarray(x), bits, storage, np.float32(-3.0))
    if storage == "int32" and bits == 32:
        # clip's top, 2^31 - 1 in f32, is 2^31: it saturates to INT32_MAX
        assert codes.reshape(-1)[0] == 2 ** 31 - 1
        assert codes.reshape(-1)[1] == -2 ** 31


@pytest.mark.parametrize("storage", ["int8", "int16"])
def test_grid_wider_than_storage_saturates(storage):
    x = _values((3, 5, 33), 16, seed=3)
    codes = _check_pow2(jnp.asarray(x), 16 if storage == "int8" else 32,
                        storage, np.float32(-3.0))
    info = np.iinfo(STORE[storage])
    assert codes.min() == info.min and codes.max() == info.max


def test_to_storage_saturates_where_a_cast_wraps():
    q = torch.tensor([2.0 ** 31, -2.0 ** 31, 32768.0, -40000.0, 5.0])
    assert TN.to_storage(q, torch.int32).tolist() == [2 ** 31 - 1, -2 ** 31,
                                                      32768, -40000, 5]
    assert TN.to_storage(q, torch.int16).tolist() == [32767, -32768, 32767,
                                                      -32768, 5]
    assert TN.to_storage(q, torch.int8).tolist() == [127, -128, 127, -128, 5]
    assert TN.to_storage(q, torch.float32).tolist() == q.tolist()


# ---------------------------------------------------------------------------
# (c) blockwise with wider storage
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,block", [((1000,), 256), ((5, 777), 256),
                                         ((2, 3, 50), 16), ((4096,), 1024)])
@pytest.mark.parametrize("bits,storage", [(16, "int16"), (12, "int16"),
                                          (24, "int32"), (16, "float32")])
def test_blockwise_storage_bit_identical_to_jax(shape, block, bits,
                                                storage):
    """Port reference and cuda codecs == JAX reference bit for bit (codes,
    their dtype, scales, values). Pallas divides by qmax as a multiply by
    its reciprocal (ROADMAP queue 3): its scales are within one ulp, and
    its codes within one of the reference's."""
    rng = np.random.RandomState(block + bits)
    x = (rng.standard_normal(shape) * 9).astype(np.float32)
    x[..., :min(block, shape[-1]) // 2] *= 1e-3        # small-scale blocks
    jspec = JN.QuantSpec("blockwise", bits, block, storage, "per_tensor_max")
    tspec = TN.QuantSpec("blockwise", bits, block, storage, "per_tensor_max")
    jq = JN.encode(jnp.asarray(x), jspec)
    want = np.asarray(jq.codes)
    assert want.dtype == STORE[storage]
    jd = np.asarray(JN.decode(jq))
    for backend in ("reference", "cuda"):
        tq = TN.encode(torch.from_numpy(x), tspec, backend=backend)
        assert tq.codes.dtype == tspec.torch_storage
        assert tq.nbytes() == jq.nbytes()
        np.testing.assert_array_equal(tq.codes.numpy(), want)
        np.testing.assert_array_equal(tq.scale.numpy().view(np.int32),
                                      np.asarray(jq.scale).view(np.int32))
        np.testing.assert_array_equal(
            TN.decode(tq, backend=backend).numpy().view(np.int32),
            jd.view(np.int32))
    pq = JN.encode(jnp.asarray(x), jspec, backend="pallas")
    assert np.asarray(pq.codes).dtype == want.dtype
    assert np.abs(np.asarray(pq.codes).astype(np.int64)
                  - want.astype(np.int64)).max() <= 1
    ulps = np.abs(np.asarray(pq.scale).view(np.int32).astype(np.int64)
                  - np.asarray(jq.scale).view(np.int32))
    assert ulps.max() <= 1
    qmax = 2 ** (bits - 1) - 1
    assert np.abs(want).max() == qmax


# ---------------------------------------------------------------------------
# (d) the bf16 16-bit top code
# ---------------------------------------------------------------------------

def test_bf16_16bit_int16_top_code_is_32767():
    """A bf16 tensor at 16 bits in int16, scale 2^0: the encode clips in
    f32, so 40000 (39936 in bf16) stores 32767 in both JAX backends and
    in the port, and decodes to 32767 (32768 in bf16). torch's cast of
    bf16 32768 to int16 would give -32768: the codes never take it."""
    x = jnp.asarray(np.array([40000.0, 32767.0, -40000.0, 1e10, -1e10, 3.0],
                             np.float32), jnp.bfloat16)
    codes = _check_pow2(x, 16, "int16", np.float32(0.0))
    assert codes.tolist() == [32767, 32767, -32768, 32767, -32768, 3]
    assert torch.tensor([32768.0], dtype=torch.bfloat16).to(
        torch.int16).item() == -32768
    spec = TN.QuantSpec("pow2", 16, 0, "int16")
    xt = _to_torch(np.asarray(x))
    y = TN.decode(TN.encode(xt, spec, torch.tensor(0.0), backend="cuda"),
                  torch.bfloat16, backend="cuda")
    want = JN.decode(JN.encode(x, JN.QuantSpec("pow2", 16, 0, "int16"),
                               jnp.asarray(0.0)), jnp.bfloat16)
    np.testing.assert_array_equal(_bits(y), _bits(want))


# ---------------------------------------------------------------------------
# (e) the bit range follows the storage type
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("storage,most", [(torch.int8, 8), (torch.int16, 16),
                                          (torch.int32, 32),
                                          (torch.float32, 32)])
def test_kernel_bit_range_follows_storage(storage, most):
    assert CB._check_storage("enc", most, storage) == CB._CODE[storage]
    assert CB._check_storage("enc", 2, storage) == CB._CODE[storage]
    for bad in (1, most + 1):
        with pytest.raises(ValueError, match=f"holds 2..{most} bits"):
            CB._check_storage("enc", bad, storage)
    with pytest.raises(TypeError):
        CB._check_storage("enc", 8, torch.float16)
