"""repro_torch's TTM algebra and PE contractions against repro (the JAX
reference).

On CPU tensors ``repro_torch.kernels.ops.pe1/pe2/pe3`` run the CUDA
kernels' plain versions, so these tests hold the plain versions — the
oracle the kernels meet on the card (tests/test_torch_cuda.py) — to the
JAX Pallas kernels in interpret mode, at JAX's own test shapes and at
every shape the FMNIST training step gives them. Tolerances are JAX's
(``tests/test_kernels.py::_tol``): f32 1e-4, bf16 2e-2 relative and
absolute — the two sides sum in different orders. The PE1 epilogue is
held bit for bit to the port's own encode -> decode. The TT autograd
Function's backward (PE3 + Appendix A.2 contractions + transposed chain)
is held to ``jax.grad`` at 1e-3 (``tests/test_ttm.py``'s tolerance) and
checked with ``torch.autograd.gradcheck`` in float64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import ttm as JT  # noqa: E402
from repro.kernels import ops as JOPS  # noqa: E402
from repro.models import mlp_tt as JM  # noqa: E402
from repro_torch import numerics as TN  # noqa: E402
from repro_torch.core import ttm as TT  # noqa: E402
from repro_torch.kernels import ops as TOPS  # noqa: E402

PE1_SHAPES = [(37, 5, 48), (128, 1, 16), (8, 7, 130), (256, 16, 256),
              (1, 3, 16)]
PE2_SHAPES = [(19, 7, 33, 21), (8, 1, 128, 16), (64, 16, 256, 8),
              (1, 4, 16, 130)]
PE3_SHAPES = [(130, 47, 65), (64, 128, 128), (8, 1, 300), (256, 16, 16)]
DTYPES = ["float32", "bfloat16"]
BATCH = 64


def _tol(dt):
    return dict(rtol=2e-2, atol=2e-2) if dt == "bfloat16" \
        else dict(rtol=1e-4, atol=1e-4)


def _pair(a: np.ndarray, dt: str):
    """The same values (same bits in bf16) as a jax array and a tensor."""
    j = jnp.asarray(a, dtype=dt)
    n = np.asarray(j)
    if dt == "bfloat16":
        t = torch.from_numpy(n.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(n.copy())
    return j, t


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _step_shapes():
    """Every (pe, z shape, g shape) the FMNIST step runs: the forward chain
    of both layers and their transposed (dx) chains, batch 64."""
    d = JM.make_mlp()
    seen = []

    def rec(kind):
        def f(z, g):
            seen.append((kind, tuple(z.shape), tuple(g.shape)))
            out = (TT.pe1_contract if kind == "pe1" else TT.pe2_contract)(z, g)
            return out
        return f
    for js in (d.spec1, d.spec2):
        spec = TT.TTMSpec(js.j_dims, js.i_dims, js.ranks)
        for sp in (spec, spec.transposed()):
            cores = [torch.zeros(s) for s in sp.core_shapes]
            TT.ttm_matvec_pe(cores, torch.zeros(BATCH, sp.in_dim), sp,
                             pe1=rec("pe1"), pe2=rec("pe2"))
    return seen


STEP = _step_shapes()
STEP_PE1 = [(z, g) for k, z, g in STEP if k == "pe1"]
STEP_PE2 = [(z, g) for k, z, g in STEP if k == "pe2"]
# PE3 on the step: (Ybar (B, J), X (B, I)) per layer
STEP_PE3 = [(BATCH, 512, 896), (BATCH, 16, 512)]


def test_step_shapes_are_the_counted_ones():
    """The chain shapes this file tests are the ones the launch count of
    the step is worked out from: 2 PE1 + 4 PE2 per forward of the MLP,
    the same again for its two dx chains."""
    assert len(STEP_PE1) == 4 and len(STEP_PE2) == 8
    assert STEP_PE1[0] == ((3584, 1, 16), (1, 256, 16))
    assert ((1792, 32, 16), (32, 32)) in STEP_PE2
    assert ((64, 512, 16), (512, 1)) in STEP_PE2


def test_pe_shapes_traces_the_chain_on_meta_tensors():
    """``pe_shapes`` (what ``chip_smoke.py`` checks the kernels at) lists
    the same calls, in order, as a chain run on real tensors."""
    d = JM.make_mlp()
    got = []
    for js in (d.spec1, d.spec2):
        spec = TT.TTMSpec(js.j_dims, js.i_dims, js.ranks)
        for sp in (spec, spec.transposed()):
            got += TT.pe_shapes(sp, BATCH)
    assert got == STEP


@pytest.mark.parametrize("shape", PE1_SHAPES)
@pytest.mark.parametrize("dt", DTYPES)
def test_pe1_plain_matches_pallas(shape, dt):
    a, b, c = shape
    d = max(8, a // 2)
    rng = np.random.RandomState(a + b)
    zj, zt = _pair(rng.randn(a, b, c), dt)
    gj, gt = _pair(rng.randn(b, d, c), dt)
    out = TOPS.pe1(zt, gt)
    assert out.dtype == zt.dtype and tuple(out.shape) == (a, d)
    np.testing.assert_allclose(_f32(out), _f32(JOPS.pe1(zj, gj)), **_tol(dt))


@pytest.mark.parametrize("shape", PE2_SHAPES)
@pytest.mark.parametrize("dt", DTYPES)
def test_pe2_plain_matches_pallas(shape, dt):
    a, b, c, d = shape
    rng = np.random.RandomState(a + c)
    zj, zt = _pair(rng.randn(a, b, c), dt)
    gj, gt = _pair(rng.randn(b, d), dt)
    out = TOPS.pe2(zt, gt)
    assert out.dtype == zt.dtype and tuple(out.shape) == (a, d, c)
    np.testing.assert_allclose(_f32(out), _f32(JOPS.pe2(zj, gj)), **_tol(dt))


@pytest.mark.parametrize("shape", PE3_SHAPES)
@pytest.mark.parametrize("dt", DTYPES)
def test_pe3_plain_matches_pallas(shape, dt):
    b, j, i = shape
    rng = np.random.RandomState(b + i)
    yj, yt = _pair(rng.randn(b, j), dt)
    xj, xt = _pair(rng.randn(b, i), dt)
    out = TOPS.pe3(yt, xt)
    assert out.dtype == yt.dtype and tuple(out.shape) == (j, i)
    np.testing.assert_allclose(_f32(out), _f32(JOPS.pe3(yj, xj)), **_tol(dt))


@pytest.mark.parametrize("zs,gs", STEP_PE1)
@pytest.mark.parametrize("dt", DTYPES)
def test_pe1_plain_matches_pallas_at_step_shapes(zs, gs, dt):
    rng = np.random.RandomState(zs[0])
    zj, zt = _pair(rng.randn(*zs), dt)
    gj, gt = _pair(rng.randn(*gs) * 0.2, dt)
    np.testing.assert_allclose(_f32(TOPS.pe1(zt, gt)),
                               _f32(JOPS.pe1(zj, gj)), **_tol(dt))


@pytest.mark.parametrize("zs,gs", STEP_PE2)
@pytest.mark.parametrize("dt", DTYPES)
def test_pe2_plain_matches_pallas_at_step_shapes(zs, gs, dt):
    rng = np.random.RandomState(zs[0] + zs[1])
    zj, zt = _pair(rng.randn(*zs), dt)
    gj, gt = _pair(rng.randn(*gs) * 0.2, dt)
    np.testing.assert_allclose(_f32(TOPS.pe2(zt, gt)),
                               _f32(JOPS.pe2(zj, gj)), **_tol(dt))


@pytest.mark.parametrize("b,j,i", STEP_PE3)
@pytest.mark.parametrize("dt", DTYPES)
def test_pe3_plain_matches_pallas_at_step_shapes(b, j, i, dt):
    rng = np.random.RandomState(j)
    yj, yt = _pair(rng.randn(b, j) * 0.1, dt)
    xj, xt = _pair(rng.randn(b, i), dt)
    np.testing.assert_allclose(_f32(TOPS.pe3(yt, xt)),
                               _f32(JOPS.pe3(yj, xj)), **_tol(dt))


# (37, 5, 48) and (8, 7, 130) contract over a split (b, c) index; (256,
# 16, 256) over 4096 terms; plus the step's first PE1
PE1_EPILOGUE_SHAPES = [(37, 5, 48), (128, 1, 16), (256, 16, 256),
                       (8, 7, 130), (3584, 1, 16)]


@pytest.mark.parametrize("shape", PE1_EPILOGUE_SHAPES)
@pytest.mark.parametrize("bits", [4, 8])
def test_pe1_epilogue_bit_identical_to_encode_decode(shape, bits):
    """Exactly: the fused requant equals the unfused output through the
    port's own codec (encode -> decode, the ``cuda`` backend's plain
    versions here)."""
    a, b, c = shape
    d = 256 if a == 3584 else max(8, a // 2)
    rng = np.random.RandomState(bits)
    z = torch.from_numpy(rng.randn(a, b, c).astype(np.float32))
    g = torch.from_numpy(rng.randn(b, d, c).astype(np.float32))
    acc = TOPS.pe1(z, g)
    # a step whose grid ends at half the smaller tail: both ends clip
    hi = 2 ** (bits - 1) - 1
    tail = float(min(acc.max(), -acc.min()))
    step = torch.tensor(float(np.floor(np.log2(0.5 * tail / hi))))
    fused = TOPS.pe1(z, g, step_log2=step, bits=bits)
    spec = TN.QuantSpec("pow2", bits)
    unfused = TN.decode(TN.encode(acc, spec, step, backend="cuda"),
                        torch.float32, backend="cuda")
    assert torch.equal(fused, unfused)
    # the grid really clipped and really rounded
    q = unfused / 2.0 ** float(step)
    assert q.max() == hi and q.min() == -hi - 1
    assert not torch.equal(unfused, acc)


def test_pe1_epilogue_matches_jax_reference_oracle():
    """The port's requant epilogue on the plain accumulator equals JAX's
    ``ref.pe1_quant_ref`` on the same f32 inputs, up to accumulations
    that land within roundoff of a rounding boundary (none here)."""
    from repro.kernels import ref
    rng = np.random.RandomState(5)
    z = rng.randn(37, 5, 48).astype(np.float32)
    g = rng.randn(5, 16, 48).astype(np.float32)
    out = TOPS.pe1(torch.from_numpy(z), torch.from_numpy(g), step_log2=-4.0,
                   bits=8).numpy()
    want = np.asarray(ref.pe1_quant_ref(jnp.asarray(z), jnp.asarray(g),
                                        jnp.asarray(-4.0), 8))
    np.testing.assert_array_equal(out, want)


def test_impl_torch_refuses_nothing_on_cpu_and_names_bad_impl():
    z = torch.randn(4, 2, 3)
    g = torch.randn(2, 5, 3)
    assert torch.equal(TOPS.pe1(z, g, impl="torch"), TOPS.pe1(z, g))
    with pytest.raises(ValueError):
        TOPS.pe2(z, torch.randn(2, 5), impl="pallas")
    with pytest.raises(ValueError):               # G's b does not match
        TOPS.pe1(z, torch.randn(3, 5, 3))
    # the kernel entry points take card tensors only: no CPU fallback
    from repro_torch.kernels import ttm_pe1, ttm_pe2, ttm_pe3
    for fn, args in ((ttm_pe1.pe1_cuda, (z, g)),
                     (ttm_pe2.pe2_cuda, (z, torch.randn(2, 5))),
                     (ttm_pe3.pe3_cuda, (torch.randn(4, 2),
                                         torch.randn(4, 3)))):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args)


# ---------------------------------------------------------------------------
# TTM algebra
# ---------------------------------------------------------------------------

CASES = [
    (512, 896, 4, 16),     # paper layer 1
    (16, 512, 2, 16),      # paper layer 2
    (120, 84, 3, 8),
    (64, 64, 2, 4),
    (7, 5, 1, 4),          # d=1 degenerates to dense
]


def _spec_pair(j, i, d, r):
    js = JT.make_spec(j, i, d, r)
    ts = TT.make_spec(j, i, d, r)
    assert (ts.j_dims, ts.i_dims, ts.ranks) == (js.j_dims, js.i_dims,
                                                js.ranks)
    return js, ts


def _cores(spec, seed, scale=None):
    rng = np.random.RandomState(seed)
    sigma = scale or TT.core_sigma(spec)
    return [(rng.randn(*s) * sigma).astype(np.float32)
            for s in spec.core_shapes]


@pytest.mark.parametrize("j,i,d,r", CASES)
def test_spec_helpers_match_reference(j, i, d, r):
    js, ts = _spec_pair(j, i, d, r)
    assert ts.core_shapes == js.core_shapes
    assert ts.num_params == js.num_params
    assert TT.ttm_flops_matvec(ts, 64) == JT.ttm_flops_matvec(js, 64)
    assert TT.auto_factorize(7168, 20480, 3) == JT.auto_factorize(7168,
                                                                  20480, 3)


@pytest.mark.parametrize("j,i,d,r", CASES)
def test_matvec_pe_and_dense_match_reference(j, i, d, r):
    """ttm_matvec, ttm_matvec_pe (plain PE kernels) and ttm_to_dense vs
    JAX's ttm_matvec / ttm_to_dense, 1e-4."""
    js, ts = _spec_pair(j, i, d, r)
    cores = _cores(ts, seed=j)
    x = np.random.RandomState(1).randn(6, i).astype(np.float32)
    want = np.asarray(JT.ttm_matvec([jnp.asarray(c) for c in cores],
                                    jnp.asarray(x), js))
    tc = [torch.from_numpy(c) for c in cores]
    tx = torch.from_numpy(x)
    for got in (TT.ttm_matvec(tc, tx, ts),
                TOPS.ttm_matvec_kernels(tc, tx, ts),
                TT.ttm_matvec_pe(tc, tx, ts)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        TT.ttm_to_dense(tc, ts).numpy(),
        np.asarray(JT.ttm_to_dense([jnp.asarray(c) for c in cores], js)),
        rtol=1e-5, atol=1e-6)


def test_transposed_spec_is_w_transpose():
    ts = TT.make_spec(120, 84, 3, 8)
    tc = [torch.from_numpy(c) for c in _cores(ts, seed=3)]
    w = TT.ttm_to_dense(tc, ts)
    wt = TT.ttm_to_dense([c.permute(0, 2, 1, 3) for c in tc], ts.transposed())
    np.testing.assert_allclose(wt.numpy(), w.t().numpy(), rtol=1e-6,
                               atol=1e-7)


def test_core_grads_from_what_matches_reference():
    js, ts = _spec_pair(24, 30, 3, 6)
    cores = _cores(ts, seed=0)
    what = np.random.RandomState(2).randn(24, 30).astype(np.float32)
    want = JT.core_grads_from_what(jnp.asarray(what),
                                   [jnp.asarray(c) for c in cores], js)
    got = TT.core_grads_from_what(torch.from_numpy(what),
                                  [torch.from_numpy(c) for c in cores], ts)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("layer", ["l1", "l2"])
def test_tt_function_backward_matches_jax_grad_at_fmnist_specs(layer):
    """TTMatvec's backward (PE3 -> Ŵ -> A.2 core contractions, transposed
    chain for dx) vs jax.grad through JAX's einsum chain, at the paper's
    layer specs and batch 64: 1e-3."""
    d = JM.make_mlp()
    js = d.spec1 if layer == "l1" else d.spec2
    ts = TT.TTMSpec(js.j_dims, js.i_dims, js.ranks)
    cores = _cores(ts, seed=7)
    rng = np.random.RandomState(8)
    x = rng.randn(BATCH, ts.in_dim).astype(np.float32)
    ybar = rng.randn(BATCH, ts.out_dim).astype(np.float32)

    def loss(cs, xx):
        return jnp.sum(JT.ttm_matvec(cs, xx, js) * jnp.asarray(ybar))
    gc, gx = jax.grad(loss, argnums=(0, 1))([jnp.asarray(c) for c in cores],
                                           jnp.asarray(x))
    tc = [torch.from_numpy(c).requires_grad_() for c in cores]
    tx = torch.from_numpy(x).requires_grad_()
    y = TT.tt_matvec(tc, tx, ts)
    np.testing.assert_allclose(
        y.detach().numpy(),
        np.asarray(JT.ttm_matvec([jnp.asarray(c) for c in cores],
                                 jnp.asarray(x), js)), rtol=1e-4, atol=1e-4)
    (y * torch.from_numpy(ybar)).sum().backward()
    for t, w in zip(tc, gc):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-3,
                                   atol=1e-3)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-3,
                               atol=1e-3)


def test_tt_function_gradcheck_float64():
    """torch.autograd.gradcheck (finite differences, float64) on a small
    spec: every core gradient and the input gradient."""
    ts = TT.make_spec(6, 12, 3, 3)
    rng = np.random.RandomState(0)
    cores = [torch.from_numpy(rng.randn(*s)).requires_grad_()
             for s in ts.core_shapes]
    x = torch.from_numpy(rng.randn(4, ts.in_dim)).requires_grad_()

    def f(xx, *cs):
        return TT.tt_matvec(list(cs), xx, ts)
    assert torch.autograd.gradcheck(f, (x, *cores), eps=1e-6, atol=1e-7)


def test_tt_function_skips_dx_when_input_takes_no_gradient(monkeypatch):
    """The dx chain runs only when the input needs a gradient (the launch
    count of the training step relies on it)."""
    ts = TT.make_spec(16, 24, 2, 4)
    cores = [torch.randn(s, requires_grad=True) for s in ts.core_shapes]
    seen = []
    orig = TOPS.pe1

    def spy(*a, **k):
        seen.append(tuple(a[0].shape))
        return orig(*a, **k)
    monkeypatch.setattr(TOPS, "pe1", spy)
    TT.tt_matvec(cores, torch.randn(3, 24), ts).sum().backward()
    assert len(seen) == 1 and all(c.grad is not None for c in cores)
    TT.tt_matvec(cores, torch.randn(3, 24, requires_grad=True), ts
                 ).sum().backward()
    assert len(seen) == 3
