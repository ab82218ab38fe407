"""repro_torch's full Table-1 wire against repro (the JAX reference): the
blockwise and int4x2 packed codecs, ``NumericsPolicy``, int8 Adam moments,
the int8 gradient wire with error feedback, and one low-precision step of
``benchmarks/train_wire.py::fmnist_low_precision_step`` with its per-site
byte table.

Inputs are made with numpy and handed to both packages. On CPU tensors the
port's ``cuda`` codecs run their kernels' plain versions, so the codec
tests hold those plain versions — the oracle the CUDA kernels meet on the
card — to JAX's reference codecs and to its Pallas kernels in interpret
mode. Tolerances, each with its reason:

- codecs, ``pack_int4``/``unpack_int4``, the policy JSON and the byte
  accounting: exact (bit for bit, byte for byte) against the reference
  codecs and the Pallas packed kernels; against the Pallas blockwise
  kernel the codes exact and the scales within one f32 ulp (XLA turns the
  kernel's division by the constant qmax into a reciprocal multiply; the
  reference and the port divide), the decoded values within two;
- one int8 Adam update from one state and given gradients: the moments'
  codes and scales exact; the parameters within 2e-7 relative + 1e-8
  (XLA evaluates the update's f32 chain in another order);
- ``compress_decompress`` from one state: exact, over two calls (the
  second carries the residual);
- one full wire step with every edge's gradient exponent at -10, where
  XLA's exp2 is exact: the loss within 1e-6 relative; every compressed
  gradient, residual and decoded moment element within one quantization
  step of its block + 1e-5 of the leaf's largest |g| (a value within
  roundoff of a rounding boundary may land on the neighbouring code), and
  at least 99.5% of the compressed gradient elements within 1e-5 of the
  leaf's largest |g|;
- the same step from ``fmnist_low_precision_step``'s own init (gradient
  exponents 0, so the 16-bit gradient grid is 2^-15, where XLA's CPU exp2
  is an ulp off and JAX breaks exact ties differently — ROADMAP queue 3):
  the loss within 1e-6 relative, the compressed gradients and residuals
  within two wire steps of the leaf, the parameters within 2 lr (Adam's
  first step moves an element by at most lr), integer leaves equal, and
  the byte table exactly JAX's.
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import numerics as JN  # noqa: E402
from repro.configs.base import QuantConfig as JQuantConfig  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.models import mlp_tt as JM  # noqa: E402
from repro.numerics import ScaleState as JScaleState  # noqa: E402
from repro.numerics import codecs as JC  # noqa: E402
from repro.optim import adam as JA  # noqa: E402
from repro.optim import grad_compress as JG  # noqa: E402
from repro_torch import numerics as TN  # noqa: E402
from repro_torch.configs.base import QuantConfig  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.convert import (adam_state_from_jax,  # noqa: E402
                                 mlp_params_from_jax, residual_from_jax)
from repro_torch.launch import train_fmnist as TF  # noqa: E402
from repro_torch.launch import train_wire as TW  # noqa: E402
from repro_torch.numerics import cuda_backend as CB  # noqa: E402
from repro_torch.optim import adam as TA  # noqa: E402
from repro_torch.optim import grad_compress as TG  # noqa: E402
from repro_torch.tree import flatten_with_path, leaves, unflatten  # noqa: E402

_BENCH = (pathlib.Path(__file__).resolve().parent.parent / "benchmarks"
          / "train_wire.py")
_spec = importlib.util.spec_from_file_location("train_wire_bench", _BENCH)
JTW = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(JTW)

LR = 3e-3
MOMENT_SHAPES = [(512,), (1, 4, 7, 16), (16, 4, 4, 16), (16, 2, 2, 16),
                 (16, 16, 16, 1), (16,), (1, 1, 32, 16), ()]
# every floating gradient leaf of the step, flattened (the wire's view)
WIRE_LENGTHS = [512, 448, 4096, 1024, 16, 1]


def _t(a) -> "torch.Tensor":
    return torch.from_numpy(np.array(a))


def _data(shape, rng, scale=1.0, zero_block=None):
    x = np.asarray(rng.standard_normal(shape) * scale, np.float32)
    if zero_block is not None:
        x[..., :zero_block] = 0.0          # an all-zero first block
    if x.size >= 4 and shape[-1] >= 4:
        # the block holding the last four elements gets scale 2^-5 exactly
        # (max 127 * 2^-5), so the others divide to exact .5 ties
        x.reshape(-1)[-4:] = np.asarray([127, 2.5, -3.5, 0.5]) * 2.0 ** -5
    return x


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 8), (2, 5, 7), (1,), (4, 3)])
def test_pack_int4_matches_jax(shape):
    rng = np.random.RandomState(sum(shape))
    q = rng.randint(-8, 8, shape).astype(np.int32)
    jp = np.asarray(JC.pack_int4(jnp.asarray(q)))
    tp = TN.pack_int4(_t(q))
    np.testing.assert_array_equal(tp.numpy(), jp)
    assert tp.dtype == torch.int8 and tp.shape[-1] == TN.packed_trailing(
        shape[-1])
    np.testing.assert_array_equal(TN.unpack_int4(tp, shape[-1]).numpy(), q)
    np.testing.assert_array_equal(
        TN.unpack_int4(tp, shape[-1]).numpy(),
        np.asarray(JC.unpack_int4(jnp.asarray(jp), shape[-1])))


def _bw_cases():
    cases = [(s, 256) for s in MOMENT_SHAPES]
    cases += [((n,), 1024) for n in WIRE_LENGTHS + [14272, 1030]]
    cases += [((3, 1000), 256), ((2, 300), 1), ((5, 33), 16)]
    return cases


@pytest.mark.parametrize("shape,block", _bw_cases())
def test_blockwise_codec_bit_identical_to_jax(shape, block, monkeypatch):
    """Port reference and cuda (plain on CPU) codecs == JAX reference ==
    Pallas (interpret): codes, scales and decoded values bit for bit, at
    the step's moment shapes and wire lengths, padded multi-block shapes,
    b = 1, an all-zero block and exact ties."""
    monkeypatch.setenv("JAX_PALLAS_INTERPRET", "1")
    rng = np.random.RandomState(block + len(shape))
    zb = min(block, shape[-1]) if shape and shape[-1] > block else None
    x = _data(shape, rng, scale=0.05, zero_block=zb)
    jspec = JN.QuantSpec("blockwise", 8, block, "int8", "per_tensor_max")
    tspec = TN.QuantSpec("blockwise", 8, block, "int8", "per_tensor_max")
    b, nb, pad = TN.blockwise_geometry(tspec, shape[-1] if shape else 1)
    assert (b, nb, pad) == JC.blockwise_geometry(jspec,
                                                 shape[-1] if shape else 1)
    jq = JN.encode(jnp.asarray(x), jspec)
    pq = JN.encode(jnp.asarray(x), jspec, backend="pallas")
    jd = np.asarray(JN.decode(jq))
    for backend in ("reference", "cuda"):
        tq = TN.encode(_t(x), tspec, backend=backend)
        assert tq.shape == jq.shape and tq.nbytes() == jq.nbytes()
        np.testing.assert_array_equal(tq.codes.numpy(), np.asarray(jq.codes))
        np.testing.assert_array_equal(tq.scale.numpy().view(np.int32),
                                      np.asarray(jq.scale).view(np.int32))
        td = TN.decode(tq, backend=backend).numpy()
        np.testing.assert_array_equal(td.view(np.int32), jd.view(np.int32))
        # Pallas: XLA compiles the kernel's division by the constant qmax
        # as a multiply by its reciprocal, so a block's scale may be one
        # f32 ulp off the dividing reference, and its decoded values two
        # (ROADMAP queue 3)
        np.testing.assert_array_equal(tq.codes.numpy(), np.asarray(pq.codes))
        ulps = np.abs(tq.scale.numpy().view(np.int32).astype(np.int64)
                      - np.asarray(pq.scale).view(np.int32))
        assert ulps.max() <= 1
        np.testing.assert_allclose(
            td, np.asarray(JN.decode(pq, backend="pallas")), rtol=2 ** -22,
            atol=0)
    if zb:
        assert float(jq.scale.reshape(-1)[0]) == 0.0


def _packed_cases():
    d = JM.make_mlp()
    jp = JM.init_mlp(jax.random.PRNGKey(0), d)
    out = []
    for layer, spec in (("l1", d.spec1), ("l2", d.spec2)):
        for n in range(spec.d):
            core = np.asarray(jp[layer][f"core_{n}"]).reshape(-1)
            step = np.float32(np.asarray(jp[layer]["wscale_log2"])[n])
            out.append((f"{layer}/core_{n}", core, step))
    rng = np.random.RandomState(7)
    out.append(("stacked odd", np.asarray(rng.standard_normal((3, 5, 7)) * .3,
                                          np.float32),
                np.asarray([-3, -2, -4], np.float32)))
    out.append(("stacked 2-d scale", np.asarray(
        rng.standard_normal((2, 3, 9)), np.float32),
        np.asarray(rng.randint(-4, 0, (2, 3)), np.float32)))
    out.append(("scalar", np.asarray(0.7, np.float32), np.float32(-2)))
    return out


@pytest.mark.parametrize("case", _packed_cases(), ids=lambda c: c[0])
def test_packed_codec_bit_identical_to_jax(case, monkeypatch):
    """int4x2 encode/decode: the six FMNIST cores flattened at their
    ``wscale_log2`` (the deploy export), a stacked tensor with a per-row
    step and odd trailing dims, and a scalar; against JAX's reference and
    Pallas (interpret) codecs."""
    monkeypatch.setenv("JAX_PALLAS_INTERPRET", "1")
    _, x, s = case
    jspec = JN.QuantSpec("pow2", 4, 0, "int4x2", "fixed")
    tspec = TN.QuantSpec("pow2", 4, 0, "int4x2", "fixed")
    jq = JN.encode(jnp.asarray(x), jspec, jnp.asarray(s))
    pq = JN.encode(jnp.asarray(x), jspec, jnp.asarray(s), backend="pallas")
    jd = np.asarray(JN.decode(jq))
    for backend in ("reference", "cuda"):
        tq = TN.encode(_t(x), tspec, _t(s), backend=backend)
        assert tq.nbytes() == jq.nbytes() and tq.shape == jq.shape
        np.testing.assert_array_equal(tq.codes.numpy(), np.asarray(jq.codes))
        np.testing.assert_array_equal(tq.codes.numpy(), np.asarray(pq.codes))
        td = TN.decode(tq, backend=backend).numpy()
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(
            td, np.asarray(JN.decode(pq, backend="pallas")))
    if s.size == 1:     # a Python-number scale counts repro's 4 bytes
        assert TN.encode(_t(x), tspec, float(s)).nbytes() == jq.nbytes()


def test_packed_kernel_views_keep_rows_and_refuse_other_scales():
    x = torch.zeros(3, 5, 7)
    x2d, srow = CB._rowwise_lastdim(x, torch.tensor([1.0, 2.0, 3.0]))
    assert tuple(x2d.shape) == (15, 7) and srow.tolist() == [1.0] * 5 + \
        [2.0] * 5 + [3.0] * 5
    x2d, srow = CB._rowwise_lastdim(x, torch.tensor(-2.0))
    assert tuple(x2d.shape) == (15, 7) and tuple(srow.shape) == (1,)
    assert CB._rowwise_lastdim(x, torch.ones(3, 5, 7)) is None
    with pytest.raises(ValueError):
        CB.decode_packed(torch.zeros((2, 3), dtype=torch.int8),
                         torch.zeros(2), 7)
    with pytest.raises(ValueError):
        CB.bw_decode(torch.zeros((2, 10), dtype=torch.int8),
                     torch.zeros((2, 3)), 10)


def test_spec_nbytes_and_policy_match_jax():
    for spec_kw, shape in ((dict(kind="blockwise", block=256), (16, 16, 16,
                                                                 1)),
                           (dict(kind="blockwise", block=1024), (4096,)),
                           (dict(bits=4, storage_dtype="int4x2"), (448,)),
                           (dict(bits=4, storage_dtype="int4x2"), (3, 7)),
                           (dict(), (64, 896)), (dict(), ())):
        assert TN.spec_nbytes(TN.QuantSpec(**spec_kw), shape) == \
            JN.spec_nbytes(JN.QuantSpec(**spec_kw), shape)
    jpol = JQuantConfig(enable=True, weight_bits=3).policy()
    tpol = QuantConfig(enable=True, weight_bits=3).policy()
    assert tpol.to_json() == jpol.to_json()
    assert TN.NumericsPolicy.from_json(jpol.to_json()) == tpol
    assert JN.NumericsPolicy.from_json(tpol.to_json()) == jpol
    edited = tpol.with_spec("dp_wire", TN.QuantSpec("blockwise", 8, 512))
    assert JN.NumericsPolicy.from_json(edited.to_json()).spec_for(
        "dp_wire").block == 512
    assert tpol.managed_sites() == jpol.managed_sites()
    assert tuple(TN.SITES) == tuple(JN.policy.SITES)
    assert tpol.nbytes("activation", (64, 896)) == \
        jpol.nbytes("activation", (64, 896))


# ---------------------------------------------------------------------------
# int8 Adam and the gradient wire from one state
# ---------------------------------------------------------------------------

def _init():
    d = JM.make_mlp()
    jp = JM.init_mlp(jax.random.PRNGKey(0), d)
    return d, jp


def _random_grads(jp, rng, scale):
    def leaf(x):
        if jnp.issubdtype(x.dtype, jnp.floating):
            return jnp.asarray(rng.standard_normal(x.shape) * scale,
                               jnp.float32)
        return np.zeros(x.shape, jax.dtypes.float0)
    return jax.tree.map(leaf, jp)


def _port_grads(tparams, jgrads):
    """JAX's gradient tree (float0 for integer leaves) as the port's
    (None there)."""
    return unflatten(tparams, [
        None if a.dtype == jax.dtypes.float0 else _t(a)
        for a in jax.tree_util.tree_leaves(jgrads)])


def _port_tree(jtree):
    return mlp_params_from_jax(jax.tree.map(np.asarray, jtree), device="cpu")


def test_int8_adam_update_matches_jax_from_one_state():
    _, jp = _init()
    jcfg = JTrainConfig(learning_rate=LR, weight_decay=0.0,
                        opt_state_dtype="int8")
    tcfg = TrainConfig(learning_rate=LR, weight_decay=0.0,
                       opt_state_dtype="int8")
    rng = np.random.RandomState(3)
    js = JA.init_adam(jp, jcfg)
    jp, js = JA.adam_update(jp, _random_grads(jp, rng, 0.01), js,
                            jnp.asarray(LR), jcfg)   # non-zero moments
    g = _random_grads(jp, rng, 0.02)
    tp = _port_tree(jp)
    ts = adam_state_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    jp2, js2 = JA.adam_update(jp, g, js, jnp.asarray(LR), jcfg)
    tp2, ts2 = TA.adam_update(tp, _port_grads(tp, g), ts, LR, tcfg)
    assert int(ts2.step) == int(js2.step)
    n = 0
    for jm, tm in zip(js2.m + js2.v, ts2.m + ts2.v):
        assert (jm is None) == (tm is None)
        if tm is None:
            continue
        n += 1
        assert tm.shape == jm.shape
        np.testing.assert_array_equal(tm.codes.numpy(), np.asarray(jm.codes))
        np.testing.assert_array_equal(tm.scale.numpy(), np.asarray(jm.scale))
    assert n == 2 * 17
    for (kp, a), (p, b) in zip(jax.tree_util.tree_flatten_with_path(jp2)[0],
                               flatten_with_path(tp2)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=2e-7,
                                   atol=1e-8, err_msg=p)
    res, fp32 = TA.moment_nbytes(ts2)
    assert (res, fp32) == JA.moment_nbytes(js2)
    assert res == 98290


def test_compress_decompress_matches_jax_from_one_state():
    _, jp = _init()
    tp = _port_tree(jp)
    rng = np.random.RandomState(5)
    g1, g2 = _random_grads(jp, rng, 0.01), _random_grads(jp, rng, 0.03)
    jc, jr = JG.compress_decompress(g1, None)
    tc, tr = TG.compress_decompress(_port_grads(tp, g1), None)
    # the second call carries a residual made by either package
    jc, jr2 = JG.compress_decompress(g2, jr)
    tc, tr2 = TG.compress_decompress(
        _port_grads(tp, g2),
        residual_from_jax([None if r is None else np.asarray(r) for r in jr],
                          device="cpu"))
    assert len(tr2) == len(jr2) == 29
    for a, b in zip(jax.tree_util.tree_leaves(jc), leaves(tc)):
        if b is None:
            assert a.dtype == jax.dtypes.float0
            continue
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in zip(jr2, tr2):
        assert (a is None) == (b is None)
        if b is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert TG.wire_nbytes(tc) == JG.wire_nbytes(jc)
    assert TG.wire_nbytes(tc)[0] == 14993
    assert TG.residual_nbytes(tr2) == JG.residual_nbytes(jr2)


# ---------------------------------------------------------------------------
# one full wire step
# ---------------------------------------------------------------------------

def _jax_wire_step(jp, batch, d):
    """``fmnist_low_precision_step``'s step body, from given params."""
    jcfg = JTrainConfig(learning_rate=LR, weight_decay=0.0,
                        opt_state_dtype="int8")
    opt = JA.init_adam(jp, jcfg)
    loss, grads = jax.value_and_grad(JM.mlp_loss, allow_int=True)(jp, batch,
                                                                  d)
    grads, residual = JG.compress_decompress(
        grads, None, d.qc.policy().spec_for("dp_wire"))
    params, opt = JA.adam_update(jp, grads, opt, jnp.asarray(LR), jcfg)
    params = JM.mlp_lambda_update(params, d)
    params = JM.mlp_scale_update(params, batch, grads, d)
    return {"new_params": params, "opt": opt, "loss": loss, "grads": grads,
            "residual": residual}


def _float_pairs(jtree, ttree):
    for (kp, a), (p, b) in zip(jax.tree_util.tree_flatten_with_path(jtree)[0],
                               flatten_with_path(ttree)):
        a = np.asarray(a)
        if b is None:
            assert a.dtype == jax.dtypes.float0, p
            continue
        yield p, a, b.numpy()


def _check_common(j, t, steps: float):
    """Loss, compressed gradients and residuals within ``steps`` wire steps
    of the leaf's largest |g|, parameters within 2 lr, integer leaves and
    effective ranks equal."""
    assert abs(float(t["loss"]) - float(j["loss"])) <= 1e-6 * abs(
        float(j["loss"]))
    gmax = {}
    for p, a, b in _float_pairs(j["grads"], t["grads"]):
        gmax[p] = np.abs(a).max()
        tol = steps * gmax[p] / 127 + 1e-5 * gmax[p] + 1e-12
        assert np.abs(a - b).max() <= tol, p
    paths = [p for p, _ in flatten_with_path(t["grads"])]
    for p, a, b in zip(paths, j["residual"], t["residual"]):
        assert (a is None) == (b is None), p
        if b is not None:
            tol = steps * gmax[p] / 127 + 1e-5 * gmax[p] + 1e-12
            assert np.abs(np.asarray(a) - b.numpy()).max() <= tol, p
    for (kp, a), (p, b) in zip(
            jax.tree_util.tree_flatten_with_path(j["new_params"])[0],
            flatten_with_path(t["new_params"])):
        a = np.asarray(a)
        if a.dtype.kind == "f":
            assert np.abs(a - b.numpy()).max() <= 2 * LR + 1e-6, p
        else:
            np.testing.assert_array_equal(b.numpy(), a, err_msg=p)
    assert JM.effective_ranks(j["new_params"], JM.make_mlp()) == \
        tuple(TF.MLP.effective_ranks(t["new_params"], TF.MLP.make_mlp()))


def test_wire_step_matches_jax_at_exact_gradient_grid():
    """Every edge's gradient exponent at -10 (XLA's exp2 exact there): the
    compressed gradients agree to roundoff except where a value sits at a
    rounding boundary of the wire grid, and the decoded moments within one
    step of their block and of the wire."""
    d, jp = _init()
    for q in ("q_in", "q_h", "q_out"):
        jp[q] = jp[q]._replace(grad=JScaleState(jnp.asarray(-10, jnp.int32),
                                                jp[q].grad.mean_abs))
    rng = np.random.RandomState(0)
    batch = {"x": jnp.asarray(rng.normal(size=(64, 896)), jnp.float32),
             "y": jnp.asarray(rng.randint(0, 10, 64), jnp.int32)}
    j = _jax_wire_step(jp, batch, d)
    t = TW.low_precision_step(device="cpu", params=_port_tree(jp))
    _check_common(j, t, steps=1)
    close = total = 0
    gmax = {}
    for p, a, b in _float_pairs(j["grads"], t["grads"]):
        gmax[p] = np.abs(a).max()
        close += int((np.abs(a - b) <= 1e-5 * gmax[p]).sum())
        total += a.size
    assert close >= 0.995 * total, (close, total)
    b1, b2 = TrainConfig().beta1, TrainConfig().beta2
    paths = [p for p, _ in flatten_with_path(t["new_params"])]
    for which, jms, tms in (("m", j["opt"].m, t["opt"].m),
                            ("v", j["opt"].v, t["opt"].v)):
        for p, jm, tm in zip(paths, jms, tms):
            assert (jm is None) == (tm is None), p
            if tm is None:
                continue
            assert tm.shape == jm.shape
            dec_j = np.asarray(JN.decode(jm))
            dec_t = TN.decode(tm).numpy()
            b = jm.codes.shape[-1] // jm.scale.shape[-1]
            scale = np.repeat(np.asarray(jm.scale), b,
                              axis=-1)[..., :jm.shape[-1]]
            wire = gmax[p] / 127       # one wire step of the gradient
            moved = (1 - b1) * wire if which == "m" else \
                (1 - b2) * (2 * gmax[p] + wire) * wire
            assert (np.abs(dec_j - dec_t) <= scale + moved + 1e-12).all(), \
                (which, p)


def test_wire_step_matches_fmnist_low_precision_step():
    """One step of JAX's own ``fmnist_low_precision_step`` (its init, its
    RandomState(0) batch) against the port's ``low_precision_step`` from
    the same params, and the per-site byte table exactly JAX's."""
    j = JTW.fmnist_low_precision_step(64)
    t = TW.low_precision_step(device="cpu", params=_port_tree(j["params"]))
    np.testing.assert_array_equal(t["batch_arrays"]["x"].numpy(),
                                  np.asarray(j["batch_arrays"]["x"]))
    _check_common(j, t, steps=2)
    # the wire covers all 21 floating gradient leaves, λ and mean_abs too
    assert sum(1 for _ in _float_pairs(j["grads"], t["grads"])) == 21
    assert sum(r is not None for r in t["residual"]) == 21


def test_site_table_equals_jax(tmp_path):
    j = JTW.fmnist_low_precision_step(64)
    t = TW.low_precision_step(device="cpu", params=_port_tree(j["params"]))
    jsites, jbase, jdep = JTW.fmnist_site_table(
        j, deploy_path=str(tmp_path / "j.ckpt"))
    tsites, tbase, tdep = TW.site_table(t, str(tmp_path / "t.ckpt"))
    assert tsites == jsites and tbase == jbase
    assert tdep == jdep
    assert tsites == {"tt_factor": 7160, "activation": 91148,
                      "optimizer_moment": 98290, "dp_wire": 14993}
    assert sum(tsites.values()) == 211591 and sum(tbase.values()) == 7844096
    assert round(sum(tbase.values()) / sum(tsites.values()), 2) == 37.07
    assert round(tdep["reduction_x"], 2) == 7.97


def test_launch_counts_cover_jax_leaf_sets():
    """``launches_per_step`` counts the codec round trips from the leaf
    sets JAX's step uses: 17 Adam leaves (m and v, all decoded in one group
    launch and encoded in another) and 21 floating gradient leaves on the
    wire (likewise one group launch each way)."""
    d, jp = _init()
    jcfg = JTrainConfig(opt_state_dtype="int8")
    n_adam = sum(m is not None for m in JA.init_adam(jp, jcfg).m)
    n_wire = sum(jnp.issubdtype(x.dtype, jnp.floating)
                 for x in jax.tree_util.tree_leaves(jp))
    assert (n_adam, n_wire) == (17, 21)
    td = TF.MLP.make_mlp()
    wire = TF.launches_per_step(td, TrainConfig(opt_state_dtype="int8"),
                                compress=True)
    assert 2 * n_adam + n_wire == 55
    assert 2 * n_adam <= TF.G.BW_CAP and n_wire <= TF.G.BW_CAP
    assert wire["bw_dec"] == 2                # the moments, the wire
    assert wire["bw_enc"] == 2                # the moments, the wire
    no_wire = TF.launches_per_step(td, TrainConfig(opt_state_dtype="int8"))
    assert no_wire["bw_dec"] == 1            # 2 x 11: cores, biases, probes
    assert no_wire["bw_enc"] == 1
    assert "bw_enc" not in TF.launches_per_step(td)
    assert {k: v for k, v in wire.items() if not k.startswith("bw_")} == \
        TF.launches_per_step(td)


def test_train_wire_main_prints_the_table(capsys, tmp_path):
    TW.main(["--device", "cpu", "--steps", "2", "--deploy-out",
             str(tmp_path / "d.ckpt")])
    out = capsys.readouterr().out
    assert "211,591" in out and "7,844,096" in out and "37.07x" in out
    assert (tmp_path / "d.ckpt").exists()


def test_train_fmnist_main_writes_the_deploy_export(capsys, tmp_path):
    path = tmp_path / "fmnist_tt_deploy.ckpt"
    TF.main(["--device", "cpu", "--steps", "2", "--deploy-out", str(path)])
    out = capsys.readouterr().out
    assert "deploy export: 7,160 B packed int4 cores (8.0x vs fp32)" in out
    assert path.exists()


def test_wire_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.ckpt import export_tt_deploy, load_tt_deploy
    _, jp = _init()
    with pytest.raises(RuntimeError, match="CUDA"):
        TW.low_precision_step()
    with pytest.raises(RuntimeError, match="CUDA"):
        TW.main(["--steps", "1"])
    path = str(tmp_path / "d.ckpt")
    export_tt_deploy(path, _port_tree(jp))
    with pytest.raises(RuntimeError, match="CUDA"):
        load_tt_deploy(path)
    js = jax.tree.map(np.asarray, JA.init_adam(jp, JTrainConfig()))
    with pytest.raises(RuntimeError, match="CUDA"):
        adam_state_from_jax(js)
    with pytest.raises(RuntimeError, match="CUDA"):
        residual_from_jax((None,))
