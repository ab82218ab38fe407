"""repro_torch's training slice against repro (the JAX reference): the
paper's FMNIST TT MLP (Appendix B) at its published widths, batch 64.

JAX and the port start from the same parameters (``repro``'s
``init_mlp`` carried across by ``convert.mlp_params_from_jax``) and the
same batches (``fashion_like``, numpy). On CPU tensors the port's kernel
wrappers run their plain versions. Tolerances, each with its reason:

- the loss within 1e-5 relative, each gradient leaf within 1e-3 of the
  leaf's largest |g| — the two sides sum the TT chains in different
  orders;
- at the 8-bit activation edges an activation within roundoff of a
  rounding boundary may land on the neighbouring grid point: at most 0.1%
  of an edge's elements may differ, each by exactly one grid step;
- five full steps of the example's jitted step: losses within 1e-3
  relative (Adam's first steps move every element by ~lr whatever the
  gradient's size, so roundoff-level gradient differences show), and the
  same scale exponents and effective ranks.
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.core import quant as JQ  # noqa: E402
from repro.core import rank_adapt as JRA  # noqa: E402
from repro.core import tt_layer as JTL  # noqa: E402
from repro.data import fashion_like as j_fashion_like  # noqa: E402
from repro.models import mlp_tt as JM  # noqa: E402
from repro.optim import adam as JA  # noqa: E402
from repro.optim import binaryconnect as JBC  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.convert import mlp_params_from_jax  # noqa: E402
from repro_torch.core import quant as TQ  # noqa: E402
from repro_torch.core import rank_adapt as TRA  # noqa: E402
from repro_torch.core import tt_layer as TTL  # noqa: E402
from repro_torch.core.ttm import TTMSpec  # noqa: E402
from repro_torch.data import fashion_like  # noqa: E402
from repro_torch.kernels import ops as TOPS  # noqa: E402
from repro_torch.launch import train_fmnist as TF  # noqa: E402
from repro_torch.models import mlp_tt as TM  # noqa: E402
from repro_torch import numerics as TN  # noqa: E402
from repro_torch.numerics import cuda_backend as CB  # noqa: E402
from repro_torch.optim import adam as TA  # noqa: E402
from repro_torch.optim.binaryconnect import quantize_for_deploy  # noqa: E402
from repro_torch.tree import flatten_with_path  # noqa: E402

LR = 3e-3
BATCH = 64


def _defs(prior=True, quantize=True):
    return (JM.make_mlp(prior=prior, quantize=quantize),
            TM.make_mlp(prior=prior, quantize=quantize))


def _jax_flat(tree) -> dict:
    return {JA._path_str(kp): leaf
            for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port(jparams) -> dict:
    return mlp_params_from_jax(jax.tree.map(np.asarray, jparams),
                               device="cpu")


def _batch(i: int = 0):
    xs, ys = j_fashion_like(8192, seed=1)
    lo = (i * BATCH) % (len(ys) - BATCH)
    x, y = xs[lo:lo + BATCH], ys[lo:lo + BATCH]
    return ({"x": jnp.asarray(x), "y": jnp.asarray(y)},
            {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})


def test_fashion_like_is_the_reference_data():
    for n, seed in ((100, 1), (37, 2)):
        (xj, yj), (xt, yt) = j_fashion_like(n, seed=seed), \
            fashion_like(n, seed=seed)
        np.testing.assert_array_equal(xt, xj)
        np.testing.assert_array_equal(yt, yj)
        assert xt.dtype == np.float32 and xt.shape == (n, 896)


def test_params_carry_across_and_specs_and_counts_match():
    jd, td = _defs()
    jp = JM.init_mlp(jax.random.PRNGKey(0), jd)
    tp = _port(jp)
    jf, tf = _jax_flat(jp), dict(flatten_with_path(tp))
    assert list(jf) == list(tf)
    for path, leaf in jf.items():
        np.testing.assert_array_equal(tf[path].numpy(), np.asarray(leaf))
    assert isinstance(tp["q_h"], TQ.ActQuant)
    for js, ts in ((jd.spec1, td.spec1), (jd.spec2, td.spec2)):
        assert (ts.j_dims, ts.i_dims, ts.ranks) == (js.j_dims, js.i_dims,
                                                    js.ranks)
    # the analytic per-core steps of a fresh port init equal repro's
    own = TM.init_mlp(torch.Generator().manual_seed(0), td, device="cpu")
    for layer in ("l1", "l2"):
        np.testing.assert_array_equal(own[layer]["wscale_log2"].numpy(),
                                      np.asarray(jp[layer]["wscale_log2"]))
    # Table-1 accounting, at full ranks and at pruned ones
    assert TM.param_counts(td) == JM.param_counts(jd)
    assert TM.param_counts(td, [10, 12, 16], [8]) == \
        JM.param_counts(jd, [10, 12, 16], [8])
    c = TM.param_counts(td)
    assert c["tt_params"] == 14794
    assert round(c["dense_bits"] / c["fixed_bits"]) == 243


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    _, td = _defs()
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.init_mlp(torch.Generator(), td)
    with pytest.raises(RuntimeError, match="CUDA"):
        mlp_params_from_jax({"b": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="CUDA"):
        TF.main(["--steps", "1"])


def test_adam_leaf_rule_and_f32_moments_only():
    """The port gives moments to exactly the leaves repro's ``init_adam``
    does: cores, biases and every ActQuant float leaf (probe, mean_abs),
    never λ, ``wscale_log2`` or integer exponents."""
    jd, td = _defs()
    jp = JM.init_mlp(jax.random.PRNGKey(0), jd)
    st = JA.init_adam(jp, JTrainConfig())
    paths = list(_jax_flat(jp))
    want = [p for p, m in zip(paths, st.m) if m is not None]
    got = TA.adam_leaf_paths(_port(jp))
    assert got == want
    assert "q_in/.probe" in got and "q_h/.grad/.mean_abs" in got
    assert not any("lambda_" in p or "wscale" in p or p.endswith(".log2")
                   for p in got)
    # int8 moments: a blockwise QTensor per Adam leaf, repro's layout
    jst = JA.init_adam(jp, JTrainConfig(opt_state_dtype="int8"))
    tst = TA.init_adam(_port(jp), TrainConfig(opt_state_dtype="int8"))
    for jm, tm in zip(jst.m + jst.v, tst.m + tst.v):
        assert (jm is None) == (tm is None)
        if tm is not None:
            assert isinstance(tm, TN.QTensor) and tm.spec == TA.MOMENT_SPEC
            assert tm.shape == jm.shape and tm.nbytes() == jm.nbytes()
            np.testing.assert_array_equal(tm.codes.numpy(),
                                          np.asarray(jm.codes))
            np.testing.assert_array_equal(tm.scale.numpy(),
                                          np.asarray(jm.scale))
    with pytest.raises(ValueError, match="opt_state_dtype"):
        TA.init_adam(_port(jp), TrainConfig(opt_state_dtype="int4"))


def _managed_grad_scales(jp, log2: int):
    """``jp`` with every edge's gradient exponent at ``log2``."""
    from repro.numerics import ScaleState
    out = dict(jp)
    for q in ("q_in", "q_h", "q_out"):
        out[q] = jp[q]._replace(grad=ScaleState(
            jnp.asarray(log2, jnp.int32), jp[q].grad.mean_abs))
    return out


@pytest.mark.parametrize("quantize", [False, True])
def test_loss_and_grads_match_jax(quantize):
    """Loss 1e-5 relative, every gradient leaf 1e-3 of its largest |g|.
    Quantized, the edges' gradient exponents sit at -10, where the scale
    manager takes them within the first steps (mean|g|/2^k drifts into
    [0.1, 0.3]); at the initial exponent 0 the 16-bit gradient grid is
    2^-15, and ``test_16bit_gradient_edge_...`` counts the gradients that
    land on its neighbouring grid point there."""
    jd, td = _defs(quantize=quantize)
    jp = _managed_grad_scales(JM.init_mlp(jax.random.PRNGKey(3), jd), -10)
    tp = _port(jp)
    jb, tb = _batch(2)
    jl, jg = jax.value_and_grad(JM.mlp_loss, allow_int=True)(jp, jb, jd)
    tl, tg = TF.loss_and_grads(tp, tb, td)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    jgf, tgf = _jax_flat(jg), dict(flatten_with_path(tg))
    paths = TA.adam_leaf_paths(tp)
    assert len(paths) == 8 + 9     # cores and biases; 3 floats per edge
    for p in paths:
        want = np.asarray(jgf[p], np.float32)
        got = np.zeros_like(want) if tgf[p] is None else tgf[p].numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-3 * np.abs(want).max(), err_msg=p)
    if quantize:
        # the probes carry the scale manager's nonzero statistic
        assert all(float(tgf[f"{q}/.probe"]) > 0
                   for q in ("q_in", "q_h", "q_out"))


def _grid_diff(a: np.ndarray, b: np.ndarray, step: float) -> tuple[int, int]:
    """(elements on different grid points, largest difference in grid
    steps). Grid indices, not values: on the CPU, XLA's ``exp2`` is not
    exact at every integer exponent (2^-15 among them, ROADMAP queue 3),
    so JAX's grid values can sit an ulp off the exact powers of two the
    port uses."""
    d = np.abs(np.round(a / step) - np.round(b / step))
    return int((d > 0).sum()), int(d.max())


def test_8bit_edges_agree_but_for_one_grid_step_at_boundaries():
    """The activations reaching the ``q_h`` and ``q_out`` edges are sums
    over the TT chains in different orders; after the 8-bit edge (step
    2^-7 at the initial exponent) at most 0.1% of the elements may sit on
    the neighbouring grid point, never further. Measured when this test
    was written: 0 of 32,768 at q_h, 0 of 1,024 at q_out."""
    jd, td = _defs()
    jp = JM.init_mlp(jax.random.PRNGKey(3), jd)
    tp = _port(jp)
    jb, tb = _batch(2)
    qc = jd.qc
    xj = JQ.quant_edge(jb["x"], jp["q_in"], qc.act_bits, qc.grad_bits)
    xt = TQ.quant_edge(tb["x"], tp["q_in"], qc.act_bits, qc.grad_bits)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    hj = jax.nn.relu(JTL.tt_linear_apply(jp["l1"], xj, jd.spec1, jd.tt, qc))
    ht = torch.relu(TTL.tt_linear_apply(tp["l1"], xt, td.spec1, td.tt, qc))
    qhj = JQ.quant_edge(hj, jp["q_h"], qc.act_bits, qc.grad_bits)
    qht = TQ.quant_edge(ht, tp["q_h"], qc.act_bits, qc.grad_bits)
    oj = JTL.tt_linear_apply(jp["l2"], qhj, jd.spec2, jd.tt, qc)
    ot = TTL.tt_linear_apply(tp["l2"], qht, td.spec2, td.tt, qc)
    qoj = JQ.quant_edge(oj, jp["q_out"], qc.act_bits, qc.grad_bits)
    qot = TQ.quant_edge(ot, tp["q_out"], qc.act_bits, qc.grad_bits)
    step = 2.0 ** -(qc.act_bits - 1)
    for a, b in ((qht, qhj), (qot, qoj)):
        n, far = _grid_diff(a.detach().numpy(), np.asarray(b), step)
        assert n <= 1e-3 * b.size and far <= 1, (n, far, b.size)


@pytest.mark.parametrize("k", [0, 1])
def test_16bit_gradient_edge_differs_only_at_reference_inexact_ties(k):
    """From the same activation h, the gradient that ``q_h``'s backward
    quantizes to 16 bits (step 2^(k-15)) comes out of layer 2's
    transposed chain. Its values are exact sums of grid multiples, so
    many sit exactly on a .5 tie of the 16-bit grid. Where XLA's CPU
    ``exp2`` gives the exact step the port puts every element on JAX's
    grid point. Where it does not (2^-15, the initial exponent's step, on
    jax 0.9.0: an ulp off, ROADMAP queue 3) JAX breaks some ties the other
    way, and each element that differs is one grid step off and an exact
    tie of the port's gradient (36 of 32,768 when this test was
    written)."""
    jd, td = _defs()
    jp = _managed_grad_scales(JM.init_mlp(jax.random.PRNGKey(3), jd), k)
    tp = _port(jp)
    jb, tb = _batch(2)
    qc = jd.qc
    xj = JQ.quant_edge(jb["x"], jp["q_in"], qc.act_bits, qc.grad_bits)
    hj = jax.nn.relu(JTL.tt_linear_apply(jp["l1"], xj, jd.spec1, jd.tt, qc))

    def tail_j(h):
        h = JQ.quant_edge(h, jp["q_h"], qc.act_bits, qc.grad_bits)
        o = JTL.tt_linear_apply(jp["l2"], h, jd.spec2, jd.tt, qc)
        o = JQ.quant_edge(o, jp["q_out"], qc.act_bits, qc.grad_bits)
        return -jnp.mean(jnp.sum(jax.nn.one_hot(jb["y"], 10)
                                 * jax.nn.log_softmax(o[:, :10]), axis=-1))
    gj = np.asarray(jax.grad(tail_j)(hj))
    ht = torch.from_numpy(np.array(hj)).requires_grad_()
    h = TQ.quant_edge(ht, tp["q_h"], qc.act_bits, qc.grad_bits)
    h.retain_grad()                          # the gradient before the edge
    o = TTL.tt_linear_apply(tp["l2"], h, td.spec2, td.tt, qc)
    o = TQ.quant_edge(o, tp["q_out"], qc.act_bits, qc.grad_bits)
    torch.nn.functional.cross_entropy(o[:, :10], tb["y"].long()).backward()
    step = 2.0 ** (k - (qc.grad_bits - 1))
    n, far = _grid_diff(ht.grad.numpy(), gj, step)
    assert np.count_nonzero(gj) > gj.size // 2
    if float(jnp.exp2(jnp.float32(k - (qc.grad_bits - 1)))) == step:
        assert n == 0
        return
    assert far <= 1
    off = np.round(ht.grad.numpy() / step) != np.round(gj / step)
    pre = h.grad.numpy()[off] / step
    np.testing.assert_array_equal(np.abs(pre - np.trunc(pre)), 0.5)


def _jax_step(jd, tcfg):
    """``examples/train_fmnist_tt.py``'s jitted step."""
    @jax.jit
    def step(params, opt, batch):
        loss, grads = jax.value_and_grad(JM.mlp_loss, allow_int=True)(
            params, batch, jd)
        params, opt = JA.adam_update(params, grads, opt, jnp.asarray(LR),
                                     tcfg)
        if jd.tt.rank_adapt:
            params = JM.mlp_lambda_update(params, jd)
        if jd.qc.enable:
            params = JM.mlp_scale_update(params, batch, grads, jd)
        return params, opt, loss
    return step


def test_five_steps_match_the_jax_example_step():
    jd, td = _defs()
    jp = JM.init_mlp(jax.random.PRNGKey(0), jd)
    tp = _port(jp)
    jt = JTrainConfig(learning_rate=LR, weight_decay=0.0)
    tt = TrainConfig(learning_rate=LR, weight_decay=0.0)
    jo, to = JA.init_adam(jp, jt), TA.init_adam(tp, tt)
    jstep, tstep = _jax_step(jd, jt), TF.make_step(td, tt)
    for i in range(5):
        jb, tb = _batch(i)
        jp, jo, jl = jstep(jp, jo, jb)
        tp, to, tl = tstep(tp, to, tb)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-3,
                                   err_msg=f"step {i}")
    for q in ("q_in", "q_h", "q_out"):
        for side in ("act", "grad"):
            assert int(getattr(tp[q], side).log2) == \
                int(getattr(jp[q], side).log2), (q, side)
    assert TM.effective_ranks(tp, td) == JM.effective_ranks(jp, jd)
    assert int(to.step) == int(jo.step) == 5


def test_kernel_wrappers_per_step_are_the_counted_ones(monkeypatch):
    """Each kernel wrapper is entered per step exactly as often as
    ``launches_per_step`` works out from the code (on the card each entry
    is one launch; here each runs the plain version). The fake-quant kernel
    has two wrappers: the edges' single tensors and a layer's cores, one
    group launch for the layer."""
    _, td = _defs()
    calls = collections.Counter()

    def spy(name, fn):
        def f(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return f
    monkeypatch.setattr(CB, "fake_quant_scalar",
                        spy("p2_fake_quant", CB.fake_quant_scalar))
    monkeypatch.setattr(CB, "fake_quant_scalar_many",
                        spy("p2_fake_quant", CB.fake_quant_scalar_many))
    for name in ("pe1", "pe2", "pe3"):
        monkeypatch.setattr(TOPS, name, spy(name, getattr(TOPS, name)))
    tcfg = TrainConfig(learning_rate=LR, weight_decay=0.0)
    tp = TM.init_mlp(torch.Generator().manual_seed(0), td, device="cpu")
    step = TF.make_step(td, tcfg)
    opt = TA.init_adam(tp, tcfg)
    _, tb = _batch(0)
    for n in (1, 2):
        tp, opt, _ = step(tp, opt, tb)
        assert dict(calls) == {k: n * v for k, v in
                               TF.launches_per_step(td).items()}
    assert TF.launches_per_step(td) == {"p2_fake_quant": 9, "pe1": 6,
                                        "pe2": 12, "pe3": 2}


def test_rank_adapt_matches_reference():
    """The prior (with its relative floor on collapsed slices), the
    closed-form λ update, the masks and the effective ranks."""
    ts = TTMSpec((4, 4, 2), (7, 4, 2), (1, 6, 6, 1))
    rng = np.random.RandomState(0)
    cores = [rng.randn(*s).astype(np.float32) for s in ts.core_shapes]
    cores[0][..., :2] *= 1e-4                      # two collapsed slices
    lam = [np.abs(rng.randn(6)).astype(np.float32) for _ in range(2)]
    lam[1][3] = 1e-9
    jc, tc = [jnp.asarray(c) for c in cores], [torch.from_numpy(c)
                                               for c in cores]
    jl, tl = [jnp.asarray(v) for v in lam], [torch.from_numpy(v) for v in lam]
    np.testing.assert_allclose(float(TRA.prior_loss(tc, tl, ts)),
                               float(JRA.prior_loss(jc, jl, ts)), rtol=1e-6)
    for a, b in zip(TRA.update_lambdas(tc, ts), JRA.update_lambdas(jc, ts)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    upd = TRA.update_lambdas(tc, ts)
    assert TRA.effective_ranks(upd, 1e-2) == JRA.effective_ranks(
        JRA.update_lambdas(jc, ts), 1e-2) == [4, 6]
    for a, b in zip(TRA.rank_masks(tl, 1e-2), JRA.rank_masks(jl, 1e-2)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_quantize_for_deploy_matches_reference():
    """4-bit cores on their fixed steps and 8-bit biases, bit for bit (the
    codec's encode -> decode; the row-scale kernels' plain versions
    here)."""
    jd, td = _defs()
    jp = JM.init_mlp(jax.random.PRNGKey(1), jd)
    jp["l1"]["bias"] = jnp.linspace(-3, 3, 512, dtype=jnp.float32)
    want = _jax_flat(JBC.quantize_for_deploy(jp, jd.qc))
    got = dict(flatten_with_path(quantize_for_deploy(_port(jp), td.qc)))
    assert list(got) == list(want)
    for p, leaf in want.items():
        np.testing.assert_array_equal(got[p].numpy(), np.asarray(leaf),
                                      err_msg=p)
    assert len(np.unique(np.asarray(want["l1/core_0"]))) <= 16


def _edge_leaves(jp, jd):
    """Cores and biases with exact zeros, small negatives that round to a
    zero code (the fake-quant would give -0.0 there, the round trip +0.0),
    ties, and values far past the grid (saturating), each on its leaf's
    own step."""
    rng = np.random.RandomState(4)
    for layer in ("l1", "l2"):
        tree = jp[layer]
        steps = np.asarray(tree["wscale_log2"]).astype(np.float64)
        for k in list(tree):
            if k.startswith("core_") or k == "bias":
                step = 2.0 ** (steps[int(k.split("_")[1])]
                               if k != "bias" else -(jd.qc.act_bits - 1))
                x = np.asarray(tree[k]).copy().reshape(-1)
                x[:8] = np.array([0.0, -0.3, -0.5, 0.5, 1e3, -1e3, 2.5, -1e-9]
                                 ) * step
                x[8::13] = rng.choice([-0.25, -0.49, 100.0, -100.0],
                                      x[8::13].shape) * step
                tree[k] = jnp.asarray(x.reshape(np.shape(tree[k])),
                                      jnp.float32)
    return jp


def test_grouped_export_matches_reference_bit_for_bit():
    """The export's grouped round trip (``core.quant.quantize_store_many``,
    its plain twin here) against JAX's ``quantize_for_deploy`` leaf by
    leaf, bit for bit including the sign of zeros, at zero,
    negative-near-zero and saturating inputs."""
    jd, td = _defs()
    jp = _edge_leaves(JM.init_mlp(jax.random.PRNGKey(3), jd), jd)
    want = _jax_flat(JBC.quantize_for_deploy(jp, jd.qc))
    got = dict(flatten_with_path(quantize_for_deploy(_port(jp), td.qc)))
    assert list(got) == list(want)
    zeros = 0
    for p, leaf in want.items():
        w = np.asarray(leaf)
        if w.dtype == np.float32:
            np.testing.assert_array_equal(got[p].numpy().view(np.int32),
                                          w.view(np.int32), err_msg=p)
            zeros += int((w == 0).sum())
        else:
            np.testing.assert_array_equal(got[p].numpy(), w, err_msg=p)
    assert zeros > 0 and not any(
        np.signbit(np.asarray(want[p])[np.asarray(want[p]) == 0]).any()
        for p in want if p.split("/")[-1].startswith(("core_", "bias")))
    l1 = np.asarray(want["l1/core_0"])
    step = 2.0 ** float(np.asarray(jp["l1"]["wscale_log2"])[0])
    assert l1.max() == 7 * step and l1.min() == -8 * step      # saturated


def test_grouped_export_plan_and_route(monkeypatch):
    """The export's plan (pure Python, ``deploy_leaves``): the six 4-bit
    cores in one group and the two 8-bit biases in another, each one
    ``p2_fq_group`` launch by ``grouped.fq_plan``; the export runs one
    grouped round trip per group and no scalar encode or decode."""
    from repro_torch.kernels import grouped as G
    from repro_torch.optim.binaryconnect import deploy_leaves
    jd, td = _defs()
    tp = _port(JM.init_mlp(jax.random.PRNGKey(1), jd))
    groups = deploy_leaves(tp, td.qc)
    assert {key: [k for _, k, _, _ in leaves]
            for key, leaves in groups.items()} == {
        (4, torch.float32): ["core_0", "core_1", "core_2", "core_3",
                             "core_0", "core_1"],
        (8, torch.float32): ["bias", "bias"]}
    for leaves in groups.values():
        assert len(G.fq_plan([v.numel() for _, _, v, _ in leaves])) == 1
    calls = collections.Counter()
    for name in ("roundtrip_many", "encode_scalar", "decode_scalar"):
        def wrapped(*a, _n=name, _fn=getattr(CB, name), **k):
            calls[_n] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(CB, name, wrapped)
    quantize_for_deploy(tp, td.qc)
    assert dict(calls) == {"roundtrip_many": 2}


def test_main_runs_on_the_cpu_when_asked(capsys):
    TF.main(["--device", "cpu", "--steps", "3"])
    out = capsys.readouterr().out
    assert "step    0  loss" in out and "params 14,794" in out
    assert "effective ranks: L1 [16, 16, 16]  L2 [16]" in out
    assert "ms/batch-64 on this CPU" in out
