"""repro_torch's zoo-LM training with TT weight sites against repro (the
JAX reference): the TT weight site, the rank prior and the Eq. 4 λ update,
the TT embedding, ``lm_forward`` with the policy's activation edges, the
train step with f32 and with int8 moments + the int8 gradient wire, the
grad-accumulation step, the byte table, the parameter counts, ``lm_batch``,
the LR schedule, clipping and the scale manager.

The model is the reference's ``_tiny_tt_lm`` (``tests/test_train_wire.py``:
2 layers, d_model 32, TT d = 3 at rank 4, ``min_elements`` 1,024, so every
projection is TT, quantization on), float32 on the CPU, weights and states
carried across by ``params_from_jax`` / ``lm_train_state_from_jax``, inputs
made with numpy. On CPU tensors the port's kernels run their plain
versions. Tolerances, each with its reason:

- the TT site forward and its core and input gradients: within 1e-5 of
  the output's (gradient's) largest magnitude: the port contracts through
  the PE chain and Ŵ (Appendix A.2), JAX differentiates its einsum chain,
  so f32 sums run in other orders;
- the prior and the logits: 1e-5 relative (the same reassociation); the
  λ update, ``obs`` and the scale states: 1e-6 relative, exponents equal
  (1e-5 after two accumulated micro-batches: the gradient sum and the
  grad edge's mean |g| over it reassociate);
- three train steps: loss, ce, prior, gnorm and lr within 1e-5 relative
  (every step's reductions reassociate; 1e-4 after a first int8 step,
  which starts the next from params that differ by the moment codes
  below, and so the scale states too); the wire's residual within twice
  the leaf's largest residual (one wire code where that residual is half
  a code: a value within roundoff of a code boundary lands on the
  neighbouring code) and 99% of it within 1e-2 of that largest residual;
  params within 2e-5 absolute
  with f32 moments (Adam's update divides by sqrt(v) + eps, which turns
  the gradients' roundoff into ~1e-6 moves a step); with int8 moments
  within 1e-3 absolute (a moment within roundoff of a code boundary of
  its block lands on the neighbouring code: one code of a block is
  1/127 of its largest |m|, a move of up to lr / 127 per step at lr
  3e-4, in either direction), and 99.9% of the elements within 2e-5;
- the grad edge on its own: exact where XLA's CPU ``exp2`` gives the
  exact step; where it does not (2^-15, 2^-13 and exponents <= -16 on jax
  0.9.0, ROADMAP queue 3) 99% of the elements within 1e-5 of the leaf's
  largest |g| and every one within one code;
- the wire's round trip from one state, the byte table, the parameter
  counts, ``lm_batch``, ``lr_at``: exact.
"""
import shutil
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.configs.base import QuantConfig as JQuantConfig  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs.base import TTConfig as JTTConfig  # noqa: E402
from repro.data import lm_batch as j_lm_batch  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import common as JCM  # noqa: E402
from repro.models import lm as JL  # noqa: E402
from repro.numerics.policy import ScaleState as JScaleState  # noqa: E402
from repro.optim import adam as JA  # noqa: E402
from repro.optim.schedule import lr_at as j_lr_at  # noqa: E402
from repro.sharding import ShardPlan  # noqa: E402
from repro_torch.configs.base import ModelConfig, QuantConfig  # noqa: E402
from repro_torch.configs.base import TrainConfig, TTConfig  # noqa: E402
from repro_torch.convert import (lm_train_state_from_jax,  # noqa: E402
                                 params_from_jax)
from repro_torch.data import lm_batch as t_lm_batch  # noqa: E402
from repro_torch.kernels import grouped as G  # noqa: E402
from repro_torch.kernels import ttm_pe1, ttm_pe2, ttm_pe3  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch import train as TT  # noqa: E402
from repro_torch.models import common as TCM  # noqa: E402
from repro_torch.models import lm as TL  # noqa: E402
from repro_torch.numerics import cuda_backend as CB  # noqa: E402
from repro_torch.numerics.policy import ScaleState  # noqa: E402
from repro_torch.optim import adam as TA  # noqa: E402
from repro_torch.optim.schedule import lr_at as t_lr_at  # noqa: E402
from repro_torch.tree import flatten_with_path, stack_key  # noqa: E402

PLAN = ShardPlan(mesh=None)
KW = dict(name="t", num_layers=2, d_model=32, num_heads=2, num_kv_heads=2,
          d_ff=64, vocab_size=64, remat="none", dtype="float32")


def _configs(apply_to=("ffn", "attn_qkv", "attn_o"), **over):
    kw = dict(KW, **over)
    jcfg = JModelConfig(**kw, tt=JTTConfig(enable=True, d=3, max_rank=4,
                                           min_elements=1024,
                                           apply_to=apply_to),
                        quant=JQuantConfig(enable=True))
    tcfg = ModelConfig(**kw, tt=TTConfig(enable=True, d=3, max_rank=4,
                                         min_elements=1024,
                                         apply_to=apply_to),
                       quant=QuantConfig(enable=True))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def tiny():
    """The reference's ``_tiny_tt_lm`` and the port's twin on its weights."""
    jcfg, tcfg = _configs()
    jlm = JL.build_lm(jcfg)
    jp = JL.init_lm(jax.random.PRNGKey(0), jlm)
    tlm = TL.build_lm(tcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jlm, jp, tlm, tp


def _batch(b=2, s=16, vocab=64, seed=0):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (b, s)).astype(np.int32)
    lab = rng.integers(0, vocab, (b, s)).astype(np.int32)
    return ({"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)},
            {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)})


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _port(jtree):
    return lm_train_state_from_jax(jax.tree.map(np.asarray, jtree), "cpu")


def test_every_projection_is_a_tt_site(tiny):
    jlm, _, tlm, _ = tiny
    j_sites = list(JL._walk_sites(jlm))
    t_sites = list(TL._walk_sites(tlm))
    assert [p for p, _ in j_sites] == [p for p, _ in t_sites]
    for (_, js), (_, ts) in zip(j_sites, t_sites):
        assert (js.use_tt, js.out_dim, js.in_dim) == \
            (ts.use_tt, ts.out_dim, ts.in_dim)
        if ts.use_tt:
            assert (ts.spec.j_dims, ts.spec.i_dims, ts.spec.ranks) == \
                (js.spec.j_dims, js.spec.i_dims, js.spec.ranks)
    assert sum(s.use_tt for _, s in t_sites) == 6     # q kv o gate up down


@pytest.mark.parametrize("site_name", ["q", "kv", "down"])
def test_tt_site_forward_and_gradients_match_jax(tiny, site_name):
    jlm, jp, tlm, tp = tiny
    group = "ffn" if site_name == "down" else "mixer"
    sub_j = jlm.period[0]
    jsite = getattr(sub_j.ffn if group == "ffn" else sub_j.mixer, site_name)
    tsite = getattr(tlm.period[0].ffn if group == "ffn"
                    else tlm.period[0].mixer, site_name)
    jparams = jax.tree.map(lambda a: a[1], jp["layers"]["sub_0"][group]
                           [site_name])
    tparams = tp["layers"][1]["sub_0"][group][site_name]
    x = np.random.default_rng(1).normal(size=(2, 5, jsite.in_dim)).astype(
        np.float32)
    ybar = np.random.default_rng(2).normal(
        size=(2, 5, jsite.out_dim)).astype(np.float32)
    cfg_j, cfg_t = jlm.cfg, tlm.cfg

    def f(p, xx):
        return jnp.sum(JCM.apply_site(p, xx, jsite, cfg_j) * ybar)
    yj = np.asarray(JCM.apply_site(jparams, jnp.asarray(x), jsite, cfg_j))
    gpj, gxj = jax.grad(f, argnums=(0, 1), allow_int=True)(
        jparams, jnp.asarray(x))
    tp_live = {k: (v.detach().clone().requires_grad_()
                   if v.is_floating_point() else v)
               for k, v in tparams.items()}
    xt = torch.from_numpy(x).requires_grad_()
    yt = TCM.apply_site(tp_live, xt, tsite, cfg_t)
    (yt * torch.from_numpy(ybar)).sum().backward()
    np.testing.assert_allclose(_np(yt), yj, rtol=0,
                               atol=1e-5 * np.abs(yj).max())
    gx = np.asarray(gxj)
    np.testing.assert_allclose(xt.grad.numpy(), gx, rtol=0,
                               atol=1e-5 * np.abs(gx).max())
    for n in range(3):
        g = np.asarray(gpj[f"core_{n}"])
        np.testing.assert_allclose(tp_live[f"core_{n}"].grad.numpy(), g,
                                   rtol=0, atol=1e-5 * np.abs(g).max())


def test_prior_and_lambda_update_match_jax(tiny):
    jlm, jp, tlm, tp = tiny
    # move λ off its init so the relative floor and the log term bite
    jp = JL.lm_lambda_update(jp, jlm)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    pj = float(JL.lm_prior_loss(jp, jlm))
    pt = float(TL.lm_prior_loss(tp, tlm))
    assert pt == pytest.approx(pj, rel=1e-5)
    # a site's prior per layer sums to the reference's stacked prior
    js = jlm.period[0].mixer.kv
    stacked = float(JCM.site_prior_loss(jp["layers"]["sub_0"]["mixer"]["kv"],
                                        js, jlm.cfg))
    per_layer = sum(float(TCM.site_prior_loss(
        tp["layers"][l]["sub_0"]["mixer"]["kv"], tlm.period[0].mixer.kv,
        tlm.cfg)) for l in range(2))
    assert per_layer == pytest.approx(stacked, rel=1e-5)
    # scale the cores so the update moves λ, then both update
    jp2 = jax.tree_util.tree_map_with_path(
        lambda kp, a: a * 1.5 if "core" in str(kp[-1]) else a, jp)
    tp2 = params_from_jax(jax.tree.map(np.asarray, jp2), device="cpu")
    before = tp2["layers"][0]["sub_0"]["ffn"]["up"]["lambda_0"].clone()
    got = params_from_jax(jax.tree.map(np.asarray,
                                       JL.lm_lambda_update(jp2, jlm)), "cpu")
    new_t = TL.lm_lambda_update(tp2, tlm)
    for (p, a), (_, b) in zip(flatten_with_path(new_t),
                              flatten_with_path(got)):
        if "lambda" in p:
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6,
                                       err_msg=p)
        else:
            np.testing.assert_array_equal(_np(a), _np(b), err_msg=p)
    # the tree the update started from is untouched
    assert torch.equal(tp2["layers"][0]["sub_0"]["ffn"]["up"]["lambda_0"],
                       before)
    assert not torch.equal(
        new_t["layers"][0]["sub_0"]["ffn"]["up"]["lambda_0"], before)


def test_tt_embedding_lookup_matches_jax():
    jcfg, tcfg = _configs(apply_to=("ffn", "attn_qkv", "attn_o", "embed"),
                          vocab_size=128)
    jlm, tlm = JL.build_lm(jcfg), TL.build_lm(tcfg)
    assert jlm.embed.use_tt and tlm.embed.use_tt
    jp = JL.init_lm(jax.random.PRNGKey(4), jlm)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    tok = np.random.default_rng(3).integers(0, 128, (3, 7)).astype(np.int32)
    ej = np.asarray(JL.tt_embed_lookup(jp["embed"], jnp.asarray(tok),
                                       jlm.embed, jcfg))
    et = TL.tt_embed_lookup(tp["embed"], torch.from_numpy(tok), tlm.embed,
                            tcfg)
    assert et.shape == (3, 7, 32)
    np.testing.assert_allclose(_np(et), ej, rtol=0,
                               atol=1e-6 * np.abs(ej).max())
    # a port-initialised TT embedding runs through lm_forward
    p0 = TL.init_lm(torch.Generator().manual_seed(0), tlm, device="cpu")
    logits, _, _ = TL.lm_forward(p0, tlm, tokens=torch.from_numpy(tok))
    assert logits.shape == (3, 7, 128) and torch.isfinite(logits).all()


def test_lm_forward_with_scales_matches_jax(tiny):
    jlm, jp, tlm, tp = tiny
    jb, tb = _batch()
    jsc = jlm.cfg.quant.policy().init_scales()
    tsc = tlm.cfg.quant.policy().init_scales("cpu")
    lj, _, _, oj = JL.lm_forward(jp, jlm, PLAN, tokens=jb["tokens"],
                                 scales=jsc)
    lt, aux, cache, ot = TL.lm_forward(tp, tlm, tokens=tb["tokens"],
                                       scales=tsc)
    lj = np.asarray(lj)
    np.testing.assert_allclose(_np(lt), lj, rtol=0,
                               atol=1e-5 * np.abs(lj).max())
    assert cache is None and float(aux) == 0.0
    assert ot["activation"].shape == (1,)
    np.testing.assert_allclose(_np(ot["activation"]),
                               np.asarray(oj["activation"]), rtol=1e-6)
    # without scales: three outputs, no edges, as the reference
    assert len(TL.lm_forward(tp, tlm, tokens=tb["tokens"])) == 3


def test_lm_activation_edges_quantize_forward(tiny):
    """The port's form of the reference test: with scales the residual
    stream is fake-quantized (logits differ from the unquantized forward),
    ``obs`` carries the statistic, and an absurdly coarse activation scale
    crushes the stream."""
    _, _, tlm, tp = tiny
    _, tb = _batch()
    scales = tlm.cfg.quant.policy().init_scales("cpu")
    lq, _, _, obs = TL.lm_forward(tp, tlm, tokens=tb["tokens"],
                                  scales=scales)
    lf, _, _ = TL.lm_forward(tp, tlm, tokens=tb["tokens"])
    assert (lq - lf).abs().max() > 0
    assert float(obs["activation"][0]) > 0
    dead = dict(scales)
    dead["activation"] = ScaleState(torch.tensor(30, dtype=torch.int32),
                                    scales["activation"].mean_abs)
    ld, _, _, _ = TL.lm_forward(tp, tlm, tokens=tb["tokens"], scales=dead)
    assert ld.abs().max() < lq.abs().max()


def _params_close(jstate, tstate, atol, share=None):
    got = _port(jstate)
    worst, close, total = 0.0, 0, 0
    for (p, a), (_, b) in zip(flatten_with_path(got.params),
                              flatten_with_path(tstate.params)):
        if not a.is_floating_point():
            assert torch.equal(a, b), p
            continue
        e = (a - b).abs()
        worst = max(worst, e.max().item())
        assert e.max().item() <= atol, (p, e.max().item())
        close += int((e <= 2e-5).sum())
        total += e.numel()
    if share is not None:
        assert close >= share * total, (close, total)
    return got


@pytest.mark.parametrize("opt", ["float32", "int8"])
def test_three_train_steps_match_jax(tiny, opt):
    jlm, jp, tlm, _ = tiny
    wire = opt == "int8"
    jt = JTrainConfig(total_steps=5, warmup_steps=1, grad_compress=wire,
                      opt_state_dtype=opt)
    tt = TrainConfig(total_steps=5, warmup_steps=1, grad_compress=wire,
                     opt_state_dtype=opt)
    js = JS.init_train_state(jp, jt, policy=jlm.cfg.quant.policy())
    ts = _port(js)
    assert set(ts.scales) == {"activation", "grad_edge"}
    jstep = jax.jit(JS.make_train_step(jlm, PLAN, jt))
    tstep = TS.make_train_step(tlm, None, tt)
    jb, tb = _batch()
    for i in range(3):
        js, jm = jstep(js, jb)
        ts, tm = tstep(ts, tb)
        # after an int8 step the params differ by moment codes (below)
        rel = 1e-4 if wire and i else 1e-5
        for k in ("loss", "ce", "prior", "gnorm", "lr"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=rel), k
        assert "health" not in tm and "health" not in jm
        got = _params_close(js, ts, atol=1e-3 if wire else 2e-5,
                            share=0.999 if wire else None)
        for k in ("activation", "grad_edge"):
            assert int(ts.scales[k].log2) == int(js.scales[k].log2), k
            assert float(ts.scales[k].mean_abs) == pytest.approx(
                float(js.scales[k].mean_abs), rel=rel if i else 1e-6), k
        assert int(ts.step) == int(js.step)
    if wire:
        # the residual, what the wire lost: a value within roundoff of a
        # code boundary lands on the neighbouring code, which moves its
        # residual by one code; the wire itself is held exactly by the
        # test below
        assert any(r is not None and r.abs().max() > 0 for r in ts.residual)
        close = total = 0
        for a, b in zip(got.residual, ts.residual):
            assert (a is None) == (b is None)
            if a is not None:
                m = a.abs().max().item()
                e = (a - b).abs()
                assert e.max().item() <= 2.002 * m + 1e-7
                close += int((e <= 1e-2 * m).sum())
                total += a.numel()
        assert close >= 0.99 * total, (close, total)


def test_wire_round_trip_takes_the_stacked_leaves(tiny):
    """``compress_decompress`` on the port's per-layer tree equals the
    reference's on the stacked tree from one state, bit for bit, over two
    calls (the second carries the residual): the per-layer tensors of a
    stacked leaf are flattened together, so the 1,024-wide blocks fall
    where the reference's do (here every layer leaf is shorter than a
    block, so a per-layer round trip would not)."""
    from repro.optim import grad_compress as JG
    from repro_torch.optim import grad_compress as TG
    jlm, jp, _, _ = tiny
    rng = np.random.default_rng(11)
    jres = None
    tres = None
    for _ in range(2):
        jg = _stacked_grads(jp, rng, 0.3)
        tg = _int_to_none(params_from_jax(jax.tree.map(np.asarray, jg),
                                          "cpu"))
        jq, jres = JG.compress_decompress(jg, jres)
        tq, tres = TG.compress_decompress(tg, tres)
        want = params_from_jax(jax.tree.map(np.asarray, jq), "cpu")
        for (p, a), (_, b) in zip(flatten_with_path(want),
                                  flatten_with_path(tq)):
            if b is not None:
                assert torch.equal(a, b), p
        state = JS.TrainState(jp, JA.init_adam(jp, JTrainConfig()),
                              np.zeros((), np.int32), jres)
        got = _port(state)
        assert sum(r is not None for r in tres) == \
            sum(r is not None for r in got.residual)
        for a, b in zip(got.residual, tres):
            if b is not None:
                assert torch.equal(a, b)
    assert TG.wire_nbytes(tg) == JG.wire_nbytes(jg)


def test_grad_accum_one_micro_batch_equals_the_step(tiny):
    """n_micro=1 grad accumulation equals the plain step, the activation
    scales carried too (the reference's PR-2 residual contract)."""
    _, _, tlm, tp = tiny
    tt = TrainConfig(total_steps=5, warmup_steps=1, grad_compress=True)
    s0 = TS.init_train_state(tp, tt, policy=tlm.cfg.quant.policy())
    _, tb = _batch()
    s1, m1 = TS.make_train_step(tlm, None, tt)(s0, tb)
    s2, m2 = TS.make_grad_accum_train_step(tlm, None, tt, 1)(
        s0, {k: v[None] for k, v in tb.items()})
    assert float(m1["loss"]) == float(m2["loss"])
    for (p, a), (_, b) in zip(flatten_with_path(s1), flatten_with_path(s2)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), p


def test_grad_accum_matches_jax(tiny):
    jlm, jp, tlm, _ = tiny
    jt = JTrainConfig(total_steps=5, warmup_steps=1, grad_compress=True)
    tt = TrainConfig(total_steps=5, warmup_steps=1, grad_compress=True)
    js = JS.init_train_state(jp, jt, policy=jlm.cfg.quant.policy())
    ts = _port(js)
    b0, t0 = _batch(seed=0)
    b1, t1 = _batch(seed=1)
    jb = jax.tree.map(lambda a, b: jnp.stack([a, b]), b0, b1)
    tb = {k: torch.stack([t0[k], t1[k]]) for k in t0}
    js, jm = jax.jit(JS.make_grad_accum_train_step(jlm, PLAN, jt, 2))(js, jb)
    ts, tm = TS.make_grad_accum_train_step(tlm, None, tt, 2)(ts, tb)
    for k in ("loss", "gnorm", "lr"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
    _params_close(js, ts, atol=2e-5)
    for k in ("activation", "grad_edge"):
        assert int(ts.scales[k].log2) == int(js.scales[k].log2)
        assert float(ts.scales[k].mean_abs) == pytest.approx(
            float(js.scales[k].mean_abs), rel=1e-5)


def test_grad_accum_advances_activation_without_an_edge(tiny):
    """A state whose scales hold ``activation`` but not ``grad_edge`` (the
    policy passed to ``init_train_state`` demotes ``grad_edge`` from
    managed) runs no activation edge; the reference's accum step still
    advances the ``activation`` scale, on its (1,) zero statistic, and so
    must the port's."""
    import dataclasses
    jlm, jp, tlm, _ = tiny
    jt = JTrainConfig(total_steps=5, warmup_steps=1, grad_compress=True)
    tt = TrainConfig(total_steps=5, warmup_steps=1, grad_compress=True)
    jpol = jlm.cfg.quant.policy()
    jpol = jpol.with_spec("grad_edge", dataclasses.replace(
        jpol.spec_for("grad_edge"), scale_policy="fixed"))
    js = JS.init_train_state(jp, jt, policy=jpol)
    assert set(js.scales) == {"activation"}
    ts = _port(js)
    b0, t0 = _batch(seed=0)
    b1, t1 = _batch(seed=1)
    jb = jax.tree.map(lambda a, b: jnp.stack([a, b]), b0, b1)
    tb = {k: torch.stack([t0[k], t1[k]]) for k in t0}
    js, jm = jax.jit(JS.make_grad_accum_train_step(jlm, PLAN, jt, 2))(js, jb)
    ts, tm = TS.make_grad_accum_train_step(tlm, None, tt, 2)(ts, tb)
    assert float(js.scales["activation"].mean_abs) != pytest.approx(0.2)
    assert int(ts.scales["activation"].log2) == int(
        js.scales["activation"].log2)
    assert float(ts.scales["activation"].mean_abs) == pytest.approx(
        float(js.scales["activation"].mean_abs), rel=1e-6)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    _params_close(js, ts, atol=2e-5)


def _stacked_grads(jp, rng, scale):
    return jax.tree.map(
        lambda a: jnp.asarray(rng.normal(size=a.shape) * scale, a.dtype)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, jp)


@pytest.mark.parametrize("scale", [4.0, 3e-6])
def test_grad_edge_takes_one_step_per_stacked_leaf(tiny, scale):
    """The per-tensor-max step of the reference's stacked leaf: the port
    takes the max over the leaf's per-layer tensors together (one layer's
    norm gradient is 50x the other's here). Scale 4 puts the steps at
    2^-12..2^-9, where XLA's exp2 is exact; 3e-6 at exponents <= -16."""
    jlm, jp, tlm, _ = tiny
    rng = np.random.default_rng(5)
    jg = _stacked_grads(jp, rng, scale)
    jg["layers"]["sub_0"]["norm1"]["scale"] = \
        jg["layers"]["sub_0"]["norm1"]["scale"].at[1].multiply(50.0)
    policy_j = jlm.cfg.quant.policy()
    qj, sj = JS._quantize_grad_edge(jg, policy_j.init_scales(), policy_j)
    tg = _int_to_none(params_from_jax(jax.tree.map(np.asarray, jg), "cpu"))
    policy_t = tlm.cfg.quant.policy()
    qt, st = TS._quantize_grad_edge(tg, policy_t.init_scales("cpu"),
                                    policy_t)
    ref = params_from_jax(jax.tree.map(np.asarray, qj), device="cpu")
    qmax = policy_t.spec_for("grad_edge").qmax
    amax: dict[str, float] = {}
    for p, t in flatten_with_path(tg):
        if t is not None:
            amax[stack_key(p)] = max(amax.get(stack_key(p), 0.0),
                                     t.abs().max().item())
    n_exact = n_inexact = close = total = 0
    for (p, a), (_, b) in zip(flatten_with_path(ref), flatten_with_path(qt)):
        if b is None:
            continue
        m = amax[stack_key(p)]
        k = float(np.ceil(np.log2(max(m, 1e-8) / qmax)))
        e = (a - b).abs()
        if float(jnp.exp2(jnp.float32(k))) == 2.0 ** k:
            n_exact += 1
            assert torch.equal(a, b), p
        else:
            n_inexact += 1
            assert e.max().item() <= 2.0 ** k, p
        close += int((e <= 1e-5 * m).sum())
        total += e.numel()
    assert close >= 0.99 * total, (close, total)
    assert (n_exact > 0) if scale > 1 else (n_inexact > 0)
    assert int(st["grad_edge"].log2) == int(sj["grad_edge"].log2)
    assert float(st["grad_edge"].mean_abs) == pytest.approx(
        float(sj["grad_edge"].mean_abs), rel=1e-5)


def _int_to_none(tree):
    """JAX's float0 gradients of the integer leaves as the port's None."""
    from repro_torch.tree import unflatten
    return unflatten(tree, [t if t.is_floating_point() else None
                            for _, t in flatten_with_path(tree)])


def test_byte_table_and_param_counts_equal_jax(tiny):
    jlm, jp, tlm, _ = tiny
    jt = JTrainConfig(total_steps=5, warmup_steps=1, grad_compress=True,
                      opt_state_dtype="int8")
    js = JS.init_train_state(jp, jt, policy=jlm.cfg.quant.policy())
    ts = _port(js)
    assert TS.train_state_sites(ts) == JS.train_state_sites(js)
    tt = TrainConfig(total_steps=5, warmup_steps=1, grad_compress=True,
                     opt_state_dtype="int8")
    fresh = TS.init_train_state(ts.params, tt,
                                policy=tlm.cfg.quant.policy())
    assert TS.train_state_sites(fresh) == JS.train_state_sites(js)
    assert TL.lm_param_counts(ts.params, tlm) == JL.lm_param_counts(jp, jlm)
    # after pruning: λ of one site and layer collapsed to two live ranks
    jq = jax.tree.map(lambda a: a, jp)
    lam = jq["layers"]["sub_0"]["ffn"]["up"]["lambda_1"]
    jq["layers"]["sub_0"]["ffn"]["up"]["lambda_1"] = lam.at[1, 2:].set(0.0)
    tq = params_from_jax(jax.tree.map(np.asarray, jq), device="cpu")
    tc, jc = TL.lm_param_counts(tq, tlm), JL.lm_param_counts(jq, jlm)
    assert tc == jc and tc["live"] < tc["tt"]


def test_lm_train_state_from_jax_slices_stacked_moments(tiny):
    """A stacked int8 moment is its per-layer slices: the blockwise codec
    blocks along the last axis only, so the per-layer leaf's own encoding
    equals the stacked leaf's rows, codes and scales."""
    from repro import numerics as JN
    from repro_torch import numerics as TN
    jlm, jp, _, _ = tiny
    jt = JTrainConfig(opt_state_dtype="int8", grad_compress=True)
    js = JS.init_train_state(jp, jt, policy=jlm.cfg.quant.policy())
    rng = np.random.default_rng(7)
    paths = [JA._path_str(kp) for kp, _ in
             jax.tree_util.tree_flatten_with_path(jp)[0]]
    m = list(js.opt.m)
    for k, (path, leaf) in enumerate(zip(
            paths, jax.tree_util.tree_leaves(jp))):
        if m[k] is not None:
            m[k] = JN.encode(jnp.asarray(rng.normal(size=leaf.shape),
                                         jnp.float32), JA.MOMENT_SPEC)
    js = js._replace(opt=js.opt._replace(m=tuple(m)))
    ts = _port(js)
    tpaths = [p for p, _ in flatten_with_path(ts.params)]
    assert len(ts.opt.m) == len(tpaths) > len(m)
    k = paths.index("layers/sub_0/ffn/down/core_1")
    stacked = m[k]
    assert stacked.codes.shape[0] == 2
    for layer in range(2):
        i = tpaths.index(f"layers/{layer}/sub_0/ffn/down/core_1")
        got = ts.opt.m[i]
        assert got.shape == stacked.shape[1:]
        np.testing.assert_array_equal(got.codes.numpy(),
                                      np.asarray(stacked.codes)[layer])
        np.testing.assert_array_equal(got.scale.numpy(),
                                      np.asarray(stacked.scale)[layer])
        # the per-layer tensor's own encoding is that slice
        dec = np.asarray(JN.decode(stacked))[layer]
        own = TN.encode(torch.from_numpy(np.array(dec)), TA.MOMENT_SPEC)
        np.testing.assert_array_equal(own.codes.numpy(), got.codes.numpy())
        np.testing.assert_array_equal(own.scale.numpy(), got.scale.numpy())
    i = tpaths.index("head/w")
    np.testing.assert_array_equal(ts.opt.m[i].codes.numpy(),
                                  np.asarray(m[paths.index("head/w")].codes))
    assert ts.opt.m[tpaths.index("layers/0/sub_0/ffn/down/lambda_0")] is None


def test_lm_batch_is_the_reference_bit_for_bit():
    for kw in (dict(step=0, batch=8, seq=256, vocab=92544, seed=0),
               dict(step=3, batch=4, seq=17, vocab=64, shard=1,
                    num_shards=2, seed=9)):
        a, b = t_lm_batch(**kw), j_lm_batch(**kw)
        assert set(a) == set(b) == {"tokens", "labels"}
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])


def test_lr_schedule_and_clipping_match_jax():
    for cfg in (dict(learning_rate=3e-4, warmup_steps=5, total_steps=8),
                dict(learning_rate=1e-3, warmup_steps=0, total_steps=1)):
        jc, tc = JTrainConfig(**cfg), TrainConfig(**cfg)
        for step in range(0, 12):
            assert float(t_lr_at(torch.tensor(step, dtype=torch.int32),
                                 tc)) == float(j_lr_at(jnp.int32(step), jc))
    rng = np.random.default_rng(2)
    tree = {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": {"c": rng.normal(size=(5,)).astype(np.float32)}}
    for max_norm in (0.5, 100.0):
        gj, nj = JA.clip_by_global_norm(jax.tree.map(jnp.asarray, tree),
                                        max_norm)
        gt, nt = TA.clip_by_global_norm(
            {"a": torch.from_numpy(tree["a"]),
             "b": {"c": torch.from_numpy(tree["b"]["c"])},
             "i": None}, max_norm)
        assert float(nt) == pytest.approx(float(nj), rel=1e-6)
        np.testing.assert_allclose(_np(gt["a"]), np.asarray(gj["a"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(_np(gt["b"]["c"]), np.asarray(gj["b"]["c"]),
                                   rtol=1e-6)
        assert gt["i"] is None


def test_init_and_update_scales_match_jax():
    jpol = JQuantConfig(enable=True).policy()
    tpol = QuantConfig(enable=True).policy()
    js, ts = jpol.init_scales(), tpol.init_scales("cpu")
    assert list(js) == list(ts) == ["activation", "grad_edge"]
    rng = np.random.default_rng(3)
    for i in range(12):
        x = (rng.normal(size=(4, 8)) * 4.0 ** (i % 4 - 1)).astype(np.float32)
        js = jpol.update_scales(js, {"activation": jnp.asarray(x),
                                     "unknown": jnp.asarray(x)})
        ts = tpol.update_scales(ts, {"activation": torch.from_numpy(x),
                                     "unknown": torch.from_numpy(x)})
        assert set(ts) == {"activation", "grad_edge"}
        for k in ts:
            assert int(ts[k].log2) == int(js[k].log2)
            assert float(ts[k].mean_abs) == pytest.approx(
                float(js[k].mean_abs), rel=1e-6)
    assert isinstance(js["activation"], JScaleState)


def _count_launches(monkeypatch):
    """Count the launches each kernel wrapper would make on the card, from
    its CPU calls: one per PE call, and a group call's launches from the
    group plans."""
    counts: dict[str, int] = {}

    def bump(name, n=1):
        counts[name] = counts.get(name, 0) + n

    for mod, name in ((ttm_pe1, "pe1"), (ttm_pe2, "pe2"), (ttm_pe3, "pe3")):
        fn = getattr(mod, f"{name}_torch")

        def wrapped(*a, _fn=fn, _name=name, **k):
            bump(_name)
            return _fn(*a, **k)
        monkeypatch.setattr(mod, f"{name}_torch", wrapped)
    one, many = CB.fake_quant_scalar, CB.fake_quant_scalar_many

    def fq_one(*a, **k):
        bump("p2_fake_quant")
        return one(*a, **k)

    def fq_many(xs, *a, **k):
        bump("p2_fake_quant", len(G.fq_plan([x.numel() for x in xs])))
        return many(xs, *a, **k)
    enc, dec = CB.bw_encode_many, CB.bw_decode_many

    def bw_enc(xs, *a, **k):
        bump("bw_enc", len(G.chunks(len(xs), G.BW_CAP)))
        return enc(xs, *a, **k)

    def bw_dec(codes, *a, **k):
        bump("bw_dec", len(G.chunks(len(codes), G.BW_CAP)))
        return dec(codes, *a, **k)
    monkeypatch.setattr(CB, "fake_quant_scalar", fq_one)
    monkeypatch.setattr(CB, "fake_quant_scalar_many", fq_many)
    monkeypatch.setattr(CB, "bw_encode_many", bw_enc)
    monkeypatch.setattr(CB, "bw_decode_many", bw_dec)
    return counts


@pytest.mark.parametrize("remat", ["full", "none"])
def test_launches_per_step_counts_the_step(monkeypatch, remat):
    """``steps.launches_per_step`` (the chip smoke's exact launch check) is
    the count of a real step's kernel calls, remat recompute, activation
    and grad edges and the group plans' chunking included."""
    _, tcfg = _configs(remat=remat)
    lm = TL.build_lm(tcfg)
    params = TL.init_lm(torch.Generator().manual_seed(0), lm, device="cpu")
    tt = TrainConfig(total_steps=5, warmup_steps=1, grad_compress=True,
                     opt_state_dtype="int8")
    state = TS.init_train_state(params, tt, policy=tcfg.quant.policy())
    step = TS.make_train_step(lm, None, tt)
    _, tb = _batch()
    counts = _count_launches(monkeypatch)
    step(state, tb)
    want = TS.launches_per_step(lm, tt, params)
    assert counts == want
    assert want == TS.launches_per_step(lm, tt)       # from the meta tree
    fwd = 2 if remat == "full" else 1
    assert want["pe1"] == 6 * 2 * (fwd + 1) and want["pe3"] == 12
    # 86 moments and 67 f32 gradients: two launches each by the caps
    assert want["bw_dec"] == want["bw_enc"] == 2 + 1
    assert want["p2_fake_quant"] == 12 * fwd + 2 + 2 * (fwd + 1) + 2


def test_launches_per_step_at_the_chip_smoke_config():
    """The full-size count, from the meta tree (no weights): 144 TT sites,
    remat recompute, 483 Adam leaves, 35 wire leaves, bf16 and f32
    gradient groups."""
    from repro_torch import configs as C
    cfg = C.with_tt(C.get_config("internlm2-1.8b"), quantize=True)
    lm = TL.build_lm(cfg)
    assert sum(s.use_tt for _, s in TL._walk_sites(lm)) * 24 == 144
    tt = TrainConfig(opt_state_dtype="int8", grad_compress=True)
    want = TS.launches_per_step(lm, tt)
    assert want == {"pe1": 144 * 3, "pe2": 144 * 6, "pe3": 144,
                    "p2_fake_quant": 144 * 2 + 2 + 24 * 3 + 7 + 6,
                    "bw_dec": 21 + 1, "bw_enc": 21 + 1}


def test_train_main_reaches_tt_sites_on_the_cpu(capsys, tmp_path):
    """The CPU example the README gives: lm100m with --tt reaches TT sites
    (the reduced internlm2's projections are all under min_elements)."""
    from repro_torch import configs as C
    cfg, _ = TT.get_model_cfg("lm100m", False)
    lm = TL.build_lm(C.with_tt(cfg, max_rank=32))
    assert sum(s.use_tt for _, s in TL._walk_sites(lm)) == 6
    red, _ = TT.get_model_cfg("internlm2-1.8b", True)
    assert not any(s.use_tt for _, s in TL._walk_sites(TL.build_lm(
        C.with_tt(red, max_rank=32))))
    try:              # the final save holds lm100m's dense embedding
        TT.main(["--arch", "lm100m", "--tt", "--quantize", "--steps", "1",
                 "--batch", "1", "--seq", "8", "--device", "cpu",
                 "--ckpt-dir", str(tmp_path / "ckpt")])
    finally:
        shutil.rmtree(tmp_path / "ckpt", ignore_errors=True)
    out = capsys.readouterr().out
    assert "[train] step 0 loss" in out and "compression" in out


def test_train_entry_point_runs_on_the_cpu(capsys, tmp_path):
    jcfg, tcfg = _configs(remat="full")
    tt = TrainConfig(total_steps=2, warmup_steps=1, log_every=1,
                     opt_state_dtype="int8", grad_compress=True,
                     ckpt_dir=str(tmp_path / "a"))
    seen = []
    state, losses = TT.train(tcfg, "tp", tt, batch=2, seq=8, device="cpu",
                             on_step=lambda i, m: seen.append((i, m["ce"])))
    out = capsys.readouterr().out
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert [i for i, _ in seen] == [0, 1]
    assert "[train] step 1 loss" in out and "compression" in out
    assert int(state.step) == 2
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        TT.train(tcfg, "tp", tt, batch=2, seq=8, device="cpu",
                 mesh=object())
    with pytest.raises(NotImplementedError, match="item 8"):
        TS.make_train_step(TL.build_lm(tcfg), SimpleNamespace(mesh=object()),
                           tt)
    # the trace, the ledger and quant health are ported
    # (tests/test_torch_ledger.py holds them to the reference)
    from repro_torch.obs import MemoryLedger, TraceRecorder
    rec, led = TraceRecorder(), MemoryLedger()
    one = TrainConfig(total_steps=1, warmup_steps=1, log_every=1,
                      ckpt_dir=str(tmp_path / "b"))
    TT.train(tcfg, "tp", one, batch=2, seq=8, device="cpu", trace=rec,
             ledger=led, verbose=False)
    assert len(rec.events("train_step")) == 1
    assert led.watermark("train_step")["total_bytes"] > 0
    health = tcfg.replace(quant=QuantConfig(enable=True, health=True))
    hs = TS.make_train_step(TL.build_lm(health), None, tt)
    _, m = hs(state, {k: v[:, :8] for k, v in _batch()[1].items()})
    assert {"grad_edge", "activation"} <= set(m["health"])
