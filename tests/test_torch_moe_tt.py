"""TT "expert" sites of the port (E experts stacked on a leading axis, the
reference's vmapped ``init_site``) on the CPU, where no kernel runs:

- the grouped plain twins (``pe1_torch`` / ``pe2_torch`` / ``pe3_torch``
  with a leading E) against a loop of the ungrouped twins, and the grouped
  chain (``ttm_matvec_pe`` on stacked cores) against JAX's vmapped
  ``ttm_matvec``;
- stacked rank masks, prior and λ update against the reference's
  ``site_prior_loss`` / ``site_lambda_update`` on ``(E, ...)`` params, the
  experts' λ maxima apart, so one max over all experts would fail;
- the stacked cores' fake-quant (one row launch a core, a step an expert)
  and ``moe_forward``'s gradients with TT experts against ``jax.grad``;
- ``TTMatvec``'s backward with Ŵ taken a window of experts at a time
  (``ttm.what_windows``) equal to the one-window backward;
- the grouped launch plans at the experts' calls of with_tt(moonshot),
  with_tt(deepseek) at 2 x 256 tokens and jamba's period at 1 x 512: every
  bf16 call on the tensor cores, one group's plan that of the ungrouped
  call but its grid (``tt_mma.group_grid``), the granules with the
  groups' strides;
- a plain mirror of the grouped tile walk (each group's CTAs over its own
  tiles, the TMA's zero fill per group, rows per expert not a tile
  multiple) against ``pe*_torch``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.ttm as JTTM  # noqa: E402
import repro.models.common as JCM  # noqa: E402
import repro.models.moe as JM  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.configs.base import MoEConfig as JMoE  # noqa: E402
from repro.configs.base import QuantConfig as JQuantConfig  # noqa: E402
from repro.configs.base import TTConfig as JTTConfig  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.configs.base import ModelConfig, MoEConfig  # noqa: E402
from repro_torch.configs.base import QuantConfig, TTConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import rank_adapt as RA  # noqa: E402
from repro_torch.core import tt_layer as TTL  # noqa: E402
from repro_torch.core import ttm as TTM  # noqa: E402
from repro_torch.kernels import ops, tt_contract, tt_mma, ttm_pe1  # noqa: E402
from repro_torch.kernels import ttm_pe2, ttm_pe3  # noqa: E402
from repro_torch.models import common as TCM  # noqa: E402
from repro_torch.models import lm as TL  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402

from test_torch_pe1_mma import _mirror as _pe1_mirror  # noqa: E402
from test_torch_pe_mma import _mirror as _pe2_mirror  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale
            ).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# the grouped plain twins and chain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,zs,gs", [
    ("pe1", (5, 24, 1, 6), (5, 1, 12, 6)),
    ("pe1", (3, 7, 2, 5), (3, 2, 4, 5)),
    ("pe2", (5, 12, 8, 6), (5, 8, 10)),
    ("pe3", (4, 9, 12), (4, 9, 7)),
])
def test_grouped_twins_are_the_loop_of_ungrouped(kind, zs, gs):
    z, g = _t(_rand(zs, 1)), _t(_rand(gs, 2))
    twin = {"pe1": ttm_pe1.pe1_torch, "pe2": ttm_pe2.pe2_torch,
            "pe3": ttm_pe3.pe3_torch}[kind]
    got = twin(z, g)
    want = torch.stack([twin(z[e], g[e]) for e in range(zs[0])])
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    # the public entry points route CPU tensors to the twins, grouped too
    np.testing.assert_allclose(getattr(ops, kind)(z, g).numpy(),
                               want.numpy(), **TOL)


def test_grouped_shapes_are_checked():
    with pytest.raises(ValueError):
        ttm_pe2.pe2_torch(torch.zeros(2, 3, 4, 5), torch.zeros(3, 4, 6))
    with pytest.raises(ValueError):
        ttm_pe3.pe3_torch(torch.zeros(2, 3, 4), torch.zeros(3, 3, 4))
    with pytest.raises(ValueError):
        ttm_pe1.pe1_torch(torch.zeros(2, 3, 1, 4), torch.zeros(3, 1, 5, 4))


@pytest.mark.parametrize("out_dim,in_dim,rank", [(96, 64, 4), (64, 96, 3),
                                                 (48, 120, 5)])
def test_grouped_chain_matches_vmapped_jax(out_dim, in_dim, rank):
    """``ttm_matvec_pe`` on stacked cores (E, ...) and x (E, C, in): every
    PE call grouped, the result JAX's ``vmap(ttm_matvec)``."""
    spec = TTM.make_spec(out_dim, in_dim, 3, rank)
    e, c = 4, 6
    cores = [_rand((e,) + s, 10 + n, 0.3)
             for n, s in enumerate(spec.core_shapes)]
    x = _rand((e, c, in_dim), 3)
    seen = []

    def rec(fn, kind):
        def f(z, g):
            seen.append((kind, tuple(z.shape), tuple(g.shape)))
            return fn(z, g)
        return f
    got = TTM.ttm_matvec_pe([_t(a) for a in cores], _t(x), spec,
                            pe1=rec(ttm_pe1.pe1_torch, "pe1"),
                            pe2=rec(ttm_pe2.pe2_torch, "pe2"))
    jspec = JTTM.TTMSpec(spec.j_dims, spec.i_dims, spec.ranks)
    want = jax.vmap(lambda cs, xx: JTTM.ttm_matvec(cs, xx, jspec))(
        [jnp.asarray(a) for a in cores], jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert all(z[0] == g[0] == e for _, z, g in seen)
    assert seen == TTM.pe_shapes(spec, c, groups=e)
    assert [(k, z[1:], g[1:]) for k, z, g in seen] == TTM.pe_shapes(spec, c)


# ---------------------------------------------------------------------------
# stacked rank adaptation against the reference's site functions
# ---------------------------------------------------------------------------

def _stacked_site(seed=0, e=4):
    """A stacked TT site's params (E experts) whose λ maxima differ by
    expert (expert k's λ scaled by 100^k: under one max over all experts,
    every slice of experts 0 and 1 would be pruned and floored), and one
    slice of expert 0 under the prune threshold of its own max."""
    tt = TTConfig(enable=True, d=3, max_rank=4, min_elements=1,
                  apply_to=("expert",))
    cfg = ModelConfig(name="m", d_model=32, d_ff=48, tt=tt, dtype="float32",
                      quant=QuantConfig(enable=True),
                      moe=MoEConfig(num_experts=e, top_k=2))
    site = TCM.make_site(cfg, "expert", 48, 32)
    p = TM._init_stack(torch.Generator().manual_seed(seed), site, e, cfg,
                       torch.device("cpu"))
    rng = np.random.RandomState(seed)
    for n in range(site.spec.d - 1):
        lam = rng.uniform(0.5, 1.5, (e, site.spec.ranks[n + 1]))
        lam = lam * (100.0 ** np.arange(e))[:, None]
        lam[0, 0] = 1e-4        # under 1e-3 of expert 0's own max
        p[f"lambda_{n}"] = _t(lam.astype(np.float32))
    jtt = JTTConfig(enable=True, d=3, max_rank=4, min_elements=1,
                    apply_to=("expert",))
    jcfg = JModelConfig(name="m", d_model=32, d_ff=48, tt=jtt,
                        dtype="float32",
                        quant=JQuantConfig(enable=True),
                        moe=JMoE(num_experts=e, top_k=2))
    return cfg, site, p, jcfg, JCM.make_site(jcfg, "expert", 48, 32)


def test_stacked_rank_masks_are_per_expert():
    cfg, site, p, _, _ = _stacked_site()
    th = cfg.tt.prune_threshold
    lams = TTL.get_lambdas(p, site.spec)
    masks = RA.rank_masks(lams, th)
    for lam, m in zip(lams, masks):
        for k in range(lam.shape[0]):
            assert torch.equal(m[k], RA.rank_masks([lam[k]], th)[0])
    assert masks[0][0, 0] == 0              # pruned by expert 0's own max
    assert masks[0][0, 1:].all() and masks[0][1:].all()
    # one max over all experts would prune all of expert 0's slices
    assert not (lams[0][0] > th * lams[0].max()).any()
    # the reference's vmapped effective cores: each expert's mask
    cores = RA.apply_masks(TTL.get_cores(p, site.spec), masks)
    jc = jax.vmap(lambda pp: JCM.TL.effective_cores(
        pp, JTTM.TTMSpec(site.spec.j_dims, site.spec.i_dims,
                         site.spec.ranks),
        JTTConfig(enable=True, d=3, max_rank=4), JQuantConfig()))(
        {k: jnp.asarray(v.numpy()) for k, v in p.items()})
    for a, b in zip(cores, jc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_stacked_prior_and_lambda_update_match_jax():
    cfg, site, p, jcfg, jsite = _stacked_site(seed=3)
    jp = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    got = TCM.site_prior_loss(p, site, cfg)
    want = JCM.site_prior_loss(jp, jsite, jcfg)
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    # one max over all experts would floor other λ
    lam = p["lambda_0"]
    assert not torch.equal(RA._prior_floor(lam),
                           RA._prior_floor(lam.reshape(-1)).reshape(lam.shape))
    new = TCM.site_lambda_update(p, site, cfg)
    jnew = JCM.site_lambda_update(jp, jsite, jcfg)
    for n in range(2):
        np.testing.assert_allclose(new[f"lambda_{n}"].numpy(),
                                   np.asarray(jnew[f"lambda_{n}"]),
                                   rtol=1e-6)
        assert new[f"lambda_{n}"].shape == (4, site.spec.ranks[n + 1])


def test_stacked_prior_floor_is_per_expert():
    """The prior's relative floor: max(PRIOR_REL_FLOOR · max λ, floor) of
    each expert's row, not of all rows."""
    lam = torch.tensor([[1e-4, 1.0], [1e-4, 100.0]])
    got = RA._prior_floor(lam)
    want = torch.stack([RA._prior_floor(lam[0]), RA._prior_floor(lam[1])])
    assert torch.equal(got, want)
    assert got[0, 0] == pytest.approx(RA.PRIOR_REL_FLOOR)


# ---------------------------------------------------------------------------
# the fake-quant of stacked cores, moe_forward's gradients
# ---------------------------------------------------------------------------

def test_stacked_cores_fake_quant_is_one_row_call_a_core(monkeypatch):
    """``effective_cores`` of a stacked site: each core through
    ``fake_quant_rows`` once under its E steps (the row kernel's launch on
    the card), values and the clipped STE's gradient the reference's vmap
    of a scalar-step fake-quant."""
    from repro_torch.numerics import cuda_backend as CB
    cfg, site, p, jcfg, jsite = _stacked_site(seed=5)
    p["wscale_log2"] = _t(np.array([[-3, -2, -4], [-2, -2, -3],
                                    [-5, -3, -2], [-1, -4, -3]], np.int32))
    calls = []
    rows = CB.fake_quant_rows
    monkeypatch.setattr(CB, "fake_quant_rows",
                        lambda x, s, b: calls.append(tuple(x.shape)) or
                        rows(x, s, b))
    leaves = {k: v.clone().requires_grad_(v.is_floating_point())
              for k, v in p.items()}
    cores = TTL.effective_cores(leaves, site.spec, cfg.tt, cfg.quant)
    assert calls == [tuple(c.shape) for c in cores]
    w = [_rand(tuple(c.shape), 20 + n) for n, c in enumerate(cores)]
    sum(torch.sum(c * _t(x)) for c, x in zip(cores, w)).backward()
    jspec = JTTM.TTMSpec(site.spec.j_dims, site.spec.i_dims, site.spec.ranks)
    jp = {k: jnp.asarray(v.numpy()) for k, v in p.items()}

    def f(pp):
        cs = jax.vmap(lambda q: JCM.TL.effective_cores(
            q, jspec, jcfg.tt, jcfg.quant))(pp)
        return sum(jnp.sum(c * jnp.asarray(x)) for c, x in zip(cs, w)), cs
    (_, jcores), jg = jax.value_and_grad(f, has_aux=True, allow_int=True)(jp)
    for a, b in zip(cores, jcores):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    for n in range(site.spec.d):
        np.testing.assert_allclose(leaves[f"core_{n}"].grad.numpy(),
                                   np.asarray(jg[f"core_{n}"]), **TOL)


def _moe_pair(shared=0, quant=True):
    kw = dict(name="m", d_model=64, d_ff=96, dtype="float32")
    tt = dict(enable=True, d=3, max_rank=4, min_elements=1024,
              apply_to=("ffn", "expert"))
    jcfg = JModelConfig(**kw, tt=JTTConfig(**tt),
                        quant=JQuantConfig(enable=quant),
                        moe=JMoE(num_experts=4, top_k=2, num_shared=shared))
    tcfg = ModelConfig(**kw, tt=TTConfig(**tt),
                       quant=QuantConfig(enable=quant),
                       moe=MoEConfig(num_experts=4, top_k=2,
                                     num_shared=shared))
    jd, td = JM.make_moe(jcfg), TM.make_moe(tcfg)
    assert td.gate.use_tt and td.down.use_tt
    jp = jax.jit(lambda k: JM.init_moe(k, jd, jcfg))(jax.random.PRNGKey(1))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    assert tp["gate"]["core_1"].shape[0] == 4
    assert tp["gate"]["wscale_log2"].shape == (4, 3)
    return jcfg, jd, jp, tcfg, td, tp


@pytest.mark.parametrize("shared,quant", [(1, True), (0, False)])
def test_moe_forward_and_gradients_with_tt_experts_match_jax(shared, quant):
    jcfg, jd, jp, tcfg, td, tp = _moe_pair(shared, quant)
    x = _rand((2, 12, 64), 7)
    m = np.ones((2, 12), bool)
    m[1, 9:] = False

    def jloss(p, xx):
        out, aux = JM.moe_forward(p, xx, jd, jcfg, token_mask=jnp.asarray(m))
        return jnp.sum(out ** 2) + 0.01 * aux, out

    (jl, jo), (jg, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True, allow_int=True))(
        jp, jnp.asarray(x))
    leaves = jax.tree.map(lambda t: t.requires_grad_(t.is_floating_point()),
                          tp)
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = TM.moe_forward(leaves, tx, td, tcfg,
                              token_mask=torch.from_numpy(m))
    loss = torch.sum(out ** 2) + 0.01 * aux
    loss.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jo), **TOL)
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **TOL)
    for path, g in jax.tree_util.tree_leaves_with_path(jg):
        name = jax.tree_util.keystr(path)
        t = leaves
        for k in path:
            t = t[k.key]
        if not t.is_floating_point() or "lambda" in name:
            continue
        assert float(np.abs(np.asarray(g)).max()) > 0, name
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TOL,
                                   err_msg=name)


def test_windowed_what_equals_one_window(monkeypatch):
    """Ŵ a window of experts at a time (``WHAT_CAP`` cut to two experts'
    J x I): the same core and input gradients, three PE3 calls for 5
    experts instead of one."""
    spec = TTM.make_spec(48, 32, 3, 4)
    e, c = 5, 6
    cores = [_t(_rand((e,) + s, 30 + n, 0.3)) for n, s in
             enumerate(spec.core_shapes)]
    x = _t(_rand((e, c, 32), 4))
    ybar = _t(_rand((e, c, 48), 5))

    def grads():
        cs = [a.clone().requires_grad_() for a in cores]
        xx = x.clone().requires_grad_()
        TTM.tt_matvec(cs, xx, spec).backward(ybar)
        return [a.grad for a in cs] + [xx.grad]
    calls = []
    pe3 = ttm_pe3.pe3_torch
    monkeypatch.setattr(ttm_pe3, "pe3_torch",
                        lambda a, b: calls.append(a.shape[0]) or pe3(a, b))
    whole = grads()
    assert calls == [5]
    monkeypatch.setattr(TTM, "WHAT_CAP", 2 * 48 * 32)
    assert TTM.what_windows(spec, e) == [(0, 2), (2, 4), (4, 5)]
    windowed = grads()
    assert calls == [5, 2, 2, 1]
    for a, b in zip(whole, windowed):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
    # each window's core gradients those of its experts alone
    loop = []
    for k in range(e):
        cs = [a[k].clone().requires_grad_() for a in cores]
        TTM.tt_matvec(cs, x[k], spec).backward(ybar[k])
        loop.append([a.grad for a in cs])
    for n in range(3):
        np.testing.assert_allclose(
            whole[n].numpy(), torch.stack([g[n] for g in loop]).numpy(),
            **TOL)


# ---------------------------------------------------------------------------
# the grouped plans at the experts' calls
# ---------------------------------------------------------------------------

def _expert_calls(arch, layers, tokens):
    """(E, kind, Z shape, G shape) of every grouped PE call of ``arch``'s
    TT expert sites a step at ``tokens`` tokens: the forward and the
    transposed chain at the capacity's C rows an expert, and PE3's Ŵ."""
    cfg = TC.get_config(arch)
    if layers:
        cfg = cfg.replace(num_layers=layers, period=layers,
                          attn_positions=(1,), moe_positions=(1,))
    lm = TL.build_lm(TC.with_tt(cfg, quantize=True))
    d = next(s.ffn for s in lm.period if s.ffn_kind == "moe")
    cap = TM._capacity(tokens, d)
    out = set()
    for site in (d.gate, d.up, d.down):
        s = site.spec
        for sp in (s, s.transposed()):
            for kind, zs, gs in TTM.pe_shapes(sp, cap, groups=d.num_experts):
                out.add((kind, zs, gs))
        for e0, e1 in TTM.what_windows(s, d.num_experts):
            out.add(("pe3", (e1 - e0, cap, s.out_dim),
                     (e1 - e0, cap, s.in_dim)))
    return d.num_experts, cap, sorted(out)


def _plan(kind, zs, gs, elsize=2):
    e = zs[0]
    if kind == "pe1":
        _, a, b, c = zs
        return ttm_pe1.plan_pe1(a, b, c, gs[2], elsize, groups=e)
    if kind == "pe2":
        _, a, b, c = zs
        return tt_mma.plan(a, b, c, gs[2], elsize, groups=e)
    _, b, j = zs
    return tt_mma.plan(1, b, gs[2], j, elsize, groups=e)


CELLS = {"moonshot": ("moonshot-v1-16b", None, 8 * 256, 64, 240),
         "deepseek": ("deepseek-v2-236b", None, 2 * 256, 160, 24),
         "jamba": ("jamba-1.5-large", 3, 512, 16, 80)}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_expert_calls_take_the_tensor_cores_grouped(cell):
    arch, layers, tokens, e, cap = CELLS[cell]
    got_e, got_cap, calls = _expert_calls(arch, layers, tokens)
    assert (got_e, got_cap) == (e, cap)
    for kind, zs, gs in calls:
        p = _plan(kind, zs, gs)
        assert p is not None, (kind, zs, gs)
        groups = zs[0]
        one = (ttm_pe1.plan_pe1(*zs[1:], gs[2], 2) if kind == "pe1" else
               tt_mma.plan(*zs[1:], gs[2], 2) if kind == "pe2" else
               tt_mma.plan(1, zs[1], gs[2], zs[2], 2))
        # one group's plan is the ungrouped call's but its grid
        assert dataclasses.replace(p, grid=one.grid) == one
        assert p.grid == tt_mma.group_grid(p.tiles, groups)
        assert p.grid * min(groups, tt_mma.SMS) <= max(tt_mma.SMS, groups) \
            or p.grid == 1
        # each group's tensors under 2^31 elements, the whole call too
        # (tt_contract.check_sizes)
        if kind == "pe3":
            assert groups * zs[2] * gs[2] < 2 ** 31


def test_moonshot_and_deepseek_expert_calls():
    """The forward and dx calls of moonshot's gate (64 experts, C = 240)."""
    _, _, calls = _expert_calls("moonshot-v1-16b", None, 8 * 256)
    assert ("pe1", (64, 30720, 1, 16), (64, 1, 256, 16)) in calls
    assert ("pe2", (64, 1920, 256, 16), (64, 256, 176)) in calls
    assert ("pe2", (64, 240, 128, 176), (64, 128, 8)) in calls
    assert ("pe1", (64, 21120, 1, 16), (64, 1, 256, 16)) in calls
    assert ("pe3", (64, 240, 1408), (64, 240, 2048)) in calls
    _, _, calls = _expert_calls("deepseek-v2-236b", None, 2 * 256)
    assert ("pe1", (160, 6144, 1, 20), (160, 1, 256, 20)) in calls
    # c = 20: Z's rows on granules (40 bytes), the groups' strides too
    p = _plan("pe1", (160, 6144, 1, 20), (160, 1, 256, 20))
    assert p.gran == 8


def test_group_strides_pick_the_granule():
    """A group's start off 16 bytes narrows the granule: Z (E, a, 1, c) of
    c = 20, a = 3 (120 bytes a group) takes 8-byte granules."""
    one = ttm_pe1.plan_pe1(4, 1, 20, 16, 2)
    assert one.gran == 8
    assert ttm_pe1.plan_pe1(3, 1, 20, 16, 2, groups=2).gran == 8
    assert ttm_pe1.plan_pe1(3, 1, 10, 16, 2, groups=2).gran == 4
    # the CUDA-core routes: f32 rows of 5 (20 bytes): 4-byte granules
    assert ttm_pe1.plan(3, 1, 5, 16, 4, groups=2).gz == 4
    assert tt_contract.plan(3, 4, 6, 8, 2, groups=2).gz <= 4


def test_f32_grouped_calls_take_the_streamed_route():
    """The tile route takes no group: f32 grouped calls of any size go to
    ``tt_contract`` (its plan fills the SMs over all the groups)."""
    from repro_torch.kernels import tt_tile
    z = torch.empty((16, 64, 512, 32), device="meta")
    g = torch.empty((16, 512, 512), device="meta")
    assert tt_tile.plan_for(z, g) is None
    p1 = tt_contract.plan(8, 64, 16, 16, 4)
    p16 = tt_contract.plan(8, 64, 16, 16, 4, groups=16)
    assert p16.grid <= p1.grid


# ---------------------------------------------------------------------------
# the plain mirror of the grouped tile walk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,e,shape", [
    ("pe2", 3, (10, 64, 16, 176)),      # 10 slabs: 4 a tile, 2 short
    ("pe2", 2, (7, 96, 176, 8)),        # thin: d = 8 of 64 rows
    ("pe3", 3, (1, 80, 256, 200)),      # K = 80: 64 + 16 zero-filled rows
    ("pe1", 3, (200, 1, 16, 256)),      # a = 200: 72 rows of the last tile
])
def test_grouped_tile_walk_mirror(kind, e, shape):
    """Each group's CTAs (``p.grid`` of them, blockIdx.y the group) walk
    that group's tiles from its own operands, zero past its own edges: the
    grouped output is the per-group mirror, within 1e-5 of the grouped
    twin."""
    a, b, c, d = shape
    if kind == "pe1":
        z, g = _t(_rand((e, a, b, c), 1)), _t(_rand((e, b, d, c), 2, 0.2))
        p = ttm_pe1.plan_pe1(a, b, c, d, 2, groups=e)
        got = torch.stack([_pe1_mirror(z[k], g[k], p) for k in range(e)])
        want = ttm_pe1.pe1_torch(z, g)
    elif kind == "pe2":
        z, g = _t(_rand((e, a, b, c), 1)), _t(_rand((e, b, d), 2, 0.2))
        p = tt_mma.plan(a, b, c, d, 2, groups=e)
        got = torch.stack([_pe2_mirror(z[k], g[k], p) for k in range(e)])
        want = ttm_pe2.pe2_torch(z, g)
    else:
        x, y = _t(_rand((e, b, c), 1)), _t(_rand((e, b, d), 2, 0.2))
        p = tt_mma.plan(1, b, c, d, 2, groups=e)
        got = torch.stack([_pe2_mirror(x[k][None], y[k], p)[0]
                           for k in range(e)])
        want = ttm_pe3.pe3_torch(y, x)
    assert p is not None and p.grid == tt_mma.group_grid(p.tiles, e)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_param_counts_with_tt_experts_match_the_reference():
    """``lm_param_counts`` of reduced moonshot with TT experts, from the
    reference's seeded init carried over: dense, TT and live counts as the
    reference counts them (a stacked expert site's live ranks summed over
    its experts under one max, as there)."""
    import repro.configs as JC
    from repro.models import lm as JL
    tt = dict(enable=True, d=3, max_rank=4, min_elements=1024,
              apply_to=("ffn", "attn_qkv", "attn_o", "expert"))
    jcfg = JC.get_reduced("moonshot-v1-16b").replace(
        dtype="float32", tt=JTTConfig(**tt))
    tcfg = TC.get_reduced("moonshot-v1-16b").replace(
        dtype="float32", tt=TTConfig(**tt))
    jlm, tlm = JL.build_lm(jcfg), TL.build_lm(tcfg)
    jp = jax.jit(lambda k: JL.init_lm(k, jlm))(jax.random.PRNGKey(2))
    # experts' λ apart, so that a slice falls under one expert's max
    lam = np.array(jp["layers"]["sub_0"]["moe"]["gate"]["lambda_0"])
    lam[:, 0, 0] = 1e-6
    jp["layers"]["sub_0"]["moe"]["gate"]["lambda_0"] = jnp.asarray(lam)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    assert TL.lm_param_counts(tp, tlm) == JL.lm_param_counts(jp, jlm)


class _FakeEntry:
    """A C entry point that records its calls and checks each against the
    argument list its wrapper declared (``argtypes``), as ctypes would."""

    def __init__(self, calls, name):
        self.calls, self.name, self.argtypes, self.restype = calls, name, \
            None, None

    def __call__(self, *args):
        assert self.argtypes is not None, f"{self.name}: untyped call"
        assert len(args) == len(self.argtypes), (self.name, len(args))
        self.calls.append((self.name, args))
        return 0


class _FakeLib:
    def __init__(self, calls):
        self._calls = calls

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        entry = _FakeEntry(self._calls, name)
        setattr(self, name, entry)
        return entry


@pytest.mark.parametrize("kind,zs,gs,dtype", [
    ("pe1", (3, 200, 1, 16), (3, 1, 256, 16), torch.bfloat16),
    ("pe1", (3, 37, 5, 48), (3, 5, 18, 48), torch.float32),
    ("pe2", (3, 10, 64, 16), (3, 64, 176), torch.bfloat16),
    ("pe2", (3, 19, 7, 33), (3, 7, 21), torch.float32),
    ("pe3", (3, 80, 200), (3, 80, 256), torch.bfloat16),
    ("pe3", (3, 130, 47), (3, 130, 65), torch.float32),
    ("pe2", (10, 64, 16), (64, 176), torch.bfloat16),
])
def test_grouped_launches_pass_the_groups(monkeypatch, kind, zs, gs, dtype):
    """Each route's Python launch calls its C entry with the arguments its
    signature declares, ``groups`` the leading axis (1 ungrouped), and
    counts the launch as ``<kind>_grouped`` (``<kind>`` ungrouped): the
    wrappers run here with a recording stand-in for the library and the
    stream, where no kernel can."""
    from repro_torch.kernels import build as B
    calls = []
    lib = _FakeLib(calls)
    monkeypatch.setattr(B, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    z = torch.zeros(zs, dtype=dtype)
    g = torch.zeros(gs, dtype=dtype)
    grouped = len(zs) == (4 if kind != "pe3" else 3)
    e = zs[0] if grouped else 1
    B.reset_launches()
    if kind == "pe1":
        p = ttm_pe1.plan_pe1_for(z, g)
        out = torch.empty(zs[:-3] + (zs[-3], gs[-2]), dtype=dtype)
        if p is None:
            ttm_pe1.launch(z, g, out)
        else:
            ttm_pe1.launch_mma(p, z, g, out)
    else:
        zz, gg = (z, g) if kind == "pe2" else (g.unsqueeze(-3), z)
        out = torch.empty(zz.shape[:-2] + (gg.shape[-1], zz.shape[-1]),
                          dtype=dtype)
        p = tt_mma.plan_for(zz, gg)
        if p is None:
            tt_contract.launch(kind, f"ttm_{kind}", zz, gg, out)
        else:
            tt_mma.launch(kind, f"ttm_{kind}", p, zz, gg, out)
    assert (p is not None) == (dtype == torch.bfloat16)
    (name, args), = calls
    assert name.startswith(kind) and args[-2] == e      # groups, then stream
    assert B.LAUNCHES == {f"{kind}_grouped" if grouped else kind: 1}
