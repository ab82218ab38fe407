"""repro_torch.models.moe and the MoE LMs against repro.models (the JAX
reference), on transferred weights, float32 on the CPU, inputs from numpy
seeds.

(a) ``moe_forward``: outputs and aux within 1e-5 of JAX's, with and
    without ``token_mask`` and ``capacity_tokens``, with shared experts;
    the routed expert indices and the kept (expert, token) set exactly
    equal; the gradients of a loss within 1e-5 of ``jax.grad``'s (the
    router, the expert stacks, the shared experts and the input).
    Tolerance: the two reduce the same f32 sums in different orders;
    every error is measured against the reference's largest magnitude.
(b) The reference's MoE oracles, mirrored on the port: ``tests/
    test_moe.py``'s five, ``test_prefix_cache.py::
    test_moe_capacity_parity_unit`` (equal router weights: the earlier
    tokens keep their capacity, as ``lax.top_k`` breaks ties) and
    ``test_numerics.py::test_moe_mask_prevents_capacity_theft``.
(c) ``lm_forward`` on the reduced moonshot-v1-16b and jamba-1.5-large
    with experts: logits (1e-4, as ``tests/test_torch_models.py``) and aux
    (1e-5 relative) equal to JAX's, with and without a mask; static
    decode equal to JAX's; the site walk and parameter counts equal to the
    reference's; ``params_from_jax`` unstacks the expert stacks along the
    layer axis only and ``lm_train_state_from_jax`` carries an MoE state.
(d) The full configs build; the expert-parallel path and TT ``"expert"``
    sites raise, naming their ROADMAP items.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as JC  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.configs.base import MoEConfig as JMoE  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs.base import TTConfig as JTTConfig  # noqa: E402
from repro.launch.steps import init_train_state as j_init_state  # noqa: E402
from repro.models import build_lm as j_build  # noqa: E402
from repro.models import init_lm as j_init  # noqa: E402
from repro.models import lm as JL  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.sharding import ShardPlan  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.configs.base import (ModelConfig, MoEConfig,  # noqa: E402
                                      TTConfig)
from repro_torch.convert import (lm_train_state_from_jax,  # noqa: E402
                                 params_from_jax)
from repro_torch.models import lm as TL  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402

PLAN = ShardPlan(mesh=None)
ARCHS = ["moonshot-v1-16b", "jamba-1.5-large"]


def _close(got, want, tol=1e-5):
    """max |got - want| within ``tol`` of want's largest magnitude."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max error {err:.3e}, scale {scale:.3e}"


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _setup(e=8, k=2, d=32, f=64, shared=0, cf=2.0, seed=0):
    """A JAX and a port MoEDef on one config, JAX-initialised weights
    carried to the port."""
    kw = dict(name="m", d_model=d, d_ff=f, dtype="float32")
    jcfg = JModelConfig(**kw, moe=JMoE(num_experts=e, top_k=k,
                                      num_shared=shared, capacity_factor=cf))
    tcfg = ModelConfig(**kw, moe=MoEConfig(num_experts=e, top_k=k,
                                           num_shared=shared,
                                           capacity_factor=cf))
    jd, td = JM.make_moe(jcfg), TM.make_moe(tcfg)
    jp = JM.init_moe(jax.random.PRNGKey(seed), jd, jcfg)
    return jcfg, jd, jp, tcfg, td, _t(jp)


def _x(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale
            ).astype(np.float32)


def _kept(select_calls):
    """The kept (expert, token) pairs of each recorded selection."""
    out = []
    for cw, cidx in select_calls:
        cw, cidx = np.asarray(cw), np.asarray(cidx)
        out.append(sorted((e, int(t)) for e in range(cw.shape[0])
                          for t, w in zip(cidx[e], cw[e]) if w > 0))
    return out


# ---------------------------------------------------------------------------
# (a) moe_forward against JAX
# ---------------------------------------------------------------------------

CASES = [  # (mask, capacity_tokens, shared, cf)
    (False, None, 0, 1.25), (True, None, 0, 1.25), (False, 64, 0, 1.25),
    (True, 48, 0, 0.5), (False, None, 1, 1.25), (True, 64, 2, 2.0)]


@pytest.mark.parametrize("mask,cap,shared,cf", CASES)
def test_moe_forward_matches_jax(mask, cap, shared, cf, monkeypatch):
    jcfg, jd, jp, tcfg, td, tp = _setup(shared=shared, cf=cf)
    x = _x((2, 12, jcfg.d_model), 1)
    m = None
    if mask:
        m = np.ones((2, 12), bool)
        m[1, 7:] = False
    jo, ja = jax.jit(lambda p, xx, mm: JM.moe_forward(
        p, xx, jd, jcfg, token_mask=mm, capacity_tokens=cap))(
        jp, jnp.asarray(x), None if m is None else jnp.asarray(m))
    calls = []
    select = TM._select
    monkeypatch.setattr(TM, "_select",
                        lambda w, c: calls.append(select(w, c)) or calls[-1])
    to, ta = TM.moe_forward(tp, torch.from_numpy(x), td, tcfg,
                            token_mask=None if m is None
                            else torch.from_numpy(m),
                            capacity_tokens=cap)
    _close(to.numpy(), jo)
    _close(ta.numpy(), ja)
    # routing: the same experts and the same kept (expert, token) set
    x2 = x.reshape(-1, jcfg.d_model)
    mf = None if m is None else m.reshape(-1)
    ji, jw, _ = JM._route(jp, jnp.asarray(x2), jd, jcfg,
                          None if mf is None else jnp.asarray(mf))
    ti, tw, _ = TM._route(tp, torch.from_numpy(x2), td, tcfg,
                          None if mf is None else torch.from_numpy(mf))
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    _close(tw.numpy(), jw)
    c = TM._capacity(24, td, cap)
    w_tok = np.zeros((td.num_experts, 24), np.float32)
    for t in range(24):
        for j in range(td.top_k):
            w_tok[int(ji[t, j]), t] = float(jw[t, j])
    jcw, jcidx = jax.lax.top_k(jnp.asarray(w_tok), c)
    assert _kept(calls) == _kept([(jcw, jcidx)])


@pytest.mark.parametrize("shared", [0, 1])
def test_moe_gradients_match_jax(shared):
    jcfg, jd, jp, tcfg, td, tp = _setup(shared=shared, cf=1.0)
    x = _x((2, 16, jcfg.d_model), 5)
    m = np.ones((2, 16), bool)
    m[0, 12:] = False

    def jloss(p, xx):
        out, aux = JM.moe_forward(p, xx, jd, jcfg, token_mask=jnp.asarray(m))
        return jnp.sum(out ** 2) + 0.01 * aux

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    tp = jax.tree.map(lambda t: t.requires_grad_(True), tp)
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = TM.moe_forward(tp, tx, td, tcfg,
                              token_mask=torch.from_numpy(m))
    (torch.sum(out ** 2) + 0.01 * aux).backward()
    _close(tx.grad.numpy(), jgx)
    flat_j = jax.tree_util.tree_leaves_with_path(jg)
    flat_t = dict(jax.tree_util.tree_leaves_with_path(tp))
    assert len(flat_j) == len(flat_t) == (7 if shared else 4)
    for path, g in flat_j:
        assert float(np.abs(np.asarray(g)).max()) > 0, path
        _close(flat_t[path].grad.numpy(), g)


def test_topk_breaks_ties_to_the_lower_index():
    """``_topk`` is ``lax.top_k`` on ties, zeros and a full-width k."""
    rng = np.random.RandomState(7)
    x = rng.randint(0, 4, (6, 40)).astype(np.float32) / 4
    x[2] = 0.0
    for k in (1, 5, 40):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = TM._topk(torch.from_numpy(x), k)
        assert np.array_equal(ti.numpy(), np.asarray(ji))
        assert np.array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("tokens,basis", [(1, None), (8, None), (24, None),
                                          (100, None), (512, None),
                                          (16, 512), (128, 512), (7, 64)])
def test_capacity_is_the_reference_arithmetic(tokens, basis):
    for e, k, cf in ((8, 2, 1.25), (64, 6, 1.25), (4, 2, 0.5), (8, 1, 2.0)):
        jcfg = JModelConfig(name="m", moe=JMoE(num_experts=e, top_k=k,
                                               capacity_factor=cf))
        tcfg = ModelConfig(name="m", moe=MoEConfig(num_experts=e, top_k=k,
                                                   capacity_factor=cf))
        assert TM._capacity(tokens, TM.make_moe(tcfg), basis) == \
            JM._capacity(tokens, JM.make_moe(jcfg), basis)


# ---------------------------------------------------------------------------
# (b) the reference's oracles, mirrored
# ---------------------------------------------------------------------------

def test_routing_topk_normalized():
    _, _, _, tcfg, td, tp = _setup()
    x = torch.from_numpy(_x((64, tcfg.d_model), 1))
    idx, w, aux = TM._route(tp, x, td, tcfg)
    assert idx.shape == (64, 2) and w.shape == (64, 2)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-3)
    assert float(aux) >= 1.0 - 1e-3   # switch aux lower bound at balance


def test_moe_forward_matches_dense_dispatch():
    """Capacity-unconstrained dispatch == explicit per-token expert sum."""
    _, _, _, tcfg, td, tp = _setup(cf=100.0)
    x = torch.from_numpy(_x((2, 16, tcfg.d_model), 2))
    out, _ = TM.moe_forward(tp, x, td, tcfg)
    x2 = x.reshape(-1, tcfg.d_model)
    idx, w, _ = TM._route(tp, x2, td, tcfg)
    ref = torch.zeros_like(x2)
    for e in range(td.num_experts):
        h = TM.silu(x2 @ tp["gate"]["w"][e]) * (x2 @ tp["up"]["w"][e])
        ye = h @ tp["down"]["w"][e]
        sel = ((idx == e) * w).sum(-1)
        ref += ye * sel[:, None]
    np.testing.assert_allclose(out.reshape(-1, tcfg.d_model).numpy(),
                               ref.numpy(), rtol=2e-3, atol=2e-3)


def test_capacity_drops_tokens():
    _, _, _, tcfg, td, tp = _setup(cf=0.1)
    out, _ = TM.moe_forward(tp, torch.from_numpy(_x((1, 64, 32), 3)), td,
                            tcfg)
    assert (out[0].norm(dim=-1) < 1e-6).any()


def test_shared_experts_always_active():
    _, _, _, tcfg, td, tp = _setup(shared=1, cf=0.01)
    out, _ = TM.moe_forward(tp, torch.from_numpy(_x((1, 32, 32), 4)), td,
                            tcfg)
    assert (out[0].norm(dim=-1) > 1e-6).all()


def test_moe_grads_flow_to_experts_and_router():
    _, _, _, tcfg, td, tp = _setup()
    tp = jax.tree.map(lambda t: t.requires_grad_(True), tp)
    out, aux = TM.moe_forward(tp, torch.from_numpy(_x((2, 8, 32), 5)), td,
                              tcfg)
    (torch.sum(out ** 2) + 0.01 * aux).backward()
    assert float(tp["router"]["w"].grad.abs().sum()) > 0
    assert float(tp["gate"]["w"].grad.abs().sum()) > 0


def test_moe_capacity_parity_unit():
    """Chunked routing == whole-prompt routing iff capacity derives from the
    full token count (``test_prefix_cache.py``'s construction: 12 equal
    rows to one expert, a chunk's capacity 8, the whole prompt's 16), and
    the port keeps exactly JAX's rows: ties to the earlier token."""
    jcfg, jd, jp, tcfg, td, tp = _setup(k=1, cf=2.0)
    cand = _x((64, 32), 1)
    top1 = TM._route(tp, torch.from_numpy(cand), td, tcfg)[0][:, 0].numpy()
    protos, used = [], set()
    for i in range(64):
        if int(top1[i]) not in used:
            used.add(int(top1[i]))
            protos.append(cand[i])
        if len(protos) == 5:
            break
    assert len(protos) == 5, "need 5 distinct top-1 experts"
    a, b, c, d, e = protos
    x = np.stack([a] * 12 + [b] * 4 + [c] * 16 + [d] * 16 + [e] * 16)[None]
    tx = torch.from_numpy(x)
    whole, _ = TM.moe_forward(tp, tx, td, tcfg)
    pieces = [tx[:, i:i + 16] for i in range(0, 64, 16)]
    legacy = torch.cat([TM.moe_forward(tp, p, td, tcfg)[0] for p in pieces],
                       dim=1)
    parity = torch.cat([TM.moe_forward(tp, p, td, tcfg,
                                       capacity_tokens=64)[0]
                        for p in pieces], dim=1)
    np.testing.assert_allclose(parity.numpy(), whole.numpy(), rtol=2e-5,
                               atol=2e-5)
    assert (legacy - whole).abs().max() > 1e-3
    dropped = legacy[0, 8:12].norm(dim=-1)
    kept = whole[0, 8:12].norm(dim=-1)
    assert (dropped < 1e-6).all() and (kept > 1e-6).all()
    # the same rows as JAX's: tokens 0..7 of the run kept, 8..11 dropped
    jleg = jnp.concatenate([JM.moe_forward(jp, jnp.asarray(x[:, i:i + 16]),
                                           jd, jcfg)[0]
                            for i in range(0, 64, 16)], axis=1)
    _close(legacy.numpy(), jleg)


def test_moe_mask_prevents_capacity_theft():
    """Masked junk rows never displace real ones: the real rows' outputs do
    not depend on the junk, and the junk rows' are zero."""
    kw = dict(name="m", num_layers=1, d_model=32, num_heads=2,
              num_kv_heads=2, d_ff=64, vocab_size=64, dtype="float32")
    jcfg = JModelConfig(**kw, moe=JMoE(num_experts=2, top_k=2,
                                      capacity_factor=0.5))
    tcfg = ModelConfig(**kw, moe=MoEConfig(num_experts=2, top_k=2,
                                           capacity_factor=0.5))
    jd, td = JM.make_moe(jcfg), TM.make_moe(tcfg)
    jp = JM.init_moe(jax.random.PRNGKey(0), jd, jcfg)
    tp = _t(jp)
    x = _x((1, 16, 32), 1)
    mask = np.asarray([True] * 8 + [False] * 8)[None]
    junk_a, junk_b = x.copy(), x.copy()
    junk_a[:, 8:] = _x((1, 8, 32), 2, 100.0)
    junk_b[:, 8:] = _x((1, 8, 32), 3, 50.0)
    tm = torch.from_numpy(mask)
    out_a, _ = TM.moe_forward(tp, torch.from_numpy(junk_a), td, tcfg,
                              token_mask=tm)
    out_b, _ = TM.moe_forward(tp, torch.from_numpy(junk_b), td, tcfg,
                              token_mask=tm)
    np.testing.assert_allclose(out_a[:, :8].numpy(), out_b[:, :8].numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out_a[:, 8:].numpy(), 0.0, atol=1e-6)
    noma, _ = TM.moe_forward(tp, torch.from_numpy(junk_a), td, tcfg)
    nomb, _ = TM.moe_forward(tp, torch.from_numpy(junk_b), td, tcfg)
    assert (noma[:, :8] - nomb[:, :8]).abs().max() > 1e-4
    jo, _ = JM.moe_forward(jp, jnp.asarray(junk_a), jd, jcfg,
                           token_mask=jnp.asarray(mask))
    _close(out_a.numpy(), jo)


# ---------------------------------------------------------------------------
# (c) the MoE LMs against JAX
# ---------------------------------------------------------------------------

_PAIRS: dict = {}


def _pair(arch):
    if arch not in _PAIRS:
        jcfg = JC.get_reduced(arch).replace(dtype="float32", remat="none")
        tcfg = TC.get_reduced(arch).replace(dtype="float32", remat="none")
        jlm = j_build(jcfg)
        jp = jax.jit(lambda k: j_init(k, jlm))(jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        _PAIRS[arch] = (jlm, jp, TL.build_lm(tcfg), tp)
    return _PAIRS[arch]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_forward_logits_and_aux_match_jax(arch, masked):
    jlm, jp, tlm, tp = _pair(arch)
    toks = np.random.RandomState(0).randint(0, jlm.cfg.vocab_size, (2, 24))
    m = np.ones((2, 24), bool)
    if masked:
        m[1, 17:] = False
    jl, ja, jc = jax.jit(lambda p, t, mm: JL.lm_forward(
        p, jlm, PLAN, tokens=t, return_cache=True, token_mask=mm,
        capacity_tokens=64 if masked else None))(
        jp, jnp.asarray(toks), jnp.asarray(m) if masked else None)
    tl, ta, tc = TL.lm_forward(tp, tlm, tokens=torch.from_numpy(toks),
                               return_cache=True,
                               token_mask=torch.from_numpy(m) if masked
                               else None,
                               capacity_tokens=64 if masked else None)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    assert float(ta) > 1.0
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)
    for key, kinds in jc.items():
        for name, a in kinds.items():
            _close(tc[key][name].numpy(), a, 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_static_decode_matches_jax(arch):
    """``lm_decode_step`` (no mask, capacity over the batch's rows) from
    ``lm_init_cache``, 6 steps at B = 2, against JAX's."""
    jlm, jp, tlm, tp = _pair(arch)
    toks = np.random.RandomState(1).randint(0, jlm.cfg.vocab_size, (2, 6))
    jc = JL.lm_init_cache(jlm, 2, 8, PLAN)
    tc = TL.lm_init_cache(tlm, 2, 8, device="cpu")
    step = jax.jit(lambda p, c, t, n: JL.lm_decode_step(p, c, t, n, jlm,
                                                        PLAN))
    for t in range(6):
        jl, jc = step(jp, jc, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        tl, tc = TL.lm_decode_step(tp, tc, torch.from_numpy(toks[:, t:t + 1]),
                                   t, tlm)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)


def test_decode_matches_prefill_at_a_drop_free_capacity():
    """``tests/test_models.py::test_reduced_decode_matches_prefill`` on the
    port's moonshot: at capacity factor 64 nothing drops, so decoding one
    token at a time gives the prefill's logits."""
    cfg = TC.get_reduced("moonshot-v1-16b").replace(dtype="float32",
                                                    remat="none")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=64.0))
    lm = TL.build_lm(cfg)
    params = TL.init_lm(torch.Generator().manual_seed(0), lm, device="cpu")
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (2, 8)))
    ref, _, _ = TL.lm_forward(params, lm, tokens=toks)
    cache = TL.lm_init_cache(lm, 2, 8, device="cpu")
    outs = []
    for t in range(8):
        lg, cache = TL.lm_decode_step(params, cache, toks[:, t:t + 1], t, lm)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), ref.numpy(),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_sites_and_param_counts_match_the_reference(arch):
    jlm, jp, tlm, tp = _pair(arch)
    j_sites = [(p, (s.use_tt, s.family, s.out_dim, s.in_dim))
               for p, s in JL._walk_sites(jlm)]
    t_sites = [(p, (s.use_tt, s.family, s.out_dim, s.in_dim))
               for p, s in TL._walk_sites(tlm)]
    assert t_sites == j_sites
    assert any(p[-2:] == ("moe", "router") for p, _ in t_sites)
    assert TL.lm_param_counts(tp, tlm) == JL.lm_param_counts(jp, jlm)


def test_params_from_jax_unstacks_expert_stacks_along_layers():
    jlm, jp, tlm, tp = _pair("moonshot-v1-16b")
    e = jlm.cfg.moe.num_experts
    w = np.asarray(jp["layers"]["sub_0"]["moe"]["down"]["w"])   # (L, E, F, D)
    assert w.shape[:2] == (jlm.n_periods, e)
    for layer in range(jlm.n_periods):
        got = tp["layers"][layer]["sub_0"]["moe"]["down"]["w"]
        assert tuple(got.shape) == w.shape[1:]
        assert np.array_equal(got.numpy(), w[layer])
    # and the port's init draws the same tree
    init = TL.init_lm(torch.Generator().manual_seed(0), tlm, device="cpu")
    shape = jax.tree.map(lambda t: tuple(t.shape), tp["layers"][0])
    assert jax.tree.map(lambda t: tuple(t.shape), init["layers"][0]) == shape


def test_lm_train_state_from_jax_carries_an_moe_state():
    jlm, jp, tlm, tp = _pair("jamba-1.5-large")
    state = j_init_state(jp, JTrainConfig(total_steps=10, warmup_steps=1))
    ts = lm_train_state_from_jax(jax.tree.map(np.asarray, state), "cpu")
    assert len(ts.opt.m) == len(jax.tree_util.tree_leaves(tp))
    got = ts.params["layers"][1]["sub_1"]["moe"]["gate"]["w"]
    assert np.array_equal(got.numpy(),
                          np.asarray(jp["layers"]["sub_1"]["moe"]["gate"]["w"]
                                     )[1])


# ---------------------------------------------------------------------------
# (d) what builds and what raises
# ---------------------------------------------------------------------------

def test_full_configs_build_and_later_slices_raise():
    for arch in ARCHS:
        cfg = TC.get_config(arch)
        lm = TL.build_lm(cfg)
        kinds = [s.ffn_kind for s in lm.period]
        assert "moe" in kinds
        assert lm.n_periods * len(lm.period) == cfg.num_layers
    lm = TL.build_lm(TC.get_config("moonshot-v1-16b"))
    assert lm.n_periods == 48 and lm.period[0].ffn.num_experts == 64
    cfg = TC.get_reduced("moonshot-v1-16b")
    tt = TTConfig(enable=True, min_elements=1,
                  apply_to=("ffn", "expert"))
    # TT "expert" sites build (tests/test_torch_moe_tt.py holds them)
    assert TL.build_lm(cfg.replace(tt=tt)).period[0].ffn.gate.use_tt
    # the router is an ordinary ffn site: TT when the config says so
    lm = TL.build_lm(cfg.replace(tt=dataclasses.replace(tt,
                                                        apply_to=("ffn",))))
    assert lm.period[0].ffn.router.use_tt
    assert not lm.period[0].ffn.gate.use_tt
    _, _, _, tcfg, td, tp = _setup()
    with pytest.raises(NotImplementedError, match="item 8"):
        TM.moe_forward(tp, torch.zeros((1, 4, 32)), td, tcfg, mesh=object())
    # the JAX side agrees that these are its expert sites
    jcfg = JC.get_reduced("moonshot-v1-16b").replace(
        tt=JTTConfig(enable=True, min_elements=1, apply_to=("ffn", "expert")))
    assert JM.make_moe(jcfg).gate.use_tt
