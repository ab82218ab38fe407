"""repro_torch.models.ssm and the recurrent LMs against repro.models (the
JAX reference), on transferred weights (``convert.params_from_jax``).

Every function of ``models/ssm.py`` (Mamba's conv, step, scan, forward and
decode step; RWKV6's token shift, WKV step and scan, time and channel mix
and their single-token twins) is held to the reference on the same numpy
inputs; then ``lm_forward``'s logits and cache and a few ``lm_decode_step``
steps for the reduced rwkv6-1.6b and the reduced jamba-1.5-large with dense
FFNs (whose attention sublayer runs ``gqa_decode`` and ``cache_append``).
Tolerance: float32, max |port - reference| <= 1e-5 of the reference's
largest magnitude (the two reduce in different orders). The single-token
entry points equal the scans at S = 1 bit for bit: the engine's token
identity with static decode rests on it.
"""
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as JC  # noqa: E402
from repro.configs.base import MoEConfig as JMoE  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import build_lm as j_build  # noqa: E402
from repro.models import init_lm as j_init  # noqa: E402
from repro.models import lm_decode_step as j_decode  # noqa: E402
from repro.models import lm_forward as j_forward  # noqa: E402
from repro.models import lm_init_cache as j_init_cache  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models.lm import lm_param_counts as j_counts  # noqa: E402
from repro.sharding import ShardPlan  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import build_lm as t_build  # noqa: E402
from repro_torch.models import init_lm as t_init  # noqa: E402
from repro_torch.models import lm_decode_step as t_decode  # noqa: E402
from repro_torch.models import lm_forward as t_forward  # noqa: E402
from repro_torch.models import lm_init_cache as t_init_cache  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models.lm import lm_param_counts as t_counts  # noqa: E402

PLAN = ShardPlan(mesh=None)
ARCHS = ["rwkv6-1.6b", "jamba-1.5-large"]


def _cfgs(arch):
    """The reduced config in float32; jamba with dense FFNs (its experts
    are held in ``tests/test_torch_moe.py``)."""
    jo, to = {}, {}
    if arch.startswith("jamba"):
        jo, to = {"moe": JMoE(num_experts=0)}, {"moe": MoEConfig(num_experts=0)}
    return (JC.get_reduced(arch).replace(dtype="float32", remat="none", **jo),
            TC.get_reduced(arch).replace(dtype="float32", remat="none", **to))


_PAIRS: dict = {}


def _pair(arch):
    if arch not in _PAIRS:
        jcfg, tcfg = _cfgs(arch)
        jlm = j_build(jcfg)
        jp = j_init(jax.random.PRNGKey(0), jlm)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        _PAIRS[arch] = (jlm, jp, t_build(tcfg), tp)
    return _PAIRS[arch]


def _close(t, j, what=""):
    """max |t - j| <= 1e-5 of max |j| (and equal shapes)."""
    j = np.asarray(j, np.float32)
    t = t.detach().float().numpy() if isinstance(t, torch.Tensor) else t
    assert t.shape == j.shape, (what, t.shape, j.shape)
    err = float(np.abs(t - j).max()) if j.size else 0.0
    assert err <= 1e-5 * max(float(np.abs(j).max()), 1e-30), (what, err)


def _tree_close(t, j, what=""):
    assert sorted(t) == sorted(j), (what, sorted(t), sorted(j))
    for k in j:
        if isinstance(j[k], dict):
            _tree_close(t[k], j[k], f"{what}/{k}")
        else:
            _close(t[k], j[k], f"{what}/{k}")


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _mixer(arch, kind):
    """(reference params, port params, reference def, port def, cfg pair)
    of the first sublayer with mixer ``kind``, layer 0."""
    jlm, jp, tlm, tp = _pair(arch)
    i = next(i for i, s in enumerate(jlm.period) if s.mixer_kind == kind)
    jpp = jax.tree.map(lambda a: a[0], jp["layers"][f"sub_{i}"]["mixer"])
    return (jpp, tp["layers"][0][f"sub_{i}"]["mixer"], jlm.period[i].mixer,
            tlm.period[i].mixer, jlm.cfg, tlm.cfg)


# ---------------------------------------------------------------------------
# the module's functions, one by one
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_make_defs_and_init_layout_match_reference(arch):
    """Same SiteDefs and dimensions; ``init_lm``'s tree has the reference's
    keys, shapes and dtypes (layer by layer), and the reference's constant
    initial values (decay base, mixes, A_log, D)."""
    jlm, jp, tlm, _ = _pair(arch)
    for js, ts in zip(jlm.period, tlm.period):
        assert (js.mixer_kind, js.ffn_kind) == (ts.mixer_kind, ts.ffn_kind)
        assert asdict(js.mixer) == asdict(ts.mixer)
    tp = t_init(torch.Generator().manual_seed(0), tlm, device="cpu")

    def shapes(t):
        return {k: shapes(v) if isinstance(v, dict) else
                (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in t.items()}
    ref = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    assert shapes(tp["layers"][0]) == shapes(ref["layers"][0])
    assert len(tp["layers"]) == jlm.n_periods
    for key, sub in tp["layers"][1].items():
        for name in ("mu_x", "mu_ffn", "ln_x_scale", "D", "conv_b"):
            if name in sub["mixer"]:
                assert torch.equal(sub["mixer"][name],
                                   ref["layers"][1][key]["mixer"][name])
        for name in ("w0", "A_log"):
            # linspace and log: the two libraries' f32 arithmetic differs
            # by an ulp here and there
            if name in sub["mixer"]:
                torch.testing.assert_close(
                    sub["mixer"][name], ref["layers"][1][key]["mixer"][name],
                    rtol=1e-6, atol=0)


def test_params_from_jax_carries_the_recurrent_leaves():
    """Every leaf of both trees arrives, layer by layer: rwkv6's mu_x, w0,
    u and the channel mix, jamba's A_log, D, conv_w and every sublayer of
    its period."""
    for arch in ARCHS:
        jlm, jp, _, tp = _pair(arch)
        assert len(tp["layers"]) == jlm.n_periods
        assert sorted(tp["layers"][0]) == [f"sub_{i}"
                                           for i in range(len(jlm.period))]
        flat, _ = jax.tree_util.tree_flatten_with_path(jp["layers"])
        for path, leaf in flat:
            node = tp["layers"]
            for l in range(jlm.n_periods):
                node = tp["layers"][l]
                for p in path:
                    node = node[p.key]
                assert np.array_equal(node.numpy(), np.asarray(leaf)[l])
    _, _, _, tp = _pair("rwkv6-1.6b")
    assert {"mu_x", "w0", "u", "mu_ffn", "ffn_k"} <= set(
        tp["layers"][0]["sub_0"]["mixer"])
    _, _, _, tp = _pair("jamba-1.5-large")
    assert {"A_log", "D", "conv_w", "conv_b"} <= set(
        tp["layers"][0]["sub_0"]["mixer"])


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.RandomState(0)
    x, w, b = _rand(rng, 2, 5, 6), _rand(rng, 4, 6), _rand(rng, 6)
    st = _rand(rng, 2, 3, 6) if with_state else None
    jy, jst = JS._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                              None if st is None else jnp.asarray(st))
    ty, tst = TS._causal_conv(_t(x), _t(w), _t(b),
                              None if st is None else _t(st))
    _close(ty, jy, "y")
    _close(tst, jst, "state")


def test_ssm_step_and_selective_scan_match_reference():
    rng = np.random.RandomState(1)
    bsz, s, di, n = 2, 6, 8, 4
    u, dt = _rand(rng, bsz, s, di), np.abs(_rand(rng, bsz, s, di, scale=0.3))
    a = -np.exp(_rand(rng, di, n, scale=0.5))
    bt, ct = _rand(rng, bsz, s, n), _rand(rng, bsz, s, n)
    d_skip, h0 = _rand(rng, di), _rand(rng, bsz, di, n)
    jh, jy = JS._ssm_step(jnp.asarray(h0), jnp.asarray(u[:, 0]),
                          jnp.asarray(dt[:, 0]), jnp.asarray(bt[:, 0]),
                          jnp.asarray(ct[:, 0]), jnp.asarray(a))
    th, ty = TS._ssm_step(_t(h0), _t(u[:, 0]), _t(dt[:, 0]), _t(bt[:, 0]),
                          _t(ct[:, 0]), _t(a))
    _close(th, jh, "h")
    _close(ty, jy, "y")
    for init in (None, h0):
        jy, jh = JS._selective_scan(
            *(jnp.asarray(v) for v in (u, dt, a, bt, ct, d_skip)),
            None if init is None else jnp.asarray(init))
        ty, th = TS._selective_scan(*(_t(v) for v in (u, dt, a, bt, ct,
                                                      d_skip)),
                                    None if init is None else _t(init))
        _close(ty, jy, "scan y")
        _close(th, jh, "scan h")


def _mamba_state(rng, td, bsz):
    return {"conv": _rand(rng, bsz, td.d_conv - 1, td.d_inner),
            "h": _rand(rng, bsz, td.d_inner, td.d_state, scale=0.5)}


def test_mamba_forward_decode_step_and_init_state_match_reference():
    jpp, tpp, jd, td, jcfg, tcfg = _mixer("jamba-1.5-large", "mamba")
    rng = np.random.RandomState(2)
    x = _rand(rng, 2, 7, jcfg.d_model)
    st = _mamba_state(rng, td, 2)
    for state in (None, st):
        jy, jst = JS.mamba_forward(jpp, jnp.asarray(x), jd, jcfg,
                                   None if state is None else
                                   {k: jnp.asarray(v) for k, v in st.items()})
        ty, tst = TS.mamba_forward(tpp, _t(x), td, tcfg,
                                   None if state is None else
                                   {k: _t(v) for k, v in st.items()})
        _close(ty, jy, "y")
        _tree_close(tst, jst, "state")
    # the port decodes through the forward at S = 1: the reference's
    # single-token entry point gives the same numbers
    x1 = x[:, :1]
    jy, jst = JS.mamba_decode_step(jpp, jnp.asarray(x1), jd, jcfg,
                                   {k: jnp.asarray(v) for k, v in st.items()})
    ty, tst = TS.mamba_forward(tpp, _t(x1), td, tcfg,
                               {k: _t(v) for k, v in st.items()})
    _close(ty, jy, "step y")
    _tree_close(tst, jst, "step state")
    ji = JS.mamba_init_state(jd, 3, jnp.float32)
    ti = TS.mamba_init_state(td, 3, torch.float32, torch.device("cpu"))
    for k in ji:
        assert tuple(ti[k].shape) == ji[k].shape and not ti[k].any()
        assert str(ti[k].dtype).split(".")[-1] == str(ji[k].dtype)


def test_softplus_is_logaddexp_with_zero():
    """``jax.nn.softplus`` is ``logaddexp(x, 0)``, which the port computes
    with ``torch.logaddexp`` (to an ulp of XLA's exp and log1p) rather than
    ``torch.nn.functional.softplus``, whose threshold switches to x."""
    x = np.array([-30.0, -3.0, 0.0, 0.7, 14.0, 19.0, 20.5, 40.0], np.float32)
    j = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    t = TS._softplus(_t(x)).numpy()
    np.testing.assert_allclose(t, j, rtol=2.4e-7, atol=0)
    np.testing.assert_array_equal(
        t, torch.logaddexp(_t(x), torch.zeros(len(x))).numpy())


def test_token_shift_and_wkv6_step_and_scan_match_reference():
    rng = np.random.RandomState(3)
    x, last = _rand(rng, 2, 5, 8), _rand(rng, 2, 1, 8)
    for lst in (None, last):
        js, jl = JS._token_shift(jnp.asarray(x),
                                 None if lst is None else jnp.asarray(lst))
        ts, tl = TS._token_shift(_t(x), None if lst is None else _t(lst))
        assert np.array_equal(ts.numpy(), np.asarray(js))
        assert np.array_equal(tl.numpy(), np.asarray(jl))
    bsz, s, h, dh = 2, 6, 3, 4
    r, k, v = (_rand(rng, bsz, s, h, dh) for _ in range(3))
    w = 1 / (1 + np.exp(-_rand(rng, bsz, s, h, dh)))
    u, h0 = _rand(rng, h, dh, scale=0.1), _rand(rng, bsz, h, dh, dh)
    js, jo = JS._wkv6_step(jnp.asarray(h0), *(jnp.asarray(a[:, 0])
                                              for a in (r, k, v, w)),
                           jnp.asarray(u))
    ts, to = TS._wkv6_step(_t(h0), *(_t(a[:, 0]) for a in (r, k, v, w)),
                           _t(u))
    _close(ts, js, "step state")
    _close(to, jo, "step out")
    jo, js = JS._wkv6_scan(*(jnp.asarray(a) for a in (r, k, v, w, u, h0)))
    to, ts = TS._wkv6_scan(*(_t(a) for a in (r, k, v, w, u, h0)))
    _close(to, jo, "scan out")
    _close(ts, js, "scan state")


def _rwkv_state(rng, td, dm, bsz):
    return {"shift": _rand(rng, bsz, 1, dm), "shift_ffn": _rand(rng, bsz, 1, dm),
            "wkv": _rand(rng, bsz, td.num_heads, td.head_dim, td.head_dim,
                         scale=0.5)}


def test_rwkv6_mixes_steps_and_init_state_match_reference():
    jpp, tpp, jd, td, jcfg, tcfg = _mixer("rwkv6-1.6b", "rwkv6")
    rng = np.random.RandomState(4)
    dm = jcfg.d_model
    x = _rand(rng, 2, 7, dm)
    st = _rwkv_state(rng, td, dm, 2)
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    tst = {k: _t(v) for k, v in st.items()}
    for fn in ("rwkv6_time_mix", "rwkv6_channel_mix"):
        for state in (None, "carried"):
            jy, js = getattr(JS, fn)(jpp, jnp.asarray(x), jd, jcfg,
                                     None if state is None else jst)
            ty, ts = getattr(TS, fn)(tpp, _t(x), td, tcfg,
                                     None if state is None else tst)
            _close(ty, jy, f"{fn} y")
            _tree_close(ts, js, f"{fn} state")
    # the port decodes through the mixes at S = 1: the reference's
    # single-token entry points give the same numbers
    x1 = x[:, :1]
    for step, scan in (("rwkv6_time_mix_step", "rwkv6_time_mix"),
                       ("rwkv6_channel_mix_step", "rwkv6_channel_mix")):
        jy, js = getattr(JS, step)(jpp, jnp.asarray(x1), jd, jcfg, jst)
        ty, ts = getattr(TS, scan)(tpp, _t(x1), td, tcfg, tst)
        _close(ty, jy, f"{step} y")
        _tree_close(ts, js, f"{step} state")
    ji = JS.rwkv6_init_state(jd, 3, dm, jnp.float32)
    ti = TS.rwkv6_init_state(td, 3, dm, torch.float32, torch.device("cpu"))
    for k in ji:
        assert tuple(ti[k].shape) == ji[k].shape and not ti[k].any()


# ---------------------------------------------------------------------------
# the LM: forward, static decode, attention's static-decode pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_lm_forward_logits_and_cache_match_reference(arch):
    jlm, jp, tlm, tp = _pair(arch)
    toks = np.random.RandomState(5).randint(0, jlm.cfg.vocab_size, (2, 11))
    jl, _, jc = j_forward(jp, jlm, PLAN, tokens=jnp.asarray(toks),
                          return_cache=True)
    tl, aux, tc = t_forward(tp, tlm, tokens=_t(toks), return_cache=True)
    _close(tl, jl, "logits")
    _tree_close(tc, jc, "cache")
    assert float(aux) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_decode_steps_match_reference(arch):
    """Prefill, then four decode steps at per-slot lengths (attention leaves
    padded to a horizon), each step's logits and the whole cache held to
    the reference."""
    jlm, jp, tlm, tp = _pair(arch)
    rng = np.random.RandomState(6)
    p, horizon = 6, 12
    toks = rng.randint(0, jlm.cfg.vocab_size, (2, p))
    _, _, jc = j_forward(jp, jlm, PLAN, tokens=jnp.asarray(toks),
                         return_cache=True)
    _, _, tc = t_forward(tp, tlm, tokens=_t(toks), return_cache=True)

    def pad(tree, zeros):
        return {key: {n: (zeros(a, horizon - p) if n in ("k", "v") else a)
                      for n, a in kinds.items()} for key, kinds in tree.items()}
    jc = pad(jc, lambda a, n: jnp.pad(a, [(0, 0), (0, 0), (0, n), (0, 0),
                                          (0, 0)]))
    tc = pad(tc, lambda a, n: torch.nn.functional.pad(a, (0, 0, 0, 0, 0, n)))
    for j in range(4):
        step = rng.randint(0, jlm.cfg.vocab_size, (2, 1))
        cur = np.array([p + j, p + j], np.int32) if j % 2 else p + j
        jl, jc = j_decode(jp, jc, jnp.asarray(step), jnp.asarray(cur), jlm,
                          PLAN)
        tl, tc = t_decode(tp, tc, _t(step), cur if j % 2 == 0 else _t(cur),
                          tlm)
        _close(tl, jl, f"step {j} logits")
        _tree_close(tc, jc, f"step {j} cache")


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_init_cache_layout_matches_reference(arch):
    jlm, _, tlm, _ = _pair(arch)
    jc = j_init_cache(jlm, 3, 10, PLAN)
    tc = t_init_cache(tlm, 3, 10, device="cpu")
    assert sorted(tc) == sorted(jc)
    for key in jc:
        assert sorted(tc[key]) == sorted(jc[key])
        for n, a in jc[key].items():
            assert tuple(tc[key][n].shape) == a.shape
            assert str(tc[key][n].dtype).split(".")[-1] == str(a.dtype)
            assert not tc[key][n].any()


@pytest.mark.parametrize("per_slot", [False, True])
def test_gqa_decode_and_cache_append_match_reference(per_slot):
    jpp, tpp, jd, td, jcfg, tcfg = _mixer("jamba-1.5-large", "attn_gqa")
    rng = np.random.RandomState(7)
    b, t = 3, 9
    x = _rand(rng, b, 1, jcfg.d_model)
    cache = {n: _rand(rng, b, t, jd.num_kv_heads, jd.head_dim)
             for n in ("k", "v")}
    cur = np.array([2, 5, 8], np.int32) if per_slot else 4
    jy, jc = JA.gqa_decode(jpp, jnp.asarray(x),
                           {k: jnp.asarray(v) for k, v in cache.items()},
                           jd, jcfg, jnp.asarray(cur))
    tcache = {k: _t(v) for k, v in cache.items()}
    ty, tc = TA.gqa_decode(tpp, _t(x), tcache, td, tcfg,
                           _t(cur) if per_slot else cur)
    _close(ty, jy, "y")
    _tree_close(tc, jc, "cache")
    assert np.array_equal(tcache["k"].numpy(), cache["k"])   # a new cache
    new = _rand(rng, b, 1, jd.num_kv_heads, jd.head_dim)
    j = JA.cache_append(jnp.asarray(cache["k"]), jnp.asarray(new),
                        jnp.asarray(cur))
    tt = TA.cache_append(_t(cache["k"]), _t(new), cur)
    assert np.array_equal(tt.numpy(), np.asarray(j))
    assert np.array_equal(TA.len_positions(cur, b).numpy(),
                          np.asarray(JA.len_positions(jnp.asarray(cur), b)))


def test_gqa_forward_and_init_cache_match_reference():
    jpp, tpp, jd, td, jcfg, tcfg = _mixer("jamba-1.5-large", "attn_gqa")
    rng = np.random.RandomState(8)
    x = _rand(rng, 2, 8, jcfg.d_model)
    pos = np.tile(np.arange(8)[None], (2, 1))
    j = JA.gqa_forward(jpp, jnp.asarray(x), jd, jcfg, causal=True,
                       positions=jnp.asarray(pos))
    t = TA.gqa_forward(tpp, _t(x), td, tcfg, causal=True, positions=_t(pos))
    _close(t, j, "gqa_forward")
    jc = JA.gqa_init_cache(jd, 2, 5, jnp.float32)
    tc = TA.gqa_init_cache(td, 2, 5, torch.float32, torch.device("cpu"))
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: v.shape for k, v in jc.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_reference(arch):
    """The site walk covers the recurrent mixers' sites as the reference's
    does (the counts of a dense model: every site, once per period)."""
    jlm, jp, tlm, tp = _pair(arch)
    assert t_counts(tp, tlm) == j_counts(jp, jlm)
