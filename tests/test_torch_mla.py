"""repro_torch's MLA (DeepSeek-V2 multi-head latent attention) against repro
(the JAX reference), on the CPU, and the three paged KV kernels' wrappers
at a width per tensor.

The model is the reduced deepseek-v2-236b (``configs/deepseek_v2_236b.py``
``REDUCED``: 2 layers, d_model 64, 4 heads, kv_lora 32, q_lora 48,
nope/rope/v 16/8/16, 8 experts top-2 and 1 shared expert), float32,
weights carried across by ``params_from_jax``, inputs made with numpy
from a seed:

(a) ``mla_forward``, ``mla_decode_q``, ``mla_attend``, ``mla_decode`` (a
    per-slot and a shared length) and ``_absorb_weight`` on a dense site
    and on a TT site (``attn_qkv``/``attn_o`` factorized at d = 2, rank 4):
    within 1e-5 of the reference's largest magnitude (f32 sums in another
    order);
(b) ``lm_forward``'s logits, aux and latent caches, and three steps of
    ``lm_decode_step``: within 1e-5 likewise;
(c) the pool: what the engine's calls write and read through the three
    wrappers' plain twins (``append_kv``, ``write_chunk_kv``,
    ``write_prefill``, ``read_kv``) against JAX's ``append_token``,
    ``write_chunk``, ``write_prefill`` and ``gather_slots`` on an int8 pool
    seeded with random codes, bit for bit (codes of every real page and
    scales; the trash page is write-only scratch), on MLA's pair (``c_kv``
    32 wide, ``k_rope`` 8) and on a GQA pair (2 heads x 8); and the C
    arguments each wrapper hands its kernel: K and V at their own widths,
    GQA's one width twice, as many as the kernel's signature takes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as JC  # noqa: E402
from repro.configs.base import TTConfig as JTTConfig  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import build_lm as j_build  # noqa: E402
from repro.models import init_lm as j_init  # noqa: E402
from repro.models import lm as JL  # noqa: E402
from repro.serve import PoolConfig as JPC  # noqa: E402
from repro.serve import kv_cache as JKC  # noqa: E402
from repro.sharding import ShardPlan  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.configs.base import TTConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import kv_append as KA  # noqa: E402
from repro_torch.kernels import kv_prefill as KP  # noqa: E402
from repro_torch.kernels import kv_read as KR  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import build_lm as t_build  # noqa: E402
from repro_torch.models import lm as TL  # noqa: E402
from repro_torch.serve import PoolConfig  # noqa: E402
from repro_torch.serve import kv_cache as TKC  # noqa: E402

ARCH = "deepseek-v2-236b"
TOL = 1e-5
TT = dict(enable=True, d=2, max_rank=4, apply_to=("attn_qkv", "attn_o"),
          min_elements=256)
PLAN = ShardPlan(mesh=None)

_MODELS: dict = {}


def _models(tt: bool = False):
    """(reference lm, params, port lm, params), reduced deepseek in f32;
    ``tt``: its attention sites TT-factorized."""
    if tt not in _MODELS:
        jcfg = JC.get_reduced(ARCH).replace(dtype="float32", remat="none")
        tcfg = TC.get_reduced(ARCH).replace(dtype="float32", remat="none")
        if tt:
            jcfg, tcfg = jcfg.replace(tt=JTTConfig(**TT)), tcfg.replace(
                tt=TTConfig(**TT))
        jlm = j_build(jcfg)
        jp = jax.jit(lambda k: j_init(k, jlm))(jax.random.PRNGKey(3))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        _MODELS[tt] = (jlm, jp, t_build(tcfg), tp)
    return _MODELS[tt]


def _mixer(tt: bool = False):
    """Layer 0's MLA: (reference def, params, port def, params, cfgs)."""
    jlm, jp, tlm, tp = _models(tt)
    jpm = jax.tree.map(lambda a: a[0], jp["layers"]["sub_0"]["mixer"])
    return (jlm.period[0].mixer, jpm, tlm.period[0].mixer,
            tp["layers"][0]["sub_0"]["mixer"], jlm.cfg, tlm.cfg)


def _close(t, j):
    j = np.asarray(j)
    np.testing.assert_allclose(t.detach().numpy(), j, rtol=0,
                               atol=TOL * max(float(np.abs(j).max()), 1.0))


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# (a) the MLA functions
# ---------------------------------------------------------------------------

def _function_case(name):
    """(reference outputs, port outputs) of one MLA function."""
    jd, jpm, td, tpm, jcfg, tcfg = _mixer()
    rng = np.random.RandomState(7)
    m = jd.m
    j, t = jnp.asarray, torch.from_numpy
    if name == "forward":
        x, pos = _np(rng, 2, 6, 64), np.tile(np.arange(6, dtype=np.int32),
                                            (2, 1))
        return ([JA.mla_forward(jpm, j(x), jd, jcfg, causal=True,
                                positions=j(pos))],
                [TA.mla_forward(tpm, t(x), td, tcfg, causal=True,
                                positions=t(pos))])
    if name == "decode_q":
        x = _np(rng, 2, 3, 64)
        pos = np.array([[4, 5, 6], [0, 1, 2]], np.int32)
        return (JA.mla_decode_q(jpm, j(x), jd, jcfg, j(pos)),
                TA.mla_decode_q(tpm, t(x), td, tcfg, t(pos)))
    if name == "attend":
        q_abs, q_rope = _np(rng, 2, 3, 4, m.kv_lora_rank), _np(rng, 2, 3, 4, 8)
        ckv, kr = _np(rng, 2, 10, m.kv_lora_rank), _np(rng, 2, 10, 8)
        qpos = np.array([[2, 3, 4], [7, 8, 9]], np.int32)
        return ([JA.mla_attend(jpm, *map(j, (q_abs, q_rope, ckv, kr)), jd,
                               jcfg, j(qpos))],
                [TA.mla_attend(tpm, *map(t, (q_abs, q_rope, ckv, kr)), td,
                               tcfg, t(qpos))])
    x = _np(rng, 2, 1, 64)
    cache = {"c_kv": _np(rng, 2, 10, m.kv_lora_rank),
             "k_rope": _np(rng, 2, 10, 8)}
    cur = np.array([3, 7], np.int32) if name == "decode" else 5
    jy, jc = JA.mla_decode(jpm, j(x), {k: j(v) for k, v in cache.items()},
                           jd, jcfg, j(cur))
    ty, tc = TA.mla_decode(tpm, t(x), {k: t(v) for k, v in cache.items()},
                           td, tcfg, torch.as_tensor(cur))
    return [jy, jc["c_kv"], jc["k_rope"]], [ty, tc["c_kv"], tc["k_rope"]]


@pytest.mark.parametrize("name", ["forward", "decode_q", "attend", "decode",
                                  "decode shared length"])
def test_mla_functions_match_jax(name):
    want, got = _function_case(name)
    assert len(want) == len(got)
    for j, t in zip(want, got):
        assert tuple(t.shape) == tuple(j.shape)
        _close(t, j)


@pytest.mark.parametrize("tt", [False, True], ids=["dense", "tt"])
@pytest.mark.parametrize("site", ["k_up", "v_up"])
def test_absorb_weight_matches_jax(site, tt):
    jd, jpm, td, tpm, jcfg, tcfg = _mixer(tt)
    assert getattr(td, site).use_tt == tt
    assert ("w" in tpm[site]) != tt
    want = JA._absorb_weight(jpm[site], getattr(jd, site), jcfg)
    got = TA._absorb_weight(tpm[site], getattr(td, site), tcfg)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)
    if tt:
        # the absorbed queries go through the materialized TT weight
        x = _np(np.random.RandomState(2), 2, 1, 64)
        pos = np.array([[3], [8]], np.int32)
        for j, t in zip(JA.mla_decode_q(jpm, jnp.asarray(x), jd, jcfg,
                                        jnp.asarray(pos)),
                        TA.mla_decode_q(tpm, torch.from_numpy(x), td, tcfg,
                                        torch.from_numpy(pos))):
            _close(t, j)


# ---------------------------------------------------------------------------
# (b) the LM
# ---------------------------------------------------------------------------

def test_lm_forward_logits_and_caches_match_jax():
    jlm, jp, tlm, tp = _models()
    tokens = np.random.RandomState(5).randint(0, 128, (2, 12)).astype(
        np.int32)
    jl, ja, jc = JL.lm_forward(jp, jlm, PLAN, tokens=jnp.asarray(tokens),
                               return_cache=True)
    tl, ta, tc = TL.lm_forward(tp, tlm, tokens=torch.from_numpy(tokens),
                               return_cache=True)
    _close(tl, jl)
    _close(ta, ja)
    assert set(tc["sub_0"]) == {"c_kv", "k_rope"}
    for name in ("c_kv", "k_rope"):
        assert tuple(tc["sub_0"][name].shape) == jc["sub_0"][name].shape
        _close(tc["sub_0"][name], jc["sub_0"][name])


def test_lm_decode_step_matches_jax():
    jlm, jp, tlm, tp = _models()
    jcache = JL.lm_init_cache(jlm, 2, 16, PLAN)
    tcache = TL.lm_init_cache(tlm, 2, 16, device="cpu")
    assert {k: tuple(v.shape) for k, v in tcache["sub_0"].items()} == {
        k: v.shape for k, v in jcache["sub_0"].items()}
    rng = np.random.RandomState(6)
    cur = np.array([0, 4], np.int32)
    for step in range(3):
        tok = rng.randint(0, 128, (2, 1)).astype(np.int32)
        jl, jcache = JL.lm_decode_step(jp, jcache, jnp.asarray(tok),
                                       jnp.asarray(cur + step), jlm, PLAN)
        tl, tcache = TL.lm_decode_step(tp, tcache, torch.from_numpy(tok),
                                       torch.from_numpy(cur + step), tlm)
        _close(tl, jl)
        for name in ("c_kv", "k_rope"):
            _close(tcache["sub_0"][name], jcache["sub_0"][name])


# ---------------------------------------------------------------------------
# (c) the pool through the three wrappers
# ---------------------------------------------------------------------------

SLOTS, PAGE, PPS, LAYERS = 3, 4, 3, 2
TRASH = SLOTS * PPS
FEATS = {"mla": {"c_kv": (32,), "k_rope": (8,)},
         "gqa": {"k": (2, 8), "v": (2, 8)}}
POOL = dict(num_slots=SLOTS, page_size=PAGE, pages_per_slot=PPS,
            quantized=True)


def _pool_case(kind, seed=0):
    """A seeded int8 pool of one sublayer (random codes everywhere, random
    per-slot scales), a page table and the tokens each write takes."""
    rng = np.random.RandomState(seed)
    feats = FEATS[kind]
    data = {n: rng.randint(-128, 128, (LAYERS, TRASH + 1, PAGE) + f).astype(
        np.int8) for n, f in feats.items()}
    scale = {n: rng.randint(-6, 0, (LAYERS, SLOTS)).astype(np.float32)
             for n in feats}
    table = rng.permutation(TRASH).reshape(SLOTS, PPS).astype(np.int32)

    def tokens(*lead):
        return {n: (_np(rng, *lead, *f) * 4).astype(np.float32)
                for n, f in feats.items()}
    return dict(data=data, scale=scale, table=table, decode=tokens(SLOTS, 1),
                chunk=tokens(6), prefill=tokens(LAYERS, 1, 9))


def _port_pool(c):
    return {"data": {"sub_0": {n: torch.from_numpy(a.copy())
                               for n, a in c["data"].items()}},
            "scale_log2": {"sub_0": {n: torch.from_numpy(a.copy())
                                     for n, a in c["scale"].items()}}}


def _jax_op(op, c):
    """(data, scale) of the reference after ``op``: layer 0 for the
    per-layer writes, every layer for the prefill; the read's views."""
    pcfg = JPC(**POOL)
    names = list(c["data"])
    j = jnp.asarray
    lens, active = j(np.array([1, 5, 11], np.int32)), j(np.array(
        [True, False, True]))
    if op == "read":
        return [np.asarray(JKC.gather_slots(j(c["data"][n][0]),
                                            j(c["scale"][n][0]),
                                            j(c["table"]), pcfg,
                                            jnp.float32)) for n in names]
    if op == "prefill":
        pool = {"data": {"sub_0": {n: j(c["data"][n]) for n in names}},
                "scale_log2": {"sub_0": {n: j(c["scale"][n]) for n in names}}}
        out = JKC.write_prefill(pool, {"sub_0": {n: j(c["prefill"][n])
                                                 for n in names}},
                                j(c["table"][1]), 1, 7, pcfg)
        return [np.asarray(out["data"]["sub_0"][n]) for n in names] + [
            np.asarray(out["scale_log2"]["sub_0"][n]) for n in names]
    out = []
    for n in names:
        d, s = j(c["data"][n][0]), j(c["scale"][n][0])
        if op == "append":
            out.append(np.asarray(JKC.append_token(
                d, s, j(c["decode"][n]), j(c["table"]), lens, active, pcfg)))
        else:
            out.append(np.asarray(JKC.write_chunk(
                d, s, j(c["chunk"][n]), j(c["table"][2]), jnp.int32(3),
                jnp.int32(5), jnp.int32(2), pcfg)[0]))
    return out


def _port_op(op, c):
    """What the engine's calls leave, as ``_jax_op``; and the wrapper's C
    arguments for the same call (its kernel's widths)."""
    pcfg = PoolConfig(**POOL)
    pool = _port_pool(c)
    names = list(c["data"])
    a, b = names
    d, s = pool["data"]["sub_0"], pool["scale_log2"]["sub_0"]
    t = torch.from_numpy
    table = t(c["table"])
    if op == "read":
        args = (d[a][0], d[b][0], s[a][0], s[b][0], table)
        views = TKC.read_kv(*args, pcfg, torch.float32)
        return [v.numpy() for v in views], KR.c_args(*args,
                                                     dtype=torch.float32)[0]
    if op == "prefill":
        new = {n: t(c["prefill"][n]) for n in names}
        length = torch.tensor([7], dtype=torch.int32)
        TKC.write_prefill(pool, {"sub_0": new}, table[1], 1, length, pcfg)
        cargs = KP.c_args(d[a], d[b], s[a], s[b], new[a][:, 0], new[b][:, 0],
                          table[1], 1, length, page_size=PAGE, bits=8)[0]
        return [d[n].numpy() for n in names] + [s[n].numpy()
                                                 for n in names], cargs
    if op == "append":
        lens = torch.tensor([1, 5, 11], dtype=torch.int32)
        active = torch.tensor([True, False, True])
        new = {n: t(c["decode"][n]) for n in names}
        args = (d[a][0], d[b][0], s[a][0], s[b][0], new[a], new[b], table,
                lens, active)
        TKC.append_kv(*args, pcfg)
        kw = {}
    else:
        # the chunk step's call: the slot's row and (1,) scale views
        new = {n: t(c["chunk"][n])[None] for n in names}
        start, valid = (torch.tensor([v], dtype=torch.int32) for v in (3, 5))
        args = (d[a][0], d[b][0], s[a][0, 2:3], s[b][0, 2:3], new[a], new[b],
                table[2][None], start)
        TKC.write_chunk_kv(*args, valid, pcfg)
        args = args + (None,)
        kw = dict(n_valid=valid, clamp_last=True)
    cargs = KA.c_args(*args, page_size=PAGE, bits=8, **kw)[0]
    return [d[n][0].numpy() for n in names], cargs


# where each wrapper passes K's and V's widths among its C arguments
WIDTHS = {"append": (KA, 21, 22), "chunk": (KA, 21, 22),
          "prefill": (KP, 21, 22), "read": (KR, 12, 13)}


@pytest.mark.parametrize("op", ["append", "chunk", "prefill", "read"])
@pytest.mark.parametrize("kind", ["mla", "gqa"])
def test_pool_twins_equal_jax_bit_for_bit(kind, op):
    c = _pool_case(kind, seed=len(op))
    want = _jax_op(op, c)
    got, cargs = _port_op(op, c)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        if g.dtype == np.int8:
            # every real page (the trash page, the last, is scratch)
            real = (slice(None), slice(TRASH)) if op == "prefill" else (
                slice(TRASH),)
            g, w = g[real], w[real]
        np.testing.assert_array_equal(g, w)
    mod, ki, vi = WIDTHS[op]
    per_page = PAGE if op == "read" else 1
    widths = [int(np.prod(f)) * per_page for f in FEATS[kind].values()]
    assert [cargs[ki], cargs[vi]] == widths
    assert (widths[0] == widths[1]) == (kind == "gqa")
    assert len(cargs) + 1 == len(mod.ARGTYPES)          # and the stream
