"""The decode step's grouped state launches of repro_torch, on the CPU.

On the card a decode step reads the whole recurrent-state pool in one
``csrc/state_codec.cu::st_dec_group`` launch before its first layer and
writes every layer's new state in one ``st_enc_group`` launch after its
last (``serve/state_cache.py`` ``read_step`` / ``write_step`` through
``numerics/cuda_backend.py`` ``state_decode_many`` / ``state_encode_many``).
Here, where no kernel runs, the tests hold what those launches rest on:

(a) the launch plans (``kernels/grouped.py`` ``st_dec_plan`` /
    ``st_enc_plan``), pure functions of the shapes: one launch each way at
    rwkv6-1.6b's and jamba-1.5-large's full shapes, the caps, the tables
    within a launch's 4 KB, and mirrors of the kernels' index arithmetic:
    a decode unit never straddles a row, every element of every row is
    decoded once, every (layer, slot) row is encoded by one cluster or one
    CTA, a cluster's CTAs cover the row's units once;
(b) ``read_step`` / ``write_step`` (their plain twins) against a loop of
    ``read_layer`` / ``write_layer``, codes, scales and values bit for
    bit, on int8 and model-dtype pools in f32 and bf16, one and several
    slots, a mixed ``active``, an all-zero row and rows whose max sits at
    ``127 * 2^k`` and the three values either side; the engine's decode
    step reads once and writes once a step;
(c) the same step functions on seeded random inputs equal to a loop of
    the JAX reference's ``read_layer`` / ``write_layer`` (the scale edges
    left out: XLA's CPU ``log2`` rounds differently next to an integer,
    locked by ``tests/test_torch_kv_prefill.py``).

Inputs are made with numpy from a seed. Tolerance: none, all bit-exact.
"""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as JC  # noqa: E402
from repro.configs.base import MoEConfig as JMoE  # noqa: E402
from repro.models import build_lm as j_build  # noqa: E402
from repro.serve import state_cache as JSC  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.kernels import grouped as G  # noqa: E402
from repro_torch.models import build_lm as t_build  # noqa: E402
from repro_torch.numerics import cuda_backend as CB  # noqa: E402
from repro_torch.serve import state_cache as TSC  # noqa: E402

CPU = torch.device("cpu")
ARCHS = ["rwkv6-1.6b", "jamba-1.5-large"]


def _over(arch):
    return {"moe": MoEConfig(num_experts=0)} if arch.startswith("jamba") \
        else {}


def _step_entries(lm, slots=8):
    """(layers, slots, feat, itemsize) of every state tensor of ``lm``'s
    pool, in the order ``write_step`` passes them."""
    out = []
    for sub in lm.period:
        for f, kind in TSC.state_feature_shapes(sub, lm.cfg).values():
            out.append((lm.n_periods, slots, math.prod(f),
                        TSC.natural_dtype(kind, lm.cfg).itemsize))
    return out


# ---------------------------------------------------------------------------
# (a) the launch plans
# ---------------------------------------------------------------------------

def test_st_tables_fit_a_launch():
    dec, enc = G.st_table_bytes()
    assert dec <= 4096 and enc <= 4096
    assert (dec, enc) == (656, 3240)


@pytest.mark.parametrize("arch,periods", [("rwkv6-1.6b", None),
                                          ("jamba-1.5-large", 1),
                                          ("jamba-1.5-large", None)])
def test_st_plans_at_full_shapes(arch, periods):
    """rwkv6-1.6b (24 layers: shift, wkv, shift_ffn) and jamba-1.5-large's
    period (one, as the card serves it, and all nine: 7 Mamba layers x
    conv, h): one launch each way; the large rows (wkv 512 KB, h 1 MB,
    conv 96 KB) take clusters, rwkv6's shift (4 KB) a CTA a row."""
    lm = t_build(TC.get_config(arch).replace(**_over(arch)))
    if periods:
        lm = dataclasses.replace(lm, n_periods=periods)
    ents = _step_entries(lm)
    (dec,) = G.st_dec_plan([(n * b, f) for n, b, f, _ in ents])
    (enc,) = G.st_enc_plan(ents)
    assert list(dec.index) == list(range(len(ents)))
    assert enc.ptrs == sum(n for n, *_ in ents) <= G.ST_PTR_CAP
    big = {f: G.st_big(f, i) for _, _, f, i in ents}
    if arch == "rwkv6-1.6b":
        assert len(ents) == 3 and ents[1][2] == 32 * 64 * 64
        assert big == {2048: False, 131072: True}
        assert dec.units == (24 * 8 * 128, 24 * 8 * 8192, 24 * 8 * 128)
        small = 24 * 8 // G.ST_CLUSTER      # shift rows, one CTA each
        assert enc.task_end == (small, small + 192, 2 * small + 192)
        assert enc.stage_bytes == 8192 * 16 * 4 // G.ST_CLUSTER
    else:
        assert len(ents) == 14
        assert big == {3 * 16384: True, 16384 * 16: True}
        assert enc.tasks == 14 * lm.n_periods * 8
    assert enc.stage                # 32 KB (rwkv6) or 64 KB (jamba) a CTA
    assert [p.ptr0 for p in enc.pieces] == list(
        np.cumsum([0] + [p.layers for p in enc.pieces[:-1]]))


def test_st_plans_chunk_above_their_caps():
    """More tensors than ``ST_CAP`` take a second decode launch; more
    layers than ``ST_PTR_CAP`` split a tensor's layers over launches, every
    (tensor, layer) placed once, in order; empty tensors take no piece."""
    dec = G.st_dec_plan([(8, 5)] * 20)
    assert [list(d.index) for d in dec] == [list(range(16)),
                                           list(range(16, 20))]
    assert dec[0].tile_end[-1] == 16 and dec[1].units == (8,) * 4
    ents = [(100, 3, 40, 4), (100, 3, 20000, 4), (0, 3, 7, 4),
            (5, 0, 7, 4), (100, 3, 7, 2)]
    plan = G.st_enc_plan(ents)
    seen = []
    for launch in plan:
        assert len(launch.pieces) <= G.ST_CAP
        assert launch.ptrs <= G.ST_PTR_CAP
        for pc in launch.pieces:
            seen += [(pc.entry, pc.layer0 + i) for i in range(pc.layers)]
    assert seen == [(e, lay) for e, (n, b, *_) in enumerate(ents)
                    if b for lay in range(n)]
    assert [launch.ptrs for launch in plan] == [160, 140]
    many = G.st_enc_plan([(1, 2, 9, 4)] * 20)
    assert [len(m.pieces) for m in many] == [16, 4]
    assert G.st_enc_plan([]) == [] and G.st_dec_plan([]) == []


@pytest.mark.parametrize("feat", [1, 15, 16, 37, 2048, 4112])
def test_st_dec_units_never_straddle_a_row(feat):
    """A mirror of ``st_dec_group_kernel``'s index arithmetic: each unit
    lies in one row (one scale), and the units cover every element of
    every row once."""
    rows = 3
    (launch,) = G.st_dec_plan([(rows, feat)])
    upr = -(-feat // G.ST_UNIT)
    hit = np.zeros(rows * feat, np.int64)
    for tile in range(launch.tiles):
        for t in range(G.ST_TILE):
            u = tile * G.ST_TILE + t
            if u >= launch.units[0]:
                continue
            r, c = divmod(u, upr)
            c *= G.ST_UNIT
            n = min(G.ST_UNIT, feat - c)
            assert 0 < n <= G.ST_UNIT and c + n <= feat
            hit[r * feat + c:r * feat + c + n] += 1
    assert (hit == 1).all()


@pytest.mark.parametrize("feat,itemsize", [(131072, 4), (2048, 2),
                                           (49152, 2), (16385, 4), (3, 4)])
def test_st_enc_tasks_cover_every_row_once(feat, itemsize):
    """A mirror of ``st_enc_group_kernel``'s task arithmetic: a large row
    is one cluster whose CTAs take disjoint runs of units covering the row;
    a small row is one CTA of a task of ``ST_CLUSTER`` rows."""
    layers, slots = 3, 5
    (launch,) = G.st_enc_plan([(layers, slots, feat, itemsize)])
    (pc,) = launch.pieces
    units = -(-feat // G.ST_UNIT)
    cover = {}
    for cta in range(launch.ctas):
        task, rank = divmod(cta, G.ST_CLUSTER)
        row = task if pc.big else task * G.ST_CLUSTER + rank
        if row >= pc.rows:
            assert not pc.big
            continue
        u0, u1 = 0, units
        if pc.big:
            per = -(-units // G.ST_CLUSTER)
            u0 = min(rank * per, units)
            u1 = min(u0 + per, units)
        cover.setdefault(row, []).append((u0, u1))
    assert sorted(cover) == list(range(layers * slots))
    for spans in cover.values():
        spans.sort()
        assert spans[0][0] == 0 and spans[-1][1] == units
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert pc.big == (feat * itemsize >= G.ST_BIG_BYTES)
    assert launch.stage_bytes == (units * G.ST_UNIT * itemsize if not pc.big
                                  else -(-units // G.ST_CLUSTER)
                                  * G.ST_UNIT * itemsize)
    assert launch.stage == (launch.stage_bytes <= G.ST_STAGE_MAX)


# ---------------------------------------------------------------------------
# (b) the step functions against the per-layer primitives
# ---------------------------------------------------------------------------

def _edge_values(dt, k):
    """``127 * 2^k`` in ``dt`` and the three values of ``dt`` either side."""
    iv = torch.int16 if dt == torch.bfloat16 else torch.int32
    base = torch.tensor([127.0 * 2.0 ** k], dtype=dt).view(iv)
    return [(base + d).view(dt) for d in range(-3, 4)]


def _pool_and_states(lm, slots, quantized, seed, edges=True):
    """A filled state pool of ``lm`` (random codes and scales, or random
    values), the dtypes the step reads it in, and new states for every
    (layer, tensor), each row at its own magnitude; with ``edges`` the
    first tensor's first rows hold their max at ``127 * 2^k`` (k = -3)
    and its neighbours, the second's at k = 2, and one row is all zero."""
    rng = np.random.RandomState(seed)
    pool = TSC.init_state_pool(lm, slots, TSC.StateCacheConfig(
        quantized=quantized), CPU)
    dtypes, new, order = {}, {}, []
    for i, sub in enumerate(lm.period):
        for name, (f, kind) in TSC.state_feature_shapes(sub, lm.cfg).items():
            key, dt = f"sub_{i}", TSC.natural_dtype(kind, lm.cfg)
            dtypes.setdefault(key, {})[name] = dt
            d = pool["data"][key][name]
            if quantized:
                d.copy_(torch.from_numpy(rng.randint(
                    -128, 128, d.shape).astype(np.int8)))
                pool["scale_log2"][key][name].copy_(torch.from_numpy(
                    rng.randint(-9, 3, d.shape[:2]).astype(np.float32)))
            else:
                d.copy_(torch.from_numpy(rng.randn(*d.shape).astype(
                    np.float32)).to(d.dtype))
            mags = 2.0 ** rng.randint(-6, 7, d.shape[:2] + (1,) * len(f))
            new.setdefault(key, {})[name] = [
                torch.from_numpy((rng.randn(slots, *f) * mags[lay]).astype(
                    np.float32)).to(dt) for lay in range(d.shape[0])]
            order.append((key, name))
    if edges:
        cells = [(lay, b) for lay in range(lm.n_periods)
                 for b in range(slots)]
        for (key, name), k in zip(order[:2], (-3, 2)):
            for (lay, b), v in zip(cells, _edge_values(
                    dtypes[key][name], k)):
                row = new[key][name][lay][b].reshape(-1)
                row.copy_((row.float() / row.float().abs().max()
                           * float(v) / 2).to(row.dtype))
                row[0] = -v if b % 2 else v
        key, name = order[-1]
        new[key][name][-1][0].zero_()
    return pool, dtypes, new


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def _bits(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16)
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_pools_equal(a, b):
    for part in ("data", "scale_log2"):
        for key, kinds in a[part].items():
            for name, t in kinds.items():
                assert torch.equal(_bits(t), _bits(b[part][key][name])), \
                    (part, key, name)


def _lm(arch, dtype, layers=2):
    lm = t_build(TC.get_reduced(arch).replace(dtype=dtype, **_over(arch)))
    return dataclasses.replace(lm, n_periods=layers)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("slots", [1, 4])
def test_read_step_matches_read_layer_loop(arch, dtype, quantized, slots):
    lm = _lm(arch, dtype)
    pool, dtypes, _ = _pool_and_states(lm, slots, quantized, seed=slots)
    scfg = TSC.StateCacheConfig(quantized=quantized)
    got = TSC.read_step(pool, dtypes, scfg)
    assert sorted(got) == sorted(dtypes)
    for key, kinds in dtypes.items():
        for name, dt in kinds.items():
            d, s = pool["data"][key][name], pool["scale_log2"][key][name]
            want = torch.stack([TSC.read_layer(d[lay], s[lay], dt, scfg)
                                for lay in range(d.shape[0])])
            assert got[key][name].dtype == dt
            assert torch.equal(_bits(got[key][name]), _bits(want))
            if not quantized and d.dtype == dt:
                assert got[key][name].data_ptr() == d.data_ptr()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("slots,active", [(4, [True, False, True, True]),
                                          (1, [True]), (3, [False] * 3)])
def test_write_step_matches_write_layer_loop(arch, dtype, quantized, slots,
                                             active):
    """Codes and scales bit for bit with ``write_layer`` a (layer, tensor)
    on a copy of the pool, written in place; inactive slots keep their
    codes and scales; the scale edges land where ``write_layer`` puts
    them."""
    lm = _lm(arch, dtype)
    pool, _, new = _pool_and_states(lm, slots, quantized, seed=7 + slots)
    scfg = TSC.StateCacheConfig(quantized=quantized)
    act = torch.tensor(active)
    ref, before = _clone(pool), _clone(pool)
    for key, kinds in new.items():
        for name, layers in kinds.items():
            for lay, x in enumerate(layers):
                TSC.write_layer(ref["data"][key][name][lay],
                                ref["scale_log2"][key][name][lay], x, act,
                                scfg)
    ptrs = [t.data_ptr() for t in pool["data"]["sub_0"].values()]
    assert TSC.write_step(pool, new, act, scfg) is pool
    assert [t.data_ptr() for t in pool["data"]["sub_0"].values()] == ptrs
    _assert_pools_equal(pool, ref)
    off = ~act
    for part in ("data", "scale_log2"):
        for key, kinds in pool[part].items():
            for name, t in kinds.items():
                assert torch.equal(_bits(t[:, off]),
                                   _bits(before[part][key][name][:, off]))


def test_write_step_scale_edges():
    """At the edges the scale follows ``per_tensor_max`` exactly: a max of
    ``127 * 2^k`` codes to 127 under 2^k, the next value up moves to
    2^(k+1); an all-zero row takes the floor's scale and zero codes."""
    lm = _lm("rwkv6-1.6b", "float32", layers=1)
    pool, _, new = _pool_and_states(lm, 8, True, seed=3)
    TSC.write_step(pool, new, torch.ones(8, dtype=torch.bool),
                   TSC.StateCacheConfig(quantized=True))
    first = next(iter(pool["scale_log2"]["sub_0"]))
    s = pool["scale_log2"]["sub_0"][first][0]
    assert s[:4].tolist() == [-3.0] * 4 and s[4:7].tolist() == [-2.0] * 3
    codes = pool["data"]["sub_0"][first][0].reshape(8, -1)
    assert codes[3, 0] == -127 and codes[2, 0] == 127
    last = list(pool["data"]["sub_0"])[-1]
    assert not pool["data"]["sub_0"][last][0, 0].any()
    assert pool["scale_log2"]["sub_0"][last][0, 0] == math.ceil(
        math.log2(np.float32(1e-8) / np.float32(127)))


def test_state_group_wrappers_route_cpu_tensors_to_their_twins(monkeypatch):
    """CPU tensors run the plain twins (no kernel); a malformed call
    raises before any work."""
    calls = []
    for name in ("state_decode_many_plain", "state_encode_many_plain"):
        real = getattr(CB, name)
        monkeypatch.setattr(CB, name, lambda *a, _n=name, _f=real:
                            (calls.append(_n), _f(*a))[1])
    q = torch.zeros((2, 3, 4), dtype=torch.int8)
    s = torch.zeros((2, 3))
    CB.state_decode_many([q], [s], [torch.float32])
    CB.state_encode_many([q], [s], [[torch.ones(3, 4)] * 2],
                         torch.ones(3, dtype=torch.bool), 8)
    assert calls == ["state_decode_many_plain", "state_encode_many_plain"]
    with pytest.raises(ValueError, match="new states for"):
        CB.state_encode_many([q], [s], [[torch.ones(3, 4)]],
                             torch.ones(3, dtype=torch.bool), 8)
    with pytest.raises(ValueError, match="scales"):
        CB.state_decode_many([q], [torch.zeros(2, 4)], [torch.float32])
    with pytest.raises(ValueError, match="slots"):
        CB.state_encode_many([q], [s], [[torch.ones(3, 4)] * 2],
                             torch.ones(4, dtype=torch.bool), 8)


@pytest.mark.parametrize("quantized", [False, True])
def test_engine_decode_step_reads_and_writes_the_pool_once(monkeypatch,
                                                           quantized):
    """The engine's decode step calls ``read_step`` and ``write_step`` once
    each and no per-layer read (the chunk step and the prefill keep
    theirs); a model-dtype pool's ``write_step`` is ``write_layer``'s
    masked copy a (layer, tensor), an int8 pool's one group write."""
    from repro_torch.models import init_lm
    from repro_torch.serve import Engine, EngineConfig, PoolConfig
    lm = t_build(TC.get_reduced("jamba-1.5-large").replace(
        dtype="float32", moe=MoEConfig(num_experts=0)))
    params = init_lm(torch.Generator().manual_seed(0), lm, device="cpu")
    eng = Engine(lm, params, EngineConfig(pool=PoolConfig(
        num_slots=2, page_size=8, pages_per_slot=4, quantized=quantized)),
        device="cpu")
    eng.submit([3, 1, 4, 1, 5], max_new_tokens=4)
    eng.step()                                      # the prefill
    calls = []
    for name in ("read_step", "write_step", "read_layer", "write_layer"):
        real = getattr(TSC, name)
        monkeypatch.setattr(TSC, name, lambda *a, _n=name, _f=real:
                            (calls.append(_n), _f(*a))[1])
    eng.step()
    eng.step()
    per = 0 if quantized else lm.n_periods * sum(
        len(TSC.state_feature_shapes(sub, lm.cfg)) for sub in lm.period)
    assert per != 0 or quantized
    assert calls == (["read_step", "write_step"] + ["write_layer"] * per) * 2


# ---------------------------------------------------------------------------
# (c) against the JAX reference's per-layer loop
# ---------------------------------------------------------------------------

def _j_lm(arch, layers):
    jo = {"moe": JMoE(num_experts=0)} if arch.startswith("jamba") else {}
    return dataclasses.replace(j_build(JC.get_reduced(arch).replace(
        dtype="float32", **jo)), n_periods=layers)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("quantized", [False, True])
def test_step_functions_match_the_jax_layer_loop(arch, quantized):
    """Seeded random pool and new states through JAX's ``read_layer`` /
    ``write_layer`` a (layer, tensor) and through the port's ``read_step``
    / ``write_step``: decoded values, codes and scales bit for bit, with
    a mixed ``active``."""
    lm = _lm(arch, "float32", layers=3)
    pool, dtypes, new = _pool_and_states(lm, 4, quantized, seed=21,
                                         edges=False)
    jlm = _j_lm(arch, 3)
    scfg_t = TSC.StateCacheConfig(quantized=quantized)
    scfg_j = JSC.StateCacheConfig(quantized=quantized)
    jp = JSC.init_state_pool(jlm, 4, scfg_j)
    active = np.array([True, False, True, True])
    read = TSC.read_step(pool, dtypes, scfg_t)
    want = {}
    for key, kinds in dtypes.items():
        for name in kinds:
            jd = jnp.asarray(pool["data"][key][name].numpy())
            js = jnp.asarray(pool["scale_log2"][key][name].numpy())
            ja = jp["data"][key][name]
            assert ja.shape == tuple(pool["data"][key][name].shape)
            jdt = jnp.float32 if quantized else ja.dtype
            datas, scales = [], []
            for lay in range(3):
                got = JSC.read_layer(jd[lay], js[lay], jdt, scfg_j)
                assert np.array_equal(np.asarray(got),
                                      read[key][name][lay].numpy())
                d2, s2 = JSC.write_layer(
                    jd[lay], js[lay],
                    jnp.asarray(new[key][name][lay].numpy()),
                    jnp.asarray(active), scfg_j)
                datas.append(np.asarray(d2))
                scales.append(np.asarray(s2))
            want[key, name] = (np.stack(datas), np.stack(scales))
    TSC.write_step(pool, new, torch.from_numpy(active), scfg_t)
    for (key, name), (jd, js) in want.items():
        assert np.array_equal(pool["data"][key][name].numpy(), jd)
        assert np.array_equal(pool["scale_log2"][key][name].numpy(), js)
