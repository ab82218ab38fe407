"""The chunk step's and the prefill's one-slot state launches of
repro_torch, on the CPU.

On the card a chunk step reads its slot's state of every layer in one
``csrc/state_codec.cu::st_dec_slot`` launch before its first layer and
writes every layer's end-of-chunk state in one ``st_enc_slot`` launch
after its last; a whole-prompt prefill writes the slot's every layer in
one ``st_enc_slot`` (``serve/state_cache.py`` ``read_slot`` /
``write_slot_step`` / ``write_prefill`` through ``numerics/cuda_backend.py``
``state_decode_slot`` / ``state_encode_slot``, the slot's index an int32 on
the device). Here, where no kernel runs, the tests hold what those
launches rest on:

(a) the launch plans at one slot (``kernels/grouped.py`` ``st_dec_plan``
    with rows = layers, ``st_enc_plan`` with slots = 1): one launch each
    way at rwkv6-1.6b's 24 layers and jamba-1.5-large's period, and
    mirrors of the one-slot kernels' index arithmetic: the decode reads
    every code and scale of the slot once and nothing of another slot,
    the encode writes every (layer) row of the slot once and no other;
(b) the step functions (their plain twins) against the JAX reference:
    ``read_slot`` against ``read_layer(sd[slot][None], ss[slot][None])`` a
    layer, ``write_slot_step`` against ``write_slot`` a layer and
    ``write_prefill`` against JAX's ``write_prefill``, codes, scales and
    values bit for bit, rwkv6 and jamba, f32 and bf16, int8 and
    model-dtype pools, 1 and 4 slots, the slot first, middle and last,
    every other slot's codes and scales untouched;
(c) the scale edges (a max at ``127 * 2^k`` and the three f32 or bf16
    values either side) and an all-zero state, bit for bit with the
    port's per-layer ``write_slot`` (JAX is left out here: XLA's CPU
    ``log2`` rounds differently next to an integer, locked by
    ``tests/test_torch_kv_prefill.py``);
(d) the wrappers route CPU tensors to their twins and refuse malformed
    calls; the engine's chunk step reads and writes the slot once each,
    its prefill writes it once.

Inputs are made with numpy from a seed. Tolerance: none, all bit-exact.
"""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serve import state_cache as JSC  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.kernels import grouped as G  # noqa: E402
from repro_torch.models import build_lm as t_build  # noqa: E402
from repro_torch.numerics import cuda_backend as CB  # noqa: E402
from repro_torch.serve import state_cache as TSC  # noqa: E402

CPU = torch.device("cpu")
ARCHS = ["rwkv6-1.6b", "jamba-1.5-large"]
# (slots, which slot): one slot, and the first, a middle and the last of 4
SLOTS = [(1, "first"), (4, "first"), (4, "middle"), (4, "last")]


def _over(arch):
    return ({"moe": MoEConfig(num_experts=0)} if arch.startswith("jamba")
            else {})


def _slot(slots, where):
    return {"first": 0, "middle": slots // 2, "last": slots - 1}[where]


def _bits(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16)
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _np(t):
    """A torch tensor as numpy, bf16 kept as JAX's bf16."""
    if t.dtype == torch.bfloat16:
        return np.asarray(jnp.asarray(t.float().numpy(), jnp.bfloat16))
    return t.numpy()


def _same(j, t):
    """A JAX array and a torch tensor bit for bit."""
    j = np.asarray(j)
    if t.dtype == torch.bfloat16:
        return np.array_equal(j.view(np.int16), _bits(t).numpy())
    return np.array_equal(j.view(np.int32) if j.dtype == np.float32 else j,
                          _bits(t).numpy())


def _lm(arch, dtype, layers=3):
    lm = t_build(TC.get_reduced(arch).replace(dtype=dtype, **_over(arch)))
    return dataclasses.replace(lm, n_periods=layers)


def _case(lm, slots, quantized, seed):
    """A filled state pool of ``lm`` (random codes and scales, or random
    values), the dtypes a step reads it in, and one slot's new states, a
    (1, *feat) a (layer, tensor), each at its own magnitude."""
    rng = np.random.RandomState(seed)
    pool = TSC.init_state_pool(lm, slots, TSC.StateCacheConfig(
        quantized=quantized), CPU)
    dtypes, new = {}, {}
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
            new.setdefault(key, {})[name] = [
                torch.from_numpy((rng.randn(1, *f) * 2.0 ** rng.randint(
                    -6, 7)).astype(np.float32)).to(dt)
                for _ in range(d.shape[0])]
    return pool, dtypes, new


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def _leaves(tree):
    for k in sorted(tree):
        v = tree[k]
        yield from (_leaves(v) if isinstance(v, dict) else [(k, v)])


def _assert_other_slots_untouched(pool, before, b):
    for part in ("data", "scale_log2"):
        for (_, t), (_, u) in zip(_leaves(pool[part]), _leaves(before[part])):
            off = torch.arange(t.shape[1]) != b
            assert torch.equal(_bits(t[:, off]), _bits(u[:, off]))


def _slot_t(b):
    return torch.tensor([b], dtype=torch.int32)


# ---------------------------------------------------------------------------
# (a) the launch plans at one slot
# ---------------------------------------------------------------------------

def _slot_entries(lm):
    """(layers, feat, itemsize) of every state tensor of ``lm``'s pool, in
    the order the one-slot launches take them."""
    return [(lm.n_periods, math.prod(f),
             TSC.natural_dtype(kind, lm.cfg).itemsize)
            for sub in lm.period
            for f, kind in TSC.state_feature_shapes(sub, lm.cfg).values()]


@pytest.mark.parametrize("arch,periods", [("rwkv6-1.6b", None),
                                          ("jamba-1.5-large", 1)])
def test_st_slot_plans_at_full_shapes(arch, periods):
    """rwkv6-1.6b's slot (24 layers x shift, wkv, shift_ffn) and jamba's
    period as the card serves it (7 Mamba layers x conv, h): one launch
    each way, every tensor's every layer once, within the caps; the large
    rows take clusters whose CTAs stage their parts (32 / 64 KB)."""
    lm = t_build(TC.get_config(arch).replace(**_over(arch)))
    if periods:
        lm = dataclasses.replace(lm, n_periods=periods)
    ents = _slot_entries(lm)
    (dec,) = G.st_dec_plan([(n, f) for n, f, _ in ents])
    (enc,) = G.st_enc_plan([(n, 1, f, i) for n, f, i in ents])
    assert list(dec.index) == list(range(len(ents))) and len(ents) <= G.ST_CAP
    assert dec.units == tuple(n * -(-f // G.ST_UNIT) for n, f, _ in ents)
    assert enc.ptrs == sum(n for n, *_ in ents) <= G.ST_PTR_CAP
    seen = [(pc.entry, pc.layer0 + i) for pc in enc.pieces
            for i in range(pc.layers)]
    assert seen == [(e, lay) for e, (n, *_) in enumerate(ents)
                    for lay in range(n)]
    assert all(pc.slots == 1 for pc in enc.pieces)
    if arch == "rwkv6-1.6b":
        assert [pc.big for pc in enc.pieces] == [False, True, False]
        assert enc.task_end == (2, 26, 28)      # 24 shift rows: 2 tasks of 16
        assert enc.stage_bytes == 8192 * 16 * 4 // G.ST_CLUSTER
    else:
        assert len(ents) == 14 and all(pc.big for pc in enc.pieces)
        assert enc.tasks == 14
        assert enc.stage_bytes == 16384 * 16 * 4 // G.ST_CLUSTER
    assert enc.stage
    # the yardstick: a CTA a row, the large rows re-read (no staging room)
    (cta,) = G.st_enc_plan([(n, 1, f, i) for n, f, i in ents], cluster=False)
    assert not any(pc.big for pc in cta.pieces) and not cta.stage


@pytest.mark.parametrize("feat,slots,b", [(16, 4, 0), (37, 4, 3),
                                          (2048, 8, 5), (4112, 3, 1),
                                          (1, 1, 0)])
def test_st_dec_slot_reads_only_its_slot(feat, slots, b):
    """A mirror of ``st_dec_slot_kernel``'s index arithmetic (``dec_tile``
    with SLOT): value c of the (L, 1, feat) workspace reads code c + r *
    (pool_slots - 1) * feat + b * feat and scale r * pool_slots + b (r = c
    / feat); over the plan's tiles every code and scale of slot b is read,
    each code once, and nothing of another slot."""
    layers = 3
    (launch,) = G.st_dec_plan([(layers, feat)])
    upr = -(-feat // G.ST_UNIT)
    codes = np.zeros(layers * slots * feat, np.int64)
    scales = set()
    for tile in range(launch.tiles):
        u0 = tile * G.ST_TILE
        u1 = min(u0 + G.ST_TILE, launch.units[0])
        c0 = (u0 // upr) * feat + (u0 % upr) * G.ST_UNIT
        c1 = (u1 // upr) * feat + (u1 % upr) * G.ST_UNIT
        for c in range(c0, c1):
            r = c // feat
            codes[c + r * (slots - 1) * feat + b * feat] += 1
            scales.add(r * slots + b)
    want = np.zeros((layers, slots, feat), np.int64)
    want[:, b] = 1
    assert np.array_equal(codes, want.reshape(-1))
    assert scales == {r * slots + b for r in range(layers)}


@pytest.mark.parametrize("feat,itemsize,slots,b", [(131072, 4, 8, 7),
                                                   (2048, 2, 8, 0),
                                                   (49152, 2, 4, 2),
                                                   (3, 4, 1, 0)])
def test_st_enc_slot_writes_only_its_slot(feat, itemsize, slots, b):
    """A mirror of ``st_enc_slot_kernel``'s task arithmetic: row l of a
    piece (slots 1) writes pool row l * pool_slots + b from its layer's
    new state; a large row is one cluster whose CTAs cover its units
    once; every layer's row of slot b is written once, no other."""
    layers = 5
    (launch,) = G.st_enc_plan([(layers, 1, feat, itemsize)])
    (pc,) = launch.pieces
    units = -(-feat // G.ST_UNIT)
    cover = {}
    for cta in range(launch.ctas):
        task, rank = divmod(cta, G.ST_CLUSTER)
        row = task if pc.big else task * G.ST_CLUSTER + rank
        if row >= pc.rows:
            continue
        u0, u1 = 0, units
        if pc.big:
            per = -(-units // G.ST_CLUSTER)
            u0 = min(rank * per, units)
            u1 = min(u0 + per, units)
        cover.setdefault((row * slots + b, pc.ptr0 + row), []).append(
            (u0, u1))
    assert sorted(cover) == [(lay * slots + b, lay) for lay in range(layers)]
    for spans in cover.values():
        spans.sort()
        assert spans[0][0] == 0 and spans[-1][1] == units
        assert all(x[1] == y[0] for x, y in zip(spans, spans[1:]))


@pytest.mark.parametrize("one_slot", [False, True])
def test_dec_tables_give_the_kernel_its_rows(one_slot):
    """The decode tables ``cuda_backend`` hands ``st_dec_group`` /
    ``st_dec_slot``: each entry's pool, scales and workspace, and units
    for every (layer, slot) row of the pool (the step form) or every layer
    of one slot (the one-slot form), as many as the workspace holds."""
    codes = [torch.zeros((3, 4, 2, 40), dtype=torch.int8),
             torch.zeros((5, 4, 16), dtype=torch.int8)]
    scales = [torch.zeros(q.shape[:2]) for q in codes]
    outs = [torch.empty((q.shape[0], 1 if one_slot else q.shape[1])
                        + tuple(q.shape[2:])) for q in codes]
    ((table, n),) = list(CB._st_dec_tables(codes, scales, outs,
                                           [torch.float32] * 2, one_slot))
    assert n == 2
    end = 0
    for e, (q, sc, y) in enumerate(zip(codes, scales, outs)):
        qp, sp, yp, units, tile_end, feat, dt = table[7 * e:7 * e + 7]
        assert (qp, sp, yp, dt) == (q.data_ptr(), sc.data_ptr(),
                                    y.data_ptr(), 0)
        assert feat == math.prod(q.shape[2:])
        rows = y.shape[0] * y.shape[1]
        assert units == rows * -(-feat // G.ST_UNIT)
        end += -(-units // G.ST_TILE)
        assert tile_end == end


@pytest.mark.parametrize("one_slot", [False, True])
def test_enc_tables_give_the_kernel_its_rows(monkeypatch, one_slot):
    """The encode tables ``cuda_backend`` hands ``st_enc_group`` /
    ``st_enc_slot``, past the pointer cap: each piece's codes and scales
    start at its first layer (slot 0), its rows are layers x slots (or
    layers), and its pointers are its layers' new states in order."""
    monkeypatch.setattr(CB.torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0})())
    layers, slots, feat = G.ST_PTR_CAP + 7, 3, 24
    q = torch.zeros((layers, slots, feat), dtype=torch.int8)
    sc = torch.zeros((layers, slots))
    news = [torch.zeros((1 if one_slot else slots, feat))
            for _ in range(layers)]
    launches = list(CB._st_enc_tables(
        "test", [q], [sc], [news], 8, 1 if one_slot else slots, slots,
        False, True))
    assert len(launches) == 2
    seen = 0
    for pieces, count, ptrs, nptr, bits, stage, smem, stream in launches:
        assert (count, bits, stream) == (1, 8, 0)
        qp, sp, f, dt, rows, ptr0, big, task_end = pieces[0:8]
        assert qp == q.data_ptr() + seen * slots * feat
        assert sp == sc.data_ptr() + 4 * seen * slots
        assert (f, dt, ptr0, big) == (feat, 0, 0, 0)
        assert rows == nptr * (1 if one_slot else slots)
        assert [ptrs[2 * i] for i in range(nptr)] == [
            n.data_ptr() for n in news[seen:seen + nptr]]
        assert all(ptrs[2 * i + 1] == feat for i in range(nptr))
        seen += nptr
    assert seen == layers


# ---------------------------------------------------------------------------
# (b) the step functions against the JAX reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("slots,where", SLOTS)
def test_read_slot_matches_jax_read_layer(arch, dtype, quantized, slots,
                                          where):
    """``read_slot`` layer l of tensor n: JAX's ``read_layer(sd[l][slot]
    [None], ss[l][slot][None])`` bit for bit (the chunk step's read), and
    the port's own ``read_layer`` of the same; a model-dtype pool's are
    views of the pool where the dtypes agree."""
    lm = _lm(arch, dtype)
    b = _slot(slots, where)
    pool, dtypes, _ = _case(lm, slots, quantized, seed=slots + 3)
    scfg = TSC.StateCacheConfig(quantized=quantized)
    scfg_j = JSC.StateCacheConfig(quantized=quantized)
    got = TSC.read_slot(pool, dtypes, b, scfg, _slot_t(b))
    for key, kinds in dtypes.items():
        for name, dt in kinds.items():
            d, s = pool["data"][key][name], pool["scale_log2"][key][name]
            y = got[key][name]
            assert y.dtype == dt and tuple(y.shape) == (
                d.shape[0], 1) + tuple(d.shape[2:])
            jd, js = jnp.asarray(_np(d)), jnp.asarray(s.numpy())
            jdt = jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32
            for lay in range(d.shape[0]):
                want = JSC.read_layer(jd[lay][b][None], js[lay][b][None],
                                      jdt, scfg_j)
                assert _same(want, y[lay]), (key, name, lay)
                assert torch.equal(_bits(y[lay]), _bits(TSC.read_layer(
                    d[lay][b][None], s[lay][b][None], dt, scfg)))
            if not quantized and d.dtype == dt:
                assert y.data_ptr() == d[:, b].data_ptr()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("slots,where", SLOTS)
def test_write_slot_step_matches_jax_write_slot(arch, dtype, quantized,
                                                slots, where):
    """``write_slot_step``: codes and scales bit for bit with JAX's
    ``write_slot`` a (layer, tensor) and with the port's own, written in
    place; every other slot's codes and scales untouched."""
    lm = _lm(arch, dtype)
    b = _slot(slots, where)
    pool, _, new = _case(lm, slots, quantized, seed=11 + slots)
    scfg = TSC.StateCacheConfig(quantized=quantized)
    scfg_j = JSC.StateCacheConfig(quantized=quantized)
    before, ref = _clone(pool), _clone(pool)
    want = {}
    for key, kinds in new.items():
        for name, layers in kinds.items():
            jd = jnp.asarray(_np(pool["data"][key][name]))
            js = jnp.asarray(pool["scale_log2"][key][name].numpy())
            datas, scales = [], []
            for lay, x in enumerate(layers):
                TSC.write_slot(ref["data"][key][name][lay],
                               ref["scale_log2"][key][name][lay], x[0], b,
                               scfg)
                d2, s2 = JSC.write_slot(jd[lay], js[lay],
                                        jnp.asarray(_np(x[0])), b, scfg_j)
                datas.append(np.asarray(d2))
                scales.append(np.asarray(s2))
            want[key, name] = (np.stack(datas), np.stack(scales))
    ptrs = [t.data_ptr() for _, t in _leaves(pool)]
    assert TSC.write_slot_step(pool, new, b, scfg, _slot_t(b)) is pool
    assert [t.data_ptr() for _, t in _leaves(pool)] == ptrs
    for (key, name), (jd, js) in want.items():
        assert _same(jd, pool["data"][key][name]), (key, name)
        assert np.array_equal(js, pool["scale_log2"][key][name].numpy())
    for (_, t), (_, u) in zip(_leaves(pool), _leaves(ref)):
        assert torch.equal(_bits(t), _bits(u))
    _assert_other_slots_untouched(pool, before, b)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("slots,where", SLOTS)
def test_write_prefill_matches_jax(arch, dtype, quantized, slots, where):
    """``write_prefill`` of a stacked (L, 1, *feat) prefill state: codes
    and scales bit for bit with JAX's ``write_prefill`` (a scale per
    layer); every other slot untouched."""
    lm = _lm(arch, dtype)
    b = _slot(slots, where)
    pool, _, new = _case(lm, slots, quantized, seed=23 + slots)
    state = {key: {name: torch.stack(layers) for name, layers in kinds.items()}
             for key, kinds in new.items()}
    jp = {part: {key: {name: jnp.asarray(_np(t)) for name, t in kinds.items()}
                 for key, kinds in pool[part].items()}
          for part in ("data", "scale_log2")}
    jstate = {key: {name: jnp.asarray(_np(t)) for name, t in kinds.items()}
              for key, kinds in state.items()}
    want = JSC.write_prefill(jp, jstate, b, JSC.StateCacheConfig(
        quantized=quantized))
    before = _clone(pool)
    TSC.write_prefill(pool, state, b, TSC.StateCacheConfig(
        quantized=quantized), _slot_t(b))
    for part in ("data", "scale_log2"):
        for key, kinds in pool[part].items():
            for name, t in kinds.items():
                assert _same(want[part][key][name], t), (part, key, name)
    _assert_other_slots_untouched(pool, before, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_write_prefill_without_a_device_slot(arch):
    """Without the caller's int32 copy of the slot, ``write_prefill`` and
    the chunk step's functions make one and write the same bytes."""
    lm = _lm(arch, "float32")
    pool, dtypes, new = _case(lm, 4, True, seed=5)
    other = _clone(pool)
    scfg = TSC.StateCacheConfig(quantized=True)
    TSC.write_slot_step(pool, new, 2, scfg)
    TSC.write_slot_step(other, new, 2, scfg, _slot_t(2))
    for (_, t), (_, u) in zip(_leaves(pool), _leaves(other)):
        assert torch.equal(_bits(t), _bits(u))
    a, c = TSC.read_slot(pool, dtypes, 2, scfg), TSC.read_slot(
        pool, dtypes, 2, scfg, _slot_t(2))
    for (_, t), (_, u) in zip(_leaves(a), _leaves(c)):
        assert torch.equal(_bits(t), _bits(u))


# ---------------------------------------------------------------------------
# (c) scale edges
# ---------------------------------------------------------------------------

def _edge_values(dt, k):
    """``127 * 2^k`` in ``dt`` and the three values of ``dt`` either side."""
    iv = torch.int16 if dt == torch.bfloat16 else torch.int32
    base = torch.tensor([127.0 * 2.0 ** k], dtype=dt).view(iv)
    return [(base + d).view(dt) for d in range(-3, 4)]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [-3, 2])
def test_write_slot_step_scale_edges(arch, dtype, k):
    """Each layer's max at ``127 * 2^k`` or one of its six neighbours (and
    the last layer of the last tensor all zero): codes and scales bit for
    bit with the port's ``write_slot`` a layer; the max at the edge codes
    to +-127 under 2^k, the next value up moves to 2^(k+1); the zero
    state takes the floor's scale and zero codes."""
    lm = _lm(arch, dtype, layers=7)
    pool, _, new = _case(lm, 4, True, seed=31)
    scfg = TSC.StateCacheConfig(quantized=True)
    j = 0
    for key, kinds in new.items():
        for name, layers in kinds.items():
            for x in layers:
                v = _edge_values(x.dtype, k)[j % 7]
                row = x.reshape(-1)
                row.copy_((row.float() / row.float().abs().max()
                           * float(v) / 2).to(row.dtype))
                row[0] = -v if j % 2 else v
                j += 1
    last_key = list(new)[-1]
    last_name = list(new[last_key])[-1]
    new[last_key][last_name][-1].zero_()
    ref = _clone(pool)
    for key, kinds in new.items():
        for name, layers in kinds.items():
            for lay, x in enumerate(layers):
                TSC.write_slot(ref["data"][key][name][lay],
                               ref["scale_log2"][key][name][lay], x[0], 1,
                               scfg)
    TSC.write_slot_step(pool, new, 1, scfg, _slot_t(1))
    for (_, t), (_, u) in zip(_leaves(pool), _leaves(ref)):
        assert torch.equal(_bits(t), _bits(u))
    j = 0
    for key, kinds in new.items():
        for name, layers in kinds.items():
            s = pool["scale_log2"][key][name][:, 1]
            q = pool["data"][key][name][:, 1].reshape(len(layers), -1)
            for lay in range(len(layers)):
                if (key, name, lay) == (last_key, last_name, len(layers) - 1):
                    assert not q[lay].any()
                    assert s[lay] == math.ceil(math.log2(
                        np.float32(1e-8) / np.float32(127)))
                else:
                    assert s[lay] == (k if j % 7 <= 3 else k + 1)
                    if j % 7 == 3:
                        assert abs(int(q[lay, 0])) == 127
                j += 1


# ---------------------------------------------------------------------------
# (d) routing and the engine
# ---------------------------------------------------------------------------

def test_state_slot_wrappers_route_cpu_tensors_to_their_twins(monkeypatch):
    """CPU tensors run the plain twins (no kernel); a malformed call raises
    before any work."""
    calls = []
    for name in ("state_decode_slot_plain", "state_encode_slot_plain"):
        real = getattr(CB, name)
        monkeypatch.setattr(CB, name, lambda *a, _n=name, _f=real:
                            (calls.append(_n), _f(*a))[1])
    q = torch.zeros((2, 3, 4), dtype=torch.int8)
    s = torch.zeros((2, 3))
    y = CB.state_decode_slot([q], [s], [torch.float32], _slot_t(1))
    assert tuple(y[0].shape) == (2, 1, 4)
    CB.state_encode_slot([q], [s], [[torch.ones(1, 4)] * 2], _slot_t(1), 8)
    assert calls == ["state_decode_slot_plain", "state_encode_slot_plain"]
    # a max of 1 takes the scale ceil(log2(1 / 127)) = -6: codes 64
    assert q[:, 1].eq(64).all() and not q[:, [0, 2]].any()
    assert s[:, 1].eq(-6).all() and not s[:, [0, 2]].any()
    with pytest.raises(TypeError, match="int32"):
        CB.state_decode_slot([q], [s], [torch.float32],
                             torch.tensor([1], dtype=torch.int64))
    with pytest.raises(TypeError, match="int32"):
        CB.state_encode_slot([q], [s], [[torch.ones(1, 4)] * 2],
                             torch.tensor([1, 2], dtype=torch.int32), 8)
    with pytest.raises(ValueError, match="new state of shape"):
        CB.state_encode_slot([q], [s], [[torch.ones(3, 4)] * 2], _slot_t(1),
                             8)
    with pytest.raises(ValueError, match="new states for"):
        CB.state_encode_slot([q], [s], [[torch.ones(1, 4)]], _slot_t(1), 8)


@pytest.mark.parametrize("quantized", [False, True])
def test_engine_chunk_step_reads_and_writes_the_slot_once(monkeypatch,
                                                          quantized):
    """A chunked prefill (chunks of 8 over 20 tokens: a prefill and two
    chunk steps): each chunk step calls ``read_slot`` and
    ``write_slot_step`` once and no per-layer read; the prefill calls
    ``write_prefill`` once, which on an int8 pool is one
    ``write_slot_step``. A model-dtype pool's ``write_slot_step`` is
    ``write_slot``'s copy a (layer, tensor)."""
    from repro_torch.models import init_lm
    from repro_torch.serve import Engine, EngineConfig, PoolConfig
    lm = t_build(TC.get_reduced("jamba-1.5-large").replace(
        dtype="float32", moe=MoEConfig(num_experts=0)))
    params = init_lm(torch.Generator().manual_seed(0), lm, device="cpu")
    eng = Engine(lm, params, EngineConfig(pool=PoolConfig(
        num_slots=2, page_size=8, pages_per_slot=4, quantized=quantized),
        prefill_chunk=8), device="cpu")
    calls = []
    for name in ("read_slot", "write_slot_step", "write_prefill",
                 "read_layer", "write_slot", "read_step", "write_step"):
        real = getattr(TSC, name)
        monkeypatch.setattr(TSC, name, lambda *a, _n=name, _f=real, **k:
                            (calls.append(_n), _f(*a, **k))[1])
    eng.submit(list(range(3, 23)), max_new_tokens=2)
    eng.step()                      # the prefill's three chunks, one decode
    per = lm.n_periods * sum(len(TSC.state_feature_shapes(sub, lm.cfg))
                             for sub in lm.period)
    chunk = ["read_slot", "write_slot_step"] + (
        [] if quantized else ["write_slot"] * per)
    want = (["write_prefill"] + (["write_slot_step"] if quantized else [])
            + chunk * 2 + ["read_step", "write_step"])
    assert [c for c in calls if c != "write_layer"] == want
