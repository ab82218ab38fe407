"""repro_torch.serve.state_cache against repro.serve.state_cache (the JAX
reference).

(a) the pool of the reduced rwkv6-1.6b and jamba-1.5-large (dense FFNs):
    keys, shapes, dtypes and bytes equal to the reference's, in int8 and in
    the natural dtypes;
(b) codes and scales bit for bit with the reference for ``read_layer``,
    ``write_layer`` under a mixed ``active`` (inactive lanes keep their
    codes and scale), ``write_slot``, ``write_prefill`` (a stack of layers
    and a single layer), ``reset_slot`` and ``snapshot_slot`` /
    ``restore_slot``; f32 and bf16 state; the port writes in place;
(c) the slot-isolation walk (the reference's
    ``test_state_cache_slot_isolation_walk``) run on both pools in lockstep:
    every slot reads back its own sentinel, and the two pools agree bit for
    bit after every operation;
(d) the codec's kernel follows the size of the scale, as the reference's
    Pallas backend: per-slot or per-layer scales take the row kernels, a
    single-element scale (one slot, one layer) the scalar ones.
"""
import dataclasses

import jax
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
from repro_torch.models import build_lm as t_build  # noqa: E402
from repro_torch.numerics import cuda_backend as CB  # noqa: E402
from repro_torch.serve import state_cache as TSC  # noqa: E402

CPU = torch.device("cpu")


def _lms(arch):
    jo, to = {}, {}
    if arch.startswith("jamba"):
        jo, to = {"moe": JMoE(num_experts=0)}, {"moe": MoEConfig(num_experts=0)}
    return (j_build(JC.get_reduced(arch).replace(**jo)),
            t_build(TC.get_reduced(arch).replace(**to)))


def _np(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _jnp_bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _same(t, j, what=""):
    """Bit equality of a port tensor and a reference array."""
    tb, jb = _np(t), _jnp_bits(j)
    assert tb.shape == jb.shape and tb.dtype.itemsize == jb.dtype.itemsize, \
        (what, tb.shape, jb.shape)
    assert np.array_equal(tb, jb), (what, np.argwhere(tb != jb)[:4])


def _pair_arrays(a, dtype=torch.float32):
    """One numpy f32 array as (a reference array, a port tensor) of
    ``dtype`` with the same bits."""
    t = torch.from_numpy(np.array(a, np.float32)).to(dtype)
    if dtype == torch.bfloat16:
        return jnp.asarray(np.array(a, np.float32)).astype(jnp.bfloat16), t
    return jnp.asarray(np.array(a, np.float32)), t


def _state_values(rng, shape, per_row_scale=True):
    """Random state with a different magnitude per leading row."""
    mag = 2.0 ** rng.randint(-6, 7, shape[0]).astype(np.float32)
    x = rng.randn(*shape).astype(np.float32)
    return x * mag.reshape((-1,) + (1,) * (len(shape) - 1)) \
        if per_row_scale else x


# ---------------------------------------------------------------------------
# (a) pool layout and bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-1.5-large"])
@pytest.mark.parametrize("quantized", [False, True])
def test_pool_layout_and_bytes_match_reference(arch, quantized):
    jlm, tlm = _lms(arch)
    for js, ts in zip(jlm.period, tlm.period):
        jf = JSC.state_feature_shapes(js, jlm.cfg)
        assert TSC.state_feature_shapes(ts, tlm.cfg) == jf
        for _, kind in jf.values():
            assert str(TSC.natural_dtype(kind, tlm.cfg)).split(".")[-1] == \
                str(jnp.dtype(JSC.natural_dtype(kind, jlm.cfg)))
    jp = JSC.init_state_pool(jlm, 3, JSC.StateCacheConfig(quantized=quantized))
    tp = TSC.init_state_pool(tlm, 3, TSC.StateCacheConfig(quantized=quantized),
                             CPU)
    for part in ("data", "scale_log2"):
        assert sorted(tp[part]) == sorted(jp[part])
        for key in jp[part]:
            assert sorted(tp[part][key]) == sorted(jp[part][key])
            for name, a in jp[part][key].items():
                t = tp[part][key][name]
                assert tuple(t.shape) == a.shape
                assert str(t.dtype).split(".")[-1] == str(a.dtype)
                assert not t.any()
    assert TSC.pool_bytes(tp) == JSC.pool_bytes(jp)
    assert TSC.pool_bytes_fp32(tp) == JSC.pool_bytes_fp32(jp)
    assert TSC.StateCacheConfig(quantized=quantized).spec.to_json_dict() == \
        JSC.StateCacheConfig(quantized=quantized).spec.to_json_dict()


# ---------------------------------------------------------------------------
# (b) the primitives, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("slots", [4, 1])
def test_read_layer_matches_reference(quantized, dtype, slots):
    rng = np.random.RandomState(slots)
    feat = (3, 5, 5)
    scfg_j = JSC.StateCacheConfig(quantized=quantized)
    scfg_t = TSC.StateCacheConfig(quantized=quantized)
    if quantized:
        codes = rng.randint(-128, 128, (slots,) + feat).astype(np.int8)
        jd, td = jnp.asarray(codes), torch.from_numpy(codes.copy())
    else:
        jd, td = _pair_arrays(_state_values(rng, (slots,) + feat), dtype)
    sc = rng.randint(-9, 3, slots).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    j = JSC.read_layer(jd, jnp.asarray(sc), jdt, scfg_j)
    t = TSC.read_layer(td, torch.from_numpy(sc), dtype, scfg_t)
    _same(t, j, "read_layer")


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_write_layer_with_mixed_active_matches_reference(quantized, dtype):
    """Codes and scales of the active lanes re-encoded under fresh
    per-slot scales, the inactive lanes' codes and scale untouched; the
    port writes into the pool tensors it was given."""
    rng = np.random.RandomState(7)
    slots, feat = 5, (4, 6)
    scfg_j = JSC.StateCacheConfig(quantized=quantized)
    scfg_t = TSC.StateCacheConfig(quantized=quantized)
    if quantized:
        old = rng.randint(-128, 128, (slots,) + feat).astype(np.int8)
        jd, td = jnp.asarray(old), torch.from_numpy(old.copy())
    else:
        jd, td = _pair_arrays(rng.randn(slots, *feat), dtype)
    old_s = rng.randint(-5, 2, slots).astype(np.float32)
    js, ts = jnp.asarray(old_s), torch.from_numpy(old_s.copy())
    jn, tn = _pair_arrays(_state_values(rng, (slots,) + feat), dtype)
    active = np.array([True, False, True, True, False])
    jd2, js2 = JSC.write_layer(jd, js, jn, jnp.asarray(active), scfg_j)
    td_ptr = td.data_ptr()
    td2, ts2 = TSC.write_layer(td, ts, tn, torch.from_numpy(active), scfg_t)
    assert td2.data_ptr() == td_ptr
    _same(td, jd2, "codes")
    _same(ts, js2, "scales")
    assert np.array_equal(_np(td)[~active], _jnp_bits(jd)[~active])
    assert np.array_equal(ts.numpy()[~active], old_s[~active])


@pytest.mark.parametrize("quantized", [False, True])
def test_write_slot_matches_reference(quantized):
    rng = np.random.RandomState(8)
    slots, feat = 4, (3, 7)
    scfg_j = JSC.StateCacheConfig(quantized=quantized)
    scfg_t = TSC.StateCacheConfig(quantized=quantized)
    base = (rng.randint(-128, 128, (slots,) + feat).astype(np.int8)
            if quantized else rng.randn(slots, *feat).astype(np.float32))
    sc = rng.randint(-5, 2, slots).astype(np.float32)
    new = rng.randn(*feat).astype(np.float32) * 13.0
    jd, js = JSC.write_slot(jnp.asarray(base), jnp.asarray(sc),
                            jnp.asarray(new), jnp.int32(2), scfg_j)
    td, ts = torch.from_numpy(base.copy()), torch.from_numpy(sc.copy())
    TSC.write_slot(td, ts, torch.from_numpy(new), 2, scfg_t)
    _same(td, jd, "codes")
    _same(ts, js, "scales")


@pytest.mark.parametrize("arch,layers", [("rwkv6-1.6b", 2),
                                         ("jamba-1.5-large", 1)])
@pytest.mark.parametrize("quantized", [False, True])
def test_write_prefill_matches_reference(arch, layers, quantized):
    """The post-prompt state of every layer into one slot: a scale per layer
    (rows), and a one-period stack (one layer: a single scale)."""
    jlm, tlm = _lms(arch)
    jlm = dataclasses.replace(jlm, n_periods=layers)
    tlm = dataclasses.replace(tlm, n_periods=layers)
    scfg_j = JSC.StateCacheConfig(quantized=quantized)
    scfg_t = TSC.StateCacheConfig(quantized=quantized)
    jp = JSC.init_state_pool(jlm, 3, scfg_j)
    tp = TSC.init_state_pool(tlm, 3, scfg_t, CPU)
    rng = np.random.RandomState(9)
    jstate, tstate = {}, {}
    for i, sub in enumerate(tlm.period):
        feats = TSC.state_feature_shapes(sub, tlm.cfg)
        if not feats:
            continue
        vals = {n: _state_values(rng, (layers, 1) + f)
                for n, (f, _) in feats.items()}
        jstate[f"sub_{i}"] = {n: jnp.asarray(v) for n, v in vals.items()}
        tstate[f"sub_{i}"] = {n: torch.from_numpy(v) for n, v in vals.items()}
    jp = JSC.write_prefill(jp, jstate, jnp.int32(1), scfg_j)
    TSC.write_prefill(tp, tstate, 1, scfg_t)
    for part in ("data", "scale_log2"):
        for key in jp[part]:
            for name, a in jp[part][key].items():
                _same(tp[part][key][name], a, f"{part}/{key}/{name}")


@pytest.mark.parametrize("quantized", [False, True])
def test_reset_snapshot_and_restore_match_reference(quantized):
    jlm, tlm = _lms("rwkv6-1.6b")
    scfg_j = JSC.StateCacheConfig(quantized=quantized)
    scfg_t = TSC.StateCacheConfig(quantized=quantized)
    rng = np.random.RandomState(10)
    jp = JSC.init_state_pool(jlm, 3, scfg_j)
    tp = TSC.init_state_pool(tlm, 3, scfg_t, CPU)
    # fill every slot through write_prefill
    for slot in range(3):
        vals = {n: _state_values(rng, (jlm.n_periods, 1) + f)
                for n, (f, _) in TSC.state_feature_shapes(
                    tlm.period[0], tlm.cfg).items()}
        jp = JSC.write_prefill(jp, {"sub_0": {n: jnp.asarray(v)
                                              for n, v in vals.items()}},
                               jnp.int32(slot), scfg_j)
        TSC.write_prefill(tp, {"sub_0": {n: torch.from_numpy(v)
                                         for n, v in vals.items()}},
                          slot, scfg_t)

    def same_pools():
        for part in ("data", "scale_log2"):
            for name, a in jp[part]["sub_0"].items():
                _same(tp[part]["sub_0"][name], a, f"{part}/{name}")
    jsnap = JSC.snapshot_slot(jp, 1)
    tsnap = TSC.snapshot_slot(tp, 1)
    for part in ("data", "scale_log2"):
        for name, a in jsnap[part]["sub_0"].items():
            _same(tsnap[part]["sub_0"][name], a, f"snapshot {part}/{name}")
    jp = JSC.reset_slot(jp, jnp.int32(1))
    TSC.reset_slot(tp, 1)
    same_pools()
    assert not any(t[:, 1].any() for t in tp["data"]["sub_0"].values())
    jp = JSC.restore_slot(jp, jsnap, jnp.int32(0))
    TSC.restore_slot(tp, tsnap, 0)
    same_pools()
    # with a recorder: the reference's state_snapshot / state_restore
    from repro_torch.obs import TraceRecorder
    rec = TraceRecorder()
    snap = TSC.snapshot_slot(tp, 0, trace=rec)
    TSC.restore_slot(tp, snap, 0, trace=rec)
    nbytes = sum(a.nbytes for a in jax.tree_util.tree_leaves(
        JSC.snapshot_slot(jp, 0)))
    assert [(e.kind, e.fields) for e in rec] == [
        ("state_snapshot", {"slot": 0, "nbytes": nbytes}),
        ("state_restore", {"slot": 0, "nbytes": nbytes})]
    same_pools()


# ---------------------------------------------------------------------------
# (c) the slot-isolation walk, on both pools in lockstep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantized", [False, True])
def test_slot_isolation_walk_matches_reference(quantized):
    """Random reset / one-slot write / batched write under a random active
    mask / snapshot / restore: every slot always reads back exactly its
    own sentinel (powers of two, exact on the pow-2 grid), and the port's
    pool equals the reference's bit for bit after every operation."""
    num_slots, L, feat = 3, 2, (3,)
    scfg_j = JSC.StateCacheConfig(quantized=quantized)
    scfg_t = TSC.StateCacheConfig(quantized=quantized)
    store_j = jnp.int8 if quantized else jnp.float32
    store_t = torch.int8 if quantized else torch.float32
    jp = {"data": {"sub_0": {"h": jnp.zeros((L, num_slots) + feat, store_j)}},
          "scale_log2": {"sub_0": {"h": jnp.zeros((L, num_slots),
                                                  jnp.float32)}}}
    tp = {"data": {"sub_0": {"h": torch.zeros((L, num_slots) + feat,
                                              dtype=store_t)}},
          "scale_log2": {"sub_0": {"h": torch.zeros((L, num_slots))}}}
    rng = np.random.RandomState(0)
    expect = np.zeros((num_slots,), np.float32)
    snaps: dict = {}

    def check():
        _same(tp["data"]["sub_0"]["h"], jp["data"]["sub_0"]["h"], "codes")
        _same(tp["scale_log2"]["sub_0"]["h"], jp["scale_log2"]["sub_0"]["h"],
              "scales")
        for layer in range(L):
            got = TSC.read_layer(tp["data"]["sub_0"]["h"][layer],
                                 tp["scale_log2"]["sub_0"]["h"][layer],
                                 torch.float32, scfg_t).numpy()
            for s in range(num_slots):
                assert (got[s] == expect[s]).all(), (layer, s, got[s])

    for _ in range(60):
        op = rng.choice(["reset", "write_slot", "write_batch", "snapshot",
                         "restore"])
        slot = int(rng.randint(num_slots))
        if op == "reset":
            jp = JSC.reset_slot(jp, jnp.int32(slot))
            TSC.reset_slot(tp, slot)
            expect[slot] = 0.0
        elif op == "write_slot":
            val = float(2.0 ** rng.randint(-3, 4))
            for layer in range(L):
                d, sc = jp["data"]["sub_0"]["h"], jp["scale_log2"]["sub_0"]["h"]
                nd, ns = JSC.write_slot(d[layer], sc[layer],
                                        jnp.full((3,), val), jnp.int32(slot),
                                        scfg_j)
                jp["data"]["sub_0"]["h"] = d.at[layer].set(nd)
                jp["scale_log2"]["sub_0"]["h"] = sc.at[layer].set(ns)
                TSC.write_slot(tp["data"]["sub_0"]["h"][layer],
                               tp["scale_log2"]["sub_0"]["h"][layer],
                               torch.full((3,), val), slot, scfg_t)
            expect[slot] = val
        elif op == "write_batch":
            active = rng.rand(num_slots) < 0.5
            vals = 2.0 ** rng.randint(-3, 4, num_slots).astype(np.float32)
            new = np.repeat(vals[:, None], 3, axis=1)
            for layer in range(L):
                d, sc = jp["data"]["sub_0"]["h"], jp["scale_log2"]["sub_0"]["h"]
                nd, ns = JSC.write_layer(d[layer], sc[layer],
                                         jnp.asarray(new),
                                         jnp.asarray(active), scfg_j)
                jp["data"]["sub_0"]["h"] = d.at[layer].set(nd)
                jp["scale_log2"]["sub_0"]["h"] = sc.at[layer].set(ns)
                TSC.write_layer(tp["data"]["sub_0"]["h"][layer],
                                tp["scale_log2"]["sub_0"]["h"][layer],
                                torch.from_numpy(new),
                                torch.from_numpy(active), scfg_t)
            expect[active] = vals[active]
        elif op == "snapshot":
            snaps[slot] = (JSC.snapshot_slot(jp, slot),
                           TSC.snapshot_slot(tp, slot), expect[slot])
        elif op == "restore" and slot in snaps:
            jsnap, tsnap, val = snaps[slot]
            jp = JSC.restore_slot(jp, jsnap, jnp.int32(slot))
            TSC.restore_slot(tp, tsnap, slot)
            expect[slot] = val
        check()


# ---------------------------------------------------------------------------
# (d) the kernel follows the size of the scale
# ---------------------------------------------------------------------------

def test_state_codec_takes_the_kernel_of_its_scale(monkeypatch):
    """Which kernel wrapper the codec calls: the per-layer read and write
    of every slot (a scale per slot) the row kernels, of one slot (a
    single scale) the scalar kernels; a whole-prompt prefill's write of
    the slot's every layer, a layer stack or one layer, the one-slot
    group encode (a scale per layer, chosen in the launch)."""
    calls = []
    for name in ("encode_rows", "decode_rows", "encode_scalar",
                 "decode_scalar", "state_encode_slot"):
        real = getattr(CB, name)
        monkeypatch.setattr(CB, name, lambda *a, _n=name, _f=real, **k:
                            (calls.append(_n), _f(*a, **k))[1])
    scfg = TSC.StateCacheConfig(quantized=True)
    rng = np.random.RandomState(11)
    data = torch.zeros((4, 2, 8), dtype=torch.int8)
    scale = torch.zeros(4)
    new = torch.from_numpy(rng.randn(4, 2, 8).astype(np.float32))
    TSC.read_layer(data, scale, torch.float32, scfg)
    TSC.write_layer(data, scale, new, torch.ones(4, dtype=torch.bool), scfg)
    assert calls == ["decode_rows", "encode_rows"]
    calls.clear()
    TSC.read_layer(data[2][None], scale[2][None], torch.float32, scfg)
    TSC.write_slot(data, scale, new[0], 2, scfg)
    assert calls == ["decode_scalar", "encode_scalar"]
    for layers in (3, 1):
        calls.clear()
        pool = {"data": {"sub_0": {"h": torch.zeros((layers, 4, 2, 8),
                                                    dtype=torch.int8)}},
                "scale_log2": {"sub_0": {"h": torch.zeros((layers, 4))}}}
        TSC.write_prefill(pool, {"sub_0": {"h": torch.randn(layers, 1, 2, 8)}},
                          1, scfg)
        assert calls == ["state_encode_slot"]
