"""repro_torch.obs against repro.obs (the JAX reference), on the CPU.

(a) the quant-health aggregates (``pow2_clip_stats``,
    ``saturation_counts``, ``scale_drift_stats``, ``tree_sat_stats``,
    ``fraction``) and ``numerics.fake_quant_stats`` on the same seeded
    inputs: counts equal integer for integer, drift equal in f32;
(b) the recorder, spans and export: the lifecycle's span tree, the ring,
    a muted recorder, ``chrome_trace`` dicts equal to the reference's and
    JSONL files byte for byte;
(c) ``ServeMetrics`` with health and the bounded timeline: summaries equal
    to the reference's (the port has no ``compile_evictions``: it compiles
    nothing);
(d) the port's ``Engine(trace=..., policy=health)`` against the JAX
    ``Engine`` on the reduced GQA config, plain and with chunked prefill:
    the event sequences equal outright under counter clocks (``ts`` and
    ``dur`` included), ``quant_health`` equal integer for integer, the
    ledger's sites, bytes and watermarks equal with ``compile_cache`` the
    one stated difference (the reference's bucketed jitted prefills; the
    port compiles none), every request span closed and nested, the
    timeline as long as the decode steps, the CPU reconcile ok;
(e) the overhead: a decode step dispatches the same ATen calls with a
    recorder attached, or with a health-off policy, as with neither (the
    reference's jaxpr-identity test, in eager form), and health adds no
    kernel launch of its own.

The prefix-cache and speculative modes are in ``test_torch_obs_engine.py``,
MLA's latent pair and rwkv6's state drift in ``test_torch_obs_state.py``
(at most two JAX engine runs a file).
"""
import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as JC  # noqa: E402
import repro.obs as JO  # noqa: E402
from repro import numerics as JN  # noqa: E402
from repro.models import build_lm as j_build  # noqa: E402
from repro.models import init_lm as j_init  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import EngineConfig as JEC  # noqa: E402
from repro.serve import PoolConfig as JPC  # noqa: E402
from repro.serve.metrics import ServeMetrics as JMetrics  # noqa: E402
from repro.sharding import ShardPlan  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
import repro_torch.obs as TO  # noqa: E402
from repro_torch import numerics as TN  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import build_lm as t_build  # noqa: E402
from repro_torch.serve import Engine, EngineConfig, PoolConfig  # noqa: E402
from repro_torch.serve.metrics import ServeMetrics as TMetrics  # noqa: E402

ARCH = "internlm2-1.8b"
PLAN = ShardPlan(mesh=None)
# 2 slots of 8 pages of 4: slots recycle, decode crosses page boundaries;
# prompts of 2-9 tokens freeze scales on few values, so decode clips
POOL = dict(num_slots=2, page_size=4, pages_per_slot=8, quantized=True)
LENS, GENS = [3, 9, 2, 6], [8, 6, 9, 7]
MODES = {"plain": {}, "chunked": dict(prefill_chunk=4)}


def _clock():
    c = itertools.count()
    return lambda: float(next(c))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


def _n(x) -> np.ndarray:
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


# ---------------------------------------------------------------------------
# (a) the aggregates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,bits,shape", [(0, 8, (6, 64)), (1, 4, (3, 5, 16)),
                                             (2, 16, (4, 33))])
def test_clip_stats_equal_reference(seed, bits, shape):
    rng = np.random.RandomState(seed)
    x = (rng.standard_normal(shape) * 8).astype(np.float32)
    sc = (rng.randint(-4, 1, shape[:1]) - (bits - 6)).astype(np.float32)
    valid = rng.rand(shape[0]) > 0.3
    vshape = (-1,) + (1,) * (len(shape) - 1)
    for v in (None, valid.reshape(vshape)):
        jc, jt = JO.pow2_clip_stats(jnp.asarray(x), jnp.asarray(sc), bits,
                                    None if v is None else jnp.asarray(v))
        tc, tt = TO.pow2_clip_stats(_t(x), _t(sc), bits,
                                    None if v is None else _t(v))
        assert (int(tc), int(tt)) == (int(jc), int(jt))
        assert tc.dtype == torch.int32 and (v is not None or int(jc) > 0)


@pytest.mark.parametrize("storage,bits", [("int8", 8), ("int4x2", 4),
                                          ("int16", 16)])
def test_saturation_counts_equal_reference(storage, bits):
    rng = np.random.RandomState(3)
    x = (rng.standard_normal((5, 7)) * 20).astype(np.float32)
    spec_j = JN.QuantSpec("pow2", bits, 0, storage, "per_tensor_max")
    spec_t = TN.QuantSpec("pow2", bits, 0, storage, "per_tensor_max")
    for scale in (-1.0, 3.0):
        jq = JN.encode(jnp.asarray(x), spec_j, jnp.asarray(scale))
        tq = TN.encode(_t(x), spec_t, torch.tensor(scale))
        js, jt = JO.saturation_counts(jq)
        ts, tt = TO.saturation_counts(tq)
        assert (int(ts), int(tt)) == (int(js), int(jt)) == (int(js), 35)
    spec_j = JN.QuantSpec("blockwise", 8, 16, "int8")
    spec_t = TN.QuantSpec("blockwise", 8, 16, "int8")
    js, jt = JO.saturation_counts(JN.encode(jnp.asarray(x), spec_j))
    ts, tt = TO.saturation_counts(TN.encode(_t(x), spec_t))
    assert (int(ts), int(tt)) == (int(js), int(jt))


def test_drift_tree_sat_and_fraction_equal_reference():
    rng = np.random.RandomState(4)
    old = rng.randint(-6, 6, (3, 5)).astype(np.float32)
    new = rng.randint(-6, 6, (3, 5)).astype(np.float32)
    valid = rng.rand(3, 5) > 0.4
    for v in (None, valid):
        jd, jn = JO.scale_drift_stats(jnp.asarray(old), jnp.asarray(new),
                                      None if v is None else jnp.asarray(v))
        td, tn = TO.scale_drift_stats(_t(old), _t(new),
                                      None if v is None else _t(v))
        assert (float(td), float(tn)) == (float(jd), float(jn))
    leaves = [(rng.standard_normal((8, 4)) * 3).astype(np.float32),
              np.arange(3, dtype=np.int32), np.full((5,), 2.0, np.float32)]
    spec = ("pow2", 8, 0, "int8", "per_tensor_max")
    for scale_for in (None, -8.0):
        js, jt = JO.tree_sat_stats(
            [jnp.asarray(a) for a in leaves], JN.QuantSpec(*spec),
            None if scale_for is None else (lambda g: jnp.asarray(scale_for)))
        ts, tt = TO.tree_sat_stats(
            [_t(a) for a in leaves], TN.QuantSpec(*spec),
            None if scale_for is None else (lambda g: torch.tensor(scale_for)))
        assert (int(ts), int(tt)) == (int(js), int(jt))
    wire = ("blockwise", 8, 16, "int8")
    assert [int(v) for v in TO.tree_sat_stats([_t(leaves[0])],
                                              TN.QuantSpec(*wire))] == \
        [int(v) for v in JO.tree_sat_stats([jnp.asarray(leaves[0])],
                                           JN.QuantSpec(*wire))]
    for c, t in ((0, 0), (3, 4), (7, 9)):
        assert float(TO.fraction(torch.tensor(c), torch.tensor(t))) == \
            float(JO.fraction(jnp.asarray(c), jnp.asarray(t)))


@pytest.mark.parametrize("spec", [("pow2", 8, 0, "int8", "per_tensor_max"),
                                  ("blockwise", 8, 16, "int8")])
def test_fake_quant_stats_equal_reference(spec):
    rng = np.random.RandomState(5)
    x = (rng.standard_normal((5, 32)) * 4).astype(np.float32)
    scale = -4.0 if spec[0] == "pow2" else None
    jy, (jc, jt) = JN.fake_quant_stats(
        jnp.asarray(x), JN.QuantSpec(*spec),
        None if scale is None else jnp.asarray(scale))
    ty, (tc, tt) = TN.fake_quant_stats(
        _t(x), TN.QuantSpec(*spec),
        None if scale is None else torch.tensor(scale))
    np.testing.assert_array_equal(_n(ty), np.asarray(jy))
    assert (int(tc), int(tt)) == (int(jc), int(jt))
    assert int(tc) > 0 or spec[0] == "blockwise"


@pytest.mark.parametrize("bits", [8, 4])
def test_append_and_write_health_equal_reference(bits):
    """``kv_cache.append_health`` and ``state_cache.write_health`` (the
    engine's per-site signals; the kernels' twins count the same) against
    the reference's on one decode step's values: an inactive slot, a slot
    whose frozen scale its new token outgrows."""
    from repro.serve import kv_cache as JKC
    from repro.serve import state_cache as JSC
    from repro_torch.serve import kv_cache as TKC
    from repro_torch.serve import state_cache as TSC
    rng = np.random.RandomState(bits)
    new = (rng.standard_normal((4, 1, 2, 16)) * 3).astype(np.float32)
    scale = np.asarray([-6, -2, -5, 0], np.float32)
    active = np.asarray([True, True, False, True])
    jc = JKC.append_health(jnp.asarray(new), jnp.asarray(scale),
                           jnp.asarray(active), JPC(num_slots=4, bits=bits))
    tc = TKC.append_health(_t(new), _t(scale), _t(active), PoolConfig(
        num_slots=4, bits=bits))
    assert [int(v) for v in tc] == [int(v) for v in jc] and int(jc[0]) > 0
    state = (rng.standard_normal((4, 3, 8)) * 5).astype(np.float32)
    jw = JSC.write_health(jnp.asarray(scale), jnp.asarray(state),
                          jnp.asarray(active),
                          JSC.StateCacheConfig(quantized=True, bits=bits))
    tw = TSC.write_health(_t(scale), _t(state), _t(active),
                          TSC.StateCacheConfig(quantized=True, bits=bits))
    assert [float(v) for v in tw] == [float(v) for v in jw]
    assert float(jw[2]) > 0


# ---------------------------------------------------------------------------
# (b) recorder, spans, export
# ---------------------------------------------------------------------------

def _lifecycle(mod):
    rec = mod.TraceRecorder(clock=_clock())
    rec.emit("submit", rid=1, prompt_len=4, max_new=8)
    rec.emit("admit", rid=1, slot=0, pages=1)
    rec.emit("prefill_chunk", rid=1, slot=0, start=0, len=2)
    rec.emit("prefill", rid=1, slot=0, len=4, dur=1.0)
    rec.emit("first_token", rid=1, slot=0)
    rec.emit("decode_step", step=1, n_active=1, free_pages=3, dur=0.5)
    rec.emit("preempt", rid=1, slot=0, gen_len=2)
    rec.emit("admit", rid=1, slot=1, pages=1)
    rec.emit("prefill", rid=1, slot=1, len=6, dur=1.0)
    rec.emit("page_alloc", slot=1, page=4, pos=8)
    rec.emit("retire", rid=1, slot=1, new_tokens=8, reason="max_new")
    return rec


def _span_tuple(s):
    return (s.name, s.start, s.end, s.fields,
            [_span_tuple(c) for c in s.children])


def test_spans_and_chrome_trace_equal_reference(tmp_path):
    jrec, trec = _lifecycle(JO), _lifecycle(TO)
    jsp, tsp = JO.request_spans(jrec.events()), TO.request_spans(trec.events())
    assert {k: _span_tuple(v) for k, v in tsp.items()} == \
        {k: _span_tuple(v) for k, v in jsp.items()}
    assert TO.check_nesting(tsp[1]) and tsp[1].dur == 10.0
    assert TO.chrome_trace(trec) == JO.chrome_trace(jrec)
    paths = {}
    for name, mod, rec in (("j", JO, jrec), ("t", TO, trec)):
        paths[name] = (tmp_path / f"{name}.jsonl", tmp_path / f"{name}.json")
        assert mod.write_jsonl(rec, str(paths[name][0])) == 11
        mod.write_chrome_trace(rec, str(paths[name][1]))
    for k in range(2):
        assert paths["t"][k].read_bytes() == paths["j"][k].read_bytes()
    back = TO.read_jsonl(str(paths["t"][0]))
    assert [(e.ts, e.kind, e.fields) for e in back] == \
        [(e.ts, e.kind, e.fields) for e in trec.events()]
    doc = json.loads(paths["t"][1].read_text())
    assert {e["ph"] for e in doc["traceEvents"]} == {"X", "b", "e", "i"}


def test_ring_and_muted_recorder():
    rec = TO.TraceRecorder(capacity=4, clock=_clock())
    for i in range(10):
        rec.emit("decode_step", step=i)
    assert len(rec) == 4 and rec.dropped == 6
    assert [e.fields["step"] for e in rec.events()] == [6, 7, 8, 9]
    assert len(rec.events("decode_step")) == 4 and not rec.events("x")
    rec.clear()
    assert len(rec) == 0 and rec.dropped == 0
    rec.enabled = False
    rec.emit("submit", rid=0)
    assert len(rec) == 0
    with pytest.raises(ValueError):
        TO.TraceRecorder(capacity=0)


def test_counter_registry():
    r = TO.CounterRegistry()
    r.inc("a.b")
    r.inc("a.b", 4)
    r.inc("z")
    assert r.get("a.b") == 5 and r.snapshot("a.") == {"a.b": 5}
    r.reset("a.b")
    assert r.get("a.b") == 0 and r.get("z") == 1
    r.reset()
    assert r.snapshot() == {}
    TO.record_kernel_call("obs_test.cuda", bytes_moved=128, flops=7)
    costs = TO.kernel_costs()["obs_test.cuda"]
    assert costs["calls"] >= 1 and costs["bytes"] >= 128


# ---------------------------------------------------------------------------
# (c) ServeMetrics
# ---------------------------------------------------------------------------

def _drive_metrics(cls):
    m = cls(clock=_clock(), timeline_capacity=3)
    m.num_slots = 4
    for rid in range(3):
        m.request_submitted(rid)
        m.request_admitted(rid, 4)
        m.request_first_token(rid)
    for n, free in ((4, 10), (3, 6), (2, 8), (4, 7), (1, 9)):
        m.decode_step(n, free_pages=free, dur=0.25)
    m.prefill(8, computed=5)
    m.record_health("kv_cache", 3, 100)
    m.record_health("kv_cache", 1, 100)
    m.record_health("ssm_state", 0, 50, drift_sum=2.0, drift_n=4.0)
    m.trace_dropped = 2
    m.counter_totals = {"x": 1}
    for rid in range(2):
        m.request_finished(rid, 5)
    return m


def test_serve_metrics_summary_equals_reference():
    jm, tm = _drive_metrics(JMetrics), _drive_metrics(TMetrics)
    js, ts = jm.summary(), tm.summary()
    js.pop("compile_evictions")
    assert ts == js
    assert list(tm.timeline) == list(jm.timeline)
    assert tm.timeline_dropped == 2 and ts["free_pages_min"] == 6
    assert ts["quant_health"]["kv_cache"]["clip_fraction"] == 0.02
    assert ts["quant_health"]["ssm_state"]["scale_drift_log2"] == 0.5


# ---------------------------------------------------------------------------
# (d) the engine against the JAX engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jcfg = JC.get_reduced(ARCH).replace(dtype="float32", remat="none")
    tcfg = TC.get_reduced(ARCH).replace(dtype="float32", remat="none")
    jlm = j_build(jcfg)
    jp = j_init(jax.random.PRNGKey(0), jlm)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, jcfg.vocab_size, n).tolist() for n in LENS]
    return jlm, jp, t_build(tcfg), tp, prompts


def _serve(eng, prompts, gens):
    rids = [eng.submit(p, max_new_tokens=g) for p, g in zip(prompts, gens)]
    res = eng.run()
    return [res[r].tokens for r in rids]


def _no_cc(wm: dict) -> dict:
    return {p: {"total_bytes": w["total_bytes"],
                "sites": {k: v for k, v in w["sites"].items()
                          if k != "compile_cache"}}
            for p, w in wm.items()}


def events(rec) -> list:
    """(ts, kind, fields) of every event, request ids renumbered in submit
    order (the reference numbers requests process-wide, the port per
    engine)."""
    ids = {e.fields["rid"]: n for n, e in enumerate(rec.events("submit"))}
    return [(e.ts, e.kind, {k: ids[v] if k == "rid" else v
                            for k, v in e.fields.items()}) for e in rec]


def check_engines(jeng, jrec, jtoks, teng, trec, ttoks) -> dict:
    """The port's traced, health-counting engine against the JAX one after
    the same requests: tokens, events, quant health, the ledger."""
    assert ttoks == jtoks
    assert events(trec) == events(jrec)
    js, ts = jeng.summary(), teng.summary()
    assert ts["quant_health"] == js["quant_health"]
    jm, tm = js["memory"], ts["memory"]
    assert tm["sites"] == {k: v for k, v in jm["sites"].items()
                           if k != "compile_cache"}
    for key in ("total_bytes", "fp32_total_bytes", "reduction_vs_fp32_x",
                "phase"):
        assert tm[key] == jm[key], key
    assert tm["watermarks"] == _no_cc(jm["watermarks"])
    assert tm["reconcile"]["ok"] and tm["reconcile"]["coverage_frac"] > 0.99
    spans = TO.request_spans(trec.events())
    assert spans and all(s.end is not None for s in spans.values())
    if not trec.events("prefill_chunk"):
        # (a chunked prefill's backdated span follows its chunks' instants
        # in the reference's span builder, out of start order)
        assert all(TO.check_nesting(s) for s in spans.values())
    steps = trec.events("decode_step") + trec.events("spec_step")
    assert len(teng.metrics.timeline) == len(steps)
    assert ts["trace_dropped"] == 0 and ts["timeline_dropped"] == 0
    return ts


_JAX: dict = {}


def _jax_run(models, mode):
    if mode not in _JAX:
        jlm, jp, _, _, prompts = models
        rec = JO.TraceRecorder(clock=_clock())
        eng = JEngine(jlm, jp, JEC(pool=JPC(**POOL), policy=JN.NumericsPolicy(
            enable=True, health=True), **MODES[mode]), PLAN, clock=_clock(),
            trace=rec)
        _JAX[mode] = (eng, rec, _serve(eng, prompts, GENS))
    return _JAX[mode]


def _port(models, mode, **kw):
    _, _, tlm, tp, _ = models
    rec = TO.TraceRecorder(clock=_clock())
    eng = Engine(tlm, tp, EngineConfig(
        pool=PoolConfig(**POOL), policy=TN.NumericsPolicy(
            enable=True, health=True), **MODES[mode], **kw), device="cpu",
        clock=_clock(), trace=rec)
    return eng, rec


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_trace_health_ledger_equal_jax(models, mode):
    jeng, jrec, jtoks = _jax_run(models, mode)
    eng, rec = _port(models, mode)
    ts = check_engines(jeng, jrec, jtoks, eng, rec,
                       _serve(eng, models[4], GENS))
    kv = ts["quant_health"]["kv_cache"]
    assert 0 < kv["clipped"] < kv["total"]
    # every decode step's append counts K and V of each active slot, layer
    from repro_torch.serve import kv_cache as TKC
    lm = models[2]
    per = lm.n_periods * sum(int(np.prod(f)) for sub in lm.period
                             for f in TKC.kv_feature_shapes(sub).values())
    assert kv["total"] == per * sum(e.fields["n_active"]
                                    for e in rec.events("decode_step"))
    kinds = {e.kind for e in rec}
    assert {"submit", "admit", "prefill", "first_token", "decode_step",
            "retire", "page_alloc", "page_free"} <= kinds
    assert ("prefill_chunk" in kinds) == (mode == "chunked")


# ---------------------------------------------------------------------------
# (e) the overhead
# ---------------------------------------------------------------------------

class _Calls(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _decode_ops(models, ecfg_kw: dict, eng_kw: dict) -> list[str]:
    """The ATen calls of one steady decode step (both slots decoding, no
    admission, no retirement)."""
    _, _, tlm, tp, prompts = models
    eng = Engine(tlm, tp, EngineConfig(pool=PoolConfig(**POOL), **ecfg_kw),
                 device="cpu", **eng_kw)
    for p in prompts[:2]:
        eng.submit(p, max_new_tokens=6)
    eng.step()
    with _Calls() as calls:
        eng.step()
    return calls.ops


def test_recorder_and_health_off_dispatch_the_same_aten_calls(models):
    base = _decode_ops(models, {}, {})
    assert len(base) > 100
    traced = _decode_ops(models, {}, dict(trace=TO.TraceRecorder()))
    assert traced == base, "an attached recorder changed the decode step"
    off = _decode_ops(models, dict(policy=TN.NumericsPolicy(enable=True)), {})
    assert off == base, "health=False changed the decode step"
    # sanity: health on does change the step (the counter's zeros, the
    # plain versions' counting on the CPU, the read-back)
    on = _decode_ops(models, dict(policy=TN.NumericsPolicy(
        enable=True, health=True)), {})
    assert on != base
