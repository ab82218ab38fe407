"""repro_torch.obs.ledger and the training side of repro_torch.obs against
the JAX reference, on the CPU.

(a) ``MemoryLedger``: the same calls give the reference's summaries,
    totals, reductions, watermarks and reconciles; on the CPU a reconcile
    with no live figure raises (no allocator counts live CPU tensors), and
    with ``tensors=`` it counts each storage once;
(b) ``launch/train_wire.py::live_memory_ledger`` against the reference's
    (``benchmarks/train_wire.py``) after one low-precision FMNIST step on
    the reference's weights: the same bytes per site, the same Table-1
    reduction (``TABLE1_SITES``), at least 8x;
(c) the train step with ``policy.health`` against the reference's
    ``_train_health`` on the same state and batch (the reference's
    ``_tiny_tt_lm``, ``tests/test_torch_lm_train.py``'s configs): the grad
    edge's ``saturated`` / ``total`` exact, each managed site's
    ``scale_log2`` and ``in_band`` exact and ``mean_abs`` within 1e-6
    relative (1e-5 after two accumulated micro-batches: their gradient sum
    reassociates); ``sat_fraction`` within 1e-6; and gradients with codes
    on the grid's edge counted as the reference's ``tree_sat_stats``
    counts them;
(d) ``train(trace=, ledger=)``: one ``train_step`` event a step with the
    health fields, ``init`` and ``train_step`` watermarks, the ledger's
    sites the final state's, and the closing reconcile ok.
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.obs as JO  # noqa: E402
from repro.configs.base import QuantConfig as JQuantConfig  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import lm as JL  # noqa: E402
import repro_torch.obs as TO  # noqa: E402
from repro_torch.configs.base import QuantConfig  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.convert import mlp_params_from_jax  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch import train as TT  # noqa: E402
from repro_torch.launch import train_wire as TW  # noqa: E402
from repro_torch.models import lm as TL  # noqa: E402
from repro_torch.tree import flatten_with_path  # noqa: E402
from test_torch_lm_train import PLAN, _batch, _configs, _port  # noqa: E402

_BENCH = (pathlib.Path(__file__).resolve().parent.parent / "benchmarks"
          / "train_wire.py")
_spec = importlib.util.spec_from_file_location("train_wire_bench", _BENCH)
JTW = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(JTW)


# ---------------------------------------------------------------------------
# (a) the ledger
# ---------------------------------------------------------------------------

def _drive(led):
    led.set("a", 100, fp32=400)
    led.set("b", 50)
    led.set("overlay", 30, counted=False, pages=3)
    led.set_phase("prefill")
    led.set("a", 80, fp32=400)
    led.set("b", 300)
    led.set_phase("decode")
    led.drop("b")
    led.set("c", 7, fp32=28)
    return led


def test_ledger_equals_reference():
    j, t = _drive(JO.MemoryLedger()), _drive(TO.MemoryLedger())
    assert t.summary() == j.summary()
    for sites in (None, ("a",), ("a", "c")):
        assert t.total(sites) == j.total(sites)
        assert t.fp32_total(sites) == j.fp32_total(sites)
        assert t.reduction_vs_fp32(sites) == j.reduction_vs_fp32(sites)
    for p in ("init", "prefill", "decode", "train_step"):
        assert t.watermark(p) == j.watermark(p)
    for live in (87, 85, 20, 0):
        assert t.reconcile(live_bytes=live) == j.reconcile(live_bytes=live)
    assert t.summary()["sites"]["a"]["peak_bytes"] == 100


def test_cpu_reconcile_needs_a_live_figure():
    led = TO.MemoryLedger()
    led.set("w", 4 * 12)
    with pytest.raises(ValueError, match="live_bytes"):
        led.reconcile()
    w = torch.zeros(3, 4)
    views = {"w": w, "row": w[1], "again": [w.view(12)]}
    assert TO.tensor_bytes(views) == 48          # one storage, once
    rec = led.reconcile(tensors=views)
    assert rec["ok"] and rec["live_bytes"] == 48 and rec["coverage_frac"] == 1
    led.set("w", 4 * 13)
    assert not led.reconcile(tensors=views)["ok"]
    assert TO.device_breakdown(views) == {"cpu": 48 + 16 + 48}


# ---------------------------------------------------------------------------
# (b) the paper's memory figure, live
# ---------------------------------------------------------------------------

def test_live_memory_ledger_equals_reference(tmp_path):
    j = JTW.fmnist_low_precision_step(64)
    t = TW.low_precision_step(device="cpu", params=mlp_params_from_jax(
        jax.tree.map(np.asarray, j["params"]), device="cpu"))
    _, jbase, jdep = JTW.fmnist_site_table(j, str(tmp_path / "j.ckpt"))
    _, tbase, tdep = TW.site_table(t, str(tmp_path / "t.ckpt"))
    jled = JTW.live_memory_ledger(j, jdep, jbase)
    tled = TW.live_memory_ledger(t, tdep, tbase)
    assert tled.summary() == jled.summary()
    sites = TW.TABLE1_SITES
    assert tled.total(sites) == jled.total(sites) == 211591
    assert tled.reduction_vs_fp32(sites) == jled.reduction_vs_fp32(sites)
    assert tled.reduction_vs_fp32(sites) >= 8.0
    assert tled.get("grad_residual") > 0


# ---------------------------------------------------------------------------
# (c) the train step's health
# ---------------------------------------------------------------------------

def _health_pair(n_micro=None):
    jcfg, tcfg = _configs()
    jcfg = jcfg.replace(quant=JQuantConfig(enable=True, health=True))
    tcfg = tcfg.replace(quant=QuantConfig(enable=True, health=True))
    jlm, tlm = JL.build_lm(jcfg), TL.build_lm(tcfg)
    jp = JL.init_lm(jax.random.PRNGKey(2), jlm)
    jt = JTrainConfig(total_steps=5, warmup_steps=1)
    tt = TrainConfig(total_steps=5, warmup_steps=1)
    js = JS.init_train_state(jp, jt, policy=jlm.cfg.quant.policy())
    if n_micro is None:
        return (jax.jit(JS.make_train_step(jlm, PLAN, jt)),
                TS.make_train_step(tlm, None, tt), js, _port(js))
    return (jax.jit(JS.make_grad_accum_train_step(jlm, PLAN, jt, n_micro)),
            TS.make_grad_accum_train_step(tlm, None, tt, n_micro), js,
            _port(js))


def _check_health(jh, th, rel, extra=0):
    """``extra``: elements the reference counts that the port does not."""
    assert set(th) == set(jh) == {"grad_edge", "activation"}
    ge_j, ge_t = jh["grad_edge"], th["grad_edge"]
    assert (int(ge_t["saturated"]), int(ge_t["total"]) + extra) == \
        (int(ge_j["saturated"]), int(ge_j["total"]))
    assert float(ge_t["sat_fraction"]) == pytest.approx(
        float(ge_j["sat_fraction"]) * (1 + extra / int(ge_t["total"])),
        rel=1e-6)
    for site in th:
        assert set(th[site]) == set(jh[site]), site
        assert float(th[site]["scale_log2"]) == float(jh[site]["scale_log2"])
        assert float(th[site]["in_band"]) == float(jh[site]["in_band"])
        assert float(th[site]["mean_abs"]) == pytest.approx(
            float(jh[site]["mean_abs"]), rel=rel)
    return int(ge_t["saturated"]), int(ge_t["total"])


def test_train_step_health_equals_reference():
    jstep, tstep, js, ts = _health_pair()
    jb, tb = _batch(seed=3)
    js, jm = jstep(js, jb)
    ts, tm = tstep(ts, tb)
    _, total = _check_health(jm["health"], tm["health"], 1e-6)
    assert total == sum(t.numel() for _, t in flatten_with_path(ts.params)
                        if t.is_floating_point())


def test_grad_edge_saturation_counts_equal_reference():
    """Gradients whose largest |g| sits on the grid edge: ``saturated``
    counts them, in the port's group fake-quant counter as in the
    reference's ``tree_sat_stats``."""
    from repro.numerics import NumericsPolicy as JPolicy
    from repro_torch.numerics import NumericsPolicy as TPolicy
    rng = np.random.RandomState(9)
    edge = 32767.0 * 2.0 ** -20      # qmax times the per-tensor-max step
    grads = {"w": (rng.standard_normal((6, 40)) * 1e-3).astype(np.float32),
             "b": (rng.standard_normal((7,)) * 1e-3).astype(np.float32)}
    # two codes at hi; -edge rounds to -32767, inside the grid's lo
    grads["w"][0, :4] = [edge, edge, -edge, edge * (1 - 2 ** -12)]
    jsat, jtot = JO.tree_sat_stats([jnp.asarray(g) for g in grads.values()],
                                   JPolicy().spec_for("grad_edge"))
    sat = torch.zeros(2, dtype=torch.int64)
    tp = TPolicy()
    scales = tp.init_scales("cpu")
    out, _ = TS._quantize_grad_edge(
        {k: torch.from_numpy(v) for k, v in grads.items()}, scales, tp, sat)
    assert [int(v) for v in sat] == [int(jsat), int(jtot)]
    assert int(jsat) >= 2
    assert set(out) == set(grads)


def test_grad_accum_step_health_equals_reference():
    """The reference's accumulator carries a scalar f32 zero for each
    integer leaf (its ``zeros`` tree), which its ``tree_sat_stats`` counts
    as one element each; the port's gradients have no entry there. The
    counts agree once those are added."""
    jstep, tstep, js, ts = _health_pair(n_micro=2)
    jb0, tb0 = _batch(seed=4)
    jb1, tb1 = _batch(seed=5)
    jb = {k: jnp.stack([jb0[k], jb1[k]]) for k in jb0}
    tb = {k: torch.stack([tb0[k], tb1[k]]) for k in tb0}
    n_int = sum(1 for leaf in jax.tree_util.tree_leaves(js.params)
                if not jnp.issubdtype(leaf.dtype, jnp.floating))
    assert n_int == 6
    js, jm = jstep(js, jb)
    ts, tm = tstep(ts, tb)
    _check_health(jm["health"], tm["health"], 1e-5, extra=n_int)


# ---------------------------------------------------------------------------
# (d) the train loop's trace and ledger
# ---------------------------------------------------------------------------

def test_train_loop_trace_and_ledger(capsys, tmp_path):
    _, tcfg = _configs(remat="full")
    tcfg = tcfg.replace(quant=QuantConfig(enable=True, health=True))
    tt = TrainConfig(total_steps=3, warmup_steps=1, log_every=1,
                     opt_state_dtype="int8", grad_compress=True,
                     ckpt_dir=str(tmp_path))
    rec, led = TO.TraceRecorder(), TO.MemoryLedger()
    state, losses = TT.train(tcfg, "tp", tt, batch=2, seq=8, device="cpu",
                             trace=rec, ledger=led)
    evs = rec.events("train_step")
    assert [e.fields["step"] for e in evs] == [0, 1, 2]
    assert [e.fields["loss"] for e in evs] == losses
    for e in evs:
        assert set(e.fields) == {"step", "loss", "dur", "grad_sat_fraction",
                                 "act_scale_log2", "act_in_band"}
        assert e.fields["dur"] > 0 and 0 <= e.fields["grad_sat_fraction"] < 1
    assert led.watermark("init") and led.watermark("train_step")
    want = TS.train_state_sites(state)
    assert {s: led.get(s) for s in want} == \
        {s: row["bytes"] for s, row in want.items()}
    assert {"params", "optimizer_moment", "grad_residual",
            "scale_state"} <= set(want)
    out = capsys.readouterr().out
    assert "[train] memory" in out and "reconcile ok" in out
    assert TT._state_tensors(state)
    rec_ = led.reconcile(tensors=TT._state_tensors(state))
    assert rec_["ok"] and rec_["coverage_frac"] > 0.99
