"""repro_torch.serve against repro.serve (the JAX reference), plus the
port's package rules.

(a) ``Engine(device="cpu")`` greedy tokens are IDENTICAL to the JAX
    ``Engine`` (fused page-scan, ``fused_impl="jnp"``) on transferred
    weights, for the port's fused and gather paths over quantized and fp
    pools — 4 ragged requests on 2 slots (slots recycle, decode crosses
    page boundaries) and a shared pool small enough to force preemption;
(b) sampling knobs process logits exactly as the reference does;
(c) no file of the port imports ``jax`` or ``repro``; entry points raise
    without a card unless asked for the CPU; configs outside the slice
    raise ``NotImplementedError``;
(d) ``EngineConfig.policy``'s kv_cache site sets the pool's numerics, and
    a 4-bit site serves the JAX engine's greedy tokens.
"""
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as JC  # noqa: E402
from repro.models import build_lm as j_build  # noqa: E402
from repro.models import init_lm as j_init  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import EngineConfig as JEC  # noqa: E402
from repro.serve import PoolConfig as JPC  # noqa: E402
from repro.serve.sampling import processed_probs as j_probs  # noqa: E402
from repro.sharding import ShardPlan  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import build_lm as t_build  # noqa: E402
from repro_torch.models import init_lm as t_init  # noqa: E402
from repro_torch.serve import Engine, EngineConfig, PoolConfig  # noqa: E402
from repro_torch.serve import sampling as TS  # noqa: E402

ARCH = "internlm2-1.8b"
PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"

# (pool kwargs, gens, prompt seed/lo/hi): ragged requests on 2 slots; a
# 12-page shared pool under 3 slots x 14 new tokens forces preemption
CASES = {
    "recycle": (dict(num_slots=2, page_size=4, pages_per_slot=8),
                [8, 5, 7, 6], (7, 5, 15)),
    "preempt": (dict(num_slots=3, page_size=4, pages_per_slot=10,
                     num_pages=12), [14, 14, 14], (11, 8, 10)),
}


@pytest.fixture(scope="module")
def models():
    jcfg = JC.get_reduced(ARCH).replace(dtype="float32", remat="none")
    tcfg = TC.get_reduced(ARCH).replace(dtype="float32", remat="none")
    jlm = j_build(jcfg)
    jp = j_init(jax.random.PRNGKey(0), jlm)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jlm, jp, t_build(tcfg), tp


def _prompts(vocab, n, seed, lo, hi):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, int(rng.randint(lo, hi + 1))).tolist()
            for _ in range(n)]


def _serve(engine, prompts, gens):
    rids = [engine.submit(p, max_new_tokens=g) for p, g in zip(prompts, gens)]
    res = engine.run()
    return [res[r].tokens for r in rids]


_JAX_RUNS: dict = {}


def _jax_tokens(models, case, quantized):
    """The reference run, once per (case, pool numerics) per process."""
    key = (case, quantized)
    if key not in _JAX_RUNS:
        jlm, jp, _, _ = models
        pool, gens, (seed, lo, hi) = CASES[case]
        prompts = _prompts(jlm.cfg.vocab_size, len(gens), seed, lo, hi)
        eng = JEngine(jlm, jp, JEC(pool=JPC(**pool, quantized=quantized),
                                   fused_attention=True, fused_impl="jnp"),
                      ShardPlan(mesh=None))
        _JAX_RUNS[key] = (prompts, gens, _serve(eng, prompts, gens),
                          eng.summary())
    return _JAX_RUNS[key]


@pytest.mark.parametrize("case,quantized", [("recycle", False),
                                            ("recycle", True),
                                            ("preempt", True)])
@pytest.mark.parametrize("fused", [False, True])
def test_greedy_tokens_identical_to_jax_engine(models, case, quantized,
                                               fused):
    _, _, tlm, tp = models
    prompts, gens, ref, jsum = _jax_tokens(models, case, quantized)
    pool = PoolConfig(**CASES[case][0], quantized=quantized)
    eng = Engine(tlm, tp, EngineConfig(pool=pool, fused_attention=fused),
                 device="cpu")
    out = _serve(eng, prompts, gens)
    assert out == ref
    s = eng.summary()
    assert s["requests_completed"] == len(gens)
    assert [len(t) for t in out] == gens
    if case == "recycle":
        assert len(gens) > pool.num_slots
    assert s["cache_bytes"] == jsum["cache_bytes"]
    assert s["cache_bytes_fp32"] == jsum["cache_bytes_fp32"]
    if case == "preempt":
        assert s["preemptions"] >= 1 and jsum["preemptions"] >= 1


def test_sampling_knobs_process_like_the_reference():
    rng = np.random.RandomState(0)
    logits = (rng.randn(6, 50) * 3).astype(np.float32)
    temp = np.array([0.0, 0.7, 1.0, 1.3, 0.9, 2.0], np.float32)
    topk = np.array([0, 0, 5, 0, 3, 1], np.int32)
    topp = np.array([1.0, 0.9, 1.0, 0.0, 0.5, 1.0], np.float32)
    ref = j_probs(jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(topk),
                  jnp.asarray(topp))
    out = TS.processed_probs(torch.from_numpy(logits), torch.from_numpy(temp),
                             torch.from_numpy(topk), torch.from_numpy(topp))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)
    # supports agree exactly (same truncation decisions)
    np.testing.assert_array_equal(out.numpy() > 0, np.asarray(ref) > 0)
    gen = torch.Generator().manual_seed(0)
    for _ in range(5):
        toks = TS.sample_tokens(torch.from_numpy(logits), gen,
                                torch.from_numpy(temp),
                                torch.from_numpy(topk),
                                torch.from_numpy(topp)).numpy()
        assert toks[0] == logits[0].argmax() and toks[5] == logits[5].argmax()
        assert all(np.asarray(ref)[i, t] > 0 for i, t in enumerate(toks))


def _imports(path: Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module.split(".")[0])
    return mods


def test_port_imports_neither_jax_nor_repro():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 15
    bad = {str(f.relative_to(PORT)): sorted(_imports(f) & {"jax", "jaxlib",
                                                           "repro"})
           for f in files}
    assert not {f: m for f, m in bad.items() if m}
    smoke = PORT.parents[1] / "chip_smoke.py"
    assert not _imports(smoke) & {"jax", "jaxlib", "repro"}


def test_entry_points_raise_without_a_card(models, monkeypatch):
    """No device argument means the card; without one they raise rather
    than drift to the CPU."""
    _, _, tlm, tp = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pool = PoolConfig(num_slots=2, page_size=4, pages_per_slot=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(tlm, tp, EngineConfig(pool=pool))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_init(torch.Generator(), tlm)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax({"layers": {}})
    # the zoo-LM training slice: init with TT sites, the state converter
    # and the training loop
    from repro_torch.configs.base import TrainConfig
    from repro_torch.convert import lm_train_state_from_jax
    from repro_torch.launch.train import train
    tt_lm = t_build(TC.with_tt(tlm.cfg, quantize=True).replace(
        tt=TC.TTConfig(enable=True, min_elements=1)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_init(torch.Generator(), tt_lm)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_train_state_from_jax(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(tt_lm.cfg, "tp", TrainConfig(total_steps=1), batch=1, seq=4)
    Engine(tlm, tp, EngineConfig(pool=pool), device="cpu")


# chunked prefill, the prefix cache, speculative decoding, the policy's
# kv_cache site, quant health and the trace are ported (their parity with
# the reference: tests/test_torch_obs*.py); a mesh still raises
@pytest.mark.parametrize("ekw,kw", [
    ({}, dict(plan=object())),
    (dict(prefix_cache=True), dict(plan=object())),
])
def test_out_of_slice_engine_configs_raise(models, ekw, kw):
    _, _, tlm, tp = models
    pool = PoolConfig(num_slots=2, page_size=4, pages_per_slot=8)
    with pytest.raises(NotImplementedError, match="later slice"):
        Engine(tlm, tp, EngineConfig(pool=pool, **ekw), device="cpu", **kw)


def test_engine_pool_numerics_follow_policy(models):
    """EngineConfig.policy: the kv_cache site owns the pool's numerics (the
    port's twin of test_numerics.py's test of that name)."""
    _, _, tlm, tp = models
    from repro_torch.numerics import NumericsPolicy
    pol = NumericsPolicy(enable=True)
    eng = Engine(tlm, tp, EngineConfig(
        pool=PoolConfig(num_slots=2, quantized=False), policy=pol),
        device="cpu")
    assert eng.pcfg.quantized and eng.pcfg.bits == \
        pol.spec_for("kv_cache").bits
    assert eng.pcfg.spec == pol.spec_for("kv_cache")
    leaf = next(iter(next(iter(eng.pool["data"].values())).values()))
    assert leaf.dtype == torch.int8
    off = Engine(tlm, tp, EngineConfig(
        pool=PoolConfig(num_slots=2, quantized=True),
        policy=NumericsPolicy(enable=False)), device="cpu")
    assert not off.pcfg.quantized
    assert next(iter(off.pool["data"]["sub_0"].values())).dtype == \
        torch.float32


def test_policy_with_a_4_bit_kv_site_equals_jax(models):
    """A policy whose kv_cache site is 4-bit over an fp pool config: an
    int8-stored 4-bit pool in both packages, the same greedy tokens."""
    import dataclasses
    from repro.numerics import NumericsPolicy as JPolicy
    from repro_torch.numerics import NumericsPolicy
    jlm, jp, tlm, tp = models
    pool, gens, (seed, lo, hi) = CASES["recycle"]
    prompts = _prompts(jlm.cfg.vocab_size, len(gens), seed, lo, hi)
    jpol = JPolicy(enable=True)
    jpol = jpol.with_spec("kv_cache", dataclasses.replace(
        jpol.spec_for("kv_cache"), bits=4))
    tpol = NumericsPolicy(enable=True)
    tpol = tpol.with_spec("kv_cache", dataclasses.replace(
        tpol.spec_for("kv_cache"), bits=4))
    jeng = JEngine(jlm, jp, JEC(pool=JPC(**pool), policy=jpol),
                   ShardPlan(mesh=None))
    want = _serve(jeng, prompts, gens)
    eng = Engine(tlm, tp, EngineConfig(pool=PoolConfig(**pool), policy=tpol),
                 device="cpu")
    assert eng.pcfg.quantized and eng.pcfg.bits == 4
    got = _serve(eng, prompts, gens)
    assert got == want
    # 4-bit codes stay inside [-8, 7]
    leaf = eng.pool["data"]["sub_0"]["k"]
    assert leaf.dtype == torch.int8 and int(leaf.min()) >= -8 \
        and int(leaf.max()) <= 7
    assert eng.summary()["cache_bytes"] == jeng.summary()["cache_bytes"]
