"""repro_torch.serve with MLA sublayers against repro.serve (the JAX
reference engine), token for token, float32 on the CPU, on transferred
weights (``convert.params_from_jax``), prompts from numpy seeds.

The reduced deepseek-v2-236b (2 layers of MLA with kv_lora 32 and rope 8,
each with an MoE of 8 experts top-2 and a shared expert) serves ragged
prompts from a latent page pool (``c_kv`` and ``k_rope`` pages of two
widths) in five modes, over an int8 pool and over an fp32 pool: whole
prompt (3 requests recycling 2 slots), chunked prefill (chunks of 8), a
shared pool small enough to force preemption, the prefix cache on (a
shared preamble, the suffix through the chunk step) and speculative
decoding (k = 2) with the target itself as the MLA draft. Each mode's
greedy tokens must equal the JAX engine's in the same mode; MLA attends on
the gather path even with ``fused_attention=True``, as the reference's
``_fused_for`` rules, so every mode asks for the fused kernel and none may
reach it. On the CPU the paged kernels run their plain twins; the test
counts the engine's calls of the three wrappers (``kernels/ops.py``).
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as JC  # noqa: E402
from repro.models import build_lm as j_build  # noqa: E402
from repro.models import init_lm as j_init  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import EngineConfig as JEC  # noqa: E402
from repro.serve import PoolConfig as JPC  # noqa: E402
from repro.sharding import ShardPlan  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build_lm as t_build  # noqa: E402
from repro_torch.serve import Engine, EngineConfig, PoolConfig  # noqa: E402

ARCH = "deepseek-v2-236b"
POOL = dict(num_slots=2, page_size=4, pages_per_slot=8)
# mode -> (pool, engine fields, gens, (prompt seed, lengths), preamble)
MODES = {
    "whole": (POOL, {}, [6, 5, 7], (3, [13, 21, 13]), 0),
    "chunked": (POOL, dict(prefill_chunk=8), [6, 5, 7], (3, [13, 21, 13]),
                0),
    "preempted": (dict(num_slots=3, page_size=4, pages_per_slot=10,
                       num_pages=12), {}, [14, 14, 14], (11, [9, 9, 9]), 0),
    "prefix": (POOL, dict(prefix_cache=True), [5, 5, 5], (4, [17, 17, 17]),
               10),
    "spec": (POOL, dict(spec_k=2), [6, 5, 7], (3, [13, 21, 13]), 0),
}
RUNS = [(m, q) for m in MODES for q in (True, False)]


@pytest.fixture(scope="module")
def models():
    jcfg = JC.get_reduced(ARCH).replace(dtype="float32", remat="none")
    tcfg = TC.get_reduced(ARCH).replace(dtype="float32", remat="none")
    jlm = j_build(jcfg)
    jp = j_init(jax.random.PRNGKey(1), jlm)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jlm, jp, t_build(tcfg), tp


def _prompts(vocab, seed, lens, preamble):
    rng = np.random.RandomState(seed)
    pre = rng.randint(0, vocab, preamble).tolist()
    return [pre + rng.randint(0, vocab, n - preamble).tolist() for n in lens]


def _serve(engine, prompts, gens):
    rids = [engine.submit(p, max_new_tokens=g) for p, g in zip(prompts, gens)]
    res = engine.run()
    return [res[r].tokens for r in rids]


def _config(cls, pool_cls, mode, quantized):
    pool, fields = MODES[mode][:2]
    return cls(pool=pool_cls(**pool, quantized=quantized),
               fused_attention=True, **fields)


_JAX: dict = {}


def _jax_run(models, mode, quantized):
    """The reference run, once per (mode, pool numerics) per process."""
    if (mode, quantized) not in _JAX:
        jlm, jp, _, _ = models
        _, _, gens, (seed, lens), pre = MODES[mode]
        prompts = _prompts(jlm.cfg.vocab_size, seed, lens, pre)
        draft = (jlm, jp) if mode == "spec" else None
        eng = JEngine(jlm, jp, _config(JEC, JPC, mode, quantized),
                      ShardPlan(mesh=None), draft=draft)
        _JAX[mode, quantized] = (prompts, _serve(eng, prompts, gens),
                                 eng.summary())
    return _JAX[mode, quantized]


def _count_calls(monkeypatch):
    """Count the engine's calls of the paged wrappers; the paged-attention
    wrapper raises."""
    calls: dict = {}
    for name in ("append_paged", "read_paged", "prefill_paged"):
        fn = getattr(ops, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(ops, name, counted)

    def refused(*a, **kw):
        raise AssertionError("an MLA sublayer reached paged attention")
    monkeypatch.setattr(ops, "paged_attention", refused)
    return calls


@pytest.mark.parametrize("mode,quantized", RUNS,
                         ids=[f"{m}-{'int8' if q else 'fp32'}"
                              for m, q in RUNS])
def test_mla_engine_tokens_equal_jax_engine(models, mode, quantized,
                                            monkeypatch):
    _, _, tlm, tp = models
    prompts, want, jsum = _jax_run(models, mode, quantized)
    gens = MODES[mode][2]
    calls = _count_calls(monkeypatch)
    eng = Engine(tlm, tp, _config(EngineConfig, PoolConfig, mode, quantized),
                 device="cpu", draft=(tlm, tp) if mode == "spec" else None)
    assert set(eng.pool["data"]["sub_0"]) == {"c_kv", "k_rope"}
    got = _serve(eng, prompts, gens)
    assert got == want
    s = eng.summary()
    for k in ("prefill_tokens", "prompt_tokens", "decode_steps",
              "generated_tokens", "cache_bytes", "cache_bytes_fp32"):
        assert s[k] == jsum[k], k
    if quantized:
        assert calls["append_paged"] > 0 and calls["read_paged"] > 0
        assert calls["prefill_paged"] > 0
        assert s["cache_reduction"] > 3.9
    else:
        assert not calls            # a model-dtype pool runs no kernel
    if mode == "chunked":
        assert any(n > 8 for n, _ in eng.metrics.prefills)
    if mode == "preempted":
        assert s["preemptions"] >= 1 and jsum["preemptions"] >= 1
    if mode == "prefix":
        assert s["prefix_hit_tokens"] > 0
    if mode == "spec":
        assert s["spec"]["acceptance_rate"] == 1.0


def test_mla_paged_calls_per_step(models, monkeypatch):
    """An int8 decode step: one ``append_paged`` and one ``read_paged`` a
    layer, for the latent pair at its two widths; a whole-prompt prefill
    one ``prefill_paged``."""
    _, _, tlm, tp = models
    calls = _count_calls(monkeypatch)
    eng = Engine(tlm, tp, _config(EngineConfig, PoolConfig, "whole", True),
                 device="cpu")
    eng.submit(list(range(9)), max_new_tokens=3)
    eng.step()                  # the admission's prefill and a decode step
    assert calls == {"prefill_paged": 1, "append_paged": tlm.n_periods,
                     "read_paged": tlm.n_periods}
