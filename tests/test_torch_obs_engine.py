"""The port's ``Engine(trace=..., policy=health)`` against the JAX
``Engine`` with the prefix cache and with speculative decoding, on the
CPU (the plain and chunked modes are in ``test_torch_obs.py``, whose
comparison this file reuses).

(a) prefix cache: shared-prefix prompts on a pool small enough that the
    tree evicts — ``cache_hit``, ``cow_fork``, ``prefix_evict`` and the
    page events equal the reference's, and the ledger's uncounted
    ``prefix_*`` overlays and ``prefix_tree`` site equal too;
(b) speculative decoding with a self-draft: ``spec_step`` events, the
    ``draft_params`` and ``draft_kv_pool`` ledger sites, and the
    decode-step quant health (the reference counts none in a spec round:
    ``quant_health`` stays empty in both).

Each mode makes one JAX engine run.
"""
import copy

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.obs as JO  # noqa: E402
from repro import numerics as JN  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import EngineConfig as JEC  # noqa: E402
from repro.serve import PoolConfig as JPC  # noqa: E402
import repro_torch.obs as TO  # noqa: E402
from repro_torch import numerics as TN  # noqa: E402
from repro_torch.serve import Engine, EngineConfig, PoolConfig  # noqa: E402
from test_torch_obs import (ARCH, PLAN, _clock, _serve,  # noqa: E402,F401
                            check_engines, models)

# mode -> (pool, engine fields, prompt lengths, shared preamble, gens)
MODES = {
    "prefix": (dict(num_slots=2, page_size=4, pages_per_slot=8, num_pages=10,
                    quantized=True), dict(prefix_cache=True),
               [14, 15, 14, 13, 14, 12, 13], 10, [4, 3, 5, 4, 3, 4, 3]),
    "spec": (dict(num_slots=2, page_size=4, pages_per_slot=8,
                  quantized=True), dict(spec_k=2), [5, 9, 3], 0, [7, 6, 8]),
}


def _prompts(vocab, lens, preamble):
    """The first three prompts share ``preamble`` tokens (the second forks
    the first's page mid-way); the rest are their own, so the tree grows
    past the pool and evicts."""
    rng = np.random.RandomState(11)
    pre = rng.randint(0, vocab, preamble).tolist()
    out = [(pre if k < 3 else []) + rng.randint(
        0, vocab, n - (preamble if k < 3 else 0)).tolist()
        for k, n in enumerate(lens)]
    if preamble:
        out[1] = out[0][:13] + out[1][13:]
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_trace_health_ledger_equal_jax(models, mode):
    jlm, jp, tlm, tp, _ = models
    pool, fields, lens, pre, gens = MODES[mode]
    prompts = _prompts(jlm.cfg.vocab_size, lens, pre)
    jrec = JO.TraceRecorder(clock=_clock())
    # the self-draft holds its own copy of the weights, as a real draft
    # does: the ledger counts both and so does the live reconcile
    jeng = JEngine(jlm, jp, JEC(pool=JPC(**pool), policy=JN.NumericsPolicy(
        enable=True, health=True), **fields), PLAN, clock=_clock(), trace=jrec,
        draft=((jlm, jax.tree.map(lambda a: a + 0, jp)) if mode == "spec"
               else None))
    jtoks = _serve(jeng, prompts, gens)
    trec = TO.TraceRecorder(clock=_clock())
    teng = Engine(tlm, tp, EngineConfig(
        pool=PoolConfig(**pool), policy=TN.NumericsPolicy(
            enable=True, health=True), **fields), device="cpu",
        clock=_clock(), trace=trec,
        draft=(tlm, copy.deepcopy(tp)) if mode == "spec" else None)
    ts = check_engines(jeng, jrec, jtoks, teng, trec,
                       _serve(teng, prompts, gens))
    kinds = {e.kind for e in trec}
    sites = ts["memory"]["sites"]
    if mode == "prefix":
        assert {"cache_hit", "cow_fork", "prefix_evict"} <= kinds
        assert ts["quant_health"]["kv_cache"]["total"] > 0
        assert sites["prefix_tree"]["counted"] is False
        assert sites["prefix_tree"]["peak_bytes"] > 0
        assert ts["prefix_hit_tokens"] > 0 and ts["cow_forks"] > 0
    else:
        assert "spec_step" in kinds and "decode_step" not in kinds
        assert ts["spec"]["acceptance_rate"] == 1.0
        assert sites["draft_params"]["bytes"] == sites["params"]["bytes"]
        assert sites["draft_kv_pool"]["bytes"] == sites["kv_pool"]["bytes"]
        assert ts["quant_health"] == {}
