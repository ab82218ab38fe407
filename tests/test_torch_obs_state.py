"""Quant health, trace and ledger of the port's engine against the JAX
engine on MLA's latent pool and on rwkv6's recurrent-state pool, on the
CPU (the comparison is ``test_torch_obs.py``'s ``check_engines``).

(a) reduced ``deepseek-v2-236b`` (MLA, MoE) from an int8 latent pool: the
    ``kv_cache`` counts cover both cached tensors, ``c_kv`` and
    ``k_rope``, in the one append a layer;
(b) reduced ``rwkv6-1.6b`` from an int8 state pool (unpaged): the
    ``ssm_state`` counts and scale drift, summed over every layer and
    state tensor of each decode step, equal the reference's; the
    ``state_pool`` site holds the pool's bytes.

One JAX engine run each.
"""
import jax
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
import repro_torch.configs as TC  # noqa: E402
import repro_torch.obs as TO  # noqa: E402
from repro_torch import numerics as TN  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import build_lm as t_build  # noqa: E402
from repro_torch.serve import Engine, EngineConfig, PoolConfig  # noqa: E402
from repro_torch.serve import kv_cache as TKC  # noqa: E402
from test_torch_obs import PLAN, _clock, _serve, check_engines  # noqa: E402

POOL = dict(num_slots=2, page_size=4, pages_per_slot=8, quantized=True)
ARCHS = {"deepseek-v2-236b": ([3, 7, 2], [6, 5, 7]),
         "rwkv6-1.6b": ([4, 9, 3], [7, 5, 6])}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_engine_health_equal_jax(arch):
    lens, gens = ARCHS[arch]
    kw = dict(dtype="float32", remat="none")
    jlm = j_build(JC.get_reduced(arch).replace(**kw))
    jp = j_init(jax.random.PRNGKey(1), jlm)
    tlm = t_build(TC.get_reduced(arch).replace(**kw))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, jlm.cfg.vocab_size, n).tolist() for n in lens]
    jrec = JO.TraceRecorder(clock=_clock())
    jeng = JEngine(jlm, jp, JEC(pool=JPC(**POOL), policy=JN.NumericsPolicy(
        enable=True, health=True)), PLAN, clock=_clock(), trace=jrec)
    jtoks = _serve(jeng, prompts, gens)
    trec = TO.TraceRecorder(clock=_clock())
    teng = Engine(tlm, tp, EngineConfig(
        pool=PoolConfig(**POOL), policy=TN.NumericsPolicy(
            enable=True, health=True)), device="cpu", clock=_clock(),
        trace=trec)
    ts = check_engines(jeng, jrec, jtoks, teng, trec,
                       _serve(teng, prompts, gens))
    active = sum(e.fields["n_active"] for e in trec.events("decode_step"))
    health = ts["quant_health"]
    if arch.startswith("deepseek"):
        per = tlm.n_periods * sum(
            int(np.prod(f)) for sub in tlm.period
            for f in TKC.kv_feature_shapes(sub).values())
        assert set(TKC.kv_feature_shapes(tlm.period[0])) == {"c_kv", "k_rope"}
        assert health["kv_cache"]["total"] == per * active
        assert set(health) == {"kv_cache"}
    else:
        st = health["ssm_state"]
        assert set(health) == {"ssm_state"}
        assert st["total"] > 0 and st["scale_drift_log2"] > 0
        assert ts["memory"]["sites"]["state_pool"]["bytes"] == \
            ts["state_bytes"] > 0
        assert all(e.fields["free_pages"] is None
                   for e in trec.events("decode_step"))
