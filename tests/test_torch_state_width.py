"""The int8 recurrent-state pool at rwkv6-1.6b's full width against repro
(the JAX reference): d_model 2,048, 32 heads x 64, d_ff 7,168 and the
65,536-token vocabulary, cut to 2 layers, float32, weights carried by
``convert.params_from_jax``.

The port's engine emits the JAX engine's greedy tokens over an int8 state
pool and over an fp pool, so the int8 pool's token agreement with the fp
pool at this width is the reference's own. The test prints both
agreements (``pytest -s``).
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
from repro_torch.models import build_lm as t_build  # noqa: E402
from repro_torch.serve import Engine, EngineConfig, PoolConfig  # noqa: E402

ARCH, LAYERS, GEN = "rwkv6-1.6b", 2, 12


def _serve(eng, prompts):
    rids = [eng.submit(p, max_new_tokens=GEN) for p in prompts]
    res = eng.run()
    return [res[r].tokens for r in rids]


def test_int8_state_engine_matches_jax_engine_at_full_width():
    jcfg = JC.get_config(ARCH).replace(num_layers=LAYERS, dtype="float32",
                                       remat="none")
    assert (jcfg.d_model, jcfg.d_ff, jcfg.vocab_size) == (2048, 7168, 65536)
    jlm = j_build(jcfg)
    jp = j_init(jax.random.PRNGKey(0), jlm)
    tlm = t_build(TC.get_config(ARCH).replace(num_layers=LAYERS,
                                              dtype="float32", remat="none"))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, jcfg.vocab_size, int(n)).tolist()
               for n in rng.randint(16, 33, size=3)]
    pool = dict(num_slots=2, page_size=16, pages_per_slot=4)
    toks = {}
    for q in (True, False):
        toks["jax", q] = _serve(JEngine(jlm, jp, JEC(pool=JPC(
            **pool, quantized=q)), ShardPlan(mesh=None)), prompts)
        toks["port", q] = _serve(Engine(tlm, tp, EngineConfig(
            pool=PoolConfig(**pool, quantized=q)), device="cpu"), prompts)
        assert toks["port", q] == toks["jax", q], q
    agree = {side: sum(a == b for x, y in zip(toks[side, True],
                                              toks[side, False])
                       for a, b in zip(x, y)) / (len(prompts) * GEN)
             for side in ("jax", "port")}
    assert agree["port"] == agree["jax"]
    print(f"{ARCH} at full width, {LAYERS} layers, f32: int8-vs-fp state "
          f"pool greedy agreement {agree['jax']:.3f} (JAX engine) "
          f"{agree['port']:.3f} (port)")
