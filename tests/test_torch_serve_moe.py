"""repro_torch.serve with MoE sublayers against repro.serve (the JAX
reference engine), token for token, float32 on the CPU, on transferred
weights (``convert.params_from_jax``), prompts from numpy seeds.

The reduced moonshot-v1-16b (2 layers, 8 experts, top-2, capacity factor
1.25) serves ragged prompts on 2 slots in each mode the reference serves
MoE in, and each mode's greedy tokens must equal the JAX engine's in the
same mode, over the int8 pool: whole prompt, bucketed whole prompt
(padding masked out of the routers), chunked prefill (8; a remainder of
5 rows padded to the chunk, as the reference pads it) with
``moe_capacity_by_prompt`` off and on, a prefix-cache hit (the suffix
through the chunk step) and speculative decoding (k = 3) with a dense
one-layer draft; the reduced jamba-1.5-large with experts (two
requests of 30 tokens) whole-prompt and chunked (10; a stateful arch
pads nothing, in both packages). Moonshot's
whole-prompt prefills are capacity-bound: the port's routers drop
(expert, token) pairs there, counted by the test.

Whole prompt against chunked is not asserted at the config's capacity:
the reference does not hold it (its chunks see a larger capacity share
than the whole prompt does). On a mismatch the failure message names the
first differing token and the margin of the port's greedy choice there.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as JC  # noqa: E402
from repro.configs.base import MoEConfig as JMoE  # noqa: E402
from repro.models import build_lm as j_build  # noqa: E402
from repro.models import init_lm as j_init  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import EngineConfig as JEC  # noqa: E402
from repro.serve import PoolConfig as JPC  # noqa: E402
from repro.sharding import ShardPlan  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import build_lm as t_build  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.serve import Engine, EngineConfig, PoolConfig  # noqa: E402

POOL = dict(num_slots=2, page_size=8, pages_per_slot=8)
# two lengths (each a compiled prefill shape of the JAX engine), three
# requests (the third reuses a retired slot)
LENS, GENS = [24, 37, 24], [6, 5, 7]
JAMBA_LENS, JAMBA_GENS = [30, 30], [5, 6]

_MODELS: dict = {}


def _models(arch, layers=None, experts=None, seed=0):
    """(reference lm, params, port lm, params) of the reduced ``arch`` in
    float32; ``layers``/``experts`` cut it (the dense draft)."""
    key = (arch, layers, experts, seed)
    if key not in _MODELS:
        jo, to = {}, {}
        if layers is not None:
            jo["num_layers"] = to["num_layers"] = layers
        if experts is not None:
            jo["moe"], to["moe"] = (JMoE(num_experts=experts),
                                    MoEConfig(num_experts=experts))
        jcfg = JC.get_reduced(arch).replace(dtype="float32", remat="none",
                                            **jo)
        jlm = j_build(jcfg)
        jp = jax.jit(lambda k: j_init(k, jlm))(jax.random.PRNGKey(seed))
        tlm = t_build(TC.get_reduced(arch).replace(dtype="float32",
                                                   remat="none", **to))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        _MODELS[key] = (jlm, jp, tlm, tp)
    return _MODELS[key]


def _prompts(vocab, lens, seed, preamble=0):
    rng = np.random.RandomState(seed)
    pre = rng.randint(0, vocab, preamble).tolist()
    return [pre + rng.randint(0, vocab, n - preamble).tolist() for n in lens]


def _serve(engine, prompts, gens):
    rids = [engine.submit(p, max_new_tokens=g) for p, g in zip(prompts, gens)]
    res = engine.run()
    return [res[r].tokens for r in rids]


# mode -> (arch, engine config fields, prompts' seed, preamble)
MODES = {
    "whole": ("moonshot-v1-16b", {}, 3, 0),
    "bucket": ("moonshot-v1-16b", dict(prefill_bucket=16), 3, 0),
    "chunked": ("moonshot-v1-16b", dict(prefill_chunk=8), 3, 0),
    "chunked by prompt": ("moonshot-v1-16b",
                          dict(prefill_chunk=8, moe_capacity_by_prompt=True),
                          3, 0),
    "prefix hit": ("moonshot-v1-16b", dict(prefix_cache=True), 4, 18),
    "spec": ("moonshot-v1-16b", dict(spec_k=3), 3, 0),
    "jamba whole": ("jamba-1.5-large", {}, 5, 0),
    "jamba chunked": ("jamba-1.5-large", dict(prefill_chunk=10), 5, 0),
}


def _lens(mode):
    return (JAMBA_LENS, JAMBA_GENS) if mode.startswith("jamba") else (LENS,
                                                                      GENS)


def _config(cls, pool_cls, fields):
    return cls(pool=pool_cls(**POOL, quantized=True), **fields)


def _draft(mode):
    if MODES[mode][1].get("spec_k"):
        return _models("moonshot-v1-16b", layers=1, experts=0, seed=1)
    return None


_JAX: dict = {}


def _jax_tokens(mode):
    if mode not in _JAX:
        arch, fields, seed, pre = MODES[mode]
        jlm, jp, _, _ = _models(arch)
        lens, gens = _lens(mode)
        prompts = _prompts(jlm.cfg.vocab_size, lens, seed, pre)
        d = _draft(mode)
        eng = JEngine(jlm, jp, _config(JEC, JPC, fields), ShardPlan(mesh=None),
                      draft=None if d is None else d[:2])
        _JAX[mode] = (prompts, _serve(eng, prompts, gens), eng.summary())
    return _JAX[mode]


def _margin(tlm, tp, prompt, toks, at):
    """The port's static greedy margin (top-1 minus top-2 logit) at the
    first differing token, for the failure message."""
    from repro_torch.models import lm_forward
    seq = torch.tensor([prompt + toks[:at]])
    logits = lm_forward(tp, tlm, tokens=seq)[0][0, -1]
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1])


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_tokens_equal_jax_engine(mode, monkeypatch):
    arch, fields, _, _ = MODES[mode]
    _, _, tlm, tp = _models(arch)
    prompts, want, jsum = _jax_tokens(mode)
    drops = []
    select = TM._select

    def counted(w_tok, c):
        cw, cidx = select(w_tok, c)
        drops.append(int((w_tok > 0).sum() - (cw > 0).sum()))
        return cw, cidx
    monkeypatch.setattr(TM, "_select", counted)
    d = _draft(mode)
    eng = Engine(tlm, tp, _config(EngineConfig, PoolConfig, fields),
                 device="cpu", draft=None if d is None else d[2:])
    got = _serve(eng, prompts, _lens(mode)[1])
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            at = next(j for j, (a, b) in enumerate(zip(g, w)) if a != b)
            pytest.fail(f"{mode}: request {i} differs at token {at} (port "
                        f"{g}, JAX {w}); the port's greedy margin there "
                        f"{_margin(tlm, tp, prompts[i], w, at):.3e}")
    s = eng.summary()
    for k in ("prefill_tokens", "prompt_tokens", "decode_steps",
              "generated_tokens"):
        assert s[k] == jsum[k], k
    if mode == "prefix hit":
        assert s["prefix_hit_tokens"] > 0
    if mode == "whole":
        # moonshot's whole-prompt prefills are capacity-bound
        assert sum(drops) > 0, mode
    if "chunked" in mode:
        assert sum(-(-n // fields["prefill_chunk"]) - 1
                   for n, _ in eng.metrics.prefills) > 0
