"""repro_torch.serve with recurrent state against repro (the JAX reference):
the twins of ``tests/test_serve_state.py`` on the reduced rwkv6-1.6b and
jamba-1.5-large with dense FFNs (the expert variant is held in
``tests/test_torch_serve_moe.py``), float32, weights carried by
``convert.params_from_jax``.

(a) continuous batching (admission, decode, retirement, refill, a recycled
    slot reset on admission) emits the JAX static reference's greedy
    tokens (``make_prefill_step`` + ``lm_decode_step``), also through a
    preemption under page pressure (jamba) and a forced one (rwkv6);
(b) chunked prefill carries the state across chunks: chunk widths 0, 8
    and 7 emit the static reference's tokens;
(c) an int8 state pool cuts state bytes >= 3.5x (bytes equal to the
    reference pool's), keeps the first token, serves the JAX engine's
    tokens over an int8 pool (its post-prompt codes and scales bit for
    bit), and its decoded post-prompt state is within half a grid step of
    the fp pool's; the policy's
    ``ssm_state`` site owns the pool's numerics and refuses what the pool
    cannot store;
(d) slot isolation under reset / write / snapshot / restore;
(e) a pure-SSM arch admits past the pool's ``max_len`` (the scheduler runs
    unpaged), stateful archs bypass the prefix cache with its counters at
    0, and speculative decoding refuses a stateful target.

The static reference runs once per arch per process (``_static``): greedy
to 14 tokens, so a shorter request's tokens are its prefix.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as JC  # noqa: E402
from repro.configs.base import MoEConfig as JMoE  # noqa: E402
from repro.launch.steps import make_prefill_step  # noqa: E402
from repro.models import build_lm as j_build  # noqa: E402
from repro.models import init_lm as j_init  # noqa: E402
from repro.models import lm_decode_step as j_decode  # noqa: E402
from repro.serve import state_cache as JSC  # noqa: E402
from repro.sharding import ShardPlan  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import build_lm as t_build  # noqa: E402
from repro_torch.models import init_lm as t_init  # noqa: E402
from repro_torch.numerics import NumericsPolicy, QuantSpec, qrange  # noqa: E402
from repro_torch.serve import Engine, EngineConfig, PoolConfig  # noqa: E402
from repro_torch.serve import state_cache as SC  # noqa: E402

PLAN = ShardPlan(mesh=None)
ARCHS = ["rwkv6-1.6b", "jamba-1.5-large"]
GEN_MAX = 14            # the static reference's greedy length
HORIZON = 64            # its attention cache's length


def _prompts(vocab, n, lo, hi, seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, int(rng.randint(lo, hi + 1))).tolist()
            for _ in range(n)]


_MODELS: dict = {}


def _models(arch):
    """(reference lm, params, port lm, params, the requests' prompts: four
    of 8..16 tokens and one of 24)."""
    if arch not in _MODELS:
        jo, to = {}, {}
        if arch.startswith("jamba"):
            jo = {"moe": JMoE(num_experts=0)}
            to = {"moe": MoEConfig(num_experts=0)}
        jcfg = JC.get_reduced(arch).replace(dtype="float32", remat="none",
                                            **jo)
        jlm = j_build(jcfg)
        jp = j_init(jax.random.PRNGKey(0), jlm)
        tlm = t_build(TC.get_reduced(arch).replace(dtype="float32",
                                                   remat="none", **to))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        prompts = (_prompts(jcfg.vocab_size, 4, 8, 16)
                   + _prompts(jcfg.vocab_size, 1, 24, 24, seed=5))
        _MODELS[arch] = (jlm, jp, tlm, tp, prompts)
    return _MODELS[arch]


_STATIC: dict = {}


def _static(arch) -> dict:
    """The JAX static reference's greedy tokens (GEN_MAX) of each prompt of
    ``_models(arch)``, keyed by the prompt: whole-prompt prefill, then
    scalar-``cur_len`` decode carrying the state through the cache tree
    (attention leaves padded to HORIZON)."""
    if arch not in _STATIC:
        jlm, jp, _, _, prompts = _models(arch)
        prefill = jax.jit(make_prefill_step(jlm, PLAN))
        decode = jax.jit(lambda p, c, t, n: j_decode(p, c, t, n, jlm, PLAN))
        out = {}
        for prompt in prompts:
            logits, cache = prefill(jp, {"tokens": jnp.asarray(prompt,
                                                               jnp.int32)[None]})
            n = len(prompt)

            def pad(path, a):
                if path[-1].key in ("k", "v"):
                    return jnp.pad(a, [(0, 0), (0, 0), (0, HORIZON - n)]
                                   + [(0, 0)] * (a.ndim - 3))
                return a
            cache = jax.tree_util.tree_map_with_path(pad, cache)
            tok = int(jnp.argmax(logits[0, -1]))
            toks = [tok]
            for j in range(GEN_MAX - 1):
                lg, cache = decode(jp, cache, jnp.asarray([[tok]], jnp.int32),
                                   jnp.int32(n + j))
                tok = int(jnp.argmax(lg[0, -1]))
                toks.append(tok)
            out[tuple(prompt)] = toks
        _STATIC[arch] = out
    return _STATIC[arch]


def _want(arch, prompt, gen):
    return _static(arch)[tuple(prompt)][:gen]


def _engine(arch, **pool):
    _, _, tlm, tp, _ = _models(arch)
    ekw = {k: pool.pop(k) for k in ("prefill_chunk", "policy", "prefix_cache")
           if k in pool}
    return Engine(tlm, tp, EngineConfig(pool=PoolConfig(**pool), **ekw),
                  device="cpu")


def _serve(eng, prompts, gens):
    rids = [eng.submit(p, max_new_tokens=g) for p, g in zip(prompts, gens)]
    res = eng.run()                     # every completion of the engine
    assert set(rids) <= set(res)
    return [res[r].tokens for r in rids]


# ---------------------------------------------------------------------------
# (a) continuous batching == static decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_continuous_batching_matches_static_decode(arch):
    """4 staggered requests on 2 slots (slots recycle, each reset on
    admission): the JAX static reference's tokens, request by request."""
    prompts = _models(arch)[4][:4]
    gens = [8, 5, 7, 6]
    eng = _engine(arch, num_slots=2, page_size=8, pages_per_slot=4,
                  quantized=False)
    out = _serve(eng, prompts, gens)
    assert out == [_want(arch, p, g) for p, g in zip(prompts, gens)]
    s = eng.summary()
    assert s["state_bytes"] > 0 and s["requests_completed"] == 4
    if arch.startswith("rwkv6"):
        assert s["cache_bytes"] == 0        # pure-SSM: no KV pool at all
        assert not eng.sched.paged


def test_jamba_preemption_under_page_pressure_matches_static():
    """Hybrid: the attention layer's pages run out, the youngest slot is
    preempted, its state rebuilt by re-prefill; every request still emits
    the static reference's tokens."""
    prompts = _models("jamba-1.5-large")[4][:3]
    eng = _engine("jamba-1.5-large", num_slots=3, page_size=4,
                  pages_per_slot=10, num_pages=12, quantized=False)
    out = _serve(eng, prompts, [14] * 3)
    assert eng.summary()["preemptions"] >= 1
    assert out == [_want("jamba-1.5-large", p, 14) for p in prompts]


def test_rwkv6_forced_preemption_resumes_token_identical():
    """A pure-SSM engine never runs out of pages, so preemption is forced
    mid-decode: the request re-queues with its generated prefix, the slot
    is reset and re-prefilled, and the tokens still match."""
    prompts = _models("rwkv6-1.6b")[4][:2]
    eng = _engine("rwkv6-1.6b", num_slots=2, page_size=8, pages_per_slot=4,
                  quantized=False)
    rids = [eng.submit(p, max_new_tokens=10) for p in prompts]
    for _ in range(4):
        eng.step()
    assert eng.sched.preempt_youngest() is not None
    eng.metrics.preempted()
    res = eng.run()
    assert eng.summary()["preemptions"] == 1
    for rid, prompt in zip(rids, prompts):
        assert res[rid].tokens == _want("rwkv6-1.6b", prompt, 10)


# ---------------------------------------------------------------------------
# (b) chunked prefill carries the state across chunks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_chunked_prefill_matches_whole_prompt(arch):
    """Chunk widths 0 (whole prompt), 8 and 7 (a ragged tail, exact-length:
    no pad token enters the recurrence) emit the same tokens, the static
    reference's."""
    prompt = _models(arch)[4][4]
    want = _want(arch, prompt, 6)
    for chunk in (0, 8, 7):
        eng = _engine(arch, num_slots=2, page_size=8, pages_per_slot=6,
                      quantized=False, prefill_chunk=chunk)
        assert _serve(eng, [prompt], [6]) == [want], chunk


# ---------------------------------------------------------------------------
# (c) the int8 state pool and the policy's ssm_state site
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_state_bytes_and_first_token(arch):
    jlm, _, _, _, prompts = _models(arch)
    res = {}
    for q in (False, True):
        eng = _engine(arch, num_slots=2, page_size=8, pages_per_slot=4,
                      quantized=q)
        res[q] = (_serve(eng, [prompts[0]], [3])[0], eng.summary())
        # the pool's bytes are the reference pool's
        jpool = JSC.init_state_pool(jlm, 2, JSC.StateCacheConfig(quantized=q))
        assert res[q][1]["state_bytes"] == JSC.pool_bytes(jpool)
        assert res[q][1]["state_bytes_fp32"] == JSC.pool_bytes_fp32(jpool)
    fp_b, q_b = res[False][1]["state_bytes"], res[True][1]["state_bytes"]
    assert fp_b / q_b >= 3.5, (fp_b, q_b)
    assert res[True][1]["state_reduction"] >= 3.5
    # the first token comes from the prefill's logits: always equal
    assert res[True][0][0] == res[False][0][0] == _want(arch, prompts[0],
                                                        1)[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_state_engine_matches_jax_engine(arch):
    """On an int8 state pool, the port's engine with chunked prefill (8)
    emits the JAX engine's tokens (the state read, re-encoded and written
    every decode step and chunk step), and a prompt's post-prefill codes
    and scales equal the JAX engine's bit for bit."""
    from repro.serve import Engine as JEngine
    from repro.serve import EngineConfig as JEC
    from repro.serve import PoolConfig as JPC
    jlm, jp, _, _, prompts = _models(arch)
    pool = dict(num_slots=2, page_size=8, pages_per_slot=4, quantized=True)
    gens = [8, 5, 7, 6]
    jeng = JEngine(jlm, jp, JEC(pool=JPC(**pool), prefill_chunk=8), PLAN)
    want = _serve(jeng, prompts[:4], gens)
    eng = _engine(arch, **pool, prefill_chunk=8)
    assert _serve(eng, prompts[:4], gens) == want
    jeng = JEngine(jlm, jp, JEC(pool=JPC(**pool)), PLAN)
    eng = _engine(arch, **pool)
    for e in (jeng, eng):
        _serve(e, [prompts[4]], [1])             # the post-prompt state
    for part in ("data", "scale_log2"):
        for key, kinds in jeng.spool[part].items():
            for name, a in kinds.items():
                assert np.array_equal(eng.spool[part][key][name].numpy(),
                                      np.asarray(a)), (part, key, name)


def test_quantized_state_within_pow2_tolerance():
    """The int8 pool's decoded post-prompt state is within half a grid step
    of the fp pool's, elementwise (clipping allowed at the range edge)."""
    prompt = _models("rwkv6-1.6b")[4][1]
    pools = {}
    for q in (False, True):
        eng = _engine("rwkv6-1.6b", num_slots=1, page_size=8,
                      pages_per_slot=4, quantized=q)
        _serve(eng, [prompt], [1])      # prefill + retire: the post-prompt
        pools[q] = (eng.spool, eng.scfg)
    _, hi = qrange(8)
    for key in pools[False][0]["data"]:
        for name, fp_leaf in pools[False][0]["data"][key].items():
            fp = fp_leaf[:, 0].float().numpy()                  # (L, *feat)
            codes = pools[True][0]["data"][key][name][:, 0]
            sc = pools[True][0]["scale_log2"][key][name][:, 0]  # (L,)
            deq = SC.read_layer(codes, sc, torch.float32,
                                pools[True][1]).numpy()
            step = np.exp2(sc.numpy()).reshape((-1,) + (1,) * (fp.ndim - 1))
            clipped = np.abs(fp) >= step * hi
            err = np.abs(deq - fp)
            assert (err <= step / 2 + 1e-6)[~clipped].all(), (key, name)


def test_policy_ssm_state_site_owns_state_numerics():
    """EngineConfig.policy: the ssm_state site drives the state pool the
    way kv_cache drives the KV pool (a 4-bit site over an fp pool config);
    a site the pool cannot store raises."""
    pol = NumericsPolicy(enable=True).with_spec(
        "ssm_state", QuantSpec("pow2", 4, 0, "int8", "per_tensor_max"))
    eng = _engine("rwkv6-1.6b", num_slots=1, page_size=8, pages_per_slot=2,
                  quantized=False, policy=pol)
    assert eng.scfg.quantized and eng.scfg.bits == 4
    assert eng.scfg.spec == pol.spec_for("ssm_state")
    leaf = eng.spool["data"]["sub_0"]["wkv"]
    assert leaf.dtype == torch.int8
    toks = _serve(eng, [_models("rwkv6-1.6b")[4][0]], [4])
    assert int(leaf.min()) >= -8 and int(leaf.max()) <= 7 and toks
    off = _engine("rwkv6-1.6b", num_slots=1, page_size=8, pages_per_slot=2,
                  quantized=True, policy=NumericsPolicy(enable=False))
    assert not off.scfg.quantized
    for bad in (QuantSpec("pow2", 8, 0, "int16", "per_tensor_max"),
                QuantSpec("blockwise", 8, 64)):
        with pytest.raises(NotImplementedError, match="pow2 int8"):
            _engine("rwkv6-1.6b", num_slots=1, quantized=False,
                    policy=NumericsPolicy(enable=True).with_spec(
                        "ssm_state", bad))


# ---------------------------------------------------------------------------
# (d) slot isolation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantized", [False, True])
def test_state_cache_slot_isolation_walk(quantized):
    """Random reset / one-slot write / batched write / snapshot / restore:
    every slot always reads back exactly its own sentinel (powers of two,
    exact on the pow-2 grid)."""
    num_slots, L = 3, 2
    scfg = SC.StateCacheConfig(quantized=quantized)
    pool = {"data": {"sub_0": {"h": torch.zeros(
                (L, num_slots, 3),
                dtype=torch.int8 if quantized else torch.float32)}},
            "scale_log2": {"sub_0": {"h": torch.zeros((L, num_slots))}}}
    d, sc = pool["data"]["sub_0"]["h"], pool["scale_log2"]["sub_0"]["h"]
    rng = np.random.RandomState(0)
    expect = np.zeros((num_slots,), np.float32)
    snaps: dict = {}
    for _ in range(60):
        op = rng.choice(["reset", "write_slot", "write_batch", "snapshot",
                         "restore"])
        slot = int(rng.randint(num_slots))
        if op == "reset":
            SC.reset_slot(pool, slot)
            expect[slot] = 0.0
        elif op == "write_slot":
            val = float(2.0 ** rng.randint(-3, 4))
            for layer in range(L):
                SC.write_slot(d[layer], sc[layer], torch.full((3,), val),
                              slot, scfg)
            expect[slot] = val
        elif op == "write_batch":
            active = rng.rand(num_slots) < 0.5
            vals = 2.0 ** rng.randint(-3, 4, num_slots).astype(np.float32)
            new = torch.from_numpy(np.repeat(vals[:, None], 3, axis=1))
            for layer in range(L):
                SC.write_layer(d[layer], sc[layer], new,
                               torch.from_numpy(active), scfg)
            expect[active] = vals[active]
        elif op == "snapshot":
            snaps[slot] = (SC.snapshot_slot(pool, slot), expect[slot])
        elif op == "restore" and slot in snaps:
            SC.restore_slot(pool, snaps[slot][0], slot)
            expect[slot] = snaps[slot][1]
        for layer in range(L):
            got = SC.read_layer(d[layer], sc[layer], torch.float32,
                                scfg).numpy()
            for s in range(num_slots):
                assert (got[s] == expect[s]).all(), (layer, s, got[s])


def test_state_pool_reset_on_admit_isolates_recycled_slots():
    """A slot recycled across requests starts from zero state: a fresh
    engine and one whose only slot already served another request emit the
    same tokens for the same prompt."""
    prompts = _models("rwkv6-1.6b")[4]
    fresh = _engine("rwkv6-1.6b", num_slots=1, page_size=8, pages_per_slot=4,
                    quantized=False)
    want = _serve(fresh, [prompts[1]], [6])
    used = _engine("rwkv6-1.6b", num_slots=1, page_size=8, pages_per_slot=4,
                   quantized=False)
    _serve(used, [prompts[0]], [6])          # dirties slot 0's state
    assert _serve(used, [prompts[1]], [6]) == want
    assert want == [_want("rwkv6-1.6b", prompts[1], 6)]


# ---------------------------------------------------------------------------
# (e) admission, the prefix cache and speculative decoding
# ---------------------------------------------------------------------------

def test_pure_ssm_admits_past_max_len():
    """rwkv6's scheduler is unpaged: a request longer than the pool's
    max_len (8 here) is admitted and served, the static reference's
    tokens; a paged (hybrid) engine refuses it at submission."""
    prompt = _models("rwkv6-1.6b")[4][4]                  # 24 tokens
    eng = _engine("rwkv6-1.6b", num_slots=2, page_size=4, pages_per_slot=2,
                  quantized=True)
    assert eng.pcfg.max_len < len(prompt) + GEN_MAX
    out = _serve(eng, [prompt], [GEN_MAX])
    assert len(out[0]) == GEN_MAX and out[0][0] == _want("rwkv6-1.6b",
                                                         prompt, 1)[0]
    fp = _engine("rwkv6-1.6b", num_slots=2, page_size=4, pages_per_slot=2,
                 quantized=False)
    assert _serve(fp, [prompt], [GEN_MAX]) == [_want("rwkv6-1.6b", prompt,
                                                     GEN_MAX)]
    hybrid = _engine("jamba-1.5-large", num_slots=2, page_size=4,
                     pages_per_slot=2, quantized=False)
    with pytest.raises(ValueError, match="exceeds slot capacity"):
        hybrid.submit(prompt, max_new_tokens=GEN_MAX)


@pytest.mark.parametrize("arch", ARCHS)
def test_stateful_archs_bypass_the_prefix_cache(arch):
    """``prefix_cache=True`` on a stateful arch: no tree, every request
    prefilled in full, the prefix counters at 0, the tokens those of the
    cache-off engine (two requests share a 16-token preamble)."""
    prompts = _models(arch)[4]
    shared = [prompts[4][:16] + prompts[0][:4], prompts[4][:16]
              + prompts[1][:5]]
    outs = []
    for prefix in (False, True):
        eng = _engine(arch, num_slots=2, page_size=4, pages_per_slot=8,
                      quantized=True, prefix_cache=prefix)
        assert eng._prefix is None and eng.sched.prefix is None
        outs.append(_serve(eng, shared, [5, 5]))
        s = eng.summary()
        assert (s["prefix_hit_tokens"], s["cow_forks"], s["pages_saved"],
                s["prefix_evictions"]) == (0, 0, 0, 0)
        assert s["prefill_tokens"] == sum(len(p) for p in shared)
    assert outs[0] == outs[1]


def test_speculative_decoding_refuses_a_stateful_target():
    """A state advanced through a rejected draft token cannot roll back:
    a recurrent target raises (before the draft's checks), as does a
    recurrent draft for an attention-only target."""
    _, _, tlm, tp, _ = _models("rwkv6-1.6b")
    pool = PoolConfig(num_slots=2, page_size=8, pages_per_slot=4)
    with pytest.raises(NotImplementedError, match="TARGET"):
        Engine(tlm, tp, EngineConfig(pool=pool, spec_k=2), device="cpu",
               draft=(tlm, tp))
    dense = t_build(TC.get_reduced("internlm2-1.8b").replace(
        dtype="float32", vocab_size=tlm.cfg.vocab_size))
    dp = t_init(torch.Generator().manual_seed(0), dense, device="cpu")
    with pytest.raises(NotImplementedError, match="DRAFT"):
        Engine(dense, dp, EngineConfig(pool=pool, spec_k=2), device="cpu",
               draft=(tlm, tp))
