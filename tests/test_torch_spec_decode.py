"""repro_torch's speculative decoding against repro's (the JAX reference),
on the CPU.

The models are ``tests/test_spec_decode.py``'s: reduced ``yi-34b`` as the
target, reduced ``stablelm-3b`` (its vocabulary set to the target's) as
the draft, float32, the JAX weights carried across by
``params_from_jax``; the pools are that file's too. Prompts pad to a
bucket of 16 in both packages, so JAX compiles one prefill shape.

(a) greedy spec tokens AND ``summary()["spec"]`` counts equal to the JAX
    spec engine's over {fp32, int8} x {gather, fused} (JAX's fused path
    through its jnp page scan), and equal to the port's non-spec engine;
(b) spec_k in {1, 2, 4} equal to non-spec; preemption and resume keep the
    identity; a rollback returns every page;
(c) a self-draft accepts everything (greedy and sampled), the canary for
    the draft cache;
(d) eos and max_new_tokens cut a block mid-way; sampled requests
    complete with in-vocabulary tokens;
(e) the validation errors;
(f) ``sample_from_probs`` and ``spec_accept`` on one-hot inputs equal to
    JAX's; ``append_tokens`` (and ``append_kv`` at S > 1) on both pool
    kinds equal to JAX's ``append_tokens`` bit for bit on the whole pool,
    rows past the horizon and an inactive slot included;
(g) speculative decoding over the prefix cache and chunked prefill:
    shared-prefix prompts, one forking a page mid-way, equal to the
    non-spec engine under the same config; a self-draft still accepts
    everything (the draft recomputes the whole prompt after a hit); every
    page ends free or in the tree, none pinned.

Each JAX engine run happens once per module (four of them). Only greedy
decoding compares across packages: sampled draws come from a
``torch.Generator``, not ``jax.random``.
"""
import dataclasses

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
from repro.serve import kv_cache as JKC  # noqa: E402
from repro.serve import sampling as JS  # noqa: E402
from repro.sharding import ShardPlan  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import build_lm as t_build  # noqa: E402
from repro_torch.serve import Engine, EngineConfig, PoolConfig  # noqa: E402
from repro_torch.serve import SamplingParams  # noqa: E402
from repro_torch.serve import kv_cache as TKC  # noqa: E402
from repro_torch.serve import sampling as TS  # noqa: E402

BUCKET = 16
POOL = dict(num_slots=2, page_size=8, pages_per_slot=8)
GENS = [12, 9, 11, 10]


def _pair(arch, seed, vocab=None):
    kw = dict(dtype="float32", remat="none")
    if vocab is not None:
        kw["vocab_size"] = vocab
    jlm = j_build(JC.get_reduced(arch).replace(**kw))
    jp = j_init(jax.random.PRNGKey(seed), jlm)
    tlm = t_build(TC.get_reduced(arch).replace(**kw))
    return jlm, jp, tlm, params_from_jax(jax.tree.map(np.asarray, jp),
                                         device="cpu")


@pytest.fixture(scope="module")
def models():
    """(target, zoo draft): each a (jax lm, jax params, port lm, port
    params) quadruple on the reference's weights."""
    target = _pair("yi-34b", 0)
    draft = _pair("stablelm-3b", 1, vocab=target[0].cfg.vocab_size)
    return target, draft


def _prompts(vocab, n, lo, hi, seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, int(rng.randint(lo, hi + 1))).tolist()
            for _ in range(n)]


def _run(lm, params, pool, prompts, gens, draft=None, spec_k=0,
         sampling=None, eos_id=-1, **ekw):
    """The port's engine on the CPU: (completions in order, engine)."""
    eng = Engine(lm, params, EngineConfig(pool=PoolConfig(**pool),
                                          spec_k=spec_k,
                                          prefill_bucket=BUCKET, **ekw),
                 device="cpu", draft=draft)
    rids = [eng.submit(p, max_new_tokens=g,
                       sampling=sampling or SamplingParams(), eos_id=eos_id)
            for p, g in zip(prompts, gens)]
    res = eng.run()
    return [res[r].tokens for r in rids], eng


_JAX_RUNS: dict = {}


def _jax_spec(models, quantized, fused):
    """The JAX spec engine's greedy tokens and spec counts, once a module
    per (pool numerics, attention path)."""
    key = (quantized, fused)
    if key not in _JAX_RUNS:
        (jlm, jp, _, _), (jdlm, jdp, _, _) = models
        prompts = _prompts(jlm.cfg.vocab_size, 4, 5, 14)
        eng = JEngine(jlm, jp, JEC(pool=JPC(**POOL, quantized=quantized),
                                   spec_k=3, prefill_bucket=BUCKET,
                                   fused_attention=fused, fused_impl="jnp"),
                      ShardPlan(mesh=None), draft=(jdlm, jdp))
        rids = [eng.submit(p, max_new_tokens=g)
                for p, g in zip(prompts, GENS)]
        res = eng.run()
        _JAX_RUNS[key] = (prompts, [res[r].tokens for r in rids],
                          eng.summary()["spec"])
    return _JAX_RUNS[key]


# ---------------------------------------------------------------------------
# (a) the port against the JAX spec engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_greedy_spec_tokens_and_counts_equal_jax(models, quantized, fused):
    (_, _, tlm, tp), (_, _, tdlm, tdp) = models
    prompts, want, jspec = _jax_spec(models, quantized, fused)
    pool = dict(POOL, quantized=quantized)
    out, eng = _run(tlm, tp, pool, prompts, GENS, draft=(tdlm, tdp),
                    spec_k=3, fused_attention=fused)
    assert out == want
    spec = eng.summary()["spec"]
    assert spec == jspec
    assert spec["steps"] > 0 and spec["proposed"] > 0
    # the first token of a request comes from prefill, not a spec step
    assert spec["emitted"] == sum(len(t) for t in out) - len(out)
    ref, _ = _run(tlm, tp, pool, prompts, GENS, fused_attention=fused)
    assert out == ref


# ---------------------------------------------------------------------------
# (b) k, preemption, rollback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 4])
def test_spec_k_variants_equal_nonspec(models, k):
    (_, _, tlm, tp), (_, _, tdlm, tdp) = models
    pool = dict(POOL, quantized=False)
    prompts = _prompts(tlm.cfg.vocab_size, 2, 6, 12, seed=5)
    ref, _ = _run(tlm, tp, pool, prompts, [10, 8])
    out, _ = _run(tlm, tp, pool, prompts, [10, 8], draft=(tdlm, tdp),
                  spec_k=k)
    assert out == ref


def test_spec_preemption_and_resume_identity(models):
    (_, _, tlm, tp), _ = models
    pool = dict(POOL, num_pages=5, quantized=False)
    prompts = _prompts(tlm.cfg.vocab_size, 4, 5, 12, seed=7)
    ref, ref_eng = _run(tlm, tp, pool, prompts, [12] * 4)
    out, eng = _run(tlm, tp, pool, prompts, [12] * 4, draft=(tlm, tp),
                    spec_k=3)
    assert eng.summary()["preemptions"] >= 1
    assert ref_eng.summary()["preemptions"] >= 1
    assert out == ref


def test_spec_rollback_returns_every_page(models):
    """Pages mapped for a rejected span go back: after every request
    retires, the free list holds the whole pool."""
    (jlm, _, tlm, tp), _ = models
    _, _, tdlm, tdp = _pair("stablelm-3b", 2, vocab=jlm.cfg.vocab_size)
    pool = dict(num_slots=2, page_size=4, pages_per_slot=10, quantized=False)
    prompts = _prompts(tlm.cfg.vocab_size, 3, 5, 10, seed=9)
    out, eng = _run(tlm, tp, pool, prompts, [9, 8, 7], draft=(tdlm, tdp),
                    spec_k=4)
    assert [len(t) for t in out] == [9, 8, 7]
    assert eng.sched.alloc.free_pages == eng.pcfg.total_pages
    assert (eng.sched.page_table == eng.pcfg.trash_page).all()


# ---------------------------------------------------------------------------
# (c) self-draft canary
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sampling", [
    SamplingParams(), SamplingParams(temperature=0.9, top_k=20, top_p=0.95)])
def test_self_draft_accepts_everything(models, sampling):
    """draft == target on the gather path: P == Q, so every proposal
    passes. Below 1.0 means the draft's cache lost a position."""
    (_, _, tlm, tp), _ = models
    pool = dict(POOL, quantized=False)
    prompts = _prompts(tlm.cfg.vocab_size, 4, 5, 14)
    out, eng = _run(tlm, tp, pool, prompts, GENS, draft=(tlm, tp), spec_k=3,
                    sampling=sampling)
    spec = eng.summary()["spec"]
    assert spec["acceptance_rate"] == 1.0, spec
    assert spec["tokens_per_step"] > 1.0
    assert [len(t) for t in out] == GENS
    if sampling.temperature <= 0:
        assert out == _run(tlm, tp, pool, prompts, GENS)[0]


# ---------------------------------------------------------------------------
# (d) truncation, sampling
# ---------------------------------------------------------------------------

def test_eos_truncates_mid_block(models):
    (_, _, tlm, tp), _ = models
    pool = dict(POOL, quantized=False)
    prompts = _prompts(tlm.cfg.vocab_size, 2, 6, 12, seed=13)
    ref, _ = _run(tlm, tp, pool, prompts, [12, 12])
    eos = ref[0][4]                     # request 0's 5th generated token
    ref_e, _ = _run(tlm, tp, pool, prompts, [12, 12], eos_id=eos)
    out_e, _ = _run(tlm, tp, pool, prompts, [12, 12], draft=(tlm, tp),
                    spec_k=3, eos_id=eos)
    assert out_e == ref_e
    assert out_e[0][-1] == eos and len(out_e[0]) <= 5


def test_max_new_tokens_cut_the_last_block(models):
    (_, _, tlm, tp), _ = models
    prompts = _prompts(tlm.cfg.vocab_size, 2, 6, 10, seed=15)
    # max_new_tokens not a multiple of k+1: the last block is cut
    out, eng = _run(tlm, tp, dict(POOL, quantized=False), prompts, [7, 5],
                    draft=(tlm, tp), spec_k=3)
    assert [len(t) for t in out] == [7, 5]
    assert eng.summary()["spec"]["emitted"] == 7 + 5 - 2


def test_sampled_spec_requests_complete(models):
    (_, _, tlm, tp), (_, _, tdlm, tdp) = models
    prompts = _prompts(tlm.cfg.vocab_size, 3, 5, 12, seed=11)
    out, eng = _run(tlm, tp, dict(POOL, quantized=True), prompts, [8, 8, 8],
                    draft=(tdlm, tdp), spec_k=2,
                    sampling=SamplingParams(temperature=1.0, top_k=40,
                                            top_p=0.9))
    assert [len(t) for t in out] == [8, 8, 8]
    assert all(0 <= x < tlm.cfg.vocab_size for t in out for x in t)
    spec = eng.summary()["spec"]
    assert spec["proposed"] >= spec["accepted"] >= 0
    assert 0.0 <= spec["acceptance_rate"] <= 1.0


# ---------------------------------------------------------------------------
# (e) validation
# ---------------------------------------------------------------------------

def test_spec_validation_errors(models):
    (jlm, _, tlm, tp), (_, _, tdlm, tdp) = models
    pool = PoolConfig(**POOL)

    def build(**kw):
        draft = kw.pop("draft", None)
        return Engine(tlm, tp, EngineConfig(pool=pool, **kw), device="cpu",
                      draft=draft)

    with pytest.raises(ValueError, match="spec_k"):
        build(spec_k=-1)
    with pytest.raises(ValueError, match="draft"):
        build(spec_k=2)
    _, _, wide, wide_p = _pair("stablelm-3b", 1,
                               vocab=jlm.cfg.vocab_size + 1)
    with pytest.raises(ValueError, match="vocab"):
        build(spec_k=2, draft=(wide, wide_p))
    # a recurrent draft is refused (an MLA draft is served:
    # tests/test_torch_serve_mla.py)
    mamba = dataclasses.replace(tdlm, period=tuple(
        dataclasses.replace(s, mixer_kind="mamba") for s in tdlm.period))
    with pytest.raises(NotImplementedError, match="DRAFT"):
        build(spec_k=2, draft=(mamba, tdp))
    # draft params on another device than the engine: refused, not copied
    meta = {"embed": {"w": torch.empty((1,), device="meta")}}
    with pytest.raises(ValueError, match="draft params live on meta"):
        build(spec_k=2, draft=(tdlm, meta))
    # spec_k = 0 ignores a draft, as the reference does
    assert not build(draft=(tdlm, tdp))._spec


# ---------------------------------------------------------------------------
# (f) the pieces against JAX's
# ---------------------------------------------------------------------------

def test_sample_from_probs_and_spec_accept_on_one_hots():
    """Greedy rows: one-hot P and Q make every accept decision and every
    next token deterministic, so the port's draws equal JAX's whatever the
    generators. Slots: all accepted (bonus), a rejection at 0, 1 and 2."""
    v, k = 11, 3
    rng = np.random.RandomState(0)
    dtok = rng.randint(0, v, (4, k)).astype(np.int32)
    targ = dtok.copy()
    targ[1, 0] = (dtok[1, 0] + 1) % v
    targ[2, 1] = (dtok[2, 1] + 2) % v
    targ[3, 2] = (dtok[3, 2] + 3) % v
    bonus = rng.randint(0, v, (4, 1)).astype(np.int32)
    tgt = np.concatenate([targ, bonus], axis=1)            # argmax per row
    logits = (rng.randn(4, k + 1, v) * 0.1).astype(np.float32)
    np.put_along_axis(logits, tgt[..., None], 5.0, axis=2)
    qprobs = np.eye(v, dtype=np.float32)[dtok]             # (4, k, V)
    temp = np.zeros(4, np.float32)
    topk = np.zeros(4, np.int32)
    topp = np.ones(4, np.float32)
    ja, jn = JS.spec_accept(jnp.asarray(logits), jnp.asarray(qprobs),
                            jnp.asarray(dtok), jax.random.PRNGKey(0),
                            jnp.asarray(temp), jnp.asarray(topk),
                            jnp.asarray(topp))
    gen = torch.Generator().manual_seed(0)
    ta, tn = TS.spec_accept(torch.from_numpy(logits),
                            torch.from_numpy(qprobs), torch.from_numpy(dtok),
                            gen, torch.from_numpy(temp),
                            torch.from_numpy(topk), torch.from_numpy(topp))
    assert ta.dtype == tn.dtype == torch.int32
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(ta.numpy(), [3, 0, 1, 2])
    np.testing.assert_array_equal(tn.numpy(), tgt[np.arange(4), [3, 0, 1, 2]])
    onehots = np.eye(v, dtype=np.float32)[tgt[:, 0]]
    js = JS.sample_from_probs(jnp.asarray(onehots), jax.random.PRNGKey(1))
    for seed in range(3):
        ts = TS.sample_from_probs(torch.from_numpy(onehots),
                                  torch.Generator().manual_seed(seed))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_sample_from_probs_draws_only_the_support():
    rng = np.random.RandomState(1)
    probs = rng.rand(6, 40).astype(np.float32)
    probs[probs < 0.7] = 0.0
    gen = torch.Generator().manual_seed(0)
    seen = set()
    for _ in range(20):
        t = TS.sample_from_probs(torch.from_numpy(probs), gen).numpy()
        assert (probs[np.arange(6), t] > 0).all()
        seen.update(zip(range(6), t.tolist()))
    assert len(seen) > 6                # not a fixed argmax


def _tokens_case(quantized):
    """A pool, scales and an S = 4 block over 4 slots: slot 0 writes
    mid-page, slot 1 crosses a page boundary, slot 2 is inactive, slot 3
    overhangs the horizon (rows at max_len and past it)."""
    rng = np.random.RandomState(4)
    page, pps, b, s, h, dh = 4, 3, 4, 4, 2, 8
    total = b * pps
    table = rng.permutation(total).reshape(b, pps).astype(np.int32)
    lens = np.array([1, 3, 5, page * pps - 2], np.int32)
    active = np.array([True, True, False, True])
    k = (rng.randn(b, s, h, dh) * 3).astype(np.float32)
    v = (rng.randn(b, s, h, dh) * 3).astype(np.float32)
    if quantized:
        kd = rng.randint(-128, 128, (total + 1, page, h, dh)).astype(np.int8)
        vd = rng.randint(-128, 128, (total + 1, page, h, dh)).astype(np.int8)
    else:
        kd = rng.randn(total + 1, page, h, dh).astype(np.float32)
        vd = rng.randn(total + 1, page, h, dh).astype(np.float32)
    ks = rng.randint(-6, -2, b).astype(np.float32)
    vs = rng.randint(-6, -2, b).astype(np.float32)
    kw = dict(num_slots=b, page_size=page, pages_per_slot=pps,
              quantized=quantized)
    return (kd, vd, ks, vs, k, v, table, lens, active), kw


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("how", ["append_tokens", "append_kv"])
def test_append_tokens_equals_jax(quantized, how):
    (kd, vd, ks, vs, k, v, table, lens, active), kw = _tokens_case(quantized)
    jpc, tpc = JPC(**kw), PoolConfig(**kw)
    want = [np.asarray(JKC.append_tokens(
        jnp.asarray(d), jnp.asarray(sc), jnp.asarray(x), jnp.asarray(table),
        jnp.asarray(lens), jnp.asarray(active), jpc))
        for d, sc, x in ((kd, ks, k), (vd, vs, v))]
    t = [torch.from_numpy(a.copy()) for a in (kd, vd, ks, vs, k, v, table,
                                              lens, active)]
    if how == "append_tokens":
        got = [TKC.append_tokens(t[0], t[2], t[4], t[6], t[7], t[8], tpc),
               TKC.append_tokens(t[1], t[3], t[5], t[6], t[7], t[8], tpc)]
    else:
        got = TKC.append_kv(*t, tpc)
    for g, w, before in zip(got, want, (kd, vd)):
        np.testing.assert_array_equal(g.numpy(), w)
        # every real write landed: an active row below max_len changed its
        # cell, and nothing touched the inactive slot's pages
        assert not np.array_equal(g.numpy()[:-1], before[:-1])
        np.testing.assert_array_equal(g.numpy()[table[2]], before[table[2]])


# ---------------------------------------------------------------------------
# (g) over the prefix cache and chunked prefill
# ---------------------------------------------------------------------------

def _shared_prefix_prompts(vocab, seed=17):
    """A 20-token base: a full reuse, a divergence at 20 (mid-page on an
    8-token page: a COW fork), one at 18 (inside the base), and the first
    prompt's suffix spliced with the second's."""
    rng = np.random.RandomState(seed)
    base = rng.randint(0, vocab, 20).tolist()
    sfx = [rng.randint(0, vocab, 6).tolist() for _ in range(3)]
    return [base + sfx[0], base + sfx[1], base[:18] + sfx[2],
            base + sfx[0][:3] + sfx[1][:3]]


@pytest.mark.parametrize("case", ["draft_fp", "draft_int8", "self_fp"])
def test_spec_over_prefix_cache_and_chunked_prefill(models, case):
    """prefix_cache=True and prefill_chunk=8: the target's hits adopt
    shared pages (one a COW fork) and compute their suffix through the
    chunk step, a miss prefills in chunks, and the draft prefills every
    whole prompt. The verify's spans and rollback run over shared and
    forked pages."""
    (_, _, tlm, tp), (_, _, tdlm, tdp) = models
    draft = (tlm, tp) if case == "self_fp" else (tdlm, tdp)
    pool = dict(num_slots=2, page_size=8, pages_per_slot=5,
                quantized=case.endswith("int8"))
    prompts = _shared_prefix_prompts(tlm.cfg.vocab_size)
    gens = [8, 7, 8, 6]
    ekw = dict(prefix_cache=True, prefill_chunk=8)
    ref, _ = _run(tlm, tp, pool, prompts, gens, **ekw)
    out, eng = _run(tlm, tp, pool, prompts, gens, draft=draft, spec_k=3,
                    **ekw)
    assert out == ref
    summ = eng.summary()
    assert summ["prefix_hit_tokens"] > 0 and summ["cow_forks"] > 0
    assert summ["spec"]["steps"] > 0
    if case == "self_fp":
        assert summ["spec"]["acceptance_rate"] == 1.0, summ["spec"]
    sched, total = eng.sched, eng.pcfg.total_pages
    assert all(st is None for st in sched.slots)
    assert (sched.page_table == eng.pcfg.trash_page).all()
    assert sched.alloc.free_pages + len(eng._prefix.owned_pages) == total
    # no reader still pins a tree page: evicting the tree frees the pool
    sched.alloc.free(eng._prefix.evict(total))
    assert sched.alloc.free_pages == total
