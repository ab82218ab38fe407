"""repro_torch's radix COW prefix cache against repro's (the JAX reference).

(a) the tree alone: ``RadixPrefixCache`` driven by one seeded random
    sequence of match, acquire, insert, release and evict gives the same
    result as JAX's class at every step; the mechanics of
    ``tests/test_prefix_cache.py`` (match/insert/split, the len-1 cap,
    refcount pinning, LRU order) hold for the port's class;
(b) the pool primitives ``fork_page``, ``snapshot_scales`` and
    ``adopt_scales`` leave the same bits as JAX's on the same numpy pool;
(c) the engine: prefix-cache on is token-identical to off — fp and int8,
    mid-page COW forks, chunked prefill, eviction under page pressure (fp
    pool, see ``CASES``) and preempt/resume (the ports of
    ``test_prefix_cache.py:165-240``) — and its tokens and counters
    (``prefix_hit_tokens``, ``cow_forks``, ``pages_saved``,
    ``prefill_tokens``, ``prefix_evictions``) equal the JAX engine's on the
    same traffic, the int8 eviction traffic included (counters only);
(d) an int8 hit is exactly a cache-off run with a chunk boundary at the
    resume position (the port of ``test_prefix_cache.py:242``).
"""
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
from repro.serve import RadixPrefixCache as JRadix  # noqa: E402
from repro.serve import kv_cache as JKC  # noqa: E402
from repro.sharding import ShardPlan  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import build_lm as t_build  # noqa: E402
from repro_torch.serve import (Engine, EngineConfig, PoolConfig,  # noqa: E402
                               RadixPrefixCache)
from repro_torch.serve import kv_cache as TKC  # noqa: E402

ARCH = "internlm2-1.8b"
COUNTERS = ("prefix_hit_tokens", "cow_forks", "pages_saved",
            "prefill_tokens", "prompt_tokens", "prefix_evictions",
            "preemptions")


@pytest.fixture(scope="module")
def models():
    jcfg = JC.get_reduced(ARCH).replace(dtype="float32", remat="none")
    tcfg = TC.get_reduced(ARCH).replace(dtype="float32", remat="none")
    jlm = j_build(jcfg)
    jp = j_init(jax.random.PRNGKey(0), jlm)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jlm, jp, t_build(tcfg), tp


# ---------------------------------------------------------------------------
# (a) the tree
# ---------------------------------------------------------------------------

def _state(pc):
    """Everything observable about a tree: nodes (key, pages, scales tag,
    LRU stamp) in walk order, owners, refcounts, eviction counters."""
    rows = []

    def walk(n, depth):
        for k in sorted(n.children):
            c = n.children[k]
            rows.append((depth, c.key, tuple(c.pages), c.scales, c.last_used))
            walk(c, depth + 1)
    walk(pc.root, 0)
    refs = [pc.refs.count(p) for p in range(len(pc.refs._refs))]
    return rows, sorted(pc.owned_pages), refs, pc.evictions, pc.pages_evicted


def _match_tuple(m):
    return None if m is None else (m.shared_pages, m.fork_src, m.fork_tokens,
                                   m.resume, m.scales)


def test_radix_random_ops_match_jax():
    """400 seeded random operations on a 4-token-page tree over 40 pages,
    prompts drawn from 3 bases over a 5-token alphabet (so prefixes are
    shared and diverge mid-page): match, acquire, insert of a match's
    prompt onto fresh pages, release and evict, on both classes."""
    rng = np.random.RandomState(0)
    ps, npages = 4, 40
    jpc, tpc = JRadix(ps, npages), RadixPrefixCache(ps, npages)
    bases = [rng.randint(0, 5, 24).tolist() for _ in range(3)]
    free = list(range(npages))
    held: list[list[int]] = []
    for step in range(400):
        op = rng.randint(5)
        b = bases[rng.randint(3)]
        cut = int(rng.randint(1, len(b) + 1))
        prompt = b[:cut] + rng.randint(0, 5, int(rng.randint(0, 6))).tolist()
        if op in (0, 1):                            # match (+ acquire)
            mj, mt = jpc.match(prompt), tpc.match(prompt)
            assert _match_tuple(mt) == _match_tuple(mj), step
            if op == 1 and mj is not None:
                jpc.acquire(mj)
                tpc.acquire(mt)
                held.append(mj.shared_pages + ([mj.fork_src]
                                               if mj.fork_src is not None
                                               else []))
        elif op == 2:                               # insert on fresh pages
            n_full = len(prompt) // ps
            mj, m = jpc.match(prompt + [9]), tpc.match(prompt + [9])
            assert _match_tuple(m) == _match_tuple(mj), step
            shared = m.shared_pages if m is not None else []
            need = n_full - len(shared)
            if n_full == 0 or need < 0 or need > len(free):
                continue
            row = shared + [free.pop() for _ in range(need)]
            tag = f"s{step}"
            dj = jpc.insert(prompt, row, tag)
            dt = tpc.insert(prompt, row, tag)
            assert dt == dj, step
            free.extend(p for p in row[len(shared):] if p not in dj)
        elif op == 3 and held:                      # release
            pages = held.pop(int(rng.randint(len(held))))
            jpc.release(pages)
            tpc.release(pages)
        elif op == 4:                               # evict
            n = int(rng.randint(1, 6))
            fj, ft = jpc.evict(n), tpc.evict(n)
            assert ft == fj, step
            free.extend(fj)
        assert _state(tpc) == _state(jpc), step
    assert jpc.evictions > 0 and tpc.num_nodes() == jpc.num_nodes() > 1


def test_radix_match_insert_split():
    pc = RadixPrefixCache(page_size=4, num_pages=16)
    a = list(range(100, 112))               # 12 tokens = 3 pages
    assert pc.match(a) is None              # empty tree
    assert pc.insert(a, [0, 1, 2], scales=None) == [0, 1, 2]
    m = pc.match(a + [1, 2])
    assert (m.shared_pages, m.fork_src, m.resume) == ([0, 1, 2], None, 12)
    # the exact cached prompt: capped at len-1, so the last page forks
    m2 = pc.match(a)
    assert m2.shared_pages == [0, 1] and m2.resume == 11
    assert (m2.fork_src, m2.fork_tokens) == (2, 3)
    b = a[:6] + [999, 998] + a[8:]          # mid-page divergence at 6
    mb = pc.match(b)
    assert mb.shared_pages == [0] and (mb.fork_src, mb.fork_tokens) == (1, 2)
    assert pc.insert(b, [0, 3, 4], scales=None) == [3, 4]
    assert pc.num_nodes() == 3 and pc.owned_pages == {0, 1, 2, 3, 4}
    assert pc.match(a + [7]).shared_pages == [0, 1, 2]
    assert pc.match(b + [7]).shared_pages == [0, 3, 4]


def test_radix_refcounts_pin_and_lru_order():
    pc = RadixPrefixCache(page_size=4, num_pages=16)
    a = list(range(50, 62))
    pc.insert(a, [5, 6, 7], scales=None)
    m = pc.match(a)                         # shared [5, 6], fork 7
    pc.acquire(m)
    assert pc.evict(99) == []               # every page pinned
    pc.release(m.shared_pages + [m.fork_src])
    assert sorted(pc.evict(99)) == [5, 6, 7]
    assert pc.owned_pages == set() and pc.pages_evicted == 3
    lru = RadixPrefixCache(page_size=2, num_pages=16)
    lru.insert([1, 2, 3, 4], [0, 1], scales=None)
    lru.insert([1, 2, 9, 9], [0, 2], scales=None)
    lru.match([1, 2, 3, 4, 5])              # warm the [3, 4] branch
    assert lru.evict(1) == [2]              # the colder [9, 9] leaf first
    with pytest.raises(ValueError):
        RadixPrefixCache(page_size=1, num_pages=4)


# ---------------------------------------------------------------------------
# (b) pool primitives
# ---------------------------------------------------------------------------

def test_fork_adopt_snapshot_bit_identical_to_jax(models):
    jlm, _, tlm, _ = models
    kw = dict(num_slots=3, page_size=4, pages_per_slot=2, quantized=True)
    jpool = JKC.init_pool(jlm, JPC(**kw))
    rng = np.random.RandomState(3)
    fill = jax.tree.map(
        lambda a: (rng.randint(-128, 128, a.shape) if a.dtype == jnp.int8
                   else rng.randint(-6, 3, a.shape)).astype(a.dtype), jpool)
    tpool = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), fill)
    tpool = {"data": tpool["data"], "scale_log2": tpool["scale_log2"]}
    assert TKC.init_pool(tlm, PoolConfig(**kw), torch.device("cpu"))[
        "data"].keys() == tpool["data"].keys()
    jf = JKC.fork_page(jax.tree.map(jnp.asarray, fill), jnp.int32(1),
                       jnp.int32(4))
    assert TKC.fork_page(tpool, 1, 4) is tpool          # in place
    snap_j = JKC.snapshot_scales(jf, 0)
    snap_t = TKC.snapshot_scales(tpool, 0)
    ja = JKC.adopt_scales(jf, jnp.int32(2), jax.tree.map(jnp.asarray,
                                                         snap_j))
    TKC.adopt_scales(tpool, 2, snap_t)
    tnp = jax.tree.map(lambda t: t.numpy(), tpool,
                       is_leaf=lambda t: isinstance(t, torch.Tensor))
    for (pj, a), (pt, b) in zip(jax.tree_util.tree_flatten_with_path(ja)[0],
                                jax.tree_util.tree_flatten_with_path(tnp)[0]):
        assert pj == pt
        np.testing.assert_array_equal(b, np.asarray(a))
    for key, kinds in snap_t.items():
        for name, v in kinds.items():
            np.testing.assert_array_equal(v.numpy(), snap_j[key][name])
    assert TKC.page_nbytes(tpool, PoolConfig(**kw)) == JKC.page_nbytes(
        ja, JPC(**kw))


# ---------------------------------------------------------------------------
# (c) the engine: on == off, counters == JAX's
# ---------------------------------------------------------------------------

def _shared_prefix_prompts(vocab, seed=7):
    """A 20-token base: a full-path reuse, a divergence at 20 (a mid-page
    COW on an 8-token page) and one at 18 (inside the base)."""
    rng = np.random.RandomState(seed)
    base = rng.randint(0, vocab, 20).tolist()
    sfx = [rng.randint(0, vocab, 6).tolist() for _ in range(3)]
    return [base + sfx[0], base + sfx[1], base[:18] + sfx[2],
            base + sfx[0][:3] + sfx[1][:3]]


def _case(name, vocab):
    """(pool kwargs, engine kwargs, prompts, gens) of each traffic case."""
    if name in ("shared_fp", "shared_int8", "chunked"):
        pool = dict(num_slots=2, page_size=8, pages_per_slot=4,
                    quantized=name == "shared_int8")
        ekw = dict(prefill_chunk=8) if name == "chunked" else {}
        return pool, ekw, _shared_prefix_prompts(vocab), [6, 6, 6, 6]
    if name.startswith("eviction"):
        rng = np.random.RandomState(11)
        bases = [rng.randint(0, vocab, 8).tolist() for _ in range(4)]
        prompts = [bases[i % 4] + rng.randint(0, vocab, 4).tolist()
                   for i in range(10)]
        return (dict(num_slots=2, page_size=4, pages_per_slot=6,
                     quantized=name == "eviction_int8", num_pages=14), {},
                prompts, [4] * 10)
    rng = np.random.RandomState(13)                     # preempt
    base = rng.randint(0, vocab, 8).tolist()
    prompts = [base + rng.randint(0, vocab, 2).tolist() for _ in range(2)]
    return (dict(num_slots=2, page_size=4, pages_per_slot=4,
                 quantized=False, num_pages=5), {}, prompts, [5, 5])


# "eviction" is the reference's eviction traffic on the fp pool: on the
# int8 pool a hit decodes its shared pages under the donor's scales while a
# cache-off run chooses the prompt's own, so on == off is no identity there
# (the reference's own int8 test of it is host-dependent, ROADMAP queue 3);
# "eviction_int8" is held to the reference's counters instead
CASES = ["shared_fp", "shared_int8", "chunked", "eviction", "preempt"]


def _port(models, name, prefix):
    _, _, tlm, tp = models
    pool, ekw, prompts, gens = _case(name, tlm.cfg.vocab_size)
    eng = Engine(tlm, tp, EngineConfig(pool=PoolConfig(**pool),
                                       prefix_cache=prefix, **ekw),
                 device="cpu")
    rids = [eng.submit(p, max_new_tokens=g) for p, g in zip(prompts, gens)]
    res = eng.run()
    return [res[r].tokens for r in rids], eng.summary()


@pytest.mark.parametrize("name", CASES)
def test_prefix_on_matches_off(models, name):
    on, s_on = _port(models, name, True)
    off, s_off = _port(models, name, False)
    assert on == off
    assert s_off["prefix_hit_tokens"] == 0 and s_on["prefix_hit_tokens"] > 0
    assert s_on["prefill_tokens"] == (s_on["prompt_tokens"]
                                      - s_on["prefix_hit_tokens"])
    if name.startswith("shared"):
        assert s_on["cow_forks"] > 0 and s_on["pages_saved"] > 0
        assert 0.0 < s_on["prefix_hit_rate"] < 1.0
    if name == "eviction":
        assert s_on["prefix_evictions"] > 0
    if name == "preempt":
        assert s_on["preemptions"] > 0


@pytest.mark.parametrize("name", CASES + ["eviction_int8"])
def test_prefix_counters_match_jax(models, name):
    """The same traffic through JAX's engine: the port's prefix counters
    equal the reference's (they depend on the scheduler and the tree, not
    on the numerics). Tokens are compared too, except on the int8 eviction
    traffic, whose reference tokens depend on the host (ROADMAP queue 3)."""
    jlm, jp, _, _ = models
    pool, ekw, prompts, gens = _case(name, jlm.cfg.vocab_size)
    eng = JEngine(jlm, jp, JEC(pool=JPC(**pool), prefix_cache=True, **ekw),
                  ShardPlan(mesh=None))
    rids = [eng.submit(p, max_new_tokens=g) for p, g in zip(prompts, gens)]
    res = eng.run()
    ref, js = [res[r].tokens for r in rids], eng.summary()
    got, ts = _port(models, name, True)
    assert {k: ts[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}
    if name != "eviction_int8":
        assert got == ref


# ---------------------------------------------------------------------------
# (d) the bitwise-recompute contract
# ---------------------------------------------------------------------------

def test_quantized_hit_equals_chunk_boundary_recompute(models):
    _, _, tlm, tp = models
    rng = np.random.RandomState(17)
    v = tlm.cfg.vocab_size
    donor = rng.randint(0, v, 16).tolist()          # exactly 2 full pages
    follower = donor + rng.randint(0, v, 7).tolist()
    pcfg = PoolConfig(num_slots=2, page_size=8, pages_per_slot=4,
                      quantized=True)
    # cache-off: a chunk boundary at 16, so the follower's first 16
    # positions quantize on scales chosen from exactly those tokens
    off = Engine(tlm, tp, EngineConfig(pool=pcfg, prefill_chunk=16),
                 device="cpu")
    r_off = off.submit(follower, max_new_tokens=5)
    ref = off.run()[r_off].tokens
    on = Engine(tlm, tp, EngineConfig(pool=pcfg, prefill_chunk=16,
                                      prefix_cache=True), device="cpu")
    on.submit(donor, max_new_tokens=1)
    on.run()
    r_on = on.submit(follower, max_new_tokens=5)
    assert on.run()[r_on].tokens == ref
    s = on.summary()
    assert s["prefix_hit_tokens"] == 16 and s["cow_forks"] == 0


def test_mapped_page_stats_count_the_shared_pages(models):
    """Two live slots sharing a prefix: logical minus physical mapped pages
    is the shared span, which ``pages_saved`` counted at admission."""
    _, _, tlm, tp = models
    pool, _, prompts, _ = _case("shared_fp", tlm.cfg.vocab_size)
    eng = Engine(tlm, tp, EngineConfig(pool=PoolConfig(**pool),
                                       prefix_cache=True), device="cpu")
    for p in prompts[:2]:
        eng.submit(p, max_new_tokens=6)
    eng.step()                          # admits and prefills both, 1 decode
    logical, physical = eng.sched.mapped_page_stats()
    assert logical - physical == eng.summary()["pages_saved"] == 2
    assert TKC.page_nbytes(eng.pool, eng.pcfg) == 4 * sum(
        t[:, 0].numel() for kinds in eng.pool["data"].values()
        for t in kinds.values())        # fp32 pages
