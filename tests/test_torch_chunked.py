"""repro_torch's chunked prefill against repro's (the JAX reference).

(a) ``Engine(..., EngineConfig(prefill_chunk=8), device="cpu")`` greedy
    tokens are IDENTICAL to the JAX ``Engine`` with the same chunk width on
    transferred weights, over fp and int8 pools, with the port's fused and
    gather decode; the prefill counters agree;
(b) the port's chunked prefill equals its whole-prompt prefill on the fp
    pool (the port of ``tests/test_serve.py::test_chunked_prefill_matches_
    whole_prompt``), also across a bucketed suffix and a chunk width that
    does not divide the prompt;
(c) ``kv_cache.write_chunk`` writes the same codes (or values) into the
    same pool cells as JAX's, bit for bit, pad rows past the slot's last
    page included (JAX clamps that page index silently; the port clamps it
    explicitly and sends the rows to the trash page);
(d) a chunk step's write and history read are one paged launch a layer
    each (``append_paged``, ``read_paged``), with no scalar-scale or
    row-scale codec call.
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
from repro.serve import kv_cache as JKC  # noqa: E402
from repro.sharding import ShardPlan  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build_lm as t_build  # noqa: E402
from repro_torch.numerics import cuda_backend as CB  # noqa: E402
from repro_torch.serve import Engine, EngineConfig, PoolConfig  # noqa: E402
from repro_torch.serve import kv_cache as TKC  # noqa: E402

ARCH = "internlm2-1.8b"
POOL = dict(num_slots=2, page_size=8, pages_per_slot=6)


@pytest.fixture(scope="module")
def models():
    jcfg = JC.get_reduced(ARCH).replace(dtype="float32", remat="none")
    tcfg = TC.get_reduced(ARCH).replace(dtype="float32", remat="none")
    jlm = j_build(jcfg)
    jp = j_init(jax.random.PRNGKey(0), jlm)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jlm, jp, t_build(tcfg), tp


def _prompts(vocab, lens, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, n).tolist() for n in lens]


def _serve(engine, prompts, gens):
    rids = [engine.submit(p, max_new_tokens=g) for p, g in zip(prompts, gens)]
    res = engine.run()
    return [res[r].tokens for r in rids]


# ragged prompts on 2 slots: a one-chunk prompt, an exact multiple of the
# chunk, and tails of 1..7 tokens (pad rows past the last mapped page)
LENS, GENS = [5, 24, 17, 31], [6, 5, 7, 4]
_JAX_RUNS: dict = {}


def _jax_run(models, quantized):
    if quantized not in _JAX_RUNS:
        jlm, jp, _, _ = models
        prompts = _prompts(jlm.cfg.vocab_size, LENS, seed=3)
        eng = JEngine(jlm, jp, JEC(pool=JPC(**POOL, quantized=quantized),
                                   prefill_chunk=8), ShardPlan(mesh=None))
        _JAX_RUNS[quantized] = (prompts, _serve(eng, prompts, GENS),
                                eng.summary())
    return _JAX_RUNS[quantized]


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_chunked_engine_tokens_identical_to_jax(models, quantized, fused):
    _, _, tlm, tp = models
    prompts, ref, jsum = _jax_run(models, quantized)
    eng = Engine(tlm, tp, EngineConfig(
        pool=PoolConfig(**POOL, quantized=quantized), prefill_chunk=8,
        fused_attention=fused), device="cpu")
    assert _serve(eng, prompts, GENS) == ref
    s = eng.summary()
    for k in ("prefill_tokens", "prompt_tokens", "decode_steps",
              "cache_bytes"):
        assert s[k] == jsum[k], k
    # 17, 24 and 31 tokens split into chunks of 8: 2 + 2 + 3 chunk steps
    assert sum(-(-n // 8) - 1 for n, _ in eng.metrics.prefills) == 7


@pytest.mark.parametrize("chunk,bucket", [(8, 0), (5, 0), (0, 0), (8, 16)])
def test_chunked_prefill_matches_whole_prompt(models, chunk, bucket):
    """fp pool: the chunk step over the pool's history computes what the
    whole-prompt forward does (greedy tokens identical)."""
    _, _, tlm, tp = models
    prompt = _prompts(tlm.cfg.vocab_size, [24], seed=5)[0]
    outs = []
    for c, b in ((0, 0), (chunk, bucket)):
        eng = Engine(tlm, tp, EngineConfig(
            pool=PoolConfig(**POOL), prefill_chunk=c, prefill_bucket=b),
            device="cpu")
        outs.append(_serve(eng, [prompt], [6])[0])
    assert outs[0] == outs[1]


def _chunk_inputs(quantized, seed):
    """One layer's pool (P+1 = 7 pages of 4, Hkv 2, Dh 8), a slot whose
    table holds 3 pages (12 positions), and a chunk of 8 rows: at start 6
    or 9 the pad rows reach page index 3-4, past the slot's last entry."""
    rng = np.random.RandomState(seed)
    pcfg_kw = dict(num_slots=2, page_size=4, pages_per_slot=3,
                   quantized=quantized)
    store = np.int8 if quantized else np.float32
    data = (rng.randint(-128, 128, (7, 4, 2, 8)) if quantized
            else rng.randn(7, 4, 2, 8)).astype(store)
    scale = rng.randint(-6, 0, (2,)).astype(np.float32)
    vals = (rng.randn(8, 2, 8) * 3).astype(np.float32)
    table_row = np.array([5, 2, 4], np.int32)
    return pcfg_kw, data, scale, vals, table_row


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("start,valid", [(6, 5), (0, 8), (9, 3)])
def test_write_chunk_bit_identical_to_jax(quantized, start, valid):
    pcfg_kw, data, scale, vals, table_row = _chunk_inputs(quantized,
                                                          start + valid)
    jd, js = JKC.write_chunk(jnp.asarray(data), jnp.asarray(scale),
                             jnp.asarray(vals), jnp.asarray(table_row),
                             jnp.int32(start), jnp.int32(valid),
                             jnp.int32(1), JPC(**pcfg_kw))
    td = torch.from_numpy(data.copy())
    ts = torch.from_numpy(scale.copy())
    out_d, out_s = TKC.write_chunk(td, ts, torch.from_numpy(vals),
                                   torch.from_numpy(table_row), start, valid,
                                   1, PoolConfig(**pcfg_kw))
    assert out_d is td                       # in place
    jd, td = np.asarray(jd), td.numpy()
    trash = PoolConfig(**pcfg_kw).trash_page
    # every real page bit for bit; the trash page is write-only scratch
    np.testing.assert_array_equal(td[:trash], jd[:trash])
    np.testing.assert_array_equal(out_s.numpy(), np.asarray(js))
    assert not np.array_equal(td[:trash], data[:trash])     # it wrote


def test_chunk_step_runs_the_scalar_codec(models, monkeypatch):
    """A chunk step no longer runs the scalar-scale codec: its write and its
    history read are one paged launch a layer each, K and V together
    (``ops.append_paged`` and ``ops.read_paged``, their plain twins on the
    CPU); the first chunk's ``write_prefill`` is one ``ops.prefill_paged``
    for K and V of every layer, and no row-scale codec runs at all."""
    _, _, tlm, tp = models
    calls = {"encode_scalar": 0, "decode_scalar": 0, "encode_rows": 0,
             "decode_rows": 0, "append_paged": 0, "read_paged": 0,
             "prefill_paged": 0}
    for mod, names in ((CB, ("encode_scalar", "decode_scalar", "encode_rows",
                             "decode_rows")),
                       (ops, ("append_paged", "read_paged",
                              "prefill_paged"))):
        for name in names:
            def wrapped(*a, _n=name, _fn=getattr(mod, name), **k):
                calls[_n] += 1
                return _fn(*a, **k)
            monkeypatch.setattr(mod, name, wrapped)
    eng = Engine(tlm, tp, EngineConfig(
        pool=PoolConfig(**POOL, quantized=True), prefill_chunk=8),
        device="cpu")
    prompt = _prompts(tlm.cfg.vocab_size, [20], seed=9)[0]
    eng.submit(prompt, max_new_tokens=1)
    eng.run()
    # 20 tokens in chunks of 8: the first through lm_forward (write_prefill:
    # one paged prefill write for K and V of every layer), then 2 chunk
    # steps x layers, one write and one read each
    per = 2 * tlm.n_periods
    assert tlm.n_periods > 1
    assert calls == {"encode_scalar": 0, "decode_scalar": 0, "encode_rows": 0,
                     "decode_rows": 0, "append_paged": per,
                     "read_paged": per, "prefill_paged": 1}
