"""repro_torch.models against repro.models (the JAX reference), on
transferred weights (``convert.params_from_jax``).

``lm_forward`` logits and the prefill K/V cache must agree with JAX on the
reduced internlm2-1.8b config in float32 at rtol/atol 1e-4: the matmuls
reduce in a different order (MKL vs XLA), so agreement is to roundoff.
The building blocks (rope, rms_norm, chunked and decode attention) are
held to 1e-5.
"""
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as JC  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import build_lm as j_build  # noqa: E402
from repro.models import common as JCM  # noqa: E402
from repro.models import init_lm as j_init  # noqa: E402
from repro.models import lm_forward as j_forward  # noqa: E402
from repro.sharding import ShardPlan  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import build_lm as t_build  # noqa: E402
from repro_torch.models import common as TCM  # noqa: E402
from repro_torch.models import init_lm as t_init  # noqa: E402
from repro_torch.models import lm_forward as t_forward  # noqa: E402

ARCH = "internlm2-1.8b"


@pytest.fixture(scope="module")
def pair():
    jcfg = JC.get_reduced(ARCH).replace(dtype="float32", remat="none")
    tcfg = TC.get_reduced(ARCH).replace(dtype="float32", remat="none")
    jlm = j_build(jcfg)
    jp = j_init(jax.random.PRNGKey(0), jlm)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jlm, jp, t_build(tcfg), tp


def test_configs_are_a_faithful_copy():
    assert sorted(TC.ARCHS) == sorted(JC.ARCHS)
    for arch in JC.ARCHS:
        assert asdict(TC.get_config(arch)) == asdict(JC.get_config(arch))
        assert asdict(TC.get_reduced(arch)) == asdict(JC.get_reduced(arch))
        assert TC.get_strategy(arch) == JC.get_strategy(arch)


def test_lm_forward_logits_and_cache_match_jax(pair):
    jlm, jp, tlm, tp = pair
    toks = np.random.RandomState(0).randint(0, jlm.cfg.vocab_size, (2, 13))
    jl, _, jc = j_forward(jp, jlm, ShardPlan(mesh=None),
                          tokens=jnp.asarray(toks), return_cache=True)
    tl, aux, tc = t_forward(tp, tlm, tokens=torch.from_numpy(toks),
                            return_cache=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    for name in ("k", "v"):
        assert tuple(tc["sub_0"][name].shape) == jc["sub_0"][name].shape
        np.testing.assert_allclose(tc["sub_0"][name].numpy(),
                                   np.asarray(jc["sub_0"][name]),
                                   rtol=1e-4, atol=1e-4)
    assert float(aux) == 0.0


def test_params_from_jax_unstacks_layers_and_keeps_bf16_bits(pair):
    jlm, jp, tlm, tp = pair
    assert len(tp["layers"]) == jlm.n_periods
    w = np.asarray(jp["layers"]["sub_0"]["ffn"]["up"]["w"])
    assert np.array_equal(tp["layers"][1]["sub_0"]["ffn"]["up"]["w"].numpy(),
                          w[1])
    bf = jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)),
                      {"embed": jp["embed"], "layers": jp["layers"]})
    tb = params_from_jax(bf, device="cpu")
    assert tb["embed"]["w"].dtype == torch.bfloat16
    assert np.array_equal(tb["embed"]["w"].view(torch.int16).numpy(),
                          bf["embed"]["w"].view(np.int16))


def test_init_lm_tree_matches_reference_layout(pair):
    """Same keys, shapes and dtypes as a JAX init (unstacked), and the
    reference's distributions: norms at 1, site std ~ sqrt(2/(in+out))."""
    jlm, jp, tlm, _ = pair
    gen = torch.Generator().manual_seed(0)
    tp = t_init(gen, tlm, device="cpu")

    def shapes(t):
        return {k: shapes(v) if isinstance(v, dict) else
                (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in t.items()}
    ref = shapes(params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
                 ["layers"][0])
    assert shapes(tp["layers"][0]) == ref
    w = tp["layers"][0]["sub_0"]["ffn"]["up"]["w"]
    sigma = (2.0 / sum(w.shape)) ** 0.5
    assert abs(float(w.std()) / sigma - 1) < 0.1
    assert torch.equal(tp["final_norm"]["scale"],
                       torch.ones(tlm.cfg.d_model))


def test_rope_and_rms_norm_match_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 7, 3, 16).astype(np.float32)
    pos = np.tile(np.arange(7)[None] * 37, (2, 1))
    j = JCM.rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    t = TCM.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)
    sc = rng.rand(16).astype(np.float32)
    j = JCM.rms_norm(jnp.asarray(x), jnp.asarray(sc), 1e-5)
    t = TCM.rms_norm(torch.from_numpy(x), torch.from_numpy(sc), 1e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention_multi_chunk_matches_jax(causal):
    """Several q chunks x kv chunks with a padded kv tail: the online-
    softmax order of the reference, GQA head expansion included."""
    rng = np.random.RandomState(2)
    q = rng.randn(2, 12, 4, 16).astype(np.float32)
    k = rng.randn(2, 10, 2, 16).astype(np.float32)
    v = rng.randn(2, 10, 2, 16).astype(np.float32)
    kw = dict(causal=causal, q_chunk=4, kv_chunk=4)
    j = JA.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             **kw)
    t = TA.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), **kw)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)


def test_gqa_attend_matches_jax():
    rng = np.random.RandomState(4)
    q = rng.randn(3, 2, 4, 16).astype(np.float32)
    k = rng.randn(3, 9, 2, 16).astype(np.float32)
    v = rng.randn(3, 9, 2, 16).astype(np.float32)
    qpos = np.array([[0, 1], [4, 5], [7, 8]], np.int32)
    jd = JA.GQADef(None, None, None, 4, 2, 16, 4)
    td = TA.GQADef(None, None, None, 4, 2, 16, 4)
    j = JA.gqa_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jd,
                      jnp.asarray(qpos))
    t = TA.gqa_attend(torch.from_numpy(q), torch.from_numpy(k),
                      torch.from_numpy(v), td, torch.from_numpy(qpos))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)


def test_out_of_slice_families_raise():
    # MLA builds (deepseek-v2-236b is MLA and MoE, with shared experts;
    # tests/test_torch_mla.py holds it to the reference), its TT "expert"
    # sites too (tests/test_torch_zoo_train_deepseek.py trains them)
    lm = t_build(TC.get_reduced("deepseek-v2-236b"))
    assert [s.mixer_kind for s in lm.period] == ["attn_mla"]
    assert lm.period[0].ffn.shared is not None
    assert t_build(TC.with_tt(TC.get_config("deepseek-v2-236b"))
                   ).period[0].ffn.gate.use_tt
    # the MoE families build, experts and all (tests/test_torch_moe.py
    # holds them to the reference), TT "expert" sites too
    from repro_torch.configs.base import MoEConfig
    for arch, over in (("rwkv6-1.6b", {}), ("moonshot-v1-16b", {}),
                       ("jamba-1.5-large", {}),
                       ("jamba-1.5-large", {"moe": MoEConfig(num_experts=0)})):
        for cfg in (TC.get_reduced(arch), TC.get_config(arch)):
            lm = t_build(cfg.replace(**over))
            assert lm.n_periods * len(lm.period) == cfg.num_layers
            assert ("moe" in [s.ffn_kind for s in lm.period]) == (
                arch != "rwkv6-1.6b" and not over)
    assert t_build(TC.with_tt(TC.get_config("moonshot-v1-16b"))
                   ).period[0].ffn.down.use_tt
    # TT sites are ported (every projection TT here); remat="dots" is not
    cfg = TC.with_tt(TC.get_reduced(ARCH).replace(dtype="float32"))
    lm = t_build(cfg.replace(tt=cfg.tt.__class__(enable=True,
                                                 min_elements=1)))
    params = t_init(torch.Generator(), lm, device="cpu")
    assert "core_2" in params["layers"][0]["sub_0"]["ffn"]["down"]
    with pytest.raises(NotImplementedError):
        t_forward(params, t_build(lm.cfg.replace(remat="dots")),
                  tokens=torch.zeros((1, 4), dtype=torch.int64))
