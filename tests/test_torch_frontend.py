"""repro_torch's audio and vision frontends against repro (the JAX
reference), on the CPU.

The reference's frontends are stubs: the model takes precomputed frame
(hubert-xlarge, audio: no embedding site, frames in place of the token
embeddings, a non-causal encoder) or patch (llava-next-34b, vision:
patches before the token embeddings, the loss on the text positions only)
embeddings. Held here:

(a) ``build_lm`` builds both (and deepseek-v2-236b) at full size: the
    parameter counts of the meta trees, an audio model without ``embed``;
(b) ``launch/train.py::make_batch_fn`` gives the reference's numpy arrays
    exactly (``default_rng(step)`` frames of (B, seq, d_model), labels mod
    the vocabulary; ``max(4, seq // 4)`` patches);
(c) on the reduced configs, float32, with every projection a TT site (d =
    3, rank 4, ``min_elements`` 1,024) and quantization on (the activation
    edges with managed scales), weights and state carried across by
    ``lm_train_state_from_jax``: the loss and every gradient of
    ``make_loss_fn`` against ``repro.launch.steps``, and one train step
    with f32 moments, within ``tests/test_torch_lm_train.py``'s
    tolerances (loss, ce and prior 1e-5 relative; gradients within 1e-5
    of each leaf's largest magnitude, the TT chains' f32 sums running in
    another order, 99% of each leaf's elements and every one within one
    code more, the grad edge's rule: the activation edges quantize the
    backward at grad_bits, and a gradient within roundoff of a code
    boundary lands on the neighbouring code; params within 2e-5
    absolute);
(d) ``steps.launches_per_step`` counts such a step's kernel calls (an
    audio model's first activation edge has no backward: its frames need
    no gradient);
(e) the ``Engine`` refuses both, with the reference's messages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as JC  # noqa: E402
from repro.configs.base import QuantConfig as JQuantConfig  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs.base import TTConfig as JTTConfig  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.launch import train as JT  # noqa: E402
from repro.models import lm as JL  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import EngineConfig as JEC  # noqa: E402
from repro.serve import PoolConfig as JPC  # noqa: E402
from repro.sharding import ShardPlan  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.configs.base import QuantConfig, TrainConfig  # noqa: E402
from repro_torch.configs.base import TTConfig  # noqa: E402
from repro_torch.convert import (lm_train_state_from_jax,  # noqa: E402
                                 params_from_jax)
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch import train as TT  # noqa: E402
from repro_torch.models import frontend as TF  # noqa: E402
from repro_torch.models import lm as TL  # noqa: E402
from repro_torch.serve import Engine, EngineConfig, PoolConfig  # noqa: E402
from repro_torch.tree import flatten_with_path  # noqa: E402
from test_torch_lm_train import _count_launches  # noqa: E402

ARCHS = ("hubert-xlarge", "llava-next-34b")
TTK = dict(enable=True, d=3, max_rank=4, min_elements=1024,
           apply_to=("ffn", "attn_qkv", "attn_o"))
PLAN = ShardPlan(mesh=None)
BATCH, SEQ = 2, 16

_MODELS: dict = {}


def _models(arch):
    """(reference lm, params, port lm, params): the reduced ``arch`` in f32
    with TT sites and quantization on."""
    if arch not in _MODELS:
        jcfg = JC.get_reduced(arch).replace(
            dtype="float32", remat="none", tt=JTTConfig(**TTK),
            quant=JQuantConfig(enable=True))
        tcfg = TC.get_reduced(arch).replace(
            dtype="float32", remat="none", tt=TTConfig(**TTK),
            quant=QuantConfig(enable=True))
        jlm = JL.build_lm(jcfg)
        jp = jax.jit(lambda k: JL.init_lm(k, jlm))(jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        _MODELS[arch] = (jlm, jp, TL.build_lm(tcfg), tp)
    return _MODELS[arch]


def _batches(cfg, step=0):
    """The reference's numpy batch as JAX arrays and as torch tensors."""
    b = JT.make_batch_fn(cfg, BATCH, SEQ, 0)(step)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in b.items()})


def _leaves_close(got, want, code):
    """Port gradients ``got`` against the reference's stacked tree ``want``,
    leaf by leaf: 99% of each leaf's elements within 1e-5 of its largest
    magnitude, every one within that and one ``code`` of the activation
    edges' backward grid (an element within roundoff of a code boundary of
    the grad_bits quantizer lands on the neighbouring code; the file's
    docstring). Returns the leaves compared."""
    ref = params_from_jax(jax.tree.map(
        lambda g: (np.zeros(g.shape, np.int32)         # an integer leaf's
                   if g.dtype == jax.dtypes.float0      # gradient
                   else np.asarray(g)), want), device="cpu")
    pairs = list(zip(flatten_with_path(got), flatten_with_path(ref)))
    assert [p for (p, _), _ in pairs] == [p for _, (p, _) in pairs]
    n = 0
    for (path, a), (_, b) in pairs:
        if a is None or not b.is_floating_point():
            continue
        tol = 1e-5 * max(float(b.abs().max()), 1e-30)
        err = (a.float() - b.float()).abs()
        assert float(err.max()) <= tol + code, (path, float(err.max()), tol)
        assert int((err <= tol).sum()) >= 0.99 * err.numel(), path
        n += 1
    return n


# ---------------------------------------------------------------------------
# (a) the full-size models, (b) the batches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,layers,tt,params,embed", [
    ("hubert-xlarge", None, False, 1_259_060_480, False),
    ("hubert-xlarge", None, True, 12_883_040, False),
    ("llava-next-34b", 2, True, 918_925_220, True),
    ("deepseek-v2-236b", 6, False, 24_881_280_000, True)])
def test_build_lm_at_full_size(arch, layers, tt, params, embed):
    cfg = TC.get_config(arch)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    if tt:
        cfg = TC.with_tt(cfg, quantize=True)
    lm = TL.build_lm(cfg)
    tree = TL.init_lm(None, lm, device="meta")
    assert sum(t.numel() for _, t in flatten_with_path(tree)) == params
    assert ("embed" in tree) == embed == (lm.embed is not None)
    assert any(s.use_tt for _, s in TL._walk_sites(lm)) == tt


@pytest.mark.parametrize("step", [0, 3])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_batch_fn_is_the_reference(arch, step):
    cfg = JC.get_reduced(arch)
    want = JT.make_batch_fn(cfg, 3, 20, 7)(step)
    got = TT.make_batch_fn(TC.get_reduced(arch), 3, 20, 7)(step)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])
    name = "frames" if arch.startswith("hubert") else "patches"
    assert got[name].shape == (3, 20 if name == "frames" else 5, cfg.d_model)


def test_synthetic_embeddings_have_the_specs_shapes():
    cfg = TC.get_reduced("llava-next-34b")
    gen = torch.Generator().manual_seed(0)
    shape, dt = TF.vision_patches_spec(cfg, 2, 9, torch.bfloat16)
    x = TF.synth_vision_patches(gen, cfg, 2, 9, dt)
    assert tuple(x.shape) == shape == (2, 9, cfg.d_model) and x.dtype == dt
    shape, dt = TF.audio_frames_spec(cfg, 3, 4, torch.float32)
    assert tuple(TF.synth_audio_frames(gen, cfg, 3, 4, dt).shape) == shape


# ---------------------------------------------------------------------------
# (c) the loss, its gradients and a train step
# ---------------------------------------------------------------------------

def _state(arch):
    jlm, jp, tlm, _ = _models(arch)
    jt = JTrainConfig(total_steps=5, warmup_steps=1)
    js = JS.init_train_state(jp, jt, policy=jlm.cfg.quant.policy())
    ts = lm_train_state_from_jax(jax.tree.map(np.asarray, js), "cpu")
    return jt, js, TrainConfig(total_steps=5, warmup_steps=1), ts


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch):
    jlm, _, tlm, _ = _models(arch)
    jt, js, tt, ts = _state(arch)
    assert set(ts.scales) == {"activation", "grad_edge"}
    jb, tb = _batches(jlm.cfg)
    (jl, (jm, jo)), jg = jax.jit(jax.value_and_grad(
        JS.make_loss_fn(jlm, PLAN, jt), has_aux=True, allow_int=True))(
            js.params, jb, js.scales)
    tl, (tm, to), tg = TS._value_and_grad(TS.make_loss_fn(tlm, None, tt),
                                          ts.params, tb, ts.scales)
    for k in ("ce", "prior", "aux"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5, abs=1e-7)
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    assert float(to["activation"][0]) == pytest.approx(
        float(jo["activation"][0]), rel=1e-5)
    q = tlm.cfg.quant
    code = 2.0 ** (float(ts.scales["grad_edge"].log2) - (q.grad_bits - 1))
    assert _leaves_close(tg, jg, code) > 20
    if arch.startswith("hubert"):
        assert "embed" not in ts.params


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    jlm, _, tlm, _ = _models(arch)
    jt, js, tt, ts = _state(arch)
    jb, tb = _batches(jlm.cfg, step=1)
    js, jm = jax.jit(JS.make_train_step(jlm, PLAN, jt))(js, jb)
    ts, tm = TS.make_train_step(tlm, None, tt)(ts, tb)
    for k in ("loss", "ce", "prior", "gnorm", "lr"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
    got = lm_train_state_from_jax(jax.tree.map(np.asarray, js), "cpu")
    for (p, a), (_, b) in zip(flatten_with_path(got.params),
                              flatten_with_path(ts.params)):
        if a.is_floating_point():
            assert float((a - b).abs().max()) <= 2e-5, p
        else:
            assert torch.equal(a, b), p


# ---------------------------------------------------------------------------
# (d) launches, (e) the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_launches_per_step_counts_the_frontend_step(arch, monkeypatch):
    _, _, tlm, _ = _models(arch)
    _, _, tt, ts = _state(arch)
    _, tb = _batches(tlm.cfg)
    step = TS.make_train_step(tlm, None, tt)
    counts = _count_launches(monkeypatch)
    step(ts, tb)
    want = TS.launches_per_step(tlm, tt, ts.params)
    assert counts == want
    assert want == TS.launches_per_step(tlm, tt)       # from the meta tree
    assert want["pe3"] == sum(s.use_tt for _, s in TL._walk_sites(tlm)) * 2


@pytest.mark.parametrize("arch,message", [
    ("llava-next-34b", "frontend"), ("hubert-xlarge", "encoder-only")])
def test_engine_refuses_frontend_configs(arch, message):
    jlm, jp, tlm, tp = _models(arch)
    pool = dict(num_slots=2, page_size=4, pages_per_slot=4)
    with pytest.raises(NotImplementedError, match=message) as jerr:
        JEngine(jlm, jp, JEC(pool=JPC(**pool)), PLAN)
    with pytest.raises(NotImplementedError, match=message) as terr:
        Engine(tlm, tp, EngineConfig(pool=PoolConfig(**pool)), device="cpu")
    assert str(terr.value) == str(jerr.value)
