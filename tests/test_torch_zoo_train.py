"""repro_torch's train step on the zoo's non-MoE archs against repro (the
JAX reference): the port's twin of ``tests/test_models.py::
test_reduced_train_step``, held to the reference's jitted step.

The archs without a recurrence here (the audio and vision frontends and
the dense decoders); rwkv6-1.6b in ``test_torch_zoo_train_rwkv6.py`` and
jamba-1.5-large with dense FFNs in ``test_torch_zoo_train_jamba.py``, on
this file's helpers (the launch count and the full-size model too). Each arch
reduced, float32, ``remat="none"``; weights and the train state carried
over by ``lm_train_state_from_jax``, batches from ``make_batch_fn``
(numpy, seeded). Two steps, each against the reference's: loss and ce
within 1e-5 relative, gnorm 1e-4 (a sum of squares over every gradient
reassociates), params within 2e-5 absolute (Adam divides by sqrt(v) +
eps, which turns the gradients' roundoff into ~1e-6 moves a step).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as JC  # noqa: E402
import repro.models.ssm as JSSM  # noqa: E402
from repro.configs.base import MoEConfig as JMoE  # noqa: E402
from repro.configs.base import QuantConfig as JQuantConfig  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs.base import TTConfig as JTTConfig  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.launch import train as JT  # noqa: E402
from repro.models import lm as JL  # noqa: E402
from repro.sharding import ShardPlan  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.configs.base import MoEConfig, QuantConfig  # noqa: E402
from repro_torch.configs.base import TrainConfig, TTConfig  # noqa: E402
from repro_torch.convert import lm_train_state_from_jax  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import lm as TL  # noqa: E402
from repro_torch.models import ssm as TSSM  # noqa: E402
from repro_torch.tree import flatten_with_path  # noqa: E402

from test_torch_lm_train import _count_launches  # noqa: E402

PLAN = ShardPlan(mesh=None)
ARCHS = ("hubert-xlarge", "yi-34b", "granite-34b", "internlm2-1.8b",
         "stablelm-3b", "llava-next-34b")
BATCH, SEQ = 2, 16
TTK = dict(enable=True, d=3, max_rank=4, min_elements=1024)


def patch_scan_chunk(monkeypatch, chunk=4):
    """The scans' chunk of ``chunk`` tokens in both packages: four chunks
    of the 16-token batch."""
    monkeypatch.setattr(TSSM, "SCAN_CHUNK", chunk)
    monkeypatch.setattr(JSSM, "SCAN_CHUNK", chunk)


def _cfgs(arch, remat="none", tt=False):
    """The reduced ``arch`` in f32 for both packages; jamba with dense FFNs
    (its experts: ``test_torch_zoo_train_jamba_moe.py``); with ``tt`` the
    TT sites of ``with_tt`` (d = 3, rank 4, ``min_elements`` 1,024) and
    quantization."""
    jo, to = {}, {}
    if arch.startswith("jamba"):
        jo = {"moe": JMoE(num_experts=0)}
        to = {"moe": MoEConfig(num_experts=0)}
    if tt:
        jo.update(tt=JTTConfig(**TTK), quant=JQuantConfig(enable=True))
        to.update(tt=TTConfig(**TTK), quant=QuantConfig(enable=True))
    return (JC.get_reduced(arch).replace(dtype="float32", remat=remat, **jo),
            TC.get_reduced(arch).replace(dtype="float32", remat=remat, **to))


def _batches(cfg, step):
    """The reference loop's numpy batch (``make_batch_fn``) as JAX arrays
    and as tensors."""
    b = JT.make_batch_fn(cfg, BATCH, SEQ, 0)(step)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in b.items()})


def _port(jstate):
    return lm_train_state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")


def _start(arch, remat, tt=False, **train):
    """(reference lm, state, jitted step, port lm, state, step) from one
    seeded reference init."""
    jcfg, tcfg = _cfgs(arch, remat, tt)
    jlm, tlm = JL.build_lm(jcfg), TL.build_lm(tcfg)
    jp = jax.jit(lambda k: JL.init_lm(k, jlm))(jax.random.PRNGKey(0))
    kw = dict(total_steps=10, warmup_steps=1, **train)
    jt, tt_ = JTrainConfig(**kw), TrainConfig(**kw)
    js = JS.init_train_state(jp, jt, policy=jcfg.quant.policy())
    return (jlm, js, jax.jit(JS.make_train_step(jlm, PLAN, jt)), tlm,
            _port(js), TS.make_train_step(tlm, None, tt_))


def _params_close(jstate, tstate, atol, share=None):
    """Params leaf by leaf within ``atol``; ``share`` of the elements
    within 2e-5 where given. Returns the reference's state in the port's
    layout."""
    got = _port(jstate)
    close = total = 0
    for (p, a), (_, b) in zip(flatten_with_path(got.params),
                              flatten_with_path(tstate.params)):
        if not a.is_floating_point():
            assert torch.equal(a, b), p
            continue
        e = (a - b).abs()
        assert e.max().item() <= atol, (p, e.max().item())
        close += int((e <= 2e-5).sum())
        total += e.numel()
    if share is not None:
        assert close >= share * total, (close, total)
    assert int(got.step) == int(tstate.step)
    return got


def two_steps_match(arch, remat):
    """Two train steps of the reduced ``arch`` against the reference's."""
    jlm, js, jstep, tlm, ts, tstep = _start(arch, remat)
    assert tlm.cfg.remat == remat
    for step in range(2):
        jb, tb = _batches(jlm.cfg, step)
        js, jm = jstep(js, jb)
        ts, tm = tstep(ts, tb)
        assert np.isfinite(float(tm["loss"]))
        for k in ("loss", "ce", "gnorm"):
            assert float(tm[k]) == pytest.approx(
                float(jm[k]), rel=1e-4 if k == "gnorm" else 1e-5), (step, k)
        _params_close(js, ts, atol=2e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_two_train_steps_match_jax(arch):
    two_steps_match(arch, "none")


def launches_match(monkeypatch, arch, remat):
    """``steps.launches_per_step`` is the count of a real step's kernel
    calls on the recurrent archs with TT sites (rwkv6's channel mix,
    jamba's attention and FFNs), int8 moments and the wire; the scans'
    chunk recompute runs no TT site."""
    _, tcfg = _cfgs(arch, remat, tt=True)
    lm = TL.build_lm(tcfg)
    params = TL.init_lm(torch.Generator().manual_seed(0), lm, device="cpu")
    tt = TrainConfig(total_steps=5, warmup_steps=1, grad_compress=True,
                     opt_state_dtype="int8")
    state = TS.init_train_state(params, tt, policy=tcfg.quant.policy())
    _, tb = _batches(tcfg, 0)
    counts = _count_launches(monkeypatch)
    TS.make_train_step(lm, None, tt)(state, tb)
    want = TS.launches_per_step(lm, tt, params)
    assert counts == want
    assert want == TS.launches_per_step(lm, tt)        # from the meta tree
    sites = sum(s.use_tt for _, s in TL._walk_sites(lm)) * lm.n_periods
    assert sites and want["pe3"] == sites


def full_size_match(arch, params, sites, **over):
    """with_tt(arch, quantize=True) from the meta tree (no weights), the
    config's fields ``over`` replaced: its parameters, its TT sites and
    their PE launches a step under the config's ``remat="full"``."""
    cfg = TC.get_config(arch).replace(**over)
    lm = TL.build_lm(TC.with_tt(cfg, quantize=True))
    tree = TL.init_lm(None, lm, device="meta")
    assert sum(t.numel() for _, t in flatten_with_path(tree)) == params
    assert sum(s.use_tt for _, s in TL._walk_sites(lm)) * lm.n_periods \
        == sites
    tt = TrainConfig(opt_state_dtype="int8", grad_compress=True)
    want = TS.launches_per_step(lm, tt)
    d = 3
    assert lm.cfg.remat == "full"
    assert (want["pe1"], want["pe2"], want["pe3"]) == (
        3 * sites, 3 * sites * (d - 1), sites)
    assert want["p2_fake_quant"] > 2 * sites and want["bw_enc"] >= 2
