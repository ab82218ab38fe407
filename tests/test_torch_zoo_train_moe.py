"""repro_torch's train step on moonshot-v1-16b (MoE, 64 experts top-6 at
full size) against repro (the JAX reference): ``test_torch_zoo_train.py``'s
twin of ``tests/test_models.py::test_reduced_train_step`` on an MoE stack,
with dense experts and with TT experts (``"expert"`` in ``apply_to``: each
expert stack a grouped TT site), on that file's helpers and tolerances.

Reduced (2 layers, 8 experts top-2), float32, ``remat="none"``: two
steps, each against the reference's jitted step: loss, ce and the router's
``aux`` within 1e-5 relative, gnorm 1e-4, params within 2e-5 absolute for
99.9% of the elements and within 1e-3 for all (Adam's step is lr g /
(|g| + eps): an element whose gradient is within roundoff of zero moves by
a share of lr; deepseek's reduced dense step has one, a gradient of
7.6e-9 in the reference and 1.4e-8 here, 2.2e-5 apart after the step).
The TT twins run without quantization; one step with it (the stacked
cores' row fake-quant and its STE) is held at the same tolerances: its
grad edges round the gradients onto a pow-2 grid, where a roundoff apart
can land a value on the neighbouring code, and a code apart at a zero
gradient moves the element by up to lr.
Before any number, both packages must have kept the same (expert, token)
pairs in every MoE layer (the port's ``moe._select``, the reference's
capacity ``lax.top_k`` read by a debug callback), so a capacity flip at a
near-tie shows as that. ``steps.launches_per_step`` against a real step's
kernel calls (grouped PE launches, one ``p2_fq_rows`` a stacked core), and
the full-size model's parameters and launches from the meta tree. The
helpers here serve the deepseek and jamba twins too.
"""
import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as JC  # noqa: E402
import repro.models.moe as JM  # noqa: E402
from repro.configs.base import QuantConfig as JQuantConfig  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs.base import TTConfig as JTTConfig  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import lm as JL  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.configs.base import QuantConfig, TrainConfig  # noqa: E402
from repro_torch.configs.base import TTConfig  # noqa: E402
from repro_torch.kernels import ttm_pe1, ttm_pe2, ttm_pe3  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import lm as TL  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.numerics import cuda_backend as CB  # noqa: E402
from repro_torch.tree import flatten_with_path  # noqa: E402

from test_torch_lm_train import _count_launches  # noqa: E402
from test_torch_zoo_train import (PLAN, TTK, _batches,  # noqa: E402
                                  _params_close, _port)

ARCH = "moonshot-v1-16b"
# the zoo twins' TT sites with the experts' (``with_tt``'s default sites)
TTX = dict(TTK, apply_to=("ffn", "attn_qkv", "attn_o", "expert"))


def moe_cfgs(arch, tt: bool, remat: str = "none", quant: bool = True,
             **over):
    """The reduced ``arch`` in f32 for both packages, the config's fields
    ``over`` replaced in both; with ``tt`` the TT sites of ``with_tt``
    (experts included; d = 3, rank 4, ``min_elements`` 1,024) and, with
    ``quant``, quantization."""
    jo, to = dict(over), dict(over)
    if tt:
        jo.update(tt=JTTConfig(**TTX), quant=JQuantConfig(enable=quant))
        to.update(tt=TTConfig(**TTX), quant=QuantConfig(enable=quant))
    return (JC.get_reduced(arch).replace(dtype="float32", remat=remat, **jo),
            TC.get_reduced(arch).replace(dtype="float32", remat=remat, **to))


def _kept(select_calls) -> list:
    """The kept (expert, token) pairs of each recorded capacity selection,
    the calls in sorted order (the reference's callbacks are unordered)."""
    out = []
    for cw, cidx in select_calls:
        cw, cidx = np.asarray(cw), np.asarray(cidx)
        out.append(sorted((e, int(t)) for e in range(cw.shape[0])
                          for t, w in zip(cidx[e], cw[e]) if w > 0))
    return sorted(out)


def record_selections(monkeypatch, n_experts: int):
    """Record every capacity selection of both packages: the port's
    ``moe._select`` calls, and the reference's capacity ``lax.top_k``
    (its (E, T) operand, not the router's (T, E)) by a debug callback
    that fires as the jitted step runs. Returns (port, reference) lists."""
    port, ref = [], []
    select = TM._select

    def tselect(w, c):
        out = select(w, c)
        port.append(tuple(t.detach().numpy().copy() for t in out))
        return out
    monkeypatch.setattr(TM, "_select", tselect)
    top_k = jax.lax.top_k

    def jtop_k(x, k):
        out = top_k(x, k)
        if x.ndim == 2 and x.shape[0] == n_experts:
            jax.debug.callback(lambda v, i: ref.append((v, i)), *out)
        return out
    monkeypatch.setattr(JM.jax.lax, "top_k", jtop_k)
    return port, ref


@functools.lru_cache(maxsize=None)
def _jax_params(arch, tt: bool):
    """The reference's seeded init of the reduced ``arch`` (with TT sites
    where ``tt``): neither remat nor quantization changes it, so the twins
    of one file share it (its jit takes ~12 s on jamba)."""
    jcfg, _ = moe_cfgs(arch, tt)
    jlm = JL.build_lm(jcfg)
    return jax.jit(lambda k: JL.init_lm(k, jlm))(jax.random.PRNGKey(0))


def moe_two_steps_match(monkeypatch, arch, tt: bool, remat: str = "none",
                        quant: bool = False, **over):
    """Two train steps (one with ``quant``) of the reduced MoE ``arch``
    against the reference's jitted step: the same kept tokens per expert
    in every MoE layer first, then loss, ce, aux, gnorm and the params."""
    jcfg, tcfg = moe_cfgs(arch, tt, remat, quant, **over)
    jlm, tlm = JL.build_lm(jcfg), TL.build_lm(tcfg)
    sites = [s for _, s in TL._walk_sites(tlm) if s.family == "expert"]
    assert sites and all(s.use_tt == tt for s in sites)
    port, ref = record_selections(monkeypatch, tcfg.moe.num_experts)
    jp = _jax_params(arch, tt)
    kw = dict(total_steps=10, warmup_steps=1)
    jt, tt_ = JTrainConfig(**kw), TrainConfig(**kw)
    js = JS.init_train_state(jp, jt, policy=jcfg.quant.policy())
    jstep = jax.jit(JS.make_train_step(jlm, PLAN, jt))
    ts, tstep = _port(js), TS.make_train_step(tlm, None, tt_)
    # forward-only selections: one a MoE layer in each package, two under
    # remat (the recompute selects again)
    layers = sum(s.ffn_kind == "moe" for s in tlm.period) * tlm.n_periods \
        * (2 if remat == "full" else 1)
    for step in range(1 if quant else 2):
        jb, tb = _batches(jlm.cfg, step)
        del port[:], ref[:]
        js, jm = jstep(js, jb)
        jax.effects_barrier()
        ts, tm = tstep(ts, tb)
        assert len(port) == len(ref) == layers, (len(port), len(ref))
        assert _kept(port) == _kept(ref), f"step {step}: kept tokens differ"
        assert np.isfinite(float(tm["loss"]))
        for k in ("loss", "ce", "aux", "gnorm"):
            assert float(tm[k]) == pytest.approx(
                float(jm[k]), rel=1e-4 if k == "gnorm" else 1e-5), (step, k)
        _params_close(js, ts, atol=1e-3, share=0.999)


def count_moe_launches(monkeypatch):
    """``test_torch_lm_train._count_launches`` with a grouped PE call (Z
    with the leading expert axis) counted as ``<kind>_grouped``, the
    kernels' counter's name for it, and the row fake-quant's launches (one
    a call: a stacked core under its E steps)."""
    counts = _count_launches(monkeypatch)
    for mod, name, dims in ((ttm_pe1, "pe1", 4), (ttm_pe2, "pe2", 4),
                            (ttm_pe3, "pe3", 3)):
        fn = getattr(mod, f"{name}_torch")

        def rekeyed(z, *a, _fn=fn, _name=name, _dims=dims, **k):
            out = _fn(z, *a, **k)       # counts one _name
            if z.dim() == _dims:
                counts[_name] -= 1
                key = f"{_name}_grouped"
                counts[key] = counts.get(key, 0) + 1
            return out
        monkeypatch.setattr(mod, f"{name}_torch", rekeyed)
    rows = CB.fake_quant_rows

    def fq_rows(*a, **k):
        counts["p2_fq_rows"] = counts.get("p2_fq_rows", 0) + 1
        return rows(*a, **k)
    monkeypatch.setattr(CB, "fake_quant_rows", fq_rows)
    return counts


def moe_launches_match(monkeypatch, arch, remat: str = "none", **over):
    """``steps.launches_per_step`` is the count of a real step's kernel
    calls with TT experts, int8 moments and the wire: each expert site's
    chains grouped over the experts (its PE launches a site's), one PE3 a
    Ŵ window and d row fake-quant launches a forward."""
    _, tcfg = moe_cfgs(arch, True, remat, **over)
    lm = TL.build_lm(tcfg)
    params = TL.init_lm(torch.Generator().manual_seed(0), lm, device="cpu")
    tt = TrainConfig(total_steps=5, warmup_steps=1, grad_compress=True,
                     opt_state_dtype="int8")
    state = TS.init_train_state(params, tt, policy=tcfg.quant.policy())
    _, tb = _batches(tcfg, 0)
    counts = count_moe_launches(monkeypatch)
    TS.make_train_step(lm, None, tt)(state, tb)
    want = TS.launches_per_step(lm, tt, params)
    assert {k: v for k, v in counts.items() if v} == want
    assert want == TS.launches_per_step(lm, tt)        # from the meta tree
    experts = sum(s.family == "expert" for _, s in TL._walk_sites(lm)) \
        * lm.n_periods
    sites = sum(s.use_tt for _, s in TL._walk_sites(lm)) * lm.n_periods
    assert experts and want["pe3"] == sites - experts
    assert want["pe3_grouped"] == experts        # one Ŵ window each
    fwd = 2 if remat == "full" else 1
    assert want["pe1_grouped"] == experts * (fwd + 1)
    assert want["p2_fq_rows"] == experts * fwd * 3
    return want


def test_dense_experts_two_train_steps_match_jax(monkeypatch):
    moe_two_steps_match(monkeypatch, ARCH, tt=False)


@pytest.mark.parametrize("quant", [False, True])
def test_tt_experts_two_train_steps_match_jax(monkeypatch, quant):
    moe_two_steps_match(monkeypatch, ARCH, tt=True, quant=quant)


def test_launches_per_step_counts_the_step(monkeypatch):
    moe_launches_match(monkeypatch, ARCH)


def test_full_size_params_and_launches():
    """with_tt(moonshot-v1-16b, quantize=True) uncut, from the meta tree:
    1,145,122,368 parameters (a TT expert 50,176 against 2,883,584 dense;
    671 M of the total the untied embedding and head), seven TT sites a
    layer (q, kv, o, the router and the three expert stacks), each expert
    site's chains one launch for all 64 experts and one PE3 (its Ŵ, 64 x
    1408 x 2048, one window)."""
    lm = TL.build_lm(TC.with_tt(TC.get_config(ARCH), quantize=True))
    tree = TL.init_lm(None, lm, device="meta")
    assert sum(t.numel() for _, t in flatten_with_path(tree)) \
        == 1_145_122_368
    gate = lm.period[0].ffn.gate
    assert gate.use_tt and gate.spec.num_params == 50_176
    assert gate.out_dim * gate.in_dim == 2_883_584
    assert tree["layers"][0]["sub_0"]["moe"]["gate"]["core_1"].shape == (
        64, 16, 11, 16, 16)
    want = TS.launches_per_step(lm, TrainConfig(opt_state_dtype="int8",
                                                grad_compress=True))
    sites, experts = 4 * 48, 3 * 48
    assert lm.cfg.remat == "full"
    assert (want["pe1"], want["pe2"], want["pe3"]) == (
        3 * sites, 6 * sites, sites)
    assert (want["pe1_grouped"], want["pe2_grouped"],
            want["pe3_grouped"]) == (3 * experts, 6 * experts, experts)
    assert want["p2_fq_rows"] == 3 * 48 * 2 * 3
