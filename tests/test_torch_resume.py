"""The port's train loop resumes across packages, and its SIGTERM save
resumes exactly; the TT embedding and head sites in a step and its launch
count. Against repro (the JAX reference), on the reference's tiny TT LM
(``test_torch_lm_train.py``'s ``_configs``: 2 layers, d_model 32, every
projection TT, quantization on), f32, f32 moments and the int8 gradient
wire, on the CPU.

- Checkpoints are the reference's files in both directions: the
  reference's ``launch/train.py::train`` writes a periodic save after loop
  step 2 (meta step 2 beside a state that has taken 3 steps) and the
  final one (step 3); ``repro`` writes raw msgpack here (its
  ``zstandard`` patched to None: the port reads no zstd).
- The port's ``train`` resumes each, and its continued losses and state
  match the reference's own continuation from the same file (its
  ``load(like=state)`` and its jitted step on the same batches) within
  ``test_torch_lm_train.py``'s tolerances: loss, ce, prior, gnorm and lr
  within 1e-5 relative on the first step from the file, 1e-4 after it
  (the wire's codes may differ where a value is within roundoff of a code
  boundary, and the next step starts from params that differ by that);
  params within 2e-5 absolute on the first step, and after later steps
  99.9% of their elements within 2e-5 and every one within 2 lr. From
  the periodic save both re-run batch 2 (the reference's rule): the state
  ends one step ahead of the batch count.
- The reference resumes the port's final checkpoint the same way.
- A child process that sends itself SIGTERM from ``on_step`` exits 143
  leaving the emergency save, and a resume from it ends bit for bit where
  an uninterrupted run ends (the child takes the parent's thread count,
  so the CPU's reductions split alike).
- With ``embed`` and ``head`` TT sites: ``steps.launches_per_step`` is the
  count of a real step's kernel calls (``_count_launches``), and one train
  step matches the reference's within the tolerances above.
"""
import os
import shutil
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.ckpt.checkpoint as JCK  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.launch import train as JTR  # noqa: E402
from repro.models import lm as JL  # noqa: E402
from repro_torch.ckpt import checkpoint as TCK  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch import train as TT  # noqa: E402
from repro_torch.models import lm as TL  # noqa: E402

from test_torch_lm_train import (PLAN, _batch, _configs,  # noqa: E402
                                 _count_launches, _port)

SRC = Path(__file__).resolve().parents[1] / "src"
TOTAL = 5                    # the continuations' total_steps
LR = 3e-4


def _tcfgs(ckpt_dir, total=TOTAL, **kw):
    base = dict(total_steps=total, warmup_steps=1, grad_compress=True,
                ckpt_dir=str(ckpt_dir), ckpt_every=2)
    base.update(kw)
    return JTrainConfig(**base), TrainConfig(**base)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's 3-step run (its periodic and final files) and its
    jitted step at ``TOTAL`` steps."""
    jcfg, tcfg = _configs()
    d = tmp_path_factory.mktemp("ref")
    previous = signal.getsignal(signal.SIGTERM)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JCK, "zstandard", None)
        jstate, jlosses = JTR.train(jcfg, "tp", _tcfgs(d, total=3)[0],
                                    batch=2, seq=8, verbose=False)
    signal.signal(signal.SIGTERM, previous)
    assert sorted(os.listdir(d)) == ["step_2.ckpt", "step_3.ckpt"]
    jt = _tcfgs(d)[0]
    jstep = jax.jit(JS.make_train_step(JL.build_lm(jcfg), PLAN, jt))
    return {"dir": d, "jcfg": jcfg, "tcfg": tcfg, "jstate": jstate,
            "jlosses": jlosses, "jstep": jstep,
            "batch": JTR.make_batch_fn(jcfg, 2, 8, 0)}


def _continue_jax(ref, path):
    """The reference's continuation from ``path``: its load and start
    rule, then its jitted step to ``TOTAL``."""
    state, meta = JCK.load(path, like=ref["jstate"])
    metrics = []
    for step in range(int(meta["step"]), TOTAL):
        state, m = ref["jstep"](state, jax.tree.map(jnp.asarray,
                                                    ref["batch"](step)))
        metrics.append(m)
    return state, metrics, int(meta["step"])


def _train_port(ref, ckpt_dir, capsys):
    seen = []
    state, losses = TT.train(ref["tcfg"], "tp", _tcfgs(ckpt_dir)[1],
                             batch=2, seq=8, device="cpu",
                             on_step=lambda i, m: seen.append((i, m)))
    return state, losses, seen, capsys.readouterr().out


def _states_close(jstate, tstate, steps: int):
    got = _port(jstate)
    close = total = 0
    for (p, a), (_, b) in zip(TS.flatten_with_path(got.params),
                              TS.flatten_with_path(tstate.params)):
        if not a.is_floating_point():
            assert torch.equal(a, b), p
            continue
        e = (a - b).abs()
        assert e.max().item() <= (2e-5 if steps == 1 else 2 * LR), \
            (p, e.max().item())
        close += int((e <= 2e-5).sum())
        total += e.numel()
    assert close >= 0.999 * total, (close, total)
    assert int(got.step) == int(tstate.step)
    assert int(got.opt.step) == int(tstate.opt.step)


def _bits_equal(a, b):
    fa, fb = TCK._flatten(a), TCK._flatten(b)
    assert list(fa) == list(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k


def _metrics_close(jms, seen):
    assert len(jms) == len(seen)
    for i, (jm, (_, tm)) in enumerate(zip(jms, seen)):
        for k in ("loss", "ce", "prior", "gnorm", "lr"):
            assert float(tm[k]) == pytest.approx(
                float(jm[k]), rel=1e-4 if i else 1e-5), (i, k)


@pytest.mark.parametrize("which", ["final", "periodic"])
def test_port_resumes_the_reference_checkpoints(ref, tmp_path, capsys,
                                                which):
    step = 3 if which == "final" else 2
    src = JCK.step_path(str(ref["dir"]), step)
    shutil.copy(src, tmp_path)
    jstate, jms, start = _continue_jax(ref, src)
    assert start == step
    tstate, losses, seen, out = _train_port(ref, tmp_path, capsys)
    assert f"[train] resumed from step {step}" in out
    assert [i for i, _ in seen] == list(range(step, TOTAL))
    assert losses == [float(m["loss"]) for _, m in seen]
    _metrics_close(jms, seen)
    _states_close(jstate, tstate, len(seen))
    # the periodic file's state had taken 3 steps: batch 2 runs again in
    # both packages, so the state ends a step ahead of the batches
    assert int(tstate.step) == TOTAL + (which == "periodic")
    files = sorted(os.listdir(tmp_path))
    assert files == (["step_3.ckpt", "step_4.ckpt", "step_5.ckpt"]
                     if which == "final" else
                     ["step_2.ckpt", "step_4.ckpt", "step_6.ckpt"])


def test_reference_resumes_the_port_checkpoint(ref, tmp_path, capsys):
    _, tt = _tcfgs(tmp_path, total=3)
    first, _ = TT.train(ref["tcfg"], "tp", tt, batch=2, seq=8,
                        device="cpu", verbose=False)
    assert sorted(os.listdir(tmp_path)) == ["step_2.ckpt", "step_3.ckpt"]
    latest = JCK.latest_step(str(tmp_path))
    assert latest == 3
    back, meta = JCK.load(JCK.step_path(str(tmp_path), latest),
                          like=ref["jstate"])
    assert meta == {"final": True, "step": 3}
    _bits_equal(_port(back), first)   # the file holds the port's state
    jstate, jms, start = _continue_jax(
        ref, JCK.step_path(str(tmp_path), latest))
    tstate, _, seen, out = _train_port(ref, tmp_path, capsys)
    assert "[train] resumed from step 3" in out and start == 3
    _metrics_close(jms, seen)
    _states_close(jstate, tstate, len(seen))


_CHILD = """
import os, signal
import torch
torch.set_num_threads({threads})
from repro_torch.configs.base import *
from repro_torch.launch.train import train
cfg = {cfg!r}
tt = TrainConfig(total_steps=4, warmup_steps=1, grad_compress=True,
                 ckpt_dir={ckpt!r}, ckpt_every=2)

def on_step(i, m):
    if i == 2:
        os.kill(os.getpid(), signal.SIGTERM)

train(cfg, "tp", tt, batch=2, seq=8, device="cpu", verbose=False,
      on_step=on_step)
"""


def test_sigterm_emergency_save_resumes_bit_for_bit(tmp_path):
    _, tcfg = _configs()
    cut, whole = tmp_path / "cut", tmp_path / "whole"
    code = _CHILD.format(threads=torch.get_num_threads(), cfg=tcfg,
                         ckpt=str(cut))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert proc.returncode == 143, proc.stderr[-2000:]
    # the signal came in on_step after step 2, before its periodic save
    assert sorted(os.listdir(cut)) == ["step_3.ckpt"]
    _, meta = TCK.load(TCK.step_path(str(cut), 3))
    assert meta == {"emergency": True, "step": 3}
    tt = dict(total_steps=4, warmup_steps=1, grad_compress=True,
              ckpt_every=2)
    resumed, losses = TT.train(tcfg, "tp", TrainConfig(ckpt_dir=str(cut),
                                                       **tt),
                               batch=2, seq=8, device="cpu", verbose=False)
    assert len(losses) == 1
    ref_state, ref_losses = TT.train(
        tcfg, "tp", TrainConfig(ckpt_dir=str(whole), **tt), batch=2, seq=8,
        device="cpu", verbose=False)
    assert losses == ref_losses[3:]
    _bits_equal(resumed, ref_state)
    # both final files hold the same state under the same meta
    assert (cut / "step_4.ckpt").read_bytes() == \
        (whole / "step_4.ckpt").read_bytes()


def test_two_runs_do_not_see_each_other(tmp_path):
    """Each call reads only its own ``ckpt_dir``: a second config in the
    same process starts fresh from its own directory."""
    _, small = _configs()
    _, wide = _configs(d_model=64)
    a, _ = TT.train(small, "tp", TrainConfig(
        total_steps=1, warmup_steps=1, ckpt_dir=str(tmp_path / "a")),
        batch=2, seq=8, device="cpu", verbose=False)
    b, losses = TT.train(wide, "tp", TrainConfig(
        total_steps=1, warmup_steps=1, ckpt_dir=str(tmp_path / "b")),
        batch=2, seq=8, device="cpu", verbose=False)
    assert len(losses) == 1 and int(a.step) == int(b.step) == 1
    assert os.listdir(tmp_path / "a") == os.listdir(tmp_path / "b") == \
        ["step_1.ckpt"]


def test_resume_refuses_a_checkpoint_of_more_layers(tmp_path):
    """A 2-layer run's checkpoint in the directory of a 1-layer config of
    the same widths: the resume raises, it takes no rows of the stacks."""
    _, two = _configs()
    _, one = _configs(num_layers=1)
    TT.train(two, "tp", TrainConfig(total_steps=1, warmup_steps=1,
                                    ckpt_dir=str(tmp_path)),
             batch=2, seq=8, device="cpu", verbose=False)
    with pytest.raises(ValueError, match="shape"):
        TT.train(one, "tp", TrainConfig(total_steps=2, warmup_steps=1,
                                        ckpt_dir=str(tmp_path)),
                 batch=2, seq=8, device="cpu", verbose=False)


# ---------------------------------------------------------------------------
# TT embedding and head sites
# ---------------------------------------------------------------------------

_EH = ("ffn", "attn_qkv", "attn_o", "embed", "head")


@pytest.mark.parametrize("remat", ["full", "none"])
def test_launches_per_step_counts_embed_and_head_sites(monkeypatch, remat):
    _, tcfg = _configs(apply_to=_EH, vocab_size=128, remat=remat)
    lm = TL.build_lm(tcfg)
    assert lm.embed.use_tt and lm.head.use_tt
    params = TL.init_lm(torch.Generator().manual_seed(0), lm, device="cpu")
    tt = TrainConfig(total_steps=5, warmup_steps=1, grad_compress=True,
                     opt_state_dtype="int8")
    state = TS.init_train_state(params, tt, policy=tcfg.quant.policy())
    step = TS.make_train_step(lm, None, tt)
    tok = np.random.default_rng(0).integers(0, 128, (2, 16)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tok),
             "labels": torch.from_numpy(np.roll(tok, -1, axis=1))}
    counts = _count_launches(monkeypatch)
    step(state, batch)
    want = TS.launches_per_step(lm, tt, params)
    assert counts == want
    assert want == TS.launches_per_step(lm, tt)       # from the meta tree
    fwd = 2 if remat == "full" else 1
    # 12 layer sites (d = 3) and the head: its chain once, outside remat
    assert want["pe1"] == 12 * (fwd + 1) + 2 and want["pe3"] == 12 + 1
    assert want["pe2"] == 2 * want["pe1"]
    # the layer sites', the embedding's and the head's core groups, the
    # activation edges, the grad edge
    assert want["p2_fake_quant"] == 12 * fwd + 1 + 1 + 2 + 2 * (fwd + 1) + 2


def test_train_step_with_embed_and_head_sites_matches_jax():
    jcfg, tcfg = _configs(apply_to=_EH, vocab_size=128)
    jlm = JL.build_lm(jcfg)
    assert jlm.embed.use_tt and jlm.head.use_tt
    jp = JL.init_lm(jax.random.PRNGKey(3), jlm)
    tlm = TL.build_lm(tcfg)
    jt, tt = JTrainConfig(total_steps=5, warmup_steps=1), \
        TrainConfig(total_steps=5, warmup_steps=1)
    js = JS.init_train_state(jp, jt, policy=jcfg.quant.policy())
    ts = _port(js)
    jb, tb = _batch(vocab=128)
    js, jm = jax.jit(JS.make_train_step(jlm, PLAN, jt))(js, jb)
    ts, tm = TS.make_train_step(tlm, None, tt)(ts, tb)
    _metrics_close([jm], [(0, tm)])
    _states_close(js, ts, 1)
