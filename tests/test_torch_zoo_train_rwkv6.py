"""repro_torch's train step on rwkv6-1.6b against repro (the JAX
reference): ``test_torch_zoo_train.py``'s twin of ``tests/test_models.py::
test_reduced_train_step`` on the RWKV6 recurrence, on its helpers and
tolerances.

Reduced, float32, under ``remat`` "none" and "full", with ``SCAN_CHUNK``
patched to 4 in both packages so the 16-token batch runs the scans' chunk
remat (four chunks, nested in the layer's checkpoint under "full"): two
steps, each against the reference's (loss and ce within 1e-5 relative,
gnorm 1e-4, params within 2e-5 absolute).

Then reduced ``with_tt(rwkv6-1.6b, quantize=True)`` (TT on the channel
mix, d = 3, rank 4, ``min_elements`` 1,024) with int8 moments and the int8
wire, one step held as ``test_torch_lm_train.py`` holds its tiny LM's
int8 step; ``steps.launches_per_step`` against a real step's kernel calls,
and at full size; and a recurrent train state saved by
``launch/train.py::train`` and resumed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.ckpt import latest_step, step_path  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch import train as TT  # noqa: E402
from repro_torch.models import lm as TL  # noqa: E402
from repro_torch.tree import flatten_with_path  # noqa: E402

from test_torch_zoo_train import (BATCH, SEQ, _batches, _cfgs,  # noqa: E402
                                  _params_close, _start, full_size_match,
                                  launches_match, patch_scan_chunk,
                                  two_steps_match)

ARCH = "rwkv6-1.6b"


@pytest.fixture(autouse=True)
def _chunk(monkeypatch):
    patch_scan_chunk(monkeypatch)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_two_train_steps_match_jax(remat):
    two_steps_match(ARCH, remat)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_launches_per_step_counts_the_step(monkeypatch, remat):
    """TT on the channel mix (``ffn_k``, ``ffn_v``, ``ffn_r``); the scans'
    chunk recompute runs no TT site."""
    launches_match(monkeypatch, ARCH, remat)


def test_full_size_model_and_launches():
    """The chip's cell: 24 layers, three channel-mix TT sites each."""
    full_size_match(ARCH, 783_921_624, 3 * 24)


def test_tt_rwkv6_int8_step_matches_jax():
    """One step of reduced with_tt(rwkv6-1.6b, quantize=True) with int8
    moments and the int8 wire: loss, ce, prior, gnorm and lr within 1e-5
    relative; params within 1e-3 absolute and 99.9% of the elements within
    2e-5 (a moment within roundoff of a code boundary of its block lands on
    the neighbouring code); the wire's residual within twice the leaf's
    largest residual and 99% of it within 1e-2 of that; the managed
    scales' exponents equal, their statistics within 1e-6 relative."""
    wire = dict(grad_compress=True, opt_state_dtype="int8")
    jlm, js, jstep, tlm, ts, tstep = _start(ARCH, "full", tt=True,
                                            **wire)
    sites = [p for p, s in TL._walk_sites(tlm) if s.use_tt]
    assert {p[-1] for p in sites} == {"ffn_k", "ffn_v", "ffn_r"}
    assert set(ts.scales) == {"activation", "grad_edge"}
    jb, tb = _batches(jlm.cfg, 0)
    js, jm = jstep(js, jb)
    ts, tm = tstep(ts, tb)
    for k in ("loss", "ce", "prior", "gnorm", "lr"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
    got = _params_close(js, ts, atol=1e-3, share=0.999)
    for k in ("activation", "grad_edge"):
        assert int(ts.scales[k].log2) == int(js.scales[k].log2), k
        assert float(ts.scales[k].mean_abs) == pytest.approx(
            float(js.scales[k].mean_abs), rel=1e-6), k
    assert any(r is not None and r.abs().max() > 0 for r in ts.residual)
    close = total = 0
    for a, b in zip(got.residual, ts.residual):
        assert (a is None) == (b is None)
        if a is not None:
            m = a.abs().max().item()
            e = (a - b).abs()
            assert e.max().item() <= 2.002 * m + 1e-7
            close += int((e <= 1e-2 * m).sum())
            total += a.numel()
    assert close >= 0.99 * total, (close, total)


def test_recurrent_train_state_saves_and_resumes(tmp_path):
    """``train`` on reduced with_tt(rwkv6-1.6b, quantize=True) (int8
    moments, the wire) saves its final state; the file loads back bit for
    bit, and a resume to one more step runs only that step and equals the
    train step applied to the loaded state."""
    _, tcfg = _cfgs(ARCH, "full", tt=True)
    kw = dict(warmup_steps=1, grad_compress=True, opt_state_dtype="int8",
              ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=100)
    first, _ = TT.train(tcfg, "tp", TrainConfig(total_steps=2, **kw),
                        batch=BATCH, seq=SEQ, device="cpu", verbose=False)
    assert latest_step(kw["ckpt_dir"]) == 2
    loaded, meta = TS.load_state(step_path(kw["ckpt_dir"], 2), first)
    assert meta.get("final") and int(loaded.step) == 2
    for (p, a), (_, b) in zip(flatten_with_path(first),
                              flatten_with_path(loaded)):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), p
    wkv = [p for p, _ in flatten_with_path(loaded.params) if "w0" in p]
    assert len(wkv) == tcfg.num_layers
    t3 = TrainConfig(total_steps=3, **kw)
    seen = []
    resumed, losses = TT.train(tcfg, "tp", t3, batch=BATCH, seq=SEQ,
                               device="cpu", verbose=False,
                               on_step=lambda i, m: seen.append(i))
    assert seen == [2] and len(losses) == 1 and int(resumed.step) == 3
    want, _ = TS.make_train_step(TL.build_lm(tcfg), None, t3)(
        loaded, {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
                 TT.make_batch_fn(tcfg, BATCH, SEQ, t3.seed)(2).items()})
    for (p, a), (_, b) in zip(flatten_with_path(resumed),
                              flatten_with_path(want)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), p
