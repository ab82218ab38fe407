"""repro_torch's train step on jamba-1.5-large with its experts (16 top-2
at full size, the MoE FFN on every other layer) against repro (the JAX
reference), with dense and with TT experts: the Mamba scans beside the
MoE dispatch, on ``test_torch_zoo_train_moe.py``'s helpers and
tolerances. The dense-FFN twin is ``test_torch_zoo_train_jamba.py``.

Reduced (two periods of Mamba, attention, Mamba, Mamba; experts at
positions 1 and 3), float32, ``remat="none"``, the 16-token batch in one
scan chunk (the dense-FFN twin holds the chunk remat and "full"): two
steps each against the reference's jitted step (the quantized TT expert
step is the moonshot and deepseek twins'), the kept (expert, token)
pairs first, then loss, ce, aux, gnorm and the params;
``steps.launches_per_step`` against a real step's kernel calls; and the
chip's cell (one period of 3 layers at full width, the MoE FFN at
position 1) from the meta tree.
"""
import pytest

torch = pytest.importorskip("torch")

import repro_torch.configs as TC  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.core.ttm import what_windows  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import lm as TL  # noqa: E402
from repro_torch.tree import flatten_with_path  # noqa: E402

from test_torch_zoo_train_moe import (moe_launches_match,  # noqa: E402
                                      moe_two_steps_match)

ARCH = "jamba-1.5-large"


@pytest.mark.parametrize("tt", [False, True])
def test_two_train_steps_match_jax(monkeypatch, tt):
    moe_two_steps_match(monkeypatch, ARCH, tt=tt)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_launches_per_step_counts_the_step(monkeypatch, remat):
    moe_launches_match(monkeypatch, ARCH, remat)


def test_full_width_period_with_experts():
    """The chip's cell: with_tt(jamba-1.5-large, quantize=True) at d_model
    8,192, one period of 3 layers (Mamba, attention, Mamba) with the MoE
    FFN (16 experts top-2, d_ff 24,576, TT) at position 1 in place of its
    dense FFN: the parameters, the expert Ŵ (16 x 24,576 x 8,192) in
    eight PE3 windows of two experts, the launches."""
    cfg = TC.get_config(ARCH).replace(num_layers=3, period=3,
                                      attn_positions=(1,), moe_positions=(1,))
    lm = TL.build_lm(TC.with_tt(cfg, quantize=True))
    kinds = [(s.mixer_kind, s.ffn_kind) for s in lm.period]
    assert kinds == [("mamba", "ffn"), ("attn_gqa", "moe"), ("mamba", "ffn")]
    tree = TL.init_lm(None, lm, device="meta")
    n = sum(t.numel() for _, t in flatten_with_path(tree))
    gate = lm.period[1].ffn.gate
    assert gate.use_tt and (gate.out_dim, gate.in_dim) == (24576, 8192)
    assert len(what_windows(gate.spec, 16)) == 8
    want = TS.launches_per_step(lm, TrainConfig(opt_state_dtype="int8",
                                                grad_compress=True))
    # TT: q, kv, o; two dense FFNs of three; the router and three stacks
    sites = 3 + 6 + 1 + 3
    assert (want["pe1"], want["pe3"]) == (3 * (sites - 3), sites - 3)
    assert (want["pe1_grouped"], want["pe3_grouped"]) == (3 * 3, 3 * 8)
    assert want["p2_fq_rows"] == 3 * 2 * 3
    assert n == 1_923_017_198       # 6.9 M more than the dense-FFN cell
