"""repro_torch's train step on deepseek-v2-236b (MLA attention, 160 routed
experts top-6 and 2 shared at full size) against repro (the JAX
reference): the first port test that trains MLA (its per-head prefill
path under autograd) and the shared experts, with dense and with TT
experts, on ``test_torch_zoo_train_moe.py``'s helpers and tolerances.

Reduced (2 layers, 8 experts top-2, 1 shared), float32, ``remat``
"none" and, with TT experts and quantization, "full": two steps (one
quantized) each against the reference's jitted step, the kept (expert,
token) pairs first, then loss, ce, aux, gnorm (1e-5 / 1e-4 relative) and
the params (the moonshot twin's tolerances);
``steps.launches_per_step`` against a real step's kernel calls; and
with_tt at full width, cut to 2 of its 60 layers (the chip's cell), from
the meta tree.
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

ARCH = "deepseek-v2-236b"


@pytest.mark.parametrize("tt,remat,quant", [
    (False, "none", False), (True, "none", False), (True, "full", True)])
def test_two_train_steps_match_jax(monkeypatch, tt, remat, quant):
    moe_two_steps_match(monkeypatch, ARCH, tt=tt, remat=remat, quant=quant)


def test_launches_per_step_counts_the_step(monkeypatch):
    want = moe_launches_match(monkeypatch, ARCH)
    # per layer (reduced): five MLA projections over ``min_elements``, the
    # router and three shared sites, each one chain forward and one
    # transposed; the three expert stacks grouped
    assert (want["pe1"], want["pe1_grouped"]) == (2 * 9 * 2, 2 * 3 * 2)


def test_full_width_two_layers_params_and_launches():
    """with_tt(deepseek-v2-236b, quantize=True) at full width, 2 of its 60
    layers: 1,104,183,292 parameters (1.05 B of them the embedding and
    head), thirteen TT sites a layer, each expert site's Ŵ (160 x 1536 x
    5120) in three PE3 windows of at most 68 experts."""
    cfg = TC.get_config(ARCH).replace(num_layers=2)
    lm = TL.build_lm(TC.with_tt(cfg, quantize=True))
    tree = TL.init_lm(None, lm, device="meta")
    assert sum(t.numel() for _, t in flatten_with_path(tree)) \
        == 1_104_183_292
    gate = lm.period[0].ffn.gate
    assert [len(w) for w in [what_windows(gate.spec, 160)]] == [3]
    assert what_windows(gate.spec, 160) == [(0, 68), (68, 136), (136, 160)]
    want = TS.launches_per_step(lm, TrainConfig(opt_state_dtype="int8",
                                                grad_compress=True))
    assert (want["pe1"], want["pe3"]) == (3 * 10 * 2, 10 * 2)
    assert (want["pe1_grouped"], want["pe3_grouped"]) == (3 * 3 * 2,
                                                          3 * 3 * 2)
    assert want["p2_fq_rows"] == 3 * 2 * 2 * 3
