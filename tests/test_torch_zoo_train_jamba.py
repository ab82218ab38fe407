"""repro_torch's train step on jamba-1.5-large with dense FFNs against
repro (the JAX reference): ``test_torch_zoo_train.py``'s twin of
``tests/test_models.py::test_reduced_train_step`` on the Mamba selective
scan beside attention, on its helpers and tolerances. Its experts:
``test_torch_zoo_train_jamba_moe.py``.

Reduced (two periods of Mamba, attention, Mamba, Mamba), float32, under
``remat`` "none" and "full", with ``SCAN_CHUNK`` patched to 4 in both
packages so the 16-token batch runs the scans' chunk remat: two steps, each
against the reference's (loss and ce within 1e-5 relative, gnorm 1e-4,
params within 2e-5 absolute); ``steps.launches_per_step`` against a real
step's kernel calls with TT sites on the attention and the FFNs (an
activation edge after every sublayer of the period), and at full width
(the chip's 3-layer period and the config's 8-layer one).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import MoEConfig  # noqa: E402

from test_torch_zoo_train import (full_size_match,  # noqa: E402
                                  launches_match, patch_scan_chunk,
                                  two_steps_match)

ARCH = "jamba-1.5-large"


@pytest.fixture(autouse=True)
def _chunk(monkeypatch):
    patch_scan_chunk(monkeypatch)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_two_train_steps_match_jax(remat):
    two_steps_match(ARCH, remat)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_launches_per_step_counts_the_step(monkeypatch, remat):
    launches_match(monkeypatch, ARCH, remat)


@pytest.mark.parametrize("layers,attn,params", [
    (3, 1, 1_916_092_836), (8, 4, 4_020_136_881)])
def test_full_width_period_and_launches(layers, attn, params):
    """At d_model 8,192 with dense FFNs: the chip's cell, one period of 3
    layers (Mamba, attention, Mamba), and the config's period of 8 (7
    Mamba, attention at position 4), whose step does not fit one card; TT
    on gate, up and down of each FFN and the attention's q, kv and o."""
    full_size_match(ARCH, params, layers * 3 + 3, num_layers=layers,
                    period=layers, attn_positions=(attn,),
                    moe=MoEConfig(num_experts=0))
