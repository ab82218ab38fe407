"""NumericsPolicy: named quantization sites -> QuantSpec, plus the §3.3
scale manager that owns every *managed* pow-2 scale — the port of
``repro/numerics/policy.py``.

Site names (``SITES``): ``tt_factor`` (TT cores, 4-bit pow2, fixed scales),
``activation`` (8-bit pow2, managed), ``grad_edge`` (16-bit pow2, managed),
``optimizer_moment`` (Adam m/v, blockwise int8, block 256), ``dp_wire``
(the gradient wire, blockwise int8, block 1024, error feedback in
``optim/grad_compress.py``), ``kv_cache`` and ``ssm_state`` (8-bit pow2,
per-tensor-max scale).

The policy's JSON is ``repro``'s, byte for byte: either package reads what
the other writes.

Every managed pow-2 scale is a ``ScaleState``; the manager nudges its
exponent to keep the tracked mean |x / 2^k| inside a target band. All
updates are device tensor ops (no host sync), so a training step that runs
them stays asynchronous.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import NamedTuple

import torch

from .spec import QuantSpec, spec_nbytes

SITES = ("tt_factor", "activation", "grad_edge", "optimizer_moment",
         "dp_wire", "kv_cache", "ssm_state")


class ScaleState(NamedTuple):
    """Per-site dynamic pow-2 scale: k (log2 scale) and the tracked mean
    |x / 2^k| the manager drives into the target band."""
    log2: torch.Tensor       # int32 scalar
    mean_abs: torch.Tensor   # f32 scalar, EMA of mean |x| / 2^k


def init_scale(log2: int = 0, device=None) -> ScaleState:
    return ScaleState(torch.tensor(log2, dtype=torch.int32, device=device),
                      torch.tensor(0.2, dtype=torch.float32, device=device))


def _bump(log2: torch.Tensor, m: torch.Tensor, lo: float,
          hi: float) -> ScaleState:
    """k+1 when m is above the band, k-1 when below; m follows the bump."""
    up = (m > hi).to(torch.int32)        # too large -> coarser scale (k+1)
    dn = (m < lo).to(torch.int32)        # too small -> finer scale (k-1)
    # after a bump the tracked statistic halves/doubles accordingly
    return ScaleState(log2 + up - dn,
                      m * torch.exp2(-(up - dn).to(torch.float32)))


def update_scale(state: ScaleState, x: torch.Tensor, *, lo: float = 0.1,
                 hi: float = 0.3, ema: float = 0.9) -> ScaleState:
    """Track mean|x/2^k| and adjust k to hold it in [lo, hi] (paper
    §3.3). Reads ``x`` without gradient."""
    x = x.detach().float()
    m = torch.mean(torch.abs(x)) / torch.exp2(state.log2.float())
    m = ema * state.mean_abs + (1.0 - ema) * m
    return _bump(state.log2, m, lo, hi)


def update_from_stat(state: ScaleState, stat: torch.Tensor, *, lo: float,
                     hi: float, ema: float) -> ScaleState:
    """The same update from an already-normalised statistic (the probe
    cotangent mean|g|/2^k of a gradient edge)."""
    m = ema * state.mean_abs + (1.0 - ema) * stat
    return _bump(state.log2, m, lo, hi)


def step_log2(state: ScaleState, bits: int) -> torch.Tensor:
    """Grid step exponent of a managed scale: the representable range
    [-2^{b-1}, 2^{b-1}-1] * 2^{k-(b-1)} then covers ~2^k."""
    return state.log2.float() - (bits - 1)


# ---------------------------------------------------------------------------
# Policy
# ---------------------------------------------------------------------------

def _default_sites(weight_bits: int = 4, act_bits: int = 8,
                   grad_bits: int = 16) -> tuple[tuple[str, QuantSpec], ...]:
    return (
        ("tt_factor", QuantSpec("pow2", weight_bits, 0, "int8", "fixed")),
        ("activation", QuantSpec("pow2", act_bits, 0, "int8", "managed")),
        ("grad_edge", QuantSpec("pow2", grad_bits, 0, "int16", "managed")),
        ("optimizer_moment",
         QuantSpec("blockwise", 8, 256, "int8", "per_tensor_max")),
        ("dp_wire", QuantSpec("blockwise", 8, 1024, "int8", "per_tensor_max")),
        ("kv_cache", QuantSpec("pow2", 8, 0, "int8", "per_tensor_max")),
        ("ssm_state", QuantSpec("pow2", 8, 0, "int8", "per_tensor_max")),
    )


@dataclass(frozen=True)
class NumericsPolicy:
    """Frozen site -> QuantSpec map + scale-manager knobs."""
    enable: bool = False
    sites: tuple[tuple[str, QuantSpec], ...] = _default_sites()
    # scale manager (§3.3): keep mean |x/2^k| within [lo, hi]
    target_lo: float = 0.1
    target_hi: float = 0.3
    ema: float = 0.9
    # quant-health telemetry (repro_torch.obs): the engine's decode step
    # and the train step count clipped / saturated codes when set
    health: bool = False

    def spec_for(self, site: str) -> QuantSpec:
        for name, spec in self.sites:
            if name == site:
                return spec
        raise KeyError(f"unknown numerics site {site!r}; "
                       f"known: {[n for n, _ in self.sites]}")

    def nbytes(self, site: str, shape: tuple[int, ...]) -> int:
        """Analytic resident bytes of a ``shape`` tensor at ``site`` (codes
        + scale metadata; packed storage at two codes per byte)."""
        return spec_nbytes(self.spec_for(site), tuple(shape))

    def with_spec(self, site: str, spec: QuantSpec) -> "NumericsPolicy":
        if site not in [n for n, _ in self.sites]:
            raise KeyError(site)
        new = tuple((n, spec if n == site else s) for n, s in self.sites)
        return dataclasses.replace(self, sites=new)

    def managed_sites(self) -> tuple[str, ...]:
        return tuple(n for n, s in self.sites if s.scale_policy == "managed")

    def init_scales(self, device=None) -> dict[str, ScaleState]:
        """One ScaleState per managed site: the scale-state tree threaded
        through ``TrainState.scales``."""
        return {n: init_scale(0, device) for n in self.managed_sites()}

    def update_scales(self, scales: dict, observed: dict) -> dict:
        """Scale-manager step for every observed site. ``observed`` maps
        site name -> tensor whose magnitude statistic to track."""
        out = dict(scales)
        for name, x in observed.items():
            if name in out:
                out[name] = update_scale(out[name], x, lo=self.target_lo,
                                         hi=self.target_hi, ema=self.ema)
        return out

    def to_json_dict(self) -> dict:
        return {
            "enable": self.enable,
            "sites": {n: s.to_json_dict() for n, s in self.sites},
            "target_lo": self.target_lo,
            "target_hi": self.target_hi,
            "ema": self.ema,
            "health": self.health,
        }

    @classmethod
    def from_json_dict(cls, d: dict) -> "NumericsPolicy":
        sites = tuple((n, QuantSpec.from_json_dict(s))
                      for n, s in d["sites"].items())
        return cls(enable=d["enable"], sites=sites,
                   target_lo=d.get("target_lo", 0.1),
                   target_hi=d.get("target_hi", 0.3),
                   ema=d.get("ema", 0.9),
                   health=d.get("health", False))

    def to_json(self) -> str:
        # no sort_keys: the sites map is ordered and the order is identity
        return json.dumps(self.to_json_dict(), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "NumericsPolicy":
        return cls.from_json_dict(json.loads(s))


def policy_from_quant_config(qc) -> NumericsPolicy:
    """``configs.base.QuantConfig`` (the paper-era knob set) lowered onto
    the policy."""
    return NumericsPolicy(
        enable=qc.enable,
        sites=_default_sites(qc.weight_bits, qc.act_bits, qc.grad_bits),
        target_lo=qc.target_lo, target_hi=qc.target_hi, ema=qc.ema,
        health=qc.health)
