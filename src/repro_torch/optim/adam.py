"""AdamW with f32 or block-wise int8 first/second moments — the port of
``repro/optim/adam.py``.

The int8 state (``opt_state_dtype="int8"``) is the ``optimizer_moment``
site: each moment is a blockwise-int8 ``QTensor`` at ``MOMENT_SPEC``
(block 256 along the last axis, shape-preserving), decoded before the
update and encoded after it through the ``cuda`` codec — one group launch
of the ``bw_dec`` kernel for every m and v the step updates and one of the
``bw_enc`` kernel for the same set on the card (the encoded moments are
then views into one codes and one scales buffer, the decoded ones into one
f32 buffer), their plain versions on CPU tensors.

Leaf rule (``repro``'s ``_is_adam_leaf``, kept exactly): every floating
leaf except ``lambda_*`` (closed-form Eq. 4 update) and ``wscale*`` gets
moments. On the TT MLP that includes the ``ActQuant`` leaves
``q_*/.act/.mean_abs``, ``q_*/.grad/.mean_abs`` and ``q_*/.probe``: the
probes move (their gradient is the scale manager's statistic), the
``mean_abs`` leaves take no gradient and stay put.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..configs.base import TrainConfig
from ..numerics import QTensor, QuantSpec, decode_many, encode_many
from ..numerics.codecs import blockwise_geometry
from ..tree import flatten_with_path, leaves, unflatten

# the optimizer_moment spec (NumericsPolicy default): blockwise int8 along
# the last axis
MOMENT_SPEC = QuantSpec("blockwise", 8, 256, "int8", "per_tensor_max")
OPT_STATE_DTYPES = ("float32", "int8")


def _is_adam_leaf(path: str, leaf) -> bool:
    if not isinstance(leaf, torch.Tensor) or not leaf.is_floating_point():
        return False
    name = path.split("/")[-1]
    return not name.startswith(("lambda_", "wscale"))


def _stacked_dim(path: str, leaf: torch.Tensor) -> int:
    """The rank of the reference's leaf, which decides its weight decay: a
    leaf of a list (the LM's layers) is stacked on a new axis 0 there
    (``tree.stack_key``), so rwkv6's ``w0`` and Mamba's ``D`` decay."""
    return leaf.dim() + any(k.isdigit() for k in path.split("/"))


def _int8(cfg: TrainConfig) -> bool:
    if cfg.opt_state_dtype not in OPT_STATE_DTYPES:
        raise ValueError(f"opt_state_dtype={cfg.opt_state_dtype!r}; one of "
                         f"{OPT_STATE_DTYPES}")
    return cfg.opt_state_dtype == "int8"


def _q8_init(x: torch.Tensor) -> QTensor:
    shape = tuple(x.shape) if x.dim() > 0 else (1,)
    b, nb, _ = blockwise_geometry(MOMENT_SPEC, shape[-1])
    return QTensor(torch.zeros(shape[:-1] + (nb * b,), dtype=torch.int8,
                               device=x.device),
                   torch.zeros(shape[:-1] + (nb,), dtype=torch.float32,
                               device=x.device),
                   MOMENT_SPEC, shape)


class AdamState(NamedTuple):
    """Moments as tuples aligned with the flattened params tree (element
    = None | f32 tensor | blockwise-int8 ``QTensor``)."""
    step: torch.Tensor
    m: tuple
    v: tuple


def adam_leaf_paths(params) -> list[str]:
    """Paths of the leaves that get moments (and so a gradient)."""
    return [p for p, leaf in flatten_with_path(params)
            if _is_adam_leaf(p, leaf)]


def init_adam(params, cfg: TrainConfig) -> AdamState:
    int8 = _int8(cfg)
    flat = flatten_with_path(params)
    m = tuple((_q8_init(leaf) if int8 else
               torch.zeros(leaf.shape, dtype=torch.float32,
                           device=leaf.device))
              if _is_adam_leaf(p, leaf) else None for p, leaf in flat)
    v = tuple(None if t is None else
              QTensor(t.codes.clone(), t.scale.clone(), t.spec, t.shape)
              if int8 else t.clone() for t in m)
    device = next(leaf.device for p, leaf in flat if _is_adam_leaf(p, leaf))
    return AdamState(torch.zeros((), dtype=torch.int32, device=device), m, v)


@torch.no_grad()
def adam_update(params, grads, state: AdamState, lr, cfg: TrainConfig):
    """Returns (new_params, new_state). ``grads`` mirrors ``params``; a
    ``None`` gradient leaves its parameter and moments unchanged (the
    zero-gradient update of a ``mean_abs`` leaf is the identity). With int8
    moments every m and v the step updates is decoded in one
    ``decode_many`` (the m's, then the v's) and encoded in one
    ``encode_many``."""
    int8 = _int8(cfg)
    b1, b2, eps, wd = cfg.beta1, cfg.beta2, cfg.eps, cfg.weight_decay
    step = state.step + 1
    c1 = 1.0 - torch.pow(b1, step.float())
    c2 = 1.0 - torch.pow(b2, step.float())
    grads = leaves(grads)
    live = [i for i, (m, g) in enumerate(zip(state.m, grads))
            if m is not None and g is not None]
    if int8:
        dec = decode_many([state.m[i] for i in live]
                          + [state.v[i] for i in live], torch.float32,
                          backend="cuda")
        m_in = dict(zip(live, dec))
        v_in = dict(zip(live, dec[len(live):]))
    else:
        m_in, v_in = state.m, state.v
    new_p, new_m, new_v, moved = [], [], [], []
    for i, ((path, p), g, m, v) in enumerate(zip(
            flatten_with_path(params), grads, state.m, state.v)):
        if m is None or g is None:
            new_p.append(p)
            new_m.append(m)
            new_v.append(v)
            continue
        g32 = g.float()
        m32 = m_in[i].reshape(p.shape)
        v32 = v_in[i].reshape(p.shape)
        m32 = b1 * m32 + (1 - b1) * g32
        v32 = b2 * v32 + (1 - b2) * torch.square(g32)
        update = (m32 / c1) / (torch.sqrt(v32 / c2) + eps)
        name = path.split("/")[-1]
        decay = (0.0 if name in ("scale", "b", "bias")
                 or _stacked_dim(path, p) < 2 else wd)
        p32 = p.float()
        p32 = p32 - lr * (update + decay * p32)
        new_p.append(p32.to(p.dtype))
        moved.append(len(new_m))
        new_m.append(m32)
        new_v.append(v32)
    if int8 and moved:
        qs = encode_many([new_m[i] for i in moved] + [new_v[i] for i in moved],
                         MOMENT_SPEC, backend="cuda")
        for k, i in enumerate(moved):
            new_m[i], new_v[i] = qs[k], qs[len(moved) + k]
    return (unflatten(params, new_p),
            AdamState(step, tuple(new_m), tuple(new_v)))


def moment_nbytes(state: AdamState) -> tuple[int, int]:
    """(resident, fp32-shadow) bytes of the optimizer moments: QTensor
    moments count codes + block scales as stored; the shadow is what the
    same moments would cost as two f32 tensors per tracked leaf."""
    resident = fp32 = 0
    for mm in (*state.m, *state.v):
        if mm is None:
            continue
        if isinstance(mm, QTensor):
            resident += mm.nbytes()
            fp32 += 4 * math.prod(mm.shape)
        else:
            resident += mm.numel() * mm.element_size()
            fp32 += 4 * mm.numel()
    return resident, fp32


def _is_float(g) -> bool:
    return isinstance(g, torch.Tensor) and g.is_floating_point()


def global_norm(grads) -> torch.Tensor:
    """sqrt(sum of every floating leaf's squared f32 values + 1e-20)."""
    sq = [torch.sum(torch.square(g.float())) for g in leaves(grads)
          if _is_float(g)]
    return torch.sqrt(torch.stack(sq).sum() + 1e-20)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / norm), norm): every floating leaf
    times one f32 factor, back in its dtype; other leaves as they are."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / gn, max=1.0)
    return unflatten(grads, [(g * scale).to(g.dtype) if _is_float(g) else g
                             for g in leaves(grads)]), gn
