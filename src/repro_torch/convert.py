"""The one bridge between the two packages: a ``repro`` parameter tree,
already turned into numpy arrays, becomes a ``repro_torch`` tree.

``params_from_jax`` takes a zoo LM: the reference stacks every per-layer
leaf on axis 0 (``params["layers"]``, consumed by ``lax.scan``); the port
keeps one dict per layer, so this unstacks them. ``mlp_params_from_jax``
takes the paper's TT MLP, whose ``ActQuant``/``ScaleState`` nodes arrive as
``repro``'s NamedTuples and are matched by their ``_fields``. Everything
else maps key for key. ``adam_state_from_jax`` and ``residual_from_jax``
carry the optimizer moments (f32, or blockwise-int8 ``QTensor``s) and the
gradient wire's error-feedback residual, so both packages can step from
one state; ``lm_train_state_from_jax`` carries a zoo LM's whole
``TrainState``, re-ordering the moments and the residual from the
reference's stacked leaves to the port's per-layer ones. bf16 arrays (numpy's ``ml_dtypes.bfloat16``) are
carried bit for bit.

Nothing here imports JAX: callers convert with ``jax.tree.map(np.asarray,
params)`` first. Parity tests use this to run both packages on the same
weights, since a JAX and a torch init of one seed draw different numbers.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.quant import ActQuant
from .device import resolve_device
from .numerics.policy import ScaleState
from .numerics.spec import QTensor, QuantSpec
from .optim.adam import AdamState

# repro's NamedTuple node types, by their fields -> the port's
_NAMEDTUPLES = {ActQuant._fields: ActQuant, ScaleState._fields: ScaleState}


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()
                             ).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def _map(node, fn):
    if isinstance(node, dict):
        return {k: _map(v, fn) for k, v in node.items()}
    return fn(node)


def params_from_jax(tree: dict, device=None) -> dict:
    """numpy tree of ``repro.models.init_lm`` -> ``repro_torch`` params on
    ``device`` (default ``"cuda"``; pass ``"cpu"`` explicitly off the card)."""
    device = resolve_device(device)
    out = {k: _map(v, lambda a: _tensor(a, device))
           for k, v in tree.items() if k != "layers"}
    leaves = []
    _map(tree["layers"], leaves.append)
    n_layers = np.asarray(leaves[0]).shape[0]
    out["layers"] = [_map(tree["layers"],
                          lambda a, i=i: _tensor(np.asarray(a)[i], device))
                     for i in range(n_layers)]
    return out


def mlp_params_from_jax(tree: dict, device=None) -> dict:
    """numpy tree of ``repro.models.mlp_tt.init_mlp`` (or of a trained
    step's params) -> ``repro_torch`` params on ``device`` (default
    ``"cuda"``; pass ``"cpu"`` explicitly off the card)."""
    device = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        fields = getattr(node, "_fields", None)
        if fields is not None:
            if fields not in _NAMEDTUPLES:
                raise TypeError(f"no port type for a NamedTuple with fields "
                                f"{fields}")
            return _NAMEDTUPLES[fields](*(walk(v) for v in node))
        return _tensor(node, device)
    return walk(tree)


def _moment(node, device: torch.device):
    """None, an array, or ``repro``'s ``QTensor`` (matched by its
    ``codes``/``spec`` attributes) -> the port's."""
    if node is None:
        return None
    if hasattr(node, "codes") and hasattr(node, "spec"):
        return QTensor(_tensor(node.codes, device), _tensor(node.scale, device),
                       QuantSpec.from_json_dict(node.spec.to_json_dict()),
                       tuple(node.shape))
    return _tensor(node, device)


def adam_state_from_jax(state, device=None) -> AdamState:
    """``repro``'s ``AdamState`` with numpy leaves (``jax.tree.map(
    np.asarray, state)`` keeps its ``QTensor`` moments) -> the port's, on
    ``device`` (default ``"cuda"``; pass ``"cpu"`` explicitly off the
    card)."""
    device = resolve_device(device)
    return AdamState(_tensor(state.step, device),
                     tuple(_moment(m, device) for m in state.m),
                     tuple(_moment(v, device) for v in state.v))


def residual_from_jax(residual, device=None) -> tuple:
    """The gradient wire's residual tuple (None for the integer leaves) ->
    the port's, on ``device`` (default ``"cuda"``)."""
    device = resolve_device(device)
    return tuple(_moment(r, device) for r in residual)


def _unstack(node, n_layers: int, device: torch.device) -> list:
    """One stacked moment or residual (None, an array, or a ``QTensor``
    over (L, ...)) -> its L per-layer slices. A blockwise moment blocks
    along the last axis only, so a slice of its codes and scales along
    axis 0 is the per-layer leaf's own encoding."""
    if node is None:
        return [None] * n_layers
    if hasattr(node, "codes") and hasattr(node, "spec"):
        if len(node.shape) < 2:
            raise ValueError(f"a stacked moment of shape {node.shape} blocks "
                             "along the layer axis")
        spec = QuantSpec.from_json_dict(node.spec.to_json_dict())
        codes, scale = np.asarray(node.codes), np.asarray(node.scale)
        return [QTensor(_tensor(codes[i], device), _tensor(scale[i], device),
                        spec, tuple(node.shape[1:])) for i in range(n_layers)]
    a = np.asarray(node)
    return [_tensor(a[i], device) for i in range(n_layers)]


def lm_train_state_from_jax(state, device=None):
    """``repro.launch.steps.TrainState`` of a zoo LM with numpy leaves
    (``jax.tree.map(np.asarray, state)`` keeps its ``QTensor`` moments and
    ``ScaleState`` nodes) -> the port's ``launch.steps.TrainState`` on
    ``device`` (default ``"cuda"``; pass ``"cpu"`` explicitly off the
    card).

    The reference's moments and residual are tuples in its leaf order over
    stacked leaves; the port's are in its own order over per-layer leaves
    (``tree.py``): reference leaf k under ``layers`` becomes its L
    per-layer slices, placed at the port's positions of that leaf in
    every layer."""
    from .launch.steps import TrainState
    from .tree import flatten_with_path, stacked_groups
    device = resolve_device(device)
    params = params_from_jax(state.params, device)
    paths = [p for p, _ in flatten_with_path(params)]
    groups = stacked_groups(paths)
    n_ref = len(flatten_with_path(state.params))
    if len(groups) != n_ref:
        raise ValueError(f"{n_ref} reference leaves, {len(groups)} port "
                         "leaf groups")

    def reorder(seq):
        if seq is None:
            return None
        if len(seq) != n_ref:
            raise ValueError(f"{len(seq)} entries for {n_ref} leaves")
        out = [None] * len(paths)
        for group, node in zip(groups, seq):
            if paths[group[0]].startswith("layers/"):
                for i, t in zip(group, _unstack(node, len(group), device)):
                    out[i] = t
            else:
                out[group[0]] = _moment(node, device)
        return tuple(out)

    opt = AdamState(_tensor(state.opt.step, device), reorder(state.opt.m),
                    reorder(state.opt.v))
    scales = None
    if state.scales is not None:
        scales = {k: ScaleState(_tensor(v.log2, device),
                                _tensor(v.mean_abs, device))
                  for k, v in state.scales.items()}
    return TrainState(params, opt, _tensor(state.step, device),
                      reorder(state.residual), scales)
