"""Checkpoints and the packed-int4 TT deploy export — the port of
``repro/ckpt/checkpoint.py`` (synchronous ``save``/``load`` and
``export_tt_deploy``/``load_tt_deploy``), in ``repro``'s container format
so either package reads what the other writes:

- a flattened ``§``-joined path -> array map (dict keys sorted, NamedTuple
  fields as ``.name``, sequence items by index, a ``QTensor`` as ``q`` and
  ``scale``, ``None`` skipped), each array as ``{"dtype", "shape",
  "data"}``, beside a ``meta`` map, in one msgpack document;
- written raw (``repro`` adds zstd when its ``zstandard`` module is
  present): reading a zstd frame raises, as ``repro`` does without it;
- atomic: written to ``<path>.tmp``, then renamed.

The msgpack subset is the port's own (``_msgpack.py``): the port needs no
msgpack package.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..device import resolve_device
from ..numerics import QTensor, QuantSpec, decode, encode
from ..numerics.policy import NumericsPolicy
from . import _msgpack

_SEP = "§"
_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"     # zstd frame header (RFC 8878)


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node) -> list[tuple[str, object]] | None:
    """(key, child) pairs of a container node in ``jax.tree_util``'s order
    and key spelling, or None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, QTensor):
        return [("q", node.codes), ("scale", node.scale)]
    if _is_namedtuple(node):
        return [("." + f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _flatten(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    kids = _children(tree)
    if kids is None:
        if tree is None:
            return {}
        return {prefix: torch.as_tensor(tree).detach().cpu()}
    out = {}
    for k, v in kids:
        out.update(_flatten(v, f"{prefix}{_SEP}{k}" if prefix else k))
    return out


def _to_bytes(t: torch.Tensor) -> bytes:
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _from_bytes(dtype: str, shape, data: bytes) -> torch.Tensor:
    raw = np.frombuffer(data, dtype=np.int16 if dtype == "bfloat16"
                        else np.dtype(dtype)).reshape(shape)
    t = torch.from_numpy(raw.copy())
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


def _encode(arrays: dict[str, torch.Tensor], meta: dict) -> bytes:
    payload = {
        "meta": meta,
        "arrays": {
            k: {"dtype": str(v.dtype).removeprefix("torch."),
                "shape": list(v.shape), "data": _to_bytes(v)}
            for k, v in arrays.items()
        },
    }
    return _msgpack.packb(payload)


def _decode(blob: bytes) -> tuple[dict[str, torch.Tensor], dict]:
    if blob[:4] == _ZSTD_MAGIC:
        raise RuntimeError("checkpoint is zstd-compressed; the port reads "
                           "raw msgpack checkpoints only")
    payload = _msgpack.unpackb(blob)
    arrays = {k: _from_bytes(v["dtype"], v["shape"], v["data"])
              for k, v in payload["arrays"].items()}
    return arrays, payload["meta"]


def _write(path: str, blob: bytes, sync: bool) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
        if sync:
            f.flush()
            os.fsync(f.fileno())
    os.replace(tmp, path)


def save(path: str, tree, meta: dict | None = None) -> None:
    """Synchronous atomic save of a tree of tensors."""
    _write(path, _encode(_flatten(tree), meta or {}), sync=True)


def load(path: str, like=None):
    """Load a checkpoint: ``(arrays, meta)`` with ``arrays`` the flat key ->
    CPU tensor map; with ``like`` (a tree of the target structure) the
    arrays come back in that structure, each cast to its ``like`` leaf's
    dtype and placed on its device."""
    with open(path, "rb") as f:
        arrays, meta = _decode(f.read())
    if like is None:
        return arrays, meta

    def rebuild(node, prefix: str):
        kids = _children(node)
        if kids is None:
            if node is None:
                return None
            if prefix not in arrays:
                raise KeyError(f"checkpoint missing {prefix}")
            ref = torch.as_tensor(node)
            return arrays[prefix].to(device=ref.device, dtype=ref.dtype)
        new = [rebuild(v, f"{prefix}{_SEP}{k}" if prefix else k)
               for k, v in kids]
        if isinstance(node, dict):
            return dict(zip(sorted(node), new))
        if isinstance(node, QTensor):
            return QTensor(new[0], new[1], node.spec, node.shape)
        if _is_namedtuple(node):
            return type(node)(*new)
        return type(node)(new)
    return rebuild(like, ""), meta


# ---------------------------------------------------------------------------
# TT-factor deploy export (packed int4)
# ---------------------------------------------------------------------------

def export_tt_deploy(path: str, params, policy=None) -> dict:
    """Export trained TT cores in the packed-int4 deploy format.

    Every ``core_n`` leaf is encoded through the policy's ``tt_factor``
    codec with ``storage_dtype="int4x2"`` (two codes per byte) at its fixed
    per-core ``wscale_log2`` step — the packed encode kernel on the card —
    flattened per core (keeping any stacked leading dims, each with its own
    step), so the nibble pairing runs over the whole core. All other leaves
    (biases, λ, scale exponents, the ActQuant sites) are stored as they are.

    Codes go under ``<key>§q``, steps under ``<key>§scale``, the spec and
    logical shape in ``meta["tt_deploy"]``. Returns the byte accounting
    ``{"packed_bytes", "fp32_bytes", "reduction_x"}`` over the cores."""
    spec = (policy or NumericsPolicy(enable=True)).spec_for("tt_factor")
    spec = dataclasses.replace(spec, storage_dtype="int4x2")

    arrays: dict[str, torch.Tensor] = {}
    deploy_meta: dict[str, dict] = {}
    packed_bytes = fp32_bytes = 0

    def visit(tree: dict, prefix: str):
        nonlocal packed_bytes, fp32_bytes
        steps = tree.get("wscale_log2")
        for k, v in tree.items():
            key = f"{prefix}{_SEP}{k}" if prefix else k
            if isinstance(v, dict):
                visit(v, key)
            elif k.startswith("core_") and steps is not None:
                n = int(k.split("_")[1])
                scale = steps[..., n].float()
                stack = tuple(v.shape[:-4])
                qt = encode(v.reshape(stack + (-1,)), spec, scale,
                            backend="cuda")
                arrays[key + _SEP + "q"] = qt.codes.detach().cpu()
                arrays[key + _SEP + "scale"] = scale.detach().cpu()
                deploy_meta[key] = {"spec": spec.to_json_dict(),
                                    "shape": list(v.shape)}
                packed_bytes += qt.nbytes()
                fp32_bytes += v.numel() * 4
            else:
                arrays.update(_flatten(v, key))

    visit(params, "")
    stats = {"packed_bytes": int(packed_bytes), "fp32_bytes": int(fp32_bytes),
             "reduction_x": fp32_bytes / max(packed_bytes, 1)}
    _write(path, _encode(arrays, {"format": "tt_deploy",
                                  "tt_deploy": deploy_meta, "stats": stats}),
           sync=False)
    return stats


def load_tt_deploy(path: str, dequantize: bool = True, device=None):
    """Load a deploy export onto ``device`` (default ``"cuda"``; pass
    ``"cpu"`` explicitly off the card). With ``dequantize`` the cores come
    back as f32 values on the 4-bit grid in their original (R, J, I, R')
    shapes — the packed decode kernel on the card; otherwise as packed
    ``QTensor``s in the flattened-per-core export layout. Returns (params,
    meta); non-core leaves come back as they were stored, container sites
    as nested dicts keyed by field (``".act"``)."""
    device = resolve_device(device)
    with open(path, "rb") as f:
        arrays, meta = _decode(f.read())
    deploy = meta.get("tt_deploy", {})
    out: dict = {}

    def put(key: str, value):
        parts = key.split(_SEP)
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    for key, arr in arrays.items():
        base, _, leaf = key.rpartition(_SEP)
        if base in deploy:
            if leaf != "q":
                continue                       # the scale rides with "q"
            info = deploy[base]
            shape = tuple(info["shape"])
            flat_shape = shape[:-4] + (int(np.prod(shape[-4:])),)
            qt = QTensor(arr.to(device),
                         arrays[base + _SEP + "scale"].to(device),
                         QuantSpec.from_json_dict(info["spec"]), flat_shape)
            put(base, decode(qt, backend="cuda").reshape(shape)
                if dequantize else qt)
        else:
            put(key, arr.to(device))
    return out, meta
