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
from ..kernels import grouped as G
from ..numerics import QTensor, QuantSpec
from ..numerics import cuda_backend as CB
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

def _to_host(views: list[torch.Tensor]) -> list[torch.Tensor]:
    """CPU copies of ``views``, tensors that lie in a few device buffers (a
    packed group's: one a launch), at one device-to-host copy a buffer."""
    host: dict[int, torch.Tensor] = {}
    out = []
    for v in views:
        st = v.untyped_storage()
        if st.data_ptr() not in host:
            host[st.data_ptr()] = torch.empty(
                0, dtype=v.dtype, device=v.device).set_(st).cpu()
        out.append(host[st.data_ptr()].as_strided(v.shape, v.stride(),
                                                  v.storage_offset()))
    return out


def _packed_spec(spec: QuantSpec) -> QuantSpec:
    if spec.kind != "pow2" or not spec.packed:
        raise ValueError(f"the deploy export packs pow2 int4x2 cores, got "
                         f"{spec.kind} {spec.storage_dtype}")
    return spec


def export_tt_deploy(path: str, params, policy=None) -> dict:
    """Export trained TT cores in the packed-int4 deploy format.

    Every ``core_n`` leaf is encoded through the policy's ``tt_factor``
    codec with ``storage_dtype="int4x2"`` (two codes per byte) at its fixed
    per-core ``wscale_log2`` step, flattened per core (keeping any stacked
    leading dims, each with its own step), so the nibble pairing runs over
    the whole core. All cores go through one packed encode group (one
    launch on the card) and come back to the host in one copy of the codes
    and one of the steps. All other leaves (biases, λ, scale exponents, the
    ActQuant sites) are stored as they are.

    Codes go under ``<key>§q``, steps under ``<key>§scale``, the spec and
    logical shape in ``meta["tt_deploy"]``. Returns the byte accounting
    ``{"packed_bytes", "fp32_bytes", "reduction_x"}`` over the cores."""
    spec = (policy or NumericsPolicy(enable=True)).spec_for("tt_factor")
    spec = _packed_spec(dataclasses.replace(spec, storage_dtype="int4x2"))

    arrays: dict[str, torch.Tensor | None] = {}
    deploy_meta: dict[str, dict] = {}
    cores: list[tuple[str, torch.Tensor, torch.Tensor]] = []

    def visit(tree: dict, prefix: str):
        steps = tree.get("wscale_log2")
        for k, v in tree.items():
            key = f"{prefix}{_SEP}{k}" if prefix else k
            if isinstance(v, dict):
                visit(v, key)
            elif k.startswith("core_") and steps is not None:
                n = int(k.split("_")[1])
                cores.append((key, v, steps[..., n]))
                # the file keeps the visit's key order: filled below
                arrays[key + _SEP + "q"] = arrays[key + _SEP + "scale"] = None
                deploy_meta[key] = {"spec": spec.to_json_dict(),
                                    "shape": list(v.shape)}
            else:
                arrays.update(_flatten(v, key))

    visit(params, "")
    packed_bytes = fp32_bytes = 0
    if cores:
        flat = torch.cat([s.reshape(-1) for _, _, s in cores]).float()
        scales = [s.view(step.shape) for s, (_, _, step) in zip(
            flat.split([step.numel() for _, _, step in cores]), cores)]
        views = [CB._rowwise_lastdim(v.reshape(tuple(v.shape[:-4]) + (-1,)),
                                     s) for (_, v, _), s in zip(cores, scales)]
        if any(vw is None for vw in views):
            raise ValueError("a core's wscale_log2 is not one step per "
                             "stacked core")
        codes = _to_host(CB.encode_packed_many(
            [x for x, _ in views], [s for _, s in views], spec.bits))
        host_scales = _to_host(scales)
        for (key, v, _), q, s in zip(cores, codes, host_scales):
            arrays[key + _SEP + "q"] = q.reshape(tuple(v.shape[:-4])
                                                 + (q.shape[-1],))
            arrays[key + _SEP + "scale"] = s
            packed_bytes += q.numel() + s.numel() * 4
            fp32_bytes += v.numel() * 4
    stats = {"packed_bytes": int(packed_bytes), "fp32_bytes": int(fp32_bytes),
             "reduction_x": fp32_bytes / max(packed_bytes, 1)}
    _write(path, _encode(arrays, {"format": "tt_deploy",
                                  "tt_deploy": deploy_meta, "stats": stats}),
           sync=False)
    return stats


def _decode_cores(cores: list[tuple[torch.Tensor, torch.Tensor, tuple]],
                  device: torch.device) -> list[torch.Tensor]:
    """The f32 values of the deploy file's packed cores (host codes, host
    steps, logical shape each) on ``device``: their bytes and steps laid
    out in one host buffer each (bytes on 16), one host-to-device copy
    each, one packed decode group."""
    p2ds, srows, offs, off = [], [], [], 0
    for codes, scale, shape in cores:
        p2d, srow = CB._rowwise_lastdim(codes, scale)
        p2ds.append(p2d)
        srows.append(srow.float().reshape(-1))
        offs.append(off)
        off += -(-p2d.numel() // G.CODE_ALIGN) * G.CODE_ALIGN
    buf = torch.zeros(off, dtype=torch.int8)
    for p2d, o in zip(p2ds, offs):
        buf[o:o + p2d.numel()] = p2d.reshape(-1)
    buf = buf.to(device)
    steps = torch.cat(srows).to(device).split([s.numel() for s in srows])
    return CB.decode_packed_many(
        [buf[o:o + p.numel()].view(p.shape) for p, o in zip(p2ds, offs)],
        list(steps), [shape[-1] for _, _, shape in cores])


def load_tt_deploy(path: str, dequantize: bool = True, device=None):
    """Load a deploy export onto ``device`` (default ``"cuda"``; pass
    ``"cpu"`` explicitly off the card). With ``dequantize`` the cores come
    back as f32 values on the 4-bit grid in their original (R, J, I, R')
    shapes — one packed decode group on the card, its input in one copy of
    the codes and one of the steps; otherwise as packed ``QTensor``s in the
    flattened-per-core export layout. Returns (params, meta); non-core
    leaves come back as they were stored, container sites as nested dicts
    keyed by field (``".act"``)."""
    device = resolve_device(device)
    with open(path, "rb") as f:
        arrays, meta = _decode(f.read())
    deploy = meta.get("tt_deploy", {})
    out: dict = {}
    cores: list[tuple[str, torch.Tensor, torch.Tensor, tuple]] = []

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
            spec = _packed_spec(QuantSpec.from_json_dict(info["spec"]))
            shape = tuple(info["shape"])
            flat_shape = shape[:-4] + (int(np.prod(shape[-4:])),)
            scale = arrays[base + _SEP + "scale"]
            if dequantize:
                cores.append((base, arr, scale, flat_shape))
                put(base, None)                # its place; filled below
            else:
                put(base, QTensor(arr.to(device), scale.to(device), spec,
                                  flat_shape))
        else:
            put(key, arr.to(device))
    if cores:
        ys = _decode_cores([c[1:] for c in cores], device)
        for (base, *_), y in zip(cores, ys):
            put(base, y.reshape(deploy[base]["shape"]))
    return out, meta
