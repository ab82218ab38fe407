"""Checkpoints and the packed-int4 TT deploy export — the port of
``repro/ckpt/checkpoint.py``: synchronous ``save``/``load``, the
asynchronous ``AsyncCheckpointer`` with its step files (``step_path``,
``latest_step``) and garbage collection, the SIGTERM hook
``install_preemption_handler``, and ``export_tt_deploy``/``load_tt_deploy``,
in ``repro``'s container format so either package reads what the other
writes:

- a flattened ``§``-joined path -> array map (dict keys sorted, NamedTuple
  fields as ``.name``, sequence items by index, a ``QTensor`` as ``q`` and
  ``scale``, ``None`` skipped; a ``Stacked`` leaf as one array, its
  members stacked on a new axis 0), each array as ``{"dtype", "shape",
  "data"}``, beside a ``meta`` map, in one msgpack document;
- written raw (``repro`` adds zstd when its ``zstandard`` module is
  present): reading a zstd frame raises, as ``repro`` does without it;
- atomic: written to ``<path>.tmp``, then renamed;
- streamed: the writer emits the document's headers and then each
  array's bytes straight from its host tensor (``_write_stream``), and the
  reader takes each array as a view into the one buffer it read the file
  into, so neither holds a second copy of the arrays.

``AsyncCheckpointer.save`` copies every leaf to the host on the caller's
thread (a device leaf's copy is complete when it returns; a host leaf is
copied too), so later steps cannot leak into a pending write; a writer
thread writes and collects.

The msgpack subset is the port's own (``_msgpack.py``): the port needs no
msgpack package.
"""
from __future__ import annotations

import dataclasses
import io
import os
import queue
import signal
import threading
from typing import Callable

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


class Stacked:
    """Tensors of one shape and dtype saved as one array, their stack on a
    new axis 0: the reference's stacked layout of a per-layer leaf
    (``launch/steps.py::stack_state``). A leaf of the trees ``save`` and
    ``AsyncCheckpointer.save`` take; in ``load``'s ``like`` it comes back
    as that one tensor, on its first member's device and in its dtype."""
    __slots__ = ("items",)

    def __init__(self, items):
        self.items = list(items)


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


def _host(leaf, copy: bool) -> torch.Tensor:
    """A leaf on the host; with ``copy`` a copy of its own, complete when
    this returns (a ``Stacked`` leaf is always assembled in a new tensor,
    each member copied into its row)."""
    if isinstance(leaf, Stacked):
        first = torch.as_tensor(leaf.items[0])
        out = torch.empty((len(leaf.items),) + tuple(first.shape),
                          dtype=first.dtype)
        for row, t in zip(out, leaf.items):
            row.copy_(torch.as_tensor(t).detach())
        return out
    t = torch.as_tensor(leaf).detach()
    return t.to("cpu", copy=True) if copy else t.cpu()


def _flatten(tree, prefix: str = "",
             copy: bool = False) -> dict[str, torch.Tensor]:
    kids = _children(tree)
    if kids is None:
        if tree is None:
            return {}
        return {prefix: _host(tree, copy)}
    out = {}
    for k, v in kids:
        out.update(_flatten(v, f"{prefix}{_SEP}{k}" if prefix else k, copy))
    return out


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _raw(t: torch.Tensor) -> np.ndarray:
    """A host tensor's bytes as a flat uint8 array (bf16 through int16,
    which numpy lacks), a view where the tensor is contiguous."""
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().reshape(-1).view(np.uint8)


def _from_bytes(dtype: str, shape, data) -> torch.Tensor:
    """A tensor over ``data`` (a writable buffer: a view, not a copy)."""
    raw = np.frombuffer(data, dtype=np.int16 if dtype == "bfloat16"
                        else np.dtype(dtype)).reshape(shape)
    t = torch.from_numpy(raw)
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


def _write_stream(f, arrays: dict[str, torch.Tensor], meta: dict) -> int:
    """Write the container of ``arrays`` and ``meta`` to the file ``f``:
    the headers through ``_msgpack``, each array's bytes straight from its
    host tensor. Returns the bytes written."""
    pk = _msgpack.packb
    n = f.write(_msgpack.map_head(2) + pk("meta") + pk(meta) + pk("arrays")
                + _msgpack.map_head(len(arrays)))
    for k, v in arrays.items():
        raw = _raw(v)
        n += f.write(pk(k) + _msgpack.map_head(3) + pk("dtype")
                     + pk(_dtype_name(v)) + pk("shape") + pk(list(v.shape))
                     + pk("data") + _msgpack.bin_head(raw.nbytes))
        n += f.write(raw.data)
    return n


def _encode(arrays: dict[str, torch.Tensor], meta: dict) -> bytes:
    """The container's bytes in memory (``_write_stream`` into a buffer)."""
    buf = io.BytesIO()
    _write_stream(buf, arrays, meta)
    return buf.getvalue()


def _read(path: str) -> bytearray:
    """The file's bytes in one writable buffer."""
    with open(path, "rb") as f:
        buf = bytearray(os.fstat(f.fileno()).st_size)
        view, got = memoryview(buf), 0
        while got < len(buf):
            n = f.readinto(view[got:])
            if not n:
                raise ValueError(f"{path} ended early")
            got += n
    return buf


def _decode(blob) -> tuple[dict[str, torch.Tensor], dict]:
    """The arrays (tensors over ``blob``, no copies: pass a writable
    buffer) and the meta map of a raw container."""
    if bytes(blob[:4]) == _ZSTD_MAGIC:
        raise RuntimeError("checkpoint is zstd-compressed; the port reads "
                           "raw msgpack checkpoints only")
    payload = _msgpack.unpackb(blob)
    arrays = {k: _from_bytes(v["dtype"], v["shape"], v["data"])
              for k, v in payload["arrays"].items()}
    return arrays, payload["meta"]


def _write_arrays(path: str, arrays: dict, meta: dict, sync: bool) -> int:
    """Stream ``arrays`` and ``meta`` to ``path`` atomically; the bytes."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        n = _write_stream(f, arrays, meta)
        if sync:
            f.flush()
            os.fsync(f.fileno())
    os.replace(tmp, path)
    return n


def save(path: str, tree, meta: dict | None = None) -> None:
    """Synchronous atomic save of a tree of tensors."""
    _write_arrays(path, _flatten(tree), meta or {}, sync=True)


def load(path: str, like=None):
    """Load a checkpoint: ``(arrays, meta)`` with ``arrays`` the flat key ->
    CPU tensor map (views into the one buffer the file was read into);
    with ``like`` (a tree of the target structure) the arrays come back in
    that structure, each cast to its ``like`` leaf's dtype and placed on
    its device (a ``Stacked`` leaf: its first member's). An array whose
    shape is not its ``like`` leaf's (a ``Stacked`` leaf: its member count,
    then its first member's shape) raises ``ValueError``."""
    arrays, meta = _decode(_read(path))
    if like is None:
        return arrays, meta

    def rebuild(node, prefix: str):
        kids = _children(node)
        if kids is None:
            if node is None:
                return None
            if prefix not in arrays:
                raise KeyError(f"checkpoint missing {prefix}")
            stacked = isinstance(node, Stacked)
            ref = torch.as_tensor(node.items[0] if stacked else node)
            want = ((len(node.items),) if stacked else ()) + tuple(ref.shape)
            got = arrays[prefix]
            if tuple(got.shape) != want:
                raise ValueError(f"checkpoint {prefix} has shape "
                                 f"{tuple(got.shape)}, expected {want}")
            return got.to(device=ref.device, dtype=ref.dtype)
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


def latest_step(ckpt_dir: str) -> int | None:
    """The largest N of the ``step_N.ckpt`` files in ``ckpt_dir`` (None
    when there is none, or no directory)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(f.split("_")[1].split(".")[0])
             for f in os.listdir(ckpt_dir)
             if f.startswith("step_") and f.endswith(".ckpt")]
    return max(steps) if steps else None


def step_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step}.ckpt")


class AsyncCheckpointer:
    """Snapshot on the caller's thread, write in the background: ``save``
    returns once every leaf has a host copy of its own and queues the
    write (at most 2 waiting; a third ``save`` blocks), a writer thread
    streams it to ``step_<step>.ckpt`` through ``.tmp`` and a rename, then
    removes all but the newest ``keep`` step files. ``wait`` blocks until
    the queue is written and re-raises the writer's exception; ``close``
    stops the thread."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        self._last_exc: Exception | None = None

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            step, arrays, meta = item
            try:
                _write_arrays(step_path(self.ckpt_dir, step), arrays, meta,
                              sync=False)
                del arrays
                self._gc()
            except Exception as e:            # re-raised by wait()
                self._last_exc = e
            finally:
                self._q.task_done()

    def _gc(self):
        steps = sorted(int(f.split("_")[1].split(".")[0])
                       for f in os.listdir(self.ckpt_dir)
                       if f.startswith("step_") and f.endswith(".ckpt"))
        for s in steps[:-self.keep]:
            try:
                os.remove(step_path(self.ckpt_dir, s))
            except OSError:
                pass

    def save(self, step: int, tree, meta: dict | None = None):
        arrays = _flatten(tree, copy=True)       # synchronous snapshot
        meta = dict(meta or {})
        meta["step"] = step
        self._q.put((step, arrays, meta))        # asynchronous write

    def wait(self):
        self._q.join()
        if self._last_exc:
            raise self._last_exc

    def close(self):
        self._q.put(None)
        self._thread.join(timeout=10)


def install_preemption_handler(fn: Callable[[], None]):
    """Run ``fn`` (an emergency checkpoint flush) on SIGTERM, then exit
    with code 143. Returns the handler it replaced, so a caller can put it
    back (the reference leaves its handler installed)."""
    def handler(signum, frame):
        fn()
        raise SystemExit(143)

    return signal.signal(signal.SIGTERM, handler)


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
    _write_arrays(path, arrays, {"format": "tt_deploy",
                                 "tt_deploy": deploy_meta, "stats": stats},
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
    arrays, meta = _decode(_read(path))
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
