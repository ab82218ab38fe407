"""Slot-indexed recurrent-state cache for SSM / RWKV serving — the port of
``repro/serve/state_cache.py``, the peer of the paged KV pool
(``serve/kv_cache.py``) for mixers whose serving memory is an O(1)
per-request state instead of an O(T) token cache.

Layout: one tensor per (sublayer, state tensor) of shape ``(L, num_slots,
*feat)``, ``L`` the period-stack depth, ``num_slots`` the decode batch. A
slot's state is overwritten every decode step (no paging: state does not
grow with the sequence), so the pool's bytes are fixed at construction.

Quantization (the ``ssm_state`` site of ``NumericsPolicy``): states are
int8 codes on the pow-2 grid with one ``scale_log2`` per (layer, slot,
tensor), re-chosen at every overwrite from the tensor written
(``per_tensor_max``; recurrent state amplitude drifts with the decay) and
decoded on read just before the recurrence step. A decode step reads the
whole pool before its first layer and writes it after its last
(``read_step`` / ``write_step``): in a decode step layer l's state is read
only by layer l and only the next step reads what it writes, so on an int8
pool the step costs two launches, ``st_dec_group`` and ``st_enc_group``
(``kernels/csrc/state_codec.cu`` through ``numerics/cuda_backend.py``;
their plain versions, loops over ``read_layer`` / ``write_layer``'s
arithmetic, on CPU tensors), the encode choosing each (layer, slot)'s scale
and masking the inactive slots on the device. The per-layer primitives
(the chunk step's one slot, a whole-prompt prefill's write) are one launch
of the codec kernels each, chosen by the size of the scale as the
reference's Pallas backend chooses it: a scale per row (``num_slots`` > 1
or ``L`` > 1) takes ``p2_enc_rows`` / ``p2_dec_rows``, a single-element
scale (one slot, or one layer) ``p2_enc`` / ``p2_dec``. A model-dtype pool
runs no kernel.

In-place updates: where the reference donates the pool to a jitted step
and rebuilds it with ``.at[].set``, the functions below write into the
preallocated pool tensors (as ``kv_cache`` does) and return them for
symmetry with the reference.

Lifecycle hooks the engine drives: ``reset_slot`` (zero a slot on
admission), ``write_prefill`` (the post-prompt state ``lm_forward``
returns, all layers of one slot), ``read_step`` / ``write_step`` (the
decode step's whole pool, active-masked: inactive lanes keep their codes
and scale), ``read_layer`` / ``write_layer`` (the per-layer primitives the
step's plain versions follow), ``write_slot`` (the chunk step's
end-of-chunk state),
``snapshot_slot`` / ``restore_slot`` (park and unpark one slot) and
``pool_bytes`` / ``pool_bytes_fp32`` (``ServeMetrics.state_bytes``).
The reference's ``write_health`` and the snapshot trace events wait for
``obs/`` (ROADMAP queue 1, item 6).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.common import torch_dtype
from ..numerics import QTensor, QuantSpec, get_codec, per_tensor_max_scale_log2
from ..numerics import cuda_backend as CB
from .kv_cache import CODEC_BACKEND, _leaves


def _state_spec(bits: int) -> QuantSpec:
    """The ``ssm_state`` site: pow-2 int8 codes, per-tensor-max scale
    re-derived at every overwrite."""
    return QuantSpec("pow2", bits, 0, "int8", "per_tensor_max")


@dataclass(frozen=True)
class StateCacheConfig:
    """Numerics of the recurrent-state pool (its geometry comes from the
    model: each sublayer's state shapes are fixed by its mixer)."""
    quantized: bool = False     # int8 pow-2 storage vs natural-dtype storage
    bits: int = 8

    @property
    def spec(self) -> QuantSpec:
        return _state_spec(self.bits)


# ---------------------------------------------------------------------------
# Pool construction
# ---------------------------------------------------------------------------

def state_feature_shapes(sub, cfg) -> dict[str, tuple[tuple[int, ...], str]]:
    """Per-slot trailing feature shape and natural dtype kind ("model" |
    "f32") of each state tensor of one sublayer (the layouts the mixers in
    ``models/ssm.py`` carry). Attention sublayers have no recurrent state."""
    if sub.mixer_kind == "mamba":
        d = sub.mixer
        return {"conv": ((d.d_conv - 1, d.d_inner), "model"),
                "h": ((d.d_inner, d.d_state), "f32")}
    if sub.mixer_kind == "rwkv6":
        d = sub.mixer
        return {"shift": ((1, cfg.d_model), "model"),
                "wkv": ((d.num_heads, d.head_dim, d.head_dim), "f32"),
                "shift_ffn": ((1, cfg.d_model), "model")}
    return {}


def natural_dtype(kind: str, cfg) -> torch.dtype:
    return torch.float32 if kind == "f32" else torch_dtype(cfg.dtype)


def init_state_pool(lm, num_slots: int, scfg: StateCacheConfig,
                    device: torch.device) -> dict:
    """Allocate the state pool for every sublayer:
    {"data": {sub_i: {name: (L, num_slots, *feat)}},
     "scale_log2": {sub_i: {name: (L, num_slots) f32}}}.
    Attention sublayers get empty dicts, so the keys mirror the KV pool's."""
    L = lm.n_periods
    data, scale = {}, {}
    for i, sub in enumerate(lm.period):
        feats = state_feature_shapes(sub, lm.cfg)
        data[f"sub_{i}"] = {
            name: torch.zeros((L, num_slots) + f, device=device,
                              dtype=torch.int8 if scfg.quantized
                              else natural_dtype(kind, lm.cfg))
            for name, (f, kind) in feats.items()}
        scale[f"sub_{i}"] = {
            name: torch.zeros((L, num_slots), dtype=torch.float32,
                              device=device)
            for name in feats}
    return {"data": data, "scale_log2": scale}


def pool_bytes(pool: dict) -> int:
    """Resident bytes of the state pool (storage + scales)."""
    return sum(t.numel() * t.element_size() for t in _leaves(pool))


def pool_bytes_fp32(pool: dict) -> int:
    """What the same state pool would cost stored in fp32 (no scales)."""
    return 4 * sum(t.numel() for t in _leaves(pool["data"]))


# ---------------------------------------------------------------------------
# Quantize / dequantize — the ``ssm_state`` site
# ---------------------------------------------------------------------------

def _row_scale(step: torch.Tensor, ndim: int) -> torch.Tensor:
    return step.reshape((-1,) + (1,) * (ndim - 1))


def _encode(vals: torch.Tensor, scfg: StateCacheConfig):
    """fp -> (codes, scale_log2) with one scale per leading row (the
    per-layer or per-slot axis), re-derived from max|vals| per row: one
    encode launch (``p2_enc_rows``, or ``p2_enc`` for a single row)."""
    spec = scfg.spec
    step = per_tensor_max_scale_log2(
        vals, spec, reduce_axes=tuple(range(1, vals.dim())))
    codes = get_codec(spec, CODEC_BACKEND).encode(
        vals, spec, _row_scale(step, vals.dim())).codes
    return codes, step


def _decode(codes: torch.Tensor, scale_log2: torch.Tensor, dtype,
            scfg: StateCacheConfig) -> torch.Tensor:
    spec = scfg.spec
    return get_codec(spec, CODEC_BACKEND).decode(
        QTensor(codes, _row_scale(scale_log2, codes.dim()), spec), dtype)


# ---------------------------------------------------------------------------
# Per-layer primitives (the engine's layer loop)
# ---------------------------------------------------------------------------

def read_layer(data_l: torch.Tensor, scale_l: torch.Tensor, dtype,
               scfg: StateCacheConfig) -> torch.Tensor:
    """One layer's state for every slot, decoded on read. data_l:
    (num_slots, *feat); scale_l: (num_slots,). Returns ``dtype`` (a
    model-dtype pool's own tensor when the dtypes agree)."""
    if scfg.quantized:
        return _decode(data_l, scale_l, dtype, scfg)
    return data_l.to(dtype)


def write_layer(data_l: torch.Tensor, scale_l: torch.Tensor,
                new: torch.Tensor, active: torch.Tensor,
                scfg: StateCacheConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Overwrite every active slot's state for one layer, in place;
    inactive lanes keep their stored codes and scale (a parked snapshot
    must survive junk decode traffic). new: (num_slots, *feat) fp;
    active: (num_slots,) bool."""
    amask = active.reshape((-1,) + (1,) * (new.dim() - 1))
    if scfg.quantized:
        codes, step = _encode(new, scfg)
        data_l.copy_(torch.where(amask, codes, data_l))
        scale_l.copy_(torch.where(active, step, scale_l))
    else:
        data_l.copy_(torch.where(amask, new.to(data_l.dtype), data_l))
    return data_l, scale_l


def write_slot(data_l: torch.Tensor, scale_l: torch.Tensor,
               new: torch.Tensor, slot: int, scfg: StateCacheConfig
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Overwrite ONE slot's state for one layer, in place (the chunk
    step's write: the end-of-chunk state carried to the next chunk).
    new: (*feat) fp."""
    if scfg.quantized:
        codes, step = _encode(new[None], scfg)
        data_l[slot] = codes[0]
        scale_l[slot] = step[0]
    else:
        data_l[slot] = new.to(data_l.dtype)
    return data_l, scale_l


# ---------------------------------------------------------------------------
# The decode step's whole pool (the engine's decode step)
# ---------------------------------------------------------------------------

def _step_keys(tree: dict) -> list[tuple[str, str]]:
    return [(key, name) for key, kinds in tree.items() for name in kinds]


def read_step(pool: dict, dtypes: dict, scfg: StateCacheConfig) -> dict:
    """Every layer's state of every tensor named in ``dtypes`` ({sub:
    {name: dtype}}) for all slots, before a decode step's first layer:
    {sub: {name: (L, num_slots, *feat) of that dtype}}. On an int8 pool one
    ``st_dec_group`` launch (``cuda_backend.state_decode_many``) into a
    fresh workspace; on a model-dtype pool the pool's own tensors where the
    dtypes agree (``read_layer``'s views), no kernel."""
    keys = _step_keys(dtypes)
    data = [pool["data"][k][n] for k, n in keys]
    want = [dtypes[k][n] for k, n in keys]
    if scfg.quantized:
        ys = CB.state_decode_many(
            data, [pool["scale_log2"][k][n] for k, n in keys], want)
    else:
        ys = [d.to(dt) for d, dt in zip(data, want)]
    out: dict = {}
    for (k, n), y in zip(keys, ys):
        out.setdefault(k, {})[n] = y
    return out


def write_step(pool: dict, new_states: dict, active: torch.Tensor,
               scfg: StateCacheConfig) -> dict:
    """Write a decode step's new states ({sub: {name: [(num_slots, *feat)
    a layer]}}) into the pool after its last layer, in place; inactive
    lanes keep their codes and scale. On an int8 pool one ``st_enc_group``
    launch (``cuda_backend.state_encode_many``: a ``per_tensor_max`` scale
    per (layer, slot), chosen on the device, ``write_layer``'s codes); on a
    model-dtype pool ``write_layer``'s masked copy a layer, no kernel."""
    keys = _step_keys(new_states)
    if scfg.quantized:
        CB.state_encode_many([pool["data"][k][n] for k, n in keys],
                             [pool["scale_log2"][k][n] for k, n in keys],
                             [new_states[k][n] for k, n in keys], active,
                             scfg.bits)
        return pool
    for k, n in keys:
        for layer, new in enumerate(new_states[k][n]):
            write_layer(pool["data"][k][n][layer],
                        pool["scale_log2"][k][n][layer], new, active, scfg)
    return pool


# ---------------------------------------------------------------------------
# Slot lifecycle (whole pool, in place)
# ---------------------------------------------------------------------------

def reset_slot(pool: dict, slot: int) -> dict:
    """Zero one slot's state across all layers and tensors (admission
    hygiene: a recycled slot never sees its previous occupant's state)."""
    for t in _leaves(pool):
        t[:, slot] = 0
    return pool


def write_prefill(pool: dict, state: dict, slot: int,
                  scfg: StateCacheConfig) -> dict:
    """Scatter a whole-prompt prefill state (``lm_forward``'s, leaves
    (L, 1, *feat): the stacked per-layer states for batch 1) into one slot,
    all layers at once, in place: one encode launch a tensor on a
    quantized pool, with a scale per layer."""
    for key, kinds in state.items():
        data, scale = pool["data"][key], pool["scale_log2"][key]
        for name, arr in kinds.items():
            vals = arr[:, 0]                             # (L, *feat)
            if scfg.quantized:
                codes, step = _encode(vals, scfg)
                data[name][:, slot] = codes
                scale[name][:, slot] = step
            else:
                data[name][:, slot] = vals.to(data[name].dtype)
    return pool


def _no_trace(trace) -> None:
    if trace is not None:
        raise NotImplementedError("state snapshot trace events are a later "
                                  "slice of the port (ROADMAP queue 1, item "
                                  "6: obs/)")


def _map(tree: dict, fn) -> dict:
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def snapshot_slot(pool: dict, slot: int, trace=None) -> dict:
    """A copy of one slot's (codes, scales) across all layers, the park
    half of suspend-without-recompute: the pool's tree with the slot axis
    indexed out."""
    _no_trace(trace)
    return _map(pool, lambda a: a[:, slot].clone())


def restore_slot(pool: dict, snap: dict, slot: int, trace=None) -> dict:
    """Write a ``snapshot_slot`` capture back into ``slot``, in place."""
    _no_trace(trace)
    for key in ("data", "scale_log2"):
        for sub, kinds in snap[key].items():
            for name, s in kinds.items():
                pool[key][sub][name][:, slot] = s
    return pool
