"""Continuous-batching inference engine — the port of
``repro/serve/engine.py`` for dense and MoE models with GQA or MLA
attention, pure-SSM RWKV6 and the Jamba hybrid (Mamba and attention, dense
or MoE FFNs).

Requests occupy *slots* of a ``num_slots``-lane decode batch, each at its
own length; a retired slot (max-new-tokens or EOS) frees its pages and is
refilled on the next iteration, so the batch never drains to admit work.
Prefill's first chunk (the whole prompt unless ``prefill_chunk`` splits
it) is the model's own ``lm_forward``, whose K/V cache is scattered into
the slot-paged (optionally int8 pow-2) pool; later chunks go through the
chunk step (``_chunk``: write the chunk's K/V, read the slot's history,
attend; on an int8 pool one ``p2_append_paged`` and one ``p2_read_paged``
launch a layer). Decode appends each new token's K/V (one
``p2_append_paged`` launch a layer) and attends either through the fused
paged-attention kernel (``fused_attention=True``) or by reading every
slot's view off the pages (one ``p2_read_paged`` launch a layer) and
running ``gqa_attend`` (the default, and the in-engine reference for the
fused path).

Speculative decoding (``spec_k > 0`` with ``Engine(..., draft=(lm,
params))``): a draft model proposes k tokens per slot over its own pool
(S = 1 steps: one ``p2_append_paged`` and one ``p2_read_paged`` launch a
layer on an int8 pool), the target scores the incoming token and the k
proposals as one (B, k+1) block (one ``p2_append_paged`` launch a layer,
then the fused attention's q-block or the paged read), and rejection
sampling accepts a prefix on the device; one host read-back a round.
Greedy slots emit exactly what the non-speculative engine emits.
``policy`` (a ``NumericsPolicy``) owns the pool's numerics: its
``kv_cache`` site overrides the pool's ``quantized`` and ``bits``.

With ``prefix_cache=True`` a radix tree (``serve/prefix.py``) shares the
pages of prompt prefixes it has seen: a hit adopts its donor's scales,
copies a partly matched page (COW) and computes only the suffix through
the chunk step — exactly what a cache-off engine with a chunk boundary at
the resume position computes.

Sublayer routing: attention sublayers read and write the paged KV pool
through the reference's ``_project`` / ``_attend`` pair: a GQA sublayer
caches K and V, an MLA sublayer its latent ``c_kv`` and rope key
``k_rope`` (two widths; the paged kernels take them in one launch a layer
all the same) and attends in the latent space (``mla_attend``) over the
views read off the pages, even with ``fused_attention=True``, as the
reference's ``_fused_for`` rules (the paged-attention kernel is GQA's);
mamba and rwkv6 sublayers the slot-indexed recurrent-state pool
(``serve/state_cache.py``), through the forwards of ``models/ssm.py``
that static decode runs (at S = 1 for the decode step). A decode
step reads every such layer's state for every slot before its first layer
(``state_cache.read_step``: one ``st_dec_group`` launch on an int8 pool),
advances each layer's one token and writes the active slots' new states
back after its last layer (``write_step``: one ``st_enc_group``); a chunk
step does the same for its one slot (``read_slot`` / ``write_slot_step``:
one ``st_dec_slot`` and one ``st_enc_slot``, the slot's index read on the
device from the chunk's int32 tensor of start, valid count and slot); a
whole-prompt prefill writes every layer's state of the slot in one
``st_enc_slot`` launch (``write_prefill``). A stateful arch resets the slot's
state on admission, prefills exact-length (no bucket pad, no padded
chunk: a pad token would enter the recurrence), takes no prefix cache,
and a pure-SSM arch runs the scheduler unpaged. Speculative decoding
needs an attention-only target and draft (a state advanced through a
rejected token cannot roll back).

MoE routing (``models/moe.py``): every step masks the rows that are not
real tokens out of the routers, as the reference does, so they never take
expert capacity: inactive slots in the decode step, the draft's steps and
the verify block (``active``), bucket padding in a whole-prompt prefill
and the draft's prefill, and the pad rows of a chunk. A chunk is padded
to the chunk width (or the bucketed suffix), as in the reference, and its
routers see that padded width, so the capacity's clamp is the reference's
(a stateful arch pads nothing, in both packages). With
``moe_capacity_by_prompt`` every prefill shape of a request, whole or
chunked, takes its capacity from the whole prompt's length.

Numerics: float32 matmuls stay float32 on the card — the engine sets
``torch.backends.cuda.matmul.allow_tf32 = False`` (and cuDNN's) where it
is built, so the fp32 fused-vs-gather identity holds as in the reference.
The pool is updated in place (see ``kv_cache``); PyTorch runs eagerly, so
there is no compiled-step cache.

Observability (``obs/``): ``trace=`` takes an ``obs.TraceRecorder``; the
engine, the scheduler and the prefix cache emit the reference's events
(``submit``, ``admit``, ``prefill_chunk``, ``prefill``, ``first_token``,
``decode_step``, ``spec_step``, ``preempt``, ``retire``, ``page_alloc``,
``page_free``, ``cache_hit``, ``cow_fork``, ``prefix_evict``) from the
host-side step loop, and each decode step's ``dur`` fills the metrics'
timeline. ``policy.health`` counts, in the batched decode step only as in
the reference, the KV appends' clipped values against the slots' frozen
scales (``kv_cache``; GQA's K and V, MLA's ``c_kv`` and ``k_rope``) and the
state writes' clip counts and scale drift (``ssm_state``), summed over
layers and tensors into one (6,) int64 counter on the device: counted
inside the ``p2_append_paged`` and ``st_enc_group`` launches that encode
the values (their plain versions on the CPU), so health adds no launch of
its own, and read back once a step. ``self.ledger`` (an
``obs.MemoryLedger``) holds the resident sites — ``params``, ``kv_pool``,
``state_pool``, ``draft_params``, ``draft_kv_pool`` and the uncounted
prefix overlays — with phase watermarks; ``summary()["memory"]`` carries
it, reconciled against ``torch.cuda.memory_allocated`` on the card (on the
CPU against the bytes of the tensors the engine holds). With no recorder
and health off a decode step dispatches exactly the ATen calls it did
without them (``tests/test_torch_obs.py``).

Not carried over: the reference's ``CompileCache`` / ``max_prefill_shapes``
(they bound live jitted prefill shapes; eager PyTorch compiles none), and
with it the ledger's ``compile_cache`` site. Refused as the reference
refuses them: encoder-only archs and the frontend (audio, vision)
configs. Still to port (it raises ``NotImplementedError``): a mesh
(``plan=``).
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..models import attention as A
from ..models import ssm as S
from ..models.common import apply_site, rms_norm
from ..models.lm import (STATE_MIXERS, LMDef, embed_tokens, lm_forward,
                         sub_ffn_decode)
from ..obs import MemoryLedger, registry
from ..tree import leaves
from . import kv_cache as KC
from . import state_cache as SC
from .kv_cache import PoolConfig
from .metrics import ServeMetrics
from .prefix import RadixPrefixCache
from .sampling import (SamplingParams, processed_probs, sample_from_probs,
                       sample_tokens, spec_accept)
from .scheduler import Request, Scheduler


class Completion(NamedTuple):
    rid: int
    prompt: list[int]
    tokens: list[int]           # generated tokens (first token included)


@dataclass(frozen=True)
class EngineConfig:
    pool: PoolConfig
    prefill_chunk: int = 0      # 0: whole-prompt prefill only
    prefill_bucket: int = 0     # pad prompts to a multiple of this (0: exact)
    seed: int = 0               # seeds the sampling generator
    fused_attention: bool = False
                                # decode attends via the fused paged-
                                # attention kernel instead of gather + attend
    prefix_cache: bool = False  # radix-tree COW prefix sharing over the
                                # paged pool (serve/prefix.py)
    spec_k: int = 0             # speculative decoding: draft tokens
                                # proposed per step (0: off); needs
                                # Engine(..., draft=(lm, params))
    policy: object = None       # NumericsPolicy: its kv_cache site
                                # overrides the pool's quantized/bits, its
                                # ssm_state site the state pool's
    moe_capacity_by_prompt: bool = False
                                # MoE chunked-prefill capacity parity:
                                # expert capacity from the WHOLE prompt's
                                # length, not the visible chunk, so chunked
                                # prefill routes like the whole prompt at
                                # capacity-bound loads


def _project(pm: dict, h: torch.Tensor, sub, cfg, positions: torch.Tensor):
    """Queries and the new cache entries of one attention sublayer over
    (B, S) rows at ``positions``: GQA's q and K/V, or MLA's absorbed
    queries and latent pair."""
    if sub.mixer_kind == "attn_gqa":
        q, k_new, v_new = A.gqa_decode_qkv(pm, h, sub.mixer, cfg, positions)
        return {"q": q}, {"k": k_new, "v": v_new}
    q_abs, q_rope = A.mla_decode_q(pm, h, sub.mixer, cfg, positions)
    c_new, kr_new = A._mla_kv_latent(pm, h, sub.mixer, cfg, positions)
    return ({"q_abs": q_abs, "q_rope": q_rope},
            {"c_kv": c_new, "k_rope": kr_new})


def _attend(pm: dict, qd: dict, kv: dict, sub, cfg,
            positions: torch.Tensor) -> torch.Tensor:
    """Attention over the views read off the pages, then the output
    projection."""
    if sub.mixer_kind == "attn_gqa":
        out = A.gqa_attend(qd["q"], kv["k"], kv["v"], sub.mixer, positions)
    else:
        out = A.mla_attend(pm, qd["q_abs"], qd["q_rope"], kv["c_kv"],
                           kv["k_rope"], sub.mixer, cfg, positions)
    return apply_site(pm["o"], out, sub.mixer.o, cfg)


def _check_draft(lm: LMDef, draft) -> None:
    """What speculative decoding needs (the reference's checks): a draft
    given, an attention-only target and draft (a recurrent state advanced
    through a rejected token cannot roll back), one vocabulary."""
    if draft is None:
        raise ValueError("spec_k > 0 needs a draft model: "
                         "Engine(..., draft=(draft_lm, draft_params))")
    if any(sub.mixer_kind in STATE_MIXERS for sub in lm.period):
        raise NotImplementedError(
            "speculative decoding needs an attention-only TARGET: recurrent "
            "state advanced through a rejected draft token cannot be "
            "rolled back")
    dlm = draft[0]
    for sub in dlm.period:
        if sub.mixer_kind not in ("attn_gqa", "attn_mla"):
            raise NotImplementedError(
                "speculative decoding needs an attention-only DRAFT (got "
                f"mixer {sub.mixer_kind!r})")
    if dlm.cfg.vocab_size != lm.cfg.vocab_size:
        raise ValueError(f"draft vocab {dlm.cfg.vocab_size} != target vocab "
                         f"{lm.cfg.vocab_size}")


def _tree_bytes(tree) -> tuple[int, int]:
    """(resident, fp32) bytes of a parameter tree's tensors."""
    ts = leaves(tree)
    return (sum(t.numel() * t.element_size() for t in ts),
            4 * sum(t.numel() for t in ts))


def _bucket_len(n: int, bucket: int) -> int:
    """Smallest multiple of ``bucket`` >= n (n itself when bucket <= 0)."""
    return n if bucket <= 0 else n + (-n) % bucket


class Engine:
    """Continuous-batching serving engine over a paged, quantized KV pool.

    ``device`` defaults to ``"cuda"`` and raises without a card unless
    ``device="cpu"`` is passed; ``params`` must already live there."""

    def __init__(self, lm: LMDef, params: dict, ecfg: EngineConfig,
                 device=None, clock=time.monotonic, plan=None, trace=None,
                 draft=None):
        if plan is not None:
            raise NotImplementedError("multi-device serving (ROADMAP queue "
                                      "1: sharding) is a later slice of the "
                                      "port")
        cfg = lm.cfg
        if cfg.is_encoder:
            raise NotImplementedError("encoder-only archs have no decode path")
        if cfg.frontend != "none":
            raise NotImplementedError(
                "frontend (vision/audio) serving is an open roadmap item")
        if ecfg.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {ecfg.spec_k}")
        self._spec = ecfg.spec_k > 0
        if self._spec:
            _check_draft(lm, draft)
        self.device = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        trees = [("params", params)]
        if self._spec:
            trees.append(("draft params", draft[1]))
        for what, tree in trees:
            wdev = tree["embed"]["w"].device
            if wdev.type != self.device.type:
                raise ValueError(f"{what} live on {wdev}, engine on "
                                 f"{self.device}")
        self.lm = lm
        self.params = params
        self.ecfg = ecfg
        # per-sublayer routing: attention -> paged KV pool, mamba/rwkv6 ->
        # slot-indexed recurrent-state pool
        self._attn_keys = tuple(f"sub_{i}" for i, sub in enumerate(lm.period)
                                if sub.mixer_kind not in STATE_MIXERS)
        self._state_keys = tuple(f"sub_{i}" for i, sub in enumerate(lm.period)
                                 if sub.mixer_kind in STATE_MIXERS)
        pcfg = ecfg.pool
        squant, sbits = pcfg.quantized, pcfg.bits
        if ecfg.policy is not None:
            # one owner for the system's numerics: the policy's kv_cache
            # site sets the KV pool's, its ssm_state site the state pool's
            pcfg = dataclasses.replace(
                pcfg, quantized=ecfg.policy.enable,
                bits=ecfg.policy.spec_for("kv_cache").bits)
            if self._state_keys:
                ss = ecfg.policy.spec_for("ssm_state")
                if (ss.kind, ss.storage_dtype) != ("pow2", "int8"):
                    raise NotImplementedError(
                        "the state cache stores pow2 int8 codes only; the "
                        f"ssm_state site asks for {ss.kind}/"
                        f"{ss.storage_dtype}")
                squant, sbits = ecfg.policy.enable, ss.bits
        self.pcfg = pcfg
        self.scfg = SC.StateCacheConfig(quantized=squant, bits=sbits)
        self.pool = KC.init_pool(lm, self.pcfg, self.device)
        self.spool = SC.init_state_pool(lm, self.pcfg.num_slots, self.scfg,
                                        self.device)
        # the natural dtype of each state tensor, as the decode step reads it
        self._state_dtypes = {
            f"sub_{i}": {n: SC.natural_dtype(kind, lm.cfg) for n, (_, kind)
                         in SC.state_feature_shapes(sub, lm.cfg).items()}
            for i, sub in enumerate(lm.period)
            if sub.mixer_kind in STATE_MIXERS}
        # optional obs.TraceRecorder: events come from the host-side step
        # loop only, so an attached recorder issues no device work
        self.trace = trace
        # quant health: counted in the decode step's KV appends and state
        # writes when the policy asks (and the pool is quantized)
        health = ecfg.policy is not None and ecfg.policy.health
        self._health_kv = health and self.pcfg.quantized \
            and bool(self._attn_keys)
        self._health_state = health and squant and bool(self._state_keys)
        self._health = self._health_kv or self._health_state
        # prefix sharing needs per-token paged memory: attention-only archs
        # opt in; a recurrent sublayer sends every request down the full
        # prefill (the cache is simply absent)
        self._prefix = (RadixPrefixCache(self.pcfg.page_size,
                                         self.pcfg.total_pages, trace=trace)
                        if (ecfg.prefix_cache and not self._state_keys)
                        else None)
        # pure-SSM archs have no token-paged memory: admission is slot-only
        self.sched = Scheduler(self.pcfg, ecfg.prefill_chunk,
                               prefix=self._prefix,
                               paged=bool(self._attn_keys), trace=trace)
        self.metrics = ServeMetrics(clock=clock)
        self.metrics.num_slots = self.pcfg.num_slots
        self.metrics.cache_bytes = KC.pool_bytes(self.pool)
        self.metrics.cache_bytes_fp32 = KC.pool_bytes_fp32(self.pool)
        self.metrics.state_bytes = SC.pool_bytes(self.spool)
        self.metrics.state_bytes_fp32 = SC.pool_bytes_fp32(self.spool)
        # the live memory ledger: the pools are preallocated, so their bytes
        # are fixed here; what moves is the prefix overlay (logical vs
        # physical mapped pages)
        self.ledger = MemoryLedger(self.device)
        self._page_nbytes = (KC.page_nbytes(self.pool, self.pcfg)
                             if self._attn_keys else 0)
        self._params_nbytes, self._params_nbytes_fp32 = _tree_bytes(params)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(ecfg.seed)
        self._completions: dict[int, Completion] = {}
        self._orig_prompt: dict[int, list[int]] = {}
        if self._spec:
            # the draft's own pool mirrors the target's geometry and
            # numerics (after the policy override) and shares nothing: a
            # static identity table (slot i owns pages i*pp .. (i+1)*pp-1),
            # so draft-side rollback is the length not advancing, and K/V
            # above a slot's length is masked as on the target's side
            self._draft, self._draft_params = draft
            self._draft_pcfg = dataclasses.replace(self.pcfg, num_pages=0)
            self._draft_pool = KC.init_pool(self._draft, self._draft_pcfg,
                                            self.device)
            pp = self._draft_pcfg.pages_per_slot
            self._draft_table = torch.arange(
                self.pcfg.num_slots * pp, dtype=torch.int32,
                device=self.device).reshape(self.pcfg.num_slots, pp)
            self._draft_params_nbytes, self._draft_params_nbytes_fp32 = \
                _tree_bytes(self._draft_params)
        self._ledger_update("init")

    # ---- device steps --------------------------------------------------
    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _sub_block(self, lm: LMDef, pool: dict, pcfg: PoolConfig,
                   fused: bool, pp: dict, x: torch.Tensor, layer: int,
                   key: str, sub, table, lens, active,
                   positions, health=None) -> torch.Tensor:
        """One sublayer over (B, S) new tokens at ``positions`` = lens ..
        lens+S-1: write their cache entries (one ``append_kv``, adding its
        clip counts to ``health`` when given), then attend each row
        causally through itself, off the pages (fused, GQA only) or over
        every slot's views read off them (``read_kv`` + ``_attend``).
        Inactive slots' rows are masked out of an MoE router."""
        cfg = lm.cfg
        b, s = x.shape[:2]
        h = rms_norm(x, pp["norm1"]["scale"], cfg.norm_eps)
        qd, new = _project(pp["mixer"], h, sub, cfg, positions)
        data = {n: t[layer] for n, t in pool["data"][key].items()}
        scale = {n: t[layer] for n, t in pool["scale_log2"][key].items()}
        kn, vn = new                # "k", "v" or "c_kv", "k_rope"
        KC.append_kv(data[kn], data[vn], scale[kn], scale[vn], new[kn],
                     new[vn], table, lens, active, pcfg, health)
        if fused and sub.mixer_kind == "attn_gqa":
            d = sub.mixer
            attn = KC.fused_attend(data["k"], data["v"], scale["k"],
                                   scale["v"],
                                   qd["q"][:, 0] if s == 1 else qd["q"],
                                   table, lens, pcfg)
            attn = attn[..., :d.real_heads, :].reshape(
                b, s, d.real_heads * d.head_dim)
            x = x + apply_site(pp["mixer"]["o"], attn, d.o, cfg)
        else:
            kv = dict(zip(new, KC.read_kv(data[kn], data[vn], scale[kn],
                                          scale[vn], table, pcfg, h.dtype)))
            x = x + _attend(pp["mixer"], qd, kv, sub, cfg, positions)
        return sub_ffn_decode(pp, x, sub, cfg,
                              token_mask=active[:, None].expand(b, s))

    def _block(self, lm: LMDef, params: dict, pool: dict, pcfg: PoolConfig,
               fused: bool, tokens, table, lens, active,
               health=None) -> torch.Tensor:
        """Forward of (B, S) tokens, row j of slot b at position lens[b] + j,
        over a paged pool updated in place: the decode step at S = 1, the
        speculative verify at S = k+1, and the draft's steps over its own
        pool. ``health`` (the decode step with health on): a (6,) int64
        counter — the KV appends add (clipped, total) to its first two
        entries, the state write (clipped, total, drift_sum, drift_n) to
        the last four. Returns logits (B, S, V)."""
        x = embed_tokens(params, tokens, lm)
        positions = lens[:, None] + torch.arange(
            tokens.shape[1], dtype=lens.dtype, device=lens.device)
        # the target's decode step only: spec (S > 1, and the draft) is
        # attention-only. Layer l's state is read only by layer l and what
        # it writes only by the next step: read all before the first
        # layer, write all after the last.
        stateful = any(sub.mixer_kind in STATE_MIXERS for sub in lm.period)
        if stateful:
            states = SC.read_step(self.spool, self._state_dtypes, self.scfg)
            new = {k: {n: [] for n in kinds}
                   for k, kinds in self._state_dtypes.items()}
        for layer, pp in enumerate(params["layers"]):
            for i, sub in enumerate(lm.period):
                key = f"sub_{i}"
                if sub.mixer_kind in STATE_MIXERS:
                    # advance every slot one token; write_step encodes the
                    # new state after the last layer
                    x, st = self._state_mix(
                        pp[key], x, sub,
                        {n: t[layer] for n, t in states[key].items()},
                        active[:, None])
                    for n, t in st.items():
                        new[key][n].append(t)
                    continue
                x = self._sub_block(lm, pool, pcfg, fused, pp[key], x,
                                    layer, key, sub, table, lens,
                                    active, positions,
                                    None if health is None or not
                                    self._health_kv else health[0:2])
        if stateful:
            SC.write_step(self.spool, new, active, self.scfg,
                          None if health is None or not self._health_state
                          else health[2:6])
        x = rms_norm(x, params["final_norm"]["scale"], lm.cfg.norm_eps)
        return apply_site(params["head"], x, lm.head, lm.cfg)

    def _state_mix(self, pp: dict, x: torch.Tensor, sub, state: dict,
                   token_mask: torch.Tensor | None = None,
                   capacity_tokens: int | None = None):
        """One recurrent sublayer from ``state``, through the forwards that
        static decode runs (the decode step at S = 1, the chunk step over
        the chunk); ``token_mask`` and ``capacity_tokens`` reach a Mamba
        sublayer's MoE. Returns (x, new state)."""
        cfg = self.lm.cfg
        h = rms_norm(x, pp["norm1"]["scale"], cfg.norm_eps)
        if sub.mixer_kind == "mamba":
            out, new_state = S.mamba_forward(pp["mixer"], h, sub.mixer, cfg,
                                             state)
            return sub_ffn_decode(pp, x + out, sub, cfg, token_mask,
                                  capacity_tokens), new_state
        # rwkv6: time mix and channel mix are the whole sublayer
        out, st1 = S.rwkv6_time_mix(pp["mixer"], h, sub.mixer, cfg, state)
        x = x + out
        h2 = rms_norm(x, pp["norm2"]["scale"], cfg.norm_eps)
        out2, st2 = S.rwkv6_channel_mix(pp["mixer"], h2, sub.mixer, cfg,
                                        state)
        return x + out2, {**st1, **st2}

    @torch.no_grad()
    def _decode(self, table, lens, active, tokens):
        """One batched decode step. tokens: (B,1); lens/active: (B,).
        Returns (logits (B, V), the step's (6,) int64 health counter or
        None when health is off); the pool is updated in place."""
        health = (torch.zeros(6, dtype=torch.int64, device=self.device)
                  if self._health else None)
        return self._block(self.lm, self.params, self.pool, self.pcfg,
                           self.ecfg.fused_attention, tokens, table, lens,
                           active, health)[:, 0], health

    @torch.no_grad()
    def _verify(self, table, lens, active, block) -> torch.Tensor:
        """The target over the (B, k+1) verify block (the incoming token and
        the k proposals) in one step: each layer writes the block's K/V
        with one ``append_kv`` and attends every row (the fused q-block or
        the paged read). Returns (B, k+1, V) logits; a rejected tail's K/V
        stays as junk above the slot's advanced length."""
        return self._block(self.lm, self.params, self.pool, self.pcfg,
                           self.ecfg.fused_attention, block, table, lens,
                           active)

    def _draft_step(self, lens, active, tokens) -> torch.Tensor:
        """One S = 1 decode step of the draft over its own pool, on the
        gather path whatever ``fused_attention`` says (as in the
        reference). Returns logits (B, V)."""
        return self._block(self._draft, self._draft_params, self._draft_pool,
                           self._draft_pcfg, False, tokens, self._draft_table,
                           lens, active)[:, 0]

    @torch.no_grad()
    def _draft_propose(self, lens, active, tokens, temp, topk, topp
                       ) -> tuple[torch.Tensor, torch.Tensor]:
        """k draft steps, each drawing its proposal from the processed draft
        distribution Q (kept: the accept test reads it, and greedy slots
        their one-hots), then the trailing cache-fill step at lens + k.
        Everything stays on the device. Returns ((B, k) int32 tokens,
        (B, k, V) probs)."""
        toks, probs = [], []
        cur = tokens
        for i in range(self.ecfg.spec_k):
            qp = processed_probs(self._draft_step(lens + i, active, cur),
                                 temp, topk, topp)
            t = sample_from_probs(qp, self._gen)
            toks.append(t)
            probs.append(qp)
            cur = t[:, None]
        # each step above writes its incoming token's K/V, so the last
        # proposal has none yet; when the target accepts all k, the next
        # round starts at lens + k + 1 and would read a hole at lens + k.
        # Feed it once more (logits unused); for a slot that rejected,
        # the write is junk above its final length
        self._draft_step(lens + self.ecfg.spec_k, active, cur)
        return torch.stack(toks, dim=1), torch.stack(probs, dim=1)

    @torch.no_grad()
    def _draft_prefill(self, slot: int, st) -> None:
        """Whole-prompt prefill of the draft for one slot into its pool (one
        ``p2_prefill_paged`` launch on an int8 pool). The draft always
        recomputes the full prompt: no chunking, no prefix sharing; bucket
        padding is masked out of an MoE draft's routers."""
        toks = st.req.prompt
        width = _bucket_len(len(toks), self.ecfg.prefill_bucket)
        _, _, cache = lm_forward(
            self._draft_params, self._draft,
            tokens=self._tensor([toks + [0] * (width - len(toks))],
                                torch.long), return_cache=True,
            token_mask=self._real_rows(width, len(toks)))
        KC.write_prefill(self._draft_pool, cache, self._draft_table[slot],
                         slot, self._tensor([len(toks)], torch.int32),
                         self._draft_pcfg)

    def _real_rows(self, width: int, n: int) -> torch.Tensor:
        """(1, width) bool: the first ``n`` rows are real tokens, the rest
        padding that no MoE router may route."""
        return (torch.arange(width, device=self.device) < n)[None]

    @torch.no_grad()
    def _prefill(self, toks: list[int], table_row: torch.Tensor, slot: int,
                 capacity_tokens: int | None = None) -> torch.Tensor:
        """A first chunk at position 0: the model's own forward, then one
        write of its cache into each pool: the attention sublayers' K/V
        into the paged pool (which chooses the slot's scales; one
        ``p2_prefill_paged`` launch on a quantized pool), the recurrent
        sublayers' post-prompt state into the slot of the state pool (one
        ``st_enc_slot`` launch on an int8 pool). A stateful arch runs
        exact-length. Bucket padding is masked out of the MoE routers,
        whose capacity takes ``capacity_tokens`` as its basis when given.
        Returns the last real position's logits (1, V)."""
        bucket = 0 if self._state_keys else self.ecfg.prefill_bucket
        width = _bucket_len(len(toks), bucket)
        logits, _, cache = lm_forward(
            self.params, self.lm,
            tokens=self._tensor([toks + [0] * (width - len(toks))],
                                torch.long),
            return_cache=True, token_mask=self._real_rows(width, len(toks)),
            capacity_tokens=capacity_tokens)
        # the prompt's length and the slot on the device, in one copy: the
        # writes read them there
        meta = (self._tensor([len(toks), slot], torch.int32)
                if self._attn_keys or self.scfg.quantized else None)
        if self._attn_keys:
            KC.write_prefill(self.pool, {k: cache[k] for k in self._attn_keys},
                             table_row, slot, meta[0:1], self.pcfg)
        if self._state_keys:
            SC.write_prefill(self.spool,
                             {k: cache[k] for k in self._state_keys}, slot,
                             self.scfg, None if meta is None else meta[1:2])
        return logits[0, len(toks) - 1][None]

    def _sub_chunk(self, pp: dict, x: torch.Tensor, layer: int, key: str,
                   sub, table, slot: int, start, n_valid, positions,
                   token_mask, capacity_tokens) -> torch.Tensor:
        cfg = self.lm.cfg
        h = rms_norm(x, pp["norm1"]["scale"], cfg.norm_eps)
        qd, new = _project(pp["mixer"], h, sub, cfg, positions)
        data = {n: t[layer] for n, t in self.pool["data"][key].items()}
        scale = {n: t[layer, slot:slot + 1]
                 for n, t in self.pool["scale_log2"][key].items()}
        kn, vn = new
        KC.write_chunk_kv(data[kn], data[vn], scale[kn], scale[vn], new[kn],
                          new[vn], table, start, n_valid, self.pcfg)
        kv = dict(zip(new, KC.read_kv(data[kn], data[vn], scale[kn],
                                      scale[vn], table, self.pcfg, h.dtype)))
        x = x + _attend(pp["mixer"], qd, kv, sub, cfg, positions)
        return sub_ffn_decode(pp, x, sub, cfg, token_mask, capacity_tokens)

    @torch.no_grad()
    def _chunk(self, toks: list[int], table_row: torch.Tensor, slot: int,
               start: int, capacity_tokens: int | None = None
               ) -> torch.Tensor:
        """Chunked-prefill step of one slot (the reference's
        ``_chunk_impl``): each attention layer writes the chunk's K/V into
        the pool under the slot's scale and attends over the slot's whole
        history, read off the pages (not the fused kernel, as in the
        reference); each recurrent layer scans the chunk from the slot's
        carried state and writes the end-of-chunk state back. ``toks`` is
        padded to the chunk width (or the bucketed length when chunking is
        off), except on a stateful arch; pad rows go to the trash page.
        The slot's scales stay on the device, as (1,) views. A recurrent
        layer's state is read only by that layer and what it writes only by
        the next step, so the slot's state of every layer is read before
        the first layer (``read_slot``) and written after the last
        (``write_slot_step``). The pad rows are masked out of the MoE
        routers, which route over the padded width (the reference's
        capacity clamp) with ``capacity_tokens`` as the capacity's basis
        when given. Returns the last real position's logits (1, V)."""
        lm, ecfg = self.lm, self.ecfg
        if self._state_keys:
            width = len(toks)
        else:
            width = (ecfg.prefill_chunk if ecfg.prefill_chunk > 0
                     else _bucket_len(len(toks), ecfg.prefill_bucket))
        tokens = self._tensor([toks + [0] * (width - len(toks))], torch.long)
        positions = (start + torch.arange(width, device=self.device))[None]
        # the chunk's (1,) start, valid count and slot, on the device in
        # one copy a step
        start_t, valid_t, slot_t = self._tensor(
            [[start], [len(toks)], [slot]], torch.int32)
        x = embed_tokens(self.params, tokens, lm)
        mask = self._real_rows(width, len(toks))
        if self._state_keys:
            states = SC.read_slot(self.spool, self._state_dtypes, slot,
                                  self.scfg, slot_t)
            new = {k: {n: [] for n in kinds}
                   for k, kinds in self._state_dtypes.items()}
        for layer, pp in enumerate(self.params["layers"]):
            for i, sub in enumerate(lm.period):
                key = f"sub_{i}"
                if sub.mixer_kind in STATE_MIXERS:
                    # scan the chunk from the slot's state; write_slot_step
                    # encodes the end-of-chunk state after the last layer
                    x, st = self._state_mix(
                        pp[key], x, sub,
                        {n: t[layer] for n, t in states[key].items()},
                        mask, capacity_tokens)
                    for n, t in st.items():
                        new[key][n].append(t)
                    continue
                x = self._sub_chunk(pp[key], x, layer, key, sub,
                                    table_row[None], slot, start_t, valid_t,
                                    positions, mask, capacity_tokens)
        if self._state_keys:
            SC.write_slot_step(self.spool, new, slot, self.scfg, slot_t)
        x = x[:, len(toks) - 1:len(toks)]
        x = rms_norm(x, self.params["final_norm"]["scale"], lm.cfg.norm_eps)
        return apply_site(self.params["head"], x, lm.head, lm.cfg)[:, 0]

    def _do_prefill(self, slot: int, st) -> None:
        """Prefill one admitted request (the reference's ``_do_prefill``):
        on a prefix hit, adopt the donor's scales, make the COW copy and
        compute only the suffix through the chunk step; else the first
        chunk through ``lm_forward`` and later ones through the chunk step.
        Then sample the first token and donate the prompt's full pages to
        the prefix tree."""
        plen, resume = st.prompt_len, st.prefix_len
        trace = self.trace
        t0 = trace.clock() if trace is not None else 0.0
        self._ledger_update("prefill")
        table_row = self._tensor(self.sched.page_table[slot])
        if self._state_keys:
            # reset-on-admit: the slot may hold a retired or preempted
            # request's state (the first chunk overwrites every tensor
            # anyway; this is hygiene against partial writes)
            SC.reset_slot(self.spool, slot)
        if resume > 0:
            if self.pcfg.quantized and st.prefix_scales is not None:
                KC.adopt_scales(self.pool, slot, st.prefix_scales)
            if st.fork is not None:
                KC.fork_page(self.pool, *st.fork)
                self.metrics.cow_forked()
                if trace is not None:
                    trace.emit("cow_fork", rid=st.req.rid, slot=slot,
                               src_page=st.fork[0], dst_page=st.fork[1],
                               tokens=resume % self.pcfg.page_size)
            self.metrics.prefix_hit(resume, resume // self.pcfg.page_size)
            if trace is not None:
                trace.emit("cache_hit", rid=st.req.rid, slot=slot,
                           hit_tokens=resume, prompt_len=plen)
            c = self.ecfg.prefill_chunk
            chunks = ([(s, min(s + c, plen)) for s in range(resume, plen, c)]
                      if c > 0 else [(resume, plen)])
        else:
            chunks = self.sched.prefill_chunks(plen)
        # MoE capacity parity: every prefill shape of the request takes its
        # capacity from the whole prompt
        cap = plen if self.ecfg.moe_capacity_by_prompt else None
        for c0, c1 in chunks:
            toks = st.req.prompt[c0:c1]
            if trace is not None and len(chunks) > 1:
                trace.emit("prefill_chunk", rid=st.req.rid, slot=slot,
                           start=c0, len=c1 - c0)
            last = (self._prefill(toks, table_row, slot, cap) if c0 == 0
                    else self._chunk(toks, table_row, slot, c0, cap))
        self.metrics.prefill(plen, computed=plen - resume)
        if self._spec:
            # the draft tracks the slot from position 0; a preempted
            # request re-enters here with its generated prefix folded in,
            # so its draft cache is rebuilt too
            self._draft_prefill(slot, st)
        tok = int(self._sample(last, [slot])[0])
        st.generated.append(tok)
        st.last_token = tok
        self.metrics.request_first_token(st.req.rid)
        if self._prefix is not None:
            scales = (KC.snapshot_scales(self.pool, slot)
                      if self.pcfg.quantized else None)
            self.sched.commit_prefix(slot, scales)
        if trace is not None:
            trace.emit("prefill", rid=st.req.rid, slot=slot, len=plen,
                       dur=trace.clock() - t0)
            trace.emit("first_token", rid=st.req.rid, slot=slot)

    def _knobs(self, slots: list[int]) -> tuple[torch.Tensor, ...]:
        """The slots' (temperature, top_k, top_p) vectors on the device."""
        sp = [self.sched.slots[s].req.sampling if self.sched.slots[s]
              else SamplingParams() for s in slots]
        return (self._tensor([p.temperature for p in sp], torch.float32),
                self._tensor([p.top_k for p in sp], torch.int32),
                self._tensor([p.top_p for p in sp], torch.float32))

    def _sample(self, logits: torch.Tensor, slots: list[int]) -> np.ndarray:
        return sample_tokens(logits, self._gen,
                             *self._knobs(slots)).cpu().numpy()

    def _spec_step(self, active_slots: list[int]) -> None:
        """One speculative round over the batch: k draft proposals per
        slot, one verify block on the target, the accept test on the
        device, then ONE host read-back of the accept lengths, next
        tokens and proposals together. Each slot emits its accepted prefix
        and its next token, cut at eos or max_new_tokens, and frees the
        pages a rejected tail left mapped (``trim_unused``)."""
        sched = self.sched
        k = self.ecfg.spec_k
        table = self._tensor(sched.page_table)
        lens = self._tensor(sched.lens_vector())
        active = self._tensor(sched.active_mask())
        tokens = self._tensor(sched.tokens_vector())
        knobs = self._knobs(list(range(self.pcfg.num_slots)))
        t0 = self.trace.clock() if self.trace is not None else 0.0
        dtoks, dprobs = self._draft_propose(lens, active, tokens, *knobs)
        vlogits = self._verify(table, lens, active,
                               torch.cat([tokens, dtoks], dim=1))
        acc, nxt = spec_accept(vlogits, dprobs, dtoks, self._gen, *knobs)
        host = torch.cat([acc[:, None], nxt[:, None], dtoks], dim=1
                         ).cpu().numpy()
        dur = (self.trace.clock() - t0) if self.trace is not None else None
        accepted = emitted = 0
        for slot in active_slots:
            st = sched.slots[slot]
            a = int(host[slot, 0])
            accepted += a
            # tokens past a stop never leave the engine: their K/V junk
            # sits above the slot's final length and the slot retires
            for tok in [int(t) for t in host[slot, 2:2 + a]] + [
                    int(host[slot, 1])]:
                st.generated.append(tok)
                st.last_token = tok
                emitted += 1
                if st.done():
                    break
            sched.trim_unused(slot)
            if st.done():
                self._finish(slot)
        free_pages = sched.alloc.free_pages
        self.metrics.decode_step(emitted, free_pages, dur=dur)
        self.metrics.spec_step(len(active_slots), k * len(active_slots),
                               accepted, emitted)
        self._ledger_update("decode")
        if self.trace is not None:
            self.trace.emit("spec_step", step=self.metrics.decode_steps,
                            n_active=len(active_slots),
                            proposed=k * len(active_slots),
                            accepted=accepted, emitted=emitted,
                            free_pages=free_pages, dur=dur)

    # ---- request lifecycle --------------------------------------------
    def submit(self, prompt: list[int], max_new_tokens: int = 32,
               sampling: SamplingParams | None = None,
               eos_id: int = -1) -> int:
        req = Request(prompt=list(prompt), max_new_tokens=max_new_tokens,
                      sampling=sampling or SamplingParams(), eos_id=eos_id)
        rid = self.sched.submit(req)
        self._orig_prompt[rid] = list(prompt)
        self.metrics.request_submitted(rid)
        if self.trace is not None:
            self.trace.emit("submit", rid=rid, prompt_len=len(prompt),
                            max_new=max_new_tokens)
        return rid

    def _finish(self, slot: int) -> None:
        st = self.sched.retire(slot)
        rid = st.req.rid
        orig = self._orig_prompt[rid]
        tokens = (st.req.prompt + st.generated)[len(orig):]
        self._completions[rid] = Completion(rid, orig, tokens)
        self.metrics.request_finished(rid, len(tokens))
        if self.trace is not None:
            reason = ("max_new" if len(st.generated) >= st.req.max_new_tokens
                      else "eos")
            self.trace.emit("retire", rid=rid, slot=slot,
                            new_tokens=len(tokens), reason=reason)

    def step(self) -> None:
        """One engine iteration: admit + prefill, then one batched decode
        (or one speculative round)."""
        sched = self.sched
        while (adm := sched.try_admit()) is not None:
            slot, st = adm
            self.metrics.request_admitted(st.req.rid, st.prompt_len)
            if self.trace is not None:
                self.trace.emit("admit", rid=st.req.rid, slot=slot,
                                pages=len(sched.slot_pages[slot]))
            self._do_prefill(slot, st)
            if st.done():
                self._finish(slot)

        active_slots = [i for i, s in enumerate(sched.slots) if s is not None]
        # map the page(s) each active slot is about to write: one for
        # decode, the k+1 verify span for speculative decoding; preempt
        # the youngest slot while the pool is exhausted
        span = self.ecfg.spec_k + 1 if self._spec else 1
        for slot in active_slots:
            if sched.slots[slot] is None:
                continue
            while not sched.ensure_span(slot, span):
                # the victim, before the retire clears its slot
                yst = (sched.slots[sched.admission_order[-1]]
                       if len(sched.admission_order) > 1 else None)
                evicted = sched.preempt_youngest()
                if evicted is None:
                    raise RuntimeError(
                        "KV pool exhausted and nothing to preempt — "
                        "increase num_pages/pages_per_slot")
                self.metrics.preempted()
                if self.trace is not None:
                    self.trace.emit("preempt", rid=yst.req.rid, slot=evicted,
                                    gen_len=len(yst.generated))
                if evicted == slot:
                    break
        active_slots = [i for i, s in enumerate(sched.slots) if s is not None]
        if not active_slots:
            return
        if self._spec:
            self._spec_step(active_slots)
            return
        t0 = self.trace.clock() if self.trace is not None else 0.0
        logits, health = self._decode(self._tensor(sched.page_table),
                                      self._tensor(sched.lens_vector()),
                                      self._tensor(sched.active_mask()),
                                      self._tensor(sched.tokens_vector()))
        toks = self._sample(logits, list(range(self.pcfg.num_slots)))
        dur = (self.trace.clock() - t0) if self.trace is not None else None
        free_pages = sched.alloc.free_pages if sched.paged else None
        for slot in active_slots:
            st = sched.slots[slot]
            st.generated.append(int(toks[slot]))
            st.last_token = int(toks[slot])
            if st.done():
                self._finish(slot)
        self.metrics.decode_step(len(active_slots), free_pages, dur=dur)
        self._ledger_update("decode")
        if self.trace is not None:
            self.trace.emit("decode_step", step=self.metrics.decode_steps,
                            n_active=len(active_slots),
                            free_pages=free_pages, dur=dur)
        if health is not None:
            h = health.tolist()         # the step's one read-back of it
            if self._health_kv:
                self.metrics.record_health("kv_cache", h[0], h[1])
            if self._health_state:
                self.metrics.record_health("ssm_state", h[2], h[3],
                                           float(h[4]), float(h[5]))

    def run(self) -> dict[int, Completion]:
        """Drive until every submitted request has completed."""
        while self.sched.has_work():
            self.step()
        return dict(self._completions)

    # ---- memory ledger -------------------------------------------------
    def _ledger_update(self, phase: str | None = None) -> None:
        """Refresh every serve-side ledger site (host ints only). Counted
        sites are the resident allocations; the prefix pages are an
        uncounted overlay of ``kv_pool`` whose logical-vs-physical split
        turns page sharing into verified bytes."""
        led = self.ledger
        if phase is not None:
            led.set_phase(phase)
        led.set("params", self._params_nbytes, fp32=self._params_nbytes_fp32)
        led.set("kv_pool", self.metrics.cache_bytes,
                fp32=self.metrics.cache_bytes_fp32)
        led.set("state_pool", self.metrics.state_bytes,
                fp32=self.metrics.state_bytes_fp32)
        if self._spec:
            led.set("draft_params", self._draft_params_nbytes,
                    fp32=self._draft_params_nbytes_fp32)
            led.set("draft_kv_pool", KC.pool_bytes(self._draft_pool),
                    fp32=KC.pool_bytes_fp32(self._draft_pool))
        if self.sched.paged:
            logical, physical = self.sched.mapped_page_stats()
            pb = self._page_nbytes
            led.set("prefix_pages_logical", logical * pb, counted=False,
                    pages=logical)
            led.set("prefix_pages_physical", physical * pb, counted=False,
                    pages=physical)
            led.set("prefix_bytes_saved", (logical - physical) * pb,
                    counted=False)
        if self._prefix is not None:
            stats = self._prefix.bytes_stats(self._page_nbytes)
            led.set("prefix_tree", stats["bytes"], counted=False,
                    pages=stats["pages"], pages_pinned=stats["pages_pinned"],
                    nodes=stats["nodes"])

    def _live_tensors(self) -> list:
        """What the engine holds: params, both pools, the draft's params
        and pool (a CPU reconcile counts their storages)."""
        out = [self.params, self.pool, self.spool]
        if self._spec:
            out += [self._draft_params, self._draft_pool]
        return out

    def summary(self) -> dict:
        if self._prefix is not None:
            self.metrics.prefix_evictions = self._prefix.evictions
        if self.trace is not None:
            self.metrics.trace_dropped = self.trace.dropped
        self.metrics.counter_totals = registry.snapshot()
        self._ledger_update()
        out = self.metrics.summary()
        out["device"] = str(self.device)
        mem = self.ledger.summary()
        mem["reconcile"] = self.ledger.reconcile(
            tensors=self._live_tensors())
        out["memory"] = mem
        return out
