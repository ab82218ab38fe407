"""Continuous-batching inference engine — the port of
``repro/serve/engine.py`` for dense GQA models, pure-SSM RWKV6 and the
Jamba hybrid (Mamba and attention, dense FFNs).

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

Sublayer routing: attention sublayers read and write the paged KV pool;
mamba and rwkv6 sublayers the slot-indexed recurrent-state pool
(``serve/state_cache.py``), through the forwards of ``models/ssm.py``
that static decode runs (at S = 1 for the decode step). A decode
step reads every such layer's state for every slot before its first layer
(``state_cache.read_step``: one ``st_dec_group`` launch on an int8 pool),
advances each layer's one token and writes the active slots' new states
back after its last layer (``write_step``: one ``st_enc_group``); a chunk
step reads and writes the one slot's a layer (``p2_dec`` / ``p2_enc``); a
whole-prompt prefill
writes every layer's at once (one ``p2_enc_rows`` a tensor, ``p2_enc``
when the stack is one period deep). A stateful arch resets the slot's
state on admission, prefills exact-length (no bucket pad, no padded
chunk: a pad token would enter the recurrence), takes no prefix cache,
and a pure-SSM arch runs the scheduler unpaged. Speculative decoding
needs an attention-only target and draft (a state advanced through a
rejected token cannot roll back).

Numerics: float32 matmuls stay float32 on the card — the engine sets
``torch.backends.cuda.matmul.allow_tf32 = False`` (and cuDNN's) where it
is built, so the fp32 fused-vs-gather identity holds as in the reference.
The pool is updated in place (see ``kv_cache``); PyTorch runs eagerly, so
there is no compiled-step cache.

Not carried over: the reference's ``CompileCache`` / ``max_prefill_shapes``
(they bound live jitted prefill shapes; eager PyTorch compiles none).
Still to port (they raise ``NotImplementedError`` naming what they wait
for): MoE/MLA sublayers (at ``build_lm``), a mesh, quant-health policies
and trace recorders.
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
        if sub.mixer_kind != "attn_gqa":
            raise NotImplementedError(
                "speculative decoding needs an attention-only DRAFT (got "
                f"mixer {sub.mixer_kind!r}; the port serves attn_gqa)")
    if dlm.cfg.vocab_size != lm.cfg.vocab_size:
        raise ValueError(f"draft vocab {dlm.cfg.vocab_size} != target vocab "
                         f"{lm.cfg.vocab_size}")


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
        later = [(ecfg.policy is not None and ecfg.policy.health,
                  "quant health (ROADMAP queue 1, item 6: obs/)"),
                 (plan is not None, "multi-device serving (ROADMAP queue 1: "
                  "sharding)"),
                 (trace is not None, "trace recorders (ROADMAP queue 1: "
                  "obs/)")]
        for asked, what in later:
            if asked:
                raise NotImplementedError(f"{what} is a later slice of the "
                                          "port")
        cfg = lm.cfg
        if cfg.is_encoder:
            raise NotImplementedError("encoder-only archs have no decode path")
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
        # prefix sharing needs per-token paged memory: attention-only archs
        # opt in; a recurrent sublayer sends every request down the full
        # prefill (the cache is simply absent)
        self._prefix = (RadixPrefixCache(self.pcfg.page_size,
                                         self.pcfg.total_pages)
                        if (ecfg.prefix_cache and not self._state_keys)
                        else None)
        # pure-SSM archs have no token-paged memory: admission is slot-only
        self.sched = Scheduler(self.pcfg, ecfg.prefill_chunk,
                               prefix=self._prefix,
                               paged=bool(self._attn_keys))
        self.metrics = ServeMetrics(clock=clock)
        self.metrics.num_slots = self.pcfg.num_slots
        self.metrics.cache_bytes = KC.pool_bytes(self.pool)
        self.metrics.cache_bytes_fp32 = KC.pool_bytes_fp32(self.pool)
        self.metrics.state_bytes = SC.pool_bytes(self.spool)
        self.metrics.state_bytes_fp32 = SC.pool_bytes_fp32(self.spool)
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

    # ---- device steps --------------------------------------------------
    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _sub_block(self, lm: LMDef, pool: dict, pcfg: PoolConfig,
                   fused: bool, pp: dict, x: torch.Tensor, layer: int,
                   key: str, sub, table, lens, active,
                   positions) -> torch.Tensor:
        """One sublayer over (B, S) new tokens at ``positions`` = lens ..
        lens+S-1: write their K/V (one ``append_kv``), then attend each
        row causally through itself, off the pages (fused) or over every
        slot's view read off them (``read_kv`` + ``gqa_attend``)."""
        cfg = lm.cfg
        d = sub.mixer
        b, s = x.shape[:2]
        h = rms_norm(x, pp["norm1"]["scale"], cfg.norm_eps)
        q, k_new, v_new = A.gqa_decode_qkv(pp["mixer"], h, d, cfg, positions)
        data = {n: t[layer] for n, t in pool["data"][key].items()}
        scale = {n: t[layer] for n, t in pool["scale_log2"][key].items()}
        KC.append_kv(data["k"], data["v"], scale["k"], scale["v"], k_new,
                     v_new, table, lens, active, pcfg)
        if fused:
            attn = KC.fused_attend(data["k"], data["v"], scale["k"],
                                   scale["v"], q[:, 0] if s == 1 else q,
                                   table, lens, pcfg)
            attn = attn[..., :d.real_heads, :].reshape(
                b, s, d.real_heads * d.head_dim)
        else:
            k, v = KC.read_kv(data["k"], data["v"], scale["k"], scale["v"],
                              table, pcfg, h.dtype)
            attn = A.gqa_attend(q, k, v, d, positions)
        x = x + apply_site(pp["mixer"]["o"], attn, d.o, cfg)
        return sub_ffn_decode(pp, x, sub, cfg)

    def _block(self, lm: LMDef, params: dict, pool: dict, pcfg: PoolConfig,
               fused: bool, tokens, table, lens, active) -> torch.Tensor:
        """Forward of (B, S) tokens, row j of slot b at position lens[b] + j,
        over a paged pool updated in place: the decode step at S = 1, the
        speculative verify at S = k+1, and the draft's steps over its own
        pool. Returns logits (B, S, V)."""
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
                        {n: t[layer] for n, t in states[key].items()})
                    for n, t in st.items():
                        new[key][n].append(t)
                    continue
                x = self._sub_block(lm, pool, pcfg, fused, pp[key], x,
                                    layer, key, sub, table, lens,
                                    active, positions)
        if stateful:
            SC.write_step(self.spool, new, active, self.scfg)
        x = rms_norm(x, params["final_norm"]["scale"], lm.cfg.norm_eps)
        return apply_site(params["head"], x, lm.head, lm.cfg)

    def _state_mix(self, pp: dict, x: torch.Tensor, sub, state: dict):
        """One recurrent sublayer from ``state``, through the forwards that
        static decode runs (the decode step at S = 1, the chunk step over
        the chunk). Returns (x, new state)."""
        cfg = self.lm.cfg
        h = rms_norm(x, pp["norm1"]["scale"], cfg.norm_eps)
        if sub.mixer_kind == "mamba":
            out, new_state = S.mamba_forward(pp["mixer"], h, sub.mixer, cfg,
                                             state)
            return sub_ffn_decode(pp, x + out, sub, cfg), new_state
        # rwkv6: time mix and channel mix are the whole sublayer
        out, st1 = S.rwkv6_time_mix(pp["mixer"], h, sub.mixer, cfg, state)
        x = x + out
        h2 = rms_norm(x, pp["norm2"]["scale"], cfg.norm_eps)
        out2, st2 = S.rwkv6_channel_mix(pp["mixer"], h2, sub.mixer, cfg,
                                        state)
        return x + out2, {**st1, **st2}

    @torch.no_grad()
    def _decode(self, table, lens, active, tokens) -> torch.Tensor:
        """One batched decode step. tokens: (B,1); lens/active: (B,).
        Returns logits (B, V); the pool is updated in place."""
        return self._block(self.lm, self.params, self.pool, self.pcfg,
                           self.ecfg.fused_attention, tokens, table, lens,
                           active)[:, 0]

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
        recomputes the full prompt: no chunking, no prefix sharing. The
        reference masks bucket padding out of the forward with
        ``token_mask``, which changes MoE routing only; the port has no
        MoE, so its ``lm_forward`` takes none."""
        toks = st.req.prompt
        padded = toks + [0] * (_bucket_len(len(toks), self.ecfg.prefill_bucket)
                               - len(toks))
        _, _, cache = lm_forward(
            self._draft_params, self._draft,
            tokens=self._tensor([padded], torch.long), return_cache=True)
        KC.write_prefill(self._draft_pool, cache, self._draft_table[slot],
                         slot, self._tensor([len(toks)], torch.int32),
                         self._draft_pcfg)

    @torch.no_grad()
    def _prefill(self, toks: list[int], table_row: torch.Tensor,
                 slot: int) -> torch.Tensor:
        """A first chunk at position 0: the model's own forward, then one
        write of its cache into each pool: the attention sublayers' K/V
        into the paged pool (which chooses the slot's scales; one
        ``p2_prefill_paged`` launch on a quantized pool), the recurrent
        sublayers' post-prompt state into the slot of the state pool (one
        encode launch a state tensor on an int8 pool). A stateful arch
        runs exact-length. Returns the last real position's logits (1, V)."""
        bucket = 0 if self._state_keys else self.ecfg.prefill_bucket
        padded = toks + [0] * (_bucket_len(len(toks), bucket) - len(toks))
        logits, _, cache = lm_forward(
            self.params, self.lm, tokens=self._tensor([padded], torch.long),
            return_cache=True)
        if self._attn_keys:
            # the prompt's length on the device: the write reads it there
            KC.write_prefill(self.pool, {k: cache[k] for k in self._attn_keys},
                             table_row, slot,
                             self._tensor([len(toks)], torch.int32),
                             self.pcfg)
        if self._state_keys:
            SC.write_prefill(self.spool,
                             {k: cache[k] for k in self._state_keys}, slot,
                             self.scfg)
        return logits[0, len(toks) - 1][None]

    def _sub_chunk(self, pp: dict, x: torch.Tensor, layer: int, key: str,
                   sub, table, slot: int, start, n_valid,
                   positions) -> torch.Tensor:
        cfg = self.lm.cfg
        d = sub.mixer
        h = rms_norm(x, pp["norm1"]["scale"], cfg.norm_eps)
        q, k_new, v_new = A.gqa_decode_qkv(pp["mixer"], h, d, cfg, positions)
        data = {n: t[layer] for n, t in self.pool["data"][key].items()}
        scale = {n: t[layer, slot:slot + 1]
                 for n, t in self.pool["scale_log2"][key].items()}
        KC.write_chunk_kv(data["k"], data["v"], scale["k"], scale["v"], k_new,
                          v_new, table, start, n_valid, self.pcfg)
        k, v = KC.read_kv(data["k"], data["v"], scale["k"], scale["v"], table,
                          self.pcfg, h.dtype)
        attn = A.gqa_attend(q, k, v, d, positions)
        x = x + apply_site(pp["mixer"]["o"], attn, d.o, cfg)
        return sub_ffn_decode(pp, x, sub, cfg)

    def _sub_chunk_state(self, pp: dict, x: torch.Tensor, layer: int,
                         key: str, sub, slot: int) -> torch.Tensor:
        """One recurrent sublayer of the chunk step: decode the slot's state
        (one ``p2_dec`` launch a tensor on an int8 pool: a one-element
        scale), scan the chunk from it, encode the end-of-chunk state back
        (one ``p2_enc`` a tensor)."""
        cfg = self.lm.cfg
        shapes = SC.state_feature_shapes(sub, cfg)
        data = {n: t[layer] for n, t in self.spool["data"][key].items()}
        scale = {n: t[layer] for n, t in self.spool["scale_log2"][key].items()}
        state = {n: SC.read_layer(data[n][slot][None], scale[n][slot][None],
                                  SC.natural_dtype(kind, cfg), self.scfg)
                 for n, (_, kind) in shapes.items()}
        x, new_state = self._state_mix(pp, x, sub, state)
        for n in shapes:
            SC.write_slot(data[n], scale[n], new_state[n][0], slot, self.scfg)
        return x

    @torch.no_grad()
    def _chunk(self, toks: list[int], table_row: torch.Tensor, slot: int,
               start: int) -> torch.Tensor:
        """Chunked-prefill step of one slot (the reference's
        ``_chunk_impl``): each attention layer writes the chunk's K/V into
        the pool under the slot's scale and attends over the slot's whole
        history, read off the pages (not the fused kernel, as in the
        reference); each recurrent layer scans the chunk from the slot's
        carried state and writes the end-of-chunk state back. ``toks`` is
        padded to the chunk width (or the bucketed length when chunking is
        off), except on a stateful arch; pad rows go to the trash page.
        The slot's scales stay on the device, as (1,) views. Returns the
        last real position's logits (1, V)."""
        lm, ecfg = self.lm, self.ecfg
        if self._state_keys:
            width = len(toks)
        else:
            width = (ecfg.prefill_chunk if ecfg.prefill_chunk > 0
                     else _bucket_len(len(toks), ecfg.prefill_bucket))
        tokens = self._tensor([toks + [0] * (width - len(toks))], torch.long)
        positions = (start + torch.arange(width, device=self.device))[None]
        # the chunk's (1,) start and valid count, on the device once a step
        start_t, valid_t = self._tensor([[start], [len(toks)]], torch.int32)
        x = embed_tokens(self.params, tokens, lm)
        for layer, pp in enumerate(self.params["layers"]):
            for i, sub in enumerate(lm.period):
                if sub.mixer_kind in STATE_MIXERS:
                    x = self._sub_chunk_state(pp[f"sub_{i}"], x, layer,
                                              f"sub_{i}", sub, slot)
                    continue
                x = self._sub_chunk(pp[f"sub_{i}"], x, layer, f"sub_{i}", sub,
                                    table_row[None], slot, start_t, valid_t,
                                    positions)
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
            self.metrics.prefix_hit(resume, resume // self.pcfg.page_size)
            c = self.ecfg.prefill_chunk
            chunks = ([(s, min(s + c, plen)) for s in range(resume, plen, c)]
                      if c > 0 else [(resume, plen)])
        else:
            chunks = self.sched.prefill_chunks(plen)
        for c0, c1 in chunks:
            toks = st.req.prompt[c0:c1]
            last = (self._prefill(toks, table_row, slot) if c0 == 0
                    else self._chunk(toks, table_row, slot, c0))
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
        dtoks, dprobs = self._draft_propose(lens, active, tokens, *knobs)
        vlogits = self._verify(table, lens, active,
                               torch.cat([tokens, dtoks], dim=1))
        acc, nxt = spec_accept(vlogits, dprobs, dtoks, self._gen, *knobs)
        host = torch.cat([acc[:, None], nxt[:, None], dtoks], dim=1
                         ).cpu().numpy()
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
        self.metrics.decode_step(emitted, sched.alloc.free_pages)
        self.metrics.spec_step(len(active_slots), k * len(active_slots),
                               accepted, emitted)

    # ---- request lifecycle --------------------------------------------
    def submit(self, prompt: list[int], max_new_tokens: int = 32,
               sampling: SamplingParams | None = None,
               eos_id: int = -1) -> int:
        req = Request(prompt=list(prompt), max_new_tokens=max_new_tokens,
                      sampling=sampling or SamplingParams(), eos_id=eos_id)
        rid = self.sched.submit(req)
        self._orig_prompt[rid] = list(prompt)
        self.metrics.request_submitted(rid)
        return rid

    def _finish(self, slot: int) -> None:
        st = self.sched.retire(slot)
        rid = st.req.rid
        orig = self._orig_prompt[rid]
        tokens = (st.req.prompt + st.generated)[len(orig):]
        self._completions[rid] = Completion(rid, orig, tokens)
        self.metrics.request_finished(rid, len(tokens))

    def step(self) -> None:
        """One engine iteration: admit + prefill, then one batched decode
        (or one speculative round)."""
        sched = self.sched
        while (adm := sched.try_admit()) is not None:
            slot, st = adm
            self.metrics.request_admitted(st.req.rid, st.prompt_len)
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
                evicted = sched.preempt_youngest()
                if evicted is None:
                    raise RuntimeError(
                        "KV pool exhausted and nothing to preempt — "
                        "increase num_pages/pages_per_slot")
                self.metrics.preempted()
                if evicted == slot:
                    break
        active_slots = [i for i, s in enumerate(sched.slots) if s is not None]
        if not active_slots:
            return
        if self._spec:
            self._spec_step(active_slots)
            return
        logits = self._decode(self._tensor(sched.page_table),
                              self._tensor(sched.lens_vector()),
                              self._tensor(sched.active_mask()),
                              self._tensor(sched.tokens_vector()))
        toks = self._sample(logits, list(range(self.pcfg.num_slots)))
        free_pages = sched.alloc.free_pages if sched.paged else None
        for slot in active_slots:
            st = sched.slots[slot]
            st.generated.append(int(toks[slot]))
            st.last_token = int(toks[slot])
            if st.done():
                self._finish(slot)
        self.metrics.decode_step(len(active_slots), free_pages)

    def run(self) -> dict[int, Completion]:
        """Drive until every submitted request has completed."""
        while self.sched.has_work():
            self.step()
        return dict(self._completions)

    def summary(self) -> dict:
        if self._prefix is not None:
            self.metrics.prefix_evictions = self._prefix.evictions
        out = self.metrics.summary()
        out["device"] = str(self.device)
        return out
