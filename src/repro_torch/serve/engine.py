"""Continuous-batching inference engine — the port of
``repro/serve/engine.py`` for dense GQA models.

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

With ``prefix_cache=True`` a radix tree (``serve/prefix.py``) shares the
pages of prompt prefixes it has seen: a hit adopts its donor's scales,
copies a partly matched page (COW) and computes only the suffix through
the chunk step — exactly what a cache-off engine with a chunk boundary at
the resume position computes.

Numerics: float32 matmuls stay float32 on the card — the engine sets
``torch.backends.cuda.matmul.allow_tf32 = False`` (and cuDNN's) where it
is built, so the fp32 fused-vs-gather identity holds as in the reference.
The pool is updated in place (see ``kv_cache``); PyTorch runs eagerly, so
there is no compiled-step cache.

Not carried over: the reference's ``CompileCache`` / ``max_prefill_shapes``
(they bound live jitted prefill shapes; eager PyTorch compiles none).
Still to port (they raise ``NotImplementedError`` naming what they wait
for): speculative decoding, recurrent/MoE/MLA sublayers (at ``build_lm``),
a mesh, quant-health policies and trace recorders.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..models import attention as A
from ..models.common import apply_site, rms_norm
from ..models.lm import LMDef, embed_tokens, lm_forward, sub_ffn_decode
from . import kv_cache as KC
from .kv_cache import PoolConfig
from .metrics import ServeMetrics
from .prefix import RadixPrefixCache
from .sampling import SamplingParams, sample_tokens
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
    spec_k: int = 0             # speculative decoding (later slice)
    policy: object = None       # NumericsPolicy / quant health (later slice)


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
        later = [(ecfg.spec_k != 0 or draft is not None,
                  "speculative decoding (ROADMAP queue 1)"),
                 (ecfg.policy is not None, "numerics policies and quant "
                  "health (the training slice, numerics/policy.py)"),
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
        self.device = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        wdev = params["embed"]["w"].device
        if wdev.type != self.device.type:
            raise ValueError(f"params live on {wdev}, engine on {self.device}")
        self.lm = lm
        self.params = params
        self.ecfg = ecfg
        self.pcfg = ecfg.pool
        self.pool = KC.init_pool(lm, self.pcfg, self.device)
        # prefix sharing needs per-token paged memory, i.e. an attention-
        # only arch: every arch init_pool takes (recurrent mixers raise)
        self._prefix = (RadixPrefixCache(self.pcfg.page_size,
                                         self.pcfg.total_pages)
                        if ecfg.prefix_cache else None)
        self.sched = Scheduler(self.pcfg, ecfg.prefill_chunk,
                               prefix=self._prefix)
        self.metrics = ServeMetrics(clock=clock)
        self.metrics.num_slots = self.pcfg.num_slots
        self.metrics.cache_bytes = KC.pool_bytes(self.pool)
        self.metrics.cache_bytes_fp32 = KC.pool_bytes_fp32(self.pool)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(ecfg.seed)
        self._completions: dict[int, Completion] = {}
        self._orig_prompt: dict[int, list[int]] = {}

    # ---- device steps --------------------------------------------------
    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _sub_decode(self, pp: dict, x: torch.Tensor, layer: int, key: str,
                    sub, table, lens, active) -> torch.Tensor:
        cfg = self.lm.cfg
        d = sub.mixer
        b = x.shape[0]
        positions = A.len_positions(lens, b)
        h = rms_norm(x, pp["norm1"]["scale"], cfg.norm_eps)
        q, k_new, v_new = A.gqa_decode_qkv(pp["mixer"], h, d, cfg, positions)
        data = {n: t[layer] for n, t in self.pool["data"][key].items()}
        scale = {n: t[layer] for n, t in self.pool["scale_log2"][key].items()}
        KC.append_kv(data["k"], data["v"], scale["k"], scale["v"], k_new,
                     v_new, table, lens, active, self.pcfg)
        if self.ecfg.fused_attention:
            attn = KC.fused_attend(data["k"], data["v"], scale["k"],
                                   scale["v"], q[:, 0], table, lens,
                                   self.pcfg)
            attn = attn[:, :d.real_heads].reshape(b, 1,
                                                  d.real_heads * d.head_dim)
        else:
            k, v = KC.read_kv(data["k"], data["v"], scale["k"], scale["v"],
                              table, self.pcfg, h.dtype)
            attn = A.gqa_attend(q, k, v, d, positions)
        x = x + apply_site(pp["mixer"]["o"], attn, d.o, cfg)
        return sub_ffn_decode(pp, x, sub, cfg)

    @torch.no_grad()
    def _decode(self, table, lens, active, tokens) -> torch.Tensor:
        """One batched decode step. tokens: (B,1); lens/active: (B,).
        Returns logits (B, V); the pool is updated in place."""
        lm = self.lm
        x = embed_tokens(self.params, tokens, lm)
        for layer, pp in enumerate(self.params["layers"]):
            for i, sub in enumerate(lm.period):
                x = self._sub_decode(pp[f"sub_{i}"], x, layer, f"sub_{i}",
                                     sub, table, lens, active)
        x = rms_norm(x, self.params["final_norm"]["scale"], lm.cfg.norm_eps)
        return apply_site(self.params["head"], x, lm.head, lm.cfg)[:, 0]

    @torch.no_grad()
    def _prefill(self, toks: list[int], table_row: torch.Tensor,
                 slot: int) -> torch.Tensor:
        """A first chunk at position 0: the model's own forward, then one
        write of its cache into the pool (which chooses the slot's scales;
        one ``p2_prefill_paged`` launch on a quantized pool). Returns the
        last real position's logits (1, V)."""
        padded = toks + [0] * (_bucket_len(len(toks), self.ecfg.prefill_bucket)
                               - len(toks))
        logits, _, cache = lm_forward(
            self.params, self.lm, tokens=self._tensor([padded], torch.long),
            return_cache=True)
        # the prompt's length on the device: the write reads it there
        KC.write_prefill(self.pool, cache, table_row, slot,
                         self._tensor([len(toks)], torch.int32), self.pcfg)
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

    @torch.no_grad()
    def _chunk(self, toks: list[int], table_row: torch.Tensor, slot: int,
               start: int) -> torch.Tensor:
        """Chunked-prefill step of one slot (the reference's
        ``_chunk_impl`` for GQA sublayers): each layer writes the chunk's
        K/V into the pool under the slot's scale and attends over the
        slot's whole history, read off the pages (not the fused kernel, as
        in the reference). ``toks`` is padded to the chunk width (or the
        bucketed length when chunking is off); pad rows go to the trash
        page. The slot's scales stay on the device, as (1,) views.
        Returns the last real position's logits (1, V)."""
        lm, ecfg = self.lm, self.ecfg
        width = (ecfg.prefill_chunk if ecfg.prefill_chunk > 0
                 else _bucket_len(len(toks), ecfg.prefill_bucket))
        tokens = self._tensor([toks + [0] * (width - len(toks))], torch.long)
        positions = (start + torch.arange(width, device=self.device))[None]
        # the chunk's (1,) start and valid count, on the device once a step
        start_t, valid_t = self._tensor([[start], [len(toks)]], torch.int32)
        x = embed_tokens(self.params, tokens, lm)
        for layer, pp in enumerate(self.params["layers"]):
            for i, sub in enumerate(lm.period):
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
        tok = int(self._sample(last, [slot])[0])
        st.generated.append(tok)
        st.last_token = tok
        self.metrics.request_first_token(st.req.rid)
        if self._prefix is not None:
            scales = (KC.snapshot_scales(self.pool, slot)
                      if self.pcfg.quantized else None)
            self.sched.commit_prefix(slot, scales)

    def _sample(self, logits: torch.Tensor, slots: list[int]) -> np.ndarray:
        sp = [self.sched.slots[s].req.sampling if self.sched.slots[s]
              else SamplingParams() for s in slots]
        toks = sample_tokens(
            logits, self._gen,
            self._tensor([p.temperature for p in sp], torch.float32),
            self._tensor([p.top_k for p in sp], torch.int32),
            self._tensor([p.top_p for p in sp], torch.float32))
        return toks.cpu().numpy()

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
        """One engine iteration: admit + prefill, then one batched decode."""
        sched = self.sched
        while (adm := sched.try_admit()) is not None:
            slot, st = adm
            self.metrics.request_admitted(st.req.rid, st.prompt_len)
            self._do_prefill(slot, st)
            if st.done():
                self._finish(slot)

        active_slots = [i for i, s in enumerate(sched.slots) if s is not None]
        # map the page each active slot is about to write; preempt the
        # youngest slot while the pool is exhausted
        for slot in active_slots:
            if sched.slots[slot] is None:
                continue
            while not sched.ensure_page(slot):
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
        logits = self._decode(self._tensor(sched.page_table),
                              self._tensor(sched.lens_vector()),
                              self._tensor(sched.active_mask()),
                              self._tensor(sched.tokens_vector()))
        toks = self._sample(logits, list(range(self.pcfg.num_slots)))
        free_pages = sched.alloc.free_pages
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
