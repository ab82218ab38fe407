"""Host-side continuous-batching scheduler — the port of
``repro/serve/scheduler.py``. Plain Python and numpy.

- **Admission**: FIFO queue; a request is admitted when a slot is free and
  the pool can page its prompt plus one decode page. With a prefix cache
  the longest cached prefix is matched and its pages acquired first; only
  the rest of the prompt needs fresh pages, and prefill resumes there.
- **Paging**: pages are allocated lazily as a slot's length crosses page
  boundaries. If the pool is exhausted mid-decode the *youngest* slot is
  preempted: its pages return to the free list and the request re-queues
  with its generated prefix folded into the prompt (recompute preemption).
  Allocation evicts cold prefix-cache leaves before it gives up.
- **Chunked prefill**: prompts longer than ``prefill_chunk`` are split into
  fixed-size chunks.
- **Spans**: before each step ``ensure_span`` maps the pages the step
  writes (one token for decode, a k+1-token verify block for speculative
  decoding); ``trim_unused`` frees the private pages a rejected tail left
  mapped after it.
- **Unpaged** (``paged=False``, pure-SSM archs: every mixer carries O(1)
  recurrent state and nothing token-paged lives in the pool): admission
  needs only a free slot, with no page reservation and no bound on prompt
  plus new tokens; spans are always mapped. Preemption still works: the
  request re-queues with its generated prefix and its state is rebuilt by
  re-prefill.
- **Trace** (an optional ``obs.TraceRecorder``): ``page_alloc`` for each
  page a span maps, ``page_free`` for the pages a retire, a preemption or
  ``trim_unused`` releases, as the reference emits them.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np

from .kv_cache import PoolConfig
from .sampling import SamplingParams


@dataclass
class Request:
    prompt: list[int]
    max_new_tokens: int = 32
    sampling: SamplingParams = field(default_factory=SamplingParams)
    eos_id: int = -1                    # -1: never stop on a token
    rid: int = -1                       # assigned by Scheduler.submit


@dataclass
class SlotState:
    req: Request
    prompt_len: int
    generated: list[int] = field(default_factory=list)
    last_token: int = -1
    # prefix-cache admission outcome (serve/prefix.py): positions below
    # ``prefix_len`` are already resident (shared pages + an optional COW
    # fork) and prefill resumes there. ``fork`` is the pending (src, dst)
    # page copy the engine performs before the first suffix chunk;
    # ``prefix_scales`` the matched node's scale snapshot to adopt.
    prefix_len: int = 0
    fork: tuple[int, int] | None = None
    prefix_scales: dict | None = None

    @property
    def cur_len(self) -> int:
        return self.prompt_len + len(self.generated)

    @property
    def next_pos(self) -> int:
        """Cache position of the *incoming* decode token (= the last sampled
        token, which has not been written to the cache yet)."""
        return self.cur_len - 1

    def done(self) -> bool:
        if len(self.generated) >= self.req.max_new_tokens:
            return True
        return bool(self.generated) and self.generated[-1] == self.req.eos_id


class PageAllocator:
    """Free-list allocator over the pool's physical pages."""

    def __init__(self, num_pages: int):
        self._free = list(range(num_pages - 1, -1, -1))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: list[int]) -> None:
        self._free.extend(pages)


class Scheduler:
    """Slot/page bookkeeping for one engine. All state is host-side."""

    def __init__(self, pcfg: PoolConfig, prefill_chunk: int = 0,
                 prefix=None, paged: bool = True, trace=None):
        self.pcfg = pcfg
        self.trace = trace      # optional obs.TraceRecorder (page events)
        self.prefill_chunk = prefill_chunk
        self.paged = paged
        self.prefix = prefix    # optional serve.prefix.RadixPrefixCache
        if prefix is not None and not paged:
            raise ValueError("prefix cache requires the paged pool")
        self.queue: deque[Request] = deque()
        self.slots: list[SlotState | None] = [None] * pcfg.num_slots
        self.alloc = PageAllocator(pcfg.total_pages)
        # slot_pages: pages PRIVATE to the slot (freed at retire).
        # slot_shared: tree-owned pages mapped in the slot's row (stay in the
        # prefix cache at retire). slot_refs: pages this slot holds refcounts
        # on (shared pages + a pending COW-fork source), released at retire.
        self.slot_pages: list[list[int]] = [[] for _ in range(pcfg.num_slots)]
        self.slot_shared: list[list[int]] = [[] for _ in
                                             range(pcfg.num_slots)]
        self.slot_refs: list[list[int]] = [[] for _ in range(pcfg.num_slots)]
        # device-facing page table; unmapped entries point at the trash page
        self.page_table = np.full((pcfg.num_slots, pcfg.pages_per_slot),
                                  pcfg.trash_page, np.int32)
        self.admission_order: list[int] = []   # slot ids, oldest first
        self._next_rid = 0

    def submit(self, req: Request) -> int:
        if req.max_new_tokens < 1:
            raise ValueError(f"request {req.rid}: max_new_tokens must be "
                             f">= 1 (the first token comes from prefill)")
        if not self.paged:
            # recurrent state is O(1): no page capacity to bound against
            return self._enqueue(req)
        if len(req.prompt) + req.max_new_tokens > self.pcfg.max_len:
            raise ValueError(
                f"request {req.rid}: prompt+max_new_tokens "
                f"{len(req.prompt)}+{req.max_new_tokens} exceeds slot "
                f"capacity {self.pcfg.max_len}")
        need = self.pcfg.pages_for(len(req.prompt) + req.max_new_tokens)
        if need > self.pcfg.total_pages:
            raise ValueError(
                f"request {req.rid}: horizon needs {need} pages but the "
                f"pool has {self.pcfg.total_pages}")
        return self._enqueue(req)

    def _enqueue(self, req: Request) -> int:
        if req.rid < 0:
            req.rid = self._next_rid
            self._next_rid += 1
        self.queue.append(req)
        return req.rid

    def alloc_pages(self, n: int) -> list[int] | None:
        """Allocate ``n`` pages, evicting cold prefix-cache leaves first if
        the free list alone cannot cover it. Eviction only reclaims
        refcount-0 spans, so pages mapped (or matched and acquired) by a
        live slot are untouchable: running requests are reclaimed by
        preemption, never by cache eviction."""
        got = self.alloc.alloc(n)
        if got is None and self.prefix is not None:
            freed = self.prefix.evict(n - self.alloc.free_pages)
            if freed:
                self.alloc.free(freed)
                got = self.alloc.alloc(n)
        return got

    def try_admit(self) -> tuple[int, SlotState] | None:
        """Admit the head-of-queue request if a slot + pages are available
        (the prompt's pages plus one decode page, reserved up front).

        With a prefix cache the longest cached prefix is matched and its
        pages acquired *before* the private allocation, so eviction
        triggered by that allocation can never free the matched span."""
        if not self.queue:
            return None
        free_slots = [i for i, s in enumerate(self.slots) if s is None]
        if not free_slots:
            return None
        req = self.queue[0]
        shared: list[int] = []
        refs: list[int] = []
        pages: list[int] = []
        m = self.prefix.match(req.prompt) if self.prefix is not None else None
        if m is not None:
            self.prefix.acquire(m)
            shared = list(m.shared_pages)
            refs = shared + ([m.fork_src] if m.fork_src is not None else [])
        if self.paged:
            pages = self.alloc_pages(self.pcfg.pages_for(len(req.prompt) + 1)
                                     - len(shared))
            if pages is None:
                if refs:
                    self.prefix.release(refs)
                return None
        self.queue.popleft()
        slot = free_slots[0]
        self.slot_pages[slot] = pages
        self.slot_shared[slot] = shared
        self.slot_refs[slot] = refs
        row = shared + pages
        if row:
            self.page_table[slot, :len(row)] = row
        st = SlotState(req, prompt_len=len(req.prompt))
        if m is not None:
            st.prefix_len = m.resume
            st.prefix_scales = m.scales
            if m.fork_src is not None:
                # the first private page sits right after the shared span:
                # it is the COW destination the engine copies into
                st.fork = (m.fork_src, pages[0])
        self.slots[slot] = st
        self.admission_order.append(slot)
        return slot, st

    def commit_prefix(self, slot: int, scales: dict | None) -> list[int]:
        """After prefill: donate the slot's fully-prompt-covered private
        pages to the prefix tree. Donated pages move from the private list
        (freed at retire) to the acquired-shared lists (refs released at
        retire). Returns the donated pages."""
        if self.prefix is None:
            return []
        st = self.slots[slot]
        n_full = st.prompt_len // self.pcfg.page_size
        if n_full <= len(self.slot_shared[slot]):
            return []       # nothing beyond the already-shared span
        row = self.slot_shared[slot] + self.slot_pages[slot]
        donated = self.prefix.insert(st.req.prompt, row[:n_full], scales)
        for p in donated:
            self.slot_pages[slot].remove(p)
        if donated:
            self.prefix.refs.acquire(donated)
            self.slot_refs[slot].extend(donated)
            self.slot_shared[slot].extend(donated)
        return donated

    def prefill_chunks(self, prompt_len: int) -> list[tuple[int, int]]:
        """(start, end) chunks covering the prompt."""
        if self.prefill_chunk <= 0 or prompt_len <= self.prefill_chunk:
            return [(0, prompt_len)]
        c = self.prefill_chunk
        return [(s, min(s + c, prompt_len)) for s in range(0, prompt_len, c)]

    def ensure_span(self, slot: int, n: int) -> bool:
        """Map every page covering positions ``next_pos .. next_pos+n-1``:
        the incoming decode token at n = 1, the speculative verify block
        at n = k+1. Positions at or past the slot's horizon are clamped:
        their writes go to the trash page and need no mapping. Returns
        False when the pool is exhausted (caller should preempt). An
        unpaged scheduler maps nothing and never runs out."""
        if not self.paged:
            return True
        st = self.slots[slot]
        ps = self.pcfg.page_size
        last = min(st.next_pos + n - 1, self.pcfg.max_len - 1)
        need = last // ps + 1           # mapped pages required
        while True:
            have = len(self.slot_shared[slot]) + len(self.slot_pages[slot])
            if have >= need:
                return True
            pages = self.alloc_pages(1)
            if pages is None:
                return False
            self.slot_pages[slot].append(pages[0])
            self.page_table[slot, have] = pages[0]
            if self.trace is not None:
                self.trace.emit("page_alloc", slot=slot, page=pages[0],
                                pos=int(have * ps))

    def trim_unused(self, slot: int) -> int:
        """Free the private pages above the page holding ``next_pos``: the
        rollback half of speculative decoding (a rejected tail's K/V sits
        above the slot's length and is never read). Shared prefix pages
        are never trimmed; freed table entries point at the trash page
        again. Returns the count freed."""
        if not self.paged:
            return 0
        st = self.slots[slot]
        keep = st.next_pos // self.pcfg.page_size + 1
        n_shared = len(self.slot_shared[slot])
        keep_private = max(0, keep - n_shared)
        extra = self.slot_pages[slot][keep_private:]
        if not extra:
            return 0
        self.slot_pages[slot] = self.slot_pages[slot][:keep_private]
        have = n_shared + keep_private
        self.page_table[slot, have:have + len(extra)] = self.pcfg.trash_page
        self.alloc.free(extra)
        if self.trace is not None:
            self.trace.emit("page_free", slot=slot, n=len(extra))
        return len(extra)

    def retire(self, slot: int) -> SlotState:
        st = self.slots[slot]
        if self.trace is not None and self.slot_pages[slot]:
            self.trace.emit("page_free", slot=slot,
                            n=len(self.slot_pages[slot]))
        self.alloc.free(self.slot_pages[slot])
        if self.slot_refs[slot]:
            # shared/acquired pages stay in the prefix tree; dropping the
            # refs makes them evictable once no other reader remains
            self.prefix.release(self.slot_refs[slot])
        self.slot_pages[slot] = []
        self.slot_shared[slot] = []
        self.slot_refs[slot] = []
        self.page_table[slot, :] = self.pcfg.trash_page
        self.slots[slot] = None
        self.admission_order.remove(slot)
        return st

    def preempt_youngest(self) -> int | None:
        """Evict the most recently admitted slot; its request re-queues with
        the generated prefix folded into the prompt (recompute on re-admit;
        ``retire`` releases its prefix refs). Returns the evicted slot id,
        or None if nothing is evictable."""
        if len(self.admission_order) <= 1:
            return None     # never preempt the last running request
        slot = self.admission_order[-1]
        st = self.retire(slot)
        req = st.req
        self.queue.appendleft(Request(
            prompt=req.prompt + st.generated,
            max_new_tokens=req.max_new_tokens - len(st.generated),
            sampling=req.sampling, eos_id=req.eos_id, rid=req.rid))
        return slot

    # ---- device-facing vectors ----------------------------------------
    def lens_vector(self) -> np.ndarray:
        """Per-slot position of the incoming decode token (see next_pos)."""
        return np.asarray([s.next_pos if s else 0 for s in self.slots],
                          np.int32)

    def active_mask(self) -> np.ndarray:
        return np.asarray([s is not None for s in self.slots], bool)

    def tokens_vector(self) -> np.ndarray:
        return np.asarray([[s.last_token if s else 0] for s in self.slots],
                          np.int32)

    def has_work(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    def mapped_page_stats(self) -> tuple[int, int]:
        """(logical, physical) mapped-page counts over live slots: a page
        shared by k readers counts k times in the first, once in the
        second. The difference is the pages prefix sharing saves right now
        (times ``kv_cache.page_nbytes``: the bytes)."""
        logical = 0
        phys: set[int] = set()
        for slot, st in enumerate(self.slots):
            if st is None:
                continue
            row = self.slot_shared[slot] + self.slot_pages[slot]
            logical += len(row)
            phys.update(row)
        return logical, len(phys)
