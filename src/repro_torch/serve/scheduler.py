"""Host-side continuous-batching scheduler — the port of
``repro/serve/scheduler.py`` trimmed to this slice (no prefix cache, no
chunked-prefill planning, no speculative spans). Plain Python and numpy.

- **Admission**: FIFO queue; a request is admitted when a slot is free and
  the pool can page its prompt plus one decode page.
- **Paging**: pages are allocated lazily as a slot's length crosses page
  boundaries. If the pool is exhausted mid-decode the *youngest* slot is
  preempted: its pages return to the free list and the request re-queues
  with its generated prefix folded into the prompt (recompute preemption).
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

    @property
    def next_pos(self) -> int:
        """Cache position of the *incoming* decode token (= the last sampled
        token, which has not been written to the cache yet)."""
        return self.prompt_len + len(self.generated) - 1

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

    def __init__(self, pcfg: PoolConfig):
        self.pcfg = pcfg
        self.queue: deque[Request] = deque()
        self.slots: list[SlotState | None] = [None] * pcfg.num_slots
        self.alloc = PageAllocator(pcfg.total_pages)
        self.slot_pages: list[list[int]] = [[] for _ in range(pcfg.num_slots)]
        # device-facing page table; unmapped entries point at the trash page
        self.page_table = np.full((pcfg.num_slots, pcfg.pages_per_slot),
                                  pcfg.trash_page, np.int32)
        self.admission_order: list[int] = []   # slot ids, oldest first
        self._next_rid = 0

    def submit(self, req: Request) -> int:
        if req.max_new_tokens < 1:
            raise ValueError(f"request {req.rid}: max_new_tokens must be "
                             f">= 1 (the first token comes from prefill)")
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
        if req.rid < 0:
            req.rid = self._next_rid
            self._next_rid += 1
        self.queue.append(req)
        return req.rid

    def try_admit(self) -> tuple[int, SlotState] | None:
        """Admit the head-of-queue request if a slot + pages are available
        (the prompt's pages plus one decode page, reserved up front)."""
        if not self.queue:
            return None
        free_slots = [i for i, s in enumerate(self.slots) if s is None]
        if not free_slots:
            return None
        req = self.queue[0]
        pages = self.alloc.alloc(self.pcfg.pages_for(len(req.prompt) + 1))
        if pages is None:
            return None
        self.queue.popleft()
        slot = free_slots[0]
        self.slot_pages[slot] = pages
        self.page_table[slot, :len(pages)] = pages
        st = SlotState(req, prompt_len=len(req.prompt))
        self.slots[slot] = st
        self.admission_order.append(slot)
        return slot, st

    def ensure_page(self, slot: int) -> bool:
        """Make sure the page holding the *next* token position is mapped.
        Returns False when the pool is exhausted (caller should preempt)."""
        st = self.slots[slot]
        page_idx = st.next_pos // self.pcfg.page_size
        if page_idx < len(self.slot_pages[slot]):
            return True
        pages = self.alloc.alloc(1)
        if pages is None:
            return False
        self.slot_pages[slot].append(pages[0])
        self.page_table[slot, page_idx] = pages[0]
        return True

    def retire(self, slot: int) -> SlotState:
        st = self.slots[slot]
        self.alloc.free(self.slot_pages[slot])
        self.slot_pages[slot] = []
        self.page_table[slot, :] = self.pcfg.trash_page
        self.slots[slot] = None
        self.admission_order.remove(slot)
        return st

    def preempt_youngest(self) -> int | None:
        """Evict the most recently admitted slot; its request re-queues with
        the generated prefix folded into the prompt (recompute on re-admit).
        Returns the evicted slot id, or None if nothing is evictable."""
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
