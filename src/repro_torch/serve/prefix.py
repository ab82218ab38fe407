"""Radix-tree copy-on-write prefix cache over the slot-paged KV pool — the
port of ``repro/serve/prefix.py`` (host-side Python, unchanged in
behaviour; an optional trace recorder gets a ``prefix_evict`` event per
evicted leaf).

Two requests whose prompts agree on their first ``k`` pages map the *same*
physical pages and skip prefill for those tokens. The tree is pure
host-side bookkeeping over global page ids.

Structure: a token-keyed radix tree whose edge labels are runs of whole
pages (node keys have a length that is a multiple of ``page_size``; a node
owns ``len(key) / page_size`` physical pages, written once at insertion
and never again). Children are keyed by the tokens of their edge's first
page for O(1) exact descent, with a linear longest-common-prefix scan as
the fallback that finds mid-page divergences.

Lifecycle of a request (scheduler/engine side):

- **match**: walk the tree along the prompt, capped at ``len(prompt)-1``
  (one token must be computed for the sampling logits). Full pages on the
  path are *shared*; a divergence (or the cap) inside a page yields a COW
  **fork**: that page is copied codes-and-scales verbatim into a private
  page of the reader (``kv_cache.fork_page``) and prefill resumes at the
  divergence position.
- **acquire**: refcounts (``kv_cache.PageRefs``) are bumped on every shared
  page *and* the fork source before any allocation can fail, so eviction
  can never free a page a matched request is about to map.
- **release**: retirement and preemption drop the refs; the pages stay in
  the tree (count 0 = evictable, not freed).
- **insert**: after prefill the slot's fully-prompt-covered private pages
  are donated to the tree, splitting edges at page boundaries where the
  new path diverges.
- **evict**: when the allocator runs dry the scheduler asks for LRU leaves
  whose pages all have refcount 0; their pages return to the free list.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .kv_cache import PageRefs


@dataclass
class RadixNode:
    key: tuple[int, ...]                   # edge label, len % page_size == 0
    pages: list[int]                       # len(key) // page_size page ids
    children: dict[tuple[int, ...], "RadixNode"] = field(default_factory=dict)
    parent: "RadixNode | None" = None
    scales: dict | None = None             # kv_cache.snapshot_scales leaves
    last_used: int = 0


@dataclass
class PrefixMatch:
    """Result of matching a prompt against the tree (resume > 0 only)."""
    shared_pages: list[int]                # full shared pages, path order
    fork_src: int | None                   # physical page to COW-copy
    fork_tokens: int                       # valid tokens in the forked page
    resume: int                            # first position prefill computes
    scales: dict | None                    # deepest matched node's snapshot

    @property
    def hit_tokens(self) -> int:
        return self.resume


class RadixPrefixCache:
    """The tree + LRU eviction.  Page refcounts live in ``self.refs``;
    page *ownership* (tree holds the page ⇔ page not on the free list and
    not private to a slot) lives in ``self._owner``."""

    def __init__(self, page_size: int, num_pages: int, trace=None):
        if page_size < 2:
            raise ValueError("prefix cache needs page_size >= 2 "
                             "(a 1-token page can never be fully shared)")
        self.page_size = page_size
        self.trace = trace
        self.refs = PageRefs(num_pages)
        self.root = RadixNode(key=(), pages=[])
        self._owner: dict[int, RadixNode] = {}   # page id -> owning node
        self._clock = 0
        # counters surfaced into ServeMetrics by the engine
        self.evictions = 0          # evicted leaf nodes
        self.pages_evicted = 0

    # ---- introspection ------------------------------------------------
    @property
    def owned_pages(self) -> set[int]:
        return set(self._owner)

    def num_nodes(self) -> int:
        def count(n):
            return 1 + sum(count(c) for c in n.children.values())
        return count(self.root) - 1

    def bytes_stats(self, page_nbytes: int) -> dict:
        """How many physical pages the tree owns, how many of those are
        pinned by live readers, and what they cost given one page's bytes
        (``kv_cache.page_nbytes``). Tree-owned pages live inside the KV
        pool: these bytes are a share of ``pool_bytes``, not extra."""
        owned = list(self._owner)
        pinned = sum(1 for p in owned if self.refs.count(p) > 0)
        return {"pages": len(owned), "pages_pinned": pinned,
                "bytes": len(owned) * int(page_nbytes),
                "nodes": self.num_nodes()}

    # ---- matching -----------------------------------------------------
    def _tick(self, node: RadixNode) -> None:
        self._clock += 1
        node.last_used = self._clock

    def _best_child(self, node: RadixNode, tokens, pos: int
                    ) -> RadixNode | None:
        """Child whose edge shares the longest prefix with tokens[pos:].
        Exact first-page key wins immediately; otherwise scan for any
        partial first-page overlap (the mid-page COW case)."""
        ps = self.page_size
        exact = node.children.get(tuple(tokens[pos:pos + ps]))
        if exact is not None:
            return exact
        best, best_l = None, 0
        for child in node.children.values():
            l = _lcp(child.key, tokens, pos, pos + ps)
            if l > best_l:
                best, best_l = child, l
        return best

    def match(self, prompt: list[int]) -> PrefixMatch | None:
        """Longest cached prefix of ``prompt``, capped at len(prompt)-1.
        Pure lookup — refcounts are untouched until ``acquire``."""
        limit = len(prompt) - 1
        ps = self.page_size
        node, pos = self.root, 0
        shared: list[int] = []
        fork_src, fork_tokens = None, 0
        deepest: RadixNode | None = None
        while pos < limit:
            child = self._best_child(node, prompt, pos)
            if child is None:
                break
            common = _lcp(child.key, prompt, pos, limit)
            self._tick(child)
            if common == len(child.key):
                shared.extend(child.pages)
                deepest = child
                node, pos = child, pos + common
                continue
            full = common // ps
            if full:
                shared.extend(child.pages[:full])
                deepest = child
            rem = common % ps
            if rem:
                fork_src = child.pages[full]
                fork_tokens = rem
                deepest = child
            break
        resume = len(shared) * ps + fork_tokens
        if resume == 0:
            return None
        return PrefixMatch(shared_pages=shared, fork_src=fork_src,
                           fork_tokens=fork_tokens, resume=resume,
                           scales=deepest.scales if deepest else None)

    def acquire(self, m: PrefixMatch) -> None:
        """Pin every matched page (shared + fork source) against eviction."""
        self.refs.acquire(m.shared_pages)
        if m.fork_src is not None:
            self.refs.acquire([m.fork_src])

    def release(self, pages: list[int]) -> None:
        self.refs.release(pages)

    # ---- insertion ----------------------------------------------------
    def insert(self, prompt: list[int], row_pages: list[int],
               scales: dict | None) -> list[int]:
        """Donate a freshly prefilled slot's full-prompt pages to the tree.

        ``row_pages`` is the slot's page-table row prefix covering the
        insertable region: only pages every position of which holds a prompt
        token are eligible (``(p+1)*page_size <= prompt_len``) — the page
        that will receive the first decode write must stay private.  Where
        the path already exists the existing pages are kept (the caller's
        row already maps them — they were shared at admission); where it
        diverges, edges split at page boundaries and the slot's private
        pages transfer to tree ownership.  Returns the newly-owned pages
        (the caller re-tags them from private to acquired-shared)."""
        ps = self.page_size
        n_full = len(prompt) // ps
        if n_full == 0:
            return []
        if n_full > len(row_pages):
            raise AssertionError("row shorter than insertable prefix")
        tokens = tuple(prompt[:n_full * ps])
        node, pos, pi = self.root, 0, 0
        donated: list[int] = []
        while pos < len(tokens):
            child = self._best_child(node, tokens, pos)
            common = _lcp(child.key, tokens, pos, len(tokens)) if child else 0
            if common == 0:
                node = self._attach(node, tokens[pos:], row_pages[pi:n_full],
                                    scales, donated)
                break
            self._tick(child)
            if common == len(child.key):
                node, pos, pi = child, pos + common, pi + common // ps
                continue
            full = common // ps
            if full:
                child = self._split(child, full)
                self._tick(child)
                node, pos, pi = child, pos + full * ps, pi + full
            if pos < len(tokens):
                node = self._attach(node, tokens[pos:], row_pages[pi:n_full],
                                    scales, donated)
            break
        else:
            # fully matched an existing path: nothing donated; refresh the
            # terminal node's scales only if it had none (scale snapshots on
            # a path are mutually consistent by construction)
            pass
        if node.scales is None and scales is not None:
            node.scales = scales
        return donated

    def _attach(self, parent: RadixNode, key: tuple[int, ...],
                pages: list[int], scales: dict | None,
                donated: list[int]) -> RadixNode:
        if len(key) != len(pages) * self.page_size:
            raise AssertionError("edge key/pages length mismatch")
        node = RadixNode(key=key, pages=list(pages), parent=parent,
                         scales=scales)
        self._tick(node)
        parent.children[key[:self.page_size]] = node
        for p in pages:
            self._owner[p] = node
        donated.extend(pages)
        return node

    def _split(self, child: RadixNode, full_pages: int) -> RadixNode:
        """Split ``child``'s edge after ``full_pages`` pages; returns the
        new upper node.  LRU stamp and scales are inherited both ways (the
        upper node's pages were written under the same snapshot)."""
        ps = self.page_size
        parent = child.parent
        upper = RadixNode(key=child.key[:full_pages * ps],
                          pages=child.pages[:full_pages], parent=parent,
                          scales=child.scales, last_used=child.last_used)
        del parent.children[child.key[:ps]]
        parent.children[upper.key[:ps]] = upper
        child.key = child.key[full_pages * ps:]
        child.pages = child.pages[full_pages:]
        child.parent = upper
        upper.children[child.key[:ps]] = child
        for p in upper.pages:
            self._owner[p] = upper
        return upper

    # ---- eviction -----------------------------------------------------
    def evict(self, n_pages: int) -> list[int]:
        """Free >= n_pages by removing LRU leaves whose pages are all
        unreferenced.  Returns the freed page ids (possibly fewer than
        requested when the tree is hot).  Chains upward: a parent that
        becomes a cold leaf is immediately eligible."""
        freed: list[int] = []
        while len(freed) < n_pages:
            victim = self._coldest_free_leaf()
            if victim is None:
                break
            parent = victim.parent
            del parent.children[victim.key[:self.page_size]]
            for p in victim.pages:
                del self._owner[p]
            freed.extend(victim.pages)
            self.evictions += 1
            self.pages_evicted += len(victim.pages)
            if self.trace is not None:
                self.trace.emit("prefix_evict", pages=len(victim.pages),
                                tokens=len(victim.key))
        return freed

    def _coldest_free_leaf(self) -> RadixNode | None:
        best: RadixNode | None = None

        def walk(n: RadixNode):
            nonlocal best
            if n is not self.root and not n.children:
                if self.refs.unreferenced(n.pages):
                    if best is None or n.last_used < best.last_used:
                        best = n
                return
            for c in n.children.values():
                walk(c)

        walk(self.root)
        return best


def _lcp(key: tuple[int, ...], tokens, start: int, stop: int) -> int:
    """Length of the common prefix of ``key`` and ``tokens[start:stop]``."""
    n = min(len(key), stop - start, len(tokens) - start)
    i = 0
    while i < n and key[i] == tokens[start + i]:
        i += 1
    return i
