"""Paged KV-cache pool: block allocator + per-request page tables +
shared-prefix trie (the host side of the paged serving engine).

The port's own copy of ``kubeml_tpu/serving/kvpool.py`` (plain Python, no
framework), with the same invariants and ``check()``. The device KV arena
is carved into fixed-size pages of ``page_tokens`` tokens (vLLM's
PagedAttention, Kwon et al. 2023); this module owns all the HOST
bookkeeping:

* :class:`KVPool` — an explicit free list over ``num_pages`` physical
  pages with per-page refcounts. Physical page 0 is RESERVED as the trash
  page: the device programs redirect every invalid write (bucket padding,
  rows the host already retired) to it, so a stale program can never
  corrupt a reallocated page and the allocator never hands it out.
* :class:`PageLease` — one request-row's page table: the logical->physical
  mapping, how many leading pages are shared (prefix hits), and how many
  prompt tokens the shared pages already cover (prefill runs only on the
  unshared suffix).
* :class:`PrefixTrie` — shared-prefix reuse keyed on FULL prompt-token
  blocks: identical system prompts / few-shot headers map to the same
  refcounted pages. Only complete pages are ever shared and a row's
  unshared suffix always starts at a page boundary with >= 1 token, so
  decode writes land in row-private pages and no copy-on-write is needed.
  Trie entries hold one reference per cached page; entries whose page is
  held ONLY by the trie are evictable, least-recently-matched leaf first,
  when a fresh allocation runs short.

Everything here is plain Python driven from the decode engine thread (one
owner — the engine serializes admission, retirement and release), so the
invariants are exact and cheaply checkable: every non-trash page is either
on the free list or refcounted (never both), every lease releases exactly
once, and at drain the only held pages are the trie's. ``check()`` returns
the full accounting — the tests assert it once traffic drains.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

TRASH_PAGE = 0


class PageAllocError(RuntimeError):
    """The pool cannot satisfy an allocation even after trie eviction."""


@dataclass
class PageLease:
    """One admitted row's view of the pool: ``pages[j]`` is the physical
    page backing logical page ``j`` (positions ``j*pt .. (j+1)*pt-1``)."""

    pages: List[int]
    shared: int = 0          # leading pages refcount-shared via the trie
    prefix_tokens: int = 0   # prompt tokens those shared pages cover
    released: bool = False
    # chunked-prefill cursor: prompt tokens whose K/V is already in the
    # arena - prefix_tokens at admission, advanced one page-aligned chunk
    # per engine-loop turn until the final chunk samples the first token.
    # Monolithic prefill never moves it.
    prefill_pos: int = 0


class _TrieNode:
    __slots__ = ("children", "page", "last_use", "parent", "key")

    def __init__(self, parent=None, key=None, page: int = TRASH_PAGE):
        self.children: Dict[Tuple[int, ...], "_TrieNode"] = {}
        self.page = page
        self.last_use = 0
        self.parent = parent
        self.key = key


class PrefixTrie:
    """Prompt-block trie: one node per FULL ``page_tokens`` token block,
    holding the physical page that caches that block's K/V (given its
    prefix path). The trie owns one refcount on every node's page."""

    def __init__(self, pool: "KVPool"):
        self._pool = pool
        self._root = _TrieNode()
        self._clock = itertools.count(1)
        self.nodes = 0

    def match(self, prompt: Sequence[int], max_blocks: int) -> List[int]:
        """Longest chain of cached full blocks prefixing ``prompt``, capped
        at ``max_blocks`` (callers cap at ``(plen-1)//pt`` so at least one
        prompt token always prefills — the first sampled token needs the
        last prompt position's logits). Bumps recency on the matched path."""
        pt = self._pool.page_tokens
        node, pages = self._root, []
        now = next(self._clock)
        for b in range(max_blocks):
            key = tuple(int(t) for t in prompt[b * pt:(b + 1) * pt])
            child = node.children.get(key)
            if child is None:
                break
            child.last_use = now
            pages.append(child.page)
            node = child
        return pages

    def insert(self, prompt: Sequence[int], lease: PageLease,
               prompt_len: int) -> int:
        """Register every FULL prompt block of a just-dispatched prefill:
        new blocks take a trie reference on the lease's page for that
        block; blocks already cached keep the incumbent page (the lease's
        private copy simply isn't shared). Returns new nodes added.

        Called AT DISPATCH time, not admission: device programs execute in
        dispatch order, so a later request matching these pages is
        guaranteed to read them after this prefill wrote them."""
        pt = self._pool.page_tokens
        node = self._root
        now = next(self._clock)
        added = 0
        for b in range(prompt_len // pt):
            key = tuple(int(t) for t in prompt[b * pt:(b + 1) * pt])
            child = node.children.get(key)
            if child is None:
                child = _TrieNode(parent=node, key=key, page=lease.pages[b])
                node.children[key] = child
                self._pool._retain(child.page)
                self.nodes += 1
                added += 1
            child.last_use = now
            node = child
        return added

    def evict(self, need: int) -> int:
        """Drop least-recently-matched leaf entries whose page is held by
        the trie ALONE (refcount 1) until ``need`` pages were freed (or no
        candidate remains). Returns pages actually freed.

        One DFS collects ALL current candidates, sorted once by recency —
        O(nodes log nodes) per call instead of a full walk per page (this
        runs on the admission hot path under the engine lock). Evicting a
        whole batch of leaves can expose their parents, so the outer loop
        repeats only while progress continues and pages are still owed."""
        freed = 0
        while freed < need:
            leaves: List[_TrieNode] = []
            stack = [self._root]
            while stack:
                node = stack.pop()
                for child in node.children.values():
                    if child.children:
                        stack.append(child)
                    elif self._pool._ref[child.page] == 1:
                        leaves.append(child)
            if not leaves:
                return freed
            leaves.sort(key=lambda n: n.last_use)
            for victim in leaves:
                del victim.parent.children[victim.key]
                self.nodes -= 1
                self._pool._release_one(victim.page)
                freed += 1
                if freed >= need:
                    return freed
        return freed

    def flush(self) -> int:
        """Release every trie-held page whose refcount allows it (all of
        them once no lease is outstanding). Returns pages freed."""
        return self.evict(self.nodes)

    def pages(self) -> List[int]:
        out, stack = [], [self._root]
        while stack:
            node = stack.pop()
            for child in node.children.values():
                out.append(child.page)
                stack.append(child)
        return out


class KVPool:
    """The page allocator + prefix cache for one paged decoder.

    ``num_pages`` includes the reserved trash page 0, so ``num_pages - 1``
    pages are allocatable. All methods are called from the engine thread
    (plus ``admit``'s capacity pre-check from submit under the engine
    lock); the pool itself keeps no lock.
    """

    def __init__(self, num_pages: int, page_tokens: int,
                 prefix_cache: bool = True):
        if page_tokens < 1 or (page_tokens & (page_tokens - 1)):
            raise ValueError(
                f"page_tokens must be a power of two, got {page_tokens}")
        if num_pages < 2:
            raise ValueError("need at least one allocatable page beyond the "
                             "reserved trash page")
        self.num_pages = int(num_pages)
        self.page_tokens = int(page_tokens)
        self._free: List[int] = list(range(1, num_pages))
        self._ref: List[int] = [0] * num_pages
        self.trie: Optional[PrefixTrie] = (PrefixTrie(self) if prefix_cache
                                           else None)
        # pool-level eviction pressure (trie pages evicted for allocations);
        # prefix hit counters live in the engine's telemetry
        self.evictions = 0

    # --- sizing ---

    @property
    def capacity(self) -> int:
        """Allocatable pages (excludes the trash page)."""
        return self.num_pages - 1

    def free_pages(self) -> int:
        return len(self._free)

    def pages_for(self, total_tokens: int) -> int:
        """Pages a row writing ``total_tokens`` positions needs."""
        return -(-int(total_tokens) // self.page_tokens)

    # --- refcounting primitives ---

    def _retain(self, page: int) -> None:
        self._ref[page] += 1

    def _release_one(self, page: int) -> None:
        r = self._ref[page]
        if r <= 0:
            raise PageAllocError(f"double free of page {page}")
        self._ref[page] = r - 1
        if r == 1:
            self._free.append(page)

    def _alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` fresh pages, evicting trie-only pages as needed;
        None (state unchanged) when even eviction can't cover it."""
        if n <= 0:
            return []
        short = n - len(self._free)
        if short > 0:
            if self.trie is None:
                return None
            self.evictions += self.trie.evict(short)
            if n > len(self._free):
                return None
        out = self._free[:n]
        del self._free[:n]
        for p in out:
            self._ref[p] += 1
        return out

    # --- the admission interface (engine thread) ---

    def total_positions(self, prompt_len: int, max_new: int,
                        lookahead: int = 0,
                        max_positions: Optional[int] = None) -> int:
        """Worst-case cache positions one row can WRITE: prompt +
        ``max_new - 1`` decode writes (the last emitted token is returned,
        never written) + ``lookahead`` speculative positions (a verify at
        depth k writes up to k positions past the row's final token before
        the host learns they were rejected). ``max_positions`` (the
        model's ``max_len``) clamps the sum: the device trash-redirects
        writes past the addressable range, so no page backs them."""
        total = int(prompt_len) + int(max_new) - 1 + int(lookahead)
        if max_positions is not None:
            total = min(total, int(max_positions))
        return total

    def can_admit(self, prompt_len: int, max_new: int, lookahead: int = 0,
                  max_positions: Optional[int] = None) -> bool:
        """Whether a row could EVER be admitted (fits the arena outright,
        ignoring current occupancy) — the submit-time 400 guard. Clamped
        at ``max_positions``, the lookahead never refuses a request the
        plain engine accepts."""
        return self.pages_for(self.total_positions(
            prompt_len, max_new, lookahead, max_positions)) <= self.capacity

    def admit(self, prompt: Sequence[int], max_new: int,
              lookahead: int = 0,
              max_positions: Optional[int] = None) -> Optional[PageLease]:
        """Reserve one row's full worst-case page table: shared prefix
        pages (refcount bumped) + fresh pages for the unshared suffix,
        every decode position and the speculative ``lookahead`` window
        (held for the row's whole life, so a rollback can never run out of
        pages). None (nothing changed) when the pool can't cover it — the
        row stays queued for the next chunk edge."""
        plen = len(prompt)
        total = self.total_positions(plen, max_new, lookahead, max_positions)
        need = self.pages_for(total)
        shared: List[int] = []
        if self.trie is not None and plen > 1:
            shared = self.trie.match(prompt, (plen - 1) // self.page_tokens)
        for p in shared:  # retain BEFORE _alloc so eviction can't take them
            self._retain(p)
        fresh = self._alloc(need - len(shared))
        if fresh is None:
            for p in shared:
                self._release_one(p)
            return None
        pre = len(shared) * self.page_tokens
        return PageLease(pages=shared + fresh, shared=len(shared),
                         prefix_tokens=pre, prefill_pos=pre)

    def reserve(self, total_tokens: int) -> Optional[PageLease]:
        """Reserve fresh PRIVATE pages for ``total_tokens`` positions, with
        no prefix-trie participation: the snapshot-restore admission. A
        restored row's page bytes came from another arena's write history
        (int8 scales and all), so sharing them through this pool's trie,
        or matching its cached blocks in their place, would mix arenas.
        None when the pool can't cover it (the row stays queued)."""
        fresh = self._alloc(self.pages_for(total_tokens))
        if fresh is None:
            return None
        return PageLease(pages=fresh)

    def register_prefix(self, prompt: Sequence[int], lease: PageLease) -> None:
        """Cache a just-dispatched prefill's full prompt blocks for future
        sharers (no-op with the prefix cache off)."""
        if self.trie is not None:
            self.trie.insert(prompt, lease, len(prompt))

    def release(self, lease: PageLease) -> None:
        """Return a row's pages (idempotent per lease): refcounts drop by
        one; pages nobody else holds go back on the free list. Shared
        pages survive through the trie's own reference."""
        if lease.released:
            return
        lease.released = True
        for p in lease.pages:
            self._release_one(p)

    # --- invariants (tests + telemetry) ---

    def check(self) -> dict:
        """Full accounting; raises on any broken invariant."""
        free_set = set(self._free)
        if len(free_set) != len(self._free):
            raise PageAllocError("free list holds duplicates")
        if TRASH_PAGE in free_set or self._ref[TRASH_PAGE] != 0:
            raise PageAllocError("trash page escaped reservation")
        held = 0
        for p in range(1, self.num_pages):
            r = self._ref[p]
            if r < 0:
                raise PageAllocError(f"negative refcount on page {p}")
            if (r > 0) == (p in free_set):
                raise PageAllocError(
                    f"page {p} is {'both held and free' if r else 'neither held nor free'}")
            held += 1 if r > 0 else 0
        if held + len(free_set) != self.capacity:
            raise PageAllocError("free + held != capacity")
        trie_pages = self.trie.pages() if self.trie is not None else []
        if len(trie_pages) != len(set(trie_pages)):
            raise PageAllocError("trie maps two blocks onto one page")
        return {
            "free": len(free_set),
            "held": held,
            "trie_pages": len(trie_pages),
            "refs_total": sum(self._ref),
        }

    def telemetry(self) -> dict:
        used = self.capacity - len(self._free)
        return {
            "pages_total": float(self.capacity),
            "pages_free": float(len(self._free)),
            "page_occupancy": used / self.capacity if self.capacity else 0.0,
            "page_tokens": float(self.page_tokens),
            "prefix_cache_pages": float(self.trie.nodes
                                        if self.trie is not None else 0),
        }
