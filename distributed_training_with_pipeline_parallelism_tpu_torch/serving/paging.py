"""Host-side paged KV allocation with radix prefix reuse (the port's own
copy of the JAX package's ``serving/paging.py``, which it never imports;
the same plans, tables, refcounts and gauges for the same calls).

The device side of paged serving (:mod:`.engine`, ``paged=True``) stores
every slot's KV in one shared page pool ``[lps, n_pages, page_size, Hkv,
hd]`` addressed through a static-shape per-slot page table. This module
is the host-side brain that fills those tables:

- :class:`PagePool` — a free-list allocator over the ``n_pages`` device
  pages with per-page refcounts. Page 0 is reserved as the *null page*:
  it is never handed out, unused table entries point at it, and junk
  writes land there harmlessly (the band mask makes its rows
  unreadable, so its content never matters).
- :class:`RadixPrefixCache` — a radix index over page-sized token
  chunks: entry ``i`` is keyed by the exact token prefix
  ``prompt[: (i+1) * page_size]``, so a lookup walks the chain from the
  root and returns the longest run of cached full pages. Exact-token
  keys (not truncated hashes) make false sharing impossible. Entries
  hold one pool reference each; LRU eviction under pressure only frees
  entries whose page nobody else maps (refcount == 1).
- :class:`PagedKVAllocator` — the per-engine facade: plans an
  admission (longest-prefix match, read-only shared mappings,
  copy-on-write for the one page the new request diverges inside,
  fresh pages for the rest), binds the plan to a slot, retires slots
  back into the trie, and exposes the prefix-hit/occupancy/
  fragmentation gauges the SLO harness charts.

Sharing protocol (the correctness argument the tests pin):

- A matched prefix of ``Lm`` tokens is capped at ``plen - 1`` — the last
  prompt token is always recomputed so the slot produces its first
  output logits. ``floor(Lm / page_size)`` *full* pages are mapped
  shared (refcount++) and their prefill visits are skipped entirely
  (``pos`` starts at ``Lm``).
- If the cap lands mid-page, that one divergence page is copy-on-write:
  a fresh page is allocated and the device copies src -> dst at the next
  block's entry, before any tick runs, so the slot's recompute writes
  only ever touch private (refcount == 1) pages. At most one COW copy
  per admission.
- A visit writes only its rows ``[offset, offset + C)``, and ``offset
  >= Lm`` always lands in private pages, so a shared page is never
  written. (The JAX block scatters all of a slot's pages back every
  visit, shared ones with byte-identical content: the same values.)
- Retirement decrefs every table page and inserts the pages fully
  covered by the *prompt* (positions entirely ``< plen``) into the
  trie; decode rows and chunk-tail junk never reach a cached page.
- Pool exhaustion is backpressure, not failure: the engine leaves the
  request at the head of the waiting queue and runs a block so active
  slots can retire (a request is failed only when it needs more pages
  than the whole pool has, which no amount of waiting fixes).

Everything here is plain numpy and Python: the engine calls it between
blocks, on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# page 0 is the reserved null/trash page: never allocated, pinned with
# refcount 1 forever, the target of every unused table entry
PAGE_NULL = 0


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` cache rows."""
    return -(-int(n_tokens) // int(page_size))


class PagePool:
    """Free-list page allocator with per-page refcounts.

    ``n_pages`` counts the device pages *including* the reserved null
    page, so usable capacity is ``n_pages - 1``. ``alloc`` returns fresh
    private pages (refcount 1) or ``None`` when the free list is short —
    the caller decides whether that means evict, backpressure, or fail.
    """

    def __init__(self, n_pages: int, page_size: int) -> None:
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if n_pages < 2:
            raise ValueError(f"n_pages must be >= 2 (page 0 is the "
                             f"reserved null page), got {n_pages}")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.refcount = np.zeros(self.n_pages, np.int32)
        self.refcount[PAGE_NULL] = 1  # pinned forever
        # LIFO free list: hot pages get reused first
        self._free: List[int] = list(range(self.n_pages - 1, 0, -1))

    @property
    def capacity(self) -> int:
        return self.n_pages - 1

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.capacity - self.n_free

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` fresh private pages (each refcount 1), or None."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for pg in pages:
            self.refcount[pg] = 1
        return pages

    def incref(self, page: int) -> None:
        if page == PAGE_NULL or self.refcount[page] < 1:
            raise ValueError(f"incref on non-live page {page} "
                             f"(refcount={int(self.refcount[page])})")
        self.refcount[page] += 1

    def decref(self, page: int) -> bool:
        """Drop one reference; True when the page returned to the free
        list."""
        if page == PAGE_NULL:
            raise ValueError("decref on the null page")
        if self.refcount[page] < 1:
            raise ValueError(f"decref on free page {page}")
        self.refcount[page] -= 1
        if self.refcount[page] == 0:
            self._free.append(page)
            return True
        return False


class _CacheEntry:
    __slots__ = ("page", "last_use")

    def __init__(self, page: int, last_use: int) -> None:
        self.page = page
        self.last_use = last_use


class RadixPrefixCache:
    """Radix index over page-sized token chunks.

    Entry ``i`` of a cached prompt is keyed by the exact tuple
    ``prompt[: (i+1) * page_size]`` — a flat encoding of the radix trie
    where each node's key is its full root path, so ``match`` is a walk
    from the root that stops at the first missing chunk. Every entry
    holds one pool reference on its page.
    """

    def __init__(self, pool: PagePool) -> None:
        self.pool = pool
        self._entries: Dict[Tuple[int, ...], _CacheEntry] = {}
        self._clock = 0
        self.n_inserted = 0
        self.n_evicted = 0

    def __len__(self) -> int:
        return len(self._entries)

    def match(self, prompt: Sequence[int]) -> List[int]:
        """Longest chain of cached full pages covering ``prompt``'s
        prefix (possibly empty). Touches matched entries' LRU stamps."""
        ps = self.pool.page_size
        prompt = tuple(int(t) for t in prompt)
        self._clock += 1
        pages: List[int] = []
        for i in range(len(prompt) // ps):
            e = self._entries.get(prompt[: (i + 1) * ps])
            if e is None:
                break
            e.last_use = self._clock
            pages.append(e.page)
        return pages

    def insert(self, prompt: Sequence[int], plen: int,
               pages: Sequence[int]) -> int:
        """Cache the pages of a retiring slot that are fully covered by
        its prompt (positions entirely ``< plen`` hold real prompt KV;
        later rows are decode output or chunk-tail junk and must never
        be shared). Existing entries win — identical prompts served
        concurrently cache whichever retired first."""
        ps = self.pool.page_size
        prompt = tuple(int(t) for t in prompt)
        self._clock += 1
        n = 0
        for i in range(min(plen // ps, len(pages))):
            pg = int(pages[i])
            if pg == PAGE_NULL:
                break
            key = prompt[: (i + 1) * ps]
            if key in self._entries:
                continue
            self.pool.incref(pg)
            self._entries[key] = _CacheEntry(pg, self._clock)
            n += 1
        self.n_inserted += n
        return n

    def evict(self, n_needed: int) -> int:
        """Free up to ``n_needed`` pages by dropping LRU entries whose
        page nobody else maps (refcount == 1 — evicting a shared page's
        entry would free nothing and forfeit future hits)."""
        if n_needed <= 0:
            return 0
        freed = 0
        for key, e in sorted(self._entries.items(),
                             key=lambda kv: kv[1].last_use):
            if freed >= n_needed:
                break
            if self.pool.refcount[e.page] == 1:
                del self._entries[key]
                self.pool.decref(e.page)
                self.n_evicted += 1
                freed += 1
        return freed

    def drop_all(self) -> None:
        for e in self._entries.values():
            self.pool.decref(e.page)
        self.n_evicted += len(self._entries)
        self._entries.clear()


@dataclasses.dataclass(frozen=True)
class AdmissionPlan:
    """One slot's paging decision: the full (ordered) page-table row,
    how many prompt tokens the prefix cache covers (``matched_len`` —
    prefill for those is skipped), and the at-most-one COW copy the
    device executes at the next block entry (``cow_src/cow_dst``, -1 =
    none)."""
    pages: Tuple[int, ...]
    plen: int
    matched_len: int
    n_shared: int
    cow_src: int
    cow_dst: int

    @property
    def n_pages(self) -> int:
        return len(self.pages)


class PagedKVAllocator:
    """Paging brain for one :class:`~.engine.ServingEngine` run.

    ``try_admit`` mutates the pool (increfs + allocations) and returns
    an :class:`AdmissionPlan` or ``None`` on transient exhaustion (the
    backpressure signal); the engine then either ``bind``s the plan to
    a slot or ``release_plan``s it on a failed admission. ``retire``
    returns a slot's pages and feeds the prefix cache.
    """

    def __init__(self, *, n_pages: int, page_size: int,
                 max_pages_per_slot: int, prefill_chunk: int,
                 prefix_cache: bool = True) -> None:
        self.pool = PagePool(n_pages, page_size)
        self.cache = RadixPrefixCache(self.pool) if prefix_cache else None
        self.max_pages_per_slot = int(max_pages_per_slot)
        self.prefill_chunk = int(prefill_chunk)
        self._bound: Dict[int, AdmissionPlan] = {}
        # committed-frontier ledger (speculative append/rollback): rows
        # the device has ACCEPTED per bound slot. A speculative verify
        # writes up to C rows past this frontier, but the engine only
        # ever advances the ledger by the accepted length — overshoot
        # rows stay uncommitted, get rolled back by overwrite, and the
        # radix trie never caches a page that is not fully committed
        self._committed: Dict[int, int] = {}
        # COW source pages held live until the device executes the copy
        # (the next block): without the hold, a concurrent admission's
        # trie eviction could free the source before the copy runs
        self._cow_holds: List[int] = []
        self.n_admitted = 0
        self.n_cow = 0
        self.matched_tokens = 0
        self.prompt_tokens = 0

    # -- sizing ----------------------------------------------------------

    def pages_needed(self, plen: int, budget: int) -> int:
        """Pages covering every row the slot can write: positions up to
        ``plen + budget - 1`` plus the C-1 junk tail of the final
        chunk-wide write."""
        return pages_for(plen + budget + self.prefill_chunk - 1,
                         self.pool.page_size)

    def admissible(self, plen: int, budget: int) -> bool:
        """False when the request needs more pages than the whole pool
        has — permanent, so the engine fails it instead of waiting."""
        need = self.pages_needed(plen, budget)
        return need <= min(self.pool.capacity, self.max_pages_per_slot)

    # -- admission -------------------------------------------------------

    def try_admit(self, prompt: Sequence[int],
                  budget: int) -> Optional[AdmissionPlan]:
        prompt = [int(t) for t in prompt]
        plen = len(prompt)
        ps = self.pool.page_size
        need = self.pages_needed(plen, budget)
        matched = self.cache.match(prompt) if self.cache is not None else []
        # the last prompt token is always recomputed (its logits are the
        # first output), so a full-prompt hit still re-enters one token
        raw = len(matched) * ps
        lm = min(raw, plen - 1)
        n_shared = lm // ps
        need_cow = (lm % ps) != 0
        # pin shared pages (and the COW source) before any eviction can
        # run — eviction only frees refcount==1 pages, so pinned matches
        # survive the very allocation they enable
        for pg in matched[:n_shared]:
            self.pool.incref(pg)
        cow_src = -1
        if need_cow:
            cow_src = matched[n_shared]
            self.pool.incref(cow_src)
        n_alloc = need - n_shared
        if n_alloc > self.pool.n_free and self.cache is not None:
            self.cache.evict(n_alloc - self.pool.n_free)
        fresh = self.pool.alloc(n_alloc)
        if fresh is None:
            for pg in matched[:n_shared]:
                self.pool.decref(pg)
            if need_cow:
                self.pool.decref(cow_src)
            return None
        cow_dst = fresh[0] if need_cow else -1
        pages = tuple(matched[:n_shared]) + tuple(fresh)
        if need_cow:
            self._cow_holds.append(cow_src)
        return AdmissionPlan(pages=pages, plen=plen, matched_len=lm,
                             n_shared=n_shared, cow_src=cow_src,
                             cow_dst=cow_dst)

    def bind(self, slot: int, plan: AdmissionPlan) -> None:
        if slot in self._bound:
            raise ValueError(f"slot {slot} already bound")
        self._bound[slot] = plan
        # the cached prefix is committed on arrival (those rows hold
        # verified tokens from a previous request); everything past it
        # commits only as the device accepts it
        self._committed[slot] = plan.matched_len
        self.n_admitted += 1
        self.n_cow += int(plan.cow_dst >= 0)
        self.matched_tokens += plan.matched_len
        self.prompt_tokens += plan.plen

    def advance(self, slot: int, frontier: int) -> None:
        """Commit a bound slot's pages up to ``frontier`` accepted rows.

        The engine calls this with the slot's post-block ``pos`` — which
        advances only by prefill chunks and *accepted* speculative
        tokens, never by rejected overshoot. The ledger enforces the
        rollback contract: commits are monotone (a retreat would mean
        already-committed rows were overwritten) and bounded by the
        slot's page reservation (an overshoot past it would mean the
        device wrote rows no page backs)."""
        plan = self._bound.get(slot)
        if plan is None:
            raise ValueError(f"advance on unbound slot {slot}")
        have = self._committed[slot]
        if frontier < have:
            raise ValueError(
                f"slot {slot}: committed frontier moved backwards "
                f"({have} -> {frontier}) — speculative rollback must "
                "never touch committed rows")
        cap = plan.n_pages * self.pool.page_size
        if frontier > cap:
            raise ValueError(
                f"slot {slot}: frontier {frontier} exceeds the slot's "
                f"page reservation ({plan.n_pages} pages x "
                f"{self.pool.page_size} rows)")
        self._committed[slot] = frontier

    def committed_rows(self, slot: int) -> int:
        """Accepted rows committed for a bound slot (0 if unbound)."""
        return self._committed.get(slot, 0)

    def release_plan(self, plan: AdmissionPlan) -> None:
        """Undo ``try_admit`` for a plan that never ran (failed
        admission): one decref per table page covers both the shared
        increfs and the fresh allocations."""
        for pg in plan.pages:
            self.pool.decref(pg)

    def release(self, slot: int) -> None:
        """Scrub path: return a bound slot's pages without caching."""
        plan = self._bound.pop(slot, None)
        self._committed.pop(slot, None)
        if plan is not None:
            self.release_plan(plan)

    def retire(self, slot: int, prompt: Sequence[int]) -> None:
        """Completion path: feed the prefix cache (insert before decref
        so cached pages stay live), then return the slot's pages. Only
        committed prompt rows are cacheable: speculative overshoot never
        reaches the trie because the insert is capped at the committed
        frontier (a finished slot has committed its whole prompt, so the
        cap bites only if the ledger was never advanced)."""
        plan = self._bound.pop(slot)
        committed = self._committed.pop(slot, plan.plen)
        if self.cache is not None:
            self.cache.insert(prompt, min(plan.plen, committed), plan.pages)
        self.release_plan(plan)

    def cow_flush(self) -> None:
        """Drop the COW-source holds once the device block that executes
        the copies has run (the engine calls this after every block)."""
        for pg in self._cow_holds:
            self.pool.decref(pg)
        self._cow_holds.clear()

    # -- gauges ----------------------------------------------------------

    def plan_for(self, slot: int) -> Optional[AdmissionPlan]:
        return self._bound.get(slot)

    @property
    def pages_used(self) -> int:
        return self.pool.n_used

    def occupancy(self) -> float:
        """Fraction of the pool's usable pages currently allocated."""
        return self.pool.n_used / self.pool.capacity

    def fragmentation(self, frontier: Dict[int, int]) -> float:
        """Internal fragmentation over the *bound* slots: 1 - (cache
        rows actually filled) / (rows their pages could hold), given
        each bound slot's current write frontier ``pos``. 0.0 when
        nothing is bound."""
        alloc_rows = 0
        used_rows = 0
        ps = self.pool.page_size
        for slot, plan in self._bound.items():
            rows = plan.n_pages * ps
            alloc_rows += rows
            used_rows += min(int(frontier.get(slot, 0)), rows)
        return 1.0 - used_rows / alloc_rows if alloc_rows else 0.0

    def prefix_hit_rate(self) -> float:
        """Prompt tokens served from the cache / prompt tokens admitted
        (token-weighted, so long shared prefixes count proportionally)."""
        return (self.matched_tokens / self.prompt_tokens
                if self.prompt_tokens else 0.0)

    def check_invariants(self) -> None:
        """Post-drain accounting oracle for the tests: with no bound
        slots and no pending COWs, every live page is either the null
        page or held by exactly the prefix cache."""
        if self._bound or self._cow_holds:
            raise AssertionError("check_invariants on a non-drained "
                                 f"allocator (bound={sorted(self._bound)}, "
                                 f"cow_holds={self._cow_holds})")
        if self._committed:
            raise AssertionError(
                "committed-frontier ledger leaked entries for slots "
                f"{sorted(self._committed)} past drain")
        live = {int(p) for p in np.nonzero(self.pool.refcount)[0]}
        expected = {PAGE_NULL}
        if self.cache is not None:
            for e in self.cache._entries.values():
                expected.add(int(e.page))
            for e in self.cache._entries.values():
                if self.pool.refcount[e.page] != 1:
                    raise AssertionError(
                        f"cached page {int(e.page)} refcount "
                        f"{int(self.pool.refcount[e.page])} != 1 at drain")
        if live != expected:
            raise AssertionError(f"leaked pages: {sorted(live - expected)}; "
                                 f"lost pages: {sorted(expected - live)}")
        if self.pool.n_used != len(live) - 1:
            raise AssertionError(
                f"free-list desync: n_used={self.pool.n_used} vs "
                f"{len(live) - 1} live non-null pages")
