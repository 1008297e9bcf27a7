"""Host-side paged KV allocator with content-addressed prefix caching.

This is the G1 (device HBM) tier's logical block manager — the TPU analog
of the reference's in-engine prefix cache plus the kvbm-logical block
lifecycle (Reset → Partial → Complete → Registered,
docs/design-docs/kvbm-design.md:121-150):

- pages are allocated from a free list per sequence;
- when a page fills, it is *registered* under its lineage hash
  (dynamo_tpu.tokens.hashing) and becomes shareable: later requests with a
  matching prefix reuse it (ref-counted) without recompute;
- freed pages with refcount 0 stay cached (LRU) until capacity demands
  eviction;
- register/evict produce KV events (store/remove) that the worker's
  publisher forwards to the router's indexer.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from dynamo_tpu_torch.tokens.hashing import block_hashes


@dataclass
class KvEvent:
    kind: str  # "store" | "remove"
    block_hashes: List[int]
    # parent hash of the first stored block (lineage anchoring), store only
    parent_hash: Optional[int] = None
    tier: str = "device"  # "device" (G1) | "host" (G2) — router credit tiers


class NoSpace(Exception):
    """Raised when allocation fails even after eviction (caller preempts)."""


class PagePool:
    def __init__(self, num_pages: int, page_size: int):
        self.num_pages = num_pages
        self.page_size = page_size
        self.free: List[int] = list(range(num_pages - 1, -1, -1))
        self.ref: Dict[int, int] = {}  # page -> refcount (allocated pages)
        # registered (complete, content-addressed) pages
        self.by_hash: Dict[int, int] = {}  # block_hash -> page
        self.hash_of: Dict[int, int] = {}  # page -> block_hash
        # cached = registered pages with ref 0, LRU order (evict from front)
        self.cached: "OrderedDict[int, None]" = OrderedDict()
        self.parent_of: Dict[int, Optional[int]] = {}  # hash -> parent hash
        self.events: List[KvEvent] = []
        # offload hook: cb(page, block_hash, parent_hash) invoked just
        # before an evicted page's slot is reused (KVBM G1→G2 offload)
        self.evict_hook = None
        # cb() once an alloc's evictions are all made, before it returns
        # the pages: the port's engine offloads the alloc's evicted pages
        # in one batch here (nothing writes them before alloc returns)
        self.evict_flush = None
        # prefetch-pinned hashes: cached pages eviction must skip (promoted
        # speculatively for an inbound request; pins are TTL-bounded by the
        # PrefetchManager, never held across a pool reset)
        self.pinned: set = set()
        # cb(block_hash) when match_prefix claims a pinned hash (the
        # prefetch hit signal; the pin is dropped before the call)
        self.claim_hook = None
        # fork-on-branch: cb(src_page, dst_page) copies device KV when a
        # branch takes a private copy of a not-yet-complete page (CoW)
        self.copy_hook = None
        self.forks = 0  # fork_table calls (branch fan-outs)
        self.match_hit_blocks = 0  # blocks served warm by match_prefix

    # -- capacity ----------------------------------------------------------
    @property
    def n_free(self) -> int:
        # pinned pages sit in `cached` but eviction skips them, so they are
        # not allocatable headroom (pinned hashes always map to cached
        # pages: pin() requires it, claiming unpins)
        return len(self.free) + len(self.cached) - len(self.pinned)

    def usage(self) -> float:
        return 1.0 - self.n_free / self.num_pages

    # -- allocation --------------------------------------------------------
    def _pop_free(self) -> int:
        if self.free:
            return self.free.pop()
        # evict LRU cached page (offloading its contents first if hooked),
        # skipping prefetch-pinned pages — if EVERY cached page is pinned
        # the pool is genuinely out (pins are brief and TTL-bounded)
        victim = None
        for page in self.cached:
            if self.hash_of[page] not in self.pinned:
                victim = page
                break
        if victim is not None:
            del self.cached[victim]
            h = self.hash_of.pop(victim)
            del self.by_hash[h]
            parent = self.parent_of.pop(h, None)
            if self.evict_hook is not None:
                self.evict_hook(victim, h, parent)
            self.events.append(KvEvent("remove", [h]))
            return victim
        raise NoSpace("no free or evictable pages")

    def alloc(self, n: int) -> List[int]:
        if self.n_free < n:
            raise NoSpace(f"need {n} pages, have {self.n_free} evictable")
        pages = [self._pop_free() for _ in range(n)]
        if self.evict_flush is not None:
            self.evict_flush()
        for p in pages:
            self.ref[p] = 1
        return pages

    # -- prefix cache ------------------------------------------------------
    def match_prefix(
        self, tokens: List[int], parent: "Optional[int]" = None
    ) -> Tuple[List[int], List[int]]:
        """Longest cached prefix → (pages, hashes). Bumps refcounts.
        `parent` seeds the hash chain (per-adapter KV isolation)."""
        pages: List[int] = []
        hashes: List[int] = []
        for h in block_hashes(tokens, self.page_size, parent):
            page = self.by_hash.get(h)
            if page is None:
                break
            pages.append(page)
            hashes.append(h)
        for p in pages:
            self._ref_inc(p)
        for h in hashes:
            if h in self.pinned:  # prefetched block claimed by a request
                self.pinned.discard(h)
                if self.claim_hook is not None:
                    self.claim_hook(h)
        self.match_hit_blocks += len(pages)
        return pages, hashes

    # -- fork-on-branch ----------------------------------------------------
    def fork_table(self, pages: List[int], n_shared: int) -> List[int]:
        """Copy-on-write fork of a sequence's page table (n>1 sampling,
        tool-call retries, tree-speculation branch verify rows): the
        first `n_shared` pages hold KV both branches agree on and are
        shared by reference; the remainder — typically just the partial
        page being written — is duplicated into fresh pages via
        `copy_hook(src, dst)` so divergent decode never clobbers the
        sibling. Raises NoSpace before touching refcounts, so a failed
        fork leaves the parent untouched. Tree speculation forks one
        table per candidate branch each verify iteration and releases
        every loser (or swaps the winner in for the trunk) before
        committing tokens — `release` drops one ref per page, so
        trunk-shared pages survive exactly as long as some table still
        points at them (docs/spec_decode.md)."""
        n_shared = max(0, min(n_shared, len(pages)))
        tail = pages[n_shared:]
        fresh = self.alloc(len(tail)) if tail else []
        for p in pages[:n_shared]:
            self._ref_inc(p)
        if self.copy_hook is not None:
            for src, dst in zip(tail, fresh):
                self.copy_hook(src, dst)
        self.forks += 1
        return pages[:n_shared] + fresh

    def _ref_inc(self, page: int) -> None:
        if page in self.cached:
            del self.cached[page]
            self.ref[page] = 1
        else:
            self.ref[page] = self.ref.get(page, 0) + 1

    def register(self, page: int, block_hash: int, parent_hash: Optional[int]) -> int:
        """Mark a full page content-addressed. If the hash is already
        registered to another page (race between concurrent prefills of the
        same prefix), keep the existing mapping. Returns the canonical page."""
        existing = self.by_hash.get(block_hash)
        if existing is not None and existing != page:
            return existing
        self.by_hash[block_hash] = page
        self.hash_of[page] = block_hash
        self.parent_of[block_hash] = parent_hash
        self.events.append(KvEvent("store", [block_hash], parent_hash))
        return page

    def pin(self, block_hash: int) -> bool:
        """Shield a cached (registered, ref-0) page from eviction until
        unpin/claim. Pinning a hash that is not a cached page is a no-op
        (returns False) — the n_free accounting depends on the invariant."""
        page = self.by_hash.get(block_hash)
        if page is None or page not in self.cached:
            return False
        self.pinned.add(block_hash)
        return True

    def unpin(self, block_hash: int) -> None:
        self.pinned.discard(block_hash)

    def release(self, pages: List[int]) -> None:
        """Drop one reference; refcount-0 registered pages go to the LRU
        cache, unregistered ones back to the free list."""
        for p in pages:
            r = self.ref.get(p, 0) - 1
            if r > 0:
                self.ref[p] = r
                continue
            self.ref.pop(p, None)
            if p in self.hash_of:
                self.cached[p] = None  # most-recently-used end
                self.cached.move_to_end(p)
            else:
                self.free.append(p)

    def drain_events(self) -> List[KvEvent]:
        ev, self.events = self.events, []
        return ev

    def reset(self) -> None:
        """Forget every block and reference: the device pool's CONTENTS
        were lost (e.g. rebuilt after a failed donated step), so every
        cached page and in-flight allocation is garbage. Emits remove
        events for all registered hashes so router indices and lower-tier
        credits stay truthful. Callers must have failed/aborted the
        sequences that held references."""
        if self.by_hash:
            self.events.append(KvEvent("remove", list(self.by_hash)))
        self.free = list(range(self.num_pages - 1, -1, -1))
        self.ref.clear()
        self.by_hash.clear()
        self.hash_of.clear()
        self.cached.clear()
        self.parent_of.clear()
        self.pinned.clear()
