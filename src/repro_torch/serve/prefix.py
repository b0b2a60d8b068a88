"""Content-addressed prefix cache over the block-paged KV pool.

At multi-tenant scale most requests share system-prompt prefixes, and the
block-paged pool (serve/paged.py, PR 7) makes reuse a pure *allocator*
problem: a prompt page's KV content is a deterministic function of the
token prefix that produced it (causal stack, absolute positions fixed by
the page index), the paged kernels are invariant under page permutation,
and RACE-IT quantizer scales are per-tensor — so a cached int8 code page
is reusable **verbatim** by any request whose prompt starts with the same
tokens, with zero kernel edits.

**Chained page hashes.** Each *full* page of prompt tokens is keyed by

    h_0 = H(root | tokens[0:ps])
    h_i = H(h_{i-1} | tokens[i*ps:(i+1)*ps])

so a hit on ``h_i`` certifies the *entire* prefix up to and including
page ``i`` matches — lookups walk the chain and stop at the first miss,
and two prompts that diverge anywhere produce unrelated digests from the
divergent page onward (content addressing without storing any tokens).

**Lifecycle** (the allocator transitions live in
`repro_torch.serve.paged.PageAllocator`; this module owns *which* pages are
shared and *when* they die):

    lookup   admission walks the prompt's chain; every hit page is
             ``acquire``d into the slot's block table (ref += 1) and the
             slot starts chunk-streaming at the first miss. Hits are
             capped at ``(P - 1) // page_size`` pages: the last prompt
             token is always recomputed, because its logits seed
             generation and a fully-cached prompt would otherwise never
             produce them.
    promote  as a miss request streams its prompt, each page that fills
             completely is promoted from private to shared (ref = 1, the
             streamer keeps its reference) and registered under its chain
             digest — the next request with this prefix hits it.
    release  retiring (or quarantining) a slot decrefs its referenced
             pages; ref==0 pages stay cached — they ARE the cache — in
             LRU order.
    evict    under allocation pressure, ref==0 pages are evicted
             least-recently-used back to the free list. Referenced pages
             are pinned (a running request maps them); evicting a
             mid-chain page merely truncates future lookups at that
             point — descendants keep their entries and become reachable
             again if the prefix is ever re-promoted.

Quarantine leaks only *private* pages (see `PageAllocator.leak_slot`):
shared pages are immutable and fully written before promotion, so a dead
row holding a reference is no more dangerous than a live one.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Optional, Sequence

from .paged import PageAllocator

__all__ = ["PrefixCache", "page_digest"]

_ROOT = b"raceit-prefix-root"


def page_digest(prev: bytes, tokens: Sequence[int]) -> bytes:
    """Chain digest of one page: H(prev | token bytes).

    Token values ride as their decimal repr joined with separators —
    unambiguous (no width assumptions on the vocab) and host-side only,
    so the cost is per admitted page, never per step.
    """
    h = hashlib.blake2b(prev, digest_size=16)
    h.update(",".join(str(int(t)) for t in tokens).encode())
    return h.digest()


class PrefixCache:
    """digest -> shared physical page, in LRU order, over ``allocator``.

    The cache never allocates pages itself: promotion re-labels pages a
    streaming request already owns, so cache capacity is bounded by the
    pool and eviction is only ever *back* to the free list. All state is
    host-side Python (the device sees only block tables).
    """

    def __init__(self, allocator: PageAllocator, page_size: int):
        if page_size < 1:
            raise ValueError(f"page_size={page_size} must be >= 1")
        self.allocator = allocator
        self.page_size = int(page_size)
        # LRU: most-recently-used at the end; hits and promotions both
        # refresh recency (move_to_end / append)
        self._entries: "OrderedDict[bytes, int]" = OrderedDict()
        # counters for serve/metrics + the bench rows
        self.hit_pages = 0      # pages mapped from cache at admission
        self.miss_pages = 0     # full prompt pages that had to stream
        self.hit_requests = 0   # admissions with >= 1 hit page
        self.lookups = 0        # admissions consulted
        self.promotions = 0
        self.evictions = 0

    # -------------------------------------------------------------- queries
    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, digest: bytes) -> bool:
        return digest in self._entries

    @property
    def pages_saved(self) -> int:
        """Prompt pages served from cache instead of streamed (running
        total — the bench's pages-saved counter)."""
        return self.hit_pages

    def n_evictable(self, pinned: frozenset = frozenset()) -> int:
        """Shared pages at ref==0 (minus ``pinned``) — the headroom the
        deadlock check adds to the free list."""
        return sum(1 for p in self._entries.values()
                   if p not in pinned and self.allocator.shared_ref(p) == 0)

    # -------------------------------------------------------------- lookup
    def match(self, prompt: Sequence[int]) -> tuple[list, bytes, int]:
        """Walk the prompt's hash chain; returns (hit entries, last
        digest, tokens covered) with hit entries as (digest, page) pairs.

        Pure: touches neither refcounts nor LRU order nor counters — an
        admission attempt can be retried under page-pool backpressure
        without skewing stats or recency. The caller ``commit``s the hit
        once its private-page allocation succeeded (and only then
        ``acquire``s the pages). The returned digest is the chain value
        *after* the last hit page — the streaming slot continues
        promotion from it.
        """
        ps = self.page_size
        max_hit = (len(prompt) - 1) // ps  # last token always recomputed
        hits: list[tuple[bytes, int]] = []
        digest = _ROOT
        for i in range(max_hit):
            nxt = page_digest(digest, prompt[i * ps:(i + 1) * ps])
            page = self._entries.get(nxt)
            if page is None:
                break
            hits.append((nxt, page))
            digest = nxt
        return hits, digest, len(hits) * ps

    def commit(self, hits: list, n_full_pages: int) -> None:
        """Record a committed admission: refresh the hit run's LRU
        recency and the hit/miss counters (``n_full_pages`` is the
        prompt's full-page count, so misses = full - hits)."""
        self.lookups += 1
        for digest, _ in hits:
            self._entries.move_to_end(digest)
        self.hit_pages += len(hits)
        self.miss_pages += n_full_pages - len(hits)
        self.hit_requests += bool(hits)

    # ----------------------------------------------------------- promotion
    def promote(self, slot: int, page: int, digest: bytes,
                tokens: Sequence[int]) -> tuple[bool, bytes]:
        """Register a fully-streamed prompt page under its chain digest.

        Returns (promoted, next digest). A digest that is already cached
        (a concurrent request streamed the same prefix first) is left
        alone and ``promoted`` is False — the caller's page stays private
        and its promotion walk must STOP there: promoting a *later* page
        would interleave private and shared pages in the block-table row,
        breaking the refs-then-owned row order the allocator maintains.
        """
        nxt = page_digest(digest, tokens)
        if nxt in self._entries:
            return False, nxt
        self.allocator.promote(slot, page)
        self._entries[nxt] = page
        self.promotions += 1
        return True, nxt

    # ------------------------------------------------------------ eviction
    def evict(self, n: int, pinned: frozenset = frozenset()) -> int:
        """Evict up to ``n`` ref==0 pages, least-recently-used first,
        back to the allocator's free list; returns the number evicted.
        ``pinned`` pages (an in-flight admission's hit run) are skipped.
        """
        if n <= 0:
            return 0
        victims = [d for d, p in self._entries.items()
                   if p not in pinned and self.allocator.shared_ref(p) == 0]
        evicted = 0
        for digest in victims[:n]:
            page = self._entries.pop(digest)
            self.allocator.evict_shared(page)
            evicted += 1
        self.evictions += evicted
        return evicted

    # --------------------------------------------------------------- stats
    def stats(self) -> dict:
        total = self.hit_pages + self.miss_pages
        return {
            "prefix_entries": len(self._entries),
            "prefix_lookups": self.lookups,
            "prefix_hit_requests": self.hit_requests,
            "prefix_hit_pages": self.hit_pages,
            "prefix_miss_pages": self.miss_pages,
            "prefix_hit_rate_pct": (100.0 * self.hit_pages / total
                                    if total else 0.0),
            "prefix_pages_saved": self.pages_saved,
            "prefix_promotions": self.promotions,
            "prefix_evictions": self.evictions,
        }
