"""Host-side page bookkeeping for block-paged KV serving.

`PageAllocator` owns the physical pages of the pool cache built by
`Model.init_slot_cache(page_size=..., n_pages=...)`. It is plain Python
over numpy — page assignment is a *scheduling* decision, made once per
admission on the host, so none of this touches a traced value: the device
only ever sees the resulting (n_slots, max_pages) block-table array.

Pages live in exactly one of **four** states (the refcount-aware pool
partition, checked by `assert_invariants` and asserted after every step by
the property suite in tests/test_serve_paged.py):

* **free**    — on the free list, issuable;
* **private** — owned by exactly one slot, writable by that slot's row
  (``alloc`` hands them out, ``free_slot`` returns them);
* **shared**  — immutable, content-addressed prompt pages owned by the
  prefix cache (`repro_torch.serve.prefix.PrefixCache`) and *referenced* by any
  number of slots through per-slot refcounts: ``promote`` turns a slot's
  fully-streamed private prompt page into a shared one (the promoting
  slot keeps a reference), ``acquire`` adds a reference on a prefix-cache
  hit, retiring a slot releases its references, and a ref==0 shared page
  is evictable back to the free list (``evict_shared``) but never freed
  implicitly — it *is* the prefix cache's storage;
* **leaked**  — dropped permanently by slot quarantine; never re-issued.

So: ``free + leaked + Σ private + shared = n_pages - 1`` (page 0 is the
trash page — never owned, never free, never issued).

Allocation is whole-request and up-front: `ContinuousBatcher` reserves
every page a request can ever need (prompt + n_new - 1 tokens, minus the
prefix-cache hit pages it only references) at admission, so a running
request can never stall mid-stream waiting for a page — backpressure
happens at admission time, where the request can simply stay queued.

Quarantine (``leak_slot``) leaks only *private* pages: a dead row may
still address them and a missed write fence would corrupt a re-issued
page. Shared pages are merely *released* (decref) — they are immutable,
every writer finished before promotion, and live readers keep them mapped
regardless, so leaking them would shrink the pool without protecting
anyone.
"""
from __future__ import annotations

from typing import Optional

__all__ = ["PageAllocator"]


class PageAllocator:
    """Free-list allocator over physical pages [1, n_pages).

    ``alloc(slot, n)`` hands ``n`` private pages to ``slot`` (returns None
    without side effects when fewer than ``n`` are free); ``free_slot``
    returns a slot's private pages to the free list and releases its
    shared references (normal retire); ``leak_slot`` drops the private
    pages permanently and releases the shared references (quarantine).
    ``promote``/``acquire``/``evict_shared`` are the prefix-cache
    transitions — see the module docstring for the page-state diagram.
    """

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError(f"n_pages={n_pages}: need at least the trash "
                             f"page plus one allocatable page")
        self.n_pages = n_pages
        # LIFO free list: recently-freed pages are re-issued first, which
        # maximizes page shuffling across a trace — exactly the property
        # the paged kernels' permutation-invariance tests feed on
        self._free: list[int] = list(range(n_pages - 1, 0, -1))
        self._owned: dict[int, list[int]] = {}
        self._leaked: set[int] = set()
        # shared (immutable, prefix-cache-owned) pages: page -> refcount,
        # plus the per-slot reference lists that back free/leak release.
        # A page can be referenced at most once per slot (a block-table
        # row maps each logical page exactly once).
        self._shared: dict[int, int] = {}
        self._refs: dict[int, list[int]] = {}
        self.peak_in_use = 0  # max(private + shared) over the run

    # ------------------------------------------------------------- queries
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_leaked(self) -> int:
        return len(self._leaked)

    @property
    def n_shared(self) -> int:
        """Shared (prefix-cache-owned) pages, referenced or not."""
        return len(self._shared)

    @property
    def pages_in_use(self) -> int:
        """Pages currently owned by live slots (excludes trash, shared
        and leaked — the *private* term of the pool partition)."""
        return sum(len(p) for p in self._owned.values())

    def owned(self, slot: int) -> list[int]:
        return list(self._owned.get(slot, ()))

    def refs(self, slot: int) -> list[int]:
        """Shared pages referenced by ``slot``, in block-table order."""
        return list(self._refs.get(slot, ()))

    def shared_ref(self, page: int) -> int:
        """Refcount of a shared page (KeyError when not shared)."""
        return self._shared[page]

    def is_shared(self, page: int) -> bool:
        return page in self._shared

    # ------------------------------------------------------- state changes
    def _note_peak(self) -> None:
        in_use = self.pages_in_use + len(self._shared)
        if in_use > self.peak_in_use:
            self.peak_in_use = in_use

    def alloc(self, slot: int, n: int) -> Optional[list[int]]:
        """Reserve ``n`` private pages for ``slot``; None (no side
        effects) when the free list is short — the caller's backpressure
        signal. ``n == 0`` is a valid whole-request reservation (a full
        prefix-cache hit needs no private pages)."""
        if slot in self._owned or slot in self._refs:
            raise ValueError(f"slot {slot} already holds pages; free or "
                             f"leak it before re-admitting")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self._owned[slot] = pages
        self._note_peak()
        return list(pages)

    def promote(self, slot: int, page: int) -> None:
        """Move one of ``slot``'s private pages into the shared set.

        The page becomes immutable prefix-cache storage; the promoting
        slot keeps using it, so it starts at refcount 1 and joins the
        slot's reference list. Prompt pages are promoted in prefix order,
        and hit pages always precede private pages in a block-table row,
        so a slot's row is always ``refs(slot) + owned(slot)``.
        """
        held = self._owned.get(slot, [])
        if not held or held[0] != page:
            raise ValueError(
                f"slot {slot} cannot promote page {page}: promotion walks "
                f"the block-table row in order, so the page must be the "
                f"slot's first private page (held: {held[:3]}...)")
        if page in self._shared:
            raise ValueError(f"page {page} is already shared")
        held.pop(0)
        if not held:
            del self._owned[slot]
        self._shared[page] = 1
        self._refs.setdefault(slot, []).append(page)

    def acquire(self, slot: int, page: int) -> None:
        """Add ``slot``'s reference to a shared page (prefix-cache hit)."""
        if page not in self._shared:
            raise ValueError(f"page {page} is not shared")
        self._shared[page] += 1
        self._refs.setdefault(slot, []).append(page)

    def release_refs(self, slot: int) -> None:
        """Drop every shared reference ``slot`` holds (the pages stay
        shared at their remaining refcount — possibly 0, i.e. evictable)."""
        for page in self._refs.pop(slot, ()):
            self._shared[page] -= 1

    def evict_shared(self, page: int) -> None:
        """Return a ref==0 shared page to the free list (prefix-cache
        LRU eviction). Refusing referenced pages keeps a running hit
        request's mapped pages pinned."""
        if self._shared.get(page, None) != 0:
            raise ValueError(f"page {page} is not an evictable shared page "
                             f"(ref={self._shared.get(page)!r})")
        del self._shared[page]
        self._free.append(page)

    def free_slot(self, slot: int) -> None:
        """Normal retire: private pages return to the free list, shared
        references are released."""
        self._free.extend(self._owned.pop(slot, ()))
        self.release_refs(slot)

    def leak_slot(self, slot: int) -> None:
        """Quarantine retire: the slot's *private* pages leave the economy
        for good. The dead row keeps faulting every call; its writes are
        fenced to the trash page by per-call block tables, but re-issuing
        pages a dead row has addressed means one missed fence corrupts a
        live request — cheap insurance on an already-degraded pool.
        Shared references are only released: those pages are immutable,
        fully written before promotion, and other live rows keep reading
        them either way (leaking them protects nobody)."""
        self._leaked.update(self._owned.pop(slot, ()))
        self.release_refs(slot)

    # ---------------------------------------------------------- invariants
    def assert_invariants(self) -> None:
        """Every page in exactly one of {free, private-owned-by-one-slot,
        shared, leaked}; page 0 in none of them; shared refcounts equal
        the per-slot reference lists exactly."""
        seen: dict[int, str] = {}

        def claim(page: int, owner: str) -> None:
            if page == 0:
                raise AssertionError(f"trash page 0 appears in {owner}")
            if not 0 < page < self.n_pages:
                raise AssertionError(f"page {page} out of range in {owner}")
            if page in seen:
                raise AssertionError(
                    f"page {page} double-held: {seen[page]} and {owner}")
            seen[page] = owner

        for p in self._free:
            claim(p, "free")
        for slot, pages in self._owned.items():
            for p in pages:
                claim(p, f"slot {slot}")
        for p in self._shared:
            claim(p, "shared")
        for p in self._leaked:
            claim(p, "leaked")
        if len(seen) != self.n_pages - 1:
            missing = set(range(1, self.n_pages)) - set(seen)
            raise AssertionError(f"pages lost from the economy: {missing}")
        counts: dict[int, int] = {}
        for slot, pages in self._refs.items():
            for p in pages:
                if p not in self._shared:
                    raise AssertionError(
                        f"slot {slot} references non-shared page {p}")
                if pages.count(p) != 1:
                    raise AssertionError(
                        f"slot {slot} references page {p} twice")
                counts[p] = counts.get(p, 0) + 1
        for p, ref in self._shared.items():
            if ref != counts.get(p, 0):
                raise AssertionError(
                    f"shared page {p} refcount {ref} != "
                    f"{counts.get(p, 0)} slot references")
            if ref < 0:
                raise AssertionError(f"shared page {p} refcount {ref} < 0")
