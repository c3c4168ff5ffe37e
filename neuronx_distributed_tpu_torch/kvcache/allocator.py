"""Host-side page accounting for the paged KV cache (a copy of
``neuronx_distributed_tpu/kvcache/allocator.py``): copy-on-write copies
count into ``kvcache/cow_copies_total`` when a metrics registry is given,
and into the plain :attr:`BlockAllocator.cow_copies` attribute always.

The :class:`BlockAllocator` owns the *bookkeeping* of the device page pool
(:mod:`.pool`): a free list plus a refcount per allocated page.  It is pure
Python with no jax imports, so every allocation policy property (atomic
allocation, no leak, no double free, copy-on-write semantics) is testable
without compiling anything — the same layering as the serving
``SlotScheduler``.

Page ``0`` is the reserved NULL page: block-table entries that back nothing
(left-padding pages, not-yet-written decode pages) all point at it.  Its
device content is never written, it is never allocated, and ``retain`` /
``free`` on it are no-ops — so callers can treat a block-table row uniformly
without special-casing holes.

Allocation is ATOMIC: ``alloc(n)`` either returns ``n`` pages or raises
:class:`PoolExhausted` having taken nothing.  A partial grant would be a
leak factory — the caller's cleanup path would have to know how far the
allocator got.

Sharing is by refcount: a prefix-cache hit ``retain``\\ s the shared pages,
and ``free`` only returns a page to the free list when the last reference
drops.  ``cow`` implements copy-on-write at the accounting level: writing a
page you share requires either exclusivity (refcount 1 — write in place) or
a fresh page (the caller device-copies the content and writes the copy).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Tuple

# reserved zero page: block-table entries with nothing behind them point here
NULL_PAGE = 0

COW_COPIES_TOTAL = "kvcache/cow_copies_total"


class PoolExhausted(RuntimeError):
    """The page pool cannot satisfy the allocation right now — a
    *transient* condition (pages free as requests terminate or the prefix
    cache evicts), the kv-page analogue of the serving
    ``BackpressureError``: retry after load drains.  The failed ``alloc``
    took nothing (never a partial allocation)."""


class BlockAllocator:
    """Free-list page allocator with refcounted sharing.

    ``num_pages`` is the device pool's total page count *including* the
    reserved NULL page, so :attr:`capacity` (= ``num_pages - 1``) is what is
    actually allocatable.  :attr:`cow_copies` counts copy-on-write copies;
    ``registry`` (an ``obs.MetricRegistry``) receives them as
    ``kvcache/cow_copies_total`` too.
    """

    def __init__(self, num_pages: int, registry: Any = None):
        if num_pages < 2:
            raise ValueError(
                f"num_pages must be >= 2 (page 0 is the reserved NULL page), "
                f"got {num_pages}")
        self.num_pages = num_pages
        self.cow_copies = 0
        self.registry = registry
        if registry is not None:
            registry.counter(COW_COPIES_TOTAL)
        # pop() hands out low ids first — deterministic, test-friendly order
        self._free: List[int] = list(range(num_pages - 1, NULL_PAGE, -1))
        self._refs: Dict[int, int] = {}
        # bumped on every refcount mutation — lets PrefixIndex memoize its
        # trie-wide evictable count between mutations (the steady decode
        # path mutates nothing, so per-step gauge export stays O(1))
        self.version = 0

    # -- introspection -----------------------------------------------------

    @property
    def capacity(self) -> int:
        """Allocatable pages (the NULL page excluded)."""
        return self.num_pages - 1

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return len(self._refs)

    def refcount(self, page: int) -> int:
        """Live references on ``page`` (0 = free/unknown).  The NULL page has
        no refcount — asking for one is a caller bug."""
        if page == NULL_PAGE:
            raise ValueError("the NULL page is not refcounted")
        return self._refs.get(page, 0)

    # -- lifecycle ---------------------------------------------------------

    def alloc(self, n: int) -> List[int]:
        """Take ``n`` pages (each with refcount 1) or raise
        :class:`PoolExhausted` having taken NOTHING."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} pages")
        if n > len(self._free):
            raise PoolExhausted(
                f"need {n} KV pages, {len(self._free)} free "
                f"(capacity {self.capacity}); retry after requests drain or "
                "the prefix cache evicts")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        self.version += 1
        return pages

    def retain(self, page: int) -> None:
        """Add a reference to an allocated page (prefix-cache sharing).
        No-op on the NULL page."""
        if page == NULL_PAGE:
            return
        if page not in self._refs:
            raise ValueError(f"retain of unallocated page {page}")
        self._refs[page] += 1
        self.version += 1

    def free(self, page: int) -> None:
        """Drop one reference; the page returns to the free list when the
        last reference drops.  No-op on the NULL page; freeing an
        unallocated page is a double free and raises."""
        if page == NULL_PAGE:
            return
        rc = self._refs.get(page)
        if rc is None:
            raise ValueError(f"double free / free of unallocated page {page}")
        if rc == 1:
            del self._refs[page]
            self._free.append(page)
        else:
            self._refs[page] = rc - 1
        self.version += 1

    def free_tail(self, pages: "Iterable[int]") -> int:
        """Release a whole TAIL of page references in one call — the
        speculative-decoding rollback path: a rejected draft tail (or a
        terminal slot's worst-case overshoot reservation) rolls back by
        refcount alone, no device copy.  NULL pages in the list are skipped
        (block-table holes ride through uniformly).  Returns how many pages
        actually returned to the free list (shared prefix pages only
        decref).  Each drop is the same accounting as :meth:`free`, so the
        no-leak/no-double-free invariants hold unchanged."""
        freed = 0
        for p in pages:
            if p == NULL_PAGE:
                continue
            exclusive = self._refs.get(p) == 1
            self.free(p)
            freed += int(exclusive)
        return freed

    def cow(self, page: int) -> Tuple[int, bool]:
        """Copy-on-write: make ``page`` writable for a caller holding one
        reference.  Exclusive (refcount 1) pages are returned as-is
        (``(page, False)``); shared pages release the caller's reference and
        allocate a fresh exclusive page (``(new_page, True)`` — the caller
        must device-copy the old content before writing).  Atomic: on
        :class:`PoolExhausted` the original reference is untouched."""
        if page == NULL_PAGE:
            raise ValueError("the NULL page is never writable")
        rc = self._refs.get(page)
        if rc is None:
            raise ValueError(f"cow of unallocated page {page}")
        if rc == 1:
            return page, False
        [new] = self.alloc(1)  # may raise PoolExhausted; nothing changed yet
        self._refs[page] = rc - 1
        self.cow_copies += 1
        if self.registry is not None:
            self.registry.counter(COW_COPIES_TOTAL).inc()
        return new, True

    # -- invariants --------------------------------------------------------

    def assert_invariants(self) -> None:
        """No page both free and allocated, no duplicates, no NULL page in
        either set, every refcount >= 1, free + in-use == capacity.
        O(pages) — cheap enough to run after every op in tests."""
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate pages in free list"
        assert NULL_PAGE not in free and NULL_PAGE not in self._refs, (
            "the NULL page entered circulation")
        assert not (free & set(self._refs)), (
            f"pages both free and allocated: {sorted(free & set(self._refs))}")
        for p, rc in self._refs.items():
            assert 0 < p < self.num_pages, f"page id {p} out of range"
            assert rc >= 1, f"page {p} allocated with refcount {rc}"
        for p in free:
            assert 0 < p < self.num_pages, f"free page id {p} out of range"
        assert len(free) + len(self._refs) == self.capacity, (
            f"page leak: {len(free)} free + {len(self._refs)} in use "
            f"!= capacity {self.capacity}")
