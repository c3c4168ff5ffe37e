"""Paged-KV state manager for the serving engine (counterpart of
``neuronx_distributed_tpu/serving/paged.py``).

Glues the host-side :class:`BlockAllocator` and :class:`PrefixIndex` onto
the engine's slot table: per-slot block tables, worst-case page budgeting
for the scheduler's admission gate, prefix-cache lookup/insert around
prefill, and page release on every terminal state.

- A request's ENTIRE worst-case page need -- non-padding prompt pages it
  cannot reuse plus every decode page up to ``max_new_tokens`` (and, under
  speculative decoding, the ``spec_overshoot`` cells a verify writes past
  the budget) -- is taken at admission, so decode never runs out of pages
  mid-request.
- Admission is transactional: any failure mid-allocation (the
  ``serving/page_alloc`` fault point sits between the prompt-page and
  decode-page allocations) releases every page and reference taken so far
  before re-raising.
- A preempted victim keeps its committed prompt chain pinned while it is
  parked (:meth:`PagedKVManager.park_resume`), so its re-grant prefills only
  the uncommitted tail; the pins count as reclaimable in
  :meth:`PagedKVManager.pages_free` and are dropped, oldest park first, when
  an admission needs their pages, so admission never deadlocks behind
  them.
- Prompt pages live page-aligned in ``[0, context_len)`` and decode writes
  start at ``context_len``, so shared prefix pages are never written.
- With a metrics ``registry`` the pool exports ``kvcache/pages_*`` gauges
  (:meth:`PagedKVManager.export_gauges`) and counts prefix hits, misses and
  skipped prefills, copy-on-write copies and evictions into it.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np

from neuronx_distributed_tpu_torch.kvcache.allocator import NULL_PAGE, BlockAllocator
from neuronx_distributed_tpu_torch.kvcache.prefix import (
    PrefixIndex,
    is_padding_key,
    page_keys,
)
from neuronx_distributed_tpu_torch.resilience.faults import fault_point
from neuronx_distributed_tpu_torch.serving.request import Request

PAGES_TOTAL = "kvcache/pages_total"
PAGES_IN_USE = "kvcache/pages_in_use"
PAGES_CACHED = "kvcache/pages_cached"
PREFIX_HITS_TOTAL = "kvcache/prefix_hits_total"
PREFIX_MISSES_TOTAL = "kvcache/prefix_misses_total"
PREFILL_SKIPPED_TOTAL = "kvcache/prefill_skipped_total"


class PagedKVManager:
    """Host-side paged-KV bookkeeping for one engine.  Implements the
    scheduler's ``page_gate`` protocol and the engine's slot lifecycle
    (:meth:`admit_slot` -> :meth:`fresh_pages` writes -> :meth:`finish_insert`;
    :meth:`release_slot` on any terminal state)."""

    def __init__(self, *, num_slots: int, context_len: int, max_total_len: int,
                 page_size: int, num_pages: int, registry: Any = None,
                 prefix_cache: bool = True, spec_overshoot: int = 0):
        if context_len % page_size != 0 or max_total_len % page_size != 0:
            raise ValueError(
                f"page_size {page_size} must divide context_len "
                f"{context_len} and max_total_len {max_total_len} -- "
                "page-aligned prompts are what make shared prefix pages "
                "immutable (decode writes start at the prefill boundary)")
        self.B = num_slots
        self.C = context_len
        self.T = max_total_len
        self.page_size = page_size
        self.pages_per_slot = max_total_len // page_size
        self.ctx_pages = context_len // page_size
        # a speculative verify writes up to spec_overshoot cells past a
        # request's budget (a rejected tail is rolled back by offset
        # rewind, never un-written): the reservation backs them too
        self.spec_overshoot = spec_overshoot
        self.registry = registry
        self.alloc = BlockAllocator(num_pages, registry=registry)
        self.index = (PrefixIndex(self.alloc, registry=registry)
                      if prefix_cache else None)
        # per-slot logical -> physical page map; NULL_PAGE backs every hole
        self.tables = np.full((num_slots, self.pages_per_slot), NULL_PAGE,
                              np.int32)
        self.tables_dirty = True  # the engine's device mirror is stale
        self._slot_pages: List[List[int]] = [[] for _ in range(num_slots)]
        self._slot_fresh: List[List[tuple]] = [[] for _ in range(num_slots)]
        self._slot_keys: List[Optional[list]] = [None] * num_slots
        # parked victims holding resume pins, in park order (the last-resort
        # reclaim drops the oldest park first)
        self._resume: Dict[int, Request] = {}
        self.prefill_skipped = 0
        if registry is not None:
            registry.gauge(PAGES_TOTAL).set(self.alloc.capacity)
            registry.gauge(PAGES_IN_USE)
            registry.gauge(PAGES_CACHED)
            for c in (PREFIX_HITS_TOTAL, PREFIX_MISSES_TOTAL,
                      PREFILL_SKIPPED_TOTAL):
                registry.counter(c)

    # -- scheduler page-gate protocol --------------------------------------

    def pages_needed(self, req: Request) -> int:
        """Worst-case pages the request can hold at once: its non-padding
        prompt pages plus every decode page through ``max_new_tokens`` (and
        the speculative overshoot)."""
        L = min(req.prompt_len, self.C)
        n_ctx = self.ctx_pages - (self.C - L) // self.page_size
        return n_ctx + self._decode_pages_needed(req)

    def _decode_pages_needed(self, req: Request) -> int:
        return math.ceil(
            (req.max_new_tokens + self.spec_overshoot) / self.page_size)

    def pages_free(self) -> int:
        """The free list, plus what LRU eviction of unpinned cached chains
        would reclaim, plus what dropping parked victims' resume pins (and
        evicting the chains they free) would."""
        free = self.alloc.free_count
        if self.index is not None:
            free += self.index.evictable_pages()
        return free + self._resume_reclaimable()

    def _resume_reclaimable(self) -> int:
        """Pages that releasing every resume pin would make evictable:
        those whose only holders are the index and the pins (refcount == 1
        + pins).  A page an active slot also holds is excluded, so the
        count is a lower bound."""
        if not self._resume:
            return 0
        pins: Dict[int, int] = {}
        for req in self._resume.values():
            for p in req.resume_pages:
                if p != NULL_PAGE:
                    pins[p] = pins.get(p, 0) + 1
        return sum(1 for p, k in pins.items()
                   if self.alloc.refcount(p) == 1 + k)

    def pages_capacity(self) -> int:
        return self.alloc.capacity

    # -- slot lifecycle ----------------------------------------------------

    def admit_slot(self, slot: int, req: Request, ids_row, valid_row,
                   engine_step: int = 0):
        """Build the slot's block table: prefix-cache lookup, then atomic
        allocation of the remaining prompt pages and all decode pages
        (evicting LRU cached chains when the free list is short).  Returns
        the cached prefill logits on an exact full-prompt hit, else None.
        Transactional: on any failure every page taken is released.
        ``engine_step`` is the fault point's context."""
        # a prompt page's KV depends on the adapter that prefilled it (v
        # carries the adapter's delta), so keys are salted with the
        # request's adapter: prefixes are shared within an adapter, never
        # across; adapter-0 keys keep their unsalted bytes
        keys = page_keys(ids_row, valid_row, self.page_size,
                         salt=req.adapter_id)[:self.ctx_pages]
        matched: List[int] = []
        payload = None
        if self.index is not None:
            matched, payload = self.index.lookup(keys)
        taken = [p for p in matched if p != NULL_PAGE]
        try:
            table = np.full((self.pages_per_slot,), NULL_PAGE, np.int32)
            table[:len(matched)] = matched
            # prompt pages beyond the cached prefix; all-padding pages ride
            # the NULL page for free
            todo = [lp for lp in range(len(matched), self.ctx_pages)
                    if not is_padding_key(keys[lp])]
            n_dec = self._decode_pages_needed(req)
            self._ensure_free(len(todo) + n_dec)
            ctx_fresh = self.alloc.alloc(len(todo))
            taken += ctx_fresh
            fresh = list(zip(todo, ctx_fresh))
            for lp, p in fresh:
                table[lp] = p
            fault_point("serving/page_alloc", request_id=req.request_id,
                        engine_step=engine_step)
            dec = self.alloc.alloc(n_dec)
            taken += dec
            table[self.ctx_pages:self.ctx_pages + n_dec] = dec
        except BaseException:
            for p in taken:
                self.alloc.free(p)
            raise
        self._slot_pages[slot] = taken
        self._slot_fresh[slot] = fresh
        self._slot_keys[slot] = keys
        self.tables[slot] = table
        self.tables_dirty = True
        full_hit = payload is not None and len(matched) == self.ctx_pages
        self.prefill_skipped += int(full_hit)
        if self.registry is not None:
            n_hit = sum(1 for lp in range(len(matched))
                        if not is_padding_key(keys[lp]))
            self.registry.counter(PREFIX_HITS_TOTAL).inc(n_hit)
            self.registry.counter(PREFIX_MISSES_TOTAL).inc(len(todo))
            if full_hit:
                self.registry.counter(PREFILL_SKIPPED_TOTAL).inc()
        return payload if full_hit else None

    def fresh_pages(self, slot: int) -> List[tuple]:
        """``[(logical_page, phys_page), ...]`` the engine must fill from the
        prefill row caches; cached-prefix and padding pages are absent."""
        return list(self._slot_fresh[slot])

    def finish_insert(self, slot: int, payload: Any) -> None:
        """Register the slot's prompt chain (with the prefill's last-position
        logits as the full-hit payload) once its pages hold real KV.

        A chunked prefill registers only when its last chunk lands, so an
        identical prompt prefix admitted meanwhile missed the cache and
        prefilled pages of its own.  The chain registered first wins: a
        slot whose chain diverges from the cached one registers nothing,
        and its pages stay private until the slot is released.  (The JAX
        engine raises the index's divergence assertion there.)"""
        if self.index is None or self._slot_keys[slot] is None:
            return
        keys = self._slot_keys[slot]
        pages = [int(p) for p in self.tables[slot][:self.ctx_pages]]
        cached, _ = self.index.peek(keys)
        if cached != pages[:len(cached)]:
            return
        self.index.insert(keys, pages, payload=payload)

    def release_slot(self, slot: int) -> None:
        """Drop every page reference the slot holds and null its block
        table.  Idempotent."""
        if not self._slot_pages[slot] and self._slot_keys[slot] is None:
            return
        self.alloc.free_tail(self._slot_pages[slot])
        self._slot_pages[slot] = []
        self._slot_fresh[slot] = []
        self._slot_keys[slot] = None
        self.tables[slot] = NULL_PAGE
        self.tables_dirty = True

    # -- preemption resume --------------------------------------------------

    def park_resume(self, slot: int, req: Request,
                    fresh_done: Optional[int] = None) -> None:
        """Pin the slot's COMMITTED leading page chain on the victim about
        to be requeued, so its re-grant's prefix lookup matches the chain
        and only the uncommitted tail is prefilled again.

        Call before :meth:`release_slot` (the slot's references keep the
        pages alive while the pin is taken).  ``fresh_done``: how many of
        the slot's fresh prompt pages hold real KV -- None for a DECODE
        victim (its whole prompt chain), else the chunk loop's progress.

        The chain is registered in the prefix index (a mid-chunk victim's
        partial chain never was) and each non-NULL page takes one
        request-held reference, which keeps it from eviction while parked.
        Where the index already holds another chain under these keys (an
        identical prompt registered first), that chain holds the same KV:
        it is pinned instead, and nothing is registered.  (The JAX manager
        raises the index's divergence assertion there.)
        :meth:`release_resume` drops the pin exactly once."""
        if self.index is None or req.resume_keys is not None:
            return
        keys = self._slot_keys[slot]
        if keys is None:
            return
        fresh = self._slot_fresh[slot]
        if fresh_done is None or not fresh:
            depth = self.ctx_pages
        else:
            depth = fresh[0][0] + min(int(fresh_done), len(fresh))
        if depth <= 0:
            return
        ckeys = list(keys[:depth])
        pages = [int(p) for p in self.tables[slot][:depth]]
        cached, _ = self.index.peek(ckeys)
        if cached == pages[:len(cached)]:
            self.index.insert(ckeys, pages)
        else:
            ckeys, pages = ckeys[:len(cached)], cached
        for p in pages:
            self.alloc.retain(p)  # no-op on NULL padding pages
        req.resume_pages = pages
        req.resume_keys = ckeys
        self._resume[req.request_id] = req

    def release_resume(self, req: Request) -> None:
        """Drop a parked victim's resume pin.  Idempotent: the re-grant,
        every terminal path and the pool-pressure reclaim may all call it.
        The chain stays in the prefix index under its own references."""
        if req.resume_keys is None and not req.resume_pages:
            return
        self.alloc.free_tail(req.resume_pages)
        req.resume_pages = []
        req.resume_keys = None
        self._resume.pop(req.request_id, None)

    def prefix_fingerprints(self) -> set:
        """Chain fingerprints of every prompt chain the prefix index holds
        (empty without a prefix cache): the fleet router's shadow-resync
        source."""
        if self.index is None:
            return set()
        return self.index.chain_fingerprints()

    def flush_prefix_cache(self) -> int:
        """Drop every cached prefix chain (the live weight swap: cached KV
        and full-hit logits were computed by the outgoing weights, so no
        admission after the swap may hit them).  Active slots and parked
        resume pins keep their own page references.  Returns the nodes
        dropped (0 without a prefix cache)."""
        if self.index is None:
            return 0
        return self.index.flush()

    def _ensure_free(self, n: int) -> None:
        """Make room for ``n`` pages: evict LRU unpinned cached chains, then
        as a last resort drop parked victims' resume pins (oldest park
        first; those victims prefill again from scratch) and evict the
        chains they freed.  The admission gate already checked that free +
        evictable + pin-reclaimable covers it."""
        short = n - self.alloc.free_count
        if short > 0 and self.index is not None:
            short -= self.index.evict(short)
        if short > 0 and self._resume and self.index is not None:
            for rid in list(self._resume):
                self.release_resume(self._resume[rid])
                short -= self.index.evict(short)
                if short <= 0:
                    break

    def export_gauges(self) -> None:
        """Refresh the pool gauges (the engine calls it once a step)."""
        if self.registry is None:
            return
        self.registry.gauge(PAGES_TOTAL).set(self.alloc.capacity)
        self.registry.gauge(PAGES_IN_USE).set(self.alloc.in_use)
        self.registry.gauge(PAGES_CACHED).set(
            self.index.evictable_pages() if self.index is not None else 0)

    def leaked_pages(self) -> int:
        """Allocated pages beyond those the prefix index holds; 0 once every
        slot is released means no page leaked."""
        cached = ({n.page for n in self.index._iter() if n.page != NULL_PAGE}
                  if self.index is not None else set())
        return self.alloc.in_use - len(cached)

    def assert_invariants(self) -> None:
        """Allocator and index invariants, plus: every non-NULL table entry
        of a slot is a page the slot holds a reference on."""
        self.alloc.assert_invariants()
        if self.index is not None:
            self.index.assert_invariants()
        for slot in range(self.B):
            for p in self._slot_pages[slot]:
                assert self.alloc.refcount(p) >= 1, (
                    f"slot {slot} references freed page {p}")
            held = {int(p) for p in self.tables[slot] if p != NULL_PAGE}
            assert held <= set(self._slot_pages[slot]), (
                f"slot {slot} table points at pages it holds no reference "
                f"on: {sorted(held - set(self._slot_pages[slot]))}")
        for rid, req in self._resume.items():
            assert req.resume_keys is not None, (
                f"parked request {rid} tracked without a resume chain")
            for p in req.resume_pages:
                if p != NULL_PAGE:
                    # the pin's own reference plus the index's
                    assert self.alloc.refcount(p) >= 2, (
                        f"parked request {rid} pins page {p} with refcount "
                        f"{self.alloc.refcount(p)}")
