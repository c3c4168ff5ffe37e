"""Paged-KV state manager for the serving engine (counterpart of
``neuronx_distributed_tpu/serving/paged.py``; preemption resume pins land
with their slice).

Glues the host-side :class:`BlockAllocator` and :class:`PrefixIndex` onto
the engine's slot table: per-slot block tables, worst-case page budgeting
for the scheduler's admission gate, prefix-cache lookup/insert around
prefill, and page release on every terminal state.

- A request's ENTIRE worst-case page need -- non-padding prompt pages it
  cannot reuse plus every decode page up to ``max_new_tokens`` (and, under
  speculative decoding, the ``spec_overshoot`` cells a verify writes past
  the budget) -- is taken at admission, so decode never runs out of pages
  mid-request.
- Admission is transactional: any failure mid-allocation releases every
  page and reference taken so far before re-raising.
- Prompt pages live page-aligned in ``[0, context_len)`` and decode writes
  start at ``context_len``, so shared prefix pages are never written.
"""

from __future__ import annotations

import math
from typing import Any, List, Optional

import numpy as np

from neuronx_distributed_tpu_torch.kvcache.allocator import NULL_PAGE, BlockAllocator
from neuronx_distributed_tpu_torch.kvcache.prefix import (
    PrefixIndex,
    is_padding_key,
    page_keys,
)
from neuronx_distributed_tpu_torch.serving.request import Request


class PagedKVManager:
    """Host-side paged-KV bookkeeping for one engine.  Implements the
    scheduler's ``page_gate`` protocol and the engine's slot lifecycle
    (:meth:`admit_slot` -> :meth:`fresh_pages` writes -> :meth:`finish_insert`;
    :meth:`release_slot` on any terminal state)."""

    def __init__(self, *, num_slots: int, context_len: int, max_total_len: int,
                 page_size: int, num_pages: int, prefix_cache: bool = True,
                 spec_overshoot: int = 0):
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
        self.alloc = BlockAllocator(num_pages)
        self.index = PrefixIndex(self.alloc) if prefix_cache else None
        # per-slot logical -> physical page map; NULL_PAGE backs every hole
        self.tables = np.full((num_slots, self.pages_per_slot), NULL_PAGE,
                              np.int32)
        self.tables_dirty = True  # the engine's device mirror is stale
        self._slot_pages: List[List[int]] = [[] for _ in range(num_slots)]
        self._slot_fresh: List[List[tuple]] = [[] for _ in range(num_slots)]
        self._slot_keys: List[Optional[list]] = [None] * num_slots
        self.prefill_skipped = 0

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
        """The free list plus what LRU eviction of unpinned cached chains
        would reclaim."""
        free = self.alloc.free_count
        if self.index is not None:
            free += self.index.evictable_pages()
        return free

    def pages_capacity(self) -> int:
        return self.alloc.capacity

    # -- slot lifecycle ----------------------------------------------------

    def admit_slot(self, slot: int, req: Request, ids_row, valid_row):
        """Build the slot's block table: prefix-cache lookup, then atomic
        allocation of the remaining prompt pages and all decode pages
        (evicting LRU cached chains when the free list is short).  Returns
        the cached prefill logits on an exact full-prompt hit, else None.
        Transactional: on any failure every page taken is released."""
        keys = page_keys(ids_row, valid_row, self.page_size)[:self.ctx_pages]
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

    def _ensure_free(self, n: int) -> None:
        """Evict LRU unpinned cached chains until ``n`` pages are free (the
        admission gate already checked free + evictable covers it)."""
        short = n - self.alloc.free_count
        if short > 0 and self.index is not None:
            self.index.evict(short)

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
