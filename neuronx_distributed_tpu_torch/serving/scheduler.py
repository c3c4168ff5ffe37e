"""Slot scheduler: priority/deadline admission over a fixed-size slot table
(the admission core of ``neuronx_distributed_tpu/serving/scheduler.py``;
preemption, deadline-feasibility shedding, tenant rate limits and fleet
withdrawal land with their slices).

The decode batch has a fixed width ``B``; the scheduler treats it as a pool
of ``B`` slots.  Requests queue per priority class (``interactive`` ahead of
``batch``), earliest-deadline-first within a class (deadline-less requests
FCFS behind every deadline).  A batch-tier request that has waited longer
than ``max_batch_wait_s`` is granted first, so the batch tier drains.
Cancellation and deadline sweeps free slots before admission.  Pure
host-side bookkeeping.
"""

from __future__ import annotations

import bisect
import math
import time
from typing import Dict, List, Optional, Tuple

from neuronx_distributed_tpu_torch.serving.request import (
    PRIORITIES,
    PRIORITY_BATCH,
    PRIORITY_INTERACTIVE,
    Request,
    RequestState,
)

DEFAULT_MAX_BATCH_WAIT_S = 30.0


class AdmissionError(ValueError):
    """Request can never fit the serving envelope."""


class BackpressureError(RuntimeError):
    """The admission queue is full -- a transient rejection: retry once load
    drains."""


class SlotScheduler:
    """Fixed-``B`` slot table + per-priority-class EDF queues.

    Admission gates, checked at ``submit``: ``prompt_len <= context_len``;
    ``context_len + max_new_tokens <= max_total_len`` (decode starts at the
    prefill boundary); with a ``page_gate`` (``pages_needed(request)``,
    ``pages_free()``, ``pages_capacity()``) a request whose worst-case page
    need exceeds the pool is refused, and a granted head waits until its
    pages are free (nobody jumps it); with ``max_queue`` the backlog beyond
    what the next ``admit`` could grant is bounded (:class:`BackpressureError`).
    """

    def __init__(self, num_slots: int, context_len: int, max_total_len: int,
                 max_queue: Optional[int] = None, page_gate=None,
                 max_batch_wait_s: Optional[float] = DEFAULT_MAX_BATCH_WAIT_S):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if max_batch_wait_s is not None and max_batch_wait_s <= 0:
            raise ValueError(
                f"max_batch_wait_s must be > 0 (or None to disable the "
                f"bounded-wait promotion), got {max_batch_wait_s}")
        self.num_slots = num_slots
        self.context_len = context_len
        self.max_total_len = max_total_len
        self.max_queue = max_queue
        self.page_gate = page_gate
        self.max_batch_wait_s = max_batch_wait_s
        # per-class EDF queues of (deadline_abs, seq, request); the unique
        # seq breaks ties FCFS and keeps comparison off the Request
        self._queues: Dict[str, List[Tuple[float, int, Request]]] = {
            cls: [] for cls in PRIORITIES}
        self._seq = 0
        self._keys: Dict[int, Tuple[float, int]] = {}
        self._slots: List[Optional[Request]] = [None] * num_slots
        self._slot_of: Dict[int, int] = {}
        self._by_id: Dict[int, Request] = {}
        self._cancel_requested: set = set()

    # -- introspection -----------------------------------------------------

    @property
    def queue_depth(self) -> int:
        return sum(len(q) for q in self._queues.values())

    @property
    def active_count(self) -> int:
        return len(self._slot_of)

    @property
    def free_count(self) -> int:
        return self.num_slots - len(self._slot_of)

    def active(self) -> List[Tuple[int, Request]]:
        """``[(slot, request), ...]`` for every occupied slot."""
        return sorted(
            (slot, self._slots[slot]) for slot in self._slot_of.values())

    def _next_grant(self, now: float, queues: Optional[dict] = None
                    ) -> Optional[Tuple[str, int]]:
        """``(class, queue index)`` of the next grant: the OLDEST queued
        batch request when its wait exceeds the bound, else the interactive
        EDF head, else the batch EDF head; None when nothing is queued."""
        queues = self._queues if queues is None else queues
        batch_q = queues[PRIORITY_BATCH]
        if batch_q and self.max_batch_wait_s is not None:
            idx = min(range(len(batch_q)),
                      key=lambda i: (batch_q[i][2].submit_time
                                     if batch_q[i][2].submit_time is not None
                                     else math.inf))
            oldest = batch_q[idx][2]
            if (oldest.submit_time is not None
                    and now - oldest.submit_time > self.max_batch_wait_s):
                return (PRIORITY_BATCH, idx)
        if queues[PRIORITY_INTERACTIVE]:
            return (PRIORITY_INTERACTIVE, 0)
        if batch_q:
            return (PRIORITY_BATCH, 0)
        return None

    def _grantable_now(self, now: float, extra: Request) -> int:
        """How many queued requests (grant order, ``extra`` merged in) the
        next ``admit`` could grant now, bounded by free slots and free
        pages."""
        sim = {cls: list(q) for cls, q in self._queues.items()}
        bisect.insort(sim[extra.priority], self._edf_key(extra, now) + (extra,))
        pages = (self.page_gate.pages_free()
                 if self.page_gate is not None else None)
        n = 0
        while n < self.free_count:
            nxt = self._next_grant(now, sim)
            if nxt is None:
                break
            req = sim[nxt[0]].pop(nxt[1])[2]
            if pages is not None:
                need = self.page_gate.pages_needed(req)
                if need > pages:
                    break  # the chosen head blocks; nobody jumps it
                pages -= need
            n += 1
        return n

    def _edf_key(self, request: Request, now: float) -> Tuple[float, int]:
        submit = request.submit_time if request.submit_time is not None else now
        deadline = (submit + request.deadline_s
                    if request.deadline_s is not None else math.inf)
        return (deadline, self._seq)

    # -- lifecycle ---------------------------------------------------------

    def submit(self, request: Request, now: Optional[float] = None) -> None:
        """Queue a request; raises :class:`AdmissionError` when it can never
        fit, :class:`BackpressureError` when the bounded queue is full."""
        now = time.monotonic() if now is None else now
        if request.request_id in self._by_id:
            raise ValueError(f"duplicate request id {request.request_id}")
        if request.prompt_len > self.context_len:
            raise AdmissionError(
                f"request {request.request_id}: prompt_len "
                f"{request.prompt_len} > context_len {self.context_len}")
        if self.context_len + request.max_new_tokens > self.max_total_len:
            raise AdmissionError(
                f"request {request.request_id}: context_len + max_new_tokens"
                f" ({self.context_len} + {request.max_new_tokens}) > "
                f"max_total_len {self.max_total_len} (decode slots start at "
                "the prefill boundary)")
        if self.page_gate is not None:
            need = self.page_gate.pages_needed(request)
            cap = self.page_gate.pages_capacity()
            if need > cap:
                raise AdmissionError(
                    f"request {request.request_id}: needs {need} KV pages "
                    f"> pool capacity {cap}; it can never be admitted")
        if self.max_queue is not None \
                and self.queue_depth + 1 - self._grantable_now(now, request) \
                > self.max_queue:
            raise BackpressureError(
                f"request {request.request_id}: admission backlog full "
                f"({self.queue_depth} queued, {self.free_count} free slots, "
                f"max_queue {self.max_queue}); retry after the backlog drains")
        if request.submit_time is None:
            request.submit_time = now
        key = self._edf_key(request, now)
        self._seq += 1
        self._by_id[request.request_id] = request
        self._keys[request.request_id] = key
        bisect.insort(self._queues[request.priority], key + (request,))

    def cancel(self, request_id: int) -> bool:
        """Flag a request for cancellation (applied by the next ``sweep``);
        False for unknown/terminal ids."""
        req = self._by_id.get(request_id)
        if req is None or req.done:
            return False
        self._cancel_requested.add(request_id)
        return True

    def sweep(self, now: Optional[float] = None) -> List[Request]:
        """Apply cancellations and deadline expiries; returns the newly
        terminal requests (the caller emits their outputs)."""
        now = time.monotonic() if now is None else now
        swept: List[Request] = []
        for queue in self._queues.values():
            for entry in list(queue):
                req = entry[2]
                reason = self._sweep_reason(req, now)
                if reason is not None:
                    queue.remove(entry)
                    self._by_id.pop(req.request_id, None)
                    self._keys.pop(req.request_id, None)
                    self._terminate(req, reason, now)
                    swept.append(req)
        for _, req in self.active():
            reason = self._sweep_reason(req, now)
            if reason is not None:
                self._terminate(req, reason, now)
                self.release(req)
                swept.append(req)
        self._cancel_requested.difference_update(r.request_id for r in swept)
        return swept

    def _sweep_reason(self, req: Request, now: float):
        if req.request_id in self._cancel_requested:
            return RequestState.CANCELLED
        if req.expired(now):
            return RequestState.TIMED_OUT
        return None

    @staticmethod
    def _terminate(req: Request, reason: RequestState, now: float) -> None:
        req.transition(reason)
        req.finish_reason = reason.value
        req.finish_time = now

    def admit(self, now: Optional[float] = None) -> List[Tuple[int, Request]]:
        """Grant free slots in priority order; the chosen head blocks when
        its pages are short.  Transitions each granted request to PREFILL;
        returns ``[(slot, request), ...]``."""
        now = time.monotonic() if now is None else now
        grants: List[Tuple[int, Request]] = []
        # the engine allocates only after admit() returns, so each grant
        # reserves its worst case against this call's free-page snapshot
        budget = (self.page_gate.pages_free()
                  if self.page_gate is not None else None)
        while self.free_count > 0:
            nxt = self._next_grant(now)
            if nxt is None:
                break
            cls, idx = nxt
            req = self._queues[cls][idx][2]
            if budget is not None:
                need = self.page_gate.pages_needed(req)
                if need > budget:
                    break
                budget -= need
            self._queues[cls].pop(idx)
            slot = next(i for i, r in enumerate(self._slots) if r is None)
            self._slots[slot] = req
            self._slot_of[req.request_id] = slot
            req.transition(RequestState.PREFILL)
            req.prefill_time = now
            grants.append((slot, req))
        return grants

    def release(self, request: Request) -> int:
        """Free a terminal request's slot; returns the slot index."""
        if not request.done:
            raise ValueError(
                f"request {request.request_id} is not terminal "
                f"({request.state.value}); finish/cancel it first")
        slot = self._slot_of.pop(request.request_id, None)
        if slot is None:
            raise ValueError(f"request {request.request_id} holds no slot")
        self._slots[slot] = None
        self._by_id.pop(request.request_id, None)
        self._keys.pop(request.request_id, None)
        self._cancel_requested.discard(request.request_id)
        return slot

    def assert_invariants(self) -> None:
        """No slot leak, no double occupancy, queues hold only QUEUED
        requests in EDF order."""
        occupied = [i for i, r in enumerate(self._slots) if r is not None]
        assert len(occupied) == len(self._slot_of), (
            f"slot leak: {len(occupied)} occupied slots vs "
            f"{len(self._slot_of)} tracked requests")
        for rid, slot in self._slot_of.items():
            req = self._slots[slot]
            assert req is not None and req.request_id == rid, (
                f"slot {slot} does not hold request {rid}")
            assert req.state in (RequestState.PREFILL, RequestState.DECODE)
        seen = set()
        for cls, queue in self._queues.items():
            assert queue == sorted(queue, key=lambda e: e[:2]), (
                f"{cls} queue out of EDF order")
            for _, _, req in queue:
                assert req.priority == cls
                assert req.state is RequestState.QUEUED
                assert req.request_id not in self._slot_of
                assert req.request_id not in seen
                seen.add(req.request_id)
        assert set(self._keys) == seen | set(self._slot_of), (
            "EDF-key table out of sync with live requests")
