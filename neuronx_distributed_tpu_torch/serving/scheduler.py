"""Slot scheduler: priority/deadline admission over a fixed-size slot table
(counterpart of ``neuronx_distributed_tpu/serving/scheduler.py``).

The decode batch has a fixed width ``B``; the scheduler treats it as a pool
of ``B`` slots.  Requests queue per priority class (``interactive`` ahead of
``batch``), earliest-deadline-first within a class (deadline-less requests
FCFS behind every deadline).  Cancellation and deadline sweeps free slots
before admission.  On top of that:

- **preemption** -- when the interactive head is blocked on slots or pages,
  :meth:`SlotScheduler.pick_preemption` names a batch victim; the engine
  parks it and :meth:`SlotScheduler.requeue` puts it back at its original
  EDF key (its absolute deadline kept) for a later re-prefill;
- **bounded wait** -- a batch request that has waited longer than
  ``max_batch_wait_s`` is granted first and cannot be preempted, so the
  batch tier drains under any interactive load;
- **shedding** -- with ``shed_infeasible=True`` a deadline shorter than the
  EWMA queue wait of its class plus the EWMA time to first token is refused
  at submit with :class:`SLOInfeasible`;
- **tenant limits** -- token buckets keyed by ``adapter_id`` refuse a
  tenant over its rate with :class:`RateLimited`;
- **withdrawal** -- :meth:`SlotScheduler.withdraw` takes a live request
  out without a terminal state: the fleet's migration hop, where the
  request goes on on a sibling replica;
- **tracing** -- with a ``tracer`` the scheduler owns the WAIT phases of a
  request's trace: a ``queue`` span from submit to grant (or sweep), a
  ``preempted`` span from park to re-grant, and ``sched/blocked`` instants
  when the head waits for pages.

Pure host-side bookkeeping: every time is the caller's clock.
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

_EWMA_ALPHA = 0.25


class AdmissionError(ValueError):
    """Request can never fit the serving envelope."""


class BackpressureError(RuntimeError):
    """The admission queue is full -- a transient rejection: retry once load
    drains."""


class SLOInfeasible(BackpressureError):
    """The request's deadline cannot be met under the current load (the
    estimated queue wait plus time to first token already exceeds it): shed
    at submit instead of admitted and abandoned mid-prefill.  Transient like
    its parent, but distinct."""


class RateLimited(BackpressureError):
    """The submitting tenant is over its token-bucket rate limit: transient
    (retry after the bucket refills) and distinct from an overloaded
    engine."""


class TokenBucket:
    """``rate`` tokens a second refill toward a ``burst`` ceiling;
    :meth:`consume` takes tokens or answers no.  Time is the caller's
    (monotonic seconds)."""

    __slots__ = ("rate", "burst", "tokens", "_last")

    def __init__(self, rate: float, burst: float):
        if rate <= 0 or burst <= 0:
            raise ValueError(
                f"rate and burst must be > 0, got rate={rate} burst={burst}")
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)  # starts full
        self._last: Optional[float] = None

    def consume(self, n: float, now: float) -> bool:
        if self._last is not None and now > self._last:
            self.tokens = min(self.burst,
                              self.tokens + (now - self._last) * self.rate)
        self._last = now
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False


class SlotScheduler:
    """Fixed-``B`` slot table + per-priority-class EDF queues.

    Submit checks, in this order: ``prompt_len <= context_len``;
    ``context_len + max_new_tokens + reserve_extra <= max_total_len``
    (decode starts at the prefill boundary; ``reserve_extra`` is the
    speculative verify's overshoot); with a ``page_gate``
    (``pages_needed(request)``, ``pages_free()``, ``pages_capacity()``) a
    request whose worst-case page need exceeds the pool is refused
    (:class:`AdmissionError`); the tenant's token bucket
    (:class:`RateLimited`); deadline feasibility under ``shed_infeasible``
    (:class:`SLOInfeasible`); with ``max_queue`` the backlog beyond what
    the next ``admit`` could grant (:class:`BackpressureError`).  A granted
    head waits until its pages are free (nobody jumps it).

    Grant order: the OLDEST queued batch request once its wait exceeds
    ``max_batch_wait_s``, else the interactive EDF head, else the batch EDF
    head.
    """

    def __init__(self, num_slots: int, context_len: int, max_total_len: int,
                 max_queue: Optional[int] = None, page_gate=None,
                 reserve_extra: int = 0,
                 max_batch_wait_s: Optional[float] = DEFAULT_MAX_BATCH_WAIT_S,
                 shed_infeasible: bool = False, tracer=None):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if reserve_extra < 0:
            raise ValueError(f"reserve_extra must be >= 0, got {reserve_extra}")
        if max_batch_wait_s is not None and max_batch_wait_s <= 0:
            raise ValueError(
                f"max_batch_wait_s must be > 0 (or None to disable the "
                f"bounded-wait promotion), got {max_batch_wait_s}")
        self.num_slots = num_slots
        self.context_len = context_len
        self.max_total_len = max_total_len
        self.reserve_extra = reserve_extra
        self.max_queue = max_queue
        self.page_gate = page_gate
        self.max_batch_wait_s = max_batch_wait_s
        self.shed_infeasible = shed_infeasible
        # per-class EDF queues of (deadline_abs, seq, request); the unique
        # seq breaks ties FCFS and keeps comparison off the Request
        self._queues: Dict[str, List[Tuple[float, int, Request]]] = {
            cls: [] for cls in PRIORITIES}
        self._seq = 0
        # rid -> (deadline_abs, seq): survives a preemption round trip, so
        # a requeued victim keeps its place in time
        self._keys: Dict[int, Tuple[float, int]] = {}
        self._slots: List[Optional[Request]] = [None] * num_slots
        self._slot_of: Dict[int, int] = {}
        self._by_id: Dict[int, Request] = {}
        self._cancel_requested: set = set()
        # the shedding estimate: EWMA queue wait per class (observed at
        # each grant) and EWMA time to first token (the engine's
        # note_first_token), scaled by load_shed_scale
        self._wait_ewma: Dict[str, Optional[float]] = {
            cls: None for cls in PRIORITIES}
        self._ttft_ewma: Optional[float] = None
        # the wait-phase spans (None = tracing off: every call site is
        # guarded, so the off path allocates nothing)
        self.tracer = tracer
        self._qspans: Dict[int, object] = {}  # rid -> open queue/park span
        self.load_shed_scale = 1.0
        # per-tenant token buckets keyed by adapter_id; a default template
        # mints a bucket for each tenant seen
        self._tenant_buckets: Dict[int, TokenBucket] = {}
        self._tenant_default: Optional[Tuple[float, float]] = None

    # -- dynamic admission -------------------------------------------------

    def set_load_shed_scale(self, scale: float) -> None:
        """Scale the feasibility estimate (``shed_infeasible`` mode):
        ``scale > 1`` sheds earlier; 1.0 is the plain estimate."""
        if not (scale >= 1.0):
            raise ValueError(f"load_shed_scale must be >= 1.0, got {scale}")
        self.load_shed_scale = float(scale)

    def set_tenant_limit(self, adapter_id: int, rate: float,
                         burst: float) -> None:
        """Install or retune one tenant's bucket (requests a second, burst
        ceiling).  A retune keeps the bucket's fill, so tightening hands out
        no fresh burst."""
        bucket = self._tenant_buckets.get(adapter_id)
        if bucket is None:
            self._tenant_buckets[adapter_id] = TokenBucket(rate, burst)
        else:
            bucket.rate = float(rate)
            bucket.burst = float(burst)
            bucket.tokens = min(bucket.tokens, bucket.burst)

    def set_default_tenant_limit(self, rate: Optional[float],
                                 burst: Optional[float] = None) -> None:
        """The limit every tenant without its own bucket gets (its bucket
        is made at its first submit); None clears it, existing buckets
        stay."""
        if rate is None:
            self._tenant_default = None
        else:
            self._tenant_default = (float(rate),
                                    float(burst if burst is not None
                                          else rate))

    def clear_tenant_limits(self) -> None:
        """Drop every tenant bucket and the default."""
        self._tenant_buckets.clear()
        self._tenant_default = None

    # -- introspection -----------------------------------------------------

    @property
    def queue_depth(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def queue_depth_of(self, priority: str) -> int:
        return len(self._queues[priority])

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

    def slot_of(self, request_id: int) -> Optional[int]:
        """The slot holding ``request_id`` (None when queued or terminal):
        the engine's collect tells a request preempted and granted again
        while its step was in flight by it."""
        return self._slot_of.get(request_id)

    def queue_wait_estimate(self, priority: str) -> Optional[float]:
        """EWMA queue wait (seconds) of recent ``priority`` grants, None
        before the first."""
        return self._wait_ewma[priority]

    def _grant_order(self, now: float, extra: Optional[Request] = None,
                     limit: Optional[int] = None) -> List[Request]:
        """The first ``limit`` queued requests in the order the next
        ``admit`` calls would grant them, with ``extra`` (about to be
        submitted at ``now``) merged in: a simulation over queue copies."""
        sim = {cls: list(q) for cls, q in self._queues.items()}
        if extra is not None:
            bisect.insort(sim[extra.priority],
                          self._edf_key(extra, now) + (extra,))
        order: List[Request] = []
        while limit is None or len(order) < limit:
            nxt = self._next_grant(now, sim)
            if nxt is None:
                break
            cls, idx = nxt
            order.append(sim[cls].pop(idx)[2])
        return order

    def _next_grant(self, now: float, queues: Optional[dict] = None
                    ) -> Optional[Tuple[str, int]]:
        """``(class, queue index)`` of the next grant: the OLDEST queued
        batch request when its wait exceeds the bound (age, not EDF
        position, or a deadline-less batch request could starve behind
        tighter-deadline batch arrivals), else the interactive EDF head,
        else the batch EDF head; None when nothing is queued."""
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

    def _pick_class(self, now: float,
                    queues: Optional[dict] = None) -> Optional[str]:
        """Which class the next grant serves (see :meth:`_next_grant`)."""
        nxt = self._next_grant(now, queues)
        return nxt[0] if nxt is not None else None

    def _grantable_now(self, now: float,
                       extra: Optional[Request] = None) -> int:
        """How many queued requests (grant order, ``extra`` merged in) the
        next ``admit`` could grant now, bounded by free slots and free
        pages."""
        reqs = self._grant_order(now, extra, limit=self.free_count)
        if self.page_gate is None:
            return len(reqs)
        pages = self.page_gate.pages_free()
        n = 0
        for req in reqs:
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
        """Queue a request in its class.  Raises :class:`AdmissionError`
        when it can never fit, :class:`RateLimited` when its tenant is over
        budget, :class:`SLOInfeasible` when its deadline is dead under the
        current load (``shed_infeasible``), :class:`BackpressureError` when
        the bounded queue is full."""
        now = time.monotonic() if now is None else now
        if request.request_id in self._by_id:
            raise ValueError(f"duplicate request id {request.request_id}")
        # envelope checks first: a never-fits request gets the permanent
        # error even under load, not a retryable one
        if request.prompt_len > self.context_len:
            raise AdmissionError(
                f"request {request.request_id}: prompt_len "
                f"{request.prompt_len} > context_len {self.context_len}")
        if (self.context_len + request.max_new_tokens + self.reserve_extra
                > self.max_total_len):
            extra = (f" + {self.reserve_extra} spec reserve"
                     if self.reserve_extra else "")
            raise AdmissionError(
                f"request {request.request_id}: context_len + max_new_tokens"
                f" ({self.context_len} + {request.max_new_tokens}{extra}) > "
                f"max_total_len {self.max_total_len} (decode slots start at "
                "the prefill boundary"
                + ("; speculative verification writes up to spec_k tokens "
                   "past the budget" if self.reserve_extra else "") + ")")
        if self.page_gate is not None:
            need = self.page_gate.pages_needed(request)
            cap = self.page_gate.pages_capacity()
            if need > cap:
                raise AdmissionError(
                    f"request {request.request_id}: needs {need} KV pages "
                    f"> pool capacity {cap}; it can never be admitted")
        if self._tenant_buckets or self._tenant_default is not None:
            tenant = request.adapter_id
            bucket = self._tenant_buckets.get(tenant)
            if bucket is None and self._tenant_default is not None:
                bucket = self._tenant_buckets[tenant] = TokenBucket(
                    *self._tenant_default)
            if bucket is not None and not bucket.consume(1.0, now):
                raise RateLimited(
                    f"request {request.request_id}: tenant {tenant} over "
                    f"its rate limit ({bucket.rate:.3g}/s, burst "
                    f"{bucket.burst:.3g}); retry after the bucket refills")
        if self.shed_infeasible and request.deadline_s is not None:
            # a request arriving with its original submit_time is judged on
            # the budget it has left
            submit = (request.submit_time
                      if request.submit_time is not None else now)
            remaining = request.deadline_s - max(now - submit, 0.0)
            est = ((self._wait_ewma[request.priority] or 0.0)
                   + (self._ttft_ewma or 0.0)) * self.load_shed_scale
            if remaining <= 0 or (est > 0 and remaining < est):
                raise SLOInfeasible(
                    f"request {request.request_id}: deadline budget "
                    f"{remaining:.3f}s cannot cover the estimated "
                    f"{est:.3f}s queue wait + first token at current "
                    f"{request.priority} load; shed at admission")
        if self.max_queue is not None \
                and self.queue_depth + 1 - self._grantable_now(now, request) \
                > self.max_queue:
            raise BackpressureError(
                f"request {request.request_id}: admission backlog full "
                f"({self.queue_depth} queued, {self.free_count} free slots"
                + (f", {self.page_gate.pages_free()} free KV pages"
                   if self.page_gate is not None else "")
                + f", max_queue {self.max_queue}); retry after the backlog "
                "drains")
        if request.submit_time is None:
            request.submit_time = now
        key = self._edf_key(request, now)
        self._seq += 1
        self._by_id[request.request_id] = request
        self._keys[request.request_id] = key
        bisect.insort(self._queues[request.priority], key + (request,))
        if self.tracer is not None:
            # the queue phase, submit -> grant, under the engine's root
            self._qspans[request.request_id] = self.tracer.begin(
                "queue", request_id=request.request_id,
                parent=getattr(request, "_trace_root", None), t=now,
                priority=request.priority, deadline_s=request.deadline_s)

    def requeue(self, request: Request, now: Optional[float] = None) -> int:
        """Preemption (the engine releases the slot's pages and state):
        take an active request out of its slot, park it back in QUEUED
        (:meth:`~.request.Request.reset_for_requeue`) at its ORIGINAL EDF
        key.  Returns the freed slot.  ``now`` (the engine's clock) starts
        the trace's ``preempted`` span where the compute phase ended."""
        slot = self._slot_of.pop(request.request_id, None)
        if slot is None:
            raise ValueError(
                f"request {request.request_id} holds no slot to preempt")
        self._slots[slot] = None
        request.reset_for_requeue()
        key = self._keys[request.request_id]
        bisect.insort(self._queues[request.priority], key + (request,))
        if self.tracer is not None:
            self._qspans[request.request_id] = self.tracer.begin(
                "preempted", request_id=request.request_id,
                parent=getattr(request, "_trace_root", None), t=now,
                preemptions=request.preemptions)
        return slot

    def pick_preemption(self, now: Optional[float] = None
                        ) -> Optional[Tuple[int, Request]]:
        """The next preemption the engine should make, or None: the
        interactive EDF head is blocked (no free slot, or under a page gate
        not enough free pages), no promoted batch head owns the next grant,
        and a batch victim is active.  The victim is the active batch
        request with the LATEST deadline, ties to the fewest generated
        tokens; batch requests older than ``max_batch_wait_s`` are
        immune."""
        now = time.monotonic() if now is None else now
        int_q = self._queues[PRIORITY_INTERACTIVE]
        if not int_q:
            return None
        if self._pick_class(now) != PRIORITY_INTERACTIVE:
            return None  # a promoted batch head owns the next grant
        head = int_q[0][2]
        blocked = self.free_count == 0
        if not blocked and self.page_gate is not None:
            blocked = (self.page_gate.pages_needed(head)
                       > self.page_gate.pages_free())
        if not blocked:
            return None
        victim: Optional[Tuple[int, Request]] = None
        victim_key = None
        for slot, req in self.active():
            if req.priority != PRIORITY_BATCH:
                continue
            if (self.max_batch_wait_s is not None
                    and req.submit_time is not None
                    and now - req.submit_time > self.max_batch_wait_s):
                continue  # over the wait bound: immune
            deadline = (req.submit_time + req.deadline_s
                        if req.deadline_s is not None
                        and req.submit_time is not None else math.inf)
            key = (-deadline, len(req.generated))
            if victim_key is None or key < victim_key:
                victim_key = key
                victim = (slot, req)
        return victim

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
                    if self.tracer is not None:
                        self.tracer.end(
                            self._qspans.pop(req.request_id, None), t=now,
                            swept=reason.value)
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
        """Grant free slots in grant order; the chosen head blocks when its
        pages are short.  Transitions each granted request to PREFILL and
        feeds its queue wait to the class's EWMA; returns ``[(slot,
        request), ...]``."""
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
                    if self.tracer is not None:
                        self.tracer.instant(
                            "sched/blocked", request_id=req.request_id,
                            parent=self._qspans.get(req.request_id), t=now,
                            reason="pages", pages_needed=need,
                            pages_free=budget)
                    break  # the chosen head waits for pages
                budget -= need
            self._queues[cls].pop(idx)
            slot = next(i for i, r in enumerate(self._slots) if r is None)
            self._slots[slot] = req
            self._slot_of[req.request_id] = slot
            req.transition(RequestState.PREFILL)
            req.prefill_time = now
            if req.submit_time is not None:
                self._note_wait(req.priority, max(now - req.submit_time, 0.0))
            if self.tracer is not None:
                # the wait phase ends at the grant instant, where the
                # engine's prefill phase begins
                self.tracer.end(self._qspans.pop(req.request_id, None),
                                t=now, slot=slot)
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

    def withdraw(self, request_id: int, now: Optional[float] = None
                 ) -> Tuple[Request, Optional[int]]:
        """Remove a NON-terminal request without a terminal transition (the
        disaggregated fleet's migration hop: the request goes on on a
        sibling replica, so here it simply ceases to exist).  An active
        request frees its slot; a queued one leaves its class queue (its
        open wait span sealed).  Returns ``(request, slot)``, ``slot`` None
        for a queued withdrawal; raises ``KeyError`` for an id this
        scheduler does not hold."""
        now = time.monotonic() if now is None else now
        req = self._by_id.pop(request_id, None)
        if req is None:
            raise KeyError(f"request {request_id} is not scheduled here")
        slot = self._slot_of.pop(request_id, None)
        if slot is not None:
            self._slots[slot] = None
        else:
            self._queues[req.priority].remove(
                self._keys[request_id] + (req,))
        self._keys.pop(request_id, None)
        self._cancel_requested.discard(request_id)
        if self.tracer is not None:
            span = self._qspans.pop(request_id, None)
            if span is not None:
                self.tracer.end(span, t=now, withdrawn=True)
        return req, slot

    def trace_abort(self, now: Optional[float] = None) -> None:
        """Seal every open wait span (engine teardown)."""
        if self.tracer is None:
            return
        now = time.monotonic() if now is None else now
        for rid in list(self._qspans):
            self.tracer.end(self._qspans.pop(rid), t=now, aborted=True)

    # -- load estimators ---------------------------------------------------

    def _note_wait(self, priority: str, wait_s: float) -> None:
        prev = self._wait_ewma[priority]
        self._wait_ewma[priority] = (
            wait_s if prev is None else prev + _EWMA_ALPHA * (wait_s - prev))

    def note_first_token(self, ttft_s: float) -> None:
        """Engine hook: an observed submit-to-first-token time, the TTFT
        half of the feasibility estimate."""
        prev = self._ttft_ewma
        self._ttft_ewma = (ttft_s if prev is None
                           else prev + _EWMA_ALPHA * (ttft_s - prev))

    # -- invariants --------------------------------------------------------

    def assert_invariants(self) -> None:
        """No slot leak, no double occupancy, queues hold only QUEUED
        requests in EDF order, the key table matches the live requests."""
        occupied = [i for i, r in enumerate(self._slots) if r is not None]
        assert len(occupied) == len(self._slot_of), (
            f"slot leak: {len(occupied)} occupied slots vs "
            f"{len(self._slot_of)} tracked requests")
        for rid, slot in self._slot_of.items():
            req = self._slots[slot]
            assert req is not None and req.request_id == rid, (
                f"slot {slot} does not hold request {rid}")
            assert req.state in (RequestState.PREFILL, RequestState.DECODE), (
                f"slot {slot} holds terminal/queued request {rid} "
                f"({req.state.value})")
        seen = set()
        for cls, queue in self._queues.items():
            assert queue == sorted(queue, key=lambda e: e[:2]), (
                f"{cls} queue out of EDF order")
            for _, _, req in queue:
                assert req.priority == cls, (
                    f"request {req.request_id} ({req.priority}) queued "
                    f"under class {cls}")
                assert req.state is RequestState.QUEUED, (
                    f"queued request {req.request_id} in state "
                    f"{req.state.value}")
                assert req.request_id not in self._slot_of, (
                    f"request {req.request_id} both queued and slotted")
                assert req.request_id not in seen
                seen.add(req.request_id)
        assert set(self._keys) == seen | set(self._slot_of), (
            "EDF-key table out of sync with live requests")
