"""One fleet replica: a restartable wrapper around a ``ServingEngine``
(counterpart of ``neuronx_distributed_tpu/serving/fleet/replica.py``).

A replica owns its engine's LIFECYCLE, not its scheduling: the router
decides who gets which request; the replica turns "my engine crashed" into
a state machine the router can reason about — ``LIVE`` (in rotation),
``DEAD`` (crashed, restart scheduled on the shared
:class:`~...resilience.supervisor.RestartBackoff` discipline), ``RETIRED``
(crash budget spent, permanently out of rotation).

The engine is built by an ``engine_factory`` so a restart is a REBUILD: the
crashed engine's device state (KV pool, block tables, in-flight decode) is
discarded wholesale — exactly what a process death costs — and the fresh
engine re-enters rotation warm but empty (its prefix index starts cold; the
router's shadow resync keeps affinity honest about that).  A rebuilt
engine allocates a new pool, so the phase graphs its predecessor captured
(keyed on the old pool's addresses) do not fit it: the replica keeps the
predecessor's :meth:`~..engine.ServingEngine.graph_templates` and the new
engine captures them at once (``prewarm_graphs``), booked as warm-up, as
the JAX engine reuses its compiled programs; the closed engine drops its
own graphs from the shared model.

``step()`` carries the ``fleet/replica_step`` fault point (ctx:
``replica``, ``step``), so the ``NXD_FAULT_PLAN`` plane can kill one
in-process replica mid-run with no test shims — the mechanism behind the
failover chaos tests.

Deployment tiers: in-process replicas are the CPU tier-1 story (several
engines, one process, one device).  Real deployments run each replica as a
subprocess under :class:`~...resilience.supervisor.Supervisor`, whose
``on_exit`` hook fires after every child exit BEFORE any restart decision —
the router's drain/requeue window — and whose restart schedule is this same
``RestartBackoff``.
"""

from __future__ import annotations

import enum
import time
from typing import Any, Callable, List, Optional

from neuronx_distributed_tpu_torch.resilience.faults import fault_point
from neuronx_distributed_tpu_torch.resilience.supervisor import RestartBackoff
from neuronx_distributed_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


class ReplicaState(enum.Enum):
    LIVE = "live"
    DEAD = "dead"        # crashed; restart scheduled (backoff pending)
    RETIRED = "retired"  # crash budget spent; permanently out of rotation


class Replica:
    """A restartable engine slot in the fleet.

    ``engine_factory`` builds a fresh ``ServingEngine`` (or any object with
    the ``submit``/``step``/``has_work`` surface) — called once at
    construction and once per restart.  ``max_restarts``/``backoff_base_s``/
    ``backoff_max_s`` parameterize the shared
    :class:`~...resilience.supervisor.RestartBackoff` crash budget.
    ``clock`` is injectable for tests."""

    def __init__(self, replica_id: int,
                 engine_factory: Callable[[], Any], *,
                 role: str = "mixed",
                 max_restarts: int = 3, backoff_base_s: float = 0.5,
                 backoff_max_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.replica_id = int(replica_id)
        # disaggregated-fleet role ("prefill" / "decode" / "mixed"): a
        # STEERING label, not a capability — any replica can run either
        # phase; the role tells the router where interactive TTFT traffic
        # should land and where finished prefills should migrate.  Survives
        # restarts (lifecycle state, not engine state).
        self.role = str(role)
        self._factory = engine_factory
        self._clock = clock
        self.backoff = RestartBackoff(max_restarts, base_s=backoff_base_s,
                                      max_s=backoff_max_s)
        self.state = ReplicaState.LIVE
        self.engine: Any = engine_factory()
        self.steps = 0
        self.busy_s = 0.0  # cumulative wall time inside engine.step()
        self.last_cause: Optional[str] = None
        self._restart_at: Optional[float] = None
        # the phases the last engine captured, for its successor
        self._templates: list = []

    # -- serving surface ---------------------------------------------------

    @property
    def alive(self) -> bool:
        return self.state is ReplicaState.LIVE

    def submit(self, request: Any) -> None:
        if not self.alive:
            raise RuntimeError(
                f"replica {self.replica_id} is {self.state.value}; the "
                "router must not dispatch to it")
        self.engine.submit(request)

    def cancel(self, request_id: int) -> bool:
        return self.alive and self.engine.cancel(request_id)

    @property
    def has_work(self) -> bool:
        return self.alive and self.engine.has_work

    def step(self) -> List[Any]:
        """One engine iteration.  The ``fleet/replica_step`` fault point
        fires FIRST — an injected exception here models a replica lost
        whole (the engine may be healthy; the router must not care).
        ``busy_s`` accrues the step's wall time: the per-replica busy clock a
        benchmark accounts goodput with under the parallel-replica model
        (in-process replicas share one host and one device stream)."""
        fault_point("fleet/replica_step", replica=self.replica_id,
                    step=self.steps)
        self.steps += 1
        t0 = self._clock()
        try:
            return self.engine.step()
        finally:
            self.busy_s += self._clock() - t0

    # -- health / load view ------------------------------------------------

    def load(self) -> dict:
        """The policy-facing load view, from the engine's own bookkeeping
        and ``obs`` metrics: queue depth, active slots, slot count, pages
        free (None off paged mode), mean ``serving/host_blocked_ms``."""
        eng = self.engine
        view = {
            "replica_id": self.replica_id,
            "role": self.role,
            "queue_depth": 0, "active": 0, "slots": 1,
            "pages_free": None, "host_blocked_ms_mean": None,
        }
        sched = getattr(eng, "scheduler", None)
        if sched is not None:
            view["queue_depth"] = sched.queue_depth
            view["active"] = sched.active_count
        view["slots"] = getattr(eng, "B", 1)
        kv = getattr(eng, "_kv", None)
        view["kv_headroom_bytes"] = None
        if kv is not None:
            view["pages_free"] = kv.pages_free()
            # per-replica HBM headroom for the router: the page_bytes-
            # derived logical free KV bytes (what admission can actually
            # still hold), refined by device truth when a memory ledger
            # has polled it
            pb = getattr(eng, "_page_bytes", None)
            if pb:
                view["kv_headroom_bytes"] = view["pages_free"] * pb
        ml = getattr(eng, "memory_ledger", None)
        view["mem_bytes"] = ml.total_bytes if ml is not None else None
        view["hbm_headroom_bytes"] = (ml.headroom_bytes()
                                      if ml is not None else None)
        store = getattr(eng, "_adapters", None)
        # the tenancy tiebreak evidence: which adapters this replica's pool
        # holds device-resident right now (None off multi-adapter mode)
        view["resident_adapters"] = (store.resident_ids()
                                     if store is not None else None)
        reg = getattr(eng, "registry", None)
        if reg is not None:
            for m in reg.metrics():
                if m.name == "serving/host_blocked_ms" and m.count:
                    view["host_blocked_ms_mean"] = m.sum / m.count
                    break
        return view

    def prefix_fingerprints(self) -> set:
        """The live prefix-index truth for the router's shadow resync
        (empty for dead replicas and prefix-less engines)."""
        if not self.alive:
            return set()
        kv = getattr(self.engine, "_kv", None)
        if kv is None:
            return set()
        return kv.prefix_fingerprints()

    def describe(self) -> dict:
        """Static shape facts the router needs: the prompt-hashing inputs
        (compiled context width; page size on paged + prefix-cached
        engines) plus the rest of the admission envelope — total length,
        KV pool capacity, speculative reserve.  The router's homogeneity
        check compares ALL of it: a requeued clone must be admissible on
        any sibling, or failover could bounce an accepted request off a
        permanent AdmissionError."""
        eng = self.engine
        kv = getattr(eng, "_kv", None)
        store = getattr(eng, "_adapters", None)
        return {
            "context_len": getattr(eng, "C", None),
            "max_total_len": getattr(eng, "T", None),
            "spec_reserve": getattr(eng, "_spec_k", 0),
            "kv_pages": kv.pages_capacity() if kv is not None else None,
            "page_size": (kv.page_size
                          if kv is not None and kv.index is not None
                          else None),
            # adapter-pool envelope (multi-adapter serving): a requeued
            # clone carrying an adapter_id must land on a sibling whose
            # store can actually serve it — same pool capacity, page width
            # and rank, or the homogeneity check refuses the fleet up front
            "kv_quant": getattr(eng, "_kv_quant", None),
            # per-page HBM cost (static per config): with load()'s
            # pages_free this is the router's byte-denominated headroom
            # view — identical across a homogeneous fleet by construction
            "kv_page_bytes": getattr(eng, "_page_bytes", None),
            "adapter_pages": store.capacity if store is not None else None,
            "adapter_page_elems": (store.layout.page_elems
                                   if store is not None else None),
            "adapter_rank": (store.layout.rank
                             if store is not None else None),
            # live weights: which param version this replica serves RIGHT
            # NOW.  Excluded from the homogeneity check (mixed versions
            # are legal mid-rolling-update) — surfaced here so operators
            # and fleet_watch can see the roll's progress per replica.
            "weights_version": getattr(eng, "weights_version", 0),
        }

    # -- lifecycle ---------------------------------------------------------

    def mark_dead(self, cause: str,
                  now: Optional[float] = None) -> Optional[float]:
        """Take a crashed replica out of rotation.  Consumes one unit of the
        restart budget: returns the backoff seconds until the scheduled
        restart, or None when the budget is spent (state RETIRED).  The
        crashed engine is dropped immediately — its device state is gone
        either way; holding the reference would only pin dead HBM."""
        now = self._clock() if now is None else now
        self.last_cause = cause
        self._keep_templates(self.engine)
        close = getattr(self.engine, "close", None)
        if close is not None:
            try:
                close()
            except Exception:  # stats-file teardown must not mask the crash
                pass
        self.engine = None
        delay = self.backoff.next_delay()
        if delay is None:
            self.state = ReplicaState.RETIRED
            self._restart_at = None
            logger.error(
                "fleet: replica %d retired after %d restarts (cause %s)",
                self.replica_id, self.backoff.restarts, cause)
        else:
            self.state = ReplicaState.DEAD
            self._restart_at = now + delay
            logger.warning(
                "fleet: replica %d dead (cause %s); restart %d/%d in %.3fs",
                self.replica_id, cause, self.backoff.restarts,
                self.backoff.max_restarts, delay)
        return delay

    def retire(self, cause: str = "drained") -> None:
        """Take a LIVE replica permanently out of rotation WITHOUT
        consuming restart budget — the graceful scale-in path (autopilot
        drain).  Unlike :meth:`mark_dead`, nothing crashed: the router has
        already drained every in-flight request, so closing the engine
        releases its pool with zero work lost."""
        if self.state is not ReplicaState.LIVE:
            raise ValueError(
                f"replica {self.replica_id} is {self.state.value}; only a "
                "live replica can be retired gracefully")
        self.last_cause = cause
        if self.engine is not None:
            close = getattr(self.engine, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:  # teardown must not mask the retirement
                    pass
            self.engine = None
        self.state = ReplicaState.RETIRED
        self._restart_at = None
        logger.info("fleet: replica %d retired gracefully (cause %s)",
                    self.replica_id, cause)

    def rebuild(self) -> bool:
        """Tear down and rebuild the engine of a LIVE, drained replica
        WITHOUT a crash or a budget tick — the autopilot's proactive
        drain-and-restart rotation (a deliberate warm restart: clears
        compiled-fn churn and pool fragmentation the way a crash
        restart does, minus the crash).  Returns True on re-entry; a
        factory failure counts as a crash (the replica goes DEAD on the
        normal backoff schedule)."""
        if self.state is not ReplicaState.LIVE:
            raise ValueError(
                f"replica {self.replica_id} is {self.state.value}; only a "
                "live replica can be rebuilt proactively")
        old = self.engine
        self.engine = None
        self._keep_templates(old)
        if old is not None:
            close = getattr(old, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:
                    pass
        try:
            self.engine = self._factory()
            self._prewarm()
        except Exception as e:
            logger.error("fleet: replica %d proactive rebuild failed: %s",
                         self.replica_id, e)
            # treat like a crash: budget tick + backoff (or retirement)
            self.state = ReplicaState.LIVE  # mark_dead expects a live engine
            self.mark_dead(f"rebuild_failed:{type(e).__name__}")
            return False
        logger.info("fleet: replica %d rebuilt proactively (warm, empty "
                    "caches)", self.replica_id)
        return True

    def try_restart(self, now: Optional[float] = None) -> bool:
        """Rebuild a DEAD replica once its backoff expires; returns True on
        re-entry into rotation.  A factory failure counts as another crash
        (the next backoff tick, or retirement)."""
        if self.state is not ReplicaState.DEAD:
            return False
        now = self._clock() if now is None else now
        if self._restart_at is not None and now < self._restart_at:
            return False
        try:
            self.engine = self._factory()
            self._prewarm()
        except Exception as e:
            logger.error("fleet: replica %d restart failed: %s",
                         self.replica_id, e)
            self.mark_dead(f"restart_failed:{type(e).__name__}", now)
            return False
        self.state = ReplicaState.LIVE
        self._restart_at = None
        logger.info("fleet: replica %d restarted into rotation (warm, "
                    "empty caches)", self.replica_id)
        return True

    def _keep_templates(self, engine: Any) -> None:
        templates = getattr(engine, "graph_templates", None)
        if templates is not None:
            self._templates = templates()

    def _prewarm(self) -> None:
        prewarm = getattr(self.engine, "prewarm_graphs", None)
        if prewarm is not None and self._templates:
            prewarm(self._templates, label=f"replica{self.replica_id}_rebuild")

    def close(self) -> None:
        if self.engine is not None:
            close = getattr(self.engine, "close", None)
            if close is not None:
                close()
