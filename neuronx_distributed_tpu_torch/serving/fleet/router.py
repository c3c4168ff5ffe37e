"""Fleet router: one front door over N serving-engine replicas
(counterpart of ``neuronx_distributed_tpu/serving/fleet/router.py``).

``FleetRouter`` owns ADMISSION for the whole pool — the three fleet
concerns a single engine cannot see:

- **Globally-unique ids.**  Engine request ids are caller-chosen, so two
  replicas can silently share one; the router re-keys every submission from
  its :class:`RequestIdAllocator` (``(namespace << 32) | seq``) and the id
  folds into the per-request rng stream (:func:`~...trace.engine
  .request_rng` folds the high word too), so sampled outputs stay
  reproducible and collision-free no matter which replica serves them.

- **Placement.**  Dispatch runs through a pluggable
  :class:`~.routing.RoutingPolicy`; the flagship is prefix affinity: hash
  the prompt's leading page-aligned chunks (the exact
  :func:`~...kvcache.prefix.page_keys` the engines' tries use, rolled into
  chain fingerprints) and steer to the replica whose shadow holds the
  longest chain — the SGLang cache-aware-routing observation that the
  router is the only place per-replica ``PrefixIndex`` state can be
  exploited across the pool.

- **Zero-loss failover.**  A replica whose ``step()`` raises (the
  ``fleet/replica_step`` fault point is the ``NXD_FAULT_PLAN`` hook) is
  drained: every accepted request it held — queued or mid-decode — is
  REQUEUED on siblings as a fresh clone re-prefilled from the original
  prompt (the router holds every accepted prompt until its terminal
  output), the replica restarts into warm rotation on the shared
  :class:`~...resilience.supervisor.RestartBackoff` schedule, and its
  shadow is cleared then resynced from the live index truth.  The
  invariant — every accepted request yields EXACTLY ONE terminal output —
  is what the churn property tests assert.  (Failover caveat: a
  requeued request restarts generation, so its ``stream_cb`` re-streams
  from token 0 — at-least-once streaming.
  Deadlines stay ABSOLUTE through a crash: the clone carries the original
  submission instant, and a clone whose deadline already expired fails
  terminally as TIMED_OUT instead of burning a re-prefill.)

Telemetry: ``router/*`` counters and gauges through the standard
``MetricRegistry`` (declared in ``obs.schemas.REGISTRY_METRICS``) plus one
schema-checked ``router_stats.jsonl`` record per terminal request.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from neuronx_distributed_tpu_torch.kvcache.prefix import (
    is_padding_key,
    page_keys,
    prefix_fingerprints,
)
from neuronx_distributed_tpu_torch.obs import MetricRegistry
from neuronx_distributed_tpu_torch.serving.fleet.replica import Replica, ReplicaState
from neuronx_distributed_tpu_torch.serving.fleet.routing import (
    Decision,
    ReplicaShadow,
    RoutingPolicy,
    make_policy,
)
from neuronx_distributed_tpu_torch.serving.request import Request, RequestOutput
from neuronx_distributed_tpu_torch.serving.scheduler import BackpressureError
from neuronx_distributed_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

ROUTER_STATS_SCHEMA = "router_stats/2"


class FleetUnavailableError(RuntimeError):
    """Every replica has retired (crash budgets spent) — the fleet can
    accept nothing new and pending work is failed terminally."""


class RequestIdAllocator:
    """Fleet-global request ids: ``(namespace << 32) | seq``.  ``seq`` is
    one counter across every replica, so ids never collide inside a fleet;
    distinct namespaces keep MULTIPLE fleets (or a fleet and a bare engine)
    collision-free, and the namespace reaches the sampling streams through
    ``request_rng``'s high-word fold."""

    def __init__(self, namespace: int = 1):
        # namespace 0 would mint sub-2**32 globals that skip request_rng's
        # high-word fold and collide with bare-engine caller-chosen ids
        if not 1 <= namespace < 2 ** 31:
            raise ValueError(
                f"namespace must be in [1, 2**31), got {namespace}")
        self.namespace = namespace
        self._seq = 0

    def next_id(self) -> int:
        if self._seq > 0xFFFFFFFF:
            raise RuntimeError("request-id sequence exhausted (2**32 ids)")
        gid = (self.namespace << 32) | self._seq
        self._seq += 1
        return gid


class _Tracked:
    """Router-held record of one accepted request, kept until its terminal
    output: the template to clone on requeue, the placement history, and
    the affinity evidence for ``router_stats``."""

    __slots__ = ("global_id", "client_id", "template", "fps", "replica_id",
                 "dispatches", "requeues", "migrations", "affinity_pages",
                 "submit_time", "done", "cancelled", "clone", "adapter_id")

    def __init__(self, global_id: int, client_id: int, template: Request,
                 fps: List[int], submit_time: float):
        self.global_id = global_id
        self.client_id = client_id
        self.template = template
        self.fps = fps
        self.adapter_id = getattr(template, "adapter_id", 0)
        self.replica_id: Optional[int] = None
        self.dispatches = 0
        self.requeues = 0
        self.migrations = 0  # disagg KV-migration hops (router_stats v2)
        self.affinity_pages = 0
        self.submit_time = submit_time
        self.done = False
        self.cancelled = False  # a granted cancel() survives failover
        self.clone: Optional[Request] = None  # parked requeue, built once


class FleetRouter:
    """Front door over ``replicas`` (a list of :class:`~.replica.Replica`).

    ``policy`` is a :class:`~.routing.RoutingPolicy` instance or name
    (``round_robin`` / ``random`` / ``least_loaded`` / ``prefix_affinity``,
    the default).  ``namespace`` seeds the global-id allocator.
    ``stats_path`` appends one ``router_stats`` JSONL record per terminal
    request.  ``registry`` receives the ``router/*`` metrics (one is
    created when omitted).  ``shadow_resync_every`` (router steps) bounds
    shadow staleness against evictions; restarts always resync immediately.
    ``max_pending`` bounds the router-held queue used when no live replica
    can take a dispatch (``BackpressureError`` beyond it).  ``health`` (an
    ``obs.aggregate.FleetHealth``, None = off) wires the fleet control
    room: per-replica + fleet-level rule monitors evaluated on the step
    cadence, terminal outputs feeding the SLO burn-rate windows, and
    failover/restart edges firing/resolving the ``replica_down`` alert."""

    def __init__(self, replicas: Sequence[Replica], *,
                 policy: "str | RoutingPolicy" = "prefix_affinity",
                 namespace: int = 1, seed: int = 0,
                 registry: Optional[MetricRegistry] = None,
                 stats_path: Optional[str] = None,
                 shadow_resync_every: int = 64,
                 max_pending: Optional[int] = None,
                 retain_done: int = 4096,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 tracer: Any = None,
                 health: Any = None):
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        ids = [r.replica_id for r in replicas]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate replica ids: {sorted(ids)}")
        for r in replicas:
            tp = getattr(r.engine, "tp_size", 1)
            if tp > 1:
                raise NotImplementedError(
                    f"replica {r.replica_id} serves at tensor-parallel "
                    f"degree {tp}: a fleet of tp > 1 replicas is not ported "
                    "yet (ROADMAP A9d)")
        self.replicas: Dict[int, Replica] = {r.replica_id: r for r in replicas}
        self.policy = make_policy(policy, seed=seed)
        self.alloc = RequestIdAllocator(namespace)
        self.registry = registry if registry is not None else MetricRegistry()
        # request-lifecycle tracing (obs.tracing.Tracer, None = off): the
        # router records the PLACEMENT edges — dispatch (with spill count
        # and affinity evidence), failover requeue hops, terminal emission.
        # Replica engines record their own lifecycle spans through
        # per-replica scopes of the SAME tracer (tracer.scoped(rid)), and
        # a request's whole cross-replica trace stitches by its global id.
        self.tracer = tracer
        # fleet health monitor (obs.aggregate.FleetHealth, None = off):
        # per-replica monitors + one fleet monitor over the MERGED
        # registry snapshot, evaluated on the fleet-step cadence; every
        # terminal output feeds the fleet burn-rate windows, and
        # failover/warm-restart edges raise/clear the `replica_down`
        # condition.  Guarded at every call site — health off allocates
        # nothing (the ALERTS_EVALUATED discipline).
        self._health = health
        if health is not None:
            health.attach_router(self)
        self._clock = clock
        self._stats_path = stats_path
        self._stats_f = None
        self.shadow_resync_every = shadow_resync_every
        self.max_pending = max_pending
        self._steps = 0
        self._inflight = 0
        self._sleep = sleep
        # terminal records serve only the client_id mapping; retain_done
        # bounds how many a long-lived router keeps (live ones are never
        # evicted)
        self.retain_done = retain_done
        self._done_fifo: deque = deque()
        self._tracked: Dict[int, _Tracked] = {}
        self._pending: deque = deque()  # _Tracked awaiting a live replica
        # synthetic outputs (router-held cancels) held for the next step():
        # terminal outputs always flow out of step, exactly once, no matter
        # where the request died
        self._emit_next: List[RequestOutput] = []
        self.shadows: Dict[int, ReplicaShadow] = {
            rid: ReplicaShadow() for rid in self.replicas}
        # prompt-hashing shape facts, from the (homogeneous) fleet
        desc = replicas[0].describe()
        self._ctx = desc["context_len"]
        self._page = desc["page_size"]
        self._desc = desc  # reference envelope for autoscale add_replica
        self._check_envelopes(replicas, desc)
        # graceful drains in progress: rid -> completion plan.  A draining
        # replica stays LIVE and keeps stepping (in-flight work finishes in
        # place — zero requeues, zero re-prefills) but takes no NEW
        # dispatches; once empty, the plan runs (retire / warm rebuild /
        # re-role / live weight swap).
        self._draining: Dict[int, dict] = {}
        # fleet rolling update in progress (rolling_update): the one-at-a-
        # time drain→swap→rejoin walk; None = no roll.  last_roll keeps the
        # final status of the most recent completed roll.
        self._rolling: Optional[dict] = None
        self.last_roll: Optional[dict] = None

        reg = self.registry
        for c in ("dispatched", "requeued", "failovers", "restarts",
                  "retired", "drains", "affinity_hits", "affinity_misses"):
            reg.counter(f"router/{c}_total")
        for g in ("replicas_alive", "queue_depth", "inflight",
                  "affinity_hit_rate", "fleet_prefix_hit_rate"):
            reg.gauge(f"router/{g}")
        self._export_gauges()

    def _check_envelopes(self, replicas: Sequence[Replica],
                         desc: dict) -> None:
        """Refuse a fleet whose replicas serve different compiled
        envelopes: prefix hashing and failover requeue both assume a
        request admissible on one replica is admissible on any sibling.
        The disaggregated router overrides this with a ROLE-COMPATIBLE
        relaxation (capacity keys may differ between prefill- and
        decode-heavy replicas; geometry never does).  ``weights_version``
        is excluded on both sides: a fleet mid-rolling-update is
        EXPLICITLY allowed to serve mixed versions (the envelope is about
        compiled geometry; the version is about which params fill it)."""
        ref = {k: v for k, v in desc.items() if k != "weights_version"}
        for r in replicas[1:]:
            d = {k: v for k, v in r.describe().items()
                 if k != "weights_version"}
            if d != ref:
                raise ValueError(
                    f"heterogeneous fleet: replica {r.replica_id} serves "
                    f"{d}, replica {replicas[0].replica_id} "
                    f"{ref} — prefix hashing and requeue both assume one "
                    "compiled envelope")

    def _replica_role(self, rid: Optional[int]) -> Optional[str]:
        """The steering role of a replica id ("mixed" for plain fleets;
        None for unknown/router-held) — the ``router_stats`` v2 field."""
        replica = self.replicas.get(rid) if rid is not None else None
        return getattr(replica, "role", "mixed") if replica is not None \
            else None

    # -- request surface ---------------------------------------------------

    def submit(self, request: Request) -> int:
        """Accept one request: re-key it with a fleet-global id (the
        caller's id is retained as ``client_id`` in ``router_stats``),
        fingerprint its prompt, and dispatch via the policy.  Returns the
        assigned global id.  Raises :class:`FleetUnavailableError` when
        every replica has retired, ``BackpressureError`` when the
        router-held queue is at ``max_pending``, and passes through the
        target engine's permanent ``AdmissionError`` for never-fits
        requests."""
        if all(r.state is ReplicaState.RETIRED for r in self.replicas.values()):
            raise FleetUnavailableError(
                "every replica has retired (crash budgets spent)")
        client_id = request.request_id
        gid = self.alloc.next_id()
        request.request_id = gid
        rec = _Tracked(gid, client_id, request, self._fingerprints(request),
                       self._clock())
        self._tracked[gid] = rec
        try:
            self._dispatch(rec, request)
        except BaseException:
            # rejected, not accepted: no ghost ledger entry, and the
            # caller's request object gets its own id back for a resubmit
            self._tracked.pop(gid, None)
            request.request_id = client_id
            raise
        self._inflight += 1
        return gid

    def cancel(self, global_id: int) -> bool:
        """Cancel by global id, wherever the request currently lives
        (router-held or on a replica)."""
        rec = self._tracked.get(global_id)
        if rec is None or rec.done:
            return False
        for i, pending in enumerate(self._pending):
            if pending is rec:
                del self._pending[i]
                out = self._synthetic_output(rec, "cancelled", "cancelled",
                                             self._clock())
                self._finish(rec, out)
                self._emit_next.append(out)
                return True
        replica = self.replicas.get(rec.replica_id)
        granted = replica is not None and replica.cancel(global_id)
        if granted:
            # remember the grant: if the replica dies before its sweep
            # emits the cancelled output, failover must honor the cancel
            # instead of resurrecting the request as a requeued clone
            rec.cancelled = True
        return granted

    def client_id(self, global_id: int) -> Optional[int]:
        """The caller-chosen id a global id was re-keyed from (None for
        unknown ids; the mapping is kept for every live request plus the
        last ``retain_done`` terminal ones)."""
        rec = self._tracked.get(global_id)
        return rec.client_id if rec is not None else None

    @property
    def has_work(self) -> bool:
        return bool(self._pending) or bool(self._emit_next) or any(
            r.has_work for r in self.replicas.values())

    # -- graceful drain / autoscale (the autopilot surface) ----------------

    def _dispatchable(self, rid: int) -> bool:
        """Whether a replica may take NEW work: alive and not draining.
        Draining replicas keep stepping their in-flight requests — they
        just stop accumulating more."""
        return self.replicas[rid].alive and rid not in self._draining

    def draining(self) -> Dict[int, str]:
        """Live view of drains in progress: rid -> completion plan name."""
        return {rid: plan["then"] for rid, plan in self._draining.items()}

    def drain(self, replica_id: int, *, then: str = "retire",
              role: Optional[str] = None, cause: str = "",
              payload: Optional[dict] = None) -> None:
        """Gracefully drain one replica: stop dispatching new work to it,
        let every in-flight request finish IN PLACE (this is NOT the
        crash-failover path — nothing is requeued, nothing re-prefills),
        then run the completion plan:

        - ``then="retire"``: scale-in — retire the replica WITHOUT spending
          restart budget and release its pool (refused when it is the last
          dispatchable replica: that would be deliberate capacity suicide).
        - ``then="restart"``: proactive warm rotation — rebuild the engine
          (clears compiled-fn churn / pool fragmentation) and rejoin.
        - ``then="re_role"``: disaggregation rebalance — flip the steering
          ``role`` (requires ``role=``) and rejoin with pages intact.
        - ``then="swap"``: live weight swap — once empty, install new
          params via ``weights.WeightSwapper`` (requires ``payload=`` with
          ``"params"`` or ``"ckpt_dir"`` (and an optional ``"tag"``: a
          checkpoint of ``trainer.checkpoint``); optional ``"copy"``,
          ``"swaps_path"``) and rejoin.  The engine is
          never rebuilt; a replica over a shared model moves to a private
          one and captures its phases again inside the swap, booked as
          warm-up, so the rejoined replica fires no compile storm.  A swap
          failure (audited) rejoins the replica on its OLD weights.
        """
        if then not in ("retire", "restart", "re_role", "swap"):
            raise ValueError(f"unknown drain plan {then!r}")
        if then == "re_role" and role is None:
            raise ValueError("drain(then='re_role') requires role=")
        if then == "swap" and not (payload and (
                "params" in payload or "ckpt_dir" in payload)):
            raise ValueError(
                "drain(then='swap') requires payload= with 'params' or "
                "'ckpt_dir'")
        replica = self.replicas.get(replica_id)
        if replica is None:
            raise ValueError(f"unknown replica {replica_id}")
        if not replica.alive:
            raise ValueError(
                f"replica {replica_id} is {replica.state.value}; only a "
                "live replica can be drained")
        if replica_id in self._draining:
            raise ValueError(f"replica {replica_id} is already draining")
        if then == "retire" and not any(
                self._dispatchable(rid) for rid in self.replicas
                if rid != replica_id):
            raise ValueError(
                f"refusing to drain-retire replica {replica_id}: it is the "
                "last dispatchable replica (scale-in below one is capacity "
                "suicide)")
        self._draining[replica_id] = {
            "then": then, "role": role, "cause": cause or then,
            "payload": payload, "since": self._clock()}
        self.registry.counter("router/drains_total").inc()
        if self.tracer is not None:
            self.tracer.instant("route/drain", request_id=-1,
                                replica=replica_id, plan=then)
        logger.info("fleet: draining replica %d (plan %s%s)", replica_id,
                    then, f" -> {role}" if role else "")

    def add_replica(self, replica: Replica) -> None:
        """Admit a NEW replica into rotation (autoscale scale-out).  The
        envelope must pass the same homogeneity check construction applies
        (the disaggregated router's override relaxes capacity per role,
        never geometry) — a replica that can't serve what its siblings
        admitted is refused before it can strand a failover requeue."""
        rid = replica.replica_id
        if rid in self.replicas:
            raise ValueError(f"replica id {rid} already in the fleet")
        if not replica.alive:
            raise ValueError(
                f"replica {rid} is {replica.state.value}; only a live "
                "replica can join the fleet")
        anchor = next(iter(self.replicas.values()))
        self._check_envelopes([anchor, replica], self._desc)
        self.replicas[rid] = replica
        shadow = ReplicaShadow()
        shadow.resync(replica.prefix_fingerprints())
        self.shadows[rid] = shadow
        self._export_gauges(full=True)
        logger.info("fleet: replica %d joined rotation (role %s)", rid,
                    getattr(replica, "role", "mixed"))

    def _forget_replica(self, rid: int) -> None:
        """Hook for subclass state keyed by replica id (the disagg router
        forgets the replica's fleet-prefix-directory claims)."""

    def _complete_drains(self, now: float) -> List[RequestOutput]:
        """Run the completion plan of every draining replica that emptied
        out this step.  Returns synthetic outputs (none today; the list
        keeps the call shape uniform with the failover paths)."""
        for rid in [r for r in self._draining if not self.replicas[r].has_work]:
            plan = self._draining.pop(rid)
            replica = self.replicas[rid]
            if not replica.alive:
                continue  # crashed while draining: failover already took over
            then = plan["then"]
            if then == "retire":
                replica.retire(plan["cause"])
                self.registry.counter("router/retired_total").inc()
                self.shadows[rid].clear()
                self._forget_replica(rid)
                if self._health is not None:
                    # deliberate scale-in: terminal replica_retired edge at
                    # WARN (nothing crashed; nobody should be paged)
                    self._health.replica_retired(
                        rid, plan["cause"], now, severity="warn")
            elif then == "restart":
                self._forget_replica(rid)
                if replica.rebuild():
                    self.registry.counter("router/restarts_total").inc()
                    self.shadows[rid].resync(replica.prefix_fingerprints())
                else:
                    # the factory raised: the rebuild consumed a crash-budget
                    # tick inside Replica.rebuild -> mark_dead, so surface it
                    # exactly like a crash death
                    self.shadows[rid].clear()
                    if self._health is not None:
                        self._health.replica_down(
                            rid, replica.last_cause or "rebuild_failed", now)
                    if replica.state is ReplicaState.RETIRED:
                        self.registry.counter("router/retired_total").inc()
                        if self._health is not None:
                            self._health.replica_retired(
                                rid, replica.last_cause or "rebuild_failed",
                                now)
            elif then == "re_role":
                replica.role = plan["role"]
            else:  # swap
                self._swap_replica(rid, replica, plan, now)
            self._export_gauges(full=True)
        return []

    def _swap_replica(self, rid: int, replica: Replica, plan: dict,
                      now: float) -> bool:
        """Run a drained replica's live weight swap (the engine survives;
        only its parameters change).  The prefix-cache flush inside the swap invalidates the
        router's affinity shadow, so it resyncs from the (now empty) live
        index.  A failed swap leaves the replica serving its OLD weights
        and rejoining rotation — capacity over currency; the failure is
        audited in weight_swaps.jsonl and the roll status."""
        from neuronx_distributed_tpu_torch.weights import SwapError, WeightSwapper

        payload = plan.get("payload") or {}
        ok = True
        version = None
        try:
            swapper = WeightSwapper(
                replica.engine, path=payload.get("swaps_path"),
                replica=rid)
            try:
                # copy defaults True (memory source): each replica must own
                # its bytes, the shared mapping may be a live trainer's
                # tensors.  A caller that KNOWS the tensors are immutable
                # may pass "copy": False to alias them across the fleet.
                if "params" in payload:
                    version = swapper.swap(payload["params"],
                                           source="memory",
                                           copy=payload.get("copy"))
                else:
                    version = swapper.swap_from_checkpoint(
                        payload["ckpt_dir"], tag=payload.get("tag"))
            finally:
                swapper.close()
        except (SwapError, Exception) as e:  # noqa: BLE001 — audit + rejoin
            ok = False
            logger.warning(
                "fleet: replica %d weight swap failed (%s); rejoining on "
                "old weights", rid, e)
        # cached prefix chains were flushed (or are untrustworthy after a
        # failed half-load — there is none today, but stay conservative):
        # the shadow must stop crediting them
        self.shadows[rid].resync(replica.prefix_fingerprints())
        if self._rolling is not None:
            (self._rolling["done"] if ok
             else self._rolling["failed"]).append(rid)
            if ok:
                self._rolling["versions"][rid] = version
        if self.tracer is not None:
            self.tracer.instant("route/weight_swap", request_id=-1,
                                replica=rid, ok=ok,
                                version=version if version is not None
                                else -1)
        if ok:
            logger.info("fleet: replica %d swapped to weights version %s "
                        "and rejoined rotation", rid, version)
        return ok

    # -- fleet rolling update ----------------------------------------------

    def rolling_update(self, params: Any = None, *,
                       ckpt_dir: Optional[str] = None,
                       tag: Optional[str] = None,
                       swaps_dir: Optional[str] = None,
                       cause: str = "rolling_update") -> None:
        """Deploy new weights across the whole fleet with zero downtime
        and zero lost accepted requests: drain → swap → rejoin ONE replica
        at a time, riding the graceful-drain surface (in-flight work
        finishes in place; the rest of the fleet keeps taking traffic; a
        mixed-version fleet mid-roll is explicitly allowed and visible in
        ``Replica.describe()['weights_version']``).

        ``params`` routes the in-memory path (the rollout→train→swap
        loop); ``ckpt_dir``/``tag`` the checkpoint path (a
        ``trainer.checkpoint`` tag, loaded by each replica's swapper).
        ``swaps_dir`` (optional) receives one
        ``replica<rid>_weight_swaps.jsonl`` audit file per replica.  The
        roll advances inside :meth:`step` — keep stepping (serving traffic
        or not) until :meth:`roll_status` reports it complete.  Replicas
        that die mid-roll are skipped (failover owns them); a replica
        whose swap fails rejoins on its old weights and is listed in the
        status' ``failed``."""
        if (params is None) == (ckpt_dir is None):
            raise ValueError(
                "rolling_update needs exactly one of params= (in-memory) "
                "or ckpt_dir= (checkpoint)")
        if self._rolling is not None:
            raise ValueError("a rolling update is already in progress")
        payload: dict = {}
        if params is not None:
            payload["params"] = params
        else:
            payload["ckpt_dir"] = ckpt_dir
            payload["tag"] = tag
        queue = deque(sorted(
            rid for rid in self.replicas if self._dispatchable(rid)))
        if not queue:
            raise FleetUnavailableError(
                "rolling_update: no dispatchable replica to roll")
        self._rolling = {
            "queue": queue, "payload": payload, "swaps_dir": swaps_dir,
            "cause": cause, "active": None, "done": [], "failed": [],
            "skipped": [], "versions": {}, "started": self._clock(),
        }
        logger.info("fleet: rolling update started over replicas %s",
                    list(queue))

    def roll_status(self) -> Optional[dict]:
        """The in-progress roll's status (None when no roll is active —
        see :attr:`last_roll` for the most recent completed one)."""
        if self._rolling is None:
            return None
        r = self._rolling
        return {"active": r["active"], "queued": list(r["queue"]),
                "done": list(r["done"]), "failed": list(r["failed"]),
                "skipped": list(r["skipped"]),
                "versions": dict(r["versions"])}

    def _advance_roll(self, now: float) -> None:
        """Advance the rolling update by at most one replica: wait while
        the active replica is still drain-swapping, then start the next
        queued one (skipping replicas that died or started draining for
        some other reason since the roll was enqueued).  Runs inside
        :meth:`step`, after ``_complete_drains`` — so a swap that
        completed this step frees the roll to start the next replica in
        the SAME step."""
        roll = self._rolling
        if roll is None:
            return
        active = roll["active"]
        if active is not None and active in self._draining:
            return  # still draining — one replica at a time
        roll["active"] = None
        while roll["queue"]:
            rid = roll["queue"].popleft()
            replica = self.replicas.get(rid)
            if replica is None or not replica.alive \
                    or rid in self._draining:
                roll["skipped"].append(rid)
                continue
            payload = dict(roll["payload"])
            if roll["swaps_dir"] is not None:
                payload["swaps_path"] = os.path.join(
                    roll["swaps_dir"], f"replica{rid}_weight_swaps.jsonl")
            self.drain(rid, then="swap", cause=roll["cause"],
                       payload=payload)
            roll["active"] = rid
            return
        # queue empty, nothing active: the roll is complete
        self.last_roll = {
            "done": list(roll["done"]), "failed": list(roll["failed"]),
            "skipped": list(roll["skipped"]),
            "versions": dict(roll["versions"]),
            "duration_s": now - roll["started"],
        }
        self._rolling = None
        logger.info(
            "fleet: rolling update complete (%d swapped, %d failed, "
            "%d skipped, %.2fs)", len(self.last_roll["done"]),
            len(self.last_roll["failed"]), len(self.last_roll["skipped"]),
            self.last_roll["duration_s"])

    @property
    def inflight(self) -> int:
        """Accepted requests without a terminal output yet (O(1): the
        gauge refresh reads this every step, and `_tracked` keeps terminal
        records for the `client_id` mapping)."""
        return self._inflight

    # -- fleet loop --------------------------------------------------------

    def step(self) -> List[RequestOutput]:
        """One fleet iteration: revive restartable replicas, drain the
        router-held queue, step every replica with work (a raise is a
        replica death -> drain/requeue/restart-schedule), emit terminal
        outputs + ``router_stats`` records, refresh gauges."""
        outputs: List[RequestOutput] = list(self._emit_next)
        self._emit_next.clear()
        now = self._clock()
        self._steps += 1

        for replica in self.replicas.values():
            if replica.state is not ReplicaState.DEAD:
                continue
            if replica.try_restart(now):
                self.registry.counter("router/restarts_total").inc()
                # a rebuilt engine starts cold: resync (not clear) so the
                # shadow tracks exactly what the fresh index holds (nothing)
                self.shadows[replica.replica_id].resync(
                    replica.prefix_fingerprints())
                if self._health is not None:
                    # warm restart: the replica_down alert resolves
                    self._health.replica_up(replica.replica_id, now)
            elif replica.state is ReplicaState.RETIRED:
                # a failed REBUILD spent the budget (factory raised):
                # DEAD -> RETIRED happened inside try_restart, so count it
                # here — _failover only sees crash-time retirements
                self.registry.counter("router/retired_total").inc()
                if self._health is not None:
                    # terminal edge: "needs replacement", not "warm restart
                    # coming" — and the stale replica_down stops paging
                    self._health.replica_retired(
                        replica.replica_id,
                        replica.last_cause or "restart_budget_spent", now)

        self._drain_pending()

        failed_over = False
        for replica in list(self.replicas.values()):
            if not replica.has_work:
                continue
            try:
                outs = replica.step()
            except Exception as e:
                self._failover(replica, e, now)
                failed_over = True
                continue
            for out in outs:
                rec = self._tracked.get(out.request_id)
                if rec is not None and not rec.done:
                    self._finish(rec, out)
                outputs.append(out)

        if self._draining:
            self._complete_drains(now)
        if self._rolling is not None:
            self._advance_roll(now)

        if all(r.state is ReplicaState.RETIRED
               for r in self.replicas.values()):
            # terminal capacity loss: pending work can never run — fail it
            # terminally so every accepted request still yields exactly one
            # output (the exactly-once ledger stays balanced even here)
            while self._pending:
                rec = self._pending.popleft()
                out = self._synthetic_output(rec, "failed",
                                             "fleet_unavailable", now)
                self._finish(rec, out)
                outputs.append(out)

        if not outputs and not any(r.alive for r in self.replicas.values()):
            # total outage window: every replica is down but restarts are
            # scheduled — nothing can run until a backoff expires, so yield
            # the host instead of letting the drive loop spin on empty steps
            waits = [r._restart_at - now for r in self.replicas.values()
                     if r.state is ReplicaState.DEAD
                     and r._restart_at is not None]
            delay = min((w for w in waits if w > 0), default=0.0)
            if delay > 0:
                self._sleep(min(delay, 0.05))

        resync = bool(self.shadow_resync_every
                      and self._steps % self.shadow_resync_every == 0)
        if resync:
            for rid, replica in self.replicas.items():
                if replica.alive:
                    self.shadows[rid].resync(replica.prefix_fingerprints())

        self._export_gauges(full=resync or failed_over)
        if self._health is not None:
            # every terminal output — engine-emitted or router-synthetic —
            # feeds the fleet SLO burn-rate windows exactly once, then the
            # monitors evaluate on their cadence over the merged snapshot
            for out in outputs:
                self._health.note_output(out, now)
            self._health.step(self, now)
        return outputs

    def run_until_complete(self, max_steps: Optional[int] = None
                           ) -> List[RequestOutput]:
        outputs: List[RequestOutput] = []
        steps = 0
        while self.has_work:
            outputs.extend(self.step())
            steps += 1
            if max_steps is not None and steps >= max_steps:
                raise RuntimeError(
                    f"fleet did not drain in {max_steps} steps "
                    f"(pending={len(self._pending)}, "
                    f"inflight={self.inflight})")
        return outputs

    def dump_flight(self, reason: str) -> None:
        """Best-effort crash evidence across the pool (the drive loop's
        ``dump_flight`` hook)."""
        for replica in self.replicas.values():
            dump = getattr(replica.engine, "dump_flight", None)
            if replica.alive and dump is not None:
                try:
                    dump(reason)
                except Exception:
                    pass

    def close(self) -> None:
        for replica in self.replicas.values():
            replica.close()
        if self._stats_f is not None:
            self._stats_f.close()
            self._stats_f = None
        self._tracked.clear()

    def __enter__(self) -> "FleetRouter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # -- aggregate views ---------------------------------------------------

    def fleet_prefix_stats(self) -> dict:
        """Aggregate prefix-cache effectiveness across the CURRENT engines'
        registries (a restarted engine restarts its counts unless its
        factory reuses the registry): page hits/misses, hit rate, prefills
        skipped — the number affinity routing exists to push up."""
        hits = misses = skipped = 0.0
        for replica in self.replicas.values():
            reg = getattr(replica.engine, "registry", None)
            if reg is None:
                continue
            snap = reg.snapshot()
            hits += snap.get("kvcache/prefix_hits_total", 0.0)
            misses += snap.get("kvcache/prefix_misses_total", 0.0)
            skipped += snap.get("kvcache/prefill_skipped_total", 0.0)
        return {
            "prefix_hits": hits, "prefix_misses": misses,
            "prefix_hit_rate": (hits / (hits + misses)
                                if hits + misses else None),
            "prefills_skipped": skipped,
        }

    def assert_invariants(self) -> None:
        """The zero-loss ledger: every accepted, non-terminal request is
        either router-held (pending) or placed on a LIVE replica; nothing
        is both; terminal records never linger in either place.  O(tracked
        + replicas) — cheap enough for every property-test step."""
        pending_ids = {rec.global_id for rec in self._pending}
        assert len(pending_ids) == len(self._pending), "pending duplicates"
        live = sum(1 for rec in self._tracked.values() if not rec.done)
        assert self._inflight == live, (
            f"inflight counter {self._inflight} != live records {live}")
        for gid, rec in self._tracked.items():
            assert gid == rec.global_id
            if rec.done:
                assert gid not in pending_ids, (
                    f"terminal request {gid} still pending")
                continue
            if gid in pending_ids:
                continue
            replica = self.replicas.get(rec.replica_id)
            assert replica is not None and replica.alive, (
                f"live request {gid} placed on dead replica "
                f"{rec.replica_id}")
        for replica in self.replicas.values():
            sched = getattr(replica.engine, "scheduler", None) \
                if replica.alive else None
            if sched is not None:
                sched.assert_invariants()

    # -- internals ---------------------------------------------------------

    def _fingerprints(self, request: Request) -> List[int]:
        """Chain fingerprints of the prompt's page-aligned leading chunks,
        hashed exactly the way the engines' tries key them (padded-row page
        keys); empty off paged/prefix mode — and for policies that never
        read them — where affinity degrades to the policy's load fallback.

        Leading all-padding chains are DROPPED: every similar-length prompt
        shares the pad pages (they ride the NULL page — zero reuse value),
        so scoring them would hot-spot unrelated short prompts onto
        whichever replica saw the first one and count affinity hits with
        no real page sharing.  The remaining fingerprints are still
        full-chain rolling hashes, so they match the index truth exactly —
        matching just starts at the first real-content page."""
        if self._page is None or self._ctx is None \
                or not self.policy.needs_fps:
            return []
        C, L = self._ctx, min(request.prompt_len, self._ctx)
        ids = np.zeros((C,), np.int64)
        ids[C - L:] = request.prompt_ids[:L]
        valid = (np.arange(C) >= C - L).astype(np.int32)
        # the same adapter salt the engines' tries key with (multi-adapter serving):
        # an adapter'd prompt only matches pages prefilled under ITS adapter
        keys = page_keys(ids, valid, self._page,
                         salt=getattr(request, "adapter_id", 0))
        pad = 0
        while pad < len(keys) and is_padding_key(keys[pad]):
            pad += 1
        return prefix_fingerprints(keys)[pad:]

    def _views(self, candidates: List[int]) -> Dict[int, dict]:
        return {rid: self.replicas[rid].load() for rid in candidates}

    def _dispatch(self, rec: _Tracked, request: Request,
                  force_park: bool = False) -> None:
        """Place one request: policy choice over the live replicas, falling
        back across the pool on transient backpressure, parking router-held
        when nobody can take it right now.  ``force_park`` bypasses the
        ``max_pending`` bound — requeues of ALREADY-ACCEPTED requests must
        never be dropped by an admission limit that exists to bound NEW
        work."""
        tr = self.tracer
        dspan = (tr.begin("route/dispatch", request_id=rec.global_id,
                          hop=rec.requeues)
                 if tr is not None else None)
        # (inlined _dispatchable: the dispatch hot path must not pay a
        # bound-method allocation per replica when nothing is draining)
        candidates = [rid for rid, r in self.replicas.items()
                      if r.alive and rid not in self._draining]
        if not candidates:
            if dspan is not None:
                tr.end(dspan, parked=True, replica=-1)
            self._park(rec, force=force_park)
            return
        # load views cost a metrics scan per replica; rotation/random
        # policies never read them
        views = (self._views(candidates) if self.policy.needs_views else {})
        kw = {"adapter_id": rec.adapter_id}
        if self.policy.needs_priority:
            # only role-steering policies receive the class — keeps every
            # pre-existing policy's `choose` signature valid
            kw["priority"] = getattr(request, "priority", "interactive")
        decision: Decision = self.policy.choose(
            candidates, views, self.shadows, rec.fps, **kw)
        order = [decision.replica_id] + [
            rid for rid in candidates if rid != decision.replica_id]
        for i, rid in enumerate(order):
            try:
                self.replicas[rid].submit(request)
            except BackpressureError:
                continue  # transient: spill to the next-best live replica
            rec.replica_id = rid
            rec.dispatches += 1
            rec.affinity_pages = decision.affinity_pages if i == 0 else 0
            self.registry.counter("router/dispatched_total").inc()
            if rec.fps:
                self.registry.counter(
                    "router/affinity_hits_total" if rec.affinity_pages
                    else "router/affinity_misses_total").inc()
            self.shadows[rid].credit(rec.fps)
            if dspan is not None:
                tr.end(dspan, replica=rid, spills=i,
                       affinity_pages=rec.affinity_pages)
            return
        if dspan is not None:
            tr.end(dspan, parked=True, replica=-1, spills=len(order))
        self._park(rec, force=force_park)

    def _park(self, rec: _Tracked, force: bool = False) -> None:
        if not force and self.max_pending is not None \
                and len(self._pending) >= self.max_pending:
            self._tracked.pop(rec.global_id, None)
            raise BackpressureError(
                f"request {rec.global_id}: router backlog full "
                f"({len(self._pending)} held, max_pending "
                f"{self.max_pending}); retry after the fleet drains")
        rec.replica_id = None
        self._pending.append(rec)

    def _drain_pending(self) -> None:
        """Re-dispatch router-held requests while a live replica will take
        them (FCFS; a backpressured head re-parks and blocks the drain)."""
        while self._pending:
            if not any(r.alive for r in self.replicas.values()):
                return
            rec = self._pending.popleft()
            now = self._clock()
            if self._deadline_expired(rec, now):
                # the head's absolute deadline died while it was parked:
                # fail it terminally instead of burning a re-prefill on a
                # request nobody is waiting for anymore
                out = self._synthetic_output(rec, "timed_out", "timed_out",
                                             now)
                self._finish(rec, out)
                self._emit_next.append(out)
                continue
            before = len(self._pending)
            # build the requeue clone once per parked spell and reuse it
            # across bounced drain attempts (scheduler submit mutates
            # nothing before raising backpressure); a placement hands the
            # clone to the engine, so the next spell clones fresh
            if rec.clone is None:
                rec.clone = self._clone(rec)
            self._dispatch(rec, rec.clone, force_park=True)
            if len(self._pending) != before:
                # re-parked: nobody took it — restore the head's place so
                # a bouncing head blocks the drain instead of being
                # overtaken every round (FCFS)
                self._pending.appendleft(self._pending.pop())
                return
            rec.clone = None

    def _clone(self, rec: _Tracked) -> Request:
        """A fresh QUEUED request re-prefilled from the original prompt —
        the requeue unit.  The clone shares the template's stream_cb (which
        therefore re-streams from token 0) and sampling params; the global
        id is preserved, so the rng stream — and a greedy or sampled
        request's tokens — are identical wherever it lands.  The clone also
        carries the ORIGINAL submission instant, so ``deadline_s`` stays an
        absolute SLO through a crash (the scheduler preserves a pre-set
        ``submit_time``) instead of silently re-arming at requeue."""
        t = rec.template
        clone = Request(
            request_id=rec.global_id, prompt_ids=list(t.prompt_ids),
            max_new_tokens=t.max_new_tokens, sampling=t.sampling,
            stop_token_ids=t.stop_token_ids, deadline_s=t.deadline_s,
            stream_cb=t.stream_cb,
            adapter_id=getattr(t, "adapter_id", 0),
            priority=getattr(t, "priority", "interactive"))
        clone.submit_time = rec.submit_time
        # tracing: the clone's engine spans carry which requeue hop they
        # belong to (the original global id already stitches the trace)
        clone.hop = rec.requeues
        return clone

    def _deadline_expired(self, rec: _Tracked, now: float) -> bool:
        """Whether the request's absolute deadline (from the router-accept
        instant) has already passed — an expired clone must fail terminally
        as TIMED_OUT, never burn a sibling's re-prefill."""
        t = rec.template
        return (t is not None and t.deadline_s is not None
                and now - rec.submit_time > t.deadline_s)

    def _failover(self, replica: Replica, exc: BaseException,
                  now: float) -> None:
        """Drain a crashed replica: schedule its restart (or retirement),
        clear its shadow, requeue every accepted request it held on
        siblings.  The crashed engine's step output (if any) is lost with
        the engine — requeued clones re-run, so the router still emits
        exactly one terminal output per accepted request."""
        cause = f"{type(exc).__name__}: {exc}"
        logger.warning("fleet: replica %d crashed mid-step (%s) — draining",
                       replica.replica_id, cause)
        self.registry.counter("router/failovers_total").inc()
        if self._health is not None:
            # the replica_down condition fires (page severity) and stays
            # firing until try_restart re-enters the replica into rotation
            self._health.replica_down(replica.replica_id, cause, now)
        orphans = [rec for rec in self._tracked.values()
                   if not rec.done and rec.replica_id == replica.replica_id]
        # a crash outranks a graceful drain in progress: the failover path
        # (requeue + restart schedule) takes over and the plan is dropped
        self._draining.pop(replica.replica_id, None)
        replica.mark_dead(f"step_crash:{type(exc).__name__}", now)
        if replica.state is ReplicaState.RETIRED:
            self.registry.counter("router/retired_total").inc()
            if self._health is not None:
                self._health.replica_retired(
                    replica.replica_id,
                    replica.last_cause or f"step_crash:{type(exc).__name__}",
                    now)
        self.shadows[replica.replica_id].clear()
        requeued = 0
        for rec in orphans:
            if rec.cancelled:
                # the cancel was granted before the crash; emit the terminal
                # output the dead engine never got to sweep
                out = self._synthetic_output(rec, "cancelled", "cancelled",
                                             now)
                self._finish(rec, out)
                self._emit_next.append(out)
                continue
            if self._deadline_expired(rec, now):
                # an already-expired orphan fails terminally as TIMED_OUT —
                # requeueing it would both extend its SLO through the crash
                # and burn a sibling's prefill on a dead request
                out = self._synthetic_output(rec, "timed_out", "timed_out",
                                             now)
                self._finish(rec, out)
                self._emit_next.append(out)
                continue
            rec.requeues += 1
            requeued += 1
            self.registry.counter("router/requeued_total").inc()
            if self.tracer is not None:
                # the failover hop edge: this request's spans continue on
                # a sibling under the same global id, next hop number
                self.tracer.instant(
                    "route/requeue", request_id=rec.global_id, t=now,
                    hop=rec.requeues, from_replica=replica.replica_id,
                    cause=type(exc).__name__)
            try:
                self._dispatch(rec, self._clone(rec), force_park=True)
            except Exception as req_err:
                # unreachable on a homogeneous fleet (the original engine
                # admitted this request), but the ledger must hold even if
                # a sibling rejects the clone: fail it terminally instead
                # of losing it AND the remaining orphans to a raise
                logger.error(
                    "fleet: requeue of request %d rejected by every "
                    "sibling (%s) — failing it terminally",
                    rec.global_id, req_err)
                out = self._synthetic_output(
                    rec, "failed", f"requeue_rejected:{type(req_err).__name__}",
                    now)
                self._finish(rec, out)
                self._emit_next.append(out)
        logger.warning("fleet: requeued %d in-flight request(s) from "
                       "replica %d on siblings", requeued,
                       replica.replica_id)

    def _finish(self, rec: _Tracked, out: RequestOutput) -> None:
        rec.done = True
        self._inflight -= 1
        if self.tracer is not None:
            self.tracer.instant(
                "route/terminal", request_id=rec.global_id,
                state=out.state, replica=(rec.replica_id
                                          if rec.replica_id is not None
                                          else -1),
                requeues=rec.requeues)
        if self._stats_path is not None:
            self._write_stats(rec, out)
        # a terminal record only serves the client_id mapping from here on:
        # drop the prompt template and fingerprints, and evict the oldest
        # terminal records beyond retain_done, so a long-lived router's
        # memory does not grow with every request it ever served
        rec.template = None
        rec.fps = []
        rec.clone = None
        self._done_fifo.append(rec.global_id)
        while len(self._done_fifo) > self.retain_done:
            old = self._tracked.get(self._done_fifo.popleft())
            if old is not None and old.done:
                del self._tracked[old.global_id]

    def _write_stats(self, rec: _Tracked, out: RequestOutput) -> None:
        if self._stats_f is None:
            self._stats_f = open(self._stats_path, "a")
        self._stats_f.write(json.dumps({
            "schema": ROUTER_STATS_SCHEMA,
            "time": time.time(),
            "request_id": rec.global_id,
            "client_id": rec.client_id,
            "replica": rec.replica_id if rec.replica_id is not None else -1,
            "state": out.state,
            "finish_reason": out.finish_reason,
            "dispatches": rec.dispatches,
            "requeues": rec.requeues,
            # v2: disagg evidence — KV-migration hops this request took
            # and the steering role of the replica that finished it
            # ("mixed" on plain fleets, null for router-held terminals)
            "migrations": rec.migrations,
            "role": self._replica_role(rec.replica_id),
            "affinity_pages": rec.affinity_pages,
            "new_tokens": len(out.token_ids),
            "policy": self.policy.name,
            # extra (schemas are floors): the weights version that decoded
            # the request's last token — the mixed-version roll evidence
            "weights_version": getattr(out, "weights_version", 0),
        }) + "\n")
        self._stats_f.flush()

    def _synthetic_output(self, rec: _Tracked, state: str, reason: str,
                          now: float) -> RequestOutput:
        """Terminal output for a request that never reached (or will never
        reach) an engine — router-held cancellation or total capacity
        loss."""
        return RequestOutput(
            request_id=rec.global_id, state=state, finish_reason=reason,
            prompt_len=rec.template.prompt_len, token_ids=(),
            queue_ms=max(now - rec.submit_time, 0.0) * 1e3, ttft_ms=None,
            total_ms=max(now - rec.submit_time, 0.0) * 1e3)

    def _export_gauges(self, full: bool = True) -> None:
        """Refresh the router gauges.  The cheap ones (pool head-count,
        backlog, inflight, affinity rate — plain counter reads) refresh
        every step; ``full`` adds the expensive pool scans (per-replica
        load views, aggregate `kvcache` snapshots) and runs on the
        ``shadow_resync_every`` cadence plus construction/failover, keeping
        the per-step hot loop O(replicas)."""
        reg = self.registry
        alive = sum(1 for r in self.replicas.values() if r.alive)
        reg.gauge("router/replicas_alive").set(alive)
        reg.gauge("router/queue_depth").set(len(self._pending))
        reg.gauge("router/inflight").set(self.inflight)
        hits = reg.counter("router/affinity_hits_total").value
        misses = reg.counter("router/affinity_misses_total").value
        if hits + misses:
            reg.gauge("router/affinity_hit_rate").set(hits / (hits + misses))
        if not full:
            return
        rate = self.fleet_prefix_stats()["prefix_hit_rate"]
        if rate is not None:
            reg.gauge("router/fleet_prefix_hit_rate").set(rate)
        for rid, replica in self.replicas.items():
            view = replica.load() if replica.alive else {}
            reg.gauge(f"router/replica{rid}/alive").set(int(replica.alive))
            reg.gauge(f"router/replica{rid}/load").set(
                view.get("queue_depth", 0) + view.get("active", 0))
