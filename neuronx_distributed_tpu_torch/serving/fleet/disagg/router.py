"""Disaggregated fleet router: roles, KV migration, fleet prefix cache.

:class:`DisaggRouter` extends :class:`~..router.FleetRouter` with the
three moves of prefill/decode disaggregation (DistServe, Splitwise,
Mooncake) on top of the existing zero-loss ledger:

- **Role-aware dispatch.**  Replicas carry a steering role
  (``prefill`` / ``decode`` / ``mixed``); the default policy routes
  interactive TTFT traffic to prefill capacity and batch traffic to
  decode capacity.  The homogeneity check relaxes to ROLE-COMPATIBLE
  envelopes: pool capacity may differ between roles, page geometry never.

- **KV-page migration.**  A request that finishes prefill on a
  prefill-role replica is moved to a decode-capable sibling: its
  committed prompt chain is exported/imported (``kvcache.transfer``,
  transactional — a chaos kill mid-transfer leaks nothing on either
  side), the source withdraws the request with NO terminal output, and a
  clone re-submitted to the destination full-hits the imported chain —
  prefill is never paid twice, and the regenerated token stream is
  identical (the global id keys the rng).  Each hop is a
  ``route/migrate`` span (page count / bytes / endpoints) and one
  ``router/migrations_total`` tick.

- **Fleet-global prefix cache.**  A :class:`~.directory
  .FleetPrefixDirectory` over the per-replica prefix indexes: when a
  dispatch lands a prompt on a replica that lacks its full chain but a
  sibling holds it, the chain is imported instead of re-prefilled — a
  popular prompt is prefilled ONCE fleet-wide
  (``kvcache/fleet_prefix_hits_total``).

Failure semantics: a migration or prefix fill that fails mid-flight
aborts cleanly (the transfer layer's transactional contract) and the
request simply stays — or re-prefills — where it is; the exactly-once
output ledger is untouched.
"""

from __future__ import annotations

from typing import Any, Sequence

from neuronx_distributed_tpu_torch.serving.fleet.disagg.directory import (
    FLEET_PREFIX_HITS_TOTAL,
    FLEET_PREFIX_MISSES_TOTAL,
    FleetPrefixDirectory,
)
from neuronx_distributed_tpu_torch.serving.fleet.disagg.roles import (
    ROLE_DECODE,
    ROLE_MIXED,
    ROLE_PREFILL,
    role_compatible,
    role_envelope,
    validate_role,
)
from neuronx_distributed_tpu_torch.serving.fleet.replica import Replica
from neuronx_distributed_tpu_torch.serving.fleet.router import FleetRouter, _Tracked
from neuronx_distributed_tpu_torch.serving.fleet.routing import load_score
from neuronx_distributed_tpu_torch.serving.request import Request, RequestState
from neuronx_distributed_tpu_torch.serving.scheduler import BackpressureError
from neuronx_distributed_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

MIGRATIONS_TOTAL = "router/migrations_total"


class DisaggRouter(FleetRouter):
    """A :class:`~..router.FleetRouter` over role-labelled replicas.

    ``policy`` defaults to ``role_aware`` (interactive -> prefill
    capacity, batch -> decode capacity, prefix affinity within the role
    pool).  ``migrate_after_prefill`` (default True) enables the
    post-prefill KV migration pass; ``fleet_prefix`` (default True) the
    cross-replica prefix-cache fill.  Everything else — ids, failover,
    stats, health — is the base router."""

    def __init__(self, replicas: Sequence[Replica], *,
                 policy: Any = "role_aware",
                 migrate_after_prefill: bool = True,
                 fleet_prefix: bool = True,
                 **kwargs):
        for r in replicas:
            validate_role(getattr(r, "role", ROLE_MIXED))
        super().__init__(replicas, policy=policy, **kwargs)
        self.migrate_after_prefill = migrate_after_prefill
        self.fleet_prefix = fleet_prefix
        self.directory = FleetPrefixDirectory()
        for rid, replica in self.replicas.items():
            if replica.alive:
                self.directory.resync(rid, replica.prefix_fingerprints())
        reg = self.registry
        reg.counter(MIGRATIONS_TOTAL)
        reg.counter(FLEET_PREFIX_HITS_TOTAL)
        reg.counter(FLEET_PREFIX_MISSES_TOTAL)

    # -- relaxed homogeneity ----------------------------------------------

    def _check_envelopes(self, replicas: Sequence[Replica],
                         desc: dict) -> None:
        """Role-compatible relaxation of the base check: capacity keys
        (pool page counts and their byte mirrors) may differ between
        prefill- and decode-heavy replicas; any GEOMETRY mismatch — page
        size, context width, quantization, adapter layout — is still a
        hard refusal, because a migrated page row scattered into the
        wrong shape is silent corruption."""
        for r in replicas[1:]:
            if not role_compatible(r.describe(), desc):
                raise ValueError(
                    f"role-incompatible fleet: replica {r.replica_id} "
                    f"serves {role_envelope(r.describe())}, replica "
                    f"{replicas[0].replica_id} "
                    f"{role_envelope(desc)} — KV migration and requeue "
                    "require identical page geometry (only capacity may "
                    "differ between roles)")

    def roles(self) -> dict:
        """``{replica_id: role}`` — the fleet_watch / health view."""
        return {rid: getattr(r, "role", ROLE_MIXED)
                for rid, r in self.replicas.items()}

    def add_replica(self, replica: Replica) -> None:
        """Autoscale join with the disagg extras: the role label must be
        valid, and the new index (empty) enters the fleet prefix
        directory so fills can credit it immediately."""
        validate_role(getattr(replica, "role", ROLE_MIXED))
        super().add_replica(replica)
        self.directory.resync(replica.replica_id,
                              replica.prefix_fingerprints())

    def _forget_replica(self, rid: int) -> None:
        """A retired or rebuilt replica's pool (and index) is gone: drop
        every directory claim it held."""
        self.directory.forget_replica(rid)

    # -- fleet loop hooks --------------------------------------------------

    def step(self):
        outputs = super().step()
        now = self._clock()
        if (self.shadow_resync_every
                and self._steps % self.shadow_resync_every == 0):
            # directory staleness is bounded by the same cadence as the
            # shadows (and a stale claim is already safe — see directory)
            for rid, replica in self.replicas.items():
                if replica.alive:
                    self.directory.resync(rid, replica.prefix_fingerprints())
        if self.migrate_after_prefill:
            self._migrate_pass(now)
        return outputs

    def _failover(self, replica: Replica, exc: BaseException,
                  now: float) -> None:
        super()._failover(replica, exc, now)
        # the crashed pool (and its index) died with the engine: every
        # directory claim it held is gone
        self.directory.forget_replica(replica.replica_id)

    def _dispatch(self, rec: _Tracked, request: Request,
                  force_park: bool = False) -> None:
        super()._dispatch(rec, request, force_park=force_park)
        if rec.replica_id is not None:
            self.directory.credit(rec.replica_id, rec.fps)
            if self.fleet_prefix:
                self._fleet_prefix_fill(rec)

    # -- fleet-global prefix cache ----------------------------------------

    def _fleet_prefix_fill(self, rec: _Tracked) -> None:
        """Cross-replica prefix fill for a just-dispatched request: when
        the placed replica lacks the prompt's FULL chain but a sibling
        holds it, import the chain so the admission full-hits instead of
        re-prefilling.  Only the exact full-prompt chain is worth moving
        — partial prefixes still need a prefill pass that would overwrite
        the tail anyway."""
        if not rec.fps:
            return
        rid = rec.replica_id
        eng = self.replicas[rid].engine
        imp = getattr(eng, "import_prefix", None)
        kv = getattr(eng, "_kv", None)
        if imp is None or kv is None or kv.index is None:
            return
        fp = rec.fps[-1]
        if fp in kv.prefix_fingerprints():
            return  # locally cached: the engine's own hit path covers it
        reg = self.registry
        dead = {r for r, rep in self.replicas.items() if not rep.alive}
        tr = self.tracer
        for donor in self.directory.holders(fp, exclude={rid} | dead):
            export = self.replicas[donor].engine.export_prefix(fp)
            if export is None:
                # the donor evicted the chain since the directory last
                # synced — drop the stale claim, try the next holder
                self.directory.uncredit(donor, fp)
                continue
            span = (tr.begin(
                "route/migrate", request_id=rec.global_id,
                t=self._clock(), kind="prefix_fill", from_replica=donor,
                to_replica=rid, pages=export.n_pages, bytes=export.nbytes)
                if tr is not None else None)
            try:
                imp(export)
            except Exception as e:
                # transactional import: the target leaked nothing; the
                # request simply pays its own prefill
                if span is not None:
                    tr.end(span, t=self._clock(),
                           aborted=type(e).__name__)
                logger.warning(
                    "disagg: fleet-prefix fill of request %d onto replica "
                    "%d failed (%s); falling back to local prefill",
                    rec.global_id, rid, e)
                reg.counter(FLEET_PREFIX_MISSES_TOTAL).inc()
                return
            if span is not None:
                tr.end(span, t=self._clock())
            self.directory.credit(rid, rec.fps)
            reg.counter(FLEET_PREFIX_HITS_TOTAL).inc()
            return
        reg.counter(FLEET_PREFIX_MISSES_TOTAL).inc()

    # -- KV-page migration -------------------------------------------------

    def _migrate_pass(self, now: float) -> None:
        """Move every request that finished prefill on a strictly
        prefill-role replica to a decode-capable sibling.  Strict-role
        sources only, decode/mixed destinations only — so a migrated
        request can never ping-pong back."""
        sources = [rid for rid, r in self.replicas.items()
                   if r.alive and getattr(r, "role", ROLE_MIXED)
                   == ROLE_PREFILL]
        # destinations must be dispatchable: migrating INTO a draining
        # replica would refill the very work the drain is waiting out
        dests = [rid for rid, r in self.replicas.items()
                 if self._dispatchable(rid)
                 and getattr(r, "role", ROLE_MIXED)
                 in (ROLE_DECODE, ROLE_MIXED)]
        if not sources or not dests:
            return
        src_set = set(sources)
        for rec in list(self._tracked.values()):
            if rec.done or rec.replica_id not in src_set or not rec.fps:
                continue
            src = self.replicas[rec.replica_id]
            sched = getattr(src.engine, "scheduler", None)
            if sched is None:
                continue
            req = sched._by_id.get(rec.global_id)
            if req is None or req.state is not RequestState.DECODE:
                continue  # still queued / prefilling (or mid-sweep)
            self._migrate(rec, src, dests, now)

    def _migrate(self, rec: _Tracked, src: Replica,
                 dests: Sequence[int], now: float) -> bool:
        """One migration hop: export the committed prompt chain, import
        it into the least-loaded destination, withdraw from the source
        (no terminal output), re-submit a clone that full-hits the
        imported chain.  Import-before-withdraw ordering makes every
        failure safe: until the withdrawal the request keeps decoding on
        the source untouched."""
        fp = rec.fps[-1]
        export = src.engine.export_prefix(fp)
        if export is None:
            return False  # chain evicted under pressure: decode in place
        views = self._views(list(dests))
        dest = min(dests, key=lambda r: load_score(views[r]))
        tr = self.tracer
        span = (tr.begin(
            "route/migrate", request_id=rec.global_id, t=now,
            kind="kv_migration", from_replica=src.replica_id,
            to_replica=dest, pages=export.n_pages, bytes=export.nbytes)
            if tr is not None else None)
        imp = getattr(self.replicas[dest].engine, "import_prefix", None)
        if imp is None:
            if span is not None:
                tr.end(span, t=self._clock(), aborted="no_import_surface")
            return False
        try:
            imp(export)
        except Exception as e:
            # the transfer layer's transactional contract: the destination
            # released every page it took, the source never stopped — the
            # request simply keeps decoding where it is
            if span is not None:
                tr.end(span, t=self._clock(), aborted=type(e).__name__)
            logger.warning(
                "disagg: migration of request %d from replica %d to %d "
                "aborted (%s); request continues on the source",
                rec.global_id, src.replica_id, dest, e)
            return False
        withdrawn = src.engine.withdraw(rec.global_id)
        rec.migrations += 1
        clone = self._clone(rec)
        # engine spans key their hop on total placement attempts
        clone.hop = rec.requeues + rec.migrations
        # TTFT travels with the request: the user's first token streamed
        # from the SOURCE's prefill — the destination's re-prefill must
        # not re-stamp it (the engine preserves a pre-set instant)
        clone.first_token_time = withdrawn.first_token_time
        try:
            self.replicas[dest].submit(clone)
            rec.replica_id = dest
            rec.dispatches += 1
            self.shadows[dest].credit(rec.fps)
            self.directory.credit(dest, rec.fps)
        except BackpressureError:
            # the destination filled between the load view and the
            # submit: the normal dispatch path (force-park — an accepted
            # request is never dropped) finds it a home
            self._dispatch(rec, clone, force_park=True)
        self.registry.counter(MIGRATIONS_TOTAL).inc()
        if span is not None:
            tr.end(span, t=self._clock())
        logger.info(
            "disagg: migrated request %d (%d pages, %d bytes) from "
            "replica %d to %d", rec.global_id, export.n_pages,
            export.nbytes, src.replica_id,
            rec.replica_id if rec.replica_id is not None else -1)
        return True
