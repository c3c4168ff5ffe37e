"""Fleet autopilot: alert-driven remediation that closes the loop.

Counterpart of ``neuronx_distributed_tpu/serving/fleet/autopilot.py``.
The health layer (burn-rate SLO rules, trend rules, ``replica_down``
edges, :mod:`...obs.aggregate`) raises alerts and the fleet has roles and
KV migration, but an alert alone only pages a human.  :class:`Autopilot`
is the controller that *acts* on those signals, mapping alert edges to
five remediations:

- **scale out** — sustained fast-window burn spawns a replica from the
  engine factory; it enters rotation only after
  :meth:`~..router.FleetRouter.add_replica`'s envelope homogeneity check
  passes, and any permanently-retired replica's stale ``replica_down`` /
  ``replica_retired`` alerts resolve as "replaced by".
- **scale in** — sustained idle drains the least-loaded replica
  gracefully (:meth:`~..router.FleetRouter.drain`: no new dispatches,
  in-flight work finishes IN PLACE — zero requeues, zero re-prefills,
  unlike the crash-failover path) then retires it WITHOUT spending
  restart budget and releases its pool.
- **drain-and-restart** — compile-storm or memory-watermark alerts
  rotate the offending replica through a proactive warm rebuild (the
  crash-restart discipline of :mod:`..replica`, minus the crash).
- **dynamic admission** — the burn rate drives a load-shed scale on
  every scheduler's feasibility margin plus per-tenant token-bucket rate
  limits, both relaxed stepwise on resolve — admission follows load
  instead of a static knob.
- **role rebalance** — when the live queue mix drifts from the
  prefill/decode split (the Splitwise observation), one replica is
  drained, re-roled and rejoined with its pages intact.

Flap-bounding is structural, not hopeful: every trigger must hold for
``fire_after`` consecutive evaluations (hysteresis on top of the alert
layer's own streaks), every action kind has a cooldown, and a global
action-rate budget (actions per rolling window) caps the controller no
matter what the triggers do.  Every action emitted is a schema-checked
``autopilot_actions.jsonl`` record carrying the triggering alert edge.

The kill-switch — ``mode="page_only"`` — reverts to pager behavior
within one evaluation cadence (the mode is read at the top of every
evaluation), and autopilot-off follows the module-counter discipline
(:data:`ACTIONS_EVALUATED`, like ``SPANS_CREATED``/``PERF_RECORDS``):
nothing in the serving hot path allocates for a controller that is not
attached.
"""

from __future__ import annotations

import dataclasses
import json
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from neuronx_distributed_tpu_torch.obs.schemas import validate_record
from neuronx_distributed_tpu_torch.serving.fleet.replica import ReplicaState
from neuronx_distributed_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

AUTOPILOT_ACTION_SCHEMA = "autopilot_action/1"

# module counter (the SPANS_CREATED discipline): every evaluation pass —
# including page_only no-ops — ticks it, so "autopilot did nothing"
# is checkable as an exact count with zero per-call allocation
ACTIONS_EVALUATED = 0

MODES = ("auto", "page_only")

# action kind -> registry counter suffix (every action also ticks
# autopilot/actions_total; drain-initiating kinds also tick
# autopilot/drains_total)
_ACTION_COUNTERS = {
    "scale_out": "scale_outs_total",
    "scale_in": "scale_ins_total",
    "restart": "restarts_total",
    "tighten": "admission_tightenings_total",
    "relax": None,  # counted in actions_total only
    "rebalance": "rebalances_total",
}
_DRAIN_ACTIONS = frozenset({"scale_in", "restart", "rebalance"})

DEFAULT_COOLDOWNS_S = {
    "scale_out": 30.0,
    "scale_in": 60.0,
    "restart": 60.0,
    "tighten": 10.0,
    "relax": 10.0,
    "rebalance": 60.0,
}


@dataclasses.dataclass
class AutopilotConfig:
    """The autopilot's knobs.  Defaults suit a real fleet cadence; tests
    and the bench shrink the windows (everything is in seconds against
    the injected clock, so shrinking is exact, not flaky)."""

    mode: str = "auto"            # "auto" acts; "page_only" only pages
    eval_every: int = 4           # controller ticks per evaluation
    # fleet-size bounds for autoscale
    min_replicas: int = 1
    max_replicas: int = 8
    # hysteresis: consecutive evaluations a trigger must hold (fire) or
    # stay clear (resolve) before the controller acts on the transition
    fire_after: int = 2
    resolve_after: int = 2
    # scale-in: consecutive evaluations the fleet must sit below the
    # utilization floor (inflight / total slots)
    idle_after: int = 8
    idle_util_frac: float = 0.1
    # alert rules driving each remediation (fleet default_rules names)
    burn_rules: Tuple[str, ...] = ("slo_burn_fast_interactive",
                                   "slo_burn_fast_batch")
    restart_rules: Tuple[str, ...] = ("compile_storm", "kv_headroom")
    # dynamic admission: each tighten multiplies the schedulers'
    # feasibility margin by shed_scale_step (bounded), each relax divides
    shed_scale_step: float = 2.0
    shed_scale_max: float = 8.0
    # per-tenant token buckets while tightened: baseline requests/second
    # (scaled down by the current shed scale) and burst ceiling; None
    # leaves tenant limits alone entirely
    tenant_rate: Optional[float] = None
    tenant_burst: Optional[float] = None
    # disagg role rebalance: minimum fleet-wide backlog before the queue
    # mix is trusted, and the share drift that triggers a re-role
    rebalance_min_queued: int = 8
    rebalance_drift: float = 0.25
    # flap bounds: per-action-kind cooldowns + the global action budget
    # (actions per rolling window) — the provable cap on action rate
    cooldown_s: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_COOLDOWNS_S))
    action_budget: int = 8
    budget_window_s: float = 300.0

    def __post_init__(self) -> None:
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, "
                             f"got {self.mode!r}")
        if self.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if self.action_budget < 1:
            raise ValueError("action_budget must be >= 1")
        if self.shed_scale_step <= 1.0:
            raise ValueError("shed_scale_step must be > 1.0")


class _ActionSink:
    """Append-only ``autopilot_actions.jsonl`` writer; every record is
    validated against the ``autopilot_action`` schema BEFORE it is
    written (a malformed action record is a bug, not telemetry)."""

    def __init__(self, path: str):
        self.path = path
        # eager creation: a run that took zero actions still leaves an
        # (empty) artifact, so "no actions" and "no autopilot" differ
        self._f = open(path, "a")

    def emit(self, record: dict) -> None:
        validate_record("autopilot_action", record)
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class Autopilot:
    """The remediation controller over one fleet.

    ``router`` is a :class:`~..router.FleetRouter` (or
    :class:`~..disagg.router.DisaggRouter` — role rebalancing activates
    only when the router exposes ``roles()``), ``health`` its attached
    ``obs.aggregate.FleetHealth`` (the alert source).  ``replica_factory``
    — ``f(replica_id) -> Replica`` — enables scale-out; without it the
    scale-out trigger degrades to admission tightening.  ``actions_path``
    appends one schema-checked JSONL record per action.  ``clock``/
    ``wall`` are injectable for deterministic tests.

    Drive it from the serving loop: call :meth:`step` once per fleet
    iteration (internally cadenced by ``config.eval_every``)."""

    def __init__(self, router: Any, health: Any, *,
                 replica_factory: Optional[Callable[[int], Any]] = None,
                 config: Optional[AutopilotConfig] = None,
                 actions_path: Optional[str] = None,
                 registry: Any = None,
                 clock: Callable[[], float] = time.monotonic,
                 wall: Callable[[], float] = time.time):
        self.router = router
        self.health = health
        self.replica_factory = replica_factory
        self.config = config if config is not None else AutopilotConfig()
        self._clock = clock
        self._wall = wall
        self.sink = (_ActionSink(actions_path)
                     if actions_path is not None else None)
        self.registry = registry if registry is not None else router.registry
        reg = self.registry
        for c in ("actions", "scale_outs", "scale_ins", "drains",
                  "restarts", "admission_tightenings", "rebalances"):
            reg.counter(f"autopilot/{c}_total")
        reg.gauge("autopilot/mode").set(
            1.0 if self.config.mode == "auto" else 0.0)
        self._tick = 0
        # hysteresis streaks per trigger name (consecutive evaluations
        # the trigger held / stayed clear)
        self._streaks: Dict[str, int] = {}
        # flap bounds
        self._last_action_t: Dict[str, float] = {}
        self._action_times: deque = deque()
        self.suppressed = 0  # actions wanted but denied by the budget
        # dynamic admission state
        self._shed_scale = 1.0
        # recent actions for fleet_watch / healthz (newest last)
        self.actions: deque = deque(maxlen=256)

    # -- mode / introspection ----------------------------------------------

    @property
    def mode(self) -> str:
        return self.config.mode

    def set_mode(self, mode: str) -> None:
        """Flip the kill-switch.  Takes effect at the NEXT evaluation —
        i.e. within one evaluation cadence — because :meth:`step` reads
        the mode before doing anything else.  Flipping to ``page_only``
        also relaxes any admission tightening immediately: a disabled
        controller must not leave the fleet shedding load it can no
        longer untighten."""
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self.config.mode = mode
        self.registry.gauge("autopilot/mode").set(
            1.0 if mode == "auto" else 0.0)
        if mode != "auto" and self._shed_scale != 1.0:
            self._shed_scale = 1.0
            self._apply_admission()
        logger.info("autopilot: mode -> %s", mode)

    @property
    def shed_scale(self) -> float:
        return self._shed_scale

    def budget_remaining(self, now: Optional[float] = None) -> int:
        now = self._clock() if now is None else now
        self._trim_budget(now)
        return max(self.config.action_budget - len(self._action_times), 0)

    def healthz_fields(self) -> dict:
        """The readiness-doc slice orchestrators read: is the fleet
        self-healing (mode auto, budget left) or paging?"""
        last = self.actions[-1] if self.actions else None
        return {
            "mode": self.config.mode,
            "shed_scale": self._shed_scale,
            "last_action": ({"action": last["action"],
                             "trigger": last["trigger"],
                             "replica": last["replica"],
                             "mono": last["mono"]}
                            if last is not None else None),
            "actions_in_window": len(self._action_times),
            "action_budget": self.config.action_budget,
            "budget_remaining": self.budget_remaining(),
            "suppressed": self.suppressed,
        }

    def close(self) -> None:
        if self.sink is not None:
            self.sink.close()

    # -- the control loop --------------------------------------------------

    def step(self, now: Optional[float] = None) -> List[dict]:
        """One controller tick.  Every ``eval_every``-th call evaluates
        the triggers and takes (budget-bounded) actions; returns the
        action records emitted this evaluation (empty list on cadence
        skips and in ``page_only`` mode).  The module counter ticks on
        EVERY call — the only thing the off/cadence path touches."""
        global ACTIONS_EVALUATED
        ACTIONS_EVALUATED += 1
        self._tick += 1
        if self._tick % self.config.eval_every:
            return []
        if self.config.mode != "auto":
            # kill-switch: pager behavior — alerts keep flowing through
            # FleetHealth untouched; the controller neither reads them
            # nor acts.  Checked per evaluation, so a set_mode lands
            # within one cadence.
            return []
        now = self._clock() if now is None else now
        firing = {a["rule"]: a for a in self.health.firing()}
        emitted: List[dict] = []

        burn = self._streak("burn", any(r in firing
                                        for r in self.config.burn_rules))
        burn_edge = next((firing[r] for r in self.config.burn_rules
                          if r in firing), None)
        if burn >= self.config.fire_after:
            self._on_burn(burn_edge, now, emitted)
        elif self._shed_scale > 1.0 \
                and self._streak_value("burn") == 0 \
                and self._streak("burn_clear", True) \
                >= self.config.resolve_after:
            self._relax(now, emitted)
        if burn:
            self._streaks["burn_clear"] = 0

        restart_edge = next((firing[r] for r in self.config.restart_rules
                             if r in firing), None)
        if self._streak("restart", restart_edge is not None) \
                >= self.config.fire_after:
            self._drain_restart(restart_edge, now, emitted)

        idle = self._fleet_util(now) < self.config.idle_util_frac
        if self._streak("idle", idle) >= self.config.idle_after:
            self._scale_in(now, emitted)

        drift = self._queue_mix_drift()
        if drift is not None and self._streak("mix", drift[0]) \
                >= self.config.fire_after:
            self._rebalance(drift, now, emitted)

        if self._shed_scale != 1.0:
            # engines rebuilt by restarts/scale-out start at the static
            # knobs: re-assert the current tightening each evaluation
            self._apply_admission()
        return emitted

    # -- triggers ----------------------------------------------------------

    def _streak(self, name: str, active: bool) -> int:
        streak = self._streaks.get(name, 0) + 1 if active else 0
        self._streaks[name] = streak
        return streak

    def _streak_value(self, name: str) -> int:
        return self._streaks.get(name, 0)

    def _fleet_util(self, now: float) -> float:
        """In-system requests over total slots across dispatchable
        replicas (1.0 when no capacity — never 'idle' while dying)."""
        slots = 0
        for rid, replica in self.router.replicas.items():
            if self.router._dispatchable(rid):
                slots += getattr(replica.engine, "B", 1)
        if slots <= 0:
            return 1.0
        return self.router.inflight / slots

    def _queue_mix_drift(self) -> Optional[tuple]:
        """Disagg-only: ``(drifted, want_role, Qi, Qb)`` comparing the
        live interactive/batch backlog split against the prefill/decode
        replica split; None when the router has no roles, the fleet has
        no re-roleable pair, or the backlog is too small to trust."""
        roles_fn = getattr(self.router, "roles", None)
        if roles_fn is None:
            return None
        qi = qb = 0
        for replica in self.router.replicas.values():
            if not replica.alive:
                continue
            sched = getattr(replica.engine, "scheduler", None)
            if sched is None:
                continue
            qi += sched.queue_depth_of("interactive")
            qb += sched.queue_depth_of("batch")
        if qi + qb < self.config.rebalance_min_queued:
            return (False, None, qi, qb)
        roles = {rid: role for rid, role in roles_fn().items()
                 if self.router.replicas[rid].alive}
        n_pre = sum(1 for r in roles.values() if r == "prefill")
        n_dec = sum(1 for r in roles.values() if r == "decode")
        if n_pre + n_dec < 2:
            return (False, None, qi, qb)
        want_share = qi / (qi + qb)          # interactive -> prefill
        have_share = n_pre / (n_pre + n_dec)
        drift = want_share - have_share
        if abs(drift) <= self.config.rebalance_drift:
            return (False, None, qi, qb)
        # positive drift: interactive backlog outweighs prefill capacity
        want_role = "prefill" if drift > 0 else "decode"
        # never re-role the last replica of the donor role
        donor = "decode" if want_role == "prefill" else "prefill"
        if (n_dec if donor == "decode" else n_pre) < 2:
            return (False, None, qi, qb)
        return (True, want_role, qi, qb)

    # -- flap bounds -------------------------------------------------------

    def _trim_budget(self, now: float) -> None:
        w = self.config.budget_window_s
        while self._action_times and now - self._action_times[0] > w:
            self._action_times.popleft()

    def _may_act(self, kind: str, now: float) -> bool:
        """Cooldown + global budget gate; a budget denial is counted
        (``suppressed``) so the flapping tests — and operators — can see
        the controller WANTED to act and was bounded."""
        cd = self.config.cooldown_s.get(kind, 0.0)
        last = self._last_action_t.get(kind)
        if last is not None and now - last < cd:
            return False
        self._trim_budget(now)
        if len(self._action_times) >= self.config.action_budget:
            self.suppressed += 1
            return False
        return True

    # -- actions -----------------------------------------------------------

    def _emit(self, action: str, trigger: str, replica: int, detail: dict,
              edge: Optional[dict], now: float) -> dict:
        self._last_action_t[action] = now
        self._action_times.append(now)
        self._streaks[{"scale_out": "burn", "tighten": "burn",
                       "relax": "burn_clear", "restart": "restart",
                       "scale_in": "idle", "rebalance": "mix"}
                      .get(action, action)] = 0
        reg = self.registry
        reg.counter("autopilot/actions_total").inc()
        suffix = _ACTION_COUNTERS.get(action)
        if suffix is not None:
            reg.counter(f"autopilot/{suffix}").inc()
        if action in _DRAIN_ACTIONS:
            reg.counter("autopilot/drains_total").inc()
        record = {
            "schema": AUTOPILOT_ACTION_SCHEMA,
            "time": self._wall(),
            "mono": now,
            "action": action,
            "trigger": trigger,
            "mode": self.config.mode,
            "replica": replica,
            "detail": detail,
            "edge": dict(edge) if edge is not None else None,
            "budget_remaining": self.budget_remaining(now),
        }
        if self.sink is not None:
            self.sink.emit(record)
        self.actions.append(record)
        logger.info("autopilot: %s (trigger %s, replica %s) %s", action,
                    trigger, replica, detail)
        return record

    def _on_burn(self, edge: Optional[dict], now: float,
                 emitted: List[dict]) -> None:
        """Sustained fast-window burn: add capacity when we can, tighten
        admission either way (both on their own cooldowns)."""
        trigger = edge["rule"] if edge is not None else "slo_burn_fast"
        if self.replica_factory is not None:
            live = [rid for rid in self.router.replicas
                    if self.router._dispatchable(rid)]
            if len(live) < self.config.max_replicas \
                    and self._may_act("scale_out", now):
                rec = self._scale_out(trigger, edge, now)
                if rec is not None:
                    emitted.append(rec)
                    return  # give the new capacity a cadence to land
        if self._shed_scale < self.config.shed_scale_max \
                and self._may_act("tighten", now):
            self._shed_scale = min(
                self._shed_scale * self.config.shed_scale_step,
                self.config.shed_scale_max)
            self._apply_admission()
            emitted.append(self._emit(
                "tighten", trigger, -1,
                {"shed_scale": self._shed_scale,
                 "tenant_rate": self._effective_tenant_rate()},
                edge, now))

    def _scale_out(self, trigger: str, edge: Optional[dict],
                   now: float) -> Optional[dict]:
        rid = max(self.router.replicas) + 1
        try:
            replica = self.replica_factory(rid)
            self.router.add_replica(replica)
        except Exception as e:
            # a factory or envelope failure must not crash the fleet loop;
            # the cooldown stops a broken factory from being hammered
            logger.error("autopilot: scale-out failed: %s", e)
            self._last_action_t["scale_out"] = now
            return None
        replaced = []
        for old_rid, old in self.router.replicas.items():
            if old.state is ReplicaState.RETIRED and old_rid != rid:
                # the stale replica_down / replica_retired alerts resolve:
                # the capacity the pager was holding the fort for is back
                self.health.replica_replaced(old_rid, rid, now)
                replaced.append(old_rid)
        return self._emit("scale_out", trigger, rid,
                          {"replaces": replaced,
                           "fleet_size": len(self.router.replicas)},
                          edge, now)

    def _relax(self, now: float, emitted: List[dict]) -> None:
        if not self._may_act("relax", now):
            return
        self._shed_scale = max(self._shed_scale
                               / self.config.shed_scale_step, 1.0)
        self._apply_admission()
        emitted.append(self._emit(
            "relax", "burn_resolved", -1,
            {"shed_scale": self._shed_scale,
             "tenant_rate": self._effective_tenant_rate()}, None, now))

    def _drain_restart(self, edge: Optional[dict], now: float,
                       emitted: List[dict]) -> None:
        if not self._may_act("restart", now):
            return
        rid = edge.get("replica", -1) if edge is not None else -1
        if rid < 0 or not self.router.replicas.get(rid) \
                or not self.router._dispatchable(rid):
            # fleet-scope alert: rotate the busiest dispatchable replica
            # (the compile-storm / watermark pressure lives where the
            # work does); nothing dispatchable -> nothing to rotate
            candidates = [r for r in self.router.replicas
                          if self.router._dispatchable(r)]
            if len(candidates) < 2:
                return  # never take the only dispatchable replica offline
            views = {r: self.router.replicas[r].load() for r in candidates}
            rid = max(candidates,
                      key=lambda r: (views[r]["queue_depth"]
                                     + views[r]["active"]))
        elif sum(1 for r in self.router.replicas
                 if self.router._dispatchable(r)) < 2:
            return
        trigger = edge["rule"] if edge is not None else "restart"
        try:
            self.router.drain(rid, then="restart",
                              cause=f"autopilot:{trigger}")
        except ValueError as e:
            logger.warning("autopilot: drain-restart refused: %s", e)
            return
        emitted.append(self._emit("restart", trigger, rid,
                                  {"plan": "drain_then_rebuild"}, edge, now))

    def _scale_in(self, now: float, emitted: List[dict]) -> None:
        live = [rid for rid in self.router.replicas
                if self.router._dispatchable(rid)]
        if len(live) <= self.config.min_replicas:
            return
        if not self._may_act("scale_in", now):
            return
        views = {rid: self.router.replicas[rid].load() for rid in live}
        rid = min(live, key=lambda r: (views[r]["queue_depth"]
                                       + views[r]["active"], r))
        try:
            self.router.drain(rid, then="retire", cause="autopilot:idle")
        except ValueError as e:
            logger.warning("autopilot: scale-in refused: %s", e)
            return
        emitted.append(self._emit(
            "scale_in", "idle", rid,
            {"util": self._fleet_util(now),
             "fleet_size": len(live) - 1}, None, now))

    def _rebalance(self, drift: tuple, now: float,
                   emitted: List[dict]) -> None:
        if not self._may_act("rebalance", now):
            return
        _, want_role, qi, qb = drift
        donor_role = "decode" if want_role == "prefill" else "prefill"
        donors = [rid for rid, role in self.router.roles().items()
                  if role == donor_role and self.router._dispatchable(rid)]
        if not donors:
            return
        views = {rid: self.router.replicas[rid].load() for rid in donors}
        rid = min(donors, key=lambda r: (views[r]["queue_depth"]
                                         + views[r]["active"], r))
        try:
            self.router.drain(rid, then="re_role", role=want_role,
                              cause="autopilot:queue_mix")
        except ValueError as e:
            logger.warning("autopilot: rebalance refused: %s", e)
            return
        emitted.append(self._emit(
            "rebalance", "queue_mix", rid,
            {"to_role": want_role, "queued_interactive": qi,
             "queued_batch": qb}, None, now))

    # -- dynamic admission -------------------------------------------------

    def _effective_tenant_rate(self) -> Optional[float]:
        if self.config.tenant_rate is None or self._shed_scale <= 1.0:
            return None
        return self.config.tenant_rate / self._shed_scale

    def _apply_admission(self) -> None:
        """Push the current shed scale + tenant limits onto every live
        scheduler (idempotent; re-run each evaluation while tightened so
        rebuilt engines inherit the tightening)."""
        rate = self._effective_tenant_rate()
        for replica in self.router.replicas.values():
            if not replica.alive:
                continue
            sched = getattr(replica.engine, "scheduler", None)
            if sched is None or not hasattr(sched, "set_load_shed_scale"):
                continue
            sched.set_load_shed_scale(self._shed_scale)
            if self.config.tenant_rate is not None:
                if rate is not None:
                    sched.set_default_tenant_limit(
                        rate, self.config.tenant_burst)
                else:
                    sched.clear_tenant_limits()
