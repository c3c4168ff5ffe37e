"""PyTorch port: the fleet autopilot -- flap bounds, graceful drains,
scale out and in, drain-restart, dynamic admission, role rebalance, the
kill switch and the action ledger -- against the JAX package.

Every JAX oracle test of ``tests/test_autopilot.py`` has a counterpart
here, run as a scenario through both packages over a side's namespace
(:mod:`torch_fleet_pair`) on the same fake engine views, fake health
source and injected clock; the two logs -- the action sequences, the
``autopilot_action`` records without their wall times, the replica states,
the counters -- must be equal.  The last scenario drives a real FleetHealth
and a forced firing edge over the tiny Llama fleet: the drain-restart of
replica 1 under traffic loses nothing and gives JAX's tokens, and its
rebuilt engine's captures (eager keys on the CPU, booked by a compile
ledger) are warm-up, not a ``compile_storm``.
"""

import json

import numpy as np
import pytest

from torch_fleet_pair import (
    SIDES,
    by_client,
    engine_factory,
    fake_fleet,
    ns,
    pair,
    req,
)


@pytest.fixture(autouse=True)
def _no_plans():
    for side in SIDES:
        ns(side).clear_plan()
    yield
    for side in SIDES:
        ns(side).clear_plan()


def both(fn, *args):
    logs = {}
    for side in SIDES:
        logs[side] = []
        fn(ns(side), logs[side], *args)
    assert logs["port"] == logs["jax"]
    return logs


# -- fakes (the oracle's) ---------------------------------------------------------


class _FakeSched:
    def __init__(self):
        self.load_shed_scale = 1.0
        self.default_limit = None
        self.cleared = 0
        self.qi = 0
        self.qb = 0

    def set_load_shed_scale(self, scale):
        self.load_shed_scale = scale

    def set_default_tenant_limit(self, rate, burst=None):
        self.default_limit = (rate, burst)

    def clear_tenant_limits(self):
        self.cleared += 1
        self.default_limit = None

    def queue_depth_of(self, priority):
        return self.qi if priority == "interactive" else self.qb

    @property
    def queue_depth(self):
        return self.qi + self.qb

    @property
    def active_count(self):
        return 0


_SCHED_ENGINES: dict = {}


def sched_engine(n):
    if n.side not in _SCHED_ENGINES:
        class _SchedEngine(n.fake):
            def __init__(self, work=2, capacity=None):
                super().__init__(work=work, capacity=capacity)
                self.scheduler = _FakeSched()

        _SCHED_ENGINES[n.side] = _SchedEngine
    return _SCHED_ENGINES[n.side]


class _FakeHealth:
    def __init__(self):
        self.rules = []
        self.replaced = []
        self.retired = []
        self.downs = []

    def attach_router(self, router):
        pass

    def firing(self):
        return list(self.rules)

    def note_output(self, out, now=None):
        pass

    def step(self, router, now=None):
        pass

    def replica_down(self, rid, cause="", now=None):
        self.downs.append((rid, cause))

    def replica_up(self, rid, now=None):
        pass

    def replica_retired(self, rid, cause="", now=None, severity="page"):
        self.retired.append((rid, cause, severity))

    def replica_replaced(self, old, by, now=None):
        self.replaced.append((old, by))


def _edge(rule="slo_burn_fast_interactive", **kw):
    base = {"rule": rule, "key": "", "severity": "page", "window": 300.0,
            "observed": 20.0, "bound": 14.4, "since": 0.0}
    base.update(kw)
    return base


def _fleet(n, size=2, factory=None, **kw):
    return fake_fleet(n, size, factory=factory or sched_engine(n), **kw)


def _pilot(n, router=None, health=None, *, t=None, **cfg_kw):
    t = [0.0] if t is None else t
    router = router if router is not None else _fleet(n)
    health = health if health is not None else _FakeHealth()
    cfg_kw.setdefault("eval_every", 1)
    cfg_kw.setdefault("fire_after", 1)
    cfg_kw.setdefault("resolve_after", 1)
    cfg_kw.setdefault("idle_after", 10 ** 6)
    ap = n.Autopilot(router, health, config=n.AutopilotConfig(**cfg_kw),
                     clock=lambda: t[0], wall=lambda: t[0])
    return ap, router, health, t


def _acts(actions):
    return [(a["action"], a["trigger"], a["replica"], a["mono"],
             a["detail"], a["budget_remaining"]) for a in actions]


# -- config / construction ------------------------------------------------------


def sc_config_validation(n, log):
    for kw, match in ((dict(mode="yolo"), "mode"),
                      (dict(min_replicas=0), "min_replicas"),
                      (dict(min_replicas=3, max_replicas=2), "max_replicas"),
                      (dict(action_budget=0), "action_budget"),
                      (dict(shed_scale_step=1.0), "shed_scale_step")):
        with pytest.raises(ValueError, match=match) as e:
            n.AutopilotConfig(**kw)
        log.append(str(e.value))


def sc_registry_metrics_predeclared(n, log):
    ap, router, _, _ = _pilot(n)
    snap = router.registry.snapshot()
    for name in ("autopilot/actions_total", "autopilot/scale_outs_total",
                 "autopilot/drains_total", "autopilot/restarts_total"):
        assert name in snap
    assert snap["autopilot/mode"] == 1.0
    log.append(sorted(k for k in snap if k.startswith("autopilot/")))


# -- flap bounds ------------------------------------------------------------------


def _run_flap(n, evals, **cfg_kw):
    ap, router, health, t = _pilot(n, **cfg_kw)
    emitted = []
    for i in range(evals):
        health.rules = [_edge()] if i % 2 == 0 else []
        emitted += ap.step(now=t[0])
        t[0] += 1.0
    return ap, emitted


def sc_flapping_budget_bounded(n, log):
    zero_cd = {k: 0.0 for k in n.autopilot.DEFAULT_COOLDOWNS_S}
    naive, naive_actions = _run_flap(
        n, 60, cooldown_s=dict(zero_cd), action_budget=10 ** 6,
        budget_window_s=10 ** 6)
    bounded, bounded_actions = _run_flap(
        n, 60, cooldown_s=dict(zero_cd), action_budget=4,
        budget_window_s=10 ** 6)
    assert len(naive_actions) >= 30 and naive.suppressed == 0
    assert len(bounded_actions) == 4 and bounded.suppressed > 0
    assert bounded.budget_remaining(59.0) == 0
    log.append((_acts(naive_actions), _acts(bounded_actions),
                bounded.suppressed))


def sc_budget_rolling_window(n, log):
    zero_cd = {k: 0.0 for k in n.autopilot.DEFAULT_COOLDOWNS_S}
    _, actions = _run_flap(n, 60, cooldown_s=dict(zero_cd), action_budget=2,
                           budget_window_s=10.0)
    times = [a["mono"] for a in actions]
    assert len(times) > 2
    for i, t0 in enumerate(times):
        assert len([x for x in times[i:] if x - t0 <= 10.0]) <= 2
    log.append(times)


def sc_per_kind_cooldown(n, log):
    ap, router, health, t = _pilot(
        n, cooldown_s={"tighten": 10.0, "relax": 10.0},
        shed_scale_max=1024.0, action_budget=10 ** 6)
    health.rules = [_edge()]
    actions = []
    for _ in range(21):
        actions += ap.step(now=t[0])
        t[0] += 1.0
    assert [a["action"] for a in actions] == ["tighten"] * 3
    assert [a["mono"] for a in actions] == [0.0, 10.0, 20.0]
    log.append(_acts(actions))


def sc_hysteresis(n, log):
    ap, router, health, t = _pilot(n, fire_after=3)
    health.rules = [_edge()]
    seq = [ap.step(now=t[0])]
    t[0] += 1.0
    seq.append(ap.step(now=t[0]))
    health.rules = []
    t[0] += 1.0
    seq.append(ap.step(now=t[0]))
    health.rules = [_edge()]
    for _ in range(3):
        t[0] += 1.0
        seq.append(ap.step(now=t[0]))
    assert [[a["action"] for a in s] for s in seq] == \
        [[], [], [], [], [], ["tighten"]]
    log.append([_acts(s) for s in seq])


# -- graceful drain vs crash failover ------------------------------------------------


def sc_graceful_drain(n, log, tmp):
    health = n.FleetHealth(path=f"{tmp}/alerts.{n.side}.jsonl", rules=[],
                           replica_rules=lambda: [], eval_every=1)
    router = _fleet(n, 2, factory=lambda: sched_engine(n)(work=3),
                    health=health)
    gids = [router.submit(req(n, i)) for i in range(4)]
    router.step()
    assert {g for g in gids if router._tracked[g].replica_id == 0}
    router.drain(0, then="retire", cause="test-scale-in")
    assert router.draining() == {0: "retire"}
    extra = [router.submit(req(n, 100 + i)) for i in range(2)]
    outs = router.run_until_complete(max_steps=50)
    assert len(outs) == 6 and all(o.state == "finished" for o in outs)
    assert all(router._tracked[g].replica_id == 1 for g in extra)
    reg = router.registry
    assert reg.counter("router/requeued_total").value == 0
    assert all(router._tracked[g].requeues == 0 for g in gids)
    assert reg.counter("router/drains_total").value == 1
    assert reg.counter("router/retired_total").value == 1
    assert router.replicas[0].state is n.ReplicaState.RETIRED
    edges = [e for e in health.edges() if e["rule"] == "replica_retired"]
    assert len(edges) == 1 and edges[0]["severity"] == "warn"
    assert edges[0]["state"] == "firing"
    log.append(([o.request_id for o in outs],
                [(e["rule"], e["state"], e["severity"]) for e in edges]))
    router.close()
    health.close()


def sc_crash_failover_requeues(n, log):
    router = fake_fleet(n, 2, factory=lambda: n.fake(work=3))
    for i in range(4):
        router.submit(req(n, i))
    router.step()
    router.replicas[0].engine.crash_next = True
    router.replicas[0].backoff = type(router.replicas[0].backoff)(
        max_restarts=0)
    outs = router.run_until_complete(max_steps=80)
    assert len(outs) == 4
    assert router.registry.counter("router/requeued_total").value > 0
    log.append(([o.request_id for o in outs],
                router.registry.counter("router/requeued_total").value))


def sc_drain_validation(n, log):
    router = _fleet(n, 2)
    for kw, match in ((dict(replica_id=0, then="explode"),
                       "unknown drain plan"),
                      (dict(replica_id=0, then="re_role"), "requires role="),
                      (dict(replica_id=99), "unknown replica")):
        with pytest.raises(ValueError, match=match):
            router.drain(**kw)
    router.drain(0, then="retire")
    with pytest.raises(ValueError, match="already draining"):
        router.drain(0, then="restart")
    with pytest.raises(ValueError, match="last dispatchable"):
        router.drain(1, then="retire")
    router.step()
    with pytest.raises(ValueError, match="only a live replica"):
        router.drain(0, then="restart")
    log.append(router.replicas[0].state.value)
    router.close()


def sc_add_replica_validation(n, log):
    router = _fleet(n, 1)
    with pytest.raises(ValueError, match="already in the fleet"):
        router.add_replica(n.Replica(0, sched_engine(n), backoff_base_s=0.0))

    class Wide(sched_engine(n)):
        C = 16

    with pytest.raises(ValueError, match="heterogeneous"):
        router.add_replica(n.Replica(7, Wide, backoff_base_s=0.0))
    assert sorted(router.replicas) == [0]
    log.append(sorted(router.replicas))
    router.close()


# -- scale in / restart / scale out ------------------------------------------------


def sc_scale_in_idle(n, log):
    ap, router, health, t = _pilot(n, router=_fleet(n, 3), idle_after=3,
                                   min_replicas=2)
    actions = []
    for _ in range(10):
        actions += ap.step(now=t[0])
        router.step()
        t[0] += 1.0
    assert [a["action"] for a in actions] == ["scale_in"]
    assert actions[0]["trigger"] == "idle"
    assert len([r for r in router.replicas.values()
                if r.state is n.ReplicaState.RETIRED]) == 1
    assert router.registry.counter("autopilot/scale_ins_total").value == 1
    assert router.registry.counter("autopilot/drains_total").value == 1
    log.append(_acts(actions))


def sc_busy_fleet_never_idle(n, log):
    ap, router, health, t = _pilot(n, router=_fleet(n, 2), idle_after=1,
                                   min_replicas=1)
    for i in range(6):
        router.submit(req(n, i))
    router.step()
    assert ap.step(now=t[0]) == []
    log.append(len([r for r in router.replicas.values() if r.alive]))


def sc_drain_restart_rotates(n, log):
    ap, router, health, t = _pilot(n, fire_after=2)
    old = router.replicas[1].engine
    budget = router.replicas[1].backoff.restarts
    health.rules = [_edge(rule="kv_headroom", replica=1)]
    assert ap.step(now=t[0]) == []
    t[0] += 1.0
    actions = ap.step(now=t[0])
    assert [a["action"] for a in actions] == ["restart"]
    assert actions[0]["replica"] == 1
    assert actions[0]["edge"]["rule"] == "kv_headroom"
    assert router.draining() == {1: "restart"}
    router.step()
    assert router.replicas[1].alive and router.replicas[1].engine is not old
    assert router.replicas[1].backoff.restarts == budget
    assert router.registry.counter("router/restarts_total").value == 1
    log.append(_acts(actions))


def sc_drain_restart_refuses_last(n, log):
    ap, router, health, t = _pilot(n, router=_fleet(n, 1), fire_after=1)
    health.rules = [_edge(rule="compile_storm")]
    assert ap.step(now=t[0]) == []
    assert router.draining() == {}
    log.append(router.draining())


def sc_scale_out_on_burn(n, log):
    ap, router, health, t = _pilot(n, fire_after=2, max_replicas=3)
    ap.replica_factory = lambda rid: n.Replica(rid, sched_engine(n),
                                               backoff_base_s=0.0)
    health.rules = [_edge()]
    ap.step(now=t[0])
    t[0] += 1.0
    first = ap.step(now=t[0])
    assert [a["action"] for a in first] == ["scale_out"]
    assert first[0]["replica"] == 2 and sorted(router.replicas) == [0, 1, 2]
    assert first[0]["detail"]["fleet_size"] == 3 and ap.shed_scale == 1.0
    t[0] += 100.0
    ap.step(now=t[0])
    t[0] += 1.0
    second = ap.step(now=t[0])
    assert [a["action"] for a in second] == ["tighten"]
    assert ap.shed_scale == 2.0
    log.append((_acts(first), _acts(second)))


def sc_scale_out_replaces_retired(n, log):
    ap, router, health, t = _pilot(n, fire_after=1, max_replicas=4)
    ap.replica_factory = lambda rid: n.Replica(rid, sched_engine(n),
                                               backoff_base_s=0.0)
    router.drain(0, then="retire")
    router.step()
    assert router.replicas[0].state is n.ReplicaState.RETIRED
    health.rules = [_edge()]
    actions = ap.step(now=t[0])
    assert [a["action"] for a in actions] == ["scale_out"]
    assert actions[0]["detail"]["replaces"] == [0]
    assert health.replaced == [(0, 2)]
    log.append(_acts(actions))


def sc_scale_out_mismatch_tightens(n, log):
    class Wide(sched_engine(n)):
        C = 16

    ap, router, health, t = _pilot(n, fire_after=1, max_replicas=8)
    ap.replica_factory = lambda rid: n.Replica(rid, Wide, backoff_base_s=0.0)
    health.rules = [_edge()]
    actions = ap.step(now=t[0])
    assert [a["action"] for a in actions] == ["tighten"]
    assert sorted(router.replicas) == [0, 1] and ap.shed_scale == 2.0
    t[0] += 1.0
    later = ap.step(now=t[0])
    assert all(a["action"] != "scale_out" for a in later)
    log.append((_acts(actions), _acts(later)))


# -- dynamic admission -------------------------------------------------------------


def sc_tighten_and_relax(n, log):
    ap, router, health, t = _pilot(n, fire_after=2, resolve_after=2,
                                   tenant_rate=8.0, tenant_burst=4.0)
    scheds = [r.engine.scheduler for r in router.replicas.values()]
    health.rules = [_edge()]
    ap.step(now=t[0])
    t[0] += 1.0
    tighten = ap.step(now=t[0])
    assert [a["action"] for a in tighten] == ["tighten"]
    assert tighten[0]["detail"] == {"shed_scale": 2.0, "tenant_rate": 4.0}
    assert all(s.load_shed_scale == 2.0 for s in scheds)
    assert all(s.default_limit == (4.0, 4.0) for s in scheds)
    health.rules = []
    t[0] += 100.0
    assert ap.step(now=t[0]) == []
    t[0] += 1.0
    relax = ap.step(now=t[0])
    assert [a["action"] for a in relax] == ["relax"] and ap.shed_scale == 1.0
    assert all(s.load_shed_scale == 1.0 for s in scheds)
    assert all(s.default_limit is None and s.cleared == 1 for s in scheds)
    log.append((_acts(tighten), _acts(relax)))


def sc_tightening_reasserted(n, log):
    ap, router, health, t = _pilot(n, fire_after=1)
    health.rules = [_edge()]
    ap.step(now=t[0])
    assert ap.shed_scale == 2.0
    router.drain(1, then="restart")
    router.step()
    fresh = router.replicas[1].engine.scheduler
    assert fresh.load_shed_scale == 1.0
    t[0] += 1.0
    ap.step(now=t[0])
    assert fresh.load_shed_scale == 2.0
    log.append(fresh.load_shed_scale)


def sc_token_bucket(n, log):
    b = n.TokenBucket(rate=2.0, burst=4.0)
    assert b.tokens == 4.0
    got = [b.consume(1.0, now=0.0) for _ in range(5)]
    got += [b.consume(1.0, now=0.5), b.consume(1.0, now=0.5),
            b.consume(1.0, now=100.0)]
    assert got == [True] * 4 + [False, True, False, True]
    assert b.tokens == 3.0
    with pytest.raises(ValueError):
        n.TokenBucket(rate=0.0, burst=4.0)
    log.append(got)


def sc_tenant_rate_limit(n, log):
    sched = n.SlotScheduler(num_slots=2, context_len=8, max_total_len=16)
    sched.set_default_tenant_limit(1.0, 2.0)
    sched.submit(req(n, 1), now=0.0)
    sched.submit(req(n, 2), now=0.0)
    with pytest.raises(n.RateLimited):
        sched.submit(req(n, 3), now=0.0)
    assert isinstance(n.RateLimited("x"), n.BackpressureError)
    sched.submit(req(n, 4), now=1.0)
    sched.set_tenant_limit(0, rate=1.0, burst=10.0)
    with pytest.raises(n.RateLimited):
        sched.submit(req(n, 5), now=1.0)
    sched.clear_tenant_limits()
    sched.submit(req(n, 6), now=1.0)
    log.append(sched.queue_depth)


def sc_load_shed_scale_validation(n, log):
    sched = n.SlotScheduler(num_slots=1, context_len=8, max_total_len=16)
    with pytest.raises(ValueError, match="load_shed_scale"):
        sched.set_load_shed_scale(0.5)
    sched.set_load_shed_scale(4.0)
    log.append(sched.load_shed_scale)


# -- role rebalance -----------------------------------------------------------------


def _roles_router(n, count):
    class RolesRouter(n.FleetRouter):
        def roles(self):
            return {rid: r.role for rid, r in self.replicas.items()}

    return RolesRouter(
        [n.Replica(i, sched_engine(n), backoff_base_s=0.0,
                   role=("prefill" if i == 0 else "decode"))
         for i in range(count)], policy="round_robin")


def sc_rebalance_on_drift(n, log):
    ap, router, health, t = _pilot(n, router=_roles_router(n, 4),
                                   fire_after=2, rebalance_min_queued=8)
    router.replicas[0].engine.scheduler.qi = 9
    router.replicas[0].engine.scheduler.qb = 1
    assert ap.step(now=t[0]) == []
    t[0] += 1.0
    actions = ap.step(now=t[0])
    assert [a["action"] for a in actions] == ["rebalance"]
    assert actions[0]["trigger"] == "queue_mix"
    assert actions[0]["detail"]["to_role"] == "prefill"
    rid = actions[0]["replica"]
    assert router.replicas[rid].role == "decode"
    router.step()
    assert router.replicas[rid].role == "prefill"
    assert router.registry.counter("autopilot/rebalances_total").value == 1
    log.append(_acts(actions))


def sc_rebalance_needs_backlog(n, log):
    ap, router, health, t = _pilot(n, router=_roles_router(n, 2),
                                   fire_after=1, rebalance_min_queued=8)
    router.replicas[0].engine.scheduler.qi = 3
    assert ap.step(now=t[0]) == []
    router.replicas[0].engine.scheduler.qi = 20
    t[0] += 1.0
    assert ap.step(now=t[0]) == []
    assert router.draining() == {}
    log.append(router.draining())


def sc_plain_router_no_rebalance(n, log):
    ap, router, health, t = _pilot(n, fire_after=1, rebalance_min_queued=0)
    assert ap._queue_mix_drift() is None
    log.append(None)


# -- kill switch, cadence, healthz ---------------------------------------------------


def sc_kill_switch(n, log):
    ap, router, health, t = _pilot(n, fire_after=1)
    scheds = [r.engine.scheduler for r in router.replicas.values()]
    health.rules = [_edge()]
    ap.step(now=t[0])
    assert ap.shed_scale == 2.0
    ap.set_mode("page_only")
    assert ap.shed_scale == 1.0
    assert all(s.load_shed_scale == 1.0 for s in scheds)
    assert router.registry.gauge("autopilot/mode").value == 0.0
    before = n.autopilot.ACTIONS_EVALUATED
    t[0] += 100.0
    assert ap.step(now=t[0]) == []
    assert n.autopilot.ACTIONS_EVALUATED == before + 1
    assert ap.healthz_fields()["mode"] == "page_only"
    ap.set_mode("auto")
    t[0] += 1.0
    acts = ap.step(now=t[0])
    assert [a["action"] for a in acts] == ["tighten"]
    with pytest.raises(ValueError, match="mode"):
        ap.set_mode("off")
    log.append(_acts(acts))


def sc_cadence_skips(n, log):
    ap, router, health, t = _pilot(n, eval_every=4, fire_after=1)
    health.rules = [_edge()]
    assert [ap.step(now=float(i)) for i in range(3)] == [[], [], []]
    assert ap._streaks == {}
    acts = ap.step(now=3.0)
    assert [a["action"] for a in acts] == ["tighten"]
    log.append(_acts(acts))


def sc_healthz_fields(n, log):
    ap, router, health, t = _pilot(n, fire_after=1, action_budget=8)
    assert ap.healthz_fields() == {
        "mode": "auto", "shed_scale": 1.0, "last_action": None,
        "actions_in_window": 0, "action_budget": 8, "budget_remaining": 8,
        "suppressed": 0}
    health.rules = [_edge()]
    ap.step(now=t[0])
    doc = ap.healthz_fields()
    assert doc["last_action"]["action"] == "tighten"
    assert doc["budget_remaining"] == 7
    doc["last_action"].pop("time", None)
    log.append(doc)


# -- the action ledger ------------------------------------------------------------------


def sc_actions_ledger(n, log, tmp):
    path = f"{tmp}/autopilot_actions.{n.side}.jsonl"
    ap, router, health, t = _pilot(n, fire_after=1)
    ap.sink = n.autopilot._ActionSink(path)
    assert n.validate_jsonl("autopilot_action", path) == 0
    health.rules = [_edge()]
    ap.step(now=t[0])
    health.rules = []
    t[0] += 100.0
    ap.step(now=t[0])
    t[0] += 1.0
    ap.step(now=t[0])
    ap.close()
    assert n.validate_jsonl("autopilot_action", path) == len(ap.actions) == 2
    records = [json.loads(line) for line in open(path)]
    assert [r["action"] for r in records] == ["tighten", "relax"]
    assert all(r["schema"] == n.AUTOPILOT_ACTION_SCHEMA for r in records)
    assert records[0]["edge"]["rule"] == "slo_burn_fast_interactive"
    assert records[1]["edge"] is None
    for r in records:
        n.validate_record("autopilot_action", r)
        r.pop("time")
    log.append(records)


def sc_action_record_rejects_malformed(n, log):
    good = {"schema": n.AUTOPILOT_ACTION_SCHEMA, "time": 1.0, "mono": 1.0,
            "action": "tighten", "trigger": "slo_burn_fast_interactive",
            "mode": "auto", "replica": -1, "detail": {}, "edge": None,
            "budget_remaining": 7}
    n.validate_record("autopilot_action", good)
    missing = dict(good)
    del missing["budget_remaining"]
    with pytest.raises(ValueError, match="missing"):
        n.validate_record("autopilot_action", missing)
    with pytest.raises(ValueError):
        n.validate_record("autopilot_action", dict(good, replica=True))
    log.append(n.AUTOPILOT_ACTION_SCHEMA)


def sc_autopilot_off_zero_evaluations(n, log):
    before = n.autopilot.ACTIONS_EVALUATED
    router = _fleet(n, 2, factory=lambda: sched_engine(n)(work=2))
    for i in range(6):
        router.submit(req(n, i))
    outs = router.run_until_complete(max_steps=60)
    assert len(outs) == 6
    router.close()
    assert n.autopilot.ACTIONS_EVALUATED == before
    log.append(len(outs))


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_config_validation, sc_registry_metrics_predeclared,
    sc_flapping_budget_bounded, sc_budget_rolling_window,
    sc_per_kind_cooldown, sc_hysteresis, sc_crash_failover_requeues,
    sc_drain_validation, sc_add_replica_validation, sc_scale_in_idle,
    sc_busy_fleet_never_idle, sc_drain_restart_rotates,
    sc_drain_restart_refuses_last, sc_scale_out_on_burn,
    sc_scale_out_replaces_retired, sc_scale_out_mismatch_tightens,
    sc_tighten_and_relax, sc_tightening_reasserted, sc_token_bucket,
    sc_tenant_rate_limit, sc_load_shed_scale_validation,
    sc_rebalance_on_drift, sc_rebalance_needs_backlog,
    sc_plain_router_no_rebalance, sc_kill_switch, sc_cadence_skips,
    sc_healthz_fields, sc_action_record_rejects_malformed,
    sc_autopilot_off_zero_evaluations)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_autopilot_scenario_matches_jax(name):
    both(SCENARIOS[name])


@pytest.mark.parametrize("name", ["graceful_drain", "actions_ledger"])
def test_autopilot_artifact_scenario_matches_jax(name, tmp_path):
    both({"graceful_drain": sc_graceful_drain,
          "actions_ledger": sc_actions_ledger}[name], str(tmp_path))


def test_forced_edge_drain_restarts_replica_under_traffic(tmp_path):
    """The chip phase's autopilot path on the tiny Llama: a real
    FleetHealth, one forced ``compile_storm`` firing edge on replica 1
    (fed as JAX ``tests/test_weights.py:406`` feeds it), the drain-restart
    under traffic, zero requests lost, JAX's tokens and action records;
    the rebuilt engine takes its predecessor's phases as warm-up, so the
    compile ledger books no storm."""
    cfg = pair()[4]
    rs = np.random.RandomState(41)
    prompts = [rs.randint(1, cfg.vocab_size, size=int(rs.randint(3, 8)))
               .tolist() for _ in range(8)]

    def run(n, log):
        led = n.CompileLedger()
        health = n.FleetHealth(path=str(tmp_path / f"alerts.{n.side}.jsonl"),
                               eval_every=1)
        router = n.FleetRouter(
            [n.Replica(i, engine_factory(n.side, compile_ledger=led),
                       backoff_base_s=0.0) for i in range(2)],
            policy="round_robin", health=health)
        path = str(tmp_path / f"autopilot_actions.{n.side}.jsonl")
        pilot = n.Autopilot(router, health,
                            config=n.AutopilotConfig(fire_after=1),
                            actions_path=path)
        for i in range(2):
            router.submit(n.Request(request_id=100 + i, prompt_ids=[1, 2, 3],
                                    max_new_tokens=2))
        router.run_until_complete(max_steps=100)
        led.declare_warmup_done()
        outs = {}
        for i, p in enumerate(prompts):
            router.submit(n.Request(request_id=i, prompt_ids=p,
                                    max_new_tokens=4))
        for o in router.step():
            outs[o.request_id] = o
        emitted = []
        pilot._drain_restart(_edge(rule="compile_storm", replica=1,
                                   state="firing"), now=0.0, emitted=emitted)
        assert [a["action"] for a in emitted] == ["restart"]
        assert router.draining() == {1: "restart"}
        for o in router.run_until_complete(max_steps=300):
            outs[o.request_id] = o
        got = by_client(router, outs)
        assert len(got) == 8 and all(v[1] == "finished"
                                     for v in got.values())
        assert router.registry.counter("router/restarts_total").value == 1
        assert led.storms == 0
        pilot.close()
        assert n.validate_jsonl("autopilot_action", path) == 1
        recs = [json.loads(line) for line in open(path)]
        for r in recs:
            r.pop("time")
        log.append((got, recs))
        router.close()
        health.close()

    both(run)
