"""PyTorch port: the serving fleet -- ids, routing policies, replicas,
failover, the router's ledger and its artifacts -- against the JAX package.

Every JAX oracle test of ``tests/test_fleet.py`` has a counterpart here
(its two CLI rungs excepted: the port has no ``runner.py serve`` or
``fleet_bench`` yet).  Each runs as a scenario over a side's namespace
(:mod:`torch_fleet_pair`), once through the JAX package and once through
the port, with the oracle's assertions on both, and the two logs --
placements, ids, requeues, outputs, counters, records without their wall
times -- must be equal.

- Host-side scenarios over the oracle's engine fake: id allocation, chain
  fingerprints, shadows, every policy (``random`` draws from numpy's
  ``RandomState(seed)`` on both sides), the restart backoff, the replica
  lifecycle, the driver loop, the router's failover, backpressure,
  cancels, FCFS drain, retention, ``router_stats`` and a randomized churn
  whose whole output sequence must be equal.
- The tiny fp32 Llama of the oracles (page 4, 9 pages, B = 2; the weights
  moved by ``llama_params_from_jax``): greedy tokens per client id and the
  placements equal JAX's under all four policies; a replica killed at
  ``fleet/replica_step`` gives JAX's tokens, requeues, restarts, router
  records and ``replica_down``/``replica_up`` alert edges; the shadow
  resyncs after a restart.  Tokens are compared exactly (greedy argmax over
  fp32 logits that agree within 1e-4 on this pair).
- What JAX cannot be held to: sampled tokens (threefry and Philox differ),
  so the port's sampled fleet is held to itself across fleet shapes.
"""

import json

import numpy as np
import pytest

from neuronx_distributed_tpu_torch.trace.engine import request_key
from torch_fleet_pair import (
    SIDES,
    by_client,
    engine_factory,
    fake_fleet,
    ns,
    pair,
    req,
    shared_prompts,
)


@pytest.fixture(autouse=True)
def _no_plans():
    for side in SIDES:
        ns(side).clear_plan()
    yield
    for side in SIDES:
        ns(side).clear_plan()


def both(fn, *args):
    """Run ``fn(n, log, *args)`` on each side; the logs must be equal."""
    logs = {}
    for side in SIDES:
        logs[side] = []
        fn(ns(side), logs[side], *args)
    assert logs["port"] == logs["jax"]
    return logs["port"]


def _no_time(path):
    recs = [json.loads(line) for line in open(path)]
    for r in recs:
        r.pop("time", None)
    return recs


# -- ids, fingerprints, shadows ---------------------------------------------------


def sc_request_id_allocator(n, log):
    a = n.RequestIdAllocator(namespace=3)
    ids = [a.next_id() for _ in range(100)]
    assert len(set(ids)) == 100 and all(i >> 32 == 3 for i in ids)
    assert [i & 0xFFFFFFFF for i in ids] == list(range(100))
    b = n.RequestIdAllocator(namespace=4)
    assert not set(ids) & {b.next_id() for _ in range(100)}
    for bad in (-1, 2 ** 31, 0):
        with pytest.raises(ValueError, match="namespace"):
            n.RequestIdAllocator(namespace=bad)
    log.append(ids)


def sc_chain_fingerprints(n, log):
    keys = n.prefix.page_keys(np.arange(1, 9, dtype=np.int64),
                              np.ones(8, np.int32), 4)
    fps = n.prefix.prefix_fingerprints(keys)
    assert len(fps) == 2 and len(set(fps)) == 2
    assert fps[0] == n.prefix.chain_fingerprint(0, keys[0])
    assert fps[1] == n.prefix.chain_fingerprint(fps[0], keys[1])
    other = n.prefix.page_keys(np.arange(2, 10, dtype=np.int64),
                               np.ones(8, np.int32), 4)
    assert n.prefix.prefix_fingerprints(other)[0] != fps[0]
    alloc = n.allocator.BlockAllocator(8)
    idx = n.prefix.PrefixIndex(alloc)
    idx.insert(keys, list(alloc.alloc(2)))
    assert idx.chain_fingerprints() == set(fps)
    log.append(fps)


def sc_shadow_match_depth(n, log):
    sh = n.ReplicaShadow()
    sh.credit([10, 20, 30])
    log.append([sh.match_depth([10, 20, 30, 40]), sh.match_depth([10, 99, 30]),
                sh.match_depth([99])])
    assert log[-1] == [3, 1, 0]
    sh.resync({10})
    assert sh.match_depth([10, 20]) == 1
    sh.clear()
    assert sh.match_depth([10]) == 0


# -- routing policies --------------------------------------------------------------


def _views(loads):
    return {rid: {"replica_id": rid, "queue_depth": q, "active": a,
                  "slots": 2, "pages_free": pf, "host_blocked_ms_mean": None}
            for rid, (q, a, pf) in loads.items()}


def sc_round_robin(n, log):
    p = n.RoundRobinPolicy()
    log.append([p.choose([0, 2, 5], {}, {}, []).replica_id for _ in range(6)])
    assert log[-1] == [0, 2, 5, 0, 2, 5]


def sc_random_seeded(n, log):
    for seed in (3, 11):
        p1, p2 = n.RandomPolicy(seed=seed), n.RandomPolicy(seed=seed)
        picks = [p1.choose([0, 1, 2], {}, {}, []).replica_id
                 for _ in range(20)]
        assert picks == [p2.choose([0, 1, 2], {}, {}, []).replica_id
                         for _ in range(20)]
        log.append(picks)


def sc_least_loaded(n, log):
    views = _views({0: (4, 2, 10), 1: (0, 1, 10), 2: (0, 1, 20)})
    log.append(n.LeastLoadedPolicy().choose([0, 1, 2], views, {},
                                            []).replica_id)
    assert log[-1] == 2
    assert n.load_score(views[0]) > n.load_score(views[1])
    log.append([n.load_score(v) for v in views.values()])


def sc_prefix_affinity(n, log):
    shadows = {r: n.ReplicaShadow() for r in range(3)}
    shadows[1].credit([10, 20])
    shadows[2].credit([10])
    views = _views({0: (0, 0, 8), 1: (9, 9, 0), 2: (0, 0, 8)})
    p = n.PrefixAffinityPolicy()
    d = p.choose([0, 1, 2], views, shadows, [10, 20, 30])
    assert d.replica_id == 1 and d.affinity_pages == 2
    log.append((d.replica_id, d.affinity_pages))
    d = p.choose([0, 1, 2], views, shadows, [99])
    assert d.replica_id in (0, 2) and d.affinity_pages == 0
    log.append((d.replica_id, d.affinity_pages))
    log.append(p.choose([0, 1, 2], views, shadows, []).affinity_pages)


def sc_make_policy(n, log):
    assert isinstance(n.make_policy("least_loaded"), n.LeastLoadedPolicy)
    p = n.RoundRobinPolicy()
    assert n.make_policy(p) is p
    with pytest.raises(ValueError, match="unknown routing policy"):
        n.make_policy("fastest")
    log.append(sorted(n.POLICIES))


# -- restart backoff, replica lifecycle, driver -------------------------------------


def sc_restart_backoff(n, log):
    b = n.RestartBackoff(max_restarts=3, base_s=0.5, max_s=1.5)
    log.append([b.next_delay() for _ in range(3)])
    assert log[-1] == [0.5, 1.0, 1.5]
    assert b.exhausted and b.next_delay() is None
    with pytest.raises(ValueError):
        n.RestartBackoff(max_restarts=-1)


def sc_replica_lifecycle(n, log):
    t = [0.0]
    rep = n.Replica(0, n.fake, max_restarts=2, backoff_base_s=1.0,
                    backoff_max_s=10.0, clock=lambda: t[0])
    first = rep.engine
    log.append(rep.mark_dead("crash"))
    assert rep.state is n.ReplicaState.DEAD and first.closed
    with pytest.raises(RuntimeError, match="must not dispatch"):
        rep.submit(req(n, 0))
    assert not rep.try_restart()
    t[0] = 1.5
    assert rep.try_restart() and rep.alive and rep.engine is not first
    log.append(rep.mark_dead("crash"))
    t[0] = 10.0
    assert rep.try_restart()
    log.append(rep.mark_dead("crash"))
    assert log == [1.0, 2.0, None]
    assert rep.state is n.ReplicaState.RETIRED and not rep.try_restart()


def sc_replica_factory_failure(n, log):
    calls = [0]

    def flaky():
        calls[0] += 1
        if calls[0] == 2:
            raise RuntimeError("oom")
        return n.fake()

    t = [0.0]
    rep = n.Replica(0, flaky, max_restarts=2, backoff_base_s=1.0,
                    clock=lambda: t[0])
    rep.mark_dead("crash")
    t[0] = 100.0
    assert not rep.try_restart()
    assert rep.state is n.ReplicaState.DEAD and rep.backoff.restarts == 2
    t[0] = 300.0
    assert rep.try_restart() and rep.alive
    log.append((rep.last_cause, rep.backoff.restarts, calls[0]))


def sc_poisson_arrivals(n, log):
    rs = np.random.RandomState(0)
    arr = n.poisson_arrivals(10, 5.0, rs)
    assert arr[0] == 0.0 and len(arr) == 10 and (np.diff(arr) >= 0).all()
    assert (n.poisson_arrivals(4, float("inf"), rs) == 0.0).all()
    with pytest.raises(ValueError):
        n.poisson_arrivals(0, 5.0, rs)
    log.append([round(float(a), 12) for a in arr])


def sc_replay_any_target(n, log):
    eng = n.fake(work=1)
    outs = n.replay(eng, [0.0, 0.0], [req(n, 0), req(n, 1)],
                    clock=iter(np.arange(0, 100, 0.1)).__next__,
                    sleep=lambda s: None)
    log.append(sorted(outs))

    class Crashy(n.fake):
        dumped = None

        def step(self):
            raise RuntimeError("boom")

        def dump_flight(self, reason):
            self.dumped = reason

    eng = Crashy()
    with pytest.raises(RuntimeError, match="boom"):
        n.replay(eng, [0.0], [req(n, 0)], clock=lambda: 1.0,
                 sleep=lambda s: None)
    log.append(eng.dumped)
    assert eng.dumped == "crash:RuntimeError"
    with pytest.raises(ValueError, match="pair up"):
        n.replay(eng, [0.0], [])


# -- the router over fakes -----------------------------------------------------------


def sc_router_rekeys(n, log):
    router = fake_fleet(n)
    gid = router.submit(req(n, 77))
    assert gid >> 32 == 1 and router.client_id(gid) == 77
    outs = router.run_until_complete(max_steps=50)
    log.append([(o.request_id, o.state) for o in outs])
    router.close()


def sc_router_rejects_bad_fleets(n, log):
    with pytest.raises(ValueError, match="at least one"):
        n.FleetRouter([])
    with pytest.raises(ValueError, match="duplicate"):
        n.FleetRouter([n.Replica(0, n.fake), n.Replica(0, n.fake)])

    class Wide(n.fake):
        C = 16

    class Short(n.fake):
        T = 64

    for other in (Wide, Short):
        with pytest.raises(ValueError, match="heterogeneous") as e:
            n.FleetRouter([n.Replica(0, n.fake), n.Replica(1, other)])
        log.append(str(e.value))


def sc_router_failover(n, log):
    router = fake_fleet(n, 2, factory=lambda: n.fake(work=3))
    gids = [router.submit(req(n, i)) for i in range(4)]
    outs = router.step()
    router.replicas[0].engine.crash_next = True
    outs += router.step()
    snap = router.registry.snapshot()
    assert snap["router/failovers_total"] == 1.0
    assert snap["router/requeued_total"] >= 1.0
    outs += router.run_until_complete(max_steps=100)
    router.assert_invariants()
    assert {o.request_id for o in outs} == set(gids)
    assert all(o.state == "finished" for o in outs)
    log.append([(o.request_id, router._tracked[o.request_id].replica_id,
                 router._tracked[o.request_id].requeues) for o in outs])
    log.append({k: v for k, v in snap.items() if k.startswith("router/")})
    router.close()


def sc_router_backpressure(n, log):
    router = fake_fleet(n, 1, factory=lambda: n.fake(capacity=1),
                        max_pending=1)
    router.submit(req(n, 0))
    router.submit(req(n, 1))
    assert len(router._pending) == 1
    with pytest.raises(n.BackpressureError, match="router backlog full"):
        router.submit(req(n, 2))
    outs = router.run_until_complete(max_steps=100)
    assert {o.state for o in outs} == {"finished"} and len(outs) == 2
    log.append([o.request_id for o in outs])
    router.assert_invariants()
    router.close()


def sc_requeue_bypasses_max_pending(n, log):
    router = fake_fleet(n, 1, factory=lambda: n.fake(work=5), max_pending=0)
    gids = [router.submit(req(n, i)) for i in range(3)]
    router.replicas[0].engine.crash_next = True
    outs = router.step()
    router.assert_invariants()
    outs += router.run_until_complete(max_steps=200)
    assert {o.request_id for o in outs} == set(gids)
    assert all(o.state == "finished" for o in outs)
    log.append([o.request_id for o in outs])
    router.close()


def sc_admission_error_no_ghost(n, log):
    class Rejecting(n.fake):
        def submit(self, r):
            raise n.AdmissionError("never fits")

    router = fake_fleet(n, 1, factory=Rejecting)
    r = req(n, 5)
    with pytest.raises(n.AdmissionError):
        router.submit(r)
    assert router.inflight == 0 and r.request_id == 5
    router.assert_invariants()
    log.append(len(router._tracked))
    router.close()


def sc_total_capacity_loss(n, log):
    router = fake_fleet(n, 1, factory=lambda: n.fake(capacity=1))
    router.replicas[0].backoff.max_restarts = 0
    router.submit(req(n, 0, max_new=5))
    gid1 = router.submit(req(n, 1))
    router.replicas[0].engine.crash_next = True
    outs = router.run_until_complete(max_steps=50)
    router.assert_invariants()
    by_id = {o.request_id: o for o in outs}
    assert by_id[gid1].state == "failed"
    assert by_id[gid1].finish_reason == "fleet_unavailable"
    assert len(by_id) == 2
    with pytest.raises(n.FleetUnavailableError):
        router.submit(req(n, 2))
    log.append(sorted((o.request_id, o.state, o.finish_reason) for o in outs))
    router.close()


def sc_cancel_pending_and_placed(n, log):
    router = fake_fleet(n, 1, factory=lambda: n.fake(capacity=1))
    g0 = router.submit(req(n, 0))
    g1 = router.submit(req(n, 1))
    assert router.cancel(g1) and router.cancel(g0)
    assert not router.cancel(999)
    outs = router.run_until_complete(max_steps=50)
    states = {o.request_id: o.state for o in outs}
    assert states[g1] == "cancelled" and states[g0] == "cancelled"
    router.assert_invariants()
    log.append(sorted(states.items()))
    router.close()


def sc_requeue_rejected_fails_terminally(n, log):
    class Hostile(n.fake):
        hostile = False

        def submit(self, r):
            if self.hostile:
                raise n.AdmissionError("never fits here")
            super().submit(r)

    router = fake_fleet(n, 2, factory=lambda: Hostile(work=4))
    g0 = router.submit(req(n, 0))
    g1 = router.submit(req(n, 1))
    router.replicas[1].engine.hostile = True
    router.replicas[0].engine.crash_next = True
    outs = router.step()
    outs += router.run_until_complete(max_steps=100)
    by = {o.request_id: o for o in outs}
    assert by[g0].state == "failed"
    assert by[g0].finish_reason == "requeue_rejected:AdmissionError"
    assert by[g1].state == "finished"
    router.assert_invariants()
    log.append(sorted((k, o.state, o.finish_reason) for k, o in by.items()))
    router.close()


def sc_granted_cancel_survives_failover(n, log):
    router = fake_fleet(n, 2, factory=lambda: n.fake(work=5))
    g0 = router.submit(req(n, 0))
    outs = router.step()
    assert router.cancel(g0)
    router.replicas[0].engine.crash_next = True
    outs += router.step()
    outs += router.run_until_complete(max_steps=100)
    by = {o.request_id: o for o in outs}
    assert by[g0].state == "cancelled" and not by[g0].token_ids
    assert router.registry.snapshot()["router/requeued_total"] == 0.0
    router.assert_invariants()
    log.append([(o.request_id, o.state) for o in outs])
    router.close()


def sc_drain_preserves_fcfs_head(n, log):
    router = fake_fleet(n, 1, factory=lambda: n.fake(work=3, capacity=1))
    gids = [router.submit(req(n, i)) for i in range(3)]
    assert [r.global_id for r in router._pending] == gids[1:]
    router.step()
    assert [r.global_id for r in router._pending] == gids[1:]
    outs = router.run_until_complete(max_steps=100)
    assert [o.request_id for o in outs] == gids
    log.append([o.request_id for o in outs])
    router.close()


def sc_churn(n, log):
    """The zero-loss ledger under the oracle's randomized churn; the whole
    output sequence (ids, states, step) must be JAX's."""
    rs = np.random.RandomState(42)
    router = fake_fleet(n, 3, policy="least_loaded",
                        factory=lambda: n.fake(work=int(rs.randint(1, 4)),
                                               capacity=4))
    accepted, outputs = [], {}
    rid = 0
    for step in range(300):
        op = rs.rand()
        if op < 0.45:
            try:
                accepted.append(router.submit(
                    req(n, rid, plen=int(rs.randint(2, 6)))))
            except (n.BackpressureError, n.FleetUnavailableError):
                pass
            rid += 1
        elif op < 0.55 and accepted:
            router.cancel(accepted[rs.randint(len(accepted))])
        elif op < 0.62:
            live = [r for r in router.replicas.values() if r.alive]
            if live:
                live[rs.randint(len(live))].engine.crash_next = True
        for out in router.step():
            assert out.request_id not in outputs
            outputs[out.request_id] = out
            log.append((step, out.request_id, out.state, out.finish_reason))
        router.assert_invariants()
    for _ in range(200):
        if not router.has_work:
            break
        for out in router.step():
            assert out.request_id not in outputs
            outputs[out.request_id] = out
            log.append(("drain", out.request_id, out.state))
    router.assert_invariants()
    assert not router.has_work
    assert not [g for g in accepted if g not in outputs]
    assert len(accepted) > 60
    log.append(sorted(router.registry.snapshot().items()))
    router.close()


def sc_affinity_ignores_padding_chains(n, log):
    class FakeKV:
        page_size = 8
        index = object()

        def prefix_fingerprints(self):
            return set()

        def pages_free(self):
            return 4

        def pages_capacity(self):
            return 8

    class PagedFake(n.fake):
        C = 32
        _kv = FakeKV()

    router = n.FleetRouter([n.Replica(0, PagedFake), n.Replica(1, PagedFake)],
                           policy="prefix_affinity")

    def fps(rid, p):
        return router._fingerprints(n.Request(request_id=rid, prompt_ids=p,
                                              max_new_tokens=2))

    fa, fb = fps(0, [5, 6, 7]), fps(1, [9, 9, 9])
    assert len(fa) == 1 and len(fb) == 1 and not set(fa) & set(fb)
    assert fps(2, [5, 6, 7]) == fa
    log.append((fa, fb))
    router.close()
    rr = n.FleetRouter([n.Replica(0, PagedFake)], policy="round_robin")
    assert rr._fingerprints(n.Request(request_id=0, prompt_ids=[5, 6, 7],
                                      max_new_tokens=2)) == []
    rr.close()


def sc_retention_bounded(n, log):
    router = fake_fleet(n, 1, retain_done=2)
    gids = [router.submit(req(n, i)) for i in range(5)]
    router.run_until_complete(max_steps=100)
    assert len(router._tracked) == 2
    log.append([router.client_id(g) for g in gids])
    assert log[-1] == [None, None, None, 3, 4]
    router.assert_invariants()
    router.close()


def sc_router_stats_jsonl(n, log, path):
    path = f"{path}.{n.side}"
    router = fake_fleet(n, 2, stats_path=path)
    for i in range(5):
        router.submit(req(n, i))
    router.run_until_complete(max_steps=100)
    router.close()
    assert n.validate_jsonl("router_stats", path) == 5
    recs = _no_time(path)
    assert {r["client_id"] for r in recs} == set(range(5))
    assert all(r["policy"] == "round_robin" and r["dispatches"] == 1
               for r in recs)
    log.append(recs)


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_request_id_allocator, sc_chain_fingerprints, sc_shadow_match_depth,
    sc_round_robin, sc_random_seeded, sc_least_loaded, sc_prefix_affinity,
    sc_make_policy, sc_restart_backoff, sc_replica_lifecycle,
    sc_replica_factory_failure, sc_poisson_arrivals, sc_replay_any_target,
    sc_router_rekeys, sc_router_rejects_bad_fleets, sc_router_failover,
    sc_router_backpressure, sc_requeue_bypasses_max_pending,
    sc_admission_error_no_ghost, sc_total_capacity_loss,
    sc_cancel_pending_and_placed, sc_requeue_rejected_fails_terminally,
    sc_granted_cancel_survives_failover, sc_drain_preserves_fcfs_head,
    sc_churn, sc_affinity_ignores_padding_chains, sc_retention_bounded)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_fleet_host_scenario_matches_jax(name):
    both(SCENARIOS[name])


def test_router_stats_jsonl_validates_and_matches_jax(tmp_path):
    both(sc_router_stats_jsonl, str(tmp_path / "router_stats.jsonl"))


def test_request_key_folds_namespace_high_word():
    """The port's per-request stream key folds the id's high word, as JAX's
    ``request_rng`` does: fleet-global ids draw a stream per namespace,
    distinct from the bare low word, the same for a numpy integer."""
    legacy = request_key(0, 7)
    g1, g2 = request_key(0, (1 << 32) | 7), request_key(0, (2 << 32) | 7)
    assert g1 != g2 and g1 != legacy
    assert g1 == request_key(0, (1 << 32) | 7)
    assert g1 == request_key(0, np.int64((1 << 32) | 7))


# -- the tiny Llama fleet ---------------------------------------------------------------


def _serve(n, log, policy, prompts, replicas=3, seed=1, **router_kw):
    router = n.FleetRouter(
        [n.Replica(i, engine_factory(n.side), backoff_base_s=0.0)
         for i in range(replicas)], policy=policy, seed=seed, **router_kw)
    reqs = [n.Request(request_id=i, prompt_ids=p, max_new_tokens=4)
            for i, p in enumerate(prompts)]
    outs = n.replay(router, np.zeros(len(reqs)), reqs, sleep=lambda s: None)
    assert len(outs) == len(prompts)
    router.assert_invariants()
    got = by_client(router, outs)
    assert all(v[1] == "finished" for v in got.values())
    log.append(got)
    return router


@pytest.mark.parametrize("policy", ["round_robin", "random", "least_loaded",
                                    "prefix_affinity"])
def test_fleet_greedy_tokens_and_placements_equal_jax(policy):
    """Every policy places the burst as JAX does, and each request's greedy
    tokens equal the JAX fleet's (which equal solo generate)."""
    cfg = pair()[4]
    prompts = shared_prompts(cfg.vocab_size, 6, np.random.RandomState(13))

    def run(n, log):
        _serve(n, log, policy, prompts).close()

    both(run)


def test_fleet_sampled_reproducible_across_fleet_shapes():
    """Sampled tokens depend only on (seed, global id): a 3-replica
    affinity fleet and a 1-replica fleet draw identical tokens (the port's
    Philox streams cannot equal JAX's threefry ones)."""
    n = ns("port")
    cfg = pair()[4]
    prompts = shared_prompts(cfg.vocab_size, 4, np.random.RandomState(29))

    def run(replicas, policy):
        router = n.FleetRouter(
            [n.Replica(i, engine_factory("port", seed=5))
             for i in range(replicas)], policy=policy, namespace=9)
        reqs = [n.Request(request_id=i, prompt_ids=p, max_new_tokens=4,
                          sampling=n.SamplingParams(temperature=0.9))
                for i, p in enumerate(prompts)]
        outs = n.replay(router, np.zeros(len(reqs)), reqs,
                        sleep=lambda s: None)
        got = {router.client_id(g): list(o.token_ids)
               for g, o in outs.items()}
        router.close()
        return got

    assert run(3, "prefix_affinity") == run(1, "round_robin")


def test_fleet_kill_zero_loss_and_equal_to_jax(tmp_path):
    """A replica killed at ``fleet/replica_step`` mid-run loses nothing:
    tokens, placements, requeues, the counters, the router records and
    the fleet health's alert edges all equal JAX's."""
    cfg = pair()[4]
    prompts = shared_prompts(cfg.vocab_size, 8, np.random.RandomState(31))

    def run(n, log):
        stats = str(tmp_path / f"router_stats.{n.side}.jsonl")
        health = n.FleetHealth(path=str(tmp_path / f"alerts.{n.side}.jsonl"),
                               eval_every=1)
        n.install_plan({"faults": [{
            "point": "fleet/replica_step", "action": "exception",
            "match": {"replica": 0, "step": 2}, "count": 1}]})
        try:
            router = _serve(n, log, "round_robin", prompts,
                            stats_path=stats, health=health)
        finally:
            n.clear_plan()
        snap = router.registry.snapshot()
        assert snap["router/failovers_total"] == 1.0
        assert snap["router/requeued_total"] >= 1.0
        assert snap["router/restarts_total"] == 1.0
        assert snap["router/replicas_alive"] == 3.0
        log.append({k: v for k, v in snap.items()
                    if k.startswith("router/")})
        assert n.validate_jsonl("router_stats", stats) == len(prompts)
        recs = _no_time(stats)
        assert sum(1 for r in recs if r["requeues"] > 0) >= 1
        log.append(recs)
        log.append([(e["rule"], e["state"], e.get("replica"))
                    for e in health.edges() if e["rule"].startswith("replica")])
        router.close()
        health.close()

    both(run)


def test_fleet_shadow_resync_after_restart():
    """A restarted replica's engine is cold: its shadow resyncs to the new
    index (empty) instead of crediting the dead engine's chains."""
    cfg = pair()[4]
    p = np.random.RandomState(3).randint(1, cfg.vocab_size, size=8).tolist()

    def run(n, log):
        router = n.FleetRouter(
            [n.Replica(i, engine_factory(n.side), backoff_base_s=0.0)
             for i in range(2)], policy="prefix_affinity")
        router.submit(n.Request(request_id=0, prompt_ids=p, max_new_tokens=2))
        router.run_until_complete(max_steps=100)
        hot = [rid for rid, sh in router.shadows.items() if sh.fps]
        assert hot
        victim = router.replicas[hot[0]]
        router.submit(n.Request(request_id=1, prompt_ids=p, max_new_tokens=2))
        n.install_plan({"faults": [{
            "point": "fleet/replica_step", "action": "exception",
            "match": {"replica": hot[0]}, "count": 1}]})
        try:
            outs = router.run_until_complete(max_steps=100)
        finally:
            n.clear_plan()
        assert router.replicas[hot[0]].alive
        assert router.shadows[hot[0]].fps == victim.prefix_fingerprints()
        log.append((hot, [list(o.token_ids) for o in outs],
                    {r: len(s.fps) for r, s in router.shadows.items()}))
        router.close()

    both(run)
