"""PyTorch port: SLO serving -- priorities, preemption with resumable page
chains, deadline expiry, feasibility shedding and tenant rate limits --
against the JAX package.

- The scheduler, op for op: the same submit / admit / sweep / requeue /
  pick_preemption / release sequences, with a fake clock, through JAX's
  ``SlotScheduler`` and the port's give the same grants, victims,
  exceptions at submit (in JAX's order of checks) and EWMA estimates; the
  JAX unit cases and a randomized churn over real page managers, with
  tenant buckets and the shed scale.
- The page manager, op for op: ``park_resume`` / ``release_resume`` /
  ``pages_free`` / a pool-pressure reclaim give the same page ids,
  refcounts and free lists as JAX's.
- The engine against the JAX engine on the tiny pair: a batch victim
  preempted for an interactive arrival, under async and sync decode,
  whole and chunked prefill, bf16 and int8 pages, adapters and a self
  draft at k = 2, gives JAX's greedy tokens and preemption counts, decode
  and verify logits within 1e-4 on fp pools, each request's unpreempted
  tokens, and no page or pin left; a resumed int8 chain reads back the
  codes it was parked with; a randomized churn of arrivals keeps JAX's
  outputs and the adapter pins exact; expiry before the prefill and
  mid-chunk, a fault mid-chunk, shedding, tenant limits and the parked
  time go as in JAX.
- What JAX cannot be held to: a sampled victim regenerates its own
  unpreempted stream (threefry and Philox differ); a victim granted back
  into its own slot while its last step is in flight drops that step's
  stale token (async decode and speculative rounds); a victim whose twin
  prompt registered first pins the twin's chain, where the JAX manager
  raises the prefix index's divergence assertion.
"""

import numpy as np
import pytest
import torch

import neuronx_distributed_tpu.resilience.faults as jax_faults
import neuronx_distributed_tpu.serving as jax_serving
import neuronx_distributed_tpu_torch.resilience.faults as faults
import neuronx_distributed_tpu_torch.serving as port_serving
from neuronx_distributed_tpu.serving import ServingEngine as JaxServingEngine
from neuronx_distributed_tpu_torch.kvcache.allocator import NULL_PAGE
from neuronx_distributed_tpu_torch.resilience import InjectedFault
from neuronx_distributed_tpu_torch.serving import (
    Request,
    RequestState,
    SamplingParams,
    ServingEngine,
)
from torch_port_pair import C, build_pair

PAGE = 4
ATOL = 1e-4
SIDES = {"jax": jax_serving, "port": port_serving}


@pytest.fixture(autouse=True)
def _no_plans():
    faults.clear_plan()
    jax_faults.clear_plan()
    yield
    faults.clear_plan()
    jax_faults.clear_plan()


def _req(ns, rid, plen=4, max_new=4, **kw):
    return ns.Request(request_id=rid, prompt_ids=list(range(1, plen + 1)),
                      max_new_tokens=max_new, **kw)


def _finish(ns, sched, req):
    if req.state is ns.RequestState.PREFILL:
        req.transition(ns.RequestState.DECODE)
    req.transition(ns.RequestState.FINISHED)
    req.finish_reason = "length"
    sched.release(req)


def _ids(grants):
    return [(slot, r.request_id) for slot, r in grants]


# -- the scheduler, op for op ----------------------------------------------------


def sc_edf(ns, log):
    sched = ns.SlotScheduler(num_slots=2, context_len=8, max_total_len=16)
    sched.submit(_req(ns, 0), now=0.0)                  # no deadline -> inf
    sched.submit(_req(ns, 1, deadline_s=9.0), now=1.0)  # abs deadline 10
    sched.submit(_req(ns, 2, deadline_s=2.0), now=2.0)  # abs 4: first
    grants = sched.admit(now=3.0)
    log.append(_ids(grants))
    assert [r.request_id for _, r in grants] == [2, 1]
    sched.assert_invariants()
    for _, r in grants:
        _finish(ns, sched, r)
    sched.submit(_req(ns, 3), now=4.0)
    log.append(_ids(sched.admit(now=5.0)))
    assert [rid for _, rid in log[-1]] == [0, 3]
    log.append(sched.queue_wait_estimate("interactive"))


def sc_fcfs(ns, log):
    sched = ns.SlotScheduler(num_slots=3, context_len=8, max_total_len=16)
    for i in range(5):
        sched.submit(_req(ns, i), now=float(i))
    log.append(_ids(sched.admit(now=9.0)))
    assert [rid for _, rid in log[-1]] == [0, 1, 2]


def sc_tiers(ns, log):
    sched = ns.SlotScheduler(num_slots=1, context_len=8, max_total_len=16)
    sched.submit(_req(ns, 0, priority="batch", deadline_s=1.0), now=0.0)
    sched.submit(_req(ns, 1, priority="interactive"), now=0.5)
    log.append(_ids(sched.admit(now=0.6)))
    assert log[-1] == [(0, 1)]
    log.append(sched.queue_depth_of("batch"))


def sc_promote_head(ns, log):
    sched = ns.SlotScheduler(num_slots=1, context_len=8, max_total_len=16,
                             max_batch_wait_s=10.0)
    sched.submit(_req(ns, 0, priority="batch"), now=0.0)
    sched.submit(_req(ns, 1, priority="interactive"), now=11.0)
    log.append(_ids(sched.admit(now=11.0)))
    assert log[-1] == [(0, 0)]


def sc_promote_oldest(ns, log):
    sched = ns.SlotScheduler(num_slots=1, context_len=8, max_total_len=16,
                             max_batch_wait_s=5.0)
    sched.submit(_req(ns, 100, priority="batch"), now=0.0)
    sched.submit(_req(ns, 1, priority="batch", deadline_s=1.0), now=6.0)
    sched.submit(_req(ns, 2, priority="interactive"), now=6.0)
    log.append(_ids(sched.admit(now=6.0)))
    assert log[-1] == [(0, 100)]


def sc_batch_drains(ns, log):
    bound = 5.0
    sched = ns.SlotScheduler(num_slots=1, context_len=8, max_total_len=16,
                             max_batch_wait_s=bound)
    sched.submit(_req(ns, 1000, priority="batch"), now=0.0)
    running, admitted_at, rid = None, None, 0
    for tick in range(40):
        t = float(tick)
        if running is not None:
            _finish(ns, sched, running)
            running = None
        sched.submit(_req(ns, rid, priority="interactive"), now=t)
        rid += 1
        picked = sched.pick_preemption(now=t)
        log.append(None if picked is None
                   else (picked[0], picked[1].request_id))
        if picked is not None:
            assert picked[1].priority == "batch"
            assert t - picked[1].submit_time <= bound
            sched.requeue(picked[1])
        grants = sched.admit(now=t)
        log.append(_ids(grants))
        if any(r.request_id == 1000 for _, r in grants):
            admitted_at = t
            break
        running = grants[0][1] if grants else None
        sched.assert_invariants()
    assert admitted_at is not None and admitted_at <= bound + 2.0
    log.append(sched.queue_wait_estimate("batch"))


def sc_victim(ns, log):
    sched = ns.SlotScheduler(num_slots=2, context_len=8, max_total_len=16)
    sched.submit(_req(ns, 0, priority="batch", deadline_s=100.0), now=0.0)
    sched.submit(_req(ns, 1, priority="batch", deadline_s=5.0), now=0.0)
    grants = dict((r.request_id, s) for s, r in sched.admit(now=0.0))
    assert sched.pick_preemption(now=1.0) is None
    sched.submit(_req(ns, 2, priority="interactive"), now=1.0)
    slot, victim = sched.pick_preemption(now=1.0)
    log.append((slot, victim.request_id))
    assert victim.request_id == 0 and slot == grants[0]
    victim.generated.append(42)  # partial progress is discarded
    assert sched.requeue(victim) == slot
    assert victim.state is ns.RequestState.QUEUED
    assert victim.generated == [] and victim.preemptions == 1
    assert victim.submit_time == 0.0  # the absolute deadline is kept
    sched.assert_invariants()
    log.append(_ids(sched.admit(now=1.0)))
    assert log[-1] == [(slot, 2)]
    assert sched.pick_preemption(now=1.0) is None
    _finish(ns, sched, sched._slots[slot])
    [(_, back)] = sched.admit(now=2.0)
    log.append(back.request_id)
    assert back.request_id == 0 and back.state is ns.RequestState.PREFILL


def sc_victim_ties(ns, log):
    """Equal deadlines: the victim is the batch request with the fewest
    generated tokens; an over-bound batch request is immune."""
    sched = ns.SlotScheduler(num_slots=3, context_len=8, max_total_len=16,
                             max_batch_wait_s=10.0)
    for i in range(3):
        sched.submit(_req(ns, i, priority="batch"), now=float(i))
    sched.admit(now=3.0)
    for slot, r in sched.active():
        r.generated.extend([7] * (3 - slot))
    sched.submit(_req(ns, 9, priority="interactive"), now=10.5)
    picked = sched.pick_preemption(now=10.5)
    log.append((picked[0], picked[1].request_id))
    # at 11.5 requests 0 and 1 have waited past the bound: only 2 is left
    picked = sched.pick_preemption(now=11.5)
    log.append((picked[0], picked[1].request_id))
    assert picked[1].request_id == 2
    log.append(sched.pick_preemption(now=13.0))


def sc_blocked(ns, log):
    sched = ns.SlotScheduler(num_slots=2, context_len=8, max_total_len=16)
    sched.submit(_req(ns, 0, priority="batch"), now=0.0)
    sched.admit(now=0.0)
    sched.submit(_req(ns, 1, priority="interactive"), now=1.0)
    log.append(sched.pick_preemption(now=1.0))
    assert log[-1] is None


def sc_infeasible(ns, log):
    sched = ns.SlotScheduler(num_slots=1, context_len=8, max_total_len=16,
                             shed_infeasible=True)
    sched.submit(_req(ns, 0, deadline_s=0.5), now=0.0)
    sched.admit(now=0.0)
    sched.note_first_token(2.0)
    with pytest.raises(ns.SLOInfeasible):
        sched.submit(_req(ns, 1, deadline_s=0.5), now=1.0)
    assert issubclass(ns.SLOInfeasible, ns.BackpressureError)
    sched.submit(_req(ns, 2, deadline_s=30.0), now=1.0)
    dead = _req(ns, 3, deadline_s=1.0)
    dead.submit_time = 0.0
    with pytest.raises(ns.SLOInfeasible):
        sched.submit(dead, now=5.0)
    sched.note_first_token(1.0)
    log.append((sched._ttft_ewma, sched.queue_wait_estimate("interactive")))
    assert sched._ttft_ewma == 2.0 + 0.25 * (1.0 - 2.0)
    sched.set_load_shed_scale(20.0)  # 20 x 1.75 s > 30 s: shed
    with pytest.raises(ns.SLOInfeasible):
        sched.submit(_req(ns, 4, deadline_s=30.0), now=1.0)
    sched.assert_invariants()


def sc_preset_submit(ns, log):
    sched = ns.SlotScheduler(num_slots=1, context_len=8, max_total_len=16)
    clone = _req(ns, 0, deadline_s=5.0)
    clone.submit_time = 0.0
    sched.submit(clone, now=4.0)
    assert clone.submit_time == 0.0
    swept = sched.sweep(now=5.5)
    log.append([(r.request_id, r.state.value) for r in swept])
    assert log[-1] == [(0, "timed_out")]


def sc_tenant(ns, log):
    sched = ns.SlotScheduler(num_slots=2, context_len=8, max_total_len=16)
    sched.set_default_tenant_limit(1.0, 2.0)
    sched.submit(_req(ns, 1), now=0.0)
    sched.submit(_req(ns, 2), now=0.0)
    with pytest.raises(ns.RateLimited):
        sched.submit(_req(ns, 3), now=0.0)
    assert isinstance(ns.RateLimited("x"), ns.BackpressureError)
    sched.submit(_req(ns, 4), now=1.0)  # refilled
    sched.set_tenant_limit(0, rate=1.0, burst=10.0)  # keeps the fill
    with pytest.raises(ns.RateLimited):
        sched.submit(_req(ns, 5), now=1.0)
    # another tenant gets its own bucket from the default
    sched.submit(_req(ns, 6, adapter_id=3), now=1.0)
    log.append(sorted((k, b.tokens) for k, b in
                      sched._tenant_buckets.items()))
    sched.clear_tenant_limits()
    sched.submit(_req(ns, 7), now=1.0)
    sched.set_default_tenant_limit(None)
    log.append(sched.queue_depth)


def sc_shed_scale(ns, log):
    sched = ns.SlotScheduler(num_slots=1, context_len=8, max_total_len=16)
    with pytest.raises(ValueError, match="load_shed_scale"):
        sched.set_load_shed_scale(0.5)
    sched.set_load_shed_scale(4.0)
    log.append(sched.load_shed_scale)


def sc_bucket(ns, log):
    b = ns.TokenBucket(rate=2.0, burst=4.0)
    log.append([b.consume(1.0, now=0.0) for _ in range(5)])
    log.append([b.consume(1.0, now=0.5), b.consume(1.0, now=0.5),
                b.consume(1.0, now=100.0), b.tokens])
    assert log[-1] == [True, False, True, 3.0]
    with pytest.raises(ValueError):
        ns.TokenBucket(rate=0.0, burst=4.0)


def sc_check_order(ns, log):
    """JAX's order at submit: envelope, page capacity, the tenant bucket,
    feasibility, the backlog.  A refused envelope spends no token; a
    request over its rate is refused before its feasibility is judged."""
    kv = ns.PagedKVManager(num_slots=1, context_len=8, max_total_len=16,
                           page_size=4, num_pages=4, prefix_cache=False)
    sched = ns.SlotScheduler(1, 8, 16, max_queue=1, page_gate=kv,
                             shed_infeasible=True)
    sched.set_tenant_limit(0, rate=1.0, burst=1.0)
    for bad, err in ((_req(ns, 0, plen=9), ns.AdmissionError),
                     (_req(ns, 1, max_new=9), ns.AdmissionError),
                     (_req(ns, 2, plen=8, max_new=8), ns.AdmissionError)):
        with pytest.raises(err):
            sched.submit(bad, now=0.0)
        log.append(type(bad).__name__)
    log.append(sched._tenant_buckets[0].tokens)
    sched.submit(_req(ns, 3), now=0.0)  # spends the token
    sched.note_first_token(5.0)
    with pytest.raises(ns.RateLimited):  # over rate AND infeasible
        sched.submit(_req(ns, 4, deadline_s=1.0), now=0.0)
    sched.set_tenant_limit(0, rate=100.0, burst=100.0)
    with pytest.raises(ns.SLOInfeasible):  # infeasible AND backlog
        sched.submit(_req(ns, 5, deadline_s=1.0), now=0.5)
    sched.submit(_req(ns, 6), now=0.5)
    with pytest.raises(ns.BackpressureError) as e:
        sched.submit(_req(ns, 7), now=0.5)
    log.append(type(e.value).__name__)
    assert type(e.value) is ns.BackpressureError


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_edf, sc_fcfs, sc_tiers, sc_promote_head, sc_promote_oldest,
    sc_batch_drains, sc_victim, sc_victim_ties, sc_blocked, sc_infeasible,
    sc_preset_submit, sc_tenant, sc_shed_scale, sc_bucket, sc_check_order)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scheduler_matches_jax(name):
    logs = {}
    for side, ns in SIDES.items():
        logs[side] = []
        SCENARIOS[name](ns, logs[side])
    assert logs["port"] == logs["jax"]


def _refs(kv):
    return dict(sorted(kv.alloc._refs.items())), list(kv.alloc._free)


def _churn(ns, seed, log):
    """Random submit / cancel / sweep / preempt-with-park / admit / finish
    churn over a page manager with a prefix cache, tenant buckets and
    shedding, all on one fake clock.  Every op's outcome goes to ``log``;
    invariants hold after each."""
    rs = np.random.RandomState(seed)
    kv = ns.PagedKVManager(num_slots=3, context_len=8, max_total_len=16,
                           page_size=4, num_pages=15)
    sched = ns.SlotScheduler(3, 8, 16, page_gate=kv, max_batch_wait_s=20.0,
                             max_queue=6, shed_infeasible=True)
    sched.set_tenant_limit(2, rate=0.3, burst=2.0)
    rid, live = 0, {}
    # unique prompts (a large vocabulary), so no two chains diverge

    def check():
        sched.assert_invariants()
        kv.assert_invariants()
        log.append((kv.pages_free(), _refs(kv)))

    for step in range(250):
        now = step * 0.5
        if rs.rand() < 0.6:
            plen = int(rs.randint(1, 9))
            req = ns.Request(
                request_id=rid,
                prompt_ids=rs.randint(1, 10**6, size=plen).tolist(),
                max_new_tokens=int(rs.randint(1, 5)),
                priority="batch" if rs.rand() < 0.5 else "interactive",
                deadline_s=(float(rs.randint(2, 60))
                            if rs.rand() < 0.5 else None),
                adapter_id=int(rs.randint(0, 3)))
            try:
                sched.submit(req, now=now)
                log.append(("ok", rid))
            except ns.BackpressureError as e:
                log.append((type(e).__name__, rid))
            rid += 1
        if rs.rand() < 0.1 and rid:
            log.append(sched.cancel(int(rs.randint(rid))))
        for req in sched.sweep(now):
            log.append(("swept", req.request_id, req.state.value))
            if req.request_id in live:
                kv.release_slot(live.pop(req.request_id)[0])
            kv.release_resume(req)
            check()
        picked = sched.pick_preemption(now)
        if picked is not None:
            slot, victim = picked
            log.append(("victim", slot, victim.request_id))
            chunking = live.pop(victim.request_id)[2]
            sched.requeue(victim)
            kv.park_resume(slot, victim,
                           fresh_done=int(rs.randint(0, 3))
                           if chunking else None)
            kv.release_slot(slot)
            check()
        for slot, req in sched.admit(now):
            C = 8
            ids = np.zeros((C,), np.int64)
            ids[C - req.prompt_len:] = req.prompt_ids
            valid = (np.arange(C) >= C - req.prompt_len).astype(np.int32)
            hit = kv.admit_slot(slot, req, ids, valid)
            kv.release_resume(req)
            chunking = hit is None and rs.rand() < 0.4
            if not chunking:
                kv.finish_insert(slot, "logits")
            live[req.request_id] = (slot, req, chunking)
            log.append(("grant", slot, req.request_id, hit,
                        kv.fresh_pages(slot)))
            sched.note_first_token(float(rs.rand()))
            check()
        if live and rs.rand() < 0.4:
            key = list(live)[int(rs.randint(len(live)))]
            slot, req, chunking = live.pop(key)
            if chunking:
                kv.finish_insert(slot, "logits")
            _finish(ns, sched, req)
            kv.release_slot(slot)
            check()
        log.append((sched._ttft_ewma, dict(sched._wait_ewma)))
    for slot, req, _ in live.values():
        _finish(ns, sched, req)
        kv.release_slot(slot)
    for req in list(sched._by_id.values()):
        sched.cancel(req.request_id)
    for req in sched.sweep(now=1e9):
        kv.release_resume(req)
    check()
    assert not kv._resume
    return kv, rid


@pytest.mark.parametrize("seed", [0, 1])
def test_randomized_churn_matches_jax_op_for_op(seed):
    logs = {}
    for side, ns in SIDES.items():
        logs[side] = []
        kv, n = _churn(ns, seed, logs[side])
        cached = {nd.page for nd in kv.index._iter() if nd.page != NULL_PAGE}
        assert kv.alloc.in_use == len(cached)  # no page left outside the index
    assert logs["port"] == logs["jax"]
    kinds = {e[0] for e in logs["port"] if isinstance(e, tuple)
             and isinstance(e[0], str)}
    assert {"victim", "grant", "swept", "RateLimited", "SLOInfeasible"
            } <= kinds and n > 100


# -- the page manager, op for op -----------------------------------------------


def _admit(ns, kv, slot, rid, prompt, max_new=4, adapter_id=0):
    req = ns.Request(request_id=rid, prompt_ids=prompt,
                     max_new_tokens=max_new, adapter_id=adapter_id)
    ids = np.zeros((8,), np.int64)
    ids[8 - len(prompt):] = prompt
    valid = (np.arange(8) >= 8 - len(prompt)).astype(np.int32)
    return req, kv.admit_slot(slot, req, ids, valid)


def _resume_ops(ns, log):
    kv = ns.PagedKVManager(num_slots=3, context_len=8, max_total_len=16,
                           page_size=4, num_pages=10)

    def snap(tag):
        kv.assert_invariants()
        log.append((tag, kv.pages_free(), kv._resume_reclaimable(),
                    _refs(kv)))

    a, _ = _admit(ns, kv, 0, 0, [1, 2, 3, 4, 5, 6, 7, 8])   # 2 + 1 pages
    kv.finish_insert(0, "logits-a")                          # a DECODE chain
    b, _ = _admit(ns, kv, 1, 1, [9, 8, 7, 6, 5, 4])          # mid-chunk
    snap("admitted")
    # a DECODE victim pins its whole prompt chain
    a.transition(ns.RequestState.PREFILL)
    kv.park_resume(0, a)
    kv.release_slot(0)
    snap("parked a")
    log.append((a.resume_pages, len(a.resume_keys)))
    # a mid-chunk victim pins its chunk progress (1 of 2 fresh pages)
    kv.park_resume(1, b, fresh_done=1)
    kv.release_slot(1)
    snap("parked b")
    log.append((b.resume_pages, len(b.resume_keys)))
    kv.park_resume(1, b, fresh_done=2)  # already parked: nothing changes
    snap("parked b twice")
    # the re-grant's lookup matches the pinned chain; the pin gives way
    a2, hit = _admit(ns, kv, 0, 0, [1, 2, 3, 4, 5, 6, 7, 8])
    log.append(("a hit", hit, kv.fresh_pages(0)))
    kv.release_resume(a)
    kv.release_resume(a)  # idempotent
    snap("a re-granted")
    kv.release_slot(0)
    # pool pressure: admissions that need every page drop b's pin (the
    # oldest park) and evict its chain
    c, _ = _admit(ns, kv, 0, 2, [11, 12, 13, 14, 15, 16, 17, 18], max_new=8)
    d, _ = _admit(ns, kv, 1, 3, [21, 22, 23, 24, 25, 26, 27, 28])
    snap("pressure")
    e, _ = _admit(ns, kv, 2, 4, [31, 32, 33, 34])
    snap("reclaimed")
    log.append((b.resume_pages, b.resume_keys, list(kv._resume)))
    for slot in range(3):
        kv.release_slot(slot)
    snap("drained")


def test_park_and_resume_pages_match_jax():
    logs = {}
    for side, ns in SIDES.items():
        logs[side] = []
        _resume_ops(ns, logs[side])
    assert logs["port"] == logs["jax"]
    tags = [e[0] for e in logs["port"] if isinstance(e[0], str)]
    assert "reclaimed" in tags
    parked = dict((e[0], e) for e in logs["port"] if isinstance(e[0], str))
    # the pins are counted as reclaimable while parked
    assert parked["parked b"][2] > 0
    # the pressure reclaim dropped b's pin
    assert logs["port"][-2][2] == [] or logs["port"][-2][:2] == ([], None)


def test_park_resume_pins_a_twin_chain_where_jax_raises():
    """Two identical prompts admitted before either registered; the first
    registers, then the second is parked mid-chunk.  The JAX manager's
    registration of the victim's chain raises the prefix index's
    divergence assertion; the port pins the twin's chain (the same KV)."""
    prompt = [1, 2, 3, 4, 5, 6, 7, 8]
    for side, ns in SIDES.items():
        kv = ns.PagedKVManager(num_slots=2, context_len=8, max_total_len=16,
                               page_size=4, num_pages=10)
        _admit(ns, kv, 0, 0, prompt)
        b, _ = _admit(ns, kv, 1, 1, prompt)
        kv.finish_insert(0, "logits")
        if side == "jax":
            with pytest.raises(AssertionError, match="divergence"):
                kv.park_resume(1, b, fresh_done=1)
            continue
        kv.park_resume(1, b, fresh_done=1)
        assert b.resume_pages == [int(kv.tables[0][0])]
        kv.release_slot(1)
        kv.release_slot(0)
        kv.assert_invariants()
        _, hit = _admit(ns, kv, 1, 1, prompt)
        kv.release_resume(b)
        assert hit == "logits"
        kv.release_slot(1)
        assert kv.leaked_pages() == 0


# -- the engine against the JAX engine -------------------------------------------


class _Clock:
    """A clock the test moves: both engines read the same times."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _recorder(monkeypatch, pim, calls):
    """Record each decode / verify call's logits on the live rows (offset
    below T): the k-th call of both engines must agree."""
    T = pim.config.max_total_len
    for name in ("decode_pages", "decode_pages_lora", "verify_pages"):
        real = getattr(pim, name)

        def wrapped(*args, _real=real, **kw):
            out = _real(*args, **kw)
            offs = np.asarray(args[1] if not torch.is_tensor(args[1])
                              else args[1].cpu())
            lg = out[0]
            lg = np.asarray(lg.float() if torch.is_tensor(lg) else lg)
            calls.append({int(b): lg[b] for b in np.nonzero(offs < T)[0]})
            return out

        monkeypatch.setattr(pim, name, wrapped)


CASES = {
    "async-whole": dict(async_decode=True),
    "sync-whole": dict(async_decode=False),
    "async-chunk": dict(async_decode=True, prefill_chunk_tokens=4),
    "sync-chunk": dict(async_decode=False, prefill_chunk_tokens=4),
    "async-whole-int8": dict(async_decode=True, kv_quant="int8"),
    "sync-chunk-int8": dict(async_decode=False, kv_quant="int8",
                            prefill_chunk_tokens=4),
    "async-whole-adapters": dict(async_decode=True, adapters=True),
    "sync-chunk-adapters": dict(async_decode=False, adapters=True,
                                prefill_chunk_tokens=4),
    "async-whole-spec": dict(async_decode=True, spec=True),
    "sync-chunk-spec": dict(async_decode=False, spec=True,
                            prefill_chunk_tokens=4),
}
BATCH_NEW, INT_NEW, SPEC_K = 8, 3, 2


def _engine(side, case, clock, pim_pair, **extra):
    """One side's engine for ``case``, with a pool the three batch
    requests fill (so the interactive arrival is blocked)."""
    kw = dict(CASES[case])
    adapters = kw.pop("adapters", False)
    spec = kw.pop("spec", False)
    jpim, tpim = pim_pair
    pim = jpim if side == "jax" else tpim
    k = SPEC_K if spec else 0
    need = 2 + -(-(BATCH_NEW + k) // PAGE)
    kw.update(page_size=PAGE, num_pages=3 * need + 1, clock=clock, **extra)
    if spec:
        kw.update(draft=pim, spec_k=k)
    store = None
    if adapters:
        from test_torch_tenancy import _stores

        jstore, tstore = _stores(jpim, tpim)
        store = jstore if side == "jax" else tstore
        kw["adapter_store"] = store
    if side == "jax":
        return JaxServingEngine(pim, **kw), store
    return ServingEngine(pim, device="cpu", **kw), store


def _prompts(vocab, n, seed=5, size=5):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, vocab, size=size).tolist() for _ in range(n)]


def _preempt_run(side, case, pim_pair, vocab, arrive_after=1):
    """Three batch requests fill the engine; an interactive request
    arrives after ``arrive_after`` steps and preempts one."""
    ns = SIDES[side]
    clock = _Clock()
    eng, store = _engine(side, case, clock, pim_pair)
    adapters = CASES[case].get("adapters", False)
    prompts = _prompts(vocab, 4)
    outs = []
    for i in range(3):
        eng.submit(ns.Request(request_id=i, prompt_ids=prompts[i],
                              max_new_tokens=BATCH_NEW, priority="batch",
                              adapter_id=(i % 3) if adapters else 0))
    for _ in range(arrive_after):
        clock.t += 0.01
        outs += eng.step()
    eng.submit(ns.Request(request_id=3, prompt_ids=prompts[3],
                          max_new_tokens=INT_NEW, priority="interactive",
                          adapter_id=1 if adapters else 0))
    steps = 0
    while eng.has_work:
        clock.t += 0.01
        outs += eng.step()
        steps += 1
        assert steps < 300
    eng.scheduler.assert_invariants()
    eng._kv.assert_invariants()
    if store is not None:
        store.assert_invariants()
        assert all(store.pins(a) == 0 for a in store.resident_ids())
    return eng, {o.request_id: o for o in outs}


def _unpreempted(case, tpim_pair, vocab):
    """Each request alone on a fresh port engine of the same case."""
    prompts = _prompts(vocab, 4)
    want = {}
    adapters = CASES[case].get("adapters", False)
    for i, p in enumerate(prompts):
        eng, _ = _engine("port", case, _Clock(), tpim_pair)
        eng.submit(Request(request_id=i, prompt_ids=p,
                           max_new_tokens=INT_NEW if i == 3 else BATCH_NEW,
                           adapter_id=(1 if i == 3 else i % 3)
                           if adapters else 0))
        [o] = eng.run_until_complete(max_steps=100)
        want[i] = list(o.token_ids)
    return want


@pytest.mark.parametrize("case", sorted(CASES))
def test_preemption_token_identical_to_jax(case, monkeypatch):
    T = 32 if CASES[case].get("spec") else 16
    jpim, tpim, _, _, cfg = build_pair(3, T, 0)
    calls = {"jax": [], "port": []}
    _recorder(monkeypatch, jpim, calls["jax"])
    _recorder(monkeypatch, tpim, calls["port"])
    runs = {}
    for side in ("jax", "port"):
        eng, outs = _preempt_run(side, case, (jpim, tpim), cfg.vocab_size)
        runs[side] = {i: (o.state, list(o.token_ids), o.preemptions)
                      for i, o in outs.items()}
    assert runs["port"] == runs["jax"]
    assert set(runs["port"]) == {0, 1, 2, 3}
    victims = [i for i, r in runs["port"].items() if r[2] > 0]
    assert victims and all(i < 3 for i in victims)  # batch victims only
    assert eng.preemptions >= 1
    evictable = eng._kv.index.evictable_pages()
    assert eng._kv.alloc.in_use == evictable and eng._kv.leaked_pages() == 0
    assert len(calls["port"]) == len(calls["jax"])
    if CASES[case].get("kv_quant") is None:
        for got, ref in zip(calls["port"], calls["jax"]):
            assert set(got) == set(ref)
            for b in got:
                np.testing.assert_allclose(got[b], ref[b], atol=ATOL,
                                           rtol=0)
    want = _unpreempted(case, (jpim, tpim), cfg.vocab_size)
    assert {i: r[1] for i, r in runs["port"].items()} == want


@pytest.mark.parametrize("case", ["async-chunk", "sync-chunk-int8"])
def test_mid_chunk_victim_resumes_its_committed_pages(case):
    """A victim parked in mid-chunk keeps the pages its chunks committed:
    its re-grant dispatches only the rest, JAX's count, fewer than a
    prefill from scratch."""
    jpim, tpim, _, _, cfg = build_pair()
    runs = {}
    for side in ("jax", "port"):
        eng, outs = _preempt_run(side, case, (jpim, tpim), cfg.vocab_size,
                                 arrive_after=2)
        victim = next(o for o in outs.values() if o.preemptions)
        runs[side] = (victim.request_id, victim.prefill_chunks,
                      list(victim.token_ids))
    assert runs["port"] == runs["jax"]
    # two fresh prompt pages a request; the victim's total is below two
    # prefills from scratch
    assert runs["port"][1] < 4


def test_resumed_int8_chain_reads_back_its_codes(monkeypatch):
    """An int8 DECODE victim's prompt pages are never rewritten: after the
    drain the pinned chain's codes and page params are those it was
    parked with."""
    jpim, tpim, _, _, cfg = build_pair()
    parked = {}
    real = ServingEngine._preempt_for_priority

    def spy(self, now):
        active = dict((r.request_id, s) for s, r in self.scheduler.active())
        real(self, now)
        for rid, slot in active.items():
            req = self.scheduler._by_id.get(rid)
            if req is not None and req.state is RequestState.QUEUED \
                    and rid not in parked:
                pages = [p for p in req.resume_pages if p != NULL_PAGE]
                parked[rid] = (pages, [tuple(t[pages].clone() for t in e)
                                       for e in self.caches])

    monkeypatch.setattr(ServingEngine, "_preempt_for_priority", spy)
    eng, outs = _preempt_run("port", "async-whole-int8", (jpim, tpim),
                             cfg.vocab_size, arrive_after=3)
    assert parked
    for rid, (pages, snap) in parked.items():
        assert pages
        for entry, saved in zip(eng.caches, snap):
            for t, s in zip(entry, saved):
                assert torch.equal(t[pages], s)
        assert outs[rid].preemptions == 1


def test_sampled_victim_regenerates_its_stream():
    """A sampled batch victim's tokens equal its unpreempted run's: the
    stream is keyed on (seed, request id, token index)."""
    _, tpim, _, _, cfg = build_pair()
    prompts = _prompts(cfg.vocab_size, 4)
    sampling = SamplingParams(temperature=0.9, top_k=5)

    def run(with_interactive):
        eng = ServingEngine(tpim, page_size=PAGE, num_pages=13, seed=3,
                            device="cpu")
        for i in range(3):
            eng.submit(Request(request_id=i, prompt_ids=prompts[i],
                               max_new_tokens=BATCH_NEW, priority="batch",
                               sampling=sampling))
        outs = eng.step()
        if with_interactive:
            eng.submit(Request(request_id=3, prompt_ids=prompts[3],
                               max_new_tokens=INT_NEW, sampling=sampling))
        outs += eng.run_until_complete(max_steps=200)
        return eng, {o.request_id: o for o in outs}

    eng, pre = run(True)
    _, ref = run(False)
    victims = [i for i, o in pre.items() if o.preemptions]
    assert victims and eng.preemptions == len(victims)
    for i in range(3):
        assert list(pre[i].token_ids) == list(ref[i].token_ids)


@pytest.mark.parametrize("spec", [False, True])
def test_stale_step_dropped_when_victim_regranted_to_its_slot(spec,
                                                              monkeypatch):
    """Force a preemption while the victim's decode step (or speculative
    round) is in flight, with the pool roomy enough that the victim is
    granted straight back into its own slot in the same step: the slot's
    occupancy generation moves on, the in-flight token is dropped, and the
    victim's tokens are its unpreempted run's."""
    T = 32 if spec else 16
    _, tpim, _, _, cfg = build_pair(3, T, 0)
    prompts = _prompts(cfg.vocab_size, 3)
    kw = dict(draft=tpim, spec_k=SPEC_K) if spec else {}

    def run(force):
        eng = ServingEngine(tpim, page_size=PAGE, num_pages=40,
                            device="cpu", **kw)
        for i in range(3):
            eng.submit(Request(request_id=i, prompt_ids=prompts[i],
                               max_new_tokens=BATCH_NEW, priority="batch"))
        outs = eng.step() + eng.step()
        seen = {}
        if force:
            real = eng.scheduler.pick_preemption
            victim = next(r for _, r in eng.scheduler.active()
                          if r.request_id == 1)
            slot = eng.scheduler.slot_of(1)
            assert eng._pending is not None and victim.generated
            seen.update(slot=slot, gen=int(eng._slot_gen[slot]),
                        n=len(victim.generated))

            def once(now=None):
                eng.scheduler.pick_preemption = real
                return slot, victim

            eng.scheduler.pick_preemption = once
            outs += eng.step()
            assert eng.scheduler.slot_of(1) == slot
            assert eng._slot_gen[slot] == seen["gen"] + 1
            assert victim.state is RequestState.DECODE
            assert len(victim.generated) == 1  # only its first token again
        outs += eng.run_until_complete(max_steps=200)
        eng._kv.assert_invariants()
        assert eng._kv.leaked_pages() == 0
        return eng, {o.request_id: o for o in outs}

    eng, forced = run(True)
    _, ref = run(False)
    assert forced[1].preemptions == 1 and eng.preemptions == 1
    for i in range(3):
        assert list(forced[i].token_ids) == list(ref[i].token_ids)


def test_victim_whose_twin_is_still_chunking():
    """Twins of one prompt chunk side by side; the first registers its
    chain, the second is preempted mid-chunk and later served from the
    twin's chain: both keep their unpreempted tokens, nothing leaks.  (The
    JAX engine raises the prefix index's divergence assertion here.)"""
    jpim, tpim, _, _, cfg = build_pair()
    prompt = _prompts(cfg.vocab_size, 1, seed=9, size=8)[0]
    other = _prompts(cfg.vocab_size, 2, seed=10)

    def run(side, interactive):
        ns = SIDES[side]
        pim = jpim if side == "jax" else tpim
        kw = dict(page_size=PAGE, num_pages=13, prefill_chunk_tokens=4,
                  async_decode=False)
        eng = (JaxServingEngine(pim, **kw) if side == "jax"
               else ServingEngine(pim, device="cpu", **kw))
        reqs = [(0, prompt), (1, prompt), (2, other[0])]
        for rid, p in reqs:
            eng.submit(ns.Request(request_id=rid, prompt_ids=p,
                                  max_new_tokens=BATCH_NEW,
                                  priority="batch"))
        outs = []
        for _ in range(4):  # the first twin finishes chunking first
            outs += eng.step()
        states = {r.request_id: r.state.value
                  for _, r in eng.scheduler.active()}
        if interactive:
            eng.submit(ns.Request(request_id=3, prompt_ids=other[1],
                                  max_new_tokens=INT_NEW))
        outs += eng.run_until_complete(max_steps=200)
        return eng, states, {o.request_id: o for o in outs}

    eng, states, pre = run("port", True)
    assert states[0] == "decode" and states[1] == "prefill"
    assert pre[1].preemptions == 1
    _, _, ref = run("port", False)
    for i in range(3):
        assert list(pre[i].token_ids) == list(ref[i].token_ids)
    assert list(pre[0].token_ids) == list(pre[1].token_ids)
    eng._kv.assert_invariants()
    assert eng._kv.leaked_pages() == 0
    with pytest.raises(AssertionError, match="divergence"):
        run("jax", True)


def test_randomized_arrivals_match_jax_with_exact_pins():
    """Random arrivals over two tiers and three adapters on a tight pool:
    the port's outputs (tokens, states, preemptions) equal JAX's, and at
    every step each adapter's pins equal the slots holding it."""
    from test_torch_tenancy import _stores

    jpim, tpim, _, _, cfg = build_pair()
    rs = np.random.RandomState(21)
    arrivals = []
    for rid in range(14):
        arrivals.append((int(rs.randint(0, 20)), dict(
            request_id=rid,
            prompt_ids=rs.randint(1, cfg.vocab_size,
                                  size=rs.randint(2, C + 1)).tolist(),
            max_new_tokens=int(rs.randint(1, 7)),
            priority="batch" if rs.rand() < 0.6 else "interactive",
            adapter_id=int(rs.randint(0, 3)))))
    runs = {}
    for side in ("jax", "port"):
        ns = SIDES[side]
        jstore, tstore = _stores(jpim, tpim)
        store = jstore if side == "jax" else tstore
        clock = _Clock()
        kw = dict(page_size=PAGE, num_pages=11, adapter_store=store,
                  clock=clock, prefill_chunk_tokens=4)
        eng = (JaxServingEngine(jpim, async_decode=True, **kw)
               if side == "jax" else ServingEngine(tpim, device="cpu", **kw))
        outs = []
        for step in range(200):
            for at, r in arrivals:
                if at == step:
                    eng.submit(ns.Request(**r))
            clock.t += 0.05
            outs += eng.step()
            if side == "port":
                held = {}
                for slot, _ in eng.scheduler.active():
                    a = eng._slot_adapter[slot]
                    if a:
                        held[a] = held.get(a, 0) + 1
                assert {a: store.pins(a) for a in store.resident_ids()
                        if store.pins(a)} == held
            if step > 20 and not eng.has_work:
                break
        store.assert_invariants()
        assert all(store.pins(a) == 0 for a in store.resident_ids())
        runs[side] = {o.request_id: (o.state, list(o.token_ids),
                                     o.preemptions) for o in outs}
    assert runs["port"] == runs["jax"]
    assert len(runs["port"]) == 14
    assert sum(r[2] for r in runs["port"].values()) >= 1


def test_expired_before_prefill_counted_and_reclaimed():
    """A request whose deadline dies between the step's sweep and its
    prefill is timed out with no token and no page held, as in JAX."""
    jpim, tpim, _, _, _ = build_pair()
    runs = {}
    for side in ("jax", "port"):
        t = [0.0]

        def clock():  # each call advances: the sweep sees 0.6, prefill 0.9
            t[0] += 0.3
            return t[0]

        pim = jpim if side == "jax" else tpim
        kw = dict(page_size=PAGE, num_pages=16, clock=clock)
        eng = (JaxServingEngine(pim, **kw) if side == "jax"
               else ServingEngine(pim, device="cpu", **kw))
        eng.submit(SIDES[side].Request(request_id=0, prompt_ids=[1, 2, 3],
                                       max_new_tokens=4, deadline_s=0.45))
        [o] = eng.step()
        runs[side] = (o.state, o.token_ids, o.ttft_ms)
        eng._kv.assert_invariants()
        assert eng._kv.alloc.in_use == 0
    assert runs["port"] == runs["jax"] == ("timed_out", (), None)
    assert eng.expired_before_prefill == 1
    assert eng.scheduler._by_id == {}


def test_expiry_mid_chunking_reclaims_and_counts():
    jpim, tpim, _, _, _ = build_pair()
    runs = {}
    for side in ("jax", "port"):
        clock = _Clock()
        pim = jpim if side == "jax" else tpim
        kw = dict(page_size=PAGE, num_pages=16, prefill_chunk_tokens=4,
                  clock=clock)
        eng = (JaxServingEngine(pim, **kw) if side == "jax"
               else ServingEngine(pim, device="cpu", **kw))
        req = SIDES[side].Request(request_id=0, prompt_ids=list(range(1, 9)),
                                  max_new_tokens=4, deadline_s=1.0)
        eng.submit(req)
        eng.step()  # admits and runs the first chunk
        chunks = req.prefill_chunks
        clock.t = 2.0  # dead before the next chunk
        [o] = eng.step()
        runs[side] = (o.state, req.prefill_chunks, chunks, o.token_ids)
        assert not eng._chunking
        eng._kv.assert_invariants()
        assert eng._kv.alloc.in_use == eng._kv.index.evictable_pages()
    assert runs["port"] == runs["jax"]
    assert runs["port"][0] == "timed_out" and runs["port"][1] == 1


def test_expiry_just_before_a_chunk_is_shed_not_swept():
    """A deadline that dies between the step's sweep and the chunk
    dispatch is caught by the pre-dispatch check (``shed_reason``)."""
    _, tpim, _, _, _ = build_pair()
    t = [0.0]

    def clock():
        t[0] += 0.1
        return t[0]

    eng = ServingEngine(tpim, page_size=PAGE, num_pages=16,
                        prefill_chunk_tokens=4, clock=clock, device="cpu")
    # clock reads: submit 0.1; step 1 at 0.2, grant 0.3, chunk 0.4, step
    # end 0.5; step 2's sweep at 0.6 (0.5 after submit), its chunk check
    # at 0.7 (0.6 after submit): the deadline dies between the two
    req = Request(request_id=0, prompt_ids=list(range(1, 9)),
                  max_new_tokens=4, deadline_s=0.55)
    eng.submit(req)
    outs = eng.step() + eng.step()
    assert [o.state for o in outs] == ["timed_out"]
    assert req.shed_reason == "expired_before_prefill"
    assert eng.expired_before_prefill == 1 and req.prefill_chunks == 1
    assert outs[0].shed_reason == "expired_before_prefill"


def test_chaos_fault_mid_chunk_reclaims_and_resubmits():
    """An injected exception at ``serving/prefill_chunk`` fails the one
    request, reclaims every page, re-raises; an identical resubmission
    then finishes with JAX's tokens.  Both planes fire the same event."""
    jpim, tpim, _, _, _ = build_pair()
    prompt = list(range(1, 9))
    plan = {"faults": [{"point": "serving/prefill_chunk",
                        "action": "exception", "match": {"request_id": 0}}]}
    runs = {}
    for side, mod in (("jax", jax_faults), ("port", faults)):
        pim = jpim if side == "jax" else tpim
        kw = dict(page_size=PAGE, num_pages=16, prefill_chunk_tokens=4)
        eng = (JaxServingEngine(pim, **kw) if side == "jax"
               else ServingEngine(pim, device="cpu", **kw))
        base = eng._kv.alloc.in_use
        mod.install_plan(plan)
        eng.submit(SIDES[side].Request(request_id=0, prompt_ids=prompt,
                                       max_new_tokens=3))
        with pytest.raises(mod.InjectedFault):
            eng.run_until_complete(max_steps=50)
        assert eng._kv.alloc.in_use == base and not eng._chunking
        eng._kv.assert_invariants()
        eng.scheduler.assert_invariants()
        eng.submit(SIDES[side].Request(request_id=1, prompt_ids=prompt,
                                       max_new_tokens=3))
        [o] = eng.run_until_complete(max_steps=100)
        runs[side] = (o.state, list(o.token_ids),
                      [(e["point"], e["ctx"]) for e in mod.fired_events()])
    assert runs["port"] == runs["jax"]
    assert runs["port"][0] == "finished"
    assert issubclass(InjectedFault, RuntimeError)


def test_shedding_and_tenant_limits_like_jax():
    """With ``shed_infeasible`` a deadline under the measured time to
    first token is refused (``SLOInfeasible``, counted as shed); a tenant
    over its bucket is refused (``RateLimited``, counted as rejected);
    the admitted requests finish with JAX's tokens."""
    jpim, tpim, _, _, _ = build_pair()
    runs = {}
    for side in ("jax", "port"):
        ns = SIDES[side]
        clock = _Clock()
        pim = jpim if side == "jax" else tpim
        kw = dict(page_size=PAGE, num_pages=16, clock=clock,
                  shed_infeasible=True)
        eng = (JaxServingEngine(pim, **kw) if side == "jax"
               else ServingEngine(pim, device="cpu", **kw))
        log = []
        eng.submit(ns.Request(request_id=0, prompt_ids=[1, 2, 3],
                              max_new_tokens=2))
        clock.t = 1.0  # the first token comes 1 s after the submit
        outs = eng.step()
        for rid, deadline in ((1, 0.5), (2, 30.0)):
            try:
                eng.submit(ns.Request(request_id=rid, prompt_ids=[4, 5],
                                      max_new_tokens=2, deadline_s=deadline))
                log.append(rid)
            except ns.SLOInfeasible:
                log.append(("shed", rid))
        eng.scheduler.set_tenant_limit(0, rate=0.1, burst=1.0)
        for rid in (3, 4):
            try:
                eng.submit(ns.Request(request_id=rid, prompt_ids=[6, 7],
                                      max_new_tokens=2))
                log.append(rid)
            except ns.RateLimited:
                log.append(("limited", rid))
        outs += eng.run_until_complete(max_steps=50)
        log.append(sorted((o.request_id, o.state, tuple(o.token_ids))
                          for o in outs))
        if side == "jax":
            snap = eng.registry.snapshot()
            log.append((int(snap["serving/shed_total"]),
                         int(snap["serving/rejected_total"])))
        else:
            log.append((eng.shed, eng.rejected))
        runs[side] = log
    assert runs["port"] == runs["jax"]
    assert runs["port"][:4] == [("shed", 1), 2, 3, ("limited", 4)]
    assert runs["port"][-1] == (1, 1)


def test_parked_time_is_banked_like_jax():
    """``preempted_ms`` is the wall time from the park to the re-grant,
    on the engine's clock."""
    jpim, tpim, _, _, cfg = build_pair()
    runs = {}
    for side in ("jax", "port"):
        eng, outs = _preempt_run(side, "sync-whole", (jpim, tpim),
                                 cfg.vocab_size)
        runs[side] = {i: round(o.preempted_ms, 6) for i, o in outs.items()}
    assert runs["port"] == runs["jax"]
    assert any(v > 0 for v in runs["port"].values())


def test_requeue_edges_and_output_fields():
    req = Request(request_id=0, prompt_ids=[1, 2], max_new_tokens=2,
                  priority="batch")
    req.transition(RequestState.PREFILL)
    req.generated.append(5)
    req.first_token_time = 1.0
    req.reset_for_requeue()
    assert req.state is RequestState.QUEUED and req.generated == []
    assert req.first_token_time is None and req.preemptions == 1
    req.transition(RequestState.PREFILL)
    req.transition(RequestState.DECODE)
    req.reset_for_requeue()
    with pytest.raises(RuntimeError, match="illegal"):
        req.reset_for_requeue()  # QUEUED -> QUEUED is not an edge
    req.transition(RequestState.CANCELLED)
    req.shed_reason = "x"
    out = port_serving.RequestOutput.from_request(req, now=2.0)
    assert (out.preemptions, out.shed_reason, out.preempted_ms) == (2, "x",
                                                                   0.0)
    with pytest.raises(ValueError, match="priority"):
        Request(request_id=0, prompt_ids=[1], max_new_tokens=1,
                priority="gold")


@pytest.mark.parametrize("chunk", [None, 4])
def test_parked_victim_cancelled_releases_its_pin(chunk):
    """A victim cancelled while parked ends through the one terminal
    path: its resume pin is dropped and its parked time banked, as in JAX,
    and no page is left outside the prefix index."""
    jpim, tpim, _, _, cfg = build_pair()
    prompts = _prompts(cfg.vocab_size, 4)
    runs = {}
    for side in ("jax", "port"):
        ns = SIDES[side]
        clock = _Clock()
        pim = jpim if side == "jax" else tpim
        # three free pages: the interactive head is blocked on slots only,
        # so the victim's pin outlives the admission
        kw = dict(page_size=PAGE, num_pages=16, clock=clock,
                  prefill_chunk_tokens=chunk)
        eng = (JaxServingEngine(pim, **kw) if side == "jax"
               else ServingEngine(pim, device="cpu", **kw))
        for i in range(3):
            eng.submit(ns.Request(request_id=i, prompt_ids=prompts[i],
                                  max_new_tokens=BATCH_NEW,
                                  priority="batch"))
        clock.t = 0.1
        outs = eng.step()
        eng.submit(ns.Request(request_id=3, prompt_ids=prompts[3],
                              max_new_tokens=INT_NEW))
        clock.t = 0.2
        outs += eng.step()
        [victim] = [r for r in eng.scheduler._by_id.values()
                    if r.preemptions]
        assert victim.state.value == "queued" and victim.resume_keys
        eng.cancel(victim.request_id)
        clock.t = 0.5
        outs += eng.step()
        assert victim.resume_keys is None and victim.resume_pages == []
        outs += eng.run_until_complete(max_steps=100)
        eng._kv.assert_invariants()
        assert not eng._kv._resume
        assert eng._kv.alloc.in_use == eng._kv.index.evictable_pages()
        runs[side] = {o.request_id: (o.state, list(o.token_ids),
                                     round(o.preempted_ms, 6))
                      for o in outs}
    assert runs["port"] == runs["jax"]
    assert runs["port"][victim.request_id][0] == "cancelled"
    assert runs["port"][victim.request_id][2] == pytest.approx(300.0)
