"""PyTorch port: request-lifecycle tracing, the serving engine's telemetry
end to end, and the metrics server, against the JAX package.

- Tracer units: the same ``begin``/``end``/``instant`` sequence with
  explicit timestamps gives the JAX tracer's ``export_jsonl`` records
  (apart from the wall ``ts``) and Chrome events; ring bound, scopes,
  parenting.  ``tracer=None`` serves a full run without allocating a span.
- The engine beside the JAX engine, on the tiny pair and a step-driven
  fake clock, with a registry, a tracer, ``stats_path`` and an ``obs`` hub:
  three batch requests fill the slots, an interactive one preempts, a
  deadline expires (mid-chunk in chunked cases), a submit is shed, one is
  rate-limited, and a NaN fails one request; async and sync decode,
  chunked and whole prefill, fp and int8 pages, an adapter and a self
  draft at k = 2.  Greedy tokens, every counter of ``REGISTRY_METRICS``
  (the transfer counts where the port stages differently are checked
  against the rule that predicts them), the ``serving_stats`` records
  field by field apart from ``time``, and the span trees (names,
  parenting, request ids, attrs, fake-clock stamps) are equal.  The phase
  spans tile each request's latency and a victim's ``preempted`` phase is
  its ``preempted_ms``; JAX ``obs/report.py`` reads the port's run
  directory and gives the JAX engine's waterfall.
- ``replay_trace`` dumps the flight ring on an injected fault; ``close``
  seals open spans; two engines share one tracer through ``scoped``.
- ``/metrics`` serves the port registry's text and ``/healthz`` the
  liveness probe; ``device_trace`` on the CPU says it holds no device.
"""

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

import neuronx_distributed_tpu.obs as jax_obs
import neuronx_distributed_tpu.resilience.faults as jax_faults
import neuronx_distributed_tpu.serving as jax_serving
import neuronx_distributed_tpu_torch.obs as obs
import neuronx_distributed_tpu_torch.obs.tracing as tracing
import neuronx_distributed_tpu_torch.resilience.faults as faults
import neuronx_distributed_tpu_torch.serving as port_serving
from neuronx_distributed_tpu.obs.report import build_report, summarize_trace
from neuronx_distributed_tpu_torch.obs import MetricRegistry, Tracer
from neuronx_distributed_tpu_torch.obs.metrics_server import (
    MetricsServer,
    prometheus_from_scalars,
)
from neuronx_distributed_tpu_torch.resilience import InjectedFault
from neuronx_distributed_tpu_torch.serving import Request, ServingEngine
from neuronx_distributed_tpu_torch.trace import PhaseGraphs
from torch_port_pair import build_pair

PAGE = 4
PHASES = ("queue", "prefill", "decode", "preempted")
SIDES = {"jax": (jax_serving, jax_obs, jax_faults),
         "port": (port_serving, obs, faults)}


@pytest.fixture(autouse=True)
def _no_plans():
    faults.clear_plan()
    jax_faults.clear_plan()
    yield
    faults.clear_plan()
    jax_faults.clear_plan()


# -- tracer units against JAX ----------------------------------------------------


def _trace_ops(mod):
    tr = mod.Tracer(capacity=64, replica=2, clock=lambda: 7.0)
    root = tr.begin("request", request_id=9, t=1.0, priority="batch", hop=0)
    q = tr.begin("queue", request_id=9, parent=root, t=1.0)
    tr.instant("sched/blocked", request_id=9, parent=q, t=1.5, reason="pages")
    tr.end(q, t=2.0, slot=1)
    p = tr.begin("prefill", request_id=9, parent=root, t=2.0, slot=1)
    tr.end(tr.begin("prefill_chunk", request_id=9, parent=p, t=2.0,
                    pages=2), t=2.25)
    tr.end(p, t=2.5)
    step = tr.begin("decode_step", t=2.5, step=3, active=1)
    tr.instant("decode_slot", request_id=9, parent=step, t=3.0, slot=1)
    tr.end(step, t=3.0)
    tr.end(tr.begin("late", request_id=9, t=4.0), t=3.0)  # clamped
    other = tr.scoped(5)
    other.end(other.begin("request", request_id=-7, t=0.0))
    tr.end(root, t=3.5, state="finished")
    return tr


def test_tracer_exports_match_jax(tmp_path):
    out = {}
    for side, mod in (("jax", jax_obs), ("port", obs)):
        tr = _trace_ops(mod)
        ev, ch = tmp_path / f"{side}.jsonl", tmp_path / f"{side}.json"
        n = tr.export_jsonl(str(ev))
        tr.export_chrome(str(ch))
        recs = [{k: v for k, v in json.loads(line).items() if k != "ts"}
                for line in ev.read_text().splitlines()]
        out[side] = (n, recs, ch.read_text())
        assert obs.validate_jsonl("trace_event", str(ev)) == n
        assert jax_obs.validate_jsonl("trace_event", str(ev)) == n
    assert out["port"] == out["jax"]
    assert out["port"][0] == 9


def test_ring_scopes_and_parenting():
    tr = Tracer(capacity=4)
    for i in range(10):
        tr.end(tr.begin(f"s{i}"))
    assert [s.name for s in tr.spans()] == ["s6", "s7", "s8", "s9"]
    assert tr.dropped == 6
    tr.clear()
    assert tr.spans() == [] and tr.dropped == 0
    with tr.span("root", request_id=3) as root:
        with tr.span("child", request_id=3, parent=root):
            pass
    spans = {s.name: s for s in tr.spans()}
    assert spans["child"].parent_id == spans["root"].span_id
    a, b = tr.scoped(0), tr.scoped(1)
    a.end(a.begin("x"))
    b.end(b.begin("y"))
    assert [s.replica for s in tr.spans()[-2:]] == [0, 1]
    assert tr.end(None) is None
    with pytest.raises(ValueError):
        Tracer(capacity=0)


# -- the engine end to end against JAX -----------------------------------------

CASES = {
    "async-whole": dict(async_decode=True),
    "sync-chunk-int8": dict(async_decode=False, kv_quant="int8",
                            prefill_chunk_tokens=4),
    "async-chunk-adapters": dict(async_decode=True, adapters=True,
                                 prefill_chunk_tokens=4),
    "sync-whole-spec": dict(async_decode=False, spec=True),
}


class _StepClock:
    """The engine clock: constant within a step, advanced between steps,
    so every stamp is the same on both engines."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _serve(side, case, out_dir, part2=False):
    """The traffic of the module docstring through one side's engine with
    full telemetry (``part2``: the hub also builds the resource ledgers,
    the health monitor and the perf attribution, and the engine takes the
    hub's ledgers); returns the engine, registry, tracer, outputs and the
    refused submits."""
    ns, omod, fmod = SIDES[side]
    kw = dict(CASES[case])
    adapters = kw.pop("adapters", False)
    spec = kw.pop("spec", False)
    jpim, tpim, _, _, cfg = build_pair(3, 32 if spec else 16, 0)
    pim = jpim if side == "jax" else tpim
    k = 2 if spec else 0
    need = 2 + -(-(8 + k) // PAGE)
    os.makedirs(out_dir, exist_ok=True)
    clock = _StepClock()
    reg = omod.MetricRegistry()
    tracer = omod.Tracer(replica=0, clock=clock)
    hub = omod.Observability(out_dir, registry=reg, ledgers=part2,
                             health=part2, perf=part2)
    kw.update(page_size=PAGE, num_pages=3 * need + 1, clock=clock,
              registry=reg, tracer=tracer, obs=hub, shed_infeasible=True,
              stats_path=os.path.join(out_dir, "serving_stats.jsonl"))
    if part2:
        kw.update(compile_ledger=hub.compile_ledger,
                  memory_ledger=hub.memory_ledger)
        # a fresh compiled-program cache on each side, so that the ledger
        # sees every compile whatever ran earlier in this process
        if side == "jax":
            pim._serving_lru(reset=True)
        else:
            pim.graphs = PhaseGraphs(capture=pim.cuda_graphs)
    if spec:
        kw.update(draft=pim, spec_k=k)
    if adapters:
        from test_torch_tenancy import _stores

        jstore, tstore = _stores(jpim, tpim)
        kw["adapter_store"] = jstore if side == "jax" else tstore
    eng = (ns.ServingEngine(pim, **kw) if side == "jax"
           else ns.ServingEngine(pim, device="cpu", **kw))
    rs = np.random.RandomState(5)
    prompts = [rs.randint(1, cfg.vocab_size, size=5).tolist()
               for _ in range(7)]
    outs, refused = {}, {}

    def submit(rid, **rkw):
        try:
            eng.submit(ns.Request(request_id=rid, prompt_ids=prompts[rid],
                                  **rkw))
        except Exception as e:  # the shed and the rate-limited submits
            refused[rid] = type(e).__name__

    def step():
        clock.t += 0.01
        for o in eng.step():
            outs[o.request_id] = o

    for i in range(3):
        submit(i, max_new_tokens=8, priority="batch",
               deadline_s=0.025 if i == 2 else None,
               adapter_id=i % 3 if adapters else 0)
    step()
    submit(3, max_new_tokens=3, priority="interactive",
           adapter_id=1 if adapters else 0)
    step()
    step()
    submit(4, max_new_tokens=4, deadline_s=1e-4)
    eng.scheduler.set_tenant_limit(0, rate=1e-3, burst=1.0)
    submit(5, max_new_tokens=3, priority="batch")
    submit(6, max_new_tokens=3, priority="batch")
    eng.scheduler.clear_tenant_limits()
    for _ in range(20):  # until a request decodes: the NaN's target
        decoding = sorted((r.request_id, slot)
                          for slot, r in eng.scheduler.active()
                          if r.state.value == "decode")
        if decoding:
            break
        step()
    fmod.install_plan({"faults": [{
        "point": "serving/verify_logits" if spec else "serving/decode_logits",
        "action": "nan", "slot": decoding[0][1], "count": 1}]})
    for _ in range(200):
        if not eng.has_work:
            break
        step()
    fmod.clear_plan()
    eng.close()
    hub.close()
    tracer.export_jsonl(os.path.join(out_dir, "trace_events.jsonl"))
    if part2:  # the ledger stays on the shared model otherwise
        pim.compile_ledger = pim.perf = None
    return eng, reg, tracer, outs, refused


def _span_rows(tracer):
    return sorted((s.span_id, s.name, s.parent_id, s.request_id, s.replica,
                   s.t_start, s.t_end, json.dumps(s.attrs, sort_keys=True))
                  for s in tracer.spans())


def _transfer_rule(case, jsnap, psnap, peng):
    """The port keeps the sampler settings on the host, where each sampled
    row's generator is seeded: JAX puts them up after every admission and
    the port does not.  JAX's synchronous plain decode reads its tokens
    outside the audit; the port's goes through the same packed put and
    fetch as the async step."""
    puts, fetches = "transfer/explicit_puts_total", \
        "transfer/explicit_fetches_total"
    assert psnap[puts] == peng.puts and psnap[fetches] == peng.fetches
    sync_plain = not CASES[case]["async_decode"] and not CASES[case].get(
        "spec")
    if sync_plain:
        assert jsnap[puts] == 0
        assert psnap[fetches] - jsnap[fetches] == peng.decode_steps
        assert psnap[puts] == peng.decode_steps
    else:
        assert psnap[fetches] == jsnap[fetches]
        assert 0 < jsnap[puts] - psnap[puts] <= jsnap[
            "serving/admitted_total"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_telemetry_matches_jax(case, tmp_path):
    runs = {side: _serve(side, case, str(tmp_path / side))
            for side in ("jax", "port")}
    (jeng, jreg, jtr, jouts, jref), (peng, preg, ptr, pouts, pref) = (
        runs["jax"], runs["port"])

    # tokens and outcomes
    assert pref == jref == {4: "SLOInfeasible", 6: "RateLimited"}
    summary = {side: {i: (o.state, list(o.token_ids), o.preemptions)
                      for i, o in r[3].items()} for side, r in runs.items()}
    assert summary["port"] == summary["jax"]
    states = {i: s[0] for i, s in summary["port"].items()}
    assert states[2] == "timed_out"
    if CASES[case].get("prefill_chunk_tokens"):  # it expired mid-chunk
        assert pouts[2].prefill_chunks >= 1 and not pouts[2].token_ids
    assert sorted(states.values()).count("failed") == 1
    assert [o.finish_reason for o in pouts.values()
            if o.state == "failed"] == ["non_finite_logits"]
    assert sum(s[2] for s in summary["port"].values()) >= 1

    # every counter and histogram count of the contract
    jsnap, psnap = jreg.snapshot(), preg.snapshot()
    for name, kind in obs.REGISTRY_METRICS.items():
        if name.startswith("transfer/") or name == "serving/host_blocked_ms":
            continue
        a, b = jsnap.get(name), psnap.get(name)
        if kind == "histogram":
            a, b = a and a["count"], b and b["count"]
        if kind != "gauge":
            assert (a or 0) == (b or 0), name
    _transfer_rule(case, jsnap, psnap, peng)
    assert psnap["transfer/fetch_wait_ms"]["count"] == peng.fetches
    assert psnap["serving/preemptions_total"] == peng.preemptions >= 1
    assert psnap["serving/shed_total"] == peng.shed == 1
    assert psnap["serving/rejected_total"] == peng.rejected == 1
    assert psnap["serving/prefill_chunks_total"] == peng.prefill_chunks
    assert psnap.get("kvcache/quant_pages_total", 0) == peng.quant_pages
    # a victim's tokens before its park count too (its output restarts)
    assert psnap["serving/tokens_total"] >= sum(
        len(o.token_ids) for o in pouts.values())
    assert psnap["serving/intertoken_ms"]["count"] >= sum(
        len(o.intertoken_ms) for o in pouts.values())
    if CASES[case]["async_decode"]:
        assert psnap["transfer/guarded_sections_total"] == peng._steps
    obs.validate_registry_metrics(preg)

    # serving_stats records, field by field apart from the wall time
    recs = {}
    for side in ("jax", "port"):
        path = str(tmp_path / side / "serving_stats.jsonl")
        assert jax_obs.validate_jsonl("serving_stats", path) == 5
        assert obs.validate_jsonl("serving_stats", path) == 5
        recs[side] = [{k: v for k, v in json.loads(line).items()
                       if k != "time"} for line in open(path)]
    assert recs["port"] == recs["jax"]
    assert all(r["schema"] == "serving_stats/6" and r["weights_version"] == 0
               and r["trace_id"] == r["request_id"] for r in recs["port"])

    # span trees: names, parents, request ids, attrs and stamps
    assert _span_rows(ptr) == _span_rows(jtr)
    spans = ptr.spans()
    for rid, out in pouts.items():
        mine = [s for s in spans if s.request_id == rid]
        phases = {p: sum(s.duration_ms for s in mine if s.name == p)
                  for p in PHASES}
        assert sum(phases.values()) == pytest.approx(out.total_ms, abs=1e-6)
        assert phases["preempted"] == pytest.approx(out.preempted_ms,
                                                    abs=1e-6)
        roots = {s.span_id for s in mine if s.name == "request"}
        assert all(s.parent_id in roots for s in mine if s.name in PHASES)
        slots = [s for s in mine if s.name in ("decode_slot", "spec_slot")]
        # stale rows after a re-grant record nothing: one per decode step
        assert len(slots) == out.decode_steps
    assert {s.request_id for s in spans if s.name == "request"} == {
        0, 1, 2, 3, 4, 5, 6}

    # the JAX report reads the port's run directory as it reads JAX's
    reports = {side: build_report(run_dir=str(tmp_path / side))
               for side in ("jax", "port")}
    for side in ("jax", "port"):
        jax_obs.validate_record("obs_report", reports[side])
    assert reports["port"]["trace"] == reports["jax"]["trace"]
    assert reports["port"]["trace"]["requests"] == 7
    flight = json.load(open(tmp_path / "port" / "flight_record.json"))
    jax_obs.schemas.validate_flight_document(flight)
    assert flight["steps_recorded"] == peng._steps


def test_tracer_off_allocates_no_span(tmp_path):
    """The default engine, with a registry, stats and a hub but no tracer,
    allocates no span; its records carry a null trace id."""
    _, tpim, _, _, cfg = build_pair()
    rs = np.random.RandomState(0)
    before = tracing.SPANS_CREATED
    hub = obs.Observability(str(tmp_path))
    eng = ServingEngine(tpim, page_size=PAGE, num_pages=16, obs=hub,
                        stats_path=str(tmp_path / "s.jsonl"), device="cpu")
    for i in range(4):
        eng.submit(Request(request_id=i, max_new_tokens=4, prompt_ids=rs.randint(
            1, cfg.vocab_size, size=5).tolist()))
    outs = eng.run_until_complete(max_steps=200)
    eng.close()
    assert len(outs) == 4 and tracing.SPANS_CREATED == before
    assert all(o.trace_id is None for o in outs)
    assert eng.registry is hub.registry
    assert hub.flight.steps_recorded == eng._steps


def test_replay_trace_dumps_the_flight_ring_on_a_fault(tmp_path):
    """An exception plan mid-chunk through ``replay_trace``: the fault
    propagates, the ring lands in ``flight_record.json`` with the steps
    before it, and the drive span records the crash."""
    _, tpim, _, _, _ = build_pair()
    hub = obs.Observability(str(tmp_path))
    tracer = Tracer()
    eng = ServingEngine(tpim, page_size=PAGE, num_pages=16, obs=hub,
                        tracer=tracer, prefill_chunk_tokens=4, device="cpu")
    reqs = [Request(request_id=i, prompt_ids=list(range(1, 9)),
                    max_new_tokens=4) for i in range(2)]
    faults.install_plan({"faults": [{"point": "serving/prefill_chunk",
                                     "action": "exception",
                                     "match": {"request_id": 1}}]})
    with pytest.raises(InjectedFault):
        port_serving.replay_trace(eng, [0.0, 0.0], reqs)
    doc = json.load(open(tmp_path / "flight_record.json"))
    jax_obs.schemas.validate_flight_document(doc)
    assert doc["reason"] == "crash:InjectedFault"
    assert doc["steps_recorded"] == eng._steps - 1 >= 1
    assert [r["step"] for r in doc["records"]] == list(
        range(1, eng._steps))
    # the failed chunk's span and the request's failure are in the trace
    names = {(s.name, s.attrs.get("failed")) for s in tracer.spans()}
    assert ("prefill_chunk", "InjectedFault") in names
    # the port driver's own span, on the replay's clock
    drive = Tracer()
    t = [0.0]

    def clock():
        t[0] += 1.0
        return t[0]

    eng2 = ServingEngine(tpim, page_size=PAGE, num_pages=16, device="cpu")
    port_serving.replay(eng2, [0.0], [Request(request_id=0, prompt_ids=[1, 2],
                                              max_new_tokens=2)],
                        clock=clock, tracer=drive)
    [span] = drive.spans()
    assert span.name == "drive/replay" and span.attrs["completed"] == 1


def test_close_seals_open_spans_and_scoped_engines_share_a_ring(tmp_path):
    _, tpim, _, _, _ = build_pair()
    tracer = Tracer()
    engines = [ServingEngine(tpim, page_size=PAGE, num_pages=16,
                             tracer=tracer.scoped(r), device="cpu")
               for r in (0, 1)]
    for r, eng in enumerate(engines):
        for i in range(4):  # one more than the slots: one stays queued
            eng.submit(Request(request_id=10 * r + i, prompt_ids=[1, 2, 3],
                               max_new_tokens=6))
        eng.step()
        eng.close()
    spans = tracer.spans()
    assert {s.replica for s in spans} == {0, 1}
    aborted = [s for s in spans if s.attrs.get("aborted")]
    assert {s.name for s in aborted} >= {"request", "queue", "decode"}
    assert len({s.span_id for s in spans}) == len(spans)


def test_engine_refuses_part2_arguments_and_bad_guard(tmp_path):
    """Part 2's arguments, which raised before the port reached them, are
    taken and attached (the model carries the compile ledger and the
    perf attribution; the memory ledger accounts the pool); a bad guard
    still raises."""
    _, tpim, _, _, _ = build_pair()
    led, mem = obs.CompileLedger(), obs.MemoryLedger()
    mon, perf = obs.HealthMonitor(obs.default_rules("serving")), \
        obs.PerfAttribution()
    try:
        eng = ServingEngine(tpim, page_size=PAGE, device="cpu",
                            compile_ledger=led, memory_ledger=mem,
                            health=mon, perf=perf)
        assert tpim.compile_ledger is led and tpim.perf is perf
        assert led.registry is eng.registry and mon.registry is eng.registry
        assert mem.subsystems()["kv_pool"]["bytes"] == (
            eng._kv.alloc.num_pages * eng._page_bytes)
    finally:
        tpim.compile_ledger = tpim.perf = None
    with pytest.raises(ValueError, match="transfer_guard"):
        ServingEngine(tpim, page_size=PAGE, transfer_guard="observe",
                      device="cpu")
    eng = ServingEngine(tpim, page_size=PAGE, transfer_guard="forbid",
                        step_timeout_s=0.0, device="cpu")
    eng.submit(Request(request_id=0, prompt_ids=[1, 2], max_new_tokens=3))
    eng.run_until_complete(max_steps=20)
    snap = eng.registry.snapshot()
    # every step is slower than a zero watchdog; on the CPU the guard
    # counts its sections and enforces nothing
    assert snap["serving/slow_steps_total"] == eng._steps
    assert snap["transfer/guarded_sections_total"] == eng._steps
    assert eng.dump_flight("no hub") is None


# -- the metrics server, the device trace, the timeline -------------------------


def test_metrics_server_serves_metrics_and_healthz():
    reg = MetricRegistry()
    reg.counter("serving/tokens_total").inc(7)
    reg.histogram("serving/step_ms", obs.MS_BUCKETS).observe(3.0)
    state = {"ok": True}

    monitor = obs.HealthMonitor(obs.default_rules("serving"), registry=reg)
    with MetricsServer(reg, health_fn=lambda: dict(state), monitor=monitor,
                       scopes={"x": lambda: "x 1\n"}, port=0,
                       host="127.0.0.1") as srv:
        base = f"http://127.0.0.1:{srv.port}"
        body = urllib.request.urlopen(base + "/metrics").read().decode()
        assert body == reg.prometheus_text()
        assert "serving_tokens_total 7" in body
        assert urllib.request.urlopen(
            base + "/metrics?scope=x").read() == b"x 1\n"
        health = json.loads(urllib.request.urlopen(base + "/healthz").read())
        assert health == {"ok": True, "firing": [], "alerts_firing": 0,
                          "worst_severity": None}
        state["ok"] = False
        for path, code in (("/healthz", 503), ("/nope", 404),
                           ("/metrics?scope=fleet", 400)):
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(base + path)
            assert exc.value.code == code
    with pytest.raises(ValueError):
        MetricsServer()


def test_prometheus_from_scalars_reassembles_histograms():
    reg = MetricRegistry()
    reg.counter("serving/tokens_total").inc(3)
    reg.gauge("serving/queue_depth").set(2)
    reg.histogram("serving/step_ms", (1.0, 10.0)).observe(0.5)
    recs = reg.to_scalar_records(step=4)
    text = prometheus_from_scalars(recs)
    from neuronx_distributed_tpu.obs.metrics_server import (
        prometheus_from_scalars as jax_prometheus_from_scalars,
    )

    assert text == jax_prometheus_from_scalars(recs)
    assert 'serving_step_ms_bucket{le="+Inf"} 1' in text


def test_device_trace_on_the_cpu_says_so(tmp_path):
    import torch

    with obs.device_trace(str(tmp_path)) as prof:
        (torch.ones(4) + 1).sum()
    doc = json.load(open(tmp_path / tracing.DEVICE_TRACE_FILE))
    assert doc["device_trace"] == "cpu_only"
    assert doc["traceEvents"] and prof is not None


def test_timeline_writes_a_chrome_trace(tmp_path):
    from neuronx_distributed_tpu_torch.utils.timeline import Timeline

    path = tmp_path / "host_trace.json"
    tl = Timeline(str(path))
    with tl.event("data"):
        pass
    tl.mark_step_end(step=1)
    text = path.read_text()
    assert text.startswith("[\n")
    events = [json.loads(line.rstrip(",")) for line in text.splitlines()[1:]]
    assert [e["name"] for e in events] == ["data", "step_end"]
    assert all(e["pid"] == 0 for e in events)
    Timeline(None).mark_step_end(step=2)  # disabled: writes nothing


def test_summarize_trace_of_port_spans_matches_jax(tmp_path):
    out = {}
    for side, mod in (("jax", jax_obs), ("port", obs)):
        tr = mod.Tracer(replica=0, clock=lambda: 0.0)
        for rid, (q, p, d) in {1: (1.0, 2.0, 3.0),
                               2: (0.5, 0.5, 9.0)}.items():
            root = tr.begin("request", request_id=rid, hop=0, t=0.0)
            tr.end(tr.begin("queue", request_id=rid, parent=root, t=0.0), t=q)
            tr.end(tr.begin("prefill", request_id=rid, parent=root, t=q),
                   t=q + p)
            tr.end(tr.begin("decode", request_id=rid, parent=root, t=q + p),
                   t=q + p + d)
            tr.end(root, t=q + p + d, state="finished")
        ev = tmp_path / f"{side}.jsonl"
        tr.export_jsonl(str(ev))
        out[side] = summarize_trace([str(ev)], [
            {"trace_id": 2, "total_ms": 10_000.0, "state": "finished"}])
    assert out["port"] == out["jax"]
    assert out["port"]["slowest"][0]["request_id"] == 2
