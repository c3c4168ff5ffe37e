"""PyTorch port: the resource ledgers, the perf attribution and the health
rules (ROADMAP A8 part 2) in the serving engine, against the JAX package.

- The engine beside the JAX engine on the tiny pair, with the traffic of
  ``test_torch_tracing`` (preemption, shedding, a rate limit, a NaN) on a
  step-constant clock and a hub with ``ledgers=True, health=True,
  perf=True``, in the four cases there: the port's compile families are
  the JAX families of the same phase programs (the port compiles only its
  phase-graph phases; prefill, page writes and the sampler run eagerly),
  each key compiled once on both sides; the memory subsystems (params,
  ``kv_pool``, the draft, the adapter pool) are equal in bytes; the alert
  edges are the same rules, states and stamps; the ``perf_attribution``
  records have the same families, calls and phase milliseconds (exact:
  the engine-clock deltas are the same floats).  Costs differ by design
  (XLA's cost analysis against the port's storage count).
- Without part 2's arguments a full run moves none of
  ``LEDGER_ROWS``, ``PERF_RECORDS``, ``ALERTS_EVALUATED``.
- The compile ledger and the memory ledger op for op against JAX's (rows
  apart from ``time``/``mono``, summaries, thrash, storms in the tracer
  and the flight recorder); ``is_oom`` takes ``torch.cuda.
  OutOfMemoryError``; ``tree_bytes`` counts a module's parameters once.
- An out-of-memory error in ``step`` writes ``memory_breakdown.json``
  (reason ``oom:...``, ``params`` first) and propagates; a capture after
  ``declare_warmup_done`` is one storm, one ``compile_storm`` firing edge,
  and ``/healthz`` names it.
"""

import json
import os
import urllib.request
from collections import Counter

import numpy as np
import pytest
import torch

import neuronx_distributed_tpu.obs as jax_obs
import neuronx_distributed_tpu.obs.compile_ledger as jax_cl
import neuronx_distributed_tpu.obs.memory_ledger as jax_ml
import neuronx_distributed_tpu_torch.obs as obs
import neuronx_distributed_tpu_torch.obs.compile_ledger as cl
import neuronx_distributed_tpu_torch.obs.health as health
import neuronx_distributed_tpu_torch.obs.memory_ledger as ml
import neuronx_distributed_tpu_torch.obs.perf as perf
from neuronx_distributed_tpu_torch.obs.metrics_server import MetricsServer
from neuronx_distributed_tpu_torch.serving import Request, ServingEngine
from neuronx_distributed_tpu_torch.trace import PhaseGraphs
from test_torch_tracing import CASES, PAGE, _no_plans, _serve  # noqa: F401
from torch_port_pair import build_pair

# the programs the port captures (PhaseGraphs), by their JAX family names
PHASE_GRAPH_PROGRAMS = {"decode_pages", "decode_pages_lora", "verify_pages",
                        "decode_slots"}
SUBSYSTEMS = ("params", "kv_pool", "draft_kv", "draft_params", "adapter_pool")


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_part2_matches_jax(case, tmp_path):
    for side in ("jax", "port"):
        _serve(side, case, str(tmp_path / side), part2=True)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")

    # compile rows: the port's phase-graph families, each key once
    rows = {d: _jsonl(os.path.join(d, "compile_ledger.jsonl"))
            for d in (jdir, pdir)}
    assert jax_obs.validate_jsonl(
        "compile_ledger", os.path.join(pdir, "compile_ledger.jsonl")) > 0
    fams = {d: Counter(r["family"] for r in rs if r["event"] == "compile")
            for d, rs in rows.items()}
    assert fams[pdir] == Counter({f: n for f, n in fams[jdir].items()
                                  if f in PHASE_GRAPH_PROGRAMS})
    assert fams[pdir]
    for r in rows[pdir]:
        if r["event"] == "compile":
            assert r["kind"] == "eager" and not r["after_warmup"]
            assert r["flops"] > 0 and r["bytes_accessed"] > 0

    # memory subsystems, byte for byte
    mem = {d: json.load(open(os.path.join(d, "memory_breakdown.json")))
           for d in (jdir, pdir)}
    jax_obs.validate_record("memory_breakdown", mem[pdir])
    subs = {d: {k: v["bytes"] for k, v in m["subsystems"].items()
                if k in SUBSYSTEMS} for d, m in mem.items()}
    assert subs[pdir] == subs[jdir]
    assert {"params", "kv_pool"} <= set(subs[pdir])
    assert mem[pdir]["device"] is None  # no device truth on the CPU

    # alert edges: the same rules, severities, states and stamps
    def edges(d):
        path = os.path.join(d, "alerts.jsonl")
        return [(a["rule"], a["severity"], a["state"], a["window"],
                 a["observed"], a["mono"])
                for a in (_jsonl(path) if os.path.exists(path) else [])]

    assert edges(pdir) == edges(jdir)
    assert edges(pdir)

    # perf attribution: families, calls and phase ms
    def table(d):
        return {r["family"]: (r["calls"], r["device_ms"])
                for r in _jsonl(os.path.join(d, "perf_attribution.jsonl"))}

    assert jax_obs.validate_jsonl(
        "perf_attribution", os.path.join(pdir, "perf_attribution.jsonl")) > 1
    jt, pt = table(jdir), table(pdir)
    assert set(pt) == set(jt)
    for fam, (calls, ms) in pt.items():
        assert calls == jt[fam][0], fam
        assert ms == pytest.approx(jt[fam][1], rel=1e-6, abs=1e-9), fam


def test_part2_off_allocates_nothing():
    """A full run with a tracer-free, hub-free engine: no ledger row, perf
    record or rule evaluation is made."""
    _, tpim, _, _, cfg = build_pair()
    before = (cl.LEDGER_ROWS, perf.PERF_RECORDS, health.ALERTS_EVALUATED)
    eng = ServingEngine(tpim, page_size=PAGE, device="cpu")
    rs = np.random.RandomState(0)
    for i in range(4):
        eng.submit(Request(request_id=i, prompt_ids=rs.randint(
            1, cfg.vocab_size, size=5).tolist(), max_new_tokens=4))
    assert len(eng.run_until_complete(max_steps=100)) == 4
    eng.close()
    assert (cl.LEDGER_ROWS, perf.PERF_RECORDS,
            health.ALERTS_EVALUATED) == before


# -- the ledgers op for op against JAX -----------------------------------------


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def _drive_compile_ledger(mod, path):
    reg = (jax_obs if mod is jax_cl else obs).MetricRegistry()
    led = mod.CompileLedger(path=path, registry=reg, wall=_Clock(),
                            clock=_Clock())
    led.set_capacity("decode_pages", 2)
    for i, fam in enumerate(("decode_pages", "verify_pages",
                             "decode_pages", "decode_pages")):
        led.cache_miss(fam)
        led.record_compile(fam, (fam, i), 10.0 * (i + 1), kind="cuda_graph")
        led.cache_hit(fam)
    led.record_eviction("decode_pages", ("decode_pages", 0), capacity=2)
    led.declare_warmup_done("engine")
    led.record_compile("decode_slots", ("decode_slots", 9), 5.0,
                       kind="cuda_graph")
    return led, reg


def test_compile_ledger_matches_jax(tmp_path):
    out = {}
    for name, mod in (("jax", jax_cl), ("port", cl)):
        path = str(tmp_path / f"{name}.jsonl")
        led, reg = _drive_compile_ledger(mod, path)
        out[name] = (led.rows, led.summary(), led.storms, led.warnings,
                     reg.snapshot(), mod.read_compile_ledger(path))
        assert jax_obs.validate_jsonl("compile_ledger", path) == len(led.rows)
    (jrows, jsum, jst, jw, jsnap, jread), (prows, psum, pst, pw, psnap,
                                           pread) = out["jax"], out["port"]
    assert prows == jrows and pread == jread
    assert psum == jsum and pst == jst == 1
    assert [w["detector"] for w in pw] == [w["detector"] for w in jw] == [
        "compile_thrash", "compile_storm"]
    # the port pre-declares the ledger's counters (at 0: the eviction
    # counter is the phase-graph cache's to move)
    assert {k: psnap[k] for k in jsnap} == jsnap
    assert all(psnap[k] == 0 for k in set(psnap) - set(jsnap))
    assert cl.summarize_compile_records(prows) == \
        jax_cl.summarize_compile_records(jrows)
    assert cl.jit_cache_size(lambda: None) is None


def test_compile_storm_reaches_tracer_and_flight():
    tracer = obs.Tracer()
    flight = obs.FlightRecorder(capacity=4)
    led = obs.CompileLedger(tracer=tracer, flight=flight)
    led.declare_warmup_done()
    led.record_compile("decode_pages", "k", 12.5,
                       cost={"flops": 2.0, "bytes_accessed": 3.0,
                             "declared_flops": 1.0})
    row = led.rows[-1]
    assert row["storm"] and row["flops"] == 2.0 and row["bytes_accessed"] == 3.0
    assert "declared_flops" not in row
    span = tracer.spans()[-1]
    assert span.name == "compile" and span.attrs["storm"]
    assert span.duration_ms >= 12.5  # the stall before the row, and after
    assert flight.warnings[-1]["detector"] == "compile_storm"
    with led.timed("verify_pages", "k2") as rec:
        rec["cost"] = {"flops": 7.0, "temp_size_in_bytes": 64.0}
    assert led.rows[-1]["flops"] == 7.0 and led.rows[-1]["kind"] == "cuda_graph"


def _drive_memory_ledger(mod):
    reg = (jax_obs if mod is jax_ml else obs).MetricRegistry()
    led = mod.MemoryLedger(registry=reg, wall=lambda: 5.0)
    led.set("params", 1000)
    led.set("kv_pool", 300)
    led.add("kv_pool", 200)
    led.add("kv_pool", -400)
    led.set("adapter_pool", 50)
    led.note_program("decode_pages", {"temp_size_in_bytes": 70.0,
                                      "flops": 9.0})
    return led, reg


def test_memory_ledger_matches_jax(tmp_path):
    (jled, jreg), (pled, preg) = (_drive_memory_ledger(jax_ml),
                                  _drive_memory_ledger(ml))
    assert pled.subsystems() == jled.subsystems()
    assert pled.top() == jled.top() and pled.top()[0][0] == "params"
    assert (pled.total_bytes, pled.peak_total_bytes) == (
        jled.total_bytes, jled.peak_total_bytes)
    assert preg.snapshot() == jreg.snapshot()
    jdoc, pdoc = jled.breakdown("x"), pled.breakdown("x")
    assert pdoc.pop("remainder_bytes") is None  # no device poll
    jdoc.pop("device"), pdoc.pop("device")
    assert pdoc == jdoc
    path = pled.dump(str(tmp_path / "m.json"), reason="close")
    assert jax_ml.read_memory_breakdown(path)["reason"] == "close"
    if not torch.cuda.is_available():  # no device truth on the CPU
        assert pled.poll_device() is None and pled.headroom_bytes() is None


def test_is_oom_and_tree_bytes():
    assert ml.is_oom(torch.cuda.OutOfMemoryError("CUDA out of memory"))
    assert ml.is_oom(RuntimeError("RESOURCE_EXHAUSTED: hbm"))
    assert not ml.is_oom(RuntimeError("boom"))
    lin = torch.nn.Linear(4, 3)
    assert ml.tree_bytes(lin) == (12 + 3) * 4
    t = torch.zeros(5, dtype=torch.bfloat16)
    assert ml.tree_bytes({"a": [t, (t, lin.weight)]}) == 10 + 48


# -- the engine: out of memory, storms, alerts, /healthz ---------------------


def test_engine_oom_dump_names_params_and_propagates(tmp_path, monkeypatch):
    _, tpim, _, _, cfg = build_pair()
    mem = obs.MemoryLedger(path=str(tmp_path / "memory_breakdown.json"))
    eng = ServingEngine(tpim, page_size=PAGE, device="cpu",
                        memory_ledger=mem)
    eng.submit(Request(request_id=0, prompt_ids=[1, 2, 3],
                       max_new_tokens=4))

    def oom(*a, **kw):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                          "allocate 1.00 TiB")

    monkeypatch.setattr(tpim, "decode_pages", oom)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        eng.run_until_complete(max_steps=10)
    doc = json.load(open(tmp_path / "memory_breakdown.json"))
    jax_obs.validate_record("memory_breakdown", doc)
    assert doc["reason"] == "oom:OutOfMemoryError"
    assert doc["top"][0][0] == "params"
    assert doc["subsystems"]["kv_pool"]["bytes"] == (
        eng._kv.alloc.num_pages * eng._page_bytes)


def test_storm_after_warmup_fires_compile_storm_and_healthz(tmp_path):
    _, tpim, _, _, cfg = build_pair()
    tpim.graphs = PhaseGraphs(capture=False)  # no key of an earlier test
    hub = obs.Observability(str(tmp_path), ledgers=True, health="serving",
                            perf=True)
    try:
        eng = ServingEngine(tpim, page_size=PAGE, device="cpu", obs=hub,
                            compile_ledger=hub.compile_ledger,
                            memory_ledger=hub.memory_ledger)
        for i in range(3):
            eng.submit(Request(request_id=i, prompt_ids=[1 + i, 2, 3],
                               max_new_tokens=5))
        eng.run_until_complete(max_steps=50)
        eng.declare_warmup_done()
        steady = hub.compile_ledger.mark()
        for i in range(3, 6):  # the same keys: replays only
            eng.submit(Request(request_id=i, prompt_ids=[1 + i, 2, 3],
                               max_new_tokens=5))
        eng.run_until_complete(max_steps=50)
        assert hub.compile_ledger.compiles_since(steady) == 0
        assert hub.health_monitor.page_edges() == 0
        # a second engine over the same model: a new pool is a new key
        eng2 = ServingEngine(tpim, page_size=PAGE, device="cpu", obs=hub,
                             compile_ledger=hub.compile_ledger)
        eng2.submit(Request(request_id=9, prompt_ids=[4, 5],
                            max_new_tokens=3))
        eng2.step()  # its first decode compiles: the rule fires at once
        snap = hub.registry.snapshot()
        assert snap["trace/compile_storms_total"] == 1.0
        assert hub.compile_ledger.storms == 1
        firing = [e for e in hub.health_monitor.edges
                  if e["rule"] == "compile_storm" and e["state"] == "firing"]
        assert len(firing) == 1
        with MetricsServer(hub.registry, monitor=hub.health_monitor, port=0,
                           host="127.0.0.1") as srv:
            hz = json.loads(urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/healthz").read())
        # a warn-severity rule: named, and the target stays ready
        assert hz["firing"] == ["compile_storm"] and hz["ok"]
        eng2.run_until_complete(max_steps=20)
        assert hub.compile_ledger.storms == 1
    finally:
        tpim.compile_ledger = tpim.perf = None
        hub.close()
    edges = [a["state"] for a in _jsonl(str(tmp_path / "alerts.jsonl"))
             if a["rule"] == "compile_storm"]
    assert edges == ["firing", "resolved"]
    assert jax_obs.validate_jsonl("alert", str(tmp_path / "alerts.jsonl"))


def test_first_storm_fires_where_jax_misses_it():
    """ROADMAP C3: the JAX ledger creates ``trace/compile_storms_total`` at
    the first storm, and the rate rule's first sight of a metric has no
    delta, so that storm fires nothing; the port pre-declares the counter
    and the first storm fires."""
    edges = {}
    for side, omod in (("jax", jax_obs), ("port", obs)):
        reg = omod.MetricRegistry()
        led = omod.CompileLedger(registry=reg)
        mon = omod.HealthMonitor(omod.default_rules("serving"), registry=reg)
        mon.on_step(now=1.0)
        led.declare_warmup_done()
        led.record_compile("decode_pages", "late", 5.0)
        mon.on_step(now=2.0)
        mon.on_step(now=3.0)
        edges[side] = [(e["rule"], e["state"]) for e in mon.edges]
    assert edges["jax"] == []
    assert edges["port"] == [("compile_storm", "firing"),
                             ("compile_storm", "resolved")]
