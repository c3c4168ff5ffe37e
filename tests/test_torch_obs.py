"""PyTorch port: the observability core (``obs.registry``, ``obs.flight``,
``obs.transfer_audit`` and the ``Observability`` hub) against the JAX
package.

- The same seeded sequence of counter, gauge and histogram operations
  through JAX's ``MetricRegistry`` and the port's gives identical
  Prometheus text, equal ``scalars.jsonl`` records apart from ``time`` and
  ``mono``, and the same histograms reassembled by ``read_histograms``;
  the units of JAX ``tests/test_obs.py`` (round trip, get-or-create, kind
  and bucket conflicts, Prometheus semantics, name sanitizing) hold.
- The flight recorder: the same records give the same detector warnings
  and the same dump apart from times; a ``torch.Tensor`` field raises a
  ``TypeError`` naming it and is never read.
- The hub writes ``scalars.jsonl``, ``flight_record.json`` and
  ``metrics.prom`` in the formats JAX validates, and builds part 2's
  ledgers, monitor and attribution as the JAX hub does.
- The transfer audit: modes, counts, the ``forbid`` guard is only counted
  on the CPU, and a section restores what it changed.
- Scraping threads racing the one writer thread lose no update.
"""

import json
import math

import numpy as np
import pytest
import torch

import neuronx_distributed_tpu.obs as jax_obs
import neuronx_distributed_tpu.obs.flight as jax_flight
import neuronx_distributed_tpu.obs.registry as jax_registry
import neuronx_distributed_tpu.obs.schemas as jax_schemas
import neuronx_distributed_tpu_torch.obs as obs
import neuronx_distributed_tpu_torch.obs.flight as flight
import neuronx_distributed_tpu_torch.obs.registry as registry
from neuronx_distributed_tpu_torch.obs import (
    FlightRecorder,
    MetricRegistry,
    Observability,
    TransferAudit,
)
from neuronx_distributed_tpu_torch.obs.transfer_audit import allow_sync

SIDES = {"jax": (jax_registry, jax_flight), "port": (registry, flight)}


def _same(a, b) -> bool:
    """Equality that counts NaN equal to NaN (through its JSON text)."""
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


# -- the registry, op for op against JAX ----------------------------------------


def _drive_registry(mod, seed):
    """A seeded mix of registrations and updates, NaN and inf included."""
    rs = np.random.RandomState(seed)
    reg = mod.MetricRegistry()
    names = [f"serving/m{i}" for i in range(4)]
    for _ in range(60):
        op = rs.randint(4)
        name = names[rs.randint(len(names))]
        if op == 0:
            reg.counter(name + "_total").inc(float(rs.randint(0, 5)))
        elif op == 1:
            reg.gauge(name + "/g").set(float(rs.choice(
                [rs.uniform(-5, 5), math.nan, math.inf, 3.0])))
        elif op == 2:
            reg.gauge(name + "/g").inc(0.5)
        else:
            h = reg.histogram(name + "_ms", obs.MS_BUCKETS)
            h.observe(float(rs.choice([rs.exponential(40.0), math.nan,
                                       1.0, 30000.0, 1e6])))
    reg.histogram("edge_ms", (0.001, 0.5, 1.0)).observe(0.5)
    reg.gauge("train/loss-ema").set(2.0)
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_matches_jax_op_for_op(seed):
    jreg = _drive_registry(jax_registry, seed)
    preg = _drive_registry(registry, seed)
    assert preg.prometheus_text() == jreg.prometheus_text()
    assert _same(preg.snapshot(), jreg.snapshot())

    def strip(recs):
        return [{k: v for k, v in r.items() if k not in ("time", "mono")}
                for r in recs]

    jrecs = jreg.to_scalar_records(step=3)
    precs = preg.to_scalar_records(step=3)
    assert strip(precs) == strip(jrecs)
    assert all(set(r) == {"step", "tag", "value", "time", "mono"}
               for r in precs)
    assert preg.to_scalar_records(1, now=10.0, mono=5.0)[0]["mono"] == 5.0
    assert (registry.read_histograms(precs)
            == jax_registry.read_histograms(jrecs))
    jax_schemas.validate_registry_metrics(preg)


def test_registry_scalar_roundtrip(tmp_path):
    """The dump is the ``scalars`` schema; values survive the JSONL round
    trip exactly and the histograms reassemble."""
    reg = MetricRegistry()
    reg.counter("steps_total").inc(5)
    reg.gauge("train/loss").set(2.25)
    h = reg.histogram("lat_ms", (1.0, 10.0))
    h.observe(0.5)
    h.observe(5.0)
    path = tmp_path / "scalars.jsonl"
    reg.dump_jsonl(str(path), step=7)
    back = [json.loads(line) for line in path.read_text().splitlines()]
    assert obs.validate_jsonl("scalars", str(path)) == len(back)
    assert jax_obs.validate_jsonl("scalars", str(path)) == len(back)
    by_tag = {r["tag"]: r for r in back}
    assert by_tag["steps_total"]["value"] == 5.0
    assert by_tag["train/loss"]["value"] == 2.25
    assert all(r["step"] == 7 for r in back)
    hists = registry.read_histograms(back)
    assert hists["lat_ms"]["count"] == 2 and hists["lat_ms"]["sum"] == 5.5
    assert hists["lat_ms"]["buckets"] == {"1": 1.0, "10": 2.0, "inf": 2.0}


def test_registry_get_or_create_and_kind_conflict():
    reg = MetricRegistry()
    assert reg.counter("c") is reg.counter("c")
    with pytest.raises(ValueError):
        reg.gauge("c")
    h = reg.histogram("h", (1.0, 2.0))
    assert reg.histogram("h", (1.0, 2.0)) is h
    with pytest.raises(ValueError, match="boundaries"):
        reg.histogram("h", (1.0, 2.0, 3.0))
    with pytest.raises(ValueError, match="negative"):
        reg.counter("c").inc(-1)


def test_histogram_bucketing():
    """Prometheus semantics: inclusive upper edges, one implicit +Inf
    bucket, NaN observations ignored."""
    reg = MetricRegistry()
    h = reg.histogram("h", (1.0, 10.0, 100.0))
    for v in (0.5, 1.0, 5.0, 50.0, 500.0, float("nan")):
        h.observe(v)
    assert h.count == 5 and h.sum == 556.5
    assert h.counts == [2, 1, 1, 1]
    assert h.cumulative() == [(1.0, 2), (10.0, 3), (100.0, 4), (math.inf, 5)]
    with pytest.raises(ValueError):
        reg.histogram("bad", (10.0, 1.0))
    text = reg.prometheus_text()
    assert "# TYPE h histogram" in text
    assert 'h_bucket{le="1"} 2' in text
    assert 'h_bucket{le="+Inf"} 5' in text
    assert "h_count 5" in text


def test_prometheus_text_sanitizes_names():
    reg = MetricRegistry()
    reg.gauge("train/loss-ema").set(1.0)
    reg.gauge("9lives").set(2.0)
    text = reg.prometheus_text()
    assert "train_loss_ema 1" in text and "_9lives 2" in text
    assert MetricRegistry().prometheus_text() == ""


# -- the flight recorder against JAX -------------------------------------------


def _feed(mod, path, rs):
    fr = mod.FlightRecorder(capacity=16, path=path,
                            detectors=mod.default_detectors())
    warns = []
    for i in range(40):
        loss = 2.0 + 0.01 * (i % 3)
        step_time = 0.1
        if i == 20:
            loss = 50.0          # a spike
        if i == 25:
            step_time = 1.5      # a slow step
        if i == 30:
            loss = float("nan")  # a dead run
        warns += fr.record(i, loss=loss, step_time_s=step_time,
                           tokens=int(rs.randint(0, 9)), note="x")
    fr.dump("unit_test")
    return fr, warns


def test_flight_matches_jax(tmp_path):
    runs = {}
    for side, (_, mod) in SIDES.items():
        path = str(tmp_path / f"{side}.json")
        _, warns = _feed(mod, path, np.random.RandomState(0))
        doc = jax_flight.read_flight(path)
        runs[side] = (warns, doc)
    (jw, jdoc), (pw, pdoc) = runs["jax"], runs["port"]

    def strip(d):
        return {k: v for k, v in d.items() if k not in ("time", "dumped_at")}

    assert _same([strip(w) for w in pw], [strip(w) for w in jw])
    assert [w["detector"] for w in pw] == ["loss_spike",
                                          "throughput_regression", "nan_loss"]
    assert _same({**strip(pdoc), "records": [strip(r) for r in pdoc["records"]],
                  "warnings": [strip(w) for w in pdoc["warnings"]]},
                 {**strip(jdoc), "records": [strip(r) for r in jdoc["records"]],
                  "warnings": [strip(w) for w in jdoc["warnings"]]})
    assert pdoc["warnings"][2]["value"] == "NaN"
    assert [r["step"] for r in pdoc["records"]] == list(range(24, 40))
    jax_schemas.validate_flight_document(pdoc)
    obs.validate_flight_document(pdoc)
    assert flight.read_flight(str(tmp_path / "port.json")) == pdoc


def test_flight_detectors_counted_in_the_registry():
    reg = MetricRegistry()
    fr = FlightRecorder(detectors=flight.default_detectors(), registry=reg)
    fr.record(0, loss=float("inf"))
    snap = reg.snapshot()
    assert snap["obs/anomalies_total"] == 1.0
    assert snap["obs/anomalies/nan_loss"] == 1.0


def test_flight_dump_is_strict_json(tmp_path):
    path = str(tmp_path / "flight_record.json")
    fr = FlightRecorder(capacity=8, path=path,
                        detectors=flight.default_detectors())
    fr.record(0, loss=float("nan"))
    fr.dump("strict")

    def no_const(c):
        raise AssertionError(f"non-strict JSON constant {c!r} in dump")

    doc = json.loads(open(path).read(), parse_constant=no_const)
    assert doc["records"][0]["loss"] == "NaN"
    assert doc["warnings"][0]["detector"] == "nan_loss"
    assert FlightRecorder().dump("no sink") is None


def test_flight_refuses_a_tensor_field_without_reading_it(tmp_path,
                                                         monkeypatch):
    """A tensor field is a hidden host sync: refused by name, never
    ``.item()``-ed, and nothing is recorded or written."""
    def no_read(self, *a, **k):
        raise AssertionError("the recorder read a tensor")

    monkeypatch.setattr(torch.Tensor, "item", no_read)
    monkeypatch.setattr(torch.Tensor, "__float__", no_read)
    fr = FlightRecorder(path=str(tmp_path / "f.json"),
                        detectors=flight.default_detectors())
    with pytest.raises(TypeError, match="'loss'.*torch.Tensor"):
        fr.record(0, loss=torch.tensor(2.0), step_time_s=0.1)
    assert fr.steps_recorded == 0 and not fr.records
    fr.record(1, loss=2.0, extra={"nested": [1.0, torch.zeros(2)]})
    with pytest.raises(TypeError, match=r"records\[0\]\.extra\.nested\[1\]"):
        fr.dump("tensor")
    assert not list(tmp_path.iterdir())


# -- the hub -------------------------------------------------------------------


def test_observability_hub_writes_jax_formats(tmp_path):
    reg = MetricRegistry()
    with Observability(str(tmp_path), registry=reg) as hub:
        assert hub.registry is reg
        for i in range(12):
            hub.observe_step(i, loss=2.0, grad_norm=1.0, step_time_s=0.05,
                             data_wait_s=0.001, seq_per_sec=8.0)
        warns = hub.observe_step(12, loss=float("nan"), step_time_s=0.05)
        hub.dump_scalars()
    assert [w["detector"] for w in warns] == ["nan_loss"]
    assert reg.snapshot()["train/steps_total"] == 13.0
    for mod in (obs, jax_obs):
        assert mod.validate_jsonl("scalars", hub.scalars_path) > 10
    doc = json.load(open(hub.flight_path))
    jax_schemas.validate_flight_document(doc)
    assert doc["reason"] == "close" and doc["steps_recorded"] == 13
    assert open(hub.prometheus_path).read() == reg.prometheus_text()
    hub.close("again")  # idempotent
    assert json.load(open(hub.flight_path))["reason"] == "close"
    with Observability(str(tmp_path / "x")) as h2:
        pass
    assert h2.registry is not reg


def test_observability_exception_exit_reason(tmp_path):
    with pytest.raises(KeyError):
        with Observability(str(tmp_path)) as hub:
            hub.observe_step(0, loss=1.0)
            raise KeyError("boom")
    assert json.load(open(hub.flight_path))["reason"] == "exception:KeyError"


@pytest.mark.parametrize("kw", [dict(ledgers=True), dict(health=True),
                                dict(health="serving"), dict(perf=True)])
def test_observability_part2_arguments_raise(tmp_path, kw):
    """Part 2's arguments, which raised before the port reached them, now
    build their parts, wired as the JAX hub wires them; closing writes
    each artifact in the JAX package's schema."""
    hub = Observability(str(tmp_path), **kw)
    jhub = jax_obs.Observability(str(tmp_path / "jax"), **kw)
    for name in ("compile_ledger", "memory_ledger", "health_monitor",
                 "perf"):
        assert (getattr(hub, name) is None) == (getattr(jhub, name) is None)
    if kw.get("ledgers"):
        assert hub.compile_ledger.memory_ledger is hub.memory_ledger
        assert hub.compile_ledger.registry is hub.registry
        hub.compile_ledger.record_compile("decode_pages", (1,), 2.5,
                                          cost={"flops": 4.0,
                                                "bytes_accessed": 8.0})
        hub.memory_ledger.set("params", 100)
    if kw.get("health"):
        # True takes the union pack, a scope name that scope's pack
        assert [r.name for r in hub.health_monitor.rules] == [
            r.name for r in jhub.health_monitor.rules]
    if kw.get("perf"):
        hub.perf.note_phase("decode_step", 3.0)
    hub.observe_step(1, loss=1.0)
    hub.close()
    jhub.close()
    if kw.get("ledgers"):
        assert jax_obs.validate_jsonl(
            "compile_ledger", str(tmp_path / "compile_ledger.jsonl")) == 1
        doc = json.load(open(tmp_path / "memory_breakdown.json"))
        jax_schemas.validate_record("memory_breakdown", doc)
        assert doc["subsystems"]["params"]["bytes"] == 100
    if kw.get("perf"):
        path = str(tmp_path / "perf_attribution.jsonl")
        assert jax_obs.validate_jsonl("perf_attribution", path) == 2
        recs = obs.read_perf_attribution(path)
        assert [r["family"] for r in recs] == ["decode_step", "_total"]


def test_observability_audit_executable_raises(tmp_path):
    """The collective audit, which raised before the port reached it, now
    audits an FX graph: a plain program holds no collective, and the record
    and gauges are the JAX hub's."""
    gm = torch.fx.symbolic_trace(lambda x: torch.relu(x) * 2)
    hub = Observability(str(tmp_path))
    rec = hub.audit_executable("relu", gm)
    assert rec["total_collective_count"] == 0
    assert set(rec["collective_counts"]) == set(
        jax_obs.hlo_audit.COLLECTIVE_OPS)
    assert obs.read_audits(hub.hlo_audit_path)[0]["name"] == "relu"
    assert hub.registry.gauge("hlo/relu/collective_bytes").value == 0.0
    with pytest.raises(TypeError, match="GraphModule"):
        hub.audit_executable("x", object())


def test_obs_exports_exist_and_match_jax_names():
    assert all(hasattr(obs, n) for n in obs.__all__)
    for name in obs.__all__:
        assert hasattr(jax_obs, name) or hasattr(
            jax_obs.tracing, name) or hasattr(jax_flight, name) or hasattr(
            jax_registry, name) or name == "validate_flight_document", name
    assert obs.MS_BUCKETS == jax_obs.MS_BUCKETS
    for n in ("SCALARS_FILE", "FLIGHT_FILE", "PROMETHEUS_FILE"):
        assert getattr(obs, n) == getattr(jax_obs, n)


# -- the transfer audit --------------------------------------------------------


class _Staging:
    """A stand-in for the engine's packed staging: counts its calls."""

    def __init__(self):
        self.puts = self.fetches = 0

    def put(self, *arrays):
        self.puts += 1
        return [np.asarray(a) for a in arrays]

    def wait(self, handle):
        self.fetches += 1
        return np.asarray(handle)


def test_transfer_audit_counts_and_wraps_the_staging():
    reg = MetricRegistry()
    audit = TransferAudit(reg, mode="observe", device="cpu")
    st = _Staging()
    out = audit.put(st, np.arange(3), np.ones(2))
    assert [o.tolist() for o in out] == [[0, 1, 2], [1.0, 1.0]]
    with audit.section("serving/decode"):
        assert audit.fetch(st, np.arange(4), label="serving").tolist() == [
            0, 1, 2, 3]
    audit.note_fetch(0.002, label="serving")
    snap = reg.snapshot()
    assert (st.puts, st.fetches) == (1, 1)
    assert snap["transfer/explicit_puts_total"] == 1.0
    assert snap["transfer/explicit_fetches_total"] == 2.0
    assert snap["transfer/guarded_sections_total"] == 1.0
    assert snap["transfer/fetch_wait_ms"]["count"] == 2
    assert snap["serving/host_blocked_ms"]["count"] == 2
    assert audit.blocked_s >= 0.002
    jax_schemas.validate_registry_metrics(reg)


@pytest.mark.parametrize("mode", ["off", "observe", "forbid"])
def test_transfer_audit_modes_on_the_cpu(mode):
    """``off`` counts no section; on the CPU ``forbid`` counts its sections
    and sets no guard (there is no CUDA sync to detect)."""
    audit = TransferAudit(MetricRegistry(), mode=mode, device="cpu")
    with audit.section("s"):
        pass
    assert audit.sections == (0 if mode == "off" else 1)
    assert audit._guard is False
    with allow_sync():
        pass
    with pytest.raises(ValueError, match="mode must be"):
        TransferAudit(mode="disallow")


def test_transfer_audit_forbid_restores_the_mode_after_an_error(monkeypatch):
    """On a CUDA device the section sets "error" and restores the previous
    mode in ``finally``, an exception inside included (the mode calls are
    recorded, not made: this runs without a card)."""
    calls, mode = [], [0]
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: mode[0])

    def set_mode(m):
        calls.append(m)
        mode[0] = {"error": 2, "warn": 1, "default": 0}.get(m, m)

    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_mode)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    audit = TransferAudit(MetricRegistry(), mode="forbid", device="cuda")
    st = _Staging()
    with pytest.raises(RuntimeError, match="inside"):
        with audit.section("serving/decode"):
            assert mode[0] == 2
            audit.fetch(st, np.zeros(2))  # lifted for the wait, then back
            assert mode[0] == 2
            raise RuntimeError("inside")
    assert mode[0] == 0
    assert calls == ["error", 0, 2, 0]


def test_registry_scrapes_race_a_writer_safely():
    """The metrics-server threads read the registry while the engine
    thread registers and updates metrics: more scraping threads than
    cores and a short switch interval lose no update and raise nothing."""
    import os
    import sys
    import threading

    reg = MetricRegistry()
    n_ops = 2000
    errors = []
    done = threading.Event()

    def writer():
        try:
            for i in range(n_ops):
                reg.counter("serving/tokens_total").inc()
                reg.counter(f"serving/m{i % 97}_total").inc()
                reg.histogram("serving/step_ms", obs.MS_BUCKETS).observe(i)
        except Exception as e:  # recorded for the assertion below
            errors.append(e)
        finally:
            done.set()

    def scraper():
        try:
            while not done.is_set():
                reg.prometheus_text()
                reg.snapshot()
                reg.to_scalar_records(step=1)
        except Exception as e:
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=scraper)
                   for _ in range(2 * (os.cpu_count() or 2))]
        threads.append(threading.Thread(target=writer))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    snap = reg.snapshot()
    assert snap["serving/tokens_total"] == n_ops
    assert sum(v for k, v in snap.items()
               if k.startswith("serving/m")) == n_ops
    assert snap["serving/step_ms"]["count"] == n_ops
