"""PyTorch port: the artifact schemas (``obs.schemas``) against the JAX
package's, and every artifact the port writes validated under both.

- ``SCHEMAS`` and ``REGISTRY_METRICS`` equal JAX's; the same bad records
  are refused by both validators with the same messages.
- The engine pre-declares the JAX engine's metric set, plain and with
  every feature that registers metrics (adapters, int8 pages, chunks, a
  self draft); a run's registry holds each declared metric in its
  declared kind.
- ``scalars.jsonl``, ``serving_stats.jsonl``, ``trace_events.jsonl``,
  ``flight_record.json`` and ``metrics.prom`` of a port run directory
  validate under the port's schemas and JAX's.
- The supervisor's events validate as ``supervisor_event``.
"""

import json
import sys

import numpy as np
import pytest

import neuronx_distributed_tpu.obs.schemas as jax_schemas
import neuronx_distributed_tpu_torch.obs.schemas as schemas
from neuronx_distributed_tpu_torch.obs import MetricRegistry, Observability, Tracer
from neuronx_distributed_tpu_torch.resilience.supervisor import Supervisor
from neuronx_distributed_tpu_torch.serving import Request, ServingEngine
from torch_port_pair import build_pair

VALIDATORS = {"jax": jax_schemas, "port": schemas}


def test_schema_lists_equal_jax():
    assert schemas.SCHEMAS == jax_schemas.SCHEMAS
    assert schemas.REGISTRY_METRICS == jax_schemas.REGISTRY_METRICS
    assert {"serving_stats", "trace_event", "flight_record", "scalars",
            "supervisor_event", "compile_ledger", "alert", "router_stats",
            "weight_swap"} <= set(schemas.SCHEMAS)


GOOD_STATS = {
    "schema": "serving_stats/6", "time": 1.0, "request_id": 0,
    "state": "finished", "finish_reason": "length", "prompt_len": 4,
    "new_tokens": 2, "queue_ms": 1.0, "ttft_ms": 5.0, "total_ms": 9.0,
    "spec_proposed": 0, "spec_accepted": 0, "acceptance_rate": None,
    "adapter_id": 0, "priority": "interactive", "deadline_s": None,
    "queue_wait_ms": 1.0, "preemptions": 0, "shed_reason": None,
    "mono": 3.0, "decode_steps": 1, "prefill_chunks": 0,
    "preempted_ms": 0.0, "trace_id": None, "weights_version": 0}

BAD = [
    ("scalars", {"step": 1, "tag": "x", "time": 0.0}),
    ("scalars", {"step": "1", "tag": "x", "value": 1.0, "time": 0.0}),
    ("scalars", {"step": 1, "tag": "x", "value": True, "time": 0.0}),
    ("nope", {}),
    ("scalars", [1, 2]),
    ("serving_stats", {k: v for k, v in GOOD_STATS.items()
                       if k != "weights_version"}),
    ("serving_stats", dict(GOOD_STATS, total_ms="slow")),
    ("serving_stats", dict(GOOD_STATS, request_id=True)),
    ("trace_event", {"schema": "trace_event/1", "name": "x", "span_id": 1,
                     "parent_id": "root", "request_id": 0, "replica": 0,
                     "t_start": 0.0, "t_end": 0.0, "ts": 0.0, "mono": 0.0,
                     "attrs": {}}),
    ("flight_step", {"step": 1}),
    ("supervisor_event", {"schema": "supervisor_events/1", "time": 1.0,
                          "event": "start"}),
]


@pytest.mark.parametrize("i", range(len(BAD)))
def test_bad_records_refused_like_jax(i):
    kind, rec = BAD[i]
    msgs = {}
    for side, mod in VALIDATORS.items():
        with pytest.raises(ValueError) as exc:
            mod.validate_record(kind, rec)
        msgs[side] = str(exc.value)
    assert msgs["port"] == msgs["jax"]


def test_good_stats_record_and_flight_document_pass_both():
    for mod in VALIDATORS.values():
        mod.validate_record("serving_stats", GOOD_STATS)
    doc = {"schema": "flight_record_v1", "reason": "x", "dumped_at": 1.0,
           "capacity": 4, "steps_recorded": 1,
           "records": [{"step": 1, "time": 1.0}],
           "warnings": [{"step": 1, "detector": "d", "message": "m",
                         "time": 1.0}]}
    for mod in VALIDATORS.values():
        mod.validate_flight_document(doc)
        with pytest.raises(ValueError, match=r"records\[0\]"):
            mod.validate_flight_document(dict(doc, records=[{"step": 1}]))


def _full_run(out_dir):
    """Every feature that registers metrics: adapters, int8 pages,
    chunks, a self draft, a tracer, stats and a hub."""
    from test_torch_tenancy import _stores

    jpim, tpim, _, _, cfg = build_pair(3, 32, 0)
    _, store = _stores(jpim, tpim)
    hub = Observability(str(out_dir))
    tracer = Tracer()
    eng = ServingEngine(tpim, page_size=4, num_pages=40, kv_quant="int8",
                        prefill_chunk_tokens=4, draft=tpim, spec_k=2,
                        adapter_store=store, obs=hub, tracer=tracer,
                        stats_path=str(out_dir / "serving_stats.jsonl"),
                        device="cpu")
    rs = np.random.RandomState(2)
    for i in range(4):
        eng.submit(Request(request_id=i, max_new_tokens=5, adapter_id=i % 3,
                           prompt_ids=rs.randint(1, cfg.vocab_size,
                                                 size=6).tolist(),
                           priority="batch" if i % 2 else "interactive"))
    outs = eng.run_until_complete(max_steps=100)
    eng.close()
    hub.close()
    tracer.export_jsonl(str(out_dir / "trace_events.jsonl"))
    return eng, outs, hub


def test_port_run_directory_validates_under_both(tmp_path):
    eng, outs, hub = _full_run(tmp_path)
    assert len(outs) == 4
    reg = eng.registry
    for mod in VALIDATORS.values():
        mod.validate_registry_metrics(reg)
        assert mod.validate_jsonl("scalars", hub.scalars_path) > 50
        assert mod.validate_jsonl(
            "serving_stats", str(tmp_path / "serving_stats.jsonl")) == 4
        assert mod.validate_jsonl(
            "trace_event", str(tmp_path / "trace_events.jsonl")) > 20
        mod.validate_flight_document(json.load(open(hub.flight_path)))
    prom = open(hub.prometheus_path).read()
    assert prom == reg.prometheus_text()
    for line in prom.splitlines():
        if not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            float(value)
    bad = MetricRegistry()
    bad.counter("serving/host_blocked_ms")  # declared a histogram
    for mod in VALIDATORS.values():
        with pytest.raises(ValueError, match="misfile"):
            mod.validate_registry_metrics(bad)


@pytest.mark.parametrize("full", [False, True])
def test_engine_predeclares_the_jax_metric_set(full):
    from neuronx_distributed_tpu.obs import MetricRegistry as JaxRegistry
    from neuronx_distributed_tpu.serving import ServingEngine as JaxEngine
    from test_torch_tenancy import _stores

    jpim, tpim, _, _, _ = build_pair(3, 32, 0)
    stores = _stores(jpim, tpim) if full else (None, None)
    names = {}
    for side, engine, pim, reg, store in (
            ("jax", JaxEngine, jpim, JaxRegistry(), stores[0]),
            ("port", ServingEngine, tpim, MetricRegistry(), stores[1])):
        kw = dict(page_size=4, num_pages=40, registry=reg)
        if full:
            kw.update(kv_quant="int8", prefill_chunk_tokens=4, draft=pim,
                      spec_k=2, adapter_store=store)
        if side == "port":
            kw["device"] = "cpu"
        engine(pim, **kw)
        names[side] = {m.name: type(m).__name__ for m in reg.metrics()}
    assert names["port"] == names["jax"]


def test_supervisor_events_validate(tmp_path):
    events = tmp_path / "supervisor_events.jsonl"
    sup = Supervisor([sys.executable, "-c", "print('ok')"],
                     events_path=str(events), max_restarts=0)
    assert sup.run().ok
    for mod in VALIDATORS.values():
        assert mod.validate_jsonl("supervisor_event", str(events)) == 3
