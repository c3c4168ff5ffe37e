"""Observability core of the PyTorch port (counterpart of
``neuronx_distributed_tpu/obs``, ROADMAP A8 part 1).

One telemetry layer that answers "why was step N slow, where did one
request's time go, how many tokens were shed or preempted, what was the
process doing when it died" from persisted artifacts alone, in the JAX
package's formats, so its ``tools/obs_report.py`` and dashboards read a
port run directory unchanged:

- :mod:`.registry` -- counters / gauges / fixed-bucket histograms,
  serialized to ``scalars.jsonl`` and Prometheus text;
- :mod:`.schemas` -- the checked-in schema list every artifact validates
  against (equal to the JAX package's);
- :mod:`.flight` -- a ring of the last K step records dumped to
  ``flight_record.json`` on a crash and at close, with anomaly detectors;
- :mod:`.tracing` -- the request-lifecycle span tracer
  (``trace_events.jsonl`` and Perfetto exports), the trainer's Chrome-trace
  :class:`Timeline`, and :func:`~.tracing.device_trace` (``torch.profiler``);
- :mod:`.transfer_audit` -- the explicit put/fetch accounting and the
  ``forbid`` sync guard of the engine's hot section;
- :mod:`.metrics_server` -- stdlib ``/metrics`` and ``/healthz``.

The resource ledgers, performance attribution, health rules, fleet
aggregation and the report (ROADMAP A8 part 2) are not here yet:
:class:`Observability` refuses ``ledgers=``, ``health=`` and ``perf=``, and
:meth:`Observability.audit_executable`, naming that part.
"""

from __future__ import annotations

import os
from typing import Any, Optional

from neuronx_distributed_tpu_torch.obs.flight import (
    AnomalyDetector,
    FlightRecorder,
    LossSpikeDetector,
    NanLossDetector,
    ThroughputRegressionDetector,
    default_detectors,
    read_flight,
)
from neuronx_distributed_tpu_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricRegistry,
    read_histograms,
)
from neuronx_distributed_tpu_torch.obs.schemas import (
    REGISTRY_METRICS,
    SCHEMAS,
    validate_flight_document,
    validate_jsonl,
    validate_record,
    validate_registry_metrics,
)
from neuronx_distributed_tpu_torch.obs.tracing import (
    TRACE_EVENT_SCHEMA,
    TRACE_EVENTS_FILE,
    Span,
    Timeline,
    Tracer,
    device_trace,
    read_trace_events,
    write_chrome_trace,
)
from neuronx_distributed_tpu_torch.obs.transfer_audit import TransferAudit

# canonical artifact names inside an obs run directory -- the JAX package's
# obs/report.py and tools/obs_report.py look these up by name
SCALARS_FILE = "scalars.jsonl"
FLIGHT_FILE = "flight_record.json"
PROMETHEUS_FILE = "metrics.prom"

# step-time-style histogram boundaries (milliseconds)
MS_BUCKETS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
              1000.0, 2500.0, 5000.0, 10000.0, 30000.0)

PART2 = ("ROADMAP A8 part 2 (resource ledgers, perf attribution, health "
         "rules, the report) is not ported yet")


class Observability:
    """The per-run telemetry hub: one registry and one flight recorder,
    persisting under ``out_dir``.

    Hand it to ``ServingEngine(obs=...)``: the engine's metrics then ride
    this hub's registry (unless one is passed explicitly), every engine
    step becomes a flight record, and ``replay_trace`` dumps the ring on a
    crash.  Every artifact it writes validates against :mod:`.schemas`.
    ``ledgers``, ``health`` and ``perf`` belong to ROADMAP A8 part 2 and
    raise ``NotImplementedError`` when set.
    """

    def __init__(
        self,
        out_dir: str,
        flight_capacity: int = 256,
        detectors: Optional[list] = None,
        timeline: Any = None,
        registry: Optional[MetricRegistry] = None,
        ledgers: bool = False,
        health: Any = False,
        perf: bool = False,
    ):
        for name, value in (("ledgers", ledgers), ("health", health),
                            ("perf", perf)):
            if value:
                raise NotImplementedError(f"Observability({name}=...): "
                                          f"{PART2}")
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.timeline = timeline
        self.registry = registry if registry is not None else MetricRegistry()
        self.scalars_path = os.path.join(out_dir, SCALARS_FILE)
        self.flight_path = os.path.join(out_dir, FLIGHT_FILE)
        self.prometheus_path = os.path.join(out_dir, PROMETHEUS_FILE)
        self.flight = FlightRecorder(
            capacity=flight_capacity,
            path=self.flight_path,
            detectors=detectors if detectors is not None else default_detectors(),
            timeline=timeline,
            registry=self.registry,
        )
        self._last_step = 0
        self._closed = False
        # pre-declare the step metrics so a zero-step run still exports them
        self.registry.counter("train/steps_total")
        self.registry.histogram("train/step_time_ms", MS_BUCKETS)
        self.registry.histogram("train/data_wait_ms", MS_BUCKETS)

    # -- step path ---------------------------------------------------------

    def observe_step(self, step: int, **fields) -> list:
        """Record one training step (flight record + registry metrics);
        returns the anomaly warnings the detectors raised (possibly [])."""
        self._last_step = step
        reg = self.registry
        reg.counter("train/steps_total").inc()
        for key in ("loss", "grad_norm", "seq_per_sec"):
            if key in fields and fields[key] is not None:
                reg.gauge(f"train/{key}").set(float(fields[key]))
        if fields.get("step_time_s") is not None:
            reg.histogram("train/step_time_ms", MS_BUCKETS).observe(
                1e3 * float(fields["step_time_s"]))
        if fields.get("data_wait_s") is not None:
            reg.histogram("train/data_wait_ms", MS_BUCKETS).observe(
                1e3 * float(fields["data_wait_s"]))
        return self.flight.record(step, **fields)

    def audit_executable(self, name: str, compiled: Any) -> dict:
        """The JAX hub's HLO collective audit; what replaces it for CUDA
        programs is part 2's decision."""
        raise NotImplementedError(f"Observability.audit_executable: {PART2}")

    # -- persistence -------------------------------------------------------

    def dump_scalars(self, step: Optional[int] = None) -> None:
        """Append the registry snapshot to ``scalars.jsonl``."""
        self.registry.dump_jsonl(
            self.scalars_path, step if step is not None else self._last_step)

    def dump_flight(self, reason: str) -> Optional[str]:
        """Dump the flight-recorder ring to ``flight_record.json``."""
        return self.flight.dump(reason)

    def close(self, reason: str = "close") -> None:
        """Final persistence: last scalars snapshot, flight dump, Prometheus
        text export.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        self.dump_scalars()
        self.dump_flight(reason)
        with open(self.prometheus_path, "w") as f:
            f.write(self.registry.prometheus_text())

    def __enter__(self) -> "Observability":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close("exception:%s" % exc_type.__name__ if exc_type else "close")


__all__ = [
    "Observability",
    "MetricRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "read_histograms",
    "FlightRecorder",
    "AnomalyDetector",
    "NanLossDetector",
    "LossSpikeDetector",
    "ThroughputRegressionDetector",
    "default_detectors",
    "read_flight",
    "SCHEMAS",
    "REGISTRY_METRICS",
    "validate_record",
    "validate_jsonl",
    "validate_registry_metrics",
    "validate_flight_document",
    "TransferAudit",
    "Tracer",
    "Span",
    "Timeline",
    "device_trace",
    "read_trace_events",
    "write_chrome_trace",
    "TRACE_EVENTS_FILE",
    "TRACE_EVENT_SCHEMA",
    "SCALARS_FILE",
    "FLIGHT_FILE",
    "PROMETHEUS_FILE",
    "MS_BUCKETS",
]
