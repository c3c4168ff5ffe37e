"""Observability core of the PyTorch port (counterpart of
``neuronx_distributed_tpu/obs``, ROADMAP A8).

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
- :mod:`.metrics_server` -- stdlib ``/metrics`` and ``/healthz``;
- :mod:`.compile_ledger` -- every phase-graph capture accounted
  (``compile_ledger.jsonl``), cache hits and evictions, thrash and
  post-warm-up compile storms;
- :mod:`.memory_ledger` -- per-subsystem device bytes with watermarks, the
  allocator's truth on the card and the out-of-memory breakdown
  (``memory_breakdown.json``);
- :mod:`.perf` -- per-phase roofline attribution from the ledger's costs
  (``perf_attribution.jsonl``), against the card's published peaks;
- :mod:`.health` -- threshold, EWMA-trend and SLO burn-rate rules over the
  registry, alert edges streamed to ``alerts.jsonl``;
- :mod:`.hlo_audit` -- the collective audit of an FX graph or exported
  program (``hlo_audit.jsonl``);
- :mod:`.aggregate` -- fleet-wide merges and the fleet health room;
- :mod:`.report` -- one summary document over a run directory (CLI:
  ``python -m neuronx_distributed_tpu_torch.obs.report RUN_DIR``).
"""

from __future__ import annotations

import os
from typing import Any, Optional

from neuronx_distributed_tpu_torch.obs.compile_ledger import (
    COMPILE_LEDGER_FILE,
    CompileLedger,
    read_compile_ledger,
    summarize_compile_records,
)
from neuronx_distributed_tpu_torch.obs.flight import (
    AnomalyDetector,
    FlightRecorder,
    LossSpikeDetector,
    NanLossDetector,
    ThroughputRegressionDetector,
    default_detectors,
    read_flight,
)
from neuronx_distributed_tpu_torch.obs.health import (
    ALERT_SCHEMA,
    ALERTS_FILE,
    BurnRateRule,
    HealthMonitor,
    Rule,
    ThresholdRule,
    TrendRule,
    default_rules,
    read_alerts,
)
from neuronx_distributed_tpu_torch.obs.hlo_audit import (
    append_audit,
    collective_bytes,
    collective_counts,
    comm_audit,
    read_audits,
)
from neuronx_distributed_tpu_torch.obs.memory_ledger import (
    MEMORY_BREAKDOWN_FILE,
    MemoryLedger,
    read_memory_breakdown,
)
from neuronx_distributed_tpu_torch.obs.perf import (
    DEVICE_SPECS,
    PERF_ATTRIBUTION_FILE,
    PERF_ATTRIBUTION_SCHEMA,
    PERF_FAMILIES,
    DeviceSpec,
    PerfAttribution,
    device_spec,
    merge_perf_records,
    read_perf_attribution,
    roofline_attribution,
    summarize_perf,
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
from neuronx_distributed_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

# canonical artifact names inside an obs run directory -- the JAX package's
# obs/report.py and tools/obs_report.py look these up by name
SCALARS_FILE = "scalars.jsonl"
FLIGHT_FILE = "flight_record.json"
HLO_AUDIT_FILE = "hlo_audit.jsonl"
PROMETHEUS_FILE = "metrics.prom"

# step-time-style histogram boundaries (milliseconds)
MS_BUCKETS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
              1000.0, 2500.0, 5000.0, 10000.0, 30000.0)

class Observability:
    """The per-run telemetry hub: one registry, one flight recorder, one
    collective-audit stream and, when asked, the resource ledgers, the
    health monitor and the perf attribution, all persisting under
    ``out_dir``.

    Hand it to ``ServingEngine(obs=...)``: the engine's metrics then ride
    this hub's registry (unless one is passed explicitly), every engine
    step becomes a flight record, ``replay_trace`` dumps the ring on a
    crash, and the hub's ``compile_ledger``, ``memory_ledger``,
    ``health_monitor`` and ``perf`` are the engine's unless it is given
    its own.  ``ledgers=True`` builds both ledgers; ``health`` is True (the
    ``"all"`` rule pack), a scope name of :func:`~.health.default_rules`,
    a rule list or a :class:`~.health.HealthMonitor`; ``perf=True`` builds
    the attribution, joined to the compile ledger.  Every artifact it
    writes validates against :mod:`.schemas`.
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
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.timeline = timeline
        self.registry = registry if registry is not None else MetricRegistry()
        self.scalars_path = os.path.join(out_dir, SCALARS_FILE)
        self.flight_path = os.path.join(out_dir, FLIGHT_FILE)
        self.hlo_audit_path = os.path.join(out_dir, HLO_AUDIT_FILE)
        self.prometheus_path = os.path.join(out_dir, PROMETHEUS_FILE)
        self.flight = FlightRecorder(
            capacity=flight_capacity,
            path=self.flight_path,
            detectors=detectors if detectors is not None else default_detectors(),
            timeline=timeline,
            registry=self.registry,
        )
        # resource ledgers: off by default, and every consumer guards on
        # `is not None`, so the hot path stays allocation-free
        self.compile_ledger: Optional[CompileLedger] = None
        self.memory_ledger: Optional[MemoryLedger] = None
        if ledgers:
            self.memory_ledger = MemoryLedger(
                registry=self.registry,
                path=os.path.join(out_dir, MEMORY_BREAKDOWN_FILE))
            self.compile_ledger = CompileLedger(
                path=os.path.join(out_dir, COMPILE_LEDGER_FILE),
                registry=self.registry, flight=self.flight,
                memory_ledger=self.memory_ledger)
        # perf attribution: per-phase time joined with the compile
        # ledger's costs, dumped to perf_attribution.jsonl on close
        self.perf: Optional[PerfAttribution] = None
        if perf:
            self.perf = PerfAttribution(
                path=os.path.join(out_dir, PERF_ATTRIBUTION_FILE),
                registry=self.registry, ledger=self.compile_ledger)
        # the health monitor, evaluated on the step cadence over this
        # hub's registry; alert edges stream to alerts.jsonl
        self.health_monitor: Optional[HealthMonitor] = None
        if isinstance(health, HealthMonitor):
            self.health_monitor = health
            health.attach_registry(self.registry)
        elif health:
            if isinstance(health, str):  # a default-pack scope name
                rules = default_rules(health)
            elif isinstance(health, (list, tuple)):
                rules = list(health)
            else:
                # health=True: the hub may serve a trainer or an engine,
                # so the bare boolean takes the union pack (rules over
                # absent metrics stay silent)
                rules = default_rules("all")
            self.health_monitor = HealthMonitor(
                rules, registry=self.registry,
                path=os.path.join(out_dir, ALERTS_FILE))
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
        warnings = self.flight.record(step, **fields)
        if self.health_monitor is not None:
            self.health_monitor.on_step()
        return warnings

    # -- compile path ------------------------------------------------------

    def audit_executable(self, name: str, program: Any) -> dict:
        """Audit one program's collectives (a ``torch.fx.GraphModule`` or a
        ``torch.export.ExportedProgram``, :func:`~.hlo_audit.comm_audit`),
        append the record to ``hlo_audit.jsonl`` and mirror the headline
        numbers as ``hlo/<name>/*`` gauges."""
        rec = comm_audit(program, name=name)
        append_audit(self.hlo_audit_path, rec)
        for op, n in rec["collective_counts"].items():
            self.registry.gauge(f"hlo/{name}/{op}_count").set(float(n))
        self.registry.gauge(f"hlo/{name}/collective_bytes").set(
            float(rec["total_collective_bytes"]))
        logger.info("obs: collective audit %r: %s collectives, %.3e bytes",
                    name, rec["total_collective_count"],
                    rec["total_collective_bytes"])
        return rec

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
        if self.memory_ledger is not None:
            try:
                self.memory_ledger.poll_device()
                self.memory_ledger.dump(reason=reason)
            except OSError as e:  # telemetry IO must never mask the exit
                logger.warning("obs: memory breakdown dump failed: %s", e)
        if self.perf is not None:
            try:
                self.perf.update_metrics()
                self.perf.dump()
            except OSError as e:  # telemetry IO must never mask the exit
                logger.warning("obs: perf attribution dump failed: %s", e)
        if self.health_monitor is not None:
            self.health_monitor.close()
        with open(self.prometheus_path, "w") as f:
            f.write(self.registry.prometheus_text())

    def __enter__(self) -> "Observability":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close("exception:%s" % exc_type.__name__ if exc_type else "close")


__all__ = [
    "Observability",
    "MetricRegistry",
    "HealthMonitor",
    "Rule",
    "ThresholdRule",
    "TrendRule",
    "BurnRateRule",
    "default_rules",
    "read_alerts",
    "ALERTS_FILE",
    "ALERT_SCHEMA",
    "CompileLedger",
    "MemoryLedger",
    "read_compile_ledger",
    "read_memory_breakdown",
    "summarize_compile_records",
    "COMPILE_LEDGER_FILE",
    "MEMORY_BREAKDOWN_FILE",
    "comm_audit",
    "collective_counts",
    "collective_bytes",
    "append_audit",
    "read_audits",
    "PerfAttribution",
    "DeviceSpec",
    "DEVICE_SPECS",
    "device_spec",
    "roofline_attribution",
    "summarize_perf",
    "merge_perf_records",
    "read_perf_attribution",
    "PERF_ATTRIBUTION_FILE",
    "PERF_ATTRIBUTION_SCHEMA",
    "PERF_FAMILIES",
    "HLO_AUDIT_FILE",
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
