"""Step flight recorder + anomaly detectors (a copy of
``neuronx_distributed_tpu/obs/flight.py``; the port refuses tensor fields).

A ring buffer of the last K step records — loss, grad-norm, step-time
breakdown (host dispatch vs device wait via ``block_until_ready`` timing,
data-loader stall) — that dumps to ``flight_record.json`` when the run dies
(crash or SIGTERM, hooked into ``fit()``'s existing signal path) and at
clean exit.  The rounds 3-5 bench post-mortems were reconstructed by hand
from scrollback (docs/BENCH_NOTES_r5.md); this makes the last K steps a
persisted artifact instead.

Detectors run synchronously on every record (they are a few float
comparisons) and emit three-way: a structured warning record (persisted in
the dump), a ``logger.warning``, and — when a timeline is attached — an
``instant()`` marker so the anomaly is visible in the Perfetto trace at the
step where it fired.

Fields are host numbers.  A ``torch.Tensor`` field is refused with a
``TypeError`` naming it, never read with ``.item()``: turning a device
tensor into a float would hide a host sync in every step's telemetry.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import time
from collections import deque
from typing import Any, Deque, List, Optional

import torch

from neuronx_distributed_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

FLIGHT_SCHEMA = "flight_record_v1"
MAX_WARNINGS = 256


class AnomalyDetector:
    """Base detector: ``check(record, history)`` returns a message string
    when the anomaly fires, else None.  ``history`` is the ring content
    BEFORE ``record`` (oldest first)."""

    name = "anomaly"

    def check(self, record: dict, history: "Deque[dict]") -> Optional[str]:
        raise NotImplementedError


class NanLossDetector(AnomalyDetector):
    """Fires when the watched field is NaN/Inf — the canonical
    dead-run signature (the reference's runs die silently on this;
    SURVEY §5.5)."""

    name = "nan_loss"

    def __init__(self, field: str = "loss"):
        self.field = field

    def check(self, record, history):
        v = record.get(self.field)
        if v is not None and not math.isfinite(float(v)):
            return f"{self.field} is non-finite ({v!r})"
        return None


class LossSpikeDetector(AnomalyDetector):
    """Z-score of the current loss against the trailing window; fires on
    ``z > threshold`` once enough history exists.  A spike that large with a
    healthy data pipeline usually means a bad batch or an optimizer blow-up
    — worth a marker even when the run survives."""

    name = "loss_spike"

    def __init__(self, field: str = "loss", window: int = 32,
                 z_threshold: float = 6.0, min_history: int = 8):
        self.field = field
        self.window = window
        self.z_threshold = z_threshold
        self.min_history = min_history

    def check(self, record, history):
        v = record.get(self.field)
        if v is None or not math.isfinite(float(v)):
            return None  # NanLossDetector's jurisdiction
        past = [float(r[self.field]) for r in list(history)[-self.window:]
                if r.get(self.field) is not None
                and math.isfinite(float(r[self.field]))]
        if len(past) < self.min_history:
            return None
        mean = statistics.fmean(past)
        std = statistics.pstdev(past)
        # the std floor keeps a flat-loss window (std ~ 0) from firing on
        # harmless jitter: require an absolute move too
        z = (float(v) - mean) / max(std, 1e-3 * max(abs(mean), 1e-9), 1e-12)
        if z > self.z_threshold:
            return (f"{self.field} spike: {float(v):.6g} vs window "
                    f"mean {mean:.6g} (z={z:.1f})")
        return None


class ThroughputRegressionDetector(AnomalyDetector):
    """Fires when a step takes ``factor``x the trailing-window median step
    time — the host-side signature of a data stall, a recompile, or a
    neighbor stealing the chip.  ``min_excess_s`` is an absolute floor on
    the slowdown: sub-second relative jitter on tiny (dev/CPU) steps is
    noise, while the stalls worth a marker cost whole seconds."""

    name = "throughput_regression"

    def __init__(self, field: str = "step_time_s", window: int = 32,
                 factor: float = 3.0, min_history: int = 8,
                 min_excess_s: float = 0.25):
        self.field = field
        self.window = window
        self.factor = factor
        self.min_history = min_history
        self.min_excess_s = min_excess_s

    def check(self, record, history):
        v = record.get(self.field)
        if v is None:
            return None
        past = [float(r[self.field]) for r in list(history)[-self.window:]
                if r.get(self.field) is not None]
        if len(past) < self.min_history:
            return None
        med = statistics.median(past)
        if med > 0 and float(v) > self.factor * med \
                and float(v) - med > self.min_excess_s:
            return (f"step took {float(v) * 1e3:.1f} ms vs trailing median "
                    f"{med * 1e3:.1f} ms ({float(v) / med:.1f}x)")
        return None


def default_detectors() -> List[AnomalyDetector]:
    return [NanLossDetector(), LossSpikeDetector(), ThroughputRegressionDetector()]


def _refuse_tensor(obj, where: str) -> None:
    if isinstance(obj, torch.Tensor):
        raise TypeError(
            f"flight: field {where!r} is a torch.Tensor ({obj.device}); pass "
            "a host number -- reading it here would sync the device")


def _json_safe(obj, where: str = "record"):
    """Strict-JSON view: non-finite floats become strings ("NaN"/"Inf"/
    "-Inf") so the dumped artifact parses under every JSON implementation,
    not just Python's NaN-tolerant one.  A tensor anywhere raises
    ``TypeError`` naming its path."""
    _refuse_tensor(obj, where)
    if isinstance(obj, float) and not math.isfinite(obj):
        return "NaN" if math.isnan(obj) else ("Inf" if obj > 0 else "-Inf")
    if isinstance(obj, dict):
        return {k: _json_safe(v, f"{where}.{k}") for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v, f"{where}[{i}]") for i, v in enumerate(obj)]
    return obj


class FlightRecorder:
    """Ring buffer of step records with synchronous anomaly detection.

    ``record(step, **fields)`` appends one record and returns the warnings
    raised for it; ``dump(reason)`` atomically writes the whole ring (plus
    every warning so far) to ``flight_record.json``."""

    def __init__(
        self,
        capacity: int = 256,
        path: Optional[str] = None,
        detectors: Optional[List[AnomalyDetector]] = None,
        timeline: Any = None,
        registry: Any = None,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.path = path
        self.detectors = list(detectors) if detectors is not None else []
        self.timeline = timeline
        self.registry = registry
        self.records: Deque[dict] = deque(maxlen=capacity)
        self.warnings: Deque[dict] = deque(maxlen=MAX_WARNINGS)
        self.steps_recorded = 0

    def record(self, step: int, **fields) -> List[dict]:
        rec = {"step": int(step), "time": time.time()}
        for k, v in fields.items():
            _refuse_tensor(v, k)
            if v is not None:
                rec[k] = float(v) if isinstance(v, (int, float)) else v
        fired: List[dict] = []
        for det in self.detectors:
            try:
                msg = det.check(rec, self.records)
            except Exception as e:  # a broken detector must not kill training
                logger.warning("flight: detector %s raised %r", det.name, e)
                continue
            if msg:
                warning = {
                    "step": int(step),
                    "detector": det.name,
                    "message": msg,
                    "value": rec.get(getattr(det, "field", "loss")),
                    "time": rec["time"],
                }
                fired.append(warning)
                self.warnings.append(warning)
                logger.warning("flight anomaly [%s] step %d: %s",
                               det.name, step, msg)
                if self.registry is not None:
                    self.registry.counter("obs/anomalies_total").inc()
                    self.registry.counter(f"obs/anomalies/{det.name}").inc()
                if self.timeline is not None:
                    self.timeline.instant(
                        f"anomaly/{det.name}", step=int(step), message=msg)
        if fired:
            rec["anomalies"] = [w["detector"] for w in fired]
        self.records.append(rec)
        self.steps_recorded += 1
        return fired

    def dump(self, reason: str, path: Optional[str] = None) -> Optional[str]:
        """Write the ring (and accumulated warnings) as one JSON document;
        atomic (temp file + ``os.replace``) so a crash mid-dump can't leave
        a truncated artifact.  Returns the path written, or None when the
        recorder has no sink."""
        path = path or self.path
        if path is None:
            return None
        doc = {
            "schema": FLIGHT_SCHEMA,
            "reason": reason,
            "dumped_at": time.time(),
            "capacity": self.capacity,
            "steps_recorded": self.steps_recorded,
            "records": list(self.records),
            "warnings": list(self.warnings),
        }
        safe = _json_safe(doc, "flight_record")  # raises before any IO
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(safe, f, indent=1, allow_nan=False)
        os.replace(tmp, path)
        return path


def read_flight(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    if doc.get("schema") != FLIGHT_SCHEMA:
        raise ValueError(
            f"{path}: schema {doc.get('schema')!r} != {FLIGHT_SCHEMA!r}")
    return doc
