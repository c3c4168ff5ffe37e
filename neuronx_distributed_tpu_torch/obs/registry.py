"""Metric registry: counters, gauges, fixed-bucket histograms (a copy of
``neuronx_distributed_tpu/obs/registry.py``, which is stdlib only).

Low-overhead by construction: a metric update is a Python attribute write
plus (for histograms) one ``bisect``; no locks on the hot path (the serving
engine's step loop is single-threaded; registration and the serializers'
snapshot take the lock, so the metrics-server thread can scrape a live
registry).  Two serializations:

- the ``scalars.jsonl`` schema (``{"step", "tag", "value", "time",
  "mono"}`` per line, :mod:`.schemas` kind ``scalar``), histograms
  flattened to ``name/count``, ``name/sum`` and cumulative
  ``name/le_<bound>`` tags;
- Prometheus text exposition (``# TYPE`` lines, ``_bucket{le=...}``
  cumulative histograms) for scrape-based collection.

Every number a metric takes is a host number: nothing here reads a tensor.
"""

from __future__ import annotations

import bisect
import json
import math
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
)


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative increment {amount}")
        self.value += amount


class Gauge:
    """Last-value metric."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount


class Histogram:
    """Fixed-boundary histogram (Prometheus semantics: ``boundaries[i]`` is
    the inclusive upper edge of bucket ``i``; one implicit ``+Inf`` bucket)."""

    __slots__ = ("name", "boundaries", "counts", "sum", "count")

    def __init__(self, name: str, boundaries: Sequence[float] = DEFAULT_BUCKETS):
        if not boundaries or list(boundaries) != sorted(boundaries):
            raise ValueError(
                f"histogram {name}: boundaries must be non-empty and sorted, "
                f"got {boundaries!r}")
        self.name = name
        self.boundaries = tuple(float(b) for b in boundaries)
        self.counts = [0] * (len(self.boundaries) + 1)  # last = +Inf overflow
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        value = float(value)
        if math.isnan(value):
            return  # NaN observations poison sum/mean; anomaly detectors own them
        self.counts[bisect.bisect_left(self.boundaries, value)] += 1
        self.sum += value
        self.count += 1

    def cumulative(self) -> List[Tuple[float, int]]:
        """``[(le, cum_count), ...]`` including the ``+Inf`` edge."""
        out, acc = [], 0
        for le, n in zip(self.boundaries, self.counts):
            acc += n
            out.append((le, acc))
        out.append((math.inf, acc + self.counts[-1]))
        return out


def _fmt_le(le: float) -> str:
    """Bucket-edge tag fragment: finite edges keep repr fidelity, inf -> 'inf'."""
    if math.isinf(le):
        return "inf"
    return repr(le) if le != int(le) else str(int(le))


class MetricRegistry:
    """Name-keyed home for the run's metrics.  ``counter`` / ``gauge`` /
    ``histogram`` are get-or-create (idempotent, so call sites never thread
    metric objects around); a name can hold only one metric kind."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, name: str, cls, *args):
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, *args)
                self._metrics[name] = m
        return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge)

    def histogram(self, name: str,
                  boundaries: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        h = self._get_or_create(name, Histogram, boundaries)
        want = tuple(float(b) for b in boundaries)
        if h.boundaries != want:
            # silently returning the earlier buckets would misfile every
            # later observation; a mismatch is a call-site bug
            raise ValueError(
                f"histogram {name!r} already registered with boundaries "
                f"{h.boundaries}, requested {want}")
        return h

    def metrics(self) -> List[object]:
        with self._lock:
            return list(self._metrics.values())

    def _items(self) -> List[Tuple[str, object]]:
        """Sorted (name, metric) snapshot taken under the lock — the
        serializers iterate THIS, not the live dict, so a concurrent
        scrape (obs.metrics_server runs on its own thread) can never race
        a hot-path metric registration mid-iteration."""
        with self._lock:
            return sorted(self._metrics.items())

    # -- serialization -----------------------------------------------------

    def snapshot(self) -> Dict[str, object]:
        """Plain-data view: scalars map to floats, histograms to a dict."""
        out: Dict[str, object] = {}
        for name, m in self._items():
            if isinstance(m, Histogram):
                out[name] = {
                    "count": m.count,
                    "sum": m.sum,
                    "buckets": {_fmt_le(le): n for le, n in m.cumulative()},
                }
            else:
                out[name] = m.value
        return out

    def to_scalar_records(self, step: int, now: Optional[float] = None,
                          mono: Optional[float] = None) -> List[dict]:
        """Flatten every metric into ``scalars.jsonl``-schema records.

        Every record is stamped with BOTH clocks: ``time`` (wall — the
        shared epoch cross-host tooling merges on) and ``mono`` (the
        host-monotonic instant — skew-free ordering against the serving
        stack's monotonic-clocked spans and scheduler timestamps; wall
        time alone mis-sorts cross-replica artifacts after NTP steps)."""
        now = time.time() if now is None else now
        mono = time.monotonic() if mono is None else mono
        recs: List[dict] = []

        def rec(tag: str, value: float):
            value = float(value)
            if not math.isfinite(value):
                return  # a NaN gauge (e.g. diverged loss) must not poison
                # the JSONL stream; the anomaly detectors carry that signal
            recs.append({"step": int(step), "tag": tag, "value": value,
                         "time": now, "mono": mono})

        for name, m in self._items():
            if isinstance(m, Histogram):
                rec(f"{name}/count", m.count)
                rec(f"{name}/sum", m.sum)
                for le, cum in m.cumulative():
                    rec(f"{name}/le_{_fmt_le(le)}", cum)
            else:
                rec(name, m.value)
        return recs

    def dump_jsonl(self, path: str, step: int) -> None:
        """Append the current snapshot to a ``scalars.jsonl``-schema file."""
        records = self.to_scalar_records(step)
        with open(path, "a") as f:
            for r in records:
                f.write(json.dumps(r) + "\n")

    def prometheus_text(self) -> str:
        """Prometheus text exposition of the current state."""
        lines: List[str] = []
        for name, m in self._items():
            pname = _prom_name(name)
            if isinstance(m, Counter):
                lines.append(f"# TYPE {pname} counter")
                lines.append(f"{pname} {_prom_val(m.value)}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {pname} gauge")
                lines.append(f"{pname} {_prom_val(m.value)}")
            else:
                lines.append(f"# TYPE {pname} histogram")
                for le, cum in m.cumulative():
                    edge = "+Inf" if math.isinf(le) else _prom_val(le)
                    lines.append(f'{pname}_bucket{{le="{edge}"}} {cum}')
                lines.append(f"{pname}_sum {_prom_val(m.sum)}")
                lines.append(f"{pname}_count {m.count}")
        return "\n".join(lines) + ("\n" if lines else "")


def _prom_name(name: str) -> str:
    """Sanitize to the Prometheus metric-name charset."""
    out = [c if (c.isalnum() or c in "_:") else "_" for c in name]
    if out and out[0].isdigit():
        out.insert(0, "_")
    return "".join(out)


def _prom_val(v: float) -> str:
    if not math.isfinite(v):  # Prometheus text accepts NaN/+Inf/-Inf
        return "NaN" if math.isnan(v) else ("+Inf" if v > 0 else "-Inf")
    return repr(v) if v != int(v) else str(int(v))


def read_histograms(records: Iterable[dict]) -> Dict[str, dict]:
    """Reconstruct histogram summaries from ``scalars.jsonl``-schema records
    produced by :meth:`MetricRegistry.to_scalar_records` (latest step wins).
    Returns ``{name: {"count", "sum", "mean", "buckets": {le_str: cum}}}``."""
    latest: Dict[str, dict] = {}
    for r in records:
        tag = r.get("tag", "")
        for marker in ("/count", "/sum"):
            if tag.endswith(marker):
                name = tag[: -len(marker)]
                latest.setdefault(name, {"buckets": {}})[marker[1:]] = r["value"]
                break
        else:
            if "/le_" in tag:
                name, le = tag.rsplit("/le_", 1)
                latest.setdefault(name, {"buckets": {}})["buckets"][le] = r["value"]
    out = {}
    for name, h in latest.items():
        if not h["buckets"]:
            continue  # a plain tag that merely ends in /count or /sum
        count = h.get("count", 0.0)
        out[name] = {
            "count": count,
            "sum": h.get("sum", 0.0),
            "mean": (h.get("sum", 0.0) / count) if count else 0.0,
            "buckets": h["buckets"],
        }
    return out
