"""Fleet-wide metric aggregation: merge N per-replica telemetry streams
into one fleet-level view (a copy of
``neuronx_distributed_tpu/obs/aggregate.py``, stdlib only; the port's
fleet router, :mod:`..serving.fleet.router`, drives :class:`FleetHealth`
and the offline half reads the fleet's files).

A fleet run scatters its evidence: every replica engine owns a
:class:`~.registry.MetricRegistry` (plus ``serving_stats.jsonl`` when
configured) and the router owns a third.  This module is the merge layer:

- :func:`merge_snapshots` — fold per-replica ``registry.snapshot()`` dicts
  into one, per REGISTRY_METRICS kind: counters and gauges SUM (a fleet's
  queue depth is the sum of its queues), the :data:`GAUGE_MAX` set takes
  the MAX (a watermark's fleet value is its worst replica), histograms
  merge bucket-wise — the merged histogram is exactly the histogram of the
  concatenated samples (property-tested);
- :func:`fleet_prometheus_text` — the replica-labeled Prometheus
  exposition (``name{replica="0"} v`` per replica + the unlabeled merged
  series), with ``# TYPE`` emitted ONCE per metric family — concatenating
  per-replica ``prometheus_text()`` outputs duplicates TYPE lines, which
  breaks real scrapers;
- :class:`FleetAggregator` — the live object ``/metrics?scope=fleet``
  renders from: label -> registry sources, snapshot/merge/expose;
- :class:`FleetHealth` — the fleet's control room: one fleet-level
  :class:`~.health.HealthMonitor` over the MERGED snapshot plus lazily
  created per-replica monitors, all streaming to ONE ``alerts.jsonl``;
  the router raises/clears the ``replica_down`` condition through it on
  failover/restart;
- :func:`merge_scalar_records` / :func:`merge_serving_stats` /
  :func:`discover_replica_dirs` — the offline half ``obs_report
  --run-dir`` uses to fold a fleet run's scattered artifacts into one
  report.
"""

from __future__ import annotations

import glob
import json
import os
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from neuronx_distributed_tpu_torch.obs.health import (
    AlertSink,
    HealthMonitor,
    default_rules,
    healthz_doc,
)
from neuronx_distributed_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

# gauges whose fleet-level value is the WORST replica, not the sum:
# last-observation latencies and peak watermarks
GAUGE_MAX = frozenset({
    "serving/last_step_ms",
    "mem/device_peak_bytes",
    "mem/device_bytes_limit",
})


def metric_kind(name: str, value: Any) -> str:
    """``counter`` / ``gauge`` / ``histogram`` for a snapshot entry: the
    REGISTRY_METRICS declaration when present, else the repo naming
    convention (dict = histogram, ``*_total`` = counter, else gauge)."""
    from neuronx_distributed_tpu_torch.obs.schemas import REGISTRY_METRICS

    if isinstance(value, dict):
        return "histogram"
    kind = REGISTRY_METRICS.get(name)
    if kind is not None:
        return kind
    return "counter" if name.endswith("_total") else "gauge"


def merge_histogram_summaries(hists: Sequence[dict]) -> dict:
    """Merge histogram snapshot entries (``{"count", "sum", "buckets"}``
    with cumulative bucket counts).  Cumulative counts add bucket-wise, so
    for same-boundary histograms (a homogeneous fleet by construction) the
    result IS the histogram of the concatenated samples."""
    count = 0
    total = 0.0
    buckets: Dict[str, float] = {}
    for h in hists:
        count += int(h.get("count", 0))
        total += float(h.get("sum", 0.0))
        for le, cum in h.get("buckets", {}).items():
            buckets[le] = buckets.get(le, 0) + cum
    def edge(le: str) -> float:
        return float("inf") if le == "inf" else float(le)
    return {"count": count, "sum": total,
            "buckets": dict(sorted(buckets.items(),
                                   key=lambda kv: edge(kv[0])))}


def merge_snapshots(snaps: Iterable[dict]) -> dict:
    """Fold registry snapshots into one fleet-level snapshot (see module
    docstring for the per-kind merge semantics)."""
    merged: Dict[str, Any] = {}
    hists: Dict[str, List[dict]] = {}
    for snap in snaps:
        for name, value in snap.items():
            if isinstance(value, dict):
                hists.setdefault(name, []).append(value)
                continue
            kind = metric_kind(name, value)
            if name not in merged:
                merged[name] = float(value)
            elif kind == "gauge" and name in GAUGE_MAX:
                merged[name] = max(merged[name], float(value))
            else:
                merged[name] += float(value)
    for name, hs in hists.items():
        merged[name] = merge_histogram_summaries(hs)
    return dict(sorted(merged.items()))


def _prom_label(label: Any) -> str:
    s = str(label)
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", " ")


def fleet_prometheus_text(snapshots: "Dict[Any, dict]",
                          merged: bool = True) -> str:
    """Replica-labeled Prometheus exposition over per-source snapshots.

    One ``# TYPE`` line per metric FAMILY (the exposition-format rule a
    naive per-replica concatenation breaks), then one labeled series per
    replica and — with ``merged=True`` — the unlabeled fleet-merged
    series."""
    from neuronx_distributed_tpu_torch.obs.registry import _prom_name, _prom_val

    import math

    names: Dict[str, Any] = {}
    for snap in snapshots.values():
        for name, value in snap.items():
            names.setdefault(name, value)
    merged_snap = merge_snapshots(snapshots.values()) if merged else {}
    lines: List[str] = []
    for name in sorted(names):
        kind = metric_kind(name, names[name])
        pname = _prom_name(name)
        lines.append(f"# TYPE {pname} {kind}")
        series: List[Tuple[str, Any]] = [
            (f'replica="{_prom_label(label)}"', snap[name])
            for label, snap in sorted(snapshots.items(), key=lambda kv:
                                      str(kv[0]))
            if name in snap]
        if merged and name in merged_snap:
            series.append(("", merged_snap[name]))
        for label, value in series:
            if kind == "histogram":
                for le, cum in value.get("buckets", {}).items():
                    edge = "+Inf" if le == "inf" else le
                    sep = "," if label else ""
                    lines.append(
                        f'{pname}_bucket{{{label}{sep}le="{edge}"}} '
                        f"{_prom_val(float(cum))}")
                suffix = f"{{{label}}}" if label else ""
                lines.append(f"{pname}_sum{suffix} "
                             f"{_prom_val(float(value.get('sum', 0.0)))}")
                lines.append(f"{pname}_count{suffix} "
                             f"{_prom_val(float(value.get('count', 0)))}")
            else:
                v = float(value)
                if not math.isfinite(v):
                    continue
                suffix = f"{{{label}}}" if label else ""
                lines.append(f"{pname}{suffix} {_prom_val(v)}")
    return "\n".join(lines) + ("\n" if lines else "")


class FleetAggregator:
    """Live label -> registry sources with merge + exposition.

    ``sources`` is a dict of label -> registry (anything with
    ``snapshot()``), or a zero-arg callable returning one — the callable
    form follows a fleet through restarts (a rebuilt engine brings a fresh
    registry)."""

    def __init__(self, sources: "Dict[Any, Any] | Callable[[], Dict[Any, Any]]"):
        self._sources = sources

    @staticmethod
    def for_router(router: Any) -> "FleetAggregator":
        """Aggregate a :class:`~..serving.fleet.router.FleetRouter`: the
        router's own registry plus every LIVE replica engine's."""
        def sources() -> Dict[Any, Any]:
            out: Dict[Any, Any] = {"router": router.registry}
            for rid, replica in router.replicas.items():
                reg = (getattr(replica.engine, "registry", None)
                       if replica.alive else None)
                if reg is not None:
                    out[rid] = reg
            return out
        return FleetAggregator(sources)

    def snapshots(self) -> Dict[Any, dict]:
        sources = (self._sources() if callable(self._sources)
                   else self._sources)
        out: Dict[Any, dict] = {}
        for label, src in sources.items():
            out[label] = src.snapshot() if hasattr(src, "snapshot") \
                else dict(src)
        return out

    def merged(self) -> dict:
        return merge_snapshots(self.snapshots().values())

    def prometheus_text(self) -> str:
        """The ``/metrics?scope=fleet`` body."""
        return fleet_prometheus_text(self.snapshots())


class FleetHealth:
    """The fleet's control room: per-replica monitors + one fleet monitor,
    all streaming alert edges to ONE ``alerts.jsonl``.

    Wire it as ``FleetRouter(health=...)``: the router calls :meth:`step`
    every fleet iteration (cadenced by ``eval_every``), feeds terminal
    outputs through :meth:`note_output` (the fleet burn-rate rules'
    event stream), and raises/clears the ``replica_down`` condition on
    failover/warm restart.  Replica monitors are created lazily per live
    replica (scoped ``replica=`` tags on their rows) and dropped when the
    replica dies — a rebuilt engine gets a fresh monitor over its fresh
    registry."""

    def __init__(self, *, path: Optional[str] = None,
                 sink: Optional[AlertSink] = None,
                 rules: Optional[Sequence[Any]] = None,
                 replica_rules: "Optional[Callable[[], list]]" = None,
                 eval_every: int = 4,
                 clock: Callable[[], float] = time.monotonic,
                 wall: Callable[[], float] = time.time,
                 tracer: Any = None, registry: Any = None):
        if path is not None and sink is not None:
            raise ValueError("pass path= or sink=, not both")
        self.sink = sink if sink is not None else (
            AlertSink(path) if path is not None else None)
        self._own_sink = sink is None and path is not None
        self._clock = clock
        self._wall = wall
        self._tracer = tracer
        self.eval_every = int(eval_every)
        self._tick = 0
        self.fleet = HealthMonitor(
            rules if rules is not None else default_rules("fleet"),
            registry=registry, sink=self.sink, clock=clock, wall=wall,
            tracer=tracer, replica=-1)
        self._replica_rules = (replica_rules if replica_rules is not None
                               else (lambda: default_rules("serving")))
        self.replica_monitors: Dict[int, HealthMonitor] = {}
        # edge history of monitors whose replica died (the monitor object
        # goes with the engine, its emitted evidence must not): keeps
        # page_edges()/edges() consistent with the shared alerts.jsonl
        self._retired_edges: List[dict] = []

    def attach_router(self, router: Any) -> None:
        """Late-bind the fleet monitor's registry to the router's (the
        ``obs/alerts_*`` metrics then ride ``router_stats``' registry)."""
        self.fleet.attach_registry(router.registry)

    # -- router hooks ------------------------------------------------------

    def note_output(self, out: Any, now: Optional[float] = None) -> None:
        self.fleet.note_output(out, now)

    def replica_down(self, replica_id: int, cause: str = "",
                     now: Optional[float] = None) -> None:
        """A replica crashed out of rotation: fire ``replica_down`` (page)
        keyed by replica id; its per-replica monitor dies with the
        engine (a rebuilt engine gets a fresh one) but its emitted edges
        are retained."""
        dead = self.replica_monitors.pop(replica_id, None)
        if dead is not None:
            self._retired_edges.extend(dead.edges)
        self.fleet.set_condition(
            "replica_down", True, key=str(replica_id), severity="page",
            now=now, replica_id=replica_id, cause=cause)

    def replica_up(self, replica_id: int,
                   now: Optional[float] = None) -> None:
        """A warm restart re-entered rotation: resolve ``replica_down``."""
        self.fleet.set_condition(
            "replica_down", False, key=str(replica_id), severity="page",
            now=now, replica_id=replica_id)

    def replica_retired(self, replica_id: int, cause: str = "",
                        now: Optional[float] = None, *,
                        severity: str = "page") -> None:
        """A replica left rotation PERMANENTLY — crash budget spent, or a
        deliberate scale-in drain (pass ``severity="warn"``: nothing
        crashed, nobody should be paged).  Resolves the stale
        ``replica_down`` (the restart the pager was waiting on will never
        come) and fires the terminal ``replica_retired`` edge in its
        place, so autopilot and the pager can tell "warm restart coming"
        from "needs replacement".  The condition stays firing until
        :meth:`replica_replaced` reports a replacement joined."""
        dead = self.replica_monitors.pop(replica_id, None)
        if dead is not None:
            self._retired_edges.extend(dead.edges)
        self.fleet.set_condition(
            "replica_down", False, key=str(replica_id), severity="page",
            now=now, replica_id=replica_id)
        self.fleet.set_condition(
            "replica_retired", True, key=str(replica_id),
            severity=severity, now=now, replica_id=replica_id, cause=cause)

    def replica_replaced(self, replica_id: int, by: int,
                         now: Optional[float] = None) -> None:
        """Autoscale replaced a retired replica: resolve its terminal
        ``replica_retired`` (and any stale ``replica_down``) with the
        replacement's id on the edge."""
        self.fleet.set_condition(
            "replica_down", False, key=str(replica_id), severity="page",
            now=now, replica_id=replica_id, replaced_by=by)
        self.fleet.set_condition(
            "replica_retired", False, key=str(replica_id), severity="page",
            now=now, replica_id=replica_id, replaced_by=by)

    def step(self, router: Any, now: Optional[float] = None) -> None:
        """One fleet-iteration tick: every ``eval_every``-th call
        evaluates each live replica's monitor over its engine snapshot,
        then the fleet monitor over the MERGED snapshot (router registry +
        every live engine)."""
        self._tick += 1
        if self._tick % self.eval_every:
            return
        now = self._clock() if now is None else now
        snaps: List[dict] = [router.registry.snapshot()]
        for rid, replica in router.replicas.items():
            if not replica.alive:
                continue
            reg = getattr(replica.engine, "registry", None)
            if reg is None:
                continue
            snap = reg.snapshot()
            snaps.append(snap)
            mon = self.replica_monitors.get(rid)
            if mon is None:
                mon = self.replica_monitors[rid] = HealthMonitor(
                    self._replica_rules(), sink=self.sink,
                    clock=self._clock, wall=self._wall,
                    tracer=self._tracer, replica=rid)
            mon.evaluate(now, snapshot=snap)
        self.fleet.evaluate(now, snapshot=merge_snapshots(snaps))

    # -- views -------------------------------------------------------------

    def firing(self) -> List[dict]:
        out = list(self.fleet.firing())
        for rid, mon in self.replica_monitors.items():
            for a in mon.firing():
                out.append({**a, "replica": rid})
        return out

    def healthz(self) -> dict:
        return healthz_doc(self.firing())

    def edges(self) -> List[dict]:
        """Every alert edge this control room emitted — fleet monitor,
        live replica monitors, AND retired (crashed) replicas' monitors —
        matching the shared ``alerts.jsonl`` record for record (up to the
        per-monitor ring bounds)."""
        out = list(self.fleet.edges)
        for mon in self.replica_monitors.values():
            out.extend(mon.edges)
        out.extend(self._retired_edges)
        out.sort(key=lambda r: r.get("mono", 0.0))
        return out

    def page_edges(self) -> int:
        return sum(1 for r in self.edges()
                   if r["state"] == "firing" and r["severity"] == "page")

    def close(self) -> None:
        if self.sink is not None and self._own_sink:
            self.sink.close()


# -- offline merges (obs_report --run-dir fleet layouts) ---------------------

def _latest_by_tag(records: Iterable[dict]) -> Dict[str, dict]:
    latest: Dict[str, dict] = {}
    for r in records:
        tag = r.get("tag")
        if tag is None:
            continue
        prev = latest.get(tag)
        if prev is None or int(r.get("step", 0)) >= int(prev.get("step", 0)):
            latest[tag] = r
    return latest


def merge_scalar_records(streams: Sequence[List[dict]]) -> List[dict]:
    """Fold per-replica ``scalars.jsonl`` streams into ONE synthetic
    stream: each replica contributes its LATEST record per tag, and the
    per-tag values merge per kind — counters, histogram-flattened tags
    (``/le_*``, ``/count``, ``/sum`` — cumulative counts add) and gauges
    SUM; :data:`GAUGE_MAX` gauges take the max.  The result feeds the
    standard report machinery (``read_histograms`` reassembles the merged
    buckets exactly), where naively concatenating the raw streams would
    let one replica's snapshot shadow the others (latest step wins per
    tag)."""
    per_stream = [_latest_by_tag(s) for s in streams]
    tags: Dict[str, None] = {}
    for latest in per_stream:
        for tag in latest:
            tags.setdefault(tag)
    # histogram-flattened families: any tag with an /le_ edge marks its
    # base name, whose /count and /sum siblings must SUM like the edges do
    hist_bases = {tag.split("/le_")[0] for tag in tags if "/le_" in tag}
    out: List[dict] = []
    for tag in tags:
        recs = [latest[tag] for latest in per_stream if tag in latest]
        is_hist_part = "/le_" in tag or any(
            tag == f"{base}/{suffix}" for base in hist_bases
            for suffix in ("count", "sum"))
        values = [float(r["value"]) for r in recs]
        if (not is_hist_part
                and metric_kind(tag, recs[0].get("value")) == "gauge"
                and tag in GAUGE_MAX):
            value = max(values)
        else:
            value = sum(values)
        out.append({
            "step": max(int(r.get("step", 0)) for r in recs),
            "tag": tag,
            "value": value,
            "time": max(float(r.get("time", 0.0)) for r in recs),
        })
    return out


def merge_serving_stats(paths: Sequence[str]) -> List[dict]:
    """Concatenate per-replica ``serving_stats.jsonl`` streams (v4-
    tolerant), sorted by wall ``time`` so the merged stream reads like one
    engine's."""
    from neuronx_distributed_tpu_torch.obs.report import read_serving_stats

    out: List[dict] = []
    for p in paths:
        if os.path.exists(p):
            out.extend(read_serving_stats(p))
    out.sort(key=lambda r: r.get("time", 0.0))
    return out


def merge_perf_files(paths: Sequence[str]) -> List[dict]:
    """Fold per-replica ``perf_attribution.jsonl`` files into one fleet
    attribution stream: per-family calls / device time / flops / bytes SUM
    across replicas (the fleet spent that much device time on prefill,
    full stop) and the derived roofline numbers are recomputed against the
    merged totals via :func:`~.perf.merge_perf_records`.  A single file
    passes through untouched."""
    from neuronx_distributed_tpu_torch.obs.perf import (
        merge_perf_records,
        read_perf_attribution,
    )

    streams = [read_perf_attribution(p) for p in paths if os.path.exists(p)]
    streams = [s for s in streams if s]
    if not streams:
        return []
    if len(streams) == 1:
        return streams[0]
    return merge_perf_records(streams)


def discover_replica_dirs(run_dir: str) -> List[Tuple[str, str]]:
    """Fleet-layout discovery for ``obs_report --run-dir``: immediate
    subdirectories holding a ``scalars.jsonl`` or ``serving_stats.jsonl``
    are per-replica artifact dirs; returns ``[(label, dir), ...]`` sorted
    by label."""
    out: List[Tuple[str, str]] = []
    for sub in sorted(glob.glob(os.path.join(run_dir, "*"))):
        if not os.path.isdir(sub):
            continue
        if (os.path.exists(os.path.join(sub, "scalars.jsonl"))
                or os.path.exists(os.path.join(sub, "serving_stats.jsonl"))):
            out.append((os.path.basename(sub.rstrip(os.sep)), sub))
    return out


def summarize_router_stats(path: str) -> Optional[dict]:
    """Rollup of a fleet run's ``router_stats.jsonl`` for the report: how
    many terminal requests, their state mix, how many survived a failover
    (requeues > 0), and the replicas that served them."""
    if not os.path.exists(path):
        return None
    by_state: Dict[str, int] = {}
    requeued = 0
    migrated = 0
    migrations = 0
    roles: Dict[str, int] = {}
    replica_roles: Dict[int, str] = {}
    replicas: set = set()
    n = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            n += 1
            by_state[rec.get("state", "?")] = \
                by_state.get(rec.get("state", "?"), 0) + 1
            if rec.get("requeues", 0) > 0:
                requeued += 1
            # v2 disagg evidence (absent in v1 records: zeros/empty)
            if rec.get("migrations", 0) > 0:
                migrated += 1
                migrations += int(rec["migrations"])
            role = rec.get("role")
            if role is not None:
                roles[role] = roles.get(role, 0) + 1
                if rec.get("replica", -1) >= 0:
                    replica_roles[rec["replica"]] = role
            if rec.get("replica", -1) >= 0:
                replicas.add(rec["replica"])
    if not n:
        return None
    return {
        "records": n,
        "by_state": dict(sorted(by_state.items())),
        "requeued": requeued,
        "replicas_seen": sorted(replicas),
        # disagg rollup: requests that took >=1 KV-migration hop, total
        # hops, terminal-role mix, and the per-replica role map (empty on
        # v1 streams and plain fleets)
        "migrated": migrated,
        "migrations": migrations,
        "roles": dict(sorted(roles.items())),
        "replica_roles": {str(k): v
                          for k, v in sorted(replica_roles.items())},
    }
