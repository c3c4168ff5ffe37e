"""Fleet health monitor: a declarative rules engine over live metrics (a
copy of ``neuronx_distributed_tpu/obs/health.py``, stdlib only).

The instrumentation (request traces, compile/HBM ledgers, the
``serving/*`` / ``router/*`` / ``kvcache/*`` / ``tenancy/*`` registry
metrics) produce every raw signal a production fleet needs — but nothing
in-tree *evaluates* them.  This module is the control room: a
:class:`HealthMonitor` evaluates a pack of rules on a step/scrape cadence
over live :class:`~.registry.MetricRegistry` snapshots and turns metric
movement into **alerts** with firing/resolved edges:

- :class:`ThresholdRule` — a metric (or derived value) crossing a bound:
  queue backlog, KV-headroom exhaustion, compile storms, adapter-pool
  thrash;
- :class:`TrendRule` — EWMA drift detection (a fast EWMA deviating from a
  slow one): TTFT drift, prefix-hit-rate collapse, speculative-acceptance
  collapse, throughput sag — the "it got slowly worse" class no single
  threshold catches;
- :class:`BurnRateRule` — multi-window SLO **error-budget burn rate** over
  per-class deadline attainment (the DistServe goodput framing: a request
  is *good* when it finishes within its SLO).  The SRE-workbook shape: the
  alert fires only when EVERY window's burn rate exceeds the factor — the
  short window gives reactivity, the long one statistical significance —
  so a fast pair (minutes) pages and a slow pair (hours) warns.

Edges (never steady states) are persisted: each firing→resolved transition
appends one schema-checked ``alerts.jsonl`` row (``obs.schemas`` kind
``alert``), bumps the ``obs/alerts_total`` counter and the
``obs/alerts_firing`` gauge, and — with a tracer attached — drops an
``alert`` instant so alerts land inside request waterfalls.  Hysteresis
(``fire_after`` / ``resolve_after`` consecutive evaluations) keeps
flapping metrics from spamming the stream.

Monitor-off is allocation-free: every call site in the serving/trainer hot
paths guards on ``health is not None`` (the ``SPANS_CREATED`` discipline);
the module counter :data:`ALERTS_EVALUATED` is the test hook that proves
no evaluation ever ran.
"""

from __future__ import annotations

import json
import math
import os
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from neuronx_distributed_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

ALERTS_FILE = "alerts.jsonl"
ALERT_SCHEMA = "alert/1"

SEVERITIES = ("info", "warn", "page")
_SEV_ORDER = {s: i for i, s in enumerate(SEVERITIES)}

# module-level evaluation counter: the monitor-off overhead test reads it
# around a full serving run and asserts it never moved — the "zero
# allocations in the hot path when off" contract, checkable without a
# profiler (the SPANS_CREATED / LEDGER_ROWS discipline)
ALERTS_EVALUATED = 0


def worst_severity(severities: Sequence[str]) -> Optional[str]:
    """The highest-ranked severity in ``severities`` (None when empty)."""
    best = None
    for s in severities:
        if best is None or _SEV_ORDER.get(s, 0) > _SEV_ORDER.get(best, 0):
            best = s
    return best


def healthz_doc(firing: Sequence[dict]) -> dict:
    """The ONE readiness contract both monitor flavors serve on
    ``/healthz``: not-ok exactly when a ``page``-severity alert is firing
    (a warned-but-serving target stays in the load balancer; a paging one
    comes out)."""
    worst = worst_severity([a["severity"] for a in firing])
    return {
        "ok": worst != "page",
        "alerts_firing": len(firing),
        "worst_severity": worst,
        "firing": [a["rule"] for a in firing],
    }


class RuleResult:
    """One rule evaluation: whether the condition holds right now, plus the
    evidence (observed value vs bound) the alert row carries."""

    __slots__ = ("firing", "observed", "bound", "window", "attrs")

    def __init__(self, firing: bool, observed: Optional[float] = None,
                 bound: Optional[float] = None, window: Optional[str] = None,
                 attrs: Optional[dict] = None):
        self.firing = bool(firing)
        self.observed = observed
        self.bound = bound
        self.window = window
        self.attrs = attrs or {}


class EvalContext:
    """What a rule sees at evaluation time: the metrics snapshot, the
    monotonic instant, and the monitor's per-class SLO event windows."""

    __slots__ = ("snapshot", "now", "monitor")

    def __init__(self, snapshot: dict, now: float,
                 monitor: "Optional[HealthMonitor]" = None):
        self.snapshot = snapshot
        self.now = now
        self.monitor = monitor

    def value(self, name: str) -> Optional[float]:
        """A counter/gauge value from the snapshot (None when absent or a
        histogram lives under the name)."""
        v = self.snapshot.get(name)
        if v is None or isinstance(v, dict):
            return None
        return float(v)

    def hist(self, name: str) -> Optional[dict]:
        """A histogram summary (``{"count", "sum", "buckets"}``) or None."""
        v = self.snapshot.get(name)
        return v if isinstance(v, dict) else None

    def window_counts(self, priority: str, window_s: float
                      ) -> Tuple[int, int]:
        """``(good, bad)`` SLO events of ``priority`` inside the trailing
        ``window_s`` seconds (zeros without a monitor — burn rules need
        the event stream)."""
        if self.monitor is None:
            return 0, 0
        return self.monitor._window_counts(priority, window_s, self.now)


class Rule:
    """Base rule: a name, a severity, and firing hysteresis.

    ``fire_after`` / ``resolve_after`` are CONSECUTIVE evaluations the
    condition must hold / clear before the state transitions — a flapping
    metric produces one firing edge, not one per oscillation.  Subclasses
    implement :meth:`evaluate` returning a :class:`RuleResult`, or None
    for "no observation this round" (state held, streaks reset)."""

    def __init__(self, name: str, severity: str = "warn", *,
                 fire_after: int = 1, resolve_after: int = 1):
        if severity not in SEVERITIES:
            raise ValueError(f"rule {name!r}: severity must be one of "
                             f"{SEVERITIES}, got {severity!r}")
        if fire_after < 1 or resolve_after < 1:
            raise ValueError(f"rule {name!r}: fire_after/resolve_after must "
                             "be >= 1")
        self.name = name
        self.severity = severity
        self.fire_after = int(fire_after)
        self.resolve_after = int(resolve_after)

    def evaluate(self, ctx: EvalContext) -> Optional[RuleResult]:
        raise NotImplementedError


_OPS: Dict[str, Callable[[float, float], bool]] = {
    ">": lambda v, b: v > b,
    ">=": lambda v, b: v >= b,
    "<": lambda v, b: v < b,
    "<=": lambda v, b: v <= b,
}


class ThresholdRule(Rule):
    """Fire when a value crosses a bound.

    The value is ``metric``'s snapshot value, or ``value_fn(ctx)`` when
    given (None = no observation).  ``rate=True`` observes the DELTA of
    the metric between evaluations instead of its level — the right shape
    for monotone counters (compile storms, adapter evictions): the alert
    fires while the counter is MOVING and resolves when it goes quiet."""

    def __init__(self, name: str, metric: Optional[str] = None,
                 bound: float = 0.0, *, op: str = ">",
                 value_fn: Optional[Callable[[EvalContext],
                                             Optional[float]]] = None,
                 rate: bool = False, severity: str = "warn",
                 fire_after: int = 1, resolve_after: int = 1):
        super().__init__(name, severity, fire_after=fire_after,
                         resolve_after=resolve_after)
        if metric is None and value_fn is None:
            raise ValueError(f"rule {name!r}: needs metric= or value_fn=")
        if op not in _OPS:
            raise ValueError(f"rule {name!r}: op must be one of "
                             f"{sorted(_OPS)}, got {op!r}")
        self.metric = metric
        self.bound = float(bound)
        self.op = op
        self.value_fn = value_fn
        self.rate = rate
        self._prev: Optional[float] = None

    def evaluate(self, ctx: EvalContext) -> Optional[RuleResult]:
        v = (self.value_fn(ctx) if self.value_fn is not None
             else ctx.value(self.metric))
        if v is None:
            return None
        if self.rate:
            prev, self._prev = self._prev, v
            if prev is None:
                return None  # first sight: no delta yet
            v = v - prev
        return RuleResult(_OPS[self.op](v, self.bound), observed=v,
                          bound=self.bound)


class TrendRule(Rule):
    """EWMA drift: a fast EWMA deviating from a slow one by more than
    ``ratio`` in the bad ``direction``.

    ``direction="up"`` fires when ``fast > ratio * slow`` (a latency that
    drifted up); ``direction="down"`` fires when ``fast < slow / ratio``
    (a hit rate / acceptance rate / throughput that collapsed).  The first
    ``warmup`` samples only feed the EWMAs (no verdict while the baseline
    forms), and ``min_slow`` suppresses verdicts while the slow baseline
    sits below a floor (a 0-lookup hit rate is not a collapse).

    The value is ``metric``'s level, or ``value_fn(ctx)`` — the default
    rule pack derives windowed rates (counter deltas per evaluation) and
    histogram window-means through closures over :class:`_Delta` /
    :class:`_Rate` / :class:`_HistWindowMean`."""

    def __init__(self, name: str, metric: Optional[str] = None, *,
                 value_fn: Optional[Callable[[EvalContext],
                                             Optional[float]]] = None,
                 direction: str = "up", ratio: float = 2.0,
                 fast_alpha: float = 0.5, slow_alpha: float = 0.1,
                 warmup: int = 5, min_slow: Optional[float] = None,
                 severity: str = "warn", fire_after: int = 1,
                 resolve_after: int = 1):
        super().__init__(name, severity, fire_after=fire_after,
                         resolve_after=resolve_after)
        if metric is None and value_fn is None:
            raise ValueError(f"rule {name!r}: needs metric= or value_fn=")
        if direction not in ("up", "down"):
            raise ValueError(f"rule {name!r}: direction must be 'up' or "
                             f"'down', got {direction!r}")
        if ratio <= 1.0:
            raise ValueError(f"rule {name!r}: ratio must be > 1, "
                             f"got {ratio}")
        self.metric = metric
        self.value_fn = value_fn
        self.direction = direction
        self.ratio = float(ratio)
        self.fast_alpha = float(fast_alpha)
        self.slow_alpha = float(slow_alpha)
        self.warmup = int(warmup)
        self.min_slow = min_slow
        self.fast: Optional[float] = None
        self.slow: Optional[float] = None
        self._samples = 0

    def evaluate(self, ctx: EvalContext) -> Optional[RuleResult]:
        v = (self.value_fn(ctx) if self.value_fn is not None
             else ctx.value(self.metric))
        if v is None or not math.isfinite(v):
            return None
        if self.fast is None:
            self.fast = self.slow = v
        else:
            self.fast += self.fast_alpha * (v - self.fast)
            self.slow += self.slow_alpha * (v - self.slow)
        self._samples += 1
        if self._samples <= self.warmup:
            return None
        if self.min_slow is not None and abs(self.slow) < self.min_slow:
            return None
        if self.direction == "up":
            bound = self.ratio * self.slow
            firing = self.fast > bound
        else:
            bound = self.slow / self.ratio
            firing = self.fast < bound
        return RuleResult(firing, observed=self.fast, bound=bound,
                          attrs={"slow_ewma": self.slow})


class BurnRateRule(Rule):
    """Multi-window SLO error-budget burn rate over per-class deadline
    attainment.

    ``objective`` is the SLO target (0.99 = 99% of requests good); the
    error budget is ``1 - objective``.  Over each trailing window, the
    burn rate is ``error_fraction / budget`` — burn 1.0 spends the budget
    exactly at the SLO period's pace, burn ``N`` exhausts it ``N``× too
    fast.  The rule fires only when EVERY window in ``windows`` burns at
    ``>= factor`` (short window = reactivity, long window = significance —
    the multiwindow AND from the SRE workbook), and won't fire on fewer
    than ``min_events`` events in the SHORTEST window (resolving is always
    allowed; an empty window burns 0).  Events arrive through
    :meth:`HealthMonitor.note_request` — the engine feeds one per terminal
    request (good = finished within its deadline)."""

    def __init__(self, name: str, *, priority: str = "interactive",
                 objective: float = 0.99,
                 windows: Sequence[float] = (300.0, 3600.0),
                 factor: float = 14.4, min_events: int = 4,
                 severity: str = "page", fire_after: int = 1,
                 resolve_after: int = 1):
        super().__init__(name, severity, fire_after=fire_after,
                         resolve_after=resolve_after)
        if not 0.0 < objective < 1.0:
            raise ValueError(f"rule {name!r}: objective must be in (0, 1), "
                             f"got {objective}")
        if not windows or any(w <= 0 for w in windows):
            raise ValueError(f"rule {name!r}: windows must be positive, "
                             f"got {windows}")
        self.priority = priority
        self.objective = float(objective)
        self.budget = 1.0 - float(objective)
        self.windows = tuple(sorted(float(w) for w in windows))
        self.factor = float(factor)
        self.min_events = int(min_events)

    def burn_rates(self, ctx: EvalContext) -> List[Tuple[float, float, int]]:
        """``[(window_s, burn, events), ...]`` — exposed for tests so the
        hand-computed fixtures check the same arithmetic the alert uses."""
        out = []
        for w in self.windows:
            good, bad = ctx.window_counts(self.priority, w)
            total = good + bad
            err = (bad / total) if total else 0.0
            out.append((w, err / self.budget, total))
        return out

    def evaluate(self, ctx: EvalContext) -> Optional[RuleResult]:
        rates = self.burn_rates(ctx)
        firing = all(burn >= self.factor for _, burn, _ in rates)
        if firing and rates[0][2] < self.min_events:
            firing = False  # too little evidence in the shortest window
        label = "+".join(f"{int(w)}s" for w, _, _ in rates)
        # the limiting (smallest) burn is the honest observed value: the
        # alert fires exactly when IT clears the factor
        observed = min(burn for _, burn, _ in rates)
        return RuleResult(firing, observed=observed, bound=self.factor,
                          window=label,
                          attrs={"objective": self.objective,
                                 "events": rates[0][2]})


# -- derived-value helpers for the default pack ------------------------------

class _Delta:
    """Delta of a counter between evaluations (None at first sight)."""

    def __init__(self, metric: str):
        self.metric = metric
        self._prev: Optional[float] = None

    def __call__(self, ctx: EvalContext) -> Optional[float]:
        v = ctx.value(self.metric)
        if v is None:
            return None
        prev, self._prev = self._prev, v
        return None if prev is None else v - prev


class _Rate:
    """Per-second rate of a counter between evaluations."""

    def __init__(self, metric: str):
        self.metric = metric
        self._prev: Optional[Tuple[float, float]] = None

    def __call__(self, ctx: EvalContext) -> Optional[float]:
        v = ctx.value(self.metric)
        if v is None:
            return None
        prev, self._prev = self._prev, (v, ctx.now)
        if prev is None or ctx.now <= prev[1]:
            return None
        return (v - prev[0]) / (ctx.now - prev[1])


class _WindowRatio:
    """Windowed success ratio from two counters' deltas between
    evaluations: ``d(num) / (d(num) + d(den))`` — e.g. prefix hits over
    hits+misses, or accepted over proposed.  None when nothing moved."""

    def __init__(self, num: str, den: str):
        self.num = num
        self.den = den
        self._prev: Optional[Tuple[float, float]] = None

    def __call__(self, ctx: EvalContext) -> Optional[float]:
        n, d = ctx.value(self.num), ctx.value(self.den)
        if n is None or d is None:
            return None
        prev, self._prev = self._prev, (n, d)
        if prev is None:
            return None
        dn, dd = n - prev[0], d - prev[1]
        total = dn + dd
        return None if total <= 0 else dn / total


class _WindowFraction:
    """Windowed fraction from two counters' deltas between evaluations:
    ``d(num) / d(den)`` where num is a SUBSET of den — e.g. accepted out
    of proposed draft tokens.  None when the denominator did not move."""

    def __init__(self, num: str, den: str):
        self.num = num
        self.den = den
        self._prev: Optional[Tuple[float, float]] = None

    def __call__(self, ctx: EvalContext) -> Optional[float]:
        n, d = ctx.value(self.num), ctx.value(self.den)
        if n is None or d is None:
            return None
        prev, self._prev = self._prev, (n, d)
        if prev is None:
            return None
        dd = d - prev[1]
        return None if dd <= 0 else (n - prev[0]) / dd


class _HistWindowMean:
    """Mean of a histogram's NEW observations since the last evaluation
    (None when no new samples landed) — the windowed TTFT/latency feed the
    drift rules trend on."""

    def __init__(self, metric: str):
        self.metric = metric
        self._prev: Optional[Tuple[float, float]] = None

    def __call__(self, ctx: EvalContext) -> Optional[float]:
        h = ctx.hist(self.metric)
        if h is None:
            return None
        count, total = float(h.get("count", 0)), float(h.get("sum", 0.0))
        prev, self._prev = self._prev, (count, total)
        if prev is None:
            return None
        dc = count - prev[0]
        return None if dc <= 0 else (total - prev[1]) / dc


def _kv_headroom_frac(ctx: EvalContext) -> Optional[float]:
    total = ctx.value("kvcache/pages_total")
    if not total:
        return None
    in_use = ctx.value("kvcache/pages_in_use") or 0.0
    return max(1.0 - in_use / total, 0.0)


def default_rules(scope: str = "serving", *,
                  slo_objective: float = 0.99,
                  fast_windows: Sequence[float] = (300.0, 3600.0),
                  slow_windows: Sequence[float] = (3600.0, 21600.0),
                  fast_factor: float = 14.4, slow_factor: float = 6.0,
                  classes: Sequence[str] = ("interactive", "batch"),
                  queue_depth_bound: float = 64.0,
                  kv_headroom_frac: float = 0.05,
                  adapter_evictions_per_eval: float = 8.0) -> List[Rule]:
    """The default rule pack per scope.

    - ``serving``: one engine — backlog / headroom thresholds, the four
      EWMA drift rules, compile-storm and adapter-thrash rate rules, and
      the per-class fast (page) + slow (warn) burn-rate pairs;
    - ``fleet``: evaluated over the MERGED fleet snapshot — router
      backlog, failover rate, pool-wide KV headroom, fleet-level drift
      and burn rules (``replica_down`` itself is an externally-driven
      condition the router raises, not a metric rule);
    - ``train``: a trainer — throughput sag and compile storms (loss
      anomalies stay with the flight recorder's detectors);
    - ``all``: the union pack for an ``Observability(health=True)`` hub
      that may back either a trainer or a serving engine — the serving
      pack plus the train-scope rules under distinct names (rules over
      absent metrics stay silent).

    Every scope additionally carries the perf-attribution drift rules
    (``mfu_sag`` over ``perf/mfu_milli``, ``roofline_drift`` over
    ``perf/roofline_pct_milli``) — silent unless the run profiles with
    ``Observability(perf=True)``.
    """
    if scope not in ("serving", "fleet", "train", "all"):
        raise ValueError(f"unknown rule scope {scope!r}")
    rules: List[Rule] = [
        ThresholdRule("compile_storm", "trace/compile_storms_total",
                      0.0, op=">", rate=True, severity="warn"),
        # perf-attribution drift (every scope: the perf/* gauges exist for
        # trainers and engines alike, and rules over absent metrics stay
        # silent).  Milli-unit gauges; min_slow keeps a sub-0.1%-MFU
        # baseline — calibration noise, not utilization — from "sagging".
        TrendRule("mfu_sag", "perf/mfu_milli",
                  direction="down", ratio=1.5, warmup=8, min_slow=1.0,
                  severity="warn", fire_after=2, resolve_after=2),
        TrendRule("roofline_drift", "perf/roofline_pct_milli",
                  direction="down", ratio=1.5, warmup=8, min_slow=1.0,
                  severity="warn", fire_after=2, resolve_after=2),
    ]
    train_sag = TrendRule(
        "train_throughput_sag" if scope == "all" else "throughput_sag",
        "train/seq_per_sec", direction="down", ratio=1.5, warmup=8,
        min_slow=1e-9, severity="warn", fire_after=2, resolve_after=2)
    if scope == "train":
        rules.append(train_sag)
        return rules
    if scope == "all":
        rules.append(train_sag)
        scope = "serving"
    if scope == "fleet":
        rules += [
            ThresholdRule("router_backlog", "router/queue_depth",
                          queue_depth_bound, op=">=", severity="warn",
                          fire_after=2, resolve_after=2),
            ThresholdRule("failover_storm", "router/failovers_total",
                          0.0, op=">", rate=True, severity="warn"),
        ]
    else:
        rules += [
            ThresholdRule("queue_backlog", "serving/queue_depth",
                          queue_depth_bound, op=">=", severity="warn",
                          fire_after=2, resolve_after=2),
            ThresholdRule("adapter_thrash", "tenancy/adapter_evictions_total",
                          adapter_evictions_per_eval, op=">", rate=True,
                          severity="warn"),
        ]
    rules += [
        ThresholdRule("kv_headroom", value_fn=_kv_headroom_frac,
                      bound=kv_headroom_frac, op="<", severity="warn",
                      fire_after=2, resolve_after=2),
        TrendRule("ttft_drift", value_fn=_HistWindowMean("serving/ttft_ms"),
                  direction="up", ratio=2.0, warmup=5, min_slow=1e-6,
                  severity="warn", fire_after=2, resolve_after=2),
        TrendRule("prefix_hit_collapse",
                  value_fn=_WindowRatio("kvcache/prefix_hits_total",
                                        "kvcache/prefix_misses_total"),
                  direction="down", ratio=2.0, warmup=5, min_slow=0.05,
                  severity="warn", fire_after=2, resolve_after=2),
        # accepted is a SUBSET of proposed, so this is a fraction of the
        # proposed delta — not a _WindowRatio over two disjoint counters
        TrendRule("spec_acceptance_collapse",
                  value_fn=_WindowFraction("serving/spec_accepted_total",
                                           "serving/spec_proposed_total"),
                  direction="down", ratio=1.5, warmup=5, min_slow=0.05,
                  severity="warn", fire_after=2, resolve_after=2),
        TrendRule("throughput_sag",
                  value_fn=_Rate("serving/tokens_total"
                                 if scope == "serving"
                                 else "router/dispatched_total"),
                  direction="down", ratio=2.0, warmup=8, min_slow=1e-9,
                  severity="warn", fire_after=3, resolve_after=2),
    ]
    for cls in classes:
        rules.append(BurnRateRule(
            f"slo_burn_fast_{cls}", priority=cls, objective=slo_objective,
            windows=fast_windows, factor=fast_factor, severity="page"))
        rules.append(BurnRateRule(
            f"slo_burn_slow_{cls}", priority=cls, objective=slo_objective,
            windows=slow_windows, factor=slow_factor, severity="warn",
            fire_after=2, resolve_after=2))
    return rules


# -- alert persistence -------------------------------------------------------

class AlertSink:
    """Append-only ``alerts.jsonl`` writer, shareable across monitors (a
    fleet's per-replica monitors and its fleet monitor stream to ONE
    file).  The file is created eagerly so a quiet run still leaves the
    artifact; every record is validated against the checked-in ``alert``
    schema before it is written."""

    def __init__(self, path: str):
        self.path = path
        parent = os.path.dirname(os.path.abspath(path))
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._f = open(path, "a")

    def write(self, record: dict) -> None:
        from neuronx_distributed_tpu_torch.obs.schemas import validate_record

        validate_record("alert", record)  # the emitter honors its schema
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


def read_alerts(path: str) -> List[dict]:
    """Parse an ``alerts.jsonl`` file (blank lines skipped)."""
    out: List[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


class _Active:
    """Per-(rule, key) live state: current firing flag, transition streak,
    and the firing-edge instant (for resolve-row durations)."""

    __slots__ = ("firing", "streak", "since", "severity", "window",
                 "observed", "bound")

    def __init__(self):
        self.firing = False
        self.streak = 0
        self.since: Optional[float] = None
        self.severity = "warn"
        self.window: Optional[str] = None
        self.observed: Optional[float] = None
        self.bound: Optional[float] = None


class HealthMonitor:
    """Evaluate ``rules`` over registry snapshots; stream alert edges.

    ``registry`` supplies the default snapshot (and receives the
    ``obs/alerts_*`` metrics); ``path`` opens an own :class:`AlertSink`,
    ``sink`` shares an existing one (a fleet's monitors share the file).
    ``clock`` must be the SAME clock as the system under watch (the
    engine/router's injectable clock) so alert edges share the spans' and
    stats' timescale; ``wall`` stamps the shared-epoch ``time`` field.
    ``eval_every`` thins the per-step cadence (:meth:`on_step` evaluates
    every N-th call); ``replica`` tags every row this monitor writes.

    External conditions (:meth:`set_condition`) ride the same edge
    machinery without a metric rule — the fleet router raises
    ``replica_down`` on failover and clears it on warm restart."""

    def __init__(self, rules: Optional[Sequence[Rule]] = None, *,
                 registry: Any = None, path: Optional[str] = None,
                 sink: Optional[AlertSink] = None,
                 clock: Callable[[], float] = time.monotonic,
                 wall: Callable[[], float] = time.time,
                 tracer: Any = None, replica: int = -1,
                 eval_every: int = 1, max_edges: int = 4096):
        if path is not None and sink is not None:
            raise ValueError("pass path= or sink=, not both")
        if eval_every < 1:
            raise ValueError(f"eval_every must be >= 1, got {eval_every}")
        self.rules = list(rules) if rules is not None else default_rules()
        names = [r.name for r in self.rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names: {sorted(names)}")
        self.sink = sink if sink is not None else (
            AlertSink(path) if path is not None else None)
        self._own_sink = sink is None and path is not None
        self.tracer = tracer
        self.replica = int(replica)
        self.eval_every = int(eval_every)
        self._clock = clock
        self._wall = wall
        self._tick = 0
        self.evaluations = 0
        self._active: Dict[Tuple[str, str], _Active] = {}
        # bounded edge history: benches/tests read firing evidence without
        # re-parsing the jsonl (oldest dropped first)
        self.edges: deque = deque(maxlen=max_edges)
        # per-class SLO event windows feeding the burn-rate rules
        self._events: Dict[str, deque] = {}
        self._retention_s = max(
            [w for r in self.rules if isinstance(r, BurnRateRule)
             for w in r.windows] or [3600.0])
        self.registry = None
        self.attach_registry(registry)

    def attach_registry(self, registry: Any) -> None:
        """Late-bind the monitor's registry (the engine/router attach
        path): the rules' default snapshot source plus the home of the
        ``obs/alerts_*`` pair, pre-declared so a quiet run still exports
        them.  No-op when a registry is already bound or None is given."""
        if self.registry is not None or registry is None:
            return
        self.registry = registry
        registry.gauge("obs/alerts_firing")
        registry.counter("obs/alerts_total")

    # -- event feed (burn-rate rules) --------------------------------------

    def note_request(self, good: bool, priority: str = "interactive",
                     now: Optional[float] = None) -> None:
        """One terminal request's SLO outcome (good = finished within its
        deadline) — the burn-rate rules' event stream."""
        now = self._clock() if now is None else now
        q = self._events.get(priority)
        if q is None:
            q = self._events[priority] = deque()
        q.append((now, bool(good)))
        self._prune(q, now)

    def note_output(self, out: Any, now: Optional[float] = None) -> None:
        """Derive the SLO outcome from a terminal ``RequestOutput``: good =
        FINISHED within its deadline (deadline-less requests are good when
        they finish — shed/failed/timed-out requests burn budget)."""
        good = (out.state == "finished"
                and (out.deadline_s is None
                     or out.total_ms <= out.deadline_s * 1e3))
        self.note_request(good, getattr(out, "priority", "interactive"), now)

    def _prune(self, q: deque, now: float) -> None:
        horizon = now - self._retention_s
        while q and q[0][0] < horizon:
            q.popleft()

    def _window_counts(self, priority: str, window_s: float,
                       now: float) -> Tuple[int, int]:
        q = self._events.get(priority)
        if not q:
            return 0, 0
        horizon = now - window_s
        good = bad = 0
        for t, ok in reversed(q):
            if t < horizon:
                break
            if ok:
                good += 1
            else:
                bad += 1
        return good, bad

    # -- evaluation --------------------------------------------------------

    def on_step(self, now: Optional[float] = None) -> List[dict]:
        """Per-step cadence hook: evaluates every ``eval_every``-th call
        (returns the edges emitted, [] on skipped ticks)."""
        self._tick += 1
        if self._tick % self.eval_every:
            return []
        return self.evaluate(now)

    def evaluate(self, now: Optional[float] = None,
                 snapshot: Optional[dict] = None) -> List[dict]:
        """Evaluate every rule once; returns the alert edges emitted."""
        global ALERTS_EVALUATED
        ALERTS_EVALUATED += 1
        self.evaluations += 1
        now = self._clock() if now is None else now
        if snapshot is None:
            snapshot = self.registry.snapshot() \
                if self.registry is not None else {}
        for q in self._events.values():
            self._prune(q, now)
        ctx = EvalContext(snapshot, now, self)
        emitted: List[dict] = []
        for rule in self.rules:
            res = rule.evaluate(ctx)
            st = self._active.setdefault((rule.name, ""), _Active())
            if res is None:
                st.streak = 0  # no observation: hold state, reset streaks
                continue
            st.observed, st.bound = res.observed, res.bound
            st.window = res.window
            st.severity = rule.severity
            if res.firing == st.firing:
                st.streak = 0
                continue
            st.streak += 1
            need = rule.fire_after if res.firing else rule.resolve_after
            if st.streak < need:
                continue
            edge = self._transition(rule.name, "", st, res.firing, now,
                                    severity=rule.severity,
                                    window=res.window,
                                    observed=res.observed, bound=res.bound,
                                    attrs=res.attrs)
            emitted.append(edge)
        self._export_gauges()
        return emitted

    def set_condition(self, rule: str, firing: bool, *, key: str = "",
                      severity: str = "page",
                      observed: Optional[float] = None,
                      bound: Optional[float] = None,
                      window: Optional[str] = None,
                      now: Optional[float] = None, **attrs) -> Optional[dict]:
        """Externally-driven alert (no metric rule): idempotent edge set/
        clear keyed by ``(rule, key)`` — e.g. ``replica_down`` keyed by
        replica id.  Returns the emitted edge record, or None when the
        state did not change."""
        if severity not in SEVERITIES:
            raise ValueError(f"severity must be one of {SEVERITIES}, "
                             f"got {severity!r}")
        now = self._clock() if now is None else now
        st = self._active.setdefault((rule, key), _Active())
        if st.firing == bool(firing):
            return None
        st.severity = severity
        st.observed, st.bound, st.window = observed, bound, window
        if key:
            attrs = {"key": key, **attrs}
        edge = self._transition(rule, key, st, bool(firing), now,
                                severity=severity, window=window,
                                observed=observed, bound=bound, attrs=attrs)
        self._export_gauges()
        return edge

    def _transition(self, rule: str, key: str, st: _Active, firing: bool,
                    now: float, *, severity: str, window: Optional[str],
                    observed: Optional[float], bound: Optional[float],
                    attrs: dict) -> dict:
        st.firing = firing
        st.streak = 0
        record = {
            "schema": ALERT_SCHEMA,
            "time": self._wall(),
            "mono": now,
            "rule": rule,
            "severity": severity,
            "state": "firing" if firing else "resolved",
            "window": window,
            "observed": (float(observed) if observed is not None
                         and math.isfinite(observed) else None),
            "bound": (float(bound) if bound is not None
                      and math.isfinite(bound) else None),
            "replica": self.replica,
            **attrs,
        }
        if firing:
            st.since = now
            if self.registry is not None:
                self.registry.counter("obs/alerts_total").inc()
        elif st.since is not None:
            record["duration_s"] = round(max(now - st.since, 0.0), 6)
            st.since = None
        self.edges.append(record)
        if self.sink is not None:
            self.sink.write(record)
        if self.tracer is not None:
            # alerts land in request waterfalls: a batch-level instant on
            # the same monotonic timescale as the engine's spans
            self.tracer.instant("alert", t=now, rule=rule,
                                severity=severity, state=record["state"],
                                observed=record["observed"],
                                bound=record["bound"])
        log = (logger.warning if severity == "page" or firing
               else logger.info)
        log("health: alert %r %s (severity %s, observed %s vs bound %s%s)",
            rule, record["state"], severity, record["observed"],
            record["bound"], f", window {window}" if window else "")
        return record

    def _export_gauges(self) -> None:
        if self.registry is not None:
            self.registry.gauge("obs/alerts_firing").set(
                float(sum(1 for st in self._active.values() if st.firing)))

    # -- views -------------------------------------------------------------

    def firing(self) -> List[dict]:
        """Currently-firing alerts, worst first."""
        out = []
        for (rule, key), st in self._active.items():
            if not st.firing:
                continue
            out.append({"rule": rule, "key": key, "severity": st.severity,
                        "window": st.window, "observed": st.observed,
                        "bound": st.bound, "since": st.since})
        out.sort(key=lambda a: -_SEV_ORDER.get(a["severity"], 0))
        return out

    def worst_severity(self) -> Optional[str]:
        return worst_severity([a["severity"] for a in self.firing()])

    def healthz(self) -> dict:
        """Readiness document for ``/healthz`` (:func:`healthz_doc`)."""
        return healthz_doc(self.firing())

    def page_edges(self) -> int:
        """Firing edges at ``page`` severity seen so far (bench gating)."""
        return sum(1 for e in self.edges
                   if e["state"] == "firing" and e["severity"] == "page")

    def close(self) -> None:
        if self.sink is not None and self._own_sink:
            self.sink.close()
