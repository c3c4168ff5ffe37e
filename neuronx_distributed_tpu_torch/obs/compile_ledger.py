"""Compile ledger: every compile the framework triggers, accounted
(counterpart of ``neuronx_distributed_tpu/obs/compile_ledger.py``).

In the port a compile is a :class:`~..trace.engine.PhaseGraphs` capture:
the key's first call, run eagerly, plus ``torch.cuda.graph`` over it.  A
cold capture looks like a stall, and a capture on the serving hot path is
a silent stall that poisons every latency percentile near it.
:class:`CompileLedger` is the one accounting surface:

- **every capture reports here**: one ``compile`` row of kind
  ``"cuda_graph"`` per capture, its family the phase name
  (``decode_pages``, ``verify_pages``, ``decode_slots``...), its wall ms,
  and the :func:`~..utils.profiling.cost_report` of that eager first call
  (flops, compulsory bytes), which is off the steady path anyway.  On the
  CPU, where nothing is captured, a model with a ledger books each key's
  first call as kind ``"eager"``, so the ledger sees the same keys;
- **cache events join the program events**: replays are cache hits, and
  the phase-graph LRU's pops are ``eviction`` rows carrying the evicted
  ``(family, key)``, so thrash is attributable;
- **recompilation pathologies are detected, not grepped for**: a family
  whose distinct keys exceed its cache capacity raises a ``thrash``
  warning, and ANY compile recorded after :meth:`declare_warmup_done` is a
  ``compile_storm``: counted (``trace/compile_storms_total``), surfaced in
  the flight recorder's warnings, and traced as a ``compile`` span so the
  stall shows up in request waterfalls.

Rows stream to a schema-checked ``compile_ledger.jsonl``
(``obs.schemas`` kind ``compile_ledger``); ``trace/compile_ms`` /
``trace/compiles_total`` / ``trace/compiled_cache_*_total`` ride the
metric registry.  Ledger-off is allocation-free by construction: every
interception site guards on ``compile_ledger is not None`` (the
module-level :data:`LEDGER_ROWS` counter is the test hook, like
``obs.tracing.SPANS_CREATED``).
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterable, List, Optional

from neuronx_distributed_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

COMPILE_LEDGER_FILE = "compile_ledger.jsonl"
COMPILE_LEDGER_SCHEMA = "compile_ledger/1"

# compile wall-time histogram boundaries (ms): compiles span several
# orders of magnitude, a small graph's capture to a cold kernel build
COMPILE_MS_BUCKETS = (
    1.0, 5.0, 10.0, 50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0,
    10000.0, 30000.0, 60000.0, 300000.0, 900000.0, 1800000.0,
)

# module-level row counter: the ledger-off overhead test reads it around a
# full serving run and asserts it never moved — zero rows are ever built
# with no ledger attached (the obs.tracing.SPANS_CREATED discipline)
LEDGER_ROWS = 0

# cost_report / memory_analysis keys copied onto a compile row when the
# capture site measured them
_COST_KEYS = ("flops", "bytes_accessed", "argument_size_in_bytes",
              "output_size_in_bytes", "temp_size_in_bytes")


def jit_cache_size(fn: Any) -> Optional[int]:
    """Always None.  The JAX version reads a jitted function's cache size,
    whose growth between polls is a silent retrace inside jit dispatch.
    The port jits no module function: every program it compiles is a
    phase-graph capture, which reports here itself, so there is nothing to
    poll (and the engine's poll of module jits has nothing to read)."""
    return None


class CompileLedger:
    """The run's compile accounting: program rows + cache events + pathology
    detection.

    ``path`` streams every row to a ``compile_ledger.jsonl`` as it is
    recorded (append — the artifact survives a crash mid-run).
    ``registry`` receives the ``trace/compile*`` counters and the
    ``trace/compile_ms`` histogram; ``tracer`` receives a ``compile`` span
    per post-warmup compile (storms show up in request waterfalls);
    ``flight`` (a :class:`~.flight.FlightRecorder`) receives storm/thrash
    warnings next to the step anomalies; ``memory_ledger`` receives each
    measured program's temp/output bytes (its ``workspace`` subsystem).
    All optional, attachable late via :meth:`attach`."""

    def __init__(self, path: Optional[str] = None, registry: Any = None,
                 tracer: Any = None, flight: Any = None,
                 memory_ledger: Any = None, wall=time.time,
                 clock=time.monotonic):
        self.path = path
        self.registry = registry
        self.tracer = tracer
        self.flight = flight
        self.memory_ledger = memory_ledger
        self._wall = wall
        self._clock = clock
        self.rows: List[dict] = []
        self.warnings: List[dict] = []
        self.warmup_done = False
        self._rewarm: Optional[str] = None
        self._lock = threading.Lock()
        # family -> {"keys": set, "capacity": int|None, "compiles": int,
        #            "evictions": int, "cold_ms": float, "thrashed": bool}
        self._fams: Dict[str, dict] = {}
        self.cache_hits = 0
        self.cache_misses = 0
        self.cache_evictions = 0
        self._declare(registry)

    # -- wiring ------------------------------------------------------------

    @staticmethod
    def _declare(registry: Any) -> None:
        """Pre-declare the counters the ledger feeds, at 0.  A rate rule
        (``compile_storm`` over ``trace/compile_storms_total``) sees no
        delta the first time it sees a metric, so a counter the first storm
        created would hide that storm from the health monitor."""
        if registry is None:
            return
        for name in ("compiles", "compile_storms", "compile_thrash",
                     "compiled_cache_hits", "compiled_cache_misses",
                     "compiled_cache_evictions"):
            registry.counter(f"trace/{name}_total")

    def attach(self, registry: Any = None, tracer: Any = None,
               flight: Any = None, memory_ledger: Any = None) -> None:
        """Fill in sinks that were not known at construction (an engine
        attaches its registry/tracer to a caller-provided ledger).  Only
        empty slots are filled — explicit construction wins."""
        if self.registry is None:
            self.registry = registry
            self._declare(registry)
        if self.tracer is None:
            self.tracer = tracer
        if self.flight is None:
            self.flight = flight
        if self.memory_ledger is None:
            self.memory_ledger = memory_ledger

    def set_capacity(self, family: str, capacity: int) -> None:
        """Declare a family's compiled-cache capacity — the thrash
        threshold (distinct keys beyond it are cycling the LRU)."""
        self._fam(family)["capacity"] = int(capacity)

    def _fam(self, family: str) -> dict:
        f = self._fams.get(family)
        if f is None:
            f = {"keys": set(), "capacity": None, "compiles": 0,
                 "evictions": 0, "cold_ms": 0.0, "thrashed": False,
                 "hits": 0}
            self._fams[family] = f
        return f

    def family_hits(self, family: str) -> int:
        """Steady-state cache hits recorded for one program family — the
        call-count cross-check the perf-attribution join reads (one hit ==
        one compiled execution that paid no compile)."""
        f = self._fams.get(family)
        return 0 if f is None else f["hits"]

    # -- recording ---------------------------------------------------------

    def _row(self, event: str, family: str, key: Any, kind: str,
             wall_ms: Optional[float], **extra) -> dict:
        global LEDGER_ROWS
        LEDGER_ROWS += 1
        row = {
            "schema": COMPILE_LEDGER_SCHEMA,
            "time": self._wall(),
            "mono": self._clock(),
            "event": event,
            "family": str(family),
            "key": repr(key),
            "kind": kind,
            "wall_ms": (None if wall_ms is None
                        else round(float(wall_ms), 3)),
            "after_warmup": bool(self.warmup_done),
        }
        row.update(extra)
        with self._lock:
            self.rows.append(row)
        if self.path is not None:
            try:
                parent = os.path.dirname(os.path.abspath(self.path))
                if parent:
                    os.makedirs(parent, exist_ok=True)
                with open(self.path, "a") as f:
                    f.write(json.dumps(row) + "\n")
            except OSError as e:  # telemetry IO must never kill the run
                logger.warning("compile ledger: append failed: %s", e)
        return row

    def record_compile(self, family: str, key: Any,
                       wall_ms: Optional[float], kind: str = "cuda_graph",
                       cost: Optional[dict] = None, **extra) -> dict:
        """One program compiled: ``family`` is the program family (the
        phase name of a capture, ``train_step``...), ``key`` the shape and
        state key within it, ``wall_ms`` the measured wall time (None when
        only the event is known), ``kind`` ``"cuda_graph"`` for a capture
        and ``"eager"`` for a first call that captured nothing (the CPU).
        ``cost`` (a :func:`~..utils.profiling.cost_report` dict, possibly
        with :func:`~..utils.profiling.memory_analysis` keys) adds the
        program's flops, bytes and memory to the row."""
        if cost is not None:
            for k in _COST_KEYS:
                if k in cost and k not in extra:
                    extra[k] = cost[k]
            if self.memory_ledger is not None:
                self.memory_ledger.note_program(str(family), extra)
        fam = self._fam(family)
        fam["compiles"] += 1
        fam["keys"].add(repr(key))
        if wall_ms is not None:
            fam["cold_ms"] += float(wall_ms)
        if self._rewarm is not None:
            extra["rewarm"] = self._rewarm
        if self.warmup_done:
            extra["storm"] = True  # stamped BEFORE the row streams to disk
        row = self._row("compile", family, key, kind, wall_ms, **extra)
        reg = self.registry
        if reg is not None:
            reg.counter("trace/compiles_total").inc()
            if wall_ms is not None:
                reg.histogram("trace/compile_ms",
                              COMPILE_MS_BUCKETS).observe(float(wall_ms))
        if self.warmup_done:
            self._storm(row)
        self._check_thrash(family)
        return row

    def _storm(self, row: dict) -> None:
        """A compile after warmup was declared done: the serving latency
        pathology.  Counted, flight-warned, and traced as a ``compile``
        span covering the stall's wall-time."""
        wall = (f"{row['wall_ms']} ms"
                if row["wall_ms"] is not None else "an unknown wall time")
        msg = (f"compile_storm: {row['family']} key {row['key']} compiled "
               f"{wall} after warmup was declared done")
        warning = {"step": -1, "detector": "compile_storm", "message": msg,
                   "time": row["time"]}
        self.warnings.append(warning)
        logger.warning("compile ledger: %s", msg)
        if self.registry is not None:
            self.registry.counter("trace/compile_storms_total").inc()
        if self.flight is not None:
            self.flight.warnings.append(warning)
        tr = self.tracer
        if tr is not None:
            s = tr.begin("compile", family=row["family"], key=row["key"],
                         wall_ms=row["wall_ms"], storm=True)
            if row["wall_ms"]:
                # the compile just FINISHED: the span covers the stall that
                # already happened, not the instant it was noticed
                s.t_start -= row["wall_ms"] / 1e3
            tr.end(s)

    def _check_thrash(self, family: str) -> None:
        fam = self._fam(family)
        cap = fam["capacity"]
        if cap is None or fam["thrashed"] or len(fam["keys"]) <= cap:
            return
        fam["thrashed"] = True
        msg = (f"compile thrash: family {family!r} has seen "
               f"{len(fam['keys'])} distinct program keys but its compiled "
               f"cache holds {cap} — near-identical programs are cycling "
               "the LRU (every eviction is a future recompile)")
        warning = {"step": -1, "detector": "compile_thrash", "message": msg,
                   "time": self._wall()}
        self.warnings.append(warning)
        logger.warning("compile ledger: %s", msg)
        self._row("thrash", family, sorted(fam["keys"]), "event", None,
                  capacity=cap, distinct_keys=len(fam["keys"]))
        if self.registry is not None:
            self.registry.counter("trace/compile_thrash_total").inc()
        if self.flight is not None:
            self.flight.warnings.append(warning)

    @contextmanager
    def timed(self, family: str, key: Any, kind: str = "cuda_graph"):
        """Time a compile site: ``with ledger.timed("decode_pages", key) as
        rec: rec["cost"] = cost_report(...)`` -- the row is recorded on exit
        with the measured wall time (and the cost when the body stored one
        under ``"cost"``)."""
        holder: Dict[str, Any] = {}
        t0 = time.perf_counter()
        yield holder
        wall_ms = (time.perf_counter() - t0) * 1e3
        self.record_compile(family, key, wall_ms, kind=kind,
                            cost=holder.get("cost"))

    # -- cache events ------------------------------------------------------

    def cache_hit(self, family: str) -> None:
        self.cache_hits += 1
        self._fam(family)["hits"] += 1
        if self.registry is not None:
            self.registry.counter("trace/compiled_cache_hits_total").inc()

    def cache_miss(self, family: str) -> None:
        self.cache_misses += 1
        if self.registry is not None:
            self.registry.counter("trace/compiled_cache_misses_total").inc()

    def record_eviction(self, family: str, evicted_key: Any,
                        capacity: Optional[int] = None) -> dict:
        """An LRU dropped a compiled program — the evicted ``(family,
        key)`` is the row, so thrash is attributable to the programs
        actually cycling (the eviction log used to drop the key)."""
        self.cache_evictions += 1
        fam = self._fam(family)
        fam["evictions"] += 1
        if capacity is not None:
            fam["capacity"] = int(capacity)
        row = self._row("eviction", family, evicted_key, "event", None,
                        capacity=fam["capacity"])
        self._check_thrash(family)
        return row

    # -- warmup / storms ---------------------------------------------------

    def declare_warmup_done(self, label: str = "warmup") -> None:
        """Everything is compiled now — any compile after this is a
        ``compile_storm``.  Idempotent."""
        if self.warmup_done:
            return
        self._row("warmup_done", label, None, "event", None)
        self.warmup_done = True

    @contextmanager
    def rewarm(self, label: str):
        """Book the compiles inside as warm-up, not storms, after
        :meth:`declare_warmup_done`: a new weight generation's captures
        made inside a swap, or a rebuilt replica's captures of its
        predecessor's phases, which the JAX engine reuses compiled.  Their
        rows carry ``"rewarm": label`` and ``after_warmup`` False."""
        prev, prev_label = self.warmup_done, self._rewarm
        self.warmup_done, self._rewarm = False, str(label)
        try:
            yield
        finally:
            self.warmup_done, self._rewarm = prev, prev_label

    # -- queries -----------------------------------------------------------

    def compile_count(self, after_warmup_only: bool = False) -> int:
        with self._lock:
            return sum(1 for r in self.rows if r["event"] == "compile"
                       and (r["after_warmup"] or not after_warmup_only))

    @property
    def storms(self) -> int:
        return self.compile_count(after_warmup_only=True)

    def mark(self) -> int:
        """Row-count bookmark; pair with :meth:`compiles_since` to count
        the compiles inside a measurement window."""
        with self._lock:
            return len(self.rows)

    def compiles_since(self, mark: int) -> int:
        with self._lock:
            return sum(1 for r in self.rows[mark:] if r["event"] == "compile")

    def summary(self) -> dict:
        """The report-facing rollup (also what ``obs_report --compare``
        diffs between runs)."""
        with self._lock:
            rows = list(self.rows)
        return summarize_compile_records(rows, cache={
            "hits": self.cache_hits, "misses": self.cache_misses,
            "evictions": self.cache_evictions})

    def dump(self, path: Optional[str] = None) -> Optional[str]:
        """Write every row as one self-contained JSONL snapshot (streaming
        appends already keep :attr:`path` current; this is for exporting to
        a different location)."""
        path = path or self.path
        if path is None:
            return None
        parent = os.path.dirname(os.path.abspath(path))
        if parent:
            os.makedirs(parent, exist_ok=True)
        with self._lock:
            rows = list(self.rows)
        with open(path, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
        return path


def read_compile_ledger(path: str) -> List[dict]:
    """Parse a ``compile_ledger.jsonl`` (blank lines skipped)."""
    out: List[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def summarize_compile_records(records: Iterable[dict],
                              cache: Optional[dict] = None) -> dict:
    """Rollup of ledger rows: totals, per-family breakdown, pathology
    counts — the "compile" health section of the obs report, computable
    from the artifact alone."""
    compiles = aot = 0
    cold_ms = 0.0
    cold_max = 0.0
    storms = thrash = evictions = 0
    fams: Dict[str, dict] = {}
    for r in records:
        ev = r.get("event")
        fam = fams.setdefault(r.get("family", "?"), {
            "compiles": 0, "cold_ms": 0.0, "keys": set(), "evictions": 0})
        if ev == "compile":
            compiles += 1
            fam["compiles"] += 1
            fam["keys"].add(r.get("key"))
            if r.get("kind") == "aot":
                aot += 1  # JAX ahead-of-time rows (the port has none)
            w = r.get("wall_ms")
            if w is not None:
                cold_ms += float(w)
                cold_max = max(cold_max, float(w))
                fam["cold_ms"] += float(w)
            if r.get("after_warmup"):
                storms += 1
        elif ev == "eviction":
            evictions += 1
            fam["evictions"] += 1
        elif ev == "thrash":
            thrash += 1
    out = {
        "compiles": compiles,
        "aot": aot,
        "jit": compiles - aot,
        "cold_ms_total": round(cold_ms, 3),
        "cold_ms_max": round(cold_max, 3),
        "storms": storms,
        "thrash_warnings": thrash,
        "evictions": evictions,
        "families": {
            name: {"compiles": f["compiles"],
                   "cold_ms": round(f["cold_ms"], 3),
                   "distinct_keys": len(f["keys"]),
                   "evictions": f["evictions"]}
            for name, f in sorted(fams.items()) if f["compiles"]
            or f["evictions"]},
    }
    if cache is not None:
        hits, misses = cache.get("hits", 0), cache.get("misses", 0)
        out["cache"] = {
            **cache,
            "hit_rate": (round(hits / (hits + misses), 4)
                         if hits + misses else None),
        }
    return out
