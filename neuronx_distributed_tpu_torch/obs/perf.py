"""Per-phase performance attribution: roofline, device-time accounting, MFU
(counterpart of ``neuronx_distributed_tpu/obs/perf.py``).

Request traces say ``decode_step`` took 9.8 ms; the compile ledger says the
captured program moves N bytes and F flops.  :class:`PerfAttribution` is
the join: per phase family (``prefill`` / ``prefill_chunk`` /
``decode_step`` / ``spec_round`` / ``train_step``) it accounts wall time
and call counts on the hot path, takes per-call flops/bytes from the
compile ledger's cost extras (:func:`~..utils.profiling.cost_report` of
each capture's eager first call), and classifies each family against a
:class:`DeviceSpec` roofline -- achieved FLOP/s, achieved bytes/s,
arithmetic intensity, compute- vs memory-bound, percent-of-roofline --
plus an MFU/MBU rollup for training and a tokens/s-ceiling rollup for
serving.  The port's bytes are the compulsory traffic (a lower bound), so
a family's share of the roofline reads at most 1.0.

Allocation discipline mirrors ``SPANS_CREATED`` / ``LEDGER_ROWS``: the
module-level :data:`PERF_RECORDS` counter increments on every per-family
accumulator and attribution record this module allocates, every call site
guards on ``perf is not None``, and the zero-allocation-when-off test
asserts the counter never moves over a full run with ``perf=False``.

The device table holds the cards the port has published peaks for,
matched by ``torch.cuda.get_device_name().lower()``; an unknown CUDA card
raises (pass a :class:`DeviceSpec`) instead of classifying against wrong
peaks.  On the CPU the spec is calibrated once per process from a fixed
micro-workload and cached, so every record in a test run classifies
against the same numbers: a cost model for the tests, not a claim about
the host.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

PERF_ATTRIBUTION_FILE = "perf_attribution.jsonl"
PERF_ATTRIBUTION_SCHEMA = "perf_attribution/1"

# phase-fn families the serving engine + trainer account device time for
PERF_FAMILIES = ("prefill", "prefill_chunk", "decode_step", "spec_round",
                 "train_step")

# compiled-program family -> phase family: the ledger books costs per
# PROGRAM while device time is accounted per PHASE -- this map is the join
# (the JAX package's table; the port's programs are its phase-graph
# captures, ``decode_pages``/``decode_pages_lora``/``decode_slots`` and
# ``verify_pages``, and PhaseGraphs feeds executions via
# note_program_call).  A phase's flops are the sum over its programs of
# per-call cost x executions.
PHASE_PROGRAMS: Dict[str, Tuple[str, ...]] = {
    "prefill": ("prefill_one", "prefill_one_lora", "insert_slot",
                "insert_valid", "write_page", "copy_page",
                "write_adapter_page"),
    "prefill_chunk": ("prefill_chunk_pages",),
    "decode_step": ("decode_slots", "decode_pages", "decode_pages_lora",
                    "jit:sample_rows", "jit:pack_tokens"),
    "spec_round": ("verify_pages",),
    "train_step": ("train_step",),
}
_PROGRAM_PHASE: Dict[str, str] = {
    prog: phase for phase, progs in PHASE_PROGRAMS.items() for prog in progs
}

# every per-family accumulator / attribution record allocated by this
# module bumps this counter — tests assert it stays flat with perf off
# (the SPANS_CREATED / LEDGER_ROWS discipline)
PERF_RECORDS = 0

# ms-scale histogram boundaries (mirrors obs.MS_BUCKETS; duplicated here
# because the obs package imports this module at init time)
_MS_BUCKETS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
               1000.0, 2500.0, 5000.0, 10000.0, 30000.0)


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """Peak compute + memory bandwidth for one device kind -- the two
    numbers a roofline needs.  ``kind`` is the lowercase device name
    (``torch.cuda.get_device_name(...).lower()``)."""

    kind: str
    peak_flops: float
    hbm_bytes_per_s: float


# Published dense bf16 peak FLOP/s + memory bandwidth per card (NVIDIA's
# data sheet, at the full power limit).  The H100's PCIe and NVL forms
# have other peaks and other names, so they match no row.
DEVICE_SPECS: Tuple[DeviceSpec, ...] = (
    DeviceSpec("nvidia h100 80gb hbm3", 989e12, 3.35e12),   # H100 SXM
)

_CPU_SPEC: Optional[DeviceSpec] = None


def calibrate_cpu_spec() -> DeviceSpec:
    """Calibrate-on-first-use CPU spec: one fixed matmul + one fixed copy,
    measured once per process and cached, so every classification in a
    run (and every test) sees the same numbers.  The result is a cost
    MODEL for the test mesh, not a claim about the host."""
    global _CPU_SPEC
    if _CPU_SPEC is not None:
        return _CPU_SPEC
    import numpy as np

    n = 256
    a = np.ones((n, n), np.float32)
    b = np.ones((n, n), np.float32)
    a @ b  # warm BLAS dispatch
    peak = 0.0
    for _ in range(3):
        t0 = time.perf_counter()
        a @ b
        peak = max(peak, 2.0 * n ** 3 / max(time.perf_counter() - t0, 1e-9))
    src = np.ones(4 << 20, np.uint8)
    dst = np.empty_like(src)
    np.copyto(dst, src)  # warm
    bw = 0.0
    for _ in range(3):
        t0 = time.perf_counter()
        np.copyto(dst, src)
        # read + write of the buffer per copy
        bw = max(bw, 2.0 * src.nbytes / max(time.perf_counter() - t0, 1e-9))
    _CPU_SPEC = DeviceSpec("cpu", max(peak, 1e9), max(bw, 1e9))
    return _CPU_SPEC


def device_spec(device: Any = None) -> DeviceSpec:
    """Resolve the :class:`DeviceSpec` for ``device`` (a ``torch.device``
    or its string; default: the current CUDA device when there is one,
    else the CPU).  A CUDA card is matched by its lowercase name against
    :data:`DEVICE_SPECS` (the longest matching name wins); an unknown card
    raises ``ValueError`` naming it.  The CPU takes
    :func:`calibrate_cpu_spec`."""
    import torch

    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else torch.device("cpu"))
    device = torch.device(device)
    if device.type != "cuda":
        return calibrate_cpu_spec()
    kind = torch.cuda.get_device_name(device).lower()
    for spec in sorted(DEVICE_SPECS, key=lambda s: -len(s.kind)):
        if kind == spec.kind or kind.startswith(spec.kind + " "):
            return spec
    raise ValueError(
        f"no published peaks for the device {kind!r} (known: "
        f"{[s.kind for s in DEVICE_SPECS]}): pass spec=DeviceSpec(...)")


def roofline_attribution(
    family: str,
    calls: float,
    device_ms: float,
    flops: float,
    bytes_accessed: float,
    spec: DeviceSpec,
    *,
    now: Optional[float] = None,
    mono: Optional[float] = None,
) -> dict:
    """One attribution record from TOTAL flops/bytes over ``calls``
    executions taking ``device_ms`` of device wall-time.

    ``pct_roofline`` is ``lower_bound / achieved`` — 1.0 means the family
    runs at the roofline, 0.1 means 10x off it; ``bound`` is which wall
    it would hit first.  ``mfu`` / ``mbu`` are the achieved fractions of
    peak compute / bandwidth."""
    wall_s = max(device_ms, 0.0) / 1e3
    t_compute = flops / spec.peak_flops if spec.peak_flops else 0.0
    t_memory = (bytes_accessed / spec.hbm_bytes_per_s
                if spec.hbm_bytes_per_s else 0.0)
    lower = max(t_compute, t_memory)
    safe_wall = max(wall_s, 1e-12)
    rec = {
        "schema": PERF_ATTRIBUTION_SCHEMA,
        "family": family,
        "calls": float(calls),
        "device_ms": round(device_ms, 4),
        "flops": float(flops),
        "bytes": float(bytes_accessed),
        "flops_per_s": flops / safe_wall if wall_s > 0 else 0.0,
        "bytes_per_s": bytes_accessed / safe_wall if wall_s > 0 else 0.0,
        "arithmetic_intensity": (flops / bytes_accessed
                                 if bytes_accessed else None),
        "bound": "compute" if t_compute >= t_memory else "memory",
        "lower_bound_ms": lower * 1e3,
        "pct_roofline": (lower / safe_wall) if wall_s > 0 else 0.0,
        "mfu": (flops / safe_wall / spec.peak_flops)
        if wall_s > 0 and spec.peak_flops else 0.0,
        "mbu": (bytes_accessed / safe_wall / spec.hbm_bytes_per_s)
        if wall_s > 0 and spec.hbm_bytes_per_s else 0.0,
        "device": spec.kind,
        "peak_flops": spec.peak_flops,
        "hbm_bytes_per_s": spec.hbm_bytes_per_s,
        "time": time.time() if now is None else now,
        "mono": time.monotonic() if mono is None else mono,
    }
    return rec


def attribute(
    family: str,
    calls: float,
    device_ms: float,
    flops_per_call: float,
    bytes_per_call: float,
    spec: DeviceSpec,
    **kw,
) -> dict:
    """Per-call-cost convenience wrapper over
    :func:`roofline_attribution`."""
    return roofline_attribution(
        family, calls, device_ms, calls * flops_per_call,
        calls * bytes_per_call, spec, **kw)


class PerfAttribution:
    """The live accounting object ``fit()`` and the serving engine drive.

    Hot-path API (allocation-free after the first call per family):

    - :meth:`note_phase` — device wall-time + call count per family,
      stamped with the SAME clock deltas as the tracer's spans so the
      attribution sums to the traced wall-time;
    - :meth:`note_tokens` — committed tokens (serving ceiling rollup).

    Join API (warm path / read side):

    - :meth:`note_cost` — explicit per-call flops/bytes for a family;
    - :meth:`ingest_ledger` — per-call costs from a
      :class:`~.compile_ledger.CompileLedger`'s cost extras;
    - :meth:`ingest_spans` — device time from finished tracer spans
      (offline attribution of a trace another process recorded);
    - :meth:`attribution` / :meth:`rollup` / :meth:`dump` — the records.
    """

    def __init__(
        self,
        path: Optional[str] = None,
        registry: Any = None,
        spec: Optional[DeviceSpec] = None,
        device: Any = None,
        ledger: Any = None,
        clock=time.monotonic,
    ):
        self.path = path
        self.registry = registry
        self.spec = spec if spec is not None else device_spec(device)
        self._ledger = ledger
        self._clock = clock
        # family -> [calls, device_ms]
        self._fams: Dict[str, List[float]] = {}
        # family -> (flops_per_call, bytes_per_call) from note_cost; an
        # explicit per-call cost wins over the ledger join for that family
        self._costs: Dict[str, Tuple[float, float]] = {}
        # compiled-program family -> executions.  PhaseGraphs feeds this on
        # every replay and first call while perf is attached;
        # mark_warmup_done() snapshots a baseline so warm-pass executions
        # stay out of the measured attribution.
        self._prog_calls: Dict[str, float] = {}
        self._prog_base: Dict[str, float] = {}
        # phase family -> (total flops, total bytes): rebuilt by
        # ingest_ledger as sum over the phase's programs of
        # per-call cost (mean across compile rows) x executions
        self._ledger_totals: Dict[str, Tuple[float, float]] = {}
        self._tokens = 0.0

    def attach(self, registry: Any = None, ledger: Any = None) -> None:
        """Fill in sinks not known at construction (an engine attaches its
        registry / compile ledger to a caller-provided layer).  Only empty
        slots are filled — explicit construction wins (the
        :meth:`CompileLedger.attach <..compile_ledger.CompileLedger.attach>`
        convention)."""
        if self.registry is None:
            self.registry = registry
        if self._ledger is None:
            self._ledger = ledger

    # -- hot path ----------------------------------------------------------

    def note_phase(self, family: str, device_ms: float,
                   calls: float = 1.0) -> None:
        """Account ``device_ms`` of device wall-time (and ``calls``
        executions) to ``family``.  Call sites pass the same clock deltas
        they stamp tracer spans with, so per-family sums match the trace."""
        global PERF_RECORDS
        acc = self._fams.get(family)
        if acc is None:
            PERF_RECORDS += 1
            acc = self._fams[family] = [0.0, 0.0]
        acc[0] += calls
        acc[1] += device_ms
        if self.registry is not None:
            self.registry.histogram(
                f"perf/{family}_device_ms", _MS_BUCKETS).observe(device_ms)

    def note_tokens(self, n: float) -> None:
        """Account ``n`` committed tokens (serving tokens/s ceiling)."""
        self._tokens += n

    def note_program_call(self, program: str) -> None:
        """Count one execution of a compiled program family.
        :class:`~..trace.engine.PhaseGraphs` calls this on every replay and
        first call, so executions = hits + compiles without touching the
        ledger."""
        global PERF_RECORDS
        if program not in self._prog_calls:
            PERF_RECORDS += 1
            self._prog_calls[program] = 0.0
        self._prog_calls[program] += 1.0

    def mark_warmup_done(self) -> None:
        """Start the measured window: program executions before this point
        (the warm pass's captures and calls) are excluded from the cost
        join, and the phase accounting (time, calls, tokens) restarts, so
        both sides of the join cover the same window (the JAX version keeps
        the warm pass's phase time, which a first step's capture
        inflates)."""
        self._prog_base = dict(self._prog_calls)
        self._fams.clear()
        self._tokens = 0.0

    # -- cost join ---------------------------------------------------------

    def note_cost(self, family: str, flops: float,
                  bytes_accessed: float) -> None:
        """Explicit per-call cost for a family (e.g. the trainer's
        model-flops accounting when no compiled cost report exists)."""
        self._costs[family] = (float(flops), float(bytes_accessed))

    def ingest_ledger(self, ledger: Any = None) -> int:
        """Join compile-ledger cost extras onto phase families.  Ledger
        rows carry costs per compiled PROGRAM (``prefill_one``,
        ``write_page``, ...); a phase executes several programs, so per
        phase the total is the sum over its programs of per-call cost
        (mean across that program's compile rows — keys differ by shape)
        times executions counted by :meth:`note_program_call`.  Rebuilt
        from scratch on every call (counters keep moving between calls).
        Returns the number of phase families holding a ledger total."""
        ledger = ledger if ledger is not None else self._ledger
        if ledger is None:
            return 0
        rows = getattr(ledger, "rows", None) or []
        sums: Dict[str, List[float]] = {}
        for row in rows:
            if row.get("event") != "compile":
                continue
            fl = row.get("flops")
            by = row.get("bytes_accessed")
            if fl is None and by is None:
                continue
            s = sums.setdefault(row["family"], [0.0, 0.0, 0.0])
            s[0] += float(fl or 0.0)
            s[1] += float(by or 0.0)
            s[2] += 1.0
        totals: Dict[str, List[float]] = {}
        for prog, (fl, by, n) in sums.items():
            phase = _PROGRAM_PHASE.get(prog)
            if phase is None or phase in self._costs:
                continue
            calls = (self._prog_calls.get(prog, 0.0)
                     - self._prog_base.get(prog, 0.0))
            if calls <= 0.0 and prog == phase and phase in self._fams:
                # program == phase 1:1 (train_step) runs outside any
                # phase-graph cache: every accounted phase call executed it
                calls = self._fams[phase][0]
            if calls <= 0.0:
                continue
            t = totals.setdefault(phase, [0.0, 0.0])
            t[0] += (fl / n) * calls
            t[1] += (by / n) * calls
        self._ledger_totals = {k: (v[0], v[1]) for k, v in totals.items()}
        return len(self._ledger_totals)

    def ingest_spans(self, spans: Iterable[Any],
                     families: Tuple[str, ...] = PERF_FAMILIES) -> int:
        """Offline accounting: fold finished tracer spans (Span objects or
        ``trace_event`` records) whose name is a known family into the
        per-family device time.  Returns the span count ingested."""
        n = 0
        for s in spans:
            if isinstance(s, dict):
                name = s.get("name")
                dur = (s.get("t_end", 0.0) - s.get("t_start", 0.0)) * 1e3
            else:
                name = getattr(s, "name", None)
                dur = getattr(s, "duration_ms", 0.0)
            if name in families:
                self.note_phase(name, dur)
                n += 1
        return n

    # -- read side ---------------------------------------------------------

    def attribution(self) -> List[dict]:
        """One attribution record per family plus a ``_total`` rollup
        record (summed device time / flops / bytes; its lower bound is the
        SUM of per-family lower bounds — phases run sequentially — and its
        extras carry the committed tokens + tokens/s ceiling)."""
        global PERF_RECORDS
        self.ingest_ledger()
        now, mono = time.time(), time.monotonic()
        recs: List[dict] = []
        tot_f = tot_b = tot_ms = tot_calls = 0.0
        tot_tc = tot_tm = 0.0
        for family in sorted(self._fams):
            calls, ms = self._fams[family]
            if family in self._costs:
                # explicit note_cost: per-call flops/bytes x calls
                fl_pc, by_pc = self._costs[family]
                rec = attribute(family, calls, ms, fl_pc, by_pc,
                                self.spec, now=now, mono=mono)
            else:
                # ledger join: phase TOTALS (programs x executions)
                fl, by = self._ledger_totals.get(family, (0.0, 0.0))
                rec = roofline_attribution(family, calls, ms, fl, by,
                                           self.spec, now=now, mono=mono)
            recs.append(rec)
            tot_f += rec["flops"]
            tot_b += rec["bytes"]
            tot_ms += rec["device_ms"]
            tot_calls += calls
            tot_tc += rec["flops"] / self.spec.peak_flops
            tot_tm += rec["bytes"] / self.spec.hbm_bytes_per_s
        if recs:
            total = roofline_attribution("_total", tot_calls, tot_ms,
                                         tot_f, tot_b, self.spec,
                                         now=now, mono=mono)
            # sequential phases: the total's floor is the sum of floors
            lower_s = sum(
                max(r["flops"] / self.spec.peak_flops,
                    r["bytes"] / self.spec.hbm_bytes_per_s) for r in recs)
            total["lower_bound_ms"] = lower_s * 1e3
            total["pct_roofline"] = (lower_s / (tot_ms / 1e3)
                                     if tot_ms > 0 else 0.0)
            total["bound"] = "compute" if tot_tc >= tot_tm else "memory"
            total["tokens"] = self._tokens
            total["toks_per_s_ceiling"] = (
                self._tokens / lower_s if self._tokens and lower_s > 0
                else None)
            recs.append(total)
        PERF_RECORDS += len(recs)
        return recs

    def rollup(self) -> Optional[dict]:
        """The headline numbers: MFU/MBU over everything accounted, the
        total percent-of-roofline, and (when tokens were committed) the
        tokens/s ceiling.  None before any phase was accounted."""
        recs = self.attribution()
        if not recs:
            return None
        total = recs[-1]
        return {
            "device": total["device"],
            "families": len(recs) - 1,
            "device_ms": total["device_ms"],
            "mfu": total["mfu"],
            "mbu": total["mbu"],
            "pct_roofline": total["pct_roofline"],
            "bound": total["bound"],
            "tokens": total.get("tokens", 0.0),
            "toks_per_s_ceiling": total.get("toks_per_s_ceiling"),
        }

    def update_metrics(self) -> None:
        """Refresh the ``perf/*`` registry gauges from the current rollup
        (milli-units: gauges are plain floats, MFU is a 0..1 fraction).
        Called on the observe cadence, not per phase — the rollup walks
        every family."""
        if self.registry is None:
            return
        roll = self.rollup()
        if roll is None:
            return
        self.registry.gauge("perf/mfu_milli").set(roll["mfu"] * 1e3)
        self.registry.gauge("perf/mbu_milli").set(roll["mbu"] * 1e3)
        self.registry.gauge("perf/roofline_pct_milli").set(
            roll["pct_roofline"] * 1e3)

    def dump(self, path: Optional[str] = None) -> Optional[str]:
        """Write the attribution records as ``perf_attribution.jsonl``.
        Returns the path, or None when nothing was accounted."""
        path = path or self.path
        recs = self.attribution()
        if path is None or not recs:
            return None
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            for r in recs:
                f.write(json.dumps(r) + "\n")
        return path


def read_perf_attribution(path: str) -> List[dict]:
    """Read a ``perf_attribution.jsonl`` artifact."""
    out: List[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def summarize_perf(records: Iterable[dict]) -> Optional[dict]:
    """The obs-report ``perf`` section from attribution records: per-family
    table rows (sorted by device time, the top time-eaters first) plus the
    ``_total`` rollup.  None when there are no records."""
    fams: List[dict] = []
    total: Optional[dict] = None
    for r in records:
        if r.get("family") == "_total":
            total = r
        else:
            fams.append(r)
    if not fams and total is None:
        return None
    fams.sort(key=lambda r: -r.get("device_ms", 0.0))
    section = {
        "device": (total or fams[0])["device"],
        "families": {
            r["family"]: {
                "calls": r["calls"],
                "device_ms": r["device_ms"],
                "flops": r["flops"],
                "bytes": r["bytes"],
                "arithmetic_intensity": r["arithmetic_intensity"],
                "bound": r["bound"],
                "pct_roofline": round(r["pct_roofline"], 6),
                "mfu": round(r["mfu"], 6),
                "mbu": round(r["mbu"], 6),
            }
            for r in fams
        },
        "top_time_eaters": [r["family"] for r in fams[:5]],
    }
    if total is not None:
        section["rollup"] = {
            "device_ms": total["device_ms"],
            "mfu": round(total["mfu"], 6),
            "mbu": round(total["mbu"], 6),
            "pct_roofline": round(total["pct_roofline"], 6),
            "bound": total["bound"],
            "tokens": total.get("tokens", 0.0),
            "toks_per_s_ceiling": total.get("toks_per_s_ceiling"),
        }
    return section


def merge_perf_records(streams: Iterable[Iterable[dict]]) -> List[dict]:
    """Fleet merge: sum each family's calls / device time / flops / bytes
    across replicas and recompute the derived roofline numbers against the
    first stream's device spec; ``_total`` rollups merge the same way
    (tokens sum, ceiling recomputed)."""
    fams: Dict[str, List[float]] = {}
    spec: Optional[DeviceSpec] = None
    tokens = 0.0
    for stream in streams:
        for r in stream:
            if spec is None:
                spec = DeviceSpec(r["device"], r["peak_flops"],
                                  r["hbm_bytes_per_s"])
            if r.get("family") == "_total":
                tokens += r.get("tokens", 0.0) or 0.0
                continue
            s = fams.setdefault(r["family"], [0.0, 0.0, 0.0, 0.0])
            s[0] += r.get("calls", 0.0)
            s[1] += r.get("device_ms", 0.0)
            s[2] += r.get("flops", 0.0)
            s[3] += r.get("bytes", 0.0)
    if spec is None:
        return []
    now, mono = time.time(), time.monotonic()
    out = [
        roofline_attribution(fam, c, ms, fl, by, spec, now=now, mono=mono)
        for fam, (c, ms, fl, by) in sorted(fams.items())
    ]
    if out:
        tot_f = sum(r["flops"] for r in out)
        tot_b = sum(r["bytes"] for r in out)
        tot_ms = sum(r["device_ms"] for r in out)
        tot_calls = sum(r["calls"] for r in out)
        total = roofline_attribution("_total", tot_calls, tot_ms, tot_f,
                                     tot_b, spec, now=now, mono=mono)
        lower_s = sum(max(r["flops"] / spec.peak_flops,
                          r["bytes"] / spec.hbm_bytes_per_s) for r in out)
        total["lower_bound_ms"] = lower_s * 1e3
        total["pct_roofline"] = (lower_s / (tot_ms / 1e3)
                                 if tot_ms > 0 else 0.0)
        total["tokens"] = tokens
        total["toks_per_s_ceiling"] = (tokens / lower_s
                                       if tokens and lower_s > 0 else None)
        out.append(total)
    return out


__all__ = [
    "DeviceSpec",
    "DEVICE_SPECS",
    "PERF_ATTRIBUTION_FILE",
    "PERF_ATTRIBUTION_SCHEMA",
    "PERF_FAMILIES",
    "PERF_RECORDS",
    "PHASE_PROGRAMS",
    "PerfAttribution",
    "attribute",
    "calibrate_cpu_spec",
    "device_spec",
    "merge_perf_records",
    "read_perf_attribution",
    "roofline_attribution",
    "summarize_perf",
]
