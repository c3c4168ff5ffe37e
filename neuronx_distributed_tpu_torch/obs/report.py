"""Run-report builder: merge every persisted telemetry artifact into one
summary document (a copy of ``neuronx_distributed_tpu/obs/report.py``,
stdlib only: the port writes the JAX package's formats, so one reader
serves both, and each package's report reads the other's run directory).

Inputs (all optional -- the report covers whatever exists):

- ``scalars.jsonl`` streams (the registry dumps in an obs dir);
- ``flight_record.json`` (the step flight recorder's last dump);
- ``hlo_audit.jsonl`` (one collective-audit record per program);
- ``compile_ledger.jsonl``, ``memory_breakdown.json``, ``*alerts.jsonl``
  and ``*perf_attribution.jsonl`` (the resource ledgers, the health
  monitor and the perf attribution);
- ``trace_events.jsonl`` + ``serving_stats.jsonl`` (request waterfalls);
- the fleet's files (``router_stats.jsonl``, ``*autopilot_actions.jsonl``,
  ``*weight_swaps.jsonl`` and per-replica subdirectories), as the port's
  fleet (:mod:`..serving.fleet`, :mod:`..weights`) writes them, in the
  JAX package's formats;
- Chrome-trace timeline files (:class:`~.tracing.Timeline` output).

The output validates against ``obs.schemas.SCHEMAS["obs_report"]`` and has a
markdown rendering for humans.  CLI: ``python -m
neuronx_distributed_tpu_torch.obs.report RUN_DIR`` (the flags of the JAX
package's ``tools/obs_report.py``; see :func:`main`).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
from typing import Dict, List, Optional, Sequence

from neuronx_distributed_tpu_torch.obs import FLIGHT_FILE, HLO_AUDIT_FILE, SCALARS_FILE
from neuronx_distributed_tpu_torch.obs.compile_ledger import (
    COMPILE_LEDGER_FILE,
    read_compile_ledger,
    summarize_compile_records,
)
from neuronx_distributed_tpu_torch.obs.flight import read_flight
from neuronx_distributed_tpu_torch.obs.hlo_audit import read_audits
from neuronx_distributed_tpu_torch.obs.memory_ledger import (
    MEMORY_BREAKDOWN_FILE,
    read_memory_breakdown,
)
from neuronx_distributed_tpu_torch.obs.perf import (
    PERF_ATTRIBUTION_FILE,
    summarize_perf,
)
from neuronx_distributed_tpu_torch.obs.registry import read_histograms
from neuronx_distributed_tpu_torch.obs.schemas import validate_record
from neuronx_distributed_tpu_torch.obs.tracing import (
    PHASE_NAMES,
    TRACE_EVENTS_FILE,
    read_trace_events,
)

# v2: the document gained the required "trace" section
# (per-request waterfalls from trace_events.jsonl; null when no trace).
# v3: required "compile" (compile_ledger.jsonl
# rollup) and "memory" (mem/* gauges + memory_breakdown.json) sections,
# both null when the run carried no ledger.
# v4: required "alerts" section (alerts.jsonl rollup —
# firing count, worst severity, per-rule edges and time-firing; null when
# the run carried no health monitor), and --run-dir auto-discovers fleet
# layouts (per-replica scalars/serving_stats subdirectories merged via
# obs.aggregate, router_stats.jsonl rolled into the fleet section).
# v5: required "perf" section (per-family roofline
# attribution from perf_attribution.jsonl — device-time, achieved vs peak
# FLOP/s and bytes/s, compute-/memory-bound classification, MFU/MBU and
# tokens/s-ceiling rollup; replica streams merge additively; null when
# the run carried no perf profiler).
# v6: required "autopilot" section
# (autopilot_actions.jsonl rollup — action table, per-action and
# per-trigger counts, action rate over the covered mono span; null when
# the run carried no autopilot), and --compare gates on run B's action
# rate regressing past A's (a controller that has to act more often
# under the same workload is flapping or fighting a real regression).
# v7: required "weights" section (weight_swaps.jsonl
# rollup — swap/failure counts by source, per-replica version table with
# a monotonicity check, swap-latency stats; null when the run carried no
# swapper), and --compare gates on swap failures appearing in B when A's
# swaps all committed (a deploy pipeline that starts refusing envelopes
# under the same workload is a release regression).
OBS_REPORT_SCHEMA = "obs_report_v7"
SUPERVISOR_EVENTS_FILE = "supervisor_events.jsonl"
SERVING_STATS_FILE = "serving_stats.jsonl"
ROUTER_STATS_FILE = "router_stats.jsonl"
AUTOPILOT_ACTIONS_FILE = "autopilot_actions.jsonl"
WEIGHT_SWAPS_FILE = "weight_swaps.jsonl"


def _read_scalar_file(path: str) -> List[dict]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def _parse_timeline(path: str) -> List[dict]:
    """Parse a Timeline trace file: the Perfetto-tolerant JSON-array format
    has a header '[' and one ``{...},`` object per line with no closing
    bracket — fall back to line-wise parsing when strict JSON fails."""
    with open(path) as f:
        text = f.read()
    try:
        doc = json.loads(text)
        return doc if isinstance(doc, list) else doc.get("traceEvents", [])
    except json.JSONDecodeError:
        events = []
        for line in text.splitlines():
            line = line.strip().rstrip(",")
            if line.startswith("{"):
                try:
                    events.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
        return events


def _summarize_scalars(records: List[dict],
                       histogram_names: frozenset = frozenset()) -> Dict[str, dict]:
    """Per-tag stream summary.  Histogram-flattened tags (``/le_*`` edges
    and the ``/count``/``/sum`` of any name in ``histogram_names``) are
    skipped — they are reconstructed into the histograms section instead,
    and min/max/mean over cumulative snapshots would be meaningless."""
    skip = {f"{h}/{suffix}" for h in histogram_names
            for suffix in ("count", "sum")}
    by_tag: Dict[str, dict] = {}
    for r in records:
        tag = r.get("tag")
        if tag is None or "/le_" in tag or tag in skip:
            continue
        s = by_tag.get(tag)
        v, step = float(r["value"]), int(r["step"])
        if s is None:
            by_tag[tag] = {
                "count": 1, "first_step": step, "last_step": step,
                "last": v, "min": v, "max": v, "_sum": v,
            }
        else:
            s["count"] += 1
            s["_sum"] += v
            s["min"] = min(s["min"], v)
            s["max"] = max(s["max"], v)
            if step >= s["last_step"]:
                s["last_step"], s["last"] = step, v
            s["first_step"] = min(s["first_step"], step)
    for s in by_tag.values():
        s["mean"] = s.pop("_sum") / s["count"]
    return by_tag


def _summarize_supervisor(path: str) -> dict:
    """Summarize a ``supervisor_events.jsonl`` stream: restart count, crash
    causes, time-to-recover (crash ``exit`` → next successful ``start``),
    and the final outcome — the "how many times did this run die and how
    fast did it come back" section of the run summary."""
    events = _read_scalar_file(path)  # same JSONL shape, different kind
    causes: List[str] = []
    recover_s: List[float] = []
    last_crash_time: Optional[float] = None
    gave_up = succeeded = False
    final_rc: Optional[int] = None
    for e in events:
        kind = e.get("event")
        if kind == "exit":
            final_rc = e.get("rc")
            if e.get("rc") != 0:
                causes.append(e.get("cause", "unknown"))
                last_crash_time = e.get("time")
        elif kind == "start" and last_crash_time is not None:
            recover_s.append(max(0.0, e["time"] - last_crash_time))
            last_crash_time = None
        elif kind == "giveup":
            gave_up = True
        elif kind == "success":
            succeeded = True
    return {
        "events": len(events),
        "attempts": max((e.get("attempt", 0) for e in events), default=0),
        "restarts": sum(1 for e in events if e.get("event") == "restart"),
        "crash_causes": causes,
        "recover_s": [round(s, 3) for s in recover_s],
        "mean_recover_s": (round(sum(recover_s) / len(recover_s), 3)
                           if recover_s else None),
        "succeeded": succeeded,
        "gave_up": gave_up,
        "final_rc": final_rc,
    }


def _summarize_host_blocked(histograms: Dict[str, dict]) -> Dict[str, dict]:
    """The async-hot-path overlap story, per subsystem: how much wall time
    the host spent blocked on explicit device fetches
    (``<sys>/host_blocked_ms``, written by the transfer audit) against the
    subsystem's step time — ``frac`` near 0 means the deferred/pipelined
    path is overlapping as designed, near 1 means every step drains the
    device."""
    out: Dict[str, dict] = {}
    for sys_name, step_hist in (("train", "train/step_time_ms"),
                                ("serving", "serving/step_ms")):
        hb = histograms.get(f"{sys_name}/host_blocked_ms")
        if not hb or not hb.get("count"):
            continue
        entry = {
            "blocked_ms_total": round(hb["sum"], 3),
            "blocked_ms_mean": round(hb["mean"], 3),
            "fetches": hb["count"],
        }
        steps = histograms.get(step_hist)
        if steps and steps.get("sum"):
            entry["frac"] = round(min(hb["sum"] / steps["sum"], 1.0), 4)
        out[sys_name] = entry
    return out


def _summarize_kvcache(scalars: Dict[str, dict]) -> Optional[dict]:
    """Paged-KV health from the registry's ``kvcache/*`` scalars: pool
    occupancy (in-use / total pages, with the prefix-cache-held share) and
    prefix-reuse effectiveness (page hit rate, prefills skipped outright,
    evictions, copy-on-writes).  None when the run served no paged engine."""
    total = scalars.get("kvcache/pages_total")
    if total is None or not total.get("last"):
        return None

    def last(tag):
        s = scalars.get(tag)
        return s["last"] if s else 0.0

    hits = last("kvcache/prefix_hits_total")
    misses = last("kvcache/prefix_misses_total")
    return {
        "pages_total": total["last"],
        "pages_in_use": last("kvcache/pages_in_use"),
        "pages_cached": last("kvcache/pages_cached"),
        "occupancy": round(last("kvcache/pages_in_use") / total["last"], 4),
        "prefix_hits": hits,
        "prefix_misses": misses,
        "prefix_hit_rate": (round(hits / (hits + misses), 4)
                            if hits + misses else None),
        "prefills_skipped": last("kvcache/prefill_skipped_total"),
        "evictions": last("kvcache/evictions_total"),
        "cow_copies": last("kvcache/cow_copies_total"),
        # bytes the gather decode path spent on [B, T] rematerialization;
        # 0 means the block-table-native kernel served every decode step
        "gather_bytes": last("kvcache/gather_bytes_total"),
    }


def _summarize_speculative(scalars: Dict[str, dict]) -> Optional[dict]:
    """Speculative-decoding health from the ``serving/spec_*_total``
    counters: draft acceptance rate (accepted/proposed — draft quality) and
    committed tokens per engine round (the tokens-per-step headline — the
    whole point of speculating is pushing it past 1).  None when the run
    served no speculative engine."""
    proposed = scalars.get("serving/spec_proposed_total")
    if proposed is None or not proposed.get("last"):
        return None

    def last(tag):
        s = scalars.get(tag)
        return s["last"] if s else 0.0

    p = proposed["last"]
    a = last("serving/spec_accepted_total")
    rounds = last("serving/spec_rounds_total")
    committed = last("serving/spec_committed_total")
    return {
        "proposed": p,
        "accepted": a,
        "acceptance_rate": round(a / p, 4) if p else None,
        "rounds": rounds,
        "committed": committed,
        "tokens_per_round": round(committed / rounds, 4) if rounds else None,
    }


def _summarize_tenancy(scalars: Dict[str, dict]) -> Optional[dict]:
    """Multi-tenant serving health from the ``tenancy/*`` registry scalars
    (plus ``kvcache/quant_pages_total``): adapter-pool residency and churn
    — how many adapters are device-resident, how much of the pool they
    hold, and the hit/load/eviction split (a high eviction count means the
    adapter pool thrashes — grow it or steer with adapter affinity).  None
    when the run served no multi-adapter or quantized engine."""
    resident = scalars.get("tenancy/adapters_resident")
    quant = scalars.get("kvcache/quant_pages_total")
    if (resident is None or resident.get("last") is None) and quant is None:
        return None

    def last(tag):
        s = scalars.get(tag)
        return s["last"] if s else 0.0

    hits = last("tenancy/adapter_hits_total")
    loads = last("tenancy/adapter_loads_total")
    return {
        "adapters_resident": last("tenancy/adapters_resident"),
        "adapter_pool_pages_in_use": last("tenancy/adapter_pool_pages_in_use"),
        "adapter_hits": hits,
        "adapter_loads": loads,
        "adapter_hit_rate": (round(hits / (hits + loads), 4)
                             if hits + loads else None),
        "adapter_evictions": last("tenancy/adapter_evictions_total"),
        "quant_pages": last("kvcache/quant_pages_total"),
    }


def _summarize_fleet(scalars: Dict[str, dict]) -> Optional[dict]:
    """Fleet-router health from the ``router/*`` registry scalars: pool
    size still in rotation, dispatch/requeue/failover accounting (requeues
    and failovers above 0 mean replicas died mid-run and their work moved),
    and the affinity story — how often the shadow steered a fingerprinted
    request to a replica already holding its pages, and the pool-wide
    prefix hit rate that steering exists to raise.  None when the run
    served no fleet."""
    dispatched = scalars.get("router/dispatched_total")
    if dispatched is None or not dispatched.get("last"):
        return None

    def last(tag):
        s = scalars.get(tag)
        return s["last"] if s else 0.0

    hits = last("router/affinity_hits_total")
    misses = last("router/affinity_misses_total")
    return {
        "replicas_alive": last("router/replicas_alive"),
        "dispatched": dispatched["last"],
        "requeued": last("router/requeued_total"),
        "failovers": last("router/failovers_total"),
        "restarts": last("router/restarts_total"),
        "retired": last("router/retired_total"),
        "affinity_hits": hits,
        "affinity_misses": misses,
        "affinity_hit_rate": (round(hits / (hits + misses), 4)
                              if hits + misses else None),
        "fleet_prefix_hit_rate": (
            round(last("router/fleet_prefix_hit_rate"), 4)
            if scalars.get("router/fleet_prefix_hit_rate") else None),
    }


def _hist_p99(hist: Optional[dict]) -> Optional[float]:
    """Approximate p99 from a cumulative-bucket histogram summary: the
    upper edge of the first bucket whose cumulative count covers 99% —
    coarse (bucket-resolution) but monotone, which is all the SLO line
    needs."""
    if not hist or not hist.get("count"):
        return None
    import math

    target = 0.99 * hist["count"]
    for le, cum in hist["buckets"].items():
        if cum >= target:
            try:
                v = float(le)
            except ValueError:
                return None
            # the overflow bucket's edge renders as "inf" — float() parses
            # it happily, but "p99 ~infms" is not a number worth printing
            return None if math.isinf(v) else v
    return None


def _summarize_slo(scalars: Dict[str, dict],
                   histograms: Dict[str, dict]) -> Optional[dict]:
    """SLO-serving health from the priority scheduler's counters and the
    per-class latency histograms: preemptions (batch victims parked for
    interactive heads), load shed at admission (infeasible deadlines),
    expiries caught immediately before prefill dispatch, chunked-prefill
    dispatches, and the per-class TTFT / inter-token p99s the whole
    subsystem exists to keep flat.  None when the run used none of the SLO
    machinery."""
    names = ("serving/preemptions_total", "serving/shed_total",
             "serving/expired_before_prefill_total",
             "serving/prefill_chunks_total")

    def last(tag):
        s = scalars.get(tag)
        return s["last"] if s else 0.0

    per_class = {}
    for cls in ("interactive", "batch"):
        ttft = histograms.get(f"serving/ttft_ms_{cls}")
        inter = histograms.get(f"serving/intertoken_ms_{cls}")
        if (ttft and ttft.get("count")) or (inter and inter.get("count")):
            per_class[cls] = {
                "requests": ttft["count"] if ttft else 0,
                "ttft_p99_ms": _hist_p99(ttft),
                "intertoken_p99_ms": _hist_p99(inter),
            }
    if not per_class and not any(last(n) for n in names):
        return None
    return {
        "preemptions": last("serving/preemptions_total"),
        "shed": last("serving/shed_total"),
        "expired_before_prefill": last(
            "serving/expired_before_prefill_total"),
        "prefill_chunks": last("serving/prefill_chunks_total"),
        "classes": per_class,
    }


def _summarize_compile(scalars: Dict[str, dict],
                       ledger_records: List[dict],
                       histograms: Dict[str, dict]) -> Optional[dict]:
    """The "compile" health section: the compile ledger's rollup (per-
    family compiles / cold wall-time / distinct keys / evictions, storm and
    thrash counts) joined with the live ``trace/compile*`` scalars.  None
    when the run carried no compile ledger."""
    if not ledger_records and scalars.get("trace/compiles_total") is None:
        return None

    def last(tag):
        s = scalars.get(tag)
        return s["last"] if s else 0.0

    out = summarize_compile_records(ledger_records, cache={
        "hits": last("trace/compiled_cache_hits_total"),
        "misses": last("trace/compiled_cache_misses_total"),
        "evictions": last("trace/compiled_cache_evictions_total"),
    })
    if not ledger_records:
        # scalars-only view (the jsonl was not collected): keep the counts
        out["compiles"] = last("trace/compiles_total")
        out["storms"] = last("trace/compile_storms_total")
        out["thrash_warnings"] = last("trace/compile_thrash_total")
        h = histograms.get("trace/compile_ms")
        if h:
            out["cold_ms_total"] = round(h.get("sum", 0.0), 3)
    return out


def _summarize_memory(scalars: Dict[str, dict],
                      breakdown: Optional[dict]) -> Optional[dict]:
    """The "memory" health section: per-subsystem bytes + peak watermarks
    from ``memory_breakdown.json`` when present, else reconstructed from
    the live ``mem/*_bytes`` gauges.  None when the run carried no memory
    ledger."""
    if breakdown is not None:
        return {
            "subsystems": breakdown["subsystems"],
            "total_bytes": breakdown["total_bytes"],
            "peak_total_bytes": breakdown["peak_total_bytes"],
            "device": breakdown.get("device"),
            "top": breakdown.get("top", []),
            "reason": breakdown.get("reason"),
        }
    subs: Dict[str, dict] = {}
    device: Dict[str, float] = {}
    for tag, s in scalars.items():
        if not tag.startswith("mem/"):
            continue
        name = tag[len("mem/"):]
        if name.startswith(("device_", "live_array")):
            device[name] = s["last"]
        elif name.endswith("_peak_bytes"):
            subs.setdefault(name[:-len("_peak_bytes")], {})["peak_bytes"] = \
                s["last"]
        elif name.endswith("_bytes"):
            subs.setdefault(name[:-len("_bytes")], {})["bytes"] = s["last"]
    if not subs and not device:
        return None
    for v in subs.values():
        v.setdefault("bytes", 0.0)
        v.setdefault("peak_bytes", v["bytes"])
    total = sum(v["bytes"] for v in subs.values())
    return {
        "subsystems": subs,
        "total_bytes": total,
        "peak_total_bytes": sum(v["peak_bytes"] for v in subs.values()),
        "device": device or None,
        "top": sorted(([k, v["bytes"]] for k, v in subs.items()),
                      key=lambda kv: -kv[1])[:5],
        "reason": None,
    }


def compare_resources(run_a: str, run_b: str,
                      compile_threshold: float = 0.0,
                      mem_threshold: float = 0.05,
                      mfu_threshold: float = 0.05,
                      autopilot_threshold: float = 0.5) -> dict:
    """Run-to-run compile/memory/alert/perf/autopilot regression diff
    (``python -m neuronx_distributed_tpu_torch.obs.report --compare RUN_A
    RUN_B``): reads each run dir's
    ``compile_ledger.jsonl``, ``memory_breakdown.json``,
    ``*alerts.jsonl``, ``*perf_attribution.jsonl`` and
    ``*autopilot_actions.jsonl`` and flags B against A — more compiles
    than ``(1 + compile_threshold) * A`` (or any storm in B), any
    subsystem's peak bytes past ``(1 + mem_threshold) * A``'s, any alert
    RULE that fired in B without firing in A (a new alert under the same
    workload is a health regression, threshold-free), B's MFU sagging
    below ``(1 - mfu_threshold) * A``'s (same workload, less of the
    device's peak — the perf regression the roofline profiler exists to
    catch), or B's autopilot action rate past
    ``(1 + autopilot_threshold) * A``'s (a controller that has to act
    more often under the same workload is flapping, or fighting a real
    regression upstream of it; actions appearing in B when A's autopilot
    never acted regress threshold-free).  ``*weight_swaps.jsonl`` adds
    the deploy gates: swap FAILURES appearing in B when every swap in A
    committed, and any replica whose weights_version went non-monotonic
    (both threshold-free — a refused envelope or a version rollback under
    the same deploy pipeline is a release regression, not noise).
    Returns ``{"a", "b", "compile", "memory", "alerts", "perf",
    "autopilot", "weights", "regressions", "regressed", "markdown"}``."""
    def load(run_dir):
        cl_path = os.path.join(run_dir, COMPILE_LEDGER_FILE)
        mb_path = os.path.join(run_dir, MEMORY_BREAKDOWN_FILE)
        compile_sum = (summarize_compile_records(read_compile_ledger(cl_path))
                       if os.path.exists(cl_path) else None)
        breakdown = (read_memory_breakdown(mb_path)
                     if os.path.exists(mb_path) else None)
        alerts = summarize_alerts(
            sorted(glob.glob(os.path.join(run_dir, "*alerts.jsonl"))))
        from neuronx_distributed_tpu_torch.obs.aggregate import merge_perf_files

        perf = summarize_perf(merge_perf_files(sorted(
            glob.glob(os.path.join(run_dir, f"*{PERF_ATTRIBUTION_FILE}")))))
        autopilot = summarize_autopilot(sorted(glob.glob(
            os.path.join(run_dir, f"*{AUTOPILOT_ACTIONS_FILE}"))))
        weights = summarize_weights(sorted(glob.glob(
            os.path.join(run_dir, f"*{WEIGHT_SWAPS_FILE}"))))
        return compile_sum, breakdown, alerts, perf, autopilot, weights

    ca, ma, aa, perf_a, ap_a, wt_a = load(run_a)
    cb, mb, ab, perf_b, ap_b, wt_b = load(run_b)
    regressions: List[str] = []
    lines = ["# Resource regression diff", "",
             f"- A: `{run_a}`", f"- B: `{run_b}`", ""]

    lines += ["## Compile", "",
              "| metric | A | B |", "|---|---|---|"]
    for key in ("compiles", "cold_ms_total", "cold_ms_max", "storms",
                "thrash_warnings", "evictions"):
        va = ca.get(key, 0) if ca else "n/a"
        vb = cb.get(key, 0) if cb else "n/a"
        lines.append(f"| {key} | {va} | {vb} |")
    if ca and cb:
        if cb["compiles"] > ca["compiles"] * (1.0 + compile_threshold):
            regressions.append(
                f"compiles regressed: {ca['compiles']} -> {cb['compiles']} "
                f"(threshold {compile_threshold:.0%})")
        if cb["storms"] > 0 and cb["storms"] > ca["storms"]:
            regressions.append(
                f"compile storms appeared: {ca['storms']} -> {cb['storms']}")
    lines.append("")

    lines += ["## Memory (peak bytes per subsystem)", "",
              "| subsystem | A | B |", "|---|---|---|"]
    subs_a = (ma or {}).get("subsystems", {})
    subs_b = (mb or {}).get("subsystems", {})
    for name in sorted(set(subs_a) | set(subs_b)):
        pa = subs_a.get(name, {}).get("peak_bytes")
        pb = subs_b.get(name, {}).get("peak_bytes")
        lines.append(f"| {name} | {pa if pa is not None else 'n/a'} "
                     f"| {pb if pb is not None else 'n/a'} |")
        if pa and pb and pb > pa * (1.0 + mem_threshold):
            regressions.append(
                f"memory regressed: {name} peak {pa:,.0f} -> {pb:,.0f} "
                f"bytes (threshold {mem_threshold:.0%})")
        elif not pa and pb and ma is not None:
            # a consumer with no baseline (absent or zero-peak in A) has no
            # threshold to compare against — an arbitrarily large NEW
            # footprint must not pass a regression gate silently
            regressions.append(
                f"memory regressed: new subsystem {name} appeared in B "
                f"({pb:,.0f} peak bytes, no baseline in A)")
    lines.append("")

    def fired_rules(alerts):
        if alerts is None:
            return {}
        return {name: agg for name, agg in alerts["rules"].items()
                if agg["fired"]}

    fa, fb = fired_rules(aa), fired_rules(ab)
    if aa is not None or ab is not None:
        lines += ["## Alerts (firing edges)", "",
                  "| rule | A | B |", "|---|---|---|"]
        for name in sorted(set(fa) | set(fb)):
            va = fa[name]["fired"] if name in fa else (
                0 if aa is not None else "n/a")
            vb = fb[name]["fired"] if name in fb else (
                0 if ab is not None else "n/a")
            lines.append(f"| {name} | {va} | {vb} |")
        if not (fa or fb):
            lines.append("| (none fired) | 0 | 0 |")
        lines.append("")
    if aa is not None:
        # a rule firing in B that never fired in A is a regression under
        # the same workload — no threshold, presence is the signal
        for name in sorted(set(fb) - set(fa)):
            regressions.append(
                f"alerts regressed: rule {name!r} fired "
                f"{fb[name]['fired']}x in B (severity "
                f"{fb[name]['severity']}), never in A")

    ra = (perf_a or {}).get("rollup")
    rb = (perf_b or {}).get("rollup")
    if perf_a is not None or perf_b is not None:
        lines += ["## Perf (roofline rollup)", "",
                  "| metric | A | B |", "|---|---|---|"]
        for key in ("mfu", "mbu", "pct_roofline", "device_ms"):
            va = ra.get(key) if ra else None
            vb = rb.get(key) if rb else None
            fmt = (lambda v, k=key: "n/a" if v is None else
                   (f"{v:,.1f}" if k == "device_ms" else f"{v:.1%}"))
            lines.append(f"| {key} | {fmt(va)} | {fmt(vb)} |")
        lines.append("")
    if ra and rb and ra.get("mfu") and \
            rb["mfu"] < ra["mfu"] * (1.0 - mfu_threshold):
        regressions.append(
            f"mfu regressed: {ra['mfu']:.2%} -> {rb['mfu']:.2%} "
            f"(threshold {mfu_threshold:.0%})")

    if ap_a is not None or ap_b is not None:
        lines += ["## Autopilot (remediation actions)", "",
                  "| metric | A | B |", "|---|---|---|"]
        for key in ("actions", "span_s", "rate_per_s"):
            va = ap_a.get(key) if ap_a else None
            vb = ap_b.get(key) if ap_b else None
            fmt = lambda v: "n/a" if v is None else (
                f"{v:.4g}" if isinstance(v, float) else str(v))
            lines.append(f"| {key} | {fmt(va)} | {fmt(vb)} |")
        lines.append("")
    if ap_a is not None and ap_b is not None:
        na, nb = ap_a["actions"], ap_b["actions"]
        rate_a, rate_b = ap_a["rate_per_s"], ap_b["rate_per_s"]
        if na == 0 and nb > 0:
            # A's autopilot watched the same workload and never had to
            # act — any action in B is a regression, threshold-free
            regressions.append(
                f"autopilot regressed: {nb} action(s) in B, none in A")
        elif rate_a is not None and rate_b is not None and \
                rate_b > rate_a * (1.0 + autopilot_threshold):
            regressions.append(
                f"autopilot regressed: action rate {rate_a:.4g}/s -> "
                f"{rate_b:.4g}/s (threshold {autopilot_threshold:.0%})")
        elif (rate_a is None or rate_b is None) and na > 0 and \
                nb > na * (1.0 + autopilot_threshold):
            # too few actions on one side to form a rate — fall back to
            # gating on the raw count
            regressions.append(
                f"autopilot regressed: {na} -> {nb} action(s) "
                f"(threshold {autopilot_threshold:.0%})")

    if wt_a is not None or wt_b is not None:
        lines += ["## Weights (live swaps)", "",
                  "| metric | A | B |", "|---|---|---|"]
        for key in ("swaps", "failures", "monotonic"):
            va = wt_a.get(key) if wt_a else None
            vb = wt_b.get(key) if wt_b else None
            fmt = lambda v: "n/a" if v is None else str(v)
            lines.append(f"| {key} | {fmt(va)} | {fmt(vb)} |")
        lines.append("")
    if wt_b is not None:
        # both gates are threshold-free: a deploy pipeline that starts
        # refusing envelopes (when A's swaps all committed), or ANY
        # version rollback, is a release regression
        if wt_a is not None and wt_a["failures"] == 0 \
                and wt_b["failures"] > 0:
            regressions.append(
                f"weights regressed: {wt_b['failures']} swap failure(s) "
                "in B, none in A")
        if not wt_b["monotonic"]:
            bad = sorted(rid for rid, rep in wt_b["replicas"].items()
                         if not rep["monotonic"])
            regressions.append(
                "weights regressed: weights_version went non-monotonic "
                f"in B (replica(s) {', '.join(bad)})")

    if regressions:
        lines += ["## Regressions", ""] + [f"- {r}" for r in regressions] \
            + [""]
    else:
        lines += ["No regressions past thresholds.", ""]
    return {
        "a": run_a, "b": run_b,
        "compile": {"a": ca, "b": cb},
        "memory": {"a": ma and {k: ma[k] for k in
                                ("subsystems", "total_bytes",
                                 "peak_total_bytes")},
                   "b": mb and {k: mb[k] for k in
                                ("subsystems", "total_bytes",
                                 "peak_total_bytes")}},
        "alerts": {"a": aa, "b": ab},
        "perf": {"a": ra, "b": rb},
        "autopilot": {"a": ap_a, "b": ap_b},
        "weights": {"a": wt_a, "b": wt_b},
        "regressions": regressions,
        "regressed": bool(regressions),
        "markdown": "\n".join(lines),
    }


def summarize_alerts(paths: Sequence[str]) -> Optional[dict]:
    """The "alerts" section: roll every ``alerts.jsonl`` edge stream into
    firing count, worst severity among still-firing alerts, and per-rule
    edge counts + total time-firing (fire→resolve pairs on the monotonic
    clock; an unresolved alert accrues until the stream's last stamp).
    Returns None when no alert files exist (the report key is null, not
    {}) — an existing-but-quiet file reports zero edges."""
    from neuronx_distributed_tpu_torch.obs.health import read_alerts, worst_severity

    records: List[dict] = []
    files = 0
    for p in paths:
        if os.path.exists(p):
            files += 1
            records.extend(read_alerts(p))
    if not files:
        return None
    records.sort(key=lambda r: r.get("mono", 0.0))
    last_mono = records[-1].get("mono", 0.0) if records else 0.0
    per_key: Dict[tuple, dict] = {}
    for r in records:
        key = (r.get("rule", "?"), r.get("key", ""), r.get("replica", -1))
        st = per_key.setdefault(key, {
            "rule": key[0], "severity": r.get("severity", "warn"),
            "fired": 0, "resolved": 0, "firing_since": None,
            "time_firing_s": 0.0})
        st["severity"] = r.get("severity", st["severity"])
        if r.get("state") == "firing":
            st["fired"] += 1
            st["firing_since"] = r.get("mono", 0.0)
        else:
            st["resolved"] += 1
            if st["firing_since"] is not None:
                st["time_firing_s"] += max(
                    r.get("mono", 0.0) - st["firing_since"], 0.0)
                st["firing_since"] = None
    rules: Dict[str, dict] = {}
    firing_now: List[dict] = []
    for st in per_key.values():
        if st["firing_since"] is not None:  # never resolved: accrue to end
            st["time_firing_s"] += max(last_mono - st["firing_since"], 0.0)
            firing_now.append(st)
        agg = rules.setdefault(st["rule"], {
            "severity": st["severity"], "fired": 0, "resolved": 0,
            "firing": 0, "time_firing_s": 0.0})
        agg["fired"] += st["fired"]
        agg["resolved"] += st["resolved"]
        agg["firing"] += int(st["firing_since"] is not None)
        agg["time_firing_s"] = round(
            agg["time_firing_s"] + st["time_firing_s"], 6)
        if _sev_rank(st["severity"]) > _sev_rank(agg["severity"]):
            agg["severity"] = st["severity"]
    top = sorted(((name, agg["time_firing_s"])
                  for name, agg in rules.items()),
                 key=lambda kv: -kv[1])[:5]
    return {
        "files": files,
        "records": len(records),
        "firing": len(firing_now),
        "worst_severity": worst_severity(
            [st["severity"] for st in firing_now]),
        "rules": dict(sorted(rules.items())),
        "top_firing_s": [[name, s] for name, s in top if s > 0],
    }


def _sev_rank(severity: str) -> int:
    from neuronx_distributed_tpu_torch.obs.health import _SEV_ORDER

    return _SEV_ORDER.get(severity, 0)


def summarize_autopilot(paths: Sequence[str],
                        tail: int = 20) -> Optional[dict]:
    """The "autopilot" section: roll every ``autopilot_actions.jsonl``
    stream into per-action and per-trigger counts, the action rate over
    the covered monotonic span, and the last ``tail`` actions as table
    rows.  Returns None when no action files exist (the report key is
    null, not {}) — an existing-but-quiet file reports zero actions (an
    autopilot that never had to act is the healthy outcome, and distinct
    from no autopilot at all)."""
    records: List[dict] = []
    files = 0
    for p in paths:
        if not os.path.exists(p):
            continue
        files += 1
        with open(p) as f:
            for line in f:
                line = line.strip()
                if line:
                    records.append(json.loads(line))
    if not files:
        return None
    records.sort(key=lambda r: r.get("mono", 0.0))
    by_action: Dict[str, int] = {}
    triggers: Dict[str, dict] = {}
    modes: Dict[str, int] = {}
    for r in records:
        action = r.get("action", "?")
        by_action[action] = by_action.get(action, 0) + 1
        modes[r.get("mode", "?")] = modes.get(r.get("mode", "?"), 0) + 1
        trig = triggers.setdefault(r.get("trigger", "?"), {
            "actions": 0, "by_action": {}, "replicas": set()})
        trig["actions"] += 1
        trig["by_action"][action] = trig["by_action"].get(action, 0) + 1
        rid = r.get("replica", -1)
        if rid >= 0:
            trig["replicas"].add(rid)
    for trig in triggers.values():
        trig["replicas"] = sorted(trig["replicas"])
        trig["by_action"] = dict(sorted(trig["by_action"].items()))
    span_s = (records[-1].get("mono", 0.0) - records[0].get("mono", 0.0)
              if len(records) >= 2 else 0.0)
    rate = (len(records) / span_s) if span_s > 0 else None
    slim = [{"mono": r.get("mono", 0.0),
             "action": r.get("action", "?"),
             "trigger": r.get("trigger", "?"),
             "replica": r.get("replica", -1),
             "mode": r.get("mode", "?"),
             "budget_remaining": r.get("budget_remaining", -1),
             "detail": r.get("detail", {})} for r in records]
    return {
        "files": files,
        "actions": len(records),
        "by_action": dict(sorted(by_action.items())),
        "triggers": dict(sorted(triggers.items())),
        "modes": dict(sorted(modes.items())),
        "span_s": round(span_s, 6),
        "rate_per_s": rate,
        "last": slim[-1] if slim else None,
        "tail": slim[-tail:],
    }


def summarize_weights(paths: Sequence[str],
                      tail: int = 20) -> Optional[dict]:
    """The "weights" section: roll every ``weight_swaps.jsonl`` stream
    (solo engines write one; a fleet rolling update writes one per
    replica) into committed/failed swap counts by source, swap-latency
    stats, and a per-replica version table with a monotonicity check —
    the invariant a live deploy must never break.  Returns None when no
    swap files exist (the report key is null, not {}) — an
    existing-but-quiet file reports zero swaps (an engine that installed
    a swapper and never deployed is distinct from no swapper at all)."""
    records: List[dict] = []
    files = 0
    for p in paths:
        if not os.path.exists(p):
            continue
        files += 1
        with open(p) as f:
            for line in f:
                line = line.strip()
                if line:
                    records.append(json.loads(line))
    if not files:
        return None
    records.sort(key=lambda r: r.get("mono", 0.0))
    by_source: Dict[str, int] = {}
    replicas: Dict[int, dict] = {}
    swaps = failures = 0
    ms: List[float] = []
    for r in records:
        rid = int(r.get("replica", -1))
        rep = replicas.setdefault(rid, {
            "swaps": 0, "failures": 0, "version": 0, "monotonic": True})
        src = r.get("source", "?")
        if r.get("ok"):
            swaps += 1
            by_source[src] = by_source.get(src, 0) + 1
            v = int(r.get("version", 0))
            if v <= rep["version"]:
                rep["monotonic"] = False
            rep["version"] = max(rep["version"], v)
            rep["swaps"] += 1
            if r.get("swap_ms") is not None:
                ms.append(float(r["swap_ms"]))
        else:
            failures += 1
            rep["failures"] += 1
    slim = [{"mono": r.get("mono", 0.0),
             "event": r.get("event", "?"),
             "version": r.get("version", 0),
             "source": r.get("source", "?"),
             "ok": bool(r.get("ok")),
             "swap_ms": r.get("swap_ms"),
             "error": r.get("error"),
             "replica": r.get("replica", -1)} for r in records]
    return {
        "files": files,
        "swaps": swaps,
        "failures": failures,
        "by_source": dict(sorted(by_source.items())),
        "replicas": {str(rid): rep
                     for rid, rep in sorted(replicas.items())},
        "monotonic": all(rep["monotonic"] for rep in replicas.values()),
        "swap_ms_mean": (round(sum(ms) / len(ms), 3) if ms else None),
        "swap_ms_max": (round(max(ms), 3) if ms else None),
        "last": slim[-1] if slim else None,
        "tail": slim[-tail:],
    }


def read_serving_stats(path: str) -> List[dict]:
    """Read a ``serving_stats.jsonl`` stream ACROSS schema versions: v4
    records (pre-tracing) lack ``decode_steps``/``prefill_chunks``/
    ``preempted_ms``/``trace_id``/``mono``, v5 records (pre-live-weights)
    lack ``weights_version``; they are filled with defaults so downstream
    consumers never branch on the version (version 0 is exactly right for
    a pre-swap-era record: the process-start weights)."""
    out: List[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            rec.setdefault("decode_steps", 0)
            rec.setdefault("prefill_chunks", 0)
            rec.setdefault("preempted_ms", 0.0)
            rec.setdefault("trace_id", None)
            rec.setdefault("mono", None)
            rec.setdefault("weights_version", 0)
            out.append(rec)
    return out


def summarize_trace(trace_paths: Sequence[str],
                    stats_records: Sequence[dict] = (),
                    top: int = 5) -> Optional[dict]:
    """The ``--trace`` section: per-request waterfalls reconstructed from
    ``trace_events.jsonl`` spans.

    Spans group by fleet-global ``request_id`` (one stitched trace per
    request, across replicas and failover hops); the four PHASE spans
    (queue, prefill, decode, preempted) tile a request's lifetime, so
    their per-phase sums ARE the latency decomposition.  ``stats_records``
    (``serving_stats`` v4/v5) link each waterfall to its terminal record
    via ``trace_id`` for the reported-latency cross-check.  Returns None
    when no spans exist (the report's "trace" key is null, not {})."""
    spans: List[dict] = []
    for p in trace_paths:
        if os.path.exists(p):
            spans.extend(read_trace_events(p))
    if not spans:
        return None
    stats_by_trace = {r["trace_id"]: r for r in stats_records
                      if r.get("trace_id") is not None}

    by_req: Dict[int, List[dict]] = {}
    for s in spans:
        rid = s.get("request_id", -1)
        if rid >= 0:
            by_req.setdefault(rid, []).append(s)

    requests: List[dict] = []
    agg_phases = {name: 0.0 for name in PHASE_NAMES}
    agg_migrate = 0.0
    for rid, group in by_req.items():
        phases = {name: 0.0 for name in PHASE_NAMES}
        hops = 0
        migrate_ms = 0.0
        migrations = 0
        migrate_pages = 0
        replicas = set()
        state = None
        roots = 0
        for s in group:
            dur = max(s["t_end"] - s["t_start"], 0.0) * 1e3
            if s["name"] in phases:
                phases[s["name"]] += dur
            replicas.add(s["replica"])
            attrs = s.get("attrs", {})
            if s["name"] == "request":
                roots += 1
                hops = max(hops, int(attrs.get("hop", 0)))
                if attrs.get("state") is not None:
                    state = attrs["state"]
            elif s["name"] == "route/requeue":
                hops = max(hops, int(attrs.get("hop", 0)))
            elif s["name"] == "route/migrate":
                # disagg hop: KV export/import wall time (aborted fills
                # count too — they cost the same router time)
                migrate_ms += dur
                migrations += 1
                migrate_pages += int(attrs.get("pages", 0))
        for name, ms in phases.items():
            agg_phases[name] += ms
        agg_migrate += migrate_ms
        total = sum(phases.values())
        entry = {
            "request_id": rid,
            "state": state,
            "total_ms": round(total, 3),
            "queue_ms": round(phases["queue"], 3),
            "prefill_ms": round(phases["prefill"], 3),
            "decode_ms": round(phases["decode"], 3),
            "preempted_ms": round(phases["preempted"], 3),
            "migrate_ms": round(migrate_ms, 3),
            "migrations": migrations,
            "migrate_pages": migrate_pages,
            "hops": hops,
            "replicas": sorted(replicas - {-1}) or [-1],
            "spans": len(group),
            "window_ms": round(
                (max(s["t_end"] for s in group)
                 - min(s["t_start"] for s in group)) * 1e3, 3),
        }
        rec = stats_by_trace.get(rid)
        if rec is not None:
            entry["stats_total_ms"] = rec.get("total_ms")
            entry["stats_state"] = rec.get("state")
        requests.append(entry)

    requests.sort(key=lambda e: -e["total_ms"])
    by_phase = {k: round(v, 3) for k, v in agg_phases.items()}
    # migrate rides beside the four lifetime phases (it overlaps none of
    # them: the hop happens between withdrawal and re-submission)
    by_phase["migrate"] = round(agg_migrate, 3)
    return {
        "files": len([p for p in trace_paths if os.path.exists(p)]),
        "spans": len(spans),
        "requests": len(requests),
        "by_phase_ms": by_phase,
        "slowest": requests[:top],
    }


def _summarize_timeline(paths: Sequence[str]) -> dict:
    events = instants = 0
    dur_by_name: Dict[str, float] = {}
    markers: List[dict] = []
    for path in paths:
        for e in _parse_timeline(path):
            ph = e.get("ph")
            if ph == "X":
                events += 1
                dur_by_name[e.get("name", "?")] = (
                    dur_by_name.get(e.get("name", "?"), 0.0)
                    + float(e.get("dur", 0.0)) / 1e3)
            elif ph == "i":
                instants += 1
                if e.get("name", "").startswith("anomaly/"):
                    markers.append({"name": e["name"],
                                    "args": e.get("args", {})})
    top = dict(sorted(dur_by_name.items(), key=lambda kv: -kv[1])[:20])
    return {
        "files": len(list(paths)),
        "events": events,
        "instants": instants,
        "total_ms_by_name": top,
        "anomaly_markers": markers[:50],
    }


def build_report(
    run_dir: Optional[str] = None,
    scalar_paths: Sequence[str] = (),
    flight_path: Optional[str] = None,
    hlo_audit_path: Optional[str] = None,
    timeline_paths: Sequence[str] = (),
    supervisor_events_path: Optional[str] = None,
    trace_paths: Sequence[str] = (),
    serving_stats_path: Optional[str] = None,
    compile_ledger_path: Optional[str] = None,
    memory_breakdown_path: Optional[str] = None,
    alerts_paths: Sequence[str] = (),
    router_stats_path: Optional[str] = None,
    perf_paths: Sequence[str] = (),
    autopilot_paths: Sequence[str] = (),
    weights_paths: Sequence[str] = (),
    tail: int = 10,
) -> dict:
    """Merge the artifacts into one summary document.

    ``run_dir`` seeds the default artifact locations (``scalars.jsonl``,
    ``flight_record.json``, ``hlo_audit.jsonl``, ``supervisor_events.jsonl``
    and any ``*trace*.json`` / ``*alerts.jsonl`` inside it); the explicit
    path arguments add to / override them.  A FLEET run dir — immediate
    subdirectories each holding a replica's ``scalars.jsonl`` /
    ``serving_stats.jsonl`` — is auto-discovered: per-replica scalars
    merge through :mod:`~.aggregate` (counters/histograms sum, so the
    fleet histogram is the histogram of every replica's samples),
    serving stats concatenate, and a top-level ``router_stats.jsonl``
    rolls into the fleet section."""
    scalar_paths = list(scalar_paths)
    timeline_paths = list(timeline_paths)
    trace_paths = list(trace_paths)
    alerts_paths = list(alerts_paths)
    perf_paths = list(perf_paths)
    autopilot_paths = list(autopilot_paths)
    weights_paths = list(weights_paths)
    serving_stats_paths = ([serving_stats_path]
                           if serving_stats_path else [])
    fleet_scalar_streams: List[List[dict]] = []
    fleet_replicas: List[str] = []
    if run_dir:
        from neuronx_distributed_tpu_torch.obs.aggregate import (
            discover_replica_dirs,
        )

        for label, sub in discover_replica_dirs(run_dir):
            fleet_replicas.append(label)
            q = os.path.join(sub, SCALARS_FILE)
            if os.path.exists(q):
                fleet_scalar_streams.append(_read_scalar_file(q))
            q = os.path.join(sub, SERVING_STATS_FILE)
            if os.path.exists(q) and q not in serving_stats_paths:
                serving_stats_paths.append(q)
            for q in sorted(glob.glob(os.path.join(sub, "*alerts.jsonl"))):
                if q not in alerts_paths:
                    alerts_paths.append(q)
            for q in sorted(glob.glob(
                    os.path.join(sub, f"*{TRACE_EVENTS_FILE}"))):
                if q not in trace_paths:
                    trace_paths.append(q)
            for q in sorted(glob.glob(
                    os.path.join(sub, f"*{PERF_ATTRIBUTION_FILE}"))):
                if q not in perf_paths:
                    perf_paths.append(q)
            for q in sorted(glob.glob(
                    os.path.join(sub, f"*{WEIGHT_SWAPS_FILE}"))):
                if q not in weights_paths:
                    weights_paths.append(q)
        if router_stats_path is None:
            q = os.path.join(run_dir, ROUTER_STATS_FILE)
            router_stats_path = q if os.path.exists(q) else None
        for q in sorted(glob.glob(os.path.join(run_dir, "*alerts.jsonl"))):
            if q not in alerts_paths:
                alerts_paths.append(q)
        for q in sorted(glob.glob(
                os.path.join(run_dir, f"*{AUTOPILOT_ACTIONS_FILE}"))):
            if q not in autopilot_paths:
                autopilot_paths.append(q)
        for q in sorted(glob.glob(
                os.path.join(run_dir, f"*{WEIGHT_SWAPS_FILE}"))):
            if q not in weights_paths:
                weights_paths.append(q)
        p = os.path.join(run_dir, SCALARS_FILE)
        if os.path.exists(p) and p not in scalar_paths:
            scalar_paths.append(p)
        if flight_path is None:
            q = os.path.join(run_dir, FLIGHT_FILE)
            flight_path = q if os.path.exists(q) else None
        if hlo_audit_path is None:
            q = os.path.join(run_dir, HLO_AUDIT_FILE)
            hlo_audit_path = q if os.path.exists(q) else None
        if supervisor_events_path is None:
            q = os.path.join(run_dir, SUPERVISOR_EVENTS_FILE)
            supervisor_events_path = q if os.path.exists(q) else None
        for q in sorted(glob.glob(os.path.join(run_dir, "*trace*.json"))):
            if q not in timeline_paths:
                timeline_paths.append(q)
        for q in sorted(glob.glob(
                os.path.join(run_dir, f"*{TRACE_EVENTS_FILE}"))):
            if q not in trace_paths:
                trace_paths.append(q)
        if serving_stats_path is None:
            q = os.path.join(run_dir, SERVING_STATS_FILE)
            serving_stats_path = q if os.path.exists(q) else None
        if serving_stats_path and serving_stats_path \
                not in serving_stats_paths:
            serving_stats_paths.append(serving_stats_path)
        if compile_ledger_path is None:
            q = os.path.join(run_dir, COMPILE_LEDGER_FILE)
            compile_ledger_path = q if os.path.exists(q) else None
        if memory_breakdown_path is None:
            q = os.path.join(run_dir, MEMORY_BREAKDOWN_FILE)
            memory_breakdown_path = q if os.path.exists(q) else None
        for q in sorted(glob.glob(
                os.path.join(run_dir, f"*{PERF_ATTRIBUTION_FILE}"))):
            if q not in perf_paths:
                perf_paths.append(q)

    scalar_records: List[dict] = []
    for p in scalar_paths:
        scalar_records.extend(_read_scalar_file(p))
    if fleet_scalar_streams:
        # per-replica streams merge into ONE synthetic stream (counters +
        # histogram buckets sum across replicas) — concatenating the raw
        # streams would let one replica's latest snapshot shadow the rest
        from neuronx_distributed_tpu_torch.obs.aggregate import (
            merge_scalar_records,
        )

        scalar_records.extend(merge_scalar_records(fleet_scalar_streams))

    flight = None
    if flight_path and os.path.exists(flight_path):
        flight_doc = read_flight(flight_path)
        flight = {
            "reason": flight_doc["reason"],
            "dumped_at": flight_doc["dumped_at"],
            "steps_recorded": flight_doc["steps_recorded"],
            "num_records": len(flight_doc["records"]),
            "tail": flight_doc["records"][-tail:],
            "warnings": flight_doc["warnings"],
        }

    audits = read_audits(hlo_audit_path) if (
        hlo_audit_path and os.path.exists(hlo_audit_path)) else []

    supervisor = None
    if supervisor_events_path and os.path.exists(supervisor_events_path):
        supervisor = _summarize_supervisor(supervisor_events_path)

    anomalies = list(flight["warnings"]) if flight else []
    histograms = read_histograms(scalar_records)
    host_blocked = _summarize_host_blocked(histograms)
    scalars = _summarize_scalars(scalar_records, frozenset(histograms))
    kvcache = _summarize_kvcache(scalars)
    speculative = _summarize_speculative(scalars)
    fleet = _summarize_fleet(scalars)
    tenancy = _summarize_tenancy(scalars)
    slo = _summarize_slo(scalars, histograms)
    if len(serving_stats_paths) > 1:
        from neuronx_distributed_tpu_torch.obs.aggregate import merge_serving_stats

        stats_records = merge_serving_stats(serving_stats_paths)
    else:
        stats_records = (read_serving_stats(serving_stats_paths[0])
                         if serving_stats_paths
                         and os.path.exists(serving_stats_paths[0]) else [])
    trace = summarize_trace(trace_paths, stats_records)
    alerts_section = summarize_alerts(alerts_paths)
    autopilot_section = summarize_autopilot(autopilot_paths)
    weights_section = summarize_weights(weights_paths)
    if router_stats_path:
        from neuronx_distributed_tpu_torch.obs.aggregate import (
            summarize_router_stats,
        )

        router_stats = summarize_router_stats(router_stats_path)
    else:
        router_stats = None
    if router_stats is not None and fleet is not None:
        fleet = {**fleet, "router_stats": router_stats}
    elif router_stats is not None:
        fleet = {"router_stats": router_stats}
    ledger_records = (read_compile_ledger(compile_ledger_path)
                      if compile_ledger_path
                      and os.path.exists(compile_ledger_path) else [])
    compile_section = _summarize_compile(scalars, ledger_records, histograms)
    breakdown = (read_memory_breakdown(memory_breakdown_path)
                 if memory_breakdown_path
                 and os.path.exists(memory_breakdown_path) else None)
    memory_section = _summarize_memory(scalars, breakdown)
    # fleet runs: per-replica attribution streams merge additively
    # (device-time, flops and bytes sum; the rollup is rebuilt)
    from neuronx_distributed_tpu_torch.obs.aggregate import merge_perf_files

    perf_section = summarize_perf(merge_perf_files(perf_paths))
    report = {
        "schema": OBS_REPORT_SCHEMA,
        "generated_at": time.time(),
        "run_dir": run_dir,
        "sources": {
            "scalars": scalar_paths,
            "flight": flight_path,
            "hlo_audit": hlo_audit_path,
            "timelines": timeline_paths,
            "supervisor_events": supervisor_events_path,
            "traces": trace_paths,
            "serving_stats": serving_stats_paths,
            "compile_ledger": compile_ledger_path,
            "memory_breakdown": memory_breakdown_path,
            "alerts": alerts_paths,
            "router_stats": router_stats_path,
            "perf": perf_paths,
            "autopilot": autopilot_paths,
            "weights": weights_paths,
            "fleet_replicas": fleet_replicas,
        },
        "scalars": scalars,
        "histograms": histograms,
        "flight": flight,
        "anomalies": anomalies,
        "hlo_audits": audits,
        "timeline": _summarize_timeline(timeline_paths),
        "supervisor": supervisor,
        "trace": trace,
        "compile": compile_section,
        "memory": memory_section,
        "alerts": alerts_section,
        "autopilot": autopilot_section,
        "weights": weights_section,
        "perf": perf_section,
        "health": {
            "anomaly_count": len(anomalies),
            "host_blocked": host_blocked,
            "kvcache": kvcache,
            "speculative": speculative,
            "fleet": fleet,
            "tenancy": tenancy,
            "slo": slo,
            # slim rollups only — the full per-family/per-subsystem tables
            # live once, at the top-level "compile"/"memory" sections
            "compile": (None if compile_section is None else {
                "compiles": compile_section["compiles"],
                "storms": compile_section["storms"],
                "thrash_warnings": compile_section["thrash_warnings"]}),
            "memory": (None if memory_section is None else {
                "total_bytes": memory_section["total_bytes"],
                "peak_total_bytes": memory_section["peak_total_bytes"]}),
            # slim alerts rollup — the full per-rule table lives once, at
            # the top-level "alerts" section
            "alerts": (None if alerts_section is None else {
                "firing": alerts_section["firing"],
                "worst_severity": alerts_section["worst_severity"],
                "rules_fired": sum(
                    1 for agg in alerts_section["rules"].values()
                    if agg["fired"])}),
            # slim autopilot rollup — the full action table lives once,
            # at the top-level "autopilot" section
            "autopilot": (None if autopilot_section is None else {
                "actions": autopilot_section["actions"],
                "rate_per_s": autopilot_section["rate_per_s"],
                "last_action": (autopilot_section["last"]["action"]
                                if autopilot_section["last"] else None)}),
            # slim weights rollup — the full per-replica version table
            # lives once, at the top-level "weights" section
            "weights": (None if weights_section is None else {
                "swaps": weights_section["swaps"],
                "failures": weights_section["failures"],
                "monotonic": weights_section["monotonic"]}),
            # slim perf rollup — the full per-family roofline table lives
            # once, at the top-level "perf" section
            "perf": (None if perf_section is None
                     or perf_section.get("rollup") is None else {
                         "mfu": perf_section["rollup"]["mfu"],
                         "mbu": perf_section["rollup"]["mbu"],
                         "pct_roofline":
                             perf_section["rollup"]["pct_roofline"],
                         "bound": perf_section["rollup"]["bound"]}),
            "total_collective_count": sum(
                a.get("total_collective_count", 0) for a in audits),
            "total_collective_bytes": sum(
                a.get("total_collective_bytes", 0) for a in audits),
            "restarts": supervisor["restarts"] if supervisor else 0,
        },
    }
    return report


def render_markdown(report: dict) -> str:
    """Human-readable rendering of :func:`build_report` output."""
    lines = ["# Run report", ""]
    h = report["health"]
    alerts = report.get("alerts")
    if alerts:
        worst = alerts["worst_severity"] or "none"
        fired = sum(agg["fired"] for agg in alerts["rules"].values())
        lines.append(
            f"- alerts: **{alerts['firing']} firing** (worst severity "
            f"{worst}); {fired} firing edge(s) across "
            f"{len(alerts['rules'])} rule(s)")
    ap = report.get("autopilot")
    if ap:
        rate = (f"{ap['rate_per_s'] * 60.0:.2f}/min"
                if ap["rate_per_s"] is not None else "n/a")
        last = (f"; last `{ap['last']['action']}` on "
                f"`{ap['last']['trigger']}`" if ap["last"] else "")
        lines.append(
            f"- autopilot: **{ap['actions']} action(s)** across "
            f"{len(ap['triggers'])} trigger(s) "
            f"(rate {rate} over {ap['span_s']:.1f}s){last}")
    wt = report.get("weights")
    if wt:
        mono = ("monotonic" if wt["monotonic"]
                else "**NON-MONOTONIC version order**")
        ver = (f"; now at version {wt['last']['version']} "
               f"({wt['last']['source']})" if wt["last"] else "")
        ms = (f", {wt['swap_ms_mean']:.1f} ms mean swap"
              if wt["swap_ms_mean"] is not None else "")
        lines.append(
            f"- weights: **{wt['swaps']} live swap(s)**, "
            f"{wt['failures']} failure(s) across "
            f"{len(wt['replicas'])} engine(s) ({mono}{ms}){ver}")
    lines.append(f"- anomalies: **{h['anomaly_count']}**")
    lines.append(f"- supervisor restarts: **{h.get('restarts', 0)}**")
    lines.append(f"- collectives across audited programs: "
                 f"{h['total_collective_count']} ops, "
                 f"{h['total_collective_bytes']:,} bytes")
    for sys_name, hb in sorted(h.get("host_blocked", {}).items()):
        frac = f", {hb['frac']:.1%} of step time" if "frac" in hb else ""
        lines.append(
            f"- {sys_name} host-blocked: {hb['blocked_ms_total']:.1f} ms "
            f"across {hb['fetches']:.0f} fetches{frac}")
    kv = h.get("kvcache")
    if kv:
        hit = (f"{kv['prefix_hit_rate']:.1%} prefix hit rate "
               f"({kv['prefix_hits']:.0f}/{kv['prefix_hits'] + kv['prefix_misses']:.0f} pages)"
               if kv["prefix_hit_rate"] is not None else "no prefix lookups")
        gather = (f"{kv.get('gather_bytes', 0.0):,.0f} gather-path bytes"
                  if kv.get("gather_bytes") else
                  "0 gather-path bytes (kernel decode)")
        lines.append(
            f"- kv cache: {kv['pages_in_use']:.0f}/{kv['pages_total']:.0f} "
            f"pages in use ({kv['occupancy']:.1%}, "
            f"{kv['pages_cached']:.0f} held by the prefix cache); {hit}; "
            f"{kv['prefills_skipped']:.0f} prefills skipped, "
            f"{kv['evictions']:.0f} evictions, "
            f"{kv['cow_copies']:.0f} cow copies; {gather}")
    fleet = h.get("fleet")
    if fleet and "router_stats" in fleet and fleet["router_stats"]:
        rstats = fleet["router_stats"]
        states = ", ".join(f"{k} {v}" for k, v in rstats["by_state"].items())
        lines.append(
            f"- router stats: {rstats['records']} terminal record(s) "
            f"({states}); {rstats['requeued']} survived a failover across "
            f"replicas {rstats['replicas_seen']}")
    if fleet and "dispatched" in fleet:
        aff = (f"{fleet['affinity_hit_rate']:.1%} affinity hits "
               f"({fleet['affinity_hits']:.0f}/"
               f"{fleet['affinity_hits'] + fleet['affinity_misses']:.0f})"
               if fleet["affinity_hit_rate"] is not None
               else "no fingerprinted dispatches")
        pool = (f", pool prefix hit rate {fleet['fleet_prefix_hit_rate']:.1%}"
                if fleet["fleet_prefix_hit_rate"] is not None else "")
        lines.append(
            f"- fleet: {fleet['replicas_alive']:.0f} replica(s) in rotation; "
            f"{fleet['dispatched']:.0f} dispatches, "
            f"{fleet['requeued']:.0f} requeued over "
            f"{fleet['failovers']:.0f} failover(s) "
            f"({fleet['restarts']:.0f} restarts, "
            f"{fleet['retired']:.0f} retired); {aff}{pool}")
    ten = h.get("tenancy")
    if ten:
        hit = (f"{ten['adapter_hit_rate']:.1%} adapter hit rate "
               f"({ten['adapter_hits']:.0f} hits/"
               f"{ten['adapter_loads']:.0f} loads)"
               if ten["adapter_hit_rate"] is not None else "no adapter pins")
        quant = (f"; {ten['quant_pages']:.0f} int8 page writes"
                 if ten["quant_pages"] else "")
        lines.append(
            f"- tenancy: {ten['adapters_resident']:.0f} adapter(s) resident "
            f"({ten['adapter_pool_pages_in_use']:.0f} pool pages); {hit}; "
            f"{ten['adapter_evictions']:.0f} evictions{quant}")
    slo = h.get("slo")
    if slo:
        parts = []
        for cls, c in sorted(slo.get("classes", {}).items()):
            tt = (f"ttft p99 ~{c['ttft_p99_ms']:.0f}ms"
                  if c["ttft_p99_ms"] is not None else "ttft p99 n/a")
            it = (f"inter-token p99 ~{c['intertoken_p99_ms']:.0f}ms"
                  if c["intertoken_p99_ms"] is not None
                  else "inter-token p99 n/a")
            parts.append(f"{cls}: {tt}, {it}")
        tail = ("; ".join(parts)) if parts else "no per-class latencies"
        lines.append(
            f"- slo: {slo['preemptions']:.0f} preemption(s), "
            f"{slo['shed']:.0f} shed at admission, "
            f"{slo['expired_before_prefill']:.0f} expired pre-prefill, "
            f"{slo['prefill_chunks']:.0f} prefill chunk(s); {tail}")
    spec = h.get("speculative")
    if spec:
        rate = (f"{spec['acceptance_rate']:.1%} acceptance"
                if spec["acceptance_rate"] is not None else "no proposals")
        tps = (f"{spec['tokens_per_round']:.2f} tokens/step"
               if spec["tokens_per_round"] is not None else "no rounds")
        lines.append(
            f"- speculative: {tps} over {spec['rounds']:.0f} rounds; {rate} "
            f"({spec['accepted']:.0f}/{spec['proposed']:.0f} draft tokens)")
    comp = report.get("compile")
    if comp:
        cache = comp.get("cache") or {}
        hit = (f"{cache['hit_rate']:.1%} cache hit rate"
               if cache.get("hit_rate") is not None else "no cache lookups")
        lines.append(
            f"- compile: {comp['compiles']:.0f} compile(s) "
            f"({comp.get('cold_ms_total', 0):,.0f} ms total wall); "
            f"**{comp['storms']:.0f} storm(s)** after warmup, "
            f"{comp['thrash_warnings']:.0f} thrash warning(s), "
            f"{comp.get('evictions', 0):.0f} eviction(s); {hit}")
    perf = report.get("perf")
    if perf and perf.get("rollup"):
        roll = perf["rollup"]
        ceiling = (f"; tokens/s ceiling {roll['toks_per_s_ceiling']:,.0f}"
                   if roll.get("toks_per_s_ceiling") else "")
        lines.append(
            f"- perf: MFU {roll['mfu']:.1%}, MBU {roll['mbu']:.1%}, "
            f"{roll['pct_roofline']:.1%} of roofline "
            f"({roll['bound']}-bound on {perf['device']}){ceiling}")
    memh = report.get("memory")
    if memh:
        top = ", ".join(f"{name} {nbytes / 2**20:,.1f}MiB"
                        for name, nbytes in memh.get("top", [])[:3])
        dev = memh.get("device") or {}
        used = dev.get("device_bytes_in_use")
        device = (f"; device {used / 2**20:,.1f}MiB in use"
                  if used is not None else "")
        lines.append(
            f"- memory: {memh['total_bytes'] / 2**20:,.1f} MiB accounted "
            f"(peak {memh['peak_total_bytes'] / 2**20:,.1f} MiB); "
            f"top holders: {top or 'none'}{device}")
    lines.append("")

    sup = report.get("supervisor")
    if sup:
        lines += ["## Supervisor", "",
                  f"{sup['attempts']} attempt(s), {sup['restarts']} "
                  f"restart(s); "
                  + ("succeeded" if sup["succeeded"] else
                     ("gave up" if sup["gave_up"] else
                      f"final rc {sup['final_rc']}"))]
        if sup["crash_causes"]:
            lines.append(f"- crash causes: {', '.join(sup['crash_causes'])}")
        if sup["mean_recover_s"] is not None:
            lines.append(f"- time to recover: mean {sup['mean_recover_s']}s "
                         f"({sup['recover_s']})")
        lines.append("")

    if report["scalars"]:
        lines += ["## Step metrics", "",
                  "| tag | count | last | min | max | mean |",
                  "|---|---|---|---|---|---|"]
        for tag, s in sorted(report["scalars"].items()):
            lines.append(
                f"| {tag} | {s['count']} | {s['last']:.6g} | {s['min']:.6g} "
                f"| {s['max']:.6g} | {s['mean']:.6g} |")
        lines.append("")

    if report["histograms"]:
        lines += ["## Histograms", ""]
        for name, hist in sorted(report["histograms"].items()):
            lines.append(f"### {name}")
            lines.append(f"count {hist['count']:.0f}, sum {hist['sum']:.6g}, "
                         f"mean {hist['mean']:.6g}")
            lines.append("")
            lines.append("| le | cumulative |")
            lines.append("|---|---|")
            for le, cum in hist["buckets"].items():
                lines.append(f"| {le} | {cum:.0f} |")
            lines.append("")

    if report["flight"]:
        fl = report["flight"]
        lines += ["## Flight recorder", "",
                  f"dump reason `{fl['reason']}`, {fl['num_records']} records "
                  f"held of {fl['steps_recorded']} steps recorded", ""]
        for rec in fl["tail"]:
            lines.append(f"- step {rec['step']}: " + ", ".join(
                f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in rec.items() if k not in ("step", "time")))
        lines.append("")

    alerts = report.get("alerts")
    if alerts and alerts["rules"]:
        lines += ["## Alerts", "",
                  "| rule | severity | fired | resolved | firing | "
                  "time firing (s) |",
                  "|---|---|---|---|---|---|"]
        for name, agg in sorted(
                alerts["rules"].items(),
                key=lambda kv: -kv[1]["time_firing_s"]):
            lines.append(
                f"| {name} | {agg['severity']} | {agg['fired']} | "
                f"{agg['resolved']} | {agg['firing']} | "
                f"{agg['time_firing_s']:.3f} |")
        lines.append("")

    ap = report.get("autopilot")
    if ap and ap["actions"]:
        lines += ["## Autopilot actions", "",
                  "| mono | action | trigger | replica | mode | "
                  "budget left |",
                  "|---|---|---|---|---|---|"]
        for r in ap["tail"]:
            lines.append(
                f"| {r['mono']:.3f} | {r['action']} | {r['trigger']} | "
                f"{r['replica'] if r['replica'] >= 0 else '-'} | "
                f"{r['mode']} | {r['budget_remaining']} |")
        lines += ["", "Per-trigger rollup:", "",
                  "| trigger | actions | by action | replicas |",
                  "|---|---|---|---|"]
        for name, trig in ap["triggers"].items():
            by = ", ".join(f"{k} {v}" for k, v in trig["by_action"].items())
            reps = ",".join(str(r) for r in trig["replicas"]) or "-"
            lines.append(
                f"| {name} | {trig['actions']} | {by} | {reps} |")
        lines.append("")
    elif ap:
        lines += ["## Autopilot actions", "",
                  "Autopilot was on and never had to act.", ""]

    if report["anomalies"]:
        lines += ["## Anomalies", ""]
        for w in report["anomalies"]:
            lines.append(f"- step {w['step']} [{w['detector']}]: {w['message']}")
        lines.append("")

    if report["hlo_audits"]:
        lines += ["## HLO communication audits", ""]
        for a in report["hlo_audits"]:
            counts = {k: v for k, v in a["collective_counts"].items() if v}
            lines.append(
                f"- `{a['name']}`: {counts or 'no collectives'}; "
                f"{a['total_collective_bytes']:,} bytes")
        lines.append("")

    comp = report.get("compile")
    if comp and comp.get("families"):
        lines += ["## Compile ledger", "",
                  "| family | compiles | cold ms | distinct keys | "
                  "evictions |",
                  "|---|---|---|---|---|"]
        for name, f in sorted(comp["families"].items()):
            lines.append(
                f"| {name} | {f['compiles']} | {f['cold_ms']:.1f} | "
                f"{f['distinct_keys']} | {f['evictions']} |")
        lines.append("")

    perf = report.get("perf")
    if perf and perf.get("families"):
        lines += [f"## Roofline attribution ({perf['device']})", "",
                  "| family | calls | device ms | intensity | bound | "
                  "% roofline | MFU | MBU |",
                  "|---|---|---|---|---|---|---|---|"]
        for name, f in sorted(perf["families"].items(),
                              key=lambda kv: -kv[1]["device_ms"]):
            ai = (f"{f['arithmetic_intensity']:.1f}"
                  if f["arithmetic_intensity"] is not None else "n/a")
            lines.append(
                f"| {name} | {f['calls']:.0f} | {f['device_ms']:.1f} | "
                f"{ai} | {f['bound']} | {f['pct_roofline']:.1%} | "
                f"{f['mfu']:.1%} | {f['mbu']:.1%} |")
        if perf.get("top_time_eaters"):
            lines += ["", "Top time-eaters: "
                      + ", ".join(perf["top_time_eaters"])]
        lines.append("")

    memr = report.get("memory")
    if memr and memr.get("subsystems"):
        lines += ["## Memory ledger", "",
                  "| subsystem | bytes | peak bytes |",
                  "|---|---|---|"]
        for name, s in sorted(memr["subsystems"].items()):
            lines.append(f"| {name} | {s.get('bytes', 0):,.0f} | "
                         f"{s.get('peak_bytes', 0):,.0f} |")
        lines.append("")

    trace = report.get("trace")
    if trace:
        lines += ["## Request traces", "",
                  f"{trace['spans']} spans across {trace['requests']} "
                  f"request(s) ({trace['files']} trace file(s)); aggregate "
                  "phase time: "
                  + ", ".join(f"{k} {v:.1f} ms"
                              for k, v in trace["by_phase_ms"].items()), ""]
        if trace["slowest"]:
            lines += ["Slowest requests (per-request waterfall):", "",
                      "| request | state | total ms | queue | prefill | "
                      "decode | preempted | migrate | hops | replicas |",
                      "|---|---|---|---|---|---|---|---|---|---|"]
            for e in trace["slowest"]:
                check = (f" (stats {e['stats_total_ms']:.1f})"
                         if e.get("stats_total_ms") is not None else "")
                lines.append(
                    f"| {e['request_id']} | {e['state'] or '?'} | "
                    f"{e['total_ms']:.1f}{check} | {e['queue_ms']:.1f} | "
                    f"{e['prefill_ms']:.1f} | {e['decode_ms']:.1f} | "
                    f"{e['preempted_ms']:.1f} | "
                    f"{e.get('migrate_ms', 0.0):.1f} | {e['hops']} | "
                    f"{','.join(str(r) for r in e['replicas'])} |")
            lines.append("")

    tl = report["timeline"]
    if tl["events"] or tl["instants"]:
        lines += ["## Timeline", "",
                  f"{tl['events']} events, {tl['instants']} instants "
                  f"across {tl['files']} file(s)"]
        for name, ms in tl["total_ms_by_name"].items():
            lines.append(f"- {name}: {ms:.1f} ms total")
        lines.append("")
    return "\n".join(lines)


_CLI_DOC = """Merge a run's telemetry artifacts into one summary: a JSON
document on stdout (or --out) and an optional markdown rendering.

    python -m neuronx_distributed_tpu_torch.obs.report RUN_DIR
    python -m neuronx_distributed_tpu_torch.obs.report RUN_DIR \\
        --out report.json --markdown report.md
    python -m neuronx_distributed_tpu_torch.obs.report --compare RUN_A RUN_B

--compare diffs two runs' resource ledgers, alerts, perf attribution,
autopilot actions and weight swaps, and exits 1 when run B regressed past
the thresholds."""


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m neuronx_distributed_tpu_torch.obs.report",
        description=_CLI_DOC,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("run_dir_pos", nargs="?", default=None, metavar="RUN_DIR",
                   help="obs output dir (the same as --run-dir)")
    p.add_argument("--run-dir", default=None,
                   help="obs output dir (scalars.jsonl / flight_record.json / "
                        "hlo_audit.jsonl / *trace*.json inside it)")
    p.add_argument("--scalar-dir", action="append", default=[],
                   help="extra dir holding a scalars.jsonl (repeatable)")
    p.add_argument("--scalars", action="append", default=[],
                   help="extra scalars.jsonl file (repeatable)")
    p.add_argument("--flight", default=None, help="flight_record.json path")
    p.add_argument("--hlo-audit", default=None, help="hlo_audit.jsonl path")
    p.add_argument("--timeline", action="append", default=[],
                   help="Chrome-trace timeline file (repeatable)")
    p.add_argument("--supervisor-events", default=None,
                   help="supervisor_events.jsonl path (restarts / crash "
                        "causes / time-to-recover; auto-detected in "
                        "--run-dir)")
    p.add_argument("--trace", action="append", default=[],
                   help="trace_events.jsonl file (repeatable; auto-detected "
                        "in --run-dir) — builds the per-request waterfall "
                        "section (queue/prefill/decode/preempted ms, top-5 "
                        "slowest with their span breakdown)")
    p.add_argument("--serving-stats", default=None,
                   help="serving_stats.jsonl path (v4 or v5; auto-detected "
                        "in --run-dir) — links trace waterfalls to their "
                        "terminal records via trace_id")
    p.add_argument("--compile-ledger", default=None,
                   help="compile_ledger.jsonl path (auto-detected in "
                        "--run-dir) — builds the compile health section")
    p.add_argument("--memory-breakdown", default=None,
                   help="memory_breakdown.json path (auto-detected in "
                        "--run-dir) — builds the memory health section")
    p.add_argument("--alerts", action="append", default=[],
                   help="alerts.jsonl file (repeatable; *alerts.jsonl "
                        "auto-detected in --run-dir and its replica "
                        "subdirs) — builds the alerts section (firing "
                        "count, worst severity, per-rule time-firing)")
    p.add_argument("--perf", action="append", default=[],
                   help="perf_attribution.jsonl file (repeatable; "
                        "*perf_attribution.jsonl auto-detected in --run-dir "
                        "and its replica subdirs) — builds the per-family "
                        "roofline attribution section (device time, MFU/MBU, "
                        "compute-/memory-bound, tokens/s ceiling)")
    p.add_argument("--router-stats", default=None,
                   help="router_stats.jsonl path (auto-detected in "
                        "--run-dir) — rolls fleet terminal records into "
                        "the fleet section")
    p.add_argument("--autopilot", action="append", default=[],
                   help="autopilot_actions.jsonl file (repeatable; "
                        "*autopilot_actions.jsonl auto-detected in "
                        "--run-dir) — builds the autopilot section "
                        "(action table, per-trigger rollup, action rate)")
    p.add_argument("--weight-swaps", action="append", default=[],
                   help="weight_swaps.jsonl file (repeatable; "
                        "*weight_swaps.jsonl auto-detected in --run-dir "
                        "and its replica subdirs) — builds the weights "
                        "section (live-swap/failure counts by source, "
                        "per-replica version table, monotonicity check)")
    p.add_argument("--compare", nargs=2, metavar=("RUN_A", "RUN_B"),
                   default=None,
                   help="compile/memory regression diff between two run "
                        "dirs; nonzero rc when B regressed past the "
                        "thresholds")
    p.add_argument("--compile-regress-threshold", type=float, default=0.0,
                   help="--compare: allowed fractional growth in compile "
                        "count before rc 1 (default 0: any extra compile "
                        "regresses)")
    p.add_argument("--mem-regress-threshold", type=float, default=0.05,
                   help="--compare: allowed fractional growth in any "
                        "subsystem's peak bytes before rc 1 (default 5%%)")
    p.add_argument("--mfu-regress-threshold", type=float, default=0.05,
                   help="--compare: allowed fractional DROP in run B's "
                        "rollup MFU below A's before rc 1 (default 5%%; "
                        "only applies when both runs carry perf "
                        "attribution)")
    p.add_argument("--autopilot-regress-threshold", type=float, default=0.5,
                   help="--compare: allowed fractional growth in run B's "
                        "autopilot action rate over A's before rc 1 "
                        "(default 50%%; actions appearing in B when A "
                        "never acted regress threshold-free; only applies "
                        "when both runs carry autopilot action ledgers)")
    p.add_argument("--tail", type=int, default=10,
                   help="flight-record tail length in the summary")
    p.add_argument("--out", default=None, help="write JSON here (default stdout)")
    p.add_argument("--markdown", default=None, help="also write a markdown rendering")
    args = p.parse_args(argv)
    if args.run_dir_pos is not None:
        if args.run_dir not in (None, args.run_dir_pos):
            p.error("RUN_DIR and --run-dir name different directories")
        args.run_dir = args.run_dir_pos

    if args.compare:
        diff = compare_resources(
            args.compare[0], args.compare[1],
            compile_threshold=args.compile_regress_threshold,
            mem_threshold=args.mem_regress_threshold,
            mfu_threshold=args.mfu_regress_threshold,
            autopilot_threshold=args.autopilot_regress_threshold)
        if args.out:
            doc = {k: diff[k] for k in ("a", "b", "compile", "memory",
                                        "alerts", "perf", "autopilot",
                                        "weights", "regressions",
                                        "regressed")}
            with open(args.out, "w") as f:
                f.write(json.dumps(doc, indent=2) + "\n")
        if args.markdown:
            with open(args.markdown, "w") as f:
                f.write(diff["markdown"])
        print(diff["markdown"])
        if diff["regressed"]:
            for r in diff["regressions"]:
                print(f"obs_report: REGRESSION: {r}", file=sys.stderr)
            return 1
        return 0

    if not (args.run_dir or args.scalar_dir or args.scalars or args.flight
            or args.hlo_audit or args.timeline or args.supervisor_events
            or args.trace or args.compile_ledger or args.memory_breakdown
            or args.alerts or args.perf or args.router_stats
            or args.autopilot or args.weight_swaps):
        p.error("nothing to report on: pass --run-dir or explicit artifact paths")

    scalar_paths = list(args.scalars)
    for d in args.scalar_dir:
        q = os.path.join(d, "scalars.jsonl")
        if os.path.exists(q):
            scalar_paths.append(q)
        else:
            print(f"obs_report: no scalars.jsonl in {d}", file=sys.stderr)

    report = build_report(
        run_dir=args.run_dir,
        scalar_paths=scalar_paths,
        flight_path=args.flight,
        hlo_audit_path=args.hlo_audit,
        timeline_paths=args.timeline,
        supervisor_events_path=args.supervisor_events,
        trace_paths=args.trace,
        serving_stats_path=args.serving_stats,
        compile_ledger_path=args.compile_ledger,
        memory_breakdown_path=args.memory_breakdown,
        alerts_paths=args.alerts,
        router_stats_path=args.router_stats,
        perf_paths=args.perf,
        autopilot_paths=args.autopilot,
        weights_paths=args.weight_swaps,
        tail=args.tail,
    )
    validate_record("obs_report", report)  # the emitter honors its own schema

    text = json.dumps(report, indent=2, sort_keys=False)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    else:
        print(text)
    if args.markdown:
        with open(args.markdown, "w") as f:
            f.write(render_markdown(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
