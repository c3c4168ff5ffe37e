"""Checked-in schemas for every JSONL/JSON artifact the framework emits (a
copy of ``neuronx_distributed_tpu/obs/schemas.py``, stdlib only, kept
equal to it: the port writes the same formats, so the JAX package's
``tools/obs_report.py`` and dashboards read the port's run directories).

Downstream tooling parses these files; this module is the contract that
keeps the formats stable.  The list holds every kind, including those
whose writers the port has not reached yet (compile ledger, alerts,
router stats, weight swaps): the contract is one list.  A schema here is
deliberately a floor, not a straitjacket: records may carry EXTRA keys
(forward-compatible growth), but the required keys and their types may
never change without a schema-version bump.
``tests/test_torch_artifact_schemas.py`` re-validates the port's emitters
against this list and holds it equal to the JAX package's.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable

_NUM = (int, float)

# kind -> {field: type-or-tuple-of-types}; every field is required, extra
# fields are allowed.
SCHEMAS: Dict[str, Dict[str, Any]] = {
    # one line of scalars.jsonl — written by trainer.scalar_log.ScalarWriter
    # AND obs.registry.MetricRegistry.dump_jsonl
    "scalars": {"step": int, "tag": str, "value": _NUM, "time": _NUM},
    # flight_record.json top-level document (obs.flight.FlightRecorder.dump)
    "flight_record": {
        "schema": str, "reason": str, "dumped_at": _NUM, "capacity": int,
        "steps_recorded": int, "records": list, "warnings": list,
    },
    # one entry of flight_record.json["records"]
    "flight_step": {"step": int, "time": _NUM},
    # one entry of flight_record.json["warnings"] (anomaly detectors)
    "anomaly": {"step": int, "detector": str, "message": str, "time": _NUM},
    # one line of hlo_audit.jsonl (obs.hlo_audit.comm_audit)
    "hlo_audit": {
        "schema": str, "name": str, "time": _NUM,
        "collective_counts": dict, "collective_bytes": dict,
        "total_collective_count": int, "total_collective_bytes": int,
    },
    # one line of docs/tpu_watch_results.jsonl (tools/tpu_watch.py append)
    "tpu_watch": {"ts": str, "kind": str},
    # one line of trace_events.jsonl (obs.tracing.Tracer.export_jsonl) —
    # one record per finished span: the request-lifecycle distributed
    # trace.  request_id is the fleet-global id (-1 for batch-level spans
    # like one engine decode step), replica the producing replica (-1
    # off-fleet), parent_id the enclosing span (null at a trace root).
    # Every span carries BOTH clocks: ts (wall, shared epoch) and mono
    # (monotonic start == t_start; t_start/t_end are the span's interval
    # on the monotonic clock) so cross-replica merges sort correctly
    # under wall-clock skew.  attrs is free-form span detail (phase
    # boundaries, token ranges, hop counts, ...).
    "trace_event": {
        "schema": str, "name": str, "span_id": int,
        "parent_id": (int, type(None)), "request_id": int, "replica": int,
        "t_start": _NUM, "t_end": _NUM, "ts": _NUM, "mono": _NUM,
        "attrs": dict,
    },
    # one line of serving_stats.jsonl (serving.engine.ServingEngine) —
    # one record per TERMINAL request; ttft_ms is null for requests that
    # never produced a token (cancelled/timed out while queued).  v2 adds
    # the speculative-decoding accounting: draft tokens proposed/accepted
    # for the request and its acceptance rate (null when the engine never
    # speculated for it — including every non-spec engine).  v3 adds the
    # tenancy accounting: which LoRA adapter served the request (0 = the
    # base model — every request off multi-adapter mode).  v4 adds the SLO
    # scheduling accounting: the priority class, the deadline budget (null
    # = none), the queue wait, how many times a higher tier preempted the
    # request's slot, and — for requests the engine shed before prefill —
    # the shed reason (null otherwise)
    "serving_stats": {
        "schema": str, "time": _NUM, "request_id": int, "state": str,
        "finish_reason": (str, type(None)), "prompt_len": int,
        "new_tokens": int, "queue_ms": _NUM,
        "ttft_ms": (int, float, type(None)), "total_ms": _NUM,
        "spec_proposed": int, "spec_accepted": int,
        "acceptance_rate": (int, float, type(None)),
        "adapter_id": int,
        "priority": str,
        "deadline_s": (int, float, type(None)),
        "queue_wait_ms": _NUM,
        "preemptions": int,
        "shed_reason": (str, type(None)),
        # v5 (tracing PR): second monotonic stamp pairing the wall `time`,
        # per-request work decomposition, and the trace_events.jsonl
        # linkage (null when the engine ran without a tracer).  v4 records
        # lack these five fields; obs.report reads them with defaults.
        "mono": _NUM,
        "decode_steps": int,
        "prefill_chunks": int,
        "preempted_ms": _NUM,
        "trace_id": (int, type(None)),
        # v6 (live-weights PR): the weights_version whose params decoded
        # the request's LAST committed token (0 = the process-start
        # weights, never swapped) — a mid-swap request's output is
        # attributable to the version that actually produced it.  v5
        # records lack the field; obs.report reads it with default 0.
        "weights_version": int,
    },
    # one line of router_stats.jsonl (serving.fleet.router.FleetRouter) —
    # one record per TERMINAL request across the whole fleet: which replica
    # finished it, how many times it was dispatched/requeued (requeues > 0
    # means it survived a failover), how many leading prompt pages the
    # affinity shadow matched at dispatch, and the routing policy in force.
    # replica is -1 for requests that never reached an engine (router-held
    # cancellation / total capacity loss).  v2 (disagg PR) adds the
    # disaggregation evidence: migrations counts KV-page migration hops
    # (export/import moves between replica pools — distinct from requeues,
    # which re-prefill), role is the steering role of the replica that
    # finished the request ("prefill"/"decode"/"mixed"; null for
    # router-held terminals).
    "router_stats": {
        "schema": str, "time": _NUM, "request_id": int, "client_id": int,
        "replica": int, "state": str, "finish_reason": (str, type(None)),
        "dispatches": int, "requeues": int, "migrations": int,
        "role": (str, type(None)), "affinity_pages": int,
        "new_tokens": int, "policy": str,
    },
    # one line of supervisor_events.jsonl (resilience.supervisor.Supervisor)
    # — events: start / exit / restart / giveup / success; extra keys carry
    # the event payload (pid, rc, cause, backoff_s, resume_tag, ...)
    "supervisor_event": {
        "schema": str, "time": _NUM, "event": str, "attempt": int,
    },
    # one line of compile_ledger.jsonl (obs.compile_ledger.CompileLedger)
    # — events: "compile" (one program compiled: family is the program
    # family, key the shape/static key, kind "aot" | "jit", wall_ms the
    # measured compile wall time or null when only the event is known),
    # "eviction" (an LRU dropped a compiled program — key is the EVICTED
    # key, so thrash is attributable), "thrash" (a family's distinct keys
    # exceeded its cache capacity), "warmup_done".  after_warmup marks
    # compile rows recorded past declare_warmup_done — each one is a
    # compile_storm.  Compile rows may carry extra cost/memory stats
    # (flops, bytes_accessed, *_size_in_bytes, signature).
    "compile_ledger": {
        "schema": str, "time": _NUM, "mono": _NUM, "event": str,
        "family": str, "key": str, "kind": str,
        "wall_ms": (int, float, type(None)), "after_warmup": bool,
    },
    # one line of alerts.jsonl (obs.health.HealthMonitor) — one record per
    # alert EDGE (state "firing" | "resolved"; steady states are never
    # re-emitted).  rule names the rule (or externally-driven condition,
    # e.g. replica_down), window labels a burn-rate rule's window pair
    # (null for point rules), observed/bound carry the evidence at the
    # edge (null when the edge is event-driven), replica tags the emitting
    # monitor (-1 = fleet/off-fleet).  Extra keys carry rule detail
    # (duration_s on resolves, key/cause on conditions, slow_ewma, ...).
    "alert": {
        "schema": str, "time": _NUM, "mono": _NUM, "rule": str,
        "severity": str, "state": str, "window": (str, type(None)),
        "observed": (int, float, type(None)),
        "bound": (int, float, type(None)), "replica": int,
    },
    # one line of autopilot_actions.jsonl (serving.fleet.autopilot
    # .Autopilot) — one record per remediation ACTION the controller took
    # (evaluations that act on nothing emit nothing).  action is the kind
    # ("scale_out" | "scale_in" | "restart" | "tighten" | "relax" |
    # "rebalance"), trigger the alert rule (or synthetic trigger: "idle",
    # "queue_mix", "burn_resolved") that drove it, edge the triggering
    # alert's firing view (null for synthetic triggers), replica the
    # acted-on replica (-1 for fleet-wide actions like admission
    # tightening), mode the controller mode at emission ("auto" always,
    # today — page_only emits nothing), detail free-form action payload
    # (new fleet size, shed scale, target role, ...), budget_remaining
    # the global action budget left in the rolling window AFTER this
    # action — the flap-bound audit trail.
    "autopilot_action": {
        "schema": str, "time": _NUM, "mono": _NUM, "action": str,
        "trigger": str, "mode": str, "replica": int, "detail": dict,
        "edge": (dict, type(None)), "budget_remaining": int,
    },
    # one line of weight_swaps.jsonl (weights.swapper.WeightSwapper) — one
    # record per swap ATTEMPT on one engine.  event is "swap" (committed)
    # | "swap_failed" (validation / chaos / load failure — the old weights
    # kept serving); version is the monotonic weights_version the engine
    # serves AFTER the attempt (unchanged on failure), source "memory"
    # (in-process param pytree, the rollout→train→swap path) | "checkpoint"
    # (orbax round-trip), swap_ms the load+validate+install wall time
    # (null when the attempt died before the clock mattered), error the
    # failure detail (null on success), replica the owning fleet replica
    # (-1 off-fleet).
    "weight_swap": {
        "schema": str, "time": _NUM, "mono": _NUM, "event": str,
        "version": int, "source": str, "ok": bool,
        "swap_ms": (int, float, type(None)),
        "error": (str, type(None)), "replica": int,
    },
    # memory_breakdown.json (obs.memory_ledger.MemoryLedger.dump) — the
    # per-subsystem device-byte breakdown, dumped on demand and on
    # RESOURCE_EXHAUSTED (reason "oom:<ExcType>"); "top" names the biggest
    # holders, "device" the backend's memory_stats() truth when available
    "memory_breakdown": {
        "schema": str, "time": _NUM, "reason": str, "subsystems": dict,
        "total_bytes": _NUM, "peak_total_bytes": _NUM,
        "device": (dict, type(None)), "programs": dict, "top": list,
    },
    # one line of perf_attribution.jsonl (obs.perf.PerfAttribution.dump)
    # — one record per phase-fn family plus a "_total" rollup: device
    # wall-time + call counts joined with the compiled program's
    # flops/bytes against the DeviceSpec roofline.  arithmetic_intensity
    # is null when the family moved no accounted bytes (cost model blind
    # or truly zero); bound is "compute" | "memory"; pct_roofline is
    # lower_bound/achieved (1.0 = at the roofline).  The "_total" record
    # carries extra "tokens"/"toks_per_s_ceiling" keys (extras — this is
    # a floor).
    "perf_attribution": {
        "schema": str, "family": str, "calls": _NUM, "device_ms": _NUM,
        "flops": _NUM, "bytes": _NUM, "flops_per_s": _NUM,
        "bytes_per_s": _NUM,
        "arithmetic_intensity": (int, float, type(None)),
        "bound": str, "lower_bound_ms": _NUM, "pct_roofline": _NUM,
        "mfu": _NUM, "mbu": _NUM, "device": str, "peak_flops": _NUM,
        "hbm_bytes_per_s": _NUM, "time": _NUM, "mono": _NUM,
    },
    # tools/obs_report.py output document; v2 added the required "trace"
    # key (per-request waterfalls from trace_events.jsonl); v3 adds the
    # resource-ledger sections — "compile" (compile_ledger.jsonl rollup)
    # and "memory" (mem/* gauges + memory_breakdown.json), both null when
    # the run carried no ledger; v4 (fleet health PR) adds the required
    # "alerts" section (alerts.jsonl rollup: firing count, worst severity,
    # per-rule edge counts and time-firing; null when the run carried no
    # health monitor); v5 (perf attribution PR) adds the required "perf"
    # section (perf_attribution.jsonl rollup: per-family roofline table +
    # MFU/tokens-ceiling rollup; null when the run carried no perf layer);
    # v6 (autopilot PR) adds the required "autopilot" section
    # (autopilot_actions.jsonl rollup: action table, per-trigger/per-kind
    # counts, action rate; null when the run carried no autopilot); v7
    # (live-weights PR) adds the required "weights" section
    # (weight_swaps.jsonl rollup: swap/failure counts, version range,
    # swap-latency stats; null when the run never swapped weights)
    "obs_report": {
        "schema": str, "generated_at": _NUM, "scalars": dict,
        "histograms": dict, "flight": (dict, type(None)),
        "anomalies": list, "hlo_audits": list, "timeline": dict,
        "supervisor": (dict, type(None)), "trace": (dict, type(None)),
        "compile": (dict, type(None)), "memory": (dict, type(None)),
        "alerts": (dict, type(None)), "perf": (dict, type(None)),
        "autopilot": (dict, type(None)), "weights": (dict, type(None)),
    },
}


# Registry-metric contract: the async-hot-path metrics that flow into
# scalars.jsonl through MetricRegistry.to_scalar_records (histograms
# flatten to `name/count`, `name/sum` and cumulative `name/le_*` tags — all
# validating as `scalars` records).  Name -> kind; a registered metric of
# the wrong kind is an emitter bug (it would misfile the flattened tags),
# which validate_registry_metrics catches.  Extra, undeclared metrics are
# always allowed — this is a floor, like the record schemas above.
REGISTRY_METRICS: Dict[str, str] = {
    # data/prefetch.DevicePrefetcher — the staged input pipeline
    "data/prefetch_queue_depth": "gauge",
    "data/prefetch_staged_ahead": "gauge",
    "data/prefetch_rewinds_total": "counter",
    "data/prefetch_batches_staged_total": "counter",
    "data/prefetch_wait_ms": "histogram",
    # obs/transfer_audit.TransferAudit — explicit-crossing accounting
    "transfer/explicit_fetches_total": "counter",
    "transfer/explicit_puts_total": "counter",
    "transfer/fetch_wait_ms": "histogram",
    "transfer/guarded_sections_total": "counter",
    # host-blocked wall time per subsystem (fit deferred fetch / serving
    # packed decode fetch)
    "train/host_blocked_ms": "histogram",
    "serving/host_blocked_ms": "histogram",
    # kvcache/ paged-KV subsystem (serving.paged.PagedKVManager +
    # kvcache.allocator / kvcache.prefix) — pool occupancy and prefix-reuse
    # effectiveness
    "kvcache/pages_total": "gauge",
    "kvcache/pages_in_use": "gauge",
    "kvcache/pages_cached": "gauge",
    "kvcache/prefix_hits_total": "counter",
    "kvcache/prefix_misses_total": "counter",
    "kvcache/prefill_skipped_total": "counter",
    "kvcache/cow_copies_total": "counter",
    "kvcache/evictions_total": "counter",
    # paged GATHER-path decode accounting: bytes spent rematerializing the
    # contiguous [B, T] K/V views from the page pool — stays ZERO when the
    # block-table-native kernel (ops.paged_attention) serves decode
    "kvcache/gather_bytes_total": "counter",
    # KV chain transfer (kvcache.transfer, disagg PR): pages serialized
    # out of / admitted into page pools by migration and fleet-prefix
    # fills; the fleet_prefix counters split directory consultations by
    # whether a sibling's chain could be imported instead of re-prefilled
    "kvcache/pages_exported_total": "counter",
    "kvcache/pages_imported_total": "counter",
    "kvcache/fleet_prefix_hits_total": "counter",
    "kvcache/fleet_prefix_misses_total": "counter",
    # int8 KV pages (kvcache.quant): pages written through a
    # quantize-on-write path (prefill page writes + decode requant writes)
    "kvcache/quant_pages_total": "counter",
    # multi-tenant serving (tenancy.AdapterStore) — adapter-pool residency
    # and churn: hits are pure refcount bumps, loads page a cold adapter
    # in, evictions reclaim an unpinned one under pressure
    "tenancy/adapters_resident": "gauge",
    "tenancy/adapter_pool_pages_in_use": "gauge",
    "tenancy/adapter_hits_total": "counter",
    "tenancy/adapter_loads_total": "counter",
    "tenancy/adapter_evictions_total": "counter",
    # SLO serving (stall-free serving PR): preemptions counts batch-tier
    # victims parked for the interactive queue head, shed counts
    # deadline-infeasible requests rejected at submit (SLOInfeasible),
    # expired_before_prefill counts granted requests whose deadline died
    # between the sweep and their prefill/chunk dispatch, prefill_chunks
    # counts chunked-prefill dispatches; the per-class TTFT/inter-token
    # histograms carry the per-tier latency story
    "serving/preemptions_total": "counter",
    "serving/shed_total": "counter",
    "serving/expired_before_prefill_total": "counter",
    "serving/prefill_chunks_total": "counter",
    "serving/ttft_ms_interactive": "histogram",
    "serving/ttft_ms_batch": "histogram",
    "serving/intertoken_ms_interactive": "histogram",
    "serving/intertoken_ms_batch": "histogram",
    # serving speculative decoding (serving.engine draft-k-verify rounds):
    # proposed/accepted measure draft quality, committed/rounds is the
    # tokens-per-step headline
    "serving/spec_proposed_total": "counter",
    "serving/spec_accepted_total": "counter",
    "serving/spec_committed_total": "counter",
    "serving/spec_rounds_total": "counter",
    # serving fleet router (serving.fleet.router.FleetRouter) — pool-wide
    # admission accounting.  dispatched counts placements (a requeued
    # request is dispatched again), failovers counts replica deaths the
    # router drained, affinity hits/misses split fingerprinted dispatches
    # by whether the shadow matched any leading pages.  Per-replica
    # `router/replica<N>/alive|load` gauges ride alongside as extras
    # (dynamic names — deliberately outside this floor).
    "router/dispatched_total": "counter",
    "router/requeued_total": "counter",
    "router/failovers_total": "counter",
    "router/restarts_total": "counter",
    "router/retired_total": "counter",
    # graceful drains initiated (autopilot PR): scale-in, proactive
    # restart rotation and role rebalances all begin with a drain — the
    # requeue-free path, unlike failovers above
    "router/drains_total": "counter",
    "router/affinity_hits_total": "counter",
    "router/affinity_misses_total": "counter",
    # disagg (serving.fleet.disagg.DisaggRouter): KV-page migration hops
    # from prefill-role to decode-capable replicas
    "router/migrations_total": "counter",
    "router/replicas_alive": "gauge",
    "router/queue_depth": "gauge",
    "router/inflight": "gauge",
    "router/affinity_hit_rate": "gauge",
    "router/fleet_prefix_hit_rate": "gauge",
    # compile ledger (obs.compile_ledger.CompileLedger): every intercepted
    # .lower()/.compile() site counts + times here; storms are compiles
    # after warmup was declared done, thrash warnings fire when a program
    # family's distinct keys exceed its compiled-cache capacity, and the
    # cache hit/miss/eviction counters join the _CompiledLRU's own
    # eviction counter (below) so recompile churn is attributable
    "trace/compiles_total": "counter",
    "trace/compile_ms": "histogram",
    "trace/compile_storms_total": "counter",
    "trace/compile_thrash_total": "counter",
    "trace/compiled_cache_hits_total": "counter",
    "trace/compiled_cache_misses_total": "counter",
    "trace/compiled_cache_evictions_total": "counter",
    # memory ledger (obs.memory_ledger.MemoryLedger): per-subsystem device
    # bytes + peak watermarks (the gauges' sum is the logical sizing
    # model), device truth where the backend reports it, and the largest
    # compiled program's temp bytes as the workspace subsystem.  Further
    # mem/<subsystem>_bytes names are allowed as extras (this is a floor).
    "mem/params_bytes": "gauge",
    "mem/params_peak_bytes": "gauge",
    "mem/opt_state_bytes": "gauge",
    "mem/opt_state_peak_bytes": "gauge",
    "mem/kv_pool_bytes": "gauge",
    "mem/kv_pool_peak_bytes": "gauge",
    "mem/kv_cache_bytes": "gauge",
    "mem/kv_cache_peak_bytes": "gauge",
    "mem/draft_kv_bytes": "gauge",
    "mem/draft_kv_peak_bytes": "gauge",
    "mem/adapter_pool_bytes": "gauge",
    "mem/adapter_pool_peak_bytes": "gauge",
    "mem/workspace_bytes": "gauge",
    "mem/workspace_peak_bytes": "gauge",
    "mem/device_bytes_in_use": "gauge",
    "mem/device_peak_bytes": "gauge",
    "mem/device_bytes_limit": "gauge",
    "mem/live_array_bytes": "gauge",
    # fleet health monitor (obs.health.HealthMonitor): alerts currently
    # firing and total firing edges since start — the two numbers an
    # external pager scrapes alongside /healthz
    "obs/alerts_firing": "gauge",
    "obs/alerts_total": "counter",
    # fleet autopilot (serving.fleet.autopilot.Autopilot): remediation
    # actions by kind (drains counts every drain-initiating action —
    # scale-in, proactive restart, rebalance), plus the mode gauge
    # (1 = auto, 0 = page_only — the kill-switch position, scrapeable)
    "autopilot/actions_total": "counter",
    "autopilot/scale_outs_total": "counter",
    "autopilot/scale_ins_total": "counter",
    "autopilot/drains_total": "counter",
    "autopilot/restarts_total": "counter",
    "autopilot/admission_tightenings_total": "counter",
    "autopilot/rebalances_total": "counter",
    "autopilot/mode": "gauge",
    # perf attribution (obs.perf.PerfAttribution): per-family device
    # wall-time histograms on the hot path, the milli-scaled rollup gauges
    # (mfu_milli = MFU fraction x 1e3 — gauge floats, and the health
    # TrendRules watch these), and the cost-model degradation counter
    # (compile rows whose cost_analysis() omitted keys — see
    # utils.profiling.cost_report)
    "perf/prefill_device_ms": "histogram",
    "perf/prefill_chunk_device_ms": "histogram",
    "perf/decode_step_device_ms": "histogram",
    "perf/spec_round_device_ms": "histogram",
    "perf/train_step_device_ms": "histogram",
    "perf/mfu_milli": "gauge",
    "perf/mbu_milli": "gauge",
    "perf/roofline_pct_milli": "gauge",
    "perf/cost_model_missing_total": "counter",
    # live weights (weights.swapper.WeightSwapper): hot-swap attempts and
    # failures, the end-to-end swap latency (load + validate + install),
    # and the monotonic version the engine currently serves (scrapeable —
    # a mixed-version fleet mid-roll shows as diverging per-replica gauges)
    "weights/swaps_total": "counter",
    "weights/swap_failures_total": "counter",
    "weights/swap_ms": "histogram",
    "weights/weights_version": "gauge",
}


def validate_registry_metrics(registry: Any) -> None:
    """Check every :data:`REGISTRY_METRICS` name that IS registered in
    ``registry`` against its declared kind (names may be absent — a run
    without serving has no serving metrics).  Raises ``ValueError`` on a
    kind mismatch."""
    metrics = {m.name: m for m in registry.metrics()}
    for name, kind in REGISTRY_METRICS.items():
        m = metrics.get(name)
        if m is None:
            continue
        have = type(m).__name__.lower()
        if have != kind:
            raise ValueError(
                f"registry metric {name!r} is a {have}, schema declares "
                f"{kind!r} — its scalars.jsonl tags would misfile")


def validate_record(kind: str, record: dict, where: str = "") -> None:
    """Raise ValueError when ``record`` violates the ``kind`` schema."""
    schema = SCHEMAS.get(kind)
    if schema is None:
        raise ValueError(f"unknown artifact kind {kind!r} "
                         f"(known: {sorted(SCHEMAS)})")
    if not isinstance(record, dict):
        raise ValueError(f"{where or kind}: record is {type(record).__name__}, "
                         "expected object")
    for field, types in schema.items():
        if field not in record:
            raise ValueError(f"{where or kind}: missing required field "
                             f"{field!r} (present: {sorted(record)})")
        v = record[field]
        # bool is an int subclass but never a valid numeric metric value
        if isinstance(v, bool) and bool not in (
                types if isinstance(types, tuple) else (types,)):
            raise ValueError(f"{where or kind}: field {field!r} is bool, "
                             f"expected {types}")
        if not isinstance(v, types):
            raise ValueError(f"{where or kind}: field {field!r} is "
                             f"{type(v).__name__}, expected {types}")


def validate_jsonl(kind: str, path: str, max_records: int = 0) -> int:
    """Validate every line of a JSONL artifact; returns the record count.
    ``max_records`` bounds the scan (0 = all)."""
    n = 0
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{lineno}: invalid JSON ({e})")
            validate_record(kind, rec, where=f"{path}:{lineno}")
            n += 1
            if max_records and n >= max_records:
                break
    return n


def validate_flight_document(doc: dict, where: str = "flight_record") -> None:
    """Validate a flight-record document including its nested records and
    warnings."""
    validate_record("flight_record", doc, where)
    for i, rec in enumerate(doc["records"]):
        validate_record("flight_step", rec, f"{where}.records[{i}]")
    for i, w in enumerate(doc["warnings"]):
        validate_record("anomaly", w, f"{where}.warnings[{i}]")
