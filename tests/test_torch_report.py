"""PyTorch port: the run report and the fleet readers (``obs.report``,
``obs.aggregate``) against the JAX package.

The readers are pure functions of the artifacts, so they are held exactly:

- A run directory the JAX engine wrote (the tiny pair, the traffic of
  ``test_torch_tracing``, full telemetry with the resource ledgers, the
  health monitor and the perf attribution) plus a fleet layout written by
  the JAX package's own writers (per-replica registries and serving
  stats, ``router_stats.jsonl``, a ``FleetHealth`` alert stream, weight
  swaps and autopilot actions): the port's ``build_report``,
  ``render_markdown``, ``summarize_perf``, ``read_alerts``, the merges and
  ``compare_resources`` give the JAX functions' output, apart from the
  report's ``generated_at`` wall stamp.
- The other way: the JAX readers on the port engine's run directory give
  the port readers' document, valid as ``obs_report_v7`` with its compile,
  memory, alerts, perf and trace sections filled.
- ``FleetHealth`` over the same replica snapshots, conditions and outputs
  gives JAX's alert edges, ``/healthz`` and Prometheus fleet text.
- The CLI ``python -m neuronx_distributed_tpu_torch.obs.report`` writes the
  same document and markdown, and ``--compare`` exits 1 on a regression.
"""

import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace as NS

import pytest

import neuronx_distributed_tpu.obs as jax_obs
import neuronx_distributed_tpu.obs.aggregate as jax_agg
import neuronx_distributed_tpu.obs.health as jax_health
import neuronx_distributed_tpu.obs.perf as jax_perf
import neuronx_distributed_tpu.obs.report as jax_report
import neuronx_distributed_tpu_torch.obs as obs
import neuronx_distributed_tpu_torch.obs.aggregate as agg
import neuronx_distributed_tpu_torch.obs.health as health
import neuronx_distributed_tpu_torch.obs.perf as perf
import neuronx_distributed_tpu_torch.obs.report as report
from test_torch_tracing import _no_plans, _serve  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = {"jax": (jax_obs, jax_agg, jax_health), "port": (obs, agg, health)}


def _doc(rep):
    return json.dumps({k: v for k, v in rep.items() if k != "generated_at"},
                      sort_keys=True)


def _strip(recs):
    return [{k: v for k, v in r.items() if k not in ("time", "mono")}
            for r in recs]


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _write_jsonl(path, recs):
    with open(path, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")


def _drive_fleet(side, path):
    """Two replicas and a router through one side's ``FleetHealth``: a
    backlog on the router, a replica kill and restart, a retirement and its
    replacement.  Returns the control room and its ``/healthz`` documents."""
    omod, amod, _ = SIDES[side]
    clock = _Clock()
    fh = amod.FleetHealth(path=path, eval_every=1, clock=clock,
                          wall=lambda: 1000.0)
    router = NS(registry=omod.MetricRegistry(), replicas={})
    for rid in range(2):
        reg = omod.MetricRegistry()
        router.replicas[rid] = NS(alive=True, engine=NS(registry=reg))
    docs = []
    for i in range(12):
        clock.t = float(i)
        router.registry.gauge("router/queue_depth").set(
            90.0 if 3 <= i < 6 else 2.0)
        for rid, rep in router.replicas.items():
            reg = rep.engine.registry
            reg.counter("serving/tokens_total").inc(10 + rid)
            reg.gauge("serving/queue_depth").set(70.0 if rid and i > 7 else 1)
            reg.histogram("serving/ttft_ms", (1.0, 10.0)).observe(5.0 + i)
        if i == 4:
            router.replicas[1].alive = False
            fh.replica_down(1, cause="killed", now=clock.t)
        if i == 6:
            router.replicas[1].alive = True
            fh.replica_up(1, now=clock.t)
        if i == 9:
            fh.replica_retired(0, cause="budget", now=clock.t)
            fh.replica_replaced(0, by=2, now=clock.t)
        fh.note_output(NS(priority="interactive", deadline_s=0.1,
                          total_ms=50.0 if i % 3 else 500.0,
                          state="finished", request_id=i), now=clock.t)
        fh.step(router, now=clock.t)
        docs.append(fh.healthz())
    fh.close()
    agg_text = amod.fleet_prometheus_text(
        {rid: r.engine.registry.snapshot()
         for rid, r in router.replicas.items()})
    return fh, docs, agg_text, router


def test_fleet_health_and_merges_match_jax(tmp_path):
    out = {side: _drive_fleet(side, str(tmp_path / f"{side}_alerts.jsonl"))
           for side in SIDES}
    (jfh, jdocs, jtext, jr), (pfh, pdocs, ptext, pr) = out["jax"], out["port"]
    assert _strip(pfh.edges()) == _strip(jfh.edges())
    assert {e["rule"] for e in pfh.edges()} >= {"replica_down",
                                                "replica_retired"}
    assert pdocs == jdocs and pfh.page_edges() == jfh.page_edges() > 0
    assert ptext == jtext
    snaps = [r.engine.registry.snapshot() for r in pr.replicas.values()]
    assert agg.merge_snapshots(snaps) == jax_agg.merge_snapshots(snaps)
    assert _strip(health.read_alerts(str(tmp_path / "port_alerts.jsonl"))) \
        == _strip(jax_health.read_alerts(str(tmp_path / "jax_alerts.jsonl")))


def _jax_fleet_dir(root):
    """A fleet run directory written by the JAX package's writers."""
    for rid in range(2):
        sub = os.path.join(root, f"replica{rid}")
        os.makedirs(sub)
        reg = jax_obs.MetricRegistry()
        reg.counter("serving/tokens_total").inc(10 + rid)
        reg.histogram("serving/ttft_ms", (1.0, 10.0)).observe(5.0 + rid)
        reg.dump_jsonl(os.path.join(sub, "scalars.jsonl"), step=3)
        att = jax_perf.PerfAttribution(
            path=os.path.join(sub, "perf_attribution.jsonl"),
            spec=jax_perf.DeviceSpec("nvidia h100 80gb hbm3", 989e12,
                                     3.35e12))
        att.note_cost("decode_step", 1e9, 1.5e10)
        att.note_phase("decode_step", 9.8 + rid, calls=4)
        att.note_tokens(32)
        att.dump()
    _write_jsonl(os.path.join(root, "router_stats.jsonl"), [{
        "schema": "router_stats/1", "time": 1.0, "request_id": 1,
        "client_id": 0, "replica": 0, "state": "finished",
        "finish_reason": "length", "dispatches": 2, "requeues": 1,
        "migrations": 0, "role": None, "affinity_pages": 0,
        "new_tokens": 2, "policy": "round_robin"}])
    _write_jsonl(os.path.join(root, "replica0_weight_swaps.jsonl"), [
        {"schema": "weight_swap/1", "time": 100.0 + m, "mono": m,
         "event": "swap" if ok else "swap_failed", "version": v,
         "source": "memory", "ok": ok, "swap_ms": 2.5 if ok else None,
         "error": None if ok else "injected", "replica": 0}
        for v, ok, m in ((1, True, 1.0), (2, False, 2.0))])
    _write_jsonl(os.path.join(root, "autopilot_actions.jsonl"), [
        {"schema": "autopilot_action/1", "time": 10.0 + i, "mono": float(i),
         "action": a, "trigger": "replica_down", "mode": "act",
         "replica": 1, "detail": {}, "edge": None, "budget_remaining": 3 - i}
        for i, a in enumerate(("restart", "scale_out"))])
    _drive_fleet("jax", os.path.join(root, "fleet_alerts.jsonl"))


def _both(run_dir):
    reps = (report.build_report(run_dir=run_dir),
            jax_report.build_report(run_dir=run_dir))
    for rep in reps:
        jax_obs.validate_record("obs_report", rep)
        obs.validate_record("obs_report", rep)
    return reps


def test_readers_match_jax_on_jax_written_dirs(tmp_path):
    run = str(tmp_path / "run")
    _serve("jax", "async-whole", run, part2=True)
    prep, jrep = _both(run)
    assert _doc(prep) == _doc(jrep)
    for sec in ("compile", "memory", "alerts", "perf", "trace"):
        assert prep[sec] is not None, sec
    assert report.render_markdown(prep) == jax_report.render_markdown(jrep)
    recs = perf.read_perf_attribution(os.path.join(
        run, "perf_attribution.jsonl"))
    assert perf.summarize_perf(recs) == jax_perf.summarize_perf(recs)
    assert health.read_alerts(os.path.join(run, "alerts.jsonl")) == \
        jax_health.read_alerts(os.path.join(run, "alerts.jsonl"))

    fleet = str(tmp_path / "fleet")
    _jax_fleet_dir(fleet)
    prep, jrep = _both(fleet)
    assert _doc(prep) == _doc(jrep)
    for sec in ("alerts", "perf", "autopilot", "weights"):
        assert prep[sec] is not None, sec
    assert prep["health"]["fleet"]["router_stats"]["requeued"] == 1
    assert report.render_markdown(prep) == jax_report.render_markdown(jrep)
    files = sorted(os.path.join(fleet, f"replica{i}",
                                "perf_attribution.jsonl") for i in range(2))
    assert _strip(agg.merge_perf_files(files)) == _strip(
        jax_agg.merge_perf_files(files))
    assert agg.discover_replica_dirs(fleet) == \
        jax_agg.discover_replica_dirs(fleet)
    assert agg.merge_serving_stats([]) == jax_agg.merge_serving_stats([])

    diff = report.compare_resources(run, fleet)
    jdiff = jax_report.compare_resources(run, fleet)
    assert json.dumps(diff, sort_keys=True) == json.dumps(jdiff,
                                                          sort_keys=True)


def test_jax_readers_read_the_port_run_dir(tmp_path):
    run = str(tmp_path / "run")
    _serve("port", "sync-whole-spec", run, part2=True)
    prep, jrep = _both(run)
    assert _doc(prep) == _doc(jrep)
    for sec in ("compile", "memory", "alerts", "perf", "trace"):
        assert prep[sec] is not None, sec
    assert prep["compile"]["compiles"] == prep["compile"]["families"][
        "verify_pages"]["compiles"] + prep["compile"]["families"][
        "decode_slots"]["compiles"]
    assert set(prep["perf"]["families"]) == {"prefill", "spec_round"}
    assert report.render_markdown(prep) == jax_report.render_markdown(jrep)


def test_report_cli(tmp_path):
    run = str(tmp_path / "run")
    _serve("port", "async-whole", run, part2=True)
    out, md = str(tmp_path / "r.json"), str(tmp_path / "r.md")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "neuronx_distributed_tpu_torch.obs.report",
         run, "--out", out, "--markdown", md], capture_output=True,
        text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    doc = json.load(open(out))
    assert _doc(doc) == _doc(report.build_report(run_dir=run))
    assert open(md).read() == report.render_markdown(doc)
    # the same run again: no regression; with one more compile, a storm
    # after warm-up, B regressed: exit 1
    storm = str(tmp_path / "storm")
    shutil.copytree(run, storm)
    led = obs.CompileLedger(path=os.path.join(storm, "compile_ledger.jsonl"))
    led.declare_warmup_done()
    led.record_compile("decode_pages", "new shape", 3.0)
    for b, rc in ((run, 0), (storm, 1)):
        proc = subprocess.run(
            [sys.executable, "-m", "neuronx_distributed_tpu_torch.obs.report",
             "--compare", run, b], capture_output=True, text=True, env=env,
            timeout=300)
        assert proc.returncode == rc, proc.stderr
    assert "REGRESSION" in proc.stderr
    with pytest.raises(SystemExit):
        report.main([])  # nothing to report on
