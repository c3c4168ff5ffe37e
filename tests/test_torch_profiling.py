"""PyTorch port: the cost counter (``utils.profiling``), the perf
attribution (``obs.perf``) and the health rules (``obs.health``), against
the JAX package where the function is the same.

- ``cost_report``: the flops of a matmul chain are ``2 M N K`` per product
  (exact); bytes are each distinct storage once, a view with gaps counts
  its elements, and an ``embedding`` lookup, an advanced-index read or an
  ``index_put_`` into a pool counts only the rows it touches (exact).  A
  paged-attention (B4) call and a flash call (B1-B3) through their plain
  versions declare exactly :func:`paged_attention_cost` /
  :func:`flash_cost`, computed here by hand as well, and their own ops add
  nothing.  Counters do not nest; without one a wrapper declares nothing.
- ``roofline`` and ``roofline_attribution`` / ``attribute`` /
  ``summarize_perf`` / ``merge_perf_records`` equal JAX's on the same
  numbers (apart from wall stamps); the attribution's ledger join turns
  phase-graph executions into phase totals.
- ``device_spec``: the H100 SXM name maps to 989e12 / 3.35e12; its PCIe
  and NVL names and an unknown card raise naming the card; the CPU takes
  the calibrated spec.
- The health monitor: the same rules over the same snapshot sequence give
  JAX's alert edges, gauges and ``/healthz`` document.
"""

import json
import math

import pytest
import torch

import neuronx_distributed_tpu.obs.health as jax_health
import neuronx_distributed_tpu.obs.perf as jax_perf
import neuronx_distributed_tpu.utils.profiling as jax_profiling
import neuronx_distributed_tpu_torch.obs.health as health
import neuronx_distributed_tpu_torch.obs.perf as perf
from neuronx_distributed_tpu_torch.ops.flash_attention import (
    flash_attention_dkv,
    flash_attention_dq,
    flash_attention_fwd,
    flash_cost,
    visible_pairs,
)
from neuronx_distributed_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_cost,
)
from neuronx_distributed_tpu_torch.utils import profiling


def _strip(recs):
    return [{k: v for k, v in r.items() if k not in ("time", "mono")}
            for r in recs]


# -- cost_report ---------------------------------------------------------------


def test_matmul_chain_flops_and_storage_bytes():
    g = torch.Generator().manual_seed(0)
    M, N, K, P = 8, 16, 32, 4
    a, b, c = (torch.randn(s, generator=g) for s in ((M, K), (K, N), (N, P)))
    rep = profiling.cost_report(lambda: (a @ b) @ c)
    assert rep["flops"] == 2 * M * N * K + 2 * M * P * N
    # a, b, c read; a@b written then read; the result written: each once
    assert rep["bytes_accessed"] == 4 * (M * K + K * N + N * P + M * N
                                         + M * P)
    assert rep["declared_flops"] == rep["declared_bytes"] == 0.0
    # the same storage read twice counts once
    assert profiling.cost_report(lambda: a + a)["bytes_accessed"] == \
        4 * 2 * M * K
    # a column slice reads its elements, never the gaps
    x = torch.randn(64, 64, generator=g)
    assert profiling.cost_report(lambda: x[:, :8].sum())["bytes_accessed"] \
        == 4 * (64 * 8 + 1)


def test_indexing_ops_count_the_rows_they_touch():
    g = torch.Generator().manual_seed(1)
    table = torch.randn(1000, 64, generator=g)
    ids = torch.tensor([[3, 7, 7]])
    rep = profiling.cost_report(torch.nn.functional.embedding, ids, table)
    # 3 rows read, 3 rows written, the ids read: never the 1000-row table
    assert rep["bytes_accessed"] == 3 * 64 * 4 * 2 + 3 * 8
    pool = torch.zeros(50, 4, 2, 8)
    phys, cell = torch.tensor([[3, 9]]), torch.tensor([[1, 2]])
    vals = torch.randn(1, 2, 2, 8, generator=g)

    def write():
        pool[phys, cell] = vals

    rep = profiling.cost_report(write)
    # 2 cells of 2 x 8 written, the values and both index arrays read
    assert rep["bytes_accessed"] == 2 * 16 * 4 + 2 * 16 * 4 + 2 * 2 * 8
    assert profiling.cost_report(lambda: pool[phys, cell].sum())[
        "bytes_accessed"] == 2 * 16 * 4 * 2 + 2 * 2 * 8 + 4
    src = torch.randn(2, 8, 2, 8, generator=g)
    rep = profiling.cost_report(
        lambda: pool.index_copy_(0, torch.tensor([4, 5]), src[:, :4]))
    assert rep["bytes_accessed"] == 2 * 64 * 4 + 2 * 64 * 4 + 2 * 8


def _pool(g, NP=12, page=4, NKV=2, D=64, dtype=torch.float32):
    return (torch.randn(NP, page, NKV, D, generator=g, dtype=dtype),
            torch.randn(NP, page, NKV, D, generator=g, dtype=dtype))


def _paged_hand(q, page, NKV, PP, offs, starts, window=None):
    """chip_smoke.py's bound arithmetic, restated."""
    B, S, NQ, D = q.shape
    G, T, item = NQ // NKV, PP * page, q.element_size()
    nbytes = 2 * B * S * NQ * D * item + B * PP * 4 + 2 * B * 4
    flops = 0
    for o, s0 in zip(offs, starts):
        if o >= T:
            continue
        hi, lo = min(o + S - 1, T - 1), max(s0, 0 if window is None
                                            else o - window + 1)
        nbytes += 2 * (hi - lo + 1) * NKV * D * item
        for s in range(S):
            lo_s = max(s0, 0 if window is None else o + s - window + 1)
            flops += 4 * D * NKV * G * max(min(o + s, T - 1) - lo_s + 1, 0)
    return flops, nbytes


@pytest.mark.parametrize("S,window", [(1, None), (3, None), (2, 5)])
def test_paged_attention_declares_its_formula(S, window):
    g = torch.Generator().manual_seed(2)
    B, NQ, D, page, PP = 3, 4, 64, 4, 3
    pool = _pool(g)
    q = torch.randn(B, S, NQ, D, generator=g)
    bt = torch.tensor([[1, 2, 3], [4, 5, 6], [7, 8, 9]], dtype=torch.int32)
    off = torch.tensor([5, 9, 12], dtype=torch.int32)  # slot 2 parked
    start = torch.tensor([1, 0, 0], dtype=torch.int32)
    rep = profiling.cost_report(paged_attention, q, pool, bt, off, start,
                                window=window)
    want = _paged_hand(q, page, 2, PP, [5, 9, 12], [1, 0, 0], window)
    assert (rep["flops"], rep["bytes_accessed"]) == want
    assert (rep["declared_flops"], rep["declared_bytes"]) == want
    assert paged_attention_cost(q, pool, bt, off, start, window) == want
    assert rep["ops_counted"] == 0  # the plain version's ops are not counted


@pytest.mark.parametrize("which", ["fwd", "dq", "dkv"])
def test_flash_declares_its_formula(which):
    g = torch.Generator().manual_seed(3)
    B, HQ, HKV, S, T, D = 2, 4, 2, 6, 9, 64
    q = torch.randn(B, HQ, S, D, generator=g)
    k, v = (torch.randn(B, HKV, T, D, generator=g) for _ in range(2))
    do = torch.randn(B, HQ, S, D, generator=g)
    lse = torch.randn(B, HQ, S, generator=g)
    delta = torch.randn(B, HQ, S, generator=g)
    fn = {"fwd": lambda: flash_attention_fwd(q, k, v, window=4),
          "dq": lambda: flash_attention_dq(q, k, v, do, lse, delta, window=4),
          "dkv": lambda: flash_attention_dkv(q, k, v, do, lse, delta,
                                             window=4)}[which]
    rep = profiling.cost_report(fn)
    pairs = sum(min(i + (T - S) + 1, 4) for i in range(S))
    assert visible_pairs(S, T, True, 4) == pairs
    qd, kd, rows = B * HQ * S * D * 4, B * HKV * T * D * 4, B * HQ * S * 4
    want = ({"fwd": 4, "dq": 6, "dkv": 8}[which] * D * B * HQ * pairs,
            {"fwd": 2 * qd + 2 * kd + rows,
             "dq": 3 * qd + 2 * kd + 2 * rows,
             "dkv": 2 * qd + 4 * kd + 2 * rows}[which])
    assert (rep["flops"], rep["bytes_accessed"]) == want
    assert flash_cost(which, q, k, True, 4) == want
    assert rep["ops_counted"] == 0


def test_counters_do_not_nest_and_off_declares_nothing():
    with profiling.counting():
        with pytest.raises(RuntimeError, match="already active"):
            with profiling.counting():
                pass
    assert profiling.ACTIVE is None
    with profiling.declared(1e9, 1e9):  # no counter: nothing happens
        pass
    assert profiling.memory_analysis(lambda x: x * 2, torch.ones(3)) is None


def test_roofline_matches_jax():
    for rep in ({"flops": 2e12, "bytes_accessed": 1e9},
                {"flops": 1e9, "bytes_accessed": 4e10},
                {"flops": 5.0, "bytes_accessed": 0.0}):
        assert profiling.roofline(rep) == jax_profiling.roofline(
            rep, profiling.DEFAULT_PEAK_FLOPS,
            profiling.DEFAULT_HBM_BYTES_PER_S)
    assert (profiling.DEFAULT_PEAK_FLOPS,
            profiling.DEFAULT_HBM_BYTES_PER_S) == (989e12, 3.35e12)


# -- perf attribution ----------------------------------------------------------

H100 = (989e12, 3.35e12)


def test_roofline_attribution_and_readers_match_jax():
    jspec = jax_perf.DeviceSpec("nvidia h100 80gb hbm3", *H100)
    pspec = perf.DeviceSpec("nvidia h100 80gb hbm3", *H100)
    cases = [("decode_step", 100, 980.0, 1.2e12, 1.5e12),
             ("prefill", 16, 400.0, 3e14, 2e11), ("spec_round", 0, 0.0, 0, 0)]
    for args in cases:
        kw = dict(now=1.0, mono=2.0)
        assert perf.roofline_attribution(*args, pspec, **kw) == \
            jax_perf.roofline_attribution(*args, jspec, **kw)
        assert perf.attribute(*args, pspec, **kw) == \
            jax_perf.attribute(*args, jspec, **kw)
    recs = [perf.roofline_attribution(*a, pspec, now=1.0, mono=2.0)
            for a in cases[:2]]
    assert perf.summarize_perf(recs) == jax_perf.summarize_perf(recs)
    assert perf.summarize_perf([]) is None
    streams = [recs, [perf.roofline_attribution(*cases[0], pspec)]]
    assert _strip(perf.merge_perf_records(streams)) == _strip(
        jax_perf.merge_perf_records(streams))


def test_ledger_join_turns_executions_into_phase_totals(tmp_path):
    from neuronx_distributed_tpu_torch.obs import CompileLedger

    led = CompileLedger()
    spec = perf.DeviceSpec("nvidia h100 80gb hbm3", *H100)
    att = perf.PerfAttribution(path=str(tmp_path / "p.jsonl"), spec=spec,
                               ledger=led)
    led.record_compile("decode_pages", "a", 1.0,
                       cost={"flops": 10.0, "bytes_accessed": 100.0})
    led.record_compile("decode_pages", "b", 1.0,
                       cost={"flops": 30.0, "bytes_accessed": 300.0})
    for _ in range(3):
        att.note_program_call("decode_pages")
    att.mark_warmup_done()
    for _ in range(4):
        att.note_program_call("decode_pages")
    att.note_phase("decode_step", 2.0, calls=4)
    rec = att.attribution()[0]
    # per-call cost: the mean over the family's rows; 4 measured calls
    assert (rec["flops"], rec["bytes"]) == (4 * 20.0, 4 * 200.0)
    assert rec["bound"] == "memory" and 0 < rec["pct_roofline"] <= 1.0


def test_device_spec_h100_and_unknown_cards(monkeypatch):
    names = {}
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: names["now"])
    for name, ok in (("NVIDIA H100 80GB HBM3", True),
                     ("NVIDIA H100 PCIe", False), ("NVIDIA H100 NVL", False),
                     ("NVIDIA A100-SXM4-80GB", False)):
        names["now"] = name
        if ok:
            spec = perf.device_spec("cuda:0")
            assert (spec.peak_flops, spec.hbm_bytes_per_s) == H100
        else:
            with pytest.raises(ValueError, match=name.lower()):
                perf.device_spec("cuda:0")
    cpu = perf.device_spec("cpu")
    assert cpu is perf.calibrate_cpu_spec() and cpu.kind == "cpu"


# -- health rules against JAX ----------------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _drive_monitor(mod, path):
    clock = _Clock()
    mon = mod.HealthMonitor(mod.default_rules("serving"), path=path,
                            clock=clock)
    docs = []
    storms, tokens = 0.0, 0.0
    for i in range(40):
        clock.t = float(i)
        tokens += 50.0 if i < 25 else 5.0  # throughput sags at 25
        if i == 30:
            storms += 1.0
        snap = {"serving/queue_depth": 80.0 if 10 <= i < 14 else 3.0,
                "kvcache/pages_total": 100.0,
                "kvcache/pages_in_use": 98.0 if i >= 35 else 20.0,
                "serving/tokens_total": tokens,
                "trace/compile_storms_total": storms,
                "serving/ttft_ms": {"count": float(i), "sum": 10.0 * i
                                    * (1.0 if i < 20 else 5.0)}}
        for j in range(3):
            mon.note_request(good=not (i > 32 and j), priority="batch",
                             now=float(i))
        mon.evaluate(snapshot=snap)
        docs.append(mon.healthz())
    mon.close()
    return mon, docs


def test_health_monitor_matches_jax(tmp_path):
    (jmon, jdocs), (pmon, pdocs) = (
        _drive_monitor(jax_health, str(tmp_path / "jax.jsonl")),
        _drive_monitor(health, str(tmp_path / "port.jsonl")))
    assert _strip(pmon.edges) == _strip(jmon.edges)
    assert {e["rule"] for e in pmon.edges} >= {
        "queue_backlog", "compile_storm", "kv_headroom", "throughput_sag"}
    assert pdocs == jdocs
    assert _strip(health.read_alerts(str(tmp_path / "port.jsonl"))) == \
        _strip(jax_health.read_alerts(str(tmp_path / "jax.jsonl")))
    assert [r.name for r in health.default_rules("all")] == [
        r.name for r in jax_health.default_rules("all")]
    assert [r.name for r in health.default_rules("fleet")] == [
        r.name for r in jax_health.default_rules("fleet")]
    assert math.isclose(pmon.page_edges(), jmon.page_edges())
    json.dumps(pdocs)
