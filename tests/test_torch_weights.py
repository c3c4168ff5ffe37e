"""PyTorch port: live weights -- the hot swap on one engine, the fleet's
rolling update, the swap artifacts and the report sections over a fleet
run -- against the JAX package.

Every JAX oracle test of ``tests/test_weights.py`` of a ported module has
a counterpart here.  Left out: the four ``save_nxd_checkpoint`` tests and
``shard_for_rank`` (``convert/nxd.py`` is not ported) and
``swap_from_checkpoint`` (it loads through the trainer's checkpoints).

The rig is the oracle's: the tiny fp32 Llama at B = 2 (page 4, 9 pages)
with two envelope-identical weight sets (JAX init seeds 0 and 7, moved to
the port by ``llama_params_from_jax``); each port test builds its own
wrapper, so whether an engine owns its model is the test's choice.

- One engine that owns its model: a warmed engine swaps with ZERO compile
  rows after warm-up (the ledger books the CPU's eager keys), its tokens
  flip from the seed-0 to the seed-7 weights exactly at the swap and equal
  JAX's, and the tokens of the step in flight at the swap are stamped with
  version 0 as in JAX; the ``weight_swap`` and ``serving_stats`` records
  equal JAX's apart from times.  Envelope mismatches, the
  ``weights/pre_swap`` fault and a caller that frees its tensors after a
  memory swap (the donation hazard) go as in JAX.
- A shared model: a swap moves the engine to a private model whose
  captures are booked as warm-up (no ``compile_storm``), and the shared
  model's weights stay untouched.
- The fleet: a 3-replica ``rolling_update`` under traffic loses nothing,
  shows mixed versions mid-roll and ends on version 1 with JAX's tokens,
  roll status and audit records; a failed swap rejoins on the old weights;
  one roll at a time; the autopilot never restarts a draining replica.
- Artifacts: the ``weight_swap/1`` schema floor, the report's weights
  section and the ``--compare`` gates, and the port's report over the port
  fleet's artifacts (``router_stats``, ``autopilot_actions``,
  ``weight_swaps``, the router's scalars) has JAX's fleet, router,
  autopilot and weights sections over JAX's artifacts of the same run.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from torch_fleet_pair import (
    B,
    SIDES,
    engine_factory,
    fresh_port_pool,
    ns,
    pair,
    port_params,
)
from torch_port_pair import C


@pytest.fixture(autouse=True)
def _no_plans():
    for side in SIDES:
        ns(side).clear_plan()
    yield
    for side in SIDES:
        ns(side).clear_plan()


@pytest.fixture(scope="module")
def rig():
    """``{side: (pool factory, params1)}``: the JAX side serves on the
    pair's shared wrapper; each port call of the factory builds a wrapper
    of its own over the seed-0 weights."""
    jpim, _, module, params0, cfg = pair()
    params1 = nn.unbox(module.init(jax.random.PRNGKey(7),
                                   jnp.zeros((B, C), jnp.int32)))
    return {"jax": (lambda: jpim, params1),
            "port": (lambda: fresh_port_pool(params0), port_params(params1)),
            "cfg": cfg}


def both(fn, *args):
    logs = {}
    for side in SIDES:
        logs[side] = []
        fn(ns(side), logs[side], *args)
    assert logs["port"] == logs["jax"]
    return logs


def _serve_one(engine, n, rid, prompt, max_new=4):
    engine.submit(n.Request(request_id=rid, prompt_ids=prompt,
                            max_new_tokens=max_new))
    (out,) = [o for o in engine.run_until_complete(max_steps=500)
              if o.request_id == rid]
    assert out.state == "finished"
    return out


def _records(path, drop=("time", "mono", "swap_ms", "queue_ms", "ttft_ms",
                         "total_ms", "queue_wait_ms", "preempted_ms")):
    recs = [json.loads(line) for line in open(path)]
    for r in recs:
        for k in drop:
            r.pop(k, None)
    return recs


# -- one engine --------------------------------------------------------------------


def test_live_swap_zero_compiles_and_exact_version_boundary(rig, tmp_path):
    prompt = np.random.RandomState(3).randint(
        1, rig["cfg"].vocab_size, size=6).tolist()

    def run(n, log):
        make_pool, params1 = rig[n.side]
        led = n.CompileLedger()
        stats = str(tmp_path / f"serving_stats.{n.side}.jsonl")
        swaps = str(tmp_path / f"weight_swaps.{n.side}.jsonl")
        eng = engine_factory(n.side, make_pool(), compile_ledger=led,
                             stats_path=stats)()
        sw = n.WeightSwapper(eng, path=swaps)
        before = _serve_one(eng, n, 0, prompt)
        assert before.weights_version == 0
        eng.declare_warmup_done()
        mark = led.mark()
        assert sw.swap(params1, source="memory") == 1
        assert eng.weights_version == 1 and led.compiles_since(mark) == 0
        after = _serve_one(eng, n, 1, prompt)
        assert led.compile_count(after_warmup_only=True) == 0
        assert after.weights_version == 1
        assert list(after.token_ids) != list(before.token_ids)
        eng.close()
        sw.close()
        assert n.validate_jsonl("weight_swap", swaps) == 1
        assert n.validate_jsonl("serving_stats", stats) == 2
        snap = eng.registry.snapshot()
        assert snap["weights/weights_version"] == 1.0
        assert snap["weights/swaps_total"] == 1.0
        assert snap.get("weights/swap_failures_total", 0.0) == 0.0
        log.append((list(before.token_ids), list(after.token_ids),
                    _records(swaps),
                    [r["weights_version"] for r in _records(stats)]))

    both(run)


def test_in_flight_step_stamped_with_its_dispatch_version(rig):
    """Async decode: the step in flight at the swap was dispatched on the
    old weights, and its token carries version 0 (JAX's
    ``_pending_version``); every token and stamp equals JAX's."""
    prompt = [5, 9, 3, 7, 11, 2]

    def run(n, log):
        make_pool, params1 = rig[n.side]
        eng = engine_factory(n.side, make_pool())()
        sw = n.WeightSwapper(eng)
        cb = lambda r, tok: log.append((r.request_id, tok, r.weights_version))  # noqa: E731
        eng.submit(n.Request(request_id=0, prompt_ids=prompt,
                             max_new_tokens=6, stream_cb=cb))
        for _ in range(3):
            eng.step()
        assert eng._pending is not None  # a step is in flight
        sw.swap(params1)
        eng.run_until_complete(max_steps=50)
        eng.submit(n.Request(request_id=1, prompt_ids=prompt,
                             max_new_tokens=3, stream_cb=cb))
        eng.run_until_complete(max_steps=50)
        stamps = [v for rid, _, v in log if rid == 0]
        assert stamps == [0, 0, 0, 0, 1, 1]
        eng.close()

    both(run)


def test_shared_model_swap_captures_privately_without_storm(rig):
    """Two engines over one model: the swap moves the swapping engine to a
    private model (the other keeps the old weights), its phases are
    captured again inside the install and booked as warm-up, and its
    tokens equal a swap on a model it owns."""
    prompt = [4, 8, 15, 16, 23, 42]
    make_pool, params1 = rig["port"]
    n = ns("port")
    pool = make_pool()
    led = n.CompileLedger()
    a = engine_factory("port", pool, compile_ledger=led)()
    b = engine_factory("port", pool, compile_ledger=led)()
    for eng in (a, b):
        _serve_one(eng, n, 0, prompt)
    led.declare_warmup_done()
    ref = {name: p.clone() for name, p in pool.module.named_parameters()}
    n.WeightSwapper(a).swap(params1)
    assert a.model is not pool and b.model is pool
    assert led.storms == 0
    assert [r.get("rewarm") for r in led.rows if r["event"] == "compile"][-1] \
        == "weights_v1"
    for name, p in pool.module.named_parameters():
        assert torch.equal(p, ref[name])
    swapped = _serve_one(a, n, 1, prompt)
    assert led.storms == 0
    own = engine_factory("port", make_pool())()
    n.WeightSwapper(own).swap(params1)
    assert list(swapped.token_ids) == list(_serve_one(own, n, 1,
                                                      prompt).token_ids)
    assert list(_serve_one(b, n, 1, prompt).token_ids) != list(
        swapped.token_ids)


def test_swap_through_one_wrapper_leaves_the_other_wrappers_module(rig):
    """Two ``ParallelInferenceModel`` wrappers over ONE module, one engine
    each: the module is shared, so a swap through the first wrapper moves
    its engine to a private model, and the engine on the second wrapper
    keeps serving the old weights, token for token."""
    from neuronx_distributed_tpu_torch.trace import ParallelInferenceModel

    prompt = [3, 1, 4, 1, 5, 9, 2]
    make_pool, params1 = rig["port"]
    n = ns("port")
    first = make_pool()
    second = ParallelInferenceModel(first.module, first.config, device="cpu")
    a = engine_factory("port", first)()
    b = engine_factory("port", second)()
    before = list(_serve_one(b, n, 0, prompt).token_ids)
    ref = {name: p.clone() for name, p in first.module.named_parameters()}
    assert a.shares_model and b.shares_model
    n.WeightSwapper(a).swap(params1)
    assert a.model is not first and a.model.module is not first.module
    for name, p in first.module.named_parameters():
        assert torch.equal(p, ref[name])
    assert list(_serve_one(b, n, 1, prompt).token_ids) == before
    assert list(_serve_one(a, n, 1, prompt).token_ids) != before
    a.close()
    b.close()


def test_envelope_mismatches_refused_with_old_weights_serving(rig):
    prompt = np.random.RandomState(5).randint(
        1, rig["cfg"].vocab_size, size=5).tolist()

    def run(n, log):
        make_pool, params1 = rig[n.side]
        eng = engine_factory(n.side, make_pool())()
        sw = n.WeightSwapper(eng)
        if n.side == "jax":
            leaves, treedef = jax.tree_util.tree_flatten(params1)

            def bad(fn):
                return jax.tree_util.tree_unflatten(
                    treedef, [fn(leaf) if j == 0 else leaf
                              for j, leaf in enumerate(leaves)])

            shape = bad(lambda x: np.zeros(tuple(d + 1 for d in x.shape),
                                           np.asarray(x).dtype))
            dtype = bad(lambda x: np.asarray(x).astype(np.float16))
        else:
            first = next(iter(params1))
            shape = dict(params1, **{first: torch.zeros(
                tuple(d + 1 for d in params1[first].shape))})
            dtype = dict(params1, **{first: params1[first].half()})
        for p, match in ((shape, "shape"), (dtype, "dtype"),
                         ({"not": "the model tree"}, "structure")):
            with pytest.raises(n.SwapError, match=match):
                sw.swap(p)
        assert eng.weights_version == 0
        out = _serve_one(eng, n, 0, prompt)
        assert out.weights_version == 0
        assert eng.registry.snapshot()["weights/swap_failures_total"] == 3.0
        log.append(list(out.token_ids))
        eng.close()

    both(run)


def test_pre_swap_chaos_fault_is_transactional(rig, tmp_path):
    prompt = np.random.RandomState(11).randint(
        1, rig["cfg"].vocab_size, size=4).tolist()

    def run(n, log):
        make_pool, params1 = rig[n.side]
        swaps = str(tmp_path / f"weight_swaps.{n.side}.jsonl")
        eng = engine_factory(n.side, make_pool())()
        sw = n.WeightSwapper(eng, path=swaps)
        n.install_plan({"faults": [{"point": "weights/pre_swap",
                                    "action": "exception", "count": 1,
                                    "message": "test: injected pre-swap kill"}]})
        try:
            with pytest.raises(Exception, match="pre-swap kill"):
                sw.swap(params1, source="memory")
        finally:
            n.clear_plan()
        assert eng.weights_version == 0
        old = list(_serve_one(eng, n, 0, prompt).token_ids)
        assert sw.swap(params1, source="memory") == 1
        new = list(_serve_one(eng, n, 1, prompt).token_ids)
        eng.close()
        sw.close()
        recs = _records(swaps)
        assert [r["ok"] for r in recs] == [False, True]
        assert recs[0]["event"] == "swap_failed" and recs[0]["version"] == 0
        log.append((old, new, recs))

    both(run)


@pytest.mark.parametrize("shared", [False, True])
def test_memory_swap_survives_freed_source_tensors(rig, shared):
    """The memory source copies by default: a trainer that overwrites or
    frees its tensors right after the handoff (what JAX's donation does)
    leaves the engine serving the swapped weights, on a model the engine
    owns (written in place) and on a shared one (a private copy)."""
    prompt = np.random.RandomState(17).randint(
        1, rig["cfg"].vocab_size, size=5).tolist()

    def run(n, log):
        make_pool, params1 = rig[n.side]
        pool = make_pool()
        eng = engine_factory(n.side, pool)()
        if shared:
            other = engine_factory(n.side, pool)()
        if n.side == "jax":
            donated = jax.tree.map(lambda x: jax.device_put(np.asarray(x)),
                                   params1)
            n.WeightSwapper(eng).swap(donated, source="memory")
            for leaf in jax.tree_util.tree_leaves(donated):
                leaf.delete()
        else:
            donated = {k: v.clone() for k, v in params1.items()}
            n.WeightSwapper(eng).swap(donated, source="memory")
            for v in donated.values():
                v.fill_(float("nan"))
                v.resize_(0)
        out = _serve_one(eng, n, 0, prompt)
        assert out.weights_version == 1
        log.append(list(out.token_ids))
        if shared:
            other.close()
        eng.close()

    both(run)


def test_param_envelope_is_the_module_parameters(rig):
    """The port's envelope is its module's named parameters (names, shapes,
    dtypes, device): the JAX tree's paths, one per JAX param leaf, the
    keys ``llama_params_from_jax`` produces."""
    make_pool, params1 = rig["port"]
    pool = make_pool()
    env = ns("port").param_envelope(pool)
    live = dict(pool.module.named_parameters())
    assert set(env) == set(live) == set(params1)
    for name, spec in env.items():
        assert spec.shape == tuple(live[name].shape)
        assert spec.dtype == live[name].dtype == torch.float32
        assert spec.device == live[name].device
    jenv = ns("jax").param_envelope(rig["jax"][0]())
    assert len(jax.tree_util.tree_leaves(jenv)) == len(env)


# -- the fleet rolling update ----------------------------------------------------------


def _roll_fleet(n, rig, count, **kw):
    make_pool, _ = rig[n.side]
    pool = make_pool()
    router = n.FleetRouter([n.Replica(i, engine_factory(n.side, pool, **kw))
                            for i in range(count)],
                           policy="round_robin", seed=1)
    return router, pool


def test_rolling_update_zero_loss_mixed_versions(rig, tmp_path):
    rs = np.random.RandomState(23)
    prompts = [rs.randint(1, rig["cfg"].vocab_size,
                          size=int(rs.randint(3, 7))).tolist()
               for _ in range(9)]

    def run(n, log):
        params1 = rig[n.side][1]
        led = n.CompileLedger()
        router, _ = _roll_fleet(n, rig, 3, compile_ledger=led)
        swaps = tmp_path / n.side
        swaps.mkdir()
        outs, mixed, submitted, started, seen = {}, False, 0, False, []
        for step in range(400):
            for _ in range(2):
                if submitted < len(prompts):
                    router.submit(n.Request(request_id=submitted,
                                            prompt_ids=prompts[submitted],
                                            max_new_tokens=3))
                    submitted += 1
            for o in router.step():
                outs[router.client_id(o.request_id)] = o
            if step == 3:  # every replica has decoded (captured) once
                led.declare_warmup_done()
            if not started and submitted >= 3:
                router.rolling_update(params1, swaps_dir=str(swaps),
                                      cause="test_roll")
                started = True
            if started and router.roll_status() is not None:
                versions = tuple(r.describe()["weights_version"]
                                 for r in router.replicas.values())
                seen.append(versions)
                mixed = mixed or len(set(versions)) > 1
            if (started and router.roll_status() is None
                    and submitted == len(prompts) and not router.inflight):
                break
        roll = dict(router.last_roll)
        roll.pop("duration_s")
        assert sorted(roll["done"]) == [0, 1, 2] and not roll["failed"]
        assert mixed and len(outs) == len(prompts)
        assert all(o.state == "finished" for o in outs.values())
        for r in router.replicas.values():
            assert r.describe()["weights_version"] == 1
        assert led.storms == 0
        router.assert_invariants()
        router.close()
        recs = []
        for rid in range(3):
            path = str(swaps / f"replica{rid}_weight_swaps.jsonl")
            assert n.validate_jsonl("weight_swap", path) == 1
            recs += _records(path)
        assert all(r["ok"] and r["version"] == 1 for r in recs)
        log.append((roll, seen, recs,
                    sorted((c, list(o.token_ids), o.weights_version)
                           for c, o in outs.items())))

    both(run)


def test_rolling_update_failed_swap_rejoins_on_old_weights(rig, tmp_path):
    def run(n, log):
        params1 = rig[n.side][1]
        router, _ = _roll_fleet(n, rig, 2)
        n.install_plan({"faults": [{"point": "weights/pre_swap",
                                    "action": "exception", "count": 1,
                                    "message": "test: injected swap kill"}]})
        try:
            router.rolling_update(params1, swaps_dir=str(tmp_path))
            for _ in range(100):
                router.step()
                if router.roll_status() is None:
                    break
        finally:
            n.clear_plan()
        assert router.last_roll["failed"] == [0]
        assert router.last_roll["done"] == [1]
        versions = [r.describe()["weights_version"]
                    for r in router.replicas.values()]
        assert versions == [0, 1]
        outs = {}
        for i in range(4):
            router.submit(n.Request(request_id=i, prompt_ids=[1, 2, 3],
                                    max_new_tokens=2))
        for _ in range(200):
            for o in router.step():
                outs[router.client_id(o.request_id)] = o
            if len(outs) == 4:
                break
        assert all(o.state == "finished" for o in outs.values())
        log.append((versions, sorted((c, list(o.token_ids),
                                      o.weights_version)
                                     for c, o in outs.items())))
        router.close()
        for p in os.listdir(tmp_path):
            os.remove(tmp_path / p)

    both(run)


def test_exactly_one_roll_at_a_time_and_arg_validation(rig):
    def run(n, log):
        params1 = rig[n.side][1]
        router, _ = _roll_fleet(n, rig, 2)
        with pytest.raises(ValueError, match="exactly one"):
            router.rolling_update()
        with pytest.raises(ValueError, match="exactly one"):
            router.rolling_update(params1, ckpt_dir="/nope")
        router.rolling_update(params1)
        with pytest.raises(ValueError, match="already in progress"):
            router.rolling_update(params1)
        for _ in range(100):
            router.step()
            if router.roll_status() is None:
                break
        roll = dict(router.last_roll)
        roll.pop("duration_s")
        log.append(roll)
        router.close()

    both(run)
    # checkpoint swaps wait for the trainer's checkpoints in the port
    router, _ = _roll_fleet(ns("port"), rig, 1)
    with pytest.raises(NotImplementedError, match="checkpoint"):
        router.rolling_update(ckpt_dir="/nope")
    with pytest.raises(NotImplementedError, match="checkpoint"):
        router.drain(0, then="swap", payload={"ckpt_dir": "/nope"})
    router.close()


def test_autopilot_drain_restart_skips_draining_replica(rig):
    def run(n, log):
        params1 = rig[n.side][1]
        router, _ = _roll_fleet(n, rig, 2)
        pilot = n.Autopilot(router, None, config=n.AutopilotConfig())
        router.drain(0, then="swap", payload={"params": params1})
        emitted = []
        pilot._drain_restart({"rule": "compile_storm", "replica": 0,
                              "state": "firing"}, now=0.0, emitted=emitted)
        assert emitted == [] and router.draining() == {0: "swap"}
        assert router.registry.snapshot().get(
            "router/restarts_total", 0.0) == 0.0
        with pytest.raises(ValueError, match="already draining"):
            router.drain(0, then="restart")
        log.append(router.draining())
        router.close()

    both(run)


# -- artifacts ---------------------------------------------------------------------------


def _swap_rec(version, ok=True, mono=1.0, source="memory", replica=-1):
    return {"schema": "weight_swap/1", "time": 100.0 + mono, "mono": mono,
            "event": "swap" if ok else "swap_failed", "version": version,
            "source": source, "ok": ok, "swap_ms": 2.5 if ok else None,
            "error": None if ok else "injected", "replica": replica}


def _write_jsonl(path, recs):
    with open(path, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    return str(path)


def _untimed(obj):
    """``obj`` without its clock readings and paths (keys of times,
    latencies and rates; file lists), recursively."""
    if isinstance(obj, dict):
        return {k: _untimed(v) for k, v in obj.items()
                if not (k in ("mono", "time", "span_s", "rate_per_s",
                              "files", "paths") or "_ms" in k
                        or "hit_rate" in k)}
    if isinstance(obj, list):
        return [_untimed(v) for v in obj]
    return obj


def _report(side):
    return __import__(f"{ns(side).pkg}.obs.report", fromlist=["x"])


def test_weight_swap_schema_floor():
    def run(n, log):
        n.validate_record("weight_swap", _swap_rec(1))
        with pytest.raises(ValueError, match="missing required field"):
            n.validate_record("weight_swap", {"schema": "weight_swap/1"})
        with pytest.raises(ValueError, match="expected") as e:
            n.validate_record("weight_swap", dict(_swap_rec(1), version="1"))
        log.append(str(e.value))

    both(run)


def test_summarize_weights_section_and_report(tmp_path):
    a = _write_jsonl(tmp_path / "replica0_weight_swaps.jsonl",
                     [_swap_rec(1, mono=1.0, replica=0),
                      _swap_rec(2, mono=2.0, replica=0)])
    b = _write_jsonl(tmp_path / "replica1_weight_swaps.jsonl",
                     [_swap_rec(1, mono=1.5, replica=1),
                      _swap_rec(1, ok=False, mono=2.5, replica=1,
                                source="checkpoint")])
    c = _write_jsonl(tmp_path / "replica2_weight_swaps.jsonl",
                     [_swap_rec(3, mono=1.0, replica=2),
                      _swap_rec(2, mono=2.0, replica=2)])

    def run(n, log):
        rep = _report(n.side)
        assert rep.summarize_weights([str(tmp_path / "absent.jsonl")]) is None
        s = rep.summarize_weights([a, b])
        assert s["swaps"] == 3 and s["failures"] == 1 and s["monotonic"]
        report = rep.build_report(weights_paths=[a, b])
        n.validate_record("obs_report", report)
        assert report["health"]["weights"]["failures"] == 1
        assert "live swap" in rep.render_markdown(report)
        s2 = rep.summarize_weights([c])
        assert s2["monotonic"] is False
        log.append((s, report["weights"], s2))

    both(run)


def test_compare_gates_on_new_failures_and_non_monotonic(tmp_path):
    runs = {}
    for name, recs in (("a", [_swap_rec(1), _swap_rec(2, mono=2.0)]),
                       ("b", [_swap_rec(1), _swap_rec(2, ok=False,
                                                      mono=2.0)]),
                       ("c", [_swap_rec(2), _swap_rec(1, mono=2.0)])):
        (tmp_path / name).mkdir()
        _write_jsonl(tmp_path / name / "weight_swaps.jsonl", recs)
        runs[name] = str(tmp_path / name)

    def run(n, log):
        cmp = _report(n.side).compare_resources
        same = cmp(runs["a"], runs["a"])
        assert not same["regressed"]
        b, c = cmp(runs["a"], runs["b"]), cmp(runs["a"], runs["c"])
        assert b["regressed"] and any("swap failure" in r
                                      for r in b["regressions"])
        assert c["regressed"] and any("monotonic" in r
                                      for r in c["regressions"])
        log.append((same["regressions"], b["regressions"],
                    c["regressions"]))

    both(run)


def test_port_report_over_port_fleet_equals_jax_report(rig, tmp_path):
    """One fleet run through each package writes ``router_stats.jsonl``, an
    ``autopilot_actions.jsonl`` (a forced tighten), per-replica
    ``weight_swaps.jsonl`` (a rolling update) and the router's scalars;
    the port's report over the port's files has the same fleet, router,
    autopilot and weights sections as the JAX report over JAX's."""
    prompts = [[1, 2, 3], [4, 5, 6, 7], [8, 9], [3, 1, 4, 1, 5]]
    sections = {}
    for side in SIDES:
        n = ns(side)
        params1 = rig[side][1]
        d = tmp_path / side
        d.mkdir()
        make_pool = rig[side][0]
        pool = make_pool()
        router = n.FleetRouter(
            [n.Replica(i, engine_factory(side, pool)) for i in range(2)],
            policy="round_robin", stats_path=str(d / "router_stats.jsonl"))
        t = [0.0]
        pilot = n.Autopilot(
            router, None, config=n.AutopilotConfig(fire_after=1),
            actions_path=str(d / "autopilot_actions.jsonl"),
            clock=lambda: t[0], wall=lambda: t[0])
        pilot._emit("tighten", "slo_burn_fast_interactive", -1,
                    {"shed_scale": 2.0}, None, 0.0)
        for i, p in enumerate(prompts):
            router.submit(n.Request(request_id=i, prompt_ids=p,
                                    max_new_tokens=3))
        router.rolling_update(params1, swaps_dir=str(d))
        for _ in range(300):
            router.step()
            if router.roll_status() is None and not router.has_work:
                break
        router.registry.dump_jsonl(str(d / "scalars.jsonl"), step=1)
        pilot.close()
        router.close()
        rep = _report(side)
        report = rep.build_report(
            run_dir=str(d), router_stats_path=str(d / "router_stats.jsonl"),
            autopilot_paths=[str(d / "autopilot_actions.jsonl")],
            weights_paths=sorted(str(p) for p in d.glob("*weight_swaps*")))
        n.validate_record("obs_report", report)
        fleet = dict(report["health"]["fleet"])
        rs = dict(fleet.pop("router_stats"))
        sections[side] = _untimed({
            "fleet": fleet, "router": rs, "autopilot": report["autopilot"],
            "weights": report["weights"]})
    assert sections["port"]["router"]["records"] == len(prompts)
    assert sections["port"]["weights"]["swaps"] == 2
    assert sections["port"] == sections["jax"]
