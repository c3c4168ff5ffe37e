"""PyTorch port: the fault-injection plane and the supervisor against the
JAX package.

- The same plan fires the same events (point, action, context) in the
  port's ``resilience.faults`` as in JAX's, over matching, ``hit``,
  ``count`` and every action; plans are refused for the same reasons; a
  ``nan`` spec poisons a numpy array as JAX does, and a torch tensor whole
  or one row, always in a copy; with no plan a hook hands its value back
  untouched; ``NXD_FAULT_PLAN`` loads inline JSON and files, and a
  ``kill`` at a fault point of a child process exits with the kill code
  under the supervisor.
- The supervisor restarts trivial children (no jax, no torch) until a
  clean exit, gives up on a spent budget, kills a wedged child, records
  the resume tag, and every event it writes validates as
  ``supervisor_event``; ``classify_exit``, ``newest_complete_tag`` and
  ``RestartBackoff`` answer as JAX's do.
- Chaos on the tiny serving pair, the JAX engine beside the port's under
  the same plan: a fault at ``serving/page_alloc`` (with and without an
  adapter), at ``tenancy/adapter_load`` (the store alone and in the
  engine), a NaN at ``serving/prefill_logits`` (never cached), at
  ``serving/decode_logits`` on one slot (async and sync) and at
  ``serving/verify_logits``: the same requests fail with the same
  reasons, the rest keep JAX's tokens, and nothing leaks.
"""

import json
import math
import os
import sys

import numpy as np
import pytest
import torch

import neuronx_distributed_tpu.resilience.faults as jax_faults
import neuronx_distributed_tpu_torch.resilience.faults as faults
from neuronx_distributed_tpu.resilience.supervisor import (
    RestartBackoff as JaxRestartBackoff,
    classify_exit as jax_classify_exit,
    newest_complete_tag as jax_newest_complete_tag,
)
from neuronx_distributed_tpu.serving import (
    Request as JaxRequest,
    ServingEngine as JaxServingEngine,
)
from neuronx_distributed_tpu_torch.resilience import (
    KILL_EXIT_CODE,
    FaultPlan,
    InjectedFault,
    Supervisor,
    classify_exit,
    clear_plan,
    fault_point,
    fired_events,
    install_plan,
    newest_complete_tag,
    perturb,
)
from neuronx_distributed_tpu.obs.schemas import (
    validate_record as jax_validate_record,
)
from neuronx_distributed_tpu_torch.obs.schemas import validate_record
from neuronx_distributed_tpu_torch.resilience.supervisor import RestartBackoff
from neuronx_distributed_tpu_torch.serving import Request, ServingEngine
from torch_port_pair import build_pair

PAGE, NUM_PAGES = 4, 16
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_plans():
    clear_plan()
    jax_faults.clear_plan()
    yield
    clear_plan()
    jax_faults.clear_plan()


def _events(mod):
    return [(e["point"], e["action"], e["ctx"]) for e in mod.fired_events()]


def _install_both(plan):
    install_plan(plan)
    jax_faults.install_plan(plan)


# -- the fault plane -----------------------------------------------------------


def _drive_plan(mod):
    """The JAX unit test's sequence of hook calls; returns what each call
    gave (NaN as the string "nan", a raise as its message)."""
    mod.install_plan({"faults": [
        {"point": "a/b", "action": "nan", "match": {"step": 3}},
        {"point": "a/c", "action": "exception", "message": "boom",
         "count": 2},
        {"point": "a/d", "action": "nan", "hit": 2, "count": 0},
        {"point": "a/e", "action": "sleep", "seconds": 0, "count": 0},
    ]})
    out = []

    def call(point, value, **ctx):
        try:
            v = mod.perturb(point, value, **ctx)
        except mod.InjectedFault as e:
            out.append(f"raised {e}")
            return
        out.append("nan" if isinstance(v, float) and math.isnan(v) else v)

    call("a/b", 1.0, step=2)
    call("a/b", 1.0, step=3)
    call("a/b", 1.0, step=3)   # count exhausted
    call("a/b", 1.0)           # the match key is absent: never fires
    for _ in range(3):
        call("a/c", 5.0)       # two raises, then inert
    for _ in range(3):
        call("a/d", 1.0)       # the first hit skipped, then unlimited
    mod.fault_point("a/e", request_id=7, engine_step=2)
    return out


def test_plan_fires_the_same_events_as_jax():
    got = _drive_plan(faults)
    want = _drive_plan(jax_faults)
    assert got == want == [1.0, "nan", 1.0, 1.0, "raised boom",
                           "raised boom", 5.0, 1.0, "nan", "nan"]
    assert _events(faults) == _events(jax_faults)
    assert [e[0] for e in _events(faults)] == [
        "a/b", "a/c", "a/c", "a/d", "a/d", "a/e"]
    assert _events(faults)[-1][2] == {"request_id": 7, "engine_step": 2}


@pytest.mark.parametrize("spec,match", [
    ({"point": "x", "action": "explode"}, "unknown action"),
    ({"action": "nan"}, "no 'point'"),
    ({"point": "x", "action": "nan", "step": 3}, "unknown keys"),
])
def test_plans_refused_like_jax(spec, match):
    for mod in (faults, jax_faults):
        with pytest.raises(ValueError, match=match):
            mod.FaultPlan([spec])


def test_nan_poisons_numpy_rows_like_jax():
    plan = {"faults": [{"point": "p", "action": "nan", "slot": 1},
                       {"point": "q", "action": "nan"}]}
    _install_both(plan)
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    for point in ("p", "q"):
        got = perturb(point, x)
        want = jax_faults.perturb(point, x)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_array_equal(got[~np.isnan(got)],
                                      want[~np.isnan(want)])
    assert np.isfinite(x).all()  # the input is never written


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nan_poisons_a_torch_copy_whole_or_one_row(dtype):
    install_plan({"faults": [{"point": "row", "action": "nan", "slot": 2},
                             {"point": "all", "action": "nan"}]})
    x = torch.arange(20, dtype=dtype).reshape(4, 5)
    row = perturb("row", x)
    assert row is not x and row.dtype == dtype
    assert torch.isnan(row[2]).all()
    assert torch.isfinite(row[[0, 1, 3]]).all()
    assert torch.equal(row[[0, 1, 3]], x[[0, 1, 3]])
    whole = perturb("all", x)
    assert torch.isnan(whole).all() and whole is not x
    assert torch.isfinite(x).all()  # the input (a graph's output) untouched
    # the plan's counts are spent: the value comes back as it was
    assert perturb("row", x) is x


def test_no_plan_hands_values_back_untouched(monkeypatch):
    monkeypatch.delenv(faults.ENV_VAR, raising=False)
    x = torch.ones(3)
    assert perturb("serving/decode_logits", x, engine_step=1) is x
    assert fault_point("serving/prefill_chunk", request_id=0) is None
    assert faults.active_plan() is None and fired_events() == []
    # once read, the missing plan is one global read: None
    assert faults._PLAN is None


def test_plan_from_env_inline_and_file(tmp_path, monkeypatch):
    monkeypatch.setenv(faults.ENV_VAR,
                       '{"faults": [{"point": "e", "action": "nan"}]}')
    assert math.isnan(perturb("e", 1.0))
    clear_plan()
    plan_file = tmp_path / "plan.json"
    plan_file.write_text(json.dumps(
        {"faults": [{"point": "f", "action": "nan"}]}))
    monkeypatch.setenv(faults.ENV_VAR, str(plan_file))
    assert math.isnan(perturb("f", 2.0))
    clear_plan()
    monkeypatch.delenv(faults.ENV_VAR)
    assert perturb("e", 1.0) == 1.0
    # an explicit install overrides the environment
    monkeypatch.setenv(faults.ENV_VAR,
                       '{"faults": [{"point": "e", "action": "nan"}]}')
    install_plan(None)
    assert perturb("e", 1.0) == 1.0
    assert isinstance(install_plan([{"point": "g", "action": "nan"}]),
                      FaultPlan)


# -- the supervisor --------------------------------------------------------------


def _crashy_script(tmp_path, crashes: int) -> str:
    """A child that raises ``crashes`` times (counted in a file), then
    exits cleanly; it imports neither jax nor torch."""
    counter = tmp_path / "count"
    script = tmp_path / "crashy.py"
    script.write_text(
        "import os\n"
        f"p = {str(counter)!r}\n"
        "n = int(open(p).read()) if os.path.exists(p) else 0\n"
        "open(p, 'w').write(str(n + 1))\n"
        f"if n < {crashes}:\n"
        "    raise RuntimeError('boom %d' % n)\n"
        "print('clean exit')\n")
    return str(script)


def _check_event_keys(events):
    """Every event validates as ``supervisor_event`` under the port's
    schemas and the JAX package's (the two lists are equal)."""
    for e in events:
        validate_record("supervisor_event", e)
        jax_validate_record("supervisor_event", e)
        assert e["schema"] == "supervisor_events/1"


def test_supervisor_restarts_until_clean(tmp_path):
    events_path = tmp_path / "supervisor_events.jsonl"
    exits = []
    sup = Supervisor(
        [sys.executable, _crashy_script(tmp_path, crashes=2)],
        max_restarts=3, backoff_base_s=0.01, events_path=str(events_path),
        log_path=str(tmp_path / "child.log"),
        on_exit=lambda attempt, rc, cause: exits.append((attempt, cause)))
    res = sup.run()
    assert res.ok and res.attempts == 3 and res.restarts == 2
    assert res.causes == ["exception", "exception"]
    assert [e["event"] for e in sup.events] == [
        "start", "exit", "restart", "start", "exit", "restart", "start",
        "exit", "success"]
    assert [e["backoff_s"] for e in sup.events
            if e["event"] == "restart"] == [0.01, 0.02]
    assert exits == [(1, "exception"), (2, "exception"), (3, "clean")]
    on_disk = [json.loads(line) for line in events_path.read_text().split("\n")
               if line]
    assert on_disk == sup.events
    _check_event_keys(on_disk)


def test_supervisor_gives_up_when_budget_spent(tmp_path):
    sup = Supervisor(
        [sys.executable, _crashy_script(tmp_path, crashes=99)],
        max_restarts=1, backoff_base_s=0.01,
        log_path=str(tmp_path / "child.log"))
    res = sup.run()
    assert not res.ok and res.restarts == 1 and res.final_rc != 0
    assert sup.events[-1]["event"] == "giveup"
    _check_event_keys(sup.events)


def test_supervisor_kills_wedged_child_on_timeout(tmp_path):
    script = tmp_path / "wedged.py"
    script.write_text("import time\ntime.sleep(600)\n")
    sup = Supervisor([sys.executable, str(script)], max_restarts=0,
                     timeout_s=1.0)
    res = sup.run()
    assert not res.ok and res.causes == ["timeout"]


def test_supervisor_spawn_failure_is_a_crash(tmp_path):
    sup = Supervisor([str(tmp_path / "no-such-binary")], max_restarts=0)
    res = sup.run()
    assert not res.ok and res.final_rc == 127 and res.causes == ["exit_127"]
    with pytest.raises(ValueError, match="command"):
        Supervisor([])
    with pytest.raises(ValueError, match="max_restarts"):
        Supervisor(["true"], max_restarts=-1)


def test_supervisor_records_resume_tag_and_a_fault_kill(tmp_path):
    """A child killed at a fault point through ``NXD_FAULT_PLAN`` exits
    with the kill code; the supervisor restarts it without the plan and
    records the newest complete checkpoint tag at each start."""
    ck = tmp_path / "ck"
    (ck / "step_2").mkdir(parents=True)
    (ck / "step_2" / ".done").write_text("ok")
    (ck / "newest").write_text("step_2")
    marker = tmp_path / "killed"
    script = tmp_path / "child.py"
    script.write_text(
        "import os, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        f"m = {str(marker)!r}\n"
        "if not os.path.exists(m):\n"
        "    open(m, 'w').write('1')\n"
        "else:\n"
        "    os.environ.pop('NXD_FAULT_PLAN')\n"
        "from neuronx_distributed_tpu_torch.resilience import fault_point\n"
        "fault_point('serving/prefill_chunk', request_id=0)\n")
    env = dict(os.environ)
    env[faults.ENV_VAR] = json.dumps({"faults": [
        {"point": "serving/prefill_chunk", "action": "kill"}]})
    sup = Supervisor([sys.executable, str(script)], max_restarts=1,
                     backoff_base_s=0.0, ckpt_dir=str(ck), env=env,
                     log_path=str(tmp_path / "child.log"))
    res = sup.run()
    assert res.ok and res.causes == [f"exit_{KILL_EXIT_CODE}"]
    starts = [e for e in sup.events if e["event"] == "start"]
    assert [e["resume_tag"] for e in starts] == ["step_2", "step_2"]
    assert "faults: fired serving/prefill_chunk" in (
        tmp_path / "child.log").read_text()


def test_newest_complete_tag_matches_jax(tmp_path):
    d = str(tmp_path / "ck")
    seen = [(newest_complete_tag(d), jax_newest_complete_tag(d))]
    os.makedirs(os.path.join(d, "step_2"))
    open(os.path.join(d, "step_2", ".done"), "w").write("ok")
    open(os.path.join(d, "newest"), "w").write("step_2")
    seen.append((newest_complete_tag(d), jax_newest_complete_tag(d)))
    # a stale pointer (a tag without .done) falls back to the newest done
    os.makedirs(os.path.join(d, "step_4"))
    open(os.path.join(d, "newest"), "w").write("step_4")
    seen.append((newest_complete_tag(d), jax_newest_complete_tag(d)))
    assert seen == [(None, None), ("step_2", "step_2"),
                    ("step_2", "step_2")]
    assert newest_complete_tag(None) is None


@pytest.mark.parametrize("rc,tail", [
    (0, ""), (-15, ""), (-9, ""), (-200, ""), (1, "InjectedFault: at x"),
    (1, "RetriesExhausted"), (1, "PolicyHalt"), (1, "loss went non-finite"),
    (1, "NaN loss"), (1, "Traceback (most recent call last)\nValueError"),
    (7, ""), (43, "faults: fired a/b action=kill"),
])
def test_classify_exit_matches_jax(rc, tail):
    assert classify_exit(rc, tail) == jax_classify_exit(rc, tail)


def test_restart_backoff_matches_jax():
    for kw in (dict(max_restarts=4, base_s=0.5, max_s=3.0),
               dict(max_restarts=0), dict(max_restarts=2, base_s=0.01)):
        a, b = RestartBackoff(**kw), JaxRestartBackoff(**kw)
        seq = [(a.next_delay(), b.next_delay()) for _ in range(6)]
        assert all(x == y for x, y in seq)
        assert a.exhausted == b.exhausted
    with pytest.raises(ValueError):
        RestartBackoff(-1)


# -- chaos through the serving engine, beside the JAX engine ---------------------


def _summary(outs):
    return {o.request_id: (o.state, o.finish_reason, list(o.token_ids))
            for o in outs}


def _drained(engine):
    engine._kv.assert_invariants()
    engine.scheduler.assert_invariants()
    assert engine._kv.leaked_pages() == 0


def _both(**kw):
    jpim, tpim, _, _, cfg = build_pair()
    return (JaxServingEngine(jpim, page_size=PAGE, num_pages=NUM_PAGES,
                             async_decode=kw.pop("jax_async", False), **kw),
            ServingEngine(tpim, page_size=PAGE, num_pages=NUM_PAGES,
                          device="cpu", **kw), cfg)


def test_page_alloc_fault_reclaims_like_jax():
    """A fault between the prompt-page and decode-page allocations fails
    the one request, takes back every page, and the engine serves on."""
    runs = {}
    for name, engine, cls in zip(("jax", "port"), _both()[:2],
                                 (JaxRequest, Request)):
        base = engine._kv.alloc.in_use
        (jax_faults if name == "jax" else faults).install_plan(
            {"faults": [{"point": "serving/page_alloc",
                         "action": "exception",
                         "match": {"request_id": 0}}]})
        engine.submit(cls(request_id=0, prompt_ids=[1, 2, 3, 4],
                          max_new_tokens=4))
        with pytest.raises((InjectedFault, jax_faults.InjectedFault)):
            engine.step()
        assert engine._kv.alloc.in_use == base
        assert not engine._kv._slot_pages[0]
        engine._kv.assert_invariants()
        engine.submit(cls(request_id=1, prompt_ids=[5, 6, 7],
                          max_new_tokens=3))
        runs[name] = _summary(engine.run_until_complete(max_steps=100))
    assert runs["port"] == runs["jax"]
    assert runs["port"][1][0] == "finished"
    assert _events(faults) == _events(jax_faults)
    assert _events(faults)[0][2] == {"request_id": 0, "engine_step": 1}


def test_poisoned_prefill_never_enters_prefix_cache():
    """A NaN prefill fails its request before any token, is never
    registered, and the identical prompt then prefills afresh."""
    prompt = [2, 7, 1, 8]
    runs = {}
    for name, engine, cls in zip(("jax", "port"), _both()[:2],
                                 (JaxRequest, Request)):
        mod = jax_faults if name == "jax" else faults
        mod.install_plan({"faults": [{"point": "serving/prefill_logits",
                                      "action": "nan",
                                      "match": {"request_id": 0}}]})
        engine.submit(cls(request_id=0, prompt_ids=prompt, max_new_tokens=4))
        engine.submit(cls(request_id=1, prompt_ids=[1, 2, 3],
                          max_new_tokens=2))
        outs = engine.run_until_complete(max_steps=100)
        first = {o.request_id: o for o in outs}
        assert first[0].ttft_ms is None and first[0].token_ids == ()
        engine.submit(cls(request_id=2, prompt_ids=prompt, max_new_tokens=4))
        runs[name] = _summary(outs + engine.run_until_complete(max_steps=100))
    assert runs["port"] == runs["jax"]
    assert runs["port"][0][:2] == ("failed", "non_finite_logits")
    assert runs["port"][2][0] == "finished"
    assert engine._kv.prefill_skipped == 0  # nothing poisoned was replayed
    _drained(engine)


def test_prefix_hit_runs_no_prefill():
    """Counting prefills through the fault plane (an unlimited zero-second
    sleep at ``serving/prefill_logits``): an exact repeated prompt takes
    none, in both engines."""
    prompt = [3, 1, 4, 1, 5, 9]
    plan = {"faults": [{"point": "serving/prefill_logits", "action": "sleep",
                        "seconds": 0, "count": 0}]}
    counts = {}
    for name, engine, cls in zip(("jax", "port"), _both()[:2],
                                 (JaxRequest, Request)):
        mod = jax_faults if name == "jax" else faults
        mod.install_plan(plan)
        tokens = []
        for rid in range(2):
            engine.submit(cls(request_id=rid, prompt_ids=prompt,
                              max_new_tokens=4))
            [o] = engine.run_until_complete(max_steps=100)
            tokens.append(list(o.token_ids))
        counts[name] = (len(mod.fired_events()), tokens)
    assert counts["port"] == counts["jax"]
    assert counts["port"][0] == 1
    assert counts["port"][1][0] == counts["port"][1][1]
    assert engine._kv.prefill_skipped == 1


@pytest.mark.parametrize("async_decode", [True, False])
def test_decode_nan_on_one_slot_fails_only_that_request(async_decode):
    """A NaN on one slot's decode logits fails that request with
    ``non_finite_logits``; the co-batched requests keep JAX's tokens and
    the quarantined slot serves again."""
    jpim, tpim, _, _, cfg = build_pair()
    rs = np.random.RandomState(4)
    prompts = [rs.randint(1, cfg.vocab_size, size=5).tolist()
               for _ in range(3)]
    runs = {}
    for name, pim, cls, mod in (("jax", jpim, JaxRequest, jax_faults),
                                ("port", tpim, Request, faults)):
        engine = (JaxServingEngine(pim, page_size=PAGE, num_pages=NUM_PAGES,
                                   async_decode=async_decode)
                  if name == "jax" else
                  ServingEngine(pim, page_size=PAGE, num_pages=NUM_PAGES,
                                async_decode=async_decode, device="cpu"))
        for rid in range(3):
            engine.submit(cls(request_id=rid, prompt_ids=prompts[rid],
                              max_new_tokens=6))
        outs = engine.step()
        slot = {r.request_id: s for s, r in engine.scheduler.active()}[1]
        mod.install_plan({"faults": [{"point": "serving/decode_logits",
                                      "action": "nan", "slot": slot}]})
        outs += engine.run_until_complete(max_steps=200)
        mod.clear_plan()
        engine.submit(cls(request_id=7, prompt_ids=prompts[0],
                          max_new_tokens=3))
        runs[name] = _summary(outs + engine.run_until_complete(max_steps=100))
    assert runs["port"] == runs["jax"]
    assert runs["port"][1][:2] == ("failed", "non_finite_logits")
    assert {runs["port"][i][0] for i in (0, 2, 7)} == {"finished"}
    _drained(engine)


def test_verify_nan_fails_in_flight_requests_and_recovers():
    """A NaN on the verify logits fails every request of that round; the
    engine then serves a fresh request with JAX's tokens."""
    jpim, tpim, _, _, cfg = build_pair(3, 32, 0)
    rs = np.random.RandomState(3)
    prompts = [rs.randint(1, cfg.vocab_size, size=5).tolist()
               for _ in range(3)]
    runs = {}
    for name, pim, cls, mod in (("jax", jpim, JaxRequest, jax_faults),
                                ("port", tpim, Request, faults)):
        kw = dict(page_size=PAGE, num_pages=40, draft=pim, spec_k=2)
        engine = (JaxServingEngine(pim, async_decode=False, **kw)
                  if name == "jax" else
                  ServingEngine(pim, device="cpu", **kw))
        mod.install_plan({"faults": [{"point": "serving/verify_logits",
                                      "action": "nan"}]})
        for rid in range(2):
            engine.submit(cls(request_id=rid, prompt_ids=prompts[rid],
                              max_new_tokens=6))
        outs = engine.run_until_complete(max_steps=100)
        mod.clear_plan()
        engine.submit(cls(request_id=7, prompt_ids=prompts[2],
                          max_new_tokens=4))
        runs[name] = _summary(outs + engine.run_until_complete(max_steps=100))
    assert runs["port"] == runs["jax"]
    assert [runs["port"][i][:2] for i in (0, 1)] == [
        ("failed", "non_finite_logits")] * 2
    assert runs["port"][7][0] == "finished"
    _drained(engine)


def test_draft_nan_fails_the_round():
    """``serving/draft_logits`` fires once per proposal position with the
    same context as JAX's; a NaN there fails the round's requests."""
    jpim, tpim, _, _, cfg = build_pair(3, 32, 0)
    runs = {}
    for name, pim, cls, mod in (("jax", jpim, JaxRequest, jax_faults),
                                ("port", tpim, Request, faults)):
        kw = dict(page_size=PAGE, num_pages=40, draft=pim, spec_k=2)
        engine = (JaxServingEngine(pim, async_decode=False, **kw)
                  if name == "jax" else
                  ServingEngine(pim, async_decode=False, device="cpu", **kw))
        mod.install_plan({"faults": [{"point": "serving/draft_logits",
                                      "action": "nan",
                                      "match": {"round_pos": 1}}]})
        engine.submit(cls(request_id=0, prompt_ids=[4, 5, 6],
                          max_new_tokens=6))
        runs[name] = _summary(engine.run_until_complete(max_steps=100))
    assert runs["port"] == runs["jax"]
    assert runs["port"][0][:2] == ("failed", "non_finite_logits")
    assert _events(faults) == _events(jax_faults)


# -- tenancy chaos ---------------------------------------------------------------


def test_store_adapter_load_fault_leaks_nothing():
    """The fault-plan twin of the raising-allocator test: a fault at
    ``tenancy/adapter_load`` frees every page taken, as in JAX's store, and
    the next acquire loads in full."""
    from test_torch_tenancy import _stores

    jpim, tpim, _, _, _ = build_pair()
    jstore, store = _stores(jpim, tpim)
    _install_both({"faults": [{"point": "tenancy/adapter_load",
                               "action": "exception",
                               "match": {"adapter_id": 1}}]})
    for s, err in ((store, InjectedFault),
                   (jstore, jax_faults.InjectedFault)):
        with pytest.raises(err):
            s.acquire(1)
        s.assert_invariants()
        assert s.alloc.in_use == 0 and 1 not in s.resident_ids()
    assert _events(faults) == _events(jax_faults)
    for s in (store, jstore):
        assert len(s.acquire(1)) == s.layout.pages_per_adapter
        s.release(1)


def test_adapter_faults_in_the_engine_fail_one_request():
    """A fault at ``serving/page_alloc`` on an adapter request releases
    its pin with its pages; one at ``tenancy/adapter_load`` fails only
    that request while another adapter's request finishes with JAX's
    tokens."""
    from test_torch_tenancy import _stores

    jpim, tpim, _, _, _ = build_pair()
    runs = {}
    for name in ("jax", "port"):
        jstore, tstore = _stores(jpim, tpim)
        store = jstore if name == "jax" else tstore
        mod = jax_faults if name == "jax" else faults
        cls = JaxRequest if name == "jax" else Request
        engine = (JaxServingEngine(jpim, page_size=PAGE, num_pages=NUM_PAGES,
                                   async_decode=False, adapter_store=store)
                  if name == "jax" else
                  ServingEngine(tpim, page_size=PAGE, num_pages=NUM_PAGES,
                                adapter_store=store, device="cpu"))
        mod.install_plan({"faults": [
            {"point": "serving/page_alloc", "action": "exception",
             "match": {"request_id": 0}},
            {"point": "tenancy/adapter_load", "action": "exception",
             "match": {"adapter_id": 2}}]})
        engine.submit(cls(request_id=0, prompt_ids=[1, 2, 3, 4],
                          max_new_tokens=4, adapter_id=1))
        with pytest.raises(mod.InjectedFault):
            engine.step()
        assert store.pins(1) == 0
        engine.submit(cls(request_id=1, prompt_ids=[1, 2, 3],
                          max_new_tokens=3, adapter_id=1))
        engine.submit(cls(request_id=2, prompt_ids=[4, 5, 6],
                          max_new_tokens=3, adapter_id=2))
        with pytest.raises(mod.InjectedFault):
            engine.run_until_complete(max_steps=100)
        outs = engine.run_until_complete(max_steps=100)
        store.assert_invariants()
        engine._kv.assert_invariants()
        assert all(store.pins(a) == 0 for a in store.resident_ids())
        assert store.alloc.in_use == store.layout.pages_per_adapter
        runs[name] = (_summary(outs), [(e[0], e[2]) for e in
                                       _events(mod)])
    assert runs["port"] == runs["jax"]
    assert runs["port"][0][1][0] == "finished"
