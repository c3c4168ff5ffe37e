"""PyTorch port: ``fit()`` against the JAX package's ``fit()``, and its
behaviour.

Parity: the tiny GQA Llama in fp32, initialised by JAX and moved into the
port with ``llama_params_from_jax``, runs both ``fit``s on the same
``data(step)``, warmup + cosine schedule, ``grad_accum_steps=2``, eval and
checkpoint cadence.  The loss trajectories agree within rtol 1e-5 (fp32
sums in another order), the eval histories within the same, and the
``FitResult`` steps, the callback event order (JAX
``tests/test_trainer.py:239``) and the kept checkpoint tags are equal.

Behaviour, port only: an interrupted and resumed run equals the
uninterrupted one exactly; the deferred, prefetched, guarded loop equals
the synchronous one exactly; SIGTERM finishes the step and checkpoints;
the anomaly policy skips and rolls back as JAX ``tests/test_resilience.py:
130-365`` asks; early stop, the iterator fast-forward error, telemetry
and the metrics file.
"""

import json
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neuronx_distributed_tpu as nxd
from neuronx_distributed_tpu.models.common import (
    causal_lm_loss_sum as jax_causal_lm_loss_sum,
)
from neuronx_distributed_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig,
    LlamaForCausalLM as JaxLlama,
)
from neuronx_distributed_tpu.parallel import mesh as jax_mesh
from neuronx_distributed_tpu.trainer import (
    Callback as JaxCallback,
    fit as jax_fit,
    initialize_parallel_model as jax_init_model,
    initialize_parallel_optimizer as jax_init_opt,
)
from neuronx_distributed_tpu_torch.config import training_config
from neuronx_distributed_tpu_torch.convert import llama_params_from_jax
from neuronx_distributed_tpu_torch.models.common import causal_lm_loss_sum
from neuronx_distributed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from neuronx_distributed_tpu_torch.obs import Observability
from neuronx_distributed_tpu_torch.resilience import (
    AnomalyPolicy,
    clear_plan,
    install_plan,
)
from neuronx_distributed_tpu_torch.trainer import (
    Callback,
    TrainingMetrics,
    fit,
    initialize_parallel_model,
    initialize_parallel_optimizer,
)

B, S = 4, 16
OPT = dict(learning_rate=2e-3, lr_schedule="cosine", warmup_steps=2,
           total_steps=8, min_lr_ratio=0.1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_plan():
    clear_plan()
    yield
    clear_plan()


def data(step):
    rs = np.random.RandomState(100 + step)
    ids = rs.randint(0, 256, (B, S)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1)
    labels[rs.rand(B, S) < 0.2] = -100
    return {"ids": ids, "labels": labels}


def jax_build():
    jax_mesh.destroy_model_parallel()
    jax_mesh.initialize_model_parallel(tensor_parallel_size=1,
                                       devices=jax.devices()[:1])
    config = nxd.training_config(tensor_parallel_size=1, seed=0,
                                 param_dtype="float32",
                                 compute_dtype="float32", **OPT)
    jcfg = JaxLlamaConfig.tiny(num_kv_heads=2, dtype=jnp.float32,
                               param_dtype=jnp.float32,
                               sequence_parallel=False, remat="none",
                               max_seq_len=S)
    model = jax_init_model(config, lambda: JaxLlama(jcfg),
                           (jnp.zeros((1, S), jnp.int32),))
    params0 = jax.tree.map(np.asarray, model.params)
    return config, model, jax_init_opt(config, model), params0


@pytest.fixture(scope="module")
def params0():
    return jax_build()[3]


def port_build(params, **cfg_kw):
    config = training_config(seed=0, compute_dtype="float32", **OPT)
    cfg = LlamaConfig.tiny(num_kv_heads=2, dtype=torch.float32,
                           param_dtype=torch.float32, max_seq_len=S,
                           **cfg_kw)
    model = initialize_parallel_model(
        config, lambda d: LlamaForCausalLM(cfg, device=d), device="cpu")
    model.module.load_state_dict(llama_params_from_jax(params, cfg))
    return config, model, initialize_parallel_optimizer(config, model)


def _recorder(base, events):
    class Recorder(base):
        def on_fit_start(self, step, *a):
            events.append(("fit_start", step))

        def on_step(self, step, metrics):
            assert isinstance(metrics["loss"], float)
            events.append(("step", step, metrics["loss"]))

        def on_eval(self, step, metrics):
            events.append(("eval", step, metrics["eval_loss"]))

        def on_checkpoint(self, step, path):
            assert os.path.isdir(path)
            events.append(("ckpt", step))

        def on_fit_end(self, result):
            events.append(("fit_end", result.steps_run))
    return Recorder()


def _tags(d):
    return sorted(t for t in os.listdir(d) if t.startswith("step_"))


def _same_events(a, b):
    assert [e[:2] for e in a] == [e[:2] for e in b]
    for x, y in zip(a, b):
        if len(x) == 3:
            assert x[2] == pytest.approx(y[2], rel=1e-5), (x, y)


def test_fit_matches_jax(params0, tmp_path):
    """Loss trajectory, eval history, result steps, callback event order
    and kept tags equal JAX's fit on the same data and schedule."""
    config, model, opt, _ = jax_build()
    jax_events = []
    jres = jax_fit(config, model, opt, data, steps=7,
                   loss_fn=jax_causal_lm_loss_sum, grad_accum_steps=2,
                   eval_data=data, eval_every=3,
                   ckpt_dir=str(tmp_path / "jax"), ckpt_every=2,
                   keep_ckpts=2, async_save=False, log_every=0,
                   callbacks=[_recorder(JaxCallback, jax_events)])
    jax_mesh.destroy_model_parallel()
    pconfig, pmodel, popt = port_build(params0)
    events = []
    res = fit(pconfig, pmodel, popt, data, steps=7,
              loss_fn=causal_lm_loss_sum, grad_accum_steps=2,
              eval_data=data, eval_every=3, ckpt_dir=str(tmp_path / "port"),
              ckpt_every=2, keep_ckpts=2, async_save=False, log_every=0,
              callbacks=[_recorder(Callback, events)])
    _same_events(events, jax_events)
    assert events[0] == ("fit_start", 0) and events[-1] == ("fit_end", 7)
    assert [e[1] for e in events if e[0] == "ckpt"] == [2, 4, 6, 7]
    assert (res.steps_run, res.start_step) == (jres.steps_run,
                                               jres.start_step)
    assert [s for s, _ in res.eval_history] == [3, 6]
    for (s, a), (t, b) in zip(res.eval_history, jres.eval_history):
        assert s == t and a == pytest.approx(b, rel=1e-5)
    assert res.final_loss == pytest.approx(jres.final_loss, rel=1e-5)
    assert _tags(tmp_path / "port") == _tags(tmp_path / "jax") == \
        ["step_6", "step_7"]


def _losses(params, steps, **kw):
    config, model, opt = port_build(params)
    seen = []
    res = fit(config, model, opt, data, steps=steps,
              loss_fn=causal_lm_loss_sum, log_every=0,
              on_step=lambda s, m: seen.append((s, m["loss"])), **kw)
    return seen, res, model


def test_interrupted_resume_identical(params0, tmp_path):
    """6 steps, a final checkpoint, then a fresh model resumed to 10: the
    losses and final parameters equal an uninterrupted 10-step run's
    exactly (parameters, AdamW state and the schedule's count restored)."""
    full, _, m_full = _losses(params0, 10)
    ck = str(tmp_path / "ck")
    first, _, _ = _losses(params0, 6, ckpt_dir=ck, ckpt_every=100)
    rest, res, m_res = _losses(params0, 10, ckpt_dir=ck, resume=True)
    assert res.start_step == 6
    assert first + rest == full
    for (n, a), (_, b) in zip(m_full.module.named_parameters(),
                              m_res.module.named_parameters()):
        assert torch.equal(a, b), n


def test_deferred_prefetched_guarded_equals_sync(params0, tmp_path):
    """``prefetch=2``, deferred metrics and ``transfer_guard="forbid"``
    give the synchronous loop's losses exactly; every step is published,
    in order, and the staging thread is gone after the run."""
    sync, _, _ = _losses(params0, 6)
    hub = Observability(str(tmp_path / "obs"))
    fast, res, _ = _losses(params0, 6, prefetch=2, defer_metrics=True,
                           transfer_guard="forbid", obs=hub)
    assert fast == sync
    snap = hub.registry.snapshot()
    assert snap["transfer/explicit_fetches_total"] == 6
    assert snap["transfer/guarded_sections_total"] == 6
    assert snap["data/prefetch_batches_staged_total"] >= 6
    import threading

    assert not any(t.name.endswith("-prefetch") and t.is_alive()
                   for t in threading.enumerate())


def test_fit_records_telemetry_and_metrics(params0, tmp_path):
    """``obs=`` with ledgers and perf: one flight record a step with the
    host / device / data-wait split, the compile ledger's ``train_step``
    row, the perf attribution's ``train_step`` phase, the memory ledger's
    parameter bytes; the metrics file carries the summary and MFU."""
    hub = Observability(str(tmp_path / "obs"), ledgers=True, perf=True)
    metrics = TrainingMetrics(str(tmp_path / "m.json"))
    _losses(params0, 4, obs=hub, metrics=metrics, flops_per_token=1e6,
            peak_flops=1e12)
    recs = list(hub.flight.records)
    assert [r["step"] for r in recs] == [0, 1, 2, 3]
    for r in recs:
        assert {"host_s", "device_s", "data_wait_s", "step_time_s",
                "loss"} <= set(r)
    rows = [r for r in hub.compile_ledger.rows if r["family"] == "train_step"]
    assert len(rows) == 1 and rows[0]["kind"] == "eager"
    assert hub.memory_ledger.subsystems()["params"]["bytes"] > 0
    assert any(r["family"] == "train_step"
               for r in hub.perf.attribution())
    for name in ("flight_record.json", "metrics.prom", "scalars.jsonl",
                 "compile_ledger.jsonl", "perf_attribution.jsonl"):
        assert os.path.exists(tmp_path / "obs" / name), name
    summary = json.load(open(tmp_path / "m.json"))
    assert summary["completed_steps"] == 4 and summary["mfu"] > 0


def test_early_stop_and_reused_callback(params0, tmp_path):
    class StopAt2(Callback):
        def on_step(self, step, metrics):
            if step == 2:
                self.should_stop = True

    stopper = StopAt2()
    config, model, opt = port_build(params0)
    res = fit(config, model, opt, data, steps=10, loss_fn=causal_lm_loss_sum,
              ckpt_dir=str(tmp_path / "ck"), log_every=0, callbacks=[stopper])
    assert res.steps_run == 3 and _tags(tmp_path / "ck") == ["step_3"]
    ckpts = []

    class CkptRec(Callback):
        def on_checkpoint(self, step, path):
            ckpts.append(step)

    config, model, opt = port_build(params0)
    res = fit(config, model, opt, data, steps=10, loss_fn=causal_lm_loss_sum,
              ckpt_dir=str(tmp_path / "ck3"), ckpt_every=3, log_every=0,
              callbacks=[stopper, CkptRec()], async_save=False)
    assert res.steps_run == 3 and ckpts == [3]


def test_policy_skip_discards_update(params0):
    """A NaN injected at step 3 is skipped: one skip event, no callback for
    the step, and the run ends finite."""
    install_plan({"faults": [
        {"point": "fit/loss", "action": "nan", "match": {"step": 3}}]})
    seen, res, _ = _losses(params0, 6, policy=AnomalyPolicy(on_nan="skip"))
    assert [e["action"] for e in res.policy_events] == ["skip"]
    assert res.policy_events[0]["step"] == 3
    assert [s for s, _ in seen] == [0, 1, 2, 4, 5]
    assert np.isfinite(res.final_loss)


def test_policy_skip_restores_the_pre_step_state(params0):
    """A skipped step leaves exactly the pre-step parameters and update
    count."""
    config, model, opt = port_build(params0)
    before = {n: p.detach().clone() for n, p in model.module.named_parameters()}
    install_plan({"faults": [
        {"point": "fit/loss", "action": "nan", "match": {"step": 0}}]})
    res = fit(config, model, opt, data, steps=1, loss_fn=causal_lm_loss_sum,
              log_every=0, policy=AnomalyPolicy(on_nan="skip"))
    assert res.policy_events[0]["action"] == "skip"
    for n, p in model.module.named_parameters():
        assert torch.equal(p, before[n]), n
    assert opt.update_count == 0


def test_policy_rollback_rewinds_and_completes(params0, tmp_path):
    install_plan({"faults": [
        {"point": "fit/loss", "action": "nan", "match": {"step": 4}}]})
    seen, res, _ = _losses(params0, 6, ckpt_dir=str(tmp_path / "ck"),
                           ckpt_every=2, async_save=False,
                           policy=AnomalyPolicy(on_nan="rollback"))
    assert [e["action"] for e in res.policy_events] == ["rollback"]
    assert [s for s, _ in seen] == [0, 1, 2, 3, 4, 5]
    assert res.steps_run == 6


def test_policy_and_resume_errors(params0, tmp_path):
    config, model, opt = port_build(params0)
    kw = dict(steps=4, loss_fn=causal_lm_loss_sum, log_every=0)
    with pytest.raises(ValueError, match="cannot be re-wound"):
        fit(config, model, opt, iter([data(i) for i in range(4)]),
            ckpt_dir=str(tmp_path / "ck"),
            policy=AnomalyPolicy(on_nan="rollback"), **kw)
    with pytest.raises(ValueError, match="requires ckpt_dir"):
        fit(config, model, opt, data,
            policy=AnomalyPolicy(on_nan="rollback"), **kw)
    with pytest.raises(ValueError, match="incompatible with policy"):
        fit(config, model, opt, data, defer_metrics=True,
            policy=AnomalyPolicy(), **kw)
    with pytest.raises(ValueError, match="requires ckpt_dir"):
        fit(config, model, opt, data, checkpoint_on_signal=True, **kw)
    fit(config, model, opt, data, ckpt_dir=str(tmp_path / "ck2"),
        async_save=False, **kw)
    meta = json.load(open(tmp_path / "ck2" / "step_4" / "meta.json"))
    assert meta["user_content"] == {"step": 4, "batches_consumed": 4}
    config, model, opt = port_build(params0)
    with pytest.raises(ValueError, match="batches_consumed=4"):
        fit(config, model, opt, iter([data(0), data(1)]), steps=8,
            loss_fn=causal_lm_loss_sum, log_every=0,
            ckpt_dir=str(tmp_path / "ck2"), resume=True)


def test_step_rng_gives_a_seeded_generator_per_step(params0):
    """``step_rng=True`` hands the step one CPU generator a step, seeded
    from ``(seed, step)``: the same draws on a rerun."""
    draws = []

    def loss(model, batch, generator=None):
        draws.append(torch.rand(1, generator=generator).item())
        return causal_lm_loss_sum(model, batch)

    for _ in range(2):
        config, model, opt = port_build(params0)
        fit(config, model, opt, data, steps=3, loss_fn=loss, log_every=0,
            step_rng=True)
    assert draws[:3] == draws[3:] and len(set(draws[:3])) == 3


_SIGNAL_WORKER = '''
import sys
import numpy as np, torch
sys.path.insert(0, sys.argv[2])
from neuronx_distributed_tpu_torch.config import training_config
from neuronx_distributed_tpu_torch.models.common import causal_lm_loss_sum
from neuronx_distributed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from neuronx_distributed_tpu_torch.trainer import (
    fit, initialize_parallel_model, initialize_parallel_optimizer)

config = training_config(learning_rate=1e-3, compute_dtype="float32")
cfg = LlamaConfig.tiny(dtype=torch.float32, param_dtype=torch.float32)
model = initialize_parallel_model(
    config, lambda d: LlamaForCausalLM(cfg, device=d), device="cpu")
opt = initialize_parallel_optimizer(config, model)
ids = np.random.RandomState(0).randint(0, 256, (4, 16)).astype(np.int32)
data = lambda step: {"ids": ids, "labels": np.roll(ids, -1, axis=1)}
res = fit(config, model, opt, data, steps=100000, loss_fn=causal_lm_loss_sum,
          ckpt_dir=sys.argv[1], log_every=1, checkpoint_on_signal=True)
print(f"SIGNAL-FIT-DONE steps_run={res.steps_run}", flush=True)
'''


def test_fit_checkpoint_on_sigterm(tmp_path):
    """SIGTERM mid-run finishes the step, writes the final checkpoint
    tagged with the last step, and returns normally."""
    worker = tmp_path / "worker.py"
    worker.write_text(_SIGNAL_WORKER)
    ckpt = str(tmp_path / "ck")
    out_path, err_path = tmp_path / "out.log", tmp_path / "err.log"
    with open(out_path, "w") as out_f, open(err_path, "w") as err_f:
        proc = subprocess.Popen([sys.executable, str(worker), ckpt, REPO],
                                stdout=out_f, stderr=err_f, text=True)
        deadline = time.time() + 120
        while time.time() < deadline:
            if '"step": 2' in out_path.read_text():
                break
            if proc.poll() is not None:
                raise AssertionError(err_path.read_text()[-3000:])
            time.sleep(0.1)
        else:
            proc.kill()
            raise AssertionError("worker never trained")
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise AssertionError("worker did not stop after SIGTERM")
    assert proc.returncode == 0, err_path.read_text()[-3000:]
    assert "SIGNAL-FIT-DONE" in out_path.read_text()
    steps = [int(t.split("_")[1]) for t in _tags(ckpt)]
    assert steps and 2 < max(steps) < 100000
