"""PyTorch port: crash consistency of training (chaos), the counterparts of
JAX ``tests/test_resilience.py:483`` and its supervisor demo.

A tiny worker process trains 8 steps with ``fit`` (cadence checkpoints
every 2, 2 kept, ``resume=True``).  For each of the five ``ckpt/*`` kill
points a fault plan kills the process hard mid-save; a fresh process then
finds ``newest`` on a complete tag, and the resumed run's losses equal the
uninterrupted run's exactly.  The supervised run survives one injected
crash (restart, resume from the newest tag) and one injected NaN (an
in-process policy rollback), all visible in ``supervisor_events.jsonl``
and the obs report.  Each worker is a fresh process of a few seconds.
"""

import json
import os
import subprocess
import sys

import pytest

from neuronx_distributed_tpu_torch.resilience import (
    ENV_VAR,
    KILL_EXIT_CODE,
    Supervisor,
)
from neuronx_distributed_tpu_torch.trainer.checkpoint import newest_tag

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = '''
import json, os, sys
sys.path.insert(0, sys.argv[2])
import numpy as np, torch
from neuronx_distributed_tpu_torch.config import training_config
from neuronx_distributed_tpu_torch.models.common import causal_lm_loss_sum
from neuronx_distributed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from neuronx_distributed_tpu_torch.trainer import (
    Callback, fit, initialize_parallel_model, initialize_parallel_optimizer)

def data(step):
    ids = np.random.RandomState(100 + step).randint(0, 64, (4, 8)).astype(np.int32)
    return {"ids": ids, "labels": np.roll(ids, -1, axis=1)}

class Losses(Callback):
    def on_step(self, step, metrics):
        print(json.dumps({"step": step, "loss": metrics["loss"]}), flush=True)

ckpt_dir, mode = sys.argv[1], sys.argv[3]
config = training_config(learning_rate=5e-3, compute_dtype="float32")
cfg = LlamaConfig.tiny(vocab_size=64, hidden_size=32, intermediate_size=64,
                       num_layers=1, num_heads=4, num_kv_heads=2,
                       dtype=torch.float32, param_dtype=torch.float32)
model = initialize_parallel_model(
    config, lambda d: LlamaForCausalLM(cfg, device=d), device="cpu")
opt = initialize_parallel_optimizer(config, model)
kw = {}
if mode == "policy":
    from neuronx_distributed_tpu_torch.resilience import AnomalyPolicy
    kw["policy"] = AnomalyPolicy(on_nan="rollback", max_rollbacks=2)
    kw["obs"] = os.path.join(os.path.dirname(ckpt_dir), "obs")
res = fit(config, model, opt, data, steps=8, loss_fn=causal_lm_loss_sum,
          ckpt_dir=ckpt_dir, ckpt_every=2, keep_ckpts=2, resume=True,
          async_save=False, log_every=0, callbacks=[Losses()], **kw)
print("WORKER-DONE steps_run=%d start=%d" % (res.steps_run, res.start_step),
      flush=True)
'''

# the five kill points; mid_rotation fires on the first rotation (saving
# step_6 rotates step_2 out under keep_ckpts=2)
KILL_POINTS = [
    ("ckpt/pre_shard_write", "step_4"),
    ("ckpt/mid_shard_write", "step_4"),
    ("ckpt/pre_done", "step_4"),
    ("ckpt/pre_newest", "step_4"),
    ("ckpt/mid_rotation", "step_6"),
]


def _run(worker, ckpt_dir, tmp_path, label, plan=None, mode="plain"):
    env = dict(os.environ)
    env.pop(ENV_VAR, None)
    if plan is not None:
        env[ENV_VAR] = json.dumps(plan)
    out = tmp_path / f"{label}.log"
    with open(out, "w") as f:
        proc = subprocess.run(
            [sys.executable, str(worker), str(ckpt_dir), REPO, mode],
            stdout=f, stderr=subprocess.STDOUT, env=env, timeout=240)
    return proc.returncode, out.read_text()


def _losses(text):
    out = {}
    for line in text.splitlines():
        if line.startswith("{"):
            rec = json.loads(line)
            out[rec["step"]] = rec["loss"]
    return out


@pytest.fixture(scope="module")
def worker(tmp_path_factory):
    path = tmp_path_factory.mktemp("chaos") / "worker.py"
    path.write_text(_WORKER)
    return path


@pytest.fixture(scope="module")
def baseline(worker, tmp_path_factory):
    d = tmp_path_factory.mktemp("base")
    rc, log = _run(worker, d / "ck", d, "base")
    assert rc == 0, log[-3000:]
    losses = _losses(log)
    assert sorted(losses) == list(range(8))
    return losses


@pytest.mark.chaos
@pytest.mark.parametrize("point,tag", KILL_POINTS)
def test_checkpoint_kill_point(worker, baseline, tmp_path, point, tag):
    """A hard exit at ``point`` while saving ``tag`` leaves ``newest`` on a
    complete checkpoint, and the resumed run's losses equal the
    uninterrupted run's."""
    ckpt_dir = tmp_path / "ck"
    plan = {"faults": [{"point": point, "action": "kill",
                        "match": {"tag": tag}}]}
    rc, log_a = _run(worker, ckpt_dir, tmp_path, "kill", plan)
    assert rc == KILL_EXIT_CODE, (point, rc, log_a[-3000:])
    found = newest_tag(str(ckpt_dir))
    assert found is not None, (point, os.listdir(ckpt_dir))
    assert (ckpt_dir / found / ".done").exists()
    meta = json.loads((ckpt_dir / found / "meta.json").read_text())
    assert meta["user_content"]["step"] == int(found.split("_")[1])
    rc, log_b = _run(worker, ckpt_dir, tmp_path, "resume")
    assert rc == 0 and "WORKER-DONE" in log_b, log_b[-3000:]
    covered = _losses(log_a)
    covered.update(_losses(log_b))
    assert covered == baseline, point


@pytest.mark.chaos
def test_supervisor_survives_a_crash_and_a_nan(worker, tmp_path):
    """One injected exception kills the first process at step 3 (after the
    step_2 save): the supervisor restarts it and it resumes from step_2;
    the restarted process meets a NaN at step 5 and the policy rolls back
    to step_4 in process.  Both show in the events and the obs report."""
    ckpt_dir, obs_dir = tmp_path / "ck", tmp_path / "obs"
    os.makedirs(obs_dir)
    events_path = str(obs_dir / "supervisor_events.jsonl")
    plan = {"faults": [
        {"point": "fit/step_start", "action": "exception",
         "match": {"step": 3, "start_step": 0}},
        {"point": "fit/loss", "action": "nan", "match": {"step": 5}}]}
    env = dict(os.environ, **{ENV_VAR: json.dumps(plan)})
    sup = Supervisor([sys.executable, str(worker), str(ckpt_dir), REPO,
                      "policy"], max_restarts=2, backoff_base_s=0.1,
                     ckpt_dir=str(ckpt_dir), events_path=events_path,
                     log_path=str(tmp_path / "child.log"), env=env)
    res = sup.run()
    log = (tmp_path / "child.log").read_text()
    assert res.ok, log[-4000:]
    assert res.restarts == 1 and res.causes == ["injected_fault"]
    starts = [e for e in sup.events if e["event"] == "start"]
    assert starts[1]["resume_tag"] == "step_2"
    assert "WORKER-DONE steps_run=6 start=2" in log

    from neuronx_distributed_tpu_torch.obs.report import build_report
    from neuronx_distributed_tpu_torch.obs.schemas import validate_record

    report = build_report(run_dir=str(obs_dir))
    validate_record("obs_report", report)
    assert report["supervisor"]["restarts"] == 1
    assert report["supervisor"]["crash_causes"] == ["injected_fault"]
    assert report["supervisor"]["succeeded"]
    assert report["scalars"]["resilience/rollbacks_total"]["last"] == 1.0
    assert any(w["detector"] == "nan_loss" for w in report["anomalies"])
