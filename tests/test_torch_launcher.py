"""PyTorch port: the Llama pretraining launcher and the supervisor's CLI,
on the CPU (``--device cpu``).

The launcher trains from an NXDT file through the native loader, writes
checkpoints and resumes from them to the uninterrupted run's exact final
loss, packs an eos-joined document stream (``--packed``: segment ids and
per-document positions into the model), runs as ``python -m``, and
refuses the JAX flags whose feature is not ported, naming the ROADMAP
item; at ``--cp 2`` it trains in a 2-rank gloo world, at ``--pp 2 --cp
2`` in a 4-rank one.  The supervisor's
CLI restarts a crashing command and reports one
JSON line.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from neuronx_distributed_tpu_torch.data import write_token_file
from neuronx_distributed_tpu_torch.examples import llama_pretrain
from neuronx_distributed_tpu_torch.resilience import supervisor
from neuronx_distributed_tpu_torch.utils.distributed import spawn
import torch_tp_workers as workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--device", "cpu", "--preset", "tiny", "--batch-size", "4",
        "--seq-len", "32", "--warmup-steps", "2"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    rng = np.random.RandomState(0)
    flat = str(d / "flat.nxdt")
    write_token_file(flat, rng.randint(0, 256, 4000).astype(np.int32))
    docs = []
    for _ in range(80):
        docs.append(rng.randint(1, 256, rng.randint(3, 40)))
        docs.append(np.array([0]))
    packed = str(d / "docs.nxdt")
    write_token_file(packed, np.concatenate(docs).astype(np.int32))
    return flat, packed


def test_train_checkpoint_resume(corpus, tmp_path):
    flat, _ = corpus
    args = BASE + ["--data", flat]
    full = llama_pretrain.main(args + ["--steps", "6"])
    assert full.data.dataset.is_native
    ck = str(tmp_path / "ck")
    part = llama_pretrain.main(args + ["--steps", "3", "--ckpt-dir", ck,
                                       "--ckpt-every", "2"])
    assert part.steps_run == 3
    assert sorted(os.listdir(ck)) == ["newest", "step_2", "step_3"]
    rest = llama_pretrain.main(args + ["--steps", "6", "--ckpt-dir", ck,
                                       "--resume", "--ckpt-bf16"])
    assert rest.start_step == 3 and rest.steps_run == 3
    assert rest.final_loss == full.final_loss
    meta = json.load(open(os.path.join(ck, "step_6", "meta.json")))
    assert meta["tensors"]["model"]["lm_head.kernel"]["dtype"] == "bfloat16"


def test_packed_runs_the_segment_path(corpus, tmp_path):
    _, packed = corpus
    res = llama_pretrain.main(BASE + ["--data", packed, "--packed",
                                      "--packed-eos-id", "0", "--steps", "3",
                                      "--attention", "flash",
                                      "--metrics-file",
                                      str(tmp_path / "m.json")])
    batch = res.data(0)
    assert set(batch) == {"ids", "labels", "positions", "segment_ids"}
    assert batch["segment_ids"].max() >= 2  # several documents a row
    assert np.isfinite(res.final_loss)
    m = json.load(open(tmp_path / "m.json"))
    assert m["completed_steps"] == 3 and m["mfu"] > 0


def test_module_entry_point(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "neuronx_distributed_tpu_torch.examples."
         "llama_pretrain", *BASE, "--steps", "2"],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
        env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(x) for x in proc.stdout.splitlines()
             if x.startswith("{")]
    assert [x["step"] for x in lines if "step" in x] == [0, 1]
    assert lines[-1]["done"] and lines[-1]["steps_run"] == 2


@pytest.mark.parametrize("flag,item", [
    (["--pp", "2"], "A15"), (["--scan-layers"], "not faults")])
def test_unported_flags_name_their_item(flag, item):
    """``--scan-layers`` is not ported and names its ROADMAP entry.
    ``--pp`` (A15) is ported: it parses with its schedule flags, and
    ``--loss-chunk`` with it is an error, as in JAX's launcher (the
    pipeline's last stage owns the head)."""
    if flag[0] == "--pp":
        args = llama_pretrain.parse_args(
            BASE + flag + ["--microbatches", "4", "--pp-schedule",
                           "interleaved", "--virtual-stages", "2"])
        assert (args.pp, args.microbatches, args.pp_schedule,
                args.virtual_stages) == (2, 4, "interleaved", 2)
        with pytest.raises(SystemExit):
            llama_pretrain.parse_args(BASE + flag + ["--loss-chunk", "8"])
        return
    with pytest.raises(NotImplementedError, match=item):
        llama_pretrain.parse_args(BASE + flag)


def test_cp_flag_lays_out_context_parallelism():
    """``--cp`` (A14) parses, a world of one is no cp = 2 layout, and a
    world of two trains through ``fit`` at cp = 2 (the ring on the flash
    path) to the loss of one process at cp = 1 on the same batches."""
    assert llama_pretrain.parse_args(BASE + ["--cp", "2"]).cp == 2
    with pytest.raises(ValueError, match="cp 2"):
        llama_pretrain.prepare(BASE + ["--cp", "2"])
    argv = BASE + ["--steps", "3", "--attention", "flash"]
    one = llama_pretrain.main(argv)
    ranks = spawn(workers.launcher_rank, 2, (argv + ["--cp", "2"],),
                  timeout_s=170)
    for loss, steps in ranks:
        assert steps == 3
        assert loss == pytest.approx(one.final_loss, rel=1e-5)


def test_pp_flag_trains_pipeline_stages():
    """``--pp 2`` (A15): a world of one is no pp = 2 layout, and a world of
    two trains two stages through ``fit`` (1F1B over 2 microbatches, then
    the interleaved schedule with a layer a chunk) to the loss of one
    process at pp = 1 on the same batches."""
    with pytest.raises(ValueError, match="pp 2"):
        llama_pretrain.prepare(BASE + ["--pp", "2"])
    argv = BASE + ["--steps", "3", "--num-layers", "4"]
    one = llama_pretrain.main(argv)
    for extra in (["--microbatches", "2"],
                  ["--microbatches", "4", "--pp-schedule", "interleaved",
                   "--virtual-stages", "2"]):
        ranks = spawn(workers.launcher_rank, 2,
                      (argv + ["--pp", "2"] + extra,), timeout_s=170)
        for loss, steps in ranks:
            assert steps == 3
            assert loss == pytest.approx(one.final_loss, rel=1e-5)


def test_pp_with_cp_trains_stages_over_context_chunks():
    """``--pp 2 --cp 2``: a world of four trains two pipeline stages, each
    holding its cp rank's chunk of every microbatch (the ring on the flash
    path), through ``fit`` to the loss of one process at pp = cp = 1 on
    the same batches."""
    argv = BASE + ["--steps", "3", "--attention", "flash"]
    one = llama_pretrain.main(argv)
    ranks = spawn(workers.launcher_rank, 4,
                  (argv + ["--pp", "2", "--cp", "2", "--microbatches", "2"],),
                  timeout_s=170)
    for loss, steps in ranks:
        assert steps == 3
        assert loss == pytest.approx(one.final_loss, rel=1e-5)


def test_flag_errors():
    with pytest.raises(SystemExit):
        llama_pretrain.parse_args(BASE + ["--ckpt-on-signal"])
    with pytest.raises(SystemExit):
        llama_pretrain.parse_args(BASE + ["--packed"])
    with pytest.raises(SystemExit):
        llama_pretrain.parse_args(BASE + ["--packed", "--data", "x"])


def test_supervisor_cli_restarts_a_crashing_command(tmp_path, capsys):
    state, script = tmp_path / "state", tmp_path / "child.py"
    script.write_text(
        "import os\n"
        f"p = {str(state)!r}\n"
        "n = int(open(p).read()) if os.path.exists(p) else 0\n"
        "open(p, 'w').write(str(n + 1))\n"
        "if n < 1:\n"
        "    raise RuntimeError('boom')\n")
    events = str(tmp_path / "ev.jsonl")
    rc = supervisor.main(["--max-restarts", "2", "--backoff-base", "0.01",
                          "--events", events, "--log",
                          str(tmp_path / "child.log"), "--",
                          sys.executable, str(script)])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["ok"] and out["restarts"] == 1
    assert out["causes"] == ["exception"]
    kinds = [json.loads(x)["event"] for x in open(events)]
    assert kinds == ["start", "exit", "restart", "start", "exit", "success"]
    with pytest.raises(SystemExit):
        supervisor.main(["--max-restarts", "1"])
