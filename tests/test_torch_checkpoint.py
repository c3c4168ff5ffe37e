"""PyTorch port: sharded checkpoints (``trainer/checkpoint.py``), the
counterpart of JAX ``tests/test_trainer.py:87-186`` and
``tests/test_distributed_ckpt.py``.

Round trip and rotation, the bf16 model-payload downcast (the optimizer
state never downcast), a resume whose next step equals the uninterrupted
one, the marker discipline (``newest`` on a complete tag only), a world of
2 ranks over one shared directory (sync saves with rotation and an
overwritten tag, an async save, each rank's piece and the whole tensor
re-sharded on load), and checkpoint swaps into a serving engine: a
checkpoint ``fit`` wrote, swapped in, serves the same tokens as an
in-memory swap of the same parameters, and a missing directory is an
audited failed attempt with the old weights serving.
"""

import json
import os

import numpy as np
import pytest
import torch

from neuronx_distributed_tpu_torch.config import training_config
from neuronx_distributed_tpu_torch.models.common import causal_lm_loss_sum
from neuronx_distributed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from neuronx_distributed_tpu_torch.serving import Request, ServingEngine
from neuronx_distributed_tpu_torch.trace import InferenceConfig, ParallelInferenceModel
from neuronx_distributed_tpu_torch.trainer import (
    Shard,
    fit,
    initialize_parallel_model,
    initialize_parallel_optimizer,
    load_checkpoint,
    make_train_step,
    model_shards,
    newest_tag,
    optimizer_shards,
    restore_model,
    restore_optimizer,
    save_checkpoint,
)
from neuronx_distributed_tpu_torch.trainer import checkpoint as ckpt_mod
from neuronx_distributed_tpu_torch.utils.distributed import spawn
from neuronx_distributed_tpu_torch.weights import SwapError, WeightSwapper
import torch_fit_workers as workers

CFG = LlamaConfig.tiny(num_kv_heads=2, dtype=torch.float32,
                       param_dtype=torch.float32, max_seq_len=16)


def build(seed=0, lr=5e-3):
    config = training_config(seed=seed, compute_dtype="float32",
                             learning_rate=lr)
    model = initialize_parallel_model(
        config, lambda d: LlamaForCausalLM(CFG, device=d), device="cpu")
    return config, model, initialize_parallel_optimizer(config, model)


def batch(i):
    ids = np.random.RandomState(i).randint(0, 256, (4, 16)).astype(np.int32)
    return {"ids": ids, "labels": np.roll(ids, -1, axis=1)}


def test_roundtrip_rotation_and_meta(tmp_path):
    config, model, opt = build()
    step = make_train_step(config, model, opt, causal_lm_loss_sum)
    step(batch(0))
    d = str(tmp_path / "ck")
    for i in range(4):
        save_checkpoint(d, f"step_{i}", model_shards(model),
                        optimizer_shards(model, opt),
                        user_content={"step": i}, num_kept_ckpts=2)
    assert newest_tag(d) == "step_3"
    assert sorted(t for t in os.listdir(d) if t.startswith("step_")) == \
        ["step_2", "step_3"]
    meta = json.load(open(os.path.join(d, "step_3", "meta.json")))
    assert meta["mesh"]["world_size"] == 1
    rec = meta["tensors"]["model"]["lm_head.kernel"]
    assert rec["shape"] == [64, 256] and rec["dtype"] == "float32"
    assert rec["shards"] == [{"rank": 0, "start": [0, 0], "size": [64, 256]}]
    _, model2, opt2 = build(seed=1)
    m, o, sched, user = load_checkpoint(
        d, model_template=model_shards(model2),
        optimizer_template=optimizer_shards(model2, opt2))
    assert user == {"step": 3} and sched is None and o["count"] == 1
    for n, p in model.module.named_parameters():
        assert torch.equal(m[n], p.detach()), n
    st = optimizer_shards(model, opt)
    for n, s in st["exp_avg_sq"].items():
        assert torch.equal(o["exp_avg_sq"][n], s.tensor), n


def test_bf16_downcast_keeps_optimizer_fp32(tmp_path):
    """``save_dtype=bf16`` halves the model payload; an fp32 template
    restores the bf16-rounded masters, the optimizer state stays fp32."""
    config, model, opt = build()
    make_train_step(config, model, opt, causal_lm_loss_sum)(batch(0))
    d = str(tmp_path / "ck")
    save_checkpoint(d, "t", model_shards(model), optimizer_shards(model, opt),
                    save_dtype=torch.bfloat16)
    meta = json.load(open(os.path.join(d, "t", "meta.json")))
    assert {r["dtype"] for r in meta["tensors"]["model"].values()} == \
        {"bfloat16"}
    assert {r["dtype"] for r in meta["tensors"]["optimizer"].values()} == \
        {"float32"}
    m, o, _, _ = load_checkpoint(
        d, model_template=model_shards(model),
        optimizer_template=optimizer_shards(model, opt))
    for n, p in model.module.named_parameters():
        assert m[n].dtype == torch.float32
        assert torch.equal(m[n], p.detach().bfloat16().float()), n
    for n, s in optimizer_shards(model, opt)["exp_avg"].items():
        assert torch.equal(o["exp_avg"][n], s.tensor), n


def test_resume_training_continues(tmp_path):
    """Two independent restores of one checkpoint take the same next step
    as the run that wrote it (parameters, moments and count restored)."""
    config, model, opt = build()
    step = make_train_step(config, model, opt, causal_lm_loss_sum)
    for i in range(3):
        step(batch(i))
    d = str(tmp_path / "ck")
    save_checkpoint(d, "t", model_shards(model), optimizer_shards(model, opt),
                    user_content={"step": 3}, async_save=True)
    want = step(batch(99))["loss"].item()
    for seed in (1, 2):
        c2, m2, o2 = build(seed=seed)
        ms, os_, _, user = load_checkpoint(
            d, model_template=model_shards(m2),
            optimizer_template=optimizer_shards(m2, o2))
        restore_model(m2, ms, o2)
        restore_optimizer(m2, o2, os_)
        assert user["step"] == 3 and o2.update_count == 3
        got = make_train_step(c2, m2, o2, causal_lm_loss_sum)(batch(99))
        assert got["loss"].item() == want


def test_markers_and_missing_pieces(tmp_path):
    """A tag without ``.done`` is never newest, a stale ``newest`` pointer
    falls back to the newest complete tag, stale marker temps are reaped,
    and a load whose template needs a tensor the checkpoint lacks
    raises."""
    d = str(tmp_path / "ck")
    save_checkpoint(d, "step_1", {"w": torch.ones(3)})
    os.makedirs(os.path.join(d, "step_2"))
    with open(os.path.join(d, "newest"), "w") as f:
        f.write("step_2")
    assert newest_tag(d) == "step_1"
    open(os.path.join(d, "newest.tmp.123"), "w").close()
    save_checkpoint(d, "step_3", {"w": torch.full((3,), 3.0)})
    assert not os.path.exists(os.path.join(d, "newest.tmp.123"))
    assert newest_tag(d) == "step_3"
    with pytest.raises(KeyError, match="v"):
        load_checkpoint(d, model_template={"v": torch.zeros(3)})
    with pytest.raises(ValueError, match="global shape"):
        load_checkpoint(d, model_template={"w": torch.zeros(4)})
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "none"), model_template={})
    piece = Shard(torch.arange(2.0), ((0, 3, 1),))
    assert piece.box() == ([6], [2], [2])


def test_two_ranks_share_a_directory(tmp_path):
    out = spawn(workers.ckpt_race, 2, ({"ckpt_dir": str(tmp_path / "ck")},),
                timeout_s=120)
    whole = np.arange(32.0).reshape(8, 4) * 4.0
    for rank, r in enumerate(out):
        assert r["tags"] == ["step_2", "step_3"]
        assert r["newest"] == "step_3" and r["after_async"] == "step_4"
        assert r["user"] == {"step": 4}
        np.testing.assert_array_equal(r["piece"], whole[rank * 4:rank * 4 + 4])
        np.testing.assert_array_equal(r["whole"], whole)
        np.testing.assert_array_equal(r["b"], np.arange(8.0) * 4.0)
    meta = json.load(open(tmp_path / "ck" / "step_4" / "meta.json"))
    assert meta["mesh"]["world_size"] == 2
    w = meta["tensors"]["model"]["w"]
    assert w["shape"] == [8, 4] and [p["rank"] for p in w["shards"]] == [0, 1]
    # the replicated tensor is stored once, by rank 0
    assert [p["rank"] for p in meta["tensors"]["model"]["b"]["shards"]] == [0]
    assert sorted(os.listdir(tmp_path / "ck" / "step_4" / "model")) == \
        ["rank_00000.pt", "rank_00001.pt"]


def _engine(model):
    pim = ParallelInferenceModel(model, InferenceConfig(2, 8, 16,
                                                        torch.float32),
                                 device="cpu")
    return ServingEngine(pim, page_size=4, device="cpu")


def _serve(eng):
    for i, prompt in enumerate(([3, 1, 4, 1], [5, 9, 2])):
        eng.submit(Request(request_id=i, prompt_ids=prompt, max_new_tokens=5))
    outs = eng.run_until_complete(max_steps=60)
    return {o.request_id: o.token_ids for o in outs}


def test_checkpoint_swap_serves_the_in_memory_tokens(tmp_path):
    """A checkpoint ``fit`` wrote, swapped into a serving engine, serves
    the tokens of an in-memory swap of the same trained parameters, and
    not the untrained model's; a missing directory is an audited failed
    attempt and the old weights keep serving."""
    config, model, opt = build()
    d = str(tmp_path / "ck")
    fit(config, model, opt, batch, steps=4, loss_fn=causal_lm_loss_sum,
        ckpt_dir=d, log_every=0)
    trained = {n: p.detach().clone() for n, p in model.module.named_parameters()}

    served = LlamaForCausalLM(CFG, device="cpu").init_random(7)
    eng = _engine(served)
    before = _serve(eng)
    swaps = str(tmp_path / "swaps.jsonl")
    with WeightSwapper(eng, path=swaps) as sw:
        with pytest.raises(SwapError, match="checkpoint load failed"):
            sw.swap_from_checkpoint(str(tmp_path / "nope"))
        assert _serve(eng) == before
        assert sw.swap_from_checkpoint(d) == 1
    from_ckpt = _serve(eng)
    recs = [json.loads(line) for line in open(swaps)]
    assert [(r["event"], r["source"], r["ok"]) for r in recs] == [
        ("swap_failed", "checkpoint", False), ("swap", "checkpoint", True)]

    eng2 = _engine(LlamaForCausalLM(CFG, device="cpu").init_random(7))
    WeightSwapper(eng2).swap(trained)
    assert _serve(eng2) == from_ckpt != before


def test_newest_complete_tag_agrees(tmp_path):
    """The supervisor's marker reader and the checkpoint's agree."""
    from neuronx_distributed_tpu_torch.resilience import newest_complete_tag

    d = str(tmp_path / "ck")
    for i in (2, 4):
        save_checkpoint(d, f"step_{i}", {"w": torch.ones(1)})
    assert newest_complete_tag(d) == newest_tag(d) == "step_4"
    os.remove(os.path.join(d, "step_4", ".done"))
    assert newest_complete_tag(d) == newest_tag(d) == "step_2"
    assert ckpt_mod.LAST_SAVE["bytes"] == 4.0
