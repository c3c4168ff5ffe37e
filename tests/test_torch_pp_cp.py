"""PyTorch port: context parallelism inside a pipeline stage, against the
JAX package.

JAX's pipeline engine leaves cp automatic inside a stage, so its pipelined
models run at pp = 2 x cp = 2 on four virtual CPU devices, and one spawned
4-rank gloo world (``torch_pipeline_workers.ppcp_cases``) runs each case
from JAX's pipelined tree at the same mesh.  Each stage holds its cp
rank's chunk of every microbatch, passes it to the neighbour stage of the
same cp rank, and its blocks attend over the cp group:

- the tiny Llama on the flash path's ring and on the dense core, and
  GPT-NeoX (the gathered dense core), under 1F1B: losses within ``rel
  1e-5``, token counts equal, the gradients of the mean loss (summed over
  cp) within ``rtol 1e-4, atol 1e-5``; the forward path's logits (the cp
  chunks gathered) within 1e-5;
- 3 AdamW steps through ``make_train_step`` on the ring against JAX's
  pipelined train step (losses and grad norms within ``rtol 2e-5, atol
  2e-6``, parameters within a tenth of the learning rate, the cp ranks of
  a stage bit-equal), and LoRA under the pipeline (A14's remainder): the
  adapters on the blocks' targets (JAX's pipelined head has no adapter,
  ROADMAP C8) with ``trainable=peft.lora_trainable``, 2 steps against
  JAX's pipelined LoRA step, the frozen base unchanged;
- ``fit`` with checkpoints: a run stopped at its middle and resumed gives
  the uninterrupted run's losses and parameters bit for bit, and each
  tensor is written once, by a stage's cp rank 0.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import neuronx_distributed_tpu as nxd
from neuronx_distributed_tpu import peft as jax_peft
from neuronx_distributed_tpu.models.gpt_neox import (
    GPTNeoXConfig as JaxNeoXConfig,
    build_pipelined_gpt_neox as jax_build_neox,
)
from neuronx_distributed_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig,
    build_pipelined_llama as jax_build_llama,
)
from neuronx_distributed_tpu.parallel.mesh import (
    destroy_model_parallel,
    initialize_model_parallel,
)
from neuronx_distributed_tpu.trainer import (
    initialize_parallel_optimizer as jax_init_opt,
    make_eval_step as jax_make_eval_step,
    make_train_step as jax_make_train_step,
)
from neuronx_distributed_tpu_torch.convert import (
    pipelined_grads_from_jax,
    pipelined_params_from_jax,
)
from neuronx_distributed_tpu_torch.utils.distributed import spawn
import torch_pipeline_workers as workers

LOSS_REL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
STEP_TOL = dict(rtol=2e-5, atol=2e-6)
M, MB, S = 2, 2, 16
# JAX's pipelined head builds no lm_head adapter (ROADMAP C8), so the
# adapters go on the blocks' targets
TARGETS = ("qkv", "o_proj", "mlp")
LLAMA = dict(num_layers=2, num_kv_heads=4)

CASES = {
    "llama_ring": dict(family="llama", forward=True,
                       cfg=dict(LLAMA, attention_impl="flash")),
    "llama_dense": dict(family="llama", cfg=dict(LLAMA)),
    "neox": dict(family="gpt_neox", cfg=dict(num_layers=2)),
}
TRAIN = {
    "train": dict(cfg=dict(LLAMA, attention_impl="flash"), steps=3),
    "lora": dict(cfg=dict(LLAMA, attention_impl="flash", lora_rank=4,
                          lora_targets=TARGETS), steps=2),
}


def _mesh():
    destroy_model_parallel()
    initialize_model_parallel(pipeline_parallel_size=2,
                              context_parallel_size=2,
                              devices=jax.devices()[:4])


def _jax_model(family, cfg, seed=3):
    _mesh()
    common = dict(sequence_parallel=False, remat="none", dtype=jnp.float32,
                  param_dtype=jnp.float32, max_seq_len=S)
    if family == "llama":
        return jax_build_llama(JaxLlamaConfig.tiny(**common, **cfg),
                               num_microbatches=M, seed=seed)
    return jax_build_neox(JaxNeoXConfig.tiny(**common, **cfg),
                          num_microbatches=M, seed=seed)


def _batch(seed):
    ids = np.random.RandomState(seed).randint(0, 256, (M * MB, S)).astype(
        np.int32)
    labels = np.roll(ids, -1, axis=1)
    labels[:, -1] = -100
    return {"ids": ids, "labels": labels}


def _refs(pm, batch, forward):
    _mesh()
    args = (jnp.asarray(batch["ids"]), jnp.asarray(batch["labels"]))
    (ls, tok), grads = jax.jit(pm.loss_and_grad_fn)(pm.params, *args)
    out = {"loss": float(ls), "tok": float(tok),
           "grads": jax.tree.map(np.asarray, grads)}
    if forward:
        out["logits"] = np.asarray(jax.jit(pm.forward_fn)(pm.params,
                                                          args[0]))
    return out


def _bump_adapters(params):
    """The adapters' B factors off zero, so every factor trains."""
    return jax.tree_util.tree_map_with_path(
        lambda p, x: x + 0.01 if "lora_b" in jax.tree_util.keystr(p) else x,
        params)


def _jax_train(pm, params, batches, lora):
    """JAX's eval loss and forward logits on the first batch, then its
    train steps (which donate ``params``)."""
    _mesh()
    config = nxd.training_config(pipeline_parallel_size=2,
                                 context_parallel_size=2,
                                 num_microbatches=M, learning_rate=1e-3,
                                 compute_dtype="float32", seed=0)
    b0 = {k: jnp.asarray(v) for k, v in batches[0].items()}
    eval_loss = float(jax_make_eval_step(config, pm)(params, b0)["loss"])
    logits = np.asarray(jax.jit(pm.forward_fn)(params, b0["ids"]))
    opt = jax_init_opt(config, pm, trainable=jax_peft.lora_trainable
                       if lora else None)
    step = jax_make_train_step(config, pm, opt)
    state, metrics = opt.state, []
    for b in batches:
        params, state, m = step(params, state,
                                {k: jnp.asarray(v) for k, v in b.items()},
                                None)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return {"metrics": np.array(metrics), "eval_loss": eval_loss,
            "logits": logits, "params": jax.tree.map(np.asarray, params)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    tmp = tmp_path_factory.mktemp("ppcp")
    models, inp = {}, {"cases": {}, "train": {}}
    batch = _batch(1)
    for name, case in CASES.items():
        pm = _jax_model(case["family"], case["cfg"])
        models[name] = pm
        inp["cases"][name] = {
            "schedule": "1f1b", "M": M, "cp": 2, "family": case["family"],
            "forward": case.get("forward", False),
            "cfg": dict(case["cfg"], remat="selective"),
            "params": jax.tree.map(np.asarray, pm.params),
            "rows": tuple(pm.layer_rows), "batch": batch}
    for name, case in TRAIN.items():
        # the schedule cases' weights and batch: the steps train the model
        # whose gradients test_pp_cp_schedule_matches_jax holds
        pm = _jax_model("llama", case["cfg"])
        params = pm.params
        if "lora_rank" in case["cfg"]:
            params = _bump_adapters(params)
        batches = [batch] * case["steps"]
        models[name] = (pm, params, batches)
        inp["train"][name] = {
            "M": M, "cp": 2, "cfg": case["cfg"], "zero1": False,
            "lora": "lora_rank" in case["cfg"], "forward": name == "train",
            "params": jax.tree.map(np.asarray, params),
            "rows": tuple(pm.layer_rows), "batches": batches}
    inp["resume"] = {"M": M, "cp": 2, "cfg": dict(LLAMA,
                                                 attention_impl="flash"),
                     "batches": [_batch(20 + i) for i in range(4)],
                     "dir_whole": str(tmp / "whole"),
                     "dir_resume": str(tmp / "resume")}
    ranks, want = {}, {}

    def run():
        ranks["out"] = spawn(workers.ppcp_cases, 4, (inp,), timeout_s=240)

    th = threading.Thread(target=run)
    th.start()
    try:
        for name, case in CASES.items():
            want[name] = _refs(models[name], batch, case.get("forward"))
        for name in TRAIN:
            pm, params, batches = models[name]
            want[name] = _jax_train(pm, params, batches, name == "lora")
    finally:
        th.join()
        destroy_model_parallel()
    if "out" not in ranks:
        pytest.fail("the 4-rank world did not finish")
    return inp, want, ranks["out"]


@pytest.mark.parametrize("name", list(CASES))
def test_pp_cp_schedule_matches_jax(world, name):
    """Each rank's loss, token count and gradients (its stage, summed over
    cp) equal JAX's pipelined model's at pp = 2 x cp = 2; the forward
    path gives every rank the whole sequence's logits."""
    _, want, ranks = world
    w, family = want[name], CASES[name]["family"]
    seen = set()
    for rank in ranks:
        r = rank[name]
        assert r["pp"][0] == 2 and r["cp"][0] == 2
        seen.add((r["pp"][1], r["cp"][1]))
        assert r["tok"] == w["tok"]
        assert r["loss"] == pytest.approx(w["loss"], rel=LOSS_REL)
        cut = pipelined_grads_from_jax(
            w["grads"], r["rows"], [i for c in r["layers"] for i in c],
            embed=r["embed"], head=r["head"], family=family)
        assert set(cut) == set(r["grads"])
        for n, g in r["grads"].items():
            np.testing.assert_allclose(g / w["tok"], cut[n] / w["tok"],
                                       err_msg=f"{name} {n}", **GRAD_TOL)
        if CASES[name].get("forward"):
            np.testing.assert_allclose(r["logits"], w["logits"], rtol=1e-5,
                                       atol=1e-5)
    assert seen == {(0, 0), (0, 1), (1, 0), (1, 1)}


def test_stage_transfers_stay_on_the_cp_rank(world):
    """A stage sends each microbatch's chunk forward and its gradient back
    to the same cp rank of the neighbour stage: the chunk's bytes, not
    the sequence's, once a microbatch each way."""
    _, _, ranks = world
    H = 64
    for rank in ranks:
        r = rank["llama_ring"]
        c = r["counts"]
        sent, got = ("pp_send_forward", "pp_recv_backward") if r["pp"][1] \
            == 0 else ("pp_send_backward", "pp_recv_forward")
        assert c[sent] == M and c[got] == M
        assert r["bytes"][sent] == M * MB * (S // 2) * H * 4


@pytest.mark.parametrize("name", list(TRAIN))
def test_pp_cp_training_matches_jax(world, name):
    """AdamW steps at pp = 2 x cp = 2 equal JAX's pipelined train step's:
    losses, grad norms, eval loss, forward logits, parameters; under LoRA
    only the adapters hold AdamW state and move."""
    inp, want, ranks = world
    w = want[name]
    by_stage = {}
    for rank in ranks:
        t = rank[name]
        assert t["cp"][0] == 2
        assert t["eval_loss"] == pytest.approx(w["eval_loss"], rel=LOSS_REL)
        np.testing.assert_allclose(np.stack([t["losses"], t["norms"]], 1),
                                   w["metrics"], **STEP_TOL)
        layers = [i for c in t["layers"] for i in c]
        cut = {k: v.numpy() for k, v in pipelined_params_from_jax(
            w["params"], t["rows"], layers, embed=t["embed"],
            head=t["head"]).items()}
        assert set(cut) == set(t["params"])
        for n, p in t["params"].items():
            np.testing.assert_allclose(p, cut[n], rtol=0, atol=1e-4,
                                       err_msg=n)
        if name == "train":
            np.testing.assert_allclose(t["logits"], w["logits"], rtol=1e-5,
                                       atol=1e-5)
        else:
            assert t["stateful"] and all("lora_" in n for n in t["stateful"])
            start = {k: v.numpy() for k, v in pipelined_params_from_jax(
                inp["train"][name]["params"], t["rows"], layers,
                embed=t["embed"], head=t["head"]).items()}
            for n, p in t["params"].items():
                moved = not np.array_equal(p, start[n])
                assert moved == ("lora_" in n), n
        stage = by_stage.setdefault(t["pp"][1], t["params"])
        for n, p in t["params"].items():
            assert np.array_equal(p, stage[n]), n
    assert w["metrics"][-1, 0] < w["metrics"][0, 0]


def test_checkpoint_resume_at_pp_cp(world):
    """``fit`` stopped at step 2 and resumed gives the uninterrupted run's
    losses and parameters bit for bit; the cp ranks of a stage hold the
    same pieces, so only each stage's cp rank 0 (ranks 0 and 2) writes."""
    _, _, ranks = world
    for rank in ranks:
        f = rank["resume"]
        assert f["resumed"]["start"] == 2
        assert f["first"]["losses"] + f["resumed"]["losses"] == \
            f["whole"]["losses"]
        for n, p in f["whole"]["params"].items():
            assert np.array_equal(p, f["resumed"]["params"][n]), n
        assert f["writers"] == {"model": [0, 2], "optimizer": [0, 2]}
