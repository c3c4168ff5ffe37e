"""PyTorch port: pipeline parallelism past two ranks against the JAX
package.

One spawned 4-rank gloo world (``torch_pipeline_workers.pp4_cases``)
runs each case from JAX's pipelined tree (each rank's stage and tp shard
through ``convert.pipelined_params_from_jax``) against JAX's pipelined
model at the same mesh on four virtual CPU devices:

- pp = 2 x tp = 2 with sequence parallelism (the stage boundary carries a
  rank's sequence slice), the tiny Llama under 1F1B;
- pp = 2 x tp = 2 at kvr = 2 (each rank's kv heads replicated), with
  sequence parallelism;
- GPT-NeoX tiny at pp = 2 x tp = 2 under 1F1B and the interleaved
  schedule (JAX ``tests/test_models.py:233, :269``);
- pp = 2 x dp = 2 with ZeRO-1: 3 AdamW steps through ``make_train_step``
  against JAX's pipelined train step (each dp rank runs its rows of every
  microbatch; the AdamW state sliced over dp inside a stage).

Losses agree within ``rel 1e-5`` and the gradients of the mean loss
(each sum over the token count) within ``rtol 1e-4, atol 1e-5`` (JAX's
own, ``tests/test_models.py:254-265``); training losses and grad norms
within ``rtol 2e-5, atol 2e-6`` and parameters within a tenth of the
learning rate (``tests/test_torch_tp_train.py``).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import neuronx_distributed_tpu as nxd
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
M, MB, S = 4, 2, 16

# name: the JAX mesh (tp, kvr), the family, its config and schedule
CASES = {
    "tp2_sp": dict(tp=2, kvr=1, family="llama", schedule="1f1b",
                   cfg=dict(num_layers=4, num_kv_heads=2)),
    "tp2_kvr2": dict(tp=2, kvr=2, family="llama", schedule="1f1b",
                     cfg=dict(num_layers=4, num_kv_heads=1)),
    "neox_1f1b": dict(tp=2, kvr=1, family="gpt_neox", schedule="1f1b",
                      cfg=dict(num_layers=4)),
    "neox_interleaved": dict(tp=2, kvr=1, family="gpt_neox",
                             schedule="interleaved", V=2,
                             cfg=dict(num_layers=4)),
}


def _mesh(tp=1, kvr=1):
    destroy_model_parallel()
    initialize_model_parallel(tensor_parallel_size=tp, kv_size_multiplier=kvr,
                              pipeline_parallel_size=2,
                              devices=jax.devices()[:4])


def _jax_model(case, seed=3):
    _mesh(case["tp"], case["kvr"])
    common = dict(sequence_parallel=True, remat="none", dtype=jnp.float32,
                  param_dtype=jnp.float32, max_seq_len=S)
    if case["family"] == "llama":
        cfg = JaxLlamaConfig.tiny(**common, **case["cfg"])
        return jax_build_llama(cfg, num_microbatches=M, seed=seed,
                               schedule=case["schedule"],
                               num_chunks=case.get("V", 1))
    cfg = JaxNeoXConfig.tiny(**common, **case["cfg"])
    return jax_build_neox(cfg, num_microbatches=M, seed=seed,
                          schedule=case["schedule"],
                          num_chunks=case.get("V", 1))


def _batch(seed, B=M * MB):
    ids = np.random.RandomState(seed).randint(0, 256, (B, S)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1)
    labels[:, -1] = -100
    return {"ids": ids, "labels": labels}


def _refs(case, pm, batch):
    _mesh(case["tp"], case["kvr"])
    (ls, tok), grads = jax.jit(pm.loss_and_grad_fn)(
        pm.params, jnp.asarray(batch["ids"]), jnp.asarray(batch["labels"]))
    return {"loss": float(ls), "tok": float(tok),
            "grads": jax.tree.map(np.asarray, grads)}


def _jax_train(batches):
    """JAX's pipelined model at pp = 2 x dp = 2: the initial params and
    layer rows, and a function giving the eval step's loss and the
    forward path's logits on the first batch, then its train step's
    (ZeRO-1 on) per-step losses and grad norms and final params."""
    _mesh()
    cfg = JaxLlamaConfig.tiny(num_layers=4, num_kv_heads=2,
                              sequence_parallel=False, remat="none",
                              dtype=jnp.float32, param_dtype=jnp.float32,
                              max_seq_len=S)
    pm = jax_build_llama(cfg, num_microbatches=M, seed=5)
    config = nxd.training_config(pipeline_parallel_size=2,
                                 num_microbatches=M, learning_rate=1e-3,
                                 compute_dtype="float32", seed=0)
    params0 = jax.tree.map(np.asarray, pm.params)
    rows = tuple(pm.layer_rows)
    opt = jax_init_opt(config, pm)
    step = jax_make_train_step(config, pm, opt)

    def run():
        b0 = {k: jnp.asarray(v) for k, v in batches[0].items()}
        eval_loss = float(jax_make_eval_step(config, pm)(pm.params, b0)[
            "loss"])
        logits = np.asarray(jax.jit(pm.forward_fn)(pm.params, b0["ids"]))
        params, state, metrics = pm.params, opt.state, []
        for b in batches:
            params, state, m = step(params, state,
                                    {k: jnp.asarray(v) for k, v in b.items()},
                                    None)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        return {"metrics": np.array(metrics), "eval_loss": eval_loss,
                "logits": logits,
                "params": jax.tree.map(np.asarray, params)}

    return params0, rows, run


@pytest.fixture(scope="module")
def world():
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    models, inp, want = {}, {"cases": {}}, {}
    batch = _batch(1)
    for name, case in CASES.items():
        pm = _jax_model(case)
        models[name] = pm
        inp["cases"][name] = {
            "schedule": case["schedule"], "V": case.get("V", 1), "M": M,
            "tp": case["tp"], "kvr": case["kvr"], "family": case["family"],
            "cfg": dict(case["cfg"], remat="selective"),
            "params": jax.tree.map(np.asarray, pm.params),
            "rows": tuple(pm.layer_rows), "batch": batch}
        want[name + "_rows"] = tuple(pm.layer_rows)
    batches = [_batch(10)] * 3
    params0, rows, train = _jax_train(batches)
    inp["dp_train"] = {"M": M, "cfg": dict(num_layers=4, num_kv_heads=2),
                       "params": params0, "rows": rows, "batches": batches,
                       "forward": True}
    ranks = {}

    def run():
        ranks["out"] = spawn(workers.pp4_cases, 4, (inp,), timeout_s=240)

    th = threading.Thread(target=run)
    th.start()
    try:
        want["dp_train"] = train()
        for name, case in CASES.items():
            want[name] = _refs(case, models[name], batch)
    finally:
        th.join()
        destroy_model_parallel()
    if "out" not in ranks:
        pytest.fail("the 4-rank world did not finish")
    return inp, want, ranks["out"]


@pytest.mark.parametrize("name", list(CASES))
def test_pipeline_with_tensor_parallelism_matches_jax(world, name):
    """Each rank's loss, token count and gradients (its stage, its tp
    shard, after the sequence-parallel and kvr sums) equal JAX's
    pipelined model's at the same mesh."""
    inp, want, ranks = world
    case, w = CASES[name], want[name]
    tps = set()
    for rank in ranks:
        r = rank[name]
        assert r["rows"] == want[name + "_rows"]
        assert r["pp"][0] == 2 and r["tp"][0] == case["tp"]
        assert r["tp"][2] == case["kvr"]
        assert r["embed"] == (r["pp"][1] == 0)
        assert r["head"] == (r["pp"][1] == 1)
        tps.add((r["pp"][1], r["tp"][1]))
        assert r["tok"] == w["tok"]
        assert r["loss"] == pytest.approx(w["loss"], rel=LOSS_REL)
        cut = pipelined_grads_from_jax(
            w["grads"], r["rows"], [i for c in r["layers"] for i in c],
            embed=r["embed"], head=r["head"], family=case["family"],
            tp=r["tp"][0], rank=r["tp"][1], kvr=r["tp"][2])
        assert set(cut) == set(r["grads"])
        for n, g in r["grads"].items():
            np.testing.assert_allclose(g / w["tok"], cut[n] / w["tok"],
                                       err_msg=f"{name} {n}", **GRAD_TOL)
    assert tps == {(0, 0), (0, 1), (1, 0), (1, 1)}


def test_pipeline_with_data_parallelism_trains_like_jax(world):
    """pp = 2 x dp = 2 with ZeRO-1 (the optimizer updating this rank's
    slices): the eval step's loss and ``forward_fn``'s logits (each dp
    rank's rows gathered) equal JAX's; 3 AdamW steps' losses and grad
    norms equal JAX's on every rank, and each stage's parameters JAX's
    within a tenth of the learning rate, the same on both dp ranks."""
    inp, want, ranks = world
    w = want["dp_train"]
    by_stage = {}
    for rank in ranks:
        t = rank["dp_train"]
        assert t["dp"][0] == 2 and t["pp"][0] == 2 and t["zero1"]
        assert t["eval_loss"] == pytest.approx(w["eval_loss"], rel=LOSS_REL)
        np.testing.assert_allclose(t["logits"], w["logits"], rtol=1e-5,
                                   atol=1e-5)
        got = np.stack([t["losses"], t["norms"]], axis=1)
        np.testing.assert_allclose(got, w["metrics"], **STEP_TOL)
        cut = {k: v.numpy() for k, v in pipelined_params_from_jax(
            w["params"], t["rows"], [i for c in t["layers"] for i in c],
            embed=t["embed"], head=t["head"]).items()}
        assert set(cut) == set(t["params"])
        for n, p in t["params"].items():
            np.testing.assert_allclose(p, cut[n], rtol=0, atol=1e-4,
                                       err_msg=n)
        stage = by_stage.setdefault(t["pp"][1], t["params"])
        for n, p in t["params"].items():
            assert np.array_equal(p, stage[n]), n
    assert w["metrics"][-1, 0] < w["metrics"][0, 0]
