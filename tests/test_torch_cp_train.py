"""PyTorch port: training under context parallelism against the JAX
trainer.

One spawned 4-rank gloo world (``torch_tp_workers.cp_train_cases``)
trains the tiny Llama on the flash path from each rank's tp shard of the
JAX tree, 3 steps on the same global batches as JAX's ``make_train_step``
at the same mesh on four virtual CPU devices (JAX ``tests/
test_convergence_sweep.py:135, :138``'s cells, ZeRO-1 on):

- tp = 2 x cp = 2 with sequence parallelism: the contiguous ring (GQA,
  selective remat), ulysses (one kv head a rank, expanded before the
  all-to-all) and zigzag, whose batch (ids, labels and positions) arrives
  in ``zigzag_permute`` order as in JAX ``tests/test_attention.py:291``;
- cp = 2 x dp = 2 with ZeRO-1 on the ring: the AdamW state cut over dp
  only, the same on both cp ranks of a dp rank.

Losses and grad norms agree within ``rtol=2e-5, atol=2e-6`` on every
rank, parameters within 1e-4 (a tenth of the learning rate: AdamW moves
an element whose gradient is near zero by noise, ``tests/
test_torch_tp_train.py``), and the cp ranks of a tp rank hold the same
parameters bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import neuronx_distributed_tpu as nxd
from neuronx_distributed_tpu.models.common import (
    causal_lm_loss as jax_causal_lm_loss,
)
from neuronx_distributed_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig,
    LlamaForCausalLM as JaxLlama,
)
from neuronx_distributed_tpu.parallel.mesh import (
    destroy_model_parallel,
    initialize_model_parallel,
)
from neuronx_distributed_tpu.trainer import (
    default_batch_spec as jax_batch_spec,
    initialize_parallel_model as jax_init_model,
    initialize_parallel_optimizer as jax_init_opt,
    make_train_step as jax_make_train_step,
)
from neuronx_distributed_tpu_torch.convert import shard_params_for_rank
from neuronx_distributed_tpu_torch.ops.ring_attention import zigzag_permute
from neuronx_distributed_tpu_torch.utils.distributed import spawn
import torch_tp_workers as workers

STEP_TOL = dict(rtol=2e-5, atol=2e-6)
B, S, LR = 4, 32, 1e-3

# name: tp, cp, impl, zigzag, kv heads, remat
CASES = {
    "tp2_cp2_ring": (2, 2, "ring", False, 4, "selective"),
    "tp2_cp2_ulysses": (2, 2, "ulysses", False, 2, "none"),
    "tp2_cp2_zigzag": (2, 2, "ring", True, 4, "none"),
    "cp2_dp2_zero1": (1, 2, "ring", False, 4, "none"),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _batches(rs, zigzag, cp):
    """One batch, 3 times (the sweep's fixed batch)."""
    ids = rs.randint(0, 256, (B, S)).astype(np.int32)
    b = {"ids": ids, "labels": np.roll(ids, -1, axis=1)}
    if zigzag:
        b["positions"] = np.broadcast_to(np.arange(S, dtype=np.int32),
                                         (B, S)).copy()
        b = {k: np.asarray(zigzag_permute(v, cp, axis=1))
             for k, v in b.items()}
    return [b] * 3


def _jax_train(name, batches):
    tp, cp, impl, zigzag, kv, remat = CASES[name]
    destroy_model_parallel()
    initialize_model_parallel(tensor_parallel_size=tp,
                              context_parallel_size=cp,
                              devices=jax.devices()[:4])
    cfg = JaxLlamaConfig.tiny(
        num_kv_heads=kv, attention_impl="flash", cp_impl=impl,
        cp_zigzag=zigzag, sequence_parallel=tp > 1, remat=remat,
        max_seq_len=S, dtype=jnp.float32, param_dtype=jnp.float32)
    config = nxd.training_config(
        tensor_parallel_size=tp, context_parallel_size=cp,
        zero_one_enabled=True, learning_rate=LR, compute_dtype="float32")
    model = jax_init_model(config, lambda: JaxLlama(cfg),
                           (jnp.zeros((1, S), jnp.int32),))
    params0 = _np(model.params)["params"]
    opt = jax_init_opt(config, model)
    step = jax_make_train_step(config, model, opt, jax_causal_lm_loss,
                               batch_spec={k: jax_batch_spec()
                                           for k in batches[0]})
    params, state, metrics = model.params, opt.state, []
    for b in batches:
        params, state, m = step(params, state,
                                {k: jnp.asarray(v) for k, v in b.items()},
                                None)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    destroy_model_parallel()
    return {"params0": params0, "metrics": np.array(metrics),
            "params": _np(params)["params"]}


@pytest.fixture(scope="module")
def trained():
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    rs = np.random.RandomState(0)
    want, cases, trees = {}, [], {}
    for name, (tp, cp, impl, zigzag, kv, remat) in CASES.items():
        batches = _batches(rs, zigzag, cp)
        want[name] = _jax_train(name, batches)
        trees.setdefault(kv, want[name]["params0"])
        cases.append(dict(name=name, tp=tp, cp=cp, impl=impl, zigzag=zigzag,
                          kv_heads=kv, remat=remat, batches=batches))
    # every case of one kv-head count starts from the same tree (JAX's
    # init does not depend on the mesh)
    for name, (*_, kv, _r) in CASES.items():
        for n, a in _flat(want[name]["params0"]).items():
            np.testing.assert_array_equal(a, _flat(trees[kv])[n])
    inp = {"cases": cases, "tree": trees, "lr": LR, "seq": S}
    return want, spawn(workers.cp_train_cases, 4, (inp,), timeout_s=170)


@pytest.mark.parametrize("name", sorted(CASES))
def test_cp_training_matches_jax(trained, name):
    want, ranks = trained
    tp, cp = CASES[name][:2]
    by_tp = {}
    for r in ranks:
        got = r[name]
        assert got["cp"][0] == cp and got["tp"][0] == tp
        np.testing.assert_allclose(
            np.stack([got["losses"], got["norms"]], 1),
            want[name]["metrics"], **STEP_TOL)
        rank = got["tp"][1]
        cut = _flat(shard_params_for_rank(want[name]["params"], tp, rank))
        assert set(cut) == set(got["params"])
        for n, p in got["params"].items():
            np.testing.assert_allclose(p, cut[n], rtol=0, atol=1e-4,
                                       err_msg=n)
        first = by_tp.setdefault((rank, got["dp"][1]), got["params"])
        for n, p in got["params"].items():
            np.testing.assert_array_equal(p, first[n], err_msg=n)
    assert want[name]["metrics"][-1, 0] < want[name]["metrics"][0, 0]


def test_zero1_shards_over_dp_only(trained):
    """cp = 2 x dp = 2: ZeRO-1 on, each rank's AdamW state a 1/dp slice,
    the same on the two cp ranks of a dp rank; a cp step's collectives:
    ring sends, the cp gradient sum, no all-to-all."""
    _, ranks = trained
    by_dp = {}
    for r in ranks:
        got = r["cp2_dp2_zero1"]
        assert got["zero1"] and got["dp"][0] == 2
        state = by_dp.setdefault(got["dp"][1], got["state"])
        for n, st in got["state"].items():
            for k, v in st.items():
                np.testing.assert_array_equal(v, state[n][k])
        full = sum(p.size for p in got["params"].values())
        mine = sum(st["exp_avg"].size for st in got["state"].values())
        assert mine < 0.6 * full
        counts = got["counts"][0]
        assert counts["cp_send"] == 2 * (1 + 1 + 2)   # 2 layers
        assert "all_to_all" not in counts
    assert len(by_dp) == 2


def test_ulysses_step_all_to_alls(trained):
    """Per layer 4 all-to-alls forward and 4 backward, no send."""
    _, ranks = trained
    for r in ranks:
        counts = r["tp2_cp2_ulysses"]["counts"][0]
        assert counts["all_to_all"] == 2 * 8
        assert "cp_send" not in counts
