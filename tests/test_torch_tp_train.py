"""PyTorch port: training past one rank against the JAX trainer.

Two spawned gloo worlds:

- 2 ranks (``torch_tp_workers.model_training_cases``): GPT-NeoX (its
  default sequence parallelism) and BERT (without, and with it) trained 3
  steps at tp = 2 from each rank's shard of the JAX trees, against JAX's
  ``make_train_step`` at tp = 2 on the same weights and batches (JAX
  ``tests/test_models.py:102, :122``; fp32, BERT's dropout off); BERT
  with dropout 0.1 under sequence parallelism at tp = 2 against the port
  at tp = 1 under the same seeds (the tp-invariant masks of JAX
  ``tests/test_rng_dropout.py:83``); and the collectives of one tp = 2
  sequence-parallel Llama step (``mappings.COUNTS``) at 2 and 4 layers,
  the port's version of JAX ``tests/test_hlo_collectives.py``;
- 4 ranks (``torch_tp_workers.llama_dp_cases``): the tiny Llama at tp = 2
  x dp = 2 with sequence parallelism, ZeRO-1 and the chunked loss head,
  and at tp = 2 with kvr = 2 x dp = 2 with the flash core under
  selective remat, two-step gradient accumulation, ignored labels and
  clipping that bites: 3 steps against JAX's ``make_train_step`` at the
  same mesh (JAX on its dense core), and ``make_eval_step``.

Losses and grad norms agree within ``rtol=2e-5, atol=2e-6`` (JAX's own
``tests/test_distributed_train.py``) on every rank.  Parameters agree
within 1e-5 for at least 99.9 % of each tensor's elements and within a
tenth of the learning rate for all: AdamW divides each gradient element
by ``sqrt(v) + eps``, so an element whose gradient is near zero, where the
two frameworks' sums round differently, moves by up to ``lr`` in one and
not the other (``tests/test_torch_train.py``; 1-2 elements of a tensor,
by up to 2e-5, at lr 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neuronx_distributed_tpu as nxd
from neuronx_distributed_tpu.models.bert import (
    BertConfig as JaxBertConfig,
    BertForPreTraining as JaxBert,
    pretraining_loss as jax_pretraining_loss,
)
from neuronx_distributed_tpu.models.common import (
    causal_lm_loss as jax_causal_lm_loss,
    causal_lm_loss_sum as jax_causal_lm_loss_sum,
    make_causal_lm_loss_sum as jax_make_causal_lm_loss_sum,
)
from neuronx_distributed_tpu.models.gpt_neox import (
    GPTNeoXConfig as JaxNeoXConfig,
    GPTNeoXForCausalLM as JaxNeoX,
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
from neuronx_distributed_tpu_torch.config import training_config
from neuronx_distributed_tpu_torch.convert import (
    bert_params_from_jax,
    shard_params_for_rank,
    zero1_shard_for_rank,
)
from neuronx_distributed_tpu_torch.models import BertConfig, BertForPreTraining, pretraining_loss
from neuronx_distributed_tpu_torch.trainer import (
    initialize_parallel_model,
    initialize_parallel_optimizer,
    make_train_step,
)
from neuronx_distributed_tpu_torch.utils.distributed import spawn
import torch_tp_workers as workers

STEP_TOL = dict(rtol=2e-5, atol=2e-6)
S = 16


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


def jax_train(config, ctor, loss, batches, accum=1):
    """JAX's trainer on the live mesh: the initial params (numpy, before
    the first step donates them), per-step losses and grad norms, the
    final params and AdamW moments."""
    model = jax_init_model(config, ctor, (jnp.zeros((1, S), jnp.int32),))
    params0 = _np(model.params)["params"]
    opt = jax_init_opt(config, model)
    spec = {k: jax_batch_spec() for k in batches[0]}
    step = jax_make_train_step(config, model, opt, loss, batch_spec=spec,
                               grad_accum_steps=accum)
    params, state, metrics = model.params, opt.state, []
    for b in batches:
        params, state, m = step(params, state,
                                {k: jnp.asarray(v) for k, v in b.items()},
                                None)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return {"params0": params0, "metrics": np.array(metrics),
            "params": _np(params)["params"],
            "mu": _np(state[0].mu)["params"], "nu": _np(state[0].nu)["params"]}


def lm_batches(rs, B, vocab=256, ignore=0.0, n=3):
    out = []
    for _ in range(n):
        ids = rs.randint(0, vocab, (B, S)).astype(np.int32)
        labels = np.roll(ids, -1, axis=1)
        labels[rs.rand(B, S) < ignore] = -100
        out.append({"ids": ids, "labels": labels})
    return out


def bert_batches(rs, B=4, n=3):
    """One batch, ``n`` times (JAX ``tests/test_models.py:122``'s
    masking: every other token predicted, the rest masked as 103)."""
    ids = rs.randint(0, 256, (B, S)).astype(np.int32)
    mlm = ids.copy()
    mlm[:, ::2] = -100
    ids[:, 1::2] = 103
    batch = {"ids": ids, "mlm_labels": mlm,
             "nsp_labels": rs.randint(0, 2, (B,)).astype(np.int32)}
    return [batch] * n


def port_metrics(r):
    return np.stack([r["losses"], r["norms"]], axis=1)


@pytest.fixture(scope="module")
def models():
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    rs = np.random.RandomState(0)
    f32 = dict(dtype=jnp.float32, param_dtype=jnp.float32)
    destroy_model_parallel()
    initialize_model_parallel(tensor_parallel_size=2,
                              devices=jax.devices()[:2])
    config = nxd.training_config(tensor_parallel_size=2, learning_rate=1e-3,
                                 compute_dtype="float32", seed=0)
    inp, want = {}, {}
    inp["neox_batches"] = lm_batches(rs, 4)
    want["neox"] = jax_train(config, lambda: JaxNeoX(JaxNeoXConfig.tiny(**f32)),
                             jax_causal_lm_loss, inp["neox_batches"])
    inp["neox_tree"] = want["neox"]["params0"]
    inp["bert_batches"] = bert_batches(rs)
    for name, kw in (("bert", {}), ("bert_sp", dict(sequence_parallel=True))):
        want[name] = jax_train(
            config, lambda kw=kw: JaxBert(JaxBertConfig.tiny(**f32, **kw)),
            jax_pretraining_loss, inp["bert_batches"])
    inp["bert_tree"] = want["bert"]["params0"]
    inp["dropout_seeds"] = [11, 12, 13]
    inp["budget_batches"] = [{"ids": rs.randint(0, 256, (2, 64)),
                              "labels": rs.randint(0, 256, (2, 64))}]
    destroy_model_parallel()
    return inp, want, spawn(workers.model_training_cases, 2, (inp,),
                            timeout_s=170)


@pytest.mark.parametrize("name", ["neox", "bert", "bert_sp"])
def test_tp2_training_matches_jax(models, name):
    """3 steps at tp = 2: losses and grad norms on both ranks equal JAX's;
    each rank's parameters are its cut of JAX's within a tenth of the
    learning rate (AdamW moves an element whose gradient is near zero by
    up to lr on rounding noise: ``tests/test_torch_train.py``)."""
    _, want, ranks = models
    for r in ranks:
        assert r[name]["tp"][0] == 2
        np.testing.assert_allclose(port_metrics(r[name]),
                                   want[name]["metrics"], **STEP_TOL)
    assert want[name]["metrics"][-1, 0] < want[name]["metrics"][0, 0]
    full = _flat(want[name]["params"])
    convert = {"neox": None}.get(name, bert_params_from_jax)
    for r in ranks:
        rank = r[name]["tp"][1]
        cut = _flat(shard_params_for_rank(want[name]["params"], 2, rank))
        if convert is not None:
            cut = {k: v.numpy() for k, v in convert(
                shard_params_for_rank(want[name]["params"], 2, rank),
                BertConfig.tiny(), tp=2).items()}
        assert set(cut) == set(r[name]["params"]), name
        for n, p in r[name]["params"].items():
            np.testing.assert_allclose(p, cut[n], rtol=0, atol=1e-4,
                                       err_msg=n)
    assert full


def test_bert_dropout_at_tp2_equals_tp1(models):
    """BERT with dropout 0.1 under sequence parallelism: tp = 2 under one
    seed gives tp = 1's losses (each rank's masks are its slice of the
    full-shape masks), and dropout is on (the losses differ from the
    dropout-off run's)."""
    inp, _, ranks = models
    cfg = BertConfig.tiny(dtype=torch.float32, param_dtype=torch.float32,
                          hidden_dropout=0.1)
    config = training_config(learning_rate=1e-3, compute_dtype="float32",
                             seed=0)
    model = initialize_parallel_model(
        config, lambda d: BertForPreTraining(cfg, device=d), device="cpu")
    model.module.load_state_dict(bert_params_from_jax(inp["bert_tree"], cfg))
    step = make_train_step(config, model,
                           initialize_parallel_optimizer(config, model),
                           pretraining_loss)
    tp1 = [step(b, torch.Generator().manual_seed(s))["loss"].item()
           for b, s in zip(inp["bert_batches"], inp["dropout_seeds"])]
    for r in ranks:
        np.testing.assert_allclose(r["bert_dropout"]["losses"], tp1,
                                   rtol=1e-5, atol=1e-6)
        assert abs(r["bert_dropout"]["losses"][0] - r["bert"]["losses"][0]) \
            > 1e-4


# one tp = 2 sequence-parallel step, by design: a layer's column layers
# all-gather the sequence (qkv, gate_up) and its row layers reduce-scatter
# it (o_proj, down), and backward the reverse: 4 all-gathers and 4
# reduce-scatters a layer; selective remat recomputes the forward's two
# all-gathers and the attention's reduce-scatter (only matmul outputs are
# saved; the MLP's reduce-scatter gives the block's output, which no
# backward reads).  The fixed part: the
# embedding's reduce-scatter and its backward's all-gather, the gather
# before the head, the head's backward all-reduce, the vocab-parallel
# loss's MAX and SUM all-reduces, the sequence-parallel gradient sum and
# the global norm.  No all-to-all, no permute.
PER_LAYER = {"none": {"all_gather": 4, "reduce_scatter": 4},
             "selective": {"all_gather": 6, "reduce_scatter": 5}}
FIXED = {"all_gather": 2, "reduce_scatter": 1, "all_reduce": 5}


@pytest.mark.parametrize("remat", ["none", "selective"])
def test_tp_sp_step_collective_budget(models, remat):
    _, _, ranks = models
    for r in ranks:
        c2, c4 = r[f"budget_2_{remat}"], r[f"budget_4_{remat}"]
        for c in (c2, c4):
            assert set(c) <= {"all_reduce", "all_gather", "reduce_scatter"}
        # JAX's budget: all-reduce <= 50 (reduce-scatters are all-reduces
        # on this path too), all-gather <= 40
        assert c2["all_reduce"] + c2["reduce_scatter"] <= 50, c2
        assert c2["all_gather"] <= 40, c2
        for kind in FIXED:
            assert c4.get(kind, 0) <= 2 * c2.get(kind, 0) + 4, (kind, c2, c4)
            per = (c4.get(kind, 0) - c2.get(kind, 0)) // 2
            assert per == PER_LAYER[remat].get(kind, 0), (kind, c2, c4)
            assert c2.get(kind, 0) == FIXED[kind] + 2 * per, (kind, c2)
    assert ranks[0][f"budget_2_{remat}"] == ranks[1][f"budget_2_{remat}"]


@pytest.fixture(scope="module")
def llama_dp():
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    rs = np.random.RandomState(1)
    cases, want = [], {}
    for name, kvr, remat, chunk, accum, ignore, opt, attention in (
            ("tp2_dp2_sp_zero1", 1, "none", 8, 1, 0.0,
             dict(learning_rate=1e-3, zero_one_enabled=True), "dense"),
            ("tp2_kvr2_dp2_accum", 2, "selective", 0, 2, 0.3,
             dict(learning_rate=2e-3, zero_one_enabled=False,
                  max_grad_norm=0.05), "flash")):
        destroy_model_parallel()
        initialize_model_parallel(tensor_parallel_size=2,
                                  kv_size_multiplier=kvr,
                                  devices=jax.devices()[:4])
        config = nxd.training_config(
            tensor_parallel_size=2, kv_size_multiplier=kvr, seed=0,
            param_dtype="float32", compute_dtype="float32", **opt)
        jcfg = JaxLlamaConfig.tiny(num_kv_heads=2, dtype=jnp.float32,
                                   param_dtype=jnp.float32,
                                   sequence_parallel=True, remat=remat,
                                   max_seq_len=S)
        batches = lm_batches(rs, 4, ignore=ignore)
        loss = (jax_make_causal_lm_loss_sum(chunk) if chunk
                else jax_causal_lm_loss_sum)
        want[name] = jax_train(config, lambda c=jcfg: JaxLlama(c), loss,
                               batches, accum)
        cases.append(dict(name=name, kvr=kvr, remat=remat, chunk=chunk,
                          accum=accum, opt=opt, batches=batches,
                          attention=attention,
                          params=want[name]["params0"]))
    destroy_model_parallel()
    return cases, want, spawn(workers.llama_dp_cases, 4, ({"cases": cases},),
                              timeout_s=170)


CASE_NAMES = ["tp2_dp2_sp_zero1", "tp2_kvr2_dp2_accum"]


@pytest.mark.parametrize("name", CASE_NAMES)
def test_llama_dp_losses_and_norms_match_jax(llama_dp, name):
    """Every rank's losses and norms equal JAX's (the kvr case runs the
    port's flash core, its CPU plain versions, at the local heads against
    JAX's dense core); ``make_eval_step`` on the first batch gives the
    first step's loss."""
    _, want, ranks = llama_dp
    for r in ranks:
        np.testing.assert_allclose(port_metrics(r[name]),
                                   want[name]["metrics"], **STEP_TOL)
        np.testing.assert_allclose(r[name]["eval_loss"],
                                   want[name]["metrics"][0, 0], **STEP_TOL)
    if name.endswith("accum"):
        assert want[name]["metrics"][0, 1] > 0.05   # the clip bites


@pytest.mark.parametrize("name", CASE_NAMES)
def test_llama_dp_parameters_match_jax(llama_dp, name):
    """Every rank's shard equals JAX's final parameters cut for its tp rank
    (1e-5 for 99.9 % of the elements, a tenth of lr for all), and the dp
    replicas of a tp rank hold the same bits."""
    cases, want, ranks = llama_dp
    case = next(c for c in cases if c["name"] == name)
    kvr, lr = case["kvr"], case["opt"]["learning_rate"]
    by_tp = {}
    for r in ranks:
        out = r[name]
        assert out["dp"][0] == 2 and out["tp"][0] == 2
        tp_rank = out["tp"][1]
        cut = _flat(shard_params_for_rank(want[name]["params"], 2, tp_rank,
                                          kvr))
        for n, p in out["params"].items():
            np.testing.assert_allclose(p, cut[n], rtol=0, atol=0.1 * lr,
                                       err_msg=f"{name} {n}")
            close = np.abs(p - cut[n]) <= 1e-5
            assert close.mean() >= 0.999, (name, n, close.mean())
        by_tp.setdefault(tp_rank, []).append(out["params"])
    for replicas in by_tp.values():
        assert len(replicas) == 2
        for n, p in replicas[0].items():
            np.testing.assert_array_equal(p, replicas[1][n])


@pytest.mark.parametrize("name", CASE_NAMES)
def test_llama_replicated_parameters_agree_across_tp(llama_dp, name):
    """The replicated (norm) weights are the same on both ranks of a tp
    group after 3 steps: their sequence-parallel gradients were summed."""
    _, _, ranks = llama_dp
    norms = [{n: p for n, p in r[name]["params"].items() if "norm" in n}
             for r in ranks]
    assert norms[0]
    for other in norms[1:]:
        for n, p in norms[0].items():
            np.testing.assert_array_equal(p, other[n])


def test_zero1_state_matches_jax_at_tp2_dp2(llama_dp):
    """Under ZeRO-1 each rank's AdamW moments are its dp slice of its tp
    shard of JAX's ``mu``/``nu`` (eligible leaves hold 1/dp of their
    shard), and the replicated-state case holds whole shards."""
    _, want, ranks = llama_dp
    for r in ranks:
        z = r["tp2_dp2_sp_zero1"]
        assert z["zero1"]
        tp_rank, dp_rank = z["tp"][1], z["dp"][1]
        for moment, key in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
            cut = _flat(zero1_shard_for_rank(shard_params_for_rank(
                want["tp2_dp2_sp_zero1"][key], 2, tp_rank), 2, dp_rank))
            for n, st in z["state"].items():
                assert st[moment].size * 2 == z["params"][n].size, n
                np.testing.assert_allclose(st[moment], cut[n], rtol=1e-4,
                                           atol=1e-8, err_msg=n)
        rep = r["tp2_kvr2_dp2_accum"]
        assert not rep["zero1"]
        for n, st in rep["state"].items():
            assert st["exp_avg"].shape == rep["params"][n].shape


def test_llama_dp_collectives(llama_dp):
    """What a tp = 2 x dp = 2 ZeRO-1 step adds over dp: one 2-element
    all-reduce of the loss sum and token count, one gradient
    reduce-scatter and one parameter all-gather (a bucket each at this
    size); the same counts on every rank."""
    _, _, ranks = llama_dp
    first = ranks[0]["tp2_dp2_sp_zero1"]["counts"]
    for r in ranks:
        assert r["tp2_dp2_sp_zero1"]["counts"] == first
    c = first[0]
    assert c["reduce_scatter"] >= 1 and c["all_gather"] >= 1
