"""PyTorch port: MoE and the expert axis against the JAX package (the
counterparts of JAX ``tests/test_moe.py`` and ``tests/test_swa.py:369``).

In this process: capacity drops and the Mixtral preset's shapes, the
serving refusals, and the layer's refusals.  One spawned 4-rank gloo world
(``torch_moe_workers.world4_cases``) runs, against JAX at the same mesh on
four virtual CPU devices, from the same numpy inputs and JAX's weights:

- the layer at tp = 2 x ep = 2 (scatter against einsum, without and with
  drops; expert choice against its numpy oracle; the dense routing oracle);
- the MoE Llama's train step at tp = 2 x ep = 2 (sequence parallelism,
  remat) and at dp = 2 x ep = 2 (ZeRO-1, the token-weighted loss, capacity
  drops): the first step's gradient leaves, the steps' losses and grad
  norms, the parameters and the AdamW moments.  At pp = 1 JAX routes the
  GLOBAL batch, so the port gathers every batch rank's tokens before it
  routes; an expert's gradient then holds every token of the group and is
  summed over the pure dp axis only;
- SWA + MoE, flash against dense logits;
- the pipelined MoE at tp = 2 x pp = 2 under 1F1B, the interleaved
  schedule and uneven cuts with a ragged M (against GPipe's autodiff and
  JAX's), at pp = 2 x ep = 2 with both dispatches (against JAX's pipelined
  model and JAX's pp = 1), and the aux normalisation against pp = 1.

One 8-rank world (``torch_moe_workers.world8_cases``) trains at tp = 2 x
pp = 2 x ep = 2: the Mixtral ratio (8 experts, top-2, scatter) and expert
choice, against JAX's pipelined train step on eight devices.

Tolerances: the layer's outputs and gradients within ``rtol 2e-5, atol
1e-6`` (JAX's own), the dense oracle within 2e-4, a model's first-step
gradients within 1e-5, losses and grad norms within ``rtol 2e-5, atol
2e-6``, parameters within a tenth of the learning rate
(``tests/test_torch_tp_train.py``), pipelined gradients (sums over the
token count) within ``rtol 1e-4, atol 1e-5``.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

import neuronx_distributed_tpu as nxd
from neuronx_distributed_tpu.models.common import (
    causal_lm_loss as jax_causal_lm_loss,
    causal_lm_loss_sum as jax_causal_lm_loss_sum,
)
from neuronx_distributed_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig,
    LlamaForCausalLM as JaxLlama,
    build_pipelined_llama as jax_build_llama,
)
from neuronx_distributed_tpu.parallel.mesh import (
    destroy_model_parallel,
    initialize_model_parallel,
)
from neuronx_distributed_tpu.parallel.moe import ExpertParallelMLP as JaxMoE
from neuronx_distributed_tpu.trainer import (
    default_batch_spec as jax_batch_spec,
    initialize_parallel_model as jax_init_model,
    initialize_parallel_optimizer as jax_init_opt,
    make_train_step as jax_make_train_step,
)
from neuronx_distributed_tpu_torch.convert import (
    ep_shard_for_rank,
    fsdp_shard_for_rank,
    llama_params_from_jax,
    pipelined_grads_from_jax,
    shard_params_for_rank,
    zero1_shard_for_rank,
)
from neuronx_distributed_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from neuronx_distributed_tpu_torch.parallel.moe import (
    ExpertParallelMLP,
    capacity,
)
from neuronx_distributed_tpu_torch.utils.distributed import spawn
from conftest import sharded_params
import torch_moe_workers as workers

LAYER_TOL = dict(rtol=2e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rtol=2e-5, atol=2e-6)
PIPE_TOL = dict(rtol=1e-4, atol=1e-5)
S = 16
F32 = dict(dtype=jnp.float32, param_dtype=jnp.float32)

# the layer at tp = 2 x ep = 2: E 4 experts, I 32, top-2 on [4, 8, 16]
LAYER_CASES = {
    "einsum_nodrop": dict(dispatch="einsum", cap=4.0, router="topk"),
    "scatter_nodrop": dict(dispatch="scatter", cap=4.0, router="topk"),
    "einsum_drop": dict(dispatch="einsum", cap=0.5, router="topk"),
    "scatter_drop": dict(dispatch="scatter", cap=0.5, router="topk"),
    "expert_choice": dict(dispatch="einsum", cap=1.0,
                          router="expert_choice"),
}

MOE = dict(num_experts=4, moe_top_k=2)
# the train-step cases: the JAX mesh and config, the loss, the steps
TRAIN_CASES = {
    "tp2_ep2": dict(mesh=dict(tensor_parallel_size=2, expert_parallel_size=2),
                    cfg=dict(MOE, moe_dispatch="scatter",
                             sequence_parallel=True),
                    loss="causal_lm_loss", lr=3e-3, steps=8, ignore=0.0),
    "dp2_ep2": dict(mesh=dict(expert_parallel_size=2),
                    cfg=dict(MOE, moe_dispatch="scatter",
                             moe_capacity_factor=1.0),
                    loss="causal_lm_loss_sum", lr=1e-3, steps=3,
                    ignore=0.2),
    # FSDP over dp x ep: the experts stay whole on their ep shard
    "dp2_ep2_fsdp": dict(mesh=dict(expert_parallel_size=2, fsdp=True),
                         cfg=dict(MOE, moe_dispatch="einsum"),
                         loss="causal_lm_loss_sum", lr=1e-3, steps=2,
                         ignore=0.0, grads=False),
}
GRAD_CASES = [n for n, c in TRAIN_CASES.items() if c.get("grads", True)]
JAX_LOSSES = {"causal_lm_loss": jax_causal_lm_loss,
              "causal_lm_loss_sum": jax_causal_lm_loss_sum}

# the pipelined cases: mesh, schedule, microbatches, layers
PIPE_MOE = dict(MOE, moe_capacity_factor=4.0, sequence_parallel=False)
TP_PP = dict(tensor_parallel_size=2, pipeline_parallel_size=2)
EP_PP = dict(pipeline_parallel_size=2, expert_parallel_size=2)
PIPE_CASES = {
    "1f1b": dict(mesh=TP_PP, schedule="1f1b", M=4, layers=4),
    "interleaved": dict(mesh=TP_PP, schedule="interleaved", M=4, V=2,
                        layers=4),
    "interleaved_cuts_ragged": dict(mesh=TP_PP, schedule="interleaved", M=3,
                                    V=2, cuts=(1, 3, 5), layers=6),
    "ep2_einsum": dict(mesh=EP_PP, schedule="1f1b", M=2, layers=4,
                       dispatch="einsum"),
    "ep2_scatter": dict(mesh=EP_PP, schedule="1f1b", M=2, layers=4,
                        dispatch="scatter"),
    "aux_pp2": dict(mesh=TP_PP, schedule="1f1b", M=2, layers=4, cap=8.0),
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


def _mesh(**kw):
    destroy_model_parallel()
    n = (kw.get("tensor_parallel_size", 1) * kw.get("pipeline_parallel_size", 1)
         * kw.get("expert_parallel_size", 1) * kw.pop("dp", 1))
    initialize_model_parallel(**kw, devices=jax.devices()[:n])


def _moe_kwargs(case):
    return dict(num_experts=4, intermediate_size=32, top_k=2,
                capacity_factor=case["cap"], dispatch=case["dispatch"],
                router_type=case["router"], **F32)


def dense_moe_reference(params, x, top_k):
    """Every token through its top-k experts with no capacity: the
    semantics oracle (JAX ``tests/test_moe.py:_dense_moe_reference``)."""
    router, wi, wo = params["router"], params["gate_up"], params["down"]
    xt = x.reshape(-1, x.shape[-1]).astype(np.float32)
    logits = xt @ router
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs = probs / probs.sum(-1, keepdims=True)
    order = np.argsort(-probs, axis=-1)[:, :top_k]
    out = np.zeros_like(xt)
    for n in range(xt.shape[0]):
        gates = probs[n, order[n]]
        gates = gates / gates.sum()
        for gk, e in zip(gates, order[n]):
            gu = np.einsum("h,hfi->fi", xt[n], wi[e])
            h = (gu[0] / (1 + np.exp(-gu[0]))) * gu[1]
            out[n] += gk * (h @ wo[e])
    return out.reshape(x.shape)


def expert_choice_reference(params, x, K, factor):
    """Each expert takes its top-C tokens by probability (JAX
    ``tests/test_moe.py:108``'s numpy oracle)."""
    router, wi, wo = params["router"], params["gate_up"], params["down"]
    E = router.shape[1]
    xt = x.reshape(-1, x.shape[-1]).astype(np.float32)
    N = xt.shape[0]
    cap = max(int(factor * K * N / E + 0.999), K)
    cap = min(-(-cap // 4) * 4, N)
    logits = xt @ router
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs = probs / probs.sum(-1, keepdims=True)
    out = np.zeros_like(xt)
    for e in range(E):
        for n in np.argsort(-probs[:, e], kind="stable")[:cap]:
            gu = np.einsum("h,hfi->fi", xt[n], wi[e])
            h = (gu[0] / (1 + np.exp(-gu[0]))) * gu[1]
            out[n] += probs[n, e] * (h @ wo[e])
    return out.reshape(x.shape)


# -- JAX's side -------------------------------------------------------------------


def jax_layer(case, x):
    """JAX's layer at the live mesh: initial params, output, aux and the
    gradients of ``sum(y^2) + aux`` (params and input)."""
    mod = JaxMoE(**_moe_kwargs(case))
    boxed = mod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    params = sharded_params({"params": boxed["params"]})

    def f(p, a):
        y, aux = mod.apply(p, a)
        return jnp.sum(y * y) + aux, (y, aux)

    (_, (y, aux)), (g, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    return {"params": _np(nn.unbox(boxed["params"])), "y": np.asarray(y),
            "aux": float(aux), "grads": _np(g["params"]),
            "x_grad": np.asarray(gx)}


def lm_batches(rs, B, n, ignore):
    ids = rs.randint(0, 256, (B, S)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1)
    labels[rs.rand(B, S) < ignore] = -100
    return [{"ids": ids, "labels": labels}] * n


def clean_model(model):
    """JAX's model without the ``losses`` collection its init pass sowed:
    left in ``model.params``, the train step's ``apply(mutable=["losses"])``
    appends each step's aux terms to those stale ones (the layer mean then
    halves the live aux and its gradient) and AdamW trains them as
    parameters.  The reference run is JAX's step on the parameters alone,
    which is what its ``causal_lm_loss`` computes on a clean tree."""
    import dataclasses

    return dataclasses.replace(
        model, params={"params": model.params["params"]},
        param_specs={"params": model.param_specs["params"]})


def jax_train(case, batches):
    """JAX's trainer at the live mesh: the initial params, the gradients
    of the first batch's loss, per-step losses and grad norms, the final
    params and the AdamW moments."""
    cfg = JaxLlamaConfig.tiny(remat="none", **F32, **case["cfg"])
    config = nxd.training_config(**case["mesh"], learning_rate=case["lr"],
                                 compute_dtype="float32", seed=0)
    model = clean_model(jax_init_model(config, lambda: JaxLlama(cfg),
                                       (jnp.zeros((1, S), jnp.int32),)))
    params0 = _np(model.params)["params"]
    loss = JAX_LOSSES[case["loss"]]
    b0 = {k: jnp.asarray(v) for k, v in batches[0].items()}

    def mean_loss(p):
        out = loss(model.module, p, b0)
        return out[0] / out[1] if isinstance(out, tuple) else out

    grads0 = _np(jax.jit(jax.grad(mean_loss))(
        {"params": model.params["params"]}))["params"]
    opt = jax_init_opt(config, model)
    spec = {k: jax_batch_spec() for k in batches[0]}
    step = jax_make_train_step(config, model, opt, loss, batch_spec=spec)
    params, state, metrics = model.params, opt.state, []
    for b in batches:
        params, state, m = step(params, state,
                                {k: jnp.asarray(v) for k, v in b.items()},
                                None)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return {"params0": params0, "grads0": grads0,
            "metrics": np.array(metrics), "params": _np(params)["params"],
            "mu": _np(state[0].mu)["params"],
            "nu": _np(state[0].nu)["params"]}


def _pipe_cfg(case, jax_side=True):
    kw = dict(PIPE_MOE, num_layers=case["layers"], remat="none",
              max_seq_len=S, moe_dispatch=case.get("dispatch", "einsum"),
              moe_capacity_factor=case.get("cap", 4.0))
    return JaxLlamaConfig.tiny(**F32, **kw) if jax_side else kw


def jax_pipeline(case, pm, batch):
    (ls, tok), grads = jax.jit(pm.loss_and_grad_fn)(
        pm.params, jnp.asarray(batch["ids"]), jnp.asarray(batch["labels"]))
    return {"loss": float(ls), "tok": float(tok), "grads": _np(grads)}


def jax_pp1_loss(case, batch):
    """The loss over tokens of JAX's pipelined model at pp = 1 (one
    device) from the same seed: the GSPMD path, routing per microbatch."""
    _mesh()
    p1 = jax_build_llama(_pipe_cfg(case), num_microbatches=case["M"], seed=3)
    ls, tok = jax.jit(p1.loss_fn)(p1.params, jnp.asarray(batch["ids"]),
                                  jnp.asarray(batch["labels"]))
    return float(ls) / float(tok)


# -- the 4-rank world ---------------------------------------------------------------


@pytest.fixture(scope="module")
def world4():
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    rs = np.random.RandomState(0)
    inp = {"layer": {}, "train": {}, "pipeline": {}}
    want = {"layer": {}, "train": {}, "pipeline": {}}
    x = rs.standard_normal((4, 8, 16)).astype(np.float32)
    _mesh(tensor_parallel_size=2, expert_parallel_size=2)
    for name, case in LAYER_CASES.items():
        want["layer"][name] = jax_layer(case, x)
        inp["layer"][name] = dict(case, x=x, E=4, I=32, K=2,
                                  params=want["layer"][name]["params"])
    # the train cases need JAX's initial weights before the world starts
    runs = {}
    for name, case in TRAIN_CASES.items():
        batches = lm_batches(rs, 8, case["steps"], case["ignore"])
        _mesh(**{k: v for k, v in case["mesh"].items() if k != "fsdp"},
              dp=4 // (case["mesh"].get("tensor_parallel_size", 1)
                       * case["mesh"]["expert_parallel_size"]))
        want["train"][name] = jax_train(case, batches)
        inp["train"][name] = dict(
            case, cfg=dict(case["cfg"], remat="selective"), batches=batches,
            params=want["train"][name]["params0"])
    swa_cfg = dict(MOE, moe_dispatch="einsum", sequence_parallel=False,
                   max_seq_len=32, sliding_window=10)
    _mesh(tensor_parallel_size=2, expert_parallel_size=2)
    swa_ids = rs.randint(0, 256, (2, 32)).astype(np.int32)
    jcfg = JaxLlamaConfig.tiny(attention_impl="dense", **F32, **swa_cfg)
    swa_model = jax_init_model(nxd.training_config(
        tensor_parallel_size=2, expert_parallel_size=2,
        compute_dtype="float32"), lambda: JaxLlama(jcfg),
        (jnp.zeros((1, 32), jnp.int32),))
    want["swa"] = np.asarray(jax.jit(swa_model.module.apply)(
        {"params": swa_model.params["params"]}, jnp.asarray(swa_ids)))
    inp["swa"] = {"ids": swa_ids, "cfg": swa_cfg,
                  "params": _np(swa_model.params)["params"]}
    models = {}
    for name, case in PIPE_CASES.items():
        _mesh(**case["mesh"])
        pm = jax_build_llama(_pipe_cfg(case), num_microbatches=case["M"],
                             seed=3, schedule=case["schedule"],
                             num_chunks=case.get("V", 1),
                             pipeline_cuts=case.get("cuts"))
        ids = rs.randint(0, 256, (4 * case["M"] if "ep2" in name
                                  else 2 * case["M"], S)).astype(np.int32)
        batch = {"ids": ids, "labels": np.roll(ids, -1, axis=1)}
        models[name] = (pm, batch)
        inp["pipeline"][name] = dict(
            case, cfg=_pipe_cfg(case, jax_side=False), ids=batch["ids"],
            labels=batch["labels"], params=_np(pm.params),
            rows=tuple(pm.layer_rows))
    ranks = {}

    def run():
        ranks["out"] = spawn(workers.world4_cases, 4, (inp,), timeout_s=400)

    th = threading.Thread(target=run)
    th.start()
    try:
        for name, case in PIPE_CASES.items():
            pm, batch = models[name]
            _mesh(**case["mesh"])
            want["pipeline"][name] = jax_pipeline(case, pm, batch)
            if "ep2" in name or name == "aux_pp2":
                want["pipeline"][name]["pp1"] = jax_pp1_loss(case, batch)
    finally:
        th.join()
        destroy_model_parallel()
    if "out" not in ranks:
        pytest.fail("the 4-rank world did not finish")
    return inp, want, ranks["out"]


def _layer_cut(tree, r):
    return ep_shard_for_rank(shard_params_for_rank(
        {"moe_mlp": tree}, 2, r["tp"][1]), 2, r["ep"][1])["moe_mlp"]


@pytest.mark.parametrize("name", list(LAYER_CASES))
def test_layer_matches_jax(world4, name):
    """tp = 2 x ep = 2: each rank's output rows, aux, input gradient and
    complete parameter gradients (its experts, its I slice) equal JAX's;
    each rank holds 2 of the 4 experts."""
    _, want, ranks = world4
    w = want["layer"][name]
    seen = set()
    for rank in ranks:
        r = rank["layer"][name]
        assert r["local_experts"] == 2
        seen.add((r["tp"][1], r["ep"][1]))
        lo, hi = r["rows"]
        np.testing.assert_allclose(r["y"], w["y"][lo:hi], **LAYER_TOL)
        np.testing.assert_allclose(r["x_grad"], w["x_grad"][lo:hi],
                                   **LAYER_TOL)
        assert r["aux"] == pytest.approx(w["aux"], rel=1e-6, abs=1e-9)
        cut = _layer_cut(w["grads"], r)
        assert set(cut) == set(r["grads"])
        for n, g in r["grads"].items():
            np.testing.assert_allclose(g, cut[n], err_msg=n, **LAYER_TOL)
    assert seen == {(0, 0), (0, 1), (1, 0), (1, 1)}


@pytest.mark.parametrize("cap", ["nodrop", "drop"])
def test_scatter_dispatch_matches_einsum(world4, cap):
    """Scatter against the einsum oracle on the same rank: the output bit
    for bit (both combine choice by choice, the products exact), the aux
    and every gradient within JAX's tolerance; the dropping case drops."""
    _, want, ranks = world4
    for rank in ranks:
        e, s = rank["layer"][f"einsum_{cap}"], rank["layer"][f"scatter_{cap}"]
        np.testing.assert_array_equal(s["y"], e["y"])
        assert s["aux"] == e["aux"]
        for n, g in s["grads"].items():
            np.testing.assert_allclose(g, e["grads"][n], err_msg=n,
                                       **LAYER_TOL)
    if cap == "drop":
        # capacity 0.5: some (token, choice) pairs went unserved
        assert capacity(0.5, 2, 64, 4) < 2 * 64 // 4


def test_layer_matches_dense_routing_oracle(world4):
    """No drops (capacity factor 4): every rank's rows equal the dense
    routing oracle (no capacity machinery) within 2e-4; aux >= 1."""
    inp, want, ranks = world4
    case = inp["layer"]["einsum_nodrop"]
    ref = dense_moe_reference(case["params"], case["x"], 2)
    for rank in ranks:
        r = rank["layer"]["einsum_nodrop"]
        lo, hi = r["rows"]
        np.testing.assert_allclose(r["y"], ref[lo:hi], rtol=2e-4, atol=2e-4)
        assert r["aux"] >= 1.0 - 1e-5


def test_expert_choice_matches_numpy_oracle(world4):
    """Experts choose their top-C tokens: each rank's rows equal the numpy
    oracle; aux is exactly 0."""
    inp, _, ranks = world4
    case = inp["layer"]["expert_choice"]
    ref = expert_choice_reference(case["params"], case["x"], 2, 1.0)
    for rank in ranks:
        r = rank["layer"]["expert_choice"]
        lo, hi = r["rows"]
        np.testing.assert_allclose(r["y"], ref[lo:hi], rtol=2e-4, atol=2e-5)
        assert r["aux"] == 0.0


def _nest(flat):
    out = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        d = out
        for k in path:
            d = d.setdefault(k, {})
        d[leaf] = v
    return out


def _train_cut(tree, r, case):
    tp = case["mesh"].get("tensor_parallel_size", 1)
    ep = case["mesh"]["expert_parallel_size"]
    return _flat(ep_shard_for_rank(shard_params_for_rank(
        tree, tp, r["tp"][1]), ep, r["ep"][1]))


@pytest.mark.parametrize("name", GRAD_CASES)
def test_moe_llama_gradients_match_jax(world4, name):
    """The first step's complete gradients, every leaf (this rank's tp and
    ep cut of JAX's), within 1e-5: the routing over the global batch, the
    aux term's share on each rank, the experts' dp-only sum."""
    _, want, ranks = world4
    case = TRAIN_CASES[name]
    for rank in ranks:
        r = rank[name]
        cut = _train_cut(want["train"][name]["grads0"], r, case)
        assert set(cut) == set(r["grads"])
        for n, g in r["grads"].items():
            np.testing.assert_allclose(g, cut[n], err_msg=f"{name} {n}",
                                       **GRAD_TOL)


@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_moe_llama_trains_like_jax(world4, name):
    """Through ``make_train_step``: the first step's loss and grad norm
    within STEP_TOL of JAX's on every rank, every rank the same, the
    parameters after the steps within a tenth of the learning rate of
    JAX's cut (under FSDP its dp x ep piece, the experts whole), and the
    expert leaves' E / ep experts per rank."""
    _, want, ranks = world4
    case, w = TRAIN_CASES[name], want["train"][name]
    fsdp = case["mesh"].get("fsdp", False)
    n = 3
    for rank in ranks:
        r = rank[name]
        got = np.stack([r["losses"], r["norms"]], axis=1)
        np.testing.assert_allclose(got[:n], w["metrics"][:n], **STEP_TOL)
        assert r["losses"][0] == pytest.approx(w["metrics"][0, 0], rel=1e-5)
        assert r["losses"] == ranks[0][name]["losses"]
        cut = _train_cut(w["params"], r, case)
        if fsdp:
            cut = _flat(fsdp_shard_for_rank(_nest(cut), 4, r["dp"][1]))
        for p, v in r["params"].items():
            np.testing.assert_allclose(v, cut[p], rtol=0,
                                       atol=case["lr"] / 10, err_msg=p)
            if p.endswith(("moe_mlp.gate_up", "moe_mlp.down")):
                assert v.shape == (2, *cut[p].shape[1:])
        assert r["zero1"] == (not fsdp) and r["fsdp"] == fsdp


def test_moe_llama_trains_and_balances(world4):
    """tp = 2 x ep = 2, 8 steps at lr 3e-3 on one batch: the loss falls
    by more than 0.3, as JAX's does (JAX ``tests/test_moe.py:214``), the
    aux stays >= 1 and each layer's routing statistics are finite; one
    step gathers the tokens 3 times a layer (forward, the remat recompute,
    the reduce-scatter's backward) and reduce-scatters them twice (forward,
    the gather's backward: the recompute stops at the last saved tensor,
    before the layer's closing reduce-scatter)."""
    _, want, ranks = world4
    w = want["train"]["tp2_ep2"]["metrics"][:, 0]
    assert w[-1] < w[0] - 0.3
    for rank in ranks:
        r = rank["tp2_ep2"]
        assert r["losses"][-1] < r["losses"][0] - 0.3, r["losses"]
        for st in r["stats"]:
            assert st["aux"] >= 1.0 - 1e-5 and 0.0 <= st["dropped"] < 1.0
        c = r["counts"][0]
        assert (c["ep_all_gather"], c["ep_reduce_scatter"]) == (3 * 2, 2 * 2)


def test_moe_training_at_dp2_ep2_keeps_adamw_like_jax(world4):
    """dp = 2 x ep = 2 (ZeRO-1 over the 4 batch ranks): after 3 steps each
    rank's AdamW moments equal its ZeRO-1 slice of JAX's -- an expert's
    whole on its ep shard, every other leaf sliced over dp x ep -- and the
    capacity factor 1.0 dropped pairs."""
    _, want, ranks = world4
    w = want["train"]["dp2_ep2"]
    for rank in ranks:
        r = rank["dp2_ep2"]
        assert r["dp"][0] == 4 and r["ep"][0] == 2
        for key, m in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
            cut = _flat(zero1_shard_for_rank(ep_shard_for_rank(
                w[m], 2, r["ep"][1]), 4, r["dp"][1]))
            for n, st in r["moments"].items():
                scale = float(np.abs(cut[n]).max()) + 1e-30
                np.testing.assert_allclose(st[key], cut[n], rtol=1e-3,
                                           atol=1e-4 * scale,
                                           err_msg=f"{key} {n}")
            for n in r["moments"]:
                if n.endswith(("moe_mlp.gate_up", "moe_mlp.down")):
                    assert r["moments"][n][key].shape == r["params"][n].shape
        assert any(st["dropped"] > 0 for st in r["stats"])


def test_swa_moe_flash_matches_dense(world4):
    """A sliding window with MoE at tp = 2 x ep = 2: the flash core's
    logits equal the dense core's, and JAX's (JAX ``tests/test_swa.py:
    369``)."""
    _, want, ranks = world4
    for rank in ranks:
        r = rank["swa"]
        lo, hi = r["rows"]
        np.testing.assert_allclose(r["flash"], r["dense"], rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(r["dense"], want["swa"][lo:hi],
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", list(PIPE_CASES))
def test_pipelined_moe_matches_jax_and_autodiff(world4, name):
    """Each rank's loss and complete gradient sums under the schedule
    equal GPipe's autodiff on the port and JAX's pipelined model cut for
    the rank; the router's gradient is nonzero (the aux channel works on
    every stage and chunk); at pp = 2 x ep = 2 a rank holds 2 of the 4
    experts and the loss over tokens equals JAX's at pp = 1."""
    _, want, ranks = world4
    case, w = PIPE_CASES[name], want["pipeline"][name]
    for rank in ranks:
        r = rank["pipeline"][name]
        assert r["tok"] == w["tok"]
        assert r["loss"] == pytest.approx(w["loss"], rel=1e-5)
        assert r["oracle_loss"] == pytest.approx(r["loss"], rel=1e-5)
        ep = case["mesh"].get("expert_parallel_size", 1)
        layers = [i for c in r["layers"] for i in c]
        cut = pipelined_grads_from_jax(
            w["grads"], r["rows"], layers, embed=r["pp"][1] == 0,
            head=r["pp"][1] == 1, tp=r["tp"][0], rank=r["tp"][1], ep=ep,
            ep_rank=r["ep"][1])
        assert set(cut) == set(r["grads"])
        for n, g in r["grads"].items():
            tol = dict(err_msg=f"{name} {n}", **PIPE_TOL)
            np.testing.assert_allclose(g / r["tok"], cut[n] / w["tok"], **tol)
            np.testing.assert_allclose(r["oracle_grads"][n] / r["tok"],
                                       g / r["tok"], **tol)
        routers = [g for n, g in r["grads"].items()
                   if n.endswith("moe_mlp.router")]
        assert routers and all(np.abs(g).max() > 0 for g in routers)
        assert set(r["local_experts"].values()) == {4 // ep}
        if "pp1" in w:
            assert r["loss"] / r["tok"] == pytest.approx(w["pp1"], rel=5e-4)


# -- the 8-rank world ---------------------------------------------------------------

WORLD8 = {
    "mixtral_ratio": dict(num_experts=8, moe_top_k=2, moe_dispatch="scatter"),
    "expert_choice": dict(num_experts=4, moe_top_k=2,
                          moe_router="expert_choice"),
}


@pytest.fixture(scope="module")
def world8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    rs = np.random.RandomState(1)
    mesh = dict(tensor_parallel_size=2, pipeline_parallel_size=2,
                expert_parallel_size=2)
    inp, want = {}, {}
    for name, moe in WORLD8.items():
        kw = dict(moe, num_layers=4, sequence_parallel=False, max_seq_len=S)
        _mesh(**mesh)
        config = nxd.training_config(**mesh, learning_rate=1e-3,
                                     compute_dtype="float32",
                                     num_microbatches=2)
        pm = jax_init_model(config, lambda kw=kw: JaxLlama(
            JaxLlamaConfig.tiny(remat="none", **F32, **kw)),
            (jnp.zeros((1, S), jnp.int32),))
        batches = lm_batches(rs, 4, 6, 0.0)
        inp[name] = {"mesh": mesh, "M": 2, "cfg": kw, "batches": batches,
                     "params": _np(pm.params), "rows": tuple(pm.layer_rows)}
        opt = jax_init_opt(config, pm)
        step = jax_make_train_step(config, pm, opt, None)
        params, state, metrics = pm.params, opt.state, []
        for b in batches:
            params, state, m = step(params, state,
                                    {k: jnp.asarray(v) for k, v in b.items()},
                                    None)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        want[name] = np.array(metrics)
    destroy_model_parallel()
    return want, spawn(workers.world8_cases, 8, (inp,), timeout_s=400)


@pytest.mark.parametrize("name", list(WORLD8))
def test_pp_ep_tp_training_matches_jax(world8, name):
    """tp = 2 x pp = 2 x ep = 2 (JAX ``tests/test_moe.py:146, :357``): 6
    steps' losses and grad norms equal JAX's pipelined train step's within
    STEP_TOL at the first step and 1e-3 after, the loss falls, and each
    rank holds ``E / 2`` experts."""
    want, ranks = world8
    w = want[name]
    E = WORLD8[name]["num_experts"]
    for r in ranks:
        t = r[name]
        got = np.stack([t["losses"], t["norms"]], axis=1)
        np.testing.assert_allclose(got[0], w[0], **STEP_TOL)
        np.testing.assert_allclose(got, w, rtol=1e-3, atol=1e-5)
        assert t["losses"][-1] < t["losses"][0]
        assert t["local_experts"] == [E // 2]
        assert t["pp"][0] == 2 and t["ep"][0] == 2 and t["tp"][0] == 2


# -- in this process ------------------------------------------------------------------


def test_capacity_drops_tokens():
    """Capacity factor 0.05 at top-1 over 64 tokens: capacity is the floor
    4 a expert, so at most 8 rows are served; the output is finite and
    equals JAX's (JAX ``tests/test_moe.py:197``)."""
    _mesh()
    kw = dict(num_experts=2, intermediate_size=16, top_k=1,
              capacity_factor=0.05, **F32)
    mod = JaxMoE(**kw)
    x = np.random.RandomState(3).standard_normal((1, 64, 8)).astype(
        np.float32)
    params = nn.unbox(mod.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    y_jax, _ = jax.jit(lambda p, a: mod.apply(p, a))(
        {"params": params["params"]}, jnp.asarray(x))
    destroy_model_parallel()
    port = ExpertParallelMLP(8, 2, 16, top_k=1, capacity_factor=0.05,
                             device="cpu", dtype=torch.float32,
                             param_dtype=torch.float32)
    port.load_state_dict({k: torch.from_numpy(np.array(v))
                          for k, v in params["params"].items()})
    y, aux = port(torch.from_numpy(x))
    arr = y.detach().numpy()
    assert np.isfinite(arr).all()
    assert (np.abs(arr.reshape(-1, 8)).max(-1) > 1e-9).sum() <= 8
    np.testing.assert_allclose(arr, np.asarray(y_jax), **LAYER_TOL)
    assert float(port.stats["dropped"]) > 0.8


def test_mixtral_preset_shapes():
    """The Mixtral-8x7B preset (JAX ``tests/test_moe.py:418``), and its
    cut's converter shapes at ep = 2 and tp = 2."""
    cfg = LlamaConfig.mixtral_8x7b()
    want = JaxLlamaConfig.mixtral_8x7b()
    for f in ("num_experts", "moe_top_k", "moe_dispatch", "hidden_size",
              "intermediate_size", "num_kv_heads", "num_heads", "vocab_size",
              "rope_theta", "num_layers", "moe_capacity_factor",
              "moe_router", "moe_local_experts"):
        assert getattr(cfg, f) == getattr(want, f), f
    tiny = LlamaConfig.mixtral_8x7b(hidden_size=64, intermediate_size=128,
                                    num_layers=2, num_heads=8, num_kv_heads=8,
                                    vocab_size=256, max_seq_len=64)
    assert tiny.num_experts == 8
    tree = {"model": {"layer_0": {"moe_mlp": {
        "router": np.zeros((64, 8)), "gate_up": np.zeros((8, 64, 2, 128)),
        "down": np.zeros((8, 128, 64))}}}}
    cut = _flat(ep_shard_for_rank(shard_params_for_rank(tree, 2, 1), 2, 0))
    assert cut["model.layer_0.moe_mlp.gate_up"].shape == (4, 64, 2, 64)
    assert cut["model.layer_0.moe_mlp.down"].shape == (4, 64, 64)
    assert cut["model.layer_0.moe_mlp.router"].shape == (64, 8)


def test_moe_converter_and_launcher_preset():
    """``llama_params_from_jax`` takes the ``moe_mlp`` leaves (and refuses
    a dense tree for an MoE config); the launcher offers the preset."""
    from neuronx_distributed_tpu_torch.examples.llama_pretrain import (
        PRESETS,
        parse_args,
    )

    assert "mixtral_8x7b" in PRESETS
    assert parse_args(["--preset", "mixtral_8x7b"]).preset == "mixtral_8x7b"
    cfg = LlamaConfig.tiny(num_experts=4, num_layers=1, dtype=torch.float32,
                           param_dtype=torch.float32)
    model = LlamaForCausalLM(cfg, device="cpu").init_random(0)
    tree = {}
    for n, p in model.state_dict().items():
        *path, leaf = n.split(".")
        d = tree
        for k in path:
            d = d.setdefault(k, {})
        d[leaf] = p.numpy()
    sd = llama_params_from_jax(tree, cfg)
    assert sd["model.layer_0.moe_mlp.gate_up"].shape == (4, 64, 2, 128)
    dense = LlamaConfig.tiny(num_layers=1)
    with pytest.raises(ValueError, match="does not fit"):
        llama_params_from_jax(tree, dense)


def test_layer_refusals():
    """The JAX layer's ValueErrors, and the pipeline's divisibility check
    (each at the layer's construction, as JAX raises at its call)."""
    mk = lambda **kw: ExpertParallelMLP(  # noqa: E731
        16, **{**dict(num_experts=4, intermediate_size=32), **kw},
        device="cpu")
    with pytest.raises(ValueError, match="top_k=5 > num_experts=4"):
        mk(top_k=5)
    with pytest.raises(ValueError, match="unknown dispatch"):
        mk(dispatch="dense")
    with pytest.raises(ValueError, match="unknown router_type"):
        mk(router_type="hash")
    with pytest.raises(ValueError, match="manual ep axis"):
        mk(num_experts=2, num_experts_global=4)


def test_serving_refuses_moe():
    """``ParallelInferenceModel`` and ``ServingEngine`` refuse an MoE model
    with the NotImplementedError naming ROADMAP T1b."""
    import neuronx_distributed_tpu_torch as port

    cfg = LlamaConfig.tiny(num_experts=4, num_layers=1, dtype=torch.float32)
    moe = LlamaForCausalLM(cfg, device="cpu").init_random(0)
    icfg = port.InferenceConfig(2, 8, 16, torch.float32)
    with pytest.raises(NotImplementedError, match="T1b"):
        port.ParallelInferenceModel(moe, icfg, device="cpu")
    dense = LlamaForCausalLM(LlamaConfig.tiny(num_layers=1,
                                              dtype=torch.float32),
                             device="cpu").init_random(0)
    pim = port.ParallelInferenceModel(dense, icfg, device="cpu")
    pim.module = moe
    with pytest.raises(NotImplementedError, match="T1b"):
        port.ServingEngine(pim, page_size=4, device="cpu")


def test_moe_forward_fills_aux_and_remat_keeps_it():
    """One process: the losses see each MoE layer's aux once (a recompute
    under remat adds none), ``causal_lm_loss_sum / tok`` equals
    ``causal_lm_loss``, and the gradients under selective remat equal
    those without."""
    from neuronx_distributed_tpu_torch.models.common import (
        MOE_AUX_COEF,
        causal_lm_loss,
        causal_lm_loss_sum,
        make_causal_lm_loss_sum,
    )

    ids = torch.from_numpy(np.random.RandomState(5).randint(0, 256, (2, 16)))
    batch = {"ids": ids, "labels": torch.roll(ids, -1, 1)}
    grads = {}
    for remat in ("none", "selective", "full"):
        cfg = LlamaConfig.tiny(num_experts=4, remat=remat,
                               dtype=torch.float32, param_dtype=torch.float32)
        model = LlamaForCausalLM(cfg, device="cpu").init_random(1)
        terms = []
        logits = model(ids, aux=terms)
        assert len(terms) == cfg.num_layers and logits.shape[-1] == 256
        loss = causal_lm_loss(model, batch)
        with torch.no_grad():
            ls, tok = causal_lm_loss_sum(model, batch)
            cs, ctok = make_causal_lm_loss_sum(8)(model, batch)
            plain = causal_lm_loss(
                type("Dense", (), {"__call__": lambda s, i: model(i),
                                   "tp": model.tp})(), batch)
        assert float(ls / tok) == pytest.approx(loss.item(), rel=1e-6)
        assert float(cs / ctok) == pytest.approx(loss.item(), rel=1e-5)
        aux = torch.stack(terms).mean().detach()
        assert (loss.detach() - plain).item() == pytest.approx(
            float(MOE_AUX_COEF * aux), rel=1e-5)
        loss.backward()
        grads[remat] = {n: p.grad.clone() for n, p in model.named_parameters()}
    for remat in ("selective", "full"):
        for n, g in grads[remat].items():
            torch.testing.assert_close(g, grads["none"][n], rtol=1e-5,
                                       atol=1e-6, msg=n)


def test_expert_leaves_stay_whole_under_zero1_and_fsdp():
    """JAX's ``_dp_extend`` leaves a spec that names ``ep`` alone: the
    experts' ZeRO-1 state and FSDP placement stay whole on their ep shard
    (the converters' cuts and the optimizer's layout), every other leaf is
    cut over dp as before."""
    from neuronx_distributed_tpu_torch.optimizer.zero1 import (
        optimizer_state_layout,
    )

    tree = {"layer_0": {"moe_mlp": {
        "router": np.zeros((8, 4)), "gate_up": np.zeros((4, 8, 2, 16)),
        "down": np.zeros((4, 16, 8))}, "attn": {"o_proj": {
            "kernel": np.zeros((8, 8))}}}}
    for cut in (zero1_shard_for_rank(tree, 2, 1),
                fsdp_shard_for_rank(tree, 2, 1)):
        flat = _flat(cut)
        assert flat["layer_0.moe_mlp.gate_up"].shape == (4, 8, 2, 16)
        assert flat["layer_0.moe_mlp.down"].shape == (4, 16, 8)
        assert flat["layer_0.attn.o_proj.kernel"].shape == (4, 8)
        assert flat["layer_0.moe_mlp.router"].shape == (4, 4)
    mod = ExpertParallelMLP(8, 4, 16, device="cpu")
    layout = dict(zip([n for n, _ in mod.named_parameters()],
                      optimizer_state_layout(list(mod.parameters()), 2)))
    assert layout == {"router": (0, 4), "gate_up": None, "down": None}
