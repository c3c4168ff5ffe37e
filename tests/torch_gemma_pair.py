"""The JAX side, and the world, of the PyTorch port's tests of Gemma and
Gemma-2 past one rank and of the dense attention core at context-parallel
degree > 1 (``tests/test_torch_gemma_{tp,cp}.py``,
``tests/test_torch_dense_cp.py``).

:func:`run` spawns one 4-rank gloo world
(``torch_tp_workers.gemma_parallel_cases``) that trains each asked case
from its rank's tp shard of the JAX tree, 3 steps on the same global
batches as JAX's ``make_train_step`` at the same mesh on four virtual CPU
devices (ZeRO-1 on, fp32, learning rate 1e-3), while this process runs the
JAX side.  The Gemma configs carry no cp field, in either package, so a
case picks its blocks' cp schedule through a subclass of the config.
Losses and grad norms agree within ``rtol=2e-5, atol=2e-6``, parameters
within 1e-4 (``tests/test_torch_cp_train.py``'s bounds), and the cp ranks
of a tp rank hold the same parameters bit for bit (:func:`check_training`).
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import linen as nn

import neuronx_distributed_tpu as nxd
from neuronx_distributed_tpu.models.common import (
    causal_lm_loss as jax_causal_lm_loss,
    make_causal_lm_loss_sum as jax_make_loss_sum,
)
from neuronx_distributed_tpu.models.gemma import (
    Gemma2Config as JaxGemma2Config,
    Gemma2ForCausalLM as JaxGemma2,
    GemmaConfig as JaxGemmaConfig,
    GemmaForCausalLM as JaxGemma,
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
B, S, LR, CHUNK = 4, 32, 1e-3, 16
F32 = dict(dtype=jnp.float32, param_dtype=jnp.float32)

# Gemma-2's final softcap, cut so that it bites on the tiny model's logits
# (at init they are ~0.2, where 30 * tanh(s / 30) is s to a part in 1e5)
CAP = dict(final_softcap=0.1)

# name: family, tp, cp, the blocks' cp schedule (impl, zigzag), config
# overrides, the chunked loss head's chunk (0: the mean loss)
TRAIN = {
    "gemma_tp2_sp": ("gemma", 2, 1, None, {}, 0),
    "gemma2_tp2_sp": ("gemma2", 2, 1, None, CAP, CHUNK),
    "gemma2_cp2_ring": ("gemma2", 2, 2, ("ring", False),
                        dict(CAP, attention_impl="flash",
                             remat="selective"), 0),
    "gemma2_cp2_ulysses": ("gemma2", 2, 2, ("ulysses", False),
                           dict(CAP, attention_impl="flash",
                                num_kv_heads=4), 0),
    "gemma_cp2_zigzag": ("gemma", 2, 2, ("ring", True),
                         dict(attention_impl="flash"), 0),
    "gemma2_cp2_dense": ("gemma2", 2, 2, None, CAP, 0),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _mesh(tp, cp):
    destroy_model_parallel()
    initialize_model_parallel(tensor_parallel_size=tp,
                              context_parallel_size=cp,
                              devices=jax.devices()[:4])


def _jax_gemma(family, overrides, schedule=None, **extra):
    """JAX's module for a case: the tiny config (fp32, sequence parallel,
    remat off unless asked), its blocks on ``schedule`` when given."""
    base = JaxGemmaConfig if family == "gemma" else JaxGemma2Config
    kw = {"remat": "none", "max_seq_len": S, **overrides, **extra}
    cfg = base.tiny(sequence_parallel=True, **kw, **F32)
    if schedule is not None:
        impl, zigzag = schedule

        class Picked(base):
            def block_config(self, *args):
                return dataclasses.replace(super().block_config(*args),
                                           cp_impl=impl, cp_zigzag=zigzag)

        cfg = Picked(**{f.name: getattr(cfg, f.name)
                        for f in dataclasses.fields(cfg)})
    return (JaxGemma if family == "gemma" else JaxGemma2)(cfg)


def _batches(rs, zigzag):
    ids = rs.randint(0, 256, (B, S)).astype(np.int32)
    b = {"ids": ids, "labels": np.roll(ids, -1, axis=1)}
    if zigzag:
        b["positions"] = np.broadcast_to(np.arange(S, dtype=np.int32),
                                         (B, S)).copy()
        b = {k: np.asarray(zigzag_permute(v, 2, axis=1))
             for k, v in b.items()}
    return [b] * 3


def _jax_model(name):
    family, tp, cp, schedule, overrides, _ = TRAIN[name]
    _mesh(tp, cp)
    config = nxd.training_config(
        tensor_parallel_size=tp, context_parallel_size=cp,
        zero_one_enabled=True, learning_rate=LR, compute_dtype="float32")
    model = jax_init_model(config, lambda: _jax_gemma(family, overrides,
                                                      schedule),
                           (jnp.zeros((1, S), jnp.int32),))
    return config, model


def _jax_train(name, batches):
    """JAX's 3 steps of a case: per-step loss and grad norm, final params,
    and for Gemma-2 the first batch's mean loss of the model and of the
    same weights without a final softcap."""
    config, model = _jax_model(name)
    chunk = TRAIN[name][5]
    loss = jax_make_loss_sum(chunk) if chunk else jax_causal_lm_loss
    opt = jax_init_opt(config, model)
    step = jax_make_train_step(config, model, opt, loss,
                               batch_spec={k: jax_batch_spec()
                                           for k in batches[0]})
    b0 = {k: jnp.asarray(v) for k, v in batches[0].items()}
    out = {}
    if TRAIN[name][0] == "gemma2":
        bare = _jax_gemma("gemma2", TRAIN[name][4], final_softcap=0.0)
        out["uncapped"] = float(jax.jit(lambda p: jax_causal_lm_loss(
            bare, p, b0))(model.params))
        out["capped"] = float(jax.jit(lambda p: jax_causal_lm_loss(
            model.module, p, b0))(model.params))
    params, state, metrics = model.params, opt.state, []
    for b in batches:
        params, state, m = step(params, state,
                                {k: jnp.asarray(v) for k, v in b.items()},
                                None)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    out.update(metrics=np.array(metrics), params=_np(params)["params"])
    return out


def _llama_cfg():
    return JaxLlamaConfig.tiny(attention_impl="dense", sequence_parallel=True,
                               remat="none", max_seq_len=S, **F32)


def _forward_ref(case):
    """JAX's side of a forward case: Gemma-2's logits at tp = 2, or the
    tiny dense Llama's logits and gradients of ``mean(logits ** 2)`` at tp
    = 2 x cp = 2 (on the ids in sequence order)."""
    from conftest import sharded_params

    _mesh(case["tp"], case["cp"])
    ids = jnp.asarray(case["ref_ids"])
    params = sharded_params({"params": case["tree"]})
    if case["family"] == "gemma2":
        model = _jax_gemma("gemma2", CAP)
        return {"logits": np.asarray(jax.jit(model.apply)(params, ids))}
    model = JaxLlama(_llama_cfg())
    grads = jax.jit(jax.grad(lambda p: jnp.mean(
        model.apply(p, ids).astype(jnp.float32) ** 2)))(params)
    return {"logits": np.asarray(jax.jit(model.apply)(params, ids)),
            "grads": _np(grads)["params"]}


def gemma2_logits_case(tree, ids):
    """Gemma-2's logits at tp = 2 (x dp = 2) on ``ids``, cacheless and
    cached, from ``tree`` (the ``gemma2_tp2_sp`` case's)."""
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), ids.shape).copy()
    return dict(name="gemma2_tp2_logits", family="gemma2", tp=2, cp=1,
                cfg=dict(CAP, remat="none", max_seq_len=S), tree=tree,
                ids=ids, ref_ids=ids, positions=pos)


def llama_dense_case(ids, zigzag):
    """The tiny Llama's dense core at tp = 2 x cp = 2 on ``ids`` (permuted
    into zigzag order for the port when ``zigzag``), from JAX's init."""
    _mesh(2, 2)
    tree = _np(nn.unbox(JaxLlama(_llama_cfg()).init(
        jax.random.PRNGKey(1), jnp.asarray(ids))))["params"]
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), ids.shape).copy()
    cfg = dict(attention_impl="dense", remat="none", max_seq_len=S)
    name = "llama_dense_cp2"
    if zigzag:
        cfg["cp_zigzag"] = True
        ids_p, pos = (np.asarray(zigzag_permute(x, 2, axis=1))
                      for x in (ids, pos))
        name += "_zigzag"
    else:
        ids_p = ids
    return dict(name=name, family="llama", tp=2, cp=2, cfg=cfg, tree=tree,
                ids=ids_p, ref_ids=ids, positions=pos)


def run(names, forward=(), refusals=False, seed=0):
    """The world for the training cases ``names`` (of :data:`TRAIN`) and
    the forward cases ``forward`` (functions of ``(trees, rs)`` giving a
    case), with JAX's side in this process meanwhile: ``(want, ranks)``,
    ``want`` by case name."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    rs = np.random.RandomState(seed)
    batches, trees, train = {}, {}, []
    for name in names:
        family, tp, cp, schedule, overrides, chunk = TRAIN[name]
        batches[name] = _batches(rs, schedule is not None and schedule[1])
        _, model = _jax_model(name)
        trees[name] = _np(model.params)["params"]
        train.append(dict(
            name=name, family=family, tp=tp, cp=cp, chunk=chunk,
            cp_impl=schedule and schedule[0],
            zigzag=bool(schedule and schedule[1]),
            cfg={"remat": "none", "max_seq_len": S, **overrides},
            tree=trees[name], batches=batches[name]))
    fwd = [make(trees, rs) for make in forward]
    inp = {"train": train, "forward": fwd, "lr": LR, "refusals": refusals}
    ranks, want = {}, {}

    def world():
        ranks["out"] = spawn(workers.gemma_parallel_cases, 4, (inp,),
                             timeout_s=240)

    th = threading.Thread(target=world)
    th.start()
    try:
        for name in names:
            want[name] = _jax_train(name, batches[name])
        for case in fwd:
            want[case["name"]] = dict(_forward_ref(case), case=case)
    finally:
        th.join()
        destroy_model_parallel()
    if "out" not in ranks:
        pytest.fail("the 4-rank world did not finish")
    return want, ranks["out"]


def check_training(want, ranks, name):
    """Every rank's losses, grad norms and parameters against JAX's; the
    ranks that share a tp and dp coordinate hold the same parameters."""
    tp, cp = TRAIN[name][1:3]
    by_tp = {}
    for r in ranks:
        got = r[name]
        assert got["tp"][0] == tp and got["cp"][0] == cp
        np.testing.assert_allclose(
            np.stack([got["losses"], got["norms"]], 1),
            want[name]["metrics"], **STEP_TOL)
        cut = flat(shard_params_for_rank(want[name]["params"], tp,
                                         got["tp"][1]))
        assert set(cut) == set(got["params"])
        for n, p in got["params"].items():
            np.testing.assert_allclose(p, cut[n], rtol=0, atol=1e-4,
                                       err_msg=n)
        first = by_tp.setdefault((got["tp"][1], got["dp"][1]),
                                 got["params"])
        for n, p in got["params"].items():
            np.testing.assert_array_equal(p, first[n], err_msg=n)
    assert want[name]["metrics"][-1, 0] < want[name]["metrics"][0, 0]


def check_capped_loss(want, ranks, name):
    """A Gemma-2 case's first-step loss is JAX's capped loss, and the
    uncapped loss on the same weights lies well outside the bound."""
    w = want[name]
    assert w["capped"] == pytest.approx(w["metrics"][0, 0], rel=1e-6)
    gap = abs(w["uncapped"] - w["capped"])
    assert gap > 10 * (STEP_TOL["atol"] + STEP_TOL["rtol"] * abs(w["capped"]))
    for r in ranks:
        assert r[name]["losses"][0] == pytest.approx(w["capped"], rel=2e-5)
