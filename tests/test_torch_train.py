"""PyTorch port: the training step on the CPU against the JAX trainer.

A tiny GQA Llama is initialised by JAX (``initialize_parallel_model`` at
tp = 1 on one CPU device) and moved into the port with
``convert.llama_params_from_jax``.  Both ``make_train_step``s then take the
same seeded numpy batches.  In fp32 the loss and the gradient norm agree to
1e-5 relative (fp32 sums in another order) and the parameters to a tenth
of the learning rate after the first and the third update: AdamW divides
each gradient element by ``sqrt(v) + eps``, so an element whose gradient is
near zero, where the two frameworks' sums round differently, can move by
up to ``lr`` in one and not the other; nearly all elements agree to 2e-6.  The cases
cover both loss contracts, ``grad_accum_steps=2``, clipping that bites, the
constant, linear and warmup + cosine schedules, ignored labels and a
packed batch.  Port-only cases hold the flash core to the dense core and
every ``remat`` mode to ``none`` (the same tolerances); bf16 compute is held loosely to the
JAX bf16 step (loss 2e-2, grad norm 5e-2 relative: the two frameworks round
bf16 activations in different places).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neuronx_distributed_tpu as nxd
from neuronx_distributed_tpu.models.common import (
    causal_lm_loss as jax_causal_lm_loss,
    causal_lm_loss_sum as jax_causal_lm_loss_sum,
    make_causal_lm_loss_sum as jax_make_causal_lm_loss_sum,
)
from neuronx_distributed_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig,
    LlamaForCausalLM as JaxLlama,
)
from neuronx_distributed_tpu.parallel import mesh as mesh_lib
from neuronx_distributed_tpu.trainer import (
    initialize_parallel_model as jax_init_model,
    initialize_parallel_optimizer as jax_init_opt,
    make_train_step as jax_make_train_step,
)
from neuronx_distributed_tpu_torch.config import training_config
from neuronx_distributed_tpu_torch.convert import llama_params_from_jax
from neuronx_distributed_tpu_torch.models.common import (
    causal_lm_loss,
    causal_lm_loss_sum,
    make_causal_lm_loss_sum,
)
from neuronx_distributed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from neuronx_distributed_tpu_torch.optimizer import build_lr_schedule
from neuronx_distributed_tpu_torch.parallel.loss import parallel_cross_entropy
from neuronx_distributed_tpu_torch.trainer import (
    initialize_parallel_model,
    initialize_parallel_optimizer,
    make_train_step,
)

B, S, STEPS = 4, 16, 3
LOSSES = {
    "mean": (jax_causal_lm_loss, causal_lm_loss),
    "sum": (jax_causal_lm_loss_sum, causal_lm_loss_sum),
    "chunked": (jax_make_causal_lm_loss_sum(8), make_causal_lm_loss_sum(8)),
}

# (name, loss, grad_accum_steps, optimizer kwargs, batch kind)
CASES = [
    ("mean_constant", "mean", 1, dict(learning_rate=1e-3), "plain"),
    ("sum_accum2_warmup_cosine_clip", "sum", 2,
     dict(learning_rate=2e-3, lr_schedule="cosine", warmup_steps=1,
          total_steps=3, min_lr_ratio=0.1, max_grad_norm=0.05), "ignore"),
    ("mean_accum2_linear_noclip", "mean", 2,
     dict(learning_rate=1e-3, lr_schedule="linear", warmup_steps=2,
          total_steps=4, grad_clipping=False), "plain"),
    ("chunked_packed", "chunked", 1, dict(learning_rate=1e-3), "packed"),
]


def batches(kind, vocab, seed=0):
    """STEPS seeded host batches; ``ignore`` drops some labels (-100),
    ``packed`` carries two documents per row with their own positions and
    segment ids (the tail is padding, id 0, label -100)."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(STEPS):
        ids = rs.randint(0, vocab, size=(B, S)).astype(np.int32)
        labels = np.roll(ids, -1, axis=1)
        b = {"ids": ids, "labels": labels}
        if kind == "ignore":
            labels[rs.rand(B, S) < 0.3] = -100
        if kind == "packed":
            seg = np.zeros((B, S), np.int32)
            pos = np.zeros((B, S), np.int32)
            for r in range(B):
                cut, end = 5 + r, S - 2 - (r % 2)
                seg[r, :cut], seg[r, cut:end] = 1, 2
                pos[r, :cut] = np.arange(cut)
                pos[r, cut:end] = np.arange(end - cut)
            labels[seg == 0] = -100
            b.update(positions=pos, segment_ids=seg)
        out.append(b)
    return out


def jax_model(opt_kw, dtype="float32"):
    mesh_lib.initialize_model_parallel(tensor_parallel_size=1,
                                       devices=jax.devices()[:1])
    config = nxd.training_config(tensor_parallel_size=1, seed=0,
                                 param_dtype="float32", compute_dtype=dtype,
                                 **opt_kw)
    jcfg = JaxLlamaConfig.tiny(num_kv_heads=2, dtype=getattr(jnp, dtype),
                               param_dtype=jnp.float32,
                               sequence_parallel=False, remat="none",
                               max_seq_len=S)
    model = jax_init_model(config, lambda: JaxLlama(jcfg),
                           (jnp.zeros((1, S), jnp.int32),))
    return config, model


def port_model(opt_kw, params, dtype="float32", **cfg_kw):
    config = training_config(seed=0, compute_dtype=dtype, **opt_kw)
    cfg = LlamaConfig.tiny(num_kv_heads=2, dtype=getattr(torch, dtype),
                           param_dtype=torch.float32, **cfg_kw)
    model = initialize_parallel_model(
        config, lambda d: LlamaForCausalLM(cfg, device=d), device="cpu")
    model.module.load_state_dict(llama_params_from_jax(params, cfg))
    return config, model


def flat_jax(params):
    return {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(
                params["params"])[0]}


def run_jax(config, model, loss, accum, data, snapshots=(1, 3)):
    opt = jax_init_opt(config, model)
    step = jax_make_train_step(config, model, opt, LOSSES[loss][0],
                               grad_accum_steps=accum)
    params, state = model.params, opt.state
    metrics, snaps = [], {}
    for i, b in enumerate(data, 1):
        params, state, m = step(params, state,
                                {k: jnp.asarray(v) for k, v in b.items()},
                                None)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        if i in snaps or i in snapshots:
            snaps[i] = flat_jax(params)
    return metrics, snaps


def run_port(config, model, loss, accum, data, snapshots=(1, 3)):
    opt = initialize_parallel_optimizer(config, model)
    step = make_train_step(config, model, opt, LOSSES[loss][1],
                           grad_accum_steps=accum)
    metrics, snaps = [], {}
    for i, b in enumerate(data, 1):
        m = step(b)
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
        if i in snapshots:
            snaps[i] = {k: v.detach().numpy().copy()
                        for k, v in model.module.state_dict().items()}
    return metrics, snaps


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_train_step_matches_jax(case):
    _, loss, accum, opt_kw, kind = case
    jconfig, jmodel = jax_model(opt_kw)
    params = jax.tree.map(np.asarray, jmodel.params)  # before donation
    pconfig, pmodel = port_model(opt_kw, params, remat="none")
    data = batches(kind, 256)
    jm, jsnap = run_jax(jconfig, jmodel, loss, accum, data)
    pm, psnap = run_port(pconfig, pmodel, loss, accum, data)
    np.testing.assert_allclose(np.array(pm), np.array(jm), rtol=1e-5, atol=0)
    if opt_kw.get("max_grad_norm"):
        assert jm[0][1] > opt_kw["max_grad_norm"]  # the clip bites
    lr = opt_kw["learning_rate"]
    for i in (1, 3):
        for name, want in jsnap[i].items():
            np.testing.assert_allclose(psnap[i][name], want, atol=0.1 * lr,
                                       rtol=0, err_msg=f"{name} after {i}")
            close = np.abs(psnap[i][name] - want) <= 2e-6
            assert close.mean() >= 0.999, (name, i, close.mean())


def test_flash_core_and_remat_modes_agree_in_the_port():
    """Same weights and batches: the flash core (its CPU plain versions
    under the same autograd function the kernels use) and the dense core,
    and remat none/selective/full, give the same losses, grad norms and
    parameters (fp32: 1e-5 relative; parameters to a tenth of lr)."""
    opt_kw = dict(learning_rate=1e-3)
    _, jmodel = jax_model(opt_kw)
    params = jax.tree.map(np.asarray, jmodel.params)
    data = batches("packed", 256, seed=3)
    runs = {}
    for impl, remat in (("dense", "none"), ("flash", "none"),
                        ("flash", "selective"), ("flash", "full")):
        config, model = port_model(opt_kw, params, attention_impl=impl,
                                   remat=remat)
        runs[impl, remat] = run_port(config, model, "chunked", 1, data,
                                     snapshots=(2,))
    ref_m, ref_s = runs["dense", "none"]
    for key, (m, snap) in runs.items():
        np.testing.assert_allclose(np.array(m), np.array(ref_m), rtol=1e-5,
                                   err_msg=str(key))
        for name, want in ref_s[2].items():
            np.testing.assert_allclose(snap[2][name], want, atol=1e-4,
                                       rtol=0, err_msg=f"{key} {name}")


def test_bf16_compute_matches_jax_loosely():
    opt_kw = dict(learning_rate=1e-3)
    jconfig, jmodel = jax_model(opt_kw, dtype="bfloat16")
    params = jax.tree.map(np.asarray, jmodel.params)
    pconfig, pmodel = port_model(opt_kw, params, dtype="bfloat16",
                                 attention_impl="flash", remat="none")
    data = batches("plain", 256, seed=5)
    jm, _ = run_jax(jconfig, jmodel, "sum", 1, data, snapshots=())
    pm, _ = run_port(pconfig, pmodel, "sum", 1, data, snapshots=())
    jm, pm = np.array(jm), np.array(pm)
    np.testing.assert_allclose(pm[:, 0], jm[:, 0], rtol=2e-2)
    np.testing.assert_allclose(pm[:, 1], jm[:, 1], rtol=5e-2)
    assert all(p.dtype == torch.float32 for p in pmodel.module.parameters())


@pytest.mark.parametrize("schedule,kw", [
    ("constant", dict(warmup_steps=3)),
    ("linear", dict(warmup_steps=2, total_steps=9, min_lr_ratio=0.2)),
    ("cosine", dict(warmup_steps=2, total_steps=9, min_lr_ratio=0.1)),
])
def test_lr_schedule_matches_optax(schedule, kw):
    from neuronx_distributed_tpu.optimizer.adamw_fp32 import (
        build_lr_schedule as jax_build_lr_schedule,
    )

    jax_s = jax_build_lr_schedule(1e-3, schedule, **kw)
    port_s = build_lr_schedule(1e-3, schedule, **kw)
    for count in range(12):
        np.testing.assert_allclose(port_s(count), float(jax_s(count)),
                                   rtol=1e-6, atol=1e-12)


def test_cross_entropy_matches_jax():
    from neuronx_distributed_tpu.parallel.loss import (
        parallel_cross_entropy as jax_parallel_cross_entropy,
    )

    rs = np.random.RandomState(0)
    logits = (rs.standard_normal((3, 5, 40)) * 4).astype(np.float32)
    targets = rs.randint(-2, 40, size=(3, 5)).astype(np.int32)
    for smoothing in (0.0, 0.1):
        want = jax_parallel_cross_entropy(jnp.asarray(logits),
                                          jnp.asarray(targets), smoothing)
        got = parallel_cross_entropy(torch.from_numpy(logits),
                                     torch.from_numpy(targets), smoothing)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


def test_trainer_refusals():
    cfg = LlamaConfig.tiny(dtype=torch.float32, param_dtype=torch.float32)
    build = lambda d: LlamaForCausalLM(cfg, device=d)  # noqa: E731
    # FSDP is ported (A11b) but not under a pipeline, as in JAX; in one
    # process it is no placement at all (dp = 1)
    with pytest.raises(ValueError, match="fsdp.*pipeline"):
        initialize_parallel_model(training_config(
            fsdp=True, pipeline_parallel_size=2), build, device="cpu")
    whole = initialize_parallel_model(training_config(fsdp=True), build,
                                      device="cpu")
    assert not hasattr(whole.module, "_fsdp")
    # tp, dp, cp, pp and ep are ported: one process is no world of 2
    for kw in (dict(tensor_parallel_size=2), dict(data_parallel_size=2),
               dict(context_parallel_size=2),
               dict(pipeline_parallel_size=2),
               dict(expert_parallel_size=2)):
        with pytest.raises(ValueError, match="not divisible|inconsistent"):
            initialize_parallel_model(training_config(**kw), build,
                                      device="cpu")
    config = training_config(compute_dtype="float32")
    model = initialize_parallel_model(config, build, device="cpu")
    # trainable= (PEFT, A13) freezes what its predicate rejects
    frozen = initialize_parallel_optimizer(
        config, model, trainable=lambda n: n.startswith("lm_head"))
    assert frozen.update_mask == {n: n == "lm_head.kernel" for n, _ in
                                  model.module.named_parameters()}
    assert [n for n, p in model.module.named_parameters()
            if p.requires_grad] == ["lm_head.kernel"]
    for p in model.module.parameters():
        p.requires_grad_(True)
    opt = initialize_parallel_optimizer(config, model)
    with pytest.raises(ValueError, match="loss_fn"):
        make_train_step(config, model, opt)
    step = make_train_step(config, model, opt, causal_lm_loss,
                           grad_accum_steps=3)
    with pytest.raises(ValueError, match="divisible"):
        step(batches("plain", 256)[0])
    with pytest.raises(TypeError, match="unknown config keys"):
        training_config(bogus=1)


def test_config_rebuilds_a_disagreeing_model():
    """TrainingConfig is authoritative over the model's dtypes and remat:
    a bf16-param model built by ``model_fn`` comes back with fp32 masters
    and the policy's remat."""
    cfg = LlamaConfig.tiny(dtype=torch.bfloat16, remat="none")
    config = training_config(compute_dtype="float32", policy="full")
    model = initialize_parallel_model(
        config, lambda d: LlamaForCausalLM(cfg, device=d), device="cpu")
    mcfg = model.module.config
    assert (mcfg.dtype, mcfg.param_dtype, mcfg.remat) == (
        torch.float32, torch.float32, "full")
    assert all(p.dtype == torch.float32 for p in model.module.parameters())
    with pytest.raises(ValueError, match="flash path"):
        flash = LlamaForCausalLM(LlamaConfig.tiny(
            dtype=torch.float32, attention_impl="flash"), device="cpu")
        flash.init_random(0)
        flash(torch.zeros((1, 4), dtype=torch.long),
              kv_valid=torch.ones((1, 4), dtype=torch.int32))


def test_fp32_masters_survive_conversion():
    _, jmodel = jax_model(dict(learning_rate=1e-3))
    params = jax.tree.map(np.asarray, jmodel.params)
    _, pmodel = port_model(dict(learning_rate=1e-3), params)
    flat = flat_jax(params)
    for name, p in pmodel.module.state_dict().items():
        assert p.dtype == torch.float32
        np.testing.assert_array_equal(p.numpy(), flat[name])


def test_bf16_params_accumulate_in_fp32():
    """bf16 weights (``param_dtype="bfloat16"``): two microbatches' grads
    are summed in fp32 and cast once, so the step equals the single-shot
    step to bf16 rounding."""
    cfg = LlamaConfig.tiny(num_kv_heads=2, dtype=torch.bfloat16,
                           param_dtype=torch.bfloat16, remat="none")
    config = training_config(param_dtype="bfloat16", learning_rate=1e-3)
    data = batches("ignore", 256, seed=7)[0]
    runs = []
    for accum in (1, 2):
        model = initialize_parallel_model(
            config, lambda d: LlamaForCausalLM(cfg, device=d), seed=0,
            device="cpu")
        opt = initialize_parallel_optimizer(config, model)
        m = make_train_step(config, model, opt, causal_lm_loss_sum,
                            grad_accum_steps=accum)(data)
        runs.append((m["loss"].item(), m["grad_norm"].item()))
        assert all(p.dtype == torch.bfloat16
                   for p in model.module.parameters())
    np.testing.assert_allclose(runs[1], runs[0], rtol=2e-2)
