"""PyTorch port: LoRA fine-tuning (PEFT) against the JAX package's, the
port of JAX ``tests/test_lora.py``.

One spawned 2-rank gloo world (``torch_tp_workers.lora_cases``) holds the
tiny Llama with rank-4 adapters on every target (``qkv``, ``o_proj``,
``mlp``, ``lm_head``) at tp = 2 under sequence parallelism, loaded from
each rank's shard of the JAX tree, and runs JAX's six cases against JAX
at tp = 2 on two virtual CPU devices over the same weights and batches:

- zero-init adapters leave the base model's logits unchanged (bit for bit
  within the port; JAX's within 1e-5);
- ``trainable=peft.lora_trainable``: 3 steps on one batch (the adapters'
  B factors set off zero first, so every factor's gradient is live from
  step 1) whose losses, grad norms and parameters match JAX's at the
  tolerances and learning rate (1e-3) of ``tests/test_torch_tp_train.py``,
  the base bit-unchanged, AdamW state only for the adapters;
- ``merge_lora`` of each rank's trained shard gives a ``lora_rank = 0``
  model whose logits equal the adapted model's (JAX's 2e-5);
- ``merge_lora`` of a stacked ``[L, ...]`` tree (JAX ``scan_layers``; the
  port has no scanned layers, so its merge is held on JAX's stacked tree
  itself, leaf for leaf);
- ``strip_lora`` recovers the base model exactly;
- the frozen base's gradients do not shape the clip norm: the step's
  grad norm is the adapters' alone (JAX's oracle, 1e-4 relative);

and, at tp = 2 with KV replication (kvr = 2, one kv head: each rank's
``lora_b_v`` a replica whose gradient is summed over kvr), the same
steps against JAX's; at dp = 2 under ZeRO-1, the same steps against JAX at
dp = 2 with
optimizer state only for the trainable set; and under FSDP (JAX's
``trainable=`` takes any placement, so the port's does too: the frozen
pieces are gathered and never reduce-scattered) against the same JAX
run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neuronx_distributed_tpu as nxd
from neuronx_distributed_tpu import peft as jax_peft
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
from neuronx_distributed_tpu_torch import peft
from neuronx_distributed_tpu_torch.convert import (
    fsdp_shard_for_rank,
    shard_params_for_rank,
)
from neuronx_distributed_tpu_torch.utils.distributed import spawn
import torch_tp_workers as workers

TARGETS = ("qkv", "o_proj", "mlp", "lm_head")
STEP_TOL = dict(rtol=2e-5, atol=2e-6)
S, LR = 16, 1e-3


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


def _jax_run(devices, batches, ids, tp=1, dp=1, kvr=1, kv_heads=8):
    """JAX's LoRA Llama on ``devices`` at tp x dp: initial params, logits
    of ``ids`` before training, the adapter and full gradient norms of the
    first batch, per-step losses and grad norms under
    ``trainable=lora_trainable``, and the final params."""
    destroy_model_parallel()
    initialize_model_parallel(tensor_parallel_size=tp,
                              kv_size_multiplier=kvr, devices=devices)
    f32 = dict(dtype=jnp.float32, param_dtype=jnp.float32)
    cfg = JaxLlamaConfig.tiny(lora_rank=4, lora_targets=TARGETS,
                              num_kv_heads=kv_heads,
                              sequence_parallel=tp > 1, remat="none", **f32)
    config = nxd.training_config(tensor_parallel_size=tp,
                                 kv_size_multiplier=kvr, learning_rate=LR,
                                 compute_dtype="float32",
                                 zero_one_enabled=True)
    model = jax_init_model(config, lambda: JaxLlama(cfg),
                           (jnp.zeros((1, S), jnp.int32),))
    # give the adapters' B factors a value so the steps move every factor
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: x + 0.01 if "lora_b" in jax.tree_util.keystr(p) else x,
        model.params)
    out = {"params0_zero": _np(model.params)["params"],
           "params0": _np(params)["params"],
           "logits0": np.asarray(jax.jit(model.apply)(model.params, ids))}
    batch0 = {k: jnp.asarray(v) for k, v in batches[0].items()}
    grads = jax.jit(jax.grad(lambda p: jax_causal_lm_loss(
        model.module, p, batch0)))(params)
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    sq = lambda xs: float(sum(jnp.sum(jnp.square(x)) for x in xs)) ** 0.5  # noqa
    out["adapter_norm"] = sq([g for p, g in flat
                              if "lora_" in jax.tree_util.keystr(p)])
    out["full_norm"] = sq([g for _, g in flat])
    opt = jax_init_opt(config, model, trainable=jax_peft.lora_trainable)
    spec = {k: jax_batch_spec() for k in batches[0]}
    step = jax_make_train_step(config, model, opt, jax_causal_lm_loss,
                               batch_spec=spec)
    state, metrics = opt.state, []
    for b in batches:
        params, state, m = step(params, state,
                                {k: jnp.asarray(v) for k, v in b.items()},
                                None)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    out["metrics"] = np.array(metrics)
    out["params"] = _np(params)["params"]
    out["logits_adapted"] = np.asarray(jax.jit(model.apply)(params, ids[:2]))
    merged = jax_peft.merge_lora(_np(params), alpha=cfg.lora_alpha)
    dense = JaxLlama(JaxLlamaConfig.tiny(num_kv_heads=kv_heads,
                                         sequence_parallel=tp > 1,
                                         remat="none", **f32))
    out["logits_merged"] = np.asarray(jax.jit(dense.apply)(merged, ids[:2]))
    destroy_model_parallel()
    return out


@pytest.fixture(scope="module")
def lora():
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 256, (8, S)).astype(np.int32)
    batches = [{"ids": ids, "labels": np.roll(ids, -1, axis=1)}] * 3
    ids = rs.randint(0, 256, (2, S)).astype(np.int32)
    want = {"tp2": _jax_run(jax.devices()[:2], batches, ids, tp=2),
            "dp2": _jax_run(jax.devices()[:2], batches, ids, dp=2),
            "kvr2": _jax_run(jax.devices()[:2], batches, ids, tp=2, kvr=2,
                             kv_heads=1)}
    inp = {"targets": TARGETS, "tree": want["tp2"]["params0"],
           "tree_dp2": want["dp2"]["params0"],
           "tree_kvr2": want["kvr2"]["params0"], "batches": batches,
           "ids": ids}
    zero = {"targets": TARGETS, "tree": want["tp2"]["params0_zero"]}
    return inp, want, spawn(workers.lora_cases, 2, (inp, zero),
                            timeout_s=170)


def test_zero_init_adapters_match_base(lora):
    """lora_b = 0: the adapted model's logits equal the base model's bit
    for bit (the port draws adapters after the base, and adds an exact
    zero), and JAX's adapted logits."""
    _, want, ranks = lora
    for r in ranks:
        np.testing.assert_array_equal(r["zero"]["adapted0"],
                                      r["zero"]["base"])
        np.testing.assert_allclose(r["zero"]["adapted0"],
                                   want["tp2"]["logits0"], rtol=1e-5,
                                   atol=1e-5)
    # and a port model drawn from a seed: the same base with or without
    # adapters
    from neuronx_distributed_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaForCausalLM,
    )
    f32 = dict(dtype=torch.float32, param_dtype=torch.float32)
    a = LlamaForCausalLM(LlamaConfig.tiny(lora_rank=4, lora_targets=TARGETS,
                                          **f32), device="cpu").init_random(3)
    b = LlamaForCausalLM(LlamaConfig.tiny(**f32), device="cpu").init_random(3)
    x = torch.randint(0, 256, (2, S))
    with torch.no_grad():
        assert torch.equal(a(x), b(x))
    assert all(torch.equal(p, b.state_dict()[n])
               for n, p in a.state_dict().items() if "lora_" not in n)
    assert a.model.layer_0.attn.qkv.lora_a_q.abs().sum() > 0
    assert a.model.layer_0.attn.qkv.lora_b_q.abs().sum() == 0


def test_frozen_base_trains_only_adapters(lora):
    """3 steps at tp = 2 with SP: losses, grad norms and every parameter
    against JAX's; the base bit-unchanged and without gradients; AdamW
    state for the adapters only."""
    _, want, ranks = lora
    for r in ranks:
        got = r["tp2"]
        np.testing.assert_allclose(
            np.stack([got["losses"], got["norms"]], 1),
            want["tp2"]["metrics"], **STEP_TOL)
        cut = _flat(shard_params_for_rank(want["tp2"]["params"], 2,
                                          got["rank"]))
        assert set(cut) == set(got["params"])
        for n, p in got["params"].items():
            np.testing.assert_allclose(p, cut[n], rtol=0, atol=1e-4,
                                       err_msg=n)
        lora_names = {n for n in got["params"] if "lora_" in n}
        assert len(lora_names) == (4 + 2 + 4) * 2 + 2
        for n in got["params"]:
            assert got["requires_grad"][n] == (n in lora_names), n
            assert got["mask"][n] == (n in lora_names), n
            if n not in lora_names:
                assert got["unchanged"][n], f"frozen param moved: {n}"
        moved = [n for n in lora_names if not got["unchanged"][n]]
        assert len(moved) == len(lora_names)
        assert got["state"] == sorted(lora_names)
    assert want["tp2"]["metrics"][-1, 0] < want["tp2"]["metrics"][0, 0]


def test_merge_lora_reproduces_adapted_model(lora):
    """Each rank's trained shard merged (``kernel += alpha/r * A @ B``)
    into a model without adapters gives the adapted model's logits (JAX's
    2e-5), and JAX's merged logits within 1e-3: after 3 steps the two
    frameworks' parameters agree to a tenth of the learning rate (1e-4),
    not to rounding (AdamW moves near-zero gradients by noise)."""
    _, want, ranks = lora
    for r in ranks:
        np.testing.assert_allclose(r["tp2_merge"]["merged"],
                                   r["tp2_merge"]["adapted"],
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(r["tp2_merge"]["merged"],
                                   want["tp2"]["logits_merged"],
                                   rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(r["tp2_merge"]["adapted"],
                                   want["tp2"]["logits_adapted"],
                                   rtol=1e-3, atol=1e-3)


def test_merge_lora_scan_layers_stacked(devices8):
    """The port's ``merge_lora`` on JAX's stacked ``[L, ...]`` tree
    (``scan_layers``) equals JAX's merge leaf for leaf: the port has no
    scanned layers (each layer is its own module), so this is its only
    stacked input."""
    initialize_model_parallel(tensor_parallel_size=2, devices=devices8)
    base = dict(sequence_parallel=False, remat="none", num_layers=4,
                dtype=jnp.float32, param_dtype=jnp.float32)
    cfg = JaxLlamaConfig.tiny(lora_rank=4, lora_targets=("mlp", "qkv"),
                              scan_layers=True, **base)
    config = nxd.training_config(tensor_parallel_size=2,
                                 compute_dtype="float32")
    model = jax_init_model(config, lambda: JaxLlama(cfg),
                           (jnp.zeros((1, 16), jnp.int32),))
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: x + 0.01 if "lora_b" in jax.tree_util.keystr(p) else x,
        _np(model.params))
    want = _flat(jax_peft.merge_lora(params, alpha=cfg.lora_alpha))
    got = _flat(peft.merge_lora(params, alpha=cfg.lora_alpha))
    assert set(got) == set(want) and not any("lora_" in n for n in got)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=1e-6, atol=1e-6,
                                   err_msg=n)
    destroy_model_parallel()


def test_strip_lora_recovers_base(lora):
    """Adapters moved off zero, then stripped: the base model's logits,
    bit for bit."""
    _, _, ranks = lora
    for r in ranks:
        np.testing.assert_array_equal(r["zero"]["stripped"],
                                      r["zero"]["base"])


def test_frozen_grads_do_not_shape_clip_norm(lora):
    """The first step's grad norm is the adapters' norm (JAX's oracle over
    the full gradient tree), which the frozen base's gradients would
    exceed by over 20 %."""
    _, want, ranks = lora
    w = want["tp2"]
    assert w["full_norm"] > w["adapter_norm"] * 1.2
    for r in ranks:
        assert r["tp2"]["norms"][0] == pytest.approx(w["adapter_norm"],
                                                     rel=1e-4)


def test_zero1_state_only_for_trainable(lora):
    """dp = 2 under ZeRO-1: the steps match JAX's at dp = 2, and each
    rank's AdamW state covers the adapters' slices only."""
    _, want, ranks = lora
    lora_names = None
    for r in ranks:
        got = r["dp2"]
        assert got["zero1"] and got["dp"][0] == 2
        np.testing.assert_allclose(
            np.stack([got["losses"], got["norms"]], 1),
            want["dp2"]["metrics"], **STEP_TOL)
        lora_names = sorted(n for n in got["params"] if "lora_" in n)
        assert sorted(got["state"]) == lora_names
        full = sum(p.size for p in got["params"].values())
        state = sum(v.size for st in got["state"].values()
                    for v in st.values())
        assert 0 < state < 0.2 * 2 * full
        for n, p in got["params"].items():
            if "lora_" not in n:
                np.testing.assert_array_equal(
                    p, _flat(want["dp2"]["params0"])[n], err_msg=n)


def test_fsdp_with_trainable_matches_jax(lora):
    """dp = 2 under FSDP with the base frozen: JAX's dp = 2 steps, state
    only for the adapters' pieces, the base pieces unchanged."""
    _, want, ranks = lora
    for r in ranks:
        got = r["dp2_fsdp"]
        assert got["dp"][0] == 2 and not got["zero1"]
        np.testing.assert_allclose(
            np.stack([got["losses"], got["norms"]], 1),
            want["dp2"]["metrics"], **STEP_TOL)
        assert sorted(got["state"]) == sorted(
            n for n in got["params"] if "lora_" in n)
        cut = _flat(fsdp_shard_for_rank(want["dp2"]["params0"], 2,
                                        got["dp"][1]))
        for n, p in got["params"].items():
            if "lora_" not in n:
                np.testing.assert_array_equal(p, cut[n], err_msg=n)


def test_kv_replicated_adapters_match_jax(lora):
    """tp = 2 with kvr = 2: the v adapter's B factor is replicated over
    the kvr ranks, each seeing its own q heads' share of the gradient; the
    steps and every parameter match JAX's."""
    _, want, ranks = lora
    for r in ranks:
        got = r["kvr2"]
        assert got["tp"][0] == 2
        np.testing.assert_allclose(
            np.stack([got["losses"], got["norms"]], 1),
            want["kvr2"]["metrics"], **STEP_TOL)
        cut = _flat(shard_params_for_rank(want["kvr2"]["params"], 2,
                                          got["tp"][1], kvr=2))
        assert set(cut) == set(got["params"])
        for n, p in got["params"].items():
            np.testing.assert_allclose(p, cut[n], rtol=0, atol=1e-4,
                                       err_msg=n)
