"""PyTorch port: GPT-NeoX and the dense attention core against the JAX
package.

JAX ``GPTNeoXForCausalLM`` (tiny, fp32, ``sequence_parallel=False``)
initialises the weights; ``convert.gpt_neox_params_from_jax`` moves them
into the port.  Seeded numpy ids go through both forwards.  Tolerances,
all fp32 on both sides (XLA and PyTorch sum in other orders): logits 2e-5
absolute; losses 1e-5 relative and gradient norms 1e-4 relative (JAX's
own remat test); the chunked head against the unchunked one 1e-6 in the
loss and 2e-5 / 1e-7 in every gradient (JAX's); ``dense_mha`` and the
partial RoPE 1e-6 absolute; the tp = 2 world's gathered logits 5e-4
(JAX's dense-vs-tp8 tolerance).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from neuronx_distributed_tpu.models.common import (
    causal_lm_loss as jax_causal_lm_loss,
    dense_mha as jax_dense_mha,
)
from neuronx_distributed_tpu.models.gpt_neox import (
    GPTNeoXConfig as JaxConfig,
    GPTNeoXForCausalLM as JaxNeoX,
    apply_partial_rope as jax_partial_rope,
)
from neuronx_distributed_tpu_torch.config import training_config
from neuronx_distributed_tpu_torch.convert import (
    gpt_neox_params_from_jax,
    shard_dim,
)
from neuronx_distributed_tpu_torch.models.common import (
    causal_lm_loss,
    causal_lm_loss_sum,
    dense_mha,
    make_causal_lm_loss_sum,
)
from neuronx_distributed_tpu_torch.models.gpt_neox import (
    GPTNeoXConfig,
    GPTNeoXForCausalLM,
    apply_partial_rope,
    build_pipelined_gpt_neox,
)
from neuronx_distributed_tpu_torch.trainer import (
    initialize_parallel_model,
    initialize_parallel_optimizer,
    make_train_step,
)
from neuronx_distributed_tpu_torch.utils.distributed import spawn
import torch_tp_workers as workers

B, S = 2, 16
ATOL = 2e-5
MODES = {"parallel": True, "serial": False}

_CACHE: dict = {}


def jax_side(parallel=True, remat="none"):
    """``(jax module, params as numpy)``: tiny fp32 NeoX, seed 1."""
    key = (parallel, remat)
    if key not in _CACHE:
        module = JaxNeoX(JaxConfig.tiny(
            use_parallel_residual=parallel, sequence_parallel=False,
            remat=remat, dtype=jnp.float32, param_dtype=jnp.float32))
        params = nn.unbox(module.init(jax.random.PRNGKey(1),
                                      jnp.zeros((B, S), jnp.int32)))
        _CACHE[key] = (module, jax.tree.map(np.asarray, params))
    return _CACHE[key]


def port_model(params, parallel=True, **kw):
    cfg = GPTNeoXConfig.tiny(use_parallel_residual=parallel,
                             dtype=torch.float32, **{"remat": "none", **kw})
    model = GPTNeoXForCausalLM(cfg, device="cpu")
    model.load_state_dict(gpt_neox_params_from_jax(params, cfg))
    return model


def ids_batch(seed=0, b=B, s=S):
    return np.random.RandomState(seed).randint(0, 256, size=(b, s))


def test_partial_rope_identity_portion():
    """Only the first rotary_pct of each head rotates; position 0 is the
    identity; the rotated part equals JAX's."""
    x = np.random.RandomState(0).standard_normal((1, 4, 2, 16)
                                                 ).astype(np.float32)
    pos = np.arange(4)[None]
    y = apply_partial_rope(torch.from_numpy(x), torch.from_numpy(pos), 0.25,
                           10000.0).numpy()
    np.testing.assert_array_equal(y[..., 4:], x[..., 4:])
    np.testing.assert_allclose(y[:, 0, :, :4], x[:, 0, :, :4], rtol=1e-6)
    assert not np.allclose(y[:, 1, :, :4], x[:, 1, :, :4])
    ref = np.asarray(jax_partial_rope(jnp.asarray(x), jnp.asarray(pos), 0.25,
                                      10000.0))
    np.testing.assert_allclose(y, ref, atol=1e-6, rtol=0)
    xt = torch.from_numpy(x)
    assert apply_partial_rope(xt, torch.from_numpy(pos), 0.0, 1e4) is xt


@pytest.mark.parametrize("case", ["causal", "causal_offset", "mask",
                                  "mask_and_causal"])
def test_dense_mha_matches_jax(case):
    rs = np.random.RandomState(3)
    Sq, T = (5, 7) if case == "causal_offset" else (6, 6)
    q = rs.standard_normal((2, Sq, 4, 8)).astype(np.float32)
    k, v = (rs.standard_normal((2, T, 4, 8)).astype(np.float32)
            for _ in range(2))
    mask = None
    if case.startswith("mask"):
        mask = rs.rand(2, 1, 1, T) > 0.3
        mask[..., 0] = True   # every query sees a key
    causal = case != "mask"
    out = dense_mha(*(torch.from_numpy(a) for a in (q, k, v)),
                    mask=None if mask is None else torch.from_numpy(mask),
                    causal=causal).numpy()
    ref = np.asarray(jax_dense_mha(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        mask=None if mask is None else jnp.asarray(mask), causal=causal))
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


def test_dense_mha_keeps_fp32_scores_under_bf16():
    """bf16 q and k are widened before the product: the output equals the
    fp32 core fed the same bf16 values, to bf16 output rounding."""
    rs = np.random.RandomState(4)
    q, k, v = (torch.from_numpy(rs.standard_normal((1, 8, 2, 96)) * 3
                                ).to(torch.bfloat16) for _ in range(3))
    out = dense_mha(q, k, v, causal=True)
    assert out.dtype == torch.bfloat16
    ref = dense_mha(q.float(), k.float(), v.float(), causal=True)
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=4e-2,
                               rtol=1e-2)


@pytest.mark.parametrize("mode", list(MODES))
def test_logits_match_jax(mode):
    module, params = jax_side(MODES[mode])
    model = port_model(params, MODES[mode])
    ids = ids_batch()
    ref = np.asarray(module.apply(params, jnp.asarray(ids)))
    out = model(torch.from_numpy(ids)).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def _loss_and_grad_norm_jax(module, params, ids):
    def loss(p):
        return jnp.mean(module.apply(p, ids).astype(jnp.float32) ** 2)
    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    norm = jnp.sqrt(sum(jnp.sum(g ** 2) for g in jax.tree.leaves(grads)))
    return float(value), float(norm)


@pytest.mark.parametrize("remat", ["selective", "full"])
def test_remat_matches_no_remat(remat):
    """The same loss and gradients with and without remat, and both equal
    to JAX's under the same remat."""
    ids = ids_batch(seed=5)
    module, params = jax_side(True, remat)
    jloss, jnorm = _loss_and_grad_norm_jax(module, params, jnp.asarray(ids))
    runs = {}
    for mode in ("none", remat):
        model = port_model(params, remat=mode)
        loss = model(torch.from_numpy(ids)).float().square().mean()
        loss.backward()
        runs[mode] = (loss.item(), [p.grad for p in model.parameters()])
    assert runs[remat][0] == pytest.approx(runs["none"][0], rel=1e-6)
    for x, y in zip(runs[remat][1], runs["none"][1]):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-7)
    norm = torch.sqrt(sum((g ** 2).sum() for g in runs[remat][1])).item()
    assert runs[remat][0] == pytest.approx(jloss, rel=1e-5)
    assert norm == pytest.approx(jnorm, rel=1e-4)


def test_chunked_loss_head_matches_unchunked():
    """hidden()/head(): make_causal_lm_loss_sum(8) equals the plain
    (sum, tok) path in loss and every gradient, and the loss equals
    JAX's causal_lm_loss."""
    module, params = jax_side()
    ids = ids_batch(seed=6, b=4)
    labels = np.roll(ids, -1, axis=1)
    labels[0, 9:] = -100
    batch = {"ids": torch.from_numpy(ids), "labels": torch.from_numpy(labels)}
    runs = {}
    for name, fn in (("plain", causal_lm_loss_sum),
                     ("chunked", make_causal_lm_loss_sum(chunk_size=8))):
        model = port_model(params)
        s, t = fn(model, batch)
        loss = s / t.clamp(min=1.0)
        loss.backward()
        runs[name] = (loss.item(), {n: p.grad for n, p in
                                    model.named_parameters()})
    assert runs["chunked"][0] == pytest.approx(runs["plain"][0], rel=1e-6)
    for n, g in runs["plain"][1].items():
        np.testing.assert_allclose(runs["chunked"][1][n].numpy(), g.numpy(),
                                   rtol=2e-5, atol=1e-7, err_msg=n)
    jloss = float(jax_causal_lm_loss(module, params, {
        "ids": jnp.asarray(ids), "labels": jnp.asarray(labels)}))
    assert runs["plain"][0] == pytest.approx(jloss, rel=1e-5)


def test_train_loss_decreases():
    """The trainer's entry points drive NeoX (fp32, remat selective): the
    first step's loss is JAX's loss on the same weights, and the loss falls
    by 10 % over six steps (JAX tests/test_models.py)."""
    module, params = jax_side()
    ids = ids_batch(seed=42, b=8)
    batch = {"ids": ids, "labels": np.roll(ids, -1, axis=1)}
    jloss = float(jax_causal_lm_loss(module, params, {
        k: jnp.asarray(v) for k, v in batch.items()}))
    cfg = GPTNeoXConfig.tiny(dtype=torch.float32, remat="selective")
    config = training_config(learning_rate=1e-3, compute_dtype="float32")
    model = initialize_parallel_model(
        config, lambda d: GPTNeoXForCausalLM(cfg, device=d), device="cpu")
    model.module.load_state_dict(gpt_neox_params_from_jax(params, cfg))
    step = make_train_step(config, model,
                           initialize_parallel_optimizer(config, model),
                           causal_lm_loss)
    losses = [step(batch)["loss"].item() for _ in range(6)]
    assert losses[0] == pytest.approx(jloss, rel=1e-5)
    assert losses[-1] < losses[0] * 0.9, losses


def test_tp2_forward_matches_tp1_and_jax():
    """Both residual modes in one 2-rank gloo world: heads, MLP columns
    and vocab rows cut by shard_params_for_rank; the gathered logits equal
    tp = 1 and JAX within 5e-4."""
    ids = ids_batch(seed=7)
    inp, want = {}, {}
    for mode, parallel in MODES.items():
        module, params = jax_side(parallel)
        inp[mode] = {"family": "neox", "tree": params, "ids": ids,
                     "config": {"use_parallel_residual": parallel}}
        want[mode] = (np.asarray(module.apply(params, jnp.asarray(ids))),
                      port_model(params, parallel)(torch.from_numpy(ids))
                      .detach().numpy())
    ranks = spawn(workers.neox_bert_forward, 2, (inp,), timeout_s=120)
    for mode, (ref, tp1) in want.items():
        for out in ranks:
            got = out[mode]
            assert got["local_vocab"] == 128
            np.testing.assert_allclose(got["logits"], ref, rtol=5e-4,
                                       atol=5e-4)
            np.testing.assert_allclose(got["logits"], tp1, rtol=5e-4,
                                       atol=5e-4)


def test_converter_names_and_refusals():
    _, params = jax_side()
    cfg = GPTNeoXConfig.tiny(dtype=torch.float32)
    sd = gpt_neox_params_from_jax(params, cfg)
    model = GPTNeoXForCausalLM(cfg, device="cpu")
    assert set(sd) == set(model.state_dict())
    assert shard_dim("layer_0.attn.qkv.kernel") == -1
    assert shard_dim("layer_0.attn.qkv.bias") == -1
    assert shard_dim("layer_0.attn.dense.kernel") == 0
    assert shard_dim("layer_0.attn.dense.bias") is None
    assert shard_dim("layer_0.mlp.dense_h_to_4h.bias") == -1
    assert shard_dim("layer_0.mlp.dense_4h_to_h.kernel") == 0
    assert shard_dim("layer_0.ln_1.weight") is None
    assert shard_dim("embed_in.embedding") == 0
    assert shard_dim("embed_out.kernel") == -1
    # the new suffixes capture none of Llama's names
    assert shard_dim("model.layer_0.attn.qkv.q_kernel") == 1
    assert shard_dim("model.layer_0.attn.qkv.q_bias") == 0
    assert shard_dim("model.layer_0.input_norm.weight") is None
    bad = jax.tree.map(lambda x: x, params)
    bad["params"]["embed_out"]["kernel"] = np.zeros((64, 128), np.float32)
    with pytest.raises(ValueError, match="embed_out.kernel: shape"):
        gpt_neox_params_from_jax(bad, cfg)
    with pytest.raises(ValueError, match="missing"):
        gpt_neox_params_from_jax(params, GPTNeoXConfig.tiny(num_layers=3))


def test_entry_points_default_to_cuda_and_pipelining_waits(monkeypatch):
    with pytest.raises(NotImplementedError, match="A15"):
        build_pipelined_gpt_neox(GPTNeoXConfig.tiny(), 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        GPTNeoXForCausalLM(GPTNeoXConfig.tiny())
    model = GPTNeoXForCausalLM(GPTNeoXConfig.tiny(), device="cpu")
    with pytest.raises(NotImplementedError, match="A15"):
        model.build_pipelined(2)
    with pytest.raises(ValueError, match="remat"):
        GPTNeoXConfig.tiny(remat="some")
    assert importlib.import_module(
        "neuronx_distributed_tpu_torch.models").GPTNeoXConfig is GPTNeoXConfig
