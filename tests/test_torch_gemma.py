"""PyTorch port: Gemma and Gemma-2 against the JAX package.

JAX ``GemmaForCausalLM`` and ``Gemma2ForCausalLM`` (tiny, fp32,
``sequence_parallel=False``, ``remat="none"``) initialise the weights;
``convert.gemma_params_from_jax`` / ``gemma2_params_from_jax`` move them
into the port.  Seeded numpy ids then go through both forwards: logits
agree to 2e-5 absolute (fp32 on both sides; XLA and PyTorch sum the
matmuls in other orders), at the tiny head_dim 16 and at head_dim 256, the
Gemma width the flash kernels were extended to.  Within the port: the
flash core (its CPU plain versions, under the autograd function the card
uses) equals the dense core in logits and in every gradient (1e-5
relative L2, fp32), with one sliding and one global Gemma-2 layer and a
window that bites; the tied head; the final softcap; the chunked loss head;
and the converter's refusals.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from neuronx_distributed_tpu.models.gemma import (
    Gemma2Config as JaxGemma2Config,
    Gemma2ForCausalLM as JaxGemma2,
    GemmaConfig as JaxGemmaConfig,
    GemmaForCausalLM as JaxGemma,
)
from neuronx_distributed_tpu_torch.convert import (
    gemma2_params_from_jax,
    gemma_params_from_jax,
)
from neuronx_distributed_tpu_torch.models.common import (
    causal_lm_loss,
    make_causal_lm_loss_sum,
)
from neuronx_distributed_tpu_torch.models.gemma import (
    Gemma2Config,
    Gemma2ForCausalLM,
    GemmaConfig,
    GemmaForCausalLM,
)
from neuronx_distributed_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
    LlamaMLP,
)

ATOL = 2e-5
B, S = 2, 40  # S > the tiny window (16), so Gemma-2's sliding layer bites

# family -> (JAX config, JAX model, port config, port model, converter)
FAMILIES = {
    "gemma": (JaxGemmaConfig, JaxGemma, GemmaConfig, GemmaForCausalLM,
              gemma_params_from_jax),
    "gemma2": (JaxGemma2Config, JaxGemma2, Gemma2Config, Gemma2ForCausalLM,
               gemma2_params_from_jax),
}

_CACHE: dict = {}


def build(family, head_dim=16, **port_kw):
    """``(jax module, jax params as numpy, port model)`` over the same
    weights; the port model is fp32 with fp32 masters."""
    key = (family, head_dim)
    jcfg_cls, jcls, pcfg_cls, pcls, convert = FAMILIES[family]
    if key not in _CACHE:
        jcfg = jcfg_cls.tiny(head_dim=head_dim, dtype=jnp.float32,
                             param_dtype=jnp.float32,
                             sequence_parallel=False, remat="none")
        module = jcls(jcfg)
        params = nn.unbox(module.init(jax.random.PRNGKey(head_dim),
                                      jnp.zeros((B, S), jnp.int32)))
        _CACHE[key] = (module, jax.tree.map(np.asarray, params))
    module, params = _CACHE[key]
    cfg = pcfg_cls.tiny(head_dim=head_dim, dtype=torch.float32,
                        param_dtype=torch.float32, remat="none", **port_kw)
    model = pcls(cfg, device="cpu")
    model.load_state_dict(convert(params, cfg))
    return module, params, model


def ids_batch(vocab, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, size=(B, S))


@pytest.mark.parametrize("head_dim", [16, 256])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_logits_match_jax(family, head_dim):
    module, params, model = build(family, head_dim)
    ids = ids_batch(model.config.vocab_size)
    ref = np.asarray(module.apply(params, jnp.asarray(ids)))
    out = model(torch.from_numpy(ids)).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("head_dim", [16, 256])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_flash_core_equals_dense_core(family, head_dim):
    """Logits and every gradient, fp32, 1e-5 relative L2.  Gemma-2's layer
    0 slides over a 16-token window at S = 40 (the window changes its
    output) and layer 1 is global."""
    _, params, _ = build(family, head_dim)
    ids = torch.from_numpy(ids_batch(256, seed=1))
    batch = {"ids": ids, "labels": torch.roll(ids, -1, 1)}
    runs = {}
    for impl in ("flash", "dense"):
        _, _, model = build(family, head_dim, attention_impl=impl)
        logits = model(ids)
        causal_lm_loss(model, batch).backward()
        runs[impl] = [logits.detach()] + [p.grad for p in model.parameters()]
    for a, b in zip(runs["flash"], runs["dense"]):
        assert ((a - b).norm() / b.norm()).item() <= 1e-5
    if family == "gemma2":
        _, _, model = build(family, head_dim)
        layer0 = model.layer_0.attn.config
        assert layer0.sliding_window == 16 < S
        assert model.layer_1.attn.config.sliding_window is None
        wide = Gemma2Config.tiny(head_dim=head_dim, dtype=torch.float32,
                                 param_dtype=torch.float32, remat="none",
                                 sliding_window=S)
        unwindowed = Gemma2ForCausalLM(wide, device="cpu")
        unwindowed.load_state_dict(model.state_dict())
        moved = (unwindowed(ids) - model(ids)).abs().max().item()
        assert moved > 1e-2, "the window does not change the output"


@pytest.mark.parametrize("family", list(FAMILIES))
def test_tied_head_moves_with_the_embedding(family):
    _, _, model = build(family)
    ids = torch.from_numpy(ids_batch(256, seed=2))
    r = 77
    assert not (ids == r).any()  # row r enters only through the head
    before = model(ids).detach()
    with torch.no_grad():
        model.embed.embedding[r] += 0.5
    after = model(ids).detach()
    moved = (after - before).abs().amax(dim=(0, 1))
    assert moved[r] > 1e-3
    assert torch.all(torch.cat([moved[:r], moved[r + 1:]]) == 0)
    assert not any("lm_head" in n for n, _ in model.named_parameters())


def test_final_softcap_bounds_the_logits():
    _, _, model = build("gemma2")
    ids = torch.from_numpy(ids_batch(256, seed=3))
    with torch.no_grad():
        model.embed.embedding.mul_(40.0)
    capped = model(ids).detach()
    raw = model.embed.attend(model.hidden(ids)).detach()
    assert raw.abs().max() > 60.0  # the cap has something to bound
    assert capped.abs().max() <= 30.0
    torch.testing.assert_close(capped, 30.0 * torch.tanh(raw / 30.0))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_chunked_loss_head_equals_mean_loss(family):
    """``hidden()`` and ``head()`` (with the final softcap) through the
    chunked loss give the mean next-token loss of the full forward."""
    _, _, model = build(family)
    ids = torch.from_numpy(ids_batch(256, seed=4))
    labels = torch.roll(ids, -1, 1)
    labels[0, :5] = -100
    batch = {"ids": ids, "labels": labels}
    mean = causal_lm_loss(model, batch)
    total, tok = make_causal_lm_loss_sum(8)(model, batch)
    torch.testing.assert_close(total / tok, mean, rtol=1e-6, atol=0)


def test_converter_refusals():
    _, params, _ = build("gemma2")
    cfg = Gemma2Config.tiny()
    tree = {k: dict(v) for k, v in params["params"].items()}
    extra = dict(tree, lm_head={"kernel": np.zeros((64, 256), np.float32)})
    with pytest.raises(ValueError, match="unexpected.*lm_head"):
        gemma2_params_from_jax(extra, cfg)
    missing = dict(tree)
    missing["layer_1"] = {k: v for k, v in tree["layer_1"].items()
                          if k != "post_ffw_norm"}
    with pytest.raises(ValueError, match="missing.*post_ffw_norm"):
        gemma2_params_from_jax(missing, cfg)
    with pytest.raises(ValueError, match="shape"):
        gemma2_params_from_jax(tree, dataclasses.replace(cfg,
                                                         num_kv_heads=4))
    # a Gemma-2 tree is not a Gemma-1 tree (the sandwich norms are extra)
    with pytest.raises(ValueError, match="pre_ffw_norm"):
        gemma_params_from_jax(tree, GemmaConfig.tiny())


def test_config_checks():
    cfg = Gemma2Config.gemma2_2b()
    assert (cfg.num_layers, cfg.hidden_size, cfg.head_dim_) == (26, 2304, 256)
    assert cfg.block_config(True).sliding_window == 4096
    assert cfg.block_config(False).sliding_window is None
    assert cfg.block_config(False).attn_scale == 256.0 ** -0.5
    assert cfg.block_config(True).mlp_activation == "gelu_tanh"
    assert GemmaConfig.gemma_2b().num_kv_heads == 1
    assert Gemma2Config.gemma2_27b().block_config(True).attn_scale == \
        144.0 ** -0.5
    with pytest.raises(ValueError, match="mlp_activation"):
        LlamaConfig.tiny(mlp_activation="relu")
    with pytest.raises(ValueError, match="remat"):
        Gemma2Config.tiny(remat="bogus")
    with pytest.raises(ValueError, match="attention_impl"):
        GemmaConfig.tiny(attention_impl="bogus")


def test_gelu_tanh_mlp_matches_jax():
    """``mlp_activation="gelu_tanh"`` is JAX ``gelu(approximate=True)`` on
    the gate; ``"silu"`` (the default) is unchanged."""
    from neuronx_distributed_tpu.models.llama import (
        LlamaConfig as JaxLlamaConfig,
        LlamaMLP as JaxLlamaMLP,
    )

    x = np.random.RandomState(5).standard_normal((2, 7, 64)).astype(np.float32)
    for act in ("gelu_tanh", "silu"):
        jcfg = JaxLlamaConfig.tiny(mlp_activation=act, dtype=jnp.float32,
                                   param_dtype=jnp.float32,
                                   sequence_parallel=False)
        jmlp = JaxLlamaMLP(jcfg)
        params = nn.unbox(jmlp.init(jax.random.PRNGKey(0), jnp.asarray(x)))
        ref = np.asarray(jmlp.apply(params, jnp.asarray(x)))
        cfg = LlamaConfig.tiny(mlp_activation=act, dtype=torch.float32)
        mlp = LlamaMLP(cfg, device="cpu")
        mlp.load_state_dict({
            f"{m}.kernel": torch.from_numpy(np.array(params["params"][m][
                "kernel"])) for m in ("gate_up", "down")})
        out = mlp(torch.from_numpy(x)).detach().numpy()
        np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    assert LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32),
                            device="cpu").model.layer_0.mlp.act is \
        torch.nn.functional.silu
