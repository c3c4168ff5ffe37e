"""PyTorch port: LoRA tree utilities (``peft.py``) against the JAX package.

The same numpy trees go through the port's and the JAX ``lora_params``,
``strip_lora`` and ``merge_lora``: a JAX tiny Llama built with LoRA on
every target (the GQA ``lora_a_q``/``lora_b_v`` names, fused MLP kernels,
the LM head), the stacked ``[L, ...]`` layout of ``scan_layers``, and
wrapper levels under a ``lora_*`` key.  The port's merged tree, moved into
a port model without adapters, gives the JAX LoRA model's logits; a merge
of torch tensors equals the numpy merge.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from neuronx_distributed_tpu import peft as jax_peft
from neuronx_distributed_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig,
    LlamaForCausalLM as JaxLlama,
)
from neuronx_distributed_tpu_torch import peft
from neuronx_distributed_tpu_torch.convert import llama_params_from_jax
from neuronx_distributed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

TARGETS = ("qkv", "o_proj", "mlp", "lm_head")
ALPHA = 16.0


def _lora_tree(scan_layers=False, targets=TARGETS, layers=2):
    """A JAX LoRA Llama's params as numpy, with every ``lora_b`` moved off
    zero so a merge is observable."""
    cfg = JaxLlamaConfig.tiny(lora_rank=4, lora_targets=targets,
                              lora_alpha=ALPHA, scan_layers=scan_layers,
                              num_layers=layers, num_kv_heads=2,
                              sequence_parallel=False, remat="none",
                              dtype=jnp.float32, param_dtype=jnp.float32)
    module = JaxLlama(cfg)
    params = nn.unbox(module.init(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 8), jnp.int32)))
    rs = np.random.RandomState(1)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: (np.asarray(x) + 0.05 * rs.randn(*x.shape).astype(
            np.float32)) if "lora_b" in jax.tree_util.keystr(p)
        else np.asarray(x), params)
    return cfg, module, params


def _leaves(tree, path=()):
    """``{path: leaf}`` of a tree of dicts (None leaves kept)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, path + (k,)))
        return out
    return {path: tree}


def _assert_same_tree(got, want, exact=True):
    g, w = _leaves(got), _leaves(want)
    assert sorted(g) == sorted(w)
    for k in g:
        if w[k] is None:
            assert g[k] is None, k
        elif exact:
            np.testing.assert_array_equal(np.asarray(g[k]), w[k], err_msg=str(k))
        else:
            np.testing.assert_allclose(np.asarray(g[k]), w[k], rtol=1e-5,
                                       atol=1e-6, err_msg=str(k))


@pytest.mark.parametrize("scan_layers", [False, True])
def test_lora_params_and_strip_lora_match_jax(scan_layers):
    _, _, params = _lora_tree(scan_layers)
    got = peft.lora_params(params)
    _assert_same_tree(got, jax_peft.lora_params(params))
    names = {k[-1] for k, v in _leaves(got).items() if v is not None}
    assert {"lora_a_q", "lora_b_q", "lora_a_v", "lora_b_v", "lora_a",
            "lora_b"} <= names
    stripped = peft.strip_lora(params)
    _assert_same_tree(stripped, jax_peft.strip_lora(params))
    assert not any("lora_" in "/".join(map(str, k))
                   for k in _leaves(stripped))


def test_lora_params_keeps_wrapped_leaves():
    tree = {"qkv": {"kernel": np.ones((2, 2)),
                    "lora_a": {"v": np.full((2, 1), 2.0)},
                    "lora_b": {"v": np.full((1, 2), 3.0)}},
            "stack": [np.zeros(2), {"lora_a_q": (np.ones(1),)}]}
    got = peft.lora_params(tree)
    assert got["qkv"]["kernel"] is None and got["stack"][0] is None
    np.testing.assert_array_equal(got["qkv"]["lora_a"]["v"], 2.0)
    np.testing.assert_array_equal(got["stack"][1]["lora_a_q"][0], 1.0)
    want = jax_peft.lora_params(tree)
    np.testing.assert_array_equal(want["qkv"]["lora_b"]["v"],
                                  got["qkv"]["lora_b"]["v"])
    assert peft.lora_trainable("layer_0/attn/qkv/lora_a_q")
    assert not peft.lora_trainable("layer_0/attn/qkv/q_kernel")


@pytest.mark.parametrize("scan_layers", [False, True])
def test_merge_lora_matches_jax(scan_layers):
    _, _, params = _lora_tree(scan_layers,
                              targets=("mlp",) if scan_layers else TARGETS,
                              layers=4 if scan_layers else 2)
    got = peft.merge_lora(params, alpha=ALPHA)
    want = jax_peft.merge_lora(params, alpha=ALPHA)
    _assert_same_tree(got, want, exact=False)
    # the merge moved every adapted kernel
    before = _leaves(peft.strip_lora(params))
    moved = [k for k, v in _leaves(got).items()
             if not np.array_equal(v, before[k])]
    assert moved and all(k[-1].endswith("kernel") for k in moved)


def test_merged_tree_serves_the_lora_models_logits():
    """The port's merge of the qkv LoRA, loaded into a port model without
    adapters, gives the JAX LoRA model's logits."""
    cfg, module, params = _lora_tree(targets=("qkv",))
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 8))
    want = np.asarray(module.apply(params, jnp.asarray(ids)))
    merged = peft.merge_lora(params, alpha=ALPHA)
    pcfg = LlamaConfig.tiny(num_kv_heads=2, dtype=torch.float32)
    model = LlamaForCausalLM(pcfg, device="cpu")
    model.load_state_dict(llama_params_from_jax(merged, pcfg))
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_merge_lora_on_tensors_equals_numpy(dtype):
    rs = np.random.RandomState(2)
    tree = {"qkv": {"q_kernel": rs.randn(8, 4, 2).astype(np.float32),
                    "v_kernel": rs.randn(8, 2, 2).astype(np.float32),
                    "lora_a_q": rs.randn(8, 3).astype(np.float32),
                    "lora_b_q": rs.randn(3, 4, 2).astype(np.float32),
                    "lora_a_v": rs.randn(8, 3).astype(np.float32),
                    "lora_b_v": rs.randn(3, 4).astype(np.float32)}}
    want = peft.merge_lora(tree, alpha=6.0)["qkv"]
    tensors = {"qkv": {k: torch.from_numpy(v).to(dtype)
                       for k, v in tree["qkv"].items()}}
    got = peft.merge_lora(tensors, alpha=6.0)["qkv"]
    assert sorted(got) == ["q_kernel", "v_kernel"]
    tol = 1e-6 if dtype == torch.float32 else 5e-2
    for k in got:
        assert got[k].dtype == dtype and got[k].shape == want[k].shape
        ref = peft.merge_lora(
            {"qkv": {n: v.float().numpy() for n, v in tensors["qkv"].items()}},
            alpha=6.0)["qkv"][k]
        np.testing.assert_allclose(got[k].float().numpy(), ref, rtol=tol,
                                   atol=tol)
