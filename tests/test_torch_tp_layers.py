"""PyTorch port: the tensor-parallel layers at tp = 2 against the JAX
package's.

The layers of JAX ``tests/test_layers.py`` and ``tests/test_qkv.py`` (a
gathered column layer with bias, the fused gate-up column layer, a row
layer with bias, the vocab-sharded embedding and its tied head, the GQA
QKV projection with biases) and the whole tiny Llama run at tp = 2: the
JAX modules over params placed on two virtual CPU devices by their
partition specs, the port's in a spawned 2-rank gloo world over each
rank's cut of the same numpy weights.  Outputs agree within 1e-5 (fp32),
the sharded ones joined over the ranks.  Also: the port's random init is
tp-invariant (a tp = 2 model from seed s is the tp = 1 model from seed
s, sliced), ``shard_params_for_rank`` round-trips to the full tree, the
head-count refusals, and serving's refusal of kvr > 1 (ROADMAP A9c; the
layers take it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from jax.sharding import NamedSharding

from neuronx_distributed_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig,
    LlamaForCausalLM as JaxLlama,
)
from neuronx_distributed_tpu.parallel.layers import (
    ColumnParallelLinear as JaxColumn,
    ParallelEmbedding as JaxEmbedding,
    RowParallelLinear as JaxRow,
)
from neuronx_distributed_tpu.parallel.mesh import (
    destroy_model_parallel,
    get_mesh,
    initialize_model_parallel,
)
from neuronx_distributed_tpu.parallel.qkv import GQAQKVColumnParallelLinear as JaxQKV
from neuronx_distributed_tpu_torch.convert import shard_dim, shard_params_for_rank
from neuronx_distributed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from neuronx_distributed_tpu_torch.utils.distributed import spawn
import torch_tp_workers as workers

TOL = dict(rtol=1e-5, atol=1e-5)


def _run(layer, x, overrides=None):
    """``layer`` initialised, its leaves replaced by ``overrides`` (numpy),
    placed on the tp = 2 mesh by its partition specs and applied to ``x``
    under jit; returns (numpy params, numpy output)."""
    boxed = layer.init(jax.random.PRNGKey(1), x)
    specs = nn.get_partition_spec(boxed)
    raw = jax.tree.map(np.asarray, nn.unbox(boxed))
    for k, v in (overrides or {}).items():
        raw["params"][k] = v
    placed = jax.tree.map(
        lambda a, s: jax.device_put(a, NamedSharding(get_mesh(), s)), raw,
        specs, is_leaf=lambda a: not isinstance(a, dict))
    y = jax.jit(layer.apply)(placed, x)
    return raw["params"], jax.tree.map(np.asarray, y)


@pytest.fixture(scope="module")
def results():
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    destroy_model_parallel()
    initialize_model_parallel(tensor_parallel_size=2,
                              devices=jax.devices()[:2])
    rs = np.random.RandomState(0)
    x16 = rs.standard_normal((2, 8, 16)).astype(np.float32)
    x32 = rs.standard_normal((2, 8, 32)).astype(np.float32)
    ids = rs.randint(0, 64, (2, 8)).astype(np.int32)
    inp, want = {"x16": x16, "x32": x32, "ids": ids}, {}

    def bias(*shape):
        return rs.standard_normal(shape).astype(np.float32)

    p, want["column"] = _run(JaxColumn(features=32, gather_output=True,
                                       dtype=jnp.float32), x16,
                             {"bias": bias(32)})
    inp.update(col_kernel=p["kernel"], col_bias=p["bias"])
    p, want["fused"] = _run(JaxColumn(features=64, n_fused=2, use_bias=False,
                                      dtype=jnp.float32), x16)
    inp["fused_kernel"] = p["kernel"]
    p, want["row"] = _run(JaxRow(features=16, input_is_parallel=False,
                                 dtype=jnp.float32), x32, {"bias": bias(16)})
    inp.update(row_kernel=p["kernel"], row_bias=p["bias"])
    emb = JaxEmbedding(num_embeddings=64, features=16, dtype=jnp.float32)
    p, want["embed"] = _run(emb, ids)
    inp["embedding"] = p["embedding"]
    want["attend"] = np.asarray(emb.apply(
        {"params": {"embedding": jnp.asarray(p["embedding"])}}, x16,
        method=emb.attend))
    p, want["qkv"] = _run(JaxQKV(num_heads=8, num_kv_heads=2, head_dim=4,
                                 use_bias=True, dtype=jnp.float32), x16,
                          {"q_bias": bias(8, 4), "k_bias": bias(2, 4),
                           "v_bias": bias(2, 4)})
    inp.update({f"{n}_{w}": p[f"{n}_{w}"] for n in "qkv"
                for w in ("kernel", "bias")})
    jcfg = JaxLlamaConfig.tiny(num_kv_heads=2, dtype=jnp.float32,
                               param_dtype=jnp.float32,
                               sequence_parallel=False, remat="none")
    llama_ids = rs.randint(1, 256, (2, 8)).astype(np.int32)
    p, want["llama"] = _run(JaxLlama(jcfg), llama_ids)
    inp.update(llama=p, llama_ids=llama_ids)
    destroy_model_parallel()
    return inp, want, spawn(workers.layer_cases, 2, (inp,), timeout_s=120)


# how the ranks' outputs join: the dim of the shards, None when each rank
# holds the whole output
JOIN = {"column": None, "fused": -1, "row": None, "embed": None,
        "attend": -1, "llama": None}


@pytest.mark.parametrize("case", sorted(JOIN))
def test_layer_matches_jax_at_tp2(results, case):
    _, want, ranks = results
    dim = JOIN[case]
    if dim is None:
        for r in ranks:
            np.testing.assert_allclose(r[case], want[case], **TOL)
    else:
        got = np.concatenate([r[case] for r in ranks], axis=dim)
        np.testing.assert_allclose(got, want[case], **TOL)


def test_gqa_projection_matches_jax_at_tp2(results):
    """Local q/k/v heads: rank r holds q heads [4r, 4r + 4) and kv head r,
    the q heads of its kv head."""
    _, want, ranks = results
    for i, w in enumerate(want["qkv"]):
        got = np.concatenate([r["qkv"][i] for r in ranks], axis=-2)
        np.testing.assert_allclose(got, w, **TOL)
    assert ranks[0]["qkv"][0].shape[-2] == 4
    assert ranks[0]["qkv"][1].shape[-2] == 1


def test_llama_head_gives_local_vocab(results):
    _, want, ranks = results
    got = np.concatenate([r["llama_local"] for r in ranks], axis=-1)
    np.testing.assert_allclose(got, want["llama"], **TOL)
    assert ranks[0]["llama_local"].shape[-1] == 128


def test_random_init_is_tp_invariant(results):
    _, _, ranks = results
    cfg = LlamaConfig.tiny(num_kv_heads=2, dtype=torch.float32)
    full = LlamaForCausalLM(cfg, device="cpu").init_random(5).state_dict()
    for r, out in enumerate(ranks):
        assert set(out["init"]) == set(full)
        for name, value in full.items():
            want = value.numpy()
            dim = shard_dim(name)
            if dim is not None:
                want = np.split(want, 2, axis=dim)[r]
            np.testing.assert_array_equal(out["init"][name], want, name)


def test_model_built_at_tp1_stays_tp1_under_a_live_tp2_group(results):
    """A model and a gathering column layer built before the tp = 2
    state exists keep degree 1 after it is initialized: full-vocab logits
    as before, no gather to 2 V, no collective forward or backward."""
    inp, _, ranks = results
    x = inp["x16"]
    for out in ranks:
        b = out["built_at_tp1"]
        assert b["tp"] == (1, 1)
        assert b["collectives"] == {}
        np.testing.assert_array_equal(b["after"], b["before"])
        assert b["gathered_shape"] == b["before"].shape
        assert b["gathered_shape"][-1] == 256
        assert b["column_shape"] == (*x.shape[:-1], 32)
        # d(sum y)/dx = the kernel's row sums, not reduced over the ranks
        want = np.broadcast_to(b["column_kernel"].sum(1), x.shape)
        np.testing.assert_allclose(b["x_grad"], want, **TOL)


def test_shard_params_round_trip(results):
    inp, _, _ = results
    tree = inp["llama"]
    shards = [shard_params_for_rank(tree, 2, r) for r in range(2)]

    def check(full, parts, prefix):
        for key, val in full.items():
            path = f"{prefix}{key}"
            if isinstance(val, dict):
                check(val, [p[key] for p in parts], path + ".")
                continue
            dim = shard_dim(path)
            if dim is None:
                for p in parts:
                    np.testing.assert_array_equal(p[key], val)
            else:
                assert parts[0][key].shape[dim] * 2 == val.shape[dim]
                np.testing.assert_array_equal(
                    np.concatenate([p[key] for p in parts], axis=dim), val)

    check(tree, shards, "")
    assert shard_dim("model.layer_0.input_norm.weight") is None
    with pytest.raises(ValueError, match="does not split"):
        shard_params_for_rank({"lm_head": {"kernel": np.zeros((4, 3))}}, 2, 0)


def test_refusals(results):
    _, _, ranks = results
    errors = ranks[0]["errors"]
    assert "num_kv_heads=1 not divisible by tp=2" in errors["kv_heads"]
    assert "num_heads=5 not divisible by TP degree 2" in errors["q_heads"]
    assert "vocabulary of 63" in errors["vocab"]
    assert "A9c" in errors["kvr"]
    # at kvr = 2 (tp = 2) a rank holds 4 of 8 q heads and both kv heads
    assert ranks[0]["kvr_heads"] == (4, 2)


def test_paged_attention_at_local_heads():
    """B4 at one tp = 2 rank of Llama-3-8B (16 q on 4 kv heads): the route
    is tp = 1's (G = 4 is unchanged), the decode split is chosen for the 4
    local kv heads, and the cost a launch declares is the local one (half
    the K/V bytes and half the operations of the 32 / 8 call)."""
    from neuronx_distributed_tpu_torch.ops.paged_attention import (
        decode_split_k,
        paged_attention_cost,
        paged_route,
    )

    B, D, page, pp, sms = 8, 128, 16, 64, 132
    assert paged_route(torch.bfloat16, 1, 16 // 4) == paged_route(
        torch.bfloat16, 1, 32 // 8) == "decode"
    assert paged_route(torch.bfloat16, 128, 16 // 4) == "wgmma"
    T = pp * page
    assert decode_split_k(B, 4, T, sms) == min(
        8, max(2 * sms // (B * 4), 1))
    assert decode_split_k(B, 4, T, sms) >= decode_split_k(B, 8, T, sms)
    table = torch.arange(1, B * pp + 1, dtype=torch.int32).reshape(B, pp)
    off = torch.full((B,), 500, dtype=torch.int32)
    costs = {}
    for nq, nkv in ((32, 8), (16, 4)):
        q = torch.zeros(B, 1, nq, D, dtype=torch.bfloat16)
        pool = tuple(torch.zeros(B * pp + 1, page, nkv, D,
                                 dtype=torch.bfloat16) for _ in range(2))
        costs[nkv] = paged_attention_cost(q, pool, table, off)
    assert costs[4][0] * 2 == costs[8][0]
    kv_bytes = 2 * B * 501 * D * 2  # K and V of the 501 keys a slot sees
    assert costs[8][1] - costs[4][1] == kv_bytes * 4 + 2 * B * 16 * D * 2
