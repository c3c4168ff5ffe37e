"""PyTorch port: the training layers past one rank against the JAX
package's.

One spawned 2-rank gloo world (``torch_tp_workers.layer_training_cases``)
runs, against the JAX modules on virtual CPU devices over the same numpy
weights (fp32, 1e-5 unless stated):

- sequence parallelism at tp = 2: the column -> row MLP with biases (JAX
  ``tests/test_layers.py:82``: output, input and weight gradients; the row
  bias's gradient summed over tp by
  ``allreduce_sequence_parallel_gradients``) and the embedding's
  sequence-sharded output and its table gradient;
- the vocab-parallel cross entropy at tp = 2 (JAX
  ``vocab_parallel_cross_entropy``, ``tests/test_loss.py:44``): values and
  logit gradients at smoothing 0 and 0.1, ignore labels, and the
  extreme-logit case (``:100``);
- the QKV projection at tp = 2 with kvr = 2 (``tests/test_qkv.py:28, :62,
  :100``): q/k/v, the grouped attention, and the K/V kernel gradients
  summed over the kvr group (one replica alone holds only its q heads'
  share);
- the global grad norm at tp = 2, kvr = 2 over sharded, kv-replicated and
  sequence-parallel gradients against JAX ``get_grad_norm`` over the full
  arrays (1e-6 relative), and clipping;
- ZeRO-1 at dp = 2 (``tests/test_grads_zero1.py:62``): the sharded-state
  step equal to the replicated one, both equal to JAX's AdamW, each rank's
  moments 1/dp of the eligible leaves and equal to JAX's ``mu``/``nu``
  slices.

In this process: ``zero1_spec``'s dim choice against JAX's
(``tests/test_grads_zero1.py:47``), and head padding (``pad_llama_params``
leaf for leaf against JAX's, the padded model's logits equal to the
unpadded ones).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn
from jax.sharding import PartitionSpec as P

from conftest import sharded_params
from neuronx_distributed_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig,
    LlamaForCausalLM as JaxLlama,
)
from neuronx_distributed_tpu.optimizer.adamw_fp32 import adamw_fp32 as jax_adamw
from neuronx_distributed_tpu.optimizer.zero1 import (
    fsdp_spec as jax_fsdp_spec,
    zero1_spec as jax_zero1_spec,
)
from neuronx_distributed_tpu.parallel.grads import get_grad_norm as jax_norm
from neuronx_distributed_tpu.parallel.layers import (
    ColumnParallelLinear as JaxColumn,
    ParallelEmbedding as JaxEmbedding,
    RowParallelLinear as JaxRow,
)
from neuronx_distributed_tpu.parallel.loss import (
    vocab_parallel_cross_entropy as jax_vp_ce,
)
from neuronx_distributed_tpu.parallel.mesh import (
    TENSOR_AXES,
    destroy_model_parallel,
    get_mesh,
    initialize_model_parallel,
)
from neuronx_distributed_tpu.parallel.pad import pad_llama_params as jax_pad
from neuronx_distributed_tpu.parallel.qkv import GQAQKVColumnParallelLinear as JaxQKV
from neuronx_distributed_tpu.utils.common import shard_map as jax_shard_map
from neuronx_distributed_tpu_torch.convert import (
    llama_params_from_jax,
    shard_params_for_rank,
    zero1_shard_for_rank,
)
from neuronx_distributed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from neuronx_distributed_tpu_torch.optimizer.zero1 import (
    fsdp_spec,
    zero1_dim,
    zero1_spec,
)
from neuronx_distributed_tpu_torch.parallel.pad import pad_axis_to, pad_llama_params
from neuronx_distributed_tpu_torch.utils.distributed import spawn
import torch_tp_workers as workers

TOL = dict(rtol=1e-5, atol=1e-5)
B, S, H, I = 2, 16, 16, 64


def _tree(x):
    return jax.tree.map(np.asarray, x)


def _sp_mlp(rs):
    """JAX ``tests/test_layers.py:82``'s block with biases: value and the
    gradients of ``sum(y * ct)``."""

    class TPMLP(nn.Module):
        @nn.compact
        def __call__(self, x):
            h = JaxColumn(features=I, sequence_parallel=True,
                          dtype=jnp.float32)(x)
            return JaxRow(features=H, sequence_parallel=True,
                          dtype=jnp.float32)(nn.gelu(h))

    x = rs.standard_normal((B, S, H)).astype(np.float32)
    ct = rs.standard_normal((B, S, H)).astype(np.float32)
    model = TPMLP()
    boxed = model.init(jax.random.PRNGKey(1), x)
    raw = _tree(nn.unbox(boxed))["params"]
    raw["ColumnParallelLinear_0"]["bias"] = rs.standard_normal(I).astype(
        np.float32)
    raw["RowParallelLinear_0"]["bias"] = rs.standard_normal(H).astype(
        np.float32)
    p = {"params": jax.tree.map(jnp.asarray, raw)}
    p = jax.tree.map(lambda a, b: jax.device_put(a, b.sharding), p,
                     sharded_params(boxed))

    def loss(p, x):
        return jnp.sum(model.apply(p, x) * ct)

    y = np.asarray(jax.jit(model.apply)(p, x))
    g, gx = jax.grad(loss, argnums=(0, 1))(p, x)
    g = _tree(g)["params"]
    col, row = raw["ColumnParallelLinear_0"], raw["RowParallelLinear_0"]
    inp = dict(sp_x=x, sp_ct=ct, w1=col["kernel"], b1=col["bias"],
               w2=row["kernel"], b2=row["bias"])
    want = dict(y=y, x=np.asarray(gx), w1=g["ColumnParallelLinear_0"]["kernel"],
                b1=g["ColumnParallelLinear_0"]["bias"],
                w2=g["RowParallelLinear_0"]["kernel"],
                b2=g["RowParallelLinear_0"]["bias"])
    return inp, want


def _sp_embed(rs):
    ids = rs.randint(0, 64, (B, S)).astype(np.int32)
    ct = rs.standard_normal((B, S, H)).astype(np.float32)
    emb = JaxEmbedding(num_embeddings=64, features=H,
                       sequence_parallel_output=True, dtype=jnp.float32)
    boxed = emb.init(jax.random.PRNGKey(2), ids)
    p = sharded_params(boxed)
    y = np.asarray(jax.jit(emb.apply)(p, ids))
    g = jax.grad(lambda p: jnp.sum(emb.apply(p, ids) * ct))(p)
    return (dict(table=np.asarray(nn.unbox(boxed)["params"]["embedding"]),
                 emb_ids=ids, emb_ct=ct),
            dict(y=y, table=np.asarray(g["params"]["embedding"])))


def _ce(rs):
    """JAX's shard_map vocab-parallel cross entropy at tp = 2."""
    logits = (rs.standard_normal((2, 4, 64)) * 3).astype(np.float32)
    targets = rs.randint(-2, 64, (2, 4)).astype(np.int32)  # with ignores
    ct = rs.standard_normal((2, 4)).astype(np.float32)
    want = {}
    for smoothing in (0.0, 0.1):
        def prog(lg, tg, c, sm=smoothing):
            def f(lg):
                per = jax_vp_ce(lg, tg, sm)
                return jnp.sum(per * c), per
            (_, per), g = jax.value_and_grad(f, has_aux=True)(lg)
            return per, g

        f = jax_shard_map(prog, mesh=get_mesh(),
                          in_specs=(P(None, None, TENSOR_AXES), P(), P()),
                          out_specs=(P(), P(None, None, TENSOR_AXES)),
                          check_vma=False)
        per, g = f(logits, targets, ct)
        want[f"ce_{smoothing}"] = dict(loss=np.asarray(per),
                                       grad=np.asarray(g))
    huge = jax_shard_map(
        lambda lg, tg: jax_vp_ce(lg, tg), mesh=get_mesh(),
        in_specs=(P(None, TENSOR_AXES), P()), out_specs=P(),
        check_vma=False)(jnp.full((2, 64), 1e4, jnp.float32),
                         jnp.array([3, 9]))
    want["ce_extreme"] = np.asarray(huge)
    return dict(ce_logits=logits, ce_targets=targets, ce_ct=ct), want


def _kvr(rs):
    """JAX ``tests/test_qkv.py`` at tp = 2, kvr = 2: 8 q heads on 2 kv
    heads, the grouped attention and its gradients."""
    Bq, Sq, Hq, D, NQ, NKV = 2, 8, 16, 4, 8, 2
    G = NQ // NKV
    x = rs.standard_normal((Bq, Sq, Hq)).astype(np.float32)
    ct = rs.standard_normal((Bq, Sq, NQ, D)).astype(np.float32)
    layer = JaxQKV(num_heads=NQ, num_kv_heads=NKV, head_dim=D,
                   dtype=jnp.float32)
    boxed = layer.init(jax.random.PRNGKey(1), x)
    p = sharded_params(boxed)

    def attn(p, x):
        q, k, v = layer.apply(p, x)
        qg = q.reshape(Bq, Sq, NKV, G, D)
        scores = jnp.einsum("bskgd,btkd->bkgst", qg, k) / np.sqrt(D)
        out = jnp.einsum("bkgst,btkd->bskgd", jax.nn.softmax(scores, -1), v)
        return out.reshape(Bq, Sq, NQ, D), (q, k, v)

    out, qkv = jax.jit(attn)(p, x)
    g, gx = jax.grad(lambda p, x: jnp.sum(attn(p, x)[0] * ct),
                     argnums=(0, 1))(p, x)
    raw = _tree(nn.unbox(boxed))["params"]
    g = _tree(g)["params"]
    inp = dict(kv_x=x, kv_ct=ct, q_kernel=raw["q_kernel"],
               k_kernel=raw["k_kernel"], v_kernel=raw["v_kernel"])
    want = dict(attn=np.asarray(out), q=np.asarray(qkv[0]),
                k=np.asarray(qkv[1]), v=np.asarray(qkv[2]),
                q_grad=g["q_kernel"], k_grad=g["k_kernel"],
                v_grad=g["v_kernel"], x_grad=np.asarray(gx))
    return inp, want


def _grad_tree(rs):
    """A full gradient tree of the tiny GQA Llama's shapes (random)."""
    jcfg = JaxLlamaConfig.tiny(num_kv_heads=2, dtype=jnp.float32,
                               param_dtype=jnp.float32)
    shapes = jax.eval_shape(JaxLlama(jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))
    tree = jax.tree.map(lambda s: rs.standard_normal(s.shape).astype(
        np.float32), nn.unbox(shapes))
    return tree


def _zero1(rs, steps=2):
    """JAX ``tests/test_grads_zero1.py:62``'s MLP and AdamW (replicated
    state; the JAX test holds ZeRO-1 equal to it): params and moments after
    ``steps`` updates."""

    class MLP(nn.Module):
        @nn.compact
        def __call__(self, x):
            h = JaxColumn(features=64, use_bias=False, dtype=jnp.float32)(x)
            return JaxRow(features=16, use_bias=False,
                          dtype=jnp.float32)(nn.gelu(h))

    x = rs.standard_normal((8, 4, 16)).astype(np.float32)
    y = rs.standard_normal((8, 4, 16)).astype(np.float32)
    model = MLP()
    params = _tree(nn.unbox(model.init(jax.random.PRNGKey(2), x)))
    tx = jax_adamw(1e-2)
    state = tx.init(params)

    @jax.jit
    def step(p, s):
        loss, g = jax.value_and_grad(
            lambda p: jnp.mean((model.apply(p, x) - y) ** 2))(p)
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s, loss

    p, s, losses = params, state, []
    for _ in range(steps):
        p, s, loss = step(p, s)
        losses.append(float(loss))
    w1 = params["params"]["ColumnParallelLinear_0"]["kernel"]
    w2 = params["params"]["RowParallelLinear_0"]["kernel"]
    names = {"col.kernel": "ColumnParallelLinear_0",
             "row.kernel": "RowParallelLinear_0"}
    final = _tree(p)["params"]
    mu, nu = _tree(s[0].mu)["params"], _tree(s[0].nu)["params"]
    want = dict(losses=losses,
                params={n: final[j]["kernel"] for n, j in names.items()},
                mu={n: mu[j]["kernel"] for n, j in names.items()},
                nu={n: nu[j]["kernel"] for n, j in names.items()})
    return dict(z_x=x, z_y=y, z_w1=w1, z_w2=w2, z_steps=steps), want


@pytest.fixture(scope="module")
def results():
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    rs = np.random.RandomState(0)
    inp, want = {}, {}
    destroy_model_parallel()
    initialize_model_parallel(tensor_parallel_size=2,
                              devices=jax.devices()[:2])
    for make, key in ((_sp_mlp, "sp_mlp"), (_sp_embed, "sp_embed")):
        i, w = make(rs)
        inp.update(i)
        want[key] = w
    i, w = _ce(rs)
    inp.update(i)
    want.update(w)
    destroy_model_parallel()
    initialize_model_parallel(tensor_parallel_size=2, kv_size_multiplier=2,
                              devices=jax.devices()[:2])
    i, w = _kvr(rs)
    inp.update(i)
    want["kvr"] = w
    destroy_model_parallel()
    initialize_model_parallel(tensor_parallel_size=1,
                              devices=jax.devices()[:1])
    tree = _grad_tree(rs)
    inp.update(grad_tree=tree, max_norm=1.0)
    want["norm"] = float(jax_norm(tree))
    i, w = _zero1(rs)
    inp.update(i)
    want["zero1"] = w
    destroy_model_parallel()
    return inp, want, spawn(workers.layer_training_cases, 2, (inp,),
                            timeout_s=150)


def _seq(ranks, case, key, dim=1):
    return np.concatenate([r[case][key] for r in ranks], axis=dim)


@pytest.mark.parametrize("key", ["y", "x"])
def test_sp_mlp_activations_match_jax(results, key):
    """Output and input gradient: each rank holds its half of the
    sequence."""
    _, want, ranks = results
    np.testing.assert_allclose(_seq(ranks, "sp_mlp", key),
                               want["sp_mlp"][key], **TOL)


@pytest.mark.parametrize("key,dim", [("w1", 1), ("b1", 0), ("w2", 0),
                                     ("b2", None)])
def test_sp_mlp_weight_gradients_match_jax(results, key, dim):
    """Sharded weights' gradients joined over the ranks; the replicated row
    bias equal on both ranks after the sequence-parallel sum (its rank's
    own gradient covers only its half of the sequence)."""
    _, want, ranks = results
    if dim is None:
        for r in ranks:
            np.testing.assert_allclose(r["sp_mlp"][key], want["sp_mlp"][key],
                                       **TOL)
        own = sum(r["sp_mlp"]["b2_own_shard"] for r in ranks)
        np.testing.assert_allclose(own, want["sp_mlp"][key], **TOL)
        assert not np.allclose(ranks[0]["sp_mlp"]["b2_own_shard"],
                               want["sp_mlp"][key], atol=1e-3)
    else:
        np.testing.assert_allclose(_seq(ranks, "sp_mlp", key, dim),
                                   want["sp_mlp"][key], **TOL)


def test_sp_parameters_are_marked(results):
    _, _, ranks = results
    for r in ranks:
        assert r["sp_mlp"]["marked"] == [False, False, False, True]
        assert r["sp_mlp"]["layouts"] == ["sharded", "sharded", "sharded",
                                          None]


def test_sp_embedding_matches_jax(results):
    _, want, ranks = results
    np.testing.assert_allclose(_seq(ranks, "sp_embed", "y"),
                               want["sp_embed"]["y"], **TOL)
    np.testing.assert_allclose(_seq(ranks, "sp_embed", "table", 0),
                               want["sp_embed"]["table"], **TOL)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_vocab_parallel_cross_entropy_matches_jax(results, smoothing):
    _, want, ranks = results
    key = f"ce_{smoothing}"
    for r in ranks:
        np.testing.assert_allclose(r[key]["loss"], want[key]["loss"], **TOL)
    np.testing.assert_allclose(_seq(ranks, key, "grad", -1),
                               want[key]["grad"], **TOL)


def test_vocab_parallel_cross_entropy_extreme_logits(results):
    _, want, ranks = results
    for r in ranks:
        assert np.all(np.isfinite(r["ce_extreme"]))
        np.testing.assert_allclose(r["ce_extreme"], want["ce_extreme"],
                                   **TOL)
        np.testing.assert_allclose(r["ce_extreme"], np.log(64), rtol=1e-4)


@pytest.mark.parametrize("key", ["q", "k", "v", "attn"])
def test_kvr_projection_and_grouped_attention_match_jax(results, key):
    """At tp = 2, kvr = 2 rank r holds q-head block r (of 2) and both kv
    heads (replicated along kvr); its 4 q heads read kv head r only, so
    its projection gives that one (``kv_heads``)."""
    _, want, ranks = results
    assert [r["kvr"]["q_block"] for r in ranks] == [0, 1]
    assert [r["kvr"]["kv_heads"] for r in ranks] == [(0, 1), (1, 1)]
    np.testing.assert_allclose(_seq(ranks, "kvr", key, 2), want["kvr"][key],
                               **TOL)


@pytest.mark.parametrize("key", ["q_grad", "k_grad", "v_grad", "x_grad"])
def test_kvr_gradient_correction_matches_jax(results, key):
    """The K/V kernels' gradients summed over the kvr group equal the
    dense ones (``tests/test_qkv.py:62``); a replica's own share does
    not."""
    _, want, ranks = results
    if key == "q_grad":
        np.testing.assert_allclose(_seq(ranks, "kvr", key, 1),
                                   want["kvr"][key], **TOL)
        return
    for r in ranks:
        np.testing.assert_allclose(r["kvr"][key], want["kvr"][key], **TOL)
    if key == "k_grad":
        assert not np.allclose(ranks[0]["kvr"]["k_own"], want["kvr"][key],
                               atol=1e-3)
        assert ranks[0]["kvr"]["layouts"] == ["sharded", "kv_replicated",
                                              "kv_replicated"]


def test_global_grad_norm_matches_jax(results):
    """The norm over the ranks' shards equals JAX's norm of the full tree
    (1e-6 relative) on every rank, whatever each parameter's layout; the
    local norm of one rank's tensors does not; clipping brings it to the
    bound."""
    inp, want, ranks = results
    for r in ranks:
        c = r["clip"]
        np.testing.assert_allclose(c["norm"], want["norm"], rtol=1e-6)
        np.testing.assert_allclose(c["pre"], want["norm"], rtol=1e-6)
        np.testing.assert_allclose(c["post"], inp["max_norm"], rtol=1e-5)
        assert abs(c["local"] - want["norm"]) > 1e-3 * want["norm"]
        assert c["kinds"] == ["NoneTrue", "kv_replicatedFalse",
                              "shardedFalse"]


def test_zero1_step_equals_replicated_and_jax(results):
    """ZeRO-1 at dp = 2: the sharded-state steps give the replicated steps'
    parameters to the bit, both JAX's AdamW within 1e-5."""
    _, want, ranks = results
    w = want["zero1"]
    for r in ranks:
        z, rep = r["zero1"][True], r["zero1"][False]
        assert z["zero1"] and not rep["zero1"]
        assert r["dp"][0] == 2
        for n, v in z["params"].items():
            np.testing.assert_array_equal(v, rep["params"][n])
            np.testing.assert_allclose(v, w["params"][n], rtol=1e-5,
                                       atol=1e-6)
        np.testing.assert_allclose(z["losses"], w["losses"], rtol=1e-5)
        np.testing.assert_array_equal(z["losses"], rep["losses"])


@pytest.mark.parametrize("moment,jax_key", [("exp_avg", "mu"),
                                            ("exp_avg_sq", "nu")])
def test_zero1_state_is_this_ranks_slice(results, moment, jax_key):
    """Each rank's moments cover 1/dp of each eligible leaf and equal
    JAX's ``mu``/``nu`` cut for that rank; the replicated step's cover the
    whole leaf."""
    _, want, ranks = results
    for r in ranks:
        dp_rank = r["dp"][1]
        z, rep = r["zero1"][True]["state"], r["zero1"][False]["state"]
        for n, full in want["zero1"][jax_key].items():
            mine = zero1_shard_for_rank({n: full}, 2, dp_rank)[n]
            assert z[n][moment].size * 2 == full.size
            np.testing.assert_allclose(z[n][moment], mine, rtol=1e-5,
                                       atol=1e-9)
            np.testing.assert_allclose(rep[n][moment], full, rtol=1e-5,
                                       atol=1e-9)


def test_psum_over_data_parallel(results):
    """The data-parallel mean of a gradient list over dp = 2."""
    _, _, ranks = results
    for r in ranks:
        np.testing.assert_array_equal(r["psum"][0], np.full(3, 1.5))
        np.testing.assert_array_equal(r["psum"][1], np.ones((2, 2)))


# -- in this process ----------------------------------------------------------

SPEC_CASES = [
    # (spec, shape): JAX tests/test_grads_zero1.py:47 at tp = 2, dp = 4
    ((None, ("kvr", "tp")), (16, 32)),
    ((("kvr", "tp"), None), (16, 32)),
    ((None,), (3,)),
    ((None, None), (6, 8)),
    ((("kvr", "tp"), None, None), (8, 2, 12)),
    ((None, None), (7, 5)),
]


@pytest.mark.parametrize("spec,shape", SPEC_CASES)
def test_zero1_spec_matches_jax(devices8, spec, shape):
    """The dim choice of the ZeRO-1 (first eligible) and FSDP (largest
    eligible) placements, over the spec as a tuple of entries; and the
    local-shard rule the optimizer uses picks the same dim."""
    initialize_model_parallel(tensor_parallel_size=2, devices=devices8)
    sizes = dict(get_mesh().shape)
    try:
        for port, jx in ((zero1_spec, jax_zero1_spec),
                         (fsdp_spec, jax_fsdp_spec)):
            want = tuple(jx(P(*spec), shape, get_mesh()))
            got = port(spec, shape, sizes)
            norm = lambda s: tuple(  # noqa: E731
                None if e in (None, ()) else (e,) if isinstance(e, str)
                else tuple(e) for e in s)
            assert norm(got) == norm(want), (port.__name__, got, want)
        # the local rule: tp cuts the sharded dim first
        local = [n // (2 if e else 1) for n, e in zip(
            shape, list(spec) + [None] * (len(shape) - len(spec)))]
        z = zero1_spec(spec, shape, sizes)
        dims = [i for i, e in enumerate(z) if e and "dp" in e]
        assert zero1_dim(local, 4) == (dims[0] if dims else None)
    finally:
        destroy_model_parallel()


def test_pad_axis_to():
    x = torch.arange(6.0).reshape(2, 3)
    y = pad_axis_to(x, 1, 5)
    assert y.shape == (2, 5) and torch.equal(y[:, :3], x)
    assert torch.count_nonzero(y[:, 3:]) == 0
    assert pad_axis_to(x, 0, 2) is x
    with pytest.raises(ValueError, match="down to"):
        pad_axis_to(x, 1, 2)


@pytest.mark.parametrize("heads", [(6, 3, 8, 4), (6, 6, 8, 8)])
def test_pad_llama_params_matches_jax_and_keeps_logits(heads):
    """GQA 6/3 -> 8/4 and MHA 6 -> 8: every leaf equals JAX's padded leaf,
    and the padded model's logits equal the unpadded model's."""
    old, old_kv, new, new_kv = heads
    D = 8
    jcfg = JaxLlamaConfig.tiny(hidden_size=48, num_heads=old,
                               num_kv_heads=old_kv, head_dim=D,
                               dtype=jnp.float32, param_dtype=jnp.float32,
                               sequence_parallel=False, remat="none")
    initialize_model_parallel(tensor_parallel_size=1,
                              devices=jax.devices()[:1])
    try:
        tree = _tree(nn.unbox(JaxLlama(jcfg).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))))
        padded_tree = _tree(jax_pad(tree, old, new, D, old_kv, new_kv))
    finally:
        destroy_model_parallel()
    cfg = LlamaConfig.tiny(hidden_size=48, num_heads=old, num_kv_heads=old_kv,
                           head_dim=D, dtype=torch.float32,
                           param_dtype=torch.float32)
    pcfg = LlamaConfig.tiny(hidden_size=48, num_heads=new,
                            num_kv_heads=new_kv, head_dim=D,
                            dtype=torch.float32, param_dtype=torch.float32)
    sd = llama_params_from_jax(tree, cfg)
    got = pad_llama_params(sd, old, new, D, old_kv, new_kv)
    want = llama_params_from_jax(padded_tree, pcfg)
    assert set(got) == set(want)
    for n in want:
        torch.testing.assert_close(got[n], want[n], rtol=0, atol=0)
    ids = torch.from_numpy(np.random.RandomState(1).randint(0, 256, (2, 8)))
    base, pad = (LlamaForCausalLM(c, device="cpu") for c in (cfg, pcfg))
    base.load_state_dict(sd)
    pad.load_state_dict(got)
    with torch.no_grad():
        torch.testing.assert_close(pad(ids), base(ids), rtol=1e-6, atol=1e-6)
    bad_kv = new // 2 if new_kv == new else new   # another group size
    with pytest.raises(ValueError, match="group size"):
        pad_llama_params(sd, old, new, D, old_kv, bad_kv)


def test_shard_params_for_rank_at_kvr():
    """kvr = 2 at tp = 4: rank (kvr = o, tp = i) holds q block i * 2 + o of
    4 and kv block i of 2, and the same o_proj rows as its q heads."""
    rs = np.random.RandomState(3)
    tree = {"model": {"layer_0": {"attn": {
        "qkv": {"q_kernel": rs.standard_normal((4, 8, 2)),
                "k_kernel": rs.standard_normal((4, 4, 2)),
                "v_kernel": rs.standard_normal((4, 4, 2))},
        "o_proj": {"kernel": rs.standard_normal((16, 4))}}}}}
    for rank in range(4):
        o, i = rank // 2, rank % 2
        part = shard_params_for_rank(tree, 4, rank, kvr=2)
        a = part["model"]["layer_0"]["attn"]
        full = tree["model"]["layer_0"]["attn"]
        qb = i * 2 + o
        np.testing.assert_array_equal(a["qkv"]["q_kernel"],
                                      full["qkv"]["q_kernel"][:, 2 * qb:2 * qb + 2])
        np.testing.assert_array_equal(a["qkv"]["k_kernel"],
                                      full["qkv"]["k_kernel"][:, 2 * i:2 * i + 2])
        np.testing.assert_array_equal(a["o_proj"]["kernel"],
                                      full["o_proj"]["kernel"][4 * qb:4 * qb + 4])
