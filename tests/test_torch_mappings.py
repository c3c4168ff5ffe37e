"""PyTorch port: the conjugate-pair collectives against the JAX package.

JAX ``tests/test_mappings.py``'s five programs run at tp = 2: the JAX
``custom_vjp`` mappings inside ``shard_map`` on two virtual CPU devices,
and the port's ``autograd.Function`` mappings in a spawned 2-rank gloo
world, on the same numpy inputs.  Each rank's loss and every gradient
(the sharded ones joined over the ranks) agree within 1e-6 (fp32), and
the port's gloo gather and reduce-scatter are the JAX results exactly
where the inputs are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from neuronx_distributed_tpu.parallel import mappings as jmp
from neuronx_distributed_tpu.parallel.mesh import (
    TENSOR_AXES,
    destroy_model_parallel,
    initialize_model_parallel,
)
from neuronx_distributed_tpu.utils.common import shard_map
from neuronx_distributed_tpu_torch.utils.distributed import spawn
import torch_tp_workers as workers

T = TENSOR_AXES
TOL = dict(rtol=1e-6, atol=1e-6)


def _inputs():
    rs = np.random.RandomState(0)

    def n(*shape, scale=1.0):
        return (rs.standard_normal(shape) * scale).astype(np.float32)

    return {"x": n(4, 16), "w1": n(16, 32, scale=0.25),
            "w2": n(32, 16, scale=0.25), "ct": n(4, 16),
            "g_x": n(4, 32), "g_c": n(4, 32),
            "sp_x": n(16, 8), "sp_w": n(8, 16, scale=1 / 3),
            "sp_ct": n(16, 16), "ss_x": n(16, 8), "ss_c": n(16, 8),
            "rs_parts": n(2, 16, 8), "rs_c": n(16, 8)}


def _jax_results(inp):
    destroy_model_parallel()
    mesh = initialize_model_parallel(tensor_parallel_size=2,
                                     devices=jax.devices()[:2])

    def sm(f, in_specs, out_specs):
        return shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)

    j = {k: jnp.asarray(v) for k, v in inp.items()}
    out = {}

    def mlp(x, w1, w2, ct):
        def loss(x, w1, w2):
            y = (jmp.copy_to_tensor_parallel_region(x) @ w1) @ w2
            return jnp.sum(jmp.reduce_from_tensor_parallel_region(y) * ct)
        return jax.value_and_grad(loss, argnums=(0, 1, 2))(x, w1, w2)

    l, g = sm(mlp, (P(), P(None, T), P(T, None), P()),
              (P(), (P(), P(None, T), P(T, None))))(
        j["x"], j["w1"], j["w2"], j["ct"])
    out["mlp"] = (l, *g)

    def gather(x, c):
        return jax.value_and_grad(
            lambda x: jnp.sum(jmp.gather_from_tensor_parallel_region(x) * c))(x)

    out["gather"] = sm(gather, (P(None, T), P()), (P(), P(None, T)))(
        j["g_x"], j["g_c"])

    def scatter(x, c):
        return jax.value_and_grad(lambda x: jmp.reduce_from_tensor_parallel_region(
            jnp.sum(jmp.scatter_to_tensor_parallel_region(x) * c)))(x)

    out["scatter"] = sm(scatter, (P(), P(None, T)), (P(), P()))(
        j["g_x"], j["g_c"])

    def sp_gather(x, w, ct):
        def loss(x, w):
            full = jmp.gather_from_sequence_parallel_region(x, 0, True)
            return jmp.reduce_from_tensor_parallel_region(
                jnp.sum((full @ w) * ct))
        return jax.value_and_grad(loss, argnums=(0, 1))(x, w)

    l, g = sm(sp_gather, (P(T, None), P(None, T), P(None, T)),
              (P(), (P(T, None), P(None, T))))(j["sp_x"], j["sp_w"],
                                               j["sp_ct"])
    out["sp_gather"] = (l, *g)

    def sp_scatter(x, c):
        return jax.value_and_grad(lambda x: jmp.reduce_from_tensor_parallel_region(
            jnp.sum(jmp.scatter_to_sequence_parallel_region(x, 0) * c)))(x)

    out["sp_scatter"] = sm(sp_scatter, (P(), P(T, None)), (P(), P()))(
        j["ss_x"], j["ss_c"])

    def rs(y, c):
        y = y[0]

        def loss(y):
            o = jmp.reduce_scatter_to_sequence_parallel_region(y, 0)
            return jmp.reduce_from_tensor_parallel_region(jnp.sum(o * c)), o

        (l, o), g = jax.value_and_grad(loss, has_aux=True)(y)
        return l, o, g

    out["reduce_scatter"] = sm(rs, (P(T, None, None), P(T, None)),
                               (P(), P(T, None), P()))(j["rs_parts"],
                                                       j["rs_c"])
    destroy_model_parallel()
    return {k: tuple(np.asarray(a) for a in v) for k, v in out.items()}


# how each returned value is laid out over the ranks: None replicated
# (every rank holds the whole value), else the dim the ranks' shards join on
LAYOUT = {"mlp": (None, None, 1, 0), "gather": (None, 1),
          "scatter": (None, None), "sp_gather": (None, 0, 1),
          "sp_scatter": (None, None), "reduce_scatter": (None, 0, None)}


@pytest.fixture(scope="module")
def results():
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    inp = _inputs()
    return _jax_results(inp), spawn(workers.mappings_cases, 2, (inp,),
                                    timeout_s=120)


@pytest.mark.parametrize("case", sorted(LAYOUT))
def test_mapping_forward_and_backward_match_jax(results, case):
    want, ranks = results
    for i, dim in enumerate(LAYOUT[case]):
        if dim is None:
            for r in ranks:
                np.testing.assert_allclose(np.asarray(r[case][i]),
                                           want[case][i], **TOL)
        else:
            got = np.concatenate([r[case][i] for r in ranks], axis=dim)
            np.testing.assert_allclose(got, want[case][i], **TOL)


def test_collective_counts(results):
    """Forward and backward collectives, counted by kind on each rank: the
    gather's and the reduce-scatter's conjugates included."""
    _, ranks = results
    for r in ranks:
        c = r["counts"]
        # the two gathers' forwards and the three scatters' backwards
        assert c["all_gather"] == 5
        # the sequence gather's backward, the reduce-scatter's forward
        assert c["reduce_scatter"] == 2
        # the copy's backward and the five reduce_from forwards
        assert c["all_reduce"] == 6
