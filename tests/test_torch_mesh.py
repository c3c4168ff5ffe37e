"""PyTorch port: the parallel state against the JAX mesh.

The port lays the world's ranks out as the JAX package lays out its
devices off the TPU (``np.arange(n).reshape(dp, ep, pp, cp, kvr, tp //
kvr)``) and builds one process group per line of every axis.  For each
configuration of JAX ``tests/test_mesh.py`` the port's pure layout and
its groups along every axis (and along the combined tensor and batch
axes) equal the JAX mesh's device ids; the sizes, the refusals, double
initialization and destroy / re-init behave as JAX's do.  One 4-rank gloo
world all-reduces over every group it builds, and the spawn helper kills
a world whose rank fails or that outlives its limit.
"""

import jax
import numpy as np
import pytest

from neuronx_distributed_tpu.parallel import mesh as jax_mesh
from neuronx_distributed_tpu_torch.config import MeshConfig, training_config
from neuronx_distributed_tpu_torch.parallel import mesh
from neuronx_distributed_tpu_torch.utils import common
from neuronx_distributed_tpu_torch.utils.distributed import spawn
import torch_tp_workers as workers

# (world size, initialize_model_parallel keywords): JAX test_mesh.py's
# configurations, plus the tp = 2 serving world and a 4-rank mixed one
CONFIGS = [
    (8, {}),
    (8, dict(tensor_parallel_size=4)),
    (8, dict(tensor_parallel_size=2, pipeline_parallel_size=2)),
    (8, dict(tensor_parallel_size=8, kv_size_multiplier=2)),
    (8, dict(expert_parallel_size=2, data_parallel_size=8)),
    (8, dict(tensor_parallel_size=2, context_parallel_size=2)),
    (2, dict(tensor_parallel_size=2)),
    (4, dict(tensor_parallel_size=2, pipeline_parallel_size=2)),
]
AXES = mesh.GROUP_AXES


def _jax_ids(world, kw):
    jax_mesh.destroy_model_parallel()
    m = jax_mesh.initialize_model_parallel(devices=jax.devices()[:world],
                                           **kw)
    ids = np.vectorize(lambda d: d.id)(m.devices)
    sizes = dict(tp=jax_mesh.get_tensor_parallel_size(),
                 dp=jax_mesh.get_data_parallel_size(),
                 pp=jax_mesh.get_pipeline_parallel_size(),
                 kvr=jax_mesh.get_kv_size_multiplier(),
                 cp=jax_mesh.get_context_parallel_size(),
                 ep=jax_mesh.get_expert_parallel_size())
    jax_mesh.destroy_model_parallel()
    return ids, m.axis_names, sizes


def _jax_lines(ids, axis_names, axes):
    axes = (axes,) if isinstance(axes, str) else axes
    idx = [axis_names.index(a) for a in axes]
    rest = [i for i in range(ids.ndim) if i not in idx]
    n = int(np.prod([ids.shape[i] for i in idx]))
    return np.transpose(ids, rest + idx).reshape(-1, n).tolist()


@pytest.mark.parametrize("world,kw", CONFIGS,
                         ids=[f"{w}-{sorted(k.items())}" for w, k in CONFIGS])
def test_layout_and_groups_equal_the_jax_mesh(world, kw):
    if len(jax.devices()) < world:
        pytest.skip(f"needs {world} virtual devices")
    ids, names, sizes = _jax_ids(world, kw)
    assert tuple(names) == mesh.MESH_AXES
    layout = mesh.rank_layout(world, **kw)
    np.testing.assert_array_equal(layout, ids)
    for axes in AXES:
        assert mesh.axis_lines(layout, axes) == _jax_lines(ids, names, axes)
    cfg = mesh.resolve_config(world, **kw)
    ep = cfg.expert_parallel_size
    assert (cfg.tensor_parallel_size, cfg.data_parallel_size,
            cfg.pipeline_parallel_size, cfg.kv_size_multiplier,
            cfg.context_parallel_size, ep) == (
        sizes["tp"], sizes["dp"], sizes["pp"], sizes["kvr"], sizes["cp"],
        sizes["ep"])


def test_tp_contiguity():
    """Tensor-parallel ranks are adjacent (JAX: device ids 0-3 on one tp
    line), so a tp group is one host's neighbouring ranks."""
    layout = mesh.rank_layout(8, tensor_parallel_size=4)
    assert list(layout[0, 0, 0, 0].flatten()) == [0, 1, 2, 3]
    assert mesh.axis_lines(layout, mesh.TENSOR_AXES) == [[0, 1, 2, 3],
                                                         [4, 5, 6, 7]]


@pytest.mark.parametrize("kw", [dict(tensor_parallel_size=3),
                                dict(tensor_parallel_size=4,
                                     kv_size_multiplier=3),
                                dict(expert_parallel_size=2,
                                     data_parallel_size=4)])
def test_invalid_sizes_raise_like_jax(kw):
    with pytest.raises(ValueError):
        jax_mesh.initialize_model_parallel(devices=jax.devices()[:8], **kw)
    jax_mesh.destroy_model_parallel()
    with pytest.raises(ValueError):
        mesh.rank_layout(8, **kw)


def test_double_init_destroy_and_reinit():
    """One process is a world of one: init, double init refused, a failed
    init leaves no state, destroy, re-init."""
    assert not mesh.model_parallel_is_initialized()
    assert mesh.TensorParallel.current().size == 1
    with pytest.raises(ValueError):
        mesh.initialize_model_parallel(tensor_parallel_size=2)
    assert not mesh.model_parallel_is_initialized()
    try:
        cfg = mesh.initialize_model_parallel()
        assert cfg.data_parallel_size == 1
        assert mesh.get_tensor_parallel_size() == 1
        assert mesh.get_tensor_parallel_group() is None
        with pytest.raises(RuntimeError, match="already initialized"):
            mesh.initialize_model_parallel()
    finally:
        mesh.destroy_model_parallel()
    assert not mesh.model_parallel_is_initialized()
    with pytest.raises(RuntimeError, match="initialize_model_parallel"):
        mesh.get_mesh_config()
    mesh.initialize_model_parallel()
    mesh.destroy_model_parallel()


def test_mesh_config_and_training_config():
    cfg = MeshConfig(tensor_parallel_size=8, pipeline_parallel_size=4,
                     context_parallel_size=2)
    assert cfg.model_parallel_size == 64
    tc = training_config(mesh=MeshConfig(tensor_parallel_size=2),
                         policy="full", schedule="gpipe")
    assert tc.mesh.tensor_parallel_size == 2
    with pytest.raises(TypeError):
        training_config(mesh=MeshConfig(), tensor_parallel_size=2)
    with pytest.raises(ValueError):
        MeshConfig(tensor_parallel_size=4, kv_size_multiplier=3)


def test_common_helpers():
    assert common.divide(12, 4) == 3
    with pytest.raises(ValueError, match="not divisible"):
        common.divide(10, 4)
    assert common.pad_to_multiple(10, 4) == 12
    assert common.pad_to_multiple(12, 4) == 12


def test_four_rank_world_reduces_over_every_group():
    """A 4-rank gloo world at tp = 2, pp = 2: each rank's groups are the
    JAX mesh's lines through it, a sum over each group adds exactly its
    ranks, the tp gloo twin and the host helpers work."""
    kw = dict(tensor_parallel_size=2, pipeline_parallel_size=2)
    outs = spawn(workers.mesh_world, 4, (kw,), timeout_s=120)
    ids, names, _ = _jax_ids(4, kw)
    for out in outs:
        r = out["rank"]
        for axes in AXES:
            key = axes if isinstance(axes, str) else "+".join(axes)
            line = [ln for ln in _jax_lines(ids, names, axes) if r in ln]
            assert out["groups"][key] == line[0], (r, key)
            assert out["sums"][key] == sum(x + 1 for x in line[0])
        assert out["sizes"] == {"tp": 2, "tp_rank": r % 2, "dp": 1,
                                "pp": 2, "kvr": 1}
        assert out["tp_cpu_sum"] == sum(out["groups"]["kvr+tp"])
        assert out["host0"] == {"from": 0}
        assert out["primary"] == (r == 0)


def test_spawn_kills_the_world_when_a_rank_fails():
    with pytest.raises(RuntimeError, match="planned failure"):
        spawn(workers.raise_on_rank, 2, (1,), timeout_s=60)


def test_spawn_enforces_its_wall_clock_limit():
    with pytest.raises(TimeoutError, match="every worker killed"):
        spawn(workers.sleep_forever, 2, timeout_s=3)
