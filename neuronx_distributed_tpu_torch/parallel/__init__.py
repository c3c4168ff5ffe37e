"""Parallel state, collectives and layers of the PyTorch port: the
six-axis rank layout and its process groups (:mod:`.mesh`), the
conjugate-pair collectives (:mod:`.mappings`) and the tensor-parallel
layers."""

from neuronx_distributed_tpu_torch.parallel.layers import (
    ColumnParallelLinear,
    ParallelEmbedding,
    RowParallelLinear,
)
from neuronx_distributed_tpu_torch.parallel.mesh import (
    TensorParallel,
    destroy_model_parallel,
    initialize_model_parallel,
    model_parallel_is_initialized,
)
from neuronx_distributed_tpu_torch.parallel.norm import RMSNorm
from neuronx_distributed_tpu_torch.parallel.qkv import GQAQKVColumnParallelLinear

__all__ = [
    "ColumnParallelLinear",
    "GQAQKVColumnParallelLinear",
    "ParallelEmbedding",
    "RMSNorm",
    "RowParallelLinear",
    "TensorParallel",
    "destroy_model_parallel",
    "initialize_model_parallel",
    "model_parallel_is_initialized",
]
