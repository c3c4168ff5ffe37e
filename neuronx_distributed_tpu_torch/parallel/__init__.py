"""Parallel state, collectives and layers of the PyTorch port: the
six-axis rank layout and its process groups (:mod:`.mesh`), the
conjugate-pair collectives (:mod:`.mappings`), the tensor-parallel
layers and the expert-parallel MoE layer (:mod:`.moe`)."""

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
from neuronx_distributed_tpu_torch.parallel.moe import (
    ExpertParallelMLP,
    load_balancing_loss,
)
from neuronx_distributed_tpu_torch.parallel.norm import RMSNorm
from neuronx_distributed_tpu_torch.parallel.qkv import GQAQKVColumnParallelLinear

__all__ = [
    "ColumnParallelLinear",
    "ExpertParallelMLP",
    "GQAQKVColumnParallelLinear",
    "ParallelEmbedding",
    "RMSNorm",
    "RowParallelLinear",
    "TensorParallel",
    "destroy_model_parallel",
    "initialize_model_parallel",
    "load_balancing_loss",
    "model_parallel_is_initialized",
]
