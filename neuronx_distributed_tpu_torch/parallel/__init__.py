"""Layers of the PyTorch port at tensor-parallel degree 1."""

from neuronx_distributed_tpu_torch.parallel.layers import (
    ColumnParallelLinear,
    ParallelEmbedding,
    RowParallelLinear,
)
from neuronx_distributed_tpu_torch.parallel.norm import RMSNorm
from neuronx_distributed_tpu_torch.parallel.qkv import GQAQKVColumnParallelLinear

__all__ = [
    "ColumnParallelLinear",
    "GQAQKVColumnParallelLinear",
    "ParallelEmbedding",
    "RMSNorm",
    "RowParallelLinear",
]
