"""Data pipeline of the PyTorch port: the native (C++) memory-mapped
token-dataset loader with deterministic data-parallel sharding and a
bit-identical numpy fallback, sequence packing, and :class:`DevicePrefetcher`,
which stages batches on the device ahead of the step that consumes them
(``fit(prefetch=N)``)."""

from neuronx_distributed_tpu_torch.data.loader import (
    TokenDataLoader,
    TokenDataset,
    read_token_file,
    step_indexed,
    write_token_file,
)
from neuronx_distributed_tpu_torch.data.prefetch import DevicePrefetcher

__all__ = [
    "DevicePrefetcher",
    "TokenDataLoader",
    "TokenDataset",
    "read_token_file",
    "step_indexed",
    "write_token_file",
]
