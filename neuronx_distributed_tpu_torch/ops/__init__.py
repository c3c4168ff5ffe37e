"""Attention ops of the PyTorch port; the kernels are built at first use."""

from neuronx_distributed_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_reference,
    resolve_paged_kernel,
)
from neuronx_distributed_tpu_torch.ops.ring_attention import (
    ring_attention,
    ulysses_attention,
    zigzag_indices,
    zigzag_permute,
    zigzag_unpermute,
)

__all__ = ["paged_attention", "paged_attention_reference",
           "resolve_paged_kernel", "ring_attention", "ulysses_attention",
           "zigzag_indices", "zigzag_permute", "zigzag_unpermute"]
