"""Attention ops of the PyTorch port; the kernels are built at first use."""

from neuronx_distributed_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_reference,
    resolve_paged_kernel,
)

__all__ = ["paged_attention", "paged_attention_reference",
           "resolve_paged_kernel"]
