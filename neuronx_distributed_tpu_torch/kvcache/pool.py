"""Device-side page pool for the paged KV cache (counterpart of
``neuronx_distributed_tpu/kvcache/pool.py``).

One preallocated ``[num_pages, page_size, kv_heads, head_dim]`` pair per
layer; requests hold integer block tables mapping their logical cache pages
to physical ones.  Page 0 is the NULL page: left-padding pages and unused
tail pages point at it, and its content is never attended.  Page accounting
lives in the host-side :class:`~.allocator.BlockAllocator`; the device
writes (``write_page``, ``copy_page``, the decode scatter) are on the
serving wrapper and update the pool in place.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from neuronx_distributed_tpu_torch.utils.device import resolve_device

INT8_DEFERRED = ("int8 page pools (kv_quant='int8') are not ported yet; they "
                 "land with the kv_quant slice")


def init_page_pool_caches(num_layers: int, num_pages: int, page_size: int,
                          num_kv_heads: int, head_dim: int,
                          dtype: torch.dtype = torch.bfloat16,
                          device=None) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Zero fp page-pool caches ``(k, v)``, each ``[NP, page, NKV, D]``,
    per layer."""
    device = resolve_device(device)
    shape = (num_pages, page_size, num_kv_heads, head_dim)
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(num_layers)]


def page_layer_bytes(page_size: int, num_kv_heads: int, head_dim: int,
                     dtype: torch.dtype) -> int:
    """Device bytes of one page of one layer (k + v)."""
    return 2 * page_size * num_kv_heads * head_dim * (
        torch.finfo(dtype).bits // 8)


class PagePool:
    """The preallocated device pool plus its sizing arithmetic."""

    def __init__(self, num_layers: int, num_pages: int, page_size: int,
                 num_kv_heads: int, head_dim: int,
                 dtype: torch.dtype = torch.bfloat16,
                 quant: Optional[str] = None, device=None):
        if quant is not None:
            raise NotImplementedError(INT8_DEFERRED)
        if num_pages < 2:
            raise ValueError(
                f"num_pages must be >= 2 (page 0 is the NULL page), "
                f"got {num_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.num_layers = num_layers
        self.num_pages = num_pages
        self.page_size = page_size
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.dtype = dtype
        self.caches = init_page_pool_caches(
            num_layers, num_pages, page_size, num_kv_heads, head_dim, dtype,
            device)

    @property
    def page_bytes(self) -> int:
        """Device bytes one page costs across all layers."""
        return self.num_layers * page_layer_bytes(
            self.page_size, self.num_kv_heads, self.head_dim, self.dtype)

    @property
    def total_bytes(self) -> int:
        return self.num_pages * self.page_bytes

    @staticmethod
    def pages_for_budget(budget_bytes: int, num_layers: int, page_size: int,
                         num_kv_heads: int, head_dim: int,
                         dtype: torch.dtype = torch.bfloat16) -> int:
        """How many pool pages a device-memory budget buys."""
        per_page = num_layers * page_layer_bytes(page_size, num_kv_heads,
                                                 head_dim, dtype)
        return max(int(budget_bytes // per_page), 0)
