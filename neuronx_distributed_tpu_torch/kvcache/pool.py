"""Device-side page pool for the paged KV cache (counterpart of
``neuronx_distributed_tpu/kvcache/pool.py``).

One preallocated ``[num_pages, page_size, kv_heads, head_dim]`` pair per
layer; requests hold integer block tables mapping their logical cache pages
to physical ones.  Page 0 is the NULL page: left-padding pages and unused
tail pages point at it, and its content is never attended.  Page accounting
lives in the host-side :class:`~.allocator.BlockAllocator`; the device
writes (``write_page``, ``copy_page``, the block-table scatter) are on the
serving wrapper and update the pool in place.

``quant="int8"`` makes each layer's entry the six-tuple ``(k int8, v int8,
k_scale, k_zero, v_scale, v_zero)`` with one fp32 scale/zero per physical
page (:mod:`.quant`): the marker the model's scatter and gather, and the
paged-attention kernel, key their dequantizing path on.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from neuronx_distributed_tpu_torch.kvcache.quant import check_quant, page_layer_bytes
from neuronx_distributed_tpu_torch.utils.device import resolve_device

# registry counter: bytes the paged GATHER path spends rematerializing
# per-slot [B, T] contiguous K/V clones from the pool -- what the
# block-table-native kernel saves.  Stays ZERO on the kernel path.
GATHER_BYTES_TOTAL = "kvcache/gather_bytes_total"


def init_page_pool_caches(num_layers: int, num_pages: int, page_size: int,
                          num_kv_heads: int, head_dim: int,
                          dtype: torch.dtype = torch.bfloat16,
                          device=None, quant: Optional[str] = None
                          ) -> List[Tuple[torch.Tensor, ...]]:
    """Zero page-pool caches per layer: the fp pair ``(k, v)``, each ``[NP,
    page, NKV, D]``, or with ``quant="int8"`` the int8 six-tuple with zero
    ``[NP]`` fp32 page params."""
    check_quant(quant)
    device = resolve_device(device)
    shape = (num_pages, page_size, num_kv_heads, head_dim)
    if quant is None:
        return [(torch.zeros(shape, dtype=dtype, device=device),
                 torch.zeros(shape, dtype=dtype, device=device))
                for _ in range(num_layers)]
    return [tuple(torch.zeros(shape, dtype=torch.int8, device=device)
                  for _ in range(2))
            + tuple(torch.zeros((num_pages,), dtype=torch.float32,
                                device=device) for _ in range(4))
            for _ in range(num_layers)]


class PagePool:
    """The preallocated device pool plus its sizing arithmetic."""

    def __init__(self, num_layers: int, num_pages: int, page_size: int,
                 num_kv_heads: int, head_dim: int,
                 dtype: torch.dtype = torch.bfloat16,
                 quant: Optional[str] = None, device=None):
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
        self.quant = quant
        self.caches = init_page_pool_caches(
            num_layers, num_pages, page_size, num_kv_heads, head_dim, dtype,
            device, quant)

    @property
    def page_bytes(self) -> int:
        """Device bytes one page costs across all layers (k + v, plus the
        per-page scale/zero params of an int8 pool)."""
        return self.num_layers * page_layer_bytes(
            self.page_size, self.num_kv_heads, self.head_dim, self.quant,
            self.dtype)

    @property
    def total_bytes(self) -> int:
        return self.num_pages * self.page_bytes

    @staticmethod
    def pages_for_budget(budget_bytes: int, num_layers: int, page_size: int,
                         num_kv_heads: int, head_dim: int,
                         dtype: torch.dtype = torch.bfloat16,
                         quant: Optional[str] = None) -> int:
        """How many pool pages a device-memory budget buys; ``quant="int8"``
        about doubles the answer against bf16."""
        per_page = num_layers * page_layer_bytes(page_size, num_kv_heads,
                                                 head_dim, quant, dtype)
        return max(int(budget_bytes // per_page), 0)
