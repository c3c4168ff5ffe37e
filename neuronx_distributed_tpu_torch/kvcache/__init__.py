"""Paged KV-cache subsystem of the PyTorch port: host-side page accounting
(:mod:`.allocator`), the prefix trie (:mod:`.prefix`) and the device pool
(:mod:`.pool`)."""

from neuronx_distributed_tpu_torch.kvcache.allocator import (
    NULL_PAGE,
    BlockAllocator,
    PoolExhausted,
)
from neuronx_distributed_tpu_torch.kvcache.pool import PagePool, init_page_pool_caches
from neuronx_distributed_tpu_torch.kvcache.prefix import (
    PAD,
    PrefixIndex,
    chain_fingerprint,
    is_padding_key,
    page_keys,
    prefix_fingerprints,
)

__all__ = [
    "BlockAllocator",
    "NULL_PAGE",
    "PAD",
    "PagePool",
    "PoolExhausted",
    "PrefixIndex",
    "chain_fingerprint",
    "init_page_pool_caches",
    "is_padding_key",
    "page_keys",
    "prefix_fingerprints",
]
