"""Paged KV-cache subsystem of the PyTorch port: host-side page accounting
(:mod:`.allocator`), the prefix trie (:mod:`.prefix`), the device pool
(:mod:`.pool`) and int8 page quantization (:mod:`.quant`)."""

from neuronx_distributed_tpu_torch.kvcache.allocator import (
    NULL_PAGE,
    BlockAllocator,
    PoolExhausted,
)
from neuronx_distributed_tpu_torch.kvcache.pool import (
    GATHER_BYTES_TOTAL,
    PagePool,
    init_page_pool_caches,
)
from neuronx_distributed_tpu_torch.kvcache.prefix import (
    PAD,
    PrefixIndex,
    chain_fingerprint,
    is_padding_key,
    page_keys,
    prefix_fingerprints,
)
from neuronx_distributed_tpu_torch.kvcache.quant import (
    dequantize_page,
    page_layer_bytes,
    quant_error_bound,
    quantize_page,
)

__all__ = [
    "BlockAllocator",
    "GATHER_BYTES_TOTAL",
    "NULL_PAGE",
    "PAD",
    "PagePool",
    "PoolExhausted",
    "PrefixIndex",
    "chain_fingerprint",
    "dequantize_page",
    "init_page_pool_caches",
    "is_padding_key",
    "page_keys",
    "page_layer_bytes",
    "prefix_fingerprints",
    "quant_error_bound",
    "quantize_page",
]
