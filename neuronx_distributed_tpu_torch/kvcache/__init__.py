"""Paged KV-cache subsystem of the PyTorch port: host-side page accounting
(:mod:`.allocator`), the prefix trie (:mod:`.prefix`), the device pool
(:mod:`.pool`), int8 page quantization (:mod:`.quant`) and page-chain
transfer between pools (:mod:`.transfer`)."""

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
from neuronx_distributed_tpu_torch.kvcache.transfer import (
    PAGES_EXPORTED_TOTAL,
    PAGES_IMPORTED_TOTAL,
    ChainExport,
    TransferError,
    export_chain,
    import_chain,
)
from neuronx_distributed_tpu_torch.kvcache.quant import (
    dequantize_page,
    page_layer_bytes,
    quant_error_bound,
    quantize_page,
)

__all__ = [
    "BlockAllocator",
    "ChainExport",
    "GATHER_BYTES_TOTAL",
    "NULL_PAGE",
    "PAD",
    "PAGES_EXPORTED_TOTAL",
    "PAGES_IMPORTED_TOTAL",
    "PagePool",
    "PoolExhausted",
    "PrefixIndex",
    "TransferError",
    "chain_fingerprint",
    "dequantize_page",
    "export_chain",
    "import_chain",
    "init_page_pool_caches",
    "is_padding_key",
    "page_keys",
    "page_layer_bytes",
    "prefix_fingerprints",
    "quant_error_bound",
    "quantize_page",
]
