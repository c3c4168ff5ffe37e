"""Multi-tenant serving: paged LoRA adapters behind one set of phase
functions (counterpart of ``neuronx_distributed_tpu/tenancy``).

:mod:`.store` pages adapters through the kvcache ``BlockAllocator``; the
serving engine's ``adapter_store=`` and ``Request.adapter_id`` are the
consumer surface, the models' ``adapters=`` argument the device half.
"""

from neuronx_distributed_tpu_torch.tenancy.store import (
    FACTOR_NAMES,
    AdapterLayout,
    AdapterStore,
    factors_from_params,
    make_adapter_store,
)

__all__ = [
    "FACTOR_NAMES",
    "AdapterLayout",
    "AdapterStore",
    "factors_from_params",
    "make_adapter_store",
]
