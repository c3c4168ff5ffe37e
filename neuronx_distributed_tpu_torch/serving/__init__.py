"""Continuous-batching serving of the PyTorch port (paged mode): async
decode by default, speculative decoding with ``draft=``/``spec_k=``."""

from neuronx_distributed_tpu_torch.serving.driver import (
    percentiles,
    poisson_arrivals,
    replay,
    summarize_outputs,
)
from neuronx_distributed_tpu_torch.serving.engine import FAIL_NON_FINITE, ServingEngine
from neuronx_distributed_tpu_torch.serving.paged import PagedKVManager
from neuronx_distributed_tpu_torch.serving.request import (
    Request,
    RequestOutput,
    RequestState,
    SamplingParams,
)
from neuronx_distributed_tpu_torch.serving.scheduler import (
    AdmissionError,
    BackpressureError,
    SlotScheduler,
)

__all__ = [
    "AdmissionError",
    "BackpressureError",
    "FAIL_NON_FINITE",
    "PagedKVManager",
    "Request",
    "RequestOutput",
    "RequestState",
    "SamplingParams",
    "ServingEngine",
    "SlotScheduler",
    "percentiles",
    "poisson_arrivals",
    "replay",
    "summarize_outputs",
]
