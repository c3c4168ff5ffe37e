"""Continuous-batching serving of the PyTorch port (paged mode)."""

from neuronx_distributed_tpu_torch.serving.driver import (
    percentiles,
    poisson_arrivals,
    replay,
    summarize_outputs,
)
from neuronx_distributed_tpu_torch.serving.engine import ServingEngine
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
