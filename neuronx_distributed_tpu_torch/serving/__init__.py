"""Continuous-batching serving of the PyTorch port (paged mode): async
decode by default, speculative decoding with ``draft=``/``spec_k=``, and
SLO scheduling: interactive/batch priorities with preemption, deadlines,
feasibility shedding (``SLOInfeasible``) and tenant rate limits
(``RateLimited``)."""

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
    DEFAULT_MAX_BATCH_WAIT_S,
    AdmissionError,
    BackpressureError,
    RateLimited,
    SLOInfeasible,
    SlotScheduler,
    TokenBucket,
)

__all__ = [
    "AdmissionError",
    "BackpressureError",
    "DEFAULT_MAX_BATCH_WAIT_S",
    "FAIL_NON_FINITE",
    "PagedKVManager",
    "RateLimited",
    "Request",
    "RequestOutput",
    "RequestState",
    "SLOInfeasible",
    "SamplingParams",
    "ServingEngine",
    "SlotScheduler",
    "TokenBucket",
    "percentiles",
    "poisson_arrivals",
    "replay",
    "summarize_outputs",
]
