"""Continuous-batching serving of the PyTorch port (paged mode): async
decode by default, speculative decoding with ``draft=``/``spec_k=``, SLO
scheduling (interactive/batch priorities with preemption, deadlines,
feasibility shedding ``SLOInfeasible``, tenant rate limits
``RateLimited``), and the observability hooks (``registry=``,
``stats_path=``, ``obs=``, ``tracer=``, ``transfer_guard=``).  The fleet
(:mod:`.fleet`): replicas behind a :class:`FleetRouter` (routing policies,
failover, drains, rolling weight updates), the disaggregated router and
the autopilot."""

from neuronx_distributed_tpu_torch.serving.driver import (
    percentiles,
    poisson_arrivals,
    replay,
    summarize_outputs,
)
from neuronx_distributed_tpu_torch.serving.engine import (
    FAIL_NON_FINITE,
    SERVING_STATS_SCHEMA,
    ServingEngine,
    replay_trace,
)
from neuronx_distributed_tpu_torch.serving.fleet import (
    FleetRouter,
    FleetUnavailableError,
    Replica,
    ReplicaState,
)
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
    "FleetRouter",
    "FleetUnavailableError",
    "PagedKVManager",
    "RateLimited",
    "Replica",
    "ReplicaState",
    "Request",
    "RequestOutput",
    "RequestState",
    "SERVING_STATS_SCHEMA",
    "SLOInfeasible",
    "SamplingParams",
    "ServingEngine",
    "SlotScheduler",
    "TokenBucket",
    "percentiles",
    "poisson_arrivals",
    "replay",
    "replay_trace",
    "summarize_outputs",
]
