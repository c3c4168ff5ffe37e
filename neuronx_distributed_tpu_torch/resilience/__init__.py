"""Resilience of the PyTorch port: the fault-injection plane
(:mod:`.faults`, whose fault points run through the serving engine, the
paged-KV manager, the adapter store, ``fit``, the checkpoints and the
data loader), the anomaly response policies of ``fit(policy=)``
(:mod:`.policy`) and the restart-on-crash process supervisor with its CLI
(:mod:`.supervisor`)."""

from neuronx_distributed_tpu_torch.resilience.faults import (
    ENV_VAR,
    KILL_EXIT_CODE,
    FaultPlan,
    InjectedFault,
    active_plan,
    clear_plan,
    fault_point,
    fired_events,
    install_plan,
    perturb,
)
from neuronx_distributed_tpu_torch.resilience.policy import (
    AnomalyPolicy,
    PolicyDecision,
    PolicyEngine,
    PolicyHalt,
    RetriesExhausted,
    StepWatchdog,
)
from neuronx_distributed_tpu_torch.resilience.supervisor import (
    SUPERVISOR_EVENTS_SCHEMA,
    Supervisor,
    SupervisorResult,
    classify_exit,
    newest_complete_tag,
)

__all__ = [
    "AnomalyPolicy",
    "ENV_VAR",
    "FaultPlan",
    "InjectedFault",
    "KILL_EXIT_CODE",
    "PolicyDecision",
    "PolicyEngine",
    "PolicyHalt",
    "RetriesExhausted",
    "StepWatchdog",
    "SUPERVISOR_EVENTS_SCHEMA",
    "Supervisor",
    "SupervisorResult",
    "active_plan",
    "classify_exit",
    "clear_plan",
    "fault_point",
    "fired_events",
    "install_plan",
    "newest_complete_tag",
    "perturb",
]
