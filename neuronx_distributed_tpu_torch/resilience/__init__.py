"""Resilience of the PyTorch port: the fault-injection plane
(:mod:`.faults`, whose fault points run through the serving engine, the
paged-KV manager and the adapter store) and the restart-on-crash process
supervisor (:mod:`.supervisor`).  The anomaly policies of ``fit()`` wait
for the port's training loop."""

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
from neuronx_distributed_tpu_torch.resilience.supervisor import (
    SUPERVISOR_EVENTS_SCHEMA,
    Supervisor,
    SupervisorResult,
    classify_exit,
    newest_complete_tag,
)

__all__ = [
    "ENV_VAR",
    "FaultPlan",
    "InjectedFault",
    "KILL_EXIT_CODE",
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
