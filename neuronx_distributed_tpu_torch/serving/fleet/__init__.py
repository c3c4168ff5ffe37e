"""Serving fleet: a multi-replica engine pool behind one front door.

Counterpart of ``neuronx_distributed_tpu/serving/fleet``.  One
``ServingEngine`` is one batch envelope; the north star
("heavy traffic from millions of users") needs N of them.  This package is
the admission layer over the pool:

- :mod:`.replica` — :class:`Replica`: a restartable engine slot (LIVE /
  DEAD / RETIRED) on the shared
  :class:`~..resilience.supervisor.RestartBackoff` crash budget, carrying
  the ``fleet/replica_step`` fault point for the ``NXD_FAULT_PLAN`` plane;
- :mod:`.routing` — pluggable dispatch policies (round-robin, random,
  load-aware from the ``obs`` gauges, and **prefix affinity** over a
  host-side shadow of each replica's cached prefix chains — SGLang's
  cache-aware routing on the page-granular ``PrefixIndex``);
- :mod:`.router` — :class:`FleetRouter`: globally-unique request ids
  (namespace-folded into the per-request rng streams), policy dispatch,
  zero-loss failover (crash -> drain -> requeue on siblings -> warm
  restart), ``router/*`` metrics and ``router_stats.jsonl``;
- :mod:`.disagg` — :class:`DisaggRouter`: prefill/decode replica roles,
  post-prefill KV-page migration over ``kvcache.transfer``, and a
  fleet-global prefix directory so a popular prompt is prefilled once
  fleet-wide;
- :mod:`.autopilot` — :class:`Autopilot`: alert-driven remediation over
  ``FleetHealth`` + the router — autoscale (scale out on sustained burn,
  graceful drain/scale in on idle), proactive drain-and-restart,
  burn-driven admission tightening and role rebalancing, every action a
  schema-checked ``autopilot_actions.jsonl`` record, flap-bounded by
  hysteresis + cooldowns + a global action budget.

Drive a fleet exactly like an engine: it has ``submit`` / ``step`` /
``has_work``, so :func:`~..serving.driver.replay` takes either.
"""

from neuronx_distributed_tpu_torch.serving.fleet.autopilot import (
    AUTOPILOT_ACTION_SCHEMA,
    Autopilot,
    AutopilotConfig,
)
from neuronx_distributed_tpu_torch.serving.fleet.disagg import (
    ROLE_DECODE,
    ROLE_MIXED,
    ROLE_PREFILL,
    DisaggRouter,
    FleetPrefixDirectory,
)
from neuronx_distributed_tpu_torch.serving.fleet.replica import (
    Replica,
    ReplicaState,
)
from neuronx_distributed_tpu_torch.serving.fleet.router import (
    ROUTER_STATS_SCHEMA,
    FleetRouter,
    FleetUnavailableError,
    RequestIdAllocator,
)
from neuronx_distributed_tpu_torch.serving.fleet.routing import (
    POLICIES,
    Decision,
    LeastLoadedPolicy,
    PrefixAffinityPolicy,
    RandomPolicy,
    ReplicaShadow,
    RoleAwarePolicy,
    RoundRobinPolicy,
    RoutingPolicy,
    make_policy,
)

__all__ = [
    "Autopilot",
    "AutopilotConfig",
    "AUTOPILOT_ACTION_SCHEMA",
    "DisaggRouter",
    "FleetPrefixDirectory",
    "FleetRouter",
    "FleetUnavailableError",
    "RequestIdAllocator",
    "ROUTER_STATS_SCHEMA",
    "Replica",
    "ReplicaState",
    "ROLE_DECODE",
    "ROLE_MIXED",
    "ROLE_PREFILL",
    "RoutingPolicy",
    "RoleAwarePolicy",
    "RoundRobinPolicy",
    "RandomPolicy",
    "LeastLoadedPolicy",
    "PrefixAffinityPolicy",
    "ReplicaShadow",
    "Decision",
    "POLICIES",
    "make_policy",
]
