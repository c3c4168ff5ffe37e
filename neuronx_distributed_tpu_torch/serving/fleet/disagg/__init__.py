"""Disaggregated serving fleet: prefill/decode roles, KV-page migration,
and a fleet-global prefix cache over the per-replica page pools.

- :mod:`.roles` — the role vocabulary (``prefill`` / ``decode`` /
  ``mixed``) and the role-compatible envelope relaxation (capacity may
  differ between roles; page geometry never);
- :mod:`.directory` — :class:`FleetPrefixDirectory`: fingerprint ->
  holder-set over the per-replica prefix indexes, so a popular prompt is
  prefilled once FLEET-wide;
- :mod:`.router` — :class:`DisaggRouter`: role-aware dispatch
  (interactive -> prefill capacity), post-prefill KV migration to decode
  capacity (``kvcache.transfer`` under the zero-loss ledger), and the
  directory-driven cross-replica prefix fill.

The transfer primitive itself lives in
:mod:`~...kvcache.transfer`; the single-engine preemption-resume half
(committed chains surviving a park) in :mod:`~..paged`.
"""

from neuronx_distributed_tpu_torch.serving.fleet.disagg.directory import (
    FLEET_PREFIX_HITS_TOTAL,
    FLEET_PREFIX_MISSES_TOTAL,
    FleetPrefixDirectory,
)
from neuronx_distributed_tpu_torch.serving.fleet.disagg.roles import (
    CAPACITY_KEYS,
    ROLE_DECODE,
    ROLE_MIXED,
    ROLE_PREFILL,
    ROLES,
    role_compatible,
    role_envelope,
    validate_role,
)
from neuronx_distributed_tpu_torch.serving.fleet.disagg.router import (
    MIGRATIONS_TOTAL,
    DisaggRouter,
)

__all__ = [
    "CAPACITY_KEYS",
    "DisaggRouter",
    "FLEET_PREFIX_HITS_TOTAL",
    "FLEET_PREFIX_MISSES_TOTAL",
    "FleetPrefixDirectory",
    "MIGRATIONS_TOTAL",
    "ROLES",
    "ROLE_DECODE",
    "ROLE_MIXED",
    "ROLE_PREFILL",
    "role_compatible",
    "role_envelope",
    "validate_role",
]
