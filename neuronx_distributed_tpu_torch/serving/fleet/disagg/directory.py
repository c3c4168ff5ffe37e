"""Fleet-global prefix directory: which replica holds which chain.

The per-replica :class:`~....kvcache.prefix.PrefixIndex` makes a repeated
prompt free on ONE replica; the directory makes it free FLEET-WIDE.  It
maps chain fingerprints (the same rolling blake2b the tries and the
router's shadows key on — content-addressed, so two replicas that
prefilled the same prompt agree on the name) to the set of replica ids
believed to hold that chain.  The disaggregated router consults it at
dispatch: when the chosen replica lacks the prompt's full chain but a
sibling holds it, the chain is exported/imported (``kvcache.transfer``)
instead of re-prefilled — a popular prompt is prefilled ONCE fleet-wide
(Mooncake's KVCache-centric pooling, SGLang's cache-aware routing taken
cross-replica).

Like the shadows, the directory is OPTIMISTIC: credited at dispatch and
import time, resynced from the live index truth on the shadow cadence,
and cleared for a crashed replica.  Staleness is safe by construction —
a stale holder's ``export_prefix`` returns None (the chain was evicted)
and the lookup falls through to the next holder or a miss.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Set

FLEET_PREFIX_HITS_TOTAL = "kvcache/fleet_prefix_hits_total"
FLEET_PREFIX_MISSES_TOTAL = "kvcache/fleet_prefix_misses_total"


class FleetPrefixDirectory:
    """Fingerprint -> replica-id set, with the shadow lifecycle verbs."""

    def __init__(self):
        self._holders: Dict[int, Set[int]] = {}

    def __len__(self) -> int:
        return len(self._holders)

    def credit(self, replica_id: int, fps: Iterable[int]) -> None:
        """Record that ``replica_id`` (now) holds these chains —
        optimistic, exactly like :meth:`~..routing.ReplicaShadow.credit`."""
        for fp in fps:
            self._holders.setdefault(fp, set()).add(replica_id)

    def uncredit(self, replica_id: int, fp: int) -> None:
        """Drop one stale claim (a holder whose export came back empty)."""
        holders = self._holders.get(fp)
        if holders is not None:
            holders.discard(replica_id)
            if not holders:
                del self._holders[fp]

    def forget_replica(self, replica_id: int) -> None:
        """Remove every claim of a crashed/retired replica — its pool (and
        index) died with the engine."""
        for fp in list(self._holders):
            self.uncredit(replica_id, fp)

    def resync(self, replica_id: int, fps: Iterable[int]) -> None:
        """Replace ``replica_id``'s claims with the live index truth (the
        shadow-resync cadence; also the post-restart cold reset)."""
        self.forget_replica(replica_id)
        self.credit(replica_id, fps)

    def holders(self, fp: int,
                exclude: Optional[Set[int]] = None) -> List[int]:
        """Replica ids believed to hold ``fp``, deterministic order,
        minus ``exclude`` (the requester itself, dead replicas)."""
        held = self._holders.get(fp, ())
        if exclude:
            return sorted(r for r in held if r not in exclude)
        return sorted(held)
