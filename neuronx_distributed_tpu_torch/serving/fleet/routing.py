"""Pluggable dispatch policies for the fleet router.

A policy answers ONE question — "which live replica gets this request?" —
from host-side state only: the replicas' load views (queue depth, active
slots, pages free, host-blocked time — all derived from the same ``obs``
gauges each engine already exports) and, for prefix affinity, the router's
*shadow index*: a per-replica set of page-chain fingerprints approximating
what that replica's :class:`~...kvcache.prefix.PrefixIndex` holds (see
:class:`ReplicaShadow`).  Policies never touch a device and never see an
engine — they are property-testable with fakes.

Why prefix affinity is a policy and not an engine feature: the
``PrefixIndex`` is per-replica state, so only the front door can steer a
prompt to the replica that already paid for its prefix (SGLang's
cache-aware routing).  The shadow is optimistic — updated at dispatch time
with the chains the request WILL cache — and resynced from the live index
truth (:meth:`~...serving.paged.PagedKVManager.prefix_fingerprints`)
periodically and after every replica restart, so it never credits an index
that lost its pages.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set

import numpy as np


@dataclasses.dataclass
class Decision:
    """One routing decision: the chosen replica id plus how many leading
    prompt pages the shadow says it already caches (0 = pure load/rotation
    dispatch — the affinity miss case)."""

    replica_id: int
    affinity_pages: int = 0


class ReplicaShadow:
    """Host-side approximation of one replica's cached prefix chains, as a
    set of rolling chain fingerprints (:func:`~...kvcache.prefix
    .chain_fingerprint`).  ``credit`` adds a dispatched prompt's chains
    optimistically; ``resync`` replaces the set with the live index truth;
    ``match_depth`` is the longest leading chain of ``fps`` the shadow
    holds — the affinity score."""

    def __init__(self):
        self.fps: Set[int] = set()

    def credit(self, fps: Sequence[int]) -> None:
        self.fps.update(fps)

    def resync(self, fps: Set[int]) -> None:
        self.fps = set(fps)

    def clear(self) -> None:
        self.fps.clear()

    def match_depth(self, fps: Sequence[int]) -> int:
        """Pages of the longest leading chain present in the shadow.  Chains
        are rolling hashes, so a missing prefix at depth ``i`` makes every
        deeper fingerprint unmatchable — scan stops at the first miss."""
        depth = 0
        for fp in fps:
            if fp not in self.fps:
                break
            depth += 1
        return depth


def load_score(view: dict) -> tuple:
    """Sortable load key for one replica's view (lower = less loaded):
    requests in the system (queued + active) normalized by slot count, then
    pages-free descending (a fuller pool backpressures sooner), then mean
    host-blocked ms (a replica whose host stalls on fetches is slower than
    its queue depth suggests), then replica id for determinism."""
    slots = max(int(view.get("slots") or 1), 1)
    in_system = (view.get("queue_depth", 0) + view.get("active", 0)) / slots
    pages_free = view.get("pages_free")
    blocked = view.get("host_blocked_ms_mean") or 0.0
    return (in_system, -(pages_free if pages_free is not None else 0),
            blocked, view.get("replica_id", 0))


class RoutingPolicy:
    """Base: ``choose`` picks among the LIVE candidates (router guarantees
    the list is non-empty).  ``views`` maps replica_id -> load view dict,
    ``shadows`` maps replica_id -> :class:`ReplicaShadow`, ``fps`` is the
    request's leading-chain fingerprints (empty off paged/prefix mode),
    ``adapter_id`` the request's LoRA adapter (0 = base model) — the
    tenancy tiebreak evidence: views carry ``resident_adapters``, the set
    of adapters whose pages that replica's store holds device-resident."""

    name = "base"
    # load views cost a metrics scan per replica per dispatch, and prompt
    # fingerprints cost a blake2b per page; policies that never read them
    # (pure rotation/random) opt out and receive {} / []
    needs_views = True
    needs_fps = True
    # policies that steer by the request's PRIORITY CLASS (the
    # disaggregated fleet's role-aware dispatch) opt in and receive a
    # `priority` kwarg; the default keeps every existing policy's
    # `choose` signature valid
    needs_priority = False

    def choose(self, candidates: List[int], views: Dict[int, dict],
               shadows: Dict[int, ReplicaShadow],
               fps: Sequence[int], adapter_id: int = 0) -> Decision:
        raise NotImplementedError


class RoundRobinPolicy(RoutingPolicy):
    """Strict rotation over whoever is alive — the zero-information
    baseline (and the degenerate fleet-of-one's only behavior)."""

    name = "round_robin"
    needs_views = False
    needs_fps = False

    def __init__(self):
        self._next = 0

    def choose(self, candidates, views, shadows, fps,
               adapter_id: int = 0) -> Decision:
        rid = candidates[self._next % len(candidates)]
        self._next += 1
        return Decision(rid)


class RandomPolicy(RoutingPolicy):
    """Uniform random dispatch — the control arm prefix affinity is
    measured against (seeded: benchmark runs are reproducible)."""

    name = "random"
    needs_views = False
    needs_fps = False

    def __init__(self, seed: int = 0):
        self._rs = np.random.RandomState(seed)

    def choose(self, candidates, views, shadows, fps,
               adapter_id: int = 0) -> Decision:
        return Decision(candidates[int(self._rs.randint(len(candidates)))])


class LeastLoadedPolicy(RoutingPolicy):
    """Min :func:`load_score` over the live views — the obs-gauge-driven
    dispatch (queue depth, slot occupancy, pages free, host-blocked ms)."""

    name = "least_loaded"

    def choose(self, candidates, views, shadows, fps,
               adapter_id: int = 0) -> Decision:
        return Decision(min(candidates, key=lambda r: load_score(views[r])))


class PrefixAffinityPolicy(RoutingPolicy):
    """Steer to the replica whose shadow holds the LONGEST leading chain of
    the prompt's page fingerprints; break ties (including the
    nothing-matches case) first by ADAPTER RESIDENCY — among the
    prefix-tied candidates, one whose adapter store already pins the
    request's adapter serves it without paying a cold adapter load — then
    by least load.  On engines without a prefix cache ``fps`` is always
    empty and this degrades to adapter-residency + least-loaded.

    The affinity win is multiplicative with the engines' prefix cache: a
    steered request's shared pages are refcounted once on ONE replica
    instead of being re-prefilled on every replica the rotation happens to
    land it on — and its adapter stays hot on that replica
    instead of churning every pool's LRU."""

    name = "prefix_affinity"

    @staticmethod
    def _adapter_tiebreak(pool, views, adapter_id):
        if not adapter_id:
            return pool
        resident = [r for r in pool
                    if adapter_id in (views.get(r, {})
                                      .get("resident_adapters") or ())]
        return resident or pool

    def choose(self, candidates, views, shadows, fps,
               adapter_id: int = 0) -> Decision:
        depths = {r: shadows[r].match_depth(fps)
                  for r in candidates} if fps else {}
        best = max(depths.values(), default=0)
        tied = (candidates if best == 0
                else [r for r in candidates if depths[r] == best])
        tied = self._adapter_tiebreak(tied, views, adapter_id)
        return Decision(min(tied, key=lambda r: load_score(views[r])),
                        affinity_pages=best)


class RoleAwarePolicy(RoutingPolicy):
    """Disaggregated dispatch: steer by replica ROLE (the ``role`` field
    in the load views — "prefill" / "decode" / "mixed") before anything
    else.  Interactive traffic prefers prefill-capable replicas (TTFT is
    gated on prefill queueing, the DistServe/Splitwise observation);
    batch traffic prefers decode-capable ones, keeping prefill capacity
    free for the latency-sensitive class.  Within the role-preferred
    pool the choice is exactly :class:`PrefixAffinityPolicy` — longest
    shadow chain, then adapter residency, then least load — so the
    disaggregated fleet keeps the cache-aware win.  When no replica of
    the wanted role is alive the pool falls back to everyone (roles are
    steering labels, not capabilities)."""

    name = "role_aware"
    needs_priority = True

    def choose(self, candidates, views, shadows, fps,
               adapter_id: int = 0,
               priority: str = "interactive") -> Decision:
        want = "prefill" if priority == "interactive" else "decode"
        preferred = [r for r in candidates
                     if views.get(r, {}).get("role", "mixed")
                     in (want, "mixed")]
        pool = preferred or candidates
        depths = {r: shadows[r].match_depth(fps) for r in pool} if fps else {}
        best = max(depths.values(), default=0)
        tied = (pool if best == 0
                else [r for r in pool if depths[r] == best])
        tied = PrefixAffinityPolicy._adapter_tiebreak(tied, views, adapter_id)
        return Decision(min(tied, key=lambda r: load_score(views[r])),
                        affinity_pages=best)


POLICIES = {
    p.name: p for p in (RoundRobinPolicy, RandomPolicy, LeastLoadedPolicy,
                        PrefixAffinityPolicy, RoleAwarePolicy)
}


def make_policy(policy: "str | RoutingPolicy",
                seed: int = 0) -> RoutingPolicy:
    """Resolve a policy argument: an instance passes through, a name
    constructs one (``random`` takes the seed)."""
    if isinstance(policy, RoutingPolicy):
        return policy
    cls = POLICIES.get(policy)
    if cls is None:
        raise ValueError(
            f"unknown routing policy {policy!r} (known: {sorted(POLICIES)})")
    return cls(seed) if cls is RandomPolicy else cls()
