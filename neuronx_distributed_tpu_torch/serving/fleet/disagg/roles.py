"""Replica roles for the disaggregated fleet.

A role is a STEERING label, not a capability: every replica runs the same
compiled engine and can execute either phase.  What disaggregation changes
is where work LANDS — interactive TTFT traffic on prefill-heavy capacity,
steady-state token generation on decode-heavy capacity (DistServe, Zhong
et al. 2024; Splitwise, Patel et al. 2024) — and what the router's
homogeneity check may tolerate: role-specialized replicas legitimately
differ in KV POOL CAPACITY (a prefill replica holds few long-lived chains;
a decode replica holds many), but never in page geometry, context width,
or any other compiled-envelope fact, because failover and migration both
assume a request admissible on one replica is admissible on any sibling.
"""

from __future__ import annotations

ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"
ROLE_MIXED = "mixed"
ROLES = (ROLE_PREFILL, ROLE_DECODE, ROLE_MIXED)

# describe() keys role-specialized replicas may differ in: pool CAPACITY
# (and therefore its byte mirror).  Everything else — page size, context
# width, total length, quantization, spec reserve, adapter-store layout —
# is geometry: a mismatch there would corrupt a migrated page or bounce a
# requeued clone, so it stays a hard error even under roles.
CAPACITY_KEYS = frozenset({"kv_pages", "kv_page_bytes", "adapter_pages"})

# excluded alongside capacity: the live weights version is about which
# params fill the compiled envelope, not the envelope itself — a
# mixed-version fleet mid-rolling-update stays role-compatible
_VERSION_KEYS = frozenset({"weights_version"})


def role_envelope(desc: dict) -> dict:
    """The role-compatibility view of a replica's ``describe()``: the
    compiled-envelope facts with the capacity (and live-weights version)
    keys removed."""
    return {k: v for k, v in desc.items()
            if k not in CAPACITY_KEYS and k not in _VERSION_KEYS}


def role_compatible(a: dict, b: dict) -> bool:
    """Whether two ``describe()`` dicts may share a disaggregated fleet —
    identical everywhere except (possibly) capacity."""
    return role_envelope(a) == role_envelope(b)


def validate_role(role: str) -> str:
    if role not in ROLES:
        raise ValueError(f"unknown replica role {role!r} (known: {ROLES})")
    return role
