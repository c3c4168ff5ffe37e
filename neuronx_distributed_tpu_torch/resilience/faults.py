"""Deterministic fault injection (counterpart of
``neuronx_distributed_tpu/resilience/faults.py``).

Code paths carry named fault points: ``fault_point(name, **ctx)`` for
control-flow faults and ``perturb(name, value, **ctx)`` for value faults.
With no plan installed each hook is one global read: no device sync, no
kernel.  A plan is installed with :func:`install_plan` or through the
``NXD_FAULT_PLAN`` environment variable (a path to a JSON file, or inline
JSON), read on the first hook hit, so a child process can be faulted
without any change to its code.

A plan is ``{"faults": [spec, ...]}``; each spec::

    {
      "point":  "serving/prefill_chunk",  # fault-point name (exact match)
      "action": "exception",              # kill | exception | sigterm |
                                          #   sleep | nan
      "match":  {"request_id": 0},        # optional: every key must equal
                                          #   the call site's ctx value (a
                                          #   key the site lacks never
                                          #   matches)
      "count":  1,                        # most fires (default 1; 0 = no
                                          #   limit)
      "hit":    1,                        # fire from the Nth matching hit
      "exit_code": 43,                    # kill
      "message": "...",                   # exception
      "seconds": 2.0,                     # sleep
      "slot": 1,                          # nan on an array: poison row slot
    }

Actions: ``kill`` is ``os._exit(exit_code)`` (default
:data:`KILL_EXIT_CODE`); ``exception`` raises :class:`InjectedFault`;
``sigterm`` signals the process itself; ``sleep`` stalls; ``nan`` (perturb
points) returns a NaN copy of the value, whole or row ``slot`` only --
never the value itself, so a CUDA graph's static output buffer is left as
it was.  Every fired fault is logged and appended to
:func:`fired_events`.

Fault points of the port: ``serving/page_alloc`` (between the prompt and
decode page allocations), ``serving/prefill_chunk`` (before each chunk
dispatch), ``tenancy/adapter_load`` (inside the adapter store's
transactional acquire), and the perturb points
``serving/{prefill,decode,draft,verify}_logits``.
"""

from __future__ import annotations

import json
import math
import os
import signal
import time
from typing import Any, Dict, List, Optional

from neuronx_distributed_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

ENV_VAR = "NXD_FAULT_PLAN"
KILL_EXIT_CODE = 43  # distinctive: tests can tell the kill from a crash

_ACTIONS = ("kill", "exception", "sigterm", "sleep", "nan")
_RESERVED = {"point", "action", "match", "count", "hit", "exit_code",
             "message", "seconds", "slot"}


class InjectedFault(RuntimeError):
    """The exception an ``action: exception`` spec raises."""


class FaultPlan:
    """A parsed plan with per-spec hit and fire counters, which decide
    which call of a point fires."""

    def __init__(self, specs: List[dict]):
        self.specs = []
        for i, spec in enumerate(specs):
            if "point" not in spec:
                raise ValueError(f"fault spec {i} has no 'point': {spec}")
            action = spec.get("action")
            if action not in _ACTIONS:
                raise ValueError(
                    f"fault spec {i} ({spec.get('point')}): unknown action "
                    f"{action!r} (known: {_ACTIONS})")
            unknown = set(spec) - _RESERVED
            if unknown:
                raise ValueError(
                    f"fault spec {i} ({spec['point']}): unknown keys "
                    f"{sorted(unknown)} -- conditions go under 'match'")
            self.specs.append({**spec, "_hits": 0, "_fires": 0})

    @staticmethod
    def from_json(obj: "str | dict | list") -> "FaultPlan":
        if isinstance(obj, str):
            obj = json.loads(obj)
        if isinstance(obj, list):
            obj = {"faults": obj}
        return FaultPlan(list(obj.get("faults", [])))

    @staticmethod
    def from_env() -> Optional["FaultPlan"]:
        raw = os.environ.get(ENV_VAR)
        if not raw:
            return None
        if raw.lstrip().startswith(("{", "[")):
            return FaultPlan.from_json(raw)
        with open(raw) as f:
            return FaultPlan.from_json(f.read())

    def _matches(self, spec: dict, point: str, ctx: Dict[str, Any]) -> bool:
        if spec["point"] != point:
            return False
        return all(key in ctx and ctx[key] == want
                   for key, want in spec.get("match", {}).items())

    def fire(self, point: str, value: Any, ctx: Dict[str, Any]) -> Any:
        """Run every matching spec's action; returns the (possibly
        poisoned) value."""
        for spec in self.specs:
            if not self._matches(spec, point, ctx):
                continue
            spec["_hits"] += 1
            if spec["_hits"] < int(spec.get("hit", 1)):
                continue
            count = int(spec.get("count", 1))
            if count and spec["_fires"] >= count:
                continue
            spec["_fires"] += 1
            value = _execute(spec, point, value, ctx)
        return value


def _execute(spec: dict, point: str, value: Any, ctx: Dict[str, Any]) -> Any:
    action = spec["action"]
    record = {"point": point, "action": action, "time": time.time(),
              "ctx": {k: v for k, v in ctx.items()
                      if isinstance(v, (int, float, str, bool))}}
    _FIRED.append(record)
    # logged before acting: a kill still leaves the evidence
    logger.warning("faults: fired %s action=%s ctx=%s", point, action,
                   record["ctx"])
    if action == "kill":
        os._exit(int(spec.get("exit_code", KILL_EXIT_CODE)))
    if action == "exception":
        raise InjectedFault(spec.get("message", f"injected fault at {point}"))
    if action == "sigterm":
        os.kill(os.getpid(), signal.SIGTERM)
        return value
    if action == "sleep":
        time.sleep(float(spec.get("seconds", 1.0)))
        return value
    return _poison(value, spec)


def _poison(value: Any, spec: dict) -> Any:
    """A NaN copy of ``value``: a scalar whole, an array or tensor whole or
    only row ``spec["slot"]``.  The input is never written."""
    if value is None:
        return value
    if isinstance(value, (int, float)):
        return float("nan")
    row = int(spec["slot"]) if "slot" in spec else None
    if hasattr(value, "clone"):  # torch.Tensor
        out = value.clone() if value.is_floating_point() else value.float()
        if row is not None and out.dim() >= 1:
            out[row] = math.nan
        else:
            out.fill_(math.nan)
        return out
    if hasattr(value, "shape"):  # numpy
        import numpy as np

        out = np.array(value, copy=True,
                       dtype=np.result_type(value, np.float32))
        if row is not None and out.ndim >= 1:
            out[row] = np.nan
        else:
            out[...] = np.nan
        return out
    return float("nan")


# -- module state ------------------------------------------------------------

_UNREAD = object()  # NXD_FAULT_PLAN not read yet
_PLAN: Any = _UNREAD  # a FaultPlan, None (no plan) or _UNREAD
_FIRED: List[dict] = []


def install_plan(plan: "FaultPlan | dict | str | None") -> Optional[FaultPlan]:
    """Install (or with None clear) the process-wide plan; an explicit
    install overrides ``NXD_FAULT_PLAN``."""
    global _PLAN
    _PLAN = None if plan is None else (
        plan if isinstance(plan, FaultPlan) else FaultPlan.from_json(plan))
    return _PLAN


def clear_plan() -> None:
    """Remove any plan, forget the fired events and read
    ``NXD_FAULT_PLAN`` again at the next hook hit."""
    global _PLAN
    _PLAN = _UNREAD
    _FIRED.clear()


def active_plan() -> Optional[FaultPlan]:
    """The installed plan, loading ``NXD_FAULT_PLAN`` on first use."""
    global _PLAN
    if _PLAN is _UNREAD:
        try:
            _PLAN = FaultPlan.from_env()
        except Exception as e:  # a broken plan is loud, never silent
            logger.error("faults: failed to load %s: %s", ENV_VAR, e)
            raise
        if _PLAN is not None:
            logger.warning("faults: plan loaded from %s (%d specs)",
                           ENV_VAR, len(_PLAN.specs))
    return _PLAN


def fired_events() -> List[dict]:
    """Every fault fired in this process, oldest first."""
    return list(_FIRED)


def fault_point(point: str, **ctx) -> None:
    """Control-flow hook: nothing without a plan; else may kill the
    process, raise :class:`InjectedFault`, send SIGTERM or sleep."""
    plan = _PLAN
    if plan is None:
        return
    if plan is _UNREAD:
        plan = active_plan()
        if plan is None:
            return
    plan.fire(point, None, ctx)


def perturb(point: str, value: Any, **ctx) -> Any:
    """Value hook: ``value`` itself without a plan; a matching ``nan`` spec
    returns a poisoned copy (other actions act as in :func:`fault_point`
    and return ``value``)."""
    plan = _PLAN
    if plan is None:
        return value
    if plan is _UNREAD:
        plan = active_plan()
        if plan is None:
            return value
    return plan.fire(point, value, ctx)
