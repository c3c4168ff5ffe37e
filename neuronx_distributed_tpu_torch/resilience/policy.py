"""Anomaly response policies: detections become actions inside ``fit``
(counterpart of ``neuronx_distributed_tpu/resilience/policy.py``).

- **skip**: a NaN or spiking step's update is discarded: the pre-step
  parameters and optimizer state are restored (one device copy of both a
  step while armed), the batch counts as consumed, training goes on;
- **rollback**: the newest checkpoint is reloaded and the step counter
  (and with it the step-indexed data) rewinds; needs step-indexed
  ``data(step)`` and a ``ckpt_dir`` (``fit`` writes an initial checkpoint
  when there is none);
- **halt**: :class:`PolicyHalt` is raised for the supervisor to classify
  and restart.

Both corrective actions are budgeted (``max_skips`` / ``max_rollbacks``);
an exhausted budget raises :class:`RetriesExhausted`.  A step-latency
watchdog (:class:`StepWatchdog`) warns or halts on steps slower than
``factor`` times the trailing median (and ``min_excess_s`` slower).
Detection reuses the flight recorder's detectors
(:mod:`..obs.flight`) over the policy's own history, so a policy works with
or without an ``obs=`` hub.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional

from neuronx_distributed_tpu_torch.obs.flight import (
    LossSpikeDetector,
    NanLossDetector,
    ThroughputRegressionDetector,
)
from neuronx_distributed_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

_ACTIONS = ("none", "skip", "rollback", "halt")


class PolicyHalt(RuntimeError):
    """Raised when a policy decides the process must die (supervisor's cue)."""


class RetriesExhausted(PolicyHalt):
    """A corrective action's budget ran out — escalate instead of looping."""


@dataclasses.dataclass(frozen=True)
class PolicyDecision:
    """One corrective decision: what to do, why, and the detector message."""

    action: str   # "skip" | "rollback" | "halt" | "warn"
    reason: str   # "nan_loss" | "loss_spike" | "watchdog"
    step: int
    message: str


@dataclasses.dataclass(frozen=True)
class AnomalyPolicy:
    """Declarative response policy ``fit(policy=...)`` consumes.

    ``on_nan`` / ``on_spike`` pick the action per detection
    (``"none" | "skip" | "rollback" | "halt"``).  Budgets are per-``fit``
    call.  ``watchdog_factor > 0`` arms the step-latency watchdog
    (``on_watchdog``: ``"warn"`` or ``"halt"``)."""

    on_nan: str = "skip"
    on_spike: str = "none"
    spike_window: int = 32
    spike_z: float = 6.0
    spike_min_history: int = 8
    max_skips: int = 8
    max_rollbacks: int = 2
    watchdog_factor: float = 0.0  # 0 disables
    watchdog_min_excess_s: float = 1.0
    watchdog_min_history: int = 8
    on_watchdog: str = "warn"

    def __post_init__(self):
        for name in ("on_nan", "on_spike"):
            if getattr(self, name) not in _ACTIONS:
                raise ValueError(f"{name} must be one of {_ACTIONS}, "
                                 f"got {getattr(self, name)!r}")
        if self.on_watchdog not in ("warn", "halt"):
            raise ValueError(f"on_watchdog must be 'warn' or 'halt', "
                             f"got {self.on_watchdog!r}")

    @property
    def wants_snapshot(self) -> bool:
        """True when any armed action needs a pre-step params/opt copy."""
        return "skip" in (self.on_nan, self.on_spike)

    @property
    def wants_rollback(self) -> bool:
        return "rollback" in (self.on_nan, self.on_spike)


class StepWatchdog:
    """Trailing-median step-latency watchdog (the actionable twin of
    ``ThroughputRegressionDetector``): ``check(step, step_time_s)`` returns a
    message when the step is ``factor``× slower than the trailing median AND
    at least ``min_excess_s`` absolutely slower."""

    def __init__(self, factor: float = 3.0, min_excess_s: float = 1.0,
                 window: int = 32, min_history: int = 8):
        self._det = ThroughputRegressionDetector(
            window=window, factor=factor, min_history=min_history,
            min_excess_s=min_excess_s)
        self._history: Deque[dict] = deque(maxlen=window)
        self.strikes = 0

    def check(self, step: int, step_time_s: float) -> Optional[str]:
        rec = {"step": step, "step_time_s": step_time_s}
        msg = self._det.check(rec, self._history)
        self._history.append(rec)
        if msg:
            self.strikes += 1
        return msg


class PolicyEngine:
    """The per-``fit``-call runtime of an :class:`AnomalyPolicy`: detector
    state, budgets, and the event log.  ``decide()`` is called once per step
    with host floats; the caller executes the returned decision."""

    def __init__(self, policy: AnomalyPolicy, registry=None):
        self.policy = policy
        self.registry = registry  # obs.MetricRegistry or None
        self._nan = NanLossDetector()
        self._spike = LossSpikeDetector(
            window=policy.spike_window, z_threshold=policy.spike_z,
            min_history=policy.spike_min_history)
        self._history: Deque[dict] = deque(maxlen=max(policy.spike_window, 8))
        self.watchdog = (
            StepWatchdog(factor=policy.watchdog_factor,
                         min_excess_s=policy.watchdog_min_excess_s,
                         min_history=policy.watchdog_min_history)
            if policy.watchdog_factor > 0 else None)
        self.skips = 0
        self.rollbacks = 0
        self.events: List[dict] = []

    # -- bookkeeping -------------------------------------------------------

    def _count(self, name: str) -> None:
        if self.registry is not None:
            self.registry.counter(f"resilience/{name}_total").inc()

    def _event(self, decision: PolicyDecision) -> PolicyDecision:
        self.events.append(dataclasses.asdict(decision))
        logger.warning("policy: %s at step %d (%s): %s", decision.action,
                       decision.step, decision.reason, decision.message)
        return decision

    def _resolve(self, action: str, reason: str, step: int,
                 message: str) -> Optional[PolicyDecision]:
        if action == "none":
            return None
        if action == "skip":
            if self.skips >= self.policy.max_skips:
                raise RetriesExhausted(
                    f"step {step}: {reason} ({message}) but the skip budget "
                    f"({self.policy.max_skips}) is exhausted")
            self.skips += 1
            self._count("skipped_updates")
            return self._event(PolicyDecision("skip", reason, step, message))
        if action == "rollback":
            if self.rollbacks >= self.policy.max_rollbacks:
                raise RetriesExhausted(
                    f"step {step}: {reason} ({message}) but the rollback "
                    f"budget ({self.policy.max_rollbacks}) is exhausted")
            self.rollbacks += 1
            self._count("rollbacks")
            return self._event(PolicyDecision("rollback", reason, step, message))
        # halt
        self._count("halts")
        self._event(PolicyDecision("halt", reason, step, message))
        raise PolicyHalt(f"step {step}: {reason}: {message}")

    # -- the per-step decision --------------------------------------------

    def decide(self, step: int, loss: float,
               grad_norm: Optional[float] = None,
               step_time_s: Optional[float] = None
               ) -> Optional[PolicyDecision]:
        """Returns the corrective decision for this step, or None.  Raises
        :class:`PolicyHalt` / :class:`RetriesExhausted` when the policy
        escalates.  The anomalous record enters detector history only when NO
        corrective action fires (a skipped/rolled-back step never happened as
        far as the trailing statistics are concerned)."""
        rec = {"step": step, "loss": loss}
        if grad_norm is not None:
            rec["grad_norm"] = grad_norm

        decision = None
        msg = self._nan.check(rec, self._history)
        if msg:
            decision = self._resolve(self.policy.on_nan, "nan_loss", step, msg)
        else:
            msg = self._spike.check(rec, self._history)
            if msg:
                decision = self._resolve(
                    self.policy.on_spike, "loss_spike", step, msg)

        if decision is None and self.watchdog is not None \
                and step_time_s is not None:
            wmsg = self.watchdog.check(step, step_time_s)
            if wmsg:
                self._count("watchdog_strikes")
                if self.policy.on_watchdog == "halt":
                    self._event(PolicyDecision("halt", "watchdog", step, wmsg))
                    raise PolicyHalt(f"step {step}: watchdog: {wmsg}")
                decision = self._event(
                    PolicyDecision("warn", "watchdog", step, wmsg))

        if decision is None or decision.action == "warn":
            self._history.append(rec)
        return decision
