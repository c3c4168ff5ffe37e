"""Request lifecycle for the continuous-batching serving engine (a copy of
``neuronx_distributed_tpu/serving/request.py`` without the fields of the
slices not yet ported: tenancy, preemption, tracing and live-weights
accounting).

A :class:`Request` enters QUEUED, moves to PREFILL when a slot is granted,
DECODE after its prompt's KV is in the pool, and ends in exactly one of
FINISHED (stop token / length), CANCELLED, TIMED_OUT or FAILED (its logits
went non-finite; only that request fails).  Transitions are validated.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, List, Optional, Sequence, Tuple


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    FINISHED = "finished"
    CANCELLED = "cancelled"
    TIMED_OUT = "timed_out"
    FAILED = "failed"


_TRANSITIONS = {
    RequestState.QUEUED: {RequestState.PREFILL, RequestState.CANCELLED,
                          RequestState.TIMED_OUT},
    RequestState.PREFILL: {RequestState.DECODE, RequestState.FINISHED,
                           RequestState.CANCELLED, RequestState.TIMED_OUT,
                           RequestState.FAILED},
    RequestState.DECODE: {RequestState.FINISHED, RequestState.CANCELLED,
                          RequestState.TIMED_OUT, RequestState.FAILED},
    RequestState.FINISHED: set(),
    RequestState.CANCELLED: set(),
    RequestState.TIMED_OUT: set(),
    RequestState.FAILED: set(),
}

TERMINAL_STATES = frozenset(s for s, nxt in _TRANSITIONS.items() if not nxt)

# priority classes, most-urgent first; within a class ordering is
# earliest-deadline-first (deadline-less requests FCFS behind every deadline)
PRIORITY_INTERACTIVE = "interactive"
PRIORITY_BATCH = "batch"
PRIORITIES = (PRIORITY_INTERACTIVE, PRIORITY_BATCH)


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampler knobs; ``temperature == 0`` is exact greedy."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0

    def __post_init__(self):
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")


@dataclasses.dataclass
class Request:
    """One serving request.  ``prompt_ids`` is the UNPADDED token list;
    ``deadline_s`` a relative budget from submission; ``stream_cb(request,
    token_id)`` fires once per generated token."""

    request_id: int
    prompt_ids: Sequence[int]
    max_new_tokens: int
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    stop_token_ids: Tuple[int, ...] = ()
    deadline_s: Optional[float] = None
    stream_cb: Optional[Callable[["Request", int], None]] = None
    priority: str = PRIORITY_INTERACTIVE

    # lifecycle (engine-owned)
    state: RequestState = RequestState.QUEUED
    generated: List[int] = dataclasses.field(default_factory=list)
    finish_reason: Optional[str] = None
    submit_time: Optional[float] = None
    prefill_time: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    intertoken_ms: List[float] = dataclasses.field(default_factory=list)
    decode_steps: int = 0
    prefill_chunks: int = 0  # chunked-prefill dispatches the request took
    # speculative decoding (engine-owned; zero on non-spec engines): draft
    # tokens proposed / accepted for THIS request -- verdict-level, so a
    # token accepted but clipped by the output budget still counts
    spec_proposed: int = 0
    spec_accepted: int = 0

    def __post_init__(self):
        self.prompt_ids = [int(t) for t in self.prompt_ids]
        if not self.prompt_ids:
            raise ValueError(f"request {self.request_id}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"request {self.request_id}: max_new_tokens must be >= 1, "
                f"got {self.max_new_tokens}")
        if self.priority not in PRIORITIES:
            raise ValueError(
                f"request {self.request_id}: priority must be one of "
                f"{PRIORITIES}, got {self.priority!r}")

    @property
    def prompt_len(self) -> int:
        return len(self.prompt_ids)

    @property
    def done(self) -> bool:
        return self.state in TERMINAL_STATES

    def transition(self, new_state: RequestState) -> None:
        if new_state not in _TRANSITIONS[self.state]:
            raise RuntimeError(
                f"request {self.request_id}: illegal transition "
                f"{self.state.value} -> {new_state.value}")
        self.state = new_state

    def expired(self, now: float) -> bool:
        """Whether the absolute deadline (``submit_time + deadline_s``) has
        passed."""
        return (self.deadline_s is not None and self.submit_time is not None
                and now - self.submit_time > self.deadline_s)

    def check_stop(self, token: int) -> Optional[str]:
        """Finish reason after appending ``token``, or None to keep going."""
        if token in self.stop_token_ids:
            return "stop_token"
        if len(self.generated) >= self.max_new_tokens:
            return "length"
        return None


@dataclasses.dataclass(frozen=True)
class RequestOutput:
    """Terminal snapshot handed to the caller: the generated tokens plus the
    latency decomposition (queue wait, TTFT, end-to-end)."""

    request_id: int
    state: str
    finish_reason: Optional[str]
    prompt_len: int
    token_ids: Tuple[int, ...]
    queue_ms: float
    ttft_ms: Optional[float]
    total_ms: float
    intertoken_ms: Tuple[float, ...] = ()
    priority: str = PRIORITY_INTERACTIVE
    deadline_s: Optional[float] = None
    decode_steps: int = 0
    prefill_chunks: int = 0
    spec_proposed: int = 0
    spec_accepted: int = 0

    @property
    def acceptance_rate(self) -> Optional[float]:
        """Accepted / proposed draft tokens; None when the engine never
        speculated for this request."""
        if not self.spec_proposed:
            return None
        return self.spec_accepted / self.spec_proposed

    @staticmethod
    def from_request(req: Request, now: float) -> "RequestOutput":
        if not req.done:
            raise ValueError(f"request {req.request_id} is not terminal "
                             f"({req.state.value})")
        submit = req.submit_time if req.submit_time is not None else now
        queue_end = req.prefill_time if req.prefill_time is not None else now
        return RequestOutput(
            request_id=req.request_id,
            state=req.state.value,
            finish_reason=req.finish_reason,
            prompt_len=req.prompt_len,
            token_ids=tuple(req.generated),
            queue_ms=max(queue_end - submit, 0.0) * 1e3,
            ttft_ms=((req.first_token_time - submit) * 1e3
                     if req.first_token_time is not None else None),
            total_ms=max(now - submit, 0.0) * 1e3,
            intertoken_ms=tuple(req.intertoken_ms),
            priority=req.priority,
            deadline_s=req.deadline_s,
            decode_steps=req.decode_steps,
            prefill_chunks=req.prefill_chunks,
            spec_proposed=req.spec_proposed,
            spec_accepted=req.spec_accepted,
        )
