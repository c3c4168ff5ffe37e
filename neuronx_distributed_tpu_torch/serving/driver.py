"""Workload drive loop for the serving engine (a copy of
``neuronx_distributed_tpu/serving/driver.py``).

The target only needs the admission surface:

- ``submit(request)`` — queue one request;
- ``step() -> [RequestOutput, ...]`` — one engine/fleet iteration;
- ``has_work`` — anything queued, active, or in flight;
- ``dump_flight(reason)`` (optional) — crash-evidence hook, called on an
  unhandled exception out of the drive loop before re-raising.

Pure host-side (numpy only — no jax): arrival-trace construction and the
replay loop are testable without compiling anything.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np

from neuronx_distributed_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


def poisson_arrivals(n: int, rate_hz: float,
                     rs: "np.random.RandomState") -> np.ndarray:
    """Arrival times (seconds from replay start) of a Poisson process at
    ``rate_hz`` requests/s: exponential inter-arrival gaps, first request at
    t=0 (the replay starts with work, not with dead air).  ``rate_hz=inf``
    (or any non-positive gap scale) degenerates to a burst — everything at
    t=0, the backlog-limited workload shape."""
    if n < 1:
        raise ValueError(f"need n >= 1 arrivals, got {n}")
    if not np.isfinite(rate_hz) or rate_hz <= 0:
        return np.zeros(n)
    gaps = rs.exponential(1.0 / rate_hz, size=n)
    return np.cumsum(gaps) - gaps[0]


def replay(target: Any, arrivals: Sequence[float], requests: Sequence[Any],
           on_output: Optional[Callable[[Any], None]] = None,
           clock: Callable[[], float] = time.monotonic,
           sleep: Callable[[float], None] = time.sleep,
           tracer: Any = None) -> Dict[int, Any]:
    """Replay an arrival trace through a live serving target: submit each
    request when its arrival time passes, stepping the target in between and
    sleeping only when idle ahead of the next arrival.  Returns
    ``{request_id: RequestOutput}`` keyed by the TARGET's ids — a router
    re-keys submissions to its globally-unique ids, so map back through
    ``router.client_id`` when the caller-chosen ids matter.  ``on_output``
    additionally fires per terminal request as it completes (streaming hooks
    ride on the requests themselves via ``stream_cb``).

    An unhandled exception out of the drive loop calls the target's
    ``dump_flight`` first (when it has one) — the serving twin of ``fit()``'s
    crash path: the last K steps become a persisted artifact instead of lost
    scrollback.

    ``tracer`` (an ``obs.tracing.Tracer``) wraps the whole drive in one
    ``drive/replay`` root span on the replay's clock; the per-request
    spans come from the target's own tracer (usually the same object)."""
    if len(arrivals) != len(requests):
        raise ValueError(
            f"arrivals ({len(arrivals)}) and requests ({len(requests)}) "
            "must pair up")
    outputs: Dict[int, Any] = {}
    t0 = clock()
    next_i = 0
    drive_span = (tracer.begin("drive/replay", t=clock(),
                               requests=len(requests))
                  if tracer is not None else None)
    try:
        while next_i < len(requests) or target.has_work:
            now = clock() - t0
            while next_i < len(requests) and arrivals[next_i] <= now:
                target.submit(requests[next_i])
                next_i += 1
            if target.has_work:
                for out in target.step():
                    outputs[out.request_id] = out
                    if on_output is not None:
                        on_output(out)
            elif next_i < len(requests):
                sleep(min(arrivals[next_i] - now, 0.05))
    except BaseException as e:
        if drive_span is not None:
            tracer.end(drive_span, t=clock(), crashed=type(e).__name__)
        # telemetry IO must never mask the real crash
        dump = getattr(target, "dump_flight", None)
        if dump is not None:
            try:
                dump(f"crash:{type(e).__name__}")
            except Exception as dump_err:
                logger.warning("serving: crash flight dump failed: %s",
                               dump_err)
        raise
    if drive_span is not None:
        tracer.end(drive_span, t=clock(), completed=len(outputs))
    return outputs


def percentiles(values: Sequence[float],
                ps: Sequence[int] = (50, 99)) -> Dict[str, Optional[float]]:
    """``{"p50": ..., "p99": ...}`` over ``values`` (None entries when
    empty) — the latency-summary shape every serving bench line shares."""
    if not values:
        return {f"p{p}": None for p in ps}
    arr = np.asarray(list(values), dtype=float)
    return {f"p{p}": float(np.percentile(arr, p)) for p in ps}


def summarize_outputs(outputs: Dict[int, Any], wall_s: float) -> dict:
    """The per-drive summary both benches and the runner print: request /
    finished counts, total tokens, TTFT and inter-token percentiles, goodput
    (FINISHED requests' tokens per wall second — partial generations from
    failed/cancelled/timed-out requests are work, not goodput)."""
    total_tokens = sum(len(o.token_ids) for o in outputs.values())
    good_tokens = sum(len(o.token_ids) for o in outputs.values()
                      if o.state == "finished")
    ttfts = [o.ttft_ms for o in outputs.values() if o.ttft_ms is not None]
    inter = [ms for o in outputs.values() for ms in o.intertoken_ms]
    return {
        "requests": len(outputs),
        "finished": sum(1 for o in outputs.values() if o.state == "finished"),
        "tokens": total_tokens,
        "ttft_ms": percentiles(ttfts),
        "intertoken_ms": percentiles(inter),
        "goodput_tok_s": good_tokens / max(wall_s, 1e-9),
        "wall_s": round(wall_s, 4),
    }
