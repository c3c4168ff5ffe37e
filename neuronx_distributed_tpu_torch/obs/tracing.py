"""Request-lifecycle distributed tracing + the Chrome-trace timeline writer
(a copy of ``neuronx_distributed_tpu/obs/tracing.py``: the process index
comes from ``torch.distributed``, and :func:`device_trace` is a
``torch.profiler`` capture).

Two consumers share this module:

- :class:`Tracer` / :class:`Span` — the serving stack's per-request span
  tracer (vLLM-style OpenTelemetry-shaped lifecycle spans: queue → prefill
  chunks → decode steps → preemption gaps → failover hops).  Monotonic-
  clocked, ring-bounded, ZERO overhead when no tracer is attached (the
  engine's hot paths guard every call site on ``tracer is not None``; the
  module-level :data:`SPANS_CREATED` counter is the test hook that proves
  no span is ever allocated with tracing off).  Two exporters: a
  schema-checked ``trace_events.jsonl`` (one record per span, stamped with
  BOTH wall-clock ``ts`` and monotonic ``mono`` so cross-replica merges
  sort correctly under clock skew) and a Chrome-trace / Perfetto JSON
  file (one track per replica, one row per request).

- :class:`Timeline` — the trainer's host-side Chrome-trace event recorder
  (``utils/timeline.py`` re-exports it).  Both writers share one
  Chrome-trace serialization (:func:`write_chrome_trace` /
  :func:`append_chrome_events`), so a trainer timeline and a serving trace
  open in the same Perfetto UI with the same conventions.

Span model: a span has a ``name``, the fleet-global ``request_id`` it
belongs to (-1 for batch-level spans like one engine decode step), the
``replica`` that produced it (-1 off-fleet), monotonic ``t_start``/
``t_end`` seconds, an optional ``parent_id``, and a free-form ``attrs``
dict.  A request's trace STITCHES across replicas by ``request_id``: a
failover clone keeps the original global id and its spans carry a ``hop``
attr, so one ``trace_events.jsonl`` holds exactly one trace per request no
matter how many replicas served it.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, Iterable, List, Optional, Sequence

from neuronx_distributed_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

TRACE_EVENTS_FILE = "trace_events.jsonl"
TRACE_EVENT_SCHEMA = "trace_event/1"

# span phases the per-request waterfall is built from (obs.report): every
# other span name is informational detail underneath these
PHASE_NAMES = ("queue", "prefill", "decode", "preempted")

# module-level allocation counter: the tracer-off overhead test reads it
# around a full serving run and asserts it never moved — the "zero
# allocations in the hot path when off" contract, checkable without a
# profiler
SPANS_CREATED = 0


class Span:
    """One trace span.  Mutable until :meth:`Tracer.end` seals it into the
    ring; ``attrs`` is a plain dict serialized verbatim."""

    __slots__ = ("name", "span_id", "parent_id", "request_id", "replica",
                 "t_start", "t_end", "ts", "attrs")

    def __init__(self, name: str, span_id: int, parent_id: Optional[int],
                 request_id: int, replica: int, t_start: float, ts: float,
                 attrs: Dict[str, Any]):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.request_id = request_id
        self.replica = replica
        self.t_start = t_start
        self.t_end: Optional[float] = None
        self.ts = ts
        self.attrs = attrs

    @property
    def duration_ms(self) -> Optional[float]:
        if self.t_end is None:
            return None
        return (self.t_end - self.t_start) * 1e3

    def to_record(self) -> dict:
        """The ``trace_events.jsonl`` record (``obs.schemas`` kind
        ``trace_event``): both clocks on every span — ``ts`` (wall, a
        shared epoch for cross-host merges) and ``mono`` (the monotonic
        start, skew-free ordering within a host)."""
        return {
            "schema": TRACE_EVENT_SCHEMA,
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "request_id": self.request_id,
            "replica": self.replica,
            "t_start": self.t_start,
            "t_end": self.t_end if self.t_end is not None else self.t_start,
            "ts": self.ts,
            "mono": self.t_start,
            "attrs": self.attrs,
        }


class _TraceCore:
    """State shared by a :class:`Tracer` and its per-replica scopes: ONE
    ring, ONE span-id sequence, one pair of clocks."""

    __slots__ = ("spans", "capacity", "dropped", "seq", "lock", "clock",
                 "wall")

    def __init__(self, capacity: int, clock, wall):
        self.spans: deque = deque(maxlen=capacity)
        self.capacity = capacity
        self.dropped = 0
        self.seq = 0
        self.lock = threading.Lock()
        self.clock = clock
        self.wall = wall


class Tracer:
    """Ring-bounded span recorder.

    ``capacity`` bounds retained FINISHED spans (oldest dropped first, the
    flight-recorder discipline — a long-lived server's trace memory is a
    window, not a leak).  ``clock`` must be monotonic (span math never
    touches wall time); ``wall`` stamps each span's shared-epoch ``ts``.
    ``replica`` tags every span this handle creates; :meth:`scoped` derives
    a same-ring handle with a different replica tag, which is how one
    tracer follows a request across a whole in-process fleet.
    """

    def __init__(self, capacity: int = 65536, replica: int = -1,
                 clock=time.monotonic, wall=time.time, *, _core=None):
        if _core is None:
            if capacity < 1:
                raise ValueError(f"capacity must be >= 1, got {capacity}")
            _core = _TraceCore(capacity, clock, wall)
        self._core = _core
        self.replica = int(replica)

    def scoped(self, replica: int) -> "Tracer":
        """A handle over the SAME ring/sequence tagging spans with
        ``replica`` — hand one to each fleet replica's engine."""
        return Tracer(replica=replica, _core=self._core)

    # -- recording ---------------------------------------------------------

    def begin(self, name: str, request_id: int = -1,
              parent: "Optional[Span | int]" = None,
              t: Optional[float] = None, **attrs) -> Span:
        """Open a span (not yet in the ring — :meth:`end` seals it).
        ``t`` overrides the start instant (monotonic seconds) so adjacent
        phase spans can share one boundary timestamp exactly."""
        global SPANS_CREATED
        core = self._core
        with core.lock:
            core.seq += 1
            sid = core.seq
        SPANS_CREATED += 1
        pid = parent.span_id if isinstance(parent, Span) else parent
        return Span(name, sid, pid, int(request_id), self.replica,
                    core.clock() if t is None else t, core.wall(), attrs)

    def end(self, span: Optional[Span], t: Optional[float] = None,
            **attrs) -> Optional[Span]:
        """Seal a span into the ring (idempotent on None so call sites can
        ``tr.end(state.pop(...))`` without guards)."""
        if span is None:
            return None
        core = self._core
        span.t_end = core.clock() if t is None else t
        if span.t_end < span.t_start:  # clock injection misuse, not physics
            span.t_end = span.t_start
        if attrs:
            span.attrs.update(attrs)
        with core.lock:
            if len(core.spans) == core.capacity:
                core.dropped += 1
            core.spans.append(span)
        return span

    @contextmanager
    def span(self, name: str, request_id: int = -1,
             parent: "Optional[Span | int]" = None, **attrs):
        s = self.begin(name, request_id=request_id, parent=parent, **attrs)
        try:
            yield s
        finally:
            self.end(s)

    def instant(self, name: str, request_id: int = -1,
                parent: "Optional[Span | int]" = None,
                t: Optional[float] = None, **attrs) -> Span:
        """Zero-duration marker span."""
        s = self.begin(name, request_id=request_id, parent=parent, t=t,
                       **attrs)
        return self.end(s, t=s.t_start)

    # -- introspection -----------------------------------------------------

    def spans(self) -> List[Span]:
        """Finished spans, oldest first."""
        with self._core.lock:
            return list(self._core.spans)

    @property
    def dropped(self) -> int:
        return self._core.dropped

    def clear(self) -> None:
        with self._core.lock:
            self._core.spans.clear()
            self._core.dropped = 0

    # -- exporters ---------------------------------------------------------

    def export_jsonl(self, path: str) -> int:
        """Write one ``trace_event`` record per finished span; returns the
        record count.  The file is self-contained (overwrite, not append):
        a trace export is a snapshot artifact, like a flight dump."""
        spans = self.spans()
        if self.dropped:
            logger.warning(
                "tracing: ring dropped %d span(s) (capacity %d) — the "
                "exported trace window is truncated at the front",
                self.dropped, self._core.capacity)
        _ensure_parent_dir(path)
        with open(path, "w") as f:
            for s in spans:
                f.write(json.dumps(s.to_record()) + "\n")
        return len(spans)

    def export_chrome(self, path: str) -> int:
        """Write the Perfetto / ``chrome://tracing`` JSON view: pid =
        replica (one process track per replica), tid = request id (one row
        per request), complete "X" events on the monotonic clock."""
        spans = self.spans()
        events: List[dict] = []
        named: set = set()
        for s in spans:
            key = (s.replica, s.request_id)
            if key not in named:
                named.add(key)
                events.append({"ph": "M", "name": "thread_name",
                               "pid": s.replica, "tid": s.request_id & 0x7FFFFFFF,
                               "args": {"name": f"request {s.request_id}"}})
            events.append(span_to_chrome_event(s))
        for replica in sorted({s.replica for s in spans}):
            events.append({"ph": "M", "name": "process_name", "pid": replica,
                           "args": {"name": f"replica {replica}"
                                    if replica >= 0 else "serving"}})
        write_chrome_trace(path, events)
        return len(events)


def span_to_chrome_event(span: Span) -> dict:
    """One complete ("X") Chrome-trace event for a finished span."""
    t_end = span.t_end if span.t_end is not None else span.t_start
    return {
        "name": span.name,
        "cat": "serving",
        "ph": "X",
        "ts": span.t_start * 1e6,
        "dur": max(t_end - span.t_start, 0.0) * 1e6,
        "pid": span.replica,
        "tid": span.request_id & 0x7FFFFFFF,
        "args": {"request_id": span.request_id, "span_id": span.span_id,
                 "parent_id": span.parent_id, **span.attrs},
    }


def read_trace_events(path: str) -> List[dict]:
    """Parse a ``trace_events.jsonl`` file (blank lines skipped)."""
    out: List[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


# -- shared Chrome-trace serialization ---------------------------------------
#
# One writer discipline for both emitters (Timeline and Tracer): the
# Perfetto-tolerant JSON-array format — a "[" header, one object per line
# with a trailing comma, no closing bracket required — appendable without
# re-reading the file.

def _ensure_parent_dir(path: str) -> None:
    parent = os.path.dirname(os.path.abspath(path))
    if parent:
        os.makedirs(parent, exist_ok=True)


def append_chrome_events(path: str, events: Iterable[dict],
                         first_write: bool) -> None:
    """Append events to a Chrome-trace file, writing the array header on
    the first call."""
    with open(path, "w" if first_write else "a") as f:
        if first_write:
            f.write("[\n")
        for e in events:
            f.write(json.dumps(e) + ",\n")


def write_chrome_trace(path: str, events: Sequence[dict]) -> None:
    """Write a complete Chrome-trace file in one shot (overwrite)."""
    _ensure_parent_dir(path)
    append_chrome_events(path, events, first_write=True)


# -- trainer host timeline (historically utils/timeline.py) ------------------

def _dist():
    """``torch.distributed`` when a process group is up, else None."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist
    return None


def _process_index() -> int:
    dist = _dist()
    return dist.get_rank() if dist is not None else 0


def _process_count() -> int:
    dist = _dist()
    return dist.get_world_size() if dist is not None else 1


class Timeline:
    """Buffered Chrome trace-event recorder (the trainer's host-side task
    timeline — scheduler steps, checkpoint waves, data stalls).

    Events are complete ("X") records with microsecond timestamps; flushes
    are explicit (``mark_step_end``) so the hot loop never touches the
    filesystem — the same discipline as the reference's step-end gather.
    There is no per-rank gather: every process appends its own events
    tagged ``pid = process_index`` (the ``torch.distributed`` rank) to its
    own file (or one file when single-process), which Perfetto merges
    natively.
    """

    def __init__(self, trace_file_path: Optional[str], category: str = "host"):
        self.category = category
        self.enabled = trace_file_path is not None
        self._open_events: dict = {}
        self._buffer: list = []
        self._lock = threading.Lock()
        self._wrote_header = False
        if self.enabled:
            # one file per process: multi-host jobs on a shared filesystem
            # must not clobber each other's traces
            if _process_count() > 1:
                root, ext = os.path.splitext(trace_file_path)
                trace_file_path = (
                    f"{root}.proc{_process_index()}{ext or '.json'}")
            _ensure_parent_dir(trace_file_path)
        self.path = trace_file_path

    @staticmethod
    def _now_us() -> float:
        # wall clock (not perf_counter): cross-host merges need a shared
        # epoch, and NTP-synced wall time is the best host-side option
        return time.time_ns() / 1e3

    def mark_event_start(self, name: str) -> None:
        if not self.enabled:
            return
        with self._lock:
            # key by (name, thread): same-named regions may run concurrently
            # on prefetch/worker threads
            self._open_events[(name, threading.get_ident())] = self._now_us()

    def mark_event_end(self, name: str) -> None:
        if not self.enabled:
            return
        tid = threading.get_ident()
        with self._lock:
            start = self._open_events.pop((name, tid), None)
            if start is None:
                logger.warning("timeline: end without start for %r", name)
                return
            self._buffer.append(
                {
                    "name": name,
                    "cat": self.category,
                    "ph": "X",
                    "ts": start,
                    "dur": self._now_us() - start,
                    "pid": _process_index(),
                    "tid": tid % 2**31,
                }
            )

    @contextmanager
    def event(self, name: str):
        self.mark_event_start(name)
        try:
            yield
        finally:
            self.mark_event_end(name)

    def instant(self, name: str, **args) -> None:
        """Zero-duration marker (e.g. 'step boundary')."""
        if not self.enabled:
            return
        with self._lock:
            self._buffer.append(
                {
                    "name": name,
                    "cat": self.category,
                    "ph": "i",
                    "s": "p",
                    "ts": self._now_us(),
                    "pid": _process_index(),
                    "tid": 0,
                    "args": args,
                }
            )

    def mark_step_end(self, step: Optional[int] = None) -> None:
        """Flush buffered events to the trace file (JSON-array format that
        Perfetto accepts without a closing bracket)."""
        if not self.enabled:
            return
        if step is not None:
            self.instant("step_end", step=step)
        with self._lock:
            events, self._buffer = self._buffer, []
            if not events:
                return
            append_chrome_events(self.path, events,
                                 first_write=not self._wrote_header)
            self._wrote_header = True


DEVICE_TRACE_FILE = "device_trace.json"


@contextmanager
def device_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the enclosed region and export
    it as a Chrome trace, ``log_dir/device_trace.json`` (yields the
    profiler, so a caller can also read ``key_averages()``).

    With CUDA available the capture holds the CPU and CUDA activities:
    every kernel the region launches is an event on the device track.
    Without it, the CPU alone is profiled and the trace's metadata says so
    (``"device_trace": "cpu_only"``): a CPU run never passes for a device
    trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    try:
        with prof:
            prof.add_metadata("device_trace", "cuda" if cuda else "cpu_only")
            try:
                yield prof
            finally:
                if cuda:
                    torch.cuda.synchronize()
    finally:
        prof.export_chrome_trace(os.path.join(log_dir, DEVICE_TRACE_FILE))
