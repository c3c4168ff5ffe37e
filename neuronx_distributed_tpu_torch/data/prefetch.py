"""Device-prefetch input pipeline (counterpart of
``neuronx_distributed_tpu/data/prefetch.py``): stage batch N+1..N+depth
onto the device while step N runs.

- A bounded background thread pulls from a step-indexed ``data(step)``
  (or an iterable, adapted) and stages each batch on ``device``.  On CUDA
  the batch's tensors go to pinned host memory and up with ``non_blocking``
  copies on a side stream; an event recorded after the copies travels with
  the batch, and :meth:`DevicePrefetcher.get` makes the consumer's stream
  wait on it (a device-side wait, never a host sync) and records the
  tensors on that stream for the caching allocator.  Nothing on this path
  blocks the host on the device, so it runs under the transfer audit's
  ``forbid`` guard (``torch.cuda.set_sync_debug_mode("error")``, which is
  process-global: the worker thread runs while the guard is up).
- Delivery is step-indexed and rewindable: ``get(step)`` returns exactly
  that step's batch, and a non-sequential step (a policy rollback) flushes
  the staged batches and restarts staging there.
- The queue-depth and staged-ahead gauges, the rewind and staged counters
  and the wait histogram land in the obs registry.
- ``close()`` (or the context manager) stops the worker and drops every
  staged batch; ``fit`` closes it on every exit path.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch

from neuronx_distributed_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

# metric names (the obs.schemas.REGISTRY_METRICS contract)
QUEUE_DEPTH = "data/prefetch_queue_depth"
STAGED_AHEAD = "data/prefetch_staged_ahead"
REWINDS_TOTAL = "data/prefetch_rewinds_total"
STAGED_TOTAL = "data/prefetch_batches_staged_total"
WAIT_MS = "data/prefetch_wait_ms"

_POLL_S = 0.05  # worker put / consumer get poll, so close and rewind never hang


def _map(fn, batch):
    if isinstance(batch, dict):
        return {k: _map(fn, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_map(fn, v) for v in batch)
    if isinstance(batch, (torch.Tensor, np.ndarray)):
        return fn(torch.as_tensor(batch))
    return batch


def _leaves(batch, out):
    if isinstance(batch, dict):
        for v in batch.values():
            _leaves(v, out)
    elif isinstance(batch, (list, tuple)):
        for v in batch:
            _leaves(v, out)
    elif isinstance(batch, torch.Tensor):
        out.append(batch)
    return out


class DevicePrefetcher:
    """Bounded background staging of ``source(step)`` batches onto
    ``device``.

    Args:
      source: ``source(step) -> host batch`` (a nested dict/list of numpy
        arrays or CPU tensors; rewindable) or an iterable of batches
        (delivered in order; cannot rewind).
      depth: how many batches may be staged ahead (2 = double buffering).
      device: where batches land (default CUDA); on the CPU they are only
        converted to tensors.
      registry: an ``obs.MetricRegistry`` for the gauges and counters.
      name: metric and thread-name prefix.

    ``get(step)`` blocks until that step's batch is staged (the wait is the
    pipeline's observed stall, ``data/prefetch_wait_ms``).  An exception
    from ``source`` (``StopIteration`` from an exhausted iterator included)
    surfaces on the ``get`` that would have consumed that step."""

    def __init__(self, source: "Callable[[int], Any] | Iterable[Any]", *,
                 depth: int = 2, device=None, registry: Any = None,
                 name: str = "data"):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        if callable(source):
            self._source = source
            self._rewindable = True
        else:
            it = iter(source)
            self._source = lambda step: next(it)
            self._rewindable = False
        self.depth = int(depth)
        self.device = torch.device("cuda" if device is None else device)
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._registry = registry
        self._name = name
        self._queue: "queue.Queue" = queue.Queue(maxsize=self.depth)
        self._lock = threading.Lock()
        self._gen = 0            # staging generation; a rewind bumps it
        self._thread: Optional[threading.Thread] = None
        self._next_out: Optional[int] = None  # the step get() serves next
        self._staged_to = 0      # worker progress (gauge only)
        self._closed = False
        self.rewinds = 0
        if registry is not None:
            from neuronx_distributed_tpu_torch.obs import MS_BUCKETS

            self._ms_buckets = MS_BUCKETS
            registry.gauge(QUEUE_DEPTH)
            registry.gauge(STAGED_AHEAD)
            registry.counter(REWINDS_TOTAL)
            registry.counter(STAGED_TOTAL)
            registry.histogram(WAIT_MS, MS_BUCKETS)

    # -- staging -------------------------------------------------------------

    def _stage(self, batch):
        """``(staged batch, event or None)``.  CUDA: pinned host copies, then
        ``non_blocking`` uploads on the side stream, then an event."""
        if not self._cuda:
            return _map(lambda t: t.to(self.device), batch), None
        pinned = _map(lambda t: t.pin_memory(), batch)
        with torch.cuda.stream(self._stream):
            staged = _map(lambda t: t.to(self.device, non_blocking=True),
                          pinned)
            event = torch.cuda.Event()
            event.record(self._stream)
        return staged, event

    # -- worker --------------------------------------------------------------

    def _stale(self, gen: int) -> bool:
        with self._lock:
            return self._closed or gen != self._gen

    def _offer(self, gen: int, item: tuple) -> bool:
        """A put that gives the item up when the generation went stale
        (rewind or close) instead of wedging on a full queue."""
        while True:
            if self._stale(gen):
                return False
            try:
                self._queue.put(item, timeout=_POLL_S)
                return True
            except queue.Full:
                continue

    def _worker(self, gen: int, start: int) -> None:
        step = start
        while not self._stale(gen):
            try:
                staged, event = self._stage(self._source(step))
            except BaseException as e:  # delivered to the consumer's get()
                self._offer(gen, (gen, step, None, None, e))
                return
            if not self._offer(gen, (gen, step, staged, event, None)):
                return
            with self._lock:
                self._staged_to = step + 1
            if self._registry is not None:
                self._registry.counter(STAGED_TOTAL).inc()
            step += 1

    # -- consumer ------------------------------------------------------------

    def _restart(self, step: int) -> None:
        """(Re)start staging at ``step``: bump the generation (the old worker
        sees it and exits), drop staged batches, start a worker."""
        with self._lock:
            was_running = self._thread is not None
            self._gen += 1
            gen = self._gen
            self._next_out = step
            self._staged_to = step
        self._drain()
        if was_running:
            self.rewinds += 1
            if self._registry is not None:
                self._registry.counter(REWINDS_TOTAL).inc()
            logger.info("prefetch[%s]: rewound staging to step %d",
                        self._name, step)
        self._thread = threading.Thread(
            target=self._worker, args=(gen, step),
            name=f"{self._name}-prefetch", daemon=True)
        self._thread.start()

    def _drain(self) -> None:
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                return

    def get(self, step: int) -> Any:
        """The staged batch for exactly ``step``: sequential calls stream
        from the pipeline, a non-sequential step (a rollback, or the first
        call fixing the start) rewinds or starts staging there.  On CUDA
        the current stream waits for the batch's uploads on the device."""
        if self._closed:
            raise RuntimeError(f"prefetch[{self._name}] is closed")
        if self._thread is None or step != self._next_out:
            if self._thread is not None and not self._rewindable:
                raise RuntimeError(
                    f"prefetch[{self._name}]: cannot rewind to step {step} "
                    f"(expected {self._next_out}): the source is an iterator "
                    "- rewinds need step-indexed data(step)")
            self._restart(step)
        t0 = time.perf_counter()
        while True:
            try:
                gen, s, staged, event, err = self._queue.get(timeout=_POLL_S)
            except queue.Empty:
                if self._thread is not None and not self._thread.is_alive() \
                        and self._queue.empty():
                    raise RuntimeError(
                        f"prefetch[{self._name}]: worker died without "
                        f"delivering step {step}")
                continue
            if gen == self._gen:
                break  # else staged before a rewind: stale, dropped
        wait_s = time.perf_counter() - t0
        if err is not None:
            raise err
        assert s == step, f"prefetch ordering bug: got {s}, wanted {step}"
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            for t in _leaves(staged, []):
                t.record_stream(consumer)
        self._next_out = step + 1
        if self._registry is not None:
            self._registry.gauge(QUEUE_DEPTH).set(self._queue.qsize())
            with self._lock:
                ahead = self._staged_to - (step + 1)
            self._registry.gauge(STAGED_AHEAD).set(max(ahead, 0))
            self._registry.histogram(WAIT_MS, self._ms_buckets).observe(
                wait_s * 1e3)
        return staged

    def close(self, timeout: float = 5.0) -> None:
        """Stop staging and join the worker.  Idempotent; afterwards the
        queue is empty and the thread gone."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._gen += 1
        self._drain()  # unblock a worker stuck in put
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
            if t.is_alive():  # pragma: no cover - source wedged in user code
                logger.warning("prefetch[%s]: worker did not stop in %.1fs",
                               self._name, timeout)
            self._thread = None
        self._drain()  # whatever the worker put while we were joining
        if self._registry is not None:
            self._registry.gauge(QUEUE_DEPTH).set(0)
            self._registry.gauge(STAGED_AHEAD).set(0)

    def __enter__(self) -> "DevicePrefetcher":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
