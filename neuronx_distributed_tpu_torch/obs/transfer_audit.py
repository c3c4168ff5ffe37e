"""Transfer audit: make the serving hot path's no-sync invariant enforceable
(counterpart of ``neuronx_distributed_tpu/obs/transfer_audit.py``).

The async decode loop promises a transfer discipline: inside a steady step
every host↔device crossing is *explicit* -- the step's inputs go up in the
engine's one packed put, its tokens and flags come down in one packed
fetch -- and nothing waits for the card implicitly (a stray ``.item()``,
``.cpu()`` or ``torch.tensor(x, device="cuda")`` is a full device drain).
This module turns that promise into a checked contract:

- :meth:`TransferAudit.section` wraps a hot region.  ``mode="forbid"`` on a
  CUDA device runs it under ``torch.cuda.set_sync_debug_mode("error")``, so
  any synchronizing call inside raises; the previous mode is restored in
  ``finally``, an exception inside included;
- :meth:`TransferAudit.fetch` / :meth:`TransferAudit.put` are the
  sanctioned crossings.  They wrap the engine's packed staging (the pinned
  buffers and events of ``serving.engine._Staging``) and add no copy: the
  fetch lifts the guard around its own wait on the copy's event and
  restores it, counts ``transfer/explicit_fetches_total`` and times the
  host's wait into ``transfer/fetch_wait_ms`` (and ``<label>/host_blocked_ms``
  when labelled); the put counts ``transfer/explicit_puts_total``.

Backend difference (why ``forbid`` + counting, not counting alone):
``set_sync_debug_mode`` is a CUDA setting.  On a CPU device there is no
asynchronous copy to forbid and no sync to detect, so ``forbid`` counts its
sections and enforces nothing; the discipline is then held by accounting
alone (exactly N explicit fetches and puts).  The mode is process-global,
not per thread: a thread that runs while a section is open (the metrics
server) must never touch CUDA.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Optional

import torch

MODES = ("off", "observe", "forbid")

# metric names (the obs.schemas.REGISTRY_METRICS contract)
FETCHES_TOTAL = "transfer/explicit_fetches_total"
PUTS_TOTAL = "transfer/explicit_puts_total"
FETCH_WAIT_MS = "transfer/fetch_wait_ms"
GUARDED_SECTIONS_TOTAL = "transfer/guarded_sections_total"


@contextlib.contextmanager
def allow_sync():
    """Lift an open ``forbid`` section's guard for a sanctioned wait or a
    one-time CUDA-graph capture, and restore it after.  Free when no guard
    is set."""
    if not torch.cuda.is_available() or torch.cuda.get_sync_debug_mode() == 0:
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


class TransferAudit:
    """Per-engine transfer accountant and optional sync guard.

    ``registry`` (an ``obs.MetricRegistry``) receives the counters and the
    host-blocked histograms; ``None`` keeps the audit free (the wait is
    still summed on :attr:`blocked_s`).  ``mode``:

    - ``"off"``: :meth:`section` is a no-op (fetch/put still count);
    - ``"observe"``: sections are counted, nothing is restricted;
    - ``"forbid"``: on a CUDA ``device`` sections run under
      ``set_sync_debug_mode("error")``: a synchronizing call inside raises
      ``RuntimeError``; the explicit fetch passes.  On the CPU sections are
      only counted.
    """

    def __init__(self, registry: Any = None, mode: str = "observe",
                 device: Any = None):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self.registry = registry
        self.mode = mode
        self._guard = (mode == "forbid" and device is not None
                       and torch.device(device).type == "cuda")
        self.blocked_s = 0.0   # cumulative host time spent inside fetch()
        self.sections = 0
        if registry is not None:
            from neuronx_distributed_tpu_torch.obs import MS_BUCKETS

            self._ms_buckets = MS_BUCKETS
            registry.counter(FETCHES_TOTAL)
            registry.counter(PUTS_TOTAL)
            registry.counter(GUARDED_SECTIONS_TOTAL)
            registry.histogram(FETCH_WAIT_MS, MS_BUCKETS)

    @contextlib.contextmanager
    def section(self, name: str):
        """Enter a guarded hot section; the section counter ticks in every
        mode but ``off``."""
        if self.mode == "off":
            yield
            return
        self.sections += 1
        if self.registry is not None:
            self.registry.counter(GUARDED_SECTIONS_TOTAL).inc()
        if not self._guard:
            yield
            return
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(prev)

    def fetch(self, staging: Any, handle: Any,
              label: Optional[str] = None) -> Any:
        """THE sanctioned device-to-host read: ``staging.wait(handle)`` on a
        copy :meth:`staging.fetch` started, with the guard lifted for the
        wait.  Observes the host's wait into ``transfer/fetch_wait_ms`` and,
        with ``label``, ``<label>/host_blocked_ms``."""
        t0 = time.perf_counter()
        with allow_sync():
            out = staging.wait(handle)
        self.note_fetch(time.perf_counter() - t0, label)
        return out

    def note_fetch(self, wait_s: float, label: Optional[str] = None) -> None:
        """Account one explicit fetch the caller made and timed itself."""
        self.blocked_s += wait_s
        if self.registry is not None:
            self.registry.counter(FETCHES_TOTAL).inc()
            self.registry.histogram(
                FETCH_WAIT_MS, self._ms_buckets).observe(wait_s * 1e3)
            if label is not None:
                self.registry.histogram(
                    f"{label}/host_blocked_ms",
                    self._ms_buckets).observe(wait_s * 1e3)

    def note_put(self) -> None:
        """Account one explicit put the caller made itself (a KV chain
        import)."""
        if self.registry is not None:
            self.registry.counter(PUTS_TOTAL).inc()

    def put(self, staging: Any, *arrays) -> Any:
        """The sanctioned host-to-device write: ``staging.put(*arrays)``,
        one packed copy from pinned memory, counted."""
        out = staging.put(*arrays)
        if self.registry is not None:
            self.registry.counter(PUTS_TOTAL).inc()
        return out
