"""Memory ledger: per-subsystem device-byte accounting + OOM forensics
(counterpart of ``neuronx_distributed_tpu/obs/memory_ledger.py``).

Every consumer of the card's memory is sized blind: the parameters, the
KV page pool, the adapter pool, the draft model's contiguous caches and
each phase's workspace all carve the same 80 GB, and the first time their
sum is computed is the out-of-memory traceback.  :class:`MemoryLedger` is
the accounting:

- **logical accounting first** (works everywhere, the CPU included): each
  subsystem reports its bytes (``set``/``account_tree``), exported live as
  ``mem/<subsystem>_bytes`` gauges with ``mem/<subsystem>_peak_bytes``
  watermarks -- pool sizes are the same ``page_bytes`` arithmetic the
  admission gates use, so the gauges' sum IS the sizing model;
- **device truth on the card**: :meth:`poll_device` reads
  ``torch.cuda.memory_stats`` (allocated bytes now and at peak, reserved
  bytes) and ``torch.cuda.mem_get_info`` (free and total) into
  ``mem/device_*`` gauges.  What the allocator holds beyond the logical
  sum is reported as ``remainder_bytes``, not hidden: the CUDA graphs'
  private memory pools, activations and the allocator's cache belong to
  no subsystem;
- **per-program workspace** from the compile ledger's measured stats: the
  largest temp allocation across programs is the ``workspace`` subsystem;
- **OOM forensics**: :meth:`oom_dump` turns a ``torch.cuda.
  OutOfMemoryError`` (or any exception that reads as memory exhaustion)
  into a ``memory_breakdown.json`` naming the biggest holders.

Ledger-off is allocation-free: every call site guards on
``memory_ledger is not None``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

from neuronx_distributed_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

MEMORY_BREAKDOWN_FILE = "memory_breakdown.json"
MEMORY_BREAKDOWN_SCHEMA = "memory_breakdown/1"

# substrings that mark an allocator exhaustion across backends (the CUDA
# caching allocator, host allocators, and the JAX package's markers) -- the
# signal that triggers the forensics dump
_OOM_MARKS = ("RESOURCE_EXHAUSTED", "RESOURCE EXHAUSTED", "Out of memory",
              "out of memory", "OOM", "Allocation failure")


def is_oom(exc: BaseException) -> bool:
    """Does this exception look like device-memory exhaustion?  A
    ``torch.cuda.OutOfMemoryError`` always does."""
    import torch

    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    text = f"{type(exc).__name__}: {exc}"
    return any(m in text for m in _OOM_MARKS)


def tree_bytes(tree: Any) -> int:
    """Total tensor bytes across a nested structure: tensors, sequences,
    dicts (their values) and ``nn.Module`` parameters and buffers.  A
    tensor met twice (a tied weight, the same pool in two places) counts
    once."""
    import torch

    seen, total, stack = set(), 0, [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.nn.Module):
            stack.extend(x.parameters())
            stack.extend(x.buffers())
        elif isinstance(x, torch.Tensor):
            key = (x.device, x.data_ptr(), x.numel(), x.dtype)
            if key not in seen:
                seen.add(key)
                total += x.numel() * x.element_size()
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    return total


class MemoryLedger:
    """Per-subsystem byte accounting with live gauges, peak watermarks,
    device polling, and the OOM breakdown dump.

    ``registry`` (an ``obs.MetricRegistry``) receives ``mem/*`` gauges;
    ``path`` is the default ``memory_breakdown.json`` location for
    :meth:`dump` / :meth:`oom_dump`; ``device`` is the card
    :meth:`poll_device` reads (None: the current CUDA device when there is
    one, else no device truth).  All optional and attachable late.
    """

    def __init__(self, registry: Any = None, path: Optional[str] = None,
                 wall=time.time, device: Any = None):
        self.registry = registry
        self.path = path
        self.device = device
        self._wall = wall
        # name -> {"bytes": int, "peak_bytes": int}
        self._sub: Dict[str, dict] = {}
        # program family -> {"temp_size_in_bytes": .., "output_...": ..}
        self.programs: Dict[str, dict] = {}
        self._device: Optional[dict] = None

    # -- accounting --------------------------------------------------------

    def set(self, subsystem: str, nbytes: int) -> None:
        """Set a subsystem's current bytes; peaks are tracked and both are
        exported as gauges when a registry is attached."""
        nbytes = int(nbytes)
        s = self._sub.get(subsystem)
        if s is None:
            s = {"bytes": 0, "peak_bytes": 0}
            self._sub[subsystem] = s
        s["bytes"] = nbytes
        s["peak_bytes"] = max(s["peak_bytes"], nbytes)
        reg = self.registry
        if reg is not None:
            reg.gauge(f"mem/{subsystem}_bytes").set(float(nbytes))
            reg.gauge(f"mem/{subsystem}_peak_bytes").set(
                float(s["peak_bytes"]))

    def add(self, subsystem: str, nbytes: int) -> None:
        """Adjust a subsystem by a delta (pools that grow/shrink)."""
        cur = self._sub.get(subsystem, {"bytes": 0})["bytes"]
        self.set(subsystem, cur + int(nbytes))

    def account_tree(self, subsystem: str, tree: Any) -> int:
        """Account a pytree's array bytes as a subsystem; returns them."""
        n = tree_bytes(tree)
        self.set(subsystem, n)
        return n

    def note_program(self, family: str, info: dict) -> None:
        """Per-program temp/output bytes from the compile ledger's
        ``memory_analysis`` stats; the max temp across programs becomes
        the ``workspace`` subsystem (the transient HBM one step needs on
        top of the resident pools)."""
        keep = {k: float(v) for k, v in info.items()
                if k in ("argument_size_in_bytes", "output_size_in_bytes",
                         "temp_size_in_bytes") and v is not None}
        if not keep:
            return
        prev = self.programs.get(family, {})
        self.programs[family] = {
            k: max(keep.get(k, 0.0), prev.get(k, 0.0))
            for k in set(keep) | set(prev)}
        workspace = max((p.get("temp_size_in_bytes", 0.0)
                         for p in self.programs.values()), default=0.0)
        if workspace:
            self.set("workspace", int(workspace))

    # -- device truth ------------------------------------------------------

    def poll_device(self) -> Optional[dict]:
        """Device-memory truth from the CUDA caching allocator
        (``torch.cuda.memory_stats``: ``allocated_bytes.all.current`` as
        ``device_bytes_in_use``, ``.peak`` as ``device_peak_bytes``,
        ``reserved_bytes.all.current`` as ``device_reserved_bytes``) and
        the driver (``torch.cuda.mem_get_info``: ``device_free_bytes`` and
        ``device_bytes_limit``, the card's total).  Exports ``mem/device_*``
        gauges and remembers the snapshot for :meth:`breakdown`.  None on
        a CPU device or without CUDA: the accounting stays logical."""
        import torch

        dev = self.device
        if dev is None:
            if not torch.cuda.is_available():
                return None
            dev = torch.device("cuda", torch.cuda.current_device())
        dev = torch.device(dev)
        if dev.type != "cuda":
            return None
        stats = torch.cuda.memory_stats(dev)
        free, total = torch.cuda.mem_get_info(dev)
        out: Dict[str, float] = {
            "device_bytes_in_use": float(
                stats.get("allocated_bytes.all.current", 0)),
            "device_peak_bytes": float(
                stats.get("allocated_bytes.all.peak", 0)),
            "device_reserved_bytes": float(
                stats.get("reserved_bytes.all.current", 0)),
            "device_free_bytes": float(free),
            "device_bytes_limit": float(total),
        }
        reg = self.registry
        if reg is not None:
            for name, v in out.items():
                reg.gauge(f"mem/{name}").set(v)
        self._device = out
        return out

    def headroom_bytes(self) -> Optional[int]:
        """Bytes a new allocation can still get, from the last poll: the
        driver's free memory plus what the caching allocator reserved and
        holds unallocated.  None without a device poll (callers fall back
        to their pool's logical free bytes)."""
        d = self._device
        if not d:
            return None
        return int(d["device_free_bytes"] + d["device_reserved_bytes"]
                   - d["device_bytes_in_use"])

    @property
    def remainder_bytes(self) -> Optional[int]:
        """Allocated device bytes no subsystem accounts for (the CUDA
        graphs' private pools, activations, workspaces): device minus the
        logical sum, from the last poll; None without one."""
        d = self._device
        if not d:
            return None
        return int(d["device_bytes_in_use"]) - self.total_bytes

    # -- views -------------------------------------------------------------

    @property
    def total_bytes(self) -> int:
        return sum(s["bytes"] for s in self._sub.values())

    @property
    def peak_total_bytes(self) -> int:
        return sum(s["peak_bytes"] for s in self._sub.values())

    def subsystems(self) -> Dict[str, dict]:
        return {k: dict(v) for k, v in self._sub.items()}

    def top(self, n: int = 5) -> List[list]:
        """The biggest holders, descending — what the OOM log line names."""
        ranked = sorted(self._sub.items(), key=lambda kv: -kv[1]["bytes"])
        return [[name, s["bytes"]] for name, s in ranked[:n]]

    def breakdown(self, reason: str = "snapshot") -> dict:
        """The ``memory_breakdown.json`` document (``obs.schemas`` kind
        ``memory_breakdown``)."""
        return {
            "schema": MEMORY_BREAKDOWN_SCHEMA,
            "time": self._wall(),
            "reason": reason,
            "subsystems": self.subsystems(),
            "total_bytes": self.total_bytes,
            "peak_total_bytes": self.peak_total_bytes,
            "device": self._device,
            "remainder_bytes": self.remainder_bytes,
            "programs": {k: dict(v) for k, v in self.programs.items()},
            "top": self.top(),
        }

    # -- persistence -------------------------------------------------------

    def dump(self, path: Optional[str] = None,
             reason: str = "snapshot") -> Optional[str]:
        """Atomically write the breakdown document; returns the path (None
        when the ledger has no sink)."""
        path = path or self.path
        if path is None:
            return None
        doc = self.breakdown(reason)
        parent = os.path.dirname(os.path.abspath(path))
        if parent:
            os.makedirs(parent, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, path)
        return path

    def oom_dump(self, exc: BaseException,
                 path: Optional[str] = None) -> Optional[str]:
        """Out-of-memory forensics: when ``exc`` looks like memory
        exhaustion, poll the device one last time, dump the breakdown, and
        log the biggest holders.  Returns the dump path, or None when the
        exception is not an OOM (or the ledger has no sink)."""
        if not is_oom(exc):
            return None
        try:
            self.poll_device()
        except Exception:  # the device may be unusable mid-OOM
            pass
        holders = ", ".join(
            f"{name}={nbytes / 2**20:.1f}MiB" for name, nbytes in self.top())
        logger.error(
            "memory ledger: OOM (%s); biggest holders: %s (logical total "
            "%.1f MiB)", type(exc).__name__, holders or "none accounted",
            self.total_bytes / 2**20)
        try:
            return self.dump(path, reason=f"oom:{type(exc).__name__}")
        except OSError as e:  # forensics must never mask the real error
            logger.warning("memory ledger: OOM dump failed: %s", e)
            return None


def read_memory_breakdown(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    if doc.get("schema") != MEMORY_BREAKDOWN_SCHEMA:
        raise ValueError(f"{path}: schema {doc.get('schema')!r} != "
                         f"{MEMORY_BREAKDOWN_SCHEMA!r}")
    return doc
