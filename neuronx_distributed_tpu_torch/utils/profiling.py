"""Cost reporting of one eager call (counterpart of
``neuronx_distributed_tpu/utils/profiling.py``).

The JAX package reads an executable's flops and bytes from XLA's
``cost_analysis()`` and its memory from ``memory_analysis()``.  PyTorch has
neither, so :func:`cost_report` runs the function once, eagerly, under a
counter (a ``TorchDispatchMode`` that sees every aten op):

- flops come from the formula registry of
  ``torch.utils.flop_counter.FlopCounterMode`` (matmuls, convolutions,
  attention);
- bytes count each byte of each distinct tensor storage once, the first
  time an op reads or writes it: the compulsory traffic.  Views move no
  data and count nothing; a view that an op reads counts the span it
  covers, not its whole storage.
- Indexing ops are the exception: ``embedding``, ``index``,
  ``index_select`` and ``gather`` count the elements they read, and the
  in-place ``index_put_``, ``scatter_`` / ``scatter_add_``,
  ``index_copy_`` and ``index_add_`` (the page writes) the elements they
  write, never their whole source or destination storage, which would
  count a 1 GB embedding table or a page pool whole on every step.
- The ctypes kernels are invisible to both counts, so their wrappers
  declare each launch's flops and bytes to the active counter
  (:func:`declared`), and the ops inside the declaration are not counted
  again: a kernel's plain version on the CPU counts exactly what its
  launch on the card declares.

With that exception every byte is one that some op must move at least
once, so the count is a lower bound on the traffic, and a phase's share of
the roofline built from it cannot read over 100 % by construction.

The counter holds every storage it counted until it returns, so that no
freed address is reused by a later tensor and taken for the same storage:
run it on a call whose intermediates fit in memory.  It must not be
active while ``torch.cuda.graph`` captures (:func:`cost_report` refuses to
start during a capture).  When no counter is active, a kernel wrapper pays
one read of :data:`ACTIVE`.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# NVIDIA H100 SXM (data sheet, dense bf16 tensor-core rate; HBM3 rate);
# callers pass their card's numbers for other parts
DEFAULT_PEAK_FLOPS = 989e12
DEFAULT_HBM_BYTES_PER_S = 3.35e12

# the counter the running call is measured by, or None; kernel wrappers
# read it once a launch
ACTIVE: Optional["CostCounter"] = None

_aten = torch.ops.aten
# indexing reads: count the elements read (the output's), not the source
_GATHER_OPS = frozenset({_aten.embedding, _aten.index, _aten.index_select,
                         _aten.gather})
# in-place indexing writes: count the elements written, not the destination
_SCATTER_OPS = frozenset({_aten.index_put_, _aten._index_put_impl_,
                          _aten.scatter_, _aten.scatter_add_,
                          _aten.scatter_reduce_, _aten.index_copy_,
                          _aten.index_add_})


def _span(t: torch.Tensor) -> Tuple[int, int]:
    """Byte interval ``[lo, hi)`` of ``t``'s storage that ``t`` covers."""
    item = t.element_size()
    lo = t.storage_offset() * item
    if t.numel() == 0:
        return lo, lo
    extent = 1 + sum((n - 1) * abs(s) for n, s in zip(t.shape, t.stride()))
    return lo, lo + extent * item


def _indexed_elements(self_t: torch.Tensor, indices) -> int:
    """Elements ``self_t[indices]`` selects (advanced indexing: the
    broadcast index shape times the dims no index covers; a boolean mask
    selects its true count over the dims it spans)."""
    shapes, kept, d = [], 1, 0
    for idx in indices:
        if idx is None:
            kept *= self_t.shape[d]
            d += 1
        elif idx.dtype in (torch.bool, torch.uint8):
            shapes.append((int(idx.sum()),))
            d += idx.ndim
        else:
            shapes.append(tuple(idx.shape))
            d += 1
    kept *= math.prod(self_t.shape[d:])
    return math.prod(torch.broadcast_shapes(*shapes)) * kept


class CostCounter(TorchDispatchMode):
    """Counts flops and compulsory bytes of the aten ops run under it (see
    the module docstring); kernel wrappers add their launches with
    :meth:`declare`.  Use through :func:`counting` or :func:`cost_report`."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode

        self._formulas = FlopCounterMode(display=False).flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.declared_flops = 0.0
        self.declared_bytes = 0.0
        self.ops = 0
        self._paused = 0
        # storage key -> (storage held alive, [(lo, hi), ...] disjoint)
        self._touched: Dict[tuple, tuple] = {}

    # -- declared costs ------------------------------------------------------

    def declare(self, flops: float, nbytes: float) -> None:
        """Add a kernel launch's cost, computed by its wrapper."""
        self.flops += float(flops)
        self.bytes += float(nbytes)
        self.declared_flops += float(flops)
        self.declared_bytes += float(nbytes)

    @contextlib.contextmanager
    def paused(self):
        """Count no op inside (the ops of a declared launch)."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    # -- storage accounting ---------------------------------------------------

    def _touch(self, t: torch.Tensor) -> None:
        if t.device.type == "meta" or t.numel() == 0:
            return
        st = t.untyped_storage()
        key = (t.device, st.data_ptr())
        lo, hi = _span(t)
        # a view with gaps (a column slice) counts its elements, never the
        # gaps: the count stays a lower bound
        dense = t.numel() * t.element_size()
        held, spans = self._touched.get(key, (st, []))
        added, merged = hi - lo, []
        for a, b in spans:
            if b < lo or a > hi:
                merged.append((a, b))
                continue
            added -= max(0, min(b, hi) - max(a, lo))
            lo, hi = min(a, lo), max(b, hi)
        merged.append((lo, hi))
        self._touched[key] = (held, merged)
        self.bytes += min(added, dense)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused:
            return out
        packet = func.overloadpacket
        self.ops += 1
        formula = self._formulas.get(packet)
        if formula is not None:
            self.flops += float(formula(*args, **kwargs, out_val=out))
        if func.is_view or packet in (_aten.empty, _aten.empty_like,
                                      _aten.empty_strided, _aten.lift_fresh,
                                      _aten.detach, _aten.alias):
            return out
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if packet in _GATHER_OPS:
            src = args[0]
            for t in ins[1:]:
                self._touch(t)  # the indices
            for t in outs:
                self.bytes += t.numel() * src.element_size()  # rows read
                self._touch(t)
            return out
        if packet in _SCATTER_OPS:
            dst = args[0]
            for t in ins[1:]:
                self._touch(t)  # indices and values
            if packet in (_aten.index_put_, _aten._index_put_impl_):
                n = _indexed_elements(dst, args[1])
            elif packet in (_aten.index_copy_, _aten.index_add_):
                n = args[3].numel()  # (dst, dim, index, source)
            else:  # scatter: (dst, dim, index, src | value)
                n = args[2].numel()
            self.bytes += n * dst.element_size()
            return out
        for t in ins + outs:
            self._touch(t)
        return out

    def report(self) -> Dict[str, float]:
        """The counts so far, under the JAX ``cost_report`` key names."""
        return {"flops": self.flops, "bytes_accessed": self.bytes,
                "transcendentals": 0.0,
                "declared_flops": self.declared_flops,
                "declared_bytes": self.declared_bytes,
                "ops_counted": float(self.ops)}


@contextlib.contextmanager
def counting():
    """``with counting() as c: ...`` counts the ops of the body into ``c``
    (a :class:`CostCounter`) and makes ``c`` the :data:`ACTIVE` counter the
    kernel wrappers declare to.  Counters do not nest."""
    global ACTIVE
    if ACTIVE is not None:
        raise RuntimeError("a cost counter is already active")
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("no cost counter while a CUDA graph captures")
    counter = CostCounter()
    ACTIVE = counter
    try:
        with counter:
            yield counter
    finally:
        ACTIVE = None
        counter._touched.clear()


@contextlib.contextmanager
def declared(flops: float, nbytes: float):
    """A kernel wrapper's launch (or its plain version on the CPU): its
    cost goes to the active counter, and the ops inside are not counted.
    Without an active counter it does nothing.  Wrappers test
    ``profiling.ACTIVE is not None`` first and only then compute the cost
    (which may read the launch's offsets from the device)."""
    counter = ACTIVE
    if counter is None:
        yield
        return
    counter.declare(flops, nbytes)
    with counter.paused():
        yield


def measure(fn: Callable, *args, **kwargs) -> Tuple[Any, Dict[str, float]]:
    """``(fn(*args, **kwargs), its cost_report)``: the call runs once."""
    with counting() as c:
        out = fn(*args, **kwargs)
    return out, c.report()


def cost_report(fn: Callable, *args, **kwargs) -> Dict[str, float]:
    """Run ``fn(*args, **kwargs)`` once, eagerly, and return its ``flops``
    and ``bytes_accessed`` (the compulsory traffic, a lower bound; see the
    module docstring), plus the part of each its kernels declared
    (``declared_flops``/``declared_bytes``) and the ops counted.  The JAX
    version reads a compiled executable; here the call is the program."""
    return measure(fn, *args, **kwargs)[1]


def memory_analysis(fn: Callable, *args, **kwargs) -> Optional[Dict[str, float]]:
    """Memory of one call of ``fn`` on the card, under the JAX
    ``memory_analysis`` keys: ``argument_size_in_bytes`` (the tensor
    arguments), ``output_size_in_bytes`` (allocated after the call less
    before it) and ``temp_size_in_bytes`` (the peak allocated during the
    call less before it: the transient workspace).  None when no CUDA
    tensor is involved (the CPU has no allocator statistics)."""
    tensors = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
    devs = {t.device for t in tensors if t.device.type == "cuda"}
    if not devs:
        return None
    dev = next(iter(devs))
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    out = fn(*args, **kwargs)
    torch.cuda.synchronize(dev)
    after = torch.cuda.memory_allocated(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    del out
    return {
        "argument_size_in_bytes": float(sum(
            t.untyped_storage().nbytes() for t in tensors)),
        "output_size_in_bytes": float(max(after - base, 0)),
        "temp_size_in_bytes": float(max(peak - base, 0)),
    }


def roofline(
    report: Dict[str, float],
    peak_flops: float = DEFAULT_PEAK_FLOPS,
    hbm_bytes_per_s: float = DEFAULT_HBM_BYTES_PER_S,
) -> Dict[str, float]:
    """Roofline lower bound for one execution of the reported call:
    ``max(flops/peak, bytes/bandwidth)``.  A measured time below it is
    impossible; far above it is overhead or serialization to chase."""
    flops = report.get("flops", 0.0)
    bytes_ = report.get("bytes_accessed", 0.0)
    t_compute = flops / peak_flops if peak_flops else 0.0
    t_memory = bytes_ / hbm_bytes_per_s if hbm_bytes_per_s else 0.0
    bound = max(t_compute, t_memory)
    return {
        "compute_s": t_compute,
        "memory_s": t_memory,
        "lower_bound_s": bound,
        "bound": "compute" if t_compute >= t_memory else "memory",
        "arithmetic_intensity": (flops / bytes_) if bytes_ else float("inf"),
    }


__all__ = ["ACTIVE", "CostCounter", "DEFAULT_HBM_BYTES_PER_S",
           "DEFAULT_PEAK_FLOPS", "cost_report", "counting", "declared",
           "measure", "memory_analysis", "roofline"]
