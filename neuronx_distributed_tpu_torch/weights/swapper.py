"""Live weight swaps for a running serving engine (counterpart of
``neuronx_distributed_tpu/weights/swapper.py``).

:class:`WeightSwapper` takes a new set of parameters, a flat mapping from
the module's parameter names (the JAX tree's paths, ``model.layer_0.attn.
qkv.q_kernel``...) to tensors or arrays, as
:func:`~..convert.jax_params.llama_params_from_jax` produces it or a
co-located trainer holds it, validates it against the running
:class:`~..trace.engine.ParallelInferenceModel`'s envelope (names, shapes,
dtypes), and installs it between ``ServingEngine.step()`` calls.

Where the JAX package passes the parameters to every compiled program as
its first argument, every CUDA graph of the port has the module's
parameter addresses baked in.  So :meth:`ServingEngine.install_params`
copies the caller's tensors INTO the existing parameters (``copy_`` on the
engine's stream, no staged second weight set) when no other engine ever
held the module: no graph is captured again, and a step already in flight
runs first in stream order, with the old weights.  A module shared with
other engines (a fleet's replicas) is never written: the swapper stages
the tensors on the model's device, and the engine moves to a private
model over them and captures its phases again inside the install, booked
as the new generation's warm-up.

Transactionality: validation (and, for a shared module, staging)
completes BEFORE the engine is touched.  A name/shape/dtype mismatch or a ``weights/pre_swap`` chaos
fault raises :class:`SwapError` (or the injected fault) with the OLD
weights serving.  Every attempt lands in ``weight_swaps.jsonl`` and the
``weights/*`` metrics; a committed swap bumps the engine's monotonic
``weights_version``, stamped on each token's request at collect with the
version that computed it.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, Mapping, NamedTuple, Optional

import numpy as np
import torch

from neuronx_distributed_tpu_torch.obs.schemas import validate_record
from neuronx_distributed_tpu_torch.resilience.faults import fault_point
from neuronx_distributed_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

WEIGHT_SWAP_SCHEMA = "weight_swap/1"

WEIGHT_SWAPS_FILE = "weight_swaps.jsonl"


class SwapError(RuntimeError):
    """A live swap was refused or failed: the old weights kept serving."""


class ParamSpec(NamedTuple):
    shape: tuple
    dtype: torch.dtype
    device: torch.device


def param_envelope(model: Any) -> Dict[str, ParamSpec]:
    """The model's parameter envelope: ``{name: ParamSpec(shape, dtype,
    device)}`` from its module's ``named_parameters()``, which every
    incoming mapping must match name for name."""
    return {name: ParamSpec(tuple(p.shape), p.dtype, p.device)
            for name, p in model.module.named_parameters()}


class WeightSwapper:
    """Live-weight controller for ONE serving engine.

    ``engine`` is a running ``serving.engine.ServingEngine``; ``path`` the
    ``weight_swaps.jsonl`` audit trail (None = no artifact); ``registry``
    / ``tracer`` / ``clock`` default to the engine's own.  ``replica`` tags
    the records when the engine serves inside a fleet.

    Call :meth:`swap` only between engine steps."""

    def __init__(self, engine: Any, *, path: Optional[str] = None,
                 registry: Any = None, tracer: Any = None,
                 clock: Any = None, replica: int = -1):
        self.engine = engine
        self.replica = int(replica)
        self.registry = registry if registry is not None else engine.registry
        self.tracer = tracer if tracer is not None else engine.tracer
        self._clock = clock if clock is not None else engine._clock
        self.path = path
        self._f = open(path, "a") if path is not None else None
        reg = self.registry
        # pre-declared: an engine that never swaps still exports the set,
        # and the version gauge starts at the serving version
        reg.counter("weights/swaps_total")
        reg.counter("weights/swap_failures_total")
        from neuronx_distributed_tpu_torch.obs import MS_BUCKETS

        self._ms_buckets = MS_BUCKETS
        reg.histogram("weights/swap_ms", MS_BUCKETS)
        reg.gauge("weights/weights_version").set(
            float(getattr(engine, "weights_version", 0)))

    # -- public surface ----------------------------------------------------

    def swap(self, params: Mapping[str, Any], *, source: str = "memory",
             copy: Optional[bool] = None) -> int:
        """Validate and install ``params`` as the engine's live weights;
        returns the new ``weights_version``.  Raises :class:`SwapError`
        (envelope mismatch) or the injected chaos fault with the engine
        untouched.  ``source`` tags the audit record.

        ``copy`` (default: True for ``source="memory"``, False otherwise)
        makes the engine own its bytes: a trainer that updates or frees
        its tensors after the handoff cannot change what the engine
        serves.  An engine that owns its module copies every tensor into
        its parameters whatever ``copy`` says; for a shared module each
        tensor is staged into FRESH device memory, which becomes the
        engine's private parameters (with ``copy=False`` a tensor already
        on the device is taken as it is)."""
        eng = self.engine
        copy = (source == "memory") if copy is None else bool(copy)
        next_version = int(getattr(eng, "weights_version", 0)) + 1
        t0 = self._clock()
        tr = self.tracer
        span = (tr.begin("weight_swap", t=t0, version=next_version,
                         source=source)
                if tr is not None else None)
        try:
            # the chaos hook fires before ANY engine state is touched
            fault_point("weights/pre_swap", version=next_version,
                        source=source)
            staged = self._materialize(params, stage=eng.shares_model,
                                       copy=copy)
        except BaseException as e:
            now = self._clock()
            if span is not None:
                tr.end(span, t=now, failed=str(e))
            self._note_failure(e, source, (now - t0) * 1e3)
            raise
        # commit point: the install cannot fail the envelope
        eng.install_params(staged, next_version)
        now = self._clock()
        swap_ms = (now - t0) * 1e3
        if span is not None:
            tr.end(span, t=now)
        reg = self.registry
        reg.counter("weights/swaps_total").inc()
        reg.histogram("weights/swap_ms", self._ms_buckets).observe(swap_ms)
        reg.gauge("weights/weights_version").set(float(next_version))
        self._emit("swap", next_version, source, True, swap_ms, None)
        logger.info("weights: swapped to version %d (%s, %.1f ms)",
                    next_version, source, swap_ms)
        return next_version

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self) -> "WeightSwapper":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # -- internals ---------------------------------------------------------

    def _materialize(self, params: Mapping[str, Any], stage: bool,
                     copy: bool = False) -> Dict[str, torch.Tensor]:
        """Validate ``params`` against the model's envelope and, with
        ``stage``, move every tensor to its device (into fresh memory with
        ``copy``).  Raises :class:`SwapError` on ANY mismatch before a
        single engine field is touched."""
        env = param_envelope(self.engine.model)
        if not isinstance(params, Mapping):
            raise SwapError(
                f"params must be a mapping of parameter names to tensors, "
                f"got {type(params).__name__}")
        if set(params) != set(env):
            missing = sorted(set(env) - set(params))
            extra = sorted(set(params) - set(env))
            raise SwapError(
                "param structure differs from the running model's "
                f"envelope: missing {missing[:5]}, unexpected {extra[:5]}")
        staged: Dict[str, torch.Tensor] = {}
        for name, spec in env.items():
            leaf = params[name]
            t = (leaf if isinstance(leaf, torch.Tensor)
                 else torch.as_tensor(np.asarray(leaf)))
            if tuple(t.shape) != spec.shape:
                raise SwapError(
                    f"param {name}: shape {tuple(t.shape)} != envelope "
                    f"{spec.shape}")
            if t.dtype != spec.dtype:
                raise SwapError(
                    f"param {name}: dtype {t.dtype} != envelope "
                    f"{spec.dtype}")
            t = t.detach()
            staged[name] = t.to(spec.device, copy=copy) if stage else t
        return staged

    def _note_failure(self, e: BaseException, source: str,
                      swap_ms: float) -> None:
        version = int(getattr(self.engine, "weights_version", 0))
        self.registry.counter("weights/swap_failures_total").inc()
        self._emit("swap_failed", version, source, False, swap_ms, str(e))
        logger.warning("weights: swap failed, version %d keeps serving: %s",
                       version, e)

    def _emit(self, event: str, version: int, source: str, ok: bool,
              swap_ms: Optional[float], error: Optional[str]) -> None:
        if self._f is None:
            return
        rec = {
            "schema": WEIGHT_SWAP_SCHEMA,
            "time": time.time(),
            "mono": self._clock(),
            "event": event,
            "version": version,
            "source": source,
            "ok": ok,
            "swap_ms": swap_ms,
            "error": error,
            "replica": self.replica,
        }
        validate_record("weight_swap", rec)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
