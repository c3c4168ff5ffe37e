"""Continuous-batching serving engine over the paged KV pool (counterpart of
``neuronx_distributed_tpu/serving/engine.py`` in paged mode).

``step()`` is the iteration-level loop (Orca, OSDI '22): sweep
cancellations and deadlines, admit queued requests into free slots
(prefix-cache lookup, single-request prefill, page writes of the uncached
prompt pages), advance chunked prefills, run ONE batched decode step with
per-slot cache offsets over the page pool, sample each slot from its own
request's stream, and free the slots and pages of finished requests.  Idle
slots are parked at offset ``T``: they write nothing and their logits are
ignored.

- ``kv_quant="int8"`` keeps the pool in int8 pages with one fp32
  scale/zero per page (``kvcache.quant``): about twice the pages in the
  same memory, at a bounded logit drift.
- ``prefill_chunk_tokens`` prefills prompts in page-aligned chunks
  (Sarathi-style): admission reserves the pages, and each step spends at
  most that many prompt tokens of prefill before its decode, so decodes
  keep ticking while long prompts trickle in.
- ``async_decode`` (default True) pipelines the decode loop: ``step()``
  collects the in-flight step N (ONE packed ``[2, B]`` device-to-host
  fetch into pinned memory), detects stops, dispatches step N+1, and only
  then runs step N's host work (stream callbacks, inter-token times,
  outputs) while the card computes.  The step's inputs (next tokens,
  offsets, and the block tables when admission or release changed them)
  go up in ONE packed host-to-device put; the per-slot sampler settings
  stay on the host, where the per-request generators are seeded.  A step
  whose slot was swept and re-granted while in flight is told apart by
  the slot's occupancy generation and discarded.  Outputs are
  token-identical to ``async_decode=False``.
- ``draft=`` and ``spec_k=`` make every decode step a batched
  draft-k-verify round: the draft (contiguous caches, prefilled whole at
  admission) proposes ``spec_k`` tokens per slot, the target scores the
  ``spec_k + 1`` tokens in one ``verify_pages`` call that also writes them
  into the pool, and :func:`_spec_accept` commits on the card (one packed
  ``[k+3, B]`` fetch a round).  The offset rewind is the rollback of a
  rejected tail (its pages were reserved at admission).  Greedy output is
  token-identical to the plain engine up to the arithmetic of the two
  attention paths; sampled rows use Leviathan accept/reject.
- ``adapter_store=`` (a :class:`~..tenancy.AdapterStore`) serves many LoRA
  adapters through the same phase functions (S-LoRA): ``Request.adapter_id``
  names the adapter, admission pins it (a cold adapter's pages are written
  into the device adapter pool) before any KV page is taken, and every
  prefill, chunk, decode and verify adds each slot's low-rank q/v deltas,
  gathered from the pool by the slot's adapter page table.  Adapter 0 is
  the base model (the pool's zero NULL page).  The adapter tables go up
  inside the step's one packed put when they changed.  Prefix keys are
  salted per adapter, so prompt pages are never shared across adapters.
- SLO scheduling: ``Request.priority`` ("interactive" ahead of "batch")
  and ``deadline_s`` order the queues (:mod:`.scheduler`).  When the
  interactive head is blocked on slots or pages, each step first parks
  batch victims: the victim's committed prompt chain stays pinned
  (:meth:`~.paged.PagedKVManager.park_resume`), its slot, pages and adapter
  pin are released, and it is requeued at its original deadline key; its
  re-grant matches the pinned chain and prefills only the rest, and its
  tokens are those of an unpreempted run.  ``shed_infeasible=True`` refuses
  at submit a deadline the load estimate says is already dead
  (``SLOInfeasible``), a granted request whose deadline died before its
  prefill or its next chunk is timed out without running it, and tenant
  rate limits (``scheduler.set_tenant_limit``) refuse a tenant over budget
  (``RateLimited``).  A preemption changes only block tables, offsets and
  adapter tables, all inputs of the step's one packed put, so no CUDA graph
  is captured again for it.
- Fault points (:mod:`..resilience.faults`): ``serving/prefill_chunk``
  before each chunk dispatch, ``serving/page_alloc`` and
  ``tenancy/adapter_load`` inside admission, and ``perturb`` on the
  prefill, decode, draft and verify logits (host side, after a graph
  replay and before the sampler).  Without a plan each costs one global
  read.
- Telemetry (:mod:`..obs`, the JAX package's formats): a metrics registry
  is always built (``registry=``, or an ``obs=`` hub's); ``stats_path=``
  appends one ``serving_stats/6`` record per terminal request; ``obs=``
  records one flight-recorder entry per step; ``tracer=`` records one span
  tree per request (queue, prefill with its chunks, decode, preempted
  phases under a root span) plus batch ``decode_step``/``spec_round``
  spans; ``step_timeout_s=`` arms the slow-step watchdog;
  ``transfer_guard="forbid"`` runs the async collect and dispatch under
  the CUDA sync guard (:mod:`..obs.transfer_audit`).  ``compile_ledger=``
  accounts every phase-graph capture, replay and eviction (a capture
  after :meth:`declare_warmup_done` is a compile storm); ``memory_ledger=``
  accounts the parameters, the page pool, the draft and the adapter pool
  at construction and dumps the breakdown on an out-of-memory error in
  ``step`` and at close; ``perf=`` accounts each prefill, chunk, decode
  step and speculative round with the clock deltas that stamp the spans;
  ``health=`` evaluates its rules once a step.  Every metric is fed from
  numbers already on the host (the packed fetch's tokens and flags, the
  scheduler's state, shapes): telemetry adds no host sync, no kernel and
  no CUDA-graph input on the steady path.

- Tensor parallelism: over a model built at tp > 1 (each rank holds its
  shard of the weights and of the pool), every rank runs this engine in
  lockstep.  The caller makes the same calls on every rank in the same
  order (a ``torchrun`` script does), the clock is rank 0's, agreed in
  one all-reduce a reading (:class:`~.lockstep.LockstepClock`, which also
  raises when the ranks' calls differ), and every rank samples the same
  tokens from the same gathered logits, so every rank returns the same
  outputs.  Tensor-parallel rank 0 alone writes ``stats_path`` and flight
  dumps; the other ranks keep their registries in memory.  CUDA graphs
  are off (ROADMAP A9a), and the fleet's surface below stays at tp = 1
  (A9d).

- The fleet's surface (:mod:`.fleet`): :meth:`ServingEngine.withdraw`
  (a migration's hop), :meth:`~ServingEngine.export_prefix` and
  :meth:`~ServingEngine.import_prefix` (page chains in and out of the
  pool, the import in place), :meth:`~ServingEngine.install_params` (a
  live weight swap; tokens carry the version that dispatched their step)
  and :meth:`~ServingEngine.prewarm_graphs` (a rebuilt replica captures
  its predecessor's phases at once, as warm-up).

Greedy outputs are token-identical to a solo ``generate`` of the same
prompt up to the arithmetic order of the attention path taken.  Chunked
prefill over an int8 pool is the exception: each chunk attends the
already-quantized pages of the chunks before it, while a whole prefill
attends full-precision keys, so the two drift apart within the int8
bound.
"""

from __future__ import annotations

import contextlib
import copy
import json
import time
import weakref
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from neuronx_distributed_tpu_torch.kvcache.allocator import NULL_PAGE, PoolExhausted
from neuronx_distributed_tpu_torch.kvcache.pool import GATHER_BYTES_TOTAL
from neuronx_distributed_tpu_torch.kvcache.quant import QUANT_PAGES_TOTAL
from neuronx_distributed_tpu_torch.kvcache.transfer import (
    ChainExport,
    TransferError,
    export_chain,
    import_chain,
)
from neuronx_distributed_tpu_torch.obs import MS_BUCKETS, MetricRegistry
from neuronx_distributed_tpu_torch.obs.memory_ledger import tree_bytes
from neuronx_distributed_tpu_torch.obs.transfer_audit import TransferAudit, allow_sync
from neuronx_distributed_tpu_torch.ops.paged_attention import resolve_paged_kernel
from neuronx_distributed_tpu_torch.parallel import mesh
from neuronx_distributed_tpu_torch.resilience.faults import fault_point, perturb
from neuronx_distributed_tpu_torch.serving.driver import replay as driver_replay
from neuronx_distributed_tpu_torch.serving.lockstep import LockstepClock
from neuronx_distributed_tpu_torch.serving.paged import PagedKVManager
from neuronx_distributed_tpu_torch.serving.request import (
    PRIORITIES,
    PRIORITY_INTERACTIVE,
    Request,
    RequestOutput,
    RequestState,
)
from neuronx_distributed_tpu_torch.serving.scheduler import (
    AdmissionError,
    BackpressureError,
    SLOInfeasible,
    SlotScheduler,
)
from neuronx_distributed_tpu_torch.tenancy.store import AdapterLayout
from neuronx_distributed_tpu_torch.trace.engine import (
    PhaseGraphs,
    _filtered_logits,
    gumbel_draw,
    pack_tokens,
    propose_rows,
    refuse_kv_replication,
    request_key,
    sample_rows,
    sampled_tokens,
    spec_keys,
    token_generator,
)
from neuronx_distributed_tpu_torch.utils.device import resolve_device
from neuronx_distributed_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

SERVING_STATS_SCHEMA = "serving_stats/6"

FAIL_NON_FINITE = "non_finite_logits"
SHED_EXPIRED_BEFORE_PREFILL = "expired_before_prefill"


class _ModuleHolders:
    """Which live serving engines serve each ``nn.Module``'s parameters.

    Keyed on the module a weight swap writes, not on its
    ``ParallelInferenceModel`` wrapper: two wrappers over one module serve
    the same parameters.  A module two engines have held is SHARED for good
    (a fleet's factory builds its rebuilt replicas on it, stamped with the
    weights it holds), and a weight swap never writes a shared module's
    parameters."""

    def __init__(self):
        self._engines = weakref.WeakKeyDictionary()
        self._shared = weakref.WeakSet()

    def hold(self, module, engine) -> None:
        engines = self._engines.setdefault(module, weakref.WeakSet())
        engines.add(engine)
        if len(engines) > 1:
            self._shared.add(module)

    def release(self, module, engine) -> None:
        engines = self._engines.get(module)
        if engines is not None:
            engines.discard(engine)

    def shared(self, module) -> bool:
        return module in self._shared


_HOLDERS = _ModuleHolders()


def replay_trace(engine: "ServingEngine", arrivals, requests,
                 on_output=None, clock=time.monotonic, sleep=time.sleep):
    """Replay an arrival trace through a live engine: the engine-flavoured
    name of :func:`~.driver.replay` (an unhandled exception dumps the
    engine's flight ring before re-raising)."""
    return driver_replay(engine, arrivals, requests, on_output=on_output,
                         clock=clock, sleep=sleep)


def _spec_accept(vlogits, q_filt, props, keys, tok_idx, temps, top_ks,
                 top_ps, draft_finite) -> torch.Tensor:
    """Per-slot draft-k-verify accept and commit of one speculative round,
    on the device (the JAX engine's ``_spec_accept``).

    ``vlogits [B, K+1, V]`` are the target's verify logits (position ``i``
    judges proposal ``i + 1``), ``q_filt [B, K, V]`` the filtered draft
    distributions, ``props [B, K]`` the proposals; ``keys``, ``tok_idx``
    (the token index of each slot's first proposal) and the sampler
    settings are host values.  Greedy rows accept while the target's
    argmax agrees and take the target's token at the first disagreement
    (or the bonus position).  Sampled rows accept proposal ``j`` with
    probability ``min(1, p/q)`` on a coin from the request's
    ``SPEC_ACCEPT_SALT`` stream at token ``tok_idx + j``, resample the
    first rejection from ``norm(max(p - q, 0))`` on its
    ``SPEC_RESIDUAL_SALT`` stream, and draw a full accept's bonus from the
    plain token-index stream, so ``draft == target`` reproduces plain
    sampling.  Every candidate residual draw is made, and the accepted
    count picks one on the device: nothing here waits for the card.

    Returns the round's whole device-to-host payload as one ``[K+3, B]``
    int32 tensor: rows ``0..K`` the commit candidates (proposals ``0..a-1``
    then the extra token at row ``a``; rows past ``a`` are garbage), row
    ``K+1`` the accept count ``a``, row ``K+2`` the finite flag (target
    and draft)."""
    B, K = props.shape
    dev = vlogits.device
    finite = torch.isfinite(vlogits.float()).all(dim=-1).all(dim=-1) \
        & draft_finite
    props = props.long()
    greedy = torch.argmax(vlogits, dim=-1)                         # [B, K+1]
    lead = torch.cumprod((greedy[:, :K] == props).long(), dim=1)
    acc = lead.sum(dim=1)                                           # [B]
    extra = greedy.gather(1, acc[:, None])[:, 0]
    for b in range(B):
        if not temps[b] > 0.0:
            continue
        pf = _filtered_logits(vlogits[b], temps[b], top_ks[b], top_ps[b])
        p = torch.softmax(pf[:K], dim=-1)                           # [K, V]
        q = torch.softmax(q_filt[b].float(), dim=-1)
        px = p.gather(1, props[b][:, None])[:, 0]
        qx = q.gather(1, props[b][:, None])[:, 0]
        acc_key, res_key = spec_keys(keys[b])
        idx = int(tok_idx[b])
        u = torch.stack([torch.rand((), device=dev, generator=token_generator(
            acc_key, idx + j, dev)) for j in range(K)])
        a = torch.cumprod((u < torch.clamp(px / qx.clamp_min(1e-20),
                                           max=1.0)).long(), dim=0).sum()
        res = (p - q).clamp_min(0.0)
        res_sum = res.sum(dim=-1, keepdim=True)
        # a degenerate all-zero residual falls back to p itself
        dist = torch.where(res_sum > 0, res / res_sum.clamp_min(1e-20), p)
        corr = torch.stack([gumbel_draw(
            torch.log(dist[j].clamp_min(1e-20)),
            token_generator(res_key, idx + j, dev)) for j in range(K)])
        bonus = gumbel_draw(pf[K], token_generator(keys[b], idx + K, dev))
        acc[b] = a
        extra[b] = torch.where(a == K, bonus,
                               corr.gather(0, a.clamp(max=K - 1)[None])[0])
    commit = torch.cat([props, torch.zeros((B, 1), dtype=torch.long,
                                           device=dev)], dim=1)
    commit.scatter_(1, acc[:, None], extra[:, None])
    return torch.cat([commit.T, acc[None], finite[None].long()]
                     ).to(torch.int32)


class _Staging:
    """The engine's packed transfers.  ``put`` sends several int32 host
    arrays in ONE host-to-device copy (from pinned memory on the card,
    without waiting), ``fetch`` starts ONE device-to-host copy of a packed
    result into pinned memory and ``wait`` reads it when the host needs
    it; both are counted."""

    def __init__(self, device, put_elems: int, fetch_elems: int):
        self.device = device
        self.cuda = device.type == "cuda"
        self.puts = 0
        self.fetches = 0
        if self.cuda:
            self._up = torch.empty(put_elems, dtype=torch.int32,
                                   pin_memory=True)
            self._up_done = None
            self._down = torch.empty(fetch_elems, dtype=torch.int32,
                                     pin_memory=True)

    def put(self, *arrays) -> List[torch.Tensor]:
        flat = np.concatenate([np.asarray(a, np.int32).ravel()
                               for a in arrays])
        if self.cuda:
            buf = self._up
            if flat.size > buf.numel() or (
                    self._up_done is not None and not self._up_done.query()):
                # the last copy from this buffer has not run yet
                buf = torch.empty(max(flat.size, buf.numel()),
                                  dtype=torch.int32, pin_memory=True)
                self._up = buf
            buf[:flat.size].numpy()[:] = flat
            dev = buf[:flat.size].to(self.device, non_blocking=True)
            self._up_done = torch.cuda.Event()
            self._up_done.record()
        else:
            dev = torch.from_numpy(flat)
        self.puts += 1
        out, at = [], 0
        for a in arrays:
            n = int(np.size(a))
            out.append(dev[at:at + n].view(np.shape(a)))
            at += n
        return out

    def fetch(self, packed: torch.Tensor):
        """Start the copy of ``packed`` (int32) to the host; the handle
        goes to :meth:`wait`."""
        if not self.cuda:
            return packed
        host = self._down[:packed.numel()].view(packed.shape)
        host.copy_(packed, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def wait(self, handle) -> np.ndarray:
        self.fetches += 1
        if not self.cuda:
            return handle.numpy().copy()
        host, done = handle
        done.synchronize()
        return host.numpy().copy()


class _ChunkPrefill:
    """Per-slot progress of a chunked prefill: the admission-time prompt
    row and validity, the contiguous run of fresh ``(logical, physical)``
    pages still to compute, and the last chunk's logits (the final chunk's
    are the prefill logits the first token samples from)."""

    __slots__ = ("req", "ids_row", "valid_row", "fresh", "next_i", "logits")

    def __init__(self, req, ids_row, valid_row, fresh):
        self.req = req
        self.ids_row = ids_row      # np [C] left-padded prompt ids
        self.valid_row = valid_row  # np [T] full-prompt key validity
        self.fresh = fresh          # [(lp, phys), ...] ascending, contiguous
        self.next_i = 0             # index into fresh of the next chunk page
        self.logits = None

    @property
    def pages_remaining(self) -> int:
        return len(self.fresh) - self.next_i


class ServingEngine:
    """Continuous-batching engine over a
    :class:`~..trace.engine.ParallelInferenceModel`, in paged mode.

    - ``page_size`` must divide ``context_len`` and ``max_total_len``;
      ``num_pages`` defaults to the pool a contiguous ``[B, T]`` cache
      would hold plus the NULL page (``B * T / page_size + 1``; with
      ``spec_k``, enough for every slot's verify overshoot too).
    - ``seed`` seeds the per-request sampling streams (``(seed,
      request_id, token index)``); greedy requests need none.
    - ``prefix_cache`` shares page-aligned prompt prefixes; an exact
      repeated prompt skips prefill entirely.
    - ``paged_kernel``: ``"auto"`` follows the model (the kernel on CUDA),
      ``True``/``False`` force the kernel or the gather path.
    - ``kv_quant``: ``"int8"`` or None (pages in the model's cache type).
    - ``prefill_chunk_tokens``: a positive multiple of ``page_size``, the
      per-step budget of chunked prefill; None prefills each prompt whole
      at admission.
    - ``async_decode``: pipeline the decode loop (default True; False is
      the synchronous reference).
    - ``draft``/``spec_k``: speculative decoding with a second
      ``ParallelInferenceModel`` of the same serving shapes and vocab
      (both or neither).  A draft of the target's adapter geometry (a
      self draft) proposes under each slot's adapter; another proposes
      from its base weights, and the adapter-aware verify corrects it.
    - ``adapter_store``: an :class:`~..tenancy.AdapterStore` laid out for
      ``model`` (multi-adapter serving); None serves adapter 0 only.
    - ``shed_infeasible``: refuse at submit a deadline shorter than the
      estimated queue wait plus time to first token.
    - ``clock``: the engine's time source; deadlines, shedding and the
      tenant buckets all read it.
    - ``device`` must be the model's device; ``None`` means CUDA (raises
      without it).
    - ``registry``: the ``obs.MetricRegistry`` the engine, its page pool
      and its adapter store report to (the ``serving/*``, ``kvcache/*``,
      ``tenancy/*`` and ``transfer/*`` metrics of
      ``obs.schemas.REGISTRY_METRICS``); built when omitted, or taken from
      ``obs``.  ``stats_path`` appends one ``serving_stats`` record per
      terminal request.  ``obs`` (an ``obs.Observability``) records one
      flight entry per step (``dump_flight``; ``replay_trace`` dumps it on
      a crash).  ``tracer`` (an ``obs.Tracer``, or ``tracer.scoped(r)``)
      records the request span trees; ``None`` allocates no span.
      ``step_timeout_s`` counts slower steps into
      ``serving/slow_steps_total``.  ``transfer_guard="forbid"`` runs the
      async collect and dispatch under ``set_sync_debug_mode("error")`` on
      the card (the one packed fetch is let through).
    - ``compile_ledger`` (an ``obs.CompileLedger``) is attached to the
      model (and the draft), so their phase graphs report captures,
      replays and evictions to it; ``memory_ledger`` (an
      ``obs.MemoryLedger``) accounts ``params``, ``kv_pool`` (``num_pages
      x page_bytes``), the draft's parameters and caches and the adapter
      pool; ``health`` (an ``obs.HealthMonitor``) evaluates once a step
      and takes each terminal request's SLO outcome; ``perf`` (an
      ``obs.PerfAttribution``) accounts the phases.  ``health`` and
      ``perf`` default to the ``obs`` hub's (the ledgers are passed
      explicitly, as in JAX); None is one ``is not None`` test at each
      site (the
      counters ``obs.compile_ledger.LEDGER_ROWS``,
      ``obs.perf.PERF_RECORDS`` and ``obs.health.ALERTS_EVALUATED`` stay
      put).

    ``puts`` and ``fetches`` count the packed transfers: one put and one
    fetch per steady decode step or speculative round (a round whose
    draft must catch up on a full accept adds one put), and one fetch per
    admission's first token; the registry's ``transfer/explicit_*_total``
    count the same crossings.  The plain counters ``preemptions``,
    ``shed`` (submits refused as infeasible), ``rejected`` (other
    backpressure, rate limits included), ``expired_before_prefill``,
    ``prefill_chunks``, ``quant_pages`` and ``spec_proposed`` /
    ``_accepted`` / ``_committed`` read the same numbers as their
    ``serving/*`` and ``kvcache/*`` metrics.  ``decode_steps`` and
    ``spec_rounds`` count batched dispatches; ``serving/spec_rounds_total``
    counts a round per decoding slot, as the JAX engine's does.
    """

    def __init__(self, model, *, page_size: int,
                 num_pages: Optional[int] = None, seed: Optional[int] = None,
                 eos_token_id: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic,
                 max_queue: Optional[int] = None, prefix_cache: bool = True,
                 paged_kernel="auto", kv_quant: Optional[str] = None,
                 prefill_chunk_tokens: Optional[int] = None,
                 async_decode: bool = True, draft=None, spec_k: int = 0,
                 adapter_store=None, shed_infeasible: bool = False,
                 registry: Optional[MetricRegistry] = None,
                 stats_path: Optional[str] = None, obs: Any = None,
                 tracer: Any = None, step_timeout_s: Optional[float] = None,
                 transfer_guard: str = "off", compile_ledger: Any = None,
                 memory_ledger: Any = None, health: Any = None,
                 perf: Any = None, device=None):
        if transfer_guard not in ("off", "forbid"):
            raise ValueError(f"transfer_guard must be 'off' or 'forbid', "
                             f"got {transfer_guard!r}")
        device = resolve_device(device)
        if device != model.device:
            raise ValueError(f"engine device {device} != model device "
                             f"{model.device}")
        if kv_quant not in (None, "int8"):
            raise ValueError(
                f"kv_quant must be 'int8' or None, got {kv_quant!r}")
        if prefill_chunk_tokens is not None and (
                prefill_chunk_tokens < page_size
                or prefill_chunk_tokens % page_size != 0):
            raise ValueError(
                f"prefill_chunk_tokens ({prefill_chunk_tokens}) must be a "
                f"positive multiple of page_size ({page_size}): chunks are "
                "page-aligned so cached prefix pages can be skipped whole")
        if (draft is None) != (spec_k == 0):
            raise ValueError(
                "speculative decoding needs BOTH draft= and spec_k= (got "
                f"draft={'set' if draft is not None else 'None'}, "
                f"spec_k={spec_k})")
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        cfg = model.config
        tp = getattr(model, "tp", None)
        refuse_kv_replication(tp)
        self.tp_size = tp.size if tp is not None else 1
        # tensor-parallel rank 0 writes the engine's files; every rank's
        # clock is rank 0's (see the module docstring)
        self.primary = tp is None or tp.rank == 0
        self.lockstep: Optional[LockstepClock] = None
        if self.tp_size > 1:
            group = mesh.get_tensor_parallel_cpu_group()
            if group is None:
                raise RuntimeError(
                    "a model built at tensor-parallel degree > 1 needs the "
                    "parallel state it was built in "
                    "(initialize_model_parallel)")
            self.lockstep = clock = LockstepClock(clock, group)
        if draft is not None:
            dtp = getattr(draft, "tp", None)
            if (dtp.size if dtp is not None else 1) != self.tp_size:
                raise ValueError(
                    f"draft tensor-parallel degree "
                    f"{dtp.size if dtp is not None else 1} != the target's "
                    f"{self.tp_size}")
            dcfg = draft.config
            for f in ("batch_size", "context_len", "max_total_len"):
                if getattr(dcfg, f) != getattr(cfg, f):
                    raise ValueError(
                        f"target/draft serving shapes differ on {f}: "
                        f"{getattr(cfg, f)} vs {getattr(dcfg, f)}")
            tv = model.module.config.vocab_size
            dv = draft.module.config.vocab_size
            if tv != dv:
                raise ValueError(
                    f"target/draft vocab_size differ ({tv} vs {dv}): "
                    "speculative decoding needs one shared tokenizer")
            if draft.device != device:
                raise ValueError(f"draft device {draft.device} != engine "
                                 f"device {device}")
        self.model = model
        _HOLDERS.hold(model.module, self)
        self.device = device
        self.obs = obs
        if registry is None and obs is not None:
            registry = obs.registry
        self.registry = registry if registry is not None else MetricRegistry()
        # the health monitor and the perf attribution default to the hub's
        # (the ledgers are passed explicitly, as in JAX); each site guards
        # on `is not None`
        if obs is not None:
            if health is None:
                health = getattr(obs, "health_monitor", None)
            if perf is None:
                perf = getattr(obs, "perf", None)
        self.compile_ledger = compile_ledger
        self.memory_ledger = memory_ledger
        if compile_ledger is not None:
            compile_ledger.attach(registry=self.registry, tracer=tracer,
                                  flight=(obs.flight if obs is not None
                                          else None),
                                  memory_ledger=memory_ledger)
            # explicit wins over what an earlier engine left on the model,
            # and the attachment persists on the model: give each
            # measurement's engines (warm passes included) that
            # measurement's ledger, or a warm-declared earlier ledger books
            # the new captures as storms
            model.compile_ledger = compile_ledger
            if draft is not None:
                draft.compile_ledger = compile_ledger
        if memory_ledger is not None:
            if memory_ledger.registry is None:
                memory_ledger.registry = self.registry
            if memory_ledger.device is None:
                memory_ledger.device = device
        self._health = health
        if health is not None:
            health.attach_registry(self.registry)
        self._perf = perf
        self._perf_t0: dict = {}  # rid -> prefill-phase start (engine clock)
        self._batch_t0 = None     # (family, t0) of the in-flight step
        if perf is not None:
            perf.attach(registry=self.registry, ledger=compile_ledger)
            model.perf = perf
            if draft is not None:
                draft.perf = perf
        self.tracer = tracer
        self._rt: dict = {}       # rid -> {"root": Span, "phase": Span?}
        self._batch_span = None   # the open decode_step/spec_round span
        self.step_timeout_s = step_timeout_s
        self._stats_path = stats_path
        self._stats_f = None
        self._audit = TransferAudit(
            self.registry,
            mode="forbid" if transfer_guard == "forbid" else "observe",
            device=device)
        # the version of the serving weights (weights.WeightSwapper bumps
        # it) and the version that dispatched the step in flight: its tokens
        # are stamped with the weights that computed them
        self.weights_version = 0
        self._pending_version = 0
        self.B, self.C, self.T = (cfg.batch_size, cfg.context_len,
                                  cfg.max_total_len)
        self._spec_k = int(spec_k)
        self._draft_model = draft
        if num_pages is None:
            num_pages = self.B * -(-(self.T + self._spec_k) // page_size) + 1
        self._kv = PagedKVManager(
            num_slots=self.B, context_len=self.C, max_total_len=self.T,
            page_size=page_size, num_pages=num_pages, registry=self.registry,
            prefix_cache=prefix_cache, spec_overshoot=self._spec_k)
        self._paged_kernel = (model.paged_kernel if paged_kernel in ("auto", None)
                              else resolve_paged_kernel(paged_kernel, device))
        # bytes one gather-path step spends on the contiguous clone: k and
        # v, every layer, the padded [B, T] view in the cache type
        self._gather_bytes_step = (
            model.num_layers * 2 * self.B * self.T * model.num_kv_heads
            * model.head_dim * cfg.kv_cache_dtype.itemsize)
        self.scheduler = SlotScheduler(
            self.B, self.C, self.T, max_queue=max_queue, page_gate=self._kv,
            reserve_extra=self._spec_k, shed_infeasible=shed_infeasible,
            tracer=tracer)
        self.eos_token_id = eos_token_id
        self._seed = seed
        self._clock = clock
        self._kv_quant = kv_quant
        self._chunk_tokens = prefill_chunk_tokens
        self._chunking: dict = {}  # slot -> _ChunkPrefill in progress
        self._chunk_rr = 0         # budget-rotation cursor (fairness)
        self.async_decode = async_decode
        pool = model.make_page_pool(num_pages, page_size, quant=kv_quant)
        self.caches = pool.caches
        self._page_bytes = pool.page_bytes
        self.valid = torch.zeros((self.B, self.T), dtype=torch.int32,
                                 device=device)
        if self._spec_k:
            # the draft's KV stays contiguous [B, T]: its rollback is free
            # (rejected cells sit past the rewound offset, hidden by the
            # causal mask and overwritten by the next round)
            self._draft_caches = draft.empty_caches()
            self._draft_valid = torch.zeros((self.B, self.T),
                                            dtype=torch.int32, device=device)
        self._offsets = np.full((self.B,), self.T, np.int32)  # T = parked
        self._next_tok = np.zeros((self.B,), np.int64)
        # per-slot occupancy generation, bumped at every admission: a step
        # in flight while its slot was swept and re-granted is discarded
        self._slot_gen = np.zeros((self.B,), np.int64)
        self._last_tok_time: List[Optional[float]] = [None] * self.B
        # per-slot sampling state, written once at admission; it stays on
        # the host, where each sampled row's generator is seeded
        self._keys: List[Optional[int]] = [None] * self.B
        self._temps = np.zeros((self.B,), np.float32)
        self._topks = np.zeros((self.B,), np.int32)
        self._topps = np.ones((self.B,), np.float32)
        # the in-flight decode step or round: (fetch handle, [(slot, req,
        # generation)], and in spec mode the last proposals)
        self._pending: Optional[tuple] = None
        self._tables_dev = None  # device mirror of the block tables
        PP = self.T // page_size
        AP = (0 if adapter_store is None
              else adapter_store.layout.pages_per_adapter)
        self._io = _Staging(device,
                            (3 + self._spec_k) * self.B + self.B * (PP + AP),
                            (self._spec_k + 3) * self.B)
        self.decode_steps = 0  # batched decode steps run (plain mode)
        self.spec_rounds = 0   # speculative rounds run (spec mode)
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_committed = 0
        self.prefill_chunks = 0  # chunk dispatches run
        self.prewarmed = 0  # phases run over a parked batch (prewarm_graphs)
        self.quant_pages = 0  # pages written through a quantize-on-write
        self._steps = 0  # engine steps begun (the fault points' context)
        self.preemptions = 0
        self.shed = 0
        self.rejected = 0
        self.expired_before_prefill = 0
        # multi-adapter state: the device adapter pool, per-slot adapter
        # page tables (an all-NULL row is adapter 0) and their device
        # mirror, and the slot -> pinned adapter map
        self._adapters = adapter_store
        self._atables_dev = None
        self._draft_lora = False
        if adapter_store is not None:
            if adapter_store.registry is None:
                adapter_store.attach_registry(self.registry)
            lay = adapter_store.layout
            if AdapterLayout.for_model(model, lay.rank, lay.page_elems) != lay:
                raise ValueError(
                    f"adapter_store layout {lay} does not fit the model")
            self._apool = model.make_adapter_pool(lay, adapter_store.num_pages)
            self._adapter_tables = np.zeros((self.B, lay.pages_per_adapter),
                                            np.int32)
            self._slot_adapter = [0] * self.B
            self._adapter_dirty = True
            if draft is not None and AdapterLayout.for_model(
                    draft, lay.rank, lay.page_elems) == lay:
                # the draft slices the target's pool with the same layout
                self._draft_lora = True
                draft._adapter_layout = lay
        ml = self.memory_ledger
        if ml is not None:
            # every device subsystem this engine owns at its LOGICAL size
            # (the page_bytes arithmetic the admission gates use), then one
            # device-truth poll; what the allocator holds beyond the sum
            # (the CUDA graphs' pools, activations) is the remainder
            ml.set("params", tree_bytes(model.module))
            ml.set("kv_pool", num_pages * self._page_bytes)
            if self._spec_k:
                ml.set("draft_kv", tree_bytes(self._draft_caches))
                ml.set("draft_params", tree_bytes(draft.module))
            if adapter_store is not None:
                ml.set("adapter_pool", tree_bytes(self._apool))
            ml.poll_device()
        # pre-declared so a zero-request engine still exports the full set
        reg = self.registry
        if kv_quant is not None:
            reg.counter(QUANT_PAGES_TOTAL)
        reg.gauge("serving/queue_depth")
        reg.gauge("serving/slots_active")
        reg.histogram("serving/ttft_ms", MS_BUCKETS)
        reg.histogram("serving/intertoken_ms", MS_BUCKETS)
        reg.histogram("serving/step_ms", MS_BUCKETS)
        reg.histogram("serving/host_blocked_ms", MS_BUCKETS)
        reg.gauge("serving/last_step_ms")
        for c in ("admitted", "finished", "cancelled", "timed_out", "tokens",
                  "rejected", "failed", "slow_steps", "preemptions", "shed",
                  "expired_before_prefill", "prefill_chunks"):
            reg.counter(f"serving/{c}_total")
        for cls in PRIORITIES:
            reg.histogram(f"serving/ttft_ms_{cls}", MS_BUCKETS)
            reg.histogram(f"serving/intertoken_ms_{cls}", MS_BUCKETS)
        if self._spec_k:
            for c in ("spec_proposed", "spec_accepted", "spec_committed",
                      "spec_rounds"):
                reg.counter(f"serving/{c}_total")

    # -- request surface ---------------------------------------------------

    @property
    def puts(self) -> int:
        return self._io.puts

    @property
    def fetches(self) -> int:
        return self._io.fetches

    def submit(self, request: Request) -> None:
        """Queue a request.  Raises ``AdmissionError`` when it can never
        fit or names an adapter the engine cannot serve, ``RateLimited``
        when its tenant is over its limit, ``SLOInfeasible`` when its
        deadline is dead under the current load (``shed_infeasible``),
        ``BackpressureError`` when the bounded queue is full, ``ValueError``
        for a sampled request on a seedless engine."""
        if self.lockstep is not None:
            sp = request.sampling
            self.lockstep.note(
                "submit", request.request_id, tuple(request.prompt_ids),
                request.max_new_tokens, sp.temperature, sp.top_k, sp.top_p,
                request.priority, request.deadline_s, request.adapter_id)
        if request.sampling.temperature > 0.0 and self._seed is None:
            raise ValueError(
                f"request {request.request_id} samples (temperature "
                f"{request.sampling.temperature}) but the engine has no seed")
        aid = request.adapter_id
        if aid and self._adapters is None:
            raise AdmissionError(
                f"request {request.request_id} names adapter {aid} but the "
                "engine has no adapter_store")
        if aid and not self._adapters.registered(aid):
            raise AdmissionError(
                f"request {request.request_id} names unregistered adapter "
                f"{aid}")
        tr = self.tracer
        root = None
        if tr is not None:
            # the request's root span, submit -> terminal; the scheduler
            # parents its queue span under it, and trace_id links the
            # terminal serving_stats record to it
            request.trace_id = request.request_id
            root = tr.begin(
                "request", request_id=request.request_id, t=self._clock(),
                priority=request.priority, prompt_len=request.prompt_len,
                max_new_tokens=request.max_new_tokens, adapter_id=aid,
                hop=getattr(request, "hop", 0))
            request._trace_root = root
            self._rt[request.request_id] = {"root": root}
        try:
            self.scheduler.submit(request, now=self._clock())
        except SLOInfeasible:
            self.shed += 1
            self.registry.counter("serving/shed_total").inc()
            self._trace_refused(request, root, shed="slo_infeasible")
            raise
        except BackpressureError:
            self.rejected += 1
            self.registry.counter("serving/rejected_total").inc()
            self._trace_refused(request, root, rejected="backpressure")
            raise
        except BaseException:
            self._trace_refused(request, root, rejected="error")
            raise

    def _trace_refused(self, request: Request, root, **attrs) -> None:
        """A refused submit ends its root span at once."""
        if root is not None:
            self._rt.pop(request.request_id, None)
            self.tracer.end(root, t=self._clock(), **attrs)

    def cancel(self, request_id: int) -> bool:
        if self.lockstep is not None:
            self.lockstep.note("cancel", request_id)
        return self.scheduler.cancel(request_id)

    @property
    def has_work(self) -> bool:
        # an in-flight step is work: its tokens still need a step() to be
        # collected and emitted
        return (self.scheduler.queue_depth > 0
                or self.scheduler.active_count > 0
                or self._pending is not None)

    # -- disaggregation surface (fleet migration, fleet prefix cache) -----

    def withdraw(self, request_id: int) -> Request:
        """Pull a live request out of this engine WITHOUT a terminal output
        (the disaggregated fleet's migration hop).  The slot is parked as a
        preemption parks it (offset ``T``, pages and adapter pin released,
        resume pin dropped), but nothing is requeued and no stats record is
        written: the request goes on on a sibling replica.  The slot's
        occupancy generation moves on, so a row of a step still in flight
        is dropped at its collect and the withdrawn request emits no token
        here.  Its committed prompt chain survives through the prefix
        index's own references (the one a migration exports).  Raises
        ``KeyError`` for an id this engine does not hold."""
        self._tp1_only("withdraw")
        now = self._clock()
        # the open compute phase ends before the scheduler forgets the
        # request (a queued withdrawal's wait span is the scheduler's)
        if self.scheduler.slot_of(request_id) is not None:
            rt = self._rt.get(request_id)
            if rt is not None and self.tracer is not None:
                self.tracer.end(rt.pop("phase", None), t=now, migrated=True)
        req, slot = self.scheduler.withdraw(request_id, now=now)
        if slot is not None:
            self._slot_gen[slot] += 1
            self._park(slot)
        # a parked victim being migrated drops its local resume pin: the
        # destination resumes from the imported chain instead
        self._kv.release_resume(req)
        if self.tracer is not None:
            rt = self._rt.pop(request_id, None)
            if rt is not None:
                self.tracer.end(rt.get("root"), t=now, migrated=True,
                                new_tokens=len(req.generated))
        if self._perf is not None:
            self._perf_t0.pop(request_id, None)
        return req

    def _tp1_only(self, what: str) -> None:
        if self.tp_size > 1:
            raise NotImplementedError(
                f"{what} at tensor-parallel degree {self.tp_size}: the "
                "fleet's surface (migration, page-chain transfer, weight "
                "swaps) is not ported to tp > 1 yet (ROADMAP A9d)")

    def export_prefix(self, fingerprint: int) -> Optional[ChainExport]:
        """Serialize the committed chain whose terminal fingerprint is
        ``fingerprint`` out of this engine's prefix index (the donor half of
        a migration and of the fleet-global prefix cache); None when the
        index does not hold it.  May be called while a step is in flight:
        the chain's pages are committed, and the copy, on the same stream,
        is ordered after the in-flight step's writes.  The export makes a
        small asynchronous upload of the page ids and ONE synchronizing
        device-to-host copy of the packed rows and payload, booked as one
        explicit fetch (allowed under ``forbid``)."""
        self._tp1_only("export_prefix")
        if self._kv.index is None:
            return None
        hit = self._kv.index.find_fingerprint(fingerprint)
        if hit is None:
            return None
        keys, pages, payload = hit
        t0 = time.perf_counter()
        with allow_sync():
            export = export_chain(self.caches, keys, pages,
                                  page_size=self._kv.page_size,
                                  payload=payload, registry=self.registry)
        self._io.fetches += 1
        self._audit.note_fetch(time.perf_counter() - t0, label="kvcache")
        return export

    def import_prefix(self, export: ChainExport) -> int:
        """Admit an exported chain into this engine's pool and prefix index
        (the receiver half), in place: every captured graph keeps its pool.
        Transactional (:func:`~..kvcache.transfer.import_chain`: any
        failure, a chaos kill at ``kvcache/page_import`` included, leaks
        nothing).  The import makes one asynchronous host-to-device copy of
        the packed rows and payload and a small one of the destination
        page ids, booked as one explicit put.  Returns the pages copied in
        (0 = already fully cached here)."""
        self._tp1_only("import_prefix")
        if self._kv.index is None:
            raise TransferError(
                "engine has no prefix index; cannot import a chain")
        matched, _ = self._kv.index.peek(export.keys)
        already = sum(1 for p in matched if p != NULL_PAGE)
        with allow_sync():
            self.caches = import_chain(self.caches, self._kv.index, export,
                                       registry=self.registry)
        self._io.puts += 1
        self._audit.note_put()
        return export.n_pages - already

    # -- live weights ----------------------------------------------------

    @property
    def shares_model(self) -> bool:
        """Whether another engine has held this engine's module: a weight
        swap then moves the engine to a private model instead of writing
        the parameters in place (:meth:`install_params`)."""
        return _HOLDERS.shared(self.model.module)

    @torch.no_grad()
    def install_params(self, params: dict, version: int) -> None:
        """Commit point of a live weight swap (``weights.WeightSwapper``,
        which has validated ``params``, ``{name: tensor}`` over the
        module's parameter names).

        - The engine is the only engine that ever held its module: each
          tensor is copied INTO its parameter on the current stream,
          straight from the caller's tensor (which may lie on the host),
          so no second weight set is held.  Every captured graph keeps
          its addresses, so nothing is captured again; a step in flight
          runs first in stream order, with the old weights, and its
          tokens carry ``_pending_version``.
        - The module is shared (:attr:`shares_model`: a fleet's replicas
          share one, and its factory builds rebuilt replicas on it, so its
          weights stay the ones the factory's engines are stamped with):
          the swapper has staged ``params`` on the model's device, and the
          engine moves to a private model whose module holds those staged
          tensors (no further copy), with its own phase graphs, and
          captures there, inside this call and over a parked batch, every
          phase it had captured on the shared model, booked in the compile
          ledger as the new generation's warm-up (no ``compile_storm``).
          The JAX engine makes a shallow per-engine view of the params
          instead: its programs take the params as an argument.

        Then the prefix cache is flushed (cached KV and full-hit logits
        are the outgoing weights'), the version bumps, and the memory
        ledger accounts the live parameters."""
        self._tp1_only("install_params")
        if self.shares_model:
            self._move_to_private_model(params)
        else:
            for name, p in self.model.module.named_parameters():
                p.copy_(params[name])
        self.weights_version = int(version)
        # cached prefix KV (and full-hit prefill logits) embody the
        # OUTGOING weights: no admission after the swap may hit them
        dropped = self._kv.flush_prefix_cache()
        if dropped:
            logger.info("serving: weight swap flushed %d cached prefix "
                        "chain node(s)", dropped)
        if self.memory_ledger is not None:
            self.memory_ledger.account_tree("params", self.model.module)

    def _move_to_private_model(self, params: dict) -> None:
        """Serve from a per-engine copy of the shared model over the staged
        parameters: buffers are copied, parameters are the staged tensors,
        the phase graphs start empty and are captured again here for this
        engine's templates; its graphs on the shared model are dropped."""
        model = self.model
        templates = self.graph_templates(draft=False)
        self._drop_graphs(draft=False)
        module = model.module
        memo = {id(p): torch.nn.Parameter(params[name].to(p.device),
                                          requires_grad=False)
                for name, p in module.named_parameters()}
        view = copy.copy(model)
        view.module = copy.deepcopy(module, memo)
        view.graphs = PhaseGraphs(capture=model.graphs.capture)
        _HOLDERS.release(module, self)
        _HOLDERS.hold(view.module, self)
        self.model = view
        self.prewarm_graphs(templates,
                            label=f"weights_v{self.weights_version + 1}")

    # -- phase graphs of this engine's state -------------------------------

    def _graph_states(self, draft: bool = True) -> list:
        """``(phase-graph cache, state key)`` of every state this engine's
        phases capture over: the pool (with the adapter pool on adapter
        phases) and, in spec mode, the draft's contiguous caches."""
        states = [(self.model.graphs,
                   PhaseGraphs.state_key(self.caches, self.valid))]
        if self._adapters is not None:
            states.append((self.model.graphs, PhaseGraphs.state_key(
                self.caches, self.valid, self._apool)))
        if self._spec_k and draft:
            states.append((self._draft_model.graphs, PhaseGraphs.state_key(
                self._draft_caches, self._draft_valid,
                self._apool if self._draft_lora else None)))
        return states

    def graph_templates(self, draft: bool = True) -> list:
        """The phases this engine has captured (or, on the CPU under a
        ledger, accounted), as ``(phase key without the state, input
        shapes and dtypes)``: what :meth:`prewarm_graphs` captures again
        over another engine's state.  ``draft=False`` leaves the draft's
        out."""
        out = []
        for graphs, state in self._graph_states(draft):
            for key in graphs.keys_over(state):
                out.append((key[0][:-1], key[1]))
        return out

    def prewarm_graphs(self, templates, label: str = "prewarm") -> int:
        """Capture ``templates`` (:meth:`graph_templates` of this engine or
        of an engine it replaces) over this engine's state, on a parked
        batch (every offset ``T``: nothing is written), booked in the
        compile ledger as warm-up.  A replica rebuilt after a crash or a
        drain takes its predecessor's phases this way, as the JAX engine
        reuses its compiled programs.  Returns the phases run."""
        led = self.model.compile_ledger
        window = (led.rewarm(label) if led is not None
                  else contextlib.nullcontext())
        n = 0
        with window:
            for phase, shapes in templates:
                bufs = [torch.full(s, self.T, dtype=d, device=self.device)
                        if i == 1 else
                        torch.zeros(s, dtype=d, device=self.device)
                        for i, (s, d) in enumerate(shapes)]
                name = phase[0]
                if name == "decode_slots":
                    lora = phase[1]
                    self._draft_model.decode_slots(
                        bufs[0], bufs[1], self._draft_caches,
                        self._draft_valid,
                        self._apool if lora else None,
                        bufs[2] if lora else None)
                else:
                    _, pk, lora = phase
                    self.model._paged_phase(
                        name, bufs[0], bufs[1], bufs[2], self.caches,
                        self.valid, pk, name != "verify_pages",
                        self._apool if lora else None,
                        bufs[3] if lora else None)
                n += 1
        self.prewarmed += n
        return n

    def _drop_graphs(self, draft: bool = True) -> int:
        """Drop the graphs captured over this engine's state from the
        (possibly shared) models' phase-graph caches."""
        return sum(graphs.drop(graphs.keys_over(state))
                   for graphs, state in self._graph_states(draft))

    def declare_warmup_done(self) -> None:
        """Everything this engine will run is captured now: any capture the
        compile ledger sees from here on is a ``compile_storm`` (counted,
        flight-warned, traced), and the perf attribution's cost join counts
        only the executions from here on.  No-op without either."""
        if self.compile_ledger is not None:
            self.compile_ledger.declare_warmup_done("engine")
        if self._perf is not None:
            self._perf.mark_warmup_done()

    def step(self) -> List[RequestOutput]:
        """One engine iteration: sweep -> preempt for priority ->
        admit/prefill -> prefill chunks -> decode (or a speculative round)
        -> stop detection -> slot free.  Async: collect the in-flight step,
        dispatch the next (the guarded section), then run the collected
        step's host work.  Then the step's gauges, its time, the watchdog,
        the flight record, the perf gauges and the health rules.  Returns
        the requests that reached a terminal state during this step.  With
        a memory ledger, an exception that reads as memory exhaustion
        dumps ``memory_breakdown.json`` (reason ``oom:...``) naming the
        biggest holders before it propagates."""
        if self.memory_ledger is None:
            return self._step()
        try:
            return self._step()
        except Exception as e:
            self.memory_ledger.oom_dump(e)
            raise

    def _step(self) -> List[RequestOutput]:
        outputs: List[RequestOutput] = []
        now = self._clock()
        t_step0 = now
        self._steps += 1
        swept = self.scheduler.sweep(now)
        if swept:
            self._park_free_slots()
            for req in swept:
                # a swept active request still has its compute phase open
                self._trace_end_phase(req, t=now, swept=req.state.value)
                self.registry.counter(
                    "serving/cancelled_total"
                    if req.state is RequestState.CANCELLED
                    else "serving/timed_out_total").inc()
                outputs.append(self._emit(req, now))
        self._preempt_for_priority(now)
        for slot, req in self.scheduler.admit(now):
            self._prefill_into_slot(slot, req, outputs)
        if self._chunking:
            self._run_prefill_chunks(outputs)
        collect, dispatch = ((self._spec_collect, self._spec_dispatch)
                             if self._spec_k else
                             (self._collect_decode, self._dispatch_decode))
        if self.async_decode:
            with self._audit.section("serving/decode"):
                post = collect()
                active = self._decoding()
                if active:
                    dispatch(active)
            self._finish_decode(post, outputs)
        else:
            active = self._decoding()
            if active:
                dispatch(active)
                self._finish_decode(collect(), outputs)
        self._end_step(t_step0, outputs)
        return outputs

    def _end_step(self, t_step0: float, outputs: list) -> None:
        """The step's gauges, its time (histogram, gauge, watchdog) and its
        flight record: host numbers only."""
        reg = self.registry
        reg.gauge("serving/queue_depth").set(self.scheduler.queue_depth)
        reg.gauge("serving/slots_active").set(self.scheduler.active_count)
        self._kv.export_gauges()
        if self._adapters is not None:
            self._adapters.export_gauges()
        step_s = self._clock() - t_step0
        reg.gauge("serving/last_step_ms").set(step_s * 1e3)
        reg.histogram("serving/step_ms", MS_BUCKETS).observe(step_s * 1e3)
        if self.step_timeout_s is not None and step_s > self.step_timeout_s:
            reg.counter("serving/slow_steps_total").inc()
            logger.warning(
                "serving: engine step %d took %.3fs (> watchdog %.3fs; "
                "active=%d queued=%d)", self._steps, step_s,
                self.step_timeout_s, self.scheduler.active_count,
                self.scheduler.queue_depth)
        if self.obs is not None:
            self.obs.flight.record(
                self._steps, step_time_s=step_s,
                queue_depth=self.scheduler.queue_depth,
                slots_active=self.scheduler.active_count,
                terminal=len(outputs))
        if self._perf is not None:
            # the perf/* rollup gauges the health trend rules read
            self._perf.update_metrics()
        if self._health is not None:
            # on the engine clock: alert edges share the spans' timescale
            self._health.on_step(now=self._clock())

    def dump_flight(self, reason: str) -> Optional[str]:
        """Persist the per-step flight ring (with an ``obs`` hub, on
        tensor-parallel rank 0); the crash-evidence path ``replay_trace``
        takes."""
        if self.obs is not None and self.primary:
            return self.obs.dump_flight(reason)
        return None

    def run_until_complete(self, max_steps: Optional[int] = None
                           ) -> List[RequestOutput]:
        """Drive ``step()`` until queue and slots drain; returns every
        terminal output in completion order."""
        outputs: List[RequestOutput] = []
        steps = 0
        while self.has_work:
            outputs.extend(self.step())
            steps += 1
            if max_steps is not None and steps >= max_steps:
                raise RuntimeError(
                    f"serving engine did not drain in {max_steps} steps "
                    f"(queue={self.scheduler.queue_depth}, "
                    f"active={self.scheduler.active_count})")
        return outputs

    def close(self) -> None:
        """Seal every open span (aborted), account an open batch step, dump
        the memory breakdown (reason ``close``), close the stats file, and
        drop this engine's phase graphs from its (possibly shared) models:
        they hold a pool that is going away, and in a fleet whose replicas
        are rebuilt they would otherwise fill the shared LRU."""
        self._drop_graphs()
        _HOLDERS.release(self.model.module, self)
        tr = self.tracer
        if tr is not None:
            now = self._clock()
            self.scheduler.trace_abort(now)
            if self._batch_span is not None:
                tr.end(self._batch_span, t=now, aborted=True)
                self._batch_span = None
            for rt in self._rt.values():
                tr.end(rt.pop("phase", None), t=now, aborted=True)
                tr.end(rt.get("root"), t=now, aborted=True)
            self._rt.clear()
        if self._perf is not None and self._batch_t0 is not None:
            self._note_batch(self._clock())
        if self.memory_ledger is not None:
            try:
                self.memory_ledger.dump(reason="close")
            except OSError as e:  # teardown IO must not mask the exit path
                logger.warning("serving: memory breakdown dump failed: %s", e)
        if self._stats_f is not None:
            self._stats_f.close()
            self._stats_f = None

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # -- tracing -----------------------------------------------------------

    def _trace_begin_phase(self, req: Request, name: str,
                           t: Optional[float] = None, **attrs) -> None:
        """Open a compute phase span (prefill / decode) under the request's
        root.  Phase boundaries reuse one timestamp (the grant, the first
        token, the terminal instant), so a request's phases tile its
        lifetime."""
        tr = self.tracer
        if tr is None:
            return
        rt = self._rt.get(req.request_id)
        if rt is None:
            return
        rt["phase"] = tr.begin(name, request_id=req.request_id,
                               parent=rt["root"], t=t, **attrs)

    def _trace_end_phase(self, req: Request, t: Optional[float] = None,
                         **attrs) -> None:
        if self.tracer is None:
            return
        rt = self._rt.get(req.request_id)
        if rt is None:
            return
        self.tracer.end(rt.pop("phase", None), t=t, **attrs)

    def _trace_phase_attrs(self, req: Request, **attrs) -> None:
        """Annotate the request's open phase span."""
        if self.tracer is None:
            return
        rt = self._rt.get(req.request_id)
        if rt is not None and rt.get("phase") is not None:
            rt["phase"].attrs.update(attrs)

    def _trace_phase_of(self, req: Request):
        rt = self._rt.get(req.request_id) if self.tracer is not None else None
        return rt.get("phase") if rt is not None else None

    # -- internals ---------------------------------------------------------

    def _decoding(self) -> list:
        return [(slot, req) for slot, req in self.scheduler.active()
                if req.state is RequestState.DECODE]

    def _prefill_into_slot(self, slot: int, req: Request, outputs: list) -> None:
        """The adapter pin (a cold adapter's pages written into the adapter
        pool), block-table assembly (prefix lookup, atomic page
        allocation), then either the first token from a whole prefill
        (single-request prefill unless the whole prompt is cached, page
        writes of only the uncached prompt pages) or, in chunked mode, the
        reserved fresh pages handed to the chunk loop.  The draft, in spec
        mode, prefills its contiguous row whole either way.  A failure
        mid-admission releases the pin and every page, fails the one
        request and re-raises; an adapter pool with every page pinned
        fails only the request, and serving goes on.  A request whose
        deadline died since the step's sweep is timed out without a
        prefill; a preempted victim's park ends here, and its resume pin
        gives way to the slot's own references."""
        now = self._clock()
        if req.parked_at is not None:
            t_grant = req.prefill_time if req.prefill_time is not None else now
            req.preempted_ms += max(t_grant - req.parked_at, 0.0) * 1e3
            req.parked_at = None
        # the prefill phase starts at the grant instant, where the queue
        # or preempted span ended
        self._trace_begin_phase(
            req, "prefill",
            t=req.prefill_time if req.prefill_time is not None else now,
            slot=slot)
        if self._perf is not None:
            # the grant instant the span starts at
            self._perf_t0[req.request_id] = (
                req.prefill_time if req.prefill_time is not None else now)
        if req.expired(now):
            self._expire_before_prefill(slot, req, outputs, now)
            return
        self._slot_gen[slot] += 1  # a fresh occupancy generation begins
        aid = req.adapter_id
        if aid and not self._acquire_adapter(slot, req, outputs):
            return
        L = req.prompt_len
        ids = np.zeros((1, self.C), np.int64)
        ids[0, self.C - L:] = req.prompt_ids  # LEFT-padded
        valid_np = (np.arange(self.C) >= self.C - L).astype(np.int32)
        row_valid = np.concatenate(
            [valid_np, np.zeros((self.T - self.C,), np.int32)])
        try:
            cached = self._kv.admit_slot(slot, req, ids[0], valid_np,
                                         engine_step=self._steps)
        except BaseException as e:
            now = self._clock()
            self._fail_slot(slot, req, outputs, now,
                            reason=f"page_alloc:{type(e).__name__}")
            raise
        # the slot's lookup references now cover the chain a preemption
        # pinned, if any
        self._kv.release_resume(req)
        # an adapter request prefills under its adapter (adapter 0, the
        # base model, takes the plain prefill)
        adapter = ((self._apool, self._adapter_tables[slot][None, :])
                   if aid else None)
        if self._spec_k:
            _, drow = (self._draft_model.prefill_one_lora(
                ids, valid_np[None, :], *adapter)
                if adapter is not None and self._draft_lora
                else self._draft_model.prefill_one(ids, valid_np[None, :]))
            self._draft_caches, self._draft_valid = \
                self._draft_model.insert_slot(self._draft_caches, drow,
                                              self._draft_valid, row_valid,
                                              slot)
        fresh = self._kv.fresh_pages(slot) if cached is None else []
        if self._chunk_tokens is not None and fresh:
            # chunked mode: every fresh prefill goes through the chunk loop;
            # fresh pages are one contiguous logical run (padding pages lead
            # and ride the NULL page, a matched prefix is a leading chain)
            lps = [lp for lp, _ in fresh]
            assert lps == list(range(lps[0], lps[0] + len(lps))), (
                f"fresh prompt pages not contiguous: {lps}")
            self.valid = self.model.insert_valid(self.valid, row_valid, slot)
            self._chunking[slot] = _ChunkPrefill(req, ids[0], row_valid,
                                                 fresh)
            # the prefill span stays open across the chunked steps; each
            # chunk adds a child span under it
            self._trace_phase_attrs(req, chunked=True, fresh_pages=len(fresh))
            self._set_sampling_state(slot, req)
            return
        if cached is not None:
            logits = cached  # exact full-prompt hit: no prefill compute
            self._trace_phase_attrs(req, prefix_hit=True)
        else:
            logits, row_caches = (
                self.model.prefill_one_lora(ids, valid_np[None, :], *adapter)
                if adapter is not None
                else self.model.prefill_one(ids, valid_np[None, :]))
            logits = perturb("serving/prefill_logits", logits,
                             request_id=req.request_id,
                             engine_step=self._steps)
            self._trace_phase_attrs(req, fresh_pages=len(fresh))
            for lp, phys in fresh:
                self.caches = self.model.write_page(
                    self.caches, row_caches, lp, phys, row_valid=valid_np)
            self._count_quant(len(fresh))
        self.valid = self.model.insert_valid(self.valid, row_valid, slot)
        self._set_sampling_state(slot, req)
        self._finish_prefill(slot, req, logits, outputs,
                             prefilled_fresh=cached is None)

    def _acquire_adapter(self, slot: int, req: Request, outputs: list
                         ) -> bool:
        """Pin the request's adapter at admission, before any KV page is
        taken, and write a cold adapter's pages into the pool; from here
        the slot holds the pin and every terminal path releases it
        (:meth:`_release_adapter`).  Returns False when the adapter pool
        has no page to spare (every resident adapter pinned): the request
        fails and serving goes on.  Any other failure fails the request
        and re-raises."""
        aid = req.adapter_id
        tr = self.tracer
        aspan = (tr.begin("adapter_acquire", request_id=req.request_id,
                          parent=self._trace_phase_of(req), t=self._clock(),
                          adapter_id=aid)
                 if tr is not None else None)
        try:
            loads = self._adapters.acquire(aid, engine_step=self._steps)
            if aspan is not None:
                tr.end(aspan, t=self._clock(), loads=len(loads))
        except BaseException as e:
            now = self._clock()
            if aspan is not None:
                tr.end(aspan, t=now, failed=type(e).__name__)
            self._fail_slot(slot, req, outputs, now,
                            reason=f"adapter:{type(e).__name__}")
            if isinstance(e, PoolExhausted):
                return False
            raise
        self._slot_adapter[slot] = aid
        self._adapter_tables[slot] = self._adapters.table(aid)
        self._adapter_dirty = True
        if loads:
            phys, blocks = zip(*loads)
            self.model.write_adapter_page(self._apool, np.stack(blocks), phys)
        return True

    def _set_sampling_state(self, slot: int, req: Request) -> None:
        """The slot's per-request sampler state, written once at
        admission."""
        s = req.sampling
        self._keys[slot] = (request_key(self._seed, req.request_id)
                            if s.temperature > 0.0 else None)
        self._temps[slot], self._topks[slot], self._topps[slot] = (
            s.temperature, s.top_k, s.top_p)

    def _finish_prefill(self, slot: int, req: Request, logits, outputs: list,
                        prefilled_fresh: bool) -> None:
        """The prefill's first-token tail, shared by the whole prefill and
        the chunk loop's final chunk: sample, finite gate, register the
        prefix chain, move to DECODE, stream and emit."""
        s = req.sampling
        t0 = time.perf_counter()
        toks, finite = sampled_tokens(
            logits, [self._keys[slot]], [0], [s.temperature], [s.top_k],
            [s.top_p])
        # the first token and its finite flag come up in one copy
        self._io.fetches += 1
        self._audit.note_fetch(time.perf_counter() - t0, label="serving")
        now = self._clock()
        self.registry.counter("serving/admitted_total").inc()
        if not finite[0]:
            # a poisoned prefill fails ITS request and is never cached
            self._fail_slot(slot, req, outputs, now)
            return
        if prefilled_fresh:
            self._kv.finish_insert(slot, logits)
        req.transition(RequestState.DECODE)
        # prefill ends and decode begins at the same first-token instant
        self._trace_end_phase(req, t=now)
        self._trace_begin_phase(req, "decode", t=now)
        if self._perf is not None:
            t0 = self._perf_t0.pop(req.request_id, None)
            if t0 is not None:
                self._perf.note_phase("prefill", (now - t0) * 1e3)
        if req.first_token_time is None:
            req.first_token_time = now
            if req.submit_time is not None:
                ttft_s = now - req.submit_time
                self.registry.histogram(
                    "serving/ttft_ms", MS_BUCKETS).observe(ttft_s * 1e3)
                self.registry.histogram(
                    f"serving/ttft_ms_{req.priority}", MS_BUCKETS).observe(
                        ttft_s * 1e3)
                # the shedding estimate's time to first token
                self.scheduler.note_first_token(ttft_s)
        self._append_token(slot, req, int(toks[0]), now)
        if req.done:
            outputs.append(self._emit(req, now))
        else:
            self._offsets[slot] = self.C
            self._next_tok[slot] = int(toks[0])

    def _run_prefill_chunks(self, outputs: list) -> None:
        """Advance the prefilling slots by up to the per-step budget
        (``prefill_chunk_tokens``, in pages): each chunk writes page-aligned
        prompt KV into the slot's reserved pages through
        ``prefill_chunk_pages``, and the final chunk's logits feed the first
        token.  The start slot rotates step to step so one long prompt
        cannot hog the budget; interactive prefills take it first.  Each
        slot's deadline is checked again right before its chunk: a dead
        request burns no chunk.  A failed chunk fails its one request,
        reclaims every page and re-raises."""
        budget = self._chunk_tokens // self._kv.page_size
        slots = sorted(self._chunking)
        start = self._chunk_rr % len(slots)
        self._chunk_rr += 1
        rotated = slots[start:] + slots[:start]
        rotated.sort(key=lambda s: self._chunking[s].req.priority
                     != PRIORITY_INTERACTIVE)
        for slot in rotated:
            if budget <= 0:
                break
            st = self._chunking.get(slot)
            if st is None:
                continue
            now = self._clock()
            if st.req.expired(now):
                self._chunking.pop(slot)
                self._expire_before_prefill(slot, st.req, outputs, now)
                continue
            n = min(budget, st.pages_remaining)
            budget -= n
            try:
                self._dispatch_chunk(slot, st, n)
            except BaseException as e:
                self._fail_slot(slot, st.req, outputs, self._clock(),
                                reason=f"prefill_chunk:{type(e).__name__}")
                raise
            if st.pages_remaining == 0:
                self._chunking.pop(slot)
                self._finish_prefill(slot, st.req, st.logits, outputs,
                                     prefilled_fresh=True)

    def _dispatch_chunk(self, slot: int, st: _ChunkPrefill,
                        n_pages: int) -> None:
        """One ``prefill_chunk_pages`` call over the slot's next ``n_pages``
        fresh prompt pages (page-aligned, contiguous)."""
        page = self._kv.page_size
        off = st.fresh[st.next_i][0] * page
        width = n_pages * page
        adapter = ((self._apool, self._adapter_tables[slot][None, :])
                   if self._adapters is not None else (None, None))
        tr = self.tracer
        # one start stamp: the chunk span and its perf accounting measure
        # the same interval
        t0 = (self._clock() if tr is not None or self._perf is not None
              else None)
        cspan = (tr.begin("prefill_chunk", request_id=st.req.request_id,
                          parent=self._trace_phase_of(st.req),
                          t=t0, tok_start=int(off),
                          tok_end=int(off + width), pages=n_pages)
                 if tr is not None else None)
        # a failure here fails the one request and reclaims its pages
        try:
            fault_point("serving/prefill_chunk",
                        request_id=st.req.request_id,
                        engine_step=self._steps, chunk_offset=off)
            logits, self.caches = self.model.prefill_chunk_pages(
                st.ids_row[None, off:off + width], off,
                self._kv.tables[slot][None, :], self.caches,
                st.valid_row[None, :], paged_kernel=self._paged_kernel,
                apool=adapter[0], atables=adapter[1])
        except BaseException as e:
            if t0 is not None:
                self._end_chunk(cspan, t0, failed=type(e).__name__)
            raise
        if t0 is not None:
            self._end_chunk(cspan, t0)
        if not self._paged_kernel:
            # the gather path attends a [1, T] clone of the pool
            self.registry.counter(GATHER_BYTES_TOTAL).inc(
                self._gather_bytes_step // self.B)
        st.next_i += n_pages
        if st.pages_remaining == 0:
            # the logits the first token samples from
            logits = perturb("serving/prefill_logits", logits,
                             request_id=st.req.request_id,
                             engine_step=self._steps)
        st.logits = logits
        st.req.prefill_chunks += 1
        self.prefill_chunks += 1
        self.registry.counter("serving/prefill_chunks_total").inc()
        self._count_quant(n_pages)

    def _end_chunk(self, cspan, t0: float, **attrs) -> None:
        """Close a chunk's span and account its phase time, at one stamp."""
        t1 = self._clock()
        if cspan is not None:
            self.tracer.end(cspan, t=t1, **attrs)
        if self._perf is not None:
            self._perf.note_phase("prefill_chunk", (t1 - t0) * 1e3)

    def _count_quant(self, pages: int) -> None:
        """Pages written through the int8 quantize-on-write (a no-op on a
        full-precision pool)."""
        if self._kv_quant is not None:
            self.quant_pages += pages
            self.registry.counter(QUANT_PAGES_TOTAL).inc(pages)

    def _count_gather_step(self) -> None:
        """One gather-path step's [B, T] K/V clone; the kernel path never
        counts (``kvcache/gather_bytes_total`` stays 0)."""
        if not self._paged_kernel:
            self.registry.counter(GATHER_BYTES_TOTAL).inc(
                self._gather_bytes_step)

    def _tok_idx(self, active: list) -> np.ndarray:
        tok_idx = np.zeros((self.B,), np.int32)
        for slot, req in active:
            tok_idx[slot] = len(req.generated)
        return tok_idx

    def _stage(self, *extra) -> list:
        """The step's one packed put: next tokens, offsets, ``extra``
        arrays, and the block tables and adapter tables when admission or
        release changed them (the device mirrors are reused otherwise)."""
        dirty = self._kv.tables_dirty or self._tables_dev is None
        adirty = self._adapters is not None and (
            self._adapter_dirty or self._atables_dev is None)
        arrays = [self._next_tok, self._offsets, *extra]
        if dirty:
            arrays.append(self._kv.tables)
        if adirty:
            arrays.append(self._adapter_tables)
        put = self._audit.put(self._io, *arrays)
        if adirty:
            self._atables_dev = put.pop()
            self._adapter_dirty = False
        if dirty:
            self._tables_dev = put.pop()
            self._kv.tables_dirty = False
        return put

    def _dispatch_decode(self, active: list) -> None:
        """Dispatch one per-slot-offset paged decode and the row-wise
        sampler for the active set and leave the packed ``[2, B]`` result
        in flight: one put, no wait for the card.  With a tracer the batch
        ``decode_step`` span opens here and closes at the collect, one step
        later (the step's window in flight)."""
        tok_idx = self._tok_idx(active)
        self._begin_batch_span("decode_step", active)
        self._pending_version = self.weights_version
        tok, offs = self._stage()
        if self._adapters is not None:
            logits, self.caches, self.valid = self.model.decode_pages_lora(
                tok[:, None], offs, self._tables_dev, self.caches,
                self.valid, self._apool, self._atables_dev,
                paged_kernel=self._paged_kernel)
        else:
            logits, self.caches, self.valid = self.model.decode_pages(
                tok[:, None], offs, self._tables_dev, self.caches,
                self.valid, paged_kernel=self._paged_kernel)
        self._count_gather_step()
        self.decode_steps += 1
        # every active slot's decode write requantized its page
        self._count_quant(len(active))
        logits = perturb("serving/decode_logits", logits,
                         engine_step=self._steps)
        toks, finite = sample_rows(logits, self._keys, tok_idx, self._temps,
                                   self._topks, self._topps)
        self._pending = (self._io.fetch(pack_tokens(toks, finite)),
                         [(slot, req, int(self._slot_gen[slot]))
                          for slot, req in active])

    def _begin_batch_span(self, name: str, active: list, **attrs) -> None:
        """Open the batch ``decode_step``/``spec_round`` span and the perf
        stamp of the step, at one stamp: dispatch to collect, the step's
        window in flight."""
        if self.tracer is None and self._perf is None:
            return
        t0 = self._clock()
        if self._perf is not None:
            self._batch_t0 = (name, t0)
        if self.tracer is not None:
            self._batch_span = self.tracer.begin(
                name, t=t0, step=self._steps, active=len(active),
                **attrs, weights_version=self.weights_version)

    def _note_batch(self, now: float) -> None:
        """Account the in-flight batch step's window to its family."""
        fam, t0 = self._batch_t0
        self._batch_t0 = None
        self._perf.note_phase(fam, (now - t0) * 1e3)

    def _in_flight(self, slot: int, req: Request, gen: int) -> bool:
        """Whether the in-flight step's row still belongs to ``req``.  A
        request swept or preempted while its step was in flight is told
        apart by its state and slot; one preempted AND granted again since
        (back in DECODE, even in the same slot) by the slot's occupancy
        generation, bumped at every grant."""
        return (req.state is RequestState.DECODE
                and self.scheduler.slot_of(req.request_id) == slot
                and self._slot_gen[slot] == gen)

    def _collect_decode(self) -> list:
        """Collect the in-flight decode step: ONE packed fetch, then the
        cheap bookkeeping the next dispatch depends on (offset advance,
        non-finite quarantine, stop detection, slot release).  Returns the
        deferred host work for :meth:`_finish_decode`."""
        if self._pending is None:
            return []
        handle, active = self._pending
        self._pending = None
        toks, finite = self._audit.fetch(self._io, handle, label="serving")
        now = self._clock()
        tr = self.tracer
        bspan, self._batch_span = self._batch_span, None
        post: list = []
        for slot, req, gen in active:
            if not self._in_flight(slot, req, gen):
                continue  # a stale row records nothing
            self._offsets[slot] += 1  # the step wrote req's previous token
            if not finite[slot]:
                self._fail_slot_state(slot, req, now)
                post.append(("fail", slot, req, (), None, now))
                continue
            tok = int(toks[slot])
            last = self._last_tok_time[slot]
            ms = (now - last) * 1e3 if last is not None else None
            req.generated.append(tok)
            req.weights_version = self._pending_version
            req.decode_steps += 1
            if bspan is not None:
                tr.instant("decode_slot", request_id=req.request_id,
                           parent=bspan, t=now, slot=slot,
                           tok_idx=len(req.generated) - 1)
            self._last_tok_time[slot] = now
            self.registry.counter("serving/tokens_total").inc()
            reason = self._stop_reason(req, tok)
            if reason is not None:
                self._finish_request(slot, req, reason, now)
            else:
                self._next_tok[slot] = tok
            post.append(("tokens", slot, req, (tok,), ms, now))
        if bspan is not None:
            tr.end(bspan, t=now)
        if self._perf is not None and self._batch_t0 is not None:
            self._note_batch(now)
        return post

    def _spec_dispatch(self, active: list) -> None:
        """Dispatch one draft-k-verify round for the active set and leave
        the packed ``[k+3, B]`` result in flight: the draft proposes ``k``
        tokens per slot (k batched single-token decodes on its contiguous
        caches, drawn from the plain engine's streams), the target scores
        and writes the ``[B, k+1]`` chunk in one ``verify_pages`` call, and
        :func:`_spec_accept` commits on the card.  One put (the per-step
        draft offsets ride it), no wait for the card."""
        k = self._spec_k
        tok_idx = self._tok_idx(active)
        self._begin_batch_span("spec_round", active, k=k)
        self._pending_version = self.weights_version
        offs_j = self._offsets[None, :] + np.arange(k, dtype=np.int32)[:, None]
        tok, offs, doffs = self._stage(offs_j)
        draft = self._draft_model
        dtok = tok.long()[:, None]
        props, q_filts, dfin = [], [], None
        dad = self._draft_adapter()
        for j in range(k):
            dlogits, self._draft_caches, self._draft_valid = \
                draft.decode_slots(dtok, doffs[j], self._draft_caches,
                                   self._draft_valid, *dad)
            dlogits = perturb("serving/draft_logits", dlogits,
                              engine_step=self._steps, round_pos=j)
            ptoks, qf, fin = propose_rows(dlogits, self._keys, tok_idx + j,
                                          self._temps, self._topks,
                                          self._topps)
            props.append(ptoks)
            q_filts.append(qf)
            dfin = fin if dfin is None else dfin & fin
            dtok = ptoks[:, None]
        chunk = torch.cat([tok.long()[:, None]] + [p[:, None] for p in props],
                          dim=1)
        ad = ((self._apool, self._atables_dev) if self._adapters is not None
              else (None, None))
        vlogits, self.caches, self.valid = self.model.verify_pages(
            chunk, offs, self._tables_dev, self.caches, self.valid,
            paged_kernel=self._paged_kernel, apool=ad[0], atables=ad[1])
        self._count_gather_step()
        self.spec_rounds += 1
        if self._kv_quant is not None:
            # the page(s) each active slot's k+1-token chunk straddles
            page = self._kv.page_size
            self._count_quant(sum(
                int((self._offsets[slot] + k) // page
                    - self._offsets[slot] // page + 1)
                for slot, _ in active))
        vlogits = perturb("serving/verify_logits", vlogits,
                          engine_step=self._steps)
        packed = _spec_accept(vlogits, torch.stack(q_filts, dim=1),
                              torch.stack(props, dim=1), self._keys, tok_idx,
                              self._temps, self._topks, self._topps, dfin)
        self._pending = (self._io.fetch(packed),
                         [(slot, req, int(self._slot_gen[slot]))
                          for slot, req in active], props[-1])

    def _spec_collect(self) -> list:
        """Collect the in-flight round: ONE packed fetch, then per slot
        append the accepted run (clipped to the request's budget and cut
        at the first stop token), advance the offset by exactly the
        committed count -- the rewind that rolls a rejected tail back --
        and quarantine non-finite slots.  A fully accepted slot's draft
        never wrote its last proposal: one draft decode writes it."""
        if self._pending is None:
            return []
        handle, active, last_prop = self._pending
        self._pending = None
        k = self._spec_k
        packed = self._audit.fetch(self._io, handle,
                                   label="serving")             # [k+3, B]
        commit, acc, finite = packed[:k + 1], packed[k + 1], packed[k + 2]
        now = self._clock()
        tr = self.tracer
        bspan, self._batch_span = self._batch_span, None
        reg = self.registry
        post: list = []
        ingest = np.full((self.B,), self.T, np.int32)
        for slot, req, gen in active:
            if not self._in_flight(slot, req, gen):
                continue  # a stale row records nothing
            if not finite[slot]:
                self._fail_slot_state(slot, req, now)
                post.append(("fail", slot, req, (), None, now))
                continue
            a = int(acc[slot])
            req.spec_proposed += k
            req.spec_accepted += a
            self.spec_proposed += k
            self.spec_accepted += a
            reg.counter("serving/spec_proposed_total").inc(k)
            reg.counter("serving/spec_accepted_total").inc(a)
            reg.counter("serving/spec_rounds_total").inc()
            last = self._last_tok_time[slot]
            gap_ms = (now - last) * 1e3 if last is not None else None
            toks: list = []
            reason = None
            for i in range(min(a + 1, req.max_new_tokens - len(req.generated))):
                t = int(commit[i, slot])
                req.generated.append(t)
                toks.append(t)
                reg.counter("serving/tokens_total").inc()
                reason = self._stop_reason(req, t)
                if reason is not None:
                    break  # a stop inside the accepted run commits up to it
            m = len(toks)
            self.spec_committed += m
            reg.counter("serving/spec_committed_total").inc(m)
            if m:
                req.weights_version = self._pending_version
            req.decode_steps += 1
            if bspan is not None:
                tr.instant("spec_slot", request_id=req.request_id,
                           parent=bspan, t=now, slot=slot, accepted=a,
                           committed=m)
            self._offsets[slot] += m
            self._last_tok_time[slot] = now
            if reason is not None:
                self._finish_request(slot, req, reason, now)
            else:
                self._next_tok[slot] = toks[-1]
                if m == k + 1:
                    ingest[slot] = self._offsets[slot] - 1
            # the round's tokens share its gap evenly
            per_tok = gap_ms / m if (gap_ms is not None and m) else None
            post.append(("tokens", slot, req, tuple(toks), per_tok, now))
        if bspan is not None:
            tr.end(bspan, t=now)
        if self._perf is not None and self._batch_t0 is not None:
            self._note_batch(now)
        if (ingest < self.T).any():
            (offs,) = self._audit.put(self._io, ingest)
            _, self._draft_caches, self._draft_valid = \
                self._draft_model.decode_slots(
                    last_prop[:, None], offs, self._draft_caches,
                    self._draft_valid, *self._draft_adapter())
        return post

    def _draft_adapter(self) -> tuple:
        """``(apool, atables)`` for the draft's steps: each slot's adapter
        when the draft shares the target's adapter geometry, else the
        draft's base weights."""
        if self._draft_lora:
            return self._apool, self._atables_dev
        return None, None

    def _finish_decode(self, post: list, outputs: list) -> None:
        """The collected step's deferred host work -- inter-token times,
        stream callbacks, terminal outputs -- run while the next step is
        on the card."""
        for kind, slot, req, toks, ms, now in post:
            if kind == "fail":
                logger.warning(
                    "serving: request %d failed (%s) after %d tokens; slot "
                    "%d freed", req.request_id, FAIL_NON_FINITE,
                    len(req.generated), slot)
            for t in toks:
                if ms is not None:
                    self._observe_intertoken(req, ms)
                if req.stream_cb is not None:
                    req.stream_cb(req, t)
            if req.done:
                outputs.append(self._emit(req, now))

    def _observe_intertoken(self, req: Request, ms: float) -> None:
        """One inter-token gap: on the request, the global histogram and the
        request's priority-class histogram."""
        req.intertoken_ms.append(ms)
        self.registry.histogram(
            "serving/intertoken_ms", MS_BUCKETS).observe(ms)
        self.registry.histogram(
            f"serving/intertoken_ms_{req.priority}", MS_BUCKETS).observe(ms)

    def _stop_reason(self, req: Request, tok: int) -> Optional[str]:
        reason = req.check_stop(tok)
        if (reason is None and self.eos_token_id is not None
                and tok == self.eos_token_id):
            reason = "stop_token"
        return reason

    def _append_token(self, slot: int, req: Request, tok: int,
                      now: float) -> None:
        """Record and stream one token; finish the request on a stop."""
        req.generated.append(tok)
        req.weights_version = self.weights_version
        self._last_tok_time[slot] = now
        self.registry.counter("serving/tokens_total").inc()
        if req.stream_cb is not None:
            req.stream_cb(req, tok)
        reason = self._stop_reason(req, tok)
        if reason is not None:
            self._finish_request(slot, req, reason, now)

    def _finish_request(self, slot: int, req: Request, reason: str,
                        now: float) -> None:
        req.transition(RequestState.FINISHED)
        req.finish_reason = reason
        req.finish_time = now
        self._trace_end_phase(req, t=now)
        self._release(slot, req)
        self.registry.counter("serving/finished_total").inc()

    def _fail_slot_state(self, slot: int, req: Request, now: float,
                         reason: str = FAIL_NON_FINITE) -> None:
        """Fail one request: terminal FAILED, slot and pages released, the
        rest of the batch untouched."""
        req.transition(RequestState.FAILED)
        req.finish_reason = reason
        req.finish_time = now
        self._trace_end_phase(req, t=now, failed=reason)
        self._release(slot, req)
        self.registry.counter("serving/failed_total").inc()

    def _fail_slot(self, slot: int, req: Request, outputs: list, now: float,
                   reason: str = FAIL_NON_FINITE) -> None:
        """:meth:`_fail_slot_state`, logged and emitted at once."""
        self._fail_slot_state(slot, req, now, reason)
        logger.warning("serving: request %d failed (%s) after %d tokens; "
                       "slot %d freed", req.request_id, reason,
                       len(req.generated), slot)
        outputs.append(self._emit(req, now))

    def _emit(self, req: Request, now: float) -> RequestOutput:
        """The terminal output, where every terminal path passes: a request
        terminal while parked banks its open park and drops its resume pin;
        the root span ends; the ``serving_stats`` record is written."""
        if req.parked_at is not None:
            req.preempted_ms += max(now - req.parked_at, 0.0) * 1e3
            req.parked_at = None
        self._kv.release_resume(req)
        tr = self.tracer
        if tr is not None:
            rt = self._rt.pop(req.request_id, None)
            if rt is not None:
                tr.end(rt.pop("phase", None), t=now)  # none open, normally
                tr.end(rt.get("root"), t=now, state=req.state.value,
                       finish_reason=req.finish_reason,
                       new_tokens=len(req.generated),
                       preemptions=req.preemptions)
        out = RequestOutput.from_request(req, now)
        if self._stats_path is not None:
            self._write_stats(req, out)
        if self._health is not None:
            # per-class deadline attainment feeds the SLO burn-rate windows
            self._health.note_output(out, now)
        if self._perf is not None:
            # committed tokens feed the tokens/s-ceiling rollup; a stamp a
            # failed admission left behind is dropped
            self._perf.note_tokens(len(out.token_ids))
            self._perf_t0.pop(req.request_id, None)
        return out

    def _write_stats(self, req: Request, out: RequestOutput) -> None:
        """One ``serving_stats/6`` record (the file opens at the first,
        and every record is flushed).  Every tensor-parallel rank builds
        the record, with its clock reading; rank 0 alone writes it."""
        rec = {
            "schema": SERVING_STATS_SCHEMA,
            "time": time.time(),
            "request_id": out.request_id,
            "state": out.state,
            "finish_reason": out.finish_reason,
            "prompt_len": out.prompt_len,
            "new_tokens": len(out.token_ids),
            "queue_ms": out.queue_ms,
            "ttft_ms": out.ttft_ms,
            "total_ms": out.total_ms,
            "spec_proposed": out.spec_proposed,
            "spec_accepted": out.spec_accepted,
            "acceptance_rate": out.acceptance_rate,
            "adapter_id": out.adapter_id,
            "priority": out.priority,
            "deadline_s": out.deadline_s,
            "queue_wait_ms": out.queue_ms,
            "preemptions": out.preemptions,
            "shed_reason": req.shed_reason,
            # the engine clock's stamp: the spans' timescale
            "mono": self._clock(),
            "decode_steps": out.decode_steps,
            "prefill_chunks": out.prefill_chunks,
            "preempted_ms": out.preempted_ms,
            "trace_id": out.trace_id,
            "weights_version": out.weights_version,
        }
        if not self.primary:
            return
        if self._stats_f is None:
            self._stats_f = open(self._stats_path, "a")
        self._stats_f.write(json.dumps(rec) + "\n")
        self._stats_f.flush()

    def _preempt_for_priority(self, now: float) -> None:
        """Park batch victims while the scheduler says the interactive head
        is blocked on slots or pages: the victim's committed prompt chain
        is pinned (a mid-chunk victim's to its chunk progress), its slot,
        pages and adapter pin are released, and it is requeued at its
        original deadline key.  A step in flight on its slot is dropped at
        collect (:meth:`_in_flight`)."""
        for _ in range(self.B):
            picked = self.scheduler.pick_preemption(now)
            if picked is None:
                return
            slot, req = picked
            st = self._chunking.get(slot)
            # the compute phase ends at the park instant, where the
            # scheduler's preempted span begins
            self._trace_end_phase(req, t=now, preempted=True)
            self.scheduler.requeue(req, now=now)
            req.parked_at = now
            self._kv.park_resume(
                slot, req, fresh_done=st.next_i if st is not None else None)
            self._park(slot)
            self.preemptions += 1
            self.registry.counter("serving/preemptions_total").inc()
            logger.info("serving: preempted batch request %d from slot %d "
                        "for the interactive queue head (%d preemption(s) "
                        "so far)", req.request_id, slot, req.preemptions)

    def _expire_before_prefill(self, slot: int, req: Request, outputs: list,
                               now: float) -> None:
        """A granted request whose deadline died after the step's sweep,
        before its prefill or its next chunk: TIMED_OUT without running
        it, slot, pages and adapter pin released."""
        req.transition(RequestState.TIMED_OUT)
        req.finish_reason = RequestState.TIMED_OUT.value
        req.finish_time = now
        req.shed_reason = SHED_EXPIRED_BEFORE_PREFILL
        self._trace_end_phase(req, t=now, expired=True)
        self._release(slot, req)
        self.expired_before_prefill += 1
        self.registry.counter("serving/expired_before_prefill_total").inc()
        self.registry.counter("serving/timed_out_total").inc()
        outputs.append(self._emit(req, now))

    def _release(self, slot: int, req: Request) -> None:
        self.scheduler.release(req)
        self._park(slot)

    def _park(self, slot: int) -> None:
        self._chunking.pop(slot, None)  # abandon a mid-chunk prefill
        self._offsets[slot] = self.T
        self._temps[slot] = 0.0  # a parked row is argmaxed and ignored
        self._last_tok_time[slot] = None
        self._kv.release_slot(slot)
        self._release_adapter(slot)

    def _release_adapter(self, slot: int) -> None:
        """Drop the slot's adapter pin and null its adapter table row.
        Idempotent: every terminal path parks its slot, and the sweep
        parks every free slot, a swept slot whose step is in flight
        included (the collect then drops that step by its generation)."""
        if self._adapters is None or not self._slot_adapter[slot]:
            return
        self._adapters.release(self._slot_adapter[slot])
        self._slot_adapter[slot] = 0
        self._adapter_tables[slot] = 0
        self._adapter_dirty = True

    def _park_free_slots(self) -> None:
        """Reset every slot without a live occupant (after a sweep)."""
        live = {slot for slot, _ in self.scheduler.active()}
        for slot in range(self.B):
            if slot not in live:
                self._park(slot)
