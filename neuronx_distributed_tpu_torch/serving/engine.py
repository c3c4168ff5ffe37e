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

Greedy outputs are token-identical to a solo ``generate`` of the same
prompt up to the arithmetic order of the attention path taken.  Chunked
prefill over an int8 pool is the exception: each chunk attends the
already-quantized pages of the chunks before it, while a whole prefill
attends full-precision keys, so the two drift apart within the int8
bound.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

import numpy as np
import torch

from neuronx_distributed_tpu_torch.ops.paged_attention import resolve_paged_kernel
from neuronx_distributed_tpu_torch.serving.paged import PagedKVManager
from neuronx_distributed_tpu_torch.serving.request import (
    PRIORITY_INTERACTIVE,
    Request,
    RequestOutput,
    RequestState,
)
from neuronx_distributed_tpu_torch.serving.scheduler import SlotScheduler
from neuronx_distributed_tpu_torch.trace.engine import (
    _filtered_logits,
    gumbel_draw,
    pack_tokens,
    propose_rows,
    request_key,
    sample_rows,
    sampled_tokens,
    spec_keys,
    token_generator,
)
from neuronx_distributed_tpu_torch.utils.device import resolve_device
from neuronx_distributed_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

FAIL_NON_FINITE = "non_finite_logits"


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
      (both or neither).
    - ``device`` must be the model's device; ``None`` means CUDA (raises
      without it).

    ``puts`` and ``fetches`` count the packed transfers: one put and one
    fetch per steady decode step or speculative round (a round whose
    draft must catch up on a full accept adds one put), and one fetch per
    admission's first token.
    """

    def __init__(self, model, *, page_size: int,
                 num_pages: Optional[int] = None, seed: Optional[int] = None,
                 eos_token_id: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic,
                 max_queue: Optional[int] = None, prefix_cache: bool = True,
                 paged_kernel="auto", kv_quant: Optional[str] = None,
                 prefill_chunk_tokens: Optional[int] = None,
                 async_decode: bool = True, draft=None, spec_k: int = 0,
                 device=None):
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
        if draft is not None:
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
        self.device = device
        self.B, self.C, self.T = (cfg.batch_size, cfg.context_len,
                                  cfg.max_total_len)
        self._spec_k = int(spec_k)
        self._draft_model = draft
        if num_pages is None:
            num_pages = self.B * -(-(self.T + self._spec_k) // page_size) + 1
        self._kv = PagedKVManager(
            num_slots=self.B, context_len=self.C, max_total_len=self.T,
            page_size=page_size, num_pages=num_pages,
            prefix_cache=prefix_cache, spec_overshoot=self._spec_k)
        self._paged_kernel = (model.paged_kernel if paged_kernel in ("auto", None)
                              else resolve_paged_kernel(paged_kernel, device))
        self.scheduler = SlotScheduler(
            self.B, self.C, self.T, max_queue=max_queue, page_gate=self._kv,
            reserve_extra=self._spec_k)
        self.eos_token_id = eos_token_id
        self._seed = seed
        self._clock = clock
        self._kv_quant = kv_quant
        self._chunk_tokens = prefill_chunk_tokens
        self._chunking: dict = {}  # slot -> _ChunkPrefill in progress
        self._chunk_rr = 0         # budget-rotation cursor (fairness)
        self.async_decode = async_decode
        self.caches = model.make_page_pool(num_pages, page_size,
                                           quant=kv_quant).caches
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
        self._io = _Staging(device, (3 + self._spec_k) * self.B + self.B * PP,
                            (self._spec_k + 3) * self.B)
        self.decode_steps = 0  # batched decode steps run (plain mode)
        self.spec_rounds = 0   # speculative rounds run (spec mode)
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_committed = 0
        self.prefill_chunks = 0  # chunk dispatches run
        self.quant_pages = 0  # pages written through a quantize-on-write

    # -- request surface ---------------------------------------------------

    @property
    def puts(self) -> int:
        return self._io.puts

    @property
    def fetches(self) -> int:
        return self._io.fetches

    def submit(self, request: Request) -> None:
        """Queue a request.  Raises ``AdmissionError`` when it can never
        fit, ``BackpressureError`` when the bounded queue is full,
        ``ValueError`` for a sampled request on a seedless engine."""
        if request.sampling.temperature > 0.0 and self._seed is None:
            raise ValueError(
                f"request {request.request_id} samples (temperature "
                f"{request.sampling.temperature}) but the engine has no seed")
        self.scheduler.submit(request, now=self._clock())

    def cancel(self, request_id: int) -> bool:
        return self.scheduler.cancel(request_id)

    @property
    def has_work(self) -> bool:
        # an in-flight step is work: its tokens still need a step() to be
        # collected and emitted
        return (self.scheduler.queue_depth > 0
                or self.scheduler.active_count > 0
                or self._pending is not None)

    def step(self) -> List[RequestOutput]:
        """One engine iteration: sweep -> admit/prefill -> prefill chunks ->
        decode (or a speculative round) -> stop detection -> slot free.
        Async: collect the in-flight step, dispatch the next, then run the
        collected step's host work.  Returns the requests that reached a
        terminal state during this step."""
        outputs: List[RequestOutput] = []
        now = self._clock()
        swept = self.scheduler.sweep(now)
        if swept:
            self._park_free_slots()
            outputs.extend(RequestOutput.from_request(req, now) for req in swept)
        for slot, req in self.scheduler.admit(now):
            self._prefill_into_slot(slot, req, outputs)
        if self._chunking:
            self._run_prefill_chunks(outputs)
        collect, dispatch = ((self._spec_collect, self._spec_dispatch)
                             if self._spec_k else
                             (self._collect_decode, self._dispatch_decode))
        if self.async_decode:
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
        return outputs

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

    # -- internals ---------------------------------------------------------

    def _decoding(self) -> list:
        return [(slot, req) for slot, req in self.scheduler.active()
                if req.state is RequestState.DECODE]

    def _prefill_into_slot(self, slot: int, req: Request, outputs: list) -> None:
        """Block-table assembly (prefix lookup, atomic page allocation),
        then either the first token from a whole prefill (single-request
        prefill unless the whole prompt is cached, page writes of only the
        uncached prompt pages) or, in chunked mode, the reserved fresh
        pages handed to the chunk loop.  The draft, in spec mode, prefills
        its contiguous row whole either way.  A failure mid-admission
        releases every page, fails the one request and re-raises."""
        self._slot_gen[slot] += 1  # a fresh occupancy generation begins
        L = req.prompt_len
        ids = np.zeros((1, self.C), np.int64)
        ids[0, self.C - L:] = req.prompt_ids  # LEFT-padded
        valid_np = (np.arange(self.C) >= self.C - L).astype(np.int32)
        row_valid = np.concatenate(
            [valid_np, np.zeros((self.T - self.C,), np.int32)])
        try:
            cached = self._kv.admit_slot(slot, req, ids[0], valid_np)
        except BaseException as e:
            now = self._clock()
            self._fail_slot(slot, req, outputs, now,
                            reason=f"page_alloc:{type(e).__name__}")
            raise
        if self._spec_k:
            _, drow = self._draft_model.prefill_one(ids, valid_np[None, :])
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
            self._set_sampling_state(slot, req)
            return
        if cached is not None:
            logits = cached  # exact full-prompt hit: no prefill compute
        else:
            logits, row_caches = self.model.prefill_one(ids, valid_np[None, :])
            for lp, phys in fresh:
                self.caches = self.model.write_page(
                    self.caches, row_caches, lp, phys, row_valid=valid_np)
            if self._kv_quant is not None:
                self.quant_pages += len(fresh)
        self.valid = self.model.insert_valid(self.valid, row_valid, slot)
        self._set_sampling_state(slot, req)
        self._finish_prefill(slot, req, logits, outputs,
                             prefilled_fresh=cached is None)

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
        toks, finite = sampled_tokens(
            logits, [self._keys[slot]], [0], [s.temperature], [s.top_k],
            [s.top_p])
        self._io.fetches += 1
        now = self._clock()
        if not finite[0]:
            # a poisoned prefill fails ITS request and is never cached
            self._fail_slot(slot, req, outputs, now)
            return
        if prefilled_fresh:
            self._kv.finish_insert(slot, logits)
        req.transition(RequestState.DECODE)
        if req.first_token_time is None:
            req.first_token_time = now
        self._append_token(slot, req, int(toks[0]), now)
        if req.done:
            outputs.append(RequestOutput.from_request(req, now))
        else:
            self._offsets[slot] = self.C
            self._next_tok[slot] = int(toks[0])

    def _run_prefill_chunks(self, outputs: list) -> None:
        """Advance the prefilling slots by up to the per-step budget
        (``prefill_chunk_tokens``, in pages): each chunk writes page-aligned
        prompt KV into the slot's reserved pages through
        ``prefill_chunk_pages``, and the final chunk's logits feed the first
        token.  The start slot rotates step to step so one long prompt
        cannot hog the budget; interactive prefills take it first.  A
        failed chunk fails its one request, reclaims every page and
        re-raises."""
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
            st = self._chunking[slot]
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
        st.logits, self.caches = self.model.prefill_chunk_pages(
            st.ids_row[None, off:off + width], off,
            self._kv.tables[slot][None, :], self.caches,
            st.valid_row[None, :], paged_kernel=self._paged_kernel)
        st.next_i += n_pages
        st.req.prefill_chunks += 1
        self.prefill_chunks += 1
        if self._kv_quant is not None:
            self.quant_pages += n_pages

    def _tok_idx(self, active: list) -> np.ndarray:
        tok_idx = np.zeros((self.B,), np.int32)
        for slot, req in active:
            tok_idx[slot] = len(req.generated)
        return tok_idx

    def _stage(self, *extra) -> list:
        """The step's one packed put: next tokens, offsets, ``extra``
        arrays, and the block tables when admission or release changed
        them (the device mirror is reused otherwise)."""
        dirty = self._kv.tables_dirty or self._tables_dev is None
        arrays = [self._next_tok, self._offsets, *extra]
        if dirty:
            arrays.append(self._kv.tables)
        put = self._io.put(*arrays)
        if dirty:
            self._tables_dev = put.pop()
            self._kv.tables_dirty = False
        return put

    def _dispatch_decode(self, active: list) -> None:
        """Dispatch one per-slot-offset paged decode and the row-wise
        sampler for the active set and leave the packed ``[2, B]`` result
        in flight: one put, no wait for the card."""
        tok_idx = self._tok_idx(active)
        tok, offs = self._stage()
        logits, self.caches, self.valid = self.model.decode_pages(
            tok[:, None], offs, self._tables_dev, self.caches, self.valid,
            paged_kernel=self._paged_kernel)
        self.decode_steps += 1
        if self._kv_quant is not None:
            # every active slot's decode write requantized its page
            self.quant_pages += len(active)
        toks, finite = sample_rows(logits, self._keys, tok_idx, self._temps,
                                   self._topks, self._topps)
        self._pending = (self._io.fetch(pack_tokens(toks, finite)),
                         [(slot, req, int(self._slot_gen[slot]))
                          for slot, req in active])

    def _in_flight(self, slot: int, req: Request, gen: int) -> bool:
        """Whether the in-flight step's row still belongs to ``req``: a
        request swept while its step was in flight (and a slot re-granted
        since, even to a request of the same id) is told apart by state
        and occupancy generation."""
        return (req.state is RequestState.DECODE
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
        toks, finite = self._io.wait(handle)
        now = self._clock()
        post: list = []
        for slot, req, gen in active:
            if not self._in_flight(slot, req, gen):
                continue
            self._offsets[slot] += 1  # the step wrote req's previous token
            if not finite[slot]:
                self._fail_slot_state(slot, req, now)
                post.append(("fail", slot, req, (), None, now))
                continue
            tok = int(toks[slot])
            last = self._last_tok_time[slot]
            ms = (now - last) * 1e3 if last is not None else None
            req.generated.append(tok)
            req.decode_steps += 1
            self._last_tok_time[slot] = now
            reason = self._stop_reason(req, tok)
            if reason is not None:
                self._finish_request(slot, req, reason, now)
            else:
                self._next_tok[slot] = tok
            post.append(("tokens", slot, req, (tok,), ms, now))
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
        offs_j = self._offsets[None, :] + np.arange(k, dtype=np.int32)[:, None]
        tok, offs, doffs = self._stage(offs_j)
        draft = self._draft_model
        dtok = tok.long()[:, None]
        props, q_filts, dfin = [], [], None
        for j in range(k):
            dlogits, self._draft_caches, self._draft_valid = \
                draft.decode_slots(dtok, doffs[j], self._draft_caches,
                                   self._draft_valid)
            ptoks, qf, fin = propose_rows(dlogits, self._keys, tok_idx + j,
                                          self._temps, self._topks,
                                          self._topps)
            props.append(ptoks)
            q_filts.append(qf)
            dfin = fin if dfin is None else dfin & fin
            dtok = ptoks[:, None]
        chunk = torch.cat([tok.long()[:, None]] + [p[:, None] for p in props],
                          dim=1)
        vlogits, self.caches, self.valid = self.model.verify_pages(
            chunk, offs, self._tables_dev, self.caches, self.valid,
            paged_kernel=self._paged_kernel)
        self.spec_rounds += 1
        if self._kv_quant is not None:
            # the page(s) each active slot's k+1-token chunk straddles
            page = self._kv.page_size
            self.quant_pages += sum(
                int((self._offsets[slot] + k) // page
                    - self._offsets[slot] // page + 1)
                for slot, _ in active)
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
        packed = self._io.wait(handle)                          # [k+3, B]
        commit, acc, finite = packed[:k + 1], packed[k + 1], packed[k + 2]
        now = self._clock()
        post: list = []
        ingest = np.full((self.B,), self.T, np.int32)
        for slot, req, gen in active:
            if not self._in_flight(slot, req, gen):
                continue
            if not finite[slot]:
                self._fail_slot_state(slot, req, now)
                post.append(("fail", slot, req, (), None, now))
                continue
            a = int(acc[slot])
            req.spec_proposed += k
            req.spec_accepted += a
            self.spec_proposed += k
            self.spec_accepted += a
            last = self._last_tok_time[slot]
            gap_ms = (now - last) * 1e3 if last is not None else None
            toks: list = []
            reason = None
            for i in range(min(a + 1, req.max_new_tokens - len(req.generated))):
                t = int(commit[i, slot])
                req.generated.append(t)
                toks.append(t)
                reason = self._stop_reason(req, t)
                if reason is not None:
                    break  # a stop inside the accepted run commits up to it
            m = len(toks)
            self.spec_committed += m
            req.decode_steps += 1
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
        if (ingest < self.T).any():
            (offs,) = self._io.put(ingest)
            _, self._draft_caches, self._draft_valid = \
                self._draft_model.decode_slots(
                    last_prop[:, None], offs, self._draft_caches,
                    self._draft_valid)
        return post

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
                    req.intertoken_ms.append(ms)
                if req.stream_cb is not None:
                    req.stream_cb(req, t)
            if req.done:
                outputs.append(RequestOutput.from_request(req, now))

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
        self._last_tok_time[slot] = now
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
        self._release(slot, req)

    def _fail_slot_state(self, slot: int, req: Request, now: float,
                         reason: str = FAIL_NON_FINITE) -> None:
        """Fail one request: terminal FAILED, slot and pages released, the
        rest of the batch untouched."""
        req.transition(RequestState.FAILED)
        req.finish_reason = reason
        req.finish_time = now
        self._release(slot, req)

    def _fail_slot(self, slot: int, req: Request, outputs: list, now: float,
                   reason: str = FAIL_NON_FINITE) -> None:
        """:meth:`_fail_slot_state`, logged and emitted at once."""
        self._fail_slot_state(slot, req, now, reason)
        logger.warning("serving: request %d failed (%s) after %d tokens; "
                       "slot %d freed", req.request_id, reason,
                       len(req.generated), slot)
        outputs.append(RequestOutput.from_request(req, now))

    def _release(self, slot: int, req: Request) -> None:
        self.scheduler.release(req)
        self._park(slot)

    def _park(self, slot: int) -> None:
        self._chunking.pop(slot, None)  # abandon a mid-chunk prefill
        self._offsets[slot] = self.T
        self._temps[slot] = 0.0  # a parked row is argmaxed and ignored
        self._last_tok_time[slot] = None
        self._kv.release_slot(slot)

    def _park_free_slots(self) -> None:
        """Reset every slot without a live occupant (after a sweep)."""
        live = {slot for slot, _ in self.scheduler.active()}
        for slot in range(self.B):
            if slot not in live:
                self._park(slot)
