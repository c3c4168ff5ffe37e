"""Continuous-batching serving engine over the paged KV pool (counterpart of
``neuronx_distributed_tpu/serving/engine.py`` in paged mode with
synchronous decode).

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
from neuronx_distributed_tpu_torch.trace.engine import request_key, sampled_tokens
from neuronx_distributed_tpu_torch.utils.device import resolve_device
from neuronx_distributed_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

FAIL_NON_FINITE = "non_finite_logits"


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
      would hold plus the NULL page (``B * T / page_size + 1``).
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
    - ``device`` must be the model's device; ``None`` means CUDA (raises
      without it).
    """

    def __init__(self, model, *, page_size: int,
                 num_pages: Optional[int] = None, seed: Optional[int] = None,
                 eos_token_id: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic,
                 max_queue: Optional[int] = None, prefix_cache: bool = True,
                 paged_kernel="auto", kv_quant: Optional[str] = None,
                 prefill_chunk_tokens: Optional[int] = None, device=None):
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
        self.model = model
        self.device = device
        cfg = model.config
        self.B, self.C, self.T = (cfg.batch_size, cfg.context_len,
                                  cfg.max_total_len)
        if num_pages is None:
            num_pages = self.B * (self.T // page_size) + 1
        self._kv = PagedKVManager(
            num_slots=self.B, context_len=self.C, max_total_len=self.T,
            page_size=page_size, num_pages=num_pages,
            prefix_cache=prefix_cache)
        self._paged_kernel = (model.paged_kernel if paged_kernel in ("auto", None)
                              else resolve_paged_kernel(paged_kernel, device))
        self.scheduler = SlotScheduler(
            self.B, self.C, self.T, max_queue=max_queue, page_gate=self._kv)
        self.eos_token_id = eos_token_id
        self._seed = seed
        self._clock = clock
        self._kv_quant = kv_quant
        self._chunk_tokens = prefill_chunk_tokens
        self._chunking: dict = {}  # slot -> _ChunkPrefill in progress
        self._chunk_rr = 0         # budget-rotation cursor (fairness)
        self.caches = model.make_page_pool(num_pages, page_size,
                                           quant=kv_quant).caches
        self.valid = torch.zeros((self.B, self.T), dtype=torch.int32,
                                 device=device)
        self._offsets = np.full((self.B,), self.T, np.int32)  # T = parked
        self._next_tok = np.zeros((self.B,), np.int64)
        self._last_tok_time: List[Optional[float]] = [None] * self.B
        # per-slot sampling state, written once at admission
        self._keys: List[Optional[int]] = [None] * self.B
        self._temps = np.zeros((self.B,), np.float32)
        self._topks = np.zeros((self.B,), np.int32)
        self._topps = np.ones((self.B,), np.float32)
        self.decode_steps = 0  # batched decode steps run (one per step())
        self.prefill_chunks = 0  # chunk dispatches run
        self.quant_pages = 0  # pages written through a quantize-on-write

    # -- request surface ---------------------------------------------------

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
        return self.scheduler.queue_depth > 0 or self.scheduler.active_count > 0

    def step(self) -> List[RequestOutput]:
        """One engine iteration: sweep -> admit/prefill -> prefill chunks ->
        batched decode -> stop detection -> slot free.  Returns the
        requests that reached a terminal state during this step."""
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
        active = [(slot, req) for slot, req in self.scheduler.active()
                  if req.state is RequestState.DECODE]
        if active:
            self._decode_step(active, outputs)
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

    def _prefill_into_slot(self, slot: int, req: Request, outputs: list) -> None:
        """Block-table assembly (prefix lookup, atomic page allocation),
        then either the first token from a whole prefill (single-request
        prefill unless the whole prompt is cached, page writes of only the
        uncached prompt pages) or, in chunked mode, the reserved fresh
        pages handed to the chunk loop.  A failure mid-admission releases
        every page, fails the one request and re-raises."""
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

    def _decode_step(self, active: list, outputs: list) -> None:
        """One per-slot-offset paged decode over the whole batch; inactive
        slots are parked at offset ``T``."""
        tok_idx = np.zeros((self.B,), np.int32)
        for slot, req in active:
            tok_idx[slot] = len(req.generated)
        logits, self.caches, self.valid = self.model.decode_pages(
            self._next_tok[:, None], self._offsets, self._kv.tables,
            self.caches, self.valid, paged_kernel=self._paged_kernel)
        self.decode_steps += 1
        if self._kv_quant is not None:
            # every active slot's decode write requantized its page
            self.quant_pages += len(active)
        toks, finite = sampled_tokens(logits, self._keys, tok_idx,
                                      self._temps, self._topks, self._topps)
        now = self._clock()
        for slot, req in active:
            self._offsets[slot] += 1  # the step wrote req's previous token
            if not finite[slot]:
                self._fail_slot(slot, req, outputs, now)
                continue
            tok = int(toks[slot])
            req.decode_steps += 1
            last = self._last_tok_time[slot]
            if last is not None:
                req.intertoken_ms.append((now - last) * 1e3)
            self._append_token(slot, req, tok, now)
            if req.done:
                outputs.append(RequestOutput.from_request(req, now))
            else:
                self._next_tok[slot] = tok

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
            req.transition(RequestState.FINISHED)
            req.finish_reason = reason
            req.finish_time = now
            self._release(slot, req)

    def _fail_slot(self, slot: int, req: Request, outputs: list, now: float,
                   reason: str = FAIL_NON_FINITE) -> None:
        """Fail one request: terminal FAILED, slot and pages released, the
        rest of the batch untouched."""
        req.transition(RequestState.FAILED)
        req.finish_reason = reason
        req.finish_time = now
        self._release(slot, req)
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
