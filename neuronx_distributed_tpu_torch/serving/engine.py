"""Continuous-batching serving engine over the paged KV pool (counterpart of
``neuronx_distributed_tpu/serving/engine.py`` in paged mode with
synchronous decode).

``step()`` is the iteration-level loop (Orca, OSDI '22): sweep
cancellations and deadlines, admit queued requests into free slots
(prefix-cache lookup, single-request prefill, page writes of the uncached
prompt pages), run ONE batched decode step with per-slot cache offsets over
the page pool, sample each slot from its own request's stream, and free the
slots and pages of finished requests.  Idle slots are parked at offset
``T``: they write nothing and their logits are ignored.

Greedy outputs are token-identical to a solo ``generate`` of the same
prompt up to the arithmetic order of the attention path taken.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

import numpy as np
import torch

from neuronx_distributed_tpu_torch.ops.paged_attention import resolve_paged_kernel
from neuronx_distributed_tpu_torch.serving.paged import PagedKVManager
from neuronx_distributed_tpu_torch.serving.request import (
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
    - ``device`` must be the model's device; ``None`` means CUDA (raises
      without it).
    """

    def __init__(self, model, *, page_size: int,
                 num_pages: Optional[int] = None, seed: Optional[int] = None,
                 eos_token_id: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic,
                 max_queue: Optional[int] = None, prefix_cache: bool = True,
                 paged_kernel="auto", device=None):
        device = resolve_device(device)
        if device != model.device:
            raise ValueError(f"engine device {device} != model device "
                             f"{model.device}")
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
        self.caches = model.make_page_pool(num_pages, page_size).caches
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
        """One engine iteration: sweep -> admit/prefill -> batched decode ->
        stop detection -> slot free.  Returns the requests that reached a
        terminal state during this step."""
        outputs: List[RequestOutput] = []
        now = self._clock()
        swept = self.scheduler.sweep(now)
        if swept:
            self._park_free_slots()
            outputs.extend(RequestOutput.from_request(req, now) for req in swept)
        for slot, req in self.scheduler.admit(now):
            self._prefill_into_slot(slot, req, outputs)
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
        single-request prefill unless the whole prompt is cached, page
        writes of only the uncached prompt pages, validity insert, first
        token.  A failure mid-admission releases every page, fails the one
        request and re-raises."""
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
        fresh_prefill = cached is None
        if cached is not None:
            logits = cached  # exact full-prompt hit: no prefill compute
        else:
            logits, row_caches = self.model.prefill_one(ids, valid_np[None, :])
            for lp, phys in self._kv.fresh_pages(slot):
                self.caches = self.model.write_page(self.caches, row_caches,
                                                    lp, phys)
        self.valid = self.model.insert_valid(self.valid, row_valid, slot)
        s = req.sampling
        self._keys[slot] = (request_key(self._seed, req.request_id)
                            if s.temperature > 0.0 else None)
        self._temps[slot], self._topks[slot], self._topps[slot] = (
            s.temperature, s.top_k, s.top_p)
        toks, finite = sampled_tokens(
            logits, [self._keys[slot]], [0], [s.temperature], [s.top_k],
            [s.top_p])
        now = self._clock()
        if not finite[0]:
            # a poisoned prefill fails ITS request and is never cached
            self._fail_slot(slot, req, outputs, now)
            return
        if fresh_prefill:
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
