"""Inference engine: prefill, per-slot and paged decode, page writes, and
the solo ``generate`` reference (counterpart of
``neuronx_distributed_tpu/trace/engine.py``).

The JAX package compiles each phase function ahead of time; here the
per-step phase functions (``decode_pages``, ``verify_pages``,
``decode_slots``) are captured once per shape and state into a CUDA graph
on the card (``cuda_graphs``) and replayed, and run eagerly on the CPU.
Where JAX donates a cache and returns the updated array, the port updates
the cache tensors (and the validity mask) IN PLACE and returns them, so a
caller that threads the return values works unchanged.

Ragged prompts are LEFT-padded to ``context_len``; a per-row key-validity
mask ``valid [B, T]`` rides through every phase, and a token's RoPE
position is the count of valid keys before it.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import time
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from neuronx_distributed_tpu_torch.kvcache.quant import page_ranges, quantize_page
from neuronx_distributed_tpu_torch.obs.transfer_audit import allow_sync
from neuronx_distributed_tpu_torch.ops.paged_attention import (
    paged_attention,
    resolve_paged_kernel,
)
from neuronx_distributed_tpu_torch.parallel.mesh import TensorParallel
from neuronx_distributed_tpu_torch.utils import profiling
from neuronx_distributed_tpu_torch.utils.device import resolve_device

_MASK64 = (1 << 64) - 1

# salted per-request sub-streams for speculative decoding: accept coins and
# residual resampling must not collide with the token-index sampling stream
# (shared by the solo speculative_generate and the serving engine's batched
# draft-k-verify)
SPEC_ACCEPT_SALT = 7919
SPEC_RESIDUAL_SALT = 104729

# the launch counts a captured phase replays (paged_attention's counters)
LAUNCH_COUNTERS = ("launches", "int8_launches", "wgmma_launches",
                   "decode_launches")
# captured phase graphs a model keeps (least recently used dropped first)
MAX_GRAPHS = 16


def _fold(key: int, data: int) -> int:
    """Fold one integer into a 64-bit stream key (blake2b: stable across
    processes and runs)."""
    h = hashlib.blake2b(digest_size=8)
    h.update((int(key) & _MASK64).to_bytes(8, "little"))
    h.update((int(data) & _MASK64).to_bytes(8, "little"))
    return int.from_bytes(h.digest(), "little")


def request_key(seed: int, request_id: int) -> int:
    """Per-request sampling stream key: a request's sampled tokens depend
    only on ``(seed, request_id, token index)``, never on its co-batch.  Ids
    wider than 32 bits fold their high word first (the JAX ``request_rng``
    convention), so ids differing only in the high word draw disjoint
    streams."""
    key = int(seed) & _MASK64
    request_id = int(request_id)
    if request_id > 0xFFFFFFFF:
        key = _fold(key, request_id >> 32)
        request_id &= 0xFFFFFFFF
    return _fold(key, request_id)


def token_generator(key: int, token_index: int, device) -> torch.Generator:
    """The ``torch.Generator`` that draws token ``token_index`` of the
    stream ``key``."""
    g = torch.Generator(device=device)
    g.manual_seed(_fold(key, token_index) & ((1 << 63) - 1))
    return g


def _filtered_logits(logits, temperature, top_k=0, top_p=1.0):
    """Temperature/top-k/nucleus-filtered fp32 logits ``[..., V]`` -- the
    distribution the sampler draws from (dropped tokens at fp32 min)."""
    logits = logits.float() / max(float(temperature), 1e-6)
    neg = torch.finfo(torch.float32).min
    order = torch.argsort(-logits, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    if top_k > 0:
        logits = torch.where(ranks >= top_k, torch.full_like(logits, neg),
                             logits)
    if top_p < 1.0:
        # nucleus: drop tokens whose PRECEDING sorted mass reaches top_p;
        # the cutoff is the smallest kept logit
        sorted_logits = torch.gather(logits, -1, order)
        probs = torch.softmax(sorted_logits, dim=-1)
        keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
        cutoff = torch.where(keep, sorted_logits,
                             torch.full_like(sorted_logits, float("inf"))
                             ).min(dim=-1, keepdim=True).values
        logits = torch.where(logits < cutoff, torch.full_like(logits, neg),
                             logits)
    return logits


def gumbel_draw(log_weights, generator: torch.Generator) -> torch.Tensor:
    """One Gumbel-max draw from unnormalized log-weights ``[V]``."""
    u = torch.rand(log_weights.shape, generator=generator,
                   device=log_weights.device).clamp_min(1e-20)
    return torch.argmax(log_weights - torch.log(-torch.log(u)))


def sample_row(logits, temperature: float, top_k: int, top_p: float,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """One token from one row of logits ``[V]``: argmax when ``temperature
    == 0``, else a Gumbel-max draw from the filtered distribution with
    ``generator``."""
    if temperature <= 0.0:
        return torch.argmax(logits)
    if generator is None:
        raise ValueError("temperature sampling requires a generator")
    return gumbel_draw(_filtered_logits(logits, temperature, top_k, top_p),
                       generator)


@dataclasses.dataclass(frozen=True)
class InferenceConfig:
    """Serving shapes: slots, prompt width, cache length."""

    batch_size: int
    context_len: int
    max_total_len: int
    kv_cache_dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.max_total_len < self.context_len:
            raise ValueError(
                f"max_total_len ({self.max_total_len}) < context_len "
                f"({self.context_len})")


def init_kv_caches(num_layers: int, batch_size: int, max_total_len: int,
                   num_kv_heads: int, head_dim: int,
                   dtype: torch.dtype = torch.bfloat16, device=None):
    """Zero contiguous KV caches ``[B, T, NKV, D]`` per layer."""
    device = resolve_device(device)
    shape = (batch_size, max_total_len, num_kv_heads, head_dim)
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(num_layers)]


def refuse_kv_replication(tp) -> None:
    """Serving holds a rank's ``NKV / tp`` kv heads in its pool; at KV
    replication ``kvr > 1`` the heads and the pool are cut otherwise, which
    serving does not take yet."""
    if tp is not None and tp.kvr > 1:
        raise NotImplementedError(
            f"serving at kv_size_multiplier={tp.kvr} is not ported yet: the "
            f"page pool and the engines hold NKV / tp kv heads a rank "
            f"(ROADMAP A9c; training at kvr > 1 is ported)")


def resolve_cuda_graphs(flag, device, tp_size: int = 1) -> bool:
    """Resolve the ``cuda_graphs`` knob (``"auto"`` | ``True`` |
    ``False``): auto captures on a CUDA device and runs eagerly on the
    CPU; ``True`` on the CPU raises (a graph is a CUDA object).  At
    tensor-parallel degree > 1 the phases run collectives, which gloo
    cannot capture and one card cannot test under NCCL: auto resolves to
    off and ``True`` raises."""
    if flag in ("auto", None):
        return torch.device(device).type == "cuda" and tp_size == 1
    if flag is True or flag is False:
        if flag and torch.device(device).type != "cuda":
            raise ValueError(f"cuda_graphs=True needs a CUDA device, got "
                             f"{device}")
        if flag and tp_size > 1:
            raise NotImplementedError(
                f"cuda_graphs=True at tensor-parallel degree {tp_size}: "
                "capturing the phases' collectives is not ported yet "
                "(ROADMAP A9a, graphs over NCCL at tp > 1)")
        return flag
    raise ValueError(f"cuda_graphs must be 'auto', True or False, got "
                     f"{flag!r}")


def _launch_counts() -> List[int]:
    return [getattr(paged_attention, c) for c in LAUNCH_COUNTERS]


def _add_launch_counts(delta: Sequence[int]) -> None:
    for c, d in zip(LAUNCH_COUNTERS, delta):
        setattr(paged_attention, c, getattr(paged_attention, c) + d)


class _PhaseGraph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    inputs: Tuple[torch.Tensor, ...]   # static input buffers
    output: torch.Tensor               # static output buffer
    launches: Tuple[int, ...]          # counter moves of one replay


class PhaseGraphs:
    """One captured CUDA graph per (phase, shapes, state tensors): the
    port's counterpart of the JAX package's compiled phase executables.

    The first call of a key runs the phase eagerly (its real result, and
    the warm-up the kernels' launchers need before capture: their
    once-per-process ``cudaFuncSetAttribute``), then captures it over
    static copies of the inputs; every later call copies its inputs into
    those buffers and replays.  The state (caches, validity mask) is
    captured by address, so the key holds the state tensors' addresses and
    shapes: an engine that keeps its pool and mask keeps its graph.  A
    kernel's launch counters move in Python only while capturing, so the
    capture's moves are taken back and added once per replay.  Capture
    errors propagate: there is no eager fallback.

    ``capture=False`` (the CPU, where a model routes its phases here only
    to account them) keeps the keys and runs every call eagerly: the first
    call of a key is still its "compile", so a compile ledger sees the
    same keys on either device.

    With a ``ledger`` (:class:`~..obs.compile_ledger.CompileLedger`) a
    call accounts itself: the first call of a key is one ``compile`` row
    (family: the phase name, the key's first element; kind
    ``"cuda_graph"`` or ``"eager"``; its wall ms; the
    :func:`~..utils.profiling.cost_report` of the eager call, run under
    the counter and before the capture, never during it), a replay is a
    cache hit, and the LRU's pop an eviction row.  With ``perf`` (a
    :class:`~..obs.perf.PerfAttribution`) every call counts one execution
    of its family."""

    def __init__(self, capture: bool = True):
        self.capture = capture
        self._graphs: "collections.OrderedDict" = collections.OrderedDict()
        self.captures = 0
        self.replays = 0

    @staticmethod
    def state_key(caches, valid, apool=None) -> tuple:
        """The state a phase captures by address: the caches, the validity
        mask and, for an adapter phase, the adapter pool (its page writes
        are in place, so a graph keeps reading the current pages)."""
        first = caches[0]
        key = (len(caches), tuple((t.shape, t.dtype) for t in first),
               tuple(t.data_ptr() for entry in caches for t in entry),
               valid.shape, valid.data_ptr())
        if apool is not None:
            key += (apool.shape, apool.data_ptr())
        return key

    def keys_over(self, state: tuple) -> list:
        """The cached keys whose phase runs over ``state`` (a
        :meth:`state_key`): one engine's graphs on a shared model."""
        return [k for k in self._graphs if k[0][-1] == state]

    def drop(self, keys) -> int:
        """Forget ``keys`` (an engine closing, or moving to a private
        model); returns how many were held."""
        return sum(self._graphs.pop(k, False) is not False for k in keys)

    def run(self, key, fn: Callable, inputs: Sequence[torch.Tensor],
            ledger=None, perf=None) -> torch.Tensor:
        """``fn(*inputs)`` through the graph of ``key`` (which must name
        everything ``fn`` closes over and lead with the phase name);
        returns a fresh output tensor."""
        family = key[0]
        key = (key, tuple((t.shape, t.dtype) for t in inputs))
        if key in self._graphs:
            g = self._graphs[key]
            self._graphs.move_to_end(key)
            if ledger is not None:
                ledger.cache_hit(family)
            if perf is not None:
                perf.note_program_call(family)
            if g is None:  # accounted only: nothing was captured
                return fn(*inputs)
            for buf, x in zip(g.inputs, inputs):
                buf.copy_(x)
            g.graph.replay()
            _add_launch_counts(g.launches)
            self.replays += 1
            return g.output.clone()
        if ledger is not None:
            ledger.cache_miss(family)
            ledger.set_capacity(family, MAX_GRAPHS)
        t0 = time.perf_counter()
        cost = None
        # the first call of a key is the port's compile: its eager run and
        # the capture (which synchronizes the device) are not the steady
        # path, so a serving engine's ``forbid`` sync guard is lifted here
        with allow_sync():
            if ledger is not None and profiling.ACTIVE is None:
                # eager: this call's result, the warm-up and the cost
                out, cost = profiling.measure(fn, *inputs)
            else:  # (a caller's counter, if any, counts this call)
                out = fn(*inputs)
            entry = None
            if self.capture:
                static = tuple(x.clone() for x in inputs)
                graph = torch.cuda.CUDAGraph()
                before = _launch_counts()
                with torch.cuda.graph(graph):
                    static_out = fn(*static)
                moved = tuple(a - b for a, b in zip(_launch_counts(),
                                                    before))
                _add_launch_counts([-m for m in moved])  # capture launched nothing
                entry = _PhaseGraph(graph, static, static_out, moved)
                self.captures += 1
        self._graphs[key] = entry
        if ledger is not None:
            ledger.record_compile(
                family, key, (time.perf_counter() - t0) * 1e3,
                kind="cuda_graph" if self.capture else "eager", cost=cost)
        if perf is not None:
            perf.note_program_call(family)
        while len(self._graphs) > MAX_GRAPHS:
            old_key, _ = self._graphs.popitem(last=False)
            if ledger is not None:
                if ledger.registry is not None:
                    ledger.registry.counter(
                        "trace/compiled_cache_evictions_total").inc()
                ledger.record_eviction(old_key[0][0], old_key,
                                       capacity=MAX_GRAPHS)
        return out


class _ServingBase:
    """The solo reference shared by :class:`ParallelInferenceModel` and the
    loaded model of :mod:`.export`: ``generate`` over a subclass's
    ``_context_fn(ids, valid)`` and ``_decode_fn(tok, offset, caches,
    valid)`` at its ``config`` and ``device``."""

    def _tensor(self, x, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x).to(device=self.device, dtype=dtype)

    def _valid_ctx(self, prompt_lens, B: int, C: int) -> torch.Tensor:
        if prompt_lens is None:
            return torch.ones((B, C), dtype=torch.int32, device=self.device)
        lens = self._tensor(prompt_lens)
        if lens.shape != (B,):
            raise ValueError(f"prompt_lens shape {tuple(lens.shape)} != ({B},)")
        ar = torch.arange(C, device=self.device)[None, :]
        return (ar >= C - lens[:, None]).to(torch.int32)

    def generate(self, prompt_ids, max_new_tokens: int,
                 temperature: float = 0.0, seed: Optional[int] = None,
                 prompt_lens=None, top_k: int = 0, top_p: float = 1.0,
                 request_ids: Optional[Sequence[int]] = None) -> torch.Tensor:
        """Prefill + stepped decode over a fixed batch; returns ``[B, C +
        max_new_tokens]``.  ``prompt_lens`` enables left-padded ragged
        prompts.  Sampling (``temperature > 0``) needs ``seed``; row ``b``
        draws token ``i`` from the stream ``(seed, request_ids[b], i)``
        (default request ids: the row indices), the streams the serving
        engine uses."""
        cfg = self.config
        ids = self._tensor(prompt_ids, torch.long)
        B, C = ids.shape
        if B != cfg.batch_size or C != cfg.context_len:
            raise ValueError(f"prompt shape {(B, C)} does not match the "
                             f"serving shape {(cfg.batch_size, cfg.context_len)}")
        if C + max_new_tokens > cfg.max_total_len:
            raise ValueError(f"context {C} + new {max_new_tokens} exceeds "
                             f"max_total_len {cfg.max_total_len}")
        if temperature > 0.0 and seed is None:
            raise ValueError("temperature sampling requires a seed")
        rids = list(range(B)) if request_ids is None else list(request_ids)
        if len(rids) != B:
            raise ValueError(f"{len(rids)} request_ids for batch {B}")
        keys = ([request_key(seed, r) for r in rids] if seed is not None
                else [None] * B)
        T = cfg.max_total_len
        valid = self._valid_ctx(prompt_lens, B, C)
        logits, caches = self._context_fn(ids, valid)
        valid = torch.cat([valid, torch.zeros((B, T - C), dtype=torch.int32,
                                              device=self.device)], dim=1)

        def sample(lg, i):
            return torch.stack([
                sample_row(lg[b], temperature, top_k, top_p,
                           None if keys[b] is None
                           else token_generator(keys[b], i, self.device))
                for b in range(B)])

        toks: List[torch.Tensor] = [ids]
        nxt = sample(logits, 0)[:, None]
        toks.append(nxt)
        for step in range(max_new_tokens - 1):
            logits, caches, valid = self._decode_fn(nxt, C + step, caches, valid)
            nxt = sample(logits, step + 1)[:, None]
            toks.append(nxt)
        return torch.cat(toks, dim=1)


class ParallelInferenceModel(_ServingBase):
    """Serving wrapper around a causal LM with ``LlamaForCausalLM``'s
    forward (Llama, ``GemmaForCausalLM``, ``Gemma2ForCausalLM``): the
    per-phase functions the continuous-batching engine threads its state
    through, and a solo ``generate``.

    ``device`` defaults to CUDA (raises without it); the module is moved
    there.  ``paged_kernel`` (``"auto"`` = the kernel on CUDA, the gather
    path on the CPU) is the default of :meth:`decode_pages`.
    ``cuda_graphs`` (``"auto"`` = on CUDA; ``True`` on the CPU raises)
    replays :meth:`decode_pages`, :meth:`verify_pages` and
    :meth:`decode_slots` from CUDA graphs (:class:`PhaseGraphs`) once a
    shape and state has run once.  ``compile_ledger`` (an
    ``obs.CompileLedger``; a serving engine attaches its own here) accounts
    every capture, replay and eviction of those phases, and ``perf`` (an
    ``obs.PerfAttribution``, attached the same way) counts their
    executions; without graphs a ledger still routes the phases through
    :class:`PhaseGraphs`, which then accounts them without capturing.
    Both None (the default) cost one attribute test a phase call."""

    def __init__(self, module, config: InferenceConfig, paged_kernel="auto",
                 device=None, cuda_graphs="auto", compile_ledger=None):
        self.device = resolve_device(device)
        # the tensor-parallel context the module was built in: this rank
        # holds NKV / tp heads of the pool and V / tp of the logits
        self.tp = getattr(module, "tp", None) or TensorParallel()
        refuse_kv_replication(self.tp)
        self.cuda_graphs = resolve_cuda_graphs(cuda_graphs, self.device,
                                               self.tp.size)
        self.graphs = PhaseGraphs(capture=self.cuda_graphs)
        self.compile_ledger = compile_ledger
        self.perf = None
        self.module = module.to(self.device).eval()
        self.module.requires_grad_(False)
        self.config = config
        mcfg = module.config
        self.num_layers = mcfg.num_layers
        self.num_kv_heads = self.tp.shard(mcfg.num_kv_heads, "kv heads")
        self.head_dim = mcfg.head_dim_
        self.paged_kernel = resolve_paged_kernel(paged_kernel, self.device)

    def _full(self, logits):
        """The full-vocab logits from this rank's slice (all-gathered at
        tp > 1, after the last position is cut): every rank samples the
        same tokens from them with the same generators."""
        if self.tp.size == 1:
            return logits
        return self.module.gather_logits(logits)

    def empty_caches(self, batch_size: Optional[int] = None):
        cfg = self.config
        return init_kv_caches(self.num_layers, batch_size or cfg.batch_size,
                              cfg.max_total_len, self.num_kv_heads,
                              self.head_dim, cfg.kv_cache_dtype, self.device)

    # -- phase functions ---------------------------------------------------

    @torch.no_grad()
    def _context_fn(self, ids, valid, adapters=None):
        """Prefill ``ids [B, C]`` with validity ``valid [B, C]`` (real,
        non-left-pad tokens) into fresh ``[B, T]`` caches; returns the
        last-position logits ``[B, V]`` and the caches.  ``adapters``: the
        per-layer LoRA factors of :meth:`_gather_adapters`, or None."""
        ids, valid = self._tensor(ids, torch.long), self._tensor(valid)
        B, C = ids.shape
        T = self.config.max_total_len
        positions = (torch.cumsum(valid, dim=1) - 1).clamp_min(0)
        # future cache slots are gated by the causal mask, not by validity
        kv_valid = torch.cat(
            [valid, torch.ones((B, T - C), dtype=valid.dtype,
                               device=self.device)], dim=1)
        caches = self.empty_caches(B)
        logits, caches = self.module(ids, positions, caches, 0,
                                     kv_valid=kv_valid, adapters=adapters)
        return self._full(logits[:, -1, :]), caches

    def prefill_one(self, ids, valid):
        """Single-request prefill ``[1, C] -> (logits [1, V], caches B=1)``:
        the same function as the batched :meth:`_context_fn`, so a slot's
        prefill equals a solo ``generate``'s."""
        return self._context_fn(ids, valid)

    @torch.no_grad()
    def _decode_fn(self, tok, offset, caches, valid):
        """One token step at the scalar cache index ``offset`` (the solo
        path: an int, or a 0-d int tensor, the form the exported decode
        program takes); ``valid [B, T]`` gains the new key.  Returns
        ``(logits [B, V], caches, valid)``."""
        tok = self._tensor(tok, torch.long)
        ar = torch.arange(valid.shape[1], device=self.device)[None, :]
        valid.masked_fill_(ar == offset, 1)
        before = torch.where(ar < offset, valid, 0)
        positions = before.sum(dim=1, keepdim=True)
        logits, caches = self.module(tok, positions, caches, offset,
                                     kv_valid=valid)
        return self._full(logits[:, -1, :]), caches, valid

    def decode_slots(self, tok, offsets, caches, valid, apool=None,
                     atables=None):
        """One token step with per-slot cache offsets ``[B]`` over
        contiguous caches: every slot writes its new key at its own
        position and takes its RoPE phase from its own validity prefix; an
        offset of ``T`` parks an idle slot.  ``apool``/``atables`` run the
        step under each slot's LoRA adapter (a speculative draft that
        shares the target's adapters).  Returns ``(logits [B, V], caches,
        valid)``."""
        inputs = (self._tensor(tok, torch.long), self._tensor(offsets))
        if apool is not None:
            inputs += (self._tensor(atables),)

        def fn(t, o, at=None):
            return self._decode_slots_fn(t, o, caches, valid, apool, at)

        if not self.cuda_graphs and self.compile_ledger is None:
            return fn(*inputs), caches, valid
        logits = self.graphs.run(
            ("decode_slots", apool is not None,
             PhaseGraphs.state_key(caches, valid, apool)), fn, inputs,
            self.compile_ledger, self.perf)
        return logits, caches, valid

    @torch.no_grad()
    def _decode_slots_fn(self, tok, offsets, caches, valid, apool=None,
                         atables=None):
        T = valid.shape[1]
        ar = torch.arange(T, device=self.device)[None, :]
        valid.masked_fill_(ar == offsets[:, None], 1)
        before = torch.where(ar < offsets[:, None], valid, 0)
        positions = before.sum(dim=1, keepdim=True)
        logits, _ = self.module(tok, positions, caches, offsets,
                                kv_valid=valid,
                                adapters=self._gather_adapters(apool, atables))
        return self._full(logits[:, -1, :])

    @torch.no_grad()
    def _score_chunk(self, toks, offset: int, caches, valid):
        """Score a chunk ``toks [B, S]`` written at the scalar cache index
        ``offset`` over contiguous caches (the solo speculative verify):
        the chunk's cells are marked valid, positions are prefix counts,
        and EVERY position's logits ``[B, S, V]`` come back."""
        toks = self._tensor(toks, torch.long)
        S = toks.shape[1]
        valid[:, offset:offset + S] = 1
        counts = torch.cumsum(valid, dim=1) - valid
        positions = counts[:, offset:offset + S]
        logits, caches = self.module(toks, positions, caches, offset,
                                     kv_valid=valid)
        return self._full(logits), caches, valid

    def score_chunk(self, ids, offset: int, caches, valid):
        """Score ``ids [B, S]`` written at the scalar cache index ``offset``
        over contiguous caches; returns ``(logits [B, S, V], caches,
        valid)`` (the JAX ``score_chunk``: teacher-forced chunk scoring, the
        solo speculative verify)."""
        return self._score_chunk(ids, offset, caches, valid)

    @torch.no_grad()
    def insert_slot(self, caches, row_caches, valid, row_valid, slot: int):
        """Write a prefilled request's one-row caches and validity row at
        batch index ``slot``."""
        for (ck, cv), (rk, rv) in zip(caches, row_caches):
            ck[slot].copy_(rk[0])
            cv[slot].copy_(rv[0])
        return caches, self.insert_valid(valid, row_valid, slot)

    @torch.no_grad()
    def insert_valid(self, valid, row_valid, slot: int):
        """Write the validity row of a paged admission (block tables carry
        the KV)."""
        valid[slot].copy_(self._tensor(row_valid).reshape(-1))
        return valid

    # -- paged KV ----------------------------------------------------------

    def make_page_pool(self, num_pages: int, page_size: int,
                       quant: Optional[str] = None):
        """A :class:`~..kvcache.pool.PagePool` for this model's layers and
        cache type on the model's device (``quant="int8"``: the int8
        six-tuple pool)."""
        from neuronx_distributed_tpu_torch.kvcache.pool import PagePool

        return PagePool(self.num_layers, num_pages, page_size,
                        self.num_kv_heads, self.head_dim,
                        self.config.kv_cache_dtype, quant=quant,
                        device=self.device)

    @torch.no_grad()
    def _paged_step_fn(self, toks, offsets, block_table, caches, valid,
                       paged_kernel: bool, update_valid: bool = True,
                       last_only: bool = True, apool=None, atables=None):
        """THE paged phase function: token ``s`` of slot ``b`` is written
        at cache index ``offsets[b] + s`` through the block table;
        positions are prefix counts of the validity row.  ``S = 1`` is
        decode; verify (``S = k+1``, ``last_only=False``) and chunked
        prefill (``update_valid=False``) are the same function with more
        query rows.  ``apool``/``atables`` add each slot's LoRA deltas
        (multi-adapter serving; any ``S``).  An offset of ``T`` parks an
        idle slot."""
        S = toks.shape[1]
        T = valid.shape[1]
        idx = offsets[:, None] + torch.arange(S, device=self.device)[None, :]
        if update_valid:
            hot = (torch.arange(T, device=self.device)[None, None, :]
                   == idx[:, :, None]).any(dim=1)
            valid.masked_fill_(hot, 1)
        counts = torch.cumsum(valid, dim=1) - valid
        positions = counts.gather(1, idx.clamp(0, T - 1).long())
        logits, caches = self.module(
            toks, positions, caches, offsets, kv_valid=valid,
            block_table=block_table, paged_kernel=paged_kernel,
            adapters=self._gather_adapters(apool, atables))
        if last_only:
            logits = logits[:, -1, :]
        return self._full(logits), caches, valid

    def _paged_phase(self, name: str, toks, offsets, block_table, caches,
                     valid, paged_kernel, last_only: bool, apool=None,
                     atables=None):
        """:meth:`_paged_step_fn` with ``valid`` updated, through the
        phase's CUDA graph when graphs are on.  The adapter tables ride as
        a graph input; the adapter pool is state, like the caches."""
        pk = self.paged_kernel if paged_kernel is None else bool(paged_kernel)
        inputs = (self._tensor(toks, torch.long), self._tensor(offsets),
                  self._tensor(block_table))
        if apool is not None:
            inputs += (self._tensor(atables),)

        def fn(t, o, bt, at=None):
            return self._paged_step_fn(t, o, bt, caches, valid,
                                       paged_kernel=pk, last_only=last_only,
                                       apool=apool, atables=at)[0]

        if not self.cuda_graphs and self.compile_ledger is None:
            return fn(*inputs), caches, valid
        logits = self.graphs.run(
            (name, pk, apool is not None,
             PhaseGraphs.state_key(caches, valid, apool)), fn, inputs,
            self.compile_ledger, self.perf)
        return logits, caches, valid

    def decode_pages(self, tok, offsets, block_table, caches, valid,
                     paged_kernel=None):
        """Paged per-slot decode step (``S = 1``): ``block_table [B, T //
        page]`` int32 maps logical to physical pages, ``caches`` is the
        pool.  ``paged_kernel`` (default: the model's) selects the
        paged-attention kernel over the gather path.  Returns ``(logits
        [B, V], caches, valid)``."""
        return self._paged_phase("decode_pages", tok, offsets, block_table,
                                 caches, valid, paged_kernel, True)

    def decode_pages_lora(self, tok, offsets, block_table, caches, valid,
                          apool, atables, paged_kernel=None):
        """:meth:`decode_pages` under per-slot LoRA adapters: ``apool`` is
        the adapter pool (:meth:`make_adapter_pool`), ``atables [B,
        pages_per_adapter]`` int32 each slot's adapter page map (an
        all-NULL row is adapter 0, an exact no-op).  The deltas land on q
        and v before RoPE and the page write, so the kernel and the gather
        path attend the same adapted projections."""
        return self._paged_phase("decode_pages_lora", tok, offsets,
                                 block_table, caches, valid, paged_kernel,
                                 True, apool, atables)

    def verify_pages(self, toks, offsets, block_table, caches, valid,
                     paged_kernel=None, apool=None, atables=None):
        """Batched speculative verification (``S = k + 1``): the
        ``last_only=False`` member of :meth:`_paged_step_fn`.  Token ``s``
        of slot ``b`` is written at cache index ``offsets[b] + s`` (int8
        pools requantize the pages the chunk covers) and position ``i``'s
        logits judge the draft's proposal ``i + 1``.  An offset of ``T``
        parks an idle slot.  ``apool``/``atables`` score each slot under
        its own adapter, as its plain decode would.  Returns ``(logits [B,
        S, V], caches, valid)``."""
        return self._paged_phase("verify_pages", toks, offsets, block_table,
                                 caches, valid, paged_kernel, False, apool,
                                 atables)

    def prefill_chunk_pages(self, ids, offset: int, block_table, caches,
                            valid, paged_kernel=None, apool=None,
                            atables=None):
        """Paged chunk prefill: the ``S = Cc``, ``update_valid=False``
        member of :meth:`_paged_step_fn`.  ``ids [1, Cc]`` is the chunk's
        slice of the left-padded prompt, ``offset`` the cache index its
        first token writes at, ``block_table [1, PP]`` the slot's page map
        and ``valid [1, T]`` the slot's validity row with the FULL prompt's
        validity written and zeros beyond it: positions are prefix counts
        of that row, so RoPE phases equal a whole ``prefill_one``'s, and
        keys past the chunk are causally masked.  ``apool``/``atables [1,
        pages_per_adapter]`` prefill under the request's adapter.  Returns
        the chunk's last-position logits ``[1, V]`` (the final chunk's are
        the prefill logits) and the pool."""
        pk = self.paged_kernel if paged_kernel is None else bool(paged_kernel)
        logits, caches, _ = self._paged_step_fn(
            self._tensor(ids, torch.long), self._tensor([offset]),
            self._tensor(block_table), caches, self._tensor(valid),
            paged_kernel=pk, update_valid=False, last_only=True,
            apool=apool,
            atables=None if apool is None else self._tensor(atables))
        return logits, caches

    # -- multi-adapter pool (tenancy) -----------------------------------------

    def make_adapter_pool(self, layout, num_pages: int) -> torch.Tensor:
        """The device adapter pool ``[num_pages, page_elems]`` fp32, all
        zeros; page 0 is the NULL page, whose zeros ARE adapter 0.
        ``layout`` (a :class:`~..tenancy.AdapterLayout`) is what
        :meth:`_gather_adapters` slices the gathered pages by."""
        self._adapter_layout = layout
        return torch.zeros((num_pages, layout.page_elems),
                           dtype=torch.float32, device=self.device)

    @torch.no_grad()
    def write_adapter_page(self, pool, block, phys):
        """Write host pages into the adapter pool IN PLACE: ``block
        [page_elems]`` into page ``phys``, or ``block [n, page_elems]``
        into pages ``phys [n]`` (a cold load in one copy).  The pool keeps
        its address, so every graph captured over it reads the new pages.
        The host block is copied from pageable memory, which the copy
        reads before it returns."""
        idx = torch.as_tensor(np.atleast_1d(np.asarray(phys, np.int64)),
                              device=self.device)
        src = torch.as_tensor(np.asarray(block, np.float32)).reshape(
            idx.numel(), -1)
        pool.index_copy_(0, idx, src.to(self.device))
        return pool

    def _gather_adapters(self, apool, atables):
        """Per-slot, per-layer LoRA factors from the adapter pool: ONE
        gather of every slot's pages (``apool[atables]``), then the static
        slices of the layout, ``[(a_q [B, H, r], b_q [B, r, NQ*D], a_v,
        b_v), ...]`` per layer (views, no copy).  Slots on adapter 0 hold
        all-NULL tables and gather zeros.  No pool: None (the base
        model)."""
        if apool is None:
            return None
        layout = self._adapter_layout
        B = atables.shape[0]
        flat = apool[atables.long()].reshape(B, -1)  # [B, AP * page_elems]
        out = [tuple(flat[:, off:off + shape[0] * shape[1]].view(B, *shape)
                     for _, off, shape in entries)
               for entries in layout.layer_entries()]
        if self.tp.size > 1:
            # the pool is replicated (the full factors); a rank's q/v
            # projections are its head blocks, so it takes its columns of
            # b_q and b_v
            out = [(a_q, self._tp_columns(b_q), a_v, self._tp_columns(b_v))
                   for a_q, b_q, a_v, b_v in out]
        return out

    def _tp_columns(self, b: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the last dim of ``b`` (a view)."""
        n = self.tp.shard(b.shape[-1], "adapter columns")
        return b.narrow(-1, self.tp.rank * n, n)

    def prefill_one_lora(self, ids, valid, apool, atable):
        """:meth:`prefill_one` under the request's adapter (``atable [1,
        pages_per_adapter]``): the adapter's deltas shape the prompt's KV
        as a merged dense model would.  Returns ``(logits [1, V], caches
        B=1)``."""
        return self._context_fn(
            ids, valid, adapters=self._gather_adapters(
                apool, self._tensor(atable)))

    @torch.no_grad()
    def write_page(self, caches, row_caches, logical_page: int,
                   phys_page: int, row_valid=None):
        """Copy page ``logical_page`` of the ``prefill_one`` row caches into
        pool page ``phys_page``.  An int8 pool quantizes on write (scale and
        zero from the page's content) with the invalid (left-pad) cells of
        ``row_valid [C]`` zeroed first: their values are masked-attention
        garbage that must not set the page's scale, and zeroing them is what
        the chunk scatter's valid-masked write gives, so chunked and whole
        int8 prefills quantize the same pages.  An fp pool ignores
        ``row_valid``."""
        quantized = []  # (codes, scale, zero, page) of an int8 pool
        for entry, (rk, rv) in zip(caches, row_caches):
            page = entry[0].shape[1]
            lo = logical_page * page
            if len(entry) == 2:
                entry[0][phys_page].copy_(rk[0, lo:lo + page])
                entry[1][phys_page].copy_(rv[0, lo:lo + page])
                continue
            keep = None
            if row_valid is not None:
                keep = self._tensor(row_valid).reshape(-1)[lo:lo + page] > 0
            for cq, sc, zp, r in ((entry[0], entry[2], entry[3], rk),
                                  (entry[1], entry[4], entry[5], rv)):
                chunk = r[0, lo:lo + page]
                if keep is not None:
                    chunk = chunk * keep[:, None, None].to(chunk.dtype)
                quantized.append((cq, sc, zp, chunk))
        # a shard's page range is over every rank's heads: one all-reduce
        # for every layer's k and v at tp > 1
        ranges = (page_ranges([q[3] for q in quantized], self.tp.group)
                  if quantized else [])
        for (cq, sc, zp, chunk), stats in zip(quantized, ranges):
            cq[phys_page], sc[phys_page], zp[phys_page] = \
                quantize_page(chunk, stats)
        return caches

    @torch.no_grad()
    def copy_page(self, caches, src_page: int, dst_page: int):
        """Pool-internal page copy, the device half of copy-on-write: every
        entry of a layer, the 1-D page params of an int8 pool included."""
        for entry in caches:
            for c in entry:
                c[dst_page].copy_(c[src_page])
        return caches

    # -- solo reference ----------------------------------------------------


def sample_rows(logits, keys: Sequence[Optional[int]],
                tok_idx: Sequence[int], temps: Sequence[float],
                top_ks: Sequence[int], top_ps: Sequence[float]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise sampler on the device (the JAX engine's ``_sample_rows``):
    row ``b`` draws token ``tok_idx[b]`` of its request's stream
    ``keys[b]`` with its own sampler settings (host values, written once
    at admission); greedy rows take the argmax and ignore their key.
    Returns ``(tokens [B] int64, finite [B] bool)`` as device tensors,
    ``finite[b]`` False when row ``b``'s logits hold NaN/Inf.  Nothing
    here waits for the device."""
    finite = torch.isfinite(logits.float()).all(dim=-1)
    toks = torch.argmax(logits, dim=-1)
    for b in range(logits.shape[0]):
        if temps[b] > 0.0:
            toks[b] = sample_row(
                logits[b], temps[b], top_ks[b], top_ps[b],
                token_generator(keys[b], tok_idx[b], logits.device))
    return toks, finite


def propose_rows(logits, keys: Sequence[Optional[int]],
                 tok_idx: Sequence[int], temps: Sequence[float],
                 top_ks: Sequence[int], top_ps: Sequence[float]
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A draft's proposals: exactly :func:`sample_rows`' draws (the same
    per-request token-index streams, so with draft == target the proposals
    ARE the plain sampler's tokens), plus the filtered fp32 logits ``[B,
    V]`` each sampled row was drawn from (the q distribution the accept
    test needs; greedy rows carry their raw logits, which it ignores).
    Returns ``(tokens [B], q_filtered [B, V], finite [B])``."""
    finite = torch.isfinite(logits.float()).all(dim=-1)
    toks = torch.argmax(logits, dim=-1)
    q = logits.to(torch.float32, copy=True)
    for b in range(logits.shape[0]):
        if temps[b] > 0.0:
            q[b] = _filtered_logits(logits[b], temps[b], top_ks[b],
                                    top_ps[b])
            toks[b] = gumbel_draw(q[b], token_generator(
                keys[b], tok_idx[b], logits.device))
    return toks, q, finite


def pack_tokens(toks, finite) -> torch.Tensor:
    """A decode step's whole device-to-host payload as one ``[2, B]`` int32
    tensor (tokens, finite flags): one fetch per step."""
    return torch.stack([toks.to(torch.int32), finite.to(torch.int32)])


def sampled_tokens(logits, keys: Sequence[Optional[int]],
                   tok_idx: Sequence[int], temps: Sequence[float],
                   top_ks: Sequence[int], top_ps: Sequence[float]
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`sample_rows` fetched to the host in one copy: ``(tokens
    [B], finite [B] bool)`` as numpy arrays."""
    packed = pack_tokens(*sample_rows(logits, keys, tok_idx, temps, top_ks,
                                      top_ps)).cpu().numpy()
    return packed[0].astype(np.int64), packed[1].astype(bool)


def spec_keys(key: int) -> Tuple[int, int]:
    """The accept-coin and residual-draw stream keys of a request stream
    ``key`` (salted, so neither collides with its token-index stream)."""
    return _fold(key, SPEC_ACCEPT_SALT), _fold(key, SPEC_RESIDUAL_SALT)


def speculative_generate(target: ParallelInferenceModel,
                         draft: ParallelInferenceModel, prompt_ids,
                         max_new_tokens: int, k: int = 4, prompt_lens=None,
                         return_stats: bool = False,
                         temperature: float = 0.0, top_k: int = 0,
                         top_p: float = 1.0, seed: Optional[int] = None,
                         request_ids: Optional[Sequence[int]] = None):
    """Speculative decoding over a fixed batch (the JAX
    ``speculative_generate``): the draft proposes ``k`` tokens per round
    with single-token decodes on its own contiguous caches, and the target
    scores the round's ``k + 1`` tokens in ONE chunk forward.  The batch
    advances in lockstep by its smallest acceptance (one host sync per
    round).

    Greedy (``temperature == 0``): accept while the target's argmax
    agrees; the first disagreement takes the target's token, and a fully
    accepted round the target's bonus token, so the output is the target's
    own greedy decode.  Sampled: Leviathan et al. accept/reject, coins
    from each row's ``SPEC_ACCEPT_SALT`` stream, the first rejection
    resampled from ``norm(max(p - q, 0))`` on its ``SPEC_RESIDUAL_SALT``
    stream, and every proposal and bonus token on the plain token-index
    stream of ``(seed, request_ids[b])`` (as :meth:`generate`), so with
    ``draft == target`` the sampled output is :meth:`generate`'s.  Rejected
    cache cells are never rewound: they lie at or past the next write
    offset, hidden by the causal mask and overwritten by the next round.
    Returns ``[B, C + max_new_tokens]`` (and ``{"rounds", "proposed",
    "accepted", "acceptance_rate"}`` with ``return_stats``)."""
    tcfg, dcfg = target.config, draft.config
    for f in ("batch_size", "context_len", "max_total_len"):
        if getattr(tcfg, f) != getattr(dcfg, f):
            raise ValueError(
                f"target/draft serving shapes differ on {f}: "
                f"{getattr(tcfg, f)} vs {getattr(dcfg, f)}")
    tv, dv = target.module.config.vocab_size, draft.module.config.vocab_size
    if tv != dv:
        raise ValueError(f"target/draft vocab_size differ ({tv} vs {dv}): "
                         "speculative decoding needs one shared tokenizer")
    ids = target._tensor(prompt_ids, torch.long)
    B, C = ids.shape
    T = tcfg.max_total_len
    if (B, C) != (tcfg.batch_size, tcfg.context_len):
        raise ValueError(f"prompt shape {(B, C)} does not match the serving "
                         f"shape {(tcfg.batch_size, tcfg.context_len)}")
    if C + max_new_tokens > T:
        raise ValueError(f"context {C} + new {max_new_tokens} exceeds "
                         f"max_total_len {T}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    sampling = temperature > 0.0
    if sampling and seed is None:
        raise ValueError("temperature sampling requires a seed")
    rids = list(range(B)) if request_ids is None else list(request_ids)
    if len(rids) != B:
        raise ValueError(f"{len(rids)} request_ids for batch {B}")
    keys = [request_key(seed, r) for r in rids] if sampling else [None] * B
    dev = target.device

    def gen(key, i):
        return token_generator(key, i, dev)

    valid_ctx = target._valid_ctx(prompt_lens, B, C)
    logits_t, caches_t = target._context_fn(ids, valid_ctx)
    _, caches_d = draft._context_fn(ids, valid_ctx)
    valid_t = torch.cat([valid_ctx, torch.zeros((B, T - C), dtype=torch.int32,
                                                device=dev)], dim=1)
    first = torch.stack([sample_row(logits_t[b], temperature, top_k, top_p,
                                    gen(keys[b], 0) if sampling else None)
                         for b in range(B)])
    committed = [first[:, None]]
    n_done, offset = 1, C
    rounds = proposed = accepted = 0
    while n_done < max_new_tokens:
        kk = min(k, max_new_tokens - n_done)
        vd = valid_t.clone()
        tok, props, q_filt = committed[-1], [], []
        for j in range(kk):
            dlogits, caches_d, vd = draft._decode_fn(tok, offset + j,
                                                      caches_d, vd)
            if sampling:
                qf = torch.stack([_filtered_logits(dlogits[b], temperature,
                                                   top_k, top_p)
                                  for b in range(B)])
                q_filt.append(qf)
                nxt = torch.stack([gumbel_draw(qf[b], gen(keys[b], n_done + j))
                                   for b in range(B)])
            else:
                nxt = torch.argmax(dlogits, dim=-1)
            tok = nxt[:, None]
            props.append(tok)
        props = torch.cat(props, dim=1)                          # [B, kk]
        chunk = torch.cat([committed[-1], props], dim=1)
        logits_full, caches_t, valid_t = target._score_chunk(
            chunk, offset, caches_t, valid_t)
        if sampling:
            pf = torch.stack([_filtered_logits(logits_full[b], temperature,
                                               top_k, top_p)
                              for b in range(B)])                # [B, kk+1, V]
            p_probs = torch.softmax(pf[:, :kk], dim=-1)
            q_probs = torch.softmax(torch.stack(q_filt, dim=1), dim=-1)
            px = p_probs.gather(-1, props[..., None])[..., 0]
            qx = q_probs.gather(-1, props[..., None])[..., 0]
            u = torch.stack([torch.stack([
                torch.rand((), generator=gen(spec_keys(keys[b])[0],
                                             n_done + j), device=dev)
                for j in range(kk)]) for b in range(B)])
            accept = (u < torch.clamp(px / qx.clamp_min(1e-20), max=1.0)
                      ).cpu().numpy()
            lead = np.minimum.accumulate(accept, axis=1)
            j = int(lead.all(axis=0).sum())
            take = min(j + 1, max_new_tokens - n_done)
            for i in range(min(take, j)):
                committed.append(props[:, i:i + 1])
            if take == j + 1:
                if j == kk:  # full accept: the bonus straight from p_kk
                    nxt = torch.stack([gumbel_draw(pf[b, kk],
                                                   gen(keys[b], n_done + kk))
                                       for b in range(B)])
                else:
                    res = (p_probs[:, j] - q_probs[:, j]).clamp_min(0.0)
                    res_sum = res.sum(dim=-1, keepdim=True)
                    # rows whose own coins still accepted at j draw from p
                    # directly, as do degenerate all-zero residuals
                    rejected = torch.from_numpy(~lead[:, j]).to(dev)[:, None]
                    dist = torch.where(rejected & (res_sum > 0),
                                       res / res_sum.clamp_min(1e-20),
                                       p_probs[:, j])
                    nxt = torch.stack([gumbel_draw(
                        torch.log(dist[b].clamp_min(1e-20)),
                        gen(spec_keys(keys[b])[1], n_done + j))
                        for b in range(B)])
                committed.append(nxt[:, None])
        else:
            tgt = torch.argmax(logits_full, dim=-1)              # [B, kk+1]
            agree = (tgt[:, :kk] == props).cpu().numpy()
            lead = np.minimum.accumulate(agree, axis=1)
            j = int(lead.all(axis=0).sum())
            take = min(j + 1, max_new_tokens - n_done)
            for i in range(take - 1):
                committed.append(props[:, i:i + 1])
            committed.append(tgt[:, take - 1:take])
        if take == kk + 1:
            # full accept: the draft proposed its last token but never
            # wrote it; it now lies in the committed region, so ingest it
            _, caches_d, vd = draft._decode_fn(props[:, kk - 1:kk],
                                               offset + kk, caches_d, vd)
        n_done += take
        offset += take
        rounds += 1
        proposed += kk
        accepted += j
    out = torch.cat([ids] + committed, dim=1)
    if return_stats:
        return out, {"rounds": rounds, "proposed": proposed,
                     "accepted": accepted,
                     "acceptance_rate": accepted / max(proposed, 1)}
    return out
