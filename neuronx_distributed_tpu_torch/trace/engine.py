"""Inference engine: prefill, per-slot and paged decode, page writes, and
the solo ``generate`` reference (counterpart of
``neuronx_distributed_tpu/trace/engine.py``).

The JAX package compiles each phase function ahead of time; PyTorch runs
them eagerly, so the phase functions here are plain methods.  Where JAX
donates a cache and returns the updated array, the port updates the cache
tensors (and the validity mask) IN PLACE and returns them, so a caller that
threads the return values works unchanged.

Ragged prompts are LEFT-padded to ``context_len``; a per-row key-validity
mask ``valid [B, T]`` rides through every phase, and a token's RoPE
position is the count of valid keys before it.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from neuronx_distributed_tpu_torch.kvcache.quant import quantize_page
from neuronx_distributed_tpu_torch.ops.paged_attention import resolve_paged_kernel
from neuronx_distributed_tpu_torch.utils.device import resolve_device

_MASK64 = (1 << 64) - 1


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


def sample_row(logits, temperature: float, top_k: int, top_p: float,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """One token from one row of logits ``[V]``: argmax when ``temperature
    == 0``, else a Gumbel-max draw from the filtered distribution with
    ``generator``."""
    if temperature <= 0.0:
        return torch.argmax(logits)
    if generator is None:
        raise ValueError("temperature sampling requires a generator")
    filtered = _filtered_logits(logits, temperature, top_k, top_p)
    u = torch.rand(filtered.shape, generator=generator,
                   device=filtered.device).clamp_min(1e-20)
    return torch.argmax(filtered - torch.log(-torch.log(u)))


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


class ParallelInferenceModel:
    """Serving wrapper around a causal LM with ``LlamaForCausalLM``'s
    forward (Llama, ``GemmaForCausalLM``, ``Gemma2ForCausalLM``): the
    per-phase functions the continuous-batching engine threads its state
    through, and a solo ``generate``.

    ``device`` defaults to CUDA (raises without it); the module is moved
    there.  ``paged_kernel`` (``"auto"`` = the kernel on CUDA, the gather
    path on the CPU) is the default of :meth:`decode_pages`."""

    def __init__(self, module, config: InferenceConfig, paged_kernel="auto",
                 device=None):
        self.device = resolve_device(device)
        self.module = module.to(self.device).eval()
        self.module.requires_grad_(False)
        self.config = config
        mcfg = module.config
        self.num_layers = mcfg.num_layers
        self.num_kv_heads = mcfg.num_kv_heads
        self.head_dim = mcfg.head_dim_
        self.paged_kernel = resolve_paged_kernel(paged_kernel, self.device)

    def _tensor(self, x, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x).to(device=self.device, dtype=dtype)

    def empty_caches(self, batch_size: Optional[int] = None):
        cfg = self.config
        return init_kv_caches(self.num_layers, batch_size or cfg.batch_size,
                              cfg.max_total_len, self.num_kv_heads,
                              self.head_dim, cfg.kv_cache_dtype, self.device)

    # -- phase functions ---------------------------------------------------

    @torch.no_grad()
    def _context_fn(self, ids, valid):
        """Prefill ``ids [B, C]`` with validity ``valid [B, C]`` (real,
        non-left-pad tokens) into fresh ``[B, T]`` caches; returns the
        last-position logits ``[B, V]`` and the caches."""
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
                                     kv_valid=kv_valid)
        return logits[:, -1, :], caches

    def prefill_one(self, ids, valid):
        """Single-request prefill ``[1, C] -> (logits [1, V], caches B=1)``:
        the same function as the batched :meth:`_context_fn`, so a slot's
        prefill equals a solo ``generate``'s."""
        return self._context_fn(ids, valid)

    @torch.no_grad()
    def _decode_fn(self, tok, offset: int, caches, valid):
        """One token step at the scalar cache index ``offset`` (the solo
        path); ``valid [B, T]`` gains the new key.  Returns ``(logits [B,
        V], caches, valid)``."""
        tok = self._tensor(tok, torch.long)
        T = valid.shape[1]
        valid[:, offset] = 1
        before = torch.where(
            torch.arange(T, device=self.device)[None, :] < offset, valid, 0)
        positions = before.sum(dim=1, keepdim=True)
        logits, caches = self.module(tok, positions, caches, offset,
                                     kv_valid=valid)
        return logits[:, -1, :], caches, valid

    @torch.no_grad()
    def decode_slots(self, tok, offsets, caches, valid):
        """One token step with per-slot cache offsets ``[B]`` over
        contiguous caches: every slot writes its new key at its own
        position and takes its RoPE phase from its own validity prefix; an
        offset of ``T`` parks an idle slot."""
        tok = self._tensor(tok, torch.long)
        offsets = self._tensor(offsets)
        T = valid.shape[1]
        ar = torch.arange(T, device=self.device)[None, :]
        valid.masked_fill_(ar == offsets[:, None], 1)
        before = torch.where(ar < offsets[:, None], valid, 0)
        positions = before.sum(dim=1, keepdim=True)
        logits, caches = self.module(tok, positions, caches, offsets,
                                     kv_valid=valid)
        return logits[:, -1, :], caches, valid

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
                       last_only: bool = True):
        """THE paged phase function: token ``s`` of slot ``b`` is written
        at cache index ``offsets[b] + s`` through the block table;
        positions are prefix counts of the validity row.  ``S = 1`` is
        decode; verify (``S = k+1``, ``last_only=False``) and chunked
        prefill (``update_valid=False``) are the same function with more
        query rows.  An offset of ``T`` parks an idle slot."""
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
            block_table=block_table, paged_kernel=paged_kernel)
        if last_only:
            logits = logits[:, -1, :]
        return logits, caches, valid

    def decode_pages(self, tok, offsets, block_table, caches, valid,
                     paged_kernel=None):
        """Paged per-slot decode step (``S = 1``): ``block_table [B, T //
        page]`` int32 maps logical to physical pages, ``caches`` is the
        pool.  ``paged_kernel`` (default: the model's) selects the
        paged-attention kernel over the gather path.  Returns ``(logits
        [B, V], caches, valid)``."""
        pk = self.paged_kernel if paged_kernel is None else bool(paged_kernel)
        return self._paged_step_fn(
            self._tensor(tok, torch.long), self._tensor(offsets),
            self._tensor(block_table), caches, valid, paged_kernel=pk)

    def prefill_chunk_pages(self, ids, offset: int, block_table, caches,
                            valid, paged_kernel=None):
        """Paged chunk prefill: the ``S = Cc``, ``update_valid=False``
        member of :meth:`_paged_step_fn`.  ``ids [1, Cc]`` is the chunk's
        slice of the left-padded prompt, ``offset`` the cache index its
        first token writes at, ``block_table [1, PP]`` the slot's page map
        and ``valid [1, T]`` the slot's validity row with the FULL prompt's
        validity written and zeros beyond it: positions are prefix counts
        of that row, so RoPE phases equal a whole ``prefill_one``'s, and
        keys past the chunk are causally masked.  Returns the chunk's
        last-position logits ``[1, V]`` (the final chunk's are the prefill
        logits) and the pool."""
        pk = self.paged_kernel if paged_kernel is None else bool(paged_kernel)
        logits, caches, _ = self._paged_step_fn(
            self._tensor(ids, torch.long), self._tensor([offset]),
            self._tensor(block_table), caches, self._tensor(valid),
            paged_kernel=pk, update_valid=False, last_only=True)
        return logits, caches

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
                cq[phys_page], sc[phys_page], zp[phys_page] = \
                    quantize_page(chunk)
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


def sampled_tokens(logits, keys: Sequence[Optional[int]],
                   tok_idx: Sequence[int], temps: Sequence[float],
                   top_ks: Sequence[int], top_ps: Sequence[float]
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Row-wise sampler for the serving engine: row ``b`` draws token
    ``tok_idx[b]`` of its request's stream ``keys[b]`` with its own
    sampler settings.  Returns ``(tokens [B], finite [B])`` on the host;
    ``finite[b]`` is False when row ``b``'s logits hold NaN/Inf."""
    finite = torch.isfinite(logits.float()).all(dim=-1)
    toks = torch.argmax(logits, dim=-1)
    for b in range(logits.shape[0]):
        if temps[b] > 0.0:
            toks[b] = sample_row(
                logits[b], temps[b], top_ks[b], top_ps[b],
                token_generator(keys[b], tok_idx[b], logits.device))
    return toks.cpu().numpy(), finite.cpu().numpy()
