"""KV page-chain transfer between page pools (counterpart of
``neuronx_distributed_tpu/kvcache/transfer.py``).

The primitive under prefill/decode disaggregation (DistServe, Splitwise,
Mooncake): serialize a committed prompt page chain out of one replica's
pool and admit it into a sibling's pool as a prefix chain that is
token-identical to what a local prefill would have produced.

- :func:`export_chain` gathers the chain's real pages off the device into
  a host :class:`ChainExport`.  Both pool layouts (the fp ``(k, v)`` pair
  and the int8 six-tuple) work through the pool's one structural
  invariant: every leaf has a leading ``num_pages`` axis, so one
  ``index_select`` per leaf moves a page's KV and its per-page
  quantization parameters alike.  Padding pages (NULL-backed) ship as
  structure only.  The chain's page ids go up in one small asynchronous
  copy from pinned memory; the gathered rows of every leaf and the
  terminal payload are packed into one byte buffer on the device and
  cross to the host in ONE synchronizing copy into pinned memory (a copy
  a leaf into pageable memory, 64 for Llama-3-8B's 32 layers, each
  synchronizing, moved under 1 GB/s on an H100); the leaves and the
  payload are views of that buffer, CPU tensors of the pool's own dtype
  (bf16 has no numpy dtype), so a round trip is bit-exact; ``nbytes``
  counts the same bytes as the JAX export's numpy arrays.
- :func:`import_chain` admits an export into a destination pool: it
  reuses the leading chain the destination's
  :class:`~.prefix.PrefixIndex` already holds, allocates pages for the
  rest, copies the exported rows and payload in (one asynchronous
  host-to-device copy of the packed buffer, and one small one of the
  destination page ids), and registers the full chain with the export's
  terminal payload.  The writes are IN PLACE, one ``index_copy_`` per leaf on the
  current stream: every captured CUDA graph holds the pool by address
  (``trace.engine.PhaseGraphs``), so a pool that was replaced would leave
  the graphs replaying over the old one.  It still returns the caches,
  the JAX signature.

Failure semantics are the allocator's atomic discipline: the
``kvcache/page_import`` fault point sits between allocation and commit,
and ANY failure releases every page and reference taken before it
re-raises, so a killed migration leaks nothing on either side.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple

import torch

from neuronx_distributed_tpu_torch.kvcache.allocator import NULL_PAGE, BlockAllocator
from neuronx_distributed_tpu_torch.kvcache.prefix import (
    PageKey,
    PrefixIndex,
    prefix_fingerprints,
)
from neuronx_distributed_tpu_torch.resilience.faults import fault_point
from neuronx_distributed_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

PAGES_EXPORTED_TOTAL = "kvcache/pages_exported_total"
PAGES_IMPORTED_TOTAL = "kvcache/pages_imported_total"


class TransferError(RuntimeError):
    """The export cannot be admitted into this pool: incompatible layouts
    (page size, layer count, quantization, head geometry, dtype) or a
    corrupt chain.  Raised BEFORE any destination state changes."""


@dataclass
class ChainExport:
    """One committed page chain, serialized to the host.

    ``keys``/``pages`` cover the FULL chain root-down (padding pages ride
    as NULL, as in a block table); ``leaves[l][j][i]`` is layer ``l``,
    pool leaf ``j``, the ``i``-th real page of the chain (CPU tensors in
    the pool's dtype).  ``payload`` is the chain's terminal prefill logits
    (a CPU tensor), what the destination's full-hit admission samples its
    first token from."""

    keys: List[PageKey]
    pages: List[int]                 # SOURCE page ids (diagnostic only)
    layout: str                      # "fp" | "int8"
    page_size: int
    num_layers: int
    leaves: List[Tuple[torch.Tensor, ...]]
    payload: Optional[torch.Tensor] = None
    fingerprint: int = 0
    source: Any = None               # exporting replica id (diagnostic)
    meta: dict = field(default_factory=dict)

    @property
    def n_pages(self) -> int:
        """Real (non-NULL) pages in the chain: what an import must allocate
        on a cold destination."""
        return sum(1 for p in self.pages if p != NULL_PAGE)

    @property
    def nbytes(self) -> int:
        """Serialized payload size (leaves + terminal payload): the
        migration span's byte attribute."""
        n = sum(leaf.numel() * leaf.element_size()
                for layer in self.leaves for leaf in layer)
        if self.payload is not None:
            n += self.payload.numel() * self.payload.element_size()
        return n


# each packed row starts on this byte boundary, so that every view of the
# buffer is aligned for its dtype
_ALIGN = 16


def _pack(rows: Sequence[torch.Tensor]) -> torch.Tensor:
    """One flat uint8 tensor on the rows' device holding ``rows`` one after
    the other, each padded to ``_ALIGN`` bytes (:func:`_unpack`'s
    layout)."""
    parts = []
    for r in rows:
        b = r.contiguous().reshape(-1).view(torch.uint8)
        parts.append(b)
        if b.numel() % _ALIGN:
            parts.append(b.new_zeros(-b.numel() % _ALIGN))
    return torch.cat(parts)


def _unpack(flat: torch.Tensor, like: Sequence[torch.Tensor]) -> list:
    """Views of ``flat`` with the shapes and dtypes of ``like``, as
    :func:`_pack` laid them out."""
    out, off = [], 0
    for r in like:
        n = math.prod(r.shape) * r.dtype.itemsize
        out.append(flat[off:off + n].view(r.dtype).reshape(r.shape))
        off += n + (-n % _ALIGN)
    return out


def _page_ids(ids: Sequence[int], device: torch.device) -> torch.Tensor:
    """``ids`` as a long tensor on ``device``: on a CUDA device one
    asynchronous copy from pinned memory (the caching host allocator keeps
    the block until the copy has run)."""
    t = torch.as_tensor(list(ids), dtype=torch.long)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _layout_of(caches: Sequence[Tuple]) -> str:
    if not caches:
        raise TransferError("empty page pool (no layers)")
    width = len(caches[0])
    if width == 2:
        return "fp"
    if width == 6:
        return "int8"
    raise TransferError(f"unknown pool layout: {width} leaves per layer")


@torch.no_grad()
def export_chain(caches: Sequence[Tuple], keys: Sequence[PageKey],
                 pages: Sequence[int], page_size: int,
                 payload: Any = None, registry: Any = None,
                 source: Any = None) -> ChainExport:
    """Serialize the chain ``(keys, pages)`` out of a live page pool.

    The caller holds the pages live for the call (a slot's references or
    the index's own).  The device-to-host copies wait for the pages'
    writes in stream order; a caller under a sync guard lifts it around
    this call (``obs.transfer_audit.allow_sync``)."""
    if len(keys) != len(pages):
        raise TransferError(f"{len(keys)} keys vs {len(pages)} pages")
    layout = _layout_of(caches)
    device = caches[0][0].device
    real = _page_ids([p for p in pages if p != NULL_PAGE], device)
    rows = [leaf.index_select(0, real) for layer in caches for leaf in layer]
    if payload is not None:
        # the payload rides in the same buffer: one copy for the chain
        rows.append(torch.as_tensor(payload).detach().to(device))
    flat = _pack(rows)
    if flat.is_cuda:
        # the one device-to-host copy, into pinned memory (the caching host
        # allocator hands the block back to the next export)
        host = torch.empty(flat.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(flat, non_blocking=True)
        torch.cuda.current_stream(flat.device).synchronize()
        flat = host
    views = _unpack(flat, rows)
    host_payload = views.pop() if payload is not None else None
    width = len(caches[0])
    leaves: List[Tuple[torch.Tensor, ...]] = [
        tuple(views[i:i + width]) for i in range(0, len(views), width)]
    fps = prefix_fingerprints(list(keys))
    export = ChainExport(
        keys=list(keys), pages=[int(p) for p in pages], layout=layout,
        page_size=page_size, num_layers=len(caches), leaves=leaves,
        payload=host_payload,
        fingerprint=fps[-1] if fps else 0, source=source,
        meta={"packed": flat})
    if registry is not None:
        registry.counter(PAGES_EXPORTED_TOTAL).inc(export.n_pages)
    return export


def _check_compat(caches: Sequence[Tuple], export: ChainExport) -> None:
    """Role-compatible pools may differ in capacity (page count) but never
    in page geometry: a row copied into the wrong shape would be silent
    corruption, so every mismatch is a :class:`TransferError` before any
    destination state changes."""
    if _layout_of(caches) != export.layout:
        raise TransferError(
            f"layout mismatch: pool is {_layout_of(caches)!r}, "
            f"export is {export.layout!r}")
    if len(caches) != export.num_layers:
        raise TransferError(
            f"layer mismatch: pool has {len(caches)}, "
            f"export has {export.num_layers}")
    for l, (layer, rows) in enumerate(zip(caches, export.leaves)):
        for leaf, row in zip(layer, rows):
            if tuple(leaf.shape[1:]) != tuple(row.shape[1:]):
                raise TransferError(
                    f"page geometry mismatch at layer {l}: pool leaf "
                    f"{tuple(leaf.shape[1:])} vs export row "
                    f"{tuple(row.shape[1:])}")
            if leaf.dtype != row.dtype:
                raise TransferError(
                    f"dtype mismatch at layer {l}: pool {leaf.dtype} vs "
                    f"export {row.dtype}")


@torch.no_grad()
def import_chain(caches, index: PrefixIndex, export: ChainExport,
                 registry: Any = None):
    """Admit ``export`` into a destination pool as a registered prefix
    chain, writing the pool IN PLACE; returns ``caches`` (the same
    tensors).

    Transactional: reuses the destination's cached leading chain,
    allocates the missing tail (LRU-evicting index-only chains when the
    free list is short), copies the exported rows, registers the full
    chain in ``index`` with the payload on the pool's device, and on ANY
    failure, the ``kvcache/page_import`` chaos point between allocation and
    commit included, releases every page and reference taken before it
    re-raises.  On success the index owns exactly one reference per real
    page, the state a local prefill's ``finish_insert`` leaves."""
    _check_compat(caches, export)
    alloc: BlockAllocator = index.alloc
    device = caches[0][0].device
    matched, _ = index.lookup(export.keys)   # refs we now hold
    taken = [p for p in matched if p != NULL_PAGE]
    fresh: List[int] = []
    try:
        # the tail the destination is missing; padding keys ride NULL
        tail = list(range(len(matched), len(export.keys)))
        need = [i for i in tail if export.pages[i] != NULL_PAGE]
        short = len(need) - alloc.free_count
        if short > 0:
            index.evict(short)
        fresh = alloc.alloc(len(need))
        taken += fresh
        # chaos hook: a kill between allocation and commit must leak
        # nothing on either side
        fault_point("kvcache/page_import", pages=len(need),
                    fingerprint=export.fingerprint)
        leaves = [leaf for layer in caches for leaf in layer]
        rows = []
        if need:
            # chain position -> row index in the export's stacked leaves
            row_of = {i: j for j, i in enumerate(
                i for i, p in enumerate(export.pages) if p != NULL_PAGE)}
            sel = [row_of[i] for i in need]
            rows = [row for layer in export.leaves for row in layer]
            if sel != list(range(export.n_pages)):
                # a partial import: the destination holds a prefix
                idx = torch.as_tensor(sel, dtype=torch.long)
                rows = [row.index_select(0, idx) for row in rows]
        whole = len(need) == export.n_pages
        payload = export.payload
        if payload is not None:
            rows.append(payload)
        if rows:
            packed = export.meta.get("packed")
            if packed is None or not whole:
                # a partial import, or an export not packed by export_chain
                packed = _pack(rows)
            # the one host-to-device copy (asynchronous from an export's
            # pinned buffer), then a write per leaf
            views = _unpack(packed.to(device, non_blocking=True), rows)
            if payload is not None:
                # its own storage: a view would hold the whole upload
                payload = views.pop().clone()
            if need:
                dst = _page_ids(fresh, device)
                for leaf, row in zip(leaves, views):
                    leaf.index_copy_(0, dst, row)
        full = list(matched)
        it = iter(fresh)
        for i in tail:
            full.append(NULL_PAGE if export.pages[i] == NULL_PAGE
                        else next(it))
        index.insert(export.keys, full, payload=payload)
    except BaseException:
        for p in taken:
            alloc.free(p)
        raise
    # the index retained its own references; drop ours (lookup refs on the
    # matched prefix, allocation refs on the fresh tail)
    alloc.free_tail(taken)
    if registry is not None:
        registry.counter(PAGES_IMPORTED_TOTAL).inc(len(fresh))
    return caches
