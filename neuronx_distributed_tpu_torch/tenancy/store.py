"""Paged LoRA adapter store (counterpart of
``neuronx_distributed_tpu/tenancy/store.py``): many adapters behind one
set of phase functions, S-LoRA style (Sheng et al. 2023), paging adapter
weights through the same allocator as the KV cache.

- :class:`AdapterLayout` -- the static flattening contract.  An adapter's
  per-layer low-rank factors (``a_q [H, r]``, ``b_q [r, NQ*D]``, ``a_v``,
  ``b_v``) are flattened into fixed-size pages of one flat fp32 device
  pool ``[num_pages, page_elems]``; the layout's offsets are what the
  phase functions slice the gathered pages back into factors with (shapes,
  not data, so one captured graph serves every adapter).
- :class:`AdapterStore` -- host-side residency over a refcounted
  :class:`~..kvcache.allocator.BlockAllocator`: ``register`` keeps a host
  copy of the flattened pages, ``acquire`` pins a request's adapter at
  admission (allocating its pages on a cold start, LRU-evicting unpinned
  adapters to make room; the caller writes the returned pages to the
  device), ``release`` drops the pin on every terminal state.  A resident
  adapter's acquire is a refcount bump (a hit); a cold one costs a load.
  Page 0 is the allocator's NULL page and holds zeros, which for a
  low-rank delta IS the identity: adapter 0 ("no adapter") needs no
  pages.

``acquire`` is transactional: a failure after the pages are taken (the
``tenancy/adapter_load`` fault point sits there) frees every one of them
before re-raising.  With a metrics registry attached the store counts
hits, loads and evictions into the JAX package's ``tenancy/*`` metrics and
exports its residency gauges; the plain counters stay beside them.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from neuronx_distributed_tpu_torch.kvcache.allocator import (
    NULL_PAGE,
    BlockAllocator,
    PoolExhausted,
)
from neuronx_distributed_tpu_torch.peft import lora_params, map_with_path
from neuronx_distributed_tpu_torch.resilience.faults import fault_point
from neuronx_distributed_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

# registry contract (obs.schemas.REGISTRY_METRICS)
ADAPTERS_RESIDENT = "tenancy/adapters_resident"
ADAPTER_POOL_PAGES_IN_USE = "tenancy/adapter_pool_pages_in_use"
ADAPTER_HITS_TOTAL = "tenancy/adapter_hits_total"
ADAPTER_LOADS_TOTAL = "tenancy/adapter_loads_total"
ADAPTER_EVICTIONS_TOTAL = "tenancy/adapter_evictions_total"

# factor names in canonical order: the layout's flattening order and the
# tuple order of the model's ``adapter`` argument
FACTOR_NAMES = ("a_q", "b_q", "a_v", "b_v")

_LAYER_RE = re.compile(r"(?:^|_)layer_?(\d+)$")


@dataclasses.dataclass(frozen=True)
class AdapterLayout:
    """Static flattening contract between the store and the phase
    functions.

    ``rank`` is the POOL rank: every registered adapter's factors are
    zero-padded up to it (padding columns of A / rows of B contribute
    exact zeros), so adapters of any rank ``<= rank`` share one layout.
    ``page_elems`` is the flat page width in fp32 elements, the paging
    granularity the :class:`BlockAllocator` refcounts."""

    num_layers: int
    hidden_size: int
    q_out: int   # num_heads * head_dim
    v_out: int   # num_kv_heads * head_dim
    rank: int
    page_elems: int = 2048

    def __post_init__(self):
        if self.rank < 1:
            raise ValueError(f"pool rank must be >= 1, got {self.rank}")
        if self.page_elems < 1:
            raise ValueError(
                f"page_elems must be >= 1, got {self.page_elems}")

    @staticmethod
    def for_model(model: Any, rank: int,
                  page_elems: int = 2048) -> "AdapterLayout":
        """Layout for a serving wrapper's module config (the
        ``ParallelInferenceModel`` the engine serves)."""
        cfg = model.module.config
        return AdapterLayout(
            num_layers=cfg.num_layers, hidden_size=cfg.hidden_size,
            q_out=cfg.num_heads * cfg.head_dim_,
            v_out=cfg.num_kv_heads * cfg.head_dim_,
            rank=rank, page_elems=page_elems)

    def factor_shapes(self) -> List[Tuple[str, Tuple[int, int]]]:
        """One layer's ``(name, shape)`` list in canonical order."""
        r, h = self.rank, self.hidden_size
        return [("a_q", (h, r)), ("b_q", (r, self.q_out)),
                ("a_v", (h, r)), ("b_v", (r, self.v_out))]

    @property
    def layer_elems(self) -> int:
        return sum(s[0] * s[1] for _, s in self.factor_shapes())

    @property
    def total_elems(self) -> int:
        return self.num_layers * self.layer_elems

    @property
    def pages_per_adapter(self) -> int:
        return math.ceil(self.total_elems / self.page_elems)

    def layer_entries(self) -> List[List[Tuple[str, int, Tuple[int, int]]]]:
        """Per layer, the ``(name, flat_offset, shape)`` slices the phase
        functions carve the gathered ``[B, AP * page_elems]`` view with."""
        out = []
        off = 0
        for _ in range(self.num_layers):
            entries = []
            for name, shape in self.factor_shapes():
                entries.append((name, off, shape))
                off += shape[0] * shape[1]
            out.append(entries)
        return out

    def flatten(self, factors: Sequence[Dict[str, np.ndarray]],
                alpha: float) -> np.ndarray:
        """Flatten per-layer factor dicts into the padded page blocks
        ``[pages_per_adapter, page_elems]`` fp32.

        Each layer dict holds ``a_q``/``b_q``/``a_v``/``b_v`` (b factors as
        ``[r, n_heads, head_dim]`` or ``[r, out]``); ranks ``<= rank`` are
        zero-padded, and the LoRA scale ``alpha / r`` is folded into the b
        factors here, so the device math is a bare einsum pair (``alpha``
        must equal the adapters' ``lora_alpha``, as for
        ``peft.merge_lora``)."""
        if len(factors) != self.num_layers:
            raise ValueError(
                f"adapter has {len(factors)} layers, layout expects "
                f"{self.num_layers}")
        flat = np.zeros((self.pages_per_adapter * self.page_elems,),
                        np.float32)
        for layer, entries in zip(factors, self.layer_entries()):
            missing = [n for n, _, _ in entries if n not in layer]
            if missing:
                raise ValueError(
                    f"adapter layer missing factors {missing} "
                    f"(present: {sorted(layer)})")
            r_a = None
            for name, off, shape in entries:
                arr = np.asarray(layer[name], np.float32)
                if arr.ndim == 3:  # [r, n_heads, head_dim] module layout
                    arr = arr.reshape(arr.shape[0], -1)
                if arr.ndim != 2:
                    raise ValueError(
                        f"factor {name} must be 2-D (or the module's 3-D "
                        f"[r, heads, dim]), got shape {arr.shape}")
                ra = arr.shape[1] if name.startswith("a_") else arr.shape[0]
                if r_a is None:
                    r_a = ra
                elif ra != r_a:
                    raise ValueError(
                        f"factor {name} rank {ra} != layer rank {r_a}")
                if ra > self.rank:
                    raise ValueError(
                        f"adapter rank {ra} exceeds pool rank {self.rank}")
                want = ((shape[0], ra) if name.startswith("a_")
                        else (ra, shape[1]))
                if arr.shape != want:
                    raise ValueError(
                        f"factor {name} shape {arr.shape} != expected "
                        f"{want} (layout {shape}, adapter rank {ra})")
                padded = np.zeros(shape, np.float32)
                if name.startswith("a_"):
                    padded[:, :ra] = arr
                else:
                    padded[:ra, :] = (alpha / ra) * arr
                flat[off:off + shape[0] * shape[1]] = padded.reshape(-1)
        return flat.reshape(self.pages_per_adapter, self.page_elems)


def factors_from_params(params: Any) -> List[Dict[str, np.ndarray]]:
    """The q/v LoRA factors per layer of a LoRA params tree (the tree
    ``peft.lora_params`` prunes): leaves under a ``lora_a_q`` /
    ``lora_b_q`` / ``lora_a_v`` / ``lora_b_v`` key and a ``layer_<i>``
    path component, however deeply nested or wrapped.  Returns the
    per-layer dict list :meth:`AdapterLayout.flatten` takes."""
    found: Dict[int, Dict[str, np.ndarray]] = {}

    def visit(path, leaf):
        if leaf is None:
            return
        keys = [str(k) for k in path]
        name = None
        for k in keys:
            if k.startswith("lora_") and k[len("lora_"):] in FACTOR_NAMES:
                name = k[len("lora_"):]
        if name is None:
            return
        layer = None
        for k in keys:
            m = _LAYER_RE.search(k)
            if m:
                layer = int(m.group(1))
        if layer is None:
            raise ValueError(
                f"LoRA leaf {'/'.join(keys)} has no layer_<i> path "
                "component; per-layer named trees are required (unstack "
                "scan_layers checkpoints first)")
        found.setdefault(layer, {})[name] = np.asarray(leaf)

    map_with_path(visit, lora_params(params))
    if not found:
        raise ValueError(
            "no lora_{a,b}_{q,v} leaves found: the adapter tree carries no "
            "q/v LoRA factors (was the model built with lora_targets "
            "including 'qkv'?)")
    layers = sorted(found)
    if layers != list(range(len(layers))):
        raise ValueError(f"non-contiguous adapter layers: {layers}")
    return [found[i] for i in layers]


class AdapterStore:
    """Refcounted paged residency for registered LoRA adapters.

    Adapter id 0 is RESERVED: it means "no adapter", is served by the
    pool's zero NULL page, and can never be registered.  ``registry`` (an
    ``obs.MetricRegistry``) may be given here or attached later with
    :meth:`attach_registry` (the serving engine attaches its own).  Plain
    counters and the metrics they feed: ``hits``
    (``tenancy/adapter_hits_total``), ``loads``
    (``tenancy/adapter_loads_total``), ``evictions``
    (``tenancy/adapter_evictions_total``); :meth:`export_gauges` sets
    ``tenancy/adapters_resident`` and :attr:`pages_in_use`
    (``tenancy/adapter_pool_pages_in_use``)."""

    def __init__(self, layout: AdapterLayout, num_pages: int,
                 registry: Any = None):
        if layout.pages_per_adapter > num_pages - 1:
            raise ValueError(
                f"one adapter needs {layout.pages_per_adapter} pages but "
                f"the pool holds only {num_pages - 1} allocatable pages "
                "(page 0 is the NULL page); grow num_pages or page_elems")
        self.layout = layout
        self.num_pages = num_pages
        self.alloc = BlockAllocator(num_pages)
        self._blocks: Dict[int, np.ndarray] = {}   # host copy, survives evict
        self._resident: Dict[int, List[int]] = {}  # aid -> physical pages
        self._last_used: Dict[int, int] = {}
        self._clock = 0
        self.hits = 0
        self.loads = 0
        self.evictions = 0
        self.registry = None
        if registry is not None:
            self.attach_registry(registry)

    # -- wiring ------------------------------------------------------------

    def attach_registry(self, registry: Any) -> None:
        self.registry = registry
        registry.gauge(ADAPTERS_RESIDENT)
        registry.gauge(ADAPTER_POOL_PAGES_IN_USE)
        for c in (ADAPTER_HITS_TOTAL, ADAPTER_LOADS_TOTAL,
                  ADAPTER_EVICTIONS_TOTAL):
            registry.counter(c)

    def export_gauges(self) -> None:
        """Refresh the residency gauges (the engine calls it once a
        step)."""
        if self.registry is None:
            return
        self.registry.gauge(ADAPTERS_RESIDENT).set(len(self._resident))
        self.registry.gauge(ADAPTER_POOL_PAGES_IN_USE).set(self.alloc.in_use)

    # -- registration ------------------------------------------------------

    def register(self, adapter_id: int, adapter: Any,
                 alpha: float = 16.0) -> None:
        """Register an adapter under ``adapter_id`` (> 0).  ``adapter`` is
        a LoRA params tree (``lora_{a,b}_{q,v}`` leaves under
        ``layer_<i>``) or a per-layer list of ``{"a_q", "b_q", "a_v",
        "b_v"}`` factor dicts; ``alpha`` must equal the adapters'
        ``lora_alpha``.  Host-only: device pages are paid at the first
        :meth:`acquire`."""
        adapter_id = int(adapter_id)
        if adapter_id < 1:
            raise ValueError(
                f"adapter_id must be >= 1 (0 is the reserved no-adapter "
                f"identity), got {adapter_id}")
        if adapter_id in self._blocks:
            raise ValueError(f"adapter {adapter_id} already registered")
        factors = (list(adapter) if isinstance(adapter, (list, tuple))
                   else factors_from_params(adapter))
        self._blocks[adapter_id] = self.layout.flatten(factors, alpha)

    def registered(self, adapter_id: int) -> bool:
        return adapter_id == 0 or adapter_id in self._blocks

    def resident_ids(self) -> frozenset:
        """Adapters whose pages are on the device right now."""
        return frozenset(self._resident)

    # -- residency (pin at admission / release on terminal) -----------------

    def acquire(self, adapter_id: int,
                engine_step: int = 0) -> List[Tuple[int, np.ndarray]]:
        """Pin ``adapter_id`` for one request.  Returns the device loads
        the caller must perform, ``[(phys_page, host_block), ...]``, on a
        cold start, or ``[]`` when the adapter is already resident (or is
        adapter 0).  Transactional: a failure after the allocation frees
        every page taken before re-raising.  ``engine_step`` is the fault
        point's context."""
        if adapter_id == 0:
            return []
        blocks = self._blocks.get(adapter_id)
        if blocks is None:
            raise KeyError(f"adapter {adapter_id} is not registered")
        self._clock += 1
        self._last_used[adapter_id] = self._clock
        pages = self._resident.get(adapter_id)
        if pages is not None:
            for p in pages:
                self.alloc.retain(p)
            self.hits += 1
            if self.registry is not None:
                self.registry.counter(ADAPTER_HITS_TOTAL).inc()
            return []
        need = self.layout.pages_per_adapter
        self._ensure_free(need)
        pages = self.alloc.alloc(need)  # atomic: PoolExhausted takes nothing
        try:
            # a crash between the allocation and the pin leaks nothing
            fault_point("tenancy/adapter_load", adapter_id=adapter_id,
                        engine_step=engine_step)
            for p in pages:
                self.alloc.retain(p)  # the request's pin atop the store ref
        except BaseException:
            for p in pages:
                while self.alloc.refcount(p):
                    self.alloc.free(p)
            raise
        self._resident[adapter_id] = pages
        self.loads += 1
        if self.registry is not None:
            self.registry.counter(ADAPTER_LOADS_TOTAL).inc()
        return [(phys, blocks[i]) for i, phys in enumerate(pages)]

    def release(self, adapter_id: int) -> None:
        """Drop one request's pin.  The adapter stays resident (the store's
        own reference) until LRU eviction needs its pages."""
        if adapter_id == 0:
            return
        pages = self._resident.get(adapter_id)
        if pages is None:
            raise ValueError(
                f"release of non-resident adapter {adapter_id}")
        for p in pages:
            self.alloc.free(p)

    def table(self, adapter_id: int) -> np.ndarray:
        """The adapter's ``[pages_per_adapter]`` int32 physical page map
        (all NULL for adapter 0): a slot's row of the adapter tables."""
        if adapter_id == 0:
            return np.full((self.layout.pages_per_adapter,), NULL_PAGE,
                           np.int32)
        return np.asarray(self._resident[adapter_id], np.int32)

    def pins(self, adapter_id: int) -> int:
        """Active request pins on a resident adapter (0 when merely
        resident: the store's own reference does not count)."""
        pages = self._resident.get(adapter_id)
        if not pages:
            return 0
        return self.alloc.refcount(pages[0]) - 1

    # -- capacity ----------------------------------------------------------

    @property
    def capacity(self) -> int:
        return self.alloc.capacity

    @property
    def pages_in_use(self) -> int:
        return self.alloc.in_use

    def evictable_pages(self) -> int:
        return sum(len(pages) for aid, pages in self._resident.items()
                   if self.pins(aid) == 0)

    def pages_free(self) -> int:
        return self.alloc.free_count + self.evictable_pages()

    def _ensure_free(self, n: int) -> None:
        """LRU-evict unpinned resident adapters until ``n`` pages are free
        (host accounting only: the next load overwrites the evicted pages'
        device content)."""
        while self.alloc.free_count < n:
            cold = [aid for aid in self._resident if self.pins(aid) == 0]
            if not cold:
                raise PoolExhausted(
                    f"adapter pool exhausted: need {n} pages, "
                    f"{self.alloc.free_count} free and every resident "
                    "adapter is pinned; retry after requests drain or grow "
                    "the pool")
            victim = min(cold, key=lambda aid: self._last_used.get(aid, 0))
            for p in self._resident.pop(victim):
                self.alloc.free(p)
            self.evictions += 1
            if self.registry is not None:
                self.registry.counter(ADAPTER_EVICTIONS_TOTAL).inc()
            logger.info("tenancy: evicted cold adapter %d (%d pages)",
                        victim, self.layout.pages_per_adapter)

    # -- invariants --------------------------------------------------------

    def assert_invariants(self) -> None:
        """Allocator invariants plus the residency contract: resident
        adapters own disjoint allocated pages (refcount = 1 store ref +
        pins), every resident id is registered, and nothing else holds
        pool pages."""
        self.alloc.assert_invariants()
        seen: set = set()
        for aid, pages in self._resident.items():
            assert aid in self._blocks, f"resident unregistered adapter {aid}"
            assert len(pages) == self.layout.pages_per_adapter
            refs = {self.alloc.refcount(p) for p in pages}
            assert len(refs) == 1, (
                f"adapter {aid} pages carry uneven refcounts {refs}")
            assert not (seen & set(pages)), (
                f"adapter {aid} shares pages with another adapter")
            seen.update(pages)
        assert len(seen) == self.alloc.in_use, (
            f"pool pages leaked outside residency: {self.alloc.in_use} in "
            f"use, {len(seen)} owned by resident adapters")


def make_adapter_store(model: Any, rank: int, num_pages: int,
                       page_elems: int = 2048,
                       registry: Any = None) -> AdapterStore:
    """An :class:`AdapterStore` laid out for a serving wrapper's module
    (what ``ServingEngine(adapter_store=)`` takes)."""
    return AdapterStore(AdapterLayout.for_model(model, rank, page_elems),
                        num_pages, registry=registry)
