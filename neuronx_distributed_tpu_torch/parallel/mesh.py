"""Parallel state: the six-axis rank layout and its process groups
(counterpart of ``neuronx_distributed_tpu/parallel/mesh.py``).

The JAX package builds one named ``Mesh`` whose axes are its replica
groups and lets XLA derive each collective's devices from axis names.
The port runs one process per rank, so the same layout becomes process
groups: the ranks ``0 .. world - 1`` are laid out as
``np.arange(world).reshape(dp, ep, pp, cp, kvr, tp // kvr)`` (the JAX
package's non-TPU device array, ``tp`` innermost so tensor-parallel
groups are contiguous ranks), and every line of every axis, and of the
combined tensor axes ``TENSOR_AXES = (kvr, tp)``, gets its own
``torch.distributed`` group.  :func:`rank_layout` and :func:`axis_lines`
are pure functions of the sizes, so the layout can be held against the
JAX mesh's device ids without starting a process.

The tensor-parallel group also has a gloo twin (the same group under a
gloo default): the serving engine agrees on host decisions over it, which
works on CPU tensors whatever the device backend.  The context-parallel
group has one too, over which ring attention stages the blocks it passes
when the device backend cannot send them (:class:`ContextParallel`, with
the ring's next and previous ranks), and so has the pipeline-parallel
group, over which a stage stages the activations and gradients it sends
its neighbours (:class:`PipelineParallel`).

``named_sharding``, ``mesh_context``, ``strip_axes_from_spec`` and
``ambient_manual_axes`` are GSPMD machinery (placing arrays on a mesh,
partial-manual ``shard_map`` bodies) with no counterpart here: a rank
holds its own shard and runs explicit collectives
(:mod:`.mappings`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch.distributed as dist

from neuronx_distributed_tpu_torch.config import MeshConfig
from neuronx_distributed_tpu_torch.utils import distributed
from neuronx_distributed_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

# canonical axis names, outermost first (the JAX package's)
DATA_AXIS = "dp"
EXPERT_AXIS = "ep"
PIPELINE_AXIS = "pp"
CONTEXT_AXIS = "cp"
KV_REPLICA_AXIS = "kvr"
TENSOR_AXIS = "tp"

MESH_AXES = (DATA_AXIS, EXPERT_AXIS, PIPELINE_AXIS, CONTEXT_AXIS,
             KV_REPLICA_AXIS, TENSOR_AXIS)
TENSOR_AXES = (KV_REPLICA_AXIS, TENSOR_AXIS)  # full TP degree = kvr * tp
BATCH_AXES = (DATA_AXIS, EXPERT_AXIS)          # full DP degree = dp * ep

Axes = Union[str, Tuple[str, ...]]


def _as_tuple(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def resolve_config(world_size: int, tensor_parallel_size: int = 1,
                   pipeline_parallel_size: int = 1,
                   context_parallel_size: int = 1,
                   expert_parallel_size: int = 1, kv_size_multiplier: int = 1,
                   data_parallel_size: Optional[int] = None) -> MeshConfig:
    """The sizes, checked against ``world_size`` as the JAX
    ``initialize_model_parallel`` checks them against the device count;
    ``data_parallel_size`` comes back as the full degree ``dp * ep``."""
    cfg = MeshConfig(
        tensor_parallel_size=tensor_parallel_size,
        pipeline_parallel_size=pipeline_parallel_size,
        context_parallel_size=context_parallel_size,
        expert_parallel_size=expert_parallel_size,
        kv_size_multiplier=kv_size_multiplier,
        data_parallel_size=data_parallel_size)
    mp = (tensor_parallel_size * pipeline_parallel_size
          * context_parallel_size * expert_parallel_size)
    if world_size % mp != 0:
        raise ValueError(f"device count {world_size} not divisible by model "
                         f"parallel size {mp}")
    dp = world_size // mp
    if (data_parallel_size is not None
            and data_parallel_size != dp * expert_parallel_size):
        raise ValueError(
            f"explicit data_parallel_size {data_parallel_size} inconsistent "
            f"with device count {world_size}: expected "
            f"{dp * expert_parallel_size} (= {world_size} / (tp*pp*cp) with "
            f"ep={expert_parallel_size})")
    return dataclasses.replace(cfg, data_parallel_size=dp * expert_parallel_size)


def mesh_shape(cfg: MeshConfig) -> Tuple[int, ...]:
    """The layout's shape over :data:`MESH_AXES`."""
    ep = cfg.expert_parallel_size
    return (cfg.data_parallel_size // ep, ep, cfg.pipeline_parallel_size,
            cfg.context_parallel_size, cfg.kv_size_multiplier,
            cfg.tensor_parallel_size // cfg.kv_size_multiplier)


def rank_layout(world_size: int, **sizes) -> np.ndarray:
    """Ranks ``0 .. world_size - 1`` in the six-axis layout (``sizes``:
    :func:`resolve_config`'s keywords)."""
    cfg = resolve_config(world_size, **sizes)
    return np.arange(world_size).reshape(mesh_shape(cfg))


def axis_lines(layout: np.ndarray, axes: Axes) -> List[List[int]]:
    """The rank groups along ``axes`` (one axis name or a tuple, major to
    minor): every line of the layout that varies only those axes, ranks in
    axis order, lines in the order of the other axes."""
    axes = _as_tuple(axes)
    idx = [MESH_AXES.index(a) for a in axes]
    rest = [i for i in range(layout.ndim) if i not in idx]
    moved = np.transpose(layout, rest + idx)
    n = math.prod(layout.shape[i] for i in idx)
    return [list(map(int, line)) for line in moved.reshape(-1, n)]


# the groups initialize_model_parallel builds: each axis, and the
# combined tensor and batch axes
GROUP_AXES: Tuple[Axes, ...] = MESH_AXES + (TENSOR_AXES, BATCH_AXES)


class _State:
    """The live layout and this rank's groups (module globals, like the
    JAX package's mesh singleton)."""

    def __init__(self):
        self.clear()

    def clear(self):
        self.config: Optional[MeshConfig] = None
        self.layout: Optional[np.ndarray] = None
        self.rank = 0
        self.coords: Dict[str, int] = {}
        self.groups: Dict[Tuple[str, ...], object] = {}
        self.ranks: Dict[Tuple[str, ...], List[int]] = {}
        self.tp_cpu_group = None
        self.cp_cpu_group = None
        self.pp_cpu_group = None
        self.owned: list = []


_STATE = _State()


def initialize_model_parallel(tensor_parallel_size: int = 1,
                              pipeline_parallel_size: int = 1,
                              context_parallel_size: int = 1,
                              expert_parallel_size: int = 1,
                              kv_size_multiplier: int = 1,
                              data_parallel_size: Optional[int] = None
                              ) -> MeshConfig:
    """Lay out the world (:func:`.distributed.initialize_distributed`
    first; without a world it is one rank) and build one process group per
    line of every axis of :data:`GROUP_AXES`.  Every rank makes the same
    calls in the same order, as ``torch.distributed.new_group`` requires.
    Raises ``RuntimeError`` when already initialized; a failed call leaves
    no state behind."""
    if _STATE.config is not None:
        raise RuntimeError("model parallel is already initialized; call "
                           "destroy_model_parallel() first")
    world = distributed.get_world_size()
    rank = distributed.get_rank()
    cfg = resolve_config(world, tensor_parallel_size, pipeline_parallel_size,
                         context_parallel_size, expert_parallel_size,
                         kv_size_multiplier, data_parallel_size)
    layout = np.arange(world).reshape(mesh_shape(cfg))
    state = _State()
    state.config, state.layout, state.rank = cfg, layout, rank
    where = np.argwhere(layout == rank)[0]
    state.coords = {a: int(i) for a, i in zip(MESH_AXES, where)}
    in_world = dist.is_initialized()
    gloo = in_world and dist.get_backend() == "gloo"
    timeout = distributed.group_timeout()
    for axes in GROUP_AXES:
        key = _as_tuple(axes)
        for line in axis_lines(layout, key):
            group = None
            if in_world:
                group = dist.new_group(line, timeout=timeout)
                state.owned.append(group)
            if rank in line:
                state.groups[key] = group
                state.ranks[key] = line
    state.tp_cpu_group = state.groups.get(TENSOR_AXES)
    state.cp_cpu_group = state.groups.get((CONTEXT_AXIS,))
    state.pp_cpu_group = state.groups.get((PIPELINE_AXIS,))
    if in_world and not gloo:
        for axes, attr in ((TENSOR_AXES, "tp_cpu_group"),
                           ((CONTEXT_AXIS,), "cp_cpu_group"),
                           ((PIPELINE_AXIS,), "pp_cpu_group")):
            for line in axis_lines(layout, axes):
                group = dist.new_group(line, backend="gloo", timeout=timeout)
                state.owned.append(group)
                if rank in line:
                    setattr(state, attr, group)
    _STATE.__dict__.update(state.__dict__)
    logger.info("initialized the layout: dp=%d ep=%d pp=%d cp=%d kvr=%d "
                "tp=%d over %d ranks", *mesh_shape(cfg), world)
    return cfg


def destroy_model_parallel() -> None:
    """Tear the groups down and forget the layout."""
    if dist.is_initialized():
        for group in _STATE.owned:
            if group is not None and group is not dist.GroupMember.NON_GROUP_MEMBER:
                dist.destroy_process_group(group)
    _STATE.clear()


def model_parallel_is_initialized() -> bool:
    return _STATE.config is not None


def get_mesh_config() -> MeshConfig:
    if _STATE.config is None:
        raise RuntimeError("model parallel is not initialized; call "
                           "initialize_model_parallel() first")
    return _STATE.config


def _size(axes: Axes) -> int:
    if _STATE.config is None:
        return 1
    return math.prod(_STATE.layout.shape[MESH_AXES.index(a)]
                     for a in _as_tuple(axes))


def _rank(axes: Axes) -> int:
    """This rank's index along ``axes`` (major to minor)."""
    r = 0
    for a in _as_tuple(axes):
        r = r * _size(a) + _STATE.coords.get(a, 0)
    return r


def get_group(axes: Axes):
    """This rank's process group along ``axes`` (an axis of
    :data:`GROUP_AXES`); None outside a world."""
    get_mesh_config()
    return _STATE.groups.get(_as_tuple(axes))


def get_group_ranks(axes: Axes) -> List[int]:
    """The global ranks of this rank's group along ``axes``."""
    get_mesh_config()
    return list(_STATE.ranks[_as_tuple(axes)])


def get_tensor_parallel_size() -> int:
    """Full TP degree, ``kvr * tp`` (1 before initialization)."""
    return _size(TENSOR_AXES)


def get_tensor_parallel_rank() -> int:
    """``kvr_index * (tp / kvr) + tp_index``, as the JAX
    ``tensor_parallel_rank``."""
    return _rank(TENSOR_AXES)


def get_tensor_parallel_group():
    return get_group(TENSOR_AXES) if model_parallel_is_initialized() else None


def get_tensor_parallel_cpu_group():
    """The gloo group over this rank's tensor-parallel ranks (host-side
    agreement); None outside a world."""
    return _STATE.tp_cpu_group


def get_kv_size_multiplier() -> int:
    return _size(KV_REPLICA_AXIS)


def get_pipeline_parallel_size() -> int:
    return _size(PIPELINE_AXIS)


def get_pipeline_parallel_rank() -> int:
    return _rank(PIPELINE_AXIS)


def get_pipeline_parallel_group():
    return get_group(PIPELINE_AXIS)


def get_pipeline_parallel_cpu_group():
    """The gloo group over this rank's pipeline-parallel ranks; None
    outside a world."""
    return _STATE.pp_cpu_group


def get_pipeline_parallel_neighbors() -> Tuple[int, int]:
    """``(next, previous)``: the global ranks of the stages after and
    before this one (a ring: the last stage's next is stage 0, as the
    interleaved schedule's chunk wrap needs; itself at pp = 1)."""
    if _STATE.config is None:
        return 0, 0
    line = _STATE.ranks[(PIPELINE_AXIS,)]
    i = line.index(_STATE.rank)
    return line[(i + 1) % len(line)], line[(i - 1) % len(line)]


def get_data_parallel_size() -> int:
    """Full data-parallel degree, ``dp * ep``."""
    return _size(BATCH_AXES)


def get_data_parallel_rank() -> int:
    return _rank(BATCH_AXES)


def get_data_parallel_group():
    return get_group(BATCH_AXES)


def get_context_parallel_size() -> int:
    return _size(CONTEXT_AXIS)


def get_context_parallel_rank() -> int:
    return _rank(CONTEXT_AXIS)


def get_context_parallel_group():
    return get_group(CONTEXT_AXIS)


def get_context_parallel_cpu_group():
    """The gloo group over this rank's context-parallel ranks; None
    outside a world."""
    return _STATE.cp_cpu_group


def get_context_parallel_neighbors() -> Tuple[int, int]:
    """``(next, previous)``: the global ranks after and before this one on
    the context-parallel ring (itself at cp = 1)."""
    if _STATE.config is None:
        return 0, 0
    line = _STATE.ranks[(CONTEXT_AXIS,)]
    i = line.index(_STATE.rank)
    return line[(i + 1) % len(line)], line[(i - 1) % len(line)]


def get_expert_parallel_size() -> int:
    return _size(EXPERT_AXIS)


def get_expert_parallel_rank() -> int:
    return _rank(EXPERT_AXIS)


def get_expert_parallel_group():
    return get_group(EXPERT_AXIS)


def get_expert_data_parallel_size() -> int:
    """The pure data-parallel degree ``dp`` (the batch degree without
    ``ep``): an expert's replicas, over which its gradient is summed."""
    return _size(DATA_AXIS)


def get_expert_data_parallel_rank() -> int:
    return _rank(DATA_AXIS)


def get_expert_data_parallel_group():
    return get_group(DATA_AXIS)


class TensorParallel:
    """The tensor-parallel context a layer is built in: ``size`` (the full
    degree ``kvr * tp``), ``rank`` (in the group, kvr-major), ``group``,
    and ``kvr`` with its ``kvr_group`` (size 1, rank 0 and no groups
    before initialization).

    Heads are cut as the JAX specs cut them: q heads (and the attention
    output's rows) over ``('tp', 'kvr')``, tp-major, so rank ``(kvr = o,
    tp = i)`` holds q block :attr:`q_block` ``= i * kvr + o``; k/v heads
    over ``'tp'`` only, block :attr:`kv_block` ``= i``, replicated along
    kvr.  At ``kvr = 1`` both are ``rank``."""

    def __init__(self, size: int = 1, rank: int = 0, group=None,
                 kvr: int = 1, kvr_group=None):
        self.size, self.rank, self.group = size, rank, group
        self.kvr, self.kvr_group = kvr, kvr_group

    @staticmethod
    def current() -> "TensorParallel":
        if not model_parallel_is_initialized():
            return TensorParallel()
        return TensorParallel(get_tensor_parallel_size(),
                              get_tensor_parallel_rank(),
                              get_tensor_parallel_group(),
                              get_kv_size_multiplier(),
                              get_group(KV_REPLICA_AXIS))

    @property
    def inner(self) -> int:
        """The degree k/v heads split over, ``size / kvr``."""
        return self.size // self.kvr

    @property
    def q_block(self) -> int:
        """This rank's block of q heads (of ``size`` blocks)."""
        return (self.rank % self.inner) * self.kvr + self.rank // self.inner

    @property
    def kv_block(self) -> int:
        """This rank's block of k/v heads (of ``inner`` blocks)."""
        return self.rank % self.inner

    def shard(self, n: int, what: str = "dimension") -> int:
        """``n / size``, raising when it does not divide."""
        if n % self.size:
            raise ValueError(f"{what} of {n} does not split over tensor-"
                             f"parallel degree {self.size}")
        return n // self.size

    def __repr__(self) -> str:
        return (f"TensorParallel(size={self.size}, rank={self.rank}, "
                f"kvr={self.kvr})")


class ContextParallel:
    """The context-parallel context a model is built in: ``size``,
    ``rank`` (this rank's chunk of the sequence), ``group``, its gloo twin
    ``cpu_group`` and the ring's ``next``/``prev`` global ranks (size 1
    and no groups before initialization)."""

    def __init__(self, size: int = 1, rank: int = 0, group=None,
                 cpu_group=None, next: int = 0, prev: int = 0):
        self.size, self.rank, self.group = size, rank, group
        self.cpu_group, self.next, self.prev = cpu_group, next, prev

    @staticmethod
    def current() -> "ContextParallel":
        if not model_parallel_is_initialized() or \
                get_context_parallel_size() == 1:
            return ContextParallel()
        return ContextParallel(get_context_parallel_size(),
                               get_context_parallel_rank(),
                               get_context_parallel_group(),
                               get_context_parallel_cpu_group(),
                               *get_context_parallel_neighbors())

    def __repr__(self) -> str:
        return f"ContextParallel(size={self.size}, rank={self.rank})"


class ExpertParallel:
    """The expert-parallel context an MoE layer is built in: ``size`` (the
    ep degree), ``rank`` and ``group`` (a rank holds experts ``rank *
    E / size`` on), and the routing group its tokens are gathered over,
    ``route_group`` with ``route_size`` and ``route_rank``: at pipeline
    degree 1 the batch group (dp x ep, the JAX GSPMD layer routes over
    the global batch), under a pipeline the ep group (the JAX engine's
    manual-ep layer routes over its ep group's microbatch rows).  Ranks
    of the routing group are batch-ordered, dp-major, so this rank's ep
    group holds the consecutive rows :attr:`line_start` on (size 1 and no
    groups before initialization)."""

    def __init__(self, size: int = 1, rank: int = 0, group=None,
                 route_size: int = 1, route_rank: int = 0,
                 route_group=None):
        self.size, self.rank, self.group = size, rank, group
        self.route_size, self.route_rank = route_size, route_rank
        self.route_group = route_group

    @staticmethod
    def current() -> "ExpertParallel":
        if not model_parallel_is_initialized():
            return ExpertParallel()
        ep = (get_expert_parallel_size(), get_expert_parallel_rank(),
              get_expert_parallel_group())
        if get_pipeline_parallel_size() > 1:
            return ExpertParallel(*ep, *ep)
        return ExpertParallel(*ep, get_data_parallel_size(),
                              get_data_parallel_rank(),
                              get_data_parallel_group())

    def line_start(self, n: int) -> int:
        """The first row of this rank's ep group among the routing group's
        gathered rows, ``n`` rows a rank."""
        return (self.route_rank - self.rank) * n

    def __repr__(self) -> str:
        return (f"ExpertParallel(size={self.size}, rank={self.rank}, "
                f"route_size={self.route_size})")


class PipelineParallel:
    """The pipeline-parallel context a stage runs in: ``size`` (the number
    of stages), ``rank`` (this rank's stage), ``group``, its gloo twin
    ``cpu_group``, the global ranks ``next``/``prev`` of the neighbouring
    stages (a ring) and ``last``, the global rank of the last stage (size
    1 and no groups before initialization)."""

    def __init__(self, size: int = 1, rank: int = 0, group=None,
                 cpu_group=None, next: int = 0, prev: int = 0,
                 last: int = 0):
        self.size, self.rank, self.group = size, rank, group
        self.cpu_group, self.next, self.prev = cpu_group, next, prev
        self.last = last

    @staticmethod
    def current() -> "PipelineParallel":
        if not model_parallel_is_initialized() or \
                get_pipeline_parallel_size() == 1:
            return PipelineParallel()
        return PipelineParallel(get_pipeline_parallel_size(),
                                get_pipeline_parallel_rank(),
                                get_pipeline_parallel_group(),
                                get_pipeline_parallel_cpu_group(),
                                *get_pipeline_parallel_neighbors(),
                                get_group_ranks(PIPELINE_AXIS)[-1])

    @property
    def is_first(self) -> bool:
        return self.rank == 0

    @property
    def is_last(self) -> bool:
        return self.rank == self.size - 1

    def __repr__(self) -> str:
        return f"PipelineParallel(size={self.size}, rank={self.rank})"
