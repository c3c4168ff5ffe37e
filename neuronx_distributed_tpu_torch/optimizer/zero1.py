"""ZeRO-1: optimizer-state sharding over the data-parallel ranks
(counterpart of ``neuronx_distributed_tpu/optimizer/zero1.py``).

The JAX package makes ZeRO-1 a placement policy: an optimizer-state leaf
takes its parameter's ``PartitionSpec`` with the data-parallel axes
prepended onto the first dim that divides ``dp x`` its existing sharding
(:func:`zero1_spec`), and XLA inserts the reduce-scatter of the gradients
and the all-gather of the parameters.  Here a rank holds its tensor-
parallel shard of each parameter, and :class:`Zero1` does those steps by
hand: the gradients are reduced over dp (one coalesced collective a
bucket), each rank keeps its slice of every eligible parameter's
gradient, runs AdamW over its state shards (fp32, the same elementwise
update as the replicated optimizer: ``optimizer.adamw_fp32``), and the
updated slices are all-gathered back into the parameters.

At pp > 1 the same runs inside each stage: a stage's parameters, sliced
over its data-parallel group.

An MoE expert's weights (``expert_parallel``) keep a whole state on their
ep shard, as JAX's ``_dp_extend`` leaves a spec that already names a batch
axis, and their gradients are summed over the pure dp axis
(``expert_group``), not dp x ep.

The eligible dim of a local shard is the first whose size divides dp
(:func:`zero1_dim`): the dim JAX picks, since the shard's size is the
full size over the existing sharding.  Within that dim the port's slices
are tp-major (a rank's tp shard, cut in dp pieces), where JAX's are
dp-major; the values and the update are the same, the owner of a given
element differs.  Parameters with no eligible dim keep a replicated state.
The gradients' reduce-scatter is an all-reduce of the bucket, as every
reduce-scatter of the port (``parallel/mappings``, ROADMAP A9a); the
parameters' all-gather is one broadcast of each rank's slices (gloo takes
only broadcast and all-reduce on CUDA tensors), so their bytes cross once
and exactly.

:func:`fsdp_spec` (ZeRO-3 as placement) picks the dim a parameter itself
is cut along over dp under ``fsdp=True``: the LARGEST eligible global dim
(:func:`fsdp_dim` on a rank's local shard; :mod:`..parallel.fsdp` does the
gathers).  The layout choice, the same as ZeRO-1's: a rank's dp piece is
its tensor-parallel shard cut in ``dp`` pieces along that dim, so within a
dim that tp also cuts the order is tp-major (global offset ``tp_block *
n / tp + dp_rank * n / (tp * dp)``), where JAX's spec prepends the batch
axes and is dp-major.  Either layout computes the same values; the
converter (``convert.fsdp_shard_for_rank``), the checkpoint's ``meta.json``
(each shard's box in the global tensor) and the parity tests all use the
tp-major one.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from neuronx_distributed_tpu_torch.parallel import mappings, mesh
from neuronx_distributed_tpu_torch.parallel.grads import (
    buckets,
    coalesced_all_reduce,
    unflatten_into,
)
from neuronx_distributed_tpu_torch.parallel.moe import is_expert_parallel

# a spec entry: None (replicated), one axis name, or a tuple of axis names
Entry = Union[None, str, Tuple[str, ...]]


def _axes_of(entry: Entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _sizes(sizes: Optional[Mapping[str, int]]) -> Mapping[str, int]:
    if sizes is not None:
        return sizes
    cfg = mesh.get_mesh_config()
    return dict(zip(mesh.MESH_AXES, mesh.mesh_shape(cfg)))


def _dp_extend(spec: Optional[Sequence[Entry]], shape: Sequence[int],
               sizes: Optional[Mapping[str, int]], largest: bool) -> tuple:
    """The JAX ``_dp_extend`` over a spec given as a tuple of entries and
    the axis sizes (default: the live layout's)."""
    sizes = _sizes(sizes)
    dp = math.prod(sizes.get(a, 1) for a in mesh.BATCH_AXES)
    entries = list(spec or ()) + [None] * (len(shape) - len(spec or ()))
    if dp == 1:
        return tuple(spec or ())
    if any(a in mesh.BATCH_AXES for e in entries for a in _axes_of(e)):
        return tuple(entries)
    best, best_size = None, 0
    for i, (dim, entry) in enumerate(zip(shape, entries)):
        existing = math.prod(sizes.get(a, 1) for a in _axes_of(entry))
        if dim % (dp * existing) == 0:
            if not largest:
                best = i
                break
            if dim > best_size:
                best, best_size = i, dim
    if best is not None:
        entries[best] = tuple(mesh.BATCH_AXES) + _axes_of(entries[best])
    return tuple(entries)


def zero1_spec(spec: Optional[Sequence[Entry]], shape: Sequence[int],
               sizes: Optional[Mapping[str, int]] = None) -> tuple:
    """A parameter's spec extended with the dp axes for its optimizer
    state: the FIRST eligible dim (its size divides dp x its existing
    sharding); no eligible dim keeps the spec (replicated state)."""
    return _dp_extend(spec, shape, sizes, largest=False)


def fsdp_spec(spec: Optional[Sequence[Entry]], shape: Sequence[int],
              sizes: Optional[Mapping[str, int]] = None) -> tuple:
    """A parameter's own spec extended with the dp axes (ZeRO-3 as
    placement): the LARGEST eligible dim."""
    return _dp_extend(spec, shape, sizes, largest=True)


def zero1_dim(local_shape: Sequence[int], dp: int) -> Optional[int]:
    """The dim of a rank's local shard that its ZeRO-1 state is cut along
    (the first whose size divides ``dp``), or None (replicated state)."""
    if dp == 1:
        return None
    return next((i for i, n in enumerate(local_shape) if n % dp == 0), None)


def fsdp_dim(local_shape: Sequence[int], global_shape: Sequence[int],
             dp: int) -> Optional[int]:
    """The dim of a rank's local shard that FSDP cuts over ``dp``: among
    the dims whose local size divides ``dp`` (the global size divides ``dp
    x`` its tensor-parallel cut, JAX's eligibility), the one with the
    largest GLOBAL size, the first on a tie (:func:`fsdp_spec`'s pick);
    None when none is eligible (the parameter stays replicated over
    dp)."""
    if dp == 1:
        return None
    best, best_size = None, 0
    for i, (n, g) in enumerate(zip(local_shape, global_shape)):
        if n % dp == 0 and g > best_size:
            best, best_size = i, g
    return best


def optimizer_state_layout(params: Sequence[torch.Tensor], dp: int
                           ) -> list:
    """The counterpart of ``optimizer_state_specs``: for each parameter,
    ``(dim, slice length)`` of its state shard, or None when its state is
    replicated over dp."""
    out = []
    for p in params:
        if is_expert_parallel(p):
            out.append(None)
            continue
        d = zero1_dim(p.shape, dp)
        out.append(None if d is None else (d, p.shape[d] // dp))
    return out


class Zero1:
    """The data-parallel half of a ZeRO-1 step over ``params`` (the
    rank's local shards) for data-parallel ``group`` of ``size`` ranks at
    ``rank``.  :attr:`shards` are what the optimizer updates: for an
    eligible parameter a contiguous fp32 copy of this rank's slice (its
    state is that slice's), else the parameter itself.  ``expert_group``
    (the pure dp axis) sums the MoE experts' gradients."""

    def __init__(self, params: Sequence[torch.nn.Parameter], group, size: int,
                 rank: int, expert_group=None):
        self.params = list(params)
        self.group, self.size, self.rank = group, size, rank
        self.expert_group = expert_group
        self.layout = optimizer_state_layout(self.params, size)
        with torch.no_grad():
            self.shards = [p if lay is None else
                           p.detach().narrow(lay[0], rank * lay[1],
                                             lay[1]).clone()
                           for p, lay in zip(self.params, self.layout)]

    @property
    def sliced(self) -> list:
        """Per shard: True when it is this rank's slice over dp."""
        return [lay is not None for lay in self.layout]

    def reduce_scatter_grads(self) -> list:
        """Sum every gradient over dp and hand each eligible slice to its
        shard (the full gradient is dropped); returns the shards'
        gradients in order."""
        expert = [is_expert_parallel(p) for p in self.params]
        grads = [p.grad for p in self.params]
        coalesced_all_reduce([g for g, e in zip(grads, expert)
                              if g is not None and not e], self.group,
                             kind="reduce_scatter")
        ex = [g for g, e in zip(grads, expert) if g is not None and e]
        if ex and self.expert_group is not None:
            coalesced_all_reduce(ex, self.expert_group,
                                 kind="expert_all_reduce")
        for p, s, lay in zip(self.params, self.shards, self.layout):
            if lay is not None:
                s.grad = p.grad.narrow(lay[0], self.rank * lay[1],
                                       lay[1]).contiguous()
                p.grad = None
        return [s.grad for s in self.shards]

    @torch.no_grad()
    def all_gather_params(self) -> None:
        """Write each updated slice into its parameter, then all-gather the
        parameters over dp: each rank in turn broadcasts its slices, packed
        in buckets (a slice's bytes cross once, and exactly)."""
        eligible = []
        for p, s, lay in zip(self.params, self.shards, self.layout):
            if lay is not None:
                p.narrow(lay[0], self.rank * lay[1], lay[1]).copy_(s)
                eligible.append((p, lay))
        if self.size == 1:
            return
        ranks = dist.get_process_group_ranks(self.group)
        for src in range(self.size):
            views = [p.narrow(d, src * n, n) for p, (d, n) in eligible]
            for bucket in buckets(views):
                if src == self.rank:
                    flat = torch.cat([v.reshape(-1) for v in bucket])
                else:
                    flat = torch.empty(sum(v.numel() for v in bucket),
                                       dtype=bucket[0].dtype,
                                       device=bucket[0].device)
                mappings.broadcast(flat, ranks[src], self.group,
                                   kind="all_gather")
                if src != self.rank:
                    unflatten_into(flat, bucket)

    def zero_grad(self) -> None:
        for p, s in zip(self.params, self.shards):
            p.grad = None
            s.grad = None


def state_bytes(optimizer: torch.optim.Optimizer) -> int:
    """Bytes of the optimizer's tensor state (AdamW's two moments and step
    counters) on this rank."""
    return sum(v.numel() * v.element_size()
               for st in optimizer.state.values() for v in st.values()
               if isinstance(v, torch.Tensor))


def state_by_param(optimizer: torch.optim.Optimizer, zero1: Optional[Zero1],
                   names: Mapping[torch.Tensor, str]
                   ) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{param name: {"exp_avg", "exp_avg_sq"}}`` of this rank (its
    ZeRO-1 slices where it has them), by the names of ``names`` (a
    parameter -> name map, e.g. from ``named_parameters``)."""
    pairs = (zip(zero1.params, zero1.shards) if zero1 is not None
             else ((p, p) for g in optimizer.param_groups for p in g["params"]))
    out = {}
    for p, s in pairs:
        st = optimizer.state.get(s, {})
        if "exp_avg" in st:
            out[names[p]] = {"exp_avg": st["exp_avg"],
                             "exp_avg_sq": st["exp_avg_sq"]}
    return out
