"""Conjugate-pair collective mappings over the tensor-parallel group
(counterpart of ``neuronx_distributed_tpu/parallel/mappings.py``).

Each mapping is a ``torch.autograd.Function`` whose backward is its
forward's conjugate, as in the JAX package's ``custom_vjp`` forms:

=============================================  ==========================
forward                                        backward
=============================================  ==========================
copy (identity)                                all-reduce over tp
all-reduce over tp                             copy (identity)
split along last dim                           all-gather along last dim
all-gather along last dim                      split along last dim
split along seq dim                            all-gather along seq dim
all-gather along seq dim                       reduce-scatter | split
reduce-scatter along seq dim                   all-gather along seq dim
=============================================  ==========================

``group`` defaults to the tensor-parallel group of :mod:`.mesh`; a group
of one rank makes every mapping the identity.  Serving runs the forwards;
the backwards are here whole for the training slice.

On every backend the gather is an all-reduce of the shard placed in
zeros and the reduce-scatter an all-reduce then a split: gloo (the CPU,
and two ranks sharing one card) takes only ``broadcast`` and
``all_reduce`` on CUDA tensors, adding exact zeros leaves every value as
it was, and one path serves every device.  NCCL's own all-gather and
reduce-scatter move 1/tp of those bytes; they come with the first
two-card measurement (ROADMAP A9a).

:data:`COUNTS` counts every collective by kind, and :data:`SECONDS` the
host time spent inside them (the whole cost under gloo, which returns
when its work is done); :func:`reset_counts` zeroes both.
"""

from __future__ import annotations

import collections
import time

import torch
import torch.distributed as dist

from neuronx_distributed_tpu_torch.parallel import mesh

COUNTS: "collections.Counter[str]" = collections.Counter()
SECONDS: "collections.Counter[str]" = collections.Counter()


def reset_counts() -> None:
    COUNTS.clear()
    SECONDS.clear()


def _group(group):
    return mesh.get_tensor_parallel_group() if group is None else group


def group_size(group=None) -> int:
    g = _group(group)
    return 1 if g is None else dist.get_world_size(g)


def group_rank(group=None) -> int:
    g = _group(group)
    return 0 if g is None else dist.get_rank(g)


def all_reduce(x: torch.Tensor, group=None, op=dist.ReduceOp.SUM,
               kind: str = "all_reduce") -> torch.Tensor:
    """``x`` reduced over ``group`` (a new tensor; ``x`` is not written),
    counted under ``kind``."""
    g = _group(group)
    if g is None or dist.get_world_size(g) == 1:
        return x
    t0 = time.perf_counter()
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=g)
    SECONDS[kind] += time.perf_counter() - t0
    COUNTS[kind] += 1
    return out


def broadcast(x: torch.Tensor, src: int, group=None,
              kind: str = "broadcast") -> torch.Tensor:
    """``x`` of global rank ``src`` on every rank of ``group``, IN PLACE,
    counted under ``kind``."""
    g = _group(group)
    if g is None or dist.get_world_size(g) == 1:
        return x
    t0 = time.perf_counter()
    dist.broadcast(x, src=src, group=g)
    SECONDS[kind] += time.perf_counter() - t0
    COUNTS[kind] += 1
    return x


def all_gather(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The group's shards of ``x`` concatenated along ``dim`` in rank
    order."""
    g = _group(group)
    n = 1 if g is None else dist.get_world_size(g)
    if n == 1:
        return x
    t0 = time.perf_counter()
    dim = dim % x.ndim
    shape = list(x.shape)
    shape[dim] *= n
    out = torch.zeros(shape, dtype=x.dtype, device=x.device)
    out.narrow(dim, dist.get_rank(g) * x.shape[dim], x.shape[dim]).copy_(x)
    dist.all_reduce(out, group=g)
    SECONDS["all_gather"] += time.perf_counter() - t0
    COUNTS["all_gather"] += 1
    return out


def split(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """This rank's slice of ``x`` along ``dim`` (no communication)."""
    g = _group(group)
    n = 1 if g is None else dist.get_world_size(g)
    if n == 1:
        return x
    if x.shape[dim] % n != 0:
        raise ValueError(f"cannot split dim {dim} of size {x.shape[dim]} "
                         f"across {n} ranks: not divisible")
    chunk = x.shape[dim] // n
    return x.narrow(dim, dist.get_rank(g) * chunk, chunk).contiguous()


def reduce_scatter(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The sum over the group of ``x``, this rank's slice along ``dim``."""
    g = _group(group)
    n = 1 if g is None else dist.get_world_size(g)
    if n == 1:
        return x
    if x.shape[dim] % n != 0:
        raise ValueError(f"cannot reduce-scatter dim {dim} of size "
                         f"{x.shape[dim]} across {n} ranks: not divisible")
    t0 = time.perf_counter()
    full = x.contiguous().clone()
    dist.all_reduce(full, group=g)
    out = split(full, dim, g)
    SECONDS["reduce_scatter"] += time.perf_counter() - t0
    COUNTS["reduce_scatter"] += 1
    return out


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return split(x, -1, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, -1, ctx.group), None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather(x, -1, group)

    @staticmethod
    def backward(ctx, g):
        return split(g, -1, ctx.group), None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seq_dim, group):
        ctx.seq_dim, ctx.group = seq_dim, group
        return split(x, seq_dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.seq_dim, ctx.group), None, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seq_dim, to_tensor_parallel, group):
        ctx.seq_dim, ctx.to_tp, ctx.group = seq_dim, to_tensor_parallel, group
        return all_gather(x, seq_dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.to_tp:
            return reduce_scatter(g, ctx.seq_dim, ctx.group), None, None, None
        return split(g, ctx.seq_dim, ctx.group), None, None, None


class _ReduceScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seq_dim, group):
        ctx.seq_dim, ctx.group = seq_dim, group
        return reduce_scatter(x, seq_dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.seq_dim, ctx.group), None, None


def _trivial(group) -> bool:
    return group_size(group) == 1


def copy_to_tensor_parallel_region(x: torch.Tensor, group=None) -> torch.Tensor:
    """Forward identity, backward all-reduce over tp."""
    return x if _trivial(group) else _Copy.apply(x, _group(group))


def reduce_from_tensor_parallel_region(x: torch.Tensor,
                                       group=None) -> torch.Tensor:
    """Forward all-reduce over tp, backward identity."""
    return x if _trivial(group) else _Reduce.apply(x, _group(group))


def scatter_to_tensor_parallel_region(x: torch.Tensor,
                                      group=None) -> torch.Tensor:
    """Forward split of the last dim, backward all-gather of it."""
    return x if _trivial(group) else _ScatterLast.apply(x, _group(group))


def gather_from_tensor_parallel_region(x: torch.Tensor,
                                       group=None) -> torch.Tensor:
    """Forward all-gather of the last dim, backward split of it."""
    return x if _trivial(group) else _GatherLast.apply(x, _group(group))


def scatter_to_sequence_parallel_region(x: torch.Tensor, seq_dim: int = 0,
                                        group=None) -> torch.Tensor:
    """Forward split of the sequence dim, backward all-gather of it."""
    return x if _trivial(group) else _ScatterSeq.apply(x, seq_dim, _group(group))


def gather_from_sequence_parallel_region(
        x: torch.Tensor, seq_dim: int = 0, to_tensor_parallel: bool = True,
        group=None) -> torch.Tensor:
    """Forward all-gather of the sequence dim; backward reduce-scatter
    (feeding a tensor-parallel block) or a plain split."""
    if _trivial(group):
        return x
    return _GatherSeq.apply(x, seq_dim, to_tensor_parallel, _group(group))


def reduce_scatter_to_sequence_parallel_region(x: torch.Tensor,
                                               seq_dim: int = 0,
                                               group=None) -> torch.Tensor:
    """Forward reduce-scatter of the sequence dim, backward all-gather."""
    if _trivial(group):
        return x
    return _ReduceScatterSeq.apply(x, seq_dim, _group(group))
