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
all-gather along token dim (MoE, any group)    reduce-scatter
reduce-scatter along token dim                 all-gather
all-gather along seq dim over cp               reduce-scatter over cp
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

Context parallelism passes blocks around its ring (:func:`exchange`:
point-to-point sends and receives), re-shards sequence and heads
(:func:`all_to_all`, its own conjugate), and gathers every rank's keys
and values for the dense core
(:func:`gather_from_context_parallel_region`, counted as
``cp_all_gather`` and ``cp_reduce_scatter``).  Pipeline stages pass
activations forward and their gradients back (:func:`stage_exchange`:
one batch of tagged sends and receives whose receives are waited one by
one, when their data is needed).  None of these has a CUDA path under
gloo, so there they are staged through host memory over the group's gloo
twin.

:data:`COUNTS` counts every collective by kind, :data:`SECONDS` the host
time spent inside them (the whole cost under gloo, which returns when its
work is done) and :data:`BYTES` the bytes each rank hands them (a
reduce's whole tensor, a send's blocks); :func:`reset_counts` zeroes all
three.
"""

from __future__ import annotations

import collections
import time
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from neuronx_distributed_tpu_torch.parallel import mesh

COUNTS: "collections.Counter[str]" = collections.Counter()
SECONDS: "collections.Counter[str]" = collections.Counter()
BYTES: "collections.Counter[str]" = collections.Counter()


def reset_counts() -> None:
    COUNTS.clear()
    SECONDS.clear()
    BYTES.clear()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


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
    BYTES[kind] += _nbytes(out)
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
    BYTES[kind] += _nbytes(x)
    return x


def all_gather(x: torch.Tensor, dim: int, group=None,
               kind: str = "all_gather") -> torch.Tensor:
    """The group's shards of ``x`` concatenated along ``dim`` in rank
    order, counted under ``kind``."""
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
    SECONDS[kind] += time.perf_counter() - t0
    COUNTS[kind] += 1
    BYTES[kind] += _nbytes(out)
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


def reduce_scatter(x: torch.Tensor, dim: int, group=None,
                   kind: str = "reduce_scatter") -> torch.Tensor:
    """The sum over the group of ``x``, this rank's slice along ``dim``,
    counted under ``kind``."""
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
    SECONDS[kind] += time.perf_counter() - t0
    COUNTS[kind] += 1
    BYTES[kind] += _nbytes(full)
    return out


def _staged(t: torch.Tensor, group) -> bool:
    """Whether ``t`` must pass through host memory: gloo has no CUDA
    send, receive or all-to-all."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


class Pending:
    """Blocks on their way (:func:`exchange`): :meth:`wait` returns the
    received blocks on their device, or an empty list when this rank
    receives nothing."""

    def __init__(self, works, received, device, kind: str, t0: float):
        self._works, self._received = works, received
        self._device, self._kind, self._t0 = device, kind, t0

    def wait(self) -> List[torch.Tensor]:
        t0 = time.perf_counter()
        for w in self._works:
            w.wait()
        out = [r.to(self._device, non_blocking=True) for r in self._received]
        SECONDS[self._kind] += time.perf_counter() - t0 + self._t0
        return out


def exchange(tensors: Sequence[torch.Tensor], send_to: Optional[int],
             recv_from: Optional[int], group, cpu_group=None,
             kind: str = "cp_send") -> Pending:
    """Start sending ``tensors`` to global rank ``send_to`` and receiving
    blocks of the same shapes and types from ``recv_from`` (either None:
    that half is skipped); returns at once with a :class:`Pending`.
    Under gloo, CUDA blocks are staged through host memory over
    ``cpu_group`` (default: ``group``, a gloo group itself).  Counted
    once a call under ``kind``, its bytes those sent."""
    t0 = time.perf_counter()
    device = tensors[0].device
    stage = _staged(tensors[0], group)
    g = (cpu_group or group) if stage else group
    ops, received = [], []
    if send_to is not None:
        for i, t in enumerate(tensors):
            t = t.detach().contiguous()
            t = t.cpu() if stage else t
            ops.append(dist.P2POp(dist.isend, t, send_to, g, i))
            BYTES[kind] += _nbytes(t)
    if recv_from is not None:
        for i, t in enumerate(tensors):
            buf = torch.empty(t.shape, dtype=t.dtype,
                              device="cpu" if stage else device)
            ops.append(dist.P2POp(dist.irecv, buf, recv_from, g, i))
            received.append(buf)
    works = dist.batch_isend_irecv(ops) if ops else []
    COUNTS[kind] += 1
    return Pending(works, received, device, kind,
                   time.perf_counter() - t0)


def stage_exchange(sends: Sequence[tuple], recvs: Sequence[tuple], group,
                   cpu_group=None) -> Tuple[List[Pending], List[Pending]]:
    """Post one batch of stage-to-stage transfers over ``group`` and return
    at once: ``sends`` ``[(tensor, dst, tag, kind)]`` and ``recvs``
    ``[(shape, dtype, device, src, tag, kind)]`` (``dst``/``src`` global
    ranks; a receive matches the send of the same tag).  The receives are
    posted before the sends (the reference's receive-before-send rule),
    all in one ``batch_isend_irecv``.  Returns ``(receives, sends)``, one
    :class:`Pending` each: a receive's :meth:`Pending.wait` gives ``[the
    tensor]`` on its device.  Each transfer counts one call and its bytes
    under its ``kind``; a receive's seconds are the time spent waiting
    for it, a send's the time to post it (its host copy under gloo).
    Under gloo, CUDA tensors are staged through host memory over
    ``cpu_group``."""
    ops, meta = [], []
    for shape, dtype, device, src, tag, kind in recvs:
        t0 = time.perf_counter()
        stage = torch.device(device).type == "cuda" and \
            dist.get_backend(group) == "gloo"
        g = (cpu_group or group) if stage else group
        buf = torch.empty(tuple(shape), dtype=dtype,
                          device="cpu" if stage else device)
        ops.append(dist.P2POp(dist.irecv, buf, src, g, tag))
        meta.append(("recv", buf, device, kind, time.perf_counter() - t0))
        COUNTS[kind] += 1
        BYTES[kind] += _nbytes(buf)
    for t, dst, tag, kind in sends:
        t0 = time.perf_counter()
        stage = _staged(t, group)
        g = (cpu_group or group) if stage else group
        t = t.detach().contiguous()
        t = t.cpu() if stage else t
        ops.append(dist.P2POp(dist.isend, t, dst, g, tag))
        meta.append(("send", t, t.device, kind, time.perf_counter() - t0))
        COUNTS[kind] += 1
        BYTES[kind] += _nbytes(t)
    works = dist.batch_isend_irecv(ops) if ops else []
    received, sent = [], []
    for w, (what, buf, device, kind, t_post) in zip(works, meta):
        if what == "recv":
            received.append(Pending([w], [buf], device, kind, t_post))
        else:
            # the send's buffer stays referenced until its wait
            p = Pending([w], [], device, kind, t_post)
            p.buffer = buf
            sent.append(p)
    return received, sent


def _all_to_all(x: torch.Tensor, group, cpu_group) -> torch.Tensor:
    t0 = time.perf_counter()
    stage = _staged(x, group)
    src = x.detach().contiguous()
    src = src.cpu() if stage else src
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=(cpu_group or group) if stage
                           else group)
    SECONDS["all_to_all"] += time.perf_counter() - t0
    COUNTS["all_to_all"] += 1
    BYTES["all_to_all"] += _nbytes(src)
    return out.to(x.device, non_blocking=True) if stage else out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, cpu_group):
        ctx.group, ctx.cpu_group = group, cpu_group
        return _all_to_all(x, group, cpu_group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group, ctx.cpu_group), None, None


def all_to_all(x: torch.Tensor, group, cpu_group=None) -> torch.Tensor:
    """Dim 0 of ``x`` cut into one block per rank of ``group``: block
    ``j`` goes to rank ``j``, and block ``j`` of the result came from rank
    ``j``.  Its own conjugate (backward: the same exchange); staged
    through host memory over ``cpu_group`` under gloo."""
    if group_size(group) == 1:
        return x
    return _AllToAll.apply(x, group, cpu_group)


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


class _GatherTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather(x, 0, group, kind="ep_all_gather")

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, 0, ctx.group, kind="ep_reduce_scatter"), None


class _ReduceScatterTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return reduce_scatter(x, 0, group, kind="ep_reduce_scatter")

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, 0, ctx.group, kind="ep_all_gather"), None


class _GatherContext(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seq_dim, group):
        ctx.seq_dim, ctx.group = seq_dim, group
        return all_gather(x, seq_dim, group, kind="cp_all_gather")

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter(g, ctx.seq_dim, ctx.group,
                               kind="cp_reduce_scatter"), None, None)


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


def gather_tokens(x: torch.Tensor, group) -> torch.Tensor:
    """Forward all-gather of the token dim (dim 0) over ``group`` in rank
    order, backward reduce-scatter of it: an MoE layer's tokens in
    (counted as ``ep_all_gather`` and ``ep_reduce_scatter``)."""
    return x if _trivial(group) else _GatherTokens.apply(x, group)


def reduce_scatter_tokens(x: torch.Tensor, group) -> torch.Tensor:
    """Forward reduce-scatter of the token dim (dim 0) over ``group``,
    backward all-gather of it: an MoE layer's partial outputs back to the
    rank that holds each token."""
    return x if _trivial(group) else _ReduceScatterTokens.apply(x, group)


def gather_from_context_parallel_region(x: torch.Tensor, seq_dim: int,
                                        group) -> torch.Tensor:
    """Forward all-gather of the sequence dim over the context-parallel
    ``group`` in rank order (every rank's chunk), backward reduce-scatter
    of it: the dense attention core's keys and values at cp > 1 (counted
    as ``cp_all_gather`` and ``cp_reduce_scatter``)."""
    return x if _trivial(group) else _GatherContext.apply(x, seq_dim, group)
