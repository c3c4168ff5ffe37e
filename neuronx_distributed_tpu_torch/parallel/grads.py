"""Gradient norm, clipping and the gradient reductions a rank's shard
needs (counterpart of ``neuronx_distributed_tpu/parallel/grads.py``).

Under GSPMD every gradient is a logically global array, so the JAX norm is
a plain reduction.  Here a rank holds its shard, so the norm needs to
know how each gradient lies over the ranks: pass ``params`` and each
parameter's layout (:func:`.layers.tp_layout`) decides.  A tp-sharded
gradient's squared sum is summed over tp; a replicated one (a row bias, a
norm weight after its sequence-parallel sum) counts once, on tp rank 0; a
``kv_replicated`` one (a K/V kernel at kvr > 1) once per kv block, on its
kvr rank 0.  Under ZeRO-1 (``dp_sliced``) a gradient that is this rank's
slice over dp is summed over dp as well; the others count on dp rank 0.
Each rank adds only the gradients it owns and one all-reduce over the
world gives every rank the global norm (pp = cp = 1).

The reductions the reference does by hand and GSPMD derives:
:func:`allreduce_sequence_parallel_gradients` (replicated parameters
acting on sequence shards: each rank's gradient covers its shard) and
:func:`allreduce_kv_replicated_gradients` (the kvr replicas of a K/V
kernel each see their own q heads' share), each one coalesced all-reduce
a step, and :func:`psum_over_data_parallel` (the data-parallel sum).
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from neuronx_distributed_tpu_torch.parallel import mappings, mesh
from neuronx_distributed_tpu_torch.parallel.layers import (
    KV_REPLICATED,
    SHARDED,
    is_sequence_parallel,
    tp_layout,
)

# bytes of one coalesced all-reduce (the reference's bucket size)
BUCKET_BYTES = 512 * 2 ** 20


def _owned(p, sliced: bool) -> bool:
    """Whether this rank counts ``p``'s gradient in the global norm."""
    layout, rank = tp_layout(p), mesh.get_tensor_parallel_rank()
    if layout == KV_REPLICATED:   # kvr index 0 (the tp rank is kvr-major)
        inner = mesh.get_tensor_parallel_size() // mesh.get_kv_size_multiplier()
        mine = rank < inner
    else:
        mine = layout == SHARDED or rank == 0
    return mine and (sliced or mesh.get_data_parallel_rank() == 0)


def _partial(g: torch.Tensor, norm_type: float) -> torch.Tensor:
    g = g.float()
    if norm_type == float("inf"):
        return g.abs().max()
    if norm_type == 2.0:
        return g.square().sum()
    return (g.abs() ** norm_type).sum()


def get_grad_norm(grads: Iterable[torch.Tensor], norm_type: float = 2.0,
                  params: Optional[Sequence[torch.Tensor]] = None,
                  dp_sliced: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """Global norm over ``grads`` (None entries skipped), accumulated in
    fp32.  Without ``params`` (or outside a multi-rank world) the norm of
    the tensors as given; with them (``params[i]`` is ``grads[i]``'s
    parameter, ``dp_sliced[i]`` true when ``grads[i]`` is this rank's
    ZeRO-1 slice) the norm of the full gradients over every rank."""
    grads = list(grads)
    world = params is not None and dist.is_initialized() \
        and mesh.model_parallel_is_initialized() \
        and dist.get_world_size() > 1
    sliced = list(dp_sliced) if dp_sliced is not None else [False] * len(grads)
    parts = [_partial(g, norm_type) for i, g in enumerate(grads)
             if g is not None and (not world or _owned(params[i], sliced[i]))]
    device = next((g.device for g in grads if g is not None), None)
    total = (torch.stack(parts) if parts
             else torch.zeros(1, dtype=torch.float32, device=device))
    total = total.max() if norm_type == float("inf") else total.sum()
    if world:
        op = (dist.ReduceOp.MAX if norm_type == float("inf")
              else dist.ReduceOp.SUM)
        total = mappings.all_reduce(total, dist.group.WORLD, op=op)
    if norm_type in (2.0, float("inf")):
        return total.sqrt() if norm_type == 2.0 else total
    return total ** (1.0 / norm_type)


def clip_grad_norm(grads: List[torch.Tensor], max_norm: float,
                   norm_type: float = 2.0, eps: float = 1e-6,
                   params: Optional[Sequence[torch.Tensor]] = None,
                   dp_sliced: Optional[Sequence[bool]] = None,
                   ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Scale ``grads`` IN PLACE so their global norm (:func:`get_grad_norm`,
    with ``params``/``dp_sliced`` as there) is at most ``max_norm``
    (``coeff = min(max_norm / (norm + eps), 1)``, applied in fp32); returns
    ``(grads, pre-clip norm)``.  The JAX function returns new arrays
    instead."""
    norm = get_grad_norm(grads, norm_type, params, dp_sliced)
    coeff = torch.clamp(max_norm / (norm + eps), max=1.0)
    for g in grads:
        if g is not None:
            g.mul_(coeff)  # a 0-dim fp32 factor: computed in fp32
    return grads, norm


def buckets(tensors: Sequence[torch.Tensor],
            bucket_bytes: int = BUCKET_BYTES) -> List[List[torch.Tensor]]:
    """``tensors`` packed in order into lists of one dtype and at most
    ``bucket_bytes`` (a larger tensor alone)."""
    out, by_dtype = [], {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group_ts in by_dtype.values():
        bucket, size = [], 0
        for t in group_ts:
            n = t.numel() * t.element_size()
            if bucket and size + n > bucket_bytes:
                out.append(bucket)
                bucket, size = [], 0
            bucket.append(t)
            size += n
        out.append(bucket)
    return out


def unflatten_into(flat: torch.Tensor, bucket: Sequence[torch.Tensor]
                   ) -> None:
    """Copy ``flat`` back into the tensors it was packed from."""
    for b, part in zip(bucket, flat.split([b.numel() for b in bucket])):
        b.copy_(part.view_as(b))


def coalesced_all_reduce(tensors: Sequence[torch.Tensor], group,
                         kind: str = "all_reduce",
                         bucket_bytes: int = BUCKET_BYTES) -> None:
    """Sum ``tensors`` over ``group`` IN PLACE, packed into flat buckets of
    at most ``bucket_bytes`` by dtype (one collective a bucket, counted
    under ``kind``)."""
    if mappings.group_size(group) == 1:
        return
    for bucket in buckets(tensors, bucket_bytes):
        unflatten_into(mappings.all_reduce(
            torch.cat([b.reshape(-1) for b in bucket]), group, kind=kind),
            bucket)


def allreduce_sequence_parallel_gradients(params: Iterable[torch.Tensor]
                                          ) -> None:
    """Sum the gradients of the ``sequence_parallel`` parameters over the
    tensor-parallel group, in place (the reference's
    ``allreduce_sequence_parallel_gradients``)."""
    grads = [p.grad for p in params
             if is_sequence_parallel(p) and p.grad is not None]
    if grads:
        coalesced_all_reduce(grads, mesh.get_tensor_parallel_group())


def allreduce_kv_replicated_gradients(params: Iterable[torch.Tensor]) -> None:
    """Sum the gradients of the ``kv_replicated`` parameters over the kvr
    group, in place: each replica saw only its own q heads' share."""
    grads = [p.grad for p in params
             if tp_layout(p) == KV_REPLICATED and p.grad is not None]
    if grads:
        coalesced_all_reduce(grads, mesh.get_group(mesh.KV_REPLICA_AXIS))


def psum_over_data_parallel(grads: Sequence[torch.Tensor],
                            mean: bool = True) -> Sequence[torch.Tensor]:
    """Sum ``grads`` over the data-parallel group in place (divided by its
    size when ``mean``); returns them (the conjugate of the reference's
    ``bucket_allreduce_gradients``)."""
    grads = [g for g in grads if g is not None]
    if not mesh.model_parallel_is_initialized():
        return grads
    coalesced_all_reduce(grads, mesh.get_data_parallel_group())
    n = mesh.get_data_parallel_size()
    if mean and n > 1:
        for g in grads:
            g.div_(n)
    return grads
