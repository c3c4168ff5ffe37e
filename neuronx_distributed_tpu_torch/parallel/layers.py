"""Linear and embedding layers (counterpart of
``neuronx_distributed_tpu/parallel/layers.py``), at any tensor-parallel
degree.

A layer is built at the tensor-parallel context current at construction
(:class:`.mesh.TensorParallel`; degree 1 before
:func:`.mesh.initialize_model_parallel`) and holds only its rank's shard,
cut as the JAX package's partition specs cut the global array.  That
context, not the one live at call time, decides its collectives: a layer
built at degree 1 calls no mapping, whatever group is initialized later.

- :class:`ColumnParallelLinear` holds ``out / tp`` output features; a
  fused kernel ``[in, n_fused, out / n_fused]`` is sharded on its last
  dim, so each rank holds its slice of every fused part.  Its output
  stays sharded unless ``gather_output``;
- :class:`RowParallelLinear` holds ``in / tp`` input features, all-reduces
  its partial sums (in fp32, rounded once to the compute type) and adds
  its (replicated) bias once, after the reduce;
- :class:`ParallelEmbedding` holds ``vocab / tp`` rows: a masked local
  lookup plus an all-reduce, and :meth:`~ParallelEmbedding.attend` gives
  local-vocab logits.

Sequence parallelism (``sequence_parallel``, the embedding's
``sequence_parallel_output``): between the layers the activations hold
this rank's slice of the sequence (dim -2, in tp-group rank order, the
JAX ``SEQUENCE_AXES`` order at cp = 1).  A column layer all-gathers the
sequence before its matmul (its backward reduce-scatters), a row layer
reduce-scatters its fp32 partials onto the sequence instead of
all-reducing them (then rounds once), and the embedding reduce-scatters
its masked rows.  ``forward(..., sequence_parallel=False)`` runs the
plain collectives for one call (a model decides per forward: serving
and sequences that do not split run without).  A layer built without SP
keeps the plain collectives.

Every parameter records how its gradient lies over the tensor-parallel
group (:func:`tp_layout`): ``"sharded"`` (each rank its own slice),
``"kv_replicated"`` (k/v heads: sharded over ``tp / kvr``, the same on
the ``kvr`` ranks of a kv block), or replicated; a replicated parameter
that acts on sequence shards is also marked ``sequence_parallel`` (its
rank's gradient covers only its shard, :mod:`.grads` sums them over tp).

Parameters keep the JAX package's names and layouts so a JAX param tree
loads by path (at tp > 1 after ``convert.shard_params_for_rank``):
``kernel [in, out]`` (``[in, n_fused, out / n_fused]`` fused), ``bias``,
``embedding [V, H]``.  Weights are stored in ``param_dtype`` (default: the
compute ``dtype``, as serving holds them) and cast to ``dtype`` at each
matmul and lookup, as flax does with the JAX package's fp32 masters.
Random init is tp-invariant: each full tensor is drawn from the generator
and the rank keeps its slice, so a model built at tp from seed ``s``
holds the tp = 1 model's weights, sliced (JAX gets the same from
partitionable threefry).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from neuronx_distributed_tpu_torch.parallel.mappings import (
    copy_to_tensor_parallel_region,
    gather_from_sequence_parallel_region,
    gather_from_tensor_parallel_region,
    reduce_from_tensor_parallel_region,
    reduce_scatter_to_sequence_parallel_region,
)
from neuronx_distributed_tpu_torch.parallel.mesh import TensorParallel

SHARDED, KV_REPLICATED = "sharded", "kv_replicated"


def _kernel(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


def set_tp_layout(p: nn.Parameter, tp: TensorParallel, layout: str = SHARDED,
                  sequence_parallel: bool = False) -> nn.Parameter:
    """Record ``p``'s layout over ``tp``'s group (nothing at degree 1,
    where every parameter is whole)."""
    if tp.size > 1:
        if layout is not None:
            p.tp_layout = layout
        if sequence_parallel:
            p.sequence_parallel = True
    return p


def tp_layout(p: torch.Tensor) -> Optional[str]:
    """``"sharded"``, ``"kv_replicated"`` or None (replicated)."""
    return getattr(p, "tp_layout", None)


def is_sequence_parallel(p: torch.Tensor) -> bool:
    return getattr(p, "sequence_parallel", False)


def _sp(layer, override: Optional[bool]) -> bool:
    """Whether this call runs the sequence-parallel collectives."""
    if layer.tp.size == 1:
        return False
    return layer.sequence_parallel if override is None else override


def init_normal_(p: torch.Tensor, std: float, generator=None,
                 full_shape: Optional[Sequence[int]] = None, dim: int = 0,
                 tp: Optional[TensorParallel] = None,
                 block: Optional[int] = None) -> None:
    """``p ~ N(0, std^2)`` from ``generator``.  A shard (``tp.size > 1``)
    draws the whole ``full_shape`` tensor and keeps its slice along
    ``dim`` (block ``block`` of its size, default ``tp.rank``), so the
    generator advances as at tp = 1 and the values are the tp = 1
    tensor's."""
    with torch.no_grad():
        if tp is None or tp.size == 1:
            p.normal_(0.0, std, generator=generator)
            return
        full = torch.empty(tuple(full_shape), dtype=p.dtype, device=p.device)
        full.normal_(0.0, std, generator=generator)
        n = p.shape[dim]
        p.copy_(full.narrow(dim, (tp.rank if block is None else block) * n,
                            n))


class ColumnParallelLinear(nn.Module):
    """``y = x @ kernel (+ bias)`` over this rank's output features; with
    ``n_fused > 1`` the output is ``[..., n_fused, features // n_fused /
    tp]`` (the fused gate-up layout).  ``gather_output`` all-gathers the
    full feature dim."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 n_fused: int = 1, dtype: torch.dtype = torch.bfloat16,
                 device=None, param_dtype: Optional[torch.dtype] = None,
                 gather_output: bool = False,
                 sequence_parallel: bool = False):
        super().__init__()
        if features % n_fused:
            raise ValueError(f"{features} features do not split into "
                             f"{n_fused} fused parts")
        self.tp = TensorParallel.current()
        self.n_fused = n_fused
        self.dtype = dtype
        self.gather_output = gather_output
        self.sequence_parallel = sequence_parallel
        per = features // n_fused
        local = self.tp.shard(per, "output features a fused part")
        self.full_shape = ((in_features, features) if n_fused == 1
                           else (in_features, n_fused, per))
        shape = ((in_features, local) if n_fused == 1
                 else (in_features, n_fused, local))
        pdt = param_dtype or dtype
        self.kernel = set_tp_layout(_kernel(shape, pdt, device), self.tp)
        self.bias = (set_tp_layout(_kernel(shape[1:], pdt, device), self.tp)
                     if use_bias else None)

    def reset_parameters(self, generator=None) -> None:
        init_normal_(self.kernel, 1.0 / math.sqrt(self.kernel.shape[0]),
                     generator, self.full_shape, self.kernel.ndim - 1,
                     self.tp)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor,
                sequence_parallel: Optional[bool] = None) -> torch.Tensor:
        x = x.to(self.dtype)
        if _sp(self, sequence_parallel):
            # x holds this rank's sequence slice: the whole sequence in,
            # its gradient reduce-scattered back
            x = gather_from_sequence_parallel_region(x, x.ndim - 2, True,
                                                     self.tp.group)
        elif self.tp.size > 1:
            x = copy_to_tensor_parallel_region(x, self.tp.group)
        w = self.kernel.reshape(self.kernel.shape[0], -1).to(self.dtype)
        y = torch.matmul(x, w).reshape(*x.shape[:-1], *self.kernel.shape[1:])
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        if self.gather_output and self.tp.size > 1:
            y = gather_from_tensor_parallel_region(y, self.tp.group)
        return y


class _MatmulFp32(torch.autograd.Function):
    """``torch.mm(out_dtype=float32)`` (which has no derivative) with its
    backward in the operands' type.  The gradient reaching the fp32 output
    is the upcast of a compute-type gradient (the output is rounded to the
    compute type once, after the reduce), so casting it back is exact and
    ``dx``, ``dw`` are the tp = 1 products."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = torch.matmul(g, w.t()) if ctx.needs_input_grad[0] else None
        dw = (torch.mm(x.reshape(-1, x.shape[-1]).t(),
                       g.reshape(-1, g.shape[-1]))
              if ctx.needs_input_grad[1] else None)
        return dx, dw


def _matmul_fp32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with an fp32 result: bf16/fp16 operands on CUDA keep the
    tensor-core product and write its fp32 accumulator
    (``torch.mm(out_dtype=)``, differentiable through
    :class:`_MatmulFp32`); elsewhere the operands are widened."""
    if x.dtype == torch.float32:
        return torch.matmul(x, w)
    if x.is_cuda:
        return _MatmulFp32.apply(x, w)
    return torch.matmul(x.float(), w.float())


class RowParallelLinear(nn.Module):
    """``y = all_reduce(x_shard @ kernel_shard) (+ bias)``: the input
    arrives sharded on its last dim (a column layer's output), and the
    bias is added once, after the reduce.  At tp > 1 the partial sums are
    reduced in fp32 and rounded once to the compute type, as the tp = 1
    product is rounded once: a bf16 partial rounded on every rank, then
    its sum rounded again, drifts from tp = 1 by the rounding of every
    layer (2.1e-2 relative L2 on Llama-3-8B's bf16 prefill logits against
    1.8e-2 reduced in fp32, NVIDIA H100 80GB HBM3 at 700 W, PERF.md)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 param_dtype: Optional[torch.dtype] = None,
                 sequence_parallel: bool = False, head_blocks: bool = False):
        super().__init__()
        self.tp = TensorParallel.current()
        self.dtype = dtype
        self.sequence_parallel = sequence_parallel
        # the input rows in q-head blocks (an attention output at kvr > 1,
        # JAX ``input_partition_axes=Q_HEAD_AXES``), else in rank order
        self.block = self.tp.q_block if head_blocks else self.tp.rank
        self.full_shape = (in_features, features)
        pdt = param_dtype or dtype
        self.kernel = set_tp_layout(_kernel(
            (self.tp.shard(in_features, "input features"), features), pdt,
            device), self.tp)
        self.bias = (set_tp_layout(_kernel((features,), pdt, device), self.tp,
                                   None, sequence_parallel)
                     if use_bias else None)

    def reset_parameters(self, generator=None) -> None:
        init_normal_(self.kernel, 1.0 / math.sqrt(self.full_shape[0]),
                     generator, self.full_shape, 0, self.tp, self.block)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor,
                sequence_parallel: Optional[bool] = None) -> torch.Tensor:
        x, w = x.to(self.dtype), self.kernel.to(self.dtype)
        if self.tp.size == 1:
            y = torch.matmul(x, w)
        elif _sp(self, sequence_parallel):
            y = reduce_scatter_to_sequence_parallel_region(
                _matmul_fp32(x, w), x.ndim - 2, self.tp.group).to(self.dtype)
        else:
            y = reduce_from_tensor_parallel_region(_matmul_fp32(x, w),
                                                   self.tp.group)
            y = y.to(self.dtype)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class ParallelEmbedding(nn.Module):
    """Vocab-sharded embedding table: this rank holds rows ``[rank * V /
    tp, (rank + 1) * V / tp)``."""

    def __init__(self, num_embeddings: int, features: int,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 param_dtype: Optional[torch.dtype] = None,
                 sequence_parallel_output: bool = False):
        super().__init__()
        self.tp = TensorParallel.current()
        self.dtype = dtype
        self.sequence_parallel = sequence_parallel_output
        self.full_shape = (num_embeddings, features)
        local = self.tp.shard(num_embeddings, "vocabulary")
        self.vocab_start = self.tp.rank * local
        self.embedding = set_tp_layout(_kernel(
            (local, features), param_dtype or dtype, device), self.tp)

    def reset_parameters(self, generator=None) -> None:
        init_normal_(self.embedding, 0.02, generator, self.full_shape, 0,
                     self.tp)

    def forward(self, ids: torch.Tensor,
                sequence_parallel: Optional[bool] = None) -> torch.Tensor:
        """``[..., S] -> [..., S, H]``, or this rank's sequence slice ``[...,
        S / tp, H]`` under sequence parallelism (the model's first SP
        region)."""
        # gather, then cast: the same values as flax's cast-then-take, with
        # the table's gradient scattered in param_dtype
        if self.tp.size == 1:
            return self.embedding[ids].to(self.dtype)
        local = ids - self.vocab_start
        outside = (local < 0) | (local >= self.embedding.shape[0])
        rows = self.embedding[torch.where(outside, 0, local)].to(self.dtype)
        rows = rows.masked_fill(outside[..., None], 0)
        # each id's row lives on one rank: the others add exact zeros
        if _sp(self, sequence_parallel):
            return reduce_scatter_to_sequence_parallel_region(
                rows, rows.ndim - 2, self.tp.group)
        return reduce_from_tensor_parallel_region(rows, self.tp.group)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """The tied LM head: ``[..., H] -> [..., V / tp]`` (this rank's
        vocab slice) against the same table, in the compute type; its
        gradient adds to the lookup's in the one ``embedding``
        parameter."""
        x = x.to(self.dtype)
        if self.tp.size > 1:
            x = copy_to_tensor_parallel_region(x, self.tp.group)
        return torch.matmul(x, self.embedding.to(self.dtype).t())
