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
    gather_from_tensor_parallel_region,
    reduce_from_tensor_parallel_region,
)
from neuronx_distributed_tpu_torch.parallel.mesh import TensorParallel


def _kernel(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


def init_normal_(p: torch.Tensor, std: float, generator=None,
                 full_shape: Optional[Sequence[int]] = None, dim: int = 0,
                 tp: Optional[TensorParallel] = None) -> None:
    """``p ~ N(0, std^2)`` from ``generator``.  A shard (``tp.size > 1``)
    draws the whole ``full_shape`` tensor and keeps its slice along
    ``dim``, so the generator advances as at tp = 1 and the values are the
    tp = 1 tensor's."""
    with torch.no_grad():
        if tp is None or tp.size == 1:
            p.normal_(0.0, std, generator=generator)
            return
        full = torch.empty(tuple(full_shape), dtype=p.dtype, device=p.device)
        full.normal_(0.0, std, generator=generator)
        n = p.shape[dim]
        p.copy_(full.narrow(dim, tp.rank * n, n))


class ColumnParallelLinear(nn.Module):
    """``y = x @ kernel (+ bias)`` over this rank's output features; with
    ``n_fused > 1`` the output is ``[..., n_fused, features // n_fused /
    tp]`` (the fused gate-up layout).  ``gather_output`` all-gathers the
    full feature dim."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 n_fused: int = 1, dtype: torch.dtype = torch.bfloat16,
                 device=None, param_dtype: Optional[torch.dtype] = None,
                 gather_output: bool = False):
        super().__init__()
        if features % n_fused:
            raise ValueError(f"{features} features do not split into "
                             f"{n_fused} fused parts")
        self.tp = TensorParallel.current()
        self.n_fused = n_fused
        self.dtype = dtype
        self.gather_output = gather_output
        per = features // n_fused
        local = self.tp.shard(per, "output features a fused part")
        self.full_shape = ((in_features, features) if n_fused == 1
                           else (in_features, n_fused, per))
        shape = ((in_features, local) if n_fused == 1
                 else (in_features, n_fused, local))
        pdt = param_dtype or dtype
        self.kernel = _kernel(shape, pdt, device)
        self.bias = (_kernel(shape[1:], pdt, device) if use_bias else None)

    def reset_parameters(self, generator=None) -> None:
        init_normal_(self.kernel, 1.0 / math.sqrt(self.kernel.shape[0]),
                     generator, self.full_shape, self.kernel.ndim - 1,
                     self.tp)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.tp.size > 1:
            x = copy_to_tensor_parallel_region(x, self.tp.group)
        w = self.kernel.reshape(self.kernel.shape[0], -1).to(self.dtype)
        y = torch.matmul(x, w).reshape(*x.shape[:-1], *self.kernel.shape[1:])
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        if self.gather_output and self.tp.size > 1:
            y = gather_from_tensor_parallel_region(y, self.tp.group)
        return y


def _matmul_fp32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with an fp32 result: bf16/fp16 operands on CUDA keep the
    tensor-core product and write its fp32 accumulator
    (``torch.mm(out_dtype=)``); elsewhere the operands are widened."""
    if x.dtype == torch.float32:
        return torch.matmul(x, w)
    if x.is_cuda:
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[-1])
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
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.tp = TensorParallel.current()
        self.dtype = dtype
        self.full_shape = (in_features, features)
        pdt = param_dtype or dtype
        self.kernel = _kernel((self.tp.shard(in_features, "input features"),
                               features), pdt, device)
        self.bias = _kernel((features,), pdt, device) if use_bias else None

    def reset_parameters(self, generator=None) -> None:
        init_normal_(self.kernel, 1.0 / math.sqrt(self.full_shape[0]),
                     generator, self.full_shape, 0, self.tp)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w = x.to(self.dtype), self.kernel.to(self.dtype)
        if self.tp.size == 1:
            y = torch.matmul(x, w)
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
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.tp = TensorParallel.current()
        self.dtype = dtype
        self.full_shape = (num_embeddings, features)
        local = self.tp.shard(num_embeddings, "vocabulary")
        self.vocab_start = self.tp.rank * local
        self.embedding = _kernel((local, features), param_dtype or dtype,
                                 device)

    def reset_parameters(self, generator=None) -> None:
        init_normal_(self.embedding, 0.02, generator, self.full_shape, 0,
                     self.tp)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        # gather, then cast: the same values as flax's cast-then-take, with
        # the table's gradient scattered in param_dtype
        if self.tp.size == 1:
            return self.embedding[ids].to(self.dtype)
        local = ids - self.vocab_start
        outside = (local < 0) | (local >= self.embedding.shape[0])
        rows = self.embedding[torch.where(outside, 0, local)].to(self.dtype)
        rows = rows.masked_fill(outside[..., None], 0)
        # each id's row lives on one rank: the others add exact zeros
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
