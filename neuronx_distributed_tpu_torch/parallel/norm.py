"""RMSNorm and LayerNorm (counterpart of
``neuronx_distributed_tpu/parallel/norm.py``).

Both compute in fp32 whatever the input type and return the model's
compute type; the weight (and LayerNorm's bias) is held in ``param_dtype``
(fp32 by default, as the JAX package keeps its fp32 params).  LayerNorm is
written out rather than ``F.layer_norm``: BERT's eps is 1e-12, below the
resolution of a bf16 variance, so the statistics must be fp32 exactly as
the JAX package takes them (mean, biased variance, ``rsqrt(var + eps)``).

A norm built with ``sequence_parallel=True`` inside a tensor-parallel
context acts on this rank's sequence slice: its weight (and bias) stay
replicated, but each rank's gradient covers only its slice, so they are
marked ``sequence_parallel`` and summed over the group before clipping
(:func:`.grads.allreduce_sequence_parallel_gradients`).
"""

from __future__ import annotations

import torch
from torch import nn

from neuronx_distributed_tpu_torch.parallel.layers import set_tp_layout
from neuronx_distributed_tpu_torch.parallel.mesh import TensorParallel


def _mark(module: nn.Module, sequence_parallel: bool) -> None:
    if sequence_parallel:
        tp = TensorParallel.current()
        for p in module.parameters():
            set_tp_layout(p, tp, None, True)


class RMSNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-6,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 param_dtype: torch.dtype = torch.float32,
                 sequence_parallel: bool = False):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.ones(features, dtype=param_dtype, device=device))
        _mark(self, sequence_parallel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + self.eps)
        return (y * self.weight.float()).to(self.dtype)


class LayerNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-5, use_bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32, device=None,
                 sequence_parallel: bool = False):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.ones(features, dtype=param_dtype, device=device))
        self.bias = (nn.Parameter(torch.zeros(features, dtype=param_dtype,
                                              device=device))
                     if use_bias else None)
        _mark(self, sequence_parallel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps) * self.weight.float()
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(self.dtype)
