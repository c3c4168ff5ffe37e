"""RMSNorm and LayerNorm (counterpart of
``neuronx_distributed_tpu/parallel/norm.py``).

Both compute in fp32 whatever the input type and return the model's
compute type; the weight (and LayerNorm's bias) is held in ``param_dtype``
(fp32 by default, as the JAX package keeps its fp32 params).  LayerNorm is
written out rather than ``F.layer_norm``: BERT's eps is 1e-12, below the
resolution of a bf16 variance, so the statistics must be fp32 exactly as
the JAX package takes them (mean, biased variance, ``rsqrt(var + eps)``).
"""

from __future__ import annotations

import torch
from torch import nn


class RMSNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-6,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.ones(features, dtype=param_dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + self.eps)
        return (y * self.weight.float()).to(self.dtype)


class LayerNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-5, use_bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.ones(features, dtype=param_dtype, device=device))
        self.bias = (nn.Parameter(torch.zeros(features, dtype=param_dtype,
                                              device=device))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps) * self.weight.float()
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(self.dtype)
