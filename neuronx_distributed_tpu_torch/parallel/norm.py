"""RMSNorm (counterpart of ``neuronx_distributed_tpu/parallel/norm.py``).

Computes in fp32 whatever the input type and returns the model's compute
type; the weight is held in ``param_dtype`` (fp32 by default, as the JAX
package keeps its fp32 params).
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
