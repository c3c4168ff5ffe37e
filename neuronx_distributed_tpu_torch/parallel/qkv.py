"""GQA QKV projection (counterpart of
``neuronx_distributed_tpu/parallel/qkv.py``) at tp=1, kv_size_multiplier=1.

Kernels keep the JAX layout ``q_kernel [H, NQ, D]``, ``k_kernel`` and
``v_kernel [H, NKV, D]``, with optional ``{q,k,v}_bias [heads, D]``, held in
``param_dtype`` (default ``dtype``) and cast to ``dtype`` at each matmul.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from neuronx_distributed_tpu_torch.parallel.layers import _kernel, init_normal_


class GQAQKVColumnParallelLinear(nn.Module):
    def __init__(self, in_features: int, num_heads: int, num_kv_heads: int,
                 head_dim: int, use_bias: bool = False,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if num_heads % num_kv_heads:
            raise ValueError(f"num_heads={num_heads} not divisible by "
                             f"num_kv_heads={num_kv_heads}")
        self.dtype = dtype
        pdt = param_dtype or dtype
        self.q_kernel = _kernel((in_features, num_heads, head_dim), pdt,
                                device)
        self.k_kernel = _kernel((in_features, num_kv_heads, head_dim), pdt,
                                device)
        self.v_kernel = _kernel((in_features, num_kv_heads, head_dim), pdt,
                                device)
        self.use_bias = use_bias
        if use_bias:
            self.q_bias = _kernel((num_heads, head_dim), pdt, device)
            self.k_bias = _kernel((num_kv_heads, head_dim), pdt, device)
            self.v_bias = _kernel((num_kv_heads, head_dim), pdt, device)

    def reset_parameters(self, generator=None) -> None:
        std = 1.0 / math.sqrt(self.q_kernel.shape[0])
        for w in (self.q_kernel, self.k_kernel, self.v_kernel):
            init_normal_(w, std, generator)
        if self.use_bias:
            for b in (self.q_bias, self.k_bias, self.v_bias):
                nn.init.zeros_(b)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = x.to(self.dtype)
        lead = x.shape[:-1]

        def proj(w):
            return torch.matmul(x, w.reshape(w.shape[0], -1).to(
                self.dtype)).reshape(*lead, *w.shape[1:])

        q, k, v = proj(self.q_kernel), proj(self.k_kernel), proj(self.v_kernel)
        if self.use_bias:
            q, k, v = (q + self.q_bias.to(self.dtype),
                       k + self.k_bias.to(self.dtype),
                       v + self.v_bias.to(self.dtype))
        return q, k, v
