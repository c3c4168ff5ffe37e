"""Linear and embedding layers (counterpart of
``neuronx_distributed_tpu/parallel/layers.py``) at tensor-parallel degree 1.

Parameters keep the JAX package's names and layouts so a JAX param tree
loads by path: ``kernel [in, out]`` (``[in, n_fused, out / n_fused]`` for a
fused projection), ``bias``, ``embedding [V, H]``.  Weights are stored in
``param_dtype`` (default: the compute ``dtype``, as serving holds them) and
cast to ``dtype`` at each matmul and embedding lookup, as flax does with
the JAX package's fp32 masters; training keeps fp32 masters.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


def _kernel(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


def init_normal_(p: torch.Tensor, std: float, generator=None) -> None:
    with torch.no_grad():
        p.normal_(0.0, std, generator=generator)


class ColumnParallelLinear(nn.Module):
    """``y = x @ kernel (+ bias)``; with ``n_fused > 1`` the output is
    ``[..., n_fused, features // n_fused]`` (the fused gate-up layout)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 n_fused: int = 1, dtype: torch.dtype = torch.bfloat16,
                 device=None, param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if features % n_fused:
            raise ValueError(f"{features} features do not split into "
                             f"{n_fused} fused parts")
        self.n_fused = n_fused
        self.dtype = dtype
        shape = ((in_features, features) if n_fused == 1
                 else (in_features, n_fused, features // n_fused))
        pdt = param_dtype or dtype
        self.kernel = _kernel(shape, pdt, device)
        self.bias = (_kernel(shape[1:], pdt, device) if use_bias else None)

    def reset_parameters(self, generator=None) -> None:
        init_normal_(self.kernel, 1.0 / math.sqrt(self.kernel.shape[0]),
                     generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        w = self.kernel.reshape(self.kernel.shape[0], -1).to(self.dtype)
        y = torch.matmul(x, w).reshape(*x.shape[:-1], *self.kernel.shape[1:])
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class RowParallelLinear(nn.Module):
    """``y = x @ kernel (+ bias)`` over the input-sharded kernel; at tp=1
    there is no partial sum to reduce."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        pdt = param_dtype or dtype
        self.kernel = _kernel((in_features, features), pdt, device)
        self.bias = _kernel((features,), pdt, device) if use_bias else None

    def reset_parameters(self, generator=None) -> None:
        init_normal_(self.kernel, 1.0 / math.sqrt(self.kernel.shape[0]),
                     generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x.to(self.dtype), self.kernel.to(self.dtype))
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class ParallelEmbedding(nn.Module):
    """Embedding table ``[V, H]`` (vocab-sharded in the JAX package)."""

    def __init__(self, num_embeddings: int, features: int,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.embedding = _kernel((num_embeddings, features),
                                 param_dtype or dtype, device)

    def reset_parameters(self, generator=None) -> None:
        init_normal_(self.embedding, 0.02, generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        # gather, then cast: the same values as flax's cast-then-take, with
        # the table's gradient scattered in param_dtype
        return self.embedding[ids].to(self.dtype)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """The tied LM head: ``[..., H] -> [..., V]`` against the same
        table, in the compute type; its gradient adds to the lookup's in
        the one ``embedding`` parameter."""
        return torch.matmul(x.to(self.dtype), self.embedding.to(self.dtype).t())
