"""GQA QKV projection (counterpart of
``neuronx_distributed_tpu/parallel/qkv.py``) at any tensor-parallel degree
with ``kv_size_multiplier = 1``.

Kernels keep the JAX layout ``q_kernel [H, NQ, D]``, ``k_kernel`` and
``v_kernel [H, NKV, D]``, with optional ``{q,k,v}_bias [heads, D]``, held in
``param_dtype`` (default ``dtype``) and cast to ``dtype`` at each matmul.
A rank holds the contiguous head blocks ``NQ / tp`` and ``NKV / tp`` of
its tensor-parallel index (the JAX specs shard heads over ``('tp',
'kvr')`` and ``'tp'``, which at ``kvr = 1`` are the same blocks), so its q
heads are exactly the q heads of its kv heads and attention needs no
communication.  KV replication over ``kvr > 1`` comes with the training
layers (ROADMAP A9c, with A11) and raises here.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from neuronx_distributed_tpu_torch.parallel import mesh
from neuronx_distributed_tpu_torch.parallel.layers import _kernel, init_normal_
from neuronx_distributed_tpu_torch.parallel.mappings import (
    copy_to_tensor_parallel_region,
)
from neuronx_distributed_tpu_torch.parallel.mesh import TensorParallel


def validate_gqa_sharding(num_heads: int, num_kv_heads: int) -> None:
    """Check head counts against the live layout, guiding the choice of
    ``kv_size_multiplier`` (the JAX package's check, word for word)."""
    if not mesh.model_parallel_is_initialized():
        return
    tp_full = mesh.get_tensor_parallel_size()
    kvr = mesh.get_kv_size_multiplier()
    tp_inner = tp_full // kvr
    if num_heads % tp_full != 0:
        raise ValueError(f"num_heads={num_heads} not divisible by TP degree "
                         f"{tp_full}")
    if num_kv_heads % tp_inner != 0:
        raise ValueError(
            f"num_kv_heads={num_kv_heads} not divisible by tp={tp_inner} (= "
            f"TP degree {tp_full} / kv_size_multiplier {kvr}); initialize the "
            f"mesh with kv_size_multiplier="
            f"{tp_full // num_kv_heads if num_kv_heads and tp_full % num_kv_heads == 0 else '<tp/num_kv_heads>'}")


class GQAQKVColumnParallelLinear(nn.Module):
    def __init__(self, in_features: int, num_heads: int, num_kv_heads: int,
                 head_dim: int, use_bias: bool = False,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if num_heads % num_kv_heads:
            raise ValueError(f"num_heads={num_heads} not divisible by "
                             f"num_kv_heads={num_kv_heads}")
        self.tp = TensorParallel.current()
        if self.tp.size > 1:
            if mesh.get_kv_size_multiplier() > 1:
                raise NotImplementedError(
                    f"kv_size_multiplier={mesh.get_kv_size_multiplier()}: KV "
                    "replication over kvr is not ported yet (ROADMAP A9c, "
                    "with A11)")
            validate_gqa_sharding(num_heads, num_kv_heads)
        self.dtype = dtype
        pdt = param_dtype or dtype
        nq = self.tp.shard(num_heads, "q heads")
        nkv = self.tp.shard(num_kv_heads, "kv heads")
        self.full_shapes = {"q": (in_features, num_heads, head_dim),
                            "k": (in_features, num_kv_heads, head_dim),
                            "v": (in_features, num_kv_heads, head_dim)}
        self.q_kernel = _kernel((in_features, nq, head_dim), pdt, device)
        self.k_kernel = _kernel((in_features, nkv, head_dim), pdt, device)
        self.v_kernel = _kernel((in_features, nkv, head_dim), pdt, device)
        self.use_bias = use_bias
        if use_bias:
            self.q_bias = _kernel((nq, head_dim), pdt, device)
            self.k_bias = _kernel((nkv, head_dim), pdt, device)
            self.v_bias = _kernel((nkv, head_dim), pdt, device)

    def reset_parameters(self, generator=None) -> None:
        std = 1.0 / math.sqrt(self.q_kernel.shape[0])
        for name in ("q", "k", "v"):
            init_normal_(getattr(self, f"{name}_kernel"), std, generator,
                         self.full_shapes[name], 1, self.tp)
        if self.use_bias:
            for b in (self.q_bias, self.k_bias, self.v_bias):
                nn.init.zeros_(b)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = x.to(self.dtype)
        if self.tp.size > 1:
            x = copy_to_tensor_parallel_region(x, self.tp.group)
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
