"""GQA QKV projection (counterpart of
``neuronx_distributed_tpu/parallel/qkv.py``) at any tensor-parallel degree
and KV replication ``kv_size_multiplier``.

Kernels keep the JAX layout ``q_kernel [H, NQ, D]``, ``k_kernel`` and
``v_kernel [H, NKV, D]``, with optional ``{q,k,v}_bias [heads, D]``, held in
``param_dtype`` (default ``dtype``) and cast to ``dtype`` at each matmul.
The full degree factors as ``kvr x tp`` (:mod:`.mesh`).  Q heads shard
over ``('tp', 'kvr')``, tp-major: rank ``(kvr = o, tp = i)`` holds q-head
block ``i * kvr + o`` of ``NQ / (kvr tp)`` heads
(:attr:`.mesh.TensorParallel.q_block`); K/V heads shard over ``'tp'``
only, block ``i`` of ``NKV / tp`` heads, replicated along kvr.  So a
rank's q heads are exactly q heads of its kv heads and attention needs no
communication; at ``kvr = 1`` both blocks are the rank's index.

With ``T = kvr x tp``, q block ``b`` covers global q heads ``[b NQ / T,
(b + 1) NQ / T)``, which read kv heads ``[b NKV / T, (b + 1) NKV / T)``
(one kv head when ``NKV < T``): at ``kvr > 1`` that is a sub-block of
the ``NKV / tp`` kv heads the rank holds.  :attr:`kv_heads` is that
sub-block, and the projection uses those kv heads only, so attention
pairs q head ``j`` with local kv head ``j // G`` as at tp = 1 (e.g.
Llama-3-8B at kvr = 2, tp = 1: a rank's 16 q heads on 4 of its 8 kv
heads, G = 4).  JAX's dense core reaches the same pairing by resharding
q to a kv-major layout instead.

Each kvr replica of a K/V kernel sees only its own q heads' share of the
K/V gradient: the K/V kernels (and biases) are marked ``kv_replicated``,
and the trainer sums their gradients over the kvr group
(:func:`.grads.allreduce_kv_replicated_gradients`; the reference's psum
over its KV-shared group).  Serving at ``kvr > 1`` (the pool and the
engines) is ROADMAP A9c and raises there, not here.

With ``sequence_parallel`` the input is this rank's sequence slice and is
all-gathered before the projection, as in :class:`.layers.
ColumnParallelLinear`.

LoRA (``lora_rank > 0``) on the projections named in ``lora_targets``
(default ``("q", "v")``, JAX's): ``lora_a_{t} [H, r]`` replicated and
``lora_b_{t} [r, heads, D]`` cut like its projection's heads (q blocks
tp-major; k/v blocks replicated along kvr, marked ``kv_replicated``, and
narrowed to :attr:`kv_heads` at kvr > 1), zero at init.  The targets'
``x @ lora_a`` products are concatenated and enter the tensor-parallel
region through one mapping, as in :func:`.layers.lora_branch_input`.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from neuronx_distributed_tpu_torch.parallel import mesh
from neuronx_distributed_tpu_torch.parallel.layers import (
    KV_REPLICATED,
    SHARDED,
    _kernel,
    _sp,
    init_normal_,
    lora_branch_input,
    set_tp_layout,
)
from neuronx_distributed_tpu_torch.parallel.mappings import (
    copy_to_tensor_parallel_region,
    gather_from_sequence_parallel_region,
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
                 param_dtype: Optional[torch.dtype] = None,
                 sequence_parallel: bool = False, lora_rank: int = 0,
                 lora_alpha: float = 16.0,
                 lora_targets: Tuple[str, ...] = ("q", "v")):
        super().__init__()
        if num_heads % num_kv_heads:
            raise ValueError(f"num_heads={num_heads} not divisible by "
                             f"num_kv_heads={num_kv_heads}")
        self.tp = tp = TensorParallel.current()
        if tp.size > 1:
            validate_gqa_sharding(num_heads, num_kv_heads)
        self.dtype = dtype
        self.sequence_parallel = sequence_parallel
        pdt = param_dtype or dtype
        nq = tp.shard(num_heads, "q heads")
        if num_kv_heads % tp.inner:
            raise ValueError(f"kv heads of {num_kv_heads} do not split over "
                             f"tensor-parallel degree {tp.inner}")
        nkv = num_kv_heads // tp.inner
        group = num_heads // num_kv_heads
        if nq % group and group % nq:
            raise ValueError(
                f"{nq} q heads a rank straddle the {group}-head groups of "
                f"{num_kv_heads} kv heads: choose a degree where "
                f"num_kv_heads / tp or tp / num_kv_heads is whole")
        first = tp.q_block * nq // group - tp.kv_block * nkv
        self.kv_heads = (first, max(nq // group, 1))
        self.full_shapes = {"q": (in_features, num_heads, head_dim),
                            "k": (in_features, num_kv_heads, head_dim),
                            "v": (in_features, num_kv_heads, head_dim)}
        kv = KV_REPLICATED if tp.kvr > 1 else SHARDED

        def param(shape, which):
            return set_tp_layout(_kernel(shape, pdt, device), tp,
                                 SHARDED if which == "q" else kv)

        self.q_kernel = param((in_features, nq, head_dim), "q")
        self.k_kernel = param((in_features, nkv, head_dim), "k")
        self.v_kernel = param((in_features, nkv, head_dim), "v")
        self.use_bias = use_bias
        if use_bias:
            self.q_bias = param((nq, head_dim), "q")
            self.k_bias = param((nkv, head_dim), "k")
            self.v_bias = param((nkv, head_dim), "v")
        bad = set(lora_targets) - {"q", "k", "v"}
        if bad:
            raise ValueError(f"unknown QKV LoRA targets {sorted(bad)}")
        self.lora_rank, self.lora_alpha = lora_rank, lora_alpha
        self.lora_targets = tuple(t for t in ("q", "k", "v")
                                  if t in lora_targets) if lora_rank else ()
        self.lora_full = {}
        for t in self.lora_targets:
            a = set_tp_layout(_kernel((in_features, lora_rank), pdt, device),
                              tp, None, sequence_parallel)
            setattr(self, f"lora_a_{t}", a)
            heads = nq if t == "q" else nkv
            setattr(self, f"lora_b_{t}",
                    param((lora_rank, heads, head_dim), t))
            self.lora_full[f"lora_a_{t}"] = ((in_features, lora_rank), 0, 0)

    def reset_parameters(self, generator=None) -> None:
        std = 1.0 / math.sqrt(self.q_kernel.shape[0])
        for name in ("q", "k", "v"):
            block = self.tp.q_block if name == "q" else self.tp.kv_block
            init_normal_(getattr(self, f"{name}_kernel"), std, generator,
                         self.full_shapes[name], 1, self.tp, block)
        if self.use_bias:
            for b in (self.q_bias, self.k_bias, self.v_bias):
                nn.init.zeros_(b)

    def forward(self, x: torch.Tensor,
                sequence_parallel: Optional[bool] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(q, k, v)``: this rank's q heads and the kv heads they read
        (:attr:`kv_heads`)."""
        x = x.to(self.dtype)
        sp = _sp(self, sequence_parallel)
        xa = None
        if self.lora_targets:
            a = torch.cat([getattr(self, f"lora_a_{t}")
                           for t in self.lora_targets], dim=1)
            xa = lora_branch_input(self, x, a, sp).split(self.lora_rank, -1)
            xa = dict(zip(self.lora_targets, xa))
        if sp:
            x = gather_from_sequence_parallel_region(x, x.ndim - 2, True,
                                                     self.tp.group)
        elif self.tp.size > 1:
            x = copy_to_tensor_parallel_region(x, self.tp.group)
        lead = x.shape[:-1]
        first, count = self.kv_heads
        used = ((lambda w, d: w) if count == self.k_kernel.shape[1]
                else (lambda w, d: w.narrow(d, first, count)))

        def proj(w):
            return torch.matmul(x, w.reshape(w.shape[0], -1).to(
                self.dtype)).reshape(*lead, *w.shape[1:])

        def lora(y, t):
            if xa is None or t not in xa:
                return y
            b = getattr(self, f"lora_b_{t}")
            b = b if t == "q" else used(b, 1)
            delta = torch.matmul(xa[t], b.reshape(self.lora_rank, -1).to(
                self.dtype)).reshape(y.shape)
            return y + (self.lora_alpha / self.lora_rank) * delta

        q = lora(proj(self.q_kernel), "q")
        k = lora(proj(used(self.k_kernel, 1)), "k")
        v = lora(proj(used(self.v_kernel, 1)), "v")
        if self.use_bias:
            q, k, v = (q + self.q_bias.to(self.dtype),
                       k + used(self.k_bias, 0).to(self.dtype),
                       v + used(self.v_bias, 0).to(self.dtype))
        return q, k, v
