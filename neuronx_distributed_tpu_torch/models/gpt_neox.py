"""GPT-NeoX for training, in PyTorch (counterpart of
``neuronx_distributed_tpu/models/gpt_neox.py``).

HF ``GPTNeoXForCausalLM``'s architecture: parallel residual (``x +
attn(ln_1(x)) + mlp(ln_2(x))``, or the serial form), partial rotary
embeddings (the first ``rotary_pct`` of each head's dims rotate), LayerNorm
with bias, biased linears with an erf GELU, and an untied, bias-free
``embed_out`` head.  The attention core is :func:`.common.dense_mha`, as in
the JAX package (head_dim 96 at 20B is none of the flash kernels' widths).

The module tree follows the JAX param tree (``embed_in.embedding``,
``layer_i.attn.qkv.kernel [H, 3, H]``, ``layer_i.ln_1.weight``,
``final_norm.bias``, ``embed_out.kernel``), so
:func:`..convert.jax_params.gpt_neox_params_from_jax` is a flatten plus a
shape check.  ``hidden``/``head`` serve the chunked loss head
(:func:`.common.make_causal_lm_loss_sum`); ``remat`` applies per block when
gradients are on.  At tp > 1 each layer holds its shard (heads, MLP
columns, vocab rows) and :meth:`GPTNeoXForCausalLM.gather_logits` joins the
head's vocab slices; it trains there too.  ``sequence_parallel`` (JAX's
default on) runs the residual stream and the LayerNorms on a rank's
sequence slice (:func:`.common.sequence_parallel_active`); the pipelined
build waits for A15.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from neuronx_distributed_tpu_torch.models.common import (
    dense_mha,
    maybe_remat,
    sequence_parallel_active,
)
from neuronx_distributed_tpu_torch.models.llama import apply_rope, rope_sin_cos
from neuronx_distributed_tpu_torch.parallel.layers import (
    ColumnParallelLinear,
    ParallelEmbedding,
    RowParallelLinear,
)
from neuronx_distributed_tpu_torch.parallel.mappings import (
    gather_from_sequence_parallel_region,
    gather_from_tensor_parallel_region,
)
from neuronx_distributed_tpu_torch.parallel.mesh import TensorParallel
from neuronx_distributed_tpu_torch.parallel.norm import LayerNorm
from neuronx_distributed_tpu_torch.utils.device import resolve_device

PIPELINE_DEFERRED = ("the pipelined GPT-NeoX is not ported yet (ROADMAP A15, "
                     "the pipeline engines)")


@dataclasses.dataclass(frozen=True)
class GPTNeoXConfig:
    """The JAX ``GPTNeoXConfig``.  Defaults are GPT-NeoX-20B.  ``dtype`` is the compute type,
    ``param_dtype`` the weights' (fp32 masters, as JAX)."""

    vocab_size: int = 50432
    hidden_size: int = 6144
    intermediate_size: int = 24576
    num_layers: int = 44
    num_heads: int = 64
    max_seq_len: int = 2048
    rotary_pct: float = 0.25
    rope_theta: float = 10000.0
    ln_eps: float = 1e-5
    use_parallel_residual: bool = True
    sequence_parallel: bool = True
    remat: str = "selective"  # none | selective | full
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.remat not in ("none", "selective", "full"):
            raise ValueError(f"unknown remat mode {self.remat!r}")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def neox_20b(**overrides) -> "GPTNeoXConfig":
        """EleutherAI/gpt-neox-20b."""
        return GPTNeoXConfig(**overrides)

    @staticmethod
    def neox_6_9b(**overrides) -> "GPTNeoXConfig":
        return GPTNeoXConfig(**{**dict(
            hidden_size=4096, intermediate_size=16384, num_layers=32,
            num_heads=32), **overrides})

    @staticmethod
    def tiny(**overrides) -> "GPTNeoXConfig":
        """Test-scale config."""
        return GPTNeoXConfig(**{**dict(
            vocab_size=256, hidden_size=64, intermediate_size=256,
            num_layers=2, num_heads=8, max_seq_len=128), **overrides})


def apply_partial_rope(x: torch.Tensor, positions: torch.Tensor,
                       rotary_pct: float, theta: float) -> torch.Tensor:
    """Rotate only the first ``int(D * rotary_pct)`` dims of each head of
    ``x [B, S, n, D]`` (HF GPT-NeoX convention); the rest pass through."""
    rot = int(x.shape[-1] * rotary_pct)
    if rot == 0:
        return x
    sin, cos = rope_sin_cos(positions, rot, theta)
    return torch.cat([apply_rope(x[..., :rot], sin, cos), x[..., rot:]],
                     dim=-1)


class GPTNeoXAttention(nn.Module):
    """Fused biased QKV (column), partial RoPE, the causal dense core over
    this rank's heads, then the biased ``dense`` row projection."""

    def __init__(self, cfg: GPTNeoXConfig, device=None):
        super().__init__()
        self.config = cfg
        H, sp = cfg.hidden_size, cfg.sequence_parallel
        self.qkv = ColumnParallelLinear(H, 3 * H, use_bias=True, n_fused=3,
                                        dtype=cfg.dtype, device=device,
                                        param_dtype=cfg.param_dtype,
                                        sequence_parallel=sp)
        self.heads = self.qkv.tp.shard(cfg.num_heads, "attention heads")
        self.dense = RowParallelLinear(H, H, use_bias=True, dtype=cfg.dtype,
                                       device=device,
                                       param_dtype=cfg.param_dtype,
                                       sequence_parallel=sp)

    def reset_parameters(self, generator=None) -> None:
        self.qkv.reset_parameters(generator)
        self.dense.reset_parameters(generator)

    def forward(self, x, positions, sp: bool = False):
        cfg = self.config
        qkv = self.qkv(x, sp)   # [B, S, 3, H / tp], the whole sequence
        B, S = qkv.shape[:2]
        q, k, v = (qkv[..., i, :].reshape(B, S, self.heads, cfg.head_dim)
                   for i in range(3))
        q = apply_partial_rope(q, positions, cfg.rotary_pct, cfg.rope_theta)
        k = apply_partial_rope(k, positions, cfg.rotary_pct, cfg.rope_theta)
        out = dense_mha(q, k, v, causal=True)
        return self.dense(out.reshape(B, S, self.heads * cfg.head_dim), sp)


class GPTNeoXMLP(nn.Module):
    def __init__(self, cfg: GPTNeoXConfig, device=None):
        super().__init__()
        H, I, sp = cfg.hidden_size, cfg.intermediate_size, cfg.sequence_parallel
        self.dense_h_to_4h = ColumnParallelLinear(
            H, I, use_bias=True, dtype=cfg.dtype, device=device,
            param_dtype=cfg.param_dtype, sequence_parallel=sp)
        self.dense_4h_to_h = RowParallelLinear(
            I, H, use_bias=True, dtype=cfg.dtype, device=device,
            param_dtype=cfg.param_dtype, sequence_parallel=sp)

    def reset_parameters(self, generator=None) -> None:
        self.dense_h_to_4h.reset_parameters(generator)
        self.dense_4h_to_h.reset_parameters(generator)

    def forward(self, x, sp: bool = False):
        # HF-exact erf GELU (checkpoint parity)
        return self.dense_4h_to_h(F.gelu(self.dense_h_to_4h(x, sp),
                                         approximate="none"), sp)


def _layer_norm(cfg: GPTNeoXConfig, device) -> LayerNorm:
    """A LayerNorm of the residual stream (on sequence shards under
    sequence parallelism)."""
    return LayerNorm(cfg.hidden_size, cfg.ln_eps, dtype=cfg.dtype,
                     param_dtype=cfg.param_dtype, device=device,
                     sequence_parallel=cfg.sequence_parallel)


class GPTNeoXBlock(nn.Module):
    def __init__(self, cfg: GPTNeoXConfig, device=None):
        super().__init__()
        self.config = cfg
        self.ln_1 = _layer_norm(cfg, device)
        self.attn = GPTNeoXAttention(cfg, device)
        self.ln_2 = _layer_norm(cfg, device)
        self.mlp = GPTNeoXMLP(cfg, device)

    def forward(self, x, positions, sp: bool = False):
        attn_out = self.attn(self.ln_1(x), positions, sp)
        if self.config.use_parallel_residual:
            # x + attn(ln_1(x)) + mlp(ln_2(x)), HF GPT-NeoX's parallel form
            return x + attn_out + self.mlp(self.ln_2(x), sp)
        x = x + attn_out
        return x + self.mlp(self.ln_2(x), sp)


class GPTNeoXForCausalLM(nn.Module):
    """Causal LM: ``forward(ids, positions=None) -> logits`` (this rank's
    vocab slice).  ``device`` defaults to CUDA (raises without it);
    parameters are created uninitialized -- load a state dict or call
    :meth:`init_random`."""

    def __init__(self, cfg: GPTNeoXConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.config = cfg
        self.tp = TensorParallel.current()
        self.embed_in = ParallelEmbedding(
            cfg.vocab_size, cfg.hidden_size, cfg.dtype, device,
            cfg.param_dtype, sequence_parallel_output=cfg.sequence_parallel)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", GPTNeoXBlock(cfg, device))
        self.final_norm = _layer_norm(cfg, device)
        self.embed_out = ColumnParallelLinear(
            cfg.hidden_size, cfg.vocab_size, use_bias=False, dtype=cfg.dtype,
            device=device, param_dtype=cfg.param_dtype)

    def layers(self) -> List[GPTNeoXBlock]:
        return [getattr(self, f"layer_{i}")
                for i in range(self.config.num_layers)]

    def build_pipelined(self, *args, **kwargs):
        raise NotImplementedError(PIPELINE_DEFERRED)

    @torch.no_grad()
    def init_random(self, seed: int) -> "GPTNeoXForCausalLM":
        """Random weights from one seeded generator on the parameters'
        device: kernels ~ N(0, 1/fan_in), embedding ~ N(0, 0.02^2), biases
        0, norms 1 and 0."""
        g = torch.Generator(device=self.embed_out.kernel.device)
        g.manual_seed(seed)
        self.embed_in.reset_parameters(g)
        for block in self.layers():
            block.attn.reset_parameters(g)
            block.mlp.reset_parameters(g)
        self.embed_out.reset_parameters(g)
        for m in self.modules():
            if isinstance(m, LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        return self

    def forward(self, ids, positions=None):
        return self.head(self.hidden(ids, positions))

    def hidden(self, ids, positions=None):
        """Backbone: final-norm hidden states ``[B, S, H]`` (the sequence
        gathered back from sequence parallelism), the input the chunked
        loss head consumes."""
        sp = sequence_parallel_active(self.config.sequence_parallel,
                                      self.tp, ids.shape[1])
        if positions is None:
            positions = torch.arange(ids.shape[1], device=ids.device
                                     ).expand(ids.shape)
        h = self.embed_in(ids, sp)
        remat = self.config.remat if torch.is_grad_enabled() else "none"
        for block in self.layers():
            h = maybe_remat(lambda x, p, blk=block: blk(x, p, sp),
                            remat)(h, positions)
        h = self.final_norm(h)
        if sp:
            h = gather_from_sequence_parallel_region(h, 1, False,
                                                     self.tp.group)
        return h

    def head(self, h):
        """Logits for a (chunk of) hidden states: this rank's vocab slice
        ``[..., V / tp]``."""
        return self.embed_out(h)

    def gather_logits(self, logits):
        """The full vocab ``[..., V]`` from every rank's slice (the
        identity at tp = 1)."""
        if self.tp.size == 1:
            return logits
        return gather_from_tensor_parallel_region(logits, self.tp.group)


def build_pipelined_gpt_neox(*args, **kwargs):
    raise NotImplementedError(PIPELINE_DEFERRED)
