"""Gemma and Gemma-2 for training and serving, in PyTorch (counterpart of
``neuronx_distributed_tpu/models/gemma.py``): tied-embedding decoders on the
port's Llama attention and MLP.

What differs from Llama:

- **GeGLU MLP**: the block config selects ``mlp_activation="gelu_tanh"``;
- **embedding scaling**: hidden states times ``sqrt(hidden_size)`` right
  after the lookup, the factor cast to the activation type BEFORE the
  multiply (JAX and HF alike: in bf16, sqrt(3072) rounds to 55.5);
- **tied LM head**: logits come from ``ParallelEmbedding.attend``, the same
  table the lookup reads, so both gradients meet in one parameter;
- ``head_dim`` decoupled from ``hidden_size / num_heads`` (256 at 2B);
- Gemma-2 only: **hybrid attention** (even layers slide over a 4096-token
  window, odd layers are global), **attention softcap** ``50·tanh(s/50)``
  inside the attention core or kernel, **final logit softcap**
  ``30·tanh(s/30)`` in fp32 and cast back (in :meth:`head` too, so the
  chunked loss sees it), **sandwich norms** before and after each
  sublayer, and the **decoupled scale** ``query_pre_attn_scalar ** -0.5``.

The module tree follows the JAX param tree (``embed.embedding``,
``layer_i.attn.qkv.q_kernel``, ``layer_i.pre_ffw_norm.weight``,
``final_norm.weight``; no ``model.`` level and no ``lm_head``), so
:func:`..convert.jax_params.gemma_params_from_jax` is a flatten plus a shape
check.  The forward signature is :class:`.llama.LlamaForCausalLM`'s, and the
stack runs through :func:`.llama.run_layers` (one paged-step plan per
forward, remat per block), so the trainer and the serving engine drive
Gemma unchanged.  At tp > 1 the table is vocab-sharded and the tied head
gives each rank its vocab slice, Gemma-2's softcapped in :meth:`head` (the
cap is elementwise, so capping a slice caps the vocabulary: the training
losses read the slice, :meth:`_TiedDecoder.gather_logits` only joins).
``sequence_parallel`` (JAX's default on) runs the residual stream and every
norm on a rank's slice of the sequence in cacheless forwards at tp > 1,
the embedding's rows reduce-scattered before the scale, the sequence
gathered after the final norm, before the tied head (JAX's order); cached
decode keeps it off.  At context-parallel degree > 1 a rank holds its
chunk of the sequence at its own positions and the blocks attend over the
cp group as Llama's do: the ring or ulysses on the flash path (Gemma-2's
window must fit one chunk on the ring; zigzag with a window raises), the
gathered dense core otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
from torch import nn

from neuronx_distributed_tpu_torch.models.common import (
    sequence_parallel_active,
)
from neuronx_distributed_tpu_torch.models.llama import (
    LlamaAttention,
    LlamaBlock,
    LlamaConfig,
    LlamaMLP,
    norm,
    run_layers,
)
from neuronx_distributed_tpu_torch.parallel.layers import ParallelEmbedding
from neuronx_distributed_tpu_torch.parallel.mappings import (
    gather_from_sequence_parallel_region,
    gather_from_tensor_parallel_region,
)
from neuronx_distributed_tpu_torch.parallel.mesh import (
    ContextParallel,
    TensorParallel,
)
from neuronx_distributed_tpu_torch.parallel.norm import RMSNorm
from neuronx_distributed_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class GemmaConfig:
    """Gemma-1 (2B/7B).  ``dtype`` is the compute type; ``param_dtype`` the
    weights' (None: the compute type with fp32 norm weights, the serving
    layout; training keeps fp32 masters), as in :class:`.llama.LlamaConfig`."""

    vocab_size: int = 256000
    hidden_size: int = 3072
    intermediate_size: int = 24576
    num_layers: int = 28
    num_heads: int = 16
    num_kv_heads: int = 16
    head_dim: int = 256
    max_seq_len: int = 8192
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    sequence_parallel: bool = True
    remat: str = "selective"
    attention_impl: str = "dense"
    dtype: torch.dtype = torch.bfloat16
    param_dtype: Optional[torch.dtype] = None

    def __post_init__(self):
        self.block_config()  # validates remat and attention_impl

    @property
    def head_dim_(self) -> int:
        return self.head_dim

    def block_config(self) -> LlamaConfig:
        """The shared decoder-block config (GeGLU selected here)."""
        return LlamaConfig(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            num_layers=self.num_layers, num_heads=self.num_heads,
            num_kv_heads=self.num_kv_heads, head_dim=self.head_dim,
            max_seq_len=self.max_seq_len, rope_theta=self.rope_theta,
            rms_eps=self.rms_eps, remat=self.remat,
            attention_impl=self.attention_impl, mlp_activation="gelu_tanh",
            sequence_parallel=self.sequence_parallel, dtype=self.dtype,
            param_dtype=self.param_dtype)

    @staticmethod
    def gemma_2b(**overrides) -> "GemmaConfig":
        """Gemma-2B: MQA (1 kv head), head_dim 256."""
        return GemmaConfig(**{**dict(
            hidden_size=2048, intermediate_size=16384, num_layers=18,
            num_heads=8, num_kv_heads=1), **overrides})

    @staticmethod
    def gemma_7b(**overrides) -> "GemmaConfig":
        return GemmaConfig(**overrides)

    @staticmethod
    def tiny(**overrides) -> "GemmaConfig":
        """Test-scale config."""
        return GemmaConfig(**{**dict(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=8, num_kv_heads=2, head_dim=16,
            max_seq_len=128), **overrides})


@dataclasses.dataclass(frozen=True)
class Gemma2Config:
    """Gemma-2 (2B/9B/27B): the Gemma recipe plus hybrid sliding/global
    layers, attention and final-logit softcaps, sandwich norms and the
    ``query_pre_attn_scalar ** -0.5`` score scale."""

    vocab_size: int = 256000
    hidden_size: int = 2304
    intermediate_size: int = 9216
    num_layers: int = 26
    num_heads: int = 8
    num_kv_heads: int = 4
    head_dim: int = 256
    query_pre_attn_scalar: float = 256.0
    attn_softcap: float = 50.0
    final_softcap: float = 30.0
    sliding_window: int = 4096
    max_seq_len: int = 8192
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    sequence_parallel: bool = True
    remat: str = "selective"
    attention_impl: str = "dense"
    dtype: torch.dtype = torch.bfloat16
    param_dtype: Optional[torch.dtype] = None

    def __post_init__(self):
        self.block_config(True)  # validates remat and attention_impl

    @property
    def head_dim_(self) -> int:
        return self.head_dim

    def block_config(self, sliding: bool) -> LlamaConfig:
        """Block config of one layer; ``sliding`` selects the local-window
        variant (the even layers)."""
        return LlamaConfig(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            num_layers=self.num_layers, num_heads=self.num_heads,
            num_kv_heads=self.num_kv_heads, head_dim=self.head_dim,
            max_seq_len=self.max_seq_len, rope_theta=self.rope_theta,
            rms_eps=self.rms_eps, remat=self.remat,
            attention_impl=self.attention_impl, mlp_activation="gelu_tanh",
            sliding_window=self.sliding_window if sliding else None,
            attn_softcap=self.attn_softcap,
            attn_scale=self.query_pre_attn_scalar ** -0.5,
            sequence_parallel=self.sequence_parallel, dtype=self.dtype,
            param_dtype=self.param_dtype)

    @staticmethod
    def gemma2_2b(**overrides) -> "Gemma2Config":
        return Gemma2Config(**overrides)

    @staticmethod
    def gemma2_9b(**overrides) -> "Gemma2Config":
        return Gemma2Config(**{**dict(
            hidden_size=3584, intermediate_size=14336, num_layers=42,
            num_heads=16, num_kv_heads=8), **overrides})

    @staticmethod
    def gemma2_27b(**overrides) -> "Gemma2Config":
        # the one scale where the attention scale decouples from head_dim
        return Gemma2Config(**{**dict(
            hidden_size=4608, intermediate_size=36864, num_layers=46,
            num_heads=32, num_kv_heads=16, head_dim=128,
            query_pre_attn_scalar=144.0), **overrides})

    @staticmethod
    def tiny(**overrides) -> "Gemma2Config":
        """Test-scale config."""
        return Gemma2Config(**{**dict(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=8, num_kv_heads=2, head_dim=16,
            query_pre_attn_scalar=16.0, sliding_window=16,
            max_seq_len=128), **overrides})


class Gemma2Block(nn.Module):
    """Sandwich-norm decoder block: ``x + post_attn_norm(attn(input_norm(
    x)))``, then ``x + post_ffw_norm(mlp(pre_ffw_norm(x)))``; the block
    config carries the layer's window.  Same call as :class:`LlamaBlock`;
    under sequence parallelism the four norms act on sequence shards."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.attn = LlamaAttention(cfg, device)
        for name in ("input_norm", "post_attn_norm", "pre_ffw_norm",
                     "post_ffw_norm"):
            self.add_module(name, norm(cfg, device))
        self.mlp = LlamaMLP(cfg, device)

    def forward(self, x, positions, kv_cache=None, cache_offset=0,
                kv_valid=None, paged=None, segment_ids=None, adapter=None,
                sp: bool = False):
        h, cache = self.attn(self.input_norm(x), positions, kv_cache,
                             cache_offset, kv_valid, paged, segment_ids,
                             adapter, sp)
        x = x + self.post_attn_norm(h)
        return (x + self.post_ffw_norm(self.mlp(self.pre_ffw_norm(x), sp)),
                cache)


class _TiedDecoder(nn.Module):
    """What Gemma and Gemma-2 share: the scaled embedding, the layers
    ``layer_0`` ..., the final norm and the tied head.  ``forward(ids, ...)
    -> logits`` without caches, ``-> (logits, caches)`` with them.
    ``device`` defaults to CUDA (raises without it); parameters are created
    uninitialized -- load a state dict or call :meth:`init_random`."""

    def __init__(self, cfg, blocks, device=None):
        super().__init__()
        device = resolve_device(device)
        self.config = cfg
        self.tp = TensorParallel.current()
        self.cp = ContextParallel.current()
        bcfg = blocks[0][1]
        # the SP entry (the rows' reduce-scatter) is chosen per forward:
        # cached decode keeps the sequence whole
        self.embed = ParallelEmbedding(cfg.vocab_size, cfg.hidden_size,
                                       bcfg.dtype, device, bcfg.weight_dtype)
        for i, (cls, block_cfg) in enumerate(blocks):
            self.add_module(f"layer_{i}", cls(block_cfg, device))
        self.final_norm = norm(bcfg, device)

    def layers(self) -> List[nn.Module]:
        return [getattr(self, f"layer_{i}")
                for i in range(self.config.num_layers)]

    @torch.no_grad()
    def init_random(self, seed: int):
        """Random weights from one seeded generator on the parameters'
        device: kernels ~ N(0, 1/fan_in), embedding ~ N(0, 0.02^2), norms
        1."""
        g = torch.Generator(device=self.embed.embedding.device)
        g.manual_seed(seed)
        self.embed.reset_parameters(g)
        for block in self.layers():
            block.attn.reset_parameters(g)
            block.mlp.reset_parameters(g)
        for m in self.modules():
            if isinstance(m, RMSNorm):
                nn.init.ones_(m.weight)
        return self

    def _backbone(self, ids, positions=None, kv_caches=None, cache_offset=0,
                  kv_valid=None, block_table=None, paged_kernel=False,
                  segment_ids=None, adapters=None):
        sp = sequence_parallel_active(self.config.sequence_parallel, self.tp,
                                      ids.shape[1], kv_caches is not None)
        if positions is None:
            # at cp > 1, ids are this rank's chunk: its slice of arange(S)
            start = self.cp.rank * ids.shape[1]
            positions = torch.arange(start, start + ids.shape[1],
                                     device=ids.device).expand(ids.shape)
        h = self.embed(ids, sp)
        # the scale rounded to the activation type first (as JAX), made on
        # the device: a host tensor here would be a copy, which a CUDA
        # graph cannot capture
        h = h * torch.full((), self.config.hidden_size ** 0.5,
                           dtype=h.dtype, device=h.device)
        h = self.final_norm(run_layers(
            self.layers(), h, positions, kv_caches, cache_offset, kv_valid,
            block_table, paged_kernel, segment_ids, self.config.remat,
            adapters, sp))
        if sp:
            # the sequence gathered back before the tied head
            h = gather_from_sequence_parallel_region(h, 1, False,
                                                     self.tp.group)
        return h

    def forward(self, ids, positions=None, kv_caches=None, cache_offset=0,
                kv_valid=None, block_table=None, paged_kernel=False,
                segment_ids=None, adapters=None):
        h = self._backbone(ids, positions, kv_caches, cache_offset, kv_valid,
                           block_table, paged_kernel, segment_ids, adapters)
        logits = self.head(h)
        return (logits, kv_caches) if kv_caches is not None else logits

    def hidden(self, ids, positions=None, kv_valid=None, segment_ids=None):
        """Backbone only: final-norm hidden states ``[B, S, H]`` with the
        whole sequence (gathered back from sequence parallelism), the input
        the chunked loss head (``models.common.make_causal_lm_loss_sum``)
        consumes."""
        return self._backbone(ids, positions, None, 0, kv_valid, None, False,
                              segment_ids)

    def head(self, h):
        """Logits for a (chunk of) hidden states through the tied table:
        this rank's vocab slice ``[..., V / tp]``."""
        return self.embed.attend(h)

    def gather_logits(self, logits):
        """The full vocab ``[..., V]`` from every rank's slice (the
        identity when the model was built at tp = 1): what a sampler
        reads."""
        if self.tp.size == 1:
            return logits
        return gather_from_tensor_parallel_region(logits, self.tp.group)


class GemmaForCausalLM(_TiedDecoder):
    """Gemma-1: Llama blocks with GeGLU, scaled embedding, tied head."""

    def __init__(self, cfg: GemmaConfig, device=None):
        bcfg = cfg.block_config()
        super().__init__(cfg, [(LlamaBlock, bcfg)] * cfg.num_layers, device)


class Gemma2ForCausalLM(_TiedDecoder):
    """Gemma-2: sandwich-norm blocks, even layers sliding and odd layers
    global, and softcapped final logits."""

    def __init__(self, cfg: Gemma2Config, device=None):
        super().__init__(cfg, [(Gemma2Block, cfg.block_config(i % 2 == 0))
                               for i in range(cfg.num_layers)], device)

    def head(self, h):
        """The tied head's logits, softcapped ``cap * tanh(s / cap)`` in
        fp32 and cast back (JAX's ``_logits``): this rank's vocab slice
        ``[..., V / tp]``, capped at every tp, so the training losses and
        :meth:`gather_logits` (which only joins) see capped logits."""
        logits = self.embed.attend(h)
        cap = self.config.final_softcap
        if cap:
            logits = (cap * torch.tanh(logits.float() / cap)).to(logits.dtype)
        return logits
