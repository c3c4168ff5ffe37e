"""Llama for training and serving, in PyTorch (counterpart of
``neuronx_distributed_tpu/models/llama.py``).

The module tree and parameter names follow the JAX package's param tree
(``model.layer_0.attn.qkv.q_kernel`` ...), so a JAX checkpoint loads by
path (:mod:`..convert.jax_params`).  Carried: RoPE with Llama-3.1
frequency scaling; the dense GQA core (with packed-document segment ids)
and, for training with ``attention_impl="flash"``, the flash kernels (at
context-parallel degree > 1 through the ring or ulysses), over a rank's
local heads at any tensor-parallel degree and KV replication; the dense
core at cp > 1 over the gathered keys and values; sequence parallelism
(``sequence_parallel``:
the residual stream and the norms on a rank's slice of the sequence
between the projections, for cacheless forwards); rematerialization (``remat``) at block
granularity; ``hidden``/``head`` for the chunked loss; and three KV-cache
writes -- the contiguous write at a scalar offset, the per-slot masked
write at per-slot offsets, and the paged scatter through a block table --
followed by either the gather path or the paged-attention kernel.  A page
pool is the fp pair or the int8 six-tuple (``kvcache.quant``): int8 writes
requantize every page they touch, the gather path dequantizes to the
compute type and the kernel dequantizes inside.  The port writes caches IN
PLACE (JAX returns updated arrays); the returned cache tuples are the same
tensors.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from neuronx_distributed_tpu_torch.kvcache.allocator import NULL_PAGE
from neuronx_distributed_tpu_torch.kvcache.quant import (
    dequantize_page,
    page_ranges,
    quantize_page,
)
from neuronx_distributed_tpu_torch.models.common import (
    MOE_AUX_COEF,
    build_pipelined_causal_lm,
    maybe_remat,
    sequence_parallel_active,
)
from neuronx_distributed_tpu_torch.ops.flash_attention import (
    band_mask,
    flash_attention,
    flash_attention_segmented,
)
from neuronx_distributed_tpu_torch.ops.paged_attention import gather_pages, paged_attention
from neuronx_distributed_tpu_torch.ops.ring_attention import (
    ring_attention,
    zigzag_indices,
)
from neuronx_distributed_tpu_torch.parallel.layers import (
    ColumnParallelLinear,
    ParallelEmbedding,
    RowParallelLinear,
    reset_lora_parameters,
)
from neuronx_distributed_tpu_torch.parallel.mappings import (
    all_gather,
    gather_from_context_parallel_region,
    gather_from_sequence_parallel_region,
    gather_from_tensor_parallel_region,
)
from neuronx_distributed_tpu_torch.parallel.mesh import (
    ContextParallel,
    ExpertParallel,
    PipelineParallel,
    TensorParallel,
)
from neuronx_distributed_tpu_torch.parallel.moe import ExpertParallelMLP
from neuronx_distributed_tpu_torch.parallel.norm import RMSNorm
from neuronx_distributed_tpu_torch.parallel.qkv import GQAQKVColumnParallelLinear
from neuronx_distributed_tpu_torch.utils.device import resolve_device

# a layer's cache: the fp pair (k, v), or an int8 page pool's six-tuple
KVCache = Tuple[torch.Tensor, ...]

# the gated MLP's activation: SiLU (Llama/Mistral SwiGLU) or tanh-approximate
# GELU (Gemma GeGLU, JAX ``gelu(approximate=True)``, HF ``gelu_pytorch_tanh``)
MLP_ACTIVATIONS = {"silu": F.silu,
                   "gelu_tanh": functools.partial(F.gelu, approximate="tanh")}


# the modules LoRA adapters can target (JAX ``LlamaConfig.lora_targets``)
LORA_TARGETS = ("qkv", "o_proj", "mlp", "lm_head")


def lora_rank_for(cfg, target: str) -> int:
    """The adapter rank of ``target``'s module (0: no adapter)."""
    return cfg.lora_rank if target in cfg.lora_targets else 0


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """The JAX ``LlamaConfig`` fields the port carries (scanned layers are
    not ported).
    ``sequence_parallel`` (JAX's default on) shards the residual stream's
    sequence over tp in cacheless forwards
    (:func:`.common.sequence_parallel_active`).  ``dtype`` is the compute type; ``param_dtype`` the weights'
    (None: the compute type, with fp32 norm weights -- the serving layout;
    training keeps fp32 masters).  ``remat``: ``none`` | ``selective``
    (save the matmul outputs, recompute the rest) | ``full``, applied per
    block when gradients are on.  ``attention_impl``: ``dense`` | ``flash``
    (the CUDA flash kernels for the training forward; at context-parallel
    degree > 1 through :func:`..ops.ring_attention.ring_attention`, with
    ``cp_impl`` ``ring`` | ``ulysses`` and ``cp_zigzag``, the load-balanced
    layout whose ids, positions and segment ids arrive in
    ``zigzag_permute`` order).  ``lora_rank > 0`` adds zero-initialised
    LoRA adapters (``lora_alpha``) to the ``lora_targets`` among ``qkv``
    (the q and v projections), ``o_proj``, ``mlp`` and ``lm_head``; freeze
    the base with ``initialize_parallel_optimizer(trainable=
    peft.lora_trainable)``.  ``num_experts > 1`` replaces every block's MLP
    with an expert-parallel routed FFN (:class:`..parallel.moe.
    ExpertParallelMLP`, ``moe_mlp``): ``moe_top_k`` experts a token,
    ``moe_capacity_factor``, ``moe_dispatch`` ``einsum`` | ``scatter``,
    ``moe_router`` ``topk`` | ``expert_choice``; ``moe_local_experts`` is
    set by :func:`build_pipelined_llama` (the experts a rank holds under a
    pipeline at ep > 1; 0 otherwise)."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: Optional[int] = None
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    rope_scaling_factor: float = 1.0
    rope_scaling_low_freq_factor: float = 1.0
    rope_scaling_high_freq_factor: float = 4.0
    rope_scaling_original_max_seq: int = 8192
    rms_eps: float = 1e-5
    sequence_parallel: bool = True
    qkv_bias: bool = False
    # Gemma-2 score knobs and Mistral sliding window, honored by the dense
    # core and the paged kernel alike
    attn_softcap: Optional[float] = None
    attn_scale: Optional[float] = None
    sliding_window: Optional[int] = None
    remat: str = "selective"
    attention_impl: str = "dense"
    mlp_activation: str = "silu"    # a key of MLP_ACTIVATIONS
    cp_zigzag: bool = False
    cp_impl: str = "ring"
    lora_rank: int = 0
    lora_alpha: float = 16.0
    lora_targets: Tuple[str, ...] = ("qkv",)
    num_experts: int = 1
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_dispatch: str = "einsum"
    moe_router: str = "topk"
    moe_local_experts: int = 0
    dtype: torch.dtype = torch.bfloat16
    param_dtype: Optional[torch.dtype] = None

    def __post_init__(self):
        if self.cp_impl not in ("ring", "ulysses"):
            raise ValueError(f"unknown cp_impl {self.cp_impl!r}")
        bad = set(self.lora_targets) - set(LORA_TARGETS)
        if bad:
            raise ValueError(f"unknown lora_targets {sorted(bad)} (of "
                             f"{LORA_TARGETS})")
        if self.remat not in ("none", "selective", "full"):
            raise ValueError(f"unknown remat mode {self.remat!r}")
        if self.attention_impl not in ("dense", "flash"):
            raise ValueError(
                f"unknown attention_impl {self.attention_impl!r}")
        if self.mlp_activation not in MLP_ACTIVATIONS:
            raise ValueError(
                f"unknown mlp_activation {self.mlp_activation!r} (one of "
                f"{sorted(MLP_ACTIVATIONS)})")

    @property
    def weight_dtype(self) -> torch.dtype:
        """Type of the projection and embedding weights."""
        return self.param_dtype or self.dtype

    @property
    def norm_dtype(self) -> torch.dtype:
        """Type of the RMSNorm weights."""
        return self.param_dtype or torch.float32

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @property
    def rope_scaling_(self):
        """``(factor, low, high, original_max_seq)`` or None when off."""
        if self.rope_scaling_factor == 1.0:
            return None
        return (self.rope_scaling_factor, self.rope_scaling_low_freq_factor,
                self.rope_scaling_high_freq_factor,
                self.rope_scaling_original_max_seq)

    @staticmethod
    def llama2_7b(**overrides) -> "LlamaConfig":
        return LlamaConfig(**{**dict(
            vocab_size=32000, hidden_size=4096, intermediate_size=11008,
            num_layers=32, num_heads=32, num_kv_heads=32), **overrides})

    @staticmethod
    def llama2_13b(**overrides) -> "LlamaConfig":
        return LlamaConfig(**{**dict(
            vocab_size=32000, hidden_size=5120, intermediate_size=13824,
            num_layers=40, num_heads=40, num_kv_heads=40), **overrides})

    @staticmethod
    def llama2_70b(**overrides) -> "LlamaConfig":
        return LlamaConfig(**{**dict(
            vocab_size=32000, hidden_size=8192, intermediate_size=28672,
            num_layers=80, num_heads=64, num_kv_heads=8), **overrides})

    @staticmethod
    def llama3_8b(**overrides) -> "LlamaConfig":
        return LlamaConfig(**{**dict(
            vocab_size=128256, hidden_size=4096, intermediate_size=14336,
            num_layers=32, num_heads=32, num_kv_heads=8, rope_theta=500000.0),
            **overrides})

    @staticmethod
    def qwen2_7b(**overrides) -> "LlamaConfig":
        """Qwen2-7B: the Llama architecture with QKV biases, 28 q heads on 4
        kv heads, a 152k vocabulary."""
        return LlamaConfig(**{**dict(
            vocab_size=152064, hidden_size=3584, intermediate_size=18944,
            num_layers=28, num_heads=28, num_kv_heads=4, rope_theta=1e6,
            qkv_bias=True, rms_eps=1e-6), **overrides})

    @staticmethod
    def llama31_8b(**overrides) -> "LlamaConfig":
        """Llama-3.1-8B: the 3.0 layout with "llama3" RoPE scaling (factor
        8, 128k context); ``max_seq_len`` keeps the default, so raise it
        (and cut the sequence over cp) for long contexts."""
        return LlamaConfig(**{**dict(
            vocab_size=128256, hidden_size=4096, intermediate_size=14336,
            num_layers=32, num_heads=32, num_kv_heads=8, rope_theta=500000.0,
            rope_scaling_factor=8.0, rope_scaling_low_freq_factor=1.0,
            rope_scaling_high_freq_factor=4.0,
            rope_scaling_original_max_seq=8192), **overrides})

    @staticmethod
    def mistral_7b(**overrides) -> "LlamaConfig":
        """Mistral-7B-v0.1: the Llama architecture with 8 kv heads and a
        4096-token sliding window."""
        return LlamaConfig(**{**dict(
            vocab_size=32000, hidden_size=4096, intermediate_size=14336,
            num_layers=32, num_heads=32, num_kv_heads=8,
            max_seq_len=32768, sliding_window=4096), **overrides})

    @staticmethod
    def mixtral_8x7b(**overrides) -> "LlamaConfig":
        """Mixtral-8x7B-shaped MoE config: 8 experts, top-2, scatter
        dispatch."""
        return LlamaConfig(**{**dict(
            vocab_size=32000, hidden_size=4096, intermediate_size=14336,
            num_layers=32, num_heads=32, num_kv_heads=8, rope_theta=1e6,
            num_experts=8, moe_top_k=2, moe_dispatch="scatter"),
            **overrides})

    @staticmethod
    def tiny(**overrides) -> "LlamaConfig":
        """Test-scale config."""
        return LlamaConfig(**{**dict(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=8, num_kv_heads=8, max_seq_len=128),
            **overrides})


def llama3_scale_freqs(inv_freq: torch.Tensor, factor: float,
                       low_freq_factor: float = 1.0,
                       high_freq_factor: float = 4.0,
                       original_max_seq: int = 8192) -> torch.Tensor:
    """Llama-3.1 "llama3" RoPE frequency scaling: wavelengths above
    ``original_max_seq / low_freq_factor`` slow by ``factor``, those below
    ``original_max_seq / high_freq_factor`` stay, the band between
    interpolates linearly in ``original_max_seq / wavelength``."""
    wavelen = 2.0 * np.pi / inv_freq
    low_wl = original_max_seq / low_freq_factor
    high_wl = original_max_seq / high_freq_factor
    smooth = (original_max_seq / wavelen - low_freq_factor) / (
        high_freq_factor - low_freq_factor)
    mid = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
    scaled = torch.where(wavelen > low_wl, inv_freq / factor, mid)
    return torch.where(wavelen < high_wl, inv_freq, scaled)


def rope_sin_cos(positions: torch.Tensor, head_dim: int, theta: float,
                 scaling=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 RoPE tables for ``positions [..., s]`` -> ``(sin, cos)`` of
    shape ``[..., s, head_dim / 2]``."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exps)
    if scaling is not None:
        inv_freq = llama3_scale_freqs(inv_freq, *scaling)
    angles = positions.float()[..., None] * inv_freq
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE in fp32; ``x [B, S, n, d]``, sin/cos ``[B, S, d/2]``."""
    d2 = x.shape[-1] // 2
    xf = x.float()
    x1, x2 = xf[..., :d2], xf[..., d2:]
    sin, cos = sin[..., None, :], cos[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _score_scale(cfg: LlamaConfig, D: int) -> float:
    if cfg.attn_scale is not None:
        return float(np.float32(cfg.attn_scale))
    return float(np.float32(1.0) / np.sqrt(np.float32(D)))


def core_attention(cfg: LlamaConfig, q, k, v, q_offset=0, kv_valid=None,
                   segment_ids=None, kv_segment_ids=None):
    """Dense grouped (GQA) causal attention with an fp32 softmax: ``q [B, S,
    NQ, D]`` over ``k/v [B, T, NKV, D]``.  ``q_offset`` is a scalar or a
    per-slot ``[B]`` tensor; ``kv_valid [B, T]`` masks invalid keys;
    ``segment_ids [B, S]`` (packed documents) keeps attention inside each
    nonzero id (0 is padding, blocked both ways), against the keys'
    ``kv_segment_ids [B, T]`` (default: the same ids, ``S == T``)."""
    B, S, NQ, D = q.shape
    T, NKV = k.shape[1], k.shape[2]
    G = NQ // NKV
    qg = q.reshape(B, S, NKV, G, D)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    scores = scores * _score_scale(cfg, D)
    if cfg.attn_softcap is not None:
        scores = cfg.attn_softcap * torch.tanh(scores / cfg.attn_softcap)
    mask = band_mask(S, T, q_offset, cfg.sliding_window, device=q.device)
    mask = mask[:, None, None] if mask.ndim == 3 else mask[None, None, None]
    if kv_valid is not None:
        mask = mask & (kv_valid[:, None, None, None, :] > 0)
    if segment_ids is not None:
        kseg = segment_ids if kv_segment_ids is None else kv_segment_ids
        same = kseg[:, None, :] == segment_ids[:, :, None]          # [B,S,T]
        live = (segment_ids > 0)[:, :, None]
        mask = mask & (same & live)[:, None, None]
    scores = torch.where(mask, scores,
                         torch.full_like(scores, torch.finfo(torch.float32).min))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.to(q.dtype))
    return out.reshape(B, S, NQ, D)


def context_parallel_core(cfg: LlamaConfig, q, k, v, segment_ids,
                          cp: ContextParallel):
    """The dense core at context-parallel degree > 1 (what GSPMD runs for
    JAX's dense core on a sequence cut over cp): every rank's k and v (and
    key segment ids) gathered over the cp group, their gradients
    reduce-scattered back, and this rank's q rows masked at their global
    offsets.  Contiguous layout: rank r's rows start at ``r * C``.  Zigzag
    (``cp_zigzag``: the chunk is the half-chunk pair ``(r, 2cp - 1 - r)``)
    puts the gathered keys back in sequence order and masks each half at
    its own offset, so the causal band is the sequence's, as the ring's
    zigzag schedule applies it."""
    kk = gather_from_context_parallel_region(k, 1, cp.group)
    vv = gather_from_context_parallel_region(v, 1, cp.group)
    kseg = (None if segment_ids is None else all_gather(
        segment_ids, 1, cp.group, kind="cp_all_gather"))
    C = q.shape[1]
    if not cfg.cp_zigzag:
        return core_attention(cfg, q, kk, vv, cp.rank * C, None,
                              segment_ids, kseg)
    inv = torch.argsort(zigzag_indices(C * cp.size, cp.size)).to(q.device)
    kk, vv = kk.index_select(1, inv), vv.index_select(1, inv)
    kseg = None if kseg is None else kseg.index_select(1, inv)
    h = C // 2
    outs = []
    for rows, half in ((slice(0, h), cp.rank),
                       (slice(h, C), 2 * cp.size - 1 - cp.rank)):
        qseg = None if segment_ids is None else segment_ids[:, rows]
        outs.append(core_attention(cfg, q[:, rows], kk, vv, half * h, None,
                                   qseg, kseg))
    return torch.cat(outs, dim=1)


def flash_core(cfg: LlamaConfig, q, k, v, segment_ids=None,
               cp: Optional[ContextParallel] = None):
    """The flash path: at context-parallel degree 1 (the JAX
    ``ring_attention`` at cp = 1) ``[B, S, N, D]`` activations go to the
    kernels as ``[B, N, S, D]`` views without a copy, and the output comes
    back as a ``[B, S, NQ, D]`` view of memory in that order; at cp > 1
    this rank's chunk goes through :func:`..ops.ring_attention.
    ring_attention` (``cfg.cp_impl``, ``cfg.cp_zigzag``).  JAX sends a
    segmented call whose chunk does not tile by 128 to its dense core
    (``seg_ok``), a Pallas limit: the port's kernels take any length, so
    every segmented case stays here, with the same values."""
    if cp is not None and cp.size > 1:
        return ring_attention(
            q, k, v, True, cfg.attn_scale,
            "zigzag" if cfg.cp_zigzag else "contiguous", cfg.cp_impl,
            segment_ids, cfg.sliding_window, cfg.attn_softcap, cp=cp)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if segment_ids is None:
        o = flash_attention(qt, kt, vt, True, cfg.attn_scale,
                            cfg.sliding_window, cfg.attn_softcap)
    else:
        o = flash_attention_segmented(qt, kt, vt, segment_ids, segment_ids,
                                      True, cfg.attn_scale,
                                      cfg.sliding_window, cfg.attn_softcap)
    return o.transpose(1, 2)


class PagedStep(NamedTuple):
    """What every layer of one paged step shares, computed once per forward
    by :func:`plan_paged_step`: where each new token is written
    (``phys``/``cell``, with ``keep`` false for dropped cells; for an int8
    pool the page slots to requantize, ``rmw_*``) and what the kernel reads
    (int32 offsets and the first valid key per slot)."""

    block_table: torch.Tensor          # [B, PP] int32
    offsets: torch.Tensor              # [B] int32
    kv_start: Optional[torch.Tensor]   # [B] int32, None = from position 0
    phys: torch.Tensor                 # [B, Sn] physical page per new token
    cell: torch.Tensor                 # [B, Sn] cell within that page
    keep: torch.Tensor                 # [B, Sn] bool
    kernel: bool                       # paged-attention kernel, else gather
    rmw_pages: Optional[torch.Tensor] = None  # [B * n_pg] int8 page slots
    rmw_hot: Optional[torch.Tensor] = None    # [B * n_pg, page] cells to insert
    rmw_src: Optional[torch.Tensor] = None    # [B * n_pg, page] into [B * Sn]


def plan_paged_step(block_table, cache_offset, kv_valid, n_new: int,
                    page: int, kernel: bool,
                    quantized: bool = False) -> PagedStep:
    """Token ``s`` of slot ``b`` goes to logical index ``offset[b] + s``
    through the block table.  Cells past the table (a parked slot at
    ``offset >= T``) and invalid cells are dropped: they rewrite the NULL
    page's first cell with its own value, so no host sync is needed and no
    real page is touched.  Serving key validity is a contiguous band (left
    pads, then the written prefix), so the kernel takes its first valid
    index.  An int8 pool writes whole pages: see :func:`_plan_requant`.
    Every shape here follows from the input shapes alone, so a step plans
    without a host sync (and can be captured in a CUDA graph)."""
    if not (isinstance(cache_offset, torch.Tensor) and cache_offset.ndim == 1):
        raise ValueError("the block-table decode path needs per-slot offsets "
                         "[B] (continuous-batching decode)")
    PP = block_table.shape[1]
    T = PP * page
    idx = cache_offset.long()[:, None] + torch.arange(
        n_new, device=cache_offset.device)[None, :]                   # [B, Sn]
    phys = block_table.long().gather(1, (idx // page).clamp(0, PP - 1))
    keep = idx < T
    kv_start = None
    if kv_valid is not None:
        keep = keep & (kv_valid.gather(1, idx.clamp(0, T - 1)) > 0)
        if kernel:
            kv_start = (kv_valid > 0).to(torch.float32).argmax(dim=1).to(
                torch.int32)
    rmw = (_plan_requant(block_table, cache_offset, kv_valid, n_new, page)
           if quantized else (None, None, None))
    return PagedStep(
        block_table=block_table.to(torch.int32),
        offsets=cache_offset.to(torch.int32), kv_start=kv_start,
        phys=torch.where(keep, phys, torch.zeros_like(phys)),
        cell=torch.where(keep, idx % page, torch.zeros_like(idx)),
        keep=keep, kernel=bool(kernel), rmw_pages=rmw[0], rmw_hot=rmw[1],
        rmw_src=rmw[2])


def _plan_requant(block_table, cache_offset, kv_valid, n_new: int,
                  page: int):
    """The page slots an int8 write covers, a fixed ``B * n_pg`` of them
    (``n_pg`` logical pages from slot ``b``'s first new cell on, as the
    JAX ``requant_pages``).  A slot is LIVE when its page holds at least
    one HOT cell (inside the table and valid: a chunk's left-pad rows are
    garbage that must never enter a page's min/max); a slot that is not
    live targets the NULL page and writes back the NULL page's own codes,
    scale and zero, so every duplicate write carries identical bytes and
    no page the step does not touch is requantized (that could move its
    scale by an ulp).  Returns ``(pages [B * n_pg], hot [B * n_pg, page],
    src [B * n_pg, page])``, ``src`` indexing the flattened ``[B *
    n_new]`` new tokens; a slot is live iff a cell of its ``hot`` row is
    set."""
    B, PP = block_table.shape
    T = PP * page
    dev = cache_offset.device
    off = cache_offset.long()
    n_pg = (n_new - 1 + page - 1) // page + 1
    lp = (off // page)[:, None] + torch.arange(n_pg, device=dev)   # [B, n_pg]
    pos = lp[..., None] * page + torch.arange(page, device=dev)     # [B, n_pg, page]
    s_idx = pos - off[:, None, None]
    hot = (s_idx >= 0) & (s_idx < n_new) & (pos < T)
    if kv_valid is not None:
        hot &= kv_valid.gather(1, pos.clamp(0, T - 1).reshape(B, -1)
                               ).reshape(hot.shape) > 0
    pages = block_table.long().gather(1, lp.clamp(max=PP - 1))      # [B, n_pg]
    pages = torch.where(hot.any(dim=2), pages, torch.full_like(pages, NULL_PAGE))
    src = (torch.arange(B, device=dev)[:, None, None] * n_new
           + s_idx.clamp(0, n_new - 1))
    return (pages.reshape(-1), hot.reshape(-1, page),
            src.reshape(-1, page))


def _requant_paged(kv_cache: KVCache, k, v, paged: PagedStep,
                   group=None) -> None:
    """Quantize-on-write for any number of new tokens: gather each page
    slot :func:`_plan_requant` planned, dequantize it to fp32, insert its
    hot new cells, requantize the whole page and write back codes, scale
    and zero; a slot that is not live writes back what it read.  Decode,
    verify and chunk writes touch only pages their slot owns alone (shared
    prefix pages are prompt pages, never written), so the live pages are
    distinct and the read-modify-write needs no atomics.  A
    tensor-parallel shard (``group``) takes each page's range over every
    rank's heads, k and v in one all-reduce."""
    ck, cv, ks, kz, vs, vz = kv_cache
    pages, hot = paged.rmw_pages, paged.rmw_hot
    live = hot.any(dim=1)
    olds, pgs = [], []
    for cq, sc, zp, new in ((ck, ks, kz, k), (cv, vs, vz, v)):
        flat = new.reshape(-1, *new.shape[2:])
        old = cq[pages], sc[pages], zp[pages]
        olds.append(old)
        pgs.append(torch.where(hot[..., None, None],
                               flat[paged.rmw_src].float(),
                               dequantize_page(*old)))
    ranges = page_ranges(pgs, group)
    for (cq, sc, zp), old, pg, stats in zip(
            ((ck, ks, kz), (cv, vs, vz)), olds, pgs, ranges):
        q2, s2, z2 = quantize_page(pg, stats)
        cq[pages] = torch.where(live[:, None, None, None], q2, old[0])
        sc[pages] = torch.where(live, s2, old[1])
        zp[pages] = torch.where(live, z2, old[2])


def _scatter_paged(kv_cache: KVCache, k, v, paged: PagedStep,
                   group=None) -> None:
    """Write the new tokens into the pool in place, at the cells
    :func:`plan_paged_step` chose (an int8 pool requantizes its pages,
    over ``group``'s shards of each page)."""
    if len(kv_cache) == 6:
        _requant_paged(kv_cache, k, v, paged, group)
        return
    hot = paged.keep[..., None, None]
    for c, new in zip(kv_cache, (k, v)):
        c[paged.phys, paged.cell] = torch.where(
            hot, new.to(c.dtype), c[paged.phys, paged.cell])


def apply_adapter(cfg: LlamaConfig, x, q, v, adapter):
    """Per-slot LoRA deltas on the q/v pair (multi-adapter serving):
    ``adapter`` holds one layer's gathered factors ``(a_q [B, H, r], b_q
    [B, r, NQ*D], a_v, b_v)`` with the ``alpha/r`` scale already in b;
    ``q += (x a_q) b_q`` and ``v += (x a_v) b_v``, one batched product pair
    per projection in the compute type.  A slot on adapter 0 gathers the
    NULL page's zeros and adds an exact zero."""
    a_q, b_q, a_v, b_v = (f.to(cfg.dtype) for f in adapter)
    B, S = x.shape[0], x.shape[1]
    xc = x.to(cfg.dtype)
    dq = torch.einsum("bsr,bro->bso",
                      torch.einsum("bsh,bhr->bsr", xc, a_q), b_q)
    dv = torch.einsum("bsr,bro->bso",
                      torch.einsum("bsh,bhr->bsr", xc, a_v), b_v)
    return (q + dq.reshape(B, S, *q.shape[2:]),
            v + dv.reshape(B, S, *v.shape[2:]))


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.config = cfg
        D = cfg.head_dim_
        self.qkv = GQAQKVColumnParallelLinear(
            cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, D,
            use_bias=cfg.qkv_bias, dtype=cfg.dtype, device=device,
            param_dtype=cfg.weight_dtype,
            sequence_parallel=cfg.sequence_parallel,
            lora_rank=lora_rank_for(cfg, "qkv"), lora_alpha=cfg.lora_alpha)
        # the attention output arrives in q-head blocks
        self.o_proj = RowParallelLinear(cfg.num_heads * D, cfg.hidden_size,
                                        use_bias=False, dtype=cfg.dtype,
                                        device=device,
                                        param_dtype=cfg.weight_dtype,
                                        sequence_parallel=cfg.sequence_parallel,
                                        head_blocks=True,
                                        lora_rank=lora_rank_for(cfg, "o_proj"),
                                        lora_alpha=cfg.lora_alpha)
        self.cp = ContextParallel.current()

    def forward(self, x, positions, kv_cache: Optional[KVCache] = None,
                cache_offset=0, kv_valid=None,
                paged: Optional[PagedStep] = None, segment_ids=None,
                adapter=None, sp: bool = False):
        """``sp``: ``x`` is this rank's sequence slice (sequence
        parallelism); q, k and v, and attention, cover the whole
        sequence."""
        cfg = self.config
        if self.cp.size > 1 and kv_cache is not None:
            raise NotImplementedError(
                "at context-parallel degree > 1 the port runs the cacheless "
                "(training) forward only: serving at cp > 1 is not ported "
                "(JAX's engines do not take it either)")
        q, k, v = self.qkv(x, sp)
        if adapter is not None:
            # part of the projection: before RoPE and before the page
            # write, so the pool holds the adapted v
            q, v = apply_adapter(cfg, x, q, v, adapter)
        sin, cos = rope_sin_cos(positions, cfg.head_dim_, cfg.rope_theta,
                                cfg.rope_scaling_)
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)

        if kv_cache is not None:
            if len(kv_cache) == 6 and paged is None:
                raise ValueError(
                    "quantized KV caches are page pools: the contiguous "
                    "decode paths take fp caches only")
            per_slot = isinstance(cache_offset, torch.Tensor) \
                and cache_offset.ndim == 1
            if paged is not None:
                _scatter_paged(kv_cache, k, v, paged, self.qkv.tp.group)
            elif per_slot:
                ck, cv = kv_cache
                # per-slot write positions: a masked select over the time
                # axis; an offset >= T (a parked slot) writes nothing
                if k.shape[1] != 1:
                    raise ValueError(
                        "per-example cache offsets support single-token "
                        f"decode only, got {k.shape[1]} new positions")
                hot = (torch.arange(ck.shape[1], device=ck.device)[None, :]
                       == cache_offset[:, None])[:, :, None, None]
                ck.copy_(torch.where(hot, k.to(ck.dtype), ck))
                cv.copy_(torch.where(hot, v.to(cv.dtype), cv))
            elif isinstance(cache_offset, torch.Tensor):
                # a 0-d offset (the exported decode program): written
                # through an index op, so one program serves every position
                ck, cv = kv_cache
                idx = cache_offset.reshape(1).long() + torch.arange(
                    k.shape[1], device=ck.device)
                ck.index_copy_(1, idx, k.to(ck.dtype))
                cv.index_copy_(1, idx, v.to(cv.dtype))
            else:
                ck, cv = kv_cache
                off = int(cache_offset)
                ck[:, off:off + k.shape[1]] = k.to(ck.dtype)
                cv[:, off:off + v.shape[1]] = v.to(cv.dtype)

        if kv_cache is not None and paged is not None and paged.kernel:
            out = paged_attention(
                q, kv_cache, paged.block_table, paged.offsets,
                paged.kv_start, sm_scale=cfg.attn_scale,
                window=cfg.sliding_window, softcap=cfg.attn_softcap)
        elif kv_cache is None and cfg.attention_impl == "flash":
            # the flash kernels have no query offset or key-padding mask
            # (the JAX core asserts the same)
            if not (isinstance(cache_offset, int) and cache_offset == 0):
                raise ValueError("the flash path requires q_offset == 0")
            if kv_valid is not None:
                raise ValueError("the flash path has no padding-mask support")
            out = flash_core(cfg, q, k, v, segment_ids, self.cp)
        elif kv_cache is None and self.cp.size > 1:
            if kv_valid is not None:
                raise ValueError("the dense core at context-parallel degree "
                                 "> 1 has no padding mask")
            out = context_parallel_core(cfg, q, k, v, segment_ids, self.cp)
        else:
            if kv_cache is None:
                keys, values = k, v
            elif paged is not None:
                keys, values = gather_pages(kv_cache, paged.block_table,
                                            q.dtype)
            else:
                keys, values = kv_cache
            out = core_attention(cfg, q, keys, values,
                                 cache_offset if kv_cache is not None else 0,
                                 kv_valid, segment_ids)
        B, S = x.shape[0], q.shape[1]
        return self.o_proj(out.reshape(B, S, -1), sp), kv_cache

    def reset_parameters(self, generator=None) -> None:
        self.qkv.reset_parameters(generator)
        self.o_proj.reset_parameters(generator)


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        sp = cfg.sequence_parallel
        self.gate_up = ColumnParallelLinear(
            cfg.hidden_size, 2 * cfg.intermediate_size, use_bias=False,
            n_fused=2, dtype=cfg.dtype, device=device,
            param_dtype=cfg.weight_dtype, sequence_parallel=sp,
            lora_rank=lora_rank_for(cfg, "mlp"), lora_alpha=cfg.lora_alpha)
        self.down = RowParallelLinear(cfg.intermediate_size, cfg.hidden_size,
                                      use_bias=False, dtype=cfg.dtype,
                                      device=device,
                                      param_dtype=cfg.weight_dtype,
                                      sequence_parallel=sp,
                                      lora_rank=lora_rank_for(cfg, "mlp"),
                                      lora_alpha=cfg.lora_alpha)
        self.act = MLP_ACTIVATIONS[cfg.mlp_activation]

    def forward(self, x, sp: bool = False):
        gate_up = self.gate_up(x, sp)
        return self.down(self.act(gate_up[..., 0, :]) * gate_up[..., 1, :],
                         sp)

    def reset_parameters(self, generator=None) -> None:
        self.gate_up.reset_parameters(generator)
        self.down.reset_parameters(generator)


def norm(cfg: LlamaConfig, device) -> RMSNorm:
    """A block's RMSNorm; under sequence parallelism it acts on sequence
    shards (its weight marked ``sequence_parallel``)."""
    return RMSNorm(cfg.hidden_size, cfg.rms_eps, cfg.dtype, device,
                   cfg.norm_dtype, cfg.sequence_parallel)


class LlamaBlock(nn.Module):
    """Attention and the gated MLP, each after its RMSNorm and added to the
    residual stream; an MoE config (``num_experts > 1``) has ``moe_mlp``
    in place of ``mlp`` and appends its aux term to ``aux`` (a list) when
    one is given."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.attn = LlamaAttention(cfg, device)
        self.input_norm = norm(cfg, device)
        self.post_attn_norm = norm(cfg, device)
        if cfg.num_experts > 1:
            if ContextParallel.current().size > 1:
                raise NotImplementedError(
                    "MoE at context-parallel degree > 1 is not ported: the "
                    "routing set would span the cp ranks' chunks")
            local = cfg.moe_local_experts
            self.moe_mlp = ExpertParallelMLP(
                cfg.hidden_size, local or cfg.num_experts,
                cfg.intermediate_size, top_k=cfg.moe_top_k,
                capacity_factor=cfg.moe_capacity_factor,
                dispatch=cfg.moe_dispatch,
                num_experts_global=cfg.num_experts if local else 0,
                router_type=cfg.moe_router, dtype=cfg.dtype,
                param_dtype=cfg.weight_dtype, device=device)
        else:
            self.mlp = LlamaMLP(cfg, device)

    def forward(self, x, positions, kv_cache=None, cache_offset=0,
                kv_valid=None, paged: Optional[PagedStep] = None,
                segment_ids=None, adapter=None, sp: bool = False,
                aux: Optional[list] = None):
        h, cache = self.attn(self.input_norm(x), positions, kv_cache,
                             cache_offset, kv_valid, paged, segment_ids,
                             adapter, sp)
        x = x + h
        normed = self.post_attn_norm(x)
        if hasattr(self, "moe_mlp"):
            h, a = self.moe_mlp(normed, sp)
            if aux is not None:
                aux.append(a)
            return x + h, cache
        return x + self.mlp(normed, sp), cache

    def reset_parameters(self, generator=None) -> None:
        """The block's random init: attention, the (routed) MLP, norms 1."""
        self.attn.reset_parameters(generator)
        (self.moe_mlp if hasattr(self, "moe_mlp") else self.mlp
         ).reset_parameters(generator)
        nn.init.ones_(self.input_norm.weight)
        nn.init.ones_(self.post_attn_norm.weight)


class LlamaModel(nn.Module):
    """Decoder stack without the LM head; layers are ``layer_0`` ... as in
    the JAX param tree."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.config = cfg
        self.cp = ContextParallel.current()
        self.embed = ParallelEmbedding(
            cfg.vocab_size, cfg.hidden_size, cfg.dtype, device,
            cfg.weight_dtype, sequence_parallel_output=cfg.sequence_parallel)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", LlamaBlock(cfg, device))
        self.final_norm = norm(cfg, device)

    def layers(self) -> List[LlamaBlock]:
        return [getattr(self, f"layer_{i}")
                for i in range(self.config.num_layers)]

    def forward(self, ids, positions=None, kv_caches=None, cache_offset=0,
                kv_valid=None, block_table=None, paged_kernel=False,
                segment_ids=None, adapters=None, aux=None):
        """The final-norm hidden states ``[B, S, H]`` (under sequence
        parallelism the stack runs on sequence shards and the sequence is
        gathered after the final norm); ``aux``: a list the MoE layers'
        aux terms are appended to, in layer order."""
        sp = sequence_parallel_active(self.config.sequence_parallel,
                                      self.embed.tp, ids.shape[1],
                                      kv_caches is not None)
        if positions is None:
            # at cp > 1, ids are this rank's chunk: its slice of arange(S)
            # (in zigzag layout JAX's default too: the permuted array's
            # index order)
            start = self.cp.rank * ids.shape[1]
            positions = torch.arange(start, start + ids.shape[1],
                                     device=ids.device).expand(ids.shape)
        h = self.final_norm(run_layers(
            self.layers(), self.embed(ids, sp), positions, kv_caches,
            cache_offset, kv_valid, block_table, paged_kernel, segment_ids,
            self.config.remat, adapters, sp, aux))
        if sp:
            h = gather_from_sequence_parallel_region(h, 1, False,
                                                     self.embed.tp.group)
        return h


def run_layers(layers, h, positions=None, kv_caches=None, cache_offset=0,
               kv_valid=None, block_table=None, paged_kernel=False,
               segment_ids=None, remat: str = "none",
               adapters=None, sp: bool = False,
               aux: Optional[list] = None) -> torch.Tensor:
    """The decoder stack over the embedded ``h [B, S, H]``.  Without
    caches: the training / teacher-forced forward,
    with per-document positions and segment ids (packed batches) and
    ``remat`` per block when gradients are on; ``sp``: ``h`` is this
    rank's sequence slice (sequence parallelism; ``positions`` and
    ``segment_ids`` cover the whole sequence).  With caches: the serving
    forward, the paged step planned once for every layer when there is a
    block table.  ``adapters``: one :func:`apply_adapter` factor tuple per
    layer (multi-adapter serving), or None.  ``aux``: a list the MoE
    layers' aux terms are appended to (each layer's comes out of its
    remat region with its output, so a recompute appends nothing)."""
    if adapters is None:
        adapters = [None] * len(layers)
    if positions is None:
        positions = torch.arange(h.shape[1], device=h.device
                                 ).expand(h.shape[:2])
    if block_table is not None and kv_caches is None:
        raise ValueError("a block table needs the page pool caches")
    if kv_caches is None:
        remat = remat if torch.is_grad_enabled() else "none"
        for block, adapter in zip(layers, adapters):
            def call(x, p, blk=block, ad=adapter):
                if not hasattr(blk, "moe_mlp"):
                    return blk(x, p, None, 0, kv_valid, None, segment_ids,
                               ad, sp)[0]
                terms = []
                y = blk(x, p, None, 0, kv_valid, None, segment_ids, ad, sp,
                        aux=terms)[0]
                return y, terms[0]

            out = maybe_remat(call, remat)(h, positions)
            if isinstance(out, tuple):
                h, a = out
                if aux is not None:
                    aux.append(a)
            else:
                h = out
        return h
    paged = None
    if block_table is not None:
        paged = plan_paged_step(block_table, cache_offset, kv_valid,
                                h.shape[1], kv_caches[0][0].shape[1],
                                paged_kernel, len(kv_caches[0]) == 6)
    for i, block in enumerate(layers):
        h, _ = block(h, positions, kv_caches[i], cache_offset, kv_valid,
                     paged, None, adapters[i])
    return h


class LlamaForCausalLM(nn.Module):
    """Causal LM: ``forward(ids, ...) -> logits`` without caches, ``->
    (logits, caches)`` with them.  ``device`` defaults to CUDA (raises
    without it); parameters are created uninitialized on that device --
    load a state dict or call :meth:`init_random`."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.config = cfg
        self.tp = TensorParallel.current()
        self.model = LlamaModel(cfg, device)
        self.lm_head = ColumnParallelLinear(
            cfg.hidden_size, cfg.vocab_size, use_bias=False, dtype=cfg.dtype,
            device=device, param_dtype=cfg.weight_dtype,
            lora_rank=lora_rank_for(cfg, "lm_head"),
            lora_alpha=cfg.lora_alpha)

    @torch.no_grad()
    def init_random(self, seed: int) -> "LlamaForCausalLM":
        """Random weights from one seeded generator on the parameters'
        device: kernels ~ N(0, 1/fan_in), embedding ~ N(0, 0.02^2), norms 1;
        then the LoRA adapters (``lora_a`` like kernels, ``lora_b`` zero),
        so the base weights are those of the model without adapters."""
        g = torch.Generator(device=self.lm_head.kernel.device)
        g.manual_seed(seed)
        self.model.embed.reset_parameters(g)
        for block in self.model.layers():
            block.reset_parameters(g)
        nn.init.ones_(self.model.final_norm.weight)
        self.lm_head.reset_parameters(g)
        reset_lora_parameters(self, g)
        return self

    def forward(self, ids, positions=None, kv_caches=None, cache_offset=0,
                kv_valid=None, block_table=None, paged_kernel=False,
                segment_ids=None, adapters=None, aux=None):
        """``aux``: a list the MoE layers' aux terms are appended to (the
        losses of ``models.common`` pass one for an MoE config)."""
        h = self.model(ids, positions, kv_caches, cache_offset, kv_valid,
                       block_table, paged_kernel, segment_ids, adapters, aux)
        logits = self.lm_head(h)
        return (logits, kv_caches) if kv_caches is not None else logits

    def build_pipelined(self, num_microbatches: int, schedule: str = "1f1b",
                        seed: int = 0, pipeline_cuts=None,
                        packed: bool = False, num_chunks: int = 1,
                        device=None):
        """The pipeline-capable-model protocol ``initialize_parallel_model``
        calls at ``pipeline_parallel_size > 1``: this rank's
        :func:`build_pipelined_llama` stage of this model's config (the
        model itself may live on the ``meta`` device)."""
        return build_pipelined_llama(
            self.config, num_microbatches=num_microbatches, seed=seed,
            schedule=schedule, pipeline_cuts=pipeline_cuts, packed=packed,
            num_chunks=num_chunks, device=device)

    def hidden(self, ids, positions=None, kv_valid=None, segment_ids=None,
               aux=None):
        """Backbone only: final-norm hidden states ``[B, S, H]`` with the
        whole sequence (gathered back from sequence parallelism), the input
        the chunked loss head (``models.common.make_causal_lm_loss_sum``)
        consumes."""
        return self.model(ids, positions, None, 0, kv_valid, None, False,
                          segment_ids, aux=aux)

    def head(self, h):
        """Logits for a (chunk of) hidden states: this rank's vocab slice
        ``[..., V / tp]``."""
        return self.lm_head(h)

    def gather_logits(self, logits):
        """The full vocab ``[..., V]`` from every rank's slice (the
        identity when the model was built at tp = 1): what a sampler
        reads."""
        if self.tp.size == 1:
            return logits
        return gather_from_tensor_parallel_region(logits, self.tp.group)


class LlamaHead(nn.Module):
    """Final norm + vocab-parallel LM head, the pipeline's head stage (JAX
    ``LlamaHead``): ``forward(h, sp) -> logits`` (this rank's vocab
    slice), the sequence gathered back after the norm under sequence
    parallelism.  A stage registers its children under the pp = 1 names
    ``model.final_norm`` and ``lm_head``."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.final_norm = norm(cfg, device)
        self.lm_head = ColumnParallelLinear(
            cfg.hidden_size, cfg.vocab_size, use_bias=False, dtype=cfg.dtype,
            device=device, param_dtype=cfg.weight_dtype,
            lora_rank=lora_rank_for(cfg, "lm_head"),
            lora_alpha=cfg.lora_alpha)
        self.tp = self.lm_head.tp

    def forward(self, h, sp: bool = False):
        h = self.final_norm(h)
        if sp:
            h = gather_from_sequence_parallel_region(h, 1, False,
                                                     self.tp.group)
        return self.lm_head(h)


def _llama_init_plan(cfg: LlamaConfig) -> list:
    """``LlamaForCausalLM.init_random``'s order as ``(part, reset)``
    pairs (:meth:`..pipeline.engine.PipelineStage.init_random`)."""

    def block(blk, g):
        blk.reset_parameters(g)

    def head(h, g):
        nn.init.ones_(h.final_norm.weight)
        h.lm_head.reset_parameters(g)

    plan = [("embed", lambda m, g: m.reset_parameters(g))]
    plan += [(("layer", i), block) for i in range(cfg.num_layers)]
    plan.append(("head", head))
    if cfg.lora_rank:
        # the adapters after the base, in module order
        plan += [(("layer", i), reset_lora_parameters)
                 for i in range(cfg.num_layers)]
        plan.append(("head", reset_lora_parameters))
    return plan


def build_pipelined_llama(cfg: LlamaConfig, num_microbatches: int,
                          seed: int = 0, schedule: str = "1f1b",
                          pipeline_cuts=None, packed: bool = False,
                          num_chunks: int = 1, device=None):
    """This rank's :class:`..pipeline.engine.PipelinedModel` for pipelined
    Llama training (JAX ``build_pipelined_llama``): the embedding on the
    first stage, its layers (``layer_i`` blocks, the pp = 1 model's) and
    :class:`LlamaHead` on the last, with the pp = 1 model's weights from
    ``seed``.  ``packed``: the schedule functions take ``positions`` and
    ``segment_ids`` after ``labels`` and thread them to every block (per-
    document RoPE and segment masking, as at pp = 1); ``sliding_window``
    comes from the config.  An MoE config's blocks hand their aux terms
    (``MOE_AUX_COEF`` folded in) to the engine's aux channel; at pp > 1
    and ep > 1 a rank holds ``num_experts // ep`` experts
    (``moe_local_experts``) and routes over its ep group, as JAX's manual
    ep does.  At context-parallel degree > 1 each stage holds its cp
    rank's chunk of every microbatch, and the blocks attend over the cp
    group (the ring or ulysses on the flash path, the gathered dense core
    otherwise), as at pp = 1."""
    moe = cfg.num_experts > 1
    ep = ExpertParallel.current().size
    cp = ContextParallel.current()
    if moe and PipelineParallel.current().size > 1 and ep > 1:
        if cfg.num_experts % ep != 0:
            raise ValueError(
                f"num_experts ({cfg.num_experts}) must divide by the "
                f"expert-parallel degree ({ep}) under pipeline parallelism")
        cfg = dataclasses.replace(cfg,
                                  moe_local_experts=cfg.num_experts // ep)

    def block_fn(blk, x, extras, sp, S):
        if packed:
            if len(extras) != 2:
                raise TypeError(
                    "packed pipelined model: the schedule functions take "
                    "(ids, labels, positions, segment_ids)")
            positions, segment_ids = extras
        else:
            # this cp rank's slice of arange (the layout's index order, as
            # LlamaModel.forward's default)
            positions = torch.arange(cp.rank * S, (cp.rank + 1) * S,
                                     device=x.device).expand(x.shape[0], S)
            segment_ids = None
        if not moe:
            return blk(x, positions, None, 0, None, None, segment_ids, None,
                       sp)[0]
        terms = []
        y = blk(x, positions, None, 0, None, None, segment_ids, None, sp,
                aux=terms)[0]
        return y, MOE_AUX_COEF * torch.stack(terms).sum()

    return build_pipelined_causal_lm(
        make_embed=lambda d: ParallelEmbedding(
            cfg.vocab_size, cfg.hidden_size, cfg.dtype, d, cfg.weight_dtype,
            sequence_parallel_output=cfg.sequence_parallel),
        make_block=lambda d: LlamaBlock(cfg, d),
        make_head=lambda d: LlamaHead(cfg, d),
        embed_path="model.embed", block_path="model.layer_{}".format,
        head_places={"final_norm": "model.final_norm", "lm_head": "lm_head"},
        block_fn=block_fn, init_plan=_llama_init_plan(cfg),
        num_layers=cfg.num_layers, hidden_size=cfg.hidden_size,
        vocab_size=cfg.vocab_size, dtype=cfg.dtype, remat=cfg.remat,
        sequence_parallel=cfg.sequence_parallel,
        num_microbatches=num_microbatches, seed=seed, schedule=schedule,
        pipeline_cuts=pipeline_cuts,
        extra_keys=("positions", "segment_ids") if packed else (),
        num_chunks=num_chunks, device=device, block_aux=moe)
