"""BERT pretraining, in PyTorch (counterpart of
``neuronx_distributed_tpu/models/bert.py``).

HF ``BertForPreTraining``'s architecture: learned position and token-type
embeddings, a post-LN encoder (erf GELU, dropout on both residual
branches), a tanh pooler over token 0, an MLM head whose decoder is TIED
to the word-embedding table (:meth:`.ParallelEmbedding.attend`, vocab-
sharded both ways) plus ``mlm_bias``, and an fp32 NSP classifier.

Dropout follows JAX's rng contract with a ``torch.Generator`` in place of
the key: ``generator=None`` is deterministic; with a generator the model
draws one seed for the embedding dropout and one per layer from it before
the layers run (:func:`.common.fork_seeds`), and each layer makes its two
masks from a generator seeded inside the (possibly checkpointed) layer, so
remat's recompute makes the same masks (see :mod:`.common`).

The module tree follows the JAX param tree (``bert.word_embeddings.
embedding``, ``bert.position_embeddings``, ``bert.layer_3.attention.qkv.
kernel``, ``bert.pooler.kernel [in, out]``, ``mlm_bias``,
``nsp_classifier.kernel``), so :func:`..convert.jax_params.
bert_params_from_jax` is a flatten plus a shape check.  At tp > 1 the
word table and ``mlm_bias`` hold this rank's vocab rows (JAX keeps
``mlm_bias`` whole; the rank adds its slice), QKV and ``intermediate``
their columns; :meth:`BertForPreTraining.gather_logits` joins the MLM
slices; it trains there too.  ``sequence_parallel`` (off by default, as
in JAX) scatters the sequence after the embedding's dropout and gathers
it before the pooler.  Dropout is tp-invariant: a layer's mask over a
rank's sequence slice is the slice of the full-shape mask, so tp = 2
under one seed draws tp = 1's masks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from neuronx_distributed_tpu_torch.models.common import (
    dense_mha,
    dropout,
    fork_seeds,
    maybe_remat,
    seeded_generator,
    sequence_parallel_active,
)
from neuronx_distributed_tpu_torch.parallel.layers import (
    ColumnParallelLinear,
    ParallelEmbedding,
    RowParallelLinear,
    init_normal_,
    set_tp_layout,
)
from neuronx_distributed_tpu_torch.parallel.loss import parallel_cross_entropy
from neuronx_distributed_tpu_torch.parallel.mappings import (
    gather_from_sequence_parallel_region,
    gather_from_tensor_parallel_region,
    scatter_to_sequence_parallel_region,
)
from neuronx_distributed_tpu_torch.parallel.mesh import TensorParallel
from neuronx_distributed_tpu_torch.parallel.norm import LayerNorm
from neuronx_distributed_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """The JAX ``BertConfig``.  Defaults are BERT-large.  ``dtype`` is the compute type,
    ``param_dtype`` the weights' (fp32 masters, as JAX)."""

    vocab_size: int = 30522
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    ln_eps: float = 1e-12
    hidden_dropout: float = 0.1
    sequence_parallel: bool = False
    remat: str = "none"  # none | selective | full
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.remat not in ("none", "selective", "full"):
            raise ValueError(f"unknown remat mode {self.remat!r}")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def bert_large(**overrides) -> "BertConfig":
        return BertConfig(**overrides)

    @staticmethod
    def tiny(**overrides) -> "BertConfig":
        """Test-scale config (dropout off, as JAX's)."""
        return BertConfig(**{**dict(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=8, max_position_embeddings=64,
            hidden_dropout=0.0), **overrides})


def _layer_norm(cfg: BertConfig, device, in_sp: bool = False) -> LayerNorm:
    """``in_sp``: an encoder layer's norm, on sequence shards under
    sequence parallelism."""
    return LayerNorm(cfg.hidden_size, cfg.ln_eps, dtype=cfg.dtype,
                     param_dtype=cfg.param_dtype, device=device,
                     sequence_parallel=in_sp and cfg.sequence_parallel)


class Dense(nn.Module):
    """flax ``nn.Dense``, replicated at every tp: ``kernel [in, out]``,
    ``bias [out]``, inputs, kernel and bias cast to ``dtype``."""

    def __init__(self, in_features: int, features: int, dtype, param_dtype,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_features, features,
                                               dtype=param_dtype,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(features, dtype=param_dtype,
                                             device=device))

    def reset_parameters(self, generator=None) -> None:
        init_normal_(self.kernel, 1.0 / math.sqrt(self.kernel.shape[0]),
                     generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        return (torch.matmul(x.to(self.dtype), self.kernel.to(self.dtype))
                + self.bias.to(self.dtype))


class BertSelfAttention(nn.Module):
    """Fused biased QKV (column), the dense core with the padding mask over
    this rank's heads, then the biased ``dense`` row projection."""

    def __init__(self, cfg: BertConfig, device=None):
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

    def forward(self, x, attn_mask=None, sp: bool = False):
        D = self.config.head_dim
        qkv = self.qkv(x, sp)   # [B, S, 3, H / tp], the whole sequence
        B, S = qkv.shape[:2]
        q, k, v = (qkv[..., i, :].reshape(B, S, self.heads, D)
                   for i in range(3))
        out = dense_mha(q, k, v, mask=attn_mask, causal=False)
        return self.dense(out.reshape(B, S, self.heads * D), sp)


class BertLayer(nn.Module):
    """Post-LN encoder layer: ``attention_norm(x + drop(attn(x)))``, then
    ``output_norm(x + drop(output(gelu(intermediate(x)))))``."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.config = cfg
        H, I, sp = cfg.hidden_size, cfg.intermediate_size, cfg.sequence_parallel
        self.attention = BertSelfAttention(cfg, device)
        self.attention_norm = _layer_norm(cfg, device, True)
        self.intermediate = ColumnParallelLinear(
            H, I, use_bias=True, dtype=cfg.dtype, device=device,
            param_dtype=cfg.param_dtype, sequence_parallel=sp)
        self.output = RowParallelLinear(I, H, use_bias=True, dtype=cfg.dtype,
                                        device=device,
                                        param_dtype=cfg.param_dtype,
                                        sequence_parallel=sp)
        self.output_norm = _layer_norm(cfg, device, True)

    def reset_parameters(self, generator=None) -> None:
        self.attention.qkv.reset_parameters(generator)
        self.attention.dense.reset_parameters(generator)
        self.intermediate.reset_parameters(generator)
        self.output.reset_parameters(generator)

    def forward(self, x, attn_mask=None, seed: Optional[int] = None,
                sp: bool = False):
        """``seed`` (None: deterministic) seeds this layer's dropout
        generator here, inside the layer, so a recompute draws the same
        masks.  ``sp``: ``x`` is this rank's sequence slice, and so are
        the masks."""
        rate = self.config.hidden_dropout
        g = seeded_generator(seed, x.device) if seed is not None else None
        tp = self.attention.qkv.tp if sp else None
        h = self.attention(x, attn_mask, sp)
        x = self.attention_norm(x + dropout(h, rate, g, tp))
        h = F.gelu(self.intermediate(x, sp), approximate="none")
        h = self.output(h, sp)
        return self.output_norm(x + dropout(h, rate, g, tp))


class BertModel(nn.Module):
    """Embeddings, encoder and pooler: ``forward(ids, token_type_ids=None,
    attention_mask=None, generator=None) -> (h [B, S, H], pooled [B,
    H])``."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.config = cfg
        H = cfg.hidden_size
        self.word_embeddings = ParallelEmbedding(cfg.vocab_size, H,
                                                 cfg.dtype, device,
                                                 cfg.param_dtype)
        self.position_embeddings = nn.Parameter(torch.empty(
            cfg.max_position_embeddings, H, dtype=cfg.param_dtype,
            device=device))
        self.token_type_embeddings = nn.Parameter(torch.empty(
            cfg.type_vocab_size, H, dtype=cfg.param_dtype, device=device))
        self.embed_norm = _layer_norm(cfg, device)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", BertLayer(cfg, device))
        self.pooler = Dense(H, H, cfg.dtype, cfg.param_dtype, device)

    def layers(self) -> List[BertLayer]:
        return [getattr(self, f"layer_{i}")
                for i in range(self.config.num_layers)]

    def forward(self, ids, token_type_ids=None, attention_mask=None,
                generator: Optional[torch.Generator] = None):
        cfg = self.config
        S = ids.shape[1]
        tp = self.word_embeddings.tp
        sp = sequence_parallel_active(cfg.sequence_parallel, tp, S)
        seeds = ([None] * (cfg.num_layers + 1) if generator is None
                 else fork_seeds(generator, cfg.num_layers + 1))
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(ids)
        h = self.word_embeddings(ids)
        h = h + self.position_embeddings.to(cfg.dtype)[None, :S]
        h = h + self.token_type_embeddings.to(cfg.dtype)[token_type_ids]
        h = self.embed_norm(h)
        if seeds[0] is not None:
            h = dropout(h, cfg.hidden_dropout,
                        seeded_generator(seeds[0], h.device))
        if sp:
            h = scatter_to_sequence_parallel_region(h, 1, tp.group)
        mask = None
        if attention_mask is not None:
            mask = attention_mask[:, None, None, :].bool()   # [B, 1, 1, T]
        remat = cfg.remat if torch.is_grad_enabled() else "none"
        for layer, seed in zip(self.layers(), seeds[1:]):
            h = maybe_remat(
                lambda x, m, blk=layer, s=seed: blk(x, m, s, sp), remat)(h,
                                                                       mask)
        if sp:
            h = gather_from_sequence_parallel_region(h, 1, False, tp.group)
        pooled = torch.tanh(self.pooler(h[:, 0]))
        return h, pooled


class BertForPreTraining(nn.Module):
    """MLM and NSP heads over :class:`BertModel`: ``forward(ids,
    token_type_ids=None, attention_mask=None, generator=None) ->
    (mlm_logits [B, S, V / tp], nsp_logits [B, 2] fp32)``.  ``device``
    defaults to CUDA (raises without it); parameters are created
    uninitialized -- load a state dict or call :meth:`init_random`."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.config = cfg
        self.tp = TensorParallel.current()
        H = cfg.hidden_size
        self.bert = BertModel(cfg, device)
        self.mlm_transform = Dense(H, H, cfg.dtype, cfg.param_dtype, device)
        self.mlm_norm = _layer_norm(cfg, device)
        # this rank's vocab slice, as the tied table's
        self.mlm_bias = set_tp_layout(nn.Parameter(torch.zeros(
            self.bert.word_embeddings.embedding.shape[0],
            dtype=cfg.param_dtype, device=device)), self.tp)
        self.nsp_classifier = Dense(H, 2, torch.float32, cfg.param_dtype,
                                    device)

    @torch.no_grad()
    def init_random(self, seed: int) -> "BertForPreTraining":
        """Random weights from one seeded generator on the parameters'
        device: kernels ~ N(0, 1/fan_in), the three embedding tables ~
        N(0, 0.02^2), biases and ``mlm_bias`` 0, norms 1 and 0."""
        g = torch.Generator(device=self.mlm_bias.device)
        g.manual_seed(seed)
        bert = self.bert
        bert.word_embeddings.reset_parameters(g)
        init_normal_(bert.position_embeddings, 0.02, g)
        init_normal_(bert.token_type_embeddings, 0.02, g)
        for layer in bert.layers():
            layer.reset_parameters(g)
        for dense in (bert.pooler, self.mlm_transform, self.nsp_classifier):
            dense.reset_parameters(g)
        nn.init.zeros_(self.mlm_bias)
        for m in self.modules():
            if isinstance(m, LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        return self

    def forward(self, ids, token_type_ids=None, attention_mask=None,
                generator: Optional[torch.Generator] = None):
        h, pooled = self.bert(ids, token_type_ids, attention_mask, generator)
        t = self.mlm_norm(F.gelu(self.mlm_transform(h), approximate="none"))
        # the decoder tied to the word table: this rank's vocab slice
        mlm_logits = self.bert.word_embeddings.attend(t)
        mlm_logits = mlm_logits + self.mlm_bias.to(mlm_logits.dtype)
        return mlm_logits, self.nsp_classifier(pooled)

    def gather_logits(self, mlm_logits):
        """The full vocab ``[..., V]`` of the MLM logits from every rank's
        slice (the identity at tp = 1)."""
        if self.tp.size == 1:
            return mlm_logits
        return gather_from_tensor_parallel_region(mlm_logits, self.tp.group)


def pretraining_loss(model: BertForPreTraining, batch,
                     generator: Optional[torch.Generator] = None):
    """The masked-mean MLM cross entropy (``mlm_labels < 0`` ignored) plus,
    when the batch has ``nsp_labels``, the NSP cross entropy; ``batch =
    {ids, mlm_labels[, token_type_ids, attention_mask, nsp_labels]}``.
    ``generator`` drives dropout (None: deterministic)."""
    mlm_logits, nsp_logits = model(batch["ids"], batch.get("token_type_ids"),
                                   batch.get("attention_mask"), generator)
    labels = batch["mlm_labels"]
    per_tok = parallel_cross_entropy(mlm_logits, labels, tp=model.tp)
    mask = (labels >= 0).float()
    mlm_loss = (per_tok * mask).sum() / mask.sum().clamp(min=1.0)
    nsp_labels = batch.get("nsp_labels")
    if nsp_labels is None:
        return mlm_loss
    logp = torch.log_softmax(nsp_logits.float(), dim=-1)
    nsp_loss = -logp.gather(-1, nsp_labels.long()[:, None]).mean()
    return mlm_loss + nsp_loss
