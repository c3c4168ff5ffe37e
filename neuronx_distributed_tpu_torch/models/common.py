"""Shared model-building blocks (counterpart of
``neuronx_distributed_tpu/models/common.py``): rematerialization, the
causal-LM losses, the dense attention core, dropout and the pipelined
causal LM's wiring (:func:`build_pipelined_causal_lm`).

A loss function here is ``loss_fn(model, batch, generator=None)`` -- the
port's modules hold their own parameters, so the JAX ``(module, params,
batch, rng)`` signature loses ``params``, and the ``rng`` key becomes a
``torch.Generator`` (None: deterministic, as JAX treats ``rng=None``) --
and returns either a scalar mean or ``(loss_sum, token_count)``;
``trainer.make_train_step`` accepts both.  The causal-LM families carry no
dropout, so their losses take the generator and ignore it, as JAX's
ignore the key.  At tensor-parallel degree > 1 the head gives this rank's
vocab slice and the losses take the vocab-parallel cross entropy (the
model's ``tp``); under sequence parallelism ``hidden`` gathers the
sequence before the head, so the chunked head cuts the whole sequence.

Dropout at tp > 1 is tp-invariant: a mask over a rank's slice of the
sequence is the slice of the full-shape mask drawn from the same
generator, so tp = 2 under one seed draws tp = 1's masks (the JAX
property of ``tests/test_rng_dropout.py``).

Dropout under remat: ``torch.utils.checkpoint`` restores the default CPU
and CUDA generators before it recomputes a block, never a user
``Generator``, so a mask drawn from the step's stream inside a
checkpointed block would be drawn again, differently, in backward.  A
model therefore draws one seed a block from the stream before it runs
the blocks (:func:`fork_seeds`), and each block makes its masks from a
generator seeded inside the block (:func:`seeded_generator`): the
recompute makes the same masks.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from neuronx_distributed_tpu_torch.parallel import fsdp
from neuronx_distributed_tpu_torch.parallel.loss import parallel_cross_entropy

# the ops whose outputs ``remat="selective"`` saves: matmuls without batch
# dimensions (the projections and the head), as JAX's
# checkpoint_dots_with_no_batch_dims; attention and elementwise work is
# recomputed
_SAVED_UNDER_SELECTIVE = (torch.ops.aten.mm.default,
                          torch.ops.aten.addmm.default)


def _selective_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_UNDER_SELECTIVE
            else CheckpointPolicy.PREFER_RECOMPUTE)


def maybe_remat(fn: Callable, remat: str) -> Callable:
    """``fn`` under the configured rematerialization: ``none`` returns it
    as is; ``full`` recomputes everything in backward, ``selective``
    everything but the matmul outputs (``torch.utils.checkpoint``,
    non-reentrant)."""
    if remat not in ("none", "selective", "full"):
        raise ValueError(f"unknown remat mode {remat!r}")
    if remat == "none":
        return fn
    kw = {}
    if remat == "selective":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _selective_policy)

    def wrapped(*args):
        return checkpoint(fn, *args, use_reentrant=False, **kw)

    return wrapped


def sequence_parallel_active(enabled: bool, tp, seq_len: int,
                             cached: bool = False) -> bool:
    """Whether a forward runs sequence-parallel: ``enabled`` by the model's
    config, at tensor-parallel degree > 1, without caches (serving keeps
    the plain collectives, as in JAX), over a sequence that splits over
    tp.  A training forward (gradients on) whose sequence does not split
    raises; a forward without gradients runs the plain collectives, which
    give the same values."""
    if not enabled or tp.size == 1 or cached:
        return False
    if seq_len % tp.size:
        if torch.is_grad_enabled():
            raise ValueError(
                f"sequence_parallel: a sequence of {seq_len} does not split "
                f"over tensor-parallel degree {tp.size}; pad it or build the "
                f"model with sequence_parallel=False")
        return False
    return True


def _token_mask(batch) -> torch.Tensor:
    labels = batch["labels"]
    mask = (labels >= 0).float()
    if batch.get("mask") is not None:
        mask = batch["mask"].float() * mask
    return mask


def _packed_kwargs(batch):
    return {key: batch[key] for key in ("positions", "segment_ids")
            if batch.get(key) is not None}


# the Switch-Transformer load-balancing coefficient of an MoE model's aux
# term (JAX ``MOE_AUX_COEF``)
MOE_AUX_COEF = 0.01


def _moe_kwargs(model) -> dict:
    """``{"aux": []}`` for an MoE model (``config.num_experts > 1``): the
    list its forward fills with each MoE layer's aux term (the port's
    counterpart of flax's ``sow`` into the ``losses`` collection); ``{}``
    for a dense one."""
    cfg = getattr(model, "config", None)
    return {"aux": []} if getattr(cfg, "num_experts", 1) > 1 else {}


def _aux_mean(kw: dict) -> Optional[torch.Tensor]:
    """The layer mean of the aux terms a forward collected, or None."""
    terms = kw.get("aux")
    return torch.stack(terms).mean() if terms else None


def _causal_lm_parts(model, batch):
    """``(masked loss sum, unmasked token count, aux layer mean or
    None)``."""
    kw = _moe_kwargs(model)
    logits = model(batch["ids"], **_packed_kwargs(batch), **kw)
    mask = _token_mask(batch)
    per_tok = parallel_cross_entropy(logits, batch["labels"],
                                     tp=getattr(model, "tp", None))
    return (per_tok * mask).sum(), mask.sum(), _aux_mean(kw)


def causal_lm_loss_sum(model, batch, generator=None):
    """``(loss_sum, tok)``: the summed next-token loss over unmasked
    positions (labels < 0 and ``mask == 0`` drop out) and their count, so
    the caller can normalise by the global token count.  A packed batch's
    ``positions``/``segment_ids`` are forwarded to the model; ``generator``
    is ignored (no dropout in the causal-LM families).  An MoE model's aux
    terms are added as ``MOE_AUX_COEF * layer mean * tok``, so ``loss_sum
    / tok`` is :func:`causal_lm_loss`, and summed over the data-parallel
    ranks (every rank routes the global batch, so its aux is the global
    one) the trainer's division by the global count gives JAX's mean."""
    loss_sum, tok, aux = _causal_lm_parts(model, batch)
    if aux is not None:
        loss_sum = loss_sum + MOE_AUX_COEF * aux * tok
    return loss_sum, tok


def causal_lm_loss(model, batch, generator=None) -> torch.Tensor:
    """Mean next-token loss over the unmasked positions of ``batch =
    {ids, labels[, mask, positions, segment_ids]}``, plus ``MOE_AUX_COEF``
    times the layer mean of an MoE model's aux terms."""
    loss_sum, tok, aux = _causal_lm_parts(model, batch)
    loss = loss_sum / tok.clamp(min=1.0)
    if aux is not None:
        loss = loss + MOE_AUX_COEF * aux
    return loss


def make_causal_lm_loss_sum(chunk_size: int = 0):
    """A ``(loss_sum, tok)`` loss whose head runs per sequence chunk: with
    ``chunk_size > 0`` each chunk's head matmul and cross entropy are
    checkpointed, so backward recomputes the chunk's logits and the full
    ``[B, S, V]`` logits never exist at once.  The chunk is the largest
    divisor of S that is ``<= chunk_size``.  Needs a model with
    ``hidden(ids, ...)`` and ``head(h)``; ``chunk_size == 0`` is
    :func:`causal_lm_loss_sum`."""
    if chunk_size == 0:
        return causal_lm_loss_sum

    def chunk_loss(model, h_c, y_c, m_c):
        per_tok = parallel_cross_entropy(model.head(h_c), y_c,
                                         tp=getattr(model, "tp", None))
        return torch.stack([(per_tok * m_c).sum(), m_c.sum()])

    def loss_fn(model, batch, generator=None):
        kw = _moe_kwargs(model)
        h = model.hidden(batch["ids"], **_packed_kwargs(batch), **kw)
        labels = batch["labels"]
        mask = _token_mask(batch)
        S = labels.shape[1]
        c = next(d for d in range(min(chunk_size, S), 0, -1) if S % d == 0)
        total = torch.zeros(2, dtype=torch.float32, device=h.device)
        # under FSDP the head is gathered once for every chunk and its
        # recompute, and its gradient reduce-scattered once
        with fsdp.reuse(model):
            for i in range(0, S, c):
                total = total + checkpoint(
                    chunk_loss, model, h[:, i:i + c], labels[:, i:i + c],
                    mask[:, i:i + c], use_reentrant=False)
        aux = _aux_mean(kw)
        if aux is not None:
            return total[0] + MOE_AUX_COEF * aux * total[1], total[1]
        return total[0], total[1]

    return loss_fn


def dense_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor] = None,
              causal: bool = False,
              q_offset: Optional[int] = None) -> torch.Tensor:
    """Multi-head attention core over this rank's heads, ``q/k/v [B, S, N,
    D]`` -> ``[B, S, N, D]`` in q's type (no collective: each rank computes
    its own heads).  Scores in fp32 (q and k widened, as JAX's
    ``preferred_element_type=float32``), scaled by ``1/sqrt(D)``; the
    causal mask keeps ``t <= s + q_offset`` (default ``T - S``: the queries
    are the last ``S`` of ``T`` positions; a context-parallel rank's chunk
    passes its own offset); ``mask`` (boolean,
    broadcastable to ``[B, N, S, T]``, True = attend) and the causal mask
    fill with the fp32 minimum; softmax in fp32, the probabilities cast to
    q's type before the PV product."""
    D = q.shape[-1]
    S, T = q.shape[1], k.shape[1]
    scores = torch.einsum("bsnd,btnd->bnst", q.float(), k.float())
    scores = scores / float(math.sqrt(D))
    low = torch.finfo(torch.float32).min
    if causal:
        t = torch.arange(T, device=q.device)
        s = torch.arange(S, device=q.device)
        off = T - S if q_offset is None else q_offset
        keep = t[None, :] <= s[:, None] + off
        scores = scores.masked_fill(~keep, low)
    if mask is not None:
        scores = scores.masked_fill(~mask.bool(), low)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bnst,btnd->bsnd", probs, v.to(q.dtype))


def fork_seeds(generator: torch.Generator, n: int) -> List[int]:
    """``n`` seeds drawn from ``generator``'s stream in one draw (a CUDA
    generator costs one host sync; a CPU generator none)."""
    return torch.randint(0, 2 ** 62, (n,), generator=generator,
                         device=generator.device).tolist()


def seeded_generator(seed: int, device) -> torch.Generator:
    """A fresh generator on ``device`` seeded with ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator], tp=None,
            dim: int = 1) -> torch.Tensor:
    """Inverted dropout as flax's ``nn.Dropout``: each element kept with
    probability ``1 - rate`` (a uniform draw from ``generator`` below it)
    and divided by it, in x's type.  ``generator=None`` or ``rate == 0`` is
    the identity (deterministic).  With ``tp`` (a :class:`..parallel.mesh.
    TensorParallel` of size > 1) ``x`` is this rank's slice along ``dim``
    (the sequence under sequence parallelism): the mask is the slice of
    the full-shape mask, the same draws as at tp = 1."""
    if generator is None or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    if tp is not None and tp.size > 1:
        full = list(x.shape)
        full[dim] *= tp.size
        u = torch.rand(full, generator=generator, device=x.device)
        keep = u.narrow(dim, tp.rank * x.shape[dim], x.shape[dim]) < keep_prob
    else:
        keep = torch.rand(x.shape, generator=generator,
                          device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


def build_pipelined_causal_lm(
        *, make_embed: Callable, make_block: Callable, make_head: Callable,
        embed_path: str, block_path: Callable[[int], str],
        head_places: Dict[str, str], block_fn: Callable,
        init_plan: Sequence, num_layers: int, hidden_size: int,
        vocab_size: int, dtype: torch.dtype, remat: str,
        sequence_parallel: bool, num_microbatches: int, seed: int = 0,
        schedule: str = "1f1b", pipeline_cuts=None,
        extra_keys: Sequence[str] = (), num_chunks: int = 1, device=None,
        block_aux: bool = False):
    """Shared pipeline wiring for the causal-LM families (JAX
    ``build_pipelined_causal_lm``): a family supplies its modules'
    factories (``make_*(device)``) and their pp = 1 names (``embed_path``,
    ``block_path(i)``, ``head_places``: the head module's children by
    path), ``block_fn(block, x, extras, sp, seq_len) -> y`` (``extras``:
    this microbatch's per-token arrays of ``extra_keys``, ``seq_len`` the
    whole sequence's length) and its random-init order ``init_plan``;
    this adds the vocab-parallel head loss, the remat policy per block,
    the sequence-parallel activation layout (a stage boundary carries a
    rank's sequence slice; at context-parallel degree > 1 the slice of
    its cp chunk, and ``seq_len`` is the chunk's, so ``block_fn`` places
    its positions at the cp rank's offset) and builds this rank's
    :class:`..pipeline.engine.PipelinedModel` on ``device``.
    ``block_aux``: ``block_fn`` returns ``(y, aux)`` (an MoE block's
    load-balancing term, ``MOE_AUX_COEF`` folded in) and the stage's run
    returns ``(x, the sum over its layers)`` for the engine's aux
    channel (JAX ``block_aux``)."""
    from neuronx_distributed_tpu_torch.parallel.mesh import TensorParallel
    from neuronx_distributed_tpu_torch.pipeline.engine import (
        build_pipelined_model,
    )
    from neuronx_distributed_tpu_torch.utils.device import resolve_device

    tp = TensorParallel.current()

    def run_fn(blocks, x, extras, sp):
        S = x.shape[1] * (tp.size if sp else 1)
        mode = remat if torch.is_grad_enabled() else "none"
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for blk in blocks:
            out = maybe_remat(
                lambda h, *ex, b=blk: block_fn(b, h, ex, sp, S), mode)(
                    x, *extras)
            if block_aux:
                x, a = out
                aux = aux + a.float()
            else:
                x = out
        return (x, aux) if block_aux else x

    def loss_fn(logits, labels):
        per_tok = parallel_cross_entropy(logits, labels, tp=tp)
        mask = (labels >= 0).float()
        return (per_tok * mask).sum(), mask.sum()

    parts: Dict[str, Any] = dict(
        make_embed=make_embed, make_block=make_block, make_head=make_head,
        embed_path=embed_path, block_path=block_path,
        head_places=dict(head_places),
        embed_fn=lambda embed, ids, sp: embed(ids, sp),
        run_fn=run_fn, head_fn=lambda head, h, sp: head(h, sp),
        loss_fn=loss_fn,
        sp_active=lambda S: sequence_parallel_active(sequence_parallel, tp,
                                                     S),
        init_plan=list(init_plan), hidden_size=hidden_size,
        vocab_size=vocab_size, dtype=dtype, tp=tp, block_aux=block_aux)
    return build_pipelined_model(
        parts, num_layers, num_microbatches, seed=seed, schedule=schedule,
        pipeline_cuts=pipeline_cuts, extra_keys=extra_keys,
        num_chunks=num_chunks, device=resolve_device(device))
