"""Cross entropy over the logits (counterpart of
``neuronx_distributed_tpu/parallel/loss.py``).

- :func:`vocab_parallel_cross_entropy`: the logits are this rank's vocab
  slice (``[..., V / tp]``, a column head's output) and the loss is
  computed without gathering the vocab: an all-reduce MAX of the row max,
  arithmetic target masking, one all-reduce SUM of the predicted logit and
  the sum-exp (and, with label smoothing, the shifted logits' sum over the
  full vocab), and a softmax-minus-one-hot backward (JAX's ``custom_vjp``,
  here a ``torch.autograd.Function``).
- :func:`parallel_cross_entropy`: the whole vocab at tp = 1; with ``tp`` (a
  :class:`.mesh.TensorParallel` of size > 1) the vocab-parallel form.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from neuronx_distributed_tpu_torch.parallel import mappings


class _VocabParallelCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets, label_smoothing, group):
        n = mappings.group_size(group)
        v_local = logits.shape[-1]
        vocab = v_local * n
        start = mappings.group_rank(group) * v_local
        x = logits.float()
        m = mappings.all_reduce(x.amax(dim=-1), group, op=dist.ReduceOp.MAX)
        shifted = x - m[..., None]
        # arithmetic masking: a target on another rank's slice reads index
        # 0 here and is zeroed
        local = targets.long() - start
        in_range = (local >= 0) & (local < v_local)
        clipped = local.clamp(0, v_local - 1)
        pred = shifted.gather(-1, clipped[..., None])[..., 0] * in_range
        exp_shifted = torch.exp(shifted)
        parts = [pred, exp_shifted.sum(dim=-1)]
        if label_smoothing > 0.0:
            parts.append(shifted.sum(dim=-1))
        sums = mappings.all_reduce(torch.stack(parts), group)
        pred, sum_exp = sums[0], sums[1]
        log_z = torch.log(sum_exp)
        loss = log_z - pred
        if label_smoothing > 0.0:
            smooth = log_z - sums[2] / vocab
            loss = (1.0 - label_smoothing) * loss + label_smoothing * smooth
        ctx.save_for_backward(exp_shifted, sum_exp, clipped, in_range)
        ctx.label_smoothing, ctx.vocab = label_smoothing, vocab
        ctx.in_dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        exp_shifted, sum_exp, clipped, in_range = ctx.saved_tensors
        grad = exp_shifted / sum_exp[..., None]
        onehot = torch.zeros_like(grad).scatter_(
            -1, clipped[..., None], in_range[..., None].to(grad.dtype))
        if ctx.label_smoothing > 0.0:
            onehot = ((1.0 - ctx.label_smoothing) * onehot
                      + ctx.label_smoothing / ctx.vocab)
        grad = (grad - onehot) * g[..., None]
        return grad.to(ctx.in_dtype), None, None, None


def vocab_parallel_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                                 label_smoothing: float = 0.0,
                                 group=None) -> torch.Tensor:
    """Per-token loss ``[...]`` (fp32, the same on every rank) from this
    rank's vocab slice ``logits [..., V / tp]`` of the ``group`` (default
    the tensor-parallel group) and the targets ``[...]`` (the same on every
    rank).  A target outside ``[0, V)`` (an ignore label) gives ``log Z``;
    callers mask it out."""
    group = mappings._group(group)
    return _VocabParallelCrossEntropy.apply(logits, targets,
                                            float(label_smoothing), group)


def parallel_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                           label_smoothing: float = 0.0,
                           tp=None) -> torch.Tensor:
    """Per-token loss ``[...]`` from logits ``[..., V]``, in fp32: a
    logsumexp shifted by the (gradient-free) row max, targets clipped into
    ``[0, V)`` so ignore labels (< 0) stay finite -- callers mask them out
    -- and optional label smoothing against the mean log-probability.
    ``tp`` (the model's :class:`.mesh.TensorParallel`): at size > 1 the
    logits are its vocab slice and :func:`vocab_parallel_cross_entropy`
    computes the same loss."""
    if tp is not None and tp.size > 1:
        return vocab_parallel_cross_entropy(logits, targets, label_smoothing,
                                            tp.group)
    logits = logits.float()
    m = logits.amax(dim=-1, keepdim=True).detach()
    shifted = logits - m
    log_z = torch.log(torch.exp(shifted).sum(dim=-1))
    safe = targets.long().clamp(0, logits.shape[-1] - 1)
    pred = shifted.gather(-1, safe[..., None])[..., 0]
    nll = log_z - pred
    if label_smoothing > 0.0:
        smooth = log_z - shifted.mean(dim=-1)
        return (1.0 - label_smoothing) * nll + label_smoothing * smooth
    return nll

