"""Cross entropy over the logits (counterpart of
``neuronx_distributed_tpu/parallel/loss.py:parallel_cross_entropy``) at
tensor-parallel degree 1, where the vocab is not sharded."""

from __future__ import annotations

import torch


def parallel_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                           label_smoothing: float = 0.0) -> torch.Tensor:
    """Per-token loss ``[...]`` from logits ``[..., V]``, in fp32: a
    logsumexp shifted by the (gradient-free) row max, targets clipped into
    ``[0, V)`` so ignore labels (< 0) stay finite -- callers mask them out
    -- and optional label smoothing against the mean log-probability."""
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
