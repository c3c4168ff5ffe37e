"""Gradient norm and clipping (counterpart of
``neuronx_distributed_tpu/parallel/grads.py``) over a list of gradients."""

from __future__ import annotations

from typing import Iterable, List, Tuple

import torch


def get_grad_norm(grads: Iterable[torch.Tensor],
                  norm_type: float = 2.0) -> torch.Tensor:
    """Global norm over ``grads`` (None entries skipped), accumulated in
    fp32."""
    grads = [g for g in grads if g is not None]
    if not grads:
        return torch.zeros((), dtype=torch.float32)
    if norm_type == 2.0:
        return torch.sqrt(sum(g.float().square().sum() for g in grads))
    if norm_type == float("inf"):
        return torch.stack([g.float().abs().max() for g in grads]).max()
    return sum((g.float().abs() ** norm_type).sum()
               for g in grads) ** (1.0 / norm_type)


def clip_grad_norm(grads: List[torch.Tensor], max_norm: float,
                   norm_type: float = 2.0, eps: float = 1e-6
                   ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Scale ``grads`` IN PLACE so their global norm is at most
    ``max_norm`` (``coeff = min(max_norm / (norm + eps), 1)``, applied in
    fp32); returns ``(grads, pre-clip norm)``.  The JAX function returns
    new arrays instead."""
    norm = get_grad_norm(grads, norm_type)
    coeff = torch.clamp(max_norm / (norm + eps), max=1.0)
    for g in grads:
        if g is not None:
            g.mul_(coeff)  # a 0-dim fp32 factor: computed in fp32
    return grads, norm
