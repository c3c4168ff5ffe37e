"""Attention-head padding so the head counts divide the tensor-parallel
degree (counterpart of ``neuronx_distributed_tpu/parallel/pad.py``).

:func:`pad_llama_params` transforms a Llama ``state_dict`` (the port's
flat names, e.g. ``model.layer_0.attn.qkv.q_kernel``): Q/K/V kernels and
biases gain zero heads and the attention output projection gains zero
input rows, so the padded model computes the same function -- a padded
head's attention output meets only zero rows of ``o_proj``.  Q heads are
kv-major (q head ``j * G + g`` reads kv head ``j``), so the group size
``G = heads / kv_heads`` must stay: appended zero q-head groups then pair
exactly with the appended zero kv heads.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import torch


def pad_axis_to(x: torch.Tensor, axis: int, new_size: int) -> torch.Tensor:
    """``x`` zero-padded along ``axis`` up to ``new_size``."""
    old = x.shape[axis]
    if old == new_size:
        return x
    if old > new_size:
        raise ValueError(f"cannot pad axis {axis} from {old} down to "
                         f"{new_size}")
    shape = list(x.shape)
    shape[axis] = new_size - old
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def pad_llama_params(params: Mapping[str, torch.Tensor], old_heads: int,
                     new_heads: int, head_dim: int,
                     old_kv_heads: Optional[int] = None,
                     new_kv_heads: Optional[int] = None
                     ) -> Dict[str, torch.Tensor]:
    """A Llama ``state_dict`` padded from ``old_heads`` to ``new_heads`` q
    heads (kv counts default to the q counts, MHA).  The group size must
    stay: ``new_heads / new_kv_heads == old_heads / old_kv_heads``.  Load
    the result into a model built with the padded counts."""
    old_kv = old_heads if old_kv_heads is None else old_kv_heads
    new_kv = new_heads if new_kv_heads is None else new_kv_heads
    if old_heads % old_kv or new_heads % new_kv:
        raise ValueError("q heads must be a multiple of kv heads")
    if old_heads // old_kv != new_heads // new_kv:
        raise ValueError(
            f"padding must preserve the q-per-kv group size: "
            f"{old_heads}/{old_kv} != {new_heads}/{new_kv}")

    def pad(name: str, t: torch.Tensor) -> torch.Tensor:
        if re.search(r"qkv\.q_(kernel|bias)$", name):
            return pad_axis_to(t, t.ndim - 2, new_heads)
        if re.search(r"qkv\.(k|v)_(kernel|bias)$", name):
            return pad_axis_to(t, t.ndim - 2, new_kv)
        if re.search(r"o_proj\.kernel$", name):
            return pad_axis_to(t, 0, new_heads * head_dim)
        return t

    return {name: pad(name, t) for name, t in params.items()}
