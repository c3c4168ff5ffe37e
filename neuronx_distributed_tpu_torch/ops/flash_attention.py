"""Attention-mask helpers shared by the dense core and the paged kernel.

Counterpart of ``neuronx_distributed_tpu/ops/flash_attention.py``.  Only
the pieces the serving path needs are here: the finite masking sentinel and
the one causal(+sliding-window) band-mask definition.  The flash kernels
themselves belong to the training slice.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

NEG_INF = float(-1e30)  # large-negative instead of -inf: keeps exp/where NaN-free


def band_mask(q_len: int, kv_len: int,
              q_offset: Union[int, torch.Tensor] = 0,
              window: Optional[int] = None,
              device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """Boolean ``[q_len, kv_len]`` causal(+sliding-window) mask, True =
    attend: q position i (global ``i + q_offset``) attends kv positions
    ``<=`` its own and, with ``window``, no further back than ``window - 1``
    positions.  A ``[B]`` tensor ``q_offset`` gives one mask per row,
    ``[B, q_len, kv_len]``."""
    if window is not None and window < 1:
        raise ValueError(f"sliding window must be >= 1, got {window}")
    q_pos = torch.arange(q_len, device=device)[:, None]
    if isinstance(q_offset, torch.Tensor) and q_offset.ndim == 1:
        q_pos = q_pos[None] + q_offset.to(device)[:, None, None]
    else:
        q_pos = q_pos + q_offset
    kv_pos = torch.arange(kv_len, device=device)
    mask = kv_pos <= q_pos
    if window is not None:
        mask = mask & (kv_pos > q_pos - window)
    return mask
