"""Training metrics (counterpart of
``neuronx_distributed_tpu/trainer/metrics.py``): moving-window throughput
and the 6N + attention FLOP count behind MFU."""

from __future__ import annotations

import time
from collections import deque
from typing import Optional


class Throughput:
    """Moving-average sequences per second over the last ``window_size``
    steps."""

    def __init__(self, batch_size: int, window_size: int = 10):
        self.batch_size = batch_size
        self.window: deque = deque(maxlen=window_size)
        self._last = time.time()
        self.peak = 0.0

    def step(self) -> float:
        now = time.time()
        self.window.append(now - self._last)
        self._last = now
        seqs_per_sec = self.batch_size * len(self.window) / max(
            sum(self.window), 1e-9)
        self.peak = max(self.peak, seqs_per_sec)
        return seqs_per_sec


def transformer_flops_per_token(
    num_layers: int,
    hidden: int,
    intermediate: int,
    vocab: int,
    seq_len: int,
    num_heads: Optional[int] = None,
    num_kv_heads: Optional[int] = None,
    head_dim: Optional[int] = None,
) -> float:
    """Approximate training FLOPs per token (fwd + bwd = 3x the forward
    matmul FLOPs): projections, MLP, the attention core at full ``seq_len``
    (the causal half is not discounted) and the LM head."""
    num_heads = num_heads or (hidden // 128)
    head_dim = head_dim or (hidden // num_heads)
    num_kv_heads = num_kv_heads or num_heads
    q_size = num_heads * head_dim
    kv_size = num_kv_heads * head_dim
    attn_proj = 2 * hidden * (q_size + 2 * kv_size) + 2 * q_size * hidden
    attn_core = 2 * 2 * seq_len * q_size  # qk^T + pv, per token
    mlp = 2 * 3 * hidden * intermediate  # gate, up, down
    per_layer = attn_proj + attn_core + mlp
    lm_head = 2 * hidden * vocab
    fwd = num_layers * per_layer + lm_head
    return 3.0 * fwd


def mfu(tokens_per_sec: float, flops_per_token: float,
        peak_flops: float) -> float:
    """Model FLOPs utilization against the device's peak rate."""
    return tokens_per_sec * flops_per_token / peak_flops
