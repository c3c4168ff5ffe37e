"""Training metrics (counterpart of
``neuronx_distributed_tpu/trainer/metrics.py``): moving-window throughput,
the 6N + attention FLOP count behind MFU, and the JSON results file."""

from __future__ import annotations

import json
import os
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
    num_experts: int = 1,
    top_k: int = 1,
) -> float:
    """Approximate training FLOPs per token (fwd + bwd = 3x the forward
    matmul FLOPs): projections, MLP, the attention core at full ``seq_len``
    (the causal half is not discounted) and the LM head.  An MoE model
    (``num_experts > 1``) counts its ACTIVE FLOPs: the router and the
    ``top_k`` experts a token runs (``top_k / num_experts`` of the expert
    parameters), not every expert."""
    num_heads = num_heads or (hidden // 128)
    head_dim = head_dim or (hidden // num_heads)
    num_kv_heads = num_kv_heads or num_heads
    q_size = num_heads * head_dim
    kv_size = num_kv_heads * head_dim
    attn_proj = 2 * hidden * (q_size + 2 * kv_size) + 2 * q_size * hidden
    attn_core = 2 * 2 * seq_len * q_size  # qk^T + pv, per token
    mlp = 2 * 3 * hidden * intermediate  # gate, up, down
    if num_experts > 1:
        mlp = top_k * mlp + 2 * hidden * num_experts   # experts + router
    per_layer = attn_proj + attn_core + mlp
    lm_head = 2 * hidden * vocab
    fwd = num_layers * per_layer + lm_head
    return 3.0 * fwd


def mfu(tokens_per_sec: float, flops_per_token: float,
        peak_flops: float) -> float:
    """Model FLOPs utilization against the device's peak rate."""
    return tokens_per_sec * flops_per_token / peak_flops


class TrainingMetrics:
    """JSON results file writer: ``update(**kw)`` then ``write()`` (a temp
    file and an atomic rename, so a crash mid-write leaves the previous
    complete file)."""

    def __init__(self, json_file: str):
        self.json_file = json_file
        self.metrics = {}

    def update(self, **kwargs) -> None:
        self.metrics.update(kwargs)

    def write(self) -> None:
        tmp = f"{self.json_file}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.metrics, f, indent=2)
        os.replace(tmp, self.json_file)
