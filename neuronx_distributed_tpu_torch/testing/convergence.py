"""Convergence-parity oracle (counterpart of
``neuronx_distributed_tpu/testing/convergence.py``).

A candidate run's metric curve is EMA-smoothed (TensorBoard's smoothing)
and compared point by point with a smoothed golden curve after a warmup;
the run passes when every later deviation is within ``tolerance_pct``.
Curves come from plain lists or the JSONL scalar streams of
:mod:`..trainer.scalar_log` (the same format as the JAX package's).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence


def smoothed(values: Sequence[float], weight: float = 0.6) -> List[float]:
    """TensorBoard-style EMA smoothing."""
    if not 0.0 <= weight < 1.0:
        raise ValueError(f"smoothing weight must be in [0, 1), got {weight}")
    out: List[float] = []
    last: Optional[float] = None
    for v in values:
        last = v if last is None else last * weight + (1.0 - weight) * v
        out.append(last)
    return out


@dataclasses.dataclass(frozen=True)
class CurveComparison:
    ok: bool
    max_deviation_pct: float
    worst_step: int
    compared_points: int

    def __bool__(self) -> bool:  # truthy = passed
        return self.ok


def compare_curves(candidate: Sequence[float], golden: Sequence[float],
                   warmup_steps: int = 0, tolerance_pct: float = 1.0,
                   smoothing: float = 0.6) -> CurveComparison:
    """Smoothed point-wise comparison after ``warmup_steps``; the curves
    are step-aligned and the shorter bounds the comparison."""
    n = min(len(candidate), len(golden))
    if n <= warmup_steps:
        raise ValueError(
            f"curves have {n} aligned points but warmup is {warmup_steps}")
    cs = smoothed(candidate[:n], smoothing)
    gs = smoothed(golden[:n], smoothing)
    worst, worst_step = 0.0, warmup_steps
    for i in range(warmup_steps, n):
        dev = 100.0 * abs(cs[i] - gs[i]) / max(abs(gs[i]), 1e-12)
        if dev > worst:
            worst, worst_step = dev, i
    return CurveComparison(ok=worst <= tolerance_pct, max_deviation_pct=worst,
                           worst_step=worst_step,
                           compared_points=n - warmup_steps)


def compare_scalar_logs(candidate_dir: str, golden_dir: str,
                        tag: str = "loss", warmup_steps: int = 0,
                        tolerance_pct: float = 1.0,
                        smoothing: float = 0.6) -> CurveComparison:
    """Compare two JSONL scalar streams by tag."""
    from neuronx_distributed_tpu_torch.trainer.scalar_log import read_scalars

    def curve(d):
        recs = sorted(read_scalars(d, tag), key=lambda r: r["step"])
        return [r["value"] for r in recs]

    return compare_curves(curve(candidate_dir), curve(golden_dir),
                          warmup_steps, tolerance_pct, smoothing)
