"""AdamW with fp32 optimizer states, and the LR schedule (counterpart of
``neuronx_distributed_tpu/optimizer/adamw_fp32.py``).

The JAX package uses ``optax.adamw(mu_dtype=fp32)`` over fp32 master
params.  ``torch.optim.AdamW`` (its default foreach path; never
``fused=True``) over fp32 params computes the same update: moments
``m = b1 m + (1 - b1) g`` and ``v = b2 v + (1 - b2) g^2`` in fp32, bias
correction by the update count, ``eps`` outside the square root, and
decoupled weight decay ``lr * wd * p`` on every parameter.  The schedule
is a function of the update count, read before each update (optax's
``count``, 0 for the first update).

Every step of the update is elementwise, so AdamW over a rank's ZeRO-1
state shards (:class:`.zero1.Zero1`: contiguous fp32 slices of the
parameters, their gradients' slices) computes, element for element, the
replicated optimizer's update on the same values: the shards go to the
same ``torch.optim.AdamW`` (the same foreach kernels on the card).
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional, Union

import torch

Schedule = Callable[[int], float]


def adamw_fp32(params: Iterable[torch.nn.Parameter],
               learning_rate: Union[float, Schedule],
               b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
               weight_decay: float = 0.01) -> torch.optim.AdamW:
    """AdamW over ``params`` (fp32 masters keep fp32 moments; or a rank's
    ZeRO-1 shards, leaf tensors whose ``grad`` the step sets).  A schedule
    is applied by the train step, which sets the group's ``lr`` to
    ``schedule(count)`` before each update; the optimizer starts at
    ``schedule(0)``."""
    lr0 = learning_rate(0) if callable(learning_rate) else learning_rate
    return torch.optim.AdamW(params, lr=float(lr0), betas=(b1, b2), eps=eps,
                             weight_decay=weight_decay, foreach=None,
                             fused=False)


def _linear(init: float, end: float, steps: int) -> Schedule:
    def f(count: int) -> float:
        c = min(max(count, 0), steps)
        return (init - end) * (1.0 - c / steps) + end
    return f


def _cosine(init: float, decay_steps: int, alpha: float) -> Schedule:
    def f(count: int) -> float:
        c = min(max(count, 0), decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
        return init * ((1.0 - alpha) * cosine + alpha)
    return f


def build_lr_schedule(learning_rate: float, schedule: str = "constant",
                      warmup_steps: int = 0,
                      total_steps: Optional[int] = None,
                      min_lr_ratio: float = 0.0
                      ) -> Union[float, Schedule]:
    """``constant`` | ``linear`` (warmup, then linear decay to
    ``min_lr_ratio * lr``) | ``cosine`` (warmup, then cosine decay to the
    same floor), as optax's ``join_schedules`` of a linear warmup and the
    decay; a plain float for a constant rate without warmup.
    ``total_steps`` is required for the decaying schedules."""
    if schedule == "constant" and warmup_steps == 0:
        return learning_rate
    floor = learning_rate * min_lr_ratio
    warmup = _linear(0.0 if warmup_steps else learning_rate, learning_rate,
                     max(warmup_steps, 1))
    if schedule == "constant":
        decay: Schedule = lambda count: learning_rate  # noqa: E731
    elif schedule in ("linear", "cosine"):
        if total_steps is None:
            raise ValueError(f"lr_schedule={schedule!r} requires total_steps")
        decay_steps = max(total_steps - warmup_steps, 1)
        decay = (_linear(learning_rate, floor, decay_steps)
                 if schedule == "linear"
                 else _cosine(learning_rate, decay_steps, min_lr_ratio))
    else:
        raise ValueError(
            f"unknown lr_schedule {schedule!r} (constant | linear | cosine)")

    def joined(count: int) -> float:
        return warmup(count) if count < warmup_steps else decay(
            count - warmup_steps)

    return joined
