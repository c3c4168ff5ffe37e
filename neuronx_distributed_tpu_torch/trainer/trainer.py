"""Trainer facade: config -> model and optimizer -> train step (counterpart
of ``neuronx_distributed_tpu/trainer/trainer.py``) on one device.

The port runs at tensor, data, pipeline, context and expert parallel
degree 1: :func:`initialize_parallel_model` refuses larger degrees (ROADMAP
A10-A11).  ZeRO-1 shards optimizer state over dp, so at dp = 1 there is
nothing to shard; it waits for the data-parallel slice.  FSDP, the
pipelined step and ``trainable=`` (PEFT) are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Union

import torch
from torch import nn

from neuronx_distributed_tpu_torch.config import TrainingConfig
from neuronx_distributed_tpu_torch.models.common import (
    fork_seeds,
    seeded_generator,
)
from neuronx_distributed_tpu_torch.optimizer.adamw_fp32 import (
    adamw_fp32,
    build_lr_schedule,
)
from neuronx_distributed_tpu_torch.parallel.grads import (
    clip_grad_norm,
    get_grad_norm,
)
from neuronx_distributed_tpu_torch.utils.device import resolve_device
from neuronx_distributed_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

MULTI_RANK_DEFERRED = ("is not ported yet: the port trains at every parallel "
                       "degree 1 on one card (ROADMAP A10-A11)")


@dataclasses.dataclass
class ParallelModel:
    """The model and the device it lives on (reference ``NxDModel``)."""

    module: nn.Module
    device: torch.device

    def num_parameters(self) -> int:
        return sum(p.numel() for p in self.module.parameters())


@dataclasses.dataclass
class ParallelOptimizer:
    """The optimizer, its LR schedule (a float or ``count -> lr``) and the
    number of updates taken (optax's ``count``)."""

    optimizer: torch.optim.Optimizer
    lr_schedule: Union[float, Callable[[int], float]]
    update_count: int = 0

    def lr(self) -> float:
        """The rate of the next update."""
        s = self.lr_schedule
        return float(s(self.update_count) if callable(s) else s)


def _check_degrees(config: TrainingConfig) -> None:
    m = config.mesh
    if m.pipeline_parallel_size > 1:
        raise NotImplementedError(
            f"pipeline_parallel_size={m.pipeline_parallel_size} "
            f"{MULTI_RANK_DEFERRED}")
    for name in ("tensor_parallel_size", "context_parallel_size",
                 "expert_parallel_size", "kv_size_multiplier",
                 "data_parallel_size"):
        value = getattr(m, name)
        if value not in (None, 1):
            raise NotImplementedError(f"{name}={value} {MULTI_RANK_DEFERRED}")
    if config.fsdp:
        raise NotImplementedError(f"fsdp=True {MULTI_RANK_DEFERRED}")


def _align_module_with_config(module: nn.Module, config: TrainingConfig,
                              device: torch.device) -> nn.Module:
    """Make ``TrainingConfig`` authoritative over the model's dtypes and
    (when ``activation_checkpoint.policy`` is set) its ``remat``: a model
    whose config disagrees is rebuilt from the corrected config."""
    policy = config.activation_checkpoint.policy
    mcfg = getattr(module, "config", None)
    if mcfg is None or not dataclasses.is_dataclass(mcfg):
        if policy is not None:
            raise ValueError(
                f"activation_checkpoint.policy={policy!r} is set but "
                f"{type(module).__name__} has no dataclass `config` to drive")
        return module
    overrides = {}
    for field, want in (("dtype", config.torch_compute_dtype),
                        ("param_dtype", config.torch_param_dtype)):
        if hasattr(mcfg, field) and getattr(mcfg, field) != want:
            overrides[field] = want
    if policy is not None:
        if not hasattr(mcfg, "remat"):
            raise ValueError(
                f"activation_checkpoint.policy={policy!r} is set but "
                f"{type(mcfg).__name__} has no `remat` field to drive")
        if mcfg.remat != policy:
            overrides["remat"] = policy
    if not overrides:
        return module
    cls = type(module)
    del module  # free the first build before the second
    logger.info("rebuilding %s from TrainingConfig: %s", cls.__name__,
                sorted(overrides))
    return cls(dataclasses.replace(mcfg, **overrides), device=device)


def initialize_parallel_model(config: TrainingConfig,
                              model_fn: Callable[[torch.device], nn.Module],
                              seed: Optional[int] = None,
                              device=None) -> ParallelModel:
    """Build the model with ``model_fn(device)`` on ``device`` (default
    CUDA; raises without it unless ``device="cpu"``), rebuild it if its
    config disagrees with ``config`` on dtypes or remat, and initialise its
    weights from ``seed`` (default ``config.seed``) when it has
    ``init_random``.  Raises ``NotImplementedError`` for any parallel
    degree above 1."""
    _check_degrees(config)
    dev = resolve_device(device)
    module = _align_module_with_config(model_fn(dev), config, dev)
    if hasattr(module, "init_random"):
        module.init_random(config.seed if seed is None else seed)
    module.train()
    model = ParallelModel(module=module, device=dev)
    logger.info("initialized model: %.2fM params on %s",
                model.num_parameters() / 1e6, dev)
    return model


def initialize_parallel_optimizer(config: TrainingConfig,
                                  model: ParallelModel,
                                  learning_rate=None,
                                  trainable=None) -> ParallelOptimizer:
    """AdamW with fp32 states over every parameter, at ``learning_rate``
    (a float or ``count -> lr``; default: the config's schedule).
    ``trainable=`` (PEFT) is not ported yet."""
    if trainable is not None:
        raise NotImplementedError(
            "trainable= (PEFT) is not ported yet (ROADMAP A13, PEFT training)")
    oc = config.optimizer
    lr = learning_rate if learning_rate is not None else build_lr_schedule(
        oc.learning_rate, oc.lr_schedule, oc.warmup_steps, oc.total_steps,
        oc.min_lr_ratio)
    opt = adamw_fp32(model.module.parameters(), lr, b1=oc.beta1, b2=oc.beta2,
                     eps=oc.eps, weight_decay=oc.weight_decay)
    return ParallelOptimizer(optimizer=opt, lr_schedule=lr)


def _to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items() if v is not None}


def make_train_step(config: TrainingConfig, model: ParallelModel,
                    optimizer: ParallelOptimizer,
                    loss_fn: Optional[Callable[..., Any]] = None,
                    grad_accum_steps: int = 1):
    """The train step: ``step(batch, generator=None) -> {"loss",
    "grad_norm"}`` (0-dim tensors).  It updates the model's parameters and
    the optimizer's state IN PLACE, where the JAX step returns new ones and
    donates the old.

    ``loss_fn(model, batch)`` returns a scalar mean loss or ``(loss_sum,
    token_count)``.  ``generator`` is JAX's per-step ``rng``: without it
    the step calls ``loss_fn(model, batch)`` (deterministic, as JAX's
    ``rng=None``); with it ``loss_fn(model, batch, generator=g)``, where
    ``g`` is the step's generator itself, or under ``grad_accum_steps > 1``
    one generator a microbatch seeded from it (one draw), as JAX splits the
    key.  A CPU generator costs no host sync.

    With ``grad_accum_steps > 1`` the batch's leading dim is split into
    that many microbatches whose gradients are summed in fp32; the mean
    contract then averages the per-microbatch means, the token contract
    divides the sums by the global token count once (the exact
    token-masked mean).  Then the gradients are clipped to
    ``max_grad_norm`` (when ``grad_clipping``), and AdamW takes one update
    at the schedule's rate for the update count.  Host batches (numpy or
    CPU tensors) are moved to the model's device inside the step."""
    if loss_fn is None:
        raise ValueError("loss_fn is required")
    if grad_accum_steps < 1:
        raise ValueError(
            f"grad_accum_steps must be >= 1, got {grad_accum_steps}")
    oc = config.optimizer
    module, device = model.module, model.device
    params = [p for p in module.parameters() if p.requires_grad]

    def split(batch):
        if grad_accum_steps == 1:
            return [batch]
        for k, v in batch.items():
            if v.shape[0] % grad_accum_steps:
                raise ValueError(f"batch dim {v.shape[0]} of {k!r} not "
                                 f"divisible by grad_accum_steps "
                                 f"{grad_accum_steps}")
        parts = {k: v.chunk(grad_accum_steps) for k, v in batch.items()}
        return [{k: parts[k][i] for k in batch}
                for i in range(grad_accum_steps)]

    def streams(generator):
        if generator is None:
            return [None] * grad_accum_steps
        if grad_accum_steps == 1:
            return [generator]
        return [seeded_generator(s, generator.device)
                for s in fork_seeds(generator, grad_accum_steps)]

    def loss_and_grads(batch, generator):
        loss_acc = torch.zeros((), dtype=torch.float32, device=device)
        tok_acc = torch.zeros((), dtype=torch.float32, device=device)
        # fp32 sums for parameters held in another type (fp32 params
        # accumulate in their own .grad)
        acc32 = {}
        token_weighted = None
        for mb, g in zip(split(batch), streams(generator)):
            out = (loss_fn(module, mb) if g is None
                   else loss_fn(module, mb, generator=g))
            tw = isinstance(out, tuple)
            if tw and len(out) != 2:
                raise ValueError("a tuple-returning loss_fn must return "
                                 f"(loss_sum, token_count), got {len(out)}")
            token_weighted = tw if token_weighted is None else token_weighted
            loss = out[0] if tw else out
            if tw:
                tok_acc = tok_acc + out[1].detach().float()
            loss.backward()
            loss_acc = loss_acc + loss.detach().float()
            if grad_accum_steps > 1:
                for p in params:
                    if p.grad is not None and p.dtype != torch.float32:
                        acc32[p] = acc32.get(p, 0) + p.grad.float()
                        p.grad = None
        if token_weighted:
            scale = 1.0 / tok_acc.clamp(min=1.0)
        else:
            scale = torch.tensor(1.0 / grad_accum_steps, device=device)
        for p in params:
            if p in acc32:
                p.grad = (acc32[p] * scale).to(p.dtype)
            elif p.grad is None:
                p.grad = torch.zeros_like(p)  # unused: still decayed
            else:
                p.grad.mul_(scale)
        return loss_acc * scale

    def step(batch, generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        batch = _to_device(batch, device)
        loss = loss_and_grads(batch, generator)
        grads = [p.grad for p in params]
        if oc.grad_clipping:
            _, grad_norm = clip_grad_norm(grads, oc.max_grad_norm)
        else:
            grad_norm = get_grad_norm(grads)
        lr = optimizer.lr()
        for group in optimizer.optimizer.param_groups:
            group["lr"] = lr
        optimizer.optimizer.step()
        optimizer.optimizer.zero_grad(set_to_none=True)
        optimizer.update_count += 1
        return {"loss": loss, "grad_norm": grad_norm}

    return step
