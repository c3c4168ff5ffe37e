"""Trainer facade: config -> model and optimizer -> train step (counterpart
of ``neuronx_distributed_tpu/trainer/trainer.py``), one process a rank.

The port trains at any tensor-parallel degree, KV replication and
data-parallel degree, with sequence parallelism (the model config's
``sequence_parallel``) and ZeRO-1 (``optimizer.zero_one_enabled``): each
rank holds its shard, and the step does by hand what GSPMD derives in the
JAX step -- this rank's slice of the global batch, the loss sum and token
count over dp, the sequence-parallel and kvr gradient sums, the gradient
sum over dp (reduce-scattered under ZeRO-1, :mod:`..optimizer.zero1`) and
the global norm for clipping.  Pipeline (A15), context (A14) and expert
("Then") parallelism, FSDP (A11b) and ``trainable=`` (PEFT, A13) are not
ported yet and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Union

import torch
import torch.distributed as dist
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
from neuronx_distributed_tpu_torch.optimizer.zero1 import Zero1
from neuronx_distributed_tpu_torch.parallel import mappings, mesh
from neuronx_distributed_tpu_torch.parallel.grads import (
    allreduce_kv_replicated_gradients,
    allreduce_sequence_parallel_gradients,
    clip_grad_norm,
    get_grad_norm,
    psum_over_data_parallel,
)
from neuronx_distributed_tpu_torch.utils import distributed
from neuronx_distributed_tpu_torch.utils.device import resolve_device
from neuronx_distributed_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

# the degrees the trainer does not take yet, by the ROADMAP item that
# lifts each refusal
DEFERRED_DEGREES = {
    "pipeline_parallel_size": "the pipelined train step (ROADMAP A15)",
    "context_parallel_size": "ring and ulysses context parallelism "
                             "(ROADMAP A14)",
    "expert_parallel_size": "expert parallelism, with MoE (ROADMAP, "
                            "\"Then\")",
}


@dataclasses.dataclass
class ParallelModel:
    """The model and the device it lives on (reference ``NxDModel``)."""

    module: nn.Module
    device: torch.device

    def num_parameters(self) -> int:
        return sum(p.numel() for p in self.module.parameters())


@dataclasses.dataclass
class ParallelOptimizer:
    """The optimizer, its LR schedule (a float or ``count -> lr``), the
    number of updates taken (optax's ``count``) and, under ZeRO-1 at dp >
    1, the :class:`..optimizer.zero1.Zero1` whose shards the optimizer
    updates."""

    optimizer: torch.optim.Optimizer
    lr_schedule: Union[float, Callable[[int], float]]
    update_count: int = 0
    zero1: Optional[Zero1] = None

    def lr(self) -> float:
        """The rate of the next update."""
        s = self.lr_schedule
        return float(s(self.update_count) if callable(s) else s)


def _check_degrees(config: TrainingConfig) -> None:
    m = config.mesh
    for name, item in DEFERRED_DEGREES.items():
        value = getattr(m, name)
        if value > 1:
            raise NotImplementedError(f"{name}={value} is not ported yet: "
                                      f"{item}")
    if config.fsdp:
        raise NotImplementedError(
            "fsdp=True is not ported yet: ZeRO-3 placement of the "
            "parameters over dp (ROADMAP A11b); use zero_one_enabled")


def _initialize_parallel_state(config: TrainingConfig, device) -> None:
    """The parallel state from ``config.mesh`` when none is live (JAX
    ``initialize_parallel_model``).  Outside a world and at every degree 1
    nothing is started: a single process needs no groups."""
    if mesh.model_parallel_is_initialized():
        return
    m = config.mesh
    wants_world = (m.tensor_parallel_size > 1 or m.kv_size_multiplier > 1
                   or (m.data_parallel_size or 1) > 1)
    if not (wants_world or dist.is_initialized()):
        return
    distributed.initialize_distributed(device=device)
    mesh.initialize_model_parallel(
        tensor_parallel_size=m.tensor_parallel_size,
        pipeline_parallel_size=m.pipeline_parallel_size,
        context_parallel_size=m.context_parallel_size,
        expert_parallel_size=m.expert_parallel_size,
        kv_size_multiplier=m.kv_size_multiplier,
        data_parallel_size=m.data_parallel_size)


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
    ``init_random`` (tp-invariant: a rank's shard of the tp = 1 weights).
    The parallel state comes from ``config.mesh`` when none is live (the
    world from the ``torchrun`` environment).  Raises
    ``NotImplementedError`` for pipeline, context or expert degrees above
    1 and for ``fsdp``."""
    _check_degrees(config)
    dev = resolve_device(device)
    _initialize_parallel_state(config, dev)
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
    (a float or ``count -> lr``; default: the config's schedule).  With
    ``zero_one_enabled`` at data-parallel degree > 1 each rank keeps the
    states of its slice only (:class:`..optimizer.zero1.Zero1`).
    ``trainable=`` (PEFT) is not ported yet."""
    if trainable is not None:
        raise NotImplementedError(
            "trainable= (PEFT) is not ported yet (ROADMAP A13, PEFT training)")
    oc = config.optimizer
    lr = learning_rate if learning_rate is not None else build_lr_schedule(
        oc.learning_rate, oc.lr_schedule, oc.warmup_steps, oc.total_steps,
        oc.min_lr_ratio)
    params = [p for p in model.module.parameters() if p.requires_grad]
    zero1 = None
    dp = mesh.get_data_parallel_size()
    if oc.zero_one_enabled and dp > 1:
        zero1 = Zero1(params, mesh.get_data_parallel_group(), dp,
                      mesh.get_data_parallel_rank())
        params = zero1.shards
    opt = adamw_fp32(params, lr, b1=oc.beta1, b2=oc.beta2, eps=oc.eps,
                     weight_decay=oc.weight_decay)
    return ParallelOptimizer(optimizer=opt, lr_schedule=lr, zero1=zero1)


def _to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items() if v is not None}


def default_batch_spec() -> tuple:
    """The batch layout the steps take: dim 0 of every batch array split
    over the data-parallel axes (the JAX ``P(BATCH_AXES)``)."""
    return tuple(mesh.BATCH_AXES)


def _check_batch_spec(batch_spec) -> None:
    if batch_spec is not None and tuple(batch_spec) != default_batch_spec():
        raise NotImplementedError(
            f"batch_spec={batch_spec!r}: the port's steps take the global "
            f"batch split on dim 0 over the data-parallel axes "
            f"(default_batch_spec() = {default_batch_spec()})")


def data_parallel_slice(batch: Dict[str, Any], dp: int, rank: int,
                        grad_accum_steps: int = 1) -> Dict[str, Any]:
    """This data-parallel rank's rows of a global host batch: the batch is
    cut into ``grad_accum_steps`` microbatches first and the rank takes its
    ``1 / dp`` of each, so microbatch ``i`` of every rank is a slice of the
    global microbatch ``i`` (the JAX step's split under
    ``default_batch_spec``)."""
    out = {}
    for k, v in batch.items():
        if v is None:
            continue
        t = torch.as_tensor(v)
        n = t.shape[0]
        if n % (grad_accum_steps * dp):
            raise ValueError(
                f"batch dim {n} of {k!r} not divisible by grad_accum_steps "
                f"{grad_accum_steps} x data-parallel degree {dp}")
        per = n // (grad_accum_steps * dp)
        t = t.reshape(grad_accum_steps, dp, per, *t.shape[1:])[:, rank]
        out[k] = t.reshape(grad_accum_steps * per, *t.shape[2:])
    return out


class _DataParallel:
    """The data-parallel context of a step: degree, rank and group."""

    def __init__(self):
        self.size = mesh.get_data_parallel_size()
        self.rank = mesh.get_data_parallel_rank()
        self.group = (mesh.get_data_parallel_group()
                      if mesh.model_parallel_is_initialized() else None)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return mappings.all_reduce(t, self.group) if self.size > 1 else t


def _global_loss(out_sum, tok, token_weighted, n_parts, dp: _DataParallel):
    """The global loss and the gradient scale from this rank's summed
    losses (and token count): the exact token-masked mean over the global
    batch for ``(loss_sum, tok)`` losses, the mean of the ``n_parts``
    microbatch means of every rank otherwise."""
    sums = dp.sum(torch.stack([out_sum, tok]))
    if token_weighted:
        scale = 1.0 / sums[1].clamp(min=1.0)
    else:
        scale = torch.tensor(1.0 / (n_parts * dp.size),
                             device=out_sum.device)
    return sums[0] * scale, scale


def make_train_step(config: TrainingConfig, model: ParallelModel,
                    optimizer: ParallelOptimizer,
                    loss_fn: Optional[Callable[..., Any]] = None,
                    grad_accum_steps: int = 1, batch_spec=None):
    """The train step: ``step(batch, generator=None) -> {"loss",
    "grad_norm"}`` (0-dim tensors, the same on every rank).  ``batch`` is
    the GLOBAL host batch, the same on every rank; each data-parallel rank
    trains on its rows (:func:`data_parallel_slice`; ``batch_spec``: None
    or :func:`default_batch_spec`).  It updates the model's parameters and
    the optimizer's state IN PLACE, where the JAX step returns new ones and
    donates the old.

    ``loss_fn(model, batch)`` returns a scalar mean loss or ``(loss_sum,
    token_count)``.  ``generator`` is JAX's per-step ``rng``: without it
    the step calls ``loss_fn(model, batch)`` (deterministic, as JAX's
    ``rng=None``); with it ``loss_fn(model, batch, generator=g)``, where
    ``g`` is the step's generator itself, or, under ``grad_accum_steps >
    1`` or data-parallel degree > 1, one generator a microbatch and rank
    seeded from it (one draw), as JAX splits the key.  A CPU generator
    costs no host sync.

    With ``grad_accum_steps > 1`` the rank's rows are split into that many
    microbatches whose gradients are summed in fp32.  The token contract
    divides the summed losses and gradients by the global token count,
    summed over dp (the exact token-masked mean, however the masks fall
    over ranks and microbatches); the mean contract averages the
    microbatch means of every rank (exact when each carries the same
    tokens).  Then the sequence-parallel and kvr-replicated gradients are
    summed over their groups, every gradient over dp (reduce-scattered
    under ZeRO-1), the global norm clips them to ``max_grad_norm`` (when
    ``grad_clipping``), and AdamW takes one update at the schedule's rate
    for the update count (ZeRO-1: on this rank's slices, then the
    parameters are all-gathered)."""
    if loss_fn is None:
        raise ValueError("loss_fn is required")
    if grad_accum_steps < 1:
        raise ValueError(
            f"grad_accum_steps must be >= 1, got {grad_accum_steps}")
    _check_batch_spec(batch_spec)
    oc = config.optimizer
    module, device = model.module, model.device
    params = [p for p in module.parameters() if p.requires_grad]
    dp = _DataParallel()
    zero1 = optimizer.zero1

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
        if grad_accum_steps == 1 and dp.size == 1:
            return [generator]
        seeds = fork_seeds(generator, grad_accum_steps * dp.size)
        mine = seeds[dp.rank * grad_accum_steps:
                     (dp.rank + 1) * grad_accum_steps]
        return [seeded_generator(s, generator.device) for s in mine]

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
        loss, scale = _global_loss(loss_acc, tok_acc, token_weighted,
                                   grad_accum_steps, dp)
        for p in params:
            if p in acc32:
                p.grad = (acc32[p] * scale).to(p.dtype)
            elif p.grad is None:
                p.grad = torch.zeros_like(p)  # unused: still decayed
            else:
                p.grad.mul_(scale)
        return loss

    def step(batch, generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        if dp.size > 1:
            batch = data_parallel_slice(batch, dp.size, dp.rank,
                                        grad_accum_steps)
        batch = _to_device(batch, device)
        loss = loss_and_grads(batch, generator)
        allreduce_sequence_parallel_gradients(params)
        allreduce_kv_replicated_gradients(params)
        if zero1 is not None:
            grads = zero1.reduce_scatter_grads()
            owners, sliced = zero1.params, zero1.sliced
        else:
            grads = [p.grad for p in params]
            psum_over_data_parallel(grads, mean=False)
            owners, sliced = params, None
        if oc.grad_clipping:
            _, grad_norm = clip_grad_norm(grads, oc.max_grad_norm,
                                          params=owners, dp_sliced=sliced)
        else:
            grad_norm = get_grad_norm(grads, params=owners, dp_sliced=sliced)
        lr = optimizer.lr()
        for group in optimizer.optimizer.param_groups:
            group["lr"] = lr
        optimizer.optimizer.step()
        if zero1 is not None:
            zero1.all_gather_params()
            zero1.zero_grad()
        else:
            optimizer.optimizer.zero_grad(set_to_none=True)
        optimizer.update_count += 1
        return {"loss": loss, "grad_norm": grad_norm}

    return step


def make_eval_step(config: TrainingConfig, model: ParallelModel,
                   loss_fn: Optional[Callable[..., Any]] = None,
                   batch_spec=None):
    """A loss-only step for validation (JAX ``make_eval_step``): ``step(
    batch) -> {"loss"}`` over the global host batch, split over dp as the
    train step splits it, without gradients or an optimizer; the loss is
    normalized as the train step's."""
    if loss_fn is None:
        raise ValueError("loss_fn is required")
    _check_batch_spec(batch_spec)
    module, device = model.module, model.device
    dp = _DataParallel()

    @torch.no_grad()
    def step(batch) -> Dict[str, torch.Tensor]:
        if dp.size > 1:
            batch = data_parallel_slice(batch, dp.size, dp.rank)
        out = loss_fn(module, _to_device(batch, device))
        tw = isinstance(out, tuple)
        loss = out[0] if tw else out
        tok = (out[1].float() if tw
               else torch.zeros((), dtype=torch.float32, device=device))
        return {"loss": _global_loss(loss.detach().float(), tok, tw, 1,
                                     dp)[0]}

    return step
