"""Trainer facade: config -> model and optimizer -> train step (counterpart
of ``neuronx_distributed_tpu/trainer/trainer.py``), one process a rank.

The port trains at any tensor-parallel degree, KV replication,
data-parallel, expert-parallel and context-parallel degree, with sequence
parallelism (the
model config's ``sequence_parallel``) and ZeRO-1
(``optimizer.zero_one_enabled``): each rank holds its shard, and the step
does by hand what GSPMD derives in the JAX step -- this rank's rows of
the global batch and, at cp > 1, its contiguous ``S / cp`` of every
sequence (:func:`context_parallel_slice`; a zigzag model takes the batch
already in ``zigzag_permute`` order), the loss sum and token count over
dp and cp, the gradient sum over cp (parameters are replicated over cp as
over dp), the sequence-parallel and kvr gradient sums, the gradient sum
over dp (reduce-scattered under ZeRO-1, :mod:`..optimizer.zero1`, which
shards over dp only) and the global norm for clipping.  ``fsdp=True``
cuts the parameters themselves over dp (:mod:`..parallel.fsdp`: gathered
before each use, their gradients reduce-scattered in backward).
``initialize_parallel_optimizer(trainable=)`` freezes the parameters its
predicate rejects (PEFT: ``peft.lora_trainable``).  At pipeline degree >
1 the model is a :class:`..pipeline.engine.PipelinedModel` (this rank's
stage, from the module's ``build_pipelined``) and the step runs its
schedule (:func:`make_pipelined_train_step`): the gradient sums over tp,
dp (ZeRO-1 inside a stage) and the norm over every stage are the same
code.  At expert-parallel degree > 1 (an MoE model: ``parallel.moe``)
the batch splits over dp x ep as over data parallelism, and a rank holds
``E / ep`` experts: an expert's gradient, which already holds every token
of its routing group, is summed over the pure dp axis only, its ZeRO-1
state stays whole and FSDP leaves it whole (the JAX specs naming ``ep``);
every other parameter's gradient sums over dp x ep.
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
from neuronx_distributed_tpu_torch.parallel import fsdp, mappings, mesh
from neuronx_distributed_tpu_torch.parallel.moe import is_expert_parallel
from neuronx_distributed_tpu_torch.parallel.grads import (
    allreduce_expert_gradients,
    allreduce_kv_replicated_gradients,
    allreduce_sequence_parallel_gradients,
    clip_grad_norm,
    coalesced_all_reduce,
    get_grad_norm,
    psum_over_data_parallel,
)
from neuronx_distributed_tpu_torch.pipeline.engine import PipelinedModel
from neuronx_distributed_tpu_torch.utils import distributed
from neuronx_distributed_tpu_torch.utils.device import resolve_device
from neuronx_distributed_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

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
    # parameter name -> trainable, under ``trainable=`` (None: all train)
    update_mask: Optional[Dict[str, bool]] = None

    def lr(self) -> float:
        """The rate of the next update."""
        s = self.lr_schedule
        return float(s(self.update_count) if callable(s) else s)


def _check_degrees(config: TrainingConfig) -> None:
    m = config.mesh
    if config.fsdp and m.pipeline_parallel_size > 1:
        raise ValueError(
            "fsdp=True requires pipeline_parallel_size == 1: a pipeline "
            "stage's parameters stay replicated along dp (use "
            "zero_one_enabled for state sharding)")


def _initialize_parallel_state(config: TrainingConfig, device) -> None:
    """The parallel state from ``config.mesh`` when none is live (JAX
    ``initialize_parallel_model``).  Outside a world and at every degree 1
    nothing is started: a single process needs no groups."""
    if mesh.model_parallel_is_initialized():
        return
    m = config.mesh
    wants_world = (m.tensor_parallel_size > 1 or m.kv_size_multiplier > 1
                   or m.context_parallel_size > 1
                   or m.pipeline_parallel_size > 1
                   or m.expert_parallel_size > 1
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
                              device=None
                              ) -> Union[ParallelModel, PipelinedModel]:
    """Build the model with ``model_fn(device)`` on ``device`` (default
    CUDA; raises without it unless ``device="cpu"``), rebuild it if its
    config disagrees with ``config`` on dtypes or remat, and initialise its
    weights from ``seed`` (default ``config.seed``) when it has
    ``init_random`` (tp-invariant: a rank's shard of the tp = 1 weights).
    With ``config.fsdp`` at data-parallel degree > 1 the parameters are
    then cut over dp (:func:`..parallel.fsdp.shard_module`; load weights
    afterwards through ``convert.fsdp_shard_for_rank``).  The parallel
    state comes from ``config.mesh`` when none is live (the world from the
    ``torchrun`` environment).

    At ``pipeline_parallel_size > 1`` the model is built on the ``meta``
    device (no memory) and its ``build_pipelined(num_microbatches,
    schedule, seed, [pipeline_cuts], [packed], [num_chunks], device)``
    gives this rank's :class:`..pipeline.engine.PipelinedModel` (the
    Llama and GPT-NeoX families have it) from ``config.pipeline``: its
    stage holds the pp = 1 model's weights from ``seed`` for its pieces.
    Raises ``ValueError`` for ``fsdp`` with a pipeline."""
    _check_degrees(config)
    dev = resolve_device(device)
    _initialize_parallel_state(config, dev)
    if config.mesh.pipeline_parallel_size > 1:
        return _initialize_pipelined_model(config, model_fn, seed, dev)
    module = _align_module_with_config(model_fn(dev), config, dev)
    if hasattr(module, "init_random"):
        module.init_random(config.seed if seed is None else seed)
    if config.fsdp and mesh.get_data_parallel_size() > 1:
        fsdp.shard_module(module, mesh.get_data_parallel_group(),
                          mesh.get_data_parallel_size(),
                          mesh.get_data_parallel_rank())
    module.train()
    model = ParallelModel(module=module, device=dev)
    logger.info("initialized model: %.2fM params on %s",
                model.num_parameters() / 1e6, dev)
    return model


def _initialize_pipelined_model(config: TrainingConfig, model_fn,
                                seed: Optional[int], dev) -> PipelinedModel:
    meta = torch.device("meta")
    module = _align_module_with_config(model_fn(meta), config, meta)
    build = getattr(module, "build_pipelined", None)
    if build is None:
        raise ValueError(
            f"pipeline_parallel_size={config.mesh.pipeline_parallel_size} "
            f"but {type(module).__name__} has no build_pipelined(); use a "
            "pipeline-capable model family or pp=1")
    pc = config.pipeline
    extra = {}
    if pc.pipeline_cuts is not None:
        extra["pipeline_cuts"] = pc.pipeline_cuts
    if pc.packed_inputs:
        extra["packed"] = True
    if pc.virtual_stages > 1 or pc.schedule == "interleaved":
        extra["num_chunks"] = pc.virtual_stages
    model = build(num_microbatches=pc.num_microbatches,
                    schedule=pc.schedule,
                    seed=config.seed if seed is None else seed, device=dev,
                    **extra)
    model.module.train()
    logger.info("initialized pipelined stage %d of %d: %.2fM params, "
                "schedule=%s, microbatches=%d",
                mesh.get_pipeline_parallel_rank(),
                mesh.get_pipeline_parallel_size(),
                model.num_parameters() / 1e6, pc.schedule,
                pc.num_microbatches)
    return model


def initialize_parallel_optimizer(config: TrainingConfig,
                                  model: ParallelModel,
                                  learning_rate=None,
                                  trainable=None) -> ParallelOptimizer:
    """AdamW with fp32 states over every parameter, at ``learning_rate``
    (a float or ``count -> lr``; default: the config's schedule).  With
    ``zero_one_enabled`` at data-parallel degree > 1 each rank keeps the
    states of its slice only (:class:`..optimizer.zero1.Zero1`).
    Under FSDP the optimizer takes the parameters' pieces (their states
    are cut as they are) and ZeRO-1 has nothing left to do.

    ``trainable`` (a predicate over parameter names, ``model.layer_0.attn.
    qkv.lora_a_q`` ...) freezes every parameter it rejects: frozen
    parameters get ``requires_grad=False``, so they take no gradient, no
    update and no AdamW state, and the train step's gradient sums, ZeRO-1
    slices and global norm see only the trainable ones (the JAX
    ``optax.set_to_zero`` branch, with its ``update_mask``)."""
    oc = config.optimizer
    update_mask = None
    if trainable is not None:
        update_mask = {}
        for name, p in model.module.named_parameters():
            update_mask[name] = bool(trainable(name))
            p.requires_grad_(update_mask[name])
        n_train = sum(p.numel() for p in model.module.parameters()
                      if p.requires_grad)
        logger.info("trainable filter active: %.3fM of %.3fM params update",
                    n_train / 1e6, model.num_parameters() / 1e6)
    lr = learning_rate if learning_rate is not None else build_lr_schedule(
        oc.learning_rate, oc.lr_schedule, oc.warmup_steps, oc.total_steps,
        oc.min_lr_ratio)
    params = [p for p in model.module.parameters() if p.requires_grad]
    zero1 = None
    dp = mesh.get_data_parallel_size()
    if oc.zero_one_enabled and dp > 1 and \
            fsdp.fsdp_state(model.module) is None:
        zero1 = Zero1(params, mesh.get_data_parallel_group(), dp,
                      mesh.get_data_parallel_rank(),
                      mesh.get_expert_data_parallel_group())
        params = zero1.shards
    opt = adamw_fp32(params, lr, b1=oc.beta1, b2=oc.beta2, eps=oc.eps,
                     weight_decay=oc.weight_decay)
    return ParallelOptimizer(optimizer=opt, lr_schedule=lr, zero1=zero1,
                             update_mask=update_mask)


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


def context_parallel_slice(batch: Dict[str, Any], cp: int,
                           rank: int) -> Dict[str, Any]:
    """This context-parallel rank's contiguous ``S / cp`` of every sequence
    array (dim 1 of each array with one: ids, labels, positions, segment
    ids, masks); per-row arrays pass whole.  A zigzag model's batch
    arrives in ``zigzag_permute`` order, so rank i's contiguous chunk is
    its half-chunk pair."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if t.ndim >= 2:
            S = t.shape[1]
            if S % cp:
                raise ValueError(f"sequence length {S} not divisible by cp "
                                 f"degree {cp}")
            t = t.narrow(1, rank * (S // cp), S // cp)
        out[k] = t
    return out


class _DataParallel:
    """The batch-parallel context of a step: the data-parallel degree,
    rank and group, and the context-parallel group (the batch's sequence
    is cut over it, so losses and gradients sum over it too)."""

    def __init__(self):
        live = mesh.model_parallel_is_initialized()
        self.size = mesh.get_data_parallel_size()
        self.rank = mesh.get_data_parallel_rank()
        self.group = mesh.get_data_parallel_group() if live else None
        self.cp_size = mesh.get_context_parallel_size()
        self.cp_rank = mesh.get_context_parallel_rank()
        self.cp_group = mesh.get_context_parallel_group() if live else None

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over dp and cp."""
        if self.size > 1:
            t = mappings.all_reduce(t, self.group)
        if self.cp_size > 1:
            t = mappings.all_reduce(t, self.cp_group)
        return t

    def slice(self, batch, grad_accum_steps: int = 1):
        """This rank's part of the global host batch: its dp rows, then its
        cp chunk of each sequence."""
        if self.size > 1:
            batch = data_parallel_slice(batch, self.size, self.rank,
                                        grad_accum_steps)
        if self.cp_size > 1:
            batch = context_parallel_slice(batch, self.cp_size, self.cp_rank)
        return batch


def _global_loss(out_sum, tok, token_weighted, n_parts, dp: _DataParallel):
    """The global loss and the gradient scale from this rank's summed
    losses (and token count): the exact token-masked mean over the global
    batch for ``(loss_sum, tok)`` losses, the mean of the ``n_parts``
    microbatch means of every dp and cp rank otherwise."""
    sums = dp.sum(torch.stack([out_sum, tok]))
    if token_weighted:
        scale = 1.0 / sums[1].clamp(min=1.0)
    else:
        # a fill, not a host-to-device copy: no sync inside the step
        scale = torch.full((), 1.0 / (n_parts * dp.size * dp.cp_size),
                           dtype=torch.float32, device=out_sum.device)
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
    under ZeRO-1; an FSDP piece's was reduce-scattered in backward), the
    global norm clips them to ``max_grad_norm`` (when
    ``grad_clipping``), and AdamW takes one update at the schedule's rate
    for the update count (ZeRO-1: on this rank's slices, then the
    parameters are all-gathered).

    A :class:`..pipeline.engine.PipelinedModel` goes to
    :func:`make_pipelined_train_step` (its schedule's loss replaces
    ``loss_fn``; ``grad_accum_steps`` raises, as in JAX: the schedule
    accumulates over its microbatches)."""
    if isinstance(model, PipelinedModel):
        if grad_accum_steps != 1:
            raise ValueError(
                "grad_accum_steps does not apply to pipelined models -- the "
                "schedule already accumulates over pipeline.num_microbatches;"
                " raise that instead")
        _check_batch_spec(batch_spec)
        return make_pipelined_train_step(config, model, optimizer)
    if loss_fn is None:
        raise ValueError("loss_fn is required")
    if grad_accum_steps < 1:
        raise ValueError(
            f"grad_accum_steps must be >= 1, got {grad_accum_steps}")
    _check_batch_spec(batch_spec)
    module, device = model.module, model.device
    params = [p for p in module.parameters() if p.requires_grad]
    dp = _DataParallel()
    update = _make_update(config, module, optimizer, params, dp)

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
        batch = _to_device(dp.slice(batch, grad_accum_steps), device)
        loss = loss_and_grads(batch, generator)
        return {"loss": loss, "grad_norm": update()}

    return step


def _make_update(config: TrainingConfig, module: nn.Module,
                 optimizer: ParallelOptimizer, params, dp: _DataParallel):
    """``update() -> grad_norm``: the step's tail once the parameters'
    ``.grad`` hold this rank's normalized gradients -- the cp, sequence-
    parallel and kvr sums, the dp sum (ZeRO-1's reduce-scatter; an
    expert's over the pure dp axis), the global norm and clipping, and one
    AdamW update."""
    oc = config.optimizer
    zero1 = optimizer.zero1
    sharded = fsdp.fsdp_state(module) is not None

    def update() -> torch.Tensor:
        if dp.cp_size > 1:
            coalesced_all_reduce([p.grad for p in params], dp.cp_group)
        allreduce_sequence_parallel_gradients(params)
        allreduce_kv_replicated_gradients(params)
        if zero1 is not None:
            grads = zero1.reduce_scatter_grads()
            owners, sliced = zero1.params, zero1.sliced
        else:
            grads = [p.grad for p in params]
            psum_over_data_parallel(
                [g for p, g in zip(params, grads)
                 if not (fsdp.is_sharded(p) or is_expert_parallel(p))],
                mean=False)
            allreduce_expert_gradients(
                [g for p, g in zip(params, grads) if is_expert_parallel(p)])
            owners = params
            sliced = [fsdp.is_sharded(p) for p in params] if sharded else None
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
        return grad_norm

    return update


def make_pipelined_train_step(config: TrainingConfig, model: PipelinedModel,
                              optimizer: ParallelOptimizer):
    """The train step of a :class:`..pipeline.engine.PipelinedModel` (JAX
    ``make_pipelined_train_step``): ``step(batch, generator=None) ->
    {"loss", "grad_norm"}`` over the GLOBAL host batch ``{"ids",
    "labels", *model.extra_keys}`` (``B = num_microbatches x microbatch x
    dp``), the same on every rank.  The model's schedule
    (``loss_and_grad_fn``) leaves this rank's gradient sums in its
    stage; they are divided by the global token count (the exact token-
    masked mean, as at pp = 1), then summed and clipped as every step's
    are (the global norm sums every stage's squares: the world's all-
    reduce covers pp), and AdamW updates the stage IN PLACE.  The blocks
    carry no dropout, so ``generator`` is accepted and unused."""
    params = [p for p in model.module.parameters() if p.requires_grad]
    update = _make_update(config, model.module, optimizer, params,
                          _DataParallel())
    keys = ("ids", "labels", *model.extra_keys)

    def step(batch, generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        missing = [k for k in keys if batch.get(k) is None]
        if missing:
            raise KeyError(f"the pipelined step needs batch keys {missing}")
        loss_sum, tok = model.loss_and_grad_fn(
            *(torch.as_tensor(batch[k]) for k in keys))
        scale = 1.0 / tok.clamp(min=1.0)
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)  # unused: still decayed
            else:
                p.grad.mul_(scale)
        return {"loss": loss_sum * scale, "grad_norm": update()}

    return step


def make_eval_step(config: TrainingConfig, model: ParallelModel,
                   loss_fn: Optional[Callable[..., Any]] = None,
                   batch_spec=None):
    """A loss-only step for validation (JAX ``make_eval_step``): ``step(
    batch) -> {"loss"}`` over the global host batch, split over dp as the
    train step splits it, without gradients or an optimizer; the loss is
    normalized as the train step's.  A pipelined model runs its forward
    schedule (``loss_fn`` is not needed)."""
    _check_batch_spec(batch_spec)
    if isinstance(model, PipelinedModel):
        keys = ("ids", "labels", *model.extra_keys)

        @torch.no_grad()
        def pipelined(batch) -> Dict[str, torch.Tensor]:
            loss_sum, tok = model.loss_fn(
                *(torch.as_tensor(batch[k]) for k in keys))
            return {"loss": loss_sum / tok.clamp(min=1.0)}

        return pipelined
    if loss_fn is None:
        raise ValueError("loss_fn is required")
    module, device = model.module, model.device
    dp = _DataParallel()

    @torch.no_grad()
    def step(batch) -> Dict[str, torch.Tensor]:
        out = loss_fn(module, _to_device(dp.slice(batch), device))
        tw = isinstance(out, tuple)
        loss = out[0] if tw else out
        tok = (out[1].float() if tw
               else torch.zeros((), dtype=torch.float32, device=device))
        return {"loss": _global_loss(loss.detach().float(), tok, tw, 1,
                                     dp)[0]}

    return step
