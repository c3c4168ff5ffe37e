"""Typed configuration (counterpart of ``neuronx_distributed_tpu/config.py``).

The port's own copy of the JAX package's dataclasses: the mesh sizes,
optimizer, pipeline and activation-checkpoint sub-configs, and the
top-level :class:`TrainingConfig` with its flat-kwargs constructor
:func:`training_config`.  Serving and training run at any tensor and data
parallel degree and KV replication (:mod:`.parallel.mesh` lays out the
ranks); the trainer refuses pipeline, context and expert degrees above 1
and ``fsdp`` (ROADMAP A15, A14, "Then", A11b).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Sizes of every parallel dimension (the JAX ``parallel.mesh``
    fields); ``data_parallel_size=None`` infers it from the world size."""

    tensor_parallel_size: int = 1
    pipeline_parallel_size: int = 1
    context_parallel_size: int = 1
    expert_parallel_size: int = 1
    kv_size_multiplier: int = 1
    data_parallel_size: Optional[int] = None

    def __post_init__(self):
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is not None and v < 1:
                raise ValueError(f"{f.name} must be >= 1, got {v}")
        if self.tensor_parallel_size % self.kv_size_multiplier != 0:
            raise ValueError(
                f"tensor_parallel_size ({self.tensor_parallel_size}) must be "
                f"divisible by kv_size_multiplier ({self.kv_size_multiplier})")

    @property
    def model_parallel_size(self) -> int:
        return (self.tensor_parallel_size * self.pipeline_parallel_size
                * self.context_parallel_size * self.expert_parallel_size)


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """AdamW, clipping and the LR schedule (``constant`` | ``linear`` |
    ``cosine``, with warmup; decaying schedules need ``total_steps`` and
    bottom out at ``min_lr_ratio * learning_rate``).  ``zero_one_enabled``
    shards the AdamW states over the data-parallel ranks
    (:mod:`.optimizer.zero1`; nothing to shard at dp = 1)."""

    zero_one_enabled: bool = True
    grad_clipping: bool = True
    max_grad_norm: float = 1.0
    learning_rate: float = 3e-4
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    total_steps: Optional[int] = None
    min_lr_ratio: float = 0.0
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Pipeline schedule settings, kept as data: the port's trainer refuses
    ``pipeline_parallel_size > 1``."""

    num_microbatches: int = 1
    schedule: str = "1f1b"  # "1f1b" | "gpipe" | "interleaved" | "inference"
    virtual_stages: int = 1
    pipeline_cuts: Optional[tuple] = None
    packed_inputs: bool = False


@dataclasses.dataclass(frozen=True)
class ActivationCheckpointConfig:
    """``policy``: None defers to the model config's ``remat``; ``"none"``
    | ``"full"`` | ``"selective"`` overrides it (the trainer rebuilds the
    model with ``remat=policy``)."""

    policy: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class TrainingConfig:
    """Top-level config.  ``param_dtype``/``compute_dtype`` (dtype names)
    drive model construction: the trainer rebuilds a model whose config
    disagrees.  ``sequence_parallel`` is data only, as in the JAX package:
    the model's own config decides sequence parallelism."""

    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig)
    pipeline: PipelineConfig = dataclasses.field(default_factory=PipelineConfig)
    activation_checkpoint: ActivationCheckpointConfig = dataclasses.field(
        default_factory=ActivationCheckpointConfig)
    sequence_parallel: bool = True
    fsdp: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    seed: int = 1234

    @property
    def torch_param_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def torch_compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def replace(self, **kw: Any) -> "TrainingConfig":
        return dataclasses.replace(self, **kw)


def training_config(**kwargs: Any) -> TrainingConfig:
    """Flat kwargs for the common fields (``tensor_parallel_size=``,
    ``learning_rate=``, ``policy=`` ...) or whole sub-configs (``mesh=``
    ...); unknown keys raise ``TypeError``."""
    sub_fields = {
        "mesh": MeshConfig,
        "optimizer": OptimizerConfig,
        "pipeline": PipelineConfig,
        "activation_checkpoint": ActivationCheckpointConfig,
    }
    sub_objs = {k: kwargs.pop(k) for k in list(kwargs) if k in sub_fields}
    top_keys = {f.name for f in dataclasses.fields(TrainingConfig)} - set(
        sub_fields)
    built: dict = {}
    for name, cls in sub_fields.items():
        keys = {f.name for f in dataclasses.fields(cls)}
        sub_kw = {k: kwargs.pop(k) for k in list(kwargs) if k in keys}
        if name in sub_objs:
            if sub_kw:
                raise TypeError(f"pass either {name}= or its flat keys "
                                f"{sorted(sub_kw)}, not both")
            built[name] = sub_objs[name]
        else:
            built[name] = cls(**sub_kw)
    top_kw = {k: kwargs.pop(k) for k in list(kwargs) if k in top_keys}
    if kwargs:
        raise TypeError(f"unknown config keys: {sorted(kwargs)}")
    return TrainingConfig(**built, **top_kw)
