"""Pipeline parallelism (counterpart of ``neuronx_distributed_tpu/pipeline``:
the reference's NxDPPModel, 1F1B scheduler, partitioner and neighbour
transport).

The port's engine (:mod:`.engine`) is host-driven: each pp rank holds its
stage and walks its task list eagerly, sending activations and gradients
to its neighbours; the declarative schedules (:mod:`.scheduler`) and the
partition arithmetic (:mod:`.partition`) are the JAX package's, copied.
JAX's ``stacked_layer_specs`` (the pp-sharded ``[L, ...]`` stack's
partition specs) has no counterpart: a port stage holds its own layers.
"""

from neuronx_distributed_tpu_torch.pipeline.engine import (
    EMBED,
    HEAD,
    LAYERS,
    PipelinedModel,
    PipelineStage,
    build_pipelined_model,
    make_pipelined_forward_fn,
    make_pipelined_loss_fn,
    microbatch,
)
from neuronx_distributed_tpu_torch.pipeline.partition import (
    layers_per_stage,
    partition_uniform,
    spans_from_cuts,
)
from neuronx_distributed_tpu_torch.pipeline.scheduler import (
    BackwardStep,
    ForwardStep,
    InferenceSchedule,
    PipeSchedule,
    RecvBackward,
    RecvForward,
    ReduceGrads,
    SendBackward,
    SendForward,
    TrainSchedule,
    bubble_fraction,
)

__all__ = [
    "EMBED",
    "HEAD",
    "LAYERS",
    "PipelinedModel",
    "PipelineStage",
    "build_pipelined_model",
    "make_pipelined_loss_fn",
    "make_pipelined_forward_fn",
    "microbatch",
    "partition_uniform",
    "spans_from_cuts",
    "layers_per_stage",
    "PipeSchedule",
    "TrainSchedule",
    "InferenceSchedule",
    "ForwardStep",
    "BackwardStep",
    "RecvForward",
    "SendForward",
    "RecvBackward",
    "SendBackward",
    "ReduceGrads",
    "bubble_fraction",
]
