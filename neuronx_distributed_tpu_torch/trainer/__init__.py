"""Training of the PyTorch port: the trainer facade, ``fit()``, the
checkpoints, the scalar log and the metrics."""

from neuronx_distributed_tpu_torch.trainer.checkpoint import (
    Shard,
    load_checkpoint,
    model_shards,
    newest_tag,
    optimizer_shards,
    restore_model,
    restore_optimizer,
    save_checkpoint,
    wait_for_checkpoint,
)
from neuronx_distributed_tpu_torch.trainer.fit import Callback, FitResult, fit
from neuronx_distributed_tpu_torch.trainer.metrics import (
    Throughput,
    TrainingMetrics,
    mfu,
    transformer_flops_per_token,
)
from neuronx_distributed_tpu_torch.trainer.scalar_log import (
    ScalarWriter,
    read_scalars,
)
from neuronx_distributed_tpu_torch.trainer.trainer import (
    ParallelModel,
    ParallelOptimizer,
    data_parallel_slice,
    default_batch_spec,
    initialize_parallel_model,
    initialize_parallel_optimizer,
    make_eval_step,
    make_pipelined_train_step,
    make_train_step,
)

__all__ = [
    "Callback",
    "FitResult",
    "ParallelModel",
    "ParallelOptimizer",
    "ScalarWriter",
    "Shard",
    "Throughput",
    "TrainingMetrics",
    "data_parallel_slice",
    "default_batch_spec",
    "fit",
    "initialize_parallel_model",
    "initialize_parallel_optimizer",
    "load_checkpoint",
    "make_eval_step",
    "make_pipelined_train_step",
    "make_train_step",
    "mfu",
    "model_shards",
    "newest_tag",
    "optimizer_shards",
    "read_scalars",
    "restore_model",
    "restore_optimizer",
    "save_checkpoint",
    "transformer_flops_per_token",
    "wait_for_checkpoint",
]
