"""Training of the PyTorch port: the trainer facade and its metrics."""

from neuronx_distributed_tpu_torch.trainer.metrics import (
    Throughput,
    mfu,
    transformer_flops_per_token,
)
from neuronx_distributed_tpu_torch.trainer.trainer import (
    ParallelModel,
    ParallelOptimizer,
    data_parallel_slice,
    default_batch_spec,
    initialize_parallel_model,
    initialize_parallel_optimizer,
    make_eval_step,
    make_train_step,
)

__all__ = [
    "ParallelModel",
    "ParallelOptimizer",
    "Throughput",
    "data_parallel_slice",
    "default_batch_spec",
    "initialize_parallel_model",
    "initialize_parallel_optimizer",
    "make_eval_step",
    "make_train_step",
    "mfu",
    "transformer_flops_per_token",
]
