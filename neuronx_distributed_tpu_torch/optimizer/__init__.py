"""Optimizers of the PyTorch port: AdamW with fp32 states and its
schedules, ZeRO-1's state sharding over the data-parallel ranks and the
FSDP dim choice."""

from neuronx_distributed_tpu_torch.optimizer.adamw_fp32 import adamw_fp32, build_lr_schedule
from neuronx_distributed_tpu_torch.optimizer.zero1 import (
    Zero1,
    fsdp_dim,
    fsdp_spec,
    optimizer_state_layout,
    zero1_dim,
    zero1_spec,
)

__all__ = ["Zero1", "adamw_fp32", "build_lr_schedule", "fsdp_dim", "fsdp_spec",
           "optimizer_state_layout", "zero1_dim", "zero1_spec"]
