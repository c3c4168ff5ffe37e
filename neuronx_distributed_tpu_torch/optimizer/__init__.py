"""Optimizers of the PyTorch port."""

from neuronx_distributed_tpu_torch.optimizer.adamw_fp32 import adamw_fp32, build_lr_schedule

__all__ = ["adamw_fp32", "build_lr_schedule"]
