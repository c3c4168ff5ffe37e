"""Host-side utilities of the PyTorch port."""

from neuronx_distributed_tpu_torch.utils.device import resolve_device
from neuronx_distributed_tpu_torch.utils.logger import get_logger

__all__ = ["get_logger", "resolve_device"]
