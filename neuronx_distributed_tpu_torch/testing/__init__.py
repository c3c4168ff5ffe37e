"""Testing utilities of the PyTorch port: the convergence-parity
comparator."""

from neuronx_distributed_tpu_torch.testing.convergence import (  # noqa: F401
    CurveComparison,
    compare_curves,
    compare_scalar_logs,
    smoothed,
)
