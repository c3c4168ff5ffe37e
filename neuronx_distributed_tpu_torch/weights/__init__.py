"""Live weights: hot swaps for serving engines and fleets (counterpart of
``neuronx_distributed_tpu/weights``).

:class:`WeightSwapper` validates a new set of parameters against a running
engine's envelope and installs it between steps, with no graph captured
again on an engine that owns its model and no request dropped; the fleet
router's ``rolling_update`` walks it across replicas one graceful drain at
a time.
"""

from neuronx_distributed_tpu_torch.weights.swapper import (  # noqa: F401
    WEIGHT_SWAP_SCHEMA,
    WEIGHT_SWAPS_FILE,
    SwapError,
    WeightSwapper,
    param_envelope,
)
