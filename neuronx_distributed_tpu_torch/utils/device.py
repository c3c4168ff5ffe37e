"""Device resolution for the port's entry points.

Every entry point runs on the card unless the caller asks for the CPU:
``device=None`` means CUDA, and raises when CUDA is absent instead of
quietly running somewhere slower.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda`` (raises without CUDA); anything else as given,
    with a CUDA device checked to exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU by default; "
            "pass device='cpu' to run its plain PyTorch versions on the CPU")
    return dev
