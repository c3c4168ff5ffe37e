"""Small shape and partition helpers (counterpart of
``neuronx_distributed_tpu/utils/common.py``).

The JAX module also holds ``shard_map`` (a version shim over
``jax.shard_map``) and ``ensure_virtual_devices`` (an n-device virtual CPU
mesh for parity runs).  Neither has a meaning in torch: a rank of a
``torch.distributed`` world runs its own shard eagerly, with explicit
collectives (:mod:`..parallel.mappings`), and a CPU parity run is a world
of gloo processes (:func:`.distributed.spawn`).
"""

from __future__ import annotations


def ensure_divisibility(numerator: int, denominator: int) -> None:
    if numerator % denominator != 0:
        raise ValueError(f"{numerator} is not divisible by {denominator}")


def divide(numerator: int, denominator: int) -> int:
    """Exact integer division, raising on a remainder."""
    ensure_divisibility(numerator, denominator)
    return numerator // denominator


def pad_to_multiple(n: int, multiple: int) -> int:
    """Smallest value >= n that is divisible by ``multiple``."""
    return ((n + multiple - 1) // multiple) * multiple
