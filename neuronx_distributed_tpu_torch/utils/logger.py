"""Singleton logger (reference: ``utils/logger.py:10-82``).

Env knobs mirror the reference: ``NXD_LOG_LEVEL`` sets verbosity,
``NXD_LOG_HIDE_TIME`` drops timestamps from the format.
"""

from __future__ import annotations

import logging
import os
import sys

_CONFIGURED = False


def _configure_root() -> None:
    global _CONFIGURED
    if _CONFIGURED:
        return
    level_name = os.environ.get("NXD_LOG_LEVEL", "INFO").upper()
    level = getattr(logging, level_name, logging.INFO)
    if os.environ.get("NXD_LOG_HIDE_TIME"):
        fmt = "[%(levelname)s|%(name)s] %(message)s"
    else:
        fmt = "%(asctime)s [%(levelname)s|%(name)s] %(message)s"
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(fmt))
    root = logging.getLogger("neuronx_distributed_tpu_torch")
    root.setLevel(level)
    if not root.handlers:
        root.addHandler(handler)
    root.propagate = False
    _CONFIGURED = True


def get_logger(name: str = "neuronx_distributed_tpu_torch") -> logging.Logger:
    _configure_root()
    if not name.startswith("neuronx_distributed_tpu_torch"):
        name = f"neuronx_distributed_tpu_torch.{name}"
    return logging.getLogger(name)
