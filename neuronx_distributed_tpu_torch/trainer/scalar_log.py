"""Designated-rank scalar logging, TensorBoard and JSONL (counterpart of
``neuronx_distributed_tpu/trainer/scalar_log.py``).

Every metric a train step returns is already global (the same on every
rank), so exactly one process writes the stream: rank 0
(:func:`..utils.distributed.is_primary`).  The backend is
``torch.utils.tensorboard`` when it imports, always paired with a JSONL
mirror (one ``{"step", "tag", "value", "time"}`` object a line) that
:mod:`..testing.convergence` reads without TensorBoard.  The format is the
JAX package's, so either package's comparator reads the other's streams.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

from neuronx_distributed_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


def is_designated_writer() -> bool:
    """True on the single process that writes scalar streams."""
    from neuronx_distributed_tpu_torch.utils.distributed import is_primary

    return is_primary()


class ScalarWriter:
    """Scalar stream writer, active only on the designated process (every
    method is a no-op elsewhere, so call sites need no rank guards)."""

    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        self.log_dir = log_dir
        self.active = is_designated_writer()
        self._tb = None
        self._jsonl = None
        if not self.active:
            return
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a",
                           buffering=1)
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=log_dir)
            except Exception as e:  # tensorboard not installed
                logger.warning("tensorboard writer unavailable (%s); JSONL "
                               "only", e)

    def scalar(self, tag: str, value: float, step: int) -> None:
        if not self.active:
            return
        value = float(value)
        self._jsonl.write(json.dumps({"step": int(step), "tag": tag,
                                      "value": value, "time": time.time()})
                          + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, value, global_step=int(step))

    def scalars(self, step: int, **tags: float) -> None:
        for tag, value in tags.items():
            self.scalar(tag, value, step)

    def flush(self) -> None:
        if not self.active:
            return
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        if not self.active:
            return
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()

    def __enter__(self) -> "ScalarWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_scalars(log_dir: str, tag: Optional[str] = None):
    """The JSONL stream back as a list of dicts (optionally one tag's)."""
    out = []
    with open(os.path.join(log_dir, "scalars.jsonl")) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if tag is None or rec["tag"] == tag:
                out.append(rec)
    return out
