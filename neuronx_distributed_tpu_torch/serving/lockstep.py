"""One set of host decisions on every tensor-parallel rank.

At tp > 1 every rank runs the same :class:`~.engine.ServingEngine` over
its shard, and every rank's engine must make the same admissions,
preemptions, shedding and stop decisions, step for step: a rank that
decides otherwise runs a different forward, and its collectives no longer
pair with its peers'.  The engine's decisions are a function of its
calls (``submit``, ``step``, ``cancel``, ``withdraw``), of the tokens
(sampled on every rank from the same gathered logits with the same
generators) and of its clock.  Callers drive every rank with the same
calls in the same order (a ``torchrun`` script does: each rank runs it);
:class:`LockstepClock` makes the clock the same.

Each reading of the engine clock is one all-reduce over the
tensor-parallel ranks' gloo group of ``[t, d, -d]`` under ``MAX``: rank 0
contributes its clock's reading ``t`` (the others ``-inf``), and every
rank its digest ``d`` of the calls it has made and the readings it has
taken.  Every rank reads rank 0's time, so deadlines, shedding, the
tenant buckets and the EWMA estimates agree; and when the digests differ
(``max(d) != -max(-d)``), the ranks have diverged and every rank raises
instead of pairing collectives wrongly.  The reading count is part of the
digest, so a rank that takes an extra reading is caught at once.
"""

from __future__ import annotations

import hashlib
import time
from typing import Callable

import torch
import torch.distributed as dist

# digests stay below 2^52: exact in the float64 all-reduce
_DIGEST_BITS = 52


def _fold(digest: int, data: str) -> int:
    h = hashlib.blake2b(digest_size=8)
    h.update(digest.to_bytes(8, "little"))
    h.update(data.encode())
    return int.from_bytes(h.digest(), "little") & ((1 << _DIGEST_BITS) - 1)


class DivergedRanks(RuntimeError):
    """Tensor-parallel ranks made different host calls or readings."""


class LockstepClock:
    """The engine clock shared by the ranks of ``group`` (a gloo group):
    rank 0's ``clock`` readings, agreed in one all-reduce each.
    ``reads`` and ``seconds`` count the readings and the host time spent
    agreeing on them."""

    def __init__(self, clock: Callable[[], float], group):
        self._clock = clock
        self.group = group
        self.rank = dist.get_rank(group)
        self.digest = 0
        self.reads = 0
        self.seconds = 0.0

    def note(self, *fields) -> None:
        """Fold a host call (``submit``, ``cancel``, ``withdraw`` and their
        arguments) into the digest the next reading checks."""
        self.digest = _fold(self.digest, repr(fields))

    def __call__(self) -> float:
        t0 = time.perf_counter()
        self.reads += 1
        self.digest = _fold(self.digest, f"read {self.reads}")
        d = float(self.digest)
        t = float(self._clock()) if self.rank == 0 else float("-inf")
        buf = torch.tensor([t, d, -d], dtype=torch.float64)
        dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=self.group)
        t, hi, neg_lo = buf.tolist()
        self.seconds += time.perf_counter() - t0
        if hi != -neg_lo:
            raise DivergedRanks(
                f"tensor-parallel ranks diverged at clock reading "
                f"{self.reads}: their host calls differ (this rank's digest "
                f"{int(d)}, the group's range [{int(-neg_lo)}, {int(hi)}]); "
                "drive every rank's engine with the same calls in the same "
                "order")
        return t
