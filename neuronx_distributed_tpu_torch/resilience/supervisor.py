"""Process supervisor (counterpart of
``neuronx_distributed_tpu/resilience/supervisor.py``): run a command in a
child process, restart it on a crash with exponential backoff under a
crash budget, and record each attempt's resume point.

- A clean exit (rc 0) ends supervision; any other exit spends one unit of
  the budget (``max_restarts``) and backs off ``backoff_base_s *
  2^(restart - 1)`` seconds, capped at ``backoff_max_s``.
- ``timeout_s`` kills a wedged attempt and counts it as a crash of cause
  ``timeout``.
- Each exit is classified from its code and the tail of the child's log
  (:func:`classify_exit`).
- ``ckpt_dir``: every ``start`` and ``exit`` event records the newest
  complete checkpoint tag there (:func:`newest_complete_tag`), the
  contract between a crashed attempt and the next.

Every event is validated against the ``supervisor_event`` schema of
:mod:`..obs.schemas` before it is written.  The CLI, :func:`main`, runs a
training command under supervision::

    python -m neuronx_distributed_tpu_torch.resilience.supervisor \
        --max-restarts 3 --ckpt-dir ck --events ev.jsonl --log child.log -- \
        python -m neuronx_distributed_tpu_torch.examples.llama_pretrain \
        --ckpt-dir ck --resume ...
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
from typing import IO, List, Optional, Sequence

from neuronx_distributed_tpu_torch.obs.schemas import validate_record
from neuronx_distributed_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

SUPERVISOR_EVENTS_SCHEMA = "supervisor_events/1"

# crash-cause signatures in the child log's tail, most specific first
_CAUSE_SIGNATURES = (
    ("InjectedFault", "injected_fault"),
    ("RetriesExhausted", "policy_retries_exhausted"),
    ("PolicyHalt", "policy_halt"),
    ("non-finite", "non_finite"),
    ("NaN", "nan"),
    ("Traceback (most recent call last)", "exception"),
)


def newest_complete_tag(ckpt_dir: Optional[str]) -> Optional[str]:
    """The ``newest`` pointer's tag when that tag has a ``.done`` marker,
    else the most recently completed tag, else None (read from the marker
    files alone)."""
    if not ckpt_dir or not os.path.isdir(ckpt_dir):
        return None
    p = os.path.join(ckpt_dir, "newest")
    if os.path.exists(p):
        with open(p) as f:
            tag = f.read().strip()
        if tag and os.path.exists(os.path.join(ckpt_dir, tag, ".done")):
            return tag
    done = [(os.path.getmtime(os.path.join(ckpt_dir, d, ".done")), d)
            for d in os.listdir(ckpt_dir)
            if os.path.exists(os.path.join(ckpt_dir, d, ".done"))]
    return max(done)[1] if done else None


def classify_exit(rc: int, log_tail: str) -> str:
    """A crash-cause label from an exit code and the child log's tail."""
    if rc == 0:
        return "clean"
    if rc < 0:
        try:
            return f"signal_{signal.Signals(-rc).name}"
        except ValueError:
            return f"signal_{-rc}"
    for needle, label in _CAUSE_SIGNATURES:
        if needle in log_tail:
            return label
    return f"exit_{rc}"


class RestartBackoff:
    """Exponential-backoff restart budget: :meth:`next_delay` spends one
    restart and returns the backoff before it (``base * 2^(restarts-1)``,
    capped), or None once the budget is spent."""

    def __init__(self, max_restarts: int, base_s: float = 0.5,
                 max_s: float = 30.0):
        if max_restarts < 0:
            raise ValueError(f"max_restarts must be >= 0, got {max_restarts}")
        self.max_restarts = max_restarts
        self.base_s = base_s
        self.max_s = max_s
        self.restarts = 0

    @property
    def exhausted(self) -> bool:
        return self.restarts >= self.max_restarts

    def next_delay(self) -> Optional[float]:
        if self.exhausted:
            return None
        self.restarts += 1
        return min(self.base_s * (2 ** (self.restarts - 1)), self.max_s)


@dataclasses.dataclass
class SupervisorResult:
    """Outcome of :meth:`Supervisor.run`."""

    ok: bool
    attempts: int
    restarts: int
    final_rc: int
    total_runtime_s: float
    causes: List[str]
    events_path: Optional[str]


class Supervisor:
    """Run ``argv`` under supervision (see the module docstring).

    ``events_path`` appends one JSON line per lifecycle event: ``start``
    (attempt, pid, resume_tag), ``exit`` (rc, cause, runtime_s,
    resume_tag), ``restart`` (backoff_s, cause), ``giveup``, ``success``;
    :attr:`events` keeps them in memory too.  ``log_path`` takes the
    child's merged stdout and stderr (appended, one banner an attempt);
    without it the child inherits this process's streams and no cause can
    be read from its output.  ``on_exit(attempt, rc, cause)`` runs after
    every exit, before the restart decision.  ``clock`` and ``sleep`` are
    injectable for tests."""

    def __init__(self, argv: Sequence[str], *, max_restarts: int = 3,
                 backoff_base_s: float = 0.5, backoff_max_s: float = 30.0,
                 timeout_s: Optional[float] = None,
                 ckpt_dir: Optional[str] = None,
                 events_path: Optional[str] = None,
                 log_path: Optional[str] = None, env: Optional[dict] = None,
                 cwd: Optional[str] = None, on_exit=None,
                 clock=time.monotonic, sleep=time.sleep):
        if not argv:
            raise ValueError("supervisor needs a command to run")
        if max_restarts < 0:
            raise ValueError(f"max_restarts must be >= 0, got {max_restarts}")
        self.argv = list(argv)
        self.max_restarts = max_restarts
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.timeout_s = timeout_s
        self.ckpt_dir = ckpt_dir
        self.events_path = events_path
        self.log_path = log_path
        self.env = env
        self.cwd = cwd
        self.on_exit = on_exit
        self._clock = clock
        self._sleep = sleep
        self._events_f: Optional[IO] = None
        self._log_start = 0  # the child log's size when this attempt began
        self.events: List[dict] = []

    def _emit(self, event: str, attempt: int, **fields) -> dict:
        rec = {"schema": SUPERVISOR_EVENTS_SCHEMA, "time": time.time(),
               "event": event, "attempt": attempt, **fields}
        validate_record("supervisor_event", rec)  # the emitter honors it
        self.events.append(rec)
        if self.events_path:
            if self._events_f is None:
                parent = os.path.dirname(self.events_path)
                if parent:
                    os.makedirs(parent, exist_ok=True)
                self._events_f = open(self.events_path, "a")
            self._events_f.write(json.dumps(rec) + "\n")
            self._events_f.flush()
        logger.info("supervisor: %s attempt=%d %s", event, attempt, fields)
        return rec

    def _log_tail(self, nbytes: int = 8192) -> str:
        """The last ``nbytes`` the CURRENT attempt wrote to the child log
        (an earlier attempt's crash text never classifies this one)."""
        if not self.log_path or not os.path.exists(self.log_path):
            return ""
        with open(self.log_path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(self._log_start, f.tell() - nbytes))
            return f.read().decode(errors="replace")

    def _run_once(self, attempt: int) -> int:
        log_f = None
        if self.log_path:
            parent = os.path.dirname(self.log_path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            log_f = open(self.log_path, "a")
            log_f.write(f"\n=== supervisor attempt {attempt} "
                        f"({time.strftime('%Y-%m-%dT%H:%M:%S')}) ===\n")
            log_f.flush()
            self._log_start = log_f.tell()
        try:
            proc = subprocess.Popen(
                self.argv, stdout=log_f,
                stderr=subprocess.STDOUT if log_f else None,
                env=self.env, cwd=self.cwd)
            self._emit("start", attempt, pid=proc.pid,
                       resume_tag=newest_complete_tag(self.ckpt_dir))
            try:
                return proc.wait(timeout=self.timeout_s)
            except subprocess.TimeoutExpired:
                logger.warning("supervisor: attempt %d exceeded %.1fs -- "
                               "killing", attempt, self.timeout_s)
                proc.kill()
                proc.wait()
                return -signal.SIGKILL
        finally:
            if log_f is not None:
                log_f.close()

    def run(self) -> SupervisorResult:
        t_start = self._clock()
        attempt = 1
        budget = RestartBackoff(self.max_restarts, base_s=self.backoff_base_s,
                                max_s=self.backoff_max_s)
        causes: List[str] = []
        try:
            while True:
                t0 = self._clock()
                try:
                    rc = self._run_once(attempt)
                except (OSError, subprocess.SubprocessError) as e:
                    # a spawn failure is a crash too
                    logger.error("supervisor: spawn failed: %s", e)
                    rc = 127
                runtime_s = self._clock() - t0
                timed_out = (rc == -signal.SIGKILL and bool(self.timeout_s)
                             and runtime_s >= self.timeout_s)
                cause = "timeout" if timed_out else classify_exit(
                    rc, self._log_tail())
                if self.on_exit is not None:
                    try:
                        self.on_exit(attempt, rc, cause)
                    except Exception:
                        logger.exception(
                            "supervisor: on_exit hook failed (attempt %d, "
                            "rc %d, cause %s)", attempt, rc, cause)
                self._emit("exit", attempt, rc=rc, cause=cause,
                           runtime_s=round(runtime_s, 3),
                           resume_tag=newest_complete_tag(self.ckpt_dir))
                if rc == 0:
                    self._emit("success", attempt, restarts=budget.restarts)
                    return SupervisorResult(
                        ok=True, attempts=attempt, restarts=budget.restarts,
                        final_rc=0, total_runtime_s=self._clock() - t_start,
                        causes=causes, events_path=self.events_path)
                causes.append(cause)
                backoff = budget.next_delay()
                if backoff is None:
                    self._emit("giveup", attempt, rc=rc,
                               restarts=budget.restarts, cause=cause)
                    return SupervisorResult(
                        ok=False, attempts=attempt, restarts=budget.restarts,
                        final_rc=rc, total_runtime_s=self._clock() - t_start,
                        causes=causes, events_path=self.events_path)
                attempt += 1
                self._emit("restart", attempt, backoff_s=round(backoff, 3),
                           cause=cause)
                self._sleep(backoff)
        finally:
            if self._events_f is not None:
                self._events_f.close()
                self._events_f = None


def main(argv: Optional[Sequence[str]] = None) -> int:
    """The supervisor's CLI: run the command after ``--``, restart it on
    crashes with exponential backoff under a crash budget, print one JSON
    summary line; exit 0 when the command finally succeeded."""
    import argparse

    p = argparse.ArgumentParser(
        prog="train_supervisor",
        description="Supervised auto-resume: run a training command, restart "
                    "on crashes with exponential backoff and a crash budget.")
    p.add_argument("--max-restarts", type=int, default=3)
    p.add_argument("--backoff-base", type=float, default=0.5,
                   help="first backoff in seconds (doubles per restart)")
    p.add_argument("--backoff-max", type=float, default=30.0)
    p.add_argument("--timeout", type=float, default=None,
                   help="per-attempt wall-clock limit; exceeding it kills the "
                        "attempt (cause=timeout) and consumes crash budget")
    p.add_argument("--ckpt-dir", default=None,
                   help="checkpoint dir to record resume tags from")
    p.add_argument("--events", default=None,
                   help="supervisor_events.jsonl path (append)")
    p.add_argument("--log", default=None,
                   help="child stdout/stderr log (append; enables crash-cause "
                        "classification)")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="the training command (prefix with --)")
    args = p.parse_args(argv)
    command = args.command
    if command and command[0] == "--":
        command = command[1:]
    if not command:
        p.error("no command given (pass it after --)")

    sup = Supervisor(
        command, max_restarts=args.max_restarts,
        backoff_base_s=args.backoff_base, backoff_max_s=args.backoff_max,
        timeout_s=args.timeout, ckpt_dir=args.ckpt_dir,
        events_path=args.events, log_path=args.log)
    res = sup.run()
    print(json.dumps({
        "supervisor": "done", "ok": res.ok, "attempts": res.attempts,
        "restarts": res.restarts, "final_rc": res.final_rc,
        "causes": res.causes,
        "total_runtime_s": round(res.total_runtime_s, 3),
    }), flush=True)
    return 0 if res.ok else 1


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
