"""Multi-process bring-up and host-side agreement (counterpart of
``neuronx_distributed_tpu/utils/distributed.py``).

Under single-controller JAX one process drives every device and the only
host channels are the coordination service's barrier and broadcast.  The
port runs one process per rank, so this module brings the world up and
keeps the host side of the ranks in step:

- :func:`initialize_distributed` reads the ``torchrun`` environment
  (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``) and starts the default process group: NCCL for CUDA,
  gloo for the CPU (or the ``backend`` the caller names: two ranks on one
  card need gloo, since NCCL refuses two ranks on one device).  It also
  opens one gloo group over the world for host-side agreement, which
  works on CPU tensors under NCCL too;
- :func:`rendezvous` is a barrier, :func:`broadcast_from_host0` a
  ``broadcast_object_list`` from rank 0, :func:`is_primary` the rank-0
  test for singleton IO;
- :func:`spawn` starts a world of fresh Python processes on this host
  (tests and ``chip_smoke.py``; ``torchrun --nproc-per-node N`` does the
  same for a user's script), with a wall-clock limit that kills every
  worker, so a rank that never reaches a collective cannot hang its
  caller.

Every group gets a ``timeout``: a collective that a peer never joins
raises on the ranks that wait instead of blocking forever.
"""

from __future__ import annotations

import datetime
import importlib
import importlib.util
import os
import pickle
import signal
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from neuronx_distributed_tpu_torch.utils.device import resolve_device
from neuronx_distributed_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

# the default per-collective timeout of a world this module starts
DEFAULT_TIMEOUT_S = 600.0

_HOST_GROUP = None
_TIMEOUT_S = DEFAULT_TIMEOUT_S


def _timeout(seconds: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=float(seconds))


def initialize_distributed(device=None, backend: Optional[str] = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Start the default process group from the ``torchrun`` environment.

    ``device`` as everywhere in the port (None: CUDA, raising without it);
    on CUDA each process takes card ``LOCAL_RANK % device_count``.
    ``backend`` defaults to NCCL on CUDA and gloo on the CPU.  A job whose
    environment names no world, or a world of one, is a no-op that returns
    False, so library code can call this unconditionally; a second call
    returns True without doing anything."""
    global _HOST_GROUP, _TIMEOUT_S
    device = resolve_device(device)
    if dist.is_initialized():
        return True
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1 and "MASTER_ADDR" not in os.environ:
        logger.info("single-process run; no process group started")
        return False
    rank = int(os.environ["RANK"])
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        index = (device.index if device.index is not None
                 else local % torch.cuda.device_count())
        torch.cuda.set_device(index)
        device = torch.device("cuda", index)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend=backend, init_method="env://",
                            rank=rank, world_size=world,
                            timeout=_timeout(timeout_s))
    _HOST_GROUP = (dist.group.WORLD if backend == "gloo" else
                   dist.new_group(backend="gloo", timeout=_timeout(timeout_s)))
    _TIMEOUT_S = float(timeout_s)
    logger.info("process group up: rank %d/%d, backend %s, device %s", rank,
                world, backend, device)
    return True


def destroy_distributed() -> None:
    """Tear the world down (the parallel state first, if it is up)."""
    global _HOST_GROUP
    from neuronx_distributed_tpu_torch.parallel import mesh

    mesh.destroy_model_parallel()
    if dist.is_initialized():
        dist.destroy_process_group()
    _HOST_GROUP = None


def group_timeout() -> datetime.timedelta:
    """The world's per-collective timeout, for the groups built on it."""
    return _timeout(_TIMEOUT_S)


def host_group():
    """The world's gloo group for host-side agreement (None outside a
    world)."""
    return _HOST_GROUP


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rendezvous(tag: str = "") -> None:
    """A barrier over the world's host group; a no-op outside a world."""
    if dist.is_initialized():
        dist.barrier(group=_HOST_GROUP)


def broadcast_from_host0(obj: Any) -> Any:
    """Rank 0's ``obj`` on every rank (any picklable object), over the host
    group; outside a world, ``obj`` itself."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=_HOST_GROUP)
    return box[0]


def is_primary() -> bool:
    """True on the process that does singleton IO (rank 0)."""
    return get_rank() == 0


# -- spawning a world on this host -----------------------------------------


def free_port() -> int:
    """A TCP port on the loopback interface that is free right now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _target(fn: Callable) -> tuple:
    """``(module name, path, qualified name)`` by which a worker finds
    ``fn``: a function of a script run as ``__main__`` is loaded from the
    script's file (its ``__main__`` block does not run); any other module
    is imported by name with its import root (``path``) on ``sys.path``."""
    mod = fn.__module__
    path = os.path.abspath(sys.modules[mod].__file__)
    if mod != "__main__":
        root = os.path.dirname(path)
        for _ in mod.split(".")[1:] + (
                [""] if path.endswith("__init__.py") else []):
            root = os.path.dirname(root)
        path = root
    return mod, path, fn.__qualname__


def _resolve(mod: str, path: str, qualname: str) -> Callable:
    if mod == "__main__":
        spec = importlib.util.spec_from_file_location("_spawned_main", path)
        module = importlib.util.module_from_spec(spec)
        sys.modules["_spawned_main"] = module
        spec.loader.exec_module(module)
    else:
        if path not in sys.path:
            sys.path.insert(0, path)
        module = importlib.import_module(mod)
    obj = module
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def _worker_main(job_path: str, out_path: str) -> None:
    """A spawned rank: run the pickled job, pickle its result (or its
    error) to ``out_path``."""
    with open(job_path, "rb") as f:
        target, args, kwargs = pickle.load(f)
    try:
        result = ("ok", _resolve(*target)(*args, **kwargs))
    except Exception as e:  # noqa: BLE001 - reported to the parent
        # the time of the failure, before this rank's teardown breaks its
        # peers' collectives: the parent orders the failures by it
        failed_at = time.monotonic()
        import traceback

        traceback.print_exc()
        result = ("error", f"{type(e).__name__}: {e}", failed_at)
    finally:
        if dist.is_initialized():
            try:
                destroy_distributed()
            except Exception:  # noqa: BLE001 - teardown after the result
                pass
    with open(out_path, "wb") as f:
        pickle.dump(result, f)
    sys.stdout.flush()
    sys.stderr.flush()
    # the result is on disk: skip interpreter teardown (a library's exit
    # handlers cannot hang the caller's wall-clock budget)
    os._exit(0 if result[0] == "ok" else 1)


def _kill(procs) -> None:
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
    for p in procs:
        p.wait()


def _tail(path: str, n: int = 4000) -> str:
    with open(path, "rb") as f:
        data = f.read()
    return data[-n:].decode(errors="replace")


def _load_result(path: str):
    """A rank's pickled result, or None when it wrote none."""
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return pickle.load(f)


def failure_order(seen: Sequence[int], results: Sequence[Any]) -> List[int]:
    """The failed ranks, the root cause first.  ``results[r]`` is rank r's
    result (``("error", message, failed_at)`` for a rank whose body
    raised, ``("ok", value)``, or None when it wrote none); ``seen`` lists
    the ranks observed exiting non-zero, in the order the poll saw them.
    Ranks whose body raised come first, by the time they raised (a rank
    fails first, then its teardown breaks its peers' collectives, so the
    peers raise later, even when every exit lands inside one poll); then
    the ranks that died without a result, in the order seen."""
    raised = [r for r, res in enumerate(results)
              if res is not None and res[0] == "error"]
    raised.sort(key=lambda r: (results[r][2], r))
    return raised + [r for r in seen if r not in raised]


def _failure_message(order, results, procs, logs, world_size) -> str:
    first = order[0]
    parts = [f"rank {first} of {world_size} failed first (rc "
             f"{procs[first].returncode}); every worker killed; the failed "
             f"ranks, the root cause first: {order}"]
    for r in order:
        what = results[r][1] if results[r] is not None else "no result"
        parts.append(f"-- rank {r} (rc {procs[r].returncode}): {what}\n"
                     + _tail(logs[r]))
    return "\n".join(parts)


def spawn(fn: Callable, world_size: int, args: Sequence = (),
          kwargs: Optional[dict] = None, timeout_s: float = 300.0,
          env: Optional[dict] = None, echo: bool = False) -> List[Any]:
    """Run ``fn(*args, **kwargs)`` in ``world_size`` fresh processes that
    form one world (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR=127.0.0.1`` and a free ``MASTER_PORT`` in their
    environment, for :func:`initialize_distributed`); returns each rank's
    result, by rank (results and arguments travel by pickle).

    ``fn`` must be a module-level function (of an importable module, or of
    the script run as ``__main__``).  If any worker fails, or the world
    outlives ``timeout_s`` seconds of wall clock, every worker is killed
    and this raises ``RuntimeError`` / ``TimeoutError`` with the output
    tails: a failure names the rank that failed first and gives every
    failed rank's tail, the root cause first (:func:`failure_order`).
    ``echo`` prints each rank's output once the world is done."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    base = dict(os.environ)
    base["PYTHONPATH"] = repo + os.pathsep + base.get("PYTHONPATH", "")
    base.update({"WORLD_SIZE": str(world_size), "MASTER_ADDR": "127.0.0.1",
                 "MASTER_PORT": str(free_port())})
    base.update(env or {})
    work = tempfile.mkdtemp(prefix="nxd_spawn_")
    job = os.path.join(work, "job.pkl")
    with open(job, "wb") as f:
        pickle.dump((_target(fn), tuple(args), dict(kwargs or {})), f)
    procs, logs, outs = [], [], []
    code = ("import sys; from neuronx_distributed_tpu_torch.utils."
            "distributed import _worker_main; _worker_main(sys.argv[1], "
            "sys.argv[2])")
    try:
        for rank in range(world_size):
            out = os.path.join(work, f"result{rank}.pkl")
            log_path = os.path.join(work, f"rank{rank}.log")
            penv = dict(base, RANK=str(rank), LOCAL_RANK=str(rank))
            with open(log_path, "wb") as log_f:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", code, job, out], env=penv,
                    stdout=log_f, stderr=subprocess.STDOUT,
                    start_new_session=True))
            logs.append(log_path)
            outs.append(out)
        deadline = time.monotonic() + timeout_s
        seen: List[int] = []   # ranks seen exiting non-zero, in poll order

        def check_failures():
            seen.extend(r for r, p in enumerate(procs)
                        if p.poll() not in (None, 0) and r not in seen)
            if not seen:
                return
            _kill(procs)
            results = [_load_result(out) for out in outs]
            order = failure_order(seen, results)
            raise RuntimeError(_failure_message(order, results, procs, logs,
                                                world_size))

        while any(p.poll() is None for p in procs):
            check_failures()
            if time.monotonic() > deadline:
                _kill(procs)
                raise TimeoutError(
                    f"world of {world_size} outlived {timeout_s} s; every "
                    "worker killed:\n" + "\n".join(
                        f"-- rank {r}:\n{_tail(p, 1500)}"
                        for r, p in enumerate(logs)))
            time.sleep(0.05)
        # every rank has exited: failures that landed inside the last poll
        # are ordered as above, not by rank
        check_failures()
        results = [_load_result(out) for out in outs]
        for rank, res in enumerate(results):
            if res is None or res[0] != "ok":
                raise RuntimeError(_failure_message(
                    [rank], results, procs, logs, world_size))
        results = [res[1] for res in results]
        if echo:
            for rank, path in enumerate(logs):
                text = _tail(path, 1 << 20).rstrip()
                if text:
                    print(f"-- rank {rank} output:\n{text}", flush=True)
        return results
    finally:
        _kill(procs)
        for name in os.listdir(work):
            os.remove(os.path.join(work, name))
        os.rmdir(work)
