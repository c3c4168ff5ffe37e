"""Sharded checkpoints with tag rotation, resume, re-sharding and async
save (counterpart of ``neuronx_distributed_tpu/trainer/checkpoint.py``).

The JAX package writes orbax files; the port writes its own format under
the same contract:

- a checkpoint is a tag directory (``step_N``) under ``ckpt_dir`` with one
  directory a payload (``model``, ``optimizer``), each holding one
  ``rank_RRRRR.pt`` a writing rank (``torch.save`` of ``{path: tensor}``),
  and ``meta.json``: the tag, the mesh degrees, the scheduler state, the
  ``user_content``, and for every tensor its global shape, dtype and
  split (each stored piece's rank and its box in the global tensor);
- a state is a tree (nested dicts, lists, tuples) whose tensor leaves are
  whole tensors or :class:`Shard` s: a rank's piece of a global tensor and
  the cuts that made it (tensor parallelism's, then ZeRO-1's or FSDP's).
  Each rank writes only the pieces it owns: of the ranks holding the same
  box, the lowest writes it, so a replicated tensor is stored once;
- :func:`load_checkpoint` re-shards to the live layout: the template's
  leaves say which box each rank wants, and it is assembled from every
  stored piece that overlaps it (memory-mapped reads), whatever the mesh
  that wrote it.  Leaves come back at the template's dtype and device.
  A pipeline stage's tree holds only its own parameters, under the pp = 1
  model's names, so the index joins the stages' names and any pp degree
  loads any other's checkpoint;
- ``save_dtype`` downcasts the model payload's floating leaves only;
- ``async_save=True`` returns once the tensors are copied to host memory;
  the files are written on background threads and the save is finalised
  (shards durable, markers written, old tags rotated out) by
  :func:`wait_for_checkpoint`, which the next save and every load call;
- every destructive filesystem operation (clearing a stale tag,
  ``meta.json``, ``.done``, ``newest``, rotation) runs on rank 0 only,
  between host barriers (``utils.distributed.rendezvous``); the markers go
  through :func:`_atomic_write` (tmp + ``fsync`` + ``os.replace``) in the
  JAX package's order, so a kill at any point leaves :func:`newest_tag`
  on a complete checkpoint.  The ``ckpt/*`` fault points sit where the
  JAX package's do.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from neuronx_distributed_tpu_torch.resilience.faults import fault_point
from neuronx_distributed_tpu_torch.utils import distributed
from neuronx_distributed_tpu_torch.utils.dtypes import cast_floating, dtype_name
from neuronx_distributed_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

_NEWEST = "newest"
_DONE = ".done"
_META = "meta.json"


@dataclasses.dataclass(frozen=True)
class Shard:
    """A rank's piece of a global tensor: ``tensor`` is the global tensor
    cut by ``cuts`` in order, each cut ``(dim, parts, index)`` keeping piece
    ``index`` of ``parts`` along ``dim``."""

    tensor: torch.Tensor
    cuts: Tuple[Tuple[int, int, int], ...] = ()

    def box(self) -> Tuple[List[int], List[int], List[int]]:
        """``(global shape, start, size)`` of this piece."""
        return box(self.tensor.shape, self.cuts)


def box(local_shape: Sequence[int], cuts) -> Tuple[List[int], List[int],
                                                   List[int]]:
    """``(global shape, start, size)`` of a piece of ``local_shape`` made
    by ``cuts``."""
    glob_ = list(local_shape)
    for d, n, _ in cuts:
        glob_[d] *= n
    start, size = [0] * len(glob_), list(glob_)
    for d, n, i in cuts:
        size[d] //= n
        start[d] += i * size[d]
    return glob_, start, size


# -- trees --------------------------------------------------------------------


def _is_tensor_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, Shard))


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """``{path: leaf}`` over nested dicts, lists and tuples (paths joined by
    ``/``; None leaves dropped)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
        return out
    return {} if tree is None else {prefix[:-1]: tree}


def _rebuild(template: Any, values: Dict[str, Any], prefix: str = "") -> Any:
    if isinstance(template, dict):
        return {k: _rebuild(template[k], values, f"{prefix}{k}/")
                for k in template}
    if isinstance(template, (list, tuple)):
        out = [_rebuild(v, values, f"{prefix}{i}/")
               for i, v in enumerate(template)]
        return out if isinstance(template, list) else tuple(out)
    return None if template is None else values[prefix[:-1]]


def _cast_model(tree: Any, dtype) -> Any:
    if isinstance(tree, Shard):
        return Shard(cast_floating(tree.tensor, dtype), tree.cuts)
    if isinstance(tree, dict):
        return {k: _cast_model(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast_model(v, dtype) for v in tree)
    return cast_floating(tree, dtype)


# -- the filesystem discipline ------------------------------------------------


def _barrier(name: str) -> None:
    distributed.rendezvous(name)


def _atomic_write(path: str, text: str) -> None:
    """Crash-consistent marker write: tmp file + ``fsync`` + ``os.replace``
    (stale tmps of killed saves are reaped first)."""
    for stale in glob.glob(f"{path}.tmp.*"):
        try:
            os.unlink(stale)
        except OSError:
            pass
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _tag_dir(ckpt_dir: str, tag: str) -> str:
    return os.path.join(ckpt_dir, tag)


def _list_tags(ckpt_dir: str) -> List[str]:
    """Completed tags (with ``.done``), oldest first."""
    if not os.path.isdir(ckpt_dir):
        return []
    tags = [d for d in sorted(os.listdir(ckpt_dir))
            if os.path.isdir(_tag_dir(ckpt_dir, d))
            and os.path.exists(os.path.join(_tag_dir(ckpt_dir, d), _DONE))]
    tags.sort(key=lambda d: os.path.getmtime(
        os.path.join(_tag_dir(ckpt_dir, d), _DONE)))
    return tags


def newest_tag(ckpt_dir: str) -> Optional[str]:
    """The ``newest`` pointer's tag when it is complete, else the most
    recently completed tag, else None."""
    p = os.path.join(ckpt_dir, _NEWEST)
    if os.path.exists(p):
        with open(p) as f:
            tag = f.read().strip()
        if tag and os.path.exists(os.path.join(_tag_dir(ckpt_dir, tag),
                                               _DONE)):
            return tag
    tags = _list_tags(ckpt_dir)
    return tags[-1] if tags else None


def _mesh_degrees() -> dict:
    from neuronx_distributed_tpu_torch.parallel import mesh

    out = {"world_size": distributed.get_world_size()}
    if mesh.model_parallel_is_initialized():
        out.update(
            tensor_parallel_size=mesh.get_tensor_parallel_size(),
            kv_size_multiplier=mesh.get_kv_size_multiplier(),
            data_parallel_size=mesh.get_data_parallel_size(),
            pipeline_parallel_size=mesh.get_pipeline_parallel_size(),
            context_parallel_size=mesh.get_context_parallel_size())
    return out


def _all_gather_object(obj: Any) -> List[Any]:
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return [obj]
    out: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj, group=distributed.host_group())
    return out


# -- save ---------------------------------------------------------------------

# the last save's and load's numbers (bytes this rank moved, seconds), read
# by the card smoke: ``blocking_s`` is what an async save holds the caller
# for (the copies to host memory), ``write_s`` the files, ``total_s`` the
# whole save through finalisation
LAST_SAVE: Dict[str, float] = {}
LAST_LOAD: Dict[str, float] = {}


class _PendingSave:
    """An in-flight save: its writer threads and its finalisation."""

    def __init__(self, threads, errors, finalize, t0: float):
        self._threads, self._errors = threads, errors
        self._finalize, self._t0 = finalize, t0
        self.done = False

    def wait(self) -> None:
        if self.done:
            return
        self.done = True
        t = time.perf_counter()
        for th in self._threads:
            th.join()
        LAST_SAVE["write_wait_s"] = time.perf_counter() - t
        if self._errors:
            raise self._errors[0]
        self._finalize()
        LAST_SAVE["total_s"] = time.perf_counter() - self._t0


_PENDING: Optional[_PendingSave] = None


def wait_for_checkpoint() -> None:
    """Block until the last async :func:`save_checkpoint` is committed
    (shards durable, ``.done``/``newest`` written, rotation done)."""
    global _PENDING
    if _PENDING is not None:
        pending, _PENDING = _PENDING, None
        pending.wait()


def _write_payload(path: str, tensors: Dict[str, torch.Tensor],
                   errors: list) -> None:
    try:
        tmp = f"{path}.tmp.{os.getpid()}"
        torch.save(tensors, tmp)
        with open(tmp, "rb+") as f:
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException as e:  # re-raised by wait()
        errors.append(e)


def save_checkpoint(ckpt_dir: str, tag: str, model_state: Any,
                    optimizer_state: Any = None, scheduler_state: Any = None,
                    user_content: Any = None,
                    num_kept_ckpts: Optional[int] = None,
                    async_save: bool = False, save_dtype: Any = None) -> str:
    """Save a tagged checkpoint; every rank calls it with its own pieces.
    With ``async_save`` the call returns once the tensors are copied to
    host memory; the save is durable after :func:`wait_for_checkpoint`
    (the next save calls it).  ``save_dtype`` (e.g. ``torch.bfloat16``)
    downcasts the MODEL payload's floating leaves; the optimizer state is
    never downcast.  Non-tensor leaves are stored in ``meta.json`` (rank
    0's values)."""
    global _PENDING
    wait_for_checkpoint()  # at most one save in flight
    t0 = time.perf_counter()
    if save_dtype is not None:
        model_state = _cast_model(model_state, save_dtype)
    path = _tag_dir(ckpt_dir, tag)
    rank = distributed.get_rank()
    if distributed.is_primary():
        if os.path.exists(path):
            shutil.rmtree(path)
        os.makedirs(path, exist_ok=True)
    _barrier(f"ckpt_prep:{tag}")
    fault_point("ckpt/pre_shard_write", tag=tag)

    payloads = [("model", model_state)]
    if optimizer_state is not None:
        payloads.append(("optimizer", optimizer_state))
    mine, extras = {}, {}
    for name, state in payloads:
        flat = _flatten(state)
        mine[name] = {}
        extras[name] = {}
        for key, leaf in flat.items():
            if _is_tensor_leaf(leaf):
                sh = leaf if isinstance(leaf, Shard) else Shard(leaf)
                g, start, size = sh.box()
                mine[name][key] = (sh.tensor, g, start, size)
            else:
                extras[name][key] = leaf
    # who writes what: of the ranks holding the same box, the lowest
    boxes = _all_gather_object(
        {name: {k: (g, s, z, dtype_name(t.dtype))
                for k, (t, g, s, z) in entries.items()}
         for name, entries in mine.items()})
    index: Dict[str, Dict[str, dict]] = {}
    for r, per in enumerate(boxes):
        for name, entries in per.items():
            for key, (g, s, z, dt) in entries.items():
                rec = index.setdefault(name, {}).setdefault(
                    key, {"shape": g, "dtype": dt, "shards": []})
                if rec["shape"] != g:
                    raise ValueError(
                        f"{name}/{key}: ranks disagree on the global shape "
                        f"({rec['shape']} vs {g})")
                if not any(p["start"] == s and p["size"] == z
                           for p in rec["shards"]):
                    rec["shards"].append({"rank": r, "start": s, "size": z})
    # the host copies (a snapshot: training goes on updating in place)
    t_snap = time.perf_counter()
    nbytes = 0
    to_write: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, entries in mine.items():
        own = {}
        for key, (t, g, s, z) in entries.items():
            if any(p["rank"] == rank and p["start"] == s and p["size"] == z
                   for p in index[name][key]["shards"]):
                own[key] = t.detach().to("cpu", copy=True)
                nbytes += own[key].numel() * own[key].element_size()
        to_write[name] = own
    LAST_SAVE.clear()
    LAST_SAVE.update(bytes=float(nbytes),
                     blocking_s=time.perf_counter() - t_snap)

    threads: list = []
    errors: list = []
    for name, _ in payloads:
        os.makedirs(os.path.join(path, name), exist_ok=True)
        th = threading.Thread(
            target=_write_payload,
            args=(os.path.join(path, name, f"rank_{rank:05d}.pt"),
                  to_write[name], errors),
            name=f"ckpt-{name}", daemon=True)
        th.start()
        threads.append(th)
        fault_point("ckpt/mid_shard_write", tag=tag, payload=name)

    def finalize() -> None:
        _barrier(f"ckpt_written:{tag}")
        if distributed.is_primary():
            meta = {"tag": tag, "mesh": _mesh_degrees(),
                    "tensors": index,
                    "extras": {k: v for k, v in extras.items() if v}}
            if scheduler_state is not None:
                meta["scheduler"] = scheduler_state
            if user_content is not None:
                meta["user_content"] = user_content
            fault_point("ckpt/pre_meta", tag=tag)
            _atomic_write(os.path.join(path, _META), json.dumps(meta))
            fault_point("ckpt/pre_done", tag=tag)
            _atomic_write(os.path.join(path, _DONE), "ok")
            fault_point("ckpt/pre_newest", tag=tag)
            _atomic_write(os.path.join(ckpt_dir, _NEWEST), tag)
            if num_kept_ckpts is not None and num_kept_ckpts > 0:
                for old in _list_tags(ckpt_dir)[:-num_kept_ckpts]:
                    logger.info("rotating out checkpoint %s", old)
                    shutil.rmtree(_tag_dir(ckpt_dir, old), ignore_errors=True)
                    fault_point("ckpt/mid_rotation", tag=tag, rotated=old)
        _barrier(f"ckpt_done:{tag}")
        logger.info("saved checkpoint %s", path)

    _PENDING = _PendingSave(threads, errors, finalize, t0)
    if not async_save:
        wait_for_checkpoint()
    return path


# -- load ---------------------------------------------------------------------


def _intersect(a_start, a_size, b_start, b_size):
    lo = [max(x, y) for x, y in zip(a_start, b_start)]
    hi = [min(x + n, y + m) for x, n, y, m in zip(a_start, a_size, b_start,
                                                  b_size)]
    if any(h <= lo_ for lo_, h in zip(lo, hi)):
        return None
    return lo, hi


def _assemble(rec: dict, key: str, want_start, want_size, files) -> torch.Tensor:
    out = torch.empty(want_size, dtype=getattr(torch, rec["dtype"]))
    covered = 0
    for piece in rec["shards"]:
        hit = _intersect(want_start, want_size, piece["start"], piece["size"])
        if hit is None:
            continue
        lo, hi = hit
        src = files(piece["rank"])[key]
        src_idx = tuple(slice(a - s, b - s)
                        for a, b, s in zip(lo, hi, piece["start"]))
        dst_idx = tuple(slice(a - s, b - s)
                        for a, b, s in zip(lo, hi, want_start))
        out[dst_idx] = src[src_idx]
        n = 1
        for a, b in zip(lo, hi):
            n *= b - a
        covered += n
    want = 1
    for n in want_size:
        want *= n
    if covered != want:
        raise ValueError(f"{key}: the checkpoint's pieces cover {covered} of "
                         f"the {want} elements this rank needs")
    return out


def _restore_payload(path: str, rec_index: Dict[str, dict], extras: dict,
                     template: Any) -> Any:
    cache: Dict[int, dict] = {}

    def files(r: int) -> dict:
        if r not in cache:
            cache[r] = torch.load(os.path.join(path, f"rank_{r:05d}.pt"),
                                  mmap=True, weights_only=True)
        return cache[r]

    values = {}
    nbytes = 0
    for key, leaf in _flatten(template).items():
        if not _is_tensor_leaf(leaf):
            if key not in extras:
                raise KeyError(f"{key!r} is not in the checkpoint")
            values[key] = extras[key]
            continue
        sh = leaf if isinstance(leaf, Shard) else Shard(leaf)
        if key not in rec_index:
            raise KeyError(f"{key!r} is not in the checkpoint")
        rec = rec_index[key]
        g, start, size = sh.box()
        if list(g) != list(rec["shape"]):
            raise ValueError(f"{key}: the live layout's global shape {g} is "
                             f"not the checkpoint's {rec['shape']}")
        t = _assemble(rec, key, start, size, files)
        values[key] = t.to(device=sh.tensor.device, dtype=sh.tensor.dtype)
        nbytes += t.numel() * t.element_size()
    LAST_LOAD["bytes"] = LAST_LOAD.get("bytes", 0.0) + float(nbytes)
    return _rebuild(template, values)


def load_checkpoint(ckpt_dir: str, tag: Optional[str] = None,
                    model_template: Any = None,
                    optimizer_template: Any = None
                    ) -> Tuple[Any, Any, Any, Any]:
    """``(model_state, optimizer_state, scheduler_state, user_content)``
    of tag ``tag`` (default: :func:`newest_tag`), re-sharded to the live
    layout: each tensor leaf of a template (a whole tensor or a
    :class:`Shard`) comes back as this rank's piece, at the template's
    dtype and device; non-tensor leaves come from ``meta.json``.  A None
    template skips its payload; an optimizer template with no optimizer
    payload gives None."""
    wait_for_checkpoint()
    t0 = time.perf_counter()
    LAST_LOAD.clear()
    tag = tag or newest_tag(ckpt_dir)
    if tag is None:
        raise FileNotFoundError(f"no completed checkpoints under {ckpt_dir}")
    path = _tag_dir(ckpt_dir, tag)
    with open(os.path.join(path, _META)) as f:
        meta = json.load(f)
    extras = meta.get("extras", {})
    out = []
    for name, template in (("model", model_template),
                           ("optimizer", optimizer_template)):
        if template is None or name not in meta["tensors"] and \
                name not in extras:
            out.append(None)
            continue
        out.append(_restore_payload(os.path.join(path, name),
                                    meta["tensors"].get(name, {}),
                                    extras.get(name, {}), template))
    LAST_LOAD["seconds"] = time.perf_counter() - t0
    logger.info("loaded checkpoint %s", path)
    return out[0], out[1], meta.get("scheduler"), meta.get("user_content")


# -- a trainer's state as checkpoint trees -------------------------------------


def _tp_cuts(name: str, p: torch.Tensor) -> tuple:
    from neuronx_distributed_tpu_torch.convert.jax_params import tp_cut
    from neuronx_distributed_tpu_torch.parallel.mesh import TensorParallel

    tp = TensorParallel.current()
    cut = tp_cut(name, p.ndim, tp.size, tp.rank, tp.kvr)
    return () if cut is None else (cut,)


def _ep_cuts(p: torch.Tensor) -> tuple:
    """An MoE expert's cut over ep: its rank's experts on dim 0."""
    from neuronx_distributed_tpu_torch.parallel import mesh
    from neuronx_distributed_tpu_torch.parallel.moe import is_expert_parallel

    ep = mesh.get_expert_parallel_size()
    if ep == 1 or not is_expert_parallel(p):
        return ()
    return ((0, ep, mesh.get_expert_parallel_rank()),)


def _dp_cut(dim: Optional[int]) -> tuple:
    from neuronx_distributed_tpu_torch.parallel import mesh

    if dim is None:
        return ()
    return ((dim, mesh.get_data_parallel_size(),
             mesh.get_data_parallel_rank()),)


def model_shards(model) -> Dict[str, Shard]:
    """``{parameter name: Shard}`` of a ``ParallelModel`` (or module): this
    rank's tensor-parallel shard of each parameter (an MoE expert's cut
    over ep too), cut again over dp under FSDP."""
    module = getattr(model, "module", model)
    return {name: Shard(p, _tp_cuts(name, p) + _ep_cuts(p)
                        + _dp_cut(getattr(p, "fsdp_dim", None)))
            for name, p in module.named_parameters()}


def _state_pairs(model, optimizer):
    """``(name, parameter, optimizer key, dp cut dim)`` for every trained
    parameter: the key is the tensor AdamW updates (a ZeRO-1 slice copy
    under ZeRO-1)."""
    module = getattr(model, "module", model)
    zero1 = getattr(optimizer, "zero1", None)
    slices = {}
    if zero1 is not None:
        for p, s, lay in zip(zero1.params, zero1.shards, zero1.layout):
            slices[p] = (s, None if lay is None else lay[0])
    for name, p in module.named_parameters():
        if not p.requires_grad:
            continue
        if p in slices:
            key, dim = slices[p]
        else:
            key, dim = p, getattr(p, "fsdp_dim", None)
        yield name, p, key, dim


def optimizer_shards(model, optimizer) -> dict:
    """The AdamW state of a ``ParallelOptimizer`` as a checkpoint tree:
    ``{"count": updates taken, "exp_avg": {name: Shard}, "exp_avg_sq":
    {...}}``, each moment cut as the tensor it updates (its parameter's
    tp shard, then its ZeRO-1 or FSDP piece).  Moments not created yet
    (no update taken) are zeros, as optax's initial state."""
    opt = optimizer.optimizer
    out = {"count": int(optimizer.update_count), "exp_avg": {},
           "exp_avg_sq": {}}
    for name, p, key, dim in _state_pairs(model, optimizer):
        st = opt.state.get(key, {})
        cuts = _tp_cuts(name, p) + _ep_cuts(p) + _dp_cut(dim)
        for m in ("exp_avg", "exp_avg_sq"):
            t = st.get(m)
            out[m][name] = Shard(torch.zeros_like(key) if t is None else t,
                                 cuts)
    return out


@torch.no_grad()
def restore_model(model, state: Dict[str, torch.Tensor],
                  optimizer=None) -> None:
    """Copy a loaded model tree into the live parameters in place (and
    into a ZeRO-1 optimizer's slice copies)."""
    module = getattr(model, "module", model)
    for name, p in module.named_parameters():
        p.copy_(state[name])
    zero1 = getattr(optimizer, "zero1", None)
    if zero1 is not None:
        for p, s, lay in zip(zero1.params, zero1.shards, zero1.layout):
            if lay is not None:
                s.copy_(p.narrow(lay[0], zero1.rank * lay[1], lay[1]))


@torch.no_grad()
def restore_optimizer(model, optimizer, state: dict) -> None:
    """Install a loaded optimizer tree: every moment, AdamW's step counter
    and ``update_count`` (the schedule continues from it)."""
    opt = optimizer.optimizer
    count = int(state["count"])
    for name, _, key, _ in _state_pairs(model, optimizer):
        st = opt.state[key]
        for m in ("exp_avg", "exp_avg_sq"):
            if m in st:
                st[m].copy_(state[m][name])
            else:
                st[m] = state[m][name].clone()
        st["step"] = torch.tensor(float(count), dtype=torch.float32)
    optimizer.update_count = count
