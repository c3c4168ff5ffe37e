"""FSDP: ZeRO-3 as placement over the data-parallel ranks (counterpart of
the JAX trainer's ``fsdp=True``, ``optimizer/zero1.py:fsdp_spec``).

In the JAX package FSDP is a sharding of the parameters and XLA inserts
the all-gathers and reduce-scatters.  Here :func:`shard_module` does it by
hand on a built model: every parameter with an eligible dim
(``optimizer.zero1.fsdp_dim``: the largest global dim whose rank-local
size divides dp) is replaced by this rank's piece of its tensor-parallel
shard, cut tp-major along that dim (``optimizer/zero1.py`` says why), and
the module that owns it gets two forward hooks:

- before its forward, each piece is all-gathered over the dp group by
  :class:`_Gather` (an autograd Function: each rank broadcasts its piece,
  so the bytes cross once and exactly; gloo takes only broadcast and
  all-reduce on CUDA tensors) and the full tensor stands in the module's
  parameter slot for that forward;
- after it, the piece is put back, so nothing but autograd holds the full
  tensor: under remat the recompute in backward runs the hooks again and
  gathers again.

The Function's backward reduce-scatters the full gradient onto the piece
(an all-reduce, then this rank's slice, as every reduce-scatter of the port
over gloo, ROADMAP A9a), so after backward a piece's ``.grad`` is already
summed over dp and the trainer skips its data-parallel sum.  A rank holds
only its pieces of parameters, gradients and AdamW state.  Parameters with
no eligible dim, and MoE experts (whole on their ep shard, as JAX's
``fsdp_spec`` leaves a spec naming ``ep``), stay replicated over dp (their
gradients are summed by the trainer as without FSDP).  ``mappings.COUNTS`` counts ``fsdp_all_gather``
and ``fsdp_reduce_scatter`` (one a piece a gather).

Two uses fall outside that pattern, and each has its own entry:

- a parameter read outside its owner's ``forward`` (the tied head's
  ``ParallelEmbedding.attend`` reads the embedding table) is gathered
  there by :func:`gathered`;
- a module called several times a step (the LM head once a loss chunk,
  and again in each chunk's recompute) is gathered once under
  :func:`reuse`: the whole tensors are held until their gradient comes
  back, so every use sums into one gradient and that sum is
  reduce-scattered once, the replicated run's one dp sum of the same
  values.
"""

from __future__ import annotations

import contextlib
import time
import weakref
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from neuronx_distributed_tpu_torch.convert.jax_params import tp_cut
from neuronx_distributed_tpu_torch.optimizer.zero1 import fsdp_dim
from neuronx_distributed_tpu_torch.parallel import mappings
from neuronx_distributed_tpu_torch.parallel.layers import tp_layout
from neuronx_distributed_tpu_torch.parallel.mesh import TensorParallel
from neuronx_distributed_tpu_torch.parallel.moe import is_expert_parallel

# the parameter attributes the trainer and the checkpoints read, carried
# from a parameter to its FSDP piece
_CARRIED = ("tp_layout", "sequence_parallel")


def _gather(piece: torch.Tensor, dim: int, group, ranks: List[int],
            rank: int) -> torch.Tensor:
    t0 = time.perf_counter()
    parts = []
    for src, global_src in enumerate(ranks):
        buf = piece.contiguous() if src == rank else torch.empty_like(piece)
        dist.broadcast(buf, src=global_src, group=group)
        parts.append(buf)
    out = torch.cat(parts, dim)
    mappings.SECONDS["fsdp_all_gather"] += time.perf_counter() - t0
    mappings.COUNTS["fsdp_all_gather"] += 1
    return out


class _Gather(torch.autograd.Function):
    """Forward: the full tensor from every rank's piece along ``dim``;
    backward: the gradient summed over the group, this rank's slice (after
    ``release``, when given, lets go of the held whole tensors)."""

    @staticmethod
    def forward(ctx, piece, dim, group, ranks, rank, release):
        ctx.dim, ctx.group, ctx.rank, ctx.n = dim, group, rank, piece.shape[dim]
        ctx.release = release
        return _gather(piece, dim, group, ranks, rank)

    @staticmethod
    def backward(ctx, g):
        if ctx.release is not None:
            ctx.release()
        t0 = time.perf_counter()
        full = g.contiguous().clone()
        dist.all_reduce(full, group=ctx.group)
        out = full.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n).contiguous()
        mappings.SECONDS["fsdp_reduce_scatter"] += time.perf_counter() - t0
        mappings.COUNTS["fsdp_reduce_scatter"] += 1
        return out, None, None, None, None, None


class FsdpState:
    """What :func:`shard_module` did: ``pieces`` maps each sharded
    parameter's name to ``(owner module, attribute, dim)``; ``group``,
    ``size``, ``rank`` are the dp group's; ``reusing`` is set inside
    :func:`reuse`."""

    def __init__(self, group, size: int, rank: int):
        self.group, self.size, self.rank = group, size, rank
        self.ranks = dist.get_process_group_ranks(group)
        self.pieces: Dict[str, tuple] = {}
        self.reusing = False
        self._hooks: list = []

    def gather(self, piece: torch.Tensor, dim: int,
               release: Optional[Callable[[], None]] = None) -> torch.Tensor:
        return _Gather.apply(piece, dim, self.group, self.ranks, self.rank,
                             release)


def is_sharded(p: torch.Tensor) -> bool:
    """Whether ``p`` is an FSDP piece (its gradient is summed over dp by
    the gather's backward)."""
    return getattr(p, "fsdp_dim", None) is not None


def fsdp_state(module: nn.Module) -> Optional[FsdpState]:
    """The :class:`FsdpState` of a module :func:`shard_module` sharded, or
    None."""
    return getattr(module, "_fsdp", None)


def _versions(owner) -> tuple:
    return tuple(piece._version for piece, _ in owner._fsdp_params.values())


def _held(owner) -> Optional[Dict[str, torch.Tensor]]:
    """The whole tensors held from an earlier use under :func:`reuse`, if
    the pieces have not changed since (an optimizer step bumps their
    version)."""
    if owner._fsdp_hold is None:
        return None
    versions, full = owner._fsdp_hold
    if versions != _versions(owner):
        owner._fsdp_hold = None
        return None
    return full


def _release(ref) -> None:
    owner = ref()
    if owner is not None:
        owner._fsdp_hold = None


def _enter(owner) -> None:
    """Put ``owner``'s whole parameters in their slots for one use: the held
    ones, else gathered (and held when :func:`reuse` is on and autograd
    records); nested uses share them."""
    owner._fsdp_depth += 1
    if owner._fsdp_depth > 1:
        return
    st = owner._fsdp_owner
    full = _held(owner)
    if full is None:
        hold = st.reusing and torch.is_grad_enabled()
        # a weak reference: the held tensors' graph must not keep the
        # module alive
        release = (lambda ref=weakref.ref(owner): _release(ref)) if hold \
            else None
        full = {attr: st.gather(piece, dim, release)
                for attr, (piece, dim) in owner._fsdp_params.items()}
        if hold:
            owner._fsdp_hold = (_versions(owner), full)
    for attr, t in full.items():
        owner._parameters[attr] = t


def _exit(owner) -> None:
    owner._fsdp_depth -= 1
    if owner._fsdp_depth == 0:
        for attr, (piece, _) in owner._fsdp_params.items():
            owner._parameters[attr] = piece


def _pre_hook(module, args):
    _enter(module)


def _post_hook(module, args, out):
    _exit(module)


@contextlib.contextmanager
def gathered(module: nn.Module):
    """``module``'s whole parameters in their slots for the body, for a use
    outside its own ``forward`` (the tied head's ``attend``); a no-op on a
    module that owns no FSDP piece."""
    if getattr(module, "_fsdp_params", None) is None:
        yield
        return
    _enter(module)
    try:
        yield
    finally:
        _exit(module)


@contextlib.contextmanager
def reuse(model: nn.Module):
    """Inside the body, each module gathered is held until its gradient
    comes back: its later uses of the step, a checkpointed recompute's
    too, take the held tensors, and its gradient, summed over every use,
    is reduce-scattered once.  For a module called several times a step
    (the chunked loss's head); a no-op on a model :func:`shard_module` did
    not cut."""
    st = fsdp_state(model)
    if st is None:
        yield
        return
    st.reusing = True
    try:
        yield
    finally:
        st.reusing = False


def shard_module(module: nn.Module, group, size: int, rank: int
                 ) -> FsdpState:
    """Cut ``module``'s parameters over the data-parallel ``group`` (``size``
    ranks, this one ``rank``) in place, as the module docstring says;
    returns the state (also ``module._fsdp``).  Each piece is a new leaf
    ``nn.Parameter`` under the parameter's name, with ``fsdp_dim`` set and
    the tensor-parallel attributes carried over."""
    if fsdp_state(module) is not None:
        raise RuntimeError("module is already FSDP-sharded")
    st = FsdpState(group, size, rank)
    tp = TensorParallel.current()
    owners = {}
    for name, p in list(module.named_parameters()):
        if is_expert_parallel(p):
            continue   # an MoE expert stays whole on its ep shard (JAX fsdp_spec)
        cut = tp_cut(name, p.ndim, tp.size, tp.rank, tp.kvr)
        if cut is None and tp_layout(p) is not None:
            raise ValueError(
                f"{name} is sharded over tensor parallelism but has no known "
                "cut (convert.jax_params._SHARD_DIMS): cannot place it "
                "under FSDP")
        full = list(p.shape)
        if cut is not None:
            full[cut[0]] *= cut[1]
        dim = fsdp_dim(p.shape, full, size)
        if dim is None:
            continue
        owner_name, _, attr = name.rpartition(".")
        owner = module.get_submodule(owner_name) if owner_name else module
        n = p.shape[dim] // size
        with torch.no_grad():
            piece = nn.Parameter(p.detach().narrow(dim, rank * n, n).clone(),
                                 requires_grad=p.requires_grad)
        for a in _CARRIED:
            if hasattr(p, a):
                setattr(piece, a, getattr(p, a))
        piece.fsdp_dim = dim
        owner._parameters[attr] = piece
        if not hasattr(owner, "_fsdp_params"):
            owner._fsdp_params = {}
            owner._fsdp_owner = st
            owner._fsdp_depth = 0
            owner._fsdp_hold = None
            owners[id(owner)] = owner
        owner._fsdp_params[attr] = (piece, dim)
        st.pieces[name] = (owner, attr, dim)
    for owner in owners.values():
        st._hooks.append(owner.register_forward_pre_hook(_pre_hook))
        st._hooks.append(owner.register_forward_hook(_post_hook,
                                                     always_call=True))
    module._fsdp = st
    return st
