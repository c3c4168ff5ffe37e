"""Pipeline-parallel execution: a host-driven executor over each rank's
stage (counterpart of ``neuronx_distributed_tpu/pipeline/engine.py``).

The JAX engine compiles the whole microbatch schedule into one
``lax.scan`` inside a ``shard_map`` whose pp axis is manual; its
synchronous slot tables and rank-uniform masked ticks exist to keep SPMD
collectives deadlock-free.  The port has no GSPMD: each pp rank is its own
process, holds its own stage (:class:`PipelineStage`: only its real
layers, under the pp = 1 model's parameter names) and walks its own task
list eagerly, as the reference's ``NxDPPModel`` did:

- **1F1B** (``schedule="1f1b"``, the default): ``TrainSchedule(M, P,
  r).tasks()``; a rank keeps at most ``TrainSchedule.num_in_flight()``
  microbatch graphs alive (``P - r``), and runs each backward with
  ``torch.autograd.backward(stage_out, grad_in)``, sending the stage
  input's ``.grad`` back;
- **GPipe** (``"gpipe"``): :func:`make_pipelined_loss_fn`, differentiable
  through the stage boundaries (a received activation's backward sends
  its gradient back, a sent one's receives it), so ``loss_sum.backward()``
  on every rank is the fill-drain backward: all ``M`` graphs live at once.
  It is the port's oracle for the other schedules;
- **interleaved** (``"interleaved"``, ``num_chunks = V > 1``): virtual
  stage ``s = v * P + r`` on rank ``r`` as chunk ``v`` (Megatron's
  placement); a rank's order is its non-empty ticks of
  :func:`.scheduler.build_interleaved_sync_tables` (forward, then backward,
  then that tick's transfers), and the forward-only path walks
  :func:`.scheduler.build_interleaved_fwd_tables` the same way.

Transfers (:func:`..parallel.mappings.stage_exchange`) are tagged by the
edge they cross (direction, receiving virtual stage, microbatch): each
group of transfers between two computations is posted in one batch,
receives first (the reference's rule), and a receive is waited when its
data is needed; sends complete by the end of the step.  A rank blocks only
on data it needs, and every order above is a valid timetable (JAX's slot
tables prove it), so no schedule can deadlock.  Counted in
``mappings.COUNTS``/``BYTES``/``SECONDS`` as ``pp_send_forward``,
``pp_recv_forward``, ``pp_send_backward`` and ``pp_recv_backward``.

The embedding lives on the first virtual stage and the head on the last,
each on one rank: JAX replicates them along pp and psums their gradients
(neither pipelined family ties its head), the port keeps each where it
runs.  The loss sum is summed over pp and dp once at the end of a step;
the token count comes from the global batch's labels, which every rank
holds, so it needs no collective.  At dp > 1 a rank runs its rows of each
microbatch (``microbatch(x, M)`` then its ``1 / dp``, as JAX splits the
batch) and leaves its share of each gradient in ``.grad``: the trainer
sums them over dp.  At context-parallel degree > 1 (JAX leaves cp
automatic inside a stage) each rank holds its cp rank's contiguous chunk
of every microbatch's sequence (a zigzag model's batch arrives in
``zigzag_permute`` order, as at pp = 1), its blocks attend over the cp
group, a stage boundary carries the chunk to the neighbour stage of the
same cp (and tp, dp) coordinates, the loss sum adds the cp ranks' once a
step and the trainer sums the gradients over cp.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from neuronx_distributed_tpu_torch.parallel import mappings, mesh
from neuronx_distributed_tpu_torch.parallel.mesh import PipelineParallel
from neuronx_distributed_tpu_torch.pipeline.partition import (
    interleaved_layout_from_spans,
    layout_from_spans,
    padded_layer_layout,
    partition_uniform,
    spans_from_cuts,
)
from neuronx_distributed_tpu_torch.pipeline.scheduler import (
    BackwardStep,
    ForwardStep,
    InferenceSchedule,
    RecvBackward,
    RecvForward,
    SendBackward,
    SendForward,
    TrainSchedule,
    build_interleaved_fwd_tables,
    build_interleaved_sync_tables,
)

# the stage's parts, by the JAX param tree's top-level keys
EMBED = "embed"
LAYERS = "layers"
HEAD = "head"

SCHEDULES = ("1f1b", "gpipe", "interleaved")


def microbatch(x, num_microbatches: int, dp: int = 1):
    """``[B, ...] -> [M, B / M, ...]`` (the reference's microbatch split).
    The microbatch size must also divide by the data-parallel degree
    ``dp``: each dp rank runs its rows of every microbatch."""
    if x.shape[0] % num_microbatches != 0:
        raise ValueError(
            f"batch size {x.shape[0]} not divisible by num_microbatches "
            f"{num_microbatches}")
    mb = x.shape[0] // num_microbatches
    if mb % dp != 0:
        raise ValueError(
            f"microbatch size {mb} (batch {x.shape[0]} / {num_microbatches} "
            f"microbatches) must be divisible by the data-parallel degree "
            f"{dp}")
    return x.reshape(num_microbatches, mb, *x.shape[1:])


# -- the stage ---------------------------------------------------------------


class PipelineStage(nn.Module):
    """One pp rank's part of a model: the embedding (first virtual stage),
    its layers in chunks (one a virtual stage it runs) and the head (last
    virtual stage), each registered under its name in the pp = 1 model
    (``model.layer_2....``), so a stage's ``named_parameters`` are the
    whole model's names for the pieces it holds and checkpoints move
    between pp degrees by name.

    ``parts`` (a family's wiring, :func:`..models.common.
    build_pipelined_causal_lm`): ``embed_path`` and ``make_embed(device)``;
    ``block_path(i)`` and ``make_block(device)``; ``make_head(device)``
    (a module whose children ``head_places`` maps to their paths);
    ``embed_fn(embed, ids, sp)``, ``run_fn(blocks, x, extras, sp)``,
    ``head_fn(head, h, sp) -> logits`` (this rank's vocab slice),
    ``loss_fn(logits, labels) -> (loss_sum, tok)``, ``sp_active(S)``,
    ``init_plan`` (the pp = 1 model's random-init order, see
    :meth:`init_random`), ``hidden_size`` and ``dtype`` (the activations'
    width and type)."""

    def __init__(self, parts: Dict[str, Any], chunks: Sequence[Sequence[int]],
                 has_embed: bool, has_head: bool, device):
        super().__init__()
        self.parts = parts
        self.chunks = tuple(tuple(c) for c in chunks)
        self.has_embed, self.has_head = has_embed, has_head
        self.device = torch.device(device)
        # the embedding and the head, unregistered here: their modules
        # are registered under their pp = 1 names by ``_put``
        self.__dict__["_embed"] = self.__dict__["_head"] = None
        if has_embed:
            self.__dict__["_embed"] = parts["make_embed"](device)
            self._put(parts["embed_path"], self._embed)
        for chunk in self.chunks:
            for i in chunk:
                self._put(parts["block_path"](i), parts["make_block"](device))
        if has_head:
            head = parts["make_head"](device)
            for child, path in parts["head_places"].items():
                self._put(path, getattr(head, child))
            self.__dict__["_head"] = head

    def _put(self, path: str, module: nn.Module) -> None:
        owner = self
        *dirs, leaf = path.split(".")
        for d in dirs:
            if not hasattr(owner, d):
                owner.add_module(d, nn.Module())
            owner = getattr(owner, d)
        owner.add_module(leaf, module)

    def block(self, i: int) -> nn.Module:
        return self.get_submodule(self.parts["block_path"](i))

    @property
    def layer_ids(self) -> Tuple[int, ...]:
        return tuple(i for c in self.chunks for i in c)

    def embed(self, ids, sp: bool):
        return self.parts["embed_fn"](self._embed, ids, sp)

    def run(self, chunk: int, x, extras: Sequence, sp: bool):
        """``(the chunk's output, the sum of its blocks' aux terms)``; the
        aux is None unless the family's blocks return one (``block_aux``:
        an MoE block's load-balancing term)."""
        out = self.parts["run_fn"]([self.block(i) for i in self.chunks[chunk]],
                                   x, extras, sp)
        return out if self.parts.get("block_aux") else (out, None)

    def logits(self, h, sp: bool):
        return self.parts["head_fn"](self._head, h, sp)

    def head_loss(self, h, labels, sp: bool):
        return self.parts["loss_fn"](self.logits(h, sp), labels)

    @torch.no_grad()
    def init_random(self, seed: int) -> "PipelineStage":
        """The pp = 1 model's random weights for the pieces this stage
        holds: one generator seeded with ``seed`` walks the pp = 1 model's
        init order (``init_plan``: ``(part, reset)`` pairs, ``part``
        ``"embed"``, ``("layer", i)`` or ``"head"``), and a part this
        stage does not hold is drawn into a throwaway module built on the
        same device, so the generator advances as at pp = 1."""
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        held = set(self.layer_ids)
        for part, reset in self.parts["init_plan"]:
            if part == EMBED:
                module = self._embed if self.has_embed else \
                    self.parts["make_embed"](self.device)
            elif part == HEAD:
                module = self._head if self.has_head else \
                    self.parts["make_head"](self.device)
            else:
                i = part[1]
                module = self.block(i) if i in held else \
                    self.parts["make_block"](self.device)
            reset(module, g)
        return self


# -- transfers ---------------------------------------------------------------

_KINDS = {("send", "F"): "pp_send_forward", ("recv", "F"): "pp_recv_forward",
          ("send", "B"): "pp_send_backward",
          ("recv", "B"): "pp_recv_backward"}


class _Link:
    """This rank's transfers: the tags of the edges it sends over and
    receives from, posted in batches (:func:`..parallel.mappings.
    stage_exchange`), receives waited on demand and every send waited by
    :meth:`finish`."""

    def __init__(self, pp: PipelineParallel, M: int, shape, dtype, device):
        self.pp, self.M = pp, M
        self.shape, self.dtype, self.device = tuple(shape), dtype, device
        self.pending: Dict[tuple, mappings.Pending] = {}
        self.sent: List[mappings.Pending] = []

    def _vs(self, chunk: int) -> int:
        return chunk * self.pp.size + self.pp.rank

    def _tag(self, d: str, vs: int, m: int) -> int:
        """The tag of the transfer INTO virtual stage ``vs`` (forward) or
        of the gradient OF virtual stage ``vs``'s output (backward)."""
        return 2 * (vs * self.M + m) + (0 if d == "F" else 1)

    def post(self, recvs, sends, outgoing: Dict[tuple, torch.Tensor]):
        """``recvs``/``sends``: ``(direction, chunk, microbatch)``; a
        send's tensor is ``outgoing[(direction, chunk, microbatch)]``
        (removed)."""
        if not recvs and not sends:
            return
        rl = []
        for d, v, m in recvs:
            src = self.pp.prev if d == "F" else self.pp.next
            rl.append((self.shape, self.dtype, self.device, src,
                       self._tag(d, self._vs(v), m), _KINDS[("recv", d)]))
        sl = []
        for d, v, m in sends:
            vs = self._vs(v)
            dst = self.pp.next if d == "F" else self.pp.prev
            to = vs + 1 if d == "F" else vs - 1
            sl.append((outgoing.pop((d, v, m)), dst, self._tag(d, to, m),
                       _KINDS[("send", d)]))
        got, sent = mappings.stage_exchange(sl, rl, self.pp.group,
                                            self.pp.cpu_group)
        for key, p in zip(recvs, got):
            self.pending[key] = p
        self.sent.extend(sent)

    def take(self, d: str, v: int, m: int) -> torch.Tensor:
        return self.pending.pop((d, v, m)).wait()[0]

    def finish(self) -> None:
        for p in self.sent:
            p.wait()
        self.sent = []
        if self.pending:
            raise RuntimeError(f"pipeline schedule left receives unread: "
                               f"{sorted(self.pending)}")


class _RecvActivation(torch.autograd.Function):
    """A received activation whose backward sends its gradient back."""

    @staticmethod
    def forward(ctx, anchor, x, link, key):
        ctx.link, ctx.key = link, key
        return x.detach().clone()

    @staticmethod
    def backward(ctx, g):
        _, v, m = ctx.key
        ctx.link.post([], [("B", v, m)], {("B", v, m): g})
        return None, None, None, None


class _SendActivation(torch.autograd.Function):
    """A sent activation: forward gives a zero token (added to the loss),
    whose backward receives the activation's gradient from the next
    stage."""

    @staticmethod
    def forward(ctx, y, link, key):
        ctx.link, ctx.key = link, key
        _, v, m = key
        link.post([], [("F", v, m)], {("F", v, m): y.detach()})
        return torch.zeros((), dtype=torch.float32, device=y.device)

    @staticmethod
    def backward(ctx, _):
        _, v, m = ctx.key
        ctx.link.post([("B", v, m)], [], {})
        return ctx.link.take("B", v, m), None, None


# -- programs ----------------------------------------------------------------

# a tick: (computations [(kind "F" | "B", chunk, mb)], receives, sends),
# the transfers posted after the computations, receives first
Tick = Tuple[List[tuple], List[tuple], List[tuple]]


def _from_tasks(tasks) -> List[Tick]:
    """A V = 1 task list as ticks: the transfers between two computations
    form one batch."""
    ticks: List[Tick] = []
    comp, recvs, sends = [], [], []
    for t in tasks:
        if isinstance(t, (ForwardStep, BackwardStep)):
            if recvs or sends:
                ticks.append((comp, recvs, sends))
                comp, recvs, sends = [], [], []
            comp.append(("F" if isinstance(t, ForwardStep) else "B", 0,
                         t.microbatch))
        elif isinstance(t, (RecvForward, RecvBackward)):
            recvs.append(("F" if isinstance(t, RecvForward) else "B", 0,
                          t.microbatch))
        elif isinstance(t, (SendForward, SendBackward)):
            sends.append(("F" if isinstance(t, SendForward) else "B", 0,
                          t.microbatch))
    if comp or recvs or sends:
        ticks.append((comp, recvs, sends))
    return ticks


def _from_tables(tb, r: int, train: bool) -> List[Tick]:
    """Rank ``r``'s non-empty ticks of an interleaved table: its forward,
    its backward (``train``), then what it sends and what arrives."""
    P, V = tb.num_stages, tb.num_chunks
    S = P * V
    prev, nxt = (r - 1) % P, (r + 1) % P
    ticks: List[Tick] = []
    for t in range(tb.num_slots):
        comp, recvs, sends = [], [], []
        fm, fc = tb.fwd_mb[r][t], tb.fwd_chunk[r][t]
        if fm >= 0:
            comp.append(("F", fc, fm))
            if fc * P + r < S - 1:
                sends.append(("F", fc, fm))
        pm, pc = tb.fwd_mb[prev][t], tb.fwd_chunk[prev][t]
        if pm >= 0 and pc * P + prev + 1 < S:
            recvs.append(("F", (pc * P + prev + 1) // P, pm))
        if train:
            bm, bc = tb.bwd_mb[r][t], tb.bwd_chunk[r][t]
            if bm >= 0:
                comp.append(("B", bc, bm))
                if bc * P + r > 0:
                    sends.append(("B", bc, bm))
            nm, nc = tb.bwd_mb[nxt][t], tb.bwd_chunk[nxt][t]
            if nm >= 0 and nc * P + nxt - 1 >= 0:
                recvs.append(("B", (nc * P + nxt - 1) // P, nm))
        if comp or recvs or sends:
            ticks.append((comp, recvs, sends))
    return ticks


def train_program(schedule: str, M: int, P: int, r: int, V: int = 1
                  ) -> List[Tick]:
    """Rank ``r``'s ticks for a training step of ``schedule``."""
    if schedule == "interleaved" and P > 1:
        return _from_tables(build_interleaved_sync_tables(M, P, V), r, True)
    return _from_tasks(TrainSchedule(M, P, r).tasks())


def forward_program(schedule: str, M: int, P: int, r: int, V: int = 1
                    ) -> List[Tick]:
    """Rank ``r``'s ticks for a forward-only pass of ``schedule``."""
    if schedule == "interleaved" and P > 1:
        return _from_tables(build_interleaved_fwd_tables(M, P, V), r, False)
    return _from_tasks(InferenceSchedule(M, P, r).tasks())


# -- the model ---------------------------------------------------------------


@dataclasses.dataclass
class PipelinedModel:
    """One pp rank's view of a pipeline-staged model (the PP analogue of
    the trainer's ``ParallelModel``; reference ``NxDPPModel``).

    ``module`` is this rank's :class:`PipelineStage` (what the optimizer
    and checkpoints take); every function takes the GLOBAL batch, the same
    on every rank:

    - ``loss_fn(ids, labels, *extras) -> (loss_sum, token_count)``: the
      fill-drain schedule, differentiable (``loss_sum.backward()`` on every
      rank is GPipe's backward), the same values on every rank;
    - ``loss_and_grad_fn(ids, labels, *extras) -> (loss_sum,
      token_count)``: the training schedule, leaving this rank's gradient
      sums (unnormalized, its dp share) in the stage's ``.grad``;
    - ``forward_fn(ids, *extras) -> logits``: the forward-only path, the
      last stage's logits (this tp rank's vocab slice) on every rank,
      broadcast once.

    ``layer_rows``: the JAX stack row of each real layer (the padded
    layout of ``partition.py``, for converting JAX's pipelined tree);
    ``extra_keys``: the batch keys the functions take as ``*extras``
    (``("positions", "segment_ids")`` for packed batches); ``stats``: the
    last call's ``peak_in_flight`` (microbatch graphs alive at once)."""

    module: PipelineStage
    device: torch.device
    num_microbatches: int
    loss_fn: Callable
    forward_fn: Callable
    loss_and_grad_fn: Callable
    schedule: str = "1f1b"
    layer_rows: Tuple[int, ...] = ()
    extra_keys: Tuple[str, ...] = ()
    num_chunks: int = 1
    stats: Dict[str, int] = dataclasses.field(default_factory=dict)
    num_layers: int = 0

    def num_parameters(self) -> int:
        return sum(p.numel() for p in self.module.parameters())


class _Batch:
    """A step's global batch: this dp rank's rows of each microbatch, this
    cp rank's chunk of their sequence, on the device, and the global
    token count."""

    def __init__(self, ids, labels, extras, M: int, device):
        dp = mesh.get_data_parallel_size()
        rank = mesh.get_data_parallel_rank()
        cp = mesh.get_context_parallel_size()
        cp_rank = mesh.get_context_parallel_rank()

        def mine(x):
            x = microbatch(torch.as_tensor(x), M, dp)
            per = x.shape[1] // dp
            x = x[:, rank * per:(rank + 1) * per]
            if cp > 1:
                if x.shape[2] % cp:
                    raise ValueError(f"sequence length {x.shape[2]} not "
                                     f"divisible by cp degree {cp}")
                C = x.shape[2] // cp
                x = x[:, :, cp_rank * C:(cp_rank + 1) * C]
            return x.contiguous().to(device, non_blocking=True)

        self.ids = mine(ids)
        self.labels = None if labels is None else mine(labels)
        self.extras = [mine(e) for e in extras]
        self.tok = None
        if labels is not None:
            self.tok = (torch.as_tensor(labels) >= 0).sum().to(
                device=device, dtype=torch.float32)

    def extra(self, m: int) -> list:
        return [e[m] for e in self.extras]


class _Engine:
    """The executor behind a :class:`PipelinedModel`'s functions."""

    def __init__(self, stage: PipelineStage, M: int, schedule: str, V: int,
                 extra_keys, num_layers: int):
        self.stage, self.M, self.schedule, self.V = stage, M, schedule, V
        self.num_layers = num_layers
        self.pp = PipelineParallel.current()
        self.S = self.pp.size * V
        self.n_extra = len(extra_keys)
        self.extra_keys = tuple(extra_keys)
        self.stats: Dict[str, int] = {}
        # a differentiable loss's transfers, finished when its backward
        # ends (the backward posts sends after the loss is returned), or
        # by the next call when no backward ran
        self._open: Optional[_Link] = None

    def settle(self) -> None:
        """Wait for the sends of the last differentiable loss's backward."""
        if self._open is not None:
            link, self._open = self._open, None
            link.finish()

    def _check(self, extras, fname) -> None:
        if len(extras) != self.n_extra:
            raise TypeError(
                f"{fname} of this pipelined model takes {self.n_extra} extra "
                f"per-token arrays ({', '.join(self.extra_keys)}) after its "
                f"ids/labels arguments; got {len(extras)} -- the trainer's "
                "make_train_step supplies them from the batch dict")

    def _vs(self, chunk: int) -> int:
        return chunk * self.pp.size + self.pp.rank

    def _link(self, b: _Batch, sp: bool) -> _Link:
        mb, S = b.ids.shape[1], b.ids.shape[2]
        tp = self.stage.parts["tp"].size
        shape = (mb, S // tp if sp else S, self.stage.parts["hidden_size"])
        return _Link(self.pp, self.M, shape, self.stage.parts["dtype"],
                     self.stage.device)

    def _sp(self, b: _Batch) -> bool:
        return self.stage.parts["sp_active"](b.ids.shape[2])

    def _aux_weight(self, b: _Batch):
        """The weight of a stage's aux sum in the loss sum (JAX's
        ``aux_w``): the global token count over layers x microbatches x
        the batch degree, so that the loss sum over pp and dp, divided by
        the token count, is the mean loss plus the layer, microbatch and
        routing-group mean of the aux terms (every batch rank of one
        routing group holds its group's aux)."""
        dp = mesh.get_data_parallel_size()
        return b.tok / (self.num_layers * self.M * dp)

    def _sum_loss(self, loss_local):
        """The loss sum over pp, dp and cp (the same on every rank)."""
        if self.pp.size > 1:
            loss_local = mappings.all_reduce(loss_local, self.pp.group,
                                             kind="pp_loss")
        if mesh.get_data_parallel_size() > 1:
            loss_local = mappings.all_reduce(
                loss_local, mesh.get_data_parallel_group(), kind="pp_loss")
        if mesh.get_context_parallel_size() > 1:
            loss_local = mappings.all_reduce(
                loss_local, mesh.get_context_parallel_group(),
                kind="pp_loss")
        return loss_local

    # the training schedules, with explicit backward
    def loss_and_grad(self, ids, labels, *extras):
        self.settle()
        self._check(extras, "loss_and_grad_fn")
        if self.schedule == "gpipe":
            loss_sum, tok = self.forward_loss(ids, labels, *extras,
                                              differentiable=True)
            loss_sum.backward()
            self.settle()
            return loss_sum.detach(), tok
        stage, dev = self.stage, self.stage.device
        b = _Batch(ids, labels, extras, self.M, dev)
        sp = self._sp(b)
        link = self._link(b, sp)
        stash: Dict[tuple, tuple] = {}
        outgoing: Dict[tuple, torch.Tensor] = {}
        loss_local = torch.zeros((), dtype=torch.float32, device=dev)
        aux_w = self._aux_weight(b)
        peak = 0
        program = train_program(self.schedule, self.M, self.pp.size,
                                self.pp.rank, self.V)
        for comp, recvs, sends in program:
            for kind, v, m in comp:
                vs = self._vs(v)
                if kind == "F":
                    if vs == 0:
                        x = stage.embed(b.ids[m], sp)
                    else:
                        x = link.take("F", v, m).requires_grad_()
                    y, aux = stage.run(v, x, b.extra(m), sp)
                    term = None
                    if aux is not None:
                        term = aux * aux_w
                        loss_local = loss_local + term.detach()
                        if not term.requires_grad:
                            term = None
                    if vs == self.S - 1:
                        ls, _ = stage.head_loss(y, b.labels[m], sp)
                        loss_local = loss_local + ls.detach().float()
                        stash[(v, m)] = (x, ls if term is None
                                         else ls.float() + term, None)
                    else:
                        outgoing[("F", v, m)] = y.detach()
                        stash[(v, m)] = (x, y, term)
                    peak = max(peak, len(stash))
                else:
                    x, out, term = stash.pop((v, m))
                    if vs == self.S - 1:
                        torch.autograd.backward(out)
                    elif term is None:
                        torch.autograd.backward(out, link.take("B", v, m))
                    else:
                        torch.autograd.backward(
                            [out, term],
                            [link.take("B", v, m), torch.ones_like(term)])
                    if vs > 0:
                        outgoing[("B", v, m)] = x.grad
            link.post(recvs, sends, outgoing)
        link.finish()
        self.stats.clear()
        self.stats["peak_in_flight"] = peak
        return self._sum_loss(loss_local), b.tok

    # the forward-only schedules
    def _forward(self, b: _Batch, differentiable: bool, want_logits: bool):
        """Walk the forward program; returns (the local loss sum, {mb:
        logits} on the last virtual stage)."""
        stage, dev = self.stage, self.stage.device
        sp = self._sp(b)
        link = self._link(b, sp)
        anchor = torch.zeros((), device=dev, requires_grad=True)
        outgoing: Dict[tuple, torch.Tensor] = {}
        loss_local = torch.zeros((), dtype=torch.float32, device=dev)
        aux_w = None if want_logits else self._aux_weight(b)
        logits = {}
        program = forward_program(self.schedule, self.M, self.pp.size,
                                  self.pp.rank, self.V)
        n_live = 0
        for comp, recvs, sends in program:
            for _, v, m in comp:
                vs = self._vs(v)
                if vs == 0:
                    x = stage.embed(b.ids[m], sp)
                else:
                    x = link.take("F", v, m)
                    if differentiable:
                        x = _RecvActivation.apply(anchor, x, link, ("F", v, m))
                y, aux = stage.run(v, x, b.extra(m), sp)
                if aux is not None and aux_w is not None:
                    loss_local = loss_local + aux * aux_w
                n_live += 1
                if vs == self.S - 1:
                    if want_logits:
                        logits[m] = stage.logits(y, sp)
                    else:
                        loss_local = loss_local + stage.head_loss(
                            y, b.labels[m], sp)[0].float()
                elif differentiable:
                    # the send is posted inside; its token joins the loss
                    loss_local = loss_local + _SendActivation.apply(
                        y, link, ("F", v, m))
                    sends = [s for s in sends if s != ("F", v, m)]
                else:
                    outgoing[("F", v, m)] = y.detach()
            link.post(recvs, sends, outgoing)
        self.stats.clear()
        self.stats["peak_in_flight"] = n_live if differentiable else 1
        return link, loss_local, logits

    def forward_loss(self, ids, labels, *extras, differentiable=None):
        self.settle()
        self._check(extras, "loss_fn")
        if differentiable is None:
            differentiable = torch.is_grad_enabled()
        b = _Batch(ids, labels, extras, self.M, self.stage.device)
        link, loss_local, _ = self._forward(b, differentiable, False)
        if differentiable:
            # backward of the sum over stages is the identity: each rank's
            # graph takes the loss's gradient once
            loss_local = _ReduceLoss.apply(loss_local, self)
            self._open = link
            return loss_local, b.tok
        link.finish()
        return self._sum_loss(loss_local), b.tok

    def forward(self, ids, *extras):
        self.settle()
        self._check(extras, "forward_fn")
        with torch.no_grad():
            b = _Batch(ids, None, extras, self.M, self.stage.device)
            link, _, logits = self._forward(b, False, True)
            link.finish()
            S = b.ids.shape[2]
            shape = (self.M, b.ids.shape[1], S,
                     self.stage.parts["vocab_size"]
                     // self.stage.parts["tp"].size)
            if self.stage.has_head:
                out = torch.stack([logits[m] for m in range(self.M)])
            else:
                out = torch.empty(shape, dtype=self.stage.parts["dtype"],
                                  device=self.stage.device)
            if self.pp.size > 1:
                out = mappings.broadcast(out, self.pp.last, self.pp.group,
                                         kind="pp_broadcast")
            if mesh.get_context_parallel_size() > 1:
                out = mappings.all_gather(out, 2,
                                          mesh.get_context_parallel_group())
            dp = mesh.get_data_parallel_size()
            if dp > 1:
                out = mappings.all_gather(out, 1,
                                          mesh.get_data_parallel_group())
            return out.reshape(-1, *out.shape[2:])


class _ReduceLoss(torch.autograd.Function):
    """The loss sum over pp and dp; backward the identity (every rank's
    graph takes the gradient of its own part)."""

    @staticmethod
    def forward(ctx, loss_local, engine):
        ctx.engine = engine
        return engine._sum_loss(loss_local.detach().clone())

    @staticmethod
    def backward(ctx, g):
        # the gradient sends this backward posts are waited when it ends:
        # a rank that tears its groups down next must not cut them off
        torch.autograd.Variable._execution_engine.queue_callback(
            ctx.engine.settle)
        return g, None


# -- construction -------------------------------------------------------------


def stage_layout(num_layers: int, num_stages: int, schedule: str = "1f1b",
                 pipeline_cuts: Optional[Sequence[int]] = None,
                 num_chunks: int = 1):
    """``(chunks, layer_rows)``: each rank's layers in chunks (``chunks[r][v]``,
    the layers of virtual stage ``v * P + r``) and the JAX stack row of
    every real layer, as JAX's ``build_pipelined_model`` places them:
    uniform spans by default, ``pipeline_cuts`` for uneven ones, a
    non-divisible count through ``padded_layer_layout``, Megatron's
    interleaved placement under ``schedule="interleaved"``."""
    P = num_stages
    if schedule == "interleaved":
        if P > 1:
            S = P * num_chunks
            if pipeline_cuts is not None:
                spans = spans_from_cuts(pipeline_cuts, num_layers)
                if len(spans) != S:
                    raise ValueError(
                        f"interleaved pipeline_cuts must define "
                        f"pp*num_chunks = {S} virtual-stage spans "
                        f"({S - 1} cuts); got {len(spans)} spans")
            else:
                spans = partition_uniform(num_layers, S)
            _, rows, _ = interleaved_layout_from_spans(spans, P, num_chunks)
            chunks = [[list(range(*spans[v * P + r]))
                       for v in range(num_chunks)] for r in range(P)]
            return chunks, tuple(rows)
        if pipeline_cuts is not None:
            raise ValueError("pipeline_cuts with pp == 1 has nothing to cut")
        return [[list(range(num_layers))]], tuple(range(num_layers))
    if pipeline_cuts is not None:
        spans = spans_from_cuts(pipeline_cuts, num_layers)
        _, rows, _ = layout_from_spans(spans, P)
    elif num_layers % P == 0:
        spans = partition_uniform(num_layers, P)
        rows = list(range(num_layers))
    else:
        spans = partition_uniform(num_layers, P)
        _, rows, _ = padded_layer_layout(num_layers, P)
    return [[list(range(*spans[r]))] for r in range(P)], tuple(rows)


def build_pipelined_model(parts: Dict[str, Any], num_layers: int,
                          num_microbatches: int, seed: int = 0,
                          schedule: str = "1f1b",
                          pipeline_cuts: Optional[Sequence[int]] = None,
                          extra_keys: Sequence[str] = (),
                          num_chunks: int = 1, device=None,
                          init: bool = True) -> PipelinedModel:
    """This rank's :class:`PipelinedModel`: its stage built from ``parts``
    (a family's wiring, :class:`PipelineStage`) on ``device``, its layers
    placed by :func:`stage_layout` over the live pipeline degree, its
    weights the pp = 1 model's from ``seed`` (``init``)."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown pipeline schedule {schedule!r} "
                         f"(1f1b | gpipe | interleaved)")
    pp = PipelineParallel.current()
    chunks, rows = stage_layout(num_layers, pp.size, schedule, pipeline_cuts,
                                num_chunks)
    V = len(chunks[0])
    mine = chunks[pp.rank]
    stage = PipelineStage(parts, mine, has_embed=pp.is_first,
                          has_head=pp.is_last, device=device)
    if init:
        stage.init_random(seed)
    # interleaved at pp = 1 is the plain 1F1B engine, as in JAX
    sched = schedule if (schedule != "interleaved" or pp.size > 1) else "1f1b"
    engine = _Engine(stage, num_microbatches, sched, V, extra_keys,
                     num_layers)

    def loss_fn(ids, labels, *extras):
        return engine.forward_loss(ids, labels, *extras)

    def loss_and_grad_fn(ids, labels, *extras):
        return engine.loss_and_grad(ids, labels, *extras)

    def forward_fn(ids, *extras):
        return engine.forward(ids, *extras)

    model = PipelinedModel(
        module=stage, device=stage.device, num_microbatches=num_microbatches,
        loss_fn=loss_fn, forward_fn=forward_fn,
        loss_and_grad_fn=loss_and_grad_fn, schedule=schedule,
        layer_rows=rows, extra_keys=tuple(extra_keys), num_chunks=V,
        stats=engine.stats, num_layers=num_layers)
    return model


def make_pipelined_loss_fn(model: PipelinedModel) -> Callable:
    """``model``'s differentiable fill-drain loss (GPipe): ``(ids, labels,
    *extras) -> (loss_sum, tok)``; ``loss_sum.backward()`` on every rank
    runs the backward through the stages."""
    return model.loss_fn


def make_1f1b_loss_and_grad_fn(model: PipelinedModel) -> Callable:
    """The 1F1B training schedule over ``model``'s stage (whatever
    schedule it was built with)."""
    return _variant(model, "1f1b").loss_and_grad_fn


def make_interleaved_1f1b_loss_and_grad_fn(model: PipelinedModel
                                           ) -> Callable:
    """The interleaved training schedule of a model built with
    ``schedule="interleaved"``."""
    if model.schedule != "interleaved":
        raise ValueError("the interleaved schedule needs a model built with "
                         "schedule='interleaved' (its chunked placement)")
    return model.loss_and_grad_fn


def make_interleaved_fwd_fn(model: PipelinedModel) -> Callable:
    """The interleaved forward-only path (logits) of a model built with
    ``schedule="interleaved"``."""
    if model.schedule != "interleaved":
        raise ValueError("the interleaved schedule needs a model built with "
                         "schedule='interleaved' (its chunked placement)")
    return model.forward_fn


def make_pipelined_forward_fn(model: PipelinedModel) -> Callable:
    """``model``'s forward-only path: ``(ids, *extras) -> logits``."""
    return model.forward_fn


def _variant(model: PipelinedModel, schedule: str) -> PipelinedModel:
    """The same stage under another V = 1 schedule."""
    if model.num_chunks > 1:
        raise ValueError("a chunked (interleaved) stage runs the "
                         "interleaved schedule only")
    engine = _Engine(model.module, model.num_microbatches, schedule, 1,
                     model.extra_keys, model.num_layers)

    return dataclasses.replace(
        model, loss_and_grad_fn=engine.loss_and_grad, schedule=schedule,
        loss_fn=lambda ids, labels, *ex: engine.forward_loss(ids, labels,
                                                             *ex),
        forward_fn=engine.forward, stats=engine.stats)
