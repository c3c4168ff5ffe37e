"""Expert-parallel Mixture-of-Experts layer (counterpart of
``neuronx_distributed_tpu/parallel/moe.py``).

The JAX layer is the GShard/Switch capacity-bounded formulation on one
logical token set: router probabilities ``[N, E]`` in fp32, top-k choices,
each (token, choice)'s position in its expert's buffer by a cumulative
count (k-th choices ranked after every (k-1)-th: GShard's priority),
choices past the static capacity dropped, the kept gates renormalised per
token, a per-expert gated FFN over ``[E, C, H]`` buffers and a combine back
to token-major.  XLA places the buffers on the ``ep`` axis and inserts the
reshards.  The port does those moves by hand (:class:`..mesh.
ExpertParallel`):

- the tokens are all-gathered over the routing group in batch order
  (:func:`..mappings.gather_tokens`; its backward reduce-scatters): at
  pipeline degree 1 the batch group, dp x ep, since JAX routes the global
  batch (capacity, drops and the aux statistic are nonlinear in the
  routing set); under a pipeline the ep group, as the JAX engine's manual
  ep does.  Every rank then routes the same token set;
- a rank holds experts ``[e0, e0 + E / ep)`` and runs them on the global
  buffers (replicated over dp, as GSPMD replicates them);
- its output rows for its ep group's tokens are reduce-scattered over ep
  (:func:`..mappings.reduce_scatter_tokens`), each rank keeping its own.

At tensor-parallel degree > 1 each expert's ``gate_up`` is a column cut
over I and its ``down`` a row cut: the combined output is a partial sum,
reduced once after the combine (all-reduce, or a reduce-scatter onto the
sequence under sequence parallelism, whose input is gathered first).  The
router is replicated: its gate gradients (each rank's from its I slice)
and the expert path's input gradient are summed over tp on their way back
(``copy_to_tensor_parallel_region``), so the router's gradient and the
residual stream's are whole on every rank, as a replicated parameter's
must be.

An expert's gradient holds every token of its routing group, so the
trainer sums ``gate_up``/``down`` over the pure dp axis only (they carry
``expert_parallel``: :mod:`.grads`, ZeRO-1 and FSDP leave them whole on
their ep shard, as the JAX specs naming ``ep`` do); the router sums over
dp x ep like every other parameter.

Dispatch ``"scatter"`` places each kept (token, choice) in flat slot
``e * C + pos`` with ``index_add_`` (dropped and remote pairs go to a
sentinel row ``E * C`` that never feeds an expert) and gathers the
outputs back; ``"einsum"`` builds the one-hot ``dispatch`` / ``combine
[N, E, C]`` (the parity oracle).  Both combine choice by choice in k order
in fp32 (the products exact, the gates cast to the compute type first),
so the two agree bit for bit.  ``router_type="expert_choice"``: each
local expert takes its top-C tokens by probability, combined by a
segment sum; aux is 0.

The expert FFN is ``silu(x W_gate) * (x W_up) -> W_down`` as batched
products over the local experts (plain torch: the JAX layer is plain XLA,
with no Pallas kernel).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from neuronx_distributed_tpu_torch.parallel.layers import SHARDED, set_tp_layout
from neuronx_distributed_tpu_torch.parallel.mappings import (
    copy_to_tensor_parallel_region,
    gather_from_sequence_parallel_region,
    gather_tokens,
    reduce_from_tensor_parallel_region,
    reduce_scatter_to_sequence_parallel_region,
    reduce_scatter_tokens,
)
from neuronx_distributed_tpu_torch.parallel.mesh import (
    ExpertParallel,
    TensorParallel,
)

DISPATCHES = ("einsum", "scatter")
ROUTERS = ("topk", "expert_choice")


def load_balancing_loss(probs: torch.Tensor,
                        expert_mask: torch.Tensor) -> torch.Tensor:
    """Switch aux loss: ``E * sum_e(fraction_routed_e * mean_router_prob_e)``
    over ``probs [N, E]`` (fp32) and the 0/1 top-k selections
    ``expert_mask [N, E]`` (before the capacity drop); 1 at balance."""
    E = probs.shape[-1]
    frac = expert_mask.float().mean(dim=0)
    mean_p = probs.mean(dim=0)
    return E * (frac * mean_p).sum()


def capacity(capacity_factor: float, top_k: int, n_tokens: int,
             num_experts: int) -> int:
    """The static buffer length: ``ceil(factor * K * N / E)``, at least K,
    rounded up to a multiple of 4 and at most N (JAX's arithmetic, in its
    order)."""
    cap = max(int(capacity_factor * top_k * n_tokens / num_experts + 0.999),
              top_k)
    return min(-(-cap // 4) * 4, n_tokens)


def is_expert_parallel(p: torch.Tensor) -> bool:
    """Whether ``p`` is an expert's weight (summed over the pure dp axis,
    never cut by ZeRO-1 or FSDP)."""
    return getattr(p, "expert_parallel", False)


class ExpertParallelMLP(nn.Module):
    """Top-k routed MoE FFN (JAX ``ExpertParallelMLP``): ``forward(x, sp)
    -> (y, aux)`` for ``x [B, S, H]`` (this rank's sequence slice when
    ``sp``), ``aux`` the fp32 load-balancing term of the routing set.

    ``num_experts``: the experts this module's routing space holds, or
    with ``num_experts_global`` (the pipeline's manual form) the experts a
    rank holds; either way a rank holds ``num_experts_global / ep``.
    Parameters (JAX names and layouts): ``router [H, Eg]`` replicated,
    ``gate_up [E, H, 2, I / tp]`` and ``down [E, I / tp, H]``, this rank's
    experts, in ``param_dtype`` and cast to ``dtype`` at each product."""

    def __init__(self, hidden_size: int, num_experts: int,
                 intermediate_size: int, top_k: int = 2,
                 capacity_factor: float = 1.25, dispatch: str = "einsum",
                 num_experts_global: int = 0, router_type: str = "topk",
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.tp = TensorParallel.current()
        self.ep = ExpertParallel.current()
        manual = bool(num_experts_global) and \
            num_experts_global != num_experts
        Eg = num_experts_global or num_experts
        if manual and num_experts * self.ep.size != Eg:
            raise ValueError(
                "num_experts_global != num_experts requires a manual ep axis "
                "(the PP engine's shard_map); under plain GSPMD pass the "
                "global count as num_experts")
        if top_k > Eg:
            raise ValueError(f"top_k={top_k} > num_experts={Eg}")
        if dispatch not in DISPATCHES:
            raise ValueError(
                f"unknown dispatch {dispatch!r} (einsum | scatter)")
        if router_type not in ROUTERS:
            raise ValueError(
                f"unknown router_type {router_type!r} "
                "(topk | expert_choice)")
        if Eg % self.ep.size:
            raise ValueError(
                f"num_experts ({Eg}) must divide by the expert-parallel "
                f"degree ({self.ep.size})")
        self.hidden_size = hidden_size
        self.num_experts_global = Eg
        self.num_local = Eg // self.ep.size
        self.e0 = self.ep.rank * self.num_local
        self.intermediate_size = intermediate_size
        self.top_k, self.capacity_factor = top_k, capacity_factor
        self.dispatch, self.router_type = dispatch, router_type
        self.dtype = dtype
        I = self.tp.shard(intermediate_size, "intermediate_size")
        E, H = self.num_local, hidden_size
        mk = lambda *shape: nn.Parameter(  # noqa: E731
            torch.empty(shape, dtype=param_dtype, device=device))
        self.router = mk(H, Eg)
        self.gate_up = set_tp_layout(mk(E, H, 2, I), self.tp, SHARDED)
        self.down = set_tp_layout(mk(E, I, H), self.tp, SHARDED)
        for p in (self.gate_up, self.down):
            p.expert_parallel = True
        # the last forward's routing statistics (detached): dropped share
        # of the (token, choice) pairs and the aux term
        self.stats = {}

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        """``N(0, 1/fan_in)`` from ``generator``: each whole tensor (every
        expert, the whole I) is drawn and this rank keeps its experts and
        I slice, so the values are the tp = ep = 1 model's."""
        H, I, Eg = self.hidden_size, self.intermediate_size, \
            self.num_experts_global
        dev, dt = self.router.device, self.router.dtype
        self.router.normal_(0.0, H ** -0.5, generator=generator)
        n_i = self.gate_up.shape[-1]
        i0 = self.tp.rank * n_i
        for p, shape, std, i_dim in ((self.gate_up, (Eg, H, 2, I),
                                      H ** -0.5, 3),
                                     (self.down, (Eg, I, H), I ** -0.5, 1)):
            full = torch.empty(shape, dtype=dt, device=dev)
            full.normal_(0.0, std, generator=generator)
            p.copy_(full.narrow(0, self.e0, self.num_local)
                    .narrow(i_dim, i0, n_i))
            del full

    def _ffn(self, xe: torch.Tensor) -> torch.Tensor:
        """``[E, C, H] -> [E, C, H]``: every local expert's gated FFN on
        its buffer (this rank's I slice: a partial sum at tp > 1)."""
        E, C, H = xe.shape
        wi = self.gate_up.to(self.dtype).reshape(E, H, -1)
        gu = torch.bmm(xe, wi).reshape(E, C, 2, -1)
        h = F.silu(gu[:, :, 0]) * gu[:, :, 1]
        return torch.bmm(h, self.down.to(self.dtype))

    def forward(self, x: torch.Tensor, sp: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        B = x.shape[0]
        H = self.hidden_size
        tp = self.tp.size > 1
        sp = sp and tp
        if sp:
            # the plain split backward: the expert path's partial input
            # gradient is summed over tp below, the router's is whole
            x = gather_from_sequence_parallel_region(x, 1, False,
                                                     self.tp.group)
        S = x.shape[1]
        n = B * S
        xt = x.reshape(n, H)
        if self.ep.route_size > 1:
            xt = gather_tokens(xt, self.ep.route_group)
        N = xt.shape[0]
        cap = capacity(self.capacity_factor, self.top_k, N,
                       self.num_experts_global)
        start = self.ep.line_start(n)
        rows = slice(start, start + n * self.ep.size)

        # routing (fp32) over the global expert space, the same on every
        # rank
        logits = xt.float() @ self.router.float()
        probs = torch.softmax(logits, dim=-1)                      # [N, Eg]
        x_in = xt.to(self.dtype)
        if tp:
            x_in = copy_to_tensor_parallel_region(x_in, self.tp.group)
        if self.router_type == "expert_choice":
            y, aux = self._expert_choice(x_in, probs, cap, rows)
        else:
            y, aux = self._top_k(x_in, probs, cap, rows)
        if self.ep.size > 1:
            y = reduce_scatter_tokens(y, self.ep.group)
        y = y.reshape(B, S, H)
        if sp:
            y = reduce_scatter_to_sequence_parallel_region(y, 1,
                                                           self.tp.group)
        elif tp:
            y = reduce_from_tensor_parallel_region(y, self.tp.group)
        return y.to(self.dtype), aux

    def _tp_sum_grad(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` whose gradient is summed over tp (each rank's comes from
        its I slice)."""
        if self.tp.size == 1:
            return t
        return copy_to_tensor_parallel_region(t, self.tp.group)

    def _expert_choice(self, x_in, probs, cap: int, rows: slice):
        """Each local expert takes its top-``cap`` tokens; their outputs,
        weighted by the expert's probability, are summed per token."""
        E, H = self.num_local, self.hidden_size
        N = x_in.shape[0]
        w_loc = probs.t()[self.e0:self.e0 + E]                     # [E, N]
        g_ec, tok_idx = torch.topk(w_loc, cap, dim=-1)             # [E, C]
        g_ec = self._tp_sum_grad(g_ec)
        xe = x_in[tok_idx.reshape(-1)].reshape(E, cap, H)
        ye = self._ffn(xe)
        contrib = (g_ec.to(ye.dtype)[..., None] * ye).reshape(E * cap, H)
        y = torch.zeros((N, H), dtype=ye.dtype, device=ye.device)
        y = y.index_add(0, tok_idx.reshape(-1), contrib)
        self.stats = {"dropped": torch.zeros(()), "aux": torch.zeros(()),
                      "capacity": cap}
        return y[rows], torch.zeros((), dtype=torch.float32,
                                    device=probs.device)

    def _top_k(self, x_in, probs, cap: int, rows: slice):
        N, Eg = probs.shape
        K, E, H = self.top_k, self.num_local, self.hidden_size
        gate_vals, expert_idx = torch.topk(probs, K, dim=-1)      # [N, K]
        onehot = F.one_hot(expert_idx, Eg)                         # [N, K, Eg]
        aux = load_balancing_loss(probs, onehot.amax(dim=1))
        # position of each (token, choice) in its expert's buffer: a
        # count over tokens, k-th choices after every (k-1)-th
        flat = onehot.transpose(0, 1).reshape(K * N, Eg)
        pos = (flat.cumsum(0) - flat).reshape(K, N, Eg).transpose(0, 1)
        pos_in_expert = (pos * onehot).sum(-1)                     # [N, K]
        keep = pos_in_expert < cap
        gate_vals = gate_vals * keep
        # kept gates renormalised per token, fp32
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(
            min=1e-9)
        # detached, read on demand: no host sync in the step
        self.stats = {"dropped": 1.0 - keep.float().mean().detach(),
                      "aux": aux.detach(), "capacity": cap}
        gates = self._tp_sum_grad(gate_vals).to(self.dtype)[rows].float()
        local = expert_idx - self.e0
        if self.dispatch == "scatter":
            # a flat slot per (token, choice) among this rank's experts;
            # dropped and remote pairs take the sentinel row E * cap
            mine = keep & (local >= 0) & (local < E)
            slot = torch.where(mine, local * cap + pos_in_expert,
                               torch.full_like(local, E * cap))   # [N, K]
            src = x_in[:, None, :].expand(N, K, H).reshape(N * K, H)
            xe = torch.zeros((E * cap + 1, H), dtype=x_in.dtype,
                             device=x_in.device)
            xe = xe.index_add(0, slot.reshape(-1), src)[:E * cap]
            ye = self._ffn(xe.reshape(E, cap, H)).reshape(E * cap, H)
            ye = torch.cat([ye, ye.new_zeros((1, H))])
            y_nk = ye[slot[rows]]                                  # [n, K, H]
            terms = [y_nk[:, k].float() * gates[:, k, None] for k in range(K)]
        else:
            # dispatch / combine one-hots [N, E, C] over this rank's
            # experts (a dropped choice's position row is all zero)
            oh = onehot[..., self.e0:self.e0 + E].float()         # [N, K, E]
            pos_oh = F.one_hot(torch.where(keep, pos_in_expert,
                                           torch.full_like(pos_in_expert,
                                                           cap)),
                               cap + 1)[..., :cap].float()         # [N, K, C]
            dispatch = torch.einsum("nke,nkc->nec", oh, pos_oh)
            xe = torch.einsum("nh,nec->ech", x_in, dispatch.to(x_in.dtype))
            ye = self._ffn(xe).float()
            oh, pos_oh = oh[rows], pos_oh[rows]
            terms = [torch.einsum("ech,nec->nh", ye,
                                  oh[:, k, :, None] * pos_oh[:, k, None, :]
                                  * gates[:, k, None, None])
                     for k in range(K)]
        y = terms[0]
        for t in terms[1:]:
            y = y + t
        return y, aux.float()
