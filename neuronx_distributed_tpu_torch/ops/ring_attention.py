"""Context-parallel attention over the ``cp`` ranks: the ring (contiguous
or zigzag layout, and the one-neighbour sliding-window schedule) and
ulysses (counterpart of ``neuronx_distributed_tpu/ops/ring_attention.py``).

Each rank holds its own ``S / cp`` chunk of the sequence in model layout
``[B, S / cp, N, D]`` (the JAX ``shard_map`` body's view of a global array
whose sequence is cut over ``cp``).  The chunk calls are the flash kernels
B1--B3 (:mod:`.flash_attention`'s wrappers: the kernels on CUDA, their plain
versions on the CPU), each returning or taking the chunk's logsumexp.

- **Ring** (:func:`ring_attention`, ``cp_impl="ring"``): KV blocks (with
  their segment ids) travel to the next rank while each rank keeps its
  queries, and the partial outputs merge by their logsumexps
  (:func:`_combine`).  A rank knows where each block came from, so it
  calls only the chunks its causal mask leaves visible: step 0 its own
  chunk causally, a block from an earlier chunk in full, a later one not
  at all.  The JAX body computes every chunk and drops masked ones with
  ``where`` to stay SPMD-uniform; here the ranks may differ in work.
- **Zigzag** (``layout="zigzag"``, causal only): a rank holds the chunk
  pair ``(i, 2cp - 1 - i)`` of ``2 cp`` half chunks (inputs already in
  :func:`zigzag_permute` order) and calls two full half chunks a step
  after the three of step 0, the pair chosen in Python from the block's
  origin (no second pair computed and dropped).
- **Window** (``window <= S / cp`` on the contiguous ring): only the left
  neighbour's block intersects a query's band, so one exchange replaces
  the rotation and one call of the ``[C]`` queries against the ``[left |
  own]`` ``2C`` keys applies the global causal band (queries at kv offset
  ``C``, the kernels' ``T - S`` convention).  Rank 0 has no left
  neighbour and calls its own chunk alone (JAX blocks the wrapped block
  by segment id 0: the same visible pairs).
- **Ulysses** (``cp_impl="ulysses"``): one all-to-all turns sequence
  shards into head shards over the whole sequence, plain flash attention
  runs (banded, segmented, capped as asked), and a second all-to-all
  turns it back.

The ring's backward is its own ``torch.autograd.Function`` (point-to-point
sends have no derivative): dq from B2 and dk/dv from B3 against the final
logsumexp and ``delta = rowsum(dO * O)``, which is each chunk's probability
and lse cotangent at once; the dk/dv sums travel with the KV block and
reach its owner after ``cp`` hops.  Sends and receives go through
:func:`..parallel.mappings.exchange` (counted as ``cp_send``), staged
through host memory under gloo.

The Pallas kernels' tiling knobs (``use_flash``, ``block_q``, ``block_k``,
``interpret``) have no counterpart: the chunk calls are always the
kernels' wrappers.  The sequence split itself (JAX's ``S % cp`` check) is
the trainer's (:func:`..trainer.trainer.context_parallel_slice`).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from neuronx_distributed_tpu_torch.ops.flash_attention import (
    NEG_INF,
    _kernel_readable,
    band_mask,
    flash_attention,
    flash_attention_dkv,
    flash_attention_dq,
    flash_attention_fwd,
    flash_attention_segmented,
)
from neuronx_distributed_tpu_torch.parallel import mappings
from neuronx_distributed_tpu_torch.parallel.mesh import ContextParallel


def _dense_chunk_attn(q, k, v, causal: bool, sm_scale: float,
                      window: Optional[int] = None,
                      softcap: Optional[float] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense per-chunk attention returning ``(o, lse)``; q ``[B, HQ, S,
    D]``, k/v ``[B, HKV, T, D]``, fp32 softmax: the test oracle."""
    G = q.shape[1] // k.shape[1]
    kk, vv = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), kk.float()) * sm_scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    if causal:
        S, T = q.shape[2], k.shape[2]
        s = torch.where(band_mask(S, T, T - S, window, device=q.device), s,
                        torch.full_like(s, NEG_INF))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhst,bhtd->bhsd", p.to(v.dtype).float(), vv.float())
    return o.to(q.dtype), lse


def _combine(o1, lse1, o2, lse2):
    """Merge two normalized partial attention outputs by their
    logsumexps; ``o1`` is the fp32 running accumulator, ``o2`` a fresh
    partial."""
    lse = torch.logaddexp(lse1, lse2)
    w1 = torch.exp(lse1 - lse)[..., None]
    w2 = torch.exp(lse2 - lse)[..., None]
    return o1 * w1 + o2.float() * w2, lse


# ---------------------------------------------------------------------------
# zigzag layout
# ---------------------------------------------------------------------------


def zigzag_indices(seq_len: int, cp: int) -> torch.Tensor:
    """Global permutation placing half-chunk pair ``(i, 2cp - 1 - i)`` on
    rank ``i``."""
    if seq_len % (2 * cp) != 0:
        raise ValueError(f"seq_len {seq_len} not divisible by 2*cp={2 * cp}")
    c = seq_len // (2 * cp)
    chunks = torch.arange(seq_len).reshape(2 * cp, c)
    order = []
    for i in range(cp):
        order += [i, 2 * cp - 1 - i]
    return chunks[torch.tensor(order)].reshape(-1)


def _take(x, idx: torch.Tensor, axis: int):
    if isinstance(x, torch.Tensor):
        return x.index_select(axis, idx.to(x.device))
    return np.take(np.asarray(x), idx.numpy(), axis=axis)


def zigzag_permute(x, cp: int, axis: int = 1):
    """Reorder a sequence-major tensor (or numpy array) into zigzag
    layout."""
    return _take(x, zigzag_indices(x.shape[axis], cp), axis)


def zigzag_unpermute(x, cp: int, axis: int = 1):
    """Inverse of :func:`zigzag_permute`."""
    idx = zigzag_indices(x.shape[axis], cp)
    return _take(x, torch.argsort(idx), axis)


# ---------------------------------------------------------------------------
# the ring schedule
# ---------------------------------------------------------------------------


class _Call(NamedTuple):
    """One chunk call: the local query rows, the rows of the KV block held
    this step, and whether the causal (diagonal) mask applies."""

    q: slice
    k: slice
    causal: bool


def ring_calls(rank: int, cp: int, step: int, rows: int, causal: bool,
               zigzag: bool) -> List[_Call]:
    """The chunk calls rank ``rank`` makes at ring step ``step`` (its KV
    block then came from rank ``(rank - step) % cp``) over ``rows`` local
    rows: the schedule that fixes the kernels' launches."""
    src = (rank - step) % cp
    whole = slice(0, rows)
    if not zigzag:
        if step == 0:
            return [_Call(whole, whole, causal)]
        return [_Call(whole, whole, False)] if (not causal or src < rank) \
            else []
    c = rows // 2
    a, b = slice(0, c), slice(c, rows)
    if step == 0:
        return [_Call(a, a, True), _Call(b, b, True), _Call(b, a, False)]
    # an early block is before late chunk b; of the other pair, the
    # earlier rank's early chunk (src < rank) is before a, a later rank's
    # late chunk (2cp - 1 - src < b) before b
    return [_Call(b, a, False),
            _Call(a, a, False) if src < rank else _Call(b, b, False)]


def _readable(t: torch.Tensor) -> torch.Tensor:
    return t if _kernel_readable(t) else t.contiguous()


def _segs(block, segs, call: _Call):
    if segs is None:
        return None, None
    return segs[:, call.q].contiguous(), block[2][:, call.k].contiguous()


class _Ring(torch.autograd.Function):
    """The contiguous or zigzag ring over kernel-layout chunks ``q [B, HQ,
    C, D]``, ``k/v [B, HKV, C, D]``; see the module docstring."""

    @staticmethod
    def forward(ctx, q, k, v, segs, cp, zigzag, causal, scale, softcap):
        opts = dict(sm_scale=scale, softcap=softcap)
        rows = q.shape[2]
        o_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        lse = torch.full(q.shape[:3], NEG_INF, dtype=torch.float32,
                         device=q.device)
        block = [k.contiguous(), v.contiguous()] + (
            [segs] if segs is not None else [])
        for t in range(cp.size):
            pending = (mappings.exchange(block, cp.next, cp.prev, cp.group,
                                         cp.cpu_group)
                       if t < cp.size - 1 else None)
            for c in ring_calls(cp.rank, cp.size, t, rows, causal, zigzag):
                qs, ks = _segs(block, segs, c)
                o_c, lse_c = flash_attention_fwd(
                    q[:, :, c.q], block[0][:, :, c.k], block[1][:, :, c.k],
                    qs, ks, causal=c.causal, **opts)
                o_acc[:, :, c.q], lse[:, :, c.q] = _combine(
                    o_acc[:, :, c.q], lse[:, :, c.q], o_c, lse_c)
            if pending is not None:
                block = pending.wait()
        o = o_acc.to(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse, segs)
        ctx.cp, ctx.zigzag, ctx.causal, ctx.opts = cp, zigzag, causal, opts
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, segs = ctx.saved_tensors
        cp, rows = ctx.cp, q.shape[2]
        do = _readable(do.to(q.dtype))
        # each chunk's P against the final lse, delta from the final O:
        # the combine's lse cotangents are inside
        delta = (do.float() * o.float()).sum(dim=-1)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        block = [k.contiguous(), v.contiguous()] + (
            [segs] if segs is not None else [])
        acc = [torch.zeros(k.shape, dtype=torch.float32, device=k.device),
               torch.zeros(v.shape, dtype=torch.float32, device=v.device)]
        for t in range(cp.size):
            pending = (mappings.exchange(block, cp.next, cp.prev, cp.group,
                                         cp.cpu_group)
                       if t < cp.size - 1 else None)
            for c in ring_calls(cp.rank, cp.size, t, rows, ctx.causal,
                                ctx.zigzag):
                qs, ks = _segs(block, segs, c)
                args = (q[:, :, c.q], block[0][:, :, c.k],
                        block[1][:, :, c.k], do[:, :, c.q],
                        lse[:, :, c.q].contiguous(),
                        delta[:, :, c.q].contiguous(), qs, ks)
                dq[:, :, c.q] += flash_attention_dq(
                    *args, causal=c.causal, **ctx.opts).float()
                dk, dv = flash_attention_dkv(*args, causal=c.causal,
                                             **ctx.opts)
                acc[0][:, :, c.k] += dk.float()
                acc[1][:, :, c.k] += dv.float()
            if pending is not None:
                block = pending.wait()
            if cp.size > 1:
                # the sums for this block go on with it: after cp hops
                # each rank holds its own block's
                acc = mappings.exchange(acc, cp.next, cp.prev, cp.group,
                                        cp.cpu_group).wait()
        return (dq.to(q.dtype), acc[0].to(k.dtype), acc[1].to(v.dtype),
                None, None, None, None, None, None)


class _RingWindow(torch.autograd.Function):
    """The sliding-window schedule: one exchange with the left neighbour,
    one call of the chunk's queries on ``[left | own]`` keys."""

    @staticmethod
    def forward(ctx, q, k, v, segs, cp, scale, window, softcap):
        first, last = cp.rank == 0, cp.rank == cp.size - 1
        own = [k.contiguous(), v.contiguous()] + (
            [segs] if segs is not None else [])
        left = mappings.exchange(own, None if last else cp.next,
                                 None if first else cp.prev, cp.group,
                                 cp.cpu_group).wait()
        if first:
            kk, vv, kseg = own[0], own[1], segs
        else:
            kk = torch.cat([left[0], own[0]], dim=2)
            vv = torch.cat([left[1], own[1]], dim=2)
            kseg = (torch.cat([left[2], segs], dim=1).contiguous()
                    if segs is not None else None)
        opts = dict(causal=True, sm_scale=scale, window=window,
                    softcap=softcap)
        o, lse = flash_attention_fwd(q, kk, vv, segs, kseg, **opts)
        ctx.save_for_backward(q, kk, vv, o, lse, segs, kseg)
        ctx.cp, ctx.opts = cp, opts
        return o

    @staticmethod
    def backward(ctx, do):
        q, kk, vv, o, lse, qseg, kseg = ctx.saved_tensors
        cp = ctx.cp
        first, last = cp.rank == 0, cp.rank == cp.size - 1
        do = _readable(do.to(q.dtype))
        delta = (do.float() * o.float()).sum(dim=-1).contiguous()
        args = (q, kk, vv, do, lse, delta, qseg, kseg)
        dq = flash_attention_dq(*args, **ctx.opts)
        dkk, dvv = flash_attention_dkv(*args, **ctx.opts)
        C = q.shape[2]
        dk, dv = dkk[:, :, -C:].float(), dvv[:, :, -C:].float()
        # the left block's gradient goes back to its owner
        back = mappings.exchange([dkk[:, :, :C], dvv[:, :, :C]],
                                 None if first else cp.prev,
                                 None if last else cp.next, cp.group,
                                 cp.cpu_group).wait()
        if back:
            dk, dv = dk + back[0].float(), dv + back[1].float()
        return (dq, dk.to(kk.dtype), dv.to(vv.dtype), None, None, None, None,
                None)


# ---------------------------------------------------------------------------
# ulysses
# ---------------------------------------------------------------------------


def _seq_to_heads(x: torch.Tensor, cp: ContextParallel) -> torch.Tensor:
    """``[B, H, S/cp, D]`` sequence shards -> ``[B, H/cp, S, D]`` head
    shards over the whole sequence (one all-to-all)."""
    B, H, C, D = x.shape
    n = cp.size
    blocks = x.reshape(B, n, H // n, C, D).permute(1, 0, 2, 3, 4)
    y = mappings.all_to_all(blocks.contiguous(), cp.group, cp.cpu_group)
    return y.permute(1, 2, 0, 3, 4).reshape(B, H // n, n * C, D)


def _heads_to_seq(x: torch.Tensor, cp: ContextParallel) -> torch.Tensor:
    """The inverse of :func:`_seq_to_heads`."""
    B, Hl, S, D = x.shape
    n = cp.size
    blocks = x.reshape(B, Hl, n, S // n, D).permute(2, 0, 1, 3, 4)
    y = mappings.all_to_all(blocks.contiguous(), cp.group, cp.cpu_group)
    return y.permute(1, 0, 2, 3, 4).reshape(B, n * Hl, S // n, D)


def _ulysses(qt, kt, vt, segs, cp, causal, scale, window, softcap):
    HQ, HKV = qt.shape[1], kt.shape[1]
    if HKV % cp.size:
        # too few kv heads to split: expand to the q-head count first (the
        # kernel's h // G pairing stays aligned with the q-head chunks)
        G = HQ // HKV
        kt, vt = kt.repeat_interleave(G, 1), vt.repeat_interleave(G, 1)
    q, k, v = (_seq_to_heads(x, cp) for x in (qt, kt, vt))
    if segs is not None:
        full = mappings.all_gather(segs, 1, cp.group)
        o = flash_attention_segmented(q, k, v, full, full, causal, scale,
                                      window, softcap)
    else:
        o = flash_attention(q, k, v, causal, scale, window, softcap)
    return _heads_to_seq(o, cp)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True, sm_scale: Optional[float] = None,
                   layout: str = "contiguous", cp_impl: str = "ring",
                   segment_ids: Optional[torch.Tensor] = None,
                   window: Optional[int] = None,
                   softcap: Optional[float] = None,
                   cp: Optional[ContextParallel] = None) -> torch.Tensor:
    """Context-parallel attention in model layout: this rank's chunk ``q
    [B, S/cp, NQ, D]``, ``k/v [B, S/cp, NKV, D]`` (``NQ`` a multiple of
    ``NKV``: a rank's local heads at any tensor-parallel degree) ->
    ``[B, S/cp, NQ, D]``, over ``cp`` (default: the live
    :class:`..parallel.mesh.ContextParallel`).  At cp = 1 it is plain flash
    attention.  ``layout``: ``"contiguous"`` (rank i holds chunk i) or
    ``"zigzag"`` (inputs in :func:`zigzag_permute` order, causal only; the
    output stays in the input's layout).  ``cp_impl``: ``"ring"`` or
    ``"ulysses"`` (contiguous only; the local q heads must split over cp).
    ``segment_ids [B, S/cp]`` mask across packed documents (causal only);
    ``window`` is a causal sliding window (on the ring ``window <= S/cp``
    and contiguous); ``softcap`` rides every chunk call."""
    cp = ContextParallel.current() if cp is None else cp
    n = cp.size
    B, C, NQ, D = q.shape
    S = C * n
    scale = (D ** -0.5) if sm_scale is None else float(sm_scale)
    if layout not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown layout {layout!r}")
    if segment_ids is not None and not causal:
        raise ValueError("segment_ids requires causal=True")
    if cp_impl not in ("ring", "ulysses"):
        raise ValueError(f"unknown cp_impl {cp_impl!r}")
    if window is not None:
        if not causal or window < 1:
            raise ValueError(
                "window (sliding-window attention) requires causal=True and "
                f"window >= 1, got causal={causal}, window={window}")
        if n > 1 and cp_impl == "ring":
            if layout == "zigzag":
                raise ValueError(
                    "zigzag is a FULL-causal load-balancing layout; with a "
                    "sliding window the contiguous ring is already balanced "
                    "(every device does O(C*W) work) -- use "
                    "layout='contiguous'")
            if window > C:
                raise ValueError(
                    f"sliding window {window} exceeds the per-device chunk "
                    f"{C} (= S/cp): the one-neighbor ring schedule cannot "
                    "see far enough back; lower cp, or use "
                    "cp_impl='ulysses' (full sequence per device)")
    if cp_impl == "ulysses":
        if layout == "zigzag" and n > 1:
            raise ValueError(
                "zigzag layout is a ring-schedule optimization; ulysses "
                "sees the full sequence per device and needs no load "
                "balancing")
        if n > 1 and NQ % n != 0:
            raise ValueError(
                f"ulysses cp={n} needs the per-shard q-head count ({NQ}) "
                f"divisible by cp; use cp_impl='ring' for head-starved "
                f"configs")
    if layout == "zigzag":
        if not causal:
            raise ValueError("zigzag layout is a causal-only optimization")
        if n == 1:
            layout = "contiguous"  # degenerate: the same thing
        elif S % (2 * n) != 0:
            raise ValueError(f"zigzag needs seq_len divisible by "
                             f"2*cp={2 * n}")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    segs = (segment_ids.to(device=q.device, dtype=torch.int32).contiguous()
            if segment_ids is not None else None)
    if n == 1:
        if segs is not None:
            o = flash_attention_segmented(qt, kt, vt, segs, segs, causal,
                                          scale, window, softcap)
        else:
            o = flash_attention(qt, kt, vt, causal, scale, window, softcap)
    elif cp_impl == "ulysses":
        o = _ulysses(qt, kt, vt, segs, cp, causal, scale, window, softcap)
    elif window is not None:
        o = _RingWindow.apply(qt, kt, vt, segs, cp, scale, window, softcap)
    else:
        o = _Ring.apply(qt, kt, vt, segs, cp, layout == "zigzag", causal,
                        scale, softcap)
    return o.transpose(1, 2)


def ulysses_attention(q, k, v, causal: bool = True, **kwargs) -> torch.Tensor:
    """:func:`ring_attention` with ``cp_impl="ulysses"``; same layout."""
    return ring_attention(q, k, v, causal=causal, cp_impl="ulysses",
                          **kwargs)

