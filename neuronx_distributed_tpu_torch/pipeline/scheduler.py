"""Pipeline-parallel task schedules (a copy of
``neuronx_distributed_tpu/pipeline/scheduler.py``, pure logic).

The reference's declarative schedules (task taxonomy, ``PipeSchedule``,
the forward-only ``InferenceSchedule``, 1F1B ``TrainSchedule``), the
bubble and head-imbalance analytics, and the slot tables of the JAX
single-jit engine.  The port's engine (:mod:`.engine`) is the host-driven
executor these schedules were kept for: each pp rank walks its own task
list eagerly (``TrainSchedule.tasks()`` for 1F1B, all forwards then all
backwards for GPipe, ``InferenceSchedule`` for the forward-only path),
and the interleaved schedule's per-rank order comes from
:func:`build_interleaved_sync_tables` (a rank's non-empty ticks in
order).  The function docstrings below describe the JAX engine's use of
the tables; the arithmetic is the same for both.

The 1F1B shape: stage ``s`` of ``P`` runs ``min(M, P-1-s)`` warmup forwards,
then alternates one-forward-one-backward in the steady state, then drains the
remaining backwards.  Every stage executes exactly ``M`` forwards and ``M``
backwards; earlier stages hold at most ``P-s`` in-flight microbatches.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Task:
    """One schedulable unit; ``microbatch`` indexes the microbatch it acts on."""

    microbatch: int


class ForwardStep(Task):
    pass


class BackwardStep(Task):
    pass


class RecvForward(Task):
    """Receive the previous stage's activation for ``microbatch``."""


class SendForward(Task):
    """Send this stage's activation for ``microbatch`` to the next stage."""


class RecvBackward(Task):
    """Receive the next stage's activation-gradient for ``microbatch``."""


class SendBackward(Task):
    """Send the activation-gradient for ``microbatch`` to the previous stage."""


@dataclasses.dataclass(frozen=True)
class ReduceGrads:
    """End-of-batch gradient reduction (reference ``ReduceGradsTask``)."""


class PipeSchedule:
    """Base schedule: yields the ordered task list for one stage
    (reference ``PipeSchedule``, ``pipeline/scheduler.py:52-125``)."""

    def __init__(self, num_microbatches: int, num_stages: int, stage_id: int):
        if not 0 <= stage_id < num_stages:
            raise ValueError(f"stage_id {stage_id} out of range for {num_stages} stages")
        if num_microbatches < 1:
            raise ValueError("num_microbatches must be >= 1")
        self.num_microbatches = num_microbatches
        self.num_stages = num_stages
        self.stage_id = stage_id

    @property
    def is_first_stage(self) -> bool:
        return self.stage_id == 0

    @property
    def is_last_stage(self) -> bool:
        return self.stage_id == self.num_stages - 1

    def steps(self) -> Iterator[List[object]]:
        """Yield groups of tasks; tasks within a group may run concurrently."""
        raise NotImplementedError

    def tasks(self) -> List[object]:
        """Flat ordered task list."""
        return [t for group in self.steps() for t in group]

    def num_in_flight(self) -> int:
        """Peak number of microbatches whose activations this stage holds."""
        raise NotImplementedError


class InferenceSchedule(PipeSchedule):
    """Forward-only fill-drain (reference ``InferenceSchedule``,
    ``pipeline/scheduler.py:128-138``)."""

    def steps(self) -> Iterator[List[object]]:
        for mb in range(self.num_microbatches):
            group: List[object] = []
            if not self.is_first_stage:
                group.append(RecvForward(mb))
            group.append(ForwardStep(mb))
            if not self.is_last_stage:
                group.append(SendForward(mb))
            yield group

    def num_in_flight(self) -> int:
        return 1


class TrainSchedule(PipeSchedule):
    """1F1B (reference ``TrainSchedule``, ``pipeline/scheduler.py:141-273``).

    Warmup forwards fill the pipeline, the steady state interleaves one
    forward with one backward (receiving before sending so neighbor pairs
    never deadlock — the reference's recv-before-send rule,
    ``scheduler.py:174-180``), and the cooldown drains the backwards."""

    @property
    def num_warmup(self) -> int:
        return min(self.num_microbatches, self.num_stages - 1 - self.stage_id)

    def steps(self) -> Iterator[List[object]]:
        M, warmup = self.num_microbatches, self.num_warmup
        steady = M - warmup

        for mb in range(warmup):
            group: List[object] = []
            if not self.is_first_stage:
                group.append(RecvForward(mb))
            group.append(ForwardStep(mb))
            if not self.is_last_stage:
                group.append(SendForward(mb))
            yield group

        for i in range(steady):
            f_mb, b_mb = warmup + i, i
            group = []
            if not self.is_first_stage:
                group.append(RecvForward(f_mb))
            group.append(ForwardStep(f_mb))
            # recv the backward before sending the forward: the conjugate
            # neighbor (later stage) is sending this grad before it posts its
            # own forward recv, so the pair always matches up.
            if not self.is_last_stage:
                group.append(RecvBackward(b_mb))
                group.append(SendForward(f_mb))
            group.append(BackwardStep(b_mb))
            if not self.is_first_stage:
                group.append(SendBackward(b_mb))
            yield group

        for mb in range(steady, M):
            group = []
            if not self.is_last_stage:
                group.append(RecvBackward(mb))
            group.append(BackwardStep(mb))
            if not self.is_first_stage:
                group.append(SendBackward(mb))
            yield group

        yield [ReduceGrads()]

    def num_in_flight(self) -> int:
        return min(self.num_microbatches, self.num_stages - self.stage_id)


def bubble_fraction(
    num_microbatches: int, num_stages: int, schedule: str = "eager",
    num_chunks: int = 1,
) -> float:
    """Fraction of pipeline compute capacity wasted on bubbles.

    ``schedule="eager"`` — the classic fill-drain / 1F1B figure
    ``(P-1)/(M+P-1)``: what a per-task executor (the reference's
    ``NxDPPModel``) achieves; identical for GPipe and 1F1B, which differ
    only in peak activation memory.

    ``schedule="sync_1f1b"`` — the production single-jit engine's timetable
    (:func:`build_sync_slot_tables`): ``T = M + 2(P-1)`` ticks, each costing
    one full fwd+bwd on every rank, of which ``M`` carry useful pairs —
    overhead ``2(P-1)/(M+2(P-1))``, roughly TWICE the eager bubble at equal
    ``M`` (43% vs 27% at P=4/M=8; 4.3% vs 2.2% at P=4/M=128).  This is the
    price of SPMD uniformity (no rank-divergent control flow around
    collective-bearing compute), and it amortizes with large ``M`` exactly
    like the eager bubble.  Note the asymmetric timetable
    (:func:`build_slot_tables`) is NOT an improvement under the uniformity
    constraint: realized as masked uniform ticks its ``~2M + 2(P-1)`` slots
    would each still pay a full fwd+bwd, costing strictly more than the
    sync form — a true eager 1F1B needs per-rank divergent dispatch, which
    this engine rules out by design (see ``engine.py``).  On top of the
    bubble, the sync engine pays the embedding+head on every tick
    (:func:`sync_1f1b_head_overhead`).
    """
    M, P = num_microbatches, num_stages
    if schedule == "eager":
        return (P - 1) / (M + P - 1)
    if schedule == "sync_1f1b":
        return 2 * (P - 1) / (M + 2 * (P - 1))
    if schedule == "sync_interleaved":
        # ``sync_interleaved``: V chunks per rank, chunk-granular ticks, and
        # the engine's PHASE-SPLIT scans (fwd-only warmup / mixed middle /
        # bwd-only drain — tick-dependent but rank-uniform control flow is
        # SPMD-legal, so warm/drain ticks stop paying the garbage half).
        # Cost model: fwd-only tick = 1 unit, bwd-only = 2 (bwd ≈ 2x fwd
        # FLOPs), mixed = 3; useful work = 3 units per microbatch-chunk.
        # The fill/drain now costs chunk-ticks, which is how interleaving
        # divides the bubble (Megatron interleaved 1F1B; the reference has
        # no interleaving at all, SURVEY §2.10).
        tables = build_interleaved_sync_tables(M, P, num_chunks)
        T = tables.num_slots
        any_b = [any(tables.bwd_mb[r][t] >= 0 for r in range(P)) for t in range(T)]
        any_f = [any(tables.fwd_mb[r][t] >= 0 for r in range(P)) for t in range(T)]
        warm = any_b.index(True) if any(any_b) else T
        drain_start = T - list(reversed(any_f)).index(True) if any(any_f) else 0
        total = warm * 1 + (drain_start - warm) * 3 + (T - drain_start) * 2
        useful = 3 * M * num_chunks
        return (total - useful) / total
    raise ValueError(
        f"unknown schedule {schedule!r} (eager | sync_1f1b | sync_interleaved)"
    )


def export_schedule_metrics(
    registry,
    num_microbatches: int,
    num_stages: int,
    schedule: str = "sync_1f1b",
    num_chunks: int = 1,
    prefix: str = "pipeline",
) -> dict:
    """Publish the schedule analytics this module computes as observability
    gauges (``obs.MetricRegistry``), so a run's pipeline efficiency is part
    of its persisted telemetry instead of a hand-run calculation.

    Sets ``{prefix}/bubble_fraction``, the shape parameters, and — for the
    engine timetables — tick count and stash sizes (the peak-activation
    memory knob).  Returns the values set, keyed by gauge name."""
    vals = {
        f"{prefix}/num_microbatches": float(num_microbatches),
        f"{prefix}/num_stages": float(num_stages),
        f"{prefix}/num_chunks": float(num_chunks),
        f"{prefix}/bubble_fraction": bubble_fraction(
            num_microbatches, num_stages, schedule, num_chunks),
    }
    if schedule == "sync_1f1b":
        tables = build_sync_slot_tables(num_microbatches, num_stages)
        vals[f"{prefix}/num_slots"] = float(tables.num_slots)
        vals[f"{prefix}/fwd_stash_size"] = float(tables.fwd_stash_size)
        vals[f"{prefix}/bwd_stash_size"] = float(tables.bwd_stash_size)
    elif schedule == "sync_interleaved":
        tables = build_interleaved_sync_tables(
            num_microbatches, num_stages, num_chunks)
        vals[f"{prefix}/num_slots"] = float(tables.num_slots)
        vals[f"{prefix}/fwd_stash_size"] = float(tables.stash_size)
        vals[f"{prefix}/bwd_stash_size"] = float(tables.gstash_size)
    for name, v in vals.items():
        registry.gauge(name).set(v)
    return vals


def sync_1f1b_head_overhead(
    num_layers: int,
    num_stages: int,
    hidden: int,
    vocab: int,
    intermediate: Optional[int] = None,
) -> float:
    """Per-tick compute imbalance from the LAST stage owning the LM-head.

    The engines run embed/head under ``lax.cond`` on the owning pp rank
    (pp-uniform predicate — every auto-axis collective channel inside takes
    one branch), so the head is no longer paid on every rank; what remains
    is that the last stage's tick costs ``layers_per_stage`` blocks + one
    ``hidden x vocab`` matmul while the others cost blocks alone, and the
    synchronous tick waits for the slowest rank.  This function returns that
    critical-path excess as a fraction of a balanced stage.  Per-token fwd
    matmul FLOPs (MHA): qkv ``6h²`` + o-proj ``2h²`` + mlp ``6hi`` → block =
    ``8h² + 6hi``; head = ``2hV`` (same ratio holds fwd+bwd; attention-core
    FLOPs excluded, so this slightly over-states).  ≈8% for 7B/PP4, ≈1% for
    70B/PP4 — and removable by giving the last stage fewer layers via
    ``pipeline_cuts`` (one layer ≈ head when ``2hV ≈ 8h²+6hi``)."""
    i = intermediate if intermediate is not None else 4 * hidden
    lps = num_layers / num_stages
    block = 8 * hidden * hidden + 6 * hidden * i
    head = 2 * hidden * vocab
    return head / (lps * block)


@dataclasses.dataclass(frozen=True)
class SlotTables:
    """Global-clock realization of a 1F1B schedule.  The single-jit engine
    (:func:`..engine.make_1f1b_loss_and_grad_fn`) consumes the synchronous
    variant (:func:`build_sync_slot_tables`); the asynchronous
    :func:`build_slot_tables` (one op per stage per slot, derived from
    :class:`TrainSchedule`) is the verification oracle the tests check both
    against, and the timetable a host-driven multi-dispatch executor would
    follow.

    Each stage performs at most one compute op per slot. ``fwd_mb[s][t]`` /
    ``bwd_mb[s][t]`` give the microbatch whose forward/backward stage ``s``
    runs at slot ``t`` (-1 = none).  ``fwd_stash_size`` / ``bwd_stash_size``
    bound the circular activation / incoming-grad stashes indexed by
    ``microbatch % size`` — the engine's peak-activation memory is
    ``fwd_stash_size`` microbatch activations per stage (≤ P, vs M for
    fill-drain autodiff; the reference's in-flight bound,
    ``pipeline/scheduler.py:141-273``)."""

    num_microbatches: int
    num_stages: int
    num_slots: int
    fwd_mb: Tuple[Tuple[int, ...], ...]  # [P][T]
    bwd_mb: Tuple[Tuple[int, ...], ...]  # [P][T]
    fwd_stash_size: int
    bwd_stash_size: int


def build_slot_tables(num_microbatches: int, num_stages: int) -> SlotTables:
    """Assign every stage's :class:`TrainSchedule` op sequence to global
    slots, greedily and dependency-honoring:

    - ``fwd(s, m)`` needs ``fwd(s-1, m)`` completed in an earlier slot (the
      activation arrives via the engine's end-of-slot ppermute);
    - ``bwd(s, m)`` needs ``fwd(s, m)`` done and, for ``s < P-1``,
      ``bwd(s+1, m)`` completed in an earlier slot.

    Every stage consumes its ops in TrainSchedule order (warmup forwards →
    1F1B steady state → backward drain), so the result *is* the 1F1B
    timetable with bubbles made explicit."""
    M, P = num_microbatches, num_stages
    seqs: List[List[Task]] = []
    for s in range(P):
        seqs.append([
            t for t in TrainSchedule(M, P, s).tasks()
            if isinstance(t, (ForwardStep, BackwardStep))
        ])

    fwd_done = [[-1] * M for _ in range(P)]
    bwd_done = [[-1] * M for _ in range(P)]
    idx = [0] * P
    fwd_rows: List[List[int]] = [[] for _ in range(P)]
    bwd_rows: List[List[int]] = [[] for _ in range(P)]

    t = 0
    while any(idx[s] < len(seqs[s]) for s in range(P)):
        for s in range(P):
            f_op, b_op = -1, -1
            if idx[s] < len(seqs[s]):
                op = seqs[s][idx[s]]
                m = op.microbatch
                if isinstance(op, ForwardStep):
                    if s == 0 or 0 <= fwd_done[s - 1][m] < t:
                        f_op = m
                        fwd_done[s][m] = t
                        idx[s] += 1
                else:
                    ready = 0 <= fwd_done[s][m] < t or (s == P - 1 and fwd_done[s][m] >= 0)
                    if s < P - 1:
                        ready = ready and 0 <= bwd_done[s + 1][m] < t
                    if ready:
                        b_op = m
                        bwd_done[s][m] = t
                        idx[s] += 1
            fwd_rows[s].append(f_op)
            bwd_rows[s].append(b_op)
        t += 1
        if t > 4 * (M + P) + 8:  # pragma: no cover - schedule bug guard
            raise RuntimeError(f"1F1B slot assignment did not converge (M={M}, P={P})")

    T = t

    def _min_stash(intervals_by_index) -> int:
        """Smallest K such that mb%K circular indexing never collides two
        live intervals."""
        for K in range(1, P + 2):
            ok = True
            for s_ints in intervals_by_index:
                by_slot: dict = {}
                for m, (lo, hi) in s_ints:
                    by_slot.setdefault(m % K, []).append((lo, hi))
                for spans in by_slot.values():
                    spans.sort()
                    for a, b in zip(spans, spans[1:]):
                        if b[0] <= a[1]:
                            ok = False
            if ok:
                return K
        raise RuntimeError("no valid stash size <= P+1")  # pragma: no cover

    # fwd stash entry for (s, m): written at end of the slot the activation
    # is produced upstream (or during the fwd slot itself at stage 0), read
    # at the bwd slot.
    fwd_ints = []
    for s in range(P):
        ints = []
        for m in range(M):
            lo = fwd_done[s][m] if s == 0 else fwd_done[s - 1][m] + 1
            ints.append((m, (lo, bwd_done[s][m])))
        fwd_ints.append(ints)
    # bwd (incoming-grad) stash entry for (s, m): written at end of the slot
    # bwd(s+1, m) ran, read at bwd(s, m).  Last stage seeds its own grads.
    bwd_ints = []
    for s in range(P - 1):
        ints = []
        for m in range(M):
            ints.append((m, (bwd_done[s + 1][m] + 1, bwd_done[s][m])))
        bwd_ints.append(ints)

    return SlotTables(
        num_microbatches=M,
        num_stages=P,
        num_slots=T,
        fwd_mb=tuple(tuple(r) for r in fwd_rows),
        bwd_mb=tuple(tuple(r) for r in bwd_rows),
        fwd_stash_size=_min_stash(fwd_ints),
        bwd_stash_size=_min_stash(bwd_ints) if bwd_ints else 1,
    )


@dataclasses.dataclass(frozen=True)
class InterleavedSlotTables:
    """Tick tables for the interleaved (virtual-stage) synchronous 1F1B.

    ``V`` model chunks per pp rank; virtual stage ``s = v * P + r`` lives on
    rank ``r`` as its chunk ``v`` — the Megatron interleaved assignment
    (absent from the reference, SURVEY §2.10 "interleaved: Absent"), chosen
    because consecutive virtual stages sit on consecutive ranks, so ONE ring
    ppermute per tick still moves every edge, including the rank ``P-1 →
    0`` chunk wrap.

    Every tick each rank runs at most one chunk-forward and one
    chunk-backward (1/V of a full stage each), so the fill/drain overhead
    costs chunk-ticks, not stage-ticks: measured ticks ``T ≈ MV + O(P·V
    drain)`` against ``MV`` useful — at P=4/M=8: 43% (V=1) → ~30% (V=2) →
    ~21% (V=4) bubble, approaching the eager engine's 27%@V=1 figure from
    a fully-SPMD program (see ``bubble_fraction(..., "sync_interleaved")``).

    All index tables are ``[P][T]`` (-1 = none).  Stash slots are allocated
    offline by live-interval graph coloring (`slots` = per-rank maximum),
    so the engine does no modular-index arithmetic: it reads the slot
    number for the tick from the table."""

    num_microbatches: int
    num_stages: int       # pp ranks P
    num_chunks: int       # V
    num_slots: int        # ticks T
    # compute tables
    fwd_mb: Tuple[Tuple[int, ...], ...]
    fwd_chunk: Tuple[Tuple[int, ...], ...]
    bwd_mb: Tuple[Tuple[int, ...], ...]
    bwd_chunk: Tuple[Tuple[int, ...], ...]
    # activation-stash slot tables
    fwd_slot: Tuple[Tuple[int, ...], ...]     # slot holding this fwd's input
    bwd_slot: Tuple[Tuple[int, ...], ...]     # slot holding this bwd's stashed input
    in_fwd_slot: Tuple[Tuple[int, ...], ...]  # slot to store the arriving activation
    stash_size: int
    # incoming-grad stash
    gin_slot: Tuple[Tuple[int, ...], ...]     # slot holding this bwd's incoming grad
    in_bwd_slot: Tuple[Tuple[int, ...], ...]  # slot to store the arriving grad
    gstash_size: int


def build_interleaved_sync_tables(
    num_microbatches: int, num_stages: int, num_chunks: int
) -> InterleavedSlotTables:
    """Greedy dependency-honoring tick assignment for interleaved sync-1F1B.

    Dispatch order per rank follows Megatron's interleaved 1F1B (chunk-major
    groups of P microbatches: ``for each group of P mbs: for each chunk:
    the P mbs``; backwards mirrored chunk-descending), with each op placed
    at the earliest tick satisfying:

    - ``fwd(s, m)`` needs ``fwd(s-1, m)`` in an *earlier* tick (activation
      arrives via the end-of-tick ppermute);
    - ``bwd(s, m)`` needs ``bwd(s+1, m)`` in an earlier tick, and
      ``fwd(s, m)`` in an earlier-or-equal tick (the backward recomputes
      the stage forward from the stashed input; at the last virtual stage
      fwd and bwd of a microbatch share the tick, as in the V=1 engine);
    - at most one fwd and one bwd per rank per tick;
    - per-rank ops dispatch in order (pointer semantics, like the engine's
      sequential consumption of its tick table).

    Activation-stash live intervals ``[arrival(or fwd tick for s=0), bwd
    tick]`` and grad intervals ``[arrival, bwd tick]`` are then colored
    into the minimum slot count per rank (max over ranks = stash shape).

    ``M`` need NOT be a multiple of ``P`` (VERDICT r4 #3): the dispatch order
    is built over ``M`` padded up to the next multiple (Megatron's group
    structure), ghost microbatches are then erased from every table
    (``-1`` = none — the engine's existing masking skips them uniformly),
    ghost-only ticks are compacted away, and slot coloring sees only real
    microbatches.  A ragged tail costs a slightly larger bubble than a
    divisible ``M``, never a wrong result."""
    M_real, P, V = num_microbatches, num_stages, num_chunks
    if V < 1:
        raise ValueError(f"num_chunks must be >= 1, got {V}")
    if M_real < 1:
        raise ValueError(f"num_microbatches must be >= 1, got {M_real}")
    M = -(-M_real // P) * P  # padded for the group-of-P dispatch order
    S = V * P

    def owner(s):
        return s % P

    def chunk(s):
        return s // P

    # per-rank dispatch orders
    fwd_order: List[List[Tuple[int, int]]] = [[] for _ in range(P)]  # (s, m)
    bwd_order: List[List[Tuple[int, int]]] = [[] for _ in range(P)]
    for g in range(M // P):
        for v in range(V):
            for j in range(P):
                m = g * P + j
                for r in range(P):
                    fwd_order[r].append((v * P + r, m))
        for v in reversed(range(V)):
            for j in range(P):
                m = g * P + j
                for r in range(P):
                    bwd_order[r].append((v * P + r, m))

    fwd_done = {}
    bwd_done = {}
    fi = [0] * P
    bi = [0] * P
    rows: dict = {k: [[] for _ in range(P)] for k in ("fm", "fc", "bm", "bc")}
    t = 0
    while any(fi[r] < len(fwd_order[r]) or bi[r] < len(bwd_order[r])
              for r in range(P)):
        placed_f = {}
        placed_b = {}
        for r in range(P):
            f_sm = b_sm = None
            if fi[r] < len(fwd_order[r]):
                s, m = fwd_order[r][fi[r]]
                if s == 0 or fwd_done.get((s - 1, m), t) < t:
                    f_sm = (s, m)
                    fi[r] += 1
            if bi[r] < len(bwd_order[r]):
                s, m = bwd_order[r][bi[r]]
                f_t = fwd_done.get((s, m))
                if f_sm == (s, m):  # same tick fwd (last virtual stage)
                    f_t = t
                ready = f_t is not None and f_t <= t
                if s < S - 1:
                    ready = ready and bwd_done.get((s + 1, m), t) < t
                if ready:
                    b_sm = (s, m)
                    bi[r] += 1
            placed_f[r] = f_sm
            placed_b[r] = b_sm
        for r in range(P):
            f_sm, b_sm = placed_f[r], placed_b[r]
            if f_sm is not None:
                fwd_done[f_sm] = t
            if b_sm is not None:
                bwd_done[b_sm] = t
            # ghost microbatches (m >= M_real, the divisibility padding)
            # keep their dependency bookkeeping but never reach the tables
            f_real = f_sm is not None and f_sm[1] < M_real
            b_real = b_sm is not None and b_sm[1] < M_real
            rows["fm"][r].append(f_sm[1] if f_real else -1)
            rows["fc"][r].append(chunk(f_sm[0]) if f_real else -1)
            rows["bm"][r].append(b_sm[1] if b_real else -1)
            rows["bc"][r].append(chunk(b_sm[0]) if b_real else -1)
        t += 1
        if t > 4 * (M * V + S) + 16:  # pragma: no cover - schedule bug guard
            raise RuntimeError(
                f"interleaved slot assignment did not converge (M={M}, P={P}, V={V})"
            )
    T = t

    # ---- offline stash slot allocation (interval coloring per rank) ----
    color = _color_intervals

    fwd_slot = [[-1] * T for _ in range(P)]
    bwd_slot = [[-1] * T for _ in range(P)]
    in_fwd_slot = [[-1] * T for _ in range(P)]
    gin_slot = [[-1] * T for _ in range(P)]
    in_bwd_slot = [[-1] * T for _ in range(P)]
    stash_size = 1
    gstash_size = 1
    for r in range(P):
        # activation intervals: input of (s, m) lives from its availability
        # (fwd tick for virtual stage 0; arrival tick otherwise) to its bwd.
        # Only REAL microbatches get slots (ghosts never store anything).
        acts = []
        for s in range(r, S, P):
            for m in range(M_real):
                start = fwd_done[(s, m)] if s == 0 else fwd_done[(s - 1, m)] + 1
                acts.append((start, bwd_done[(s, m)], (s, m)))
        assign, n = color(acts)
        stash_size = max(stash_size, n)
        grads = []
        for s in range(r, S, P):
            if s == S - 1:
                continue
            for m in range(M_real):
                grads.append(
                    (bwd_done[(s + 1, m)] + 1, bwd_done[(s, m)], (s, m)))
        gassign, gn = color(grads)
        gstash_size = max(gstash_size, gn)
        for t_ in range(T):
            fm, fc = rows["fm"][r][t_], rows["fc"][r][t_]
            if fm >= 0:
                fwd_slot[r][t_] = assign[(fc * P + r, fm)]
            bm, bc = rows["bm"][r][t_], rows["bc"][r][t_]
            if bm >= 0:
                s = bc * P + r
                bwd_slot[r][t_] = assign[(s, m_ := bm)]
                if s < S - 1:
                    gin_slot[r][t_] = gassign[(s, m_)]
        # arrival tables: what lands at the END of tick t_ on this rank
        prev_r = (r - 1) % P
        next_r = (r + 1) % P
        for t_ in range(T):
            pm, pc = rows["fm"][prev_r][t_], rows["fc"][prev_r][t_]
            if pm >= 0:
                s_sender = pc * P + prev_r
                if s_sender + 1 < S and owner(s_sender + 1) == r:
                    in_fwd_slot[r][t_] = assign[(s_sender + 1, pm)]
            nm, nc = rows["bm"][next_r][t_], rows["bc"][next_r][t_]
            if nm >= 0:
                s_sender = nc * P + next_r
                if s_sender - 1 >= 0 and owner(s_sender - 1) == r:
                    in_bwd_slot[r][t_] = gassign[(s_sender - 1, nm)]

    # compact ghost-only ticks: a tick where no rank computes also sends
    # nothing (arrivals are set only opposite a sender's compute entry), so
    # dropping it preserves every strict tick-order dependency
    keep = [t_ for t_ in range(T)
            if any(rows["fm"][r][t_] >= 0 or rows["bm"][r][t_] >= 0
                   for r in range(P))]
    sel = lambda rows_: tuple(  # noqa: E731
        tuple(rows_[r][t_] for t_ in keep) for r in range(P))
    return InterleavedSlotTables(
        num_microbatches=M_real,
        num_stages=P,
        num_chunks=V,
        num_slots=len(keep),
        fwd_mb=sel(rows["fm"]),
        fwd_chunk=sel(rows["fc"]),
        bwd_mb=sel(rows["bm"]),
        bwd_chunk=sel(rows["bc"]),
        fwd_slot=sel(fwd_slot),
        bwd_slot=sel(bwd_slot),
        in_fwd_slot=sel(in_fwd_slot),
        stash_size=stash_size,
        gin_slot=sel(gin_slot),
        in_bwd_slot=sel(in_bwd_slot),
        gstash_size=gstash_size,
    )


@dataclasses.dataclass(frozen=True)
class InterleavedFwdTables:
    """Forward-only interleaved timetable (fill-drain over virtual stages):
    drives the differentiable loss oracle and the inference path of the
    interleaved engine (``InferenceSchedule`` analogue)."""

    num_microbatches: int
    num_stages: int
    num_chunks: int
    num_slots: int
    fwd_mb: Tuple[Tuple[int, ...], ...]
    fwd_chunk: Tuple[Tuple[int, ...], ...]
    fwd_slot: Tuple[Tuple[int, ...], ...]
    in_fwd_slot: Tuple[Tuple[int, ...], ...]
    stash_size: int


def _color_intervals(intervals):
    """First-fit interval coloring: ``intervals`` of (start, end, key) →
    (assignment dict, slot count).  A slot is reusable the tick after its
    previous occupant's last read (strict ``<`` on starts)."""
    intervals = sorted(intervals)
    slot_free_at: List[int] = []
    assign = {}
    for lo, hi, key in intervals:
        for i, free in enumerate(slot_free_at):
            if free < lo:
                slot_free_at[i] = hi
                assign[key] = i
                break
        else:
            assign[key] = len(slot_free_at)
            slot_free_at.append(hi)
    return assign, len(slot_free_at)


def build_interleaved_fwd_tables(
    num_microbatches: int, num_stages: int, num_chunks: int
) -> InterleavedFwdTables:
    """Greedy earliest-tick assignment of the interleaved *forward* pass:
    per-rank Megatron chunk-major dispatch order, one fwd per rank per tick,
    activation available the tick after the producing tick (ppermute).
    ``M`` need not divide ``P`` — same ghost-padding/erase/compact scheme
    as :func:`build_interleaved_sync_tables`."""
    M_real, P, V = num_microbatches, num_stages, num_chunks
    if M_real < 1:
        raise ValueError(f"num_microbatches must be >= 1, got {M_real}")
    M = -(-M_real // P) * P
    S = V * P
    fwd_order: List[List[Tuple[int, int]]] = [[] for _ in range(P)]
    for g in range(M // P):
        for v in range(V):
            for j in range(P):
                m = g * P + j
                for r in range(P):
                    fwd_order[r].append((v * P + r, m))

    fwd_done = {}
    fi = [0] * P
    fm_rows: List[List[int]] = [[] for _ in range(P)]
    fc_rows: List[List[int]] = [[] for _ in range(P)]
    t = 0
    while any(fi[r] < len(fwd_order[r]) for r in range(P)):
        placed = {}
        for r in range(P):
            placed[r] = None
            if fi[r] < len(fwd_order[r]):
                s, m = fwd_order[r][fi[r]]
                if s == 0 or fwd_done.get((s - 1, m), t) < t:
                    placed[r] = (s, m)
                    fi[r] += 1
        for r in range(P):
            sm = placed[r]
            if sm is not None:
                fwd_done[sm] = t
            real = sm is not None and sm[1] < M_real
            fm_rows[r].append(sm[1] if real else -1)
            fc_rows[r].append(sm[0] // P if real else -1)
        t += 1
        if t > 4 * (M * V + S) + 16:  # pragma: no cover
            raise RuntimeError("interleaved fwd assignment did not converge")
    T = t

    fwd_slot = [[-1] * T for _ in range(P)]
    in_fwd_slot = [[-1] * T for _ in range(P)]
    stash_size = 1
    for r in range(P):
        acts = []
        for s in range(r, S, P):
            for m in range(M_real):
                start = fwd_done[(s, m)] if s == 0 else fwd_done[(s - 1, m)] + 1
                acts.append((start, fwd_done[(s, m)], (s, m)))
        assign, n = _color_intervals(acts)
        stash_size = max(stash_size, n)
        for t_ in range(T):
            fm, fc = fm_rows[r][t_], fc_rows[r][t_]
            if fm >= 0:
                fwd_slot[r][t_] = assign[(fc * P + r, fm)]
        prev_r = (r - 1) % P
        for t_ in range(T):
            pm, pc = fm_rows[prev_r][t_], fc_rows[prev_r][t_]
            if pm >= 0:
                s_sender = pc * P + prev_r
                if s_sender + 1 < S and (s_sender + 1) % P == r:
                    in_fwd_slot[r][t_] = assign[(s_sender + 1, pm)]

    keep = [t_ for t_ in range(T)
            if any(fm_rows[r][t_] >= 0 for r in range(P))]
    sel = lambda rows_: tuple(  # noqa: E731
        tuple(rows_[r][t_] for t_ in keep) for r in range(P))
    return InterleavedFwdTables(
        num_microbatches=M_real, num_stages=P, num_chunks=V,
        num_slots=len(keep),
        fwd_mb=sel(fm_rows), fwd_chunk=sel(fc_rows), fwd_slot=sel(fwd_slot),
        in_fwd_slot=sel(in_fwd_slot), stash_size=stash_size,
    )


def build_sync_slot_tables(num_microbatches: int, num_stages: int) -> SlotTables:
    """The *synchronous* 1F1B timetable driving the single-jit engine: every
    tick, every stage runs one forward **and** one backward (on different
    microbatches), so an SPMD program needs no rank-divergent control flow
    around the collective-bearing stage compute — required because XLA
    collectives inside a ``lax.cond`` deadlock when their participant set is
    not a subset of the branch takers.

    Closed form (stage ``s`` of ``P``, microbatch ``m`` of ``M``):

    - forward of ``m`` at tick ``s + m``;
    - backward of ``m`` at tick ``2(P-1) - s + m``;

    giving ``T = M + 2(P-1)`` ticks.  Dependency check: ``bwd(s, m)`` needs
    ``bwd(s+1, m)`` (tick ``2(P-1)-s-1+m``, one earlier) and ``fwd(s, m)``
    (tick ``s+m``, earlier — equal only at the last stage, where the tick
    body runs its forward before its backward).  In-flight microbatches at
    stage ``s`` = ``2(P-1-s) + 1``: the same O(P) bound as classic 1F1B
    (which holds ``P - s``) at twice the constant, in exchange for bubble-
    free steady-state ticks; still independent of ``M`` — the point of 1F1B
    over fill-drain (reference ``pipeline/scheduler.py:141-273``)."""
    M, P = num_microbatches, num_stages
    T = M + 2 * (P - 1)
    fwd_rows = [
        [t - s if 0 <= t - s < M else -1 for t in range(T)] for s in range(P)
    ]
    bwd_rows = [
        [t - 2 * (P - 1) + s if 0 <= t - 2 * (P - 1) + s < M else -1 for t in range(T)]
        for s in range(P)
    ]
    return SlotTables(
        num_microbatches=M,
        num_stages=P,
        num_slots=T,
        fwd_mb=tuple(tuple(r) for r in fwd_rows),
        bwd_mb=tuple(tuple(r) for r in bwd_rows),
        # entry for mb m is written at fwd time and read at bwd time,
        # 2(P-1-s) ticks later; mod-K indexing needs K > that span.
        fwd_stash_size=2 * (P - 1) + 1,
        # incoming grad is consumed the tick after it arrives
        bwd_stash_size=2,
    )
