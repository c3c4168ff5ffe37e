#!/usr/bin/env python3
"""Drive the PyTorch port (``neuronx_distributed_tpu_torch``) on one NVIDIA
GPU and check it end to end.

    python3 chip_smoke.py

Phase 0 prints the card and builds every CUDA kernel from the sources in
the checkout, one ``nvcc`` per source started together (``-Xptxas -v``
report included), and holds the bf16 flash forward, dq and dk/dv kernels
as built to their design: no spill, no wgmma serialisation, no ignored
``setmaxnreg``, and HGMMA and UTMALDG instructions in their SASS at every
head dim; the multi-row paged kernel likewise, with HGMMA and LDGSTS
(cp.async) at every head dim over bf16 and int8 pools, and the decode
kernel with HMMA (mma.sync) and LDGSTS.  Phase 1 holds the
paged-attention kernels (the decode kernel for bf16 q at S = 1, the wgmma
kernel for bf16 q at S > 1, the simt kernel for fp32 q; the simt kernel's
bf16 code forced at S = 1 and S > 1) against their plain PyTorch version
at the serving path's shapes (Llama-3-8B attention geometry), over fp
pools and over int8 pools (the kernels' dequant branches), and times
each route, the plain version and one PyTorch library call doing the
same work: all three routes on the same decode inputs (with the decode
kernel's split sweep), at phase 1's chains of 64 pages and at long
chains of 512, and the two multi-row routes at the main path's chunk
call (one slot, 128 tokens at offset 384; each route's output there held
too) and at B = 8, S = 128; then both over query widths 2 to 128 at 4 q
heads a kv head and 2 to 16 at 1 (the routing rule).  Phase 2 serves
16 requests through ``ServingEngine`` on a full-width, full-depth
Llama-3-8B with random bf16 weights from a seed, counts the kernels'
launches on that run by route (every decode call on the decode kernel),
checks page accounting, and compares the kernel path's logits with the
gather path's.  Phase 2b serves the same requests on the same model with
int8 KV pages and 128-token prefill chunks (``kv_quant="int8"``,
``prefill_chunk_tokens``), counts the kernels' launches by route (every
decode step of every layer on the decode kernel, every chunk on the
wgmma kernel, none on the simt kernel), checks page accounting and the
int8 pool's size, compares the kernel's logits with the gather path's on
the int8 pool and the int8 pool's logits with the bf16 pool's after the
same prefill, and serves the requests once more with chunked prefill
over a bf16 pool.  Phases 2 and 2b run the eager, synchronous engine;
phase 2c runs them again with asynchronous decode and CUDA-graph phase
steps (the defaults on the card): (a) phase 2's requests, tokens
identical to phase 2's, (b) phase 2b's int8 chunked engine, tokens
identical to phase 2b's, each with its steady step time and device-busy
share, (c) one steady decode dispatch on each pool type under
``torch.cuda.set_sync_debug_mode("error")``, (d) speculative decoding at
k = 4 with a self draft (greedy, sampled, and on the int8 chunked engine)
and a weak draft (the model cut to 2 layers from seed 1): every verify
on the wgmma kernel, acceptance, and the two drafts' greedy tokens
identical; and, inside phase 5b, (e) the Gemma-2-2B requests again on the
async graph engine.  Phase 2d serves many LoRA adapters on the async
graph engine (``adapter_store=``, 4 adapters of rank 16 from seeded
factors): (a) every request on adapter 0, tokens identical to 2c(a)'s;
(b) requests round-robin over adapters 0-4, tokens identical to the
eager synchronous engine's and adapter-0 ones to 2c(a)'s, every decode
launch on the decode kernel; (c) the same on int8 pages with 128-token
chunks; (d) a self draft at k = 4 sharing the adapters; the steady step
of (a) and (b) beside the storeless engine's and the device time of the
adapter work; (e, inside phase 5b) Gemma-2-2B over 2 adapters; (f)
``prefill_one_lora`` against the ``peft.merge_lora`` dense model on a
2-layer cut.  Phase 2e serves with SLO scheduling on the async graph
engine: (a) 8 batch requests (256-512 prompt, 64 new tokens) fill the
slots and 4 interactive ones (32-128 prompt, 32 new) arrive after 4
steps and preempt batch victims, whose committed prompt chains stay
pinned: tokens identical to the unpreempted eager synchronous run, no page
or pin left, no graph captured again, every decode launch on the decode
kernel; the interactive TTFT beside the same traffic all batch, in turns,
and the tokens the victims prefilled again; (b) int8 pages with 128-token
chunks, a victim parked mid-chunk prefills only its uncommitted pages,
tokens identical to the eager synchronous int8 chunked run; (c)
``shed_infeasible`` refuses deadlines under (a)'s time-to-first-token
estimate; (d) a tenant limit on adapter 1 (burst 2) refuses the third
submit at one instant; (e) fault plans on the graph engine: a NaN on one
slot's decode logits fails only that request, an exception mid-chunk
leaks nothing and a resubmission finishes identical, and the steady step
with no plan beside one with an inert plan, in turns.  Phase 2f runs the
observability core on the same engine: (a) 2e(a)'s traffic with full
telemetry (``Observability``, ``Tracer``, ``stats_path``,
``transfer_guard="forbid"``): tokens identical to the run without it,
every artifact valid, the registry's counts equal to the engine's, phase
spans tiling each latency; (b) the steady graph step with and without
telemetry in turns, with device busy and launches a step unchanged and
the step's host time split by part; (c) ``obs.tracing.device_trace``
naming the decode kernel 32 times a step; (d) a fault through
``replay_trace`` leaving a valid flight record.  Phase 2g runs the
resource ledgers, perf attribution, health rules and the report.  Phase
2h runs the serving fleet over replicas of the async graph engine that
share phase 2's model: (a) a ``FleetRouter`` of 2 replicas with prefix
affinity over phase 2's requests and 8 sharing a 256-token preamble,
tokens identical to one engine's, again with a replica killed at
``fleet/replica_step`` (zero lost, the replica restarted), and the fleet
step's device busy share; (b) a ``DisaggRouter`` (a prefill replica with
128-token chunks, a decode replica): every request migrated once, pages
exported = imported, tokens identical to one mixed engine's, each
migration's bytes and ms; (c) a 32-page chain's transfer over bf16 and
int8 pools, bit-exact, a chaos kill leaking nothing, the fleet prefix
fill; (d) live weights on a 4-layer full-width cut (an in-place swap
capturing nothing, the in-flight step stamped with its version, a
2-replica rolling update with no compile storm); (e) the autopilot
draining and restarting a replica under traffic.  Phase 2i serves at
tensor-parallel degree 2: two processes share the one card over gloo
(NCCL refuses two ranks on one device), each holding half of Llama-3-8B
at full width and depth (16 q on 4 kv heads, half the pool): (a) phase
2's prompts with 32 new tokens each on the async engine, the decode
kernel launched 32 times a decode step on each rank and nothing else, both ranks' tokens and block
tables identical; (b) B4 at the local heads (decode and chunk calls,
bf16 and int8 pools) held to its plain version and timed beside it, the
library call and the bound (in this process, before the ranks start);
(c) 8 prompts' prefill logits against phase 2's model, every first
token equal to phase 2's, the greedy streams' common prefix with phase
2's, and one decode step after 8 admissions fed tp = 1's first tokens
against tp = 1's; (d) int8 pages and bf16 pages with 128-token chunks on a 4-layer
cut, launches by route, the int8 decode logits against the tp = 1 cut's;
(e) each rank's weight and pool bytes, steady step, busy share and
collective time a step (two processes time-sliced on one card, not tp
speed).  Phase 1 also holds
and times the verify call (B =
8, S = 5) over both pool types, and the simt kernel at fp32 q.  Phase 1
then holds the fp-pool kernels at head_dim 256
and Gemma-2-2B's geometry (8 q on 4 kv heads, softcap 50) and times the
three routes there.  Phase 3 holds the flash-attention forward, dq and dk/dv
kernels against their plain versions row by row (the training paths' own
shapes, causal and not, GQA 4 and 1, MQA, sliding windows, softcaps, packed
segments with padding, T > S, queries that see no key (o = 0, dq = 0), the
model's strided layout, an lse cotangent, D 64, 128 and 256, bf16 and
fp32) and times them
at Llama's training shape and at Gemma-2-2B's (global and sliding-window
layers, each with and without the softcap).  Phase 4 trains a
Llama-3-8B-width model cut to 4 layers (fp32 masters, bf16 compute, flash
attention) for 12 steps through the trainer's entry points, counts the
flash kernels' launches on that run, compares one step's loss, gradient
norm and attention-projection gradients through the flash and the dense
core, and reports tokens/s, MFU, peak memory, the device-busy share of a
profiled step and its flash time by kernel.  Phase 5 does the same for
Gemma-2-2B at full width and depth (26 layers, batch 1 x 8192, selective
remat: the flash kernels at D = 256), with flash vs dense held on a 2-layer
cut.  Phase 5b serves 8 requests through ``ServingEngine`` on Gemma-2-2B
with random bf16 weights (the decode kernel at D = 256 with the softcap),
counts launches by route, checks page accounting and compares kernel and gather
logits.  Phase 6 pretrains GPT-NeoX at GPT-NeoX-20B's width cut to 4 layers
(1 x 2048, selective remat) and BERT-large at full depth (16 x 512, 15 %
MLM masking, NSP, dropout 0.1 from a step generator) through the trainer's
entry points on the dense attention core: falling, finite losses, tokens/s,
MFU, peak memory, busy share and top device ops for each, a bf16 forward
held against the fp32 forward of the same weights on a 2-layer cut, and
BERT's dropout invariants (one seed, one loss; no generator,
deterministic).  Phase 7 trains past one rank, two processes sharing the
card over gloo (correctness, launches and per-rank memory, not tp or dp
speed): B1-B3 held and timed first at a tp = 2 rank's local heads (16 q
on 4 kv heads, and on 8, G = 2); then (a) Llama-3-8B's width cut to 4
layers at tp = 2 with sequence parallelism, fp32 masters, bf16 compute,
flash, selective remat and the chunked loss head, 1 x 2048, 2 + 3 steps
(+ 1 profiled) through the trainer's entry points: falling losses, the
first step's loss and grad norm against tp = 1 from the same seed, B1-B3
launches on each rank, the same collectives a step on both ranks, per-rank
memory, step and collective time and busy share; (b) a 2-layer cut at dp
= 2, 3 steps with ZeRO-1 on and off: parameters equal to the bit, AdamW
state about halved; (c) a 2-layer cut at tp = 2 with kvr = 2, one step
against tp = 1.  A device time below the least time its work needs fails
the run.

Any failed check exits non-zero without the result line.  The line before
the last is ``{"kernels": [...]}``; the last is ``{"ok": true, "device":
...}``.  Without CUDA, or without the package beside this file, the script
exits non-zero at once.
"""

from __future__ import annotations

import functools
import gc
import json
import math
import os
import subprocess
import sys
import time
import traceback

SEED = 0
HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory
PEAK_FLOPS = {"bfloat16": 989e12,   # dense tensor-core rate
              "float32": 67e12}     # fp32 outside the tensor cores
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the flash forward's lse, absolute: fp32 arithmetic on the same inputs in
# kernel and plain version (bf16 inputs are exact in fp32), so only the
# order of the sums differs
LSE_TOL = {"float32": 1e-3, "bfloat16": 1e-3}

# Phase 1 shapes: Llama-3-8B attention at the served engine's geometry
NQ, NKV, D, PAGE, B, PP = 32, 8, 128, 16, 8, 64
PARKED = 3
# the softcap case's score scale: q.k of standard normals over D=128 times
# 2.0 spreads scores to about +-70, where softcap 50 changes the result
SOFTCAP_SCALE = 2.0
# a masking or score option must move the plain version's output by more
# than this many tolerances, or its case could not catch a kernel that
# ignores the option
BITE = 10.0
# input copies cycled by the timing loops: 8 x 34 MB of pool, so a call's
# K/V reads come from device memory and not from the L2 of the last call
ROTATE = 8
# profiler traces taken of one timing before it fails (see device_ms)
TRACE_TRIES = 3
# cycles of torch.cuda._sleep per millisecond, about the H100's boost
# clock; only sizes the spin of queued_time_ms, which times the spin
SPIN_CYCLES_PER_MS = 2.0e6
# Phase 2: the served engine
SLOTS, CONTEXT, MAX_TOTAL, PAGE_SIZE = 8, 512, 1024, 16
N_REQUESTS, NEW_TOKENS = 16, 64
# Phase 2 kernel-vs-gather logits: relative L2 error of the last decode
# step's logits (bf16 weights and pool, 32 layers of rounding apart)
LOGITS_REL_TOL = 5e-2
# Phase 1 int8 cases: head dims and query widths (decode, verify, chunk)
INT8_DIMS, INT8_WIDTHS = (64, 128, 256), (1, 4, 128)
# Phase 2b: the chunk width, and the bound on the int8 pool's decode logits
# against the bf16 pool's after the same prefill, relative L2 over the
# live slots (PERF.md: int8 page codes err by up to half a step, ~0.2 % of
# a page's range; 0.5 is far above that drift and far below what a broken
# quantizer gives)
CHUNK_TOKENS = 128
INT8_DRIFT_REL_MAX = 0.5
# the int8 pool's device bytes against the bf16 pool's at one page count
INT8_POOL_RATIO_MAX = 0.51


# the run's start on the host clock: each log line carries the seconds
# since, so a phase's share of the time limit reads off the log
_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Wall time per call between two CUDA events around ``iters`` calls
    issued back to back.  For a short kernel this is the rate at which the
    host launches it (validation, allocation, the ctypes call), not the
    kernel's own time: see :func:`device_ms`."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def queued_time_ms(fn, iters: int, warmup: int = 3):
    """Wall time per call between two CUDA events around ``iters`` calls
    that the device runs back to back: a spin kernel
    (``torch.cuda._sleep``) holds the device until the host has issued
    every call, so a host that issues slowly or stalls (autograd's
    backward spends about half a millisecond of Python per call, and the
    host's cores are shared) leaves no idle gaps between the calls.  The
    spin is timed, and sized afresh (doubled, up to TRACE_TRIES times)
    when the host was not done issuing before it ended.  Returns ``(ms per
    call, host ms per call to issue)``; the first is None when the host
    never got ahead (a call that synchronises, or a full launch queue)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    hold_ms = 20.0
    for _ in range(TRACE_TRIES):
        held = torch.cuda.Event(enable_timing=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        held.record()
        torch.cuda._sleep(int(hold_ms * SPIN_CYCLES_PER_MS))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        issue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if issue_ms < held.elapsed_time(start):
            return start.elapsed_time(end) / iters, issue_ms / iters
        hold_ms = 2 * max(hold_ms, issue_ms)
    return None, issue_ms / iters


def dev_us(event) -> float:
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def device_events(prof):
    """The profile's device-side rows (kernels, copies), without the GPU
    ranges of user annotations such as ``Optimizer.step``, which span
    kernels already counted."""
    import torch

    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def trace(run, warm):
    """The device events of ``run()`` under ``torch.profiler``, after
    ``warm()`` ran as the profiler's warm-up step.  Events are recorded
    from the second step only: a session that traces from its first
    kernel on dropped the kernels of 2 of 20 calls in one reading.  It
    still drops one call's now and then (:func:`device_ms` allows for
    that)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        warm()
        torch.cuda.synchronize()
        prof.step()
        run()
        torch.cuda.synchronize()
        prof.step()
    return device_events(prof)


def launches_per_call(count: int, iters: int) -> int:
    """Launches of one kernel per call when the profiler recorded
    ``count`` of them over ``iters`` calls that each launch it."""
    return max(1, round(count / iters))


def device_ms(fns, iters: int, expect: str = "", show: str = "",
              names=None, launched=None) -> float:
    """Device time per call of the kernels (and copies) that ``iters``
    calls put on the card, as ``torch.profiler`` reads them.  The calls
    cycle through ``fns``, one per copy of the inputs, so that a call
    finds its inputs in device memory and not in the 50 MB L2 the
    previous call filled.  Every call launches the same kernels, ``n =
    round(count / iters)`` of each, and at least one of each kernel the
    trace shows (the profiler has recorded fewer than half of 20 calls'
    SDPA kernels); a kernel's time per call is its mean recorded duration
    times ``n``, so a call whose kernels the profiler dropped (the count
    falls short of ``n * iters``, and is logged) does not read the time
    low.  ``expect`` names a kernel that must be
    among those seen; a trace with no device time, or without that
    kernel, is taken again, up to TRACE_TRIES times (the profiler has
    returned an empty trace of 20 calls that launched a kernel each, and
    on one H100 run three empty traces of the same 20 flash calls).  When
    all of them come back so, the calls are timed between CUDA events
    instead (:func:`events_ms`); with an ``expect``, that needs
    ``launched``, the kernel wrapper's launch count, to show the kernel
    ran.  ``show`` logs every device event per call under that label;
    ``names``, a list, receives the event names, longest first."""
    def run():
        for i in range(iters):
            fns[i % len(fns)]()

    def warm():
        for fn in fns:
            fn()

    warm()
    for attempt in range(1, TRACE_TRIES + 1):
        events = trace(run, warm)
        per_call = [dev_us(e) / e.count * launches_per_call(e.count, iters)
                    for e in events]
        total = sum(per_call)
        seen = total > 0 and (not expect or any(expect in e.key
                                                for e in events))
        if seen:
            break
        log(f"torch.profiler trace {attempt}/{TRACE_TRIES} of {iters} calls "
            f"shows {total:.1f} us of device time and "
            f"{[e.key[:60] for e in events]}" + (f", no {expect}" if expect
                                                  else ""))
    else:
        if names is not None:
            names.append("not seen by torch.profiler")
        return events_ms(fns, iters, expect, launched)
    lost = [f"{e.key[:60]} {e.count}/"
            f"{launches_per_call(e.count, iters) * iters}" for e in events
            if e.count != launches_per_call(e.count, iters) * iters]
    if lost:
        log(f"torch.profiler dropped device events over {iters} calls "
            f"(recorded/expected): {lost}")
    ranked = sorted(zip(per_call, events), key=lambda x: -x[0])
    if show:
        log(f"{show}, device events per call: " + "; ".join(
            f"{e.key[:90]} x{e.count / iters:g} {ms / 1e3:.5f} ms"
            for ms, e in ranked))
    if names is not None:
        names.extend(e.key for _, e in ranked)
    return total / 1e3


def events_ms(fns, iters: int, expect: str = "", launched=None) -> float:
    """Device ms per call of ``iters`` calls cycling through ``fns``,
    between CUDA events with the calls queued (:func:`queued_time_ms`):
    the time :func:`device_ms` reports when ``torch.profiler`` recorded
    none of its calls.  With an ``expect``, ``launched()`` (the wrapper's
    launch count) must rise by at least ``iters`` over the timing, or the
    run fails: the events alone cannot tell which kernel ran."""
    if expect and launched is None:
        raise RuntimeError(f"torch.profiler saw no {expect} in "
                           f"{TRACE_TRIES} traces, and no launch count was "
                           "given to time it between CUDA events")
    turn = iter(range(10 ** 9))
    before = launched() if launched is not None else 0
    ms, host_ms = queued_time_ms(lambda: fns[next(turn) % len(fns)](), iters)
    if launched is not None and launched() - before < iters:
        raise AssertionError(f"{expect}: {launched() - before} launches over "
                             f"{iters} timed calls")
    if ms is None:
        raise RuntimeError(f"torch.profiler saw no device time (or no "
                           f"{expect or 'kernel'}) in {TRACE_TRIES} traces, "
                           f"and the host could not issue {iters} calls "
                           f"ahead of the device ({host_ms:.5f} ms per call)")
    log(f"torch.profiler saw no device time (or no {expect or 'kernel'}) in "
        f"{TRACE_TRIES} traces: timed between CUDA events instead, "
        f"{ms:.5f} ms per call over {iters} queued calls"
        + (f", the wrapper's launch count rose by {launched() - before}"
           if launched is not None else ""))
    return ms


def check_events(name: str, profiler_ms: float, fn, iters: int,
                 retrace=None) -> float:
    """For a call of a quarter millisecond and more, the wall time between
    CUDA events over ``iters`` calls of ``fn`` that the device runs back
    to back (:func:`queued_time_ms`) is the device time plus launch gaps
    of microseconds: a profiler sum below 90 % of it lost device work.
    ``retrace()`` takes the profiler reading again: a reading that lost
    work is retaken, with the events, up to TRACE_TRIES times in all (as
    an empty trace is), and the run fails if none holds.  Returns the
    profiler reading that held.  Where the host could not issue the calls
    ahead of the device, the event time says nothing of the device: the
    check is logged and skipped."""
    for attempt in range(1, TRACE_TRIES + 1):
        event_ms, host_ms = queued_time_ms(fn, iters)
        if event_ms is None:
            log(f"{name}: the host could not issue {iters} calls ahead of "
                f"the device ({host_ms:.5f} ms per call); no event check")
            return profiler_ms
        log(f"{name}: device ms per call {profiler_ms:.5f} from "
            f"torch.profiler, {event_ms:.5f} between CUDA events with the "
            f"calls queued, host {host_ms:.5f} to issue")
        if profiler_ms >= 0.9 * event_ms:
            return profiler_ms
        if retrace is None or attempt == TRACE_TRIES:
            break
        log(f"{name}: torch.profiler read under 90 % of the events "
            f"(reading {attempt}/{TRACE_TRIES}); both taken again")
        profiler_ms = retrace()
    raise AssertionError(
        f"{name}: torch.profiler reads {profiler_ms:.5f} ms per call, "
        f"under 90 % of the {event_ms:.5f} ms between CUDA events")


def check_bound(name: str, times: dict, bound: float,
                retake=None) -> dict:
    """A device time below the least time the card needs for the work
    means the profiler missed device work: never report it.  A reading
    of ``what`` that falls below is taken again by ``retake[what]()``, up
    to TRACE_TRIES readings in all (as an empty trace is), and the run
    fails if none holds (on one H100 run a split-4 decode sweep read
    0.04147 ms, 0.68 of its usual 0.061 and under its 0.04168 ms bound).
    Returns ``times`` with the readings that held."""
    held = dict(times)
    for what, ms in times.items():
        reading = 1
        while not ms >= bound:
            if (retake is None or what not in retake
                    or reading == TRACE_TRIES):
                raise AssertionError(
                    f"{name}: {what} reads {ms:.5f} ms, below its bound "
                    f"{bound:.5f} ms; the profiler missed device work")
            log(f"{name}: {what} reads {ms:.5f} ms, below its bound "
                f"{bound:.5f} ms (reading {reading}/{TRACE_TRIES}); the "
                f"profiler missed device work: taken again")
            ms = retake[what]()
            reading += 1
        held[what] = ms
    return held


# -- phase 0: build guards ---------------------------------------------------

# the bf16 kernels (B1-B3: TMA, wgmma, warp-specialised), by the index
# flash_wgmma_smem_bytes takes, and the libraries that instantiate them
WGMMA_KERNELS = {"fwd": (0, "flash_fwd_wgmma_kernel"),
                 "dq": (1, "flash_dq_wgmma_kernel"),
                 "dkv": (2, "flash_dkv_wgmma_kernel")}
WGMMA_LIBS = {"flash_attention": (64, 128), "flash_attention_d256": (256,)}
# the multi-row paged kernel (wgmma, cp.async, warp-specialised) and the
# decode kernel (mma.sync, a cp.async ring per warp, cluster merge)
PAGED_WGMMA_KERNEL = "paged_attention_wgmma_kernel"
PAGED_DECODE_KERNEL = "paged_attention_decode_kernel"


def ptxas_functions(report: str) -> dict:
    """``{mangled name: {"registers", "spill_stores", "spill_loads"}}``
    from an ``nvcc -Xptxas -v`` report."""
    import re

    funcs, cur = {}, None
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return funcs


@functools.lru_cache(maxsize=None)
def sass_functions(lib_path: str) -> dict:
    """``{mangled name: SASS text}`` of a built library, from the
    toolkit's ``cuobjdump -sass`` (one dump a library: each kernel's guard
    reads the same one)."""
    from neuronx_distributed_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    proc = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump failed on {lib_path}: {proc.stderr}")
    funcs = {}
    for part in proc.stdout.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        funcs[name.strip()] = body
    return funcs


def guard_kernels(paths: dict, lib_name: str, kname: str, tags: dict,
                  ops, smem_of) -> dict:
    """One kernel template as built in library ``lib_name``: ptxas reports
    no wgmma serialisation and no ignored setmaxnreg in the library, no
    spill for any instantiation, and the SASS of each holds every
    instruction in ``ops``.  ``tags``: ``{key: the template arguments as
    mangled}``, one instantiation each; ``smem_of(key)``: its dynamic
    shared memory.  Fails the run otherwise; returns ``{key: registers,
    shared memory and instruction counts}``."""
    from neuronx_distributed_tpu_torch.ops import _build

    report = _build.build_logs.get(lib_name, "")
    if "ptxas" not in report:
        raise AssertionError(f"no ptxas report for {lib_name}: {report!r}")
    for bad in ("instructions are serialized", "setmaxnreg ignored"):
        if bad in report:
            lines = [ln for ln in report.splitlines() if bad in ln]
            raise AssertionError(f"{lib_name}: ptxas says {bad!r}: {lines}")
    ptx = {n: f for n, f in ptxas_functions(report).items() if kname in n}
    sass = {n: t for n, t in sass_functions(paths[lib_name]).items()
            if kname in n}
    if len(ptx) != len(tags) or len(sass) != len(tags):
        raise AssertionError(f"{lib_name}: {kname} for {list(tags)} "
                             f"expected, ptxas reports {list(ptx)}, SASS has "
                             f"{list(sass)}")
    found = {}
    for key, tag in tags.items():
        (pn, pf), = [(n, f) for n, f in ptx.items() if tag in n]
        (sn, text), = [(n, t) for n, t in sass.items() if tag in n]
        counts = {op: text.count(op) for op in ops}
        spill = pf.get("spill_stores", -1) + pf.get("spill_loads", -1)
        info = dict(pf, smem_bytes=smem_of(key), sass=counts)
        log(f"phase0 guard: {kname}<{key}> in {lib_name}: {info}")
        if spill != 0:
            raise AssertionError(f"{kname}<{key}> spills: {pf}")
        if not all(counts.values()):
            raise AssertionError(f"{kname}<{key}> SASS lacks one of {ops}: "
                                 f"{counts}")
        found[key] = info
    return found


def check_build_guards(paths: dict) -> dict:
    """The bf16 flash forward, dq and dk/dv kernels in each library that
    instantiates them (HGMMA and UTMALDG at every head dim), the
    multi-row paged kernel (HGMMA and LDGSTS, cp.async, at every head dim
    over bf16 and int8 pools) and the decode kernel (HMMA, mma.sync, and
    LDGSTS at the same six): no spill, no wgmma serialisation, no ignored
    setmaxnreg.  Returns ``{kernel: {instantiation: registers, shared
    memory and instruction counts}}``."""
    from neuronx_distributed_tpu_torch.ops import _build

    found = {w: {} for w in WGMMA_KERNELS}
    for name, dims in WGMMA_LIBS.items():
        lib = _build.load(name)
        for w, (which, kname) in WGMMA_KERNELS.items():
            found[w].update(guard_kernels(
                paths, name, kname, {d: f"ILi{d}E" for d in dims},
                ("HGMMA", "UTMALDG"),
                lambda d, which=which: lib.flash_wgmma_smem_bytes(which, d)))
    paged = _build.load("paged_attention")
    found["paged_wgmma"] = guard_kernels(
        paths, "paged_attention", PAGED_WGMMA_KERNEL,
        {f"{d} {pool}": f"ILi{d}ELb{int(pool == 'int8')}E"
         for d in (64, 128, 256) for pool in ("bf16", "int8")},
        ("HGMMA", "LDGSTS"),
        lambda key: paged.paged_wgmma_smem_bytes(int(key.split()[0]),
                                                 int(key.endswith("int8"))))
    found["paged_decode"] = guard_kernels(
        paths, "paged_attention", PAGED_DECODE_KERNEL,
        {f"{d} {pool}": f"ILi{d}ELb{int(pool == 'int8')}E"
         for d in (64, 128, 256) for pool in ("bf16", "int8")},
        ("HMMA", "LDGSTS"),
        lambda key: paged.paged_decode_smem_bytes(int(key.split()[0]),
                                                  int(key.endswith("int8"))))
    found["paged_decode_clusters"] = decode_clusters(paged)
    log("phase0 guard: the bf16 forward, dq and dk/dv use HGMMA and UTMALDG "
        "at every head dim, the multi-row paged kernel HGMMA and LDGSTS and "
        "the decode kernel HMMA and LDGSTS at every head dim and pool type; "
        "none spills; no wgmma serialisation, no ignored setmaxnreg")
    return found


def decode_clusters(paged) -> dict:
    """How many of the decode kernel's clusters the card holds at once
    (``cudaOccupancyMaxActiveClusters``) at phase 1's decode shapes, beside
    the clusters a call launches (one per slot and kv head): fewer held
    than launched runs the call's short blocks in two waves."""
    import torch

    from neuronx_distributed_tpu_torch.ops.paged_attention import (
        _sm_count,
        decode_split_k,
    )

    sms = _sm_count(torch.cuda.current_device())
    fits = {}
    for label, d, quant, nq, nkv in (("bf16 D128", D, 0, NQ, NKV),
                                     ("int8 D128", D, 1, NQ, NKV),
                                     ("bf16 D256", G2_D, 0, G2_NQ, G2_NKV)):
        sk = decode_split_k(B, nkv, PP * PAGE, sms)
        fits[label] = {"split_k": sk, "clusters": B * nkv,
                       "held_at_once": paged.paged_decode_max_clusters(
                           d, quant, nq // nkv, sk)}
    log(f"phase0: decode kernel clusters at phase 1's decode shapes "
        f"(launched / held at once by the card): {fits}")
    return fits


# -- phase 1 ------------------------------------------------------------------


def paged_inputs(S: int, dtype, device, d: int = D, int8: bool = False,
                 nq: int = NQ, nkv: int = NKV, chunk_offset=None,
                 pp: int = PP):
    """Seeded inputs at the served geometry (``nq`` q heads on ``nkv`` kv
    heads, chains of ``pp`` pages): ragged offsets, one parked slot,
    non-zero kv_start, a shuffled physical block table.  ``int8``: the
    pool is the int8 six-tuple that ``quantize_page`` makes of the fp pool,
    with the first page slot 0 attends made constant first (scale 0).
    ``chunk_offset``: the main path's chunk call instead, one slot (B = 1)
    whose chunk starts at that offset, kv_start 0."""
    import numpy as np
    import torch

    from neuronx_distributed_tpu_torch.kvcache.quant import quantize_page

    rs = np.random.RandomState(SEED + S + (0 if d == D else d))
    T = pp * PAGE
    nb = B if chunk_offset is None else 1
    NP = nb * pp + 1
    q = torch.from_numpy(rs.standard_normal((nb, S, nq, d)).astype(np.float32))
    k = torch.from_numpy(rs.standard_normal((NP, PAGE, nkv, d)).astype(np.float32))
    v = torch.from_numpy(rs.standard_normal((NP, PAGE, nkv, d)).astype(np.float32))
    bt = (rs.permutation(NP - 1) + 1).reshape(nb, pp).astype(np.int32)
    if chunk_offset is None:
        off = rs.randint(40, T - S, size=B).astype(np.int32)
        off[PARKED] = T
        start = np.minimum(rs.randint(0, 40, size=B), off).astype(np.int32)
    else:
        off = np.array([chunk_offset], np.int32)
        start = np.zeros(1, np.int32)
    start[0] = 0
    to = dict(device=device)
    if int8:
        k[bt[0, 0]], v[bt[0, 0]] = 0.75, -0.5
        (qk, ks, kz), (qv, vs, vz) = quantize_page(k), quantize_page(v)
        pool = tuple(t.to(**to) for t in (qk, qv, ks, kz, vs, vz))
    else:
        pool = (k.to(dtype=dtype, **to), v.to(dtype=dtype, **to))
    return (q.to(dtype=dtype, **to), pool,
            torch.from_numpy(bt).to(**to), torch.from_numpy(off).to(**to),
            torch.from_numpy(start).to(**to))


def bound_ms(S: int, dtype_name: str, off, start, window=None, d: int = D,
             int8: bool = False, nq: int = NQ, nkv: int = NKV,
             pp: int = PP) -> tuple:
    """Least time for the work these inputs need.  Bytes, each moved once
    over the memory rate: K and V at the positions [lo, hi] each live slot
    attends (the range the kernel walks; 1 byte an element in an int8
    pool, plus 16 bytes of page params for every page that range touches),
    q read, out written, the block table, offsets and starts read.
    Operations over the peak rate of q's type: the q.K and p.V of every
    key each query row sees."""
    T = pp * PAGE
    item = 2 if dtype_name == "bfloat16" else 4
    kv_item = 1 if int8 else item
    G = nq // nkv
    nb = len(off)
    nbytes = 2 * nb * S * nq * d * item + nb * pp * 4 + 2 * nb * 4
    flops = 0
    for o, s0 in zip(off.tolist(), start.tolist()):
        if o >= T:
            continue
        hi = min(o + S - 1, T - 1)
        lo = max(s0, 0 if window is None else o - window + 1)
        nbytes += 2 * max(hi - lo + 1, 0) * nkv * d * kv_item
        if int8 and hi >= lo:
            nbytes += 16 * (hi // PAGE - lo // PAGE + 1)
        for s in range(S):
            qp = min(o + s, T - 1)
            lo_s = max(s0, 0 if window is None else o + s - window + 1)
            flops += 4 * d * nkv * G * max(qp - lo_s + 1, 0)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def library_call(q, pool, bt, off, start, sm_scale=None):
    """Yardstick only (never used by the port): gather the chains into
    [B, T, NKV, D] (an int8 pool's pages dequantized to q's type by
    ``dequantize_page``) and run scaled_dot_product_attention with the
    band mask (it has no softcap)."""
    import torch
    import torch.nn.functional as F

    from neuronx_distributed_tpu_torch.kvcache.quant import dequantize_page

    b = bt.long()
    k, v = pool[0][b], pool[1][b]
    if len(pool) == 6:
        k = dequantize_page(k, pool[2][b], pool[3][b], q.dtype)
        v = dequantize_page(v, pool[4][b], pool[5][b], q.dtype)
    T = bt.shape[1] * k.shape[2]
    nb, S, d, nkv = q.shape[0], q.shape[1], q.shape[3], k.shape[-2]
    kg = k.reshape(nb, T, nkv, d).transpose(1, 2)
    vg = v.reshape(nb, T, nkv, d).transpose(1, 2)
    qpos = off.long()[:, None] + torch.arange(S, device=q.device)[None]
    kpos = torch.arange(T, device=q.device)
    mask = (kpos[None, None] <= qpos[..., None]) & (
        kpos[None, None] >= start.long()[:, None, None])
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), kg, vg, attn_mask=mask[:, None], scale=sm_scale,
        enable_gqa=True).transpose(1, 2)


def hold_paged_cases(cases, label: str, d: int = D, nq: int = NQ,
                     nkv: int = NKV) -> dict:
    """Each case: the kernel against its plain version within TOL, the
    parked slot exact zeros, and each option of the case (window, softcap)
    moving the plain output by more than BITE tolerances.  A case may name
    its head dim (``d``), an int8 pool (``int8``: the plain version then
    dequantizes the gathered pages to q's type, as the kernels do; an fp
    pool's plain version runs in fp32 from the same inputs) and a route
    (``route``; default the wrapper's rule); the route the call took must
    be the one asked for.  Returns the worst error per (route, dtype
    name)."""
    import torch

    from neuronx_distributed_tpu_torch.ops.paged_attention import (
        _paged_attention_on,
        paged_attention,
        paged_attention_reference,
        paged_route,
    )

    live = [b for b in range(B) if b != PARKED]
    worst = {}
    for case in cases:
        S, dtype = case["S"], case["dtype"]
        dd, int8 = case.get("d", d), case.get("int8", False)
        kw = {k: case[k] for k in ("window", "softcap", "sm_scale")
              if k in case}
        q, pool, bt, off, start = paged_inputs(S, dtype, "cuda", dd,
                                               int8=int8, nq=nq, nkv=nkv)
        want = case.get("route") or paged_route(dtype, S, nq // nkv)
        before = (paged_attention.wgmma_launches,
                  paged_attention.decode_launches)
        if "route" in case:
            out = _paged_attention_on(case["route"], q, pool, bt, off, start,
                                      split_k=case["split_k"], **kw)
        else:
            out = paged_attention(q, pool, bt, off, start,
                                  split_k=case["split_k"], **kw)
        torch.cuda.synchronize()
        went = ("wgmma" if paged_attention.wgmma_launches > before[0] else
                "decode" if paged_attention.decode_launches > before[1] else
                "simt")
        if went != want:
            raise AssertionError(f"{case} ran the {went} kernel, not {want}")
        args = ((q, pool, bt, off, start) if int8 else
                (q.float(), tuple(p.float() for p in pool), bt, off, start))
        ref = paged_attention_reference(*args, **kw).float()
        err = (out.float() - ref).abs().max().item()
        name = str(dtype).replace("torch.", "")
        parked_zero = bool((out[PARKED] == 0).all().item())
        bites = {}
        for opt in ("window", "softcap"):
            if opt in kw:  # the output without the option, to show it bites
                without = {k: v for k, v in kw.items() if k != opt}
                bites[opt] = (paged_attention_reference(*args, **without)
                              .float() - ref)[live].abs().max().item()
        log(f"{label}: S={S} D={dd} NQ={nq} NKV={nkv} "
            f"{'int8' if int8 else name} pool, route {went}, split_k="
            f"{case['split_k']} {name} {kw or ''} max_abs_err={err:.3e} "
            f"(tol {TOL[name]}) parked_zero={parked_zero}" + "".join(
                f"; without {o} the plain output moves {v:.3e}"
                for o, v in bites.items()))
        if not err <= TOL[name]:
            raise AssertionError(f"paged_attention disagrees with its plain "
                                 f"version: {err} > {TOL[name]} in {case}")
        if not parked_zero:
            raise AssertionError(f"parked slot not exact zeros in {case}")
        for opt, v in bites.items():
            if not v > BITE * TOL[name]:
                raise AssertionError(
                    f"{opt} moves the plain output by only {v} in {case}: "
                    f"the case cannot catch a kernel that ignores it")
        worst[went, name] = max(worst.get((went, name), 0.0), err)
        del q, pool, out, ref
    return worst


# the kernel each route of paged_attention launches, as the profiler names it
PAGED_KERNELS = {"simt": "paged_attention_kernel",
                 "wgmma": "paged_attention_wgmma_kernel",
                 "decode": "paged_attention_decode_kernel"}
# every route on the same decode inputs, the routed one first
DECODE_ROUTES = ("decode", "simt", "wgmma")
# the decode kernel's split sweep; its largest cluster (DECODE_MAX_CLUSTER)
SPLIT_SWEEP = (1, 2, 4, 8)
CLUSTER_MAX = 8
# the long-chain decode: Llama-3-8B geometry at B = 8 with 512-page
# (8192-key) chains, the same ragged offsets (~4,100 keys a live slot)
LONG_PP = 512


def time_paged(S: int, int8: bool, routes, iters: int, label: str,
               chunk_offset=None, pp: int = PP, opts=None, sweep=(),
               parked: bool = False, dtype=None, **geom) -> dict:
    """Device ms per call of each route's kernel (``{route}_ms``), of the
    plain version and of the library call (gather (+ dequantize_page) +
    SDPA; ``opts``' sm_scale, and no softcap) on the same inputs (q in
    ``dtype``, default bf16) over ROTATE copies, each held to the bound
    of its work (a reading under it is taken again, :func:`check_bound`);
    the first route's time is ``ms``.  ``opts`` (sm_scale, softcap) go to
    the routes and the plain version.  Each route's output at its default
    split, and the first route's at each split of ``sweep``, is held
    against the plain version within TOL first (``errs``).
    ``sweep``: the first route's time at each of these splits
    (``split_k_ms``).  ``parked``: the first route's time with every slot
    parked (``parked_ms``: the call's fixed cost, no key read)."""
    import torch

    from neuronx_distributed_tpu_torch.ops.paged_attention import (
        _paged_attention_on,
        _sm_count,
        decode_split_k,
        default_split_k,
        paged_attention_reference,
        wgmma_split_k,
    )

    opts = opts or {}
    dtype = dtype or torch.bfloat16
    name = str(dtype).replace("torch.", "")
    q, pool, bt, off, start = paged_inputs(S, dtype, "cuda",
                                           int8=int8,
                                           chunk_offset=chunk_offset, pp=pp,
                                           **geom)
    nb, nq, nkv, d = q.shape[0], q.shape[2], pool[0].shape[2], q.shape[3]
    T, rows = pp * PAGE, nq // nkv * S
    sms = _sm_count(torch.cuda.current_device())
    splits = {"simt": default_split_k(nb, nkv, rows, T, sms),
              "wgmma": wgmma_split_k(nb, nkv, rows, T, d, sms),
              "decode": decode_split_k(nb, nkv, T, sms)}
    args = ((q, pool, bt, off, start) if int8 else
            (q.float(), tuple(p.float() for p in pool), bt, off, start))
    ref = paged_attention_reference(*args, **opts).float()
    errs = {}
    for r in routes:
        out = _paged_attention_on(r, q, pool, bt, off, start, **opts)
        torch.cuda.synchronize()
        errs[r] = (out.float() - ref).abs().max().item()
        log(f"{label}: {r} route at its default split_k {splits[r]} against "
            f"the plain version: max_abs_err={errs[r]:.3e} (tol "
            f"{TOL[name]})")
        if not errs[r] <= TOL[name]:
            raise AssertionError(f"{label}: the {r} kernel disagrees with its "
                                 f"plain version: {errs[r]}")
    # every split the sweep times does the whole work: its output is held
    # too, so a reading under the bound can only be the profiler's
    sweep_errs = {}
    for sk in sweep:
        out = _paged_attention_on(routes[0], q, pool, bt, off, start,
                                  split_k=sk, **opts)
        sweep_errs[sk] = (out.float() - ref).abs().max().item()
        if not sweep_errs[sk] <= TOL[name]:
            raise AssertionError(f"{label}: the {routes[0]} kernel at "
                                 f"split_k {sk} disagrees with its plain "
                                 f"version: {sweep_errs[sk]}")
    if sweep:
        log(f"{label}: {routes[0]} route at each swept split_k against the "
            f"plain version, max_abs_err: " + ", ".join(
                f"{sk}: {e:.3e}" for sk, e in sweep_errs.items()))
        errs[routes[0]] = max(errs[routes[0]], *sweep_errs.values())
    del out, ref, args
    copies = [(q.clone(), tuple(p.clone() for p in pool))
              for _ in range(ROTATE)]

    def over_copies(fn, *pre, **kw):
        return [lambda qc=qc, pc=pc: fn(*pre, qc, pc, bt, off, start, **kw)
                for qc, pc in copies]

    def route_ms(r, **kw):
        return lambda: device_ms(over_copies(_paged_attention_on, r, **kw,
                                             **opts),
                                 iters, expect=PAGED_KERNELS[r],
                                 launched=route_count(r))

    lib_scale = {"sm_scale": opts["sm_scale"]} if "sm_scale" in opts else {}
    timers = {f"{r}_ms": route_ms(r) for r in routes}
    timers["plain_ms"] = lambda: device_ms(
        over_copies(paged_attention_reference, **opts), 10)
    timers["library_ms"] = lambda: device_ms(
        over_copies(library_call, **lib_scale), 50)
    timers.update({f"split_k {sk}": route_ms(routes[0], split_k=sk)
                   for sk in sweep})
    b_ms, b_by = bound_ms(S, name, off.cpu(), start.cpu(), int8=int8,
                          pp=pp, **geom)
    held = check_bound(label, {k: t() for k, t in timers.items()}, b_ms,
                       retake=timers)
    split_ms = {sk: held.pop(f"split_k {sk}") for sk in sweep}
    times = held
    if parked:
        off_p = torch.full_like(off, T)

        def parked_ms():
            return device_ms(
                [lambda qc=qc, pc=pc: _paged_attention_on(
                    routes[0], qc, pc, bt, off_p, start, **opts)
                 for qc, pc in copies], iters,
                expect=PAGED_KERNELS[routes[0]],
                launched=route_count(routes[0]))

        times["parked_ms"] = check_bound(
            label + " parked", {"parked": parked_ms()},
            bound_ms(S, name, off_p.cpu(), start.cpu(), int8=int8, pp=pp,
                     **geom)[0], retake={"parked": parked_ms})["parked"]
    live = [b for b in range(q.shape[0]) if off[b] < T]
    lib_err = (library_call(q, pool, bt, off, start, **lib_scale).float()
               - paged_attention_reference(q, pool, bt, off, start,
                                           **lib_scale).float()
               )[live].abs().max().item()
    first = times[routes[0] + "_ms"]
    log(f"{label} timing (S={S} {name} q, "
        f"{'int8' if int8 else name} pool, "
        f"B={q.shape[0]} NQ={q.shape[2]} NKV={pool[0].shape[2]} "
        f"D={q.shape[3]} page={PAGE} PP={pp}{' ' + str(opts) if opts else ''}"
        f", offsets {off.tolist() if q.shape[0] == 1 else 'ragged'}), device "
        f"ms per call from torch.profiler: " + ", ".join(
            f"{k[:-3]} {v:.5f}" for k, v in times.items())
        + f" (library: gather + {'dequantize_page + ' if int8 else ''}SDPA"
        f"{', no softcap' if 'softcap' in opts else ''}; agrees to "
        f"{lib_err:.2e} without it); bound {b_ms:.5f} ({b_by}), {routes[0]} "
        f"/ bound {first / b_ms:.2f}, {routes[0]} / library "
        f"{first / times['library_ms']:.3f}" + "".join(
            f", {routes[0]} / {r} {first / times[r + '_ms']:.3f}"
            for r in routes[1:]))
    if sweep:
        log(f"{label} {routes[0]} split_k sweep, device ms per call: "
            + ", ".join(f"{sk}: {ms:.5f}" for sk, ms in split_ms.items()))
    del copies, q, pool
    return {"ms": first, **times, "bound_ms": b_ms, "bound_by": b_by,
            "errs": errs, "split_k": {r: splits[r] for r in routes},
            **({"split_k_ms": split_ms} if sweep else {})}


def decode_entries(times: dict, suffix: str, worst: dict, shapes: dict,
                   library: str, replaces: str) -> list:
    """The kernels-line entries of one decode shape, from one
    ``time_paged`` run over DECODE_ROUTES: the decode kernel's (the routed
    one) and the simt kernel's (forced, on the same inputs), each with the
    other routes' times beside its own."""
    common = {k: times[k] for k in ("plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "split_k")}
    other = {f"{r}_ms": times[f"{r}_ms"] for r in DECODE_ROUTES}
    csrc = "neuronx_distributed_tpu_torch/ops/csrc/"
    return [
        {"name": f"paged_attention_decode{suffix}", "route": "cuda",
         "source": csrc + "paged_attention_decode.cuh",
         "replaces": replaces, "launches": None,
         "max_abs_err": max(worst.get(("decode", "bfloat16"), 0.0),
                            times["errs"]["decode"]),
         "ms": times["decode_ms"], **other, **common,
         "split_k_ms": times.get("split_k_ms"),
         "parked_ms": times.get("parked_ms"), "library_call": library,
         "shapes": shapes},
        {"name": f"paged_attention{suffix}", "route": "cuda",
         "source": csrc + "paged_attention.cu",
         "replaces": replaces, "launches": None,
         "path": "fp32 q and G > 8 only since the decode route: the served "
                 "bf16 runs launch it 0 times",
         "max_abs_err": max(worst.get(("simt", "bfloat16"), 0.0),
                            times["errs"]["simt"]),
         "max_abs_err_fp32": worst.get(("simt", "float32"), 0.0),
         "ms": times["simt_ms"], **other, **common, "library_call": library,
         "shapes": shapes}]


def phase1():
    """The fp-pool decode holds at Llama-3-8B's geometry (bf16 q on the
    decode kernel at split 1, 4, the default and the largest cluster, and
    past a cluster; fp32 q on the simt kernel; the simt kernel's bf16 code
    forced at S = 1 and 4), then all three routes timed on the same decode
    inputs with the decode kernel's split sweep."""
    import torch

    bf16, fp32 = torch.bfloat16, torch.float32
    cases = [dict(S=S, split_k=sk, dtype=dt)
             for dt in (bf16, fp32) for S in (1, 4) for sk in (1, 4)]
    cases += [dict(S=1, split_k=None, dtype=dt, window=256)
              for dt in (bf16, fp32)]
    cases += [dict(S=1, split_k=None, dtype=dt, softcap=50.0,
                   sm_scale=SOFTCAP_SCALE) for dt in (bf16, fp32)]
    cases += [dict(S=1, split_k=sk, dtype=bf16)
              for sk in (None, CLUSTER_MAX, CLUSTER_MAX + 3)]
    # the simt kernel's bf16 code, which the rule no longer picks
    cases += [dict(S=S, split_k=sk, dtype=bf16, route="simt")
              for S in (1, 4) for sk in (1, 4)]
    worst = hold_paged_cases(cases, "phase1")
    times = time_paged(1, False, DECODE_ROUTES, 200, "phase1 decode",
                       sweep=SPLIT_SWEEP, parked=True)
    dec, simt = decode_entries(
        times, "", worst,
        {"q": [B, 1, NQ, D], "pool": [B * PP + 1, PAGE, NKV, D],
         "block_table": [B, PP], "dtype": "bfloat16"},
        "gather + F.scaled_dot_product_attention",
        "neuronx_distributed_tpu/ops/paged_attention.py:164")
    # fp32 q and pool, the simt kernel's own route, at the same shape
    fp32 = time_paged(1, False, ("simt",), 200, "phase1 fp32 decode",
                      dtype=torch.float32)
    simt["fp32_q"] = {k: fp32[k] for k in ("ms", "plain_ms", "library_ms",
                                           "bound_ms", "bound_by")}
    return dec, simt


def phase1_int8():
    """The int8 pools against the plain version (which dequantizes the
    gathered pages to q's type, as the kernels do): bf16 q at D
    64/128/256 and fp32 q at D 128, S 1/4/128 (bf16 q takes the decode
    route at S = 1 and the wgmma route at S > 1 by the rule, and is held
    on the simt route as well at D 128), split-K 1 and the default (and at S = 1 the largest cluster), a
    parked slot and a constant page in every case, plus a window and a
    softcap case.  All three routes timed at the decode shape."""
    import torch

    bf16, fp32 = torch.bfloat16, torch.float32
    # fp32 q (the simt kernel's own route) at the served head dim only,
    # to make room for phase 2i; the card tests hold it at every dim
    cases = [dict(S=S, d=d, split_k=sk, dtype=dt, int8=True)
             for dt, dims in ((bf16, INT8_DIMS), (fp32, (D,)))
             for d in dims for S in INT8_WIDTHS for sk in (1, None)]
    cases += [dict(S=1, d=d, split_k=CLUSTER_MAX, dtype=bf16, int8=True)
              for d in INT8_DIMS]
    cases += [dict(S=1, d=D, split_k=None, dtype=dt, int8=True, window=256)
              for dt in (bf16, fp32)]
    cases += [dict(S=1, d=D, split_k=None, dtype=dt, int8=True, softcap=50.0,
                   sm_scale=SOFTCAP_SCALE) for dt in (bf16, fp32)]
    # the simt kernel's forced bf16 code at the served head dim only (the
    # rule never routes bf16 q there; its fp32 code holds every dim above)
    cases += [dict(S=S, d=D, split_k=sk, dtype=bf16, int8=True, route="simt")
              for S in INT8_WIDTHS for sk in (1, None)]
    worst = hold_paged_cases(cases, "phase1 int8")
    times = time_paged(1, True, DECODE_ROUTES, 200, "phase1 int8 decode",
                       sweep=SPLIT_SWEEP, parked=True)
    return decode_entries(
        times, "_int8", worst,
        {"q": [B, 1, NQ, D], "pool": [B * PP + 1, PAGE, NKV, D],
         "pool_dtype": "int8", "block_table": [B, PP], "dtype": "bfloat16"},
        "gather + kvcache.quant.dequantize_page + "
        "F.scaled_dot_product_attention",
        "neuronx_distributed_tpu/ops/paged_attention.py:211")


def phase1_long():
    """The long-chain decode (LONG_PP pages of PAGE keys, B = 8, Llama-3-8B
    geometry, ragged offsets), bf16 and int8 pools: all three routes held
    and timed on the same inputs, the decode kernel's split sweep."""
    entries = {}
    for int8 in (False, True):
        kind = "int8" if int8 else "bf16"
        times = time_paged(1, int8, DECODE_ROUTES, 100,
                           f"phase1 long {kind} decode", pp=LONG_PP,
                           sweep=SPLIT_SWEEP)
        entries[kind] = decode_entries(
            times, f"_long_{kind}", {},
            {"q": [B, 1, NQ, D], "pool": [B * LONG_PP + 1, PAGE, NKV, D],
             "pool_dtype": "int8" if int8 else "bfloat16",
             "block_table": [B, LONG_PP], "dtype": "bfloat16"},
            "gather + " + ("kvcache.quant.dequantize_page + " if int8 else "")
            + "F.scaled_dot_product_attention",
            "neuronx_distributed_tpu/ops/paged_attention.py:"
            + ("211" if int8 else "164"))[0]
    return entries


# the main path's chunk call: one slot, a 128-token chunk at offset 384 (the
# last chunk of a 512-token prompt), kv_start 0
CHUNK_OFFSET = 384
# the route sweep, at the chunk call's offset: query widths at Llama-3-8B's
# 32 q on 8 kv heads (G = 4), and at 8 q on 8 kv heads (G = 1), where the
# fewest query rows share a kv head (6 widths: the time limit pays for
# phase 7)
SWEEP_WIDTHS = {NQ: (2, 4, 16, 128), NKV: (2, 16)}


def phase1_chunks():
    """The multi-row route (paged_attention_wgmma_kernel, bf16 q): held
    against the plain version over bf16 and int8 pools at the served head
    dims 128 and 256, S 16/32/128, split-K 1 and the default, a parked slot, a constant int8
    page, a window and a softcap; timed against the simt kernel on the
    same inputs at the main path's chunk call (B = 1, S = 128, offset
    384) and at phase 1's B = 8, S = 128 shape, each route's output at
    its default split held against the plain version there; then both
    routes swept over SWEEP_WIDTHS at the chunk call's offset (the
    routing rule), the narrowest widths held first."""
    import torch

    from neuronx_distributed_tpu_torch.ops.paged_attention import (
        _paged_attention_on,
        paged_route,
    )

    bf16 = torch.bfloat16
    w = dict(dtype=bf16, route="wgmma")
    # the served head dims (Llama's 128, Gemma-2's 256); the card tests
    # hold D 64 too
    dims = (D, G2_D)
    cases = [dict(S=S, d=d, split_k=sk, int8=i8, **w) for i8 in (False, True)
             for d in dims for S in (16, 128) for sk in (1, None)]
    cases += [dict(S=32, split_k=None, int8=i8, **w) for i8 in (False, True)]
    cases += [dict(S=128, split_k=None, int8=i8, window=256, **w)
              for i8 in (False, True)]
    cases += [dict(S=128, split_k=None, int8=i8, softcap=50.0,
                   sm_scale=SOFTCAP_SCALE, **w) for i8 in (False, True)]
    narrow = [dict(S=S, d=d, split_k=None, int8=i8, **w)
              for i8 in (False, True) for d in dims for S in (2, 3)]
    worst = max(held[("wgmma", "bfloat16")] for held in (
        hold_paged_cases(cases, "phase1 wgmma"),
        hold_paged_cases(narrow, "phase1 wgmma"),
        hold_paged_cases([c for c in narrow if c["d"] == D],
                         "phase1 wgmma G=1", nq=NKV, nkv=NKV)))

    rows = {}
    for key, i8, off in (("chunk_int8", True, CHUNK_OFFSET),
                         ("chunk_bf16", False, CHUNK_OFFSET),
                         ("s128_int8", True, None),
                         ("s128_bf16", False, None)):
        rows[key] = time_paged(128, i8, ("wgmma", "simt"), 50,
                               f"phase1 {key}", chunk_offset=off)
    sweep = {}
    for nq, widths in SWEEP_WIDTHS.items():
        for i8 in (True, False):
            for S in widths:
                q, pool, bt, off, start = paged_inputs(
                    S, bf16, "cuda", int8=i8, nq=nq,
                    chunk_offset=CHUNK_OFFSET)
                copies = [(q.clone(), tuple(p.clone() for p in pool))
                          for _ in range(ROTATE)]
                G = nq // NKV
                sweep[f"{'int8' if i8 else 'bf16'} G={G} S={S}"] = {
                    "rows": G * S, "rule": paged_route(bf16, S, G), **{
                        r: device_ms([
                            lambda qc=qc, pc=pc, r=r: _paged_attention_on(
                                r, qc, pc, bt, off, start)
                            for qc, pc in copies], 100,
                            expect=PAGED_KERNELS[r], launched=route_count(r))
                        for r in ("simt", "wgmma")}}
                del copies, q, pool
    log(f"phase1 route sweep (B=1, offset {CHUNK_OFFSET}, NKV={NKV}, D={D}),"
        f" device ms per call simt / wgmma, and the route paged_route picks: "
        + "; ".join(f"{k} (G*S={v['rows']}): {v['simt']:.5f} / "
                    f"{v['wgmma']:.5f} -> {v['rule']}"
                    for k, v in sweep.items()))
    slower = {k: v for k, v in sweep.items()
              if v[v["rule"]] > min(v["simt"], v["wgmma"])}
    if slower:
        log(f"phase1 route sweep: the rule picks the slower kernel at "
            f"{list(slower)}")
    main = rows["chunk_int8"]
    errs = [r["errs"]["wgmma"] for r in rows.values()]
    return {
        "name": "paged_attention_wgmma",
        "route": "cuda",
        "source": ("neuronx_distributed_tpu_torch/ops/csrc/"
                   "paged_attention_wgmma.cuh"),
        "replaces": "neuronx_distributed_tpu/ops/paged_attention.py:164",
        "launches": None,
        **main,
        "max_abs_err": max(worst, *errs),
        "library_call": ("gather + kvcache.quant.dequantize_page + "
                         "F.scaled_dot_product_attention"),
        **{k: v for k, v in rows.items() if k != "chunk_int8"},
        "route_sweep_ms": sweep,
        "shapes": {"q": [1, 128, NQ, D], "pool": [PP + 1, PAGE, NKV, D],
                   "pool_dtype": "int8", "block_table": [1, PP],
                   "cache_offset": CHUNK_OFFSET, "dtype": "bfloat16"},
    }


# the speculative verify call: the served engine's 8 slots, spec_k 4
VERIFY_S = 5


def phase1_verify():
    """The verify call of speculative serving (B = 8, S = k + 1 = 5, 32 q on
    8 kv heads, D 128, PP 64, page 16; bf16 q, so the wgmma route): held
    against the plain version at 2e-2 over bf16 and int8 pools at split 1
    and the default, then the wgmma kernel timed against the simt kernel,
    the plain version and gather + SDPA on the same inputs, bf16 pool
    first."""
    import torch

    cases = [dict(S=VERIFY_S, split_k=sk, dtype=torch.bfloat16, int8=i8)
             for i8 in (False, True) for sk in (1, None)]
    worst = hold_paged_cases(cases, "phase1 verify")
    rows = {kind: time_paged(VERIFY_S, kind == "int8", ("wgmma", "simt"),
                             100, f"phase1 verify {kind}")
            for kind in ("bf16", "int8")}
    main = rows["bf16"]
    return {
        "name": "paged_attention_wgmma_verify", "route": "cuda",
        "source": ("neuronx_distributed_tpu_torch/ops/csrc/"
                   "paged_attention_wgmma.cuh"),
        "replaces": "neuronx_distributed_tpu/ops/paged_attention.py:164",
        "launches": None,
        **{k: main[k] for k in ("ms", "wgmma_ms", "simt_ms", "plain_ms",
                                "bound_ms", "bound_by", "library_ms",
                                "split_k")},
        "max_abs_err": max(worst[("wgmma", "bfloat16")],
                           *(r["errs"]["wgmma"] for r in rows.values())),
        "int8": {k: rows["int8"][k] for k in (
            "ms", "simt_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
        "library_call": "gather (+ kvcache.quant.dequantize_page) + "
                        "F.scaled_dot_product_attention",
        "shapes": {"q": [B, VERIFY_S, NQ, D],
                   "pool": [B * PP + 1, PAGE, NKV, D],
                   "block_table": [B, PP], "dtype": "bfloat16"},
    }


# Gemma-2-2B decode attention: 8 q heads on 4 kv heads at head_dim 256,
# score scale 256^-0.5, attention softcap 50
G2_NQ, G2_NKV, G2_D, G2_SCALE, G2_CAP = 8, 4, 256, 256.0 ** -0.5, 50.0


def phase1_gemma():
    """The fp-pool kernels at head_dim 256 and the Gemma-2-2B geometry
    (bf16 q on the decode kernel at S = 1 and the wgmma kernel at S = 4,
    fp32 q on the simt kernel): bf16 and fp32 q and pool, S 1 and 4,
    split-K 1 and the default (and the largest cluster at S = 1), the
    softcap 50 in every case (at SOFTCAP_SCALE, where it moves the output;
    at Gemma-2's own 1/16 it hardly does).  All three routes timed at the
    decode shape with Gemma-2's scale and cap; the library call (gather +
    SDPA) has no softcap."""
    import torch

    geom = dict(d=G2_D, nq=G2_NQ, nkv=G2_NKV)
    cap = dict(softcap=G2_CAP, sm_scale=SOFTCAP_SCALE)
    cases = [dict(S=S, split_k=sk, dtype=dt, **cap)
             for dt in (torch.bfloat16, torch.float32) for S in (1, 4)
             for sk in (1, None)]
    cases += [dict(S=1, split_k=CLUSTER_MAX, dtype=torch.bfloat16, **cap),
              dict(S=1, split_k=None, dtype=torch.bfloat16, route="simt",
                   **cap)]
    worst = hold_paged_cases(cases, "phase1 gemma2", **geom)
    times = time_paged(1, False, DECODE_ROUTES, 200, "phase1 gemma2 decode",
                       opts=dict(sm_scale=G2_SCALE, softcap=G2_CAP),
                       sweep=SPLIT_SWEEP, parked=True, **geom)
    return decode_entries(
        times, "_d256", worst,
        {"q": [B, 1, G2_NQ, G2_D], "pool": [B * PP + 1, PAGE, G2_NKV, G2_D],
         "block_table": [B, PP], "dtype": "bfloat16", "softcap": G2_CAP},
        "gather + F.scaled_dot_product_attention (no softcap)",
        "neuronx_distributed_tpu/ops/paged_attention.py:164")


# -- phase 2 ------------------------------------------------------------------


def make_requests(vocab: int, n: int, new_tokens: int, seed: int,
                  adapters: int = 0):
    """``n`` greedy requests of 32 to CONTEXT prompt tokens from ``seed``;
    request ``i`` names adapter ``i % (adapters + 1)`` (0, the base model,
    when ``adapters`` is 0)."""
    import numpy as np

    from neuronx_distributed_tpu_torch.serving import Request

    rs = np.random.RandomState(seed)
    return [Request(request_id=i,
                    prompt_ids=rs.randint(1, vocab,
                                          size=rs.randint(32, CONTEXT + 1)
                                          ).tolist(),
                    max_new_tokens=new_tokens,
                    adapter_id=i % (adapters + 1)) for i in range(n)]


def serve(engine, requests):
    """Staggered arrivals: half the requests up front, then one more per
    engine step, so slots and pages are reused."""
    outs = {}
    half = len(requests) // 2
    for r in requests[:half]:
        engine.submit(r)
    for r in requests[half:]:
        for o in engine.step():
            outs[o.request_id] = o
        engine.submit(r)
    for o in engine.run_until_complete(max_steps=10_000):
        outs[o.request_id] = o
    return outs


def steady_decode_profile(model_pim, vocab: int, steps: int = 5,
                          label: str = "phase2", adapters: int = 0,
                          **engine_kw) -> dict:
    """Where a steady decode step's time goes: the host clock over
    ``steps`` engine steps with all slots decoding (no admissions), then
    the same steps under ``torch.profiler``: the device's busy share and
    the share spent in the paged-attention kernels.  ``engine_kw`` goes to
    the engine (``kv_quant="int8"``: the int8 pool; ``adapter_store``),
    ``adapters`` to :func:`make_requests`."""
    import torch

    from neuronx_distributed_tpu_torch import ServingEngine

    eng = ServingEngine(model_pim, page_size=PAGE_SIZE, **engine_kw)
    for r in make_requests(vocab, SLOTS, 3 * steps + 4, SEED + 3, adapters):
        eng.submit(r)
    for _ in range(2):
        eng.step()  # admissions and a warm decode
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    prof_wall = []

    def run():
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        prof_wall.append(time.perf_counter() - t0)

    # device-side rows only (kernels, copies): CPU-op rows repeat their time
    events = trace(run, eng.step)
    prof_ms = prof_wall[0] / steps * 1e3

    busy_ms = sum(dev_us(e) for e in events) / 1e3 / steps
    attn_ms = sum(dev_us(e) for e in events
                  if "paged_attention" in e.key or "merge_splits" in e.key
                  ) / 1e3 / steps
    top = sorted(events, key=dev_us, reverse=True)[:6]
    log(f"{label} steady decode (B={SLOTS}, all slots decoding): "
        f"{step_ms:.2f} ms/step host clock = {SLOTS * 1e3 / step_ms:.1f} "
        f"decode tokens/s; under the profiler "
        f"{prof_ms:.2f} ms/step with device busy {busy_ms:.3f} ms/step "
        f"({busy_ms / prof_ms:.1%}), paged attention {attn_ms:.3f} ms/step")
    log(f"{label} top device time per step: " + "; ".join(
        f"{e.key[:60]} {dev_us(e) / 1e3 / steps:.3f} ms" for e in top))
    if busy_ms <= 0:
        log(f"{label}: the profiler saw no device time (busy share not "
            "measured)")
    return {"steady_step_ms": step_ms,
            "decode_tok_s": SLOTS * 1e3 / step_ms, "profiled_step_ms": prof_ms,
            "device_busy_ms": busy_ms, "paged_attention_ms": attn_ms}


def zero_paged_counts() -> None:
    """Every launch count of the paged-attention wrapper set to 0."""
    from neuronx_distributed_tpu_torch.ops.paged_attention import paged_attention

    for count in ("launches", "int8_launches", "wgmma_launches",
                  "decode_launches"):
        setattr(paged_attention, count, 0)


def route_count(route: str):
    """A callable reading the paged-attention wrapper's launch count of one
    route (the ``launched`` of :func:`device_ms`)."""
    from neuronx_distributed_tpu_torch.ops.paged_attention import paged_attention

    def count() -> int:
        pa = paged_attention
        return {"wgmma": pa.wgmma_launches, "decode": pa.decode_launches,
                "simt": pa.launches - pa.wgmma_launches
                - pa.decode_launches}[route]
    return count


def check_routes(label: str, decode: int, chunk: int) -> dict:
    """The launches since :func:`zero_paged_counts` by route: every decode
    call (``decode`` of them) on the decode kernel, every chunk call
    (``chunk``) on the wgmma kernel, none on the simt kernel.  Returns
    ``{route: launches}``."""
    from neuronx_distributed_tpu_torch.ops.paged_attention import paged_attention

    pa = paged_attention
    routes = {"decode": pa.decode_launches, "wgmma": pa.wgmma_launches,
              "simt": pa.launches - pa.decode_launches - pa.wgmma_launches}
    if routes != {"decode": decode, "wgmma": chunk, "simt": 0}:
        raise AssertionError(
            f"{label}: paged_attention launches by route {routes}, expected "
            f"decode {decode} (decode steps x layers), wgmma {chunk} (chunks "
            f"x layers), simt 0")
    return routes


def set_launches(entries, routes: dict, phase: str) -> None:
    """One main-path run's launch counts into kernels-line entries: each
    decode-route entry gets the decode kernel's, each simt entry the simt
    kernel's, each wgmma entry the wgmma kernel's, under ``phase`` in
    ``launches_by_phase``; ``launches`` keeps the first path's count."""
    for e in entries:
        route = ("decode" if "decode" in e["name"] else
                 "wgmma" if "wgmma" in e["name"] else "simt")
        e.setdefault("launches_by_phase", {})[phase] = routes[route]
        if e["launches"] is None:
            e["launches"] = routes[route]


def phase2(entries):
    import torch

    from neuronx_distributed_tpu_torch import (
        InferenceConfig,
        LlamaConfig,
        LlamaForCausalLM,
        ParallelInferenceModel,
        ServingEngine,
    )
    from neuronx_distributed_tpu_torch.ops.paged_attention import paged_attention

    cfg = LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda").init_random(SEED)
    n_params = sum(p.numel() for p in model.parameters())
    # phase 2 is the eager, synchronous reference (phase 2c: graphs, async)
    model_pim = ParallelInferenceModel(
        model, InferenceConfig(SLOTS, CONTEXT, MAX_TOTAL, torch.bfloat16),
        cuda_graphs=False)
    if not model_pim.paged_kernel:
        raise AssertionError("paged_kernel did not resolve to the kernel")
    torch.cuda.synchronize()
    log(f"phase2: Llama-3-8B {cfg.num_layers} layers, vocab "
        f"{cfg.vocab_size}, {n_params / 1e9:.2f}B params bf16, random init "
        f"in {time.perf_counter() - t0:.1f} s")

    engine = ServingEngine(model_pim, page_size=PAGE_SIZE, async_decode=False)
    log(f"phase2: pool {engine._kv.alloc.num_pages} pages x {PAGE_SIZE} "
        f"tokens")
    requests = make_requests(cfg.vocab_size, N_REQUESTS, NEW_TOKENS, SEED)
    torch.cuda.reset_peak_memory_stats()
    zero_paged_counts()
    t0 = time.perf_counter()
    outs = serve(engine, requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = paged_attention.launches
    steps = engine.decode_steps
    peak = torch.cuda.max_memory_allocated()
    tokens = sum(len(o.token_ids) for o in outs.values())
    bad = [(o.request_id, o.state, len(o.token_ids)) for o in outs.values()
           if o.state != "finished" or len(o.token_ids) != NEW_TOKENS]
    if len(outs) != N_REQUESTS or bad:
        raise AssertionError(f"requests not served in full: {bad}, "
                             f"{len(outs)}/{N_REQUESTS} outputs")
    routes = check_routes("phase2", steps * cfg.num_layers, 0)
    engine._kv.assert_invariants()
    leaks = engine._kv.leaked_pages()
    if leaks:
        raise AssertionError(f"{leaks} KV pages leaked")
    decode_tokens = tokens - N_REQUESTS  # each request's first token is prefill's
    log(f"phase2: served {N_REQUESTS} requests, {tokens} tokens in "
        f"{wall:.3f} s ({tokens / wall:.1f} tok/s overall, {decode_tokens} "
        f"decode tokens over {steps} batched decode steps, "
        f"{wall / steps * 1e3:.2f} ms/step incl. admissions); kernel "
        f"launches {launches} = {steps} x {cfg.num_layers}, by route "
        f"{routes}; page leaks 0; peak memory {peak / 2**30:.2f} GiB")
    set_launches(entries, routes, "2")

    # one decode step at full width: the kernel path vs the gather path
    eng = ServingEngine(model_pim, page_size=PAGE_SIZE)
    for r in make_requests(cfg.vocab_size, SLOTS, 8, SEED + 1):
        eng.submit(r)
    eng.step()  # admits and prefills every slot, then decodes once
    logits = {}
    for pk in (True, False):
        caches = [(k.clone(), v.clone()) for k, v in eng.caches]
        lg, _, _ = model_pim.decode_pages(
            eng._next_tok[:, None], eng._offsets, eng._kv.tables, caches,
            eng.valid.clone(), paged_kernel=pk)
        logits[pk] = lg.float()
        del caches
    diff = logits[True] - logits[False]
    rel = (diff.norm() / logits[False].norm()).item()
    agree = (logits[True].argmax(-1) == logits[False].argmax(-1)
             ).float().mean().item()
    log(f"phase2: kernel vs gather logits, one decode step at full width: "
        f"rel L2 {rel:.3e} (tol {LOGITS_REL_TOL}), max abs "
        f"{diff.abs().max().item():.3e} of max |logit| "
        f"{logits[False].abs().max().item():.3e}, argmax agreement {agree:.3f}")
    if not rel <= LOGITS_REL_TOL or not torch.isfinite(logits[True]).all():
        raise AssertionError(f"kernel and gather logits disagree: rel {rel}")

    # greedy token agreement between the two paths over a short run
    runs = {}
    for pk in (True, False):
        e = ServingEngine(model_pim, page_size=PAGE_SIZE, paged_kernel=pk)
        runs[pk] = serve(e, make_requests(cfg.vocab_size, SLOTS, 16,
                                          SEED + 2))
    same = total = 0
    for rid, o in runs[True].items():
        a, b = o.token_ids, runs[False][rid].token_ids
        same += sum(x == y for x, y in zip(a, b))
        total += max(len(a), len(b))
    log(f"phase2: greedy token agreement kernel vs gather over {SLOTS} "
        f"requests x 16 tokens: {same}/{total} = {same / total:.3f}")
    busy = steady_decode_profile(model_pim, cfg.vocab_size,
                                 async_decode=False)
    summary = {**busy, "wall_s": wall, "tokens": tokens,
               "tok_s": tokens / wall, "decode_steps": steps,
               "ms_per_step": wall / steps * 1e3, "launches": launches,
               "launches_by_route": routes,
               "peak_gib": peak / 2**30, "logits_rel_l2": rel,
               "token_agreement": same / total}
    return summary, model_pim, {rid: o.token_ids for rid, o in outs.items()}


# -- phase 2b -----------------------------------------------------------------


def pool_bytes(model_pim, num_pages: int, quant) -> int:
    """Device bytes a page pool takes, from the allocator."""
    import torch

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    pool = model_pim.make_page_pool(num_pages, PAGE_SIZE, quant=quant)
    torch.cuda.synchronize()
    n = torch.cuda.memory_allocated() - before
    del pool
    return n


def admitted_engine(model_pim, vocab: int, seed: int = SEED + 1, **kw):
    """An engine whose 8 slots hold freshly prefilled requests (from
    ``seed``) and has not decoded yet (the engine's admission, without
    ``step()``'s decode)."""
    from neuronx_distributed_tpu_torch import ServingEngine

    eng = ServingEngine(model_pim, page_size=PAGE_SIZE, prefix_cache=False,
                        **kw)
    for r in make_requests(vocab, SLOTS, 8, seed):
        eng.submit(r)
    for slot, req in eng.scheduler.admit(eng._clock()):
        eng._prefill_into_slot(slot, req, [])
    return eng


def decode_logits(model_pim, eng, paged_kernel: bool, tokens=None):
    """The engine's next decode step's logits over a copy of its pool, on
    its own next tokens or on ``tokens`` (``[B]`` int64, numpy)."""
    caches = [tuple(t.clone() for t in entry) for entry in eng.caches]
    tok = eng._next_tok if tokens is None else tokens
    lg, _, _ = model_pim.decode_pages(
        tok[:, None], eng._offsets, eng._kv.tables, caches,
        eng.valid.clone(), paged_kernel=paged_kernel)
    return lg.float()


def compare_logits(a, b) -> tuple:
    """Relative L2 of ``a - b`` and the share of rows whose argmax
    agrees."""
    rel = ((a - b).norm() / b.norm()).item()
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    return rel, agree


def phase2b(model_pim, entries, whole_tokens):
    """Serving with int8 KV pages and chunked prefill on phase 2's model:
    the slice-3 main path (every decode step of every layer on the decode
    kernel, every chunk on the wgmma kernel, none on the simt kernel), then
    its checks."""
    import torch

    from neuronx_distributed_tpu_torch import ServingEngine
    from neuronx_distributed_tpu_torch.ops import flash_attention as fa
    from neuronx_distributed_tpu_torch.ops.paged_attention import paged_attention

    cfg = model_pim.module.config
    L = cfg.num_layers
    num_pages = SLOTS * (MAX_TOTAL // PAGE_SIZE) + 1
    fp_bytes = pool_bytes(model_pim, num_pages, None)
    q_bytes = pool_bytes(model_pim, num_pages, "int8")
    ratio = q_bytes / fp_bytes
    log(f"phase2b: pool of {num_pages} pages x {PAGE_SIZE} tokens x {L} "
        f"layers from torch.cuda allocation: bf16 {fp_bytes / 2**20:.2f} "
        f"MiB, int8 {q_bytes / 2**20:.2f} MiB, ratio {ratio:.5f} (limit "
        f"{INT8_POOL_RATIO_MAX})")
    if not ratio <= INT8_POOL_RATIO_MAX:
        raise AssertionError(f"int8 pool takes {ratio} of the bf16 pool")

    # the main path: every launch count from 0 over the served run
    engine = ServingEngine(model_pim, page_size=PAGE_SIZE, kv_quant="int8",
                           prefill_chunk_tokens=CHUNK_TOKENS,
                           async_decode=False)
    for fn in (fa.flash_attention_fwd, fa.flash_attention_dq,
               fa.flash_attention_dkv):
        fn.launches = 0
    zero_paged_counts()
    t0 = time.perf_counter()
    outs = serve(engine, make_requests(cfg.vocab_size, N_REQUESTS,
                                       NEW_TOKENS, SEED))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, int8_launches, wgmma_launches = (
        paged_attention.launches, paged_attention.int8_launches,
        paged_attention.wgmma_launches)
    steps, chunks = engine.decode_steps, engine.prefill_chunks
    tokens = sum(len(o.token_ids) for o in outs.values())
    bad = [(o.request_id, o.state, len(o.token_ids)) for o in outs.values()
           if o.state != "finished" or len(o.token_ids) != NEW_TOKENS]
    if len(outs) != N_REQUESTS or bad:
        raise AssertionError(f"int8 requests not served in full: {bad}, "
                             f"{len(outs)}/{N_REQUESTS} outputs")
    if not launches == int8_launches == (steps + chunks) * L:
        raise AssertionError(
            f"paged_attention launches {launches} (int8 {int8_launches}) != "
            f"(decode steps {steps} + chunks {chunks}) x {L} layers")
    routes = check_routes("phase2b", steps * L, chunks * L)
    if chunks != sum(o.prefill_chunks for o in outs.values()):
        raise AssertionError("chunk dispatches disagree with the requests'")
    if not engine.quant_pages > 0:
        raise AssertionError("no page went through a quantize-on-write")
    engine._kv.assert_invariants()
    leaks = engine._kv.leaked_pages()
    if leaks:
        raise AssertionError(f"{leaks} KV pages leaked")
    same = sum(a == b for rid, o in outs.items()
               for a, b in zip(o.token_ids, whole_tokens[rid]))
    log(f"phase2b: int8 pages, {CHUNK_TOKENS}-token chunks: served "
        f"{N_REQUESTS} requests, {tokens} tokens in {wall:.3f} s "
        f"({tokens / wall:.1f} tok/s overall, {steps} decode steps + "
        f"{chunks} chunk dispatches, {wall / (steps + chunks) * 1e3:.2f} ms "
        f"per forward); kernel launches {launches} = ({steps} + {chunks}) "
        f"x {L}, all int8, {wgmma_launches} = {chunks} x {L} of them (every "
        f"chunk) on the wgmma kernel, by route {routes}; "
        f"{engine.quant_pages} pages quantized "
        f"on write; "
        f"page leaks 0; greedy tokens equal to phase 2's bf16 whole-prefill "
        f"run {same}/{tokens}")
    set_launches(entries, routes, "2b")
    quant_pages = engine.quant_pages
    int8_tokens = {rid: o.token_ids for rid, o in outs.items()}
    del engine

    # one full-width decode step on the int8 pool, kernel vs gather; and
    # the int8 pool against the bf16 pool after the same prefill
    eng8 = admitted_engine(model_pim, cfg.vocab_size, kv_quant="int8")
    lg_k = decode_logits(model_pim, eng8, True)
    lg_g = decode_logits(model_pim, eng8, False)
    del eng8
    rel, agree = compare_logits(lg_k, lg_g)
    log(f"phase2b: int8 pool, kernel vs gather logits, one decode step at "
        f"full width: rel L2 {rel:.3e} (tol {LOGITS_REL_TOL}), argmax "
        f"agreement {agree:.3f}")
    if not rel <= LOGITS_REL_TOL or not torch.isfinite(lg_k).all():
        raise AssertionError(f"int8 kernel and gather logits disagree: {rel}")
    eng16 = admitted_engine(model_pim, cfg.vocab_size)
    lg_b = decode_logits(model_pim, eng16, True)
    del eng16
    drift, drift_agree = compare_logits(lg_k, lg_b)
    log(f"phase2b: int8 vs bf16 pool logits after the same prefill, one "
        f"decode step: rel L2 {drift:.3e} (must be > 0 and <= "
        f"{INT8_DRIFT_REL_MAX}), max abs "
        f"{(lg_k - lg_b).abs().max().item():.3e} of max |logit| "
        f"{lg_b.abs().max().item():.3e}, argmax agreement "
        f"{drift_agree:.3f}")
    if not 0.0 < drift <= INT8_DRIFT_REL_MAX:
        raise AssertionError(f"int8 logit drift {drift} outside "
                             f"(0, {INT8_DRIFT_REL_MAX}]")

    # chunked prefill over the bf16 pool against phase 2's whole prefill
    zero_paged_counts()
    eng = ServingEngine(model_pim, page_size=PAGE_SIZE,
                        prefill_chunk_tokens=CHUNK_TOKENS)
    t0 = time.perf_counter()
    chunked = serve(eng, make_requests(cfg.vocab_size, N_REQUESTS,
                                       NEW_TOKENS, SEED))
    torch.cuda.synchronize()
    fp_wall = time.perf_counter() - t0
    fp_routes = check_routes("phase2b bf16 chunked", eng.decode_steps * L,
                             eng.prefill_chunks * L)
    if any(o.state != "finished" for o in chunked.values()):
        raise AssertionError("bf16 chunked run did not finish")
    fp_same = sum(a == b for rid, o in chunked.items()
                  for a, b in zip(o.token_ids, whole_tokens[rid]))
    first_same = sum(o.token_ids[0] == whole_tokens[rid][0]
                     for rid, o in chunked.items())
    log(f"phase2b: bf16 pool with {CHUNK_TOKENS}-token chunks vs phase 2's "
        f"whole prefill: greedy tokens equal {fp_same}/{tokens}, first "
        f"tokens {first_same}/{N_REQUESTS} ({eng.prefill_chunks} chunk "
        f"dispatches, {eng.decode_steps} decode steps, launches by route "
        f"{fp_routes}, served in {fp_wall:.3f} s)")
    del eng
    busy = steady_decode_profile(model_pim, cfg.vocab_size, label="phase2b",
                                 kv_quant="int8", async_decode=False)
    return {**busy, "wall_s": wall, "tokens": tokens, "tok_s": tokens / wall,
            "decode_steps": steps, "chunk_dispatches": chunks,
            "launches": launches, "wgmma_launches": wgmma_launches,
            "launches_by_route": routes,
            "quant_pages": quant_pages,
            "pool_ratio": ratio, "int8_kernel_vs_gather_rel_l2": rel,
            "int8_kernel_vs_gather_argmax": agree,
            "int8_vs_bf16_rel_l2": drift, "int8_vs_bf16_argmax": drift_agree,
            "int8_tokens_equal_bf16_whole": same,
            "bf16_chunked_tokens_equal_whole": fp_same,
            "bf16_chunked_wall_s": fp_wall}, int8_tokens


# -- phase 2c -----------------------------------------------------------------

# speculative decoding: proposals a round; the weak draft's depth and seed
SPEC_K, WEAK_LAYERS, WEAK_SEED = 4, 2, 1
# sampled requests of (d): slots' worth, temperature, new tokens
SAMPLED_TEMP, SAMPLED_NEW = 0.8, 32
# (d): the least acceptance of the greedy self draft.  On the CPU in fp32
# it is exactly 1.0 (tests/test_torch_spec_serving.py); on the card the
# draft's S = 1 dense path over its own bf16 caches and the verify's S = 5
# paged path round differently, so near-ties reject (about one proposal
# in ten on an H100 with phase 2's random weights).  A broken accept or a
# misaligned draft gives ~0, as the weak draft does.
SELF_ACCEPT_MIN = 0.5


def graphed_pim(model_pim):
    """A second serving wrapper over the same module with CUDA graphs on
    (the default on the card)."""
    from neuronx_distributed_tpu_torch import ParallelInferenceModel

    pim = ParallelInferenceModel(model_pim.module, model_pim.config)
    if not pim.cuda_graphs:
        raise AssertionError("cuda_graphs did not resolve to on")
    return pim


def serve_checked(label, engine, requests, want_tokens=None) -> tuple:
    """Serve ``requests`` (staggered), check every one finished in full and
    the pages came back; ``want_tokens``: the tokens must equal these.
    Returns ``(outputs, wall seconds)``."""
    import torch

    t0 = time.perf_counter()
    outs = serve(engine, requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bad = [(o.request_id, o.state, len(o.token_ids)) for o in outs.values()
           if o.state != "finished"
           or len(o.token_ids) != requests[o.request_id].max_new_tokens]
    if len(outs) != len(requests) or bad:
        raise AssertionError(f"{label}: requests not served in full: {bad}")
    engine._kv.assert_invariants()
    if engine._kv.leaked_pages():
        raise AssertionError(f"{label}: {engine._kv.leaked_pages()} pages "
                             "leaked")
    if want_tokens is not None:
        diff = [rid for rid, o in outs.items()
                if tuple(o.token_ids) != tuple(want_tokens[rid])]
        if diff:
            raise AssertionError(f"{label}: tokens differ from the eager "
                                 f"synchronous run for requests {diff}")
    return outs, wall


def token_agreement(a: dict, b: dict) -> tuple:
    """Positions where two runs' tokens agree, of all, and the requests
    whose tokens are identical."""
    same = sum(x == y for rid in a for x, y in zip(a[rid], b[rid]))
    total = sum(len(a[rid]) for rid in a)
    whole = sum(tuple(a[rid]) == tuple(b[rid]) for rid in a)
    return same, total, whole


def sync_free_dispatch(label, pim, vocab: int, **engine_kw) -> None:
    """One steady ``_dispatch_decode`` (graph replay, sampler, packed put
    and fetch) under ``torch.cuda.set_sync_debug_mode("error")``: any host
    sync in it raises."""
    import torch

    from neuronx_distributed_tpu_torch import ServingEngine

    eng = ServingEngine(pim, page_size=PAGE_SIZE, **engine_kw)
    for r in make_requests(vocab, SLOTS, 8, SEED + 5):
        eng.submit(r)
    for _ in range(3):
        eng.step()  # admissions, the eager call and capture, a replay
    eng._finish_decode(eng._collect_decode(), [])
    active = eng._decoding()
    if len(active) != SLOTS:
        raise AssertionError(f"{label}: {len(active)} slots decoding")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng._dispatch_decode(active)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    eng.run_until_complete(max_steps=100)
    log(f"{label}: one steady decode dispatch over {SLOTS} slots ran under "
        f"torch.cuda.set_sync_debug_mode('error'): no host sync")


def spec_run(label, pim, draft, requests, seed=None, **engine_kw) -> tuple:
    """Serve ``requests`` speculatively (k = SPEC_K) with every launch
    count from 0: no decode-route launch, every verify (and chunk) on the
    wgmma kernel.  Returns ``(tokens, stats)``."""
    from neuronx_distributed_tpu_torch import ServingEngine

    eng = ServingEngine(pim, page_size=PAGE_SIZE, draft=draft,
                        spec_k=SPEC_K, seed=seed, **engine_kw)
    zero_paged_counts()
    outs, wall = serve_checked(label, eng, requests)
    L = pim.module.config.num_layers
    routes = check_routes(label, 0, (eng.spec_rounds + eng.prefill_chunks) * L)
    acc = eng.spec_accepted / eng.spec_proposed
    per_req = [o.acceptance_rate for o in outs.values()]
    tokens = sum(len(o.token_ids) for o in outs.values())
    log(f"{label}: {len(outs)} requests, {tokens} tokens in {wall:.3f} s "
        f"({tokens / wall:.1f} tok/s), {eng.spec_rounds} rounds of k = "
        f"{SPEC_K}, acceptance {eng.spec_accepted}/{eng.spec_proposed} = "
        f"{acc:.4f} (per request {min(per_req):.3f}..{max(per_req):.3f}), "
        f"{eng.spec_committed / eng.spec_rounds:.3f} tokens committed a "
        f"slot-round; launches by route {routes} = (rounds "
        f"{eng.spec_rounds} + chunks {eng.prefill_chunks}) x {L} on wgmma; "
        f"puts {eng.puts}, fetches {eng.fetches}")
    return ({rid: o.token_ids for rid, o in outs.items()},
            {"wall_s": wall, "tok_s": tokens / wall,
             "rounds": eng.spec_rounds, "chunks": eng.prefill_chunks,
             "proposed": eng.spec_proposed, "accepted": eng.spec_accepted,
             "acceptance": acc, "min_request_acceptance": min(per_req),
             "committed_per_slot_round":
                 eng.spec_committed / eng.spec_rounds,
             "launches_by_route": routes})


def phase2c(model_pim, sync_tokens, sync_int8_tokens, verify_entry):
    """Async decode with CUDA-graph phase steps, and speculative decoding,
    on phase 2's Llama-3-8B: (a) phase 2's requests on the async graph
    engine, tokens equal to phase 2's eager synchronous run, every decode
    launch on the decode kernel, steady step times beside phase 2's; (b)
    the same for phase 2b's int8, chunked engine; (c) a steady dispatch
    without a host sync on each pool type; (d) speculative decoding, k = 4,
    with a self draft (greedy and sampled, then on the int8 chunked engine)
    and a weak draft (the model cut to 2 layers, seed 1), every verify on
    the wgmma kernel."""
    import gc

    import torch

    from neuronx_distributed_tpu_torch import (
        LlamaConfig,
        LlamaForCausalLM,
        ParallelInferenceModel,
        ServingEngine,
    )
    from neuronx_distributed_tpu_torch.serving import SamplingParams

    cfg = model_pim.module.config
    L = cfg.num_layers
    pim = graphed_pim(model_pim)
    out = {}

    # (a) bf16 pool, whole prefill
    eng = ServingEngine(pim, page_size=PAGE_SIZE)
    zero_paged_counts()
    outs, wall = serve_checked(
        "phase2c(a)", eng, make_requests(cfg.vocab_size, N_REQUESTS,
                                         NEW_TOKENS, SEED), sync_tokens)
    routes = check_routes("phase2c(a)", eng.decode_steps * L, 0)
    log(f"phase2c(a): async decode + CUDA graphs, bf16 pool: {N_REQUESTS} "
        f"requests in {wall:.3f} s, greedy tokens identical to phase 2's "
        f"eager synchronous run; {eng.decode_steps} decode steps, launches "
        f"by route {routes} = steps x {L}; {pim.graphs.captures} graphs "
        f"captured, {pim.graphs.replays} replays; puts {eng.puts}, fetches "
        f"{eng.fetches} ({N_REQUESTS} of them first tokens)")
    out["a"] = {"wall_s": wall, "decode_steps": eng.decode_steps,
                "launches_by_route": routes, "puts": eng.puts,
                "fetches": eng.fetches,
                **steady_decode_profile(pim, cfg.vocab_size,
                                        label="phase2c(a)")}
    graph_tokens = {rid: o.token_ids for rid, o in outs.items()}
    del eng

    # (b) int8 pool, 128-token chunks
    eng = ServingEngine(pim, page_size=PAGE_SIZE, kv_quant="int8",
                        prefill_chunk_tokens=CHUNK_TOKENS)
    zero_paged_counts()
    _, wall = serve_checked(
        "phase2c(b)", eng, make_requests(cfg.vocab_size, N_REQUESTS,
                                         NEW_TOKENS, SEED), sync_int8_tokens)
    routes = check_routes("phase2c(b)", eng.decode_steps * L,
                          eng.prefill_chunks * L)
    log(f"phase2c(b): async decode + CUDA graphs, int8 pool, "
        f"{CHUNK_TOKENS}-token chunks: tokens identical to phase 2b's eager "
        f"synchronous run in {wall:.3f} s; {eng.decode_steps} decode steps "
        f"+ {eng.prefill_chunks} chunks, launches by route {routes}")
    out["b"] = {"wall_s": wall, "decode_steps": eng.decode_steps,
                "chunks": eng.prefill_chunks, "launches_by_route": routes,
                **steady_decode_profile(pim, cfg.vocab_size,
                                        label="phase2c(b) int8",
                                        kv_quant="int8")}
    del eng

    # (c) no host sync in a steady dispatch
    for kv in (None, "int8"):
        sync_free_dispatch(f"phase2c(c) {kv or 'bf16'} pool", pim,
                           cfg.vocab_size, kv_quant=kv)

    # (d) speculative decoding
    requests = lambda: make_requests(cfg.vocab_size, N_REQUESTS,  # noqa: E731
                                     NEW_TOKENS, SEED)
    self_tokens, out["d_self"] = spec_run("phase2c(d) self draft", pim, pim,
                                          requests())
    set_launches([verify_entry], out["d_self"]["launches_by_route"],
                 "2c(d)")
    weak = ParallelInferenceModel(
        LlamaForCausalLM(LlamaConfig.llama3_8b(num_layers=WEAK_LAYERS),
                         device="cuda").init_random(WEAK_SEED),
        model_pim.config)
    weak_tokens, out["d_weak"] = spec_run("phase2c(d) weak draft", pim, weak,
                                          requests())
    del weak
    gc.collect()
    same_sw = token_agreement(self_tokens, weak_tokens)
    same_sa = token_agreement(self_tokens, graph_tokens)
    same_wa = token_agreement(weak_tokens, graph_tokens)
    log(f"phase2c(d): greedy tokens, self draft vs weak draft "
        f"{same_sw[0]}/{same_sw[1]} positions, {same_sw[2]}/{N_REQUESTS} "
        f"requests identical; self draft vs (a) {same_sa[0]}/{same_sa[1]}, "
        f"{same_sa[2]} requests; weak draft vs (a) {same_wa[0]}/"
        f"{same_wa[1]}, {same_wa[2]} requests (bf16 rounding: the verify "
        f"call, S = 5, and the decode step, S = 1, differ in their last "
        f"bits, and the two drafts' rounds split the key range at other "
        f"offsets; random weights leave near-ties)")
    # checked once every run of (d) is logged
    failed = []
    if not out["d_self"]["acceptance"] >= SELF_ACCEPT_MIN:
        failed.append(f"self-draft acceptance {out['d_self']['acceptance']}"
                      f" < {SELF_ACCEPT_MIN}")
    if not out["d_self"]["acceptance"] > out["d_weak"]["acceptance"]:
        failed.append("the self draft accepts no more than the weak draft")
    out["d_agreement"] = {"self_vs_weak": same_sw, "self_vs_a": same_sa,
                          "weak_vs_a": same_wa}

    def sampled():
        reqs = make_requests(cfg.vocab_size, SLOTS, SAMPLED_NEW, SEED + 6)
        for r in reqs:
            r.sampling = SamplingParams(temperature=SAMPLED_TEMP)
        return reqs

    eng = ServingEngine(pim, page_size=PAGE_SIZE, seed=SEED)
    plain, _ = serve_checked("phase2c(d) plain sampled", eng, sampled())
    del eng
    spec_sampled, out["d_self_sampled"] = spec_run(
        "phase2c(d) self draft, sampled", pim, pim, sampled(), seed=SEED)
    same = token_agreement(spec_sampled,
                           {rid: o.token_ids for rid, o in plain.items()})
    log(f"phase2c(d): sampled (temperature {SAMPLED_TEMP}) self-draft vs "
        f"plain sampled serving: {same[0]}/{same[1]} positions, "
        f"{same[2]}/{SLOTS} requests identical")
    out["d_self_sampled"]["agreement_with_plain"] = same
    _, out["d_self_int8"] = spec_run(
        "phase2c(d) self draft, int8 pool, chunks", pim, pim, requests(),
        kv_quant="int8", prefill_chunk_tokens=CHUNK_TOKENS)
    del pim
    gc.collect()
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"phase2c(d): {'; '.join(failed)}")
    return out


# -- phase 2d -----------------------------------------------------------------

# multi-adapter serving: registered adapters, their rank (alpha = rank, so
# the folded scale is 1), and the target of ||delta|| / ||projection||
N_ADAPTERS, LORA_RANK, LORA_RATIO = 4, 16, 0.1
# (e): Gemma-2-2B's adapters
G2_ADAPTERS = 2
# (f): the merged-dense check's depth, its bound (relative L2 of the
# prefill logits, bf16) and how many times that error the adapter must
# move the logits, so that a dropped delta fails
MERGED_LAYERS, MERGED_REL_TOL, MERGED_GAP_MIN = 2, 2e-2, 5.0
# steps of each steady-step reading of phase 2d
STEADY_STEPS = 20
# 2d's cuts to its time (the fleet's phase 2h took the room): (c) and (d)
# serve one slot-full of phase 2's requests, not all 16, and the steady
# step runs once per engine in turns, not twice
D_CUT_REQUESTS = SLOTS
D_STEADY_TURNS = ("storeless", "a", "b")


def adapter_factors(cfg, aid: int, layers=None) -> list:
    """Adapter ``aid``'s per-layer factors from ``RandomState(SEED +
    aid)``: A ~ N(0, 1/H) and B ~ N(0, LORA_RATIO^2 / r), so that on the
    random init (kernels ~ N(0, 1/H)) ||x A B|| is LORA_RATIO ||x W|| for
    q and for v (:func:`delta_ratios` measures it)."""
    import numpy as np

    rs = np.random.RandomState(SEED + aid)
    H, r = cfg.hidden_size, LORA_RANK
    out = []
    for _ in range(layers or cfg.num_layers):
        f = {}
        for p, width in (("q", cfg.num_heads * cfg.head_dim_),
                         ("v", cfg.num_kv_heads * cfg.head_dim_)):
            f[f"a_{p}"] = (rs.randn(H, r) / H ** 0.5).astype(np.float32)
            f[f"b_{p}"] = (rs.randn(r, width) * LORA_RATIO / r ** 0.5
                           ).astype(np.float32)
        out.append(f)
    return out


def make_store(pim, factors: dict):
    """A store laid out for ``pim`` holding every adapter of ``factors``
    (``{aid: per-layer factors}``) and the NULL page."""
    from neuronx_distributed_tpu_torch.tenancy import (
        AdapterLayout,
        make_adapter_store,
    )

    pp = AdapterLayout.for_model(pim, LORA_RANK).pages_per_adapter
    store = make_adapter_store(pim, LORA_RANK, len(factors) * pp + 1)
    for aid, f in factors.items():
        store.register(aid, f, alpha=float(LORA_RANK))
    return store


def delta_ratios(pim, factors, prompt) -> tuple:
    """||x A B|| / ||x W|| of q and of v at layer 0 of a Llama on
    ``prompt``."""
    import torch

    block = pim.module.model.layer_0
    with torch.no_grad():
        ids = torch.tensor([prompt], device="cuda")
        x = block.input_norm(pim.module.model.embed(ids))
        q, _, v = block.attn.qkv(x)
        f = {k: torch.from_numpy(a).to("cuda", x.dtype)
             for k, a in factors[0].items()}
        dq = x @ f["a_q"] @ f["b_q"]
        dv = x @ f["a_v"] @ f["b_v"]
        return ((dq.float().norm() / q.float().norm()).item(),
                (dv.float().norm() / v.float().norm()).item())


def serve_pair(label, graphed, eager, requests, factors, **engine_kw):
    """``requests()`` on the async graph engine and on the eager
    synchronous engine, each with its own store of ``factors``, every
    launch count from 0 before the graph run and read after it: tokens
    identical, every decode launch on the decode kernel and every chunk
    on the wgmma kernel.  Returns ``(tokens, routes, graph engine, its
    store, wall s)``."""
    from neuronx_distributed_tpu_torch import ServingEngine

    L = graphed.module.config.num_layers
    store = make_store(eager, factors)
    eng = ServingEngine(eager, page_size=PAGE_SIZE, async_decode=False,
                        adapter_store=store, **engine_kw)
    ref, _ = serve_checked(f"{label} eager sync", eng, requests())
    store.assert_invariants()
    del eng
    store = make_store(graphed, factors)
    eng = ServingEngine(graphed, page_size=PAGE_SIZE, adapter_store=store,
                        **engine_kw)
    zero_paged_counts()
    outs, wall = serve_checked(label, eng, requests(),
                               {rid: o.token_ids for rid, o in ref.items()})
    routes = check_routes(label, eng.decode_steps * L,
                          eng.prefill_chunks * L)
    store.assert_invariants()
    if any(store.pins(a) for a in store.resident_ids()):
        raise AssertionError(f"{label}: adapter pins left after the drain")
    return ({rid: o.token_ids for rid, o in outs.items()}, routes, eng,
            store, wall)


def lora_device_ms(pim, eng) -> float:
    """Device ms of one decode step's adapter work at the served shapes:
    the one gather of every slot's adapter pages and, for each layer, the
    factor casts and the q and v product pairs and adds
    (``models.llama.apply_adapter``), under ``torch.profiler``."""
    import torch

    from neuronx_distributed_tpu_torch.models.llama import apply_adapter

    cfg = pim.module.config
    g = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn((SLOTS, 1, cfg.hidden_size), generator=g,
                    device="cuda").to(cfg.dtype)
    q = torch.randn((SLOTS, 1, cfg.num_heads, cfg.head_dim_), generator=g,
                    device="cuda").to(cfg.dtype)
    v = torch.randn((SLOTS, 1, cfg.num_kv_heads, cfg.head_dim_),
                    generator=g, device="cuda").to(cfg.dtype)
    atables = torch.from_numpy(eng._adapter_tables).to("cuda")

    def step():
        for adapter in pim._gather_adapters(eng._apool, atables):
            apply_adapter(cfg, x, q, v, adapter)

    return device_ms([step], 10, show="phase2d LoRA step ops")


def merged_dense_check(factors) -> dict:
    """(f): ``prefill_one_lora`` of adapter 1 on Llama-3-8B's width cut to
    MERGED_LAYERS layers (bf16, seed 0) against ``prefill_one`` of the same
    model with the adapter folded into its q/v kernels by
    ``peft.merge_lora``, and against the base model."""
    import gc

    import numpy as np
    import torch

    from neuronx_distributed_tpu_torch import (
        InferenceConfig,
        LlamaConfig,
        LlamaForCausalLM,
        ParallelInferenceModel,
    )
    from neuronx_distributed_tpu_torch.peft import merge_lora

    cfg = LlamaConfig.llama3_8b(num_layers=MERGED_LAYERS)
    icfg = InferenceConfig(1, CONTEXT, MAX_TOTAL, torch.bfloat16)
    model = LlamaForCausalLM(cfg, device="cuda").init_random(SEED)
    pim = ParallelInferenceModel(model, icfg, cuda_graphs=False)
    f = {1: factors[:MERGED_LAYERS]}
    store = make_store(pim, f)
    apool = pim.make_adapter_pool(store.layout, store.num_pages)
    phys, blocks = zip(*store.acquire(1))
    pim.write_adapter_page(apool, np.stack(blocks), phys)
    prompt = make_requests(cfg.vocab_size, 1, 1, SEED)[0].prompt_ids
    ids = np.zeros((1, CONTEXT), np.int64)
    ids[0, CONTEXT - len(prompt):] = prompt
    valid = (ids > 0).astype(np.int32)
    lora, _ = pim.prefill_one_lora(ids, valid, apool, store.table(1)[None])
    base, _ = pim.prefill_one(ids, valid)

    tree: dict = {}
    for name, t in model.state_dict().items():
        *parents, leaf = name.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    for i, lay in enumerate(f[1]):
        qkv = tree["model"][f"layer_{i}"]["attn"]["qkv"]
        for k, a in lay.items():
            qkv[f"lora_{k}"] = torch.from_numpy(a).to("cuda")
    merged = merge_lora(tree, alpha=float(LORA_RANK))
    flat: dict = {}

    def walk(node, prefix):
        for k, val in node.items():
            if isinstance(val, dict):
                walk(val, f"{prefix}{k}.")
            else:
                flat[prefix + k] = val

    walk(merged, "")
    dense = LlamaForCausalLM(cfg, device="cuda")
    dense.load_state_dict(flat)
    want, _ = ParallelInferenceModel(dense, icfg, cuda_graphs=False
                                     ).prefill_one(ids, valid)
    err = ((lora.float() - want.float()).norm() / want.float().norm()).item()
    gap = ((lora.float() - base.float()).norm() / base.float().norm()).item()
    finite = bool(torch.isfinite(lora).all())
    log(f"phase2d(f): Llama-3-8B width cut to {MERGED_LAYERS} layers, bf16: "
        f"prefill_one_lora vs the peft.merge_lora dense model, logits rel "
        f"L2 {err:.3e} (tol {MERGED_REL_TOL}); adapter vs base {gap:.3e} = "
        f"{gap / max(err, 1e-30):.1f}x the error (at least "
        f"{MERGED_GAP_MIN}x); argmax agreement with the merged model "
        f"{(lora.argmax(-1) == want.argmax(-1)).float().mean().item():.3f}")
    del model, dense, pim, apool
    gc.collect()
    torch.cuda.empty_cache()
    if not (finite and err <= MERGED_REL_TOL
            and gap >= MERGED_GAP_MIN * err):
        raise AssertionError(
            f"phase2d(f): merged-dense rel {err}, adapter gap {gap}")
    return {"rel_l2_vs_merged": err, "rel_l2_vs_base": gap}


def phase2d(model_pim, sync_tokens, entries: dict):
    """Multi-adapter (LoRA) serving on phase 2's Llama-3-8B, the async
    graph engine with an adapter store of N_ADAPTERS rank-LORA_RANK
    adapters: (a) every request on adapter 0, tokens identical to phase
    2c(a)'s (= phase 2's); (b) requests round-robin over adapters 0..4,
    tokens identical to the eager synchronous engine's, adapter-0 requests
    identical to 2c(a)'s, every decode launch on the decode kernel; (c) (b)
    on int8 pages with 128-token chunks; (d) a self draft at k = 4 sharing
    the adapters; the steady step of (a) and (b) beside the storeless
    engine's, in turns, and the device time of the adapter work; (f) the
    merged-dense check.  ``entries``: the kernels-line entries whose
    launches these runs count ("decode", "decode_int8", "chunk",
    "verify")."""
    import gc

    import torch

    from neuronx_distributed_tpu_torch import ServingEngine

    cfg = model_pim.module.config
    L = cfg.num_layers
    pim = graphed_pim(model_pim)
    out = {}
    t0 = time.perf_counter()
    factors = {aid: adapter_factors(cfg, aid)
               for aid in range(1, N_ADAPTERS + 1)}

    def requests(adapters, n=N_REQUESTS):
        return lambda: make_requests(cfg.vocab_size, n, NEW_TOKENS, SEED,
                                     adapters)

    store = make_store(pim, factors)
    layout = store.layout
    pool_bytes = store.num_pages * layout.page_elems * 4
    ratios = delta_ratios(model_pim, factors[1],
                          requests(0)()[0].prompt_ids)
    log(f"phase2d: {N_ADAPTERS} adapters of rank {LORA_RANK}, "
        f"{layout.layer_elems} fp32 factor elements a layer, "
        f"{layout.pages_per_adapter} pages of {layout.page_elems} an "
        f"adapter; pool {store.num_pages} pages = {pool_bytes} bytes; "
        f"registered in {time.perf_counter() - t0:.1f} s; adapter 1 on the "
        f"first prompt at layer 0: ||dq||/||q|| {ratios[0]:.4f}, "
        f"||dv||/||v|| {ratios[1]:.4f} (target {LORA_RATIO})")
    out.update(pool_bytes=pool_bytes, pool_pages=store.num_pages,
               pages_per_adapter=layout.pages_per_adapter,
               delta_ratio_q=ratios[0], delta_ratio_v=ratios[1])

    # (a) the store attached, every request on adapter 0
    eng = ServingEngine(pim, page_size=PAGE_SIZE, adapter_store=store)
    zero_paged_counts()
    _, wall = serve_checked("phase2d(a)", eng, requests(0)(), sync_tokens)
    routes = check_routes("phase2d(a)", eng.decode_steps * L, 0)
    if store.resident_ids() or store.loads:
        raise AssertionError("phase2d(a): adapter-0 requests loaded pages")
    log(f"phase2d(a): store attached, all {N_REQUESTS} requests on adapter "
        f"0: greedy tokens identical to phase 2c(a)'s in {wall:.3f} s; "
        f"launches by route {routes}; no adapter page loaded")
    out["a"] = {"wall_s": wall, "launches_by_route": routes,
                "decode_steps": eng.decode_steps}
    del eng, store

    # (b) round-robin over adapters 0..N_ADAPTERS
    tokens, routes, eng, store, wall = serve_pair(
        "phase2d(b)", pim, model_pim, requests(N_ADAPTERS), factors)
    leaked = [rid for rid, t in tokens.items()
              if rid % (N_ADAPTERS + 1) == 0
              and tuple(t) != tuple(sync_tokens[rid])]
    if leaked:
        raise AssertionError(f"phase2d(b): adapter-0 requests {leaked} "
                             "differ from phase 2c(a)'s tokens")
    moved = sum(tuple(t) != tuple(sync_tokens[rid])
                for rid, t in tokens.items())
    set_launches([entries["decode"]], routes, "2d(b)")
    log(f"phase2d(b): {N_REQUESTS} requests over adapters 0..{N_ADAPTERS}: "
        f"tokens identical to the eager synchronous engine's in {wall:.3f} "
        f"s; adapter-0 requests identical to 2c(a)'s, {moved} adapter "
        f"requests differ from the base model's; {eng.decode_steps} decode "
        f"steps, launches by route {routes} = steps x {L}; store loads "
        f"{store.loads}, hits {store.hits}, evictions {store.evictions}; "
        f"puts {eng.puts}, fetches {eng.fetches}")
    out["b"] = {"wall_s": wall, "launches_by_route": routes,
                "decode_steps": eng.decode_steps, "loads": store.loads,
                "hits": store.hits, "evictions": store.evictions,
                "adapter_requests_differing_from_base": moved,
                "puts": eng.puts, "fetches": eng.fetches}
    lora_ms = lora_device_ms(pim, eng)
    del eng, store

    # (c) int8 pages, 128-token chunks
    _, routes, eng, store, wall = serve_pair(
        "phase2d(c)", pim, model_pim, requests(N_ADAPTERS, D_CUT_REQUESTS),
        factors,
        kv_quant="int8", prefill_chunk_tokens=CHUNK_TOKENS)
    set_launches([entries["decode_int8"], entries["chunk"]], routes, "2d(c)")
    log(f"phase2d(c): int8 pages, {CHUNK_TOKENS}-token chunks, adapters "
        f"0..{N_ADAPTERS}: tokens identical to the eager synchronous "
        f"engine's in {wall:.3f} s; {eng.decode_steps} decode steps + "
        f"{eng.prefill_chunks} chunks, launches by route {routes}")
    out["c"] = {"wall_s": wall, "launches_by_route": routes,
                "decode_steps": eng.decode_steps,
                "chunks": eng.prefill_chunks}
    del eng, store

    # (d) a self draft sharing the adapters
    _, out["d"] = spec_run("phase2d(d) self draft, adapters", pim, pim,
                           requests(N_ADAPTERS, D_CUT_REQUESTS)(),
                           adapter_store=make_store(pim, factors))
    set_launches([entries["verify"]], out["d"]["launches_by_route"], "2d(d)")
    if not out["d"]["acceptance"] >= SELF_ACCEPT_MIN:
        raise AssertionError(f"phase2d(d): self-draft acceptance "
                             f"{out['d']['acceptance']} < {SELF_ACCEPT_MIN}")

    # the steady step in turns: storeless (2c(a)'s engine), (a), (b)
    runs = {"storeless": [], "a": [], "b": []}
    for key in D_STEADY_TURNS:
        kw = {} if key == "storeless" else dict(
            adapter_store=make_store(pim, factors),
            adapters=N_ADAPTERS if key == "b" else 0)
        runs[key].append(steady_decode_profile(
            pim, cfg.vocab_size, steps=STEADY_STEPS,
            label=f"phase2d steady {key} {len(runs[key]) + 1}", **kw))
    steady = {key: {f: sum(r[f] for r in rs) / len(rs)
                    for f in ("steady_step_ms", "device_busy_ms")}
              for key, rs in runs.items()}
    base = steady["storeless"]
    log(f"phase2d: steady step (B={SLOTS}), host clock, in turns: "
        f"storeless (2c(a)'s engine) "
        f"{base['steady_step_ms']:.2f} ms, (a) "
        f"{steady['a']['steady_step_ms']:.2f} ms, (b) "
        f"{steady['b']['steady_step_ms']:.2f} ms ("
        f"{steady['b']['steady_step_ms'] - base['steady_step_ms']:+.2f} "
        f"ms); device busy {base['device_busy_ms']:.3f} / "
        f"{steady['a']['device_busy_ms']:.3f} / "
        f"{steady['b']['device_busy_ms']:.3f} ms a step; the adapter work "
        f"(one gather, {L} x (casts, 2 product pairs, 2 adds)) "
        f"{lora_ms:.3f} ms of device time a step")
    out.update(steady=steady, steady_runs=runs, lora_device_ms=lora_ms)
    del pim
    gc.collect()
    torch.cuda.empty_cache()
    out["f"] = merged_dense_check(factors[1])
    return out


# -- phase 2e -----------------------------------------------------------------

# SLO serving: SLOTS batch requests of 256..CONTEXT prompt tokens and
# E_BATCH_NEW new tokens fill the slots; after E_ARRIVE steps E_INTERACTIVE
# interactive requests of 32..128 prompt tokens and E_INT_NEW new tokens
# arrive.  (b): the int8 chunked engine, its batch requests E_B_NEW tokens,
# one interactive arrival after one step (the victim is mid-chunk).
E_BATCH_NEW, E_INTERACTIVE, E_INT_NEW, E_ARRIVE, E_B_NEW = 64, 4, 32, 4, 64
# 2e's cuts to its time (the fleet's phase 2h took the room): the batch
# requests' 128 new tokens became 64, and (a)'s TTFT runs and (e)'s
# steady-step runs go once each in turns, not twice
E_TURNS = ("interactive", "all_batch")
E_STEADY_TURNS = ("no_plan", "inert_plan")


def slo_traffic(vocab: int, all_batch: bool = False, n_int: int = E_INTERACTIVE,
                batch_new: int = E_BATCH_NEW, seed: int = SEED + 20):
    """``(batch requests, interactive requests)`` from ``seed``; with
    ``all_batch`` the second list is submitted as batch too."""
    import numpy as np

    from neuronx_distributed_tpu_torch.serving import Request

    rs = np.random.RandomState(seed)
    batch = [Request(request_id=i, prompt_ids=rs.randint(
        1, vocab, size=rs.randint(256, CONTEXT + 1)).tolist(),
        max_new_tokens=batch_new, priority="batch") for i in range(SLOTS)]
    inter = [Request(request_id=SLOTS + i, prompt_ids=rs.randint(
        1, vocab, size=rs.randint(32, 129)).tolist(),
        max_new_tokens=E_INT_NEW,
        priority="batch" if all_batch else "interactive")
        for i in range(n_int)]
    return batch, inter


def slo_serve(label, eng, traffic, arrive=E_ARRIVE, want_tokens=None):
    """The batch requests, ``arrive`` steps, the interactive arrivals, then
    the drain.  Checks every request finished in full, the pages came
    back, the scheduler's and manager's invariants, and on a graph engine
    that nothing was captured once its decode graph was in use (the graph
    cache is keyed by the state tensors' addresses, which a new engine may
    reuse, so its first steps may capture or not): a preemption, a park
    or a resume never captures again.  ``want_tokens``: the tokens must
    equal these.  Returns ``(outputs, graph captures once warm or None,
    wall s)``."""
    import torch

    batch, inter = traffic
    outs = {}
    graphs = eng.model.graphs if eng.model.cuda_graphs else None
    captures = None
    t0 = time.perf_counter()
    for r in batch:
        eng.submit(r)
    steps = 0
    while eng.has_work or steps <= arrive:
        if steps == arrive:
            for r in inter:
                eng.submit(r)
        outs.update((o.request_id, o) for o in eng.step())
        steps += 1
        if graphs is not None and captures is None and eng.decode_steps > 2:
            captures = graphs.captures  # the eager call and the capture ran
        if steps > 10_000:
            raise AssertionError(f"{label}: not drained in 10,000 steps")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    reqs = {r.request_id: r for r in batch + inter}
    bad = [(o.request_id, o.state, len(o.token_ids)) for o in outs.values()
           if o.state != "finished"
           or len(o.token_ids) != reqs[o.request_id].max_new_tokens]
    if len(outs) != len(reqs) or bad:
        raise AssertionError(f"{label}: requests not served in full: {bad}")
    eng.scheduler.assert_invariants()
    eng._kv.assert_invariants()
    evictable = eng._kv.index.evictable_pages()
    if eng._kv.alloc.in_use != evictable or eng._kv.leaked_pages():
        raise AssertionError(f"{label}: {eng._kv.alloc.in_use} pages in use "
                             f"after the drain, {evictable} evictable")
    if eng._kv._resume:
        raise AssertionError(f"{label}: resume pins left after the drain")
    if graphs is not None:
        if captures is None or graphs.captures != captures:
            raise AssertionError(f"{label}: graphs captured after the decode "
                                 f"graph was in use ({captures} -> "
                                 f"{graphs.captures})")
    if want_tokens is not None:
        diff = [rid for rid, o in outs.items()
                if tuple(o.token_ids) != tuple(want_tokens[rid])]
        if diff:
            raise AssertionError(f"{label}: tokens differ from the "
                                 f"unpreempted eager synchronous run for "
                                 f"requests {diff}")
    return outs, captures, wall


class PrefillTokens:
    """Counts the prompt tokens a serving wrapper's ``prefill_one`` and
    ``prefill_chunk_pages`` compute (an instance attribute over each,
    removed by :meth:`close`)."""

    def __init__(self, pim):
        self.pim = pim
        self.whole = self.chunk = 0
        real_one, real_chunk = pim.prefill_one, pim.prefill_chunk_pages

        def one(ids, valid, *a, **kw):
            self.whole += int(valid.sum())
            return real_one(ids, valid, *a, **kw)

        def chunk(ids, *a, **kw):
            self.chunk += int(ids.shape[1])
            return real_chunk(ids, *a, **kw)

        pim.prefill_one, pim.prefill_chunk_pages = one, chunk

    def close(self):
        del self.pim.prefill_one, self.pim.prefill_chunk_pages


def phase2e(model_pim, steady_2c_ms, entries: dict):
    """SLO serving on phase 2's Llama-3-8B, the async graph engine: (a)
    batch requests fill the slots and interactive ones preempt them,
    tokens equal to the unpreempted eager synchronous run, no page or pin
    left, nothing captured again, every decode launch on the decode
    kernel; interactive TTFT beside the same traffic all batch, in turns;
    (b) the int8 chunked engine with a victim parked mid-chunk, which
    prefills only its uncommitted pages again; (c) ``shed_infeasible``
    with deadlines under (a)'s TTFT estimate; (d) a tenant limit on
    adapter 1; (e) fault plans on the graph engine: a NaN on one slot's
    decode logits, an exception mid-chunk, and the steady step with no
    plan beside one with an inert plan, in turns.  ``entries``: the
    kernels-line entries whose launches (a) and (b) count ("decode",
    "decode_int8", "chunk")."""
    import gc
    import statistics

    import torch

    from neuronx_distributed_tpu_torch import ServingEngine
    from neuronx_distributed_tpu_torch.resilience import (
        InjectedFault,
        clear_plan,
        fired_events,
        install_plan,
    )
    from neuronx_distributed_tpu_torch.serving import (
        FAIL_NON_FINITE,
        RateLimited,
        Request,
        SLOInfeasible,
    )

    cfg = model_pim.module.config
    L, vocab = cfg.num_layers, cfg.vocab_size
    pim = graphed_pim(model_pim)
    out = {}
    t_phase = time.perf_counter()

    # (a) preemption, bf16 pages, whole prefill
    ref, _, ref_wall = slo_serve(
        "phase2e(a) eager sync, all batch",
        ServingEngine(model_pim, page_size=PAGE_SIZE, async_decode=False),
        slo_traffic(vocab, all_batch=True))
    ref_tokens = {rid: o.token_ids for rid, o in ref.items()}
    int_ids = range(SLOTS, SLOTS + E_INTERACTIVE)
    ttft = {"interactive": [], "all_batch": []}
    for turn, kind in enumerate(E_TURNS):
        eng = ServingEngine(pim, page_size=PAGE_SIZE)
        count = PrefillTokens(pim)
        zero_paged_counts()
        try:
            outs, captures, wall = slo_serve(
                f"phase2e(a) {kind} {turn}", eng,
                slo_traffic(vocab, all_batch=kind == "all_batch"),
                want_tokens=ref_tokens)
        finally:
            count.close()
        routes = check_routes(f"phase2e(a) {kind}", eng.decode_steps * L, 0)
        ttft[kind].append([outs[i].ttft_ms for i in int_ids])
        if turn == 0:
            victims = [o for o in outs.values() if o.preemptions]
            if not victims or any(o.priority != "batch" for o in victims):
                raise AssertionError(
                    f"phase2e(a): victims {[(o.request_id, o.priority) for o in victims]}")
            a = {"wall_s": wall, "decode_steps": eng.decode_steps,
                 "launches_by_route": routes, "preemptions": eng.preemptions,
                 "victims": [o.request_id for o in victims],
                 "graph_captures": captures,
                 "ttft_ewma_s": eng.scheduler._ttft_ewma,
                 "prefill_tokens": count.whole,
                 "victim_prompt_tokens": sum(o.prompt_len for o in victims),
                 "victim_preempted_ms": [o.preempted_ms for o in victims]}
            set_launches([entries["decode"]], routes, "2e(a)")
        elif turn == 1:
            a["prefill_tokens_all_batch"] = count.whole
        del eng
    a["reprefilled_tokens"] = a["prefill_tokens"] - a["prefill_tokens_all_batch"]
    flat = {k: [x for run in v for x in run] for k, v in ttft.items()}
    a["ttft_ms"] = {k: {"median": statistics.median(v), "max": max(v),
                        "runs": ttft[k]} for k, v in flat.items()}
    log(f"phase2e(a): {SLOTS} batch requests ({E_BATCH_NEW} new tokens) "
        f"then {E_INTERACTIVE} interactive ({E_INT_NEW}) after {E_ARRIVE} "
        f"steps on the async graph engine: {a['preemptions']} preemptions, "
        f"victims {a['victims']} (all batch), tokens identical to the "
        f"unpreempted eager synchronous run ({ref_wall:.3f} s); "
        f"{a['decode_steps']} decode steps, launches by route "
        f"{a['launches_by_route']}; no page or pin left, no graph "
        f"captured once the decode graph was in use ({a['graph_captures']} "
        f"captures); victims "
        f"re-prefilled {a['reprefilled_tokens']} of their "
        f"{a['victim_prompt_tokens']} prompt tokens (their chains stayed "
        f"pinned), parked {[round(x, 1) for x in a['victim_preempted_ms']]} "
        f"ms; interactive TTFT median / max "
        f"{a['ttft_ms']['interactive']['median']:.2f} / "
        f"{a['ttft_ms']['interactive']['max']:.2f} ms, the same traffic all "
        f"batch {a['ttft_ms']['all_batch']['median']:.2f} / "
        f"{a['ttft_ms']['all_batch']['max']:.2f} ms (in turns); "
        f"TTFT estimate {a['ttft_ewma_s']:.4f} s")
    out["a"] = a

    # (b) int8 pages, 128-token chunks, a victim parked mid-chunk
    def b_traffic(all_batch=False):
        return slo_traffic(vocab, all_batch=all_batch, n_int=1,
                           batch_new=E_B_NEW, seed=SEED + 21)

    # the chunk widths a request gets depend on what else is chunking, and
    # on the card the wgmma route rounds differently at each width, so the
    # reference is the same traffic (preemption included) on the eager
    # synchronous engine; the unpreempted run is logged beside it
    sync_eng = lambda: ServingEngine(  # noqa: E731
        model_pim, page_size=PAGE_SIZE, kv_quant="int8",
        prefill_chunk_tokens=CHUNK_TOKENS, async_decode=False)
    ref, _, _ = slo_serve("phase2e(b) eager sync int8 chunks", sync_eng(),
                          b_traffic(), arrive=1)
    unpre, _, _ = slo_serve("phase2e(b) eager sync int8 chunks, all batch",
                            sync_eng(), b_traffic(all_batch=True), arrive=1)
    eng = ServingEngine(pim, page_size=PAGE_SIZE, kv_quant="int8",
                        prefill_chunk_tokens=CHUNK_TOKENS)
    parked = {}
    real_park = eng._kv.park_resume

    def park(slot, req, fresh_done=None):
        real_park(slot, req, fresh_done)
        parked[req.request_id] = (fresh_done, sum(
            p != 0 for p in req.resume_pages), req.prefill_chunks)

    eng._kv.park_resume = park
    count = PrefillTokens(pim)
    zero_paged_counts()
    try:
        outs, _, wall = slo_serve("phase2e(b)", eng, b_traffic(), arrive=1,
                                  want_tokens={rid: o.token_ids
                                               for rid, o in ref.items()})
    finally:
        count.close()
    routes = check_routes("phase2e(b)", eng.decode_steps * L,
                          eng.prefill_chunks * L)
    mid = {rid: v for rid, v in parked.items() if v[0] is not None}
    if not mid:
        raise AssertionError(f"phase2e(b): no victim parked mid-chunk "
                             f"({parked})")
    prompt_pages = {rid: -(-outs[rid].prompt_len // PAGE_SIZE) for rid in mid}
    committed = sum(v[1] for v in mid.values())
    all_pages = sum(-(-o.prompt_len // PAGE_SIZE) for o in outs.values())
    chunk_pages = count.chunk // PAGE_SIZE
    scratch_pages = all_pages + committed
    if not (committed > 0 and chunk_pages == all_pages
            and chunk_pages < scratch_pages):
        raise AssertionError(
            f"phase2e(b): {chunk_pages} chunk pages dispatched, prompts "
            f"{all_pages}, committed by victims {committed}")
    set_launches([entries["decode_int8"], entries["chunk"]], routes, "2e(b)")
    victim_same = {rid: outs[rid].token_ids == unpre[rid].token_ids
                   for rid in mid}
    others_same = token_agreement(
        {rid: o.token_ids for rid, o in outs.items() if rid not in mid},
        {rid: o.token_ids for rid, o in unpre.items() if rid not in mid})
    out["b"] = {"wall_s": wall, "decode_steps": eng.decode_steps,
                "chunks": eng.prefill_chunks, "launches_by_route": routes,
                "mid_chunk_victims": {r: {"committed_pages": v[1],
                                          "chunks_before_park": v[2],
                                          "chunks_total":
                                              outs[r].prefill_chunks,
                                          "prompt_pages": prompt_pages[r]}
                                      for r, v in mid.items()},
                "chunk_pages": chunk_pages,
                "chunk_pages_from_scratch": scratch_pages,
                "victims_equal_unpreempted": victim_same,
                "others_vs_unpreempted": others_same}
    log(f"phase2e(b): int8 pages, {CHUNK_TOKENS}-token chunks, victims "
        f"parked mid-chunk {out['b']['mid_chunk_victims']}: tokens identical "
        f"to the eager synchronous int8 chunked run of the same traffic; "
        f"against the unpreempted (all batch) run: victims identical "
        f"{victim_same}, the others {others_same[0]}/{others_same[1]} "
        f"positions, {others_same[2]} requests identical; "
        f"{eng.prefill_chunks} "
        f"chunk dispatches, launches by route {routes} = chunks x {L} on "
        f"wgmma, decode steps {eng.decode_steps} x {L} on decode; prompt "
        f"pages prefilled {chunk_pages} against {scratch_pages} had the "
        f"victims started again from scratch")
    del eng

    # (c) shedding: deadlines under (a)'s time-to-first-token estimate
    eng = ServingEngine(pim, page_size=PAGE_SIZE, shed_infeasible=True)
    warm, _, _ = slo_serve("phase2e(c) warm-up", eng, slo_traffic(vocab))
    est = (eng.scheduler.queue_wait_estimate("interactive") or 0.0) \
        + eng.scheduler._ttft_ewma
    shed, admitted = [], []
    fracs = (0.05, 0.25, 0.5, 20.0, 50.0, 100.0)
    base = make_requests(vocab, len(fracs), E_INT_NEW, SEED + 22)
    for i, frac in enumerate(fracs):
        r = base[i]
        r.request_id = 100 + i
        r.deadline_s = frac * a["ttft_ewma_s"]
        try:
            eng.submit(r)
            admitted.append(r)
        except SLOInfeasible:
            shed.append((r.request_id, r.deadline_s))
    done = {o.request_id: o for o in eng.run_until_complete(max_steps=10_000)}
    bad = [(r.request_id, done.get(r.request_id)) for r in admitted
           if done.get(r.request_id) is None
           or done[r.request_id].state not in ("finished", "timed_out")]
    eng._kv.assert_invariants()
    if not shed or bad or eng._kv.leaked_pages() or eng.shed != len(shed):
        raise AssertionError(f"phase2e(c): shed {shed}, bad {bad}, leaked "
                             f"{eng._kv.leaked_pages()}")
    out["c"] = {"estimate_s": est, "a_ttft_ewma_s": a["ttft_ewma_s"],
                "shed": shed, "admitted": {r.request_id: done[r.request_id]
                                           .state for r in admitted}}
    log(f"phase2e(c): shed_infeasible, estimate (wait + TTFT EWMA) "
        f"{est:.4f} s after a warm-up of (a)'s traffic; deadlines 0.05..100 "
        f"x (a)'s TTFT EWMA {a['ttft_ewma_s']:.4f} s: shed {shed}, admitted "
        f"{out['c']['admitted']}; no page left")
    del eng

    # (d) a tenant limit on adapter 1, burst 2
    factors = {aid: adapter_factors(cfg, aid) for aid in (1, 2)}

    def d_requests():
        reqs = make_requests(vocab, 6, E_INT_NEW, SEED + 23)
        for r, aid in zip(reqs, (1, 1, 1, 0, 2, 2)):
            r.adapter_id = aid
        return reqs

    eng = ServingEngine(pim, page_size=PAGE_SIZE,
                        adapter_store=make_store(pim, factors))
    eng.scheduler.set_tenant_limit(1, rate=1e-3, burst=2.0)
    limited = []
    for r in d_requests():
        try:
            eng.submit(r)
        except RateLimited:
            limited.append(r.request_id)
    got = {o.request_id: o.token_ids
           for o in eng.run_until_complete(max_steps=10_000)}
    store = eng._adapters
    store.assert_invariants()
    if limited != [2] or eng.rejected != 1 or any(
            store.pins(a) for a in store.resident_ids()):
        raise AssertionError(f"phase2e(d): rate limited {limited}")
    del eng
    ref_eng = ServingEngine(model_pim, page_size=PAGE_SIZE, async_decode=False,
                            adapter_store=make_store(model_pim, factors))
    for r in d_requests():
        if r.request_id not in limited:
            ref_eng.submit(r)
    want = {o.request_id: o.token_ids
            for o in ref_eng.run_until_complete(max_steps=10_000)}
    del ref_eng
    if got != want:
        raise AssertionError("phase2e(d): tokens differ from the eager run")
    out["d"] = {"rate_limited": limited, "served": sorted(got)}
    log(f"phase2e(d): adapter 1 limited to a burst of 2: the third submit "
        f"at one instant raised RateLimited ({limited}); the 5 admitted "
        f"requests' tokens identical to the eager synchronous run's")

    # (e) fault plans on the graph engine
    eng = ServingEngine(pim, page_size=PAGE_SIZE)
    batch, _ = slo_traffic(vocab)
    for r in batch:
        eng.submit(r)
    outs = eng.step() + eng.step()
    slot = eng.scheduler.slot_of(3)
    install_plan({"faults": [{"point": "serving/decode_logits",
                              "action": "nan", "slot": slot}]})
    try:
        outs += eng.run_until_complete(max_steps=10_000)
        fired = len(fired_events())
    finally:
        clear_plan()
    res = {o.request_id: o for o in outs}
    wrong = [rid for rid, o in res.items() if rid != 3 and (
        o.state != "finished" or o.token_ids != ref_tokens[rid])]
    if (fired != 1 or res[3].state != "failed"
            or res[3].finish_reason != FAIL_NON_FINITE or wrong
            or eng._kv.leaked_pages()):
        raise AssertionError(f"phase2e(e): NaN plan: request 3 "
                             f"{res[3].state}/{res[3].finish_reason}, "
                             f"differing {wrong}")
    del eng
    eng = ServingEngine(pim, page_size=PAGE_SIZE,
                        prefill_chunk_tokens=CHUNK_TOKENS)
    prompt = batch[0].prompt_ids
    install_plan({"faults": [{"point": "serving/prefill_chunk",
                              "action": "exception",
                              "match": {"request_id": 0}}]})
    raised = False
    try:
        eng.submit(Request(request_id=0, prompt_ids=prompt,
                           max_new_tokens=E_INT_NEW))
        eng.run_until_complete(max_steps=1_000)
    except InjectedFault:
        raised = True
    finally:
        clear_plan()
    eng._kv.assert_invariants()
    if not raised or eng._kv.alloc.in_use != 0:
        raise AssertionError(f"phase2e(e): chunk fault raised {raised}, "
                             f"{eng._kv.alloc.in_use} pages in use")
    eng.submit(Request(request_id=1, prompt_ids=prompt,
                       max_new_tokens=E_INT_NEW))
    [again] = eng.run_until_complete(max_steps=1_000)
    del eng
    clean = ServingEngine(model_pim, page_size=PAGE_SIZE, async_decode=False,
                          prefill_chunk_tokens=CHUNK_TOKENS)
    clean.submit(Request(request_id=1, prompt_ids=prompt,
                         max_new_tokens=E_INT_NEW))
    [want1] = clean.run_until_complete(max_steps=1_000)
    del clean
    if again.state != "finished" or again.token_ids != want1.token_ids:
        raise AssertionError("phase2e(e): the resubmission after the chunk "
                             "fault differs from the clean run")
    # the steady graph step with no plan and with an inert plan, in turns
    inert = {"faults": [{"point": "serving/none", "action": "nan"}]}
    steady = {"no_plan": [], "inert_plan": []}
    for key in E_STEADY_TURNS:
        if key == "inert_plan":
            install_plan(inert)
        try:
            steady[key].append(steady_decode_profile(
                pim, vocab, steps=STEADY_STEPS,
                label=f"phase2e(e) steady, {key} {len(steady[key]) + 1}"))
        finally:
            clear_plan()
    mean = {k: sum(r["steady_step_ms"] for r in v) / len(v)
            for k, v in steady.items()}
    out["e"] = {"nan_failed": 3, "chunk_fault_raised": raised,
                "steady_ms": mean, "steady_2c_a_ms": steady_2c_ms,
                "steady_runs": steady}
    log(f"phase2e(e): a NaN on slot {slot}'s decode logits failed only "
        f"request 3 ({FAIL_NON_FINITE}), the {SLOTS - 1} co-batched "
        f"requests' tokens "
        f"identical to (a)'s; an exception at serving/prefill_chunk raised "
        f"InjectedFault with no page left, and the resubmission's tokens "
        f"equal the clean run's; steady graph step (B={SLOTS}), host clock, "
        f"in turns: no plan {mean['no_plan']:.3f} ms, an "
        f"inert plan {mean['inert_plan']:.3f} ms; 2c(a) {steady_2c_ms:.3f} "
        f"ms")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase2e: {out['wall_s']:.1f} s")
    del pim
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- phase 2f -----------------------------------------------------------------

# steady graph steps a telemetry profile times (host clock, host split,
# profiler), and the steady steps under obs.tracing.device_trace
F_STEADY_STEPS, F_TRACE_STEPS = 10, 3


def full_telemetry(out_dir: str) -> dict:
    """Engine arguments with every telemetry hook of the observability core
    attached, writing under ``out_dir``: an ``Observability`` hub, a
    ``Tracer``, ``stats_path`` and the ``forbid`` sync guard."""
    from neuronx_distributed_tpu_torch.obs import Observability, Tracer

    os.makedirs(out_dir, exist_ok=True)
    return {"obs": Observability(out_dir), "tracer": Tracer(),
            "stats_path": os.path.join(out_dir, "serving_stats.jsonl"),
            "transfer_guard": "forbid"}


class HostSplit:
    """Host-clock seconds one engine's steps spend in each part of a
    steady async step: the fetch's wait for the card, the rest of the
    collect (offset advance, stop checks, spans), the put (``_stage``), the
    graph replay's launch (``decode_pages``), the sampler (``sample_rows``
    and ``pack_tokens``), the fetch's start, the rest of the dispatch, the
    collected step's host work (``_finish_decode``), the step's telemetry
    (``_end_step``) and the remainder (sweep, preemption, admission).  The
    parts are wrapped as instance attributes (and the engine module's
    sampler functions), removed by :meth:`close`."""

    def __init__(self, eng):
        import neuronx_distributed_tpu_torch.serving.engine as se

        self.eng, self.se = eng, se
        self.acc = {}
        self._undo = []
        for obj, name, key in (
                (eng, "step", "step"),
                (eng, "_collect_decode", "collect"),
                (eng._audit, "fetch", "fetch_wait"),
                (eng, "_dispatch_decode", "dispatch"),
                (eng, "_stage", "put"),
                (eng.model, "decode_pages", "replay"),
                (se, "sample_rows", "sampler"),
                (se, "pack_tokens", "sampler"),
                (eng._io, "fetch", "fetch_start"),
                (eng, "_finish_decode", "finish"),
                (eng, "_end_step", "telemetry")):
            self._wrap(obj, name, key)

    def _wrap(self, obj, name, key):
        real = getattr(obj, name)
        acc = self.acc
        acc.setdefault(key, 0.0)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return real(*a, **kw)
            finally:
                acc[key] += time.perf_counter() - t0

        had = name in vars(obj) if hasattr(obj, "__dict__") else False
        setattr(obj, name, timed)
        self._undo.append((obj, name, real, had))

    def close(self) -> None:
        for obj, name, real, had in reversed(self._undo):
            if had or obj is self.se:
                setattr(obj, name, real)
            else:
                delattr(obj, name)

    def per_step_ms(self, steps: int) -> dict:
        a = {k: v * 1e3 / steps for k, v in self.acc.items()}
        parts = {
            "fetch_wait": a["fetch_wait"],
            "collect_rest": a["collect"] - a["fetch_wait"],
            "put": a["put"], "replay_launch": a["replay"],
            "sampler": a["sampler"], "fetch_start": a["fetch_start"],
            "dispatch_rest": a["dispatch"] - a["put"] - a["replay"]
            - a["sampler"] - a["fetch_start"],
            "finish": a["finish"], "telemetry": a["telemetry"]}
        parts["rest"] = a["step"] - a["collect"] - a["dispatch"] \
            - a["finish"] - a["telemetry"]
        parts["step"] = a["step"]
        return parts


def telemetry_profile(pim, vocab: int, label: str, **engine_kw) -> dict:
    """A steady graph step (SLOTS slots decoding, bf16, whole prefill) on
    one engine: the host clock over F_STEADY_STEPS steps, the registry's
    ``serving/step_ms`` and ``serving/host_blocked_ms`` over the same
    steps, the host split (:class:`HostSplit`) over as many more, and the
    device time and device launches a step under ``torch.profiler``
    (TRACE_TRIES traces, the fullest kept: a trace can drop a call's
    events, never add one).  Fails if a graph is captured once warm."""
    import torch

    from neuronx_distributed_tpu_torch import ServingEngine

    steps = F_STEADY_STEPS
    eng = ServingEngine(pim, page_size=PAGE_SIZE, **engine_kw)
    # 3 warm steps, 2 x steps timed, TRACE_TRIES traces of steps + 1
    for r in make_requests(vocab, SLOTS, (TRACE_TRIES + 3) * (steps + 1) + 8,
                           SEED + 3):
        eng.submit(r)
    for _ in range(3):
        eng.step()  # admissions, the eager call and capture, a replay
    if len(eng._decoding()) != SLOTS:
        raise AssertionError(f"{label}: {len(eng._decoding())} slots decoding")
    captures = pim.graphs.captures
    reg = eng.registry

    def hist(name):
        h = reg.snapshot()[name]
        return h["sum"], h["count"]

    (s0, c0), (b0, n0) = hist("serving/step_ms"), hist("serving/host_blocked_ms")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    (s1, c1), (b1, n1) = hist("serving/step_ms"), hist("serving/host_blocked_ms")
    if c1 - c0 != steps or n1 - n0 != steps:
        raise AssertionError(f"{label}: the registry counted {c1 - c0} steps "
                             f"and {n1 - n0} fetches over {steps} steps")
    split = HostSplit(eng)
    try:
        for _ in range(steps):
            eng.step()
    finally:
        split.close()
    parts = split.per_step_ms(steps)
    best = None
    for _ in range(TRACE_TRIES):
        events = trace(lambda: [eng.step() for _ in range(steps)], eng.step)
        launches = sum(e.count for e in events)
        if best is None or launches > best[1]:
            best = (events, launches)
    events, launches = best
    busy_ms = sum(dev_us(e) for e in events) / 1e3 / steps
    decode = sum(e.count for e in events if PAGED_DECODE_KERNEL in e.key)
    if pim.graphs.captures != captures:
        raise AssertionError(f"{label}: graphs captured once warm "
                             f"({captures} -> {pim.graphs.captures})")
    eng.run_until_complete(max_steps=1_000)
    eng.close()
    out = {"steady_step_ms": step_ms,
           "registry_step_ms": (s1 - s0) / steps,
           "registry_host_blocked_ms": (b1 - b0) / steps,
           "device_busy_ms": busy_ms,
           "device_launches_per_step": launches / steps,
           "decode_launches_per_step": decode / steps,
           "host_split_ms": parts}
    log(f"{label}: steady step {step_ms:.3f} ms host clock (registry "
        f"serving/step_ms {out['registry_step_ms']:.3f}, host blocked in "
        f"the fetch {out['registry_host_blocked_ms']:.3f} ms); device busy "
        f"{busy_ms:.3f} ms, {launches / steps:.1f} device launches a step "
        f"({decode / steps:.1f} decode-kernel); host split a step: "
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()) + " ms")
    return out


def phase2f(model_pim, entries: dict):
    """The observability core on phase 2's Llama-3-8B, the async graph
    engine: (a) 2e(a)'s SLO traffic with full telemetry (an
    ``Observability`` hub, a ``Tracer``, ``stats_path``,
    ``transfer_guard="forbid"``): tokens identical to the same traffic on
    the same engine without telemetry; ``scalars.jsonl``,
    ``serving_stats.jsonl``, ``trace_events.jsonl``, ``flight_record.json``
    and ``metrics.prom`` validate; the registry's counts equal the
    engine's own; each request's phase spans tile its latency within 1 ms
    and each victim's ``preempted`` phase is its ``preempted_ms``; every
    decode launch on the decode kernel; (b) the steady graph step, default
    engine (registry only) against full telemetry in turns: host clock,
    the registry's step and host-blocked times, device busy and launches a
    step (equal: telemetry adds no kernel) and the host split; (c)
    ``obs.tracing.device_trace`` over F_TRACE_STEPS steady steps names the
    decode kernel, one launch a layer a step; (d) an exception plan at
    ``serving/prefill_chunk`` through ``replay_trace`` leaves a valid
    ``flight_record.json`` holding the steps before the fault.
    ``entries``: the kernels-line entry (a) counts ("decode")."""
    import gc
    import tempfile

    import torch

    from neuronx_distributed_tpu_torch import ServingEngine
    from neuronx_distributed_tpu_torch.obs import (
        Observability,
        device_trace,
        read_trace_events,
        schemas,
        tracing,
    )
    from neuronx_distributed_tpu_torch.resilience import (
        InjectedFault,
        clear_plan,
        install_plan,
    )
    from neuronx_distributed_tpu_torch.serving import replay_trace

    cfg = model_pim.module.config
    L, vocab = cfg.num_layers, cfg.vocab_size
    pim = graphed_pim(model_pim)
    out = {}
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    root = tmp.name

    # (a) full telemetry under 2e(a)'s SLO traffic
    plain, _, plain_wall = slo_serve(
        "phase2f(a) no telemetry", ServingEngine(pim, page_size=PAGE_SIZE),
        slo_traffic(vocab))
    want = {rid: o.token_ids for rid, o in plain.items()}
    a_dir = os.path.join(root, "a")
    kw = full_telemetry(a_dir)
    hub, tracer = kw["obs"], kw["tracer"]
    eng = ServingEngine(pim, page_size=PAGE_SIZE, **kw)
    traffic = slo_traffic(vocab)
    emitted = [0]

    def stream(req, tok):
        emitted[0] += 1

    for r in traffic[0] + traffic[1]:
        r.stream_cb = stream
    zero_paged_counts()
    outs, captures, wall = slo_serve("phase2f(a) full telemetry", eng,
                                     traffic, want_tokens=want)
    routes = check_routes("phase2f(a)", eng.decode_steps * L, 0)
    set_launches([entries["decode"]], routes, "2f(a)")
    eng.close()
    hub.close()
    events_path = os.path.join(a_dir, tracing.TRACE_EVENTS_FILE)
    tracer.export_jsonl(events_path)
    counts = {
        "scalars": schemas.validate_jsonl("scalars", hub.scalars_path),
        "serving_stats": schemas.validate_jsonl("serving_stats",
                                                kw["stats_path"]),
        "trace_event": schemas.validate_jsonl("trace_event", events_path)}
    with open(hub.flight_path) as f:
        flight = json.load(f)
    schemas.validate_flight_document(flight)
    schemas.validate_registry_metrics(eng.registry)
    with open(hub.prometheus_path) as f:
        if f.read() != eng.registry.prometheus_text():
            raise AssertionError("phase2f(a): metrics.prom differs from the "
                                 "registry's text")
    if counts["serving_stats"] != len(outs):
        raise AssertionError(f"phase2f(a): {counts['serving_stats']} stats "
                             f"records for {len(outs)} terminal requests")
    if flight["steps_recorded"] != eng._steps:
        raise AssertionError(f"phase2f(a): flight recorded "
                             f"{flight['steps_recorded']} of {eng._steps} "
                             f"steps")
    snap = eng.registry.snapshot()
    want_counts = {"serving/tokens_total": emitted[0],
                   "serving/preemptions_total": eng.preemptions,
                   "transfer/explicit_puts_total": eng.puts,
                   "transfer/explicit_fetches_total": eng.fetches,
                   "transfer/guarded_sections_total": eng._steps,
                   "serving/finished_total": len(outs)}
    got = {k: snap[k] for k in want_counts}
    if got != {k: float(v) for k, v in want_counts.items()} \
            or not eng.preemptions:
        raise AssertionError(f"phase2f(a): registry {got} != engine "
                             f"{want_counts}")
    spans = read_trace_events(events_path)
    worst_tile, worst_park = 0.0, 0.0
    for rid, o in outs.items():
        mine = [s for s in spans if s["request_id"] == rid]
        phase = {p: sum((s["t_end"] - s["t_start"]) * 1e3 for s in mine
                        if s["name"] == p)
                 for p in ("queue", "prefill", "decode", "preempted")}
        worst_tile = max(worst_tile, abs(sum(phase.values()) - o.total_ms))
        worst_park = max(worst_park, abs(phase["preempted"] - o.preempted_ms))
    if worst_tile > 1.0 or worst_park > 1.0:
        raise AssertionError(f"phase2f(a): phase spans off the latency by "
                             f"{worst_tile:.4f} ms, parks by "
                             f"{worst_park:.4f} ms")
    victims = [o.request_id for o in outs.values() if o.preemptions]
    out["a"] = {"wall_s": wall, "wall_no_telemetry_s": plain_wall,
                "decode_steps": eng.decode_steps, "launches_by_route": routes,
                "preemptions": eng.preemptions, "victims": victims,
                "graph_captures": captures, "artifact_records": counts,
                "spans": len(spans), "registry": got,
                "worst_tile_ms": worst_tile, "worst_park_ms": worst_park}
    log(f"phase2f(a): 2e(a)'s traffic with full telemetry "
        f"(transfer_guard='forbid'): tokens identical to the same engine "
        f"without it ({plain_wall:.3f} s vs {wall:.3f} s); artifacts valid "
        f"({counts}, flight {flight['steps_recorded']} steps, metrics.prom "
        f"= the registry); registry = engine {got}; {len(spans)} spans, "
        f"phases tile every latency within {worst_tile:.6f} ms, victims "
        f"{victims}' preempted phases their preempted_ms within "
        f"{worst_park:.6f} ms; {eng._steps} guarded sections, none raised; "
        f"{eng.decode_steps} decode steps, launches by route {routes}; "
        f"{captures} graphs captured, none once warm")
    del eng

    # (b) the steady step: default engine against full telemetry, in turns
    runs = {"default": [], "full": []}
    for turn, kind in enumerate(("default", "full", "full", "default")):
        kw = (full_telemetry(os.path.join(root, f"b{turn}"))
              if kind == "full" else {})
        runs[kind].append(telemetry_profile(
            pim, vocab, f"phase2f(b) {kind} {len(runs[kind]) + 1}", **kw))
        if kind == "full":
            kw["obs"].close()
    mean = {k: {f: sum(r[f] for r in v) / len(v)
                for f in ("steady_step_ms", "registry_step_ms",
                          "registry_host_blocked_ms", "device_busy_ms",
                          "device_launches_per_step",
                          "decode_launches_per_step")}
            for k, v in runs.items()}
    split = {k: {p: sum(r["host_split_ms"][p] for r in v) / len(v)
                 for p in v[0]["host_split_ms"]} for k, v in runs.items()}
    launches = {k: [r["device_launches_per_step"] for r in v]
                for k, v in runs.items()}
    if len({x for v in launches.values() for x in v}) != 1:
        raise AssertionError(f"phase2f(b): device launches a step differ "
                             f"with telemetry: {launches}")
    if mean["default"]["decode_launches_per_step"] != L:
        raise AssertionError(f"phase2f(b): {mean['default']} decode "
                             f"launches a step, not {L}")
    busy = [r["device_busy_ms"] for v in runs.values() for r in v]
    if max(busy) > 1.05 * min(busy):
        raise AssertionError(f"phase2f(b): device busy a step moved with "
                             f"telemetry: {busy}")
    out["b"] = {"mean": mean, "host_split_ms": split, "runs": runs}
    log(f"phase2f(b): steady graph step (B={SLOTS}), means of 2 runs in "
        f"turns: default {mean['default']['steady_step_ms']:.3f} ms, full "
        f"telemetry {mean['full']['steady_step_ms']:.3f} ms (host clock); "
        f"device busy {mean['default']['device_busy_ms']:.3f} / "
        f"{mean['full']['device_busy_ms']:.3f} ms and "
        f"{mean['default']['device_launches_per_step']:.1f} device launches "
        f"a step in every run; host split default "
        f"{json.dumps({k: round(v, 4) for k, v in split['default'].items()})}"
        f", full {json.dumps({k: round(v, 4) for k, v in split['full'].items()})}")

    # (c) a device trace of steady steps
    eng = ServingEngine(pim, page_size=PAGE_SIZE)
    for r in make_requests(vocab, SLOTS, 8 * F_TRACE_STEPS + 8, SEED + 4):
        eng.submit(r)
    for _ in range(3):
        eng.step()
    seen = []
    for i in range(TRACE_TRIES):
        c_dir = os.path.join(root, f"c{i}")
        with device_trace(c_dir):
            for _ in range(F_TRACE_STEPS):
                eng.step()
        with open(os.path.join(c_dir, tracing.DEVICE_TRACE_FILE)) as f:
            doc = json.load(f)
        if doc.get("device_trace") != "cuda":
            raise AssertionError(f"phase2f(c): trace metadata "
                                 f"{doc.get('device_trace')!r}")
        n = sum(1 for e in doc["traceEvents"]
                if e.get("cat") == "kernel"
                and PAGED_DECODE_KERNEL in e.get("name", ""))
        seen.append(n)
        if n == F_TRACE_STEPS * L:
            break
    else:
        raise AssertionError(f"phase2f(c): the device traces named "
                             f"{PAGED_DECODE_KERNEL} {seen} times, not "
                             f"{F_TRACE_STEPS} x {L}")
    eng.run_until_complete(max_steps=1_000)
    del eng
    out["c"] = {"decode_kernel_events": seen}
    log(f"phase2f(c): obs.tracing.device_trace over {F_TRACE_STEPS} steady "
        f"steps named {PAGED_DECODE_KERNEL} {seen[-1]} times = "
        f"{F_TRACE_STEPS} x {L} (traces read: {seen})")

    # (d) the crash ring: an exception mid-chunk through replay_trace
    d_dir = os.path.join(root, "d")
    hub = Observability(d_dir)
    eng = ServingEngine(pim, page_size=PAGE_SIZE, obs=hub,
                        prefill_chunk_tokens=CHUNK_TOKENS)
    reqs = make_requests(vocab, 4, 16, SEED + 7)
    # request 3 arrives once the others are being served: the ring holds
    # their steps when its first chunk faults
    arrivals = [0.0, 0.0, 0.0, 0.2]
    install_plan({"faults": [{"point": "serving/prefill_chunk",
                              "action": "exception",
                              "match": {"request_id": 3}}]})
    try:
        replay_trace(eng, arrivals, reqs)
        raise AssertionError("phase2f(d): the injected fault did not fire")
    except InjectedFault:
        pass
    finally:
        clear_plan()
    with open(hub.flight_path) as f:
        doc = json.load(f)
    schemas.validate_flight_document(doc)
    steps = [r["step"] for r in doc["records"]]
    if doc["reason"] != "crash:InjectedFault" or not steps \
            or steps != list(range(1, eng._steps)):
        raise AssertionError(f"phase2f(d): flight {doc['reason']!r} holds "
                             f"steps {steps} of {eng._steps}")
    out["d"] = {"reason": doc["reason"], "steps": len(steps),
                "fault_step": eng._steps}
    log(f"phase2f(d): an exception at serving/prefill_chunk (request 3) "
        f"through replay_trace left a valid flight_record.json "
        f"({doc['reason']}) holding steps 1..{steps[-1]}, the fault in step "
        f"{eng._steps}")
    del eng
    tmp.cleanup()
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase2f: {out['wall_s']:.1f} s")
    del pim
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- phase 2g -----------------------------------------------------------------

# pairs of steady telemetry profiles in 2g(f) (part 1 only, then parts 1
# and 2, in turns: part1, full, full, part1, ...)
G_PAIRS = 2  # halved from 4 to make room for phase 2i
# the export check's cut of Llama-3-8B: full width, this many layers, and
# its serving shapes (32 new tokens: every decode position of the cache)
G_EXPORT_LAYERS, G_EXPORT_B, G_EXPORT_C, G_EXPORT_NEW = 2, 2, 64, 32


def part2_telemetry(out_dir: str) -> dict:
    """:func:`full_telemetry` plus ROADMAP A8 part 2: the hub builds the
    resource ledgers, the health monitor and the perf attribution, and the
    engine takes the hub's ledgers (its monitor and attribution it takes
    from the hub itself)."""
    from neuronx_distributed_tpu_torch.obs import Observability, Tracer

    os.makedirs(out_dir, exist_ok=True)
    hub = Observability(out_dir, ledgers=True, health=True, perf=True)
    return {"obs": hub, "tracer": Tracer(),
            "stats_path": os.path.join(out_dir, "serving_stats.jsonl"),
            "transfer_guard": "forbid",
            "compile_ledger": hub.compile_ledger,
            "memory_ledger": hub.memory_ledger}


def phase2g(model_pim, whole_tokens, entries: dict):
    """ROADMAP A8 part 2 on phase 2's Llama-3-8B, the async graph engine:
    (a) a warm pass, ``declare_warmup_done``, then phase 2's 16 requests
    with full telemetry (part 1 and ``Observability(ledgers=True,
    health=True, perf=True)``): tokens identical to phase 2's, every
    artifact valid, the compile rows the run's captures, no storm, every
    decode launch on the decode kernel, no page alert; (b) ``params`` and
    ``kv_pool`` in bytes, the logical sum under the allocator's, and a real
    out-of-memory error inside ``step()`` writing a breakdown that names
    ``params`` first; (c) ``decode_step`` memory-bound against the H100
    row, its roofline share in (0, 1]; (d) one capture forced after
    warm-up: one storm, one ``compile_storm`` firing edge, ``/healthz``
    naming it; (e) the run report over (a)'s directory; (f) the steady
    step with parts 1 and 2 against part 1 alone, G_PAIRS pairs in turns:
    device launches equal, device busy within 1 %; (g) the export of a
    G_EXPORT_LAYERS-layer cut at full width, reloaded: 32 greedy tokens
    identical to the original's.  ``entries``: the kernels-line entry (a)
    counts ("decode")."""
    import gc
    import tempfile
    import urllib.request

    import torch

    from neuronx_distributed_tpu_torch import (
        InferenceConfig,
        LlamaConfig,
        LlamaForCausalLM,
        ParallelInferenceModel,
        ServingEngine,
    )
    from neuronx_distributed_tpu_torch.obs import (
        MemoryLedger,
        schemas,
        summarize_perf,
        tracing,
    )
    from neuronx_distributed_tpu_torch.obs.metrics_server import MetricsServer
    from neuronx_distributed_tpu_torch.obs.report import (
        build_report,
        render_markdown,
    )
    from neuronx_distributed_tpu_torch.trace.export import (
        parallel_model_load,
        parallel_model_save,
    )

    cfg = model_pim.module.config
    L, vocab = cfg.num_layers, cfg.vocab_size
    smi = nvidia_smi_line()
    # earlier phases' engines (held by reference cycles) are not this
    # run's memory: free them before the ledger's device reading
    gc.collect()
    torch.cuda.empty_cache()
    pim = graphed_pim(model_pim)
    out = {"card": smi}
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    root = tmp.name

    # (a) warm pass, declare_warmup_done, then phase 2's requests
    a_dir = os.path.join(root, "a")
    kw = part2_telemetry(a_dir)
    hub, tracer = kw["obs"], kw["tracer"]
    led = hub.compile_ledger
    eng = ServingEngine(pim, page_size=PAGE_SIZE, **kw)
    warm = make_requests(vocab, SLOTS, 2, SEED + 11)
    for r in warm:
        r.request_id += 10_000
        eng.submit(r)
    eng.run_until_complete(max_steps=100)
    eng.declare_warmup_done()
    captures = pim.graphs.captures
    mark = led.mark()
    warm_steps = eng.decode_steps
    zero_paged_counts()
    outs, wall = serve_checked(
        "phase2g(a)", eng, make_requests(vocab, N_REQUESTS, NEW_TOKENS, SEED),
        whole_tokens)
    steps = eng.decode_steps - warm_steps
    routes = check_routes("phase2g(a)", steps * L, 0)
    set_launches([entries["decode"]], routes, "2g(a)")
    compiles = [r for r in led.rows if r["event"] == "compile"]
    if led.compiles_since(mark) or led.storms or \
            len(compiles) != pim.graphs.captures or captures != \
            pim.graphs.captures:
        raise AssertionError(
            f"phase2g(a): {len(compiles)} compile rows for "
            f"{pim.graphs.captures} captures, {led.compiles_since(mark)} "
            f"after warm-up, storms {led.storms}")
    if any(r["kind"] != "cuda_graph" or not r["flops"] > 0
           or not r["bytes_accessed"] > 0 for r in compiles):
        raise AssertionError(f"phase2g(a): compile rows {compiles}")
    page_edges = hub.health_monitor.page_edges()
    if page_edges:
        raise AssertionError(f"phase2g(a): {page_edges} page alerts on a "
                             f"steady run: {hub.health_monitor.edges}")
    roll = summarize_perf(hub.perf.attribution())
    out["a"] = {"wall_s": wall, "decode_steps": steps,
                "launches_by_route": routes, "captures": captures,
                "compile_rows": [{k: r[k] for k in (
                    "family", "kind", "wall_ms", "flops", "bytes_accessed")}
                    for r in compiles],
                "alert_edges": len(hub.health_monitor.edges)}
    log(f"phase2g(a) [{smi}]: warm pass of {SLOTS} requests, "
        f"declare_warmup_done, then phase 2's {N_REQUESTS} requests with "
        f"parts 1 and 2 of the telemetry in {wall:.3f} s: tokens identical "
        f"to phase 2's; {len(compiles)} compile rows = {captures} captures "
        f"({', '.join(f'{r['family']} {r['wall_ms']:.1f} ms' for r in compiles)}), "
        f"none after warm-up; {steps} decode steps, launches by "
        f"route {routes}; {len(hub.health_monitor.edges)} alert edges, "
        f"none paging")

    # (b) memory: the logical accounting against the allocator
    subs = hub.memory_ledger.subsystems()
    want = {"params": sum(p.numel() * p.element_size()
                          for p in pim.module.parameters()),
            "kv_pool": eng._kv.alloc.num_pages * eng._page_bytes}
    got = {k: subs[k]["bytes"] for k in want}
    allocated = torch.cuda.memory_allocated()
    logical = hub.memory_ledger.total_bytes
    if got != want or eng._kv.alloc.num_pages != SLOTS * (
            MAX_TOTAL // PAGE_SIZE) + 1 or logical > allocated:
        raise AssertionError(f"phase2g(b): subsystems {got} != {want}, "
                             f"logical {logical} vs allocated {allocated}")
    device = hub.memory_ledger.poll_device()
    remainder = hub.memory_ledger.remainder_bytes
    eng.close()
    tracer.export_jsonl(os.path.join(a_dir, tracing.TRACE_EVENTS_FILE))
    b_path = os.path.join(root, "b_memory_breakdown.json")
    oom_eng = ServingEngine(pim, page_size=PAGE_SIZE,
                            memory_ledger=MemoryLedger(path=b_path))
    real_decode = pim.decode_pages

    def decode_oom(*a, **k):
        # more than the card holds: more than mem_get_info's free bytes
        # and the allocator's cache together
        _, total = torch.cuda.mem_get_info()
        torch.empty(total + (1 << 30), dtype=torch.uint8, device="cuda")
        return real_decode(*a, **k)

    pim.decode_pages = decode_oom
    try:
        for r in make_requests(vocab, 2, 4, SEED + 12):
            oom_eng.submit(r)
        oom_eng.step()
        raise AssertionError("phase2g(b): no out-of-memory error in step()")
    except torch.cuda.OutOfMemoryError as e:
        oom_msg = str(e).splitlines()[0]
    finally:
        del pim.decode_pages
    with open(b_path) as f:
        oom_doc = json.load(f)
    schemas.validate_record("memory_breakdown", oom_doc)
    if oom_doc["reason"] != "oom:OutOfMemoryError" or \
            oom_doc["top"][0][0] != "params":
        raise AssertionError(f"phase2g(b): breakdown {oom_doc['reason']} "
                             f"top {oom_doc['top']}")
    del oom_eng
    gc.collect()
    out["b"] = {"subsystems": got, "logical_bytes": logical,
                "allocated_bytes": allocated, "device": device,
                "remainder_bytes": remainder, "oom_top": oom_doc["top"],
                "oom_message": oom_msg}
    log(f"phase2g(b) [{smi}]: params {got['params']} B = the parameters' "
        f"bytes, kv_pool {got['kv_pool']} B = {eng._kv.alloc.num_pages} x "
        f"{eng._page_bytes}; logical sum {logical} B <= allocated "
        f"{allocated} B, remainder (graph pools, activations, workspaces) "
        f"{remainder} B; an out-of-memory error inside step() ({oom_msg!r}) "
        f"wrote memory_breakdown.json, reason {oom_doc['reason']}, top "
        f"holders {oom_doc['top'][:3]}, and propagated")

    # (c) perf attribution against the H100 row
    fam = roll["families"]["decode_step"]
    rec = [r for r in hub.perf.attribution()
           if r["family"] == "decode_step"][0]
    if rec["device"] != "nvidia h100 80gb hbm3" or fam["bound"] != "memory" \
            or not 0.0 < fam["pct_roofline"] <= 1.0:
        raise AssertionError(f"phase2g(c): decode_step {fam} on "
                             f"{rec['device']}")
    out["c"] = {"families": roll["families"], "rollup": roll.get("rollup"),
                "decode_step_bytes_per_call": rec["bytes"] / rec["calls"],
                "decode_step_flops_per_call": rec["flops"] / rec["calls"],
                "decode_step_ms_per_call": rec["device_ms"] / rec["calls"],
                "decode_step_lower_bound_ms_per_call":
                    rec["lower_bound_ms"] / rec["calls"]}
    log(f"phase2g(c) [{smi}]: perf attribution against "
        f"{rec['device']} (989 TFLOP/s, 3.35 TB/s): decode_step "
        f"{rec['bytes'] / rec['calls'] / 1e9:.3f} GB and "
        f"{rec['flops'] / rec['calls'] / 1e9:.3f} GFLOP a step, bound "
        f"{rec['lower_bound_ms'] / rec['calls']:.3f} ms ({fam['bound']}) "
        f"against {rec['device_ms'] / rec['calls']:.3f} ms a step: roofline "
        f"share {fam['pct_roofline']:.4f}")
    for name, f in roll["families"].items():
        log(f"phase2g(c) family {name}: calls {f['calls']:.0f}, "
            f"{f['device_ms']:.3f} ms, flops {f['flops']:.4g}, bytes "
            f"{f['bytes']:.4g}, {f['bound']}-bound, roofline share "
            f"{f['pct_roofline']:.4f}, mfu {f['mfu']:.4f}, mbu {f['mbu']:.4f}")

    # (d) a capture forced after warm-up: one storm, one alert edge
    B = SLOTS // 2
    park = torch.full((B,), MAX_TOTAL, dtype=torch.int32, device="cuda")
    pim.decode_pages(torch.ones((B, 1), dtype=torch.long, device="cuda"),
                     park, eng._tables_dev[:B], eng.caches, eng.valid[:B])
    eng.step()  # an idle step: the rules evaluate the storm
    snap = hub.registry.snapshot()
    storm_edges = [e for e in hub.health_monitor.edges
                   if e["rule"] == "compile_storm"]
    with MetricsServer(hub.registry, monitor=hub.health_monitor, port=0,
                       host="127.0.0.1") as srv:
        hz = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/healthz", timeout=30).read())
    if snap["trace/compile_storms_total"] != 1.0 or led.storms != 1 or \
            [e["state"] for e in storm_edges] != ["firing"] or \
            "compile_storm" not in hz["firing"]:
        raise AssertionError(f"phase2g(d): storms "
                             f"{snap['trace/compile_storms_total']}, edges "
                             f"{storm_edges}, /healthz {hz}")
    out["d"] = {"storms": led.storms, "storm_row": led.rows[-1]["wall_ms"],
                "healthz": hz}
    log(f"phase2g(d) [{smi}]: a decode at batch {B} after warm-up was one "
        f"capture ({led.rows[-1]['wall_ms']:.1f} ms): "
        f"trace/compile_storms_total 1, one compile_storm firing edge, "
        f"/healthz {hz}")
    del eng
    pim.compile_ledger = pim.perf = None
    hub.close()

    # (e) the run report over (a)'s directory
    doc = build_report(run_dir=a_dir)
    schemas.validate_record("obs_report", doc)
    missing = [s for s in ("compile", "memory", "alerts", "perf", "trace")
               if doc.get(s) is None]
    md = render_markdown(doc)
    counts = {kind: schemas.validate_jsonl(kind, os.path.join(a_dir, name))
              for kind, name in (("compile_ledger", "compile_ledger.jsonl"),
                                 ("alert", "alerts.jsonl"),
                                 ("perf_attribution",
                                  "perf_attribution.jsonl"),
                                 ("scalars", "scalars.jsonl"),
                                 ("serving_stats", "serving_stats.jsonl"))}
    with open(os.path.join(a_dir, "memory_breakdown.json")) as f:
        schemas.validate_record("memory_breakdown", json.load(f))
    if missing or doc["schema"] != "obs_report_v7" or "## " not in md:
        raise AssertionError(f"phase2g(e): sections {missing} null")
    out["e"] = {"artifact_records": counts, "markdown_chars": len(md)}
    log(f"phase2g(e): obs_report_v7 over (a)'s directory: compile, memory, "
        f"alerts, perf and trace sections filled, markdown {len(md)} chars; "
        f"artifacts valid {counts}")
    del pim
    gc.collect()
    torch.cuda.empty_cache()

    # (f) telemetry's cost: part 1 against parts 1 and 2, in turns
    pim = graphed_pim(model_pim)
    runs = {"part1": [], "full": []}
    order = ["part1", "full", "full", "part1"] * (G_PAIRS // 2)
    for turn, kind in enumerate(order):
        d = os.path.join(root, f"f{turn}")
        kw = part2_telemetry(d) if kind == "full" else full_telemetry(d)
        runs[kind].append(telemetry_profile(
            pim, vocab, f"phase2g(f) {kind} {len(runs[kind]) + 1}", **kw))
        pim.compile_ledger = pim.perf = None
        kw["obs"].close()
    launches = {k: [r["device_launches_per_step"] for r in v]
                for k, v in runs.items()}
    if len({x for v in launches.values() for x in v}) != 1:
        raise AssertionError(f"phase2g(f): device launches a step differ: "
                             f"{launches}")
    busy = [r["device_busy_ms"] for v in runs.values() for r in v]
    mean_busy = {k: sum(r["device_busy_ms"] for r in v) / len(v)
                 for k, v in runs.items()}
    if abs(mean_busy["full"] - mean_busy["part1"]) > 0.01 * mean_busy[
            "part1"]:
        raise AssertionError(f"phase2g(f): device busy a step moved with "
                             f"part 2: means {mean_busy}, runs {busy}")
    diffs = [f["steady_step_ms"] - p["steady_step_ms"]
             for f, p in zip(runs["full"], runs["part1"])]
    mean_diff = sum(diffs) / len(diffs)
    sd = (sum((d - mean_diff) ** 2 for d in diffs)
          / max(len(diffs) - 1, 1)) ** 0.5
    out["f"] = {"steady_step_ms": {k: [r["steady_step_ms"] for r in v]
                                   for k, v in runs.items()},
                "registry_step_ms": {k: [r["registry_step_ms"] for r in v]
                                     for k, v in runs.items()},
                "device_busy_ms": busy, "mean_device_busy_ms": mean_busy,
                "device_launches_per_step": launches,
                "telemetry_ms": {k: [r["host_split_ms"]["telemetry"]
                                     for r in v] for k, v in runs.items()},
                "diff_ms": diffs, "mean_diff_ms": mean_diff, "sd_ms": sd}
    log(f"phase2g(f) [{smi}]: steady graph step (B={SLOTS}), {G_PAIRS} pairs "
        f"in turns: part 1 {[round(r['steady_step_ms'], 3) for r in runs['part1']]}"
        f" ms, parts 1+2 {[round(r['steady_step_ms'], 3) for r in runs['full']]}"
        f" ms (host clock); difference a pair {[round(d, 3) for d in diffs]}, "
        f"mean {mean_diff:.3f} ms, sd {sd:.3f} ms; device launches a step "
        f"{launches['full'][0]:.1f} in every run; device busy means part 1 "
        f"{mean_busy['part1']:.3f}, parts 1+2 {mean_busy['full']:.3f} ms "
        f"(runs {min(busy):.3f}-{max(busy):.3f}); the step's telemetry part "
        f"of the host split {[round(r['host_split_ms']['telemetry'], 3) for r in runs['part1']]}"
        f" against {[round(r['host_split_ms']['telemetry'], 3) for r in runs['full']]} ms")
    del pim
    gc.collect()
    torch.cuda.empty_cache()

    # (g) export and reload of a cut at full width
    ecfg = LlamaConfig.llama3_8b(num_layers=G_EXPORT_LAYERS)
    module = LlamaForCausalLM(ecfg, device="cuda").init_random(SEED)
    epim = ParallelInferenceModel(
        module, InferenceConfig(G_EXPORT_B, G_EXPORT_C,
                                G_EXPORT_C + G_EXPORT_NEW, torch.bfloat16))
    import numpy as np

    prompt = np.random.RandomState(SEED + 13).randint(
        1, vocab, size=(G_EXPORT_B, G_EXPORT_C))
    want_t = epim.generate(prompt, G_EXPORT_NEW).cpu()
    t0 = time.perf_counter()
    path = parallel_model_save(os.path.join(root, "export"), epim)
    save_s = time.perf_counter() - t0
    sizes = {n: os.path.getsize(os.path.join(path, n))
             for n in sorted(os.listdir(path))}
    t0 = time.perf_counter()
    loaded = parallel_model_load(path)
    got_t = loaded.generate(prompt, G_EXPORT_NEW).cpu()
    load_s = time.perf_counter() - t0
    if not torch.equal(got_t, want_t):
        raise AssertionError(f"phase2g(g): the loaded model's tokens differ "
                             f"at {(got_t != want_t).nonzero().tolist()[:8]}")
    out["g"] = {"files": sizes, "save_s": save_s, "load_and_generate_s":
                load_s}
    log(f"phase2g(g): {G_EXPORT_LAYERS}-layer Llama-3-8B cut at full width "
        f"saved in {save_s:.1f} s ({sizes}); the loaded programs' greedy "
        f"tokens over {G_EXPORT_NEW} decode positions identical to the "
        f"original's (load + generate {load_s:.1f} s)")
    del module, epim, loaded
    tmp.cleanup()
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase2g: {out['wall_s']:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- phase 2h -----------------------------------------------------------------

# The fleet (ROADMAP A7) on phase 2's Llama-3-8B.  Traffic: phase 2's 16
# requests plus H_SHARED that share one H_PREAMBLE-token preamble (every
# prompt H_PROMPT tokens: the left padding is page-aligned, so the
# preamble's pages are one chain), H_NEW new tokens each.  Every replica's
# pool holds H_PAGES pages (phase 2's).  H_FAULT_STEP: the replica step
# the fault plan kills; H_PROFILE_STEPS: the fleet steps the profiler
# reads; H_LAYERS: the live-weights cut (full width); H_CHAIN: the
# standalone transfer's chain, in pages.
H_SHARED, H_PREAMBLE, H_PROMPT, H_NEW = 8, 256, 320, 32
H_PAGES, H_FAULT_STEP, H_PROFILE_STEPS = 513, 6, 6
H_LAYERS, H_CHAIN = 4, 32
# 2h(b)'s arrivals: one request every H_ARRIVE steps, so that one prompt
# at a time chunks (at most 4 chunks a prompt) in the mixed reference and
# on the prefill replica alike: a chunk's width sets its arithmetic, and
# the shared chunk budget would split differently where the prefill
# replica's slots free at each migration
H_ARRIVE = 10


def fleet_requests(vocab: int) -> list:
    """Phase 2's requests (ids 0..15), then H_SHARED with a shared
    preamble; fresh objects (a router re-keys the ones it takes)."""
    import numpy as np

    from neuronx_distributed_tpu_torch.serving import Request

    reqs = make_requests(vocab, N_REQUESTS, NEW_TOKENS, SEED)
    rs = np.random.RandomState(SEED + 30)
    pre = rs.randint(1, vocab, size=H_PREAMBLE).tolist()
    for i in range(H_SHARED):
        tail = rs.randint(1, vocab, size=H_PROMPT - H_PREAMBLE).tolist()
        reqs.append(Request(request_id=N_REQUESTS + i, prompt_ids=pre + tail,
                            max_new_tokens=H_NEW))
    return reqs


class EngineLog:
    """A replica factory over ``pim`` that keeps every engine it builds (a
    dead replica's decode steps still count toward the launches), gives
    each its own memory ledger with ``ledgers=True``, and with
    ``timed=True`` times each chain export and import (synchronized):
    ``transfers`` holds ``(kind, pages, bytes, ms)``."""

    def __init__(self, pim, ledgers: bool = False, timed: bool = False,
                 **engine_kw):
        self.pim, self.ledgers, self.timed = pim, ledgers, timed
        self.kw = engine_kw
        self.made: list = []
        self.transfers: list = []

    def __call__(self):
        from neuronx_distributed_tpu_torch import ServingEngine
        from neuronx_distributed_tpu_torch.obs import MemoryLedger

        kw = dict(self.kw)
        if self.ledgers:
            kw["memory_ledger"] = MemoryLedger()
        eng = ServingEngine(self.pim, page_size=PAGE_SIZE,
                            num_pages=H_PAGES, **kw)
        if self.timed:
            eng.export_prefix = self._timed(eng.export_prefix, "export")
            eng.import_prefix = self._timed(eng.import_prefix, "import")
        self.made.append(eng)
        return eng

    def _timed(self, fn, kind):
        import torch

        def call(arg):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = fn(arg)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            ex = got if kind == "export" else arg
            if ex is not None:
                self.transfers.append((kind, ex.n_pages, ex.nbytes, ms))
            return got
        return call

    def decode_calls(self) -> int:
        """Decode-route phase calls: decode steps and parked prewarms."""
        return sum(e.decode_steps + e.prewarmed for e in self.made)

    def chunks(self) -> int:
        return sum(e.prefill_chunks for e in self.made)


def drive(target, requests, on_step=None, gids=None,
          every: int = 0) -> dict:
    """Submit ``requests`` to ``target`` (a router or an engine) all at
    once, or one every ``every`` steps, and step it until it drains;
    returns ``{client id: output}``.  ``on_step(step)`` runs after every
    step; ``gids`` (a dict) receives a router's ``{client id: global
    id}``."""
    outs = {}
    pending = list(requests)
    client = getattr(target, "client_id", None)
    step = 0
    while pending or target.has_work:
        if pending and (not every or step % every == 0):
            take, pending = ((pending, []) if not every
                             else (pending[:1], pending[1:]))
            for r in take:
                cid = r.request_id
                gid = target.submit(r)
                if gids is not None:
                    gids[cid] = gid
        for o in target.step():
            outs[client(o.request_id) if client else o.request_id] = o
        step += 1
        if on_step is not None:
            on_step(step)
        if step > 20_000:
            raise AssertionError("the fleet did not drain")
    return outs


def check_served(label, outs, requests, want=None) -> None:
    """Every request finished in full (zero lost); ``want``: the tokens
    must equal these, request for request."""
    bad = [(rid, o.state, len(o.token_ids)) for rid, o in outs.items()
           if o.state != "finished"
           or len(o.token_ids) != requests[rid].max_new_tokens]
    if len(outs) != len(requests) or bad:
        raise AssertionError(f"{label}: {len(outs)}/{len(requests)} served, "
                             f"not in full: {bad}")
    if want is not None:
        diff = [rid for rid, o in outs.items()
                if tuple(o.token_ids) != tuple(want[rid])]
        if diff:
            raise AssertionError(f"{label}: tokens differ from the single "
                                 f"engine's for requests {diff}")


def check_pools(label, engines) -> None:
    """No page leaked; every page in use is the prefix index's, and a
    flush returns them all: nothing is left on any side."""
    for eng in engines:
        eng._kv.assert_invariants()
        if eng._kv.leaked_pages():
            raise AssertionError(f"{label}: {eng._kv.leaked_pages()} pages "
                                 "leaked")
        eng._kv.flush_prefix_cache()
        if eng._kv.alloc.in_use:
            raise AssertionError(f"{label}: {eng._kv.alloc.in_use} pages "
                                 "held after the flush")


def phase2h(model_pim, entries: dict):
    """The serving fleet on phase 2's Llama-3-8B (async graph replicas over
    one shared model): (a) a ``FleetRouter`` over 2 bf16 replicas with
    prefix affinity, tokens identical to one graph engine's, then again
    with replica 0 killed at ``fleet/replica_step`` mid-run (zero lost,
    identical, the replica restarted into rotation, no compile storm),
    and the fleet step's device busy share; (b) a ``DisaggRouter``: a
    prefill replica (128-token chunks, the wgmma kernel) and a decode
    replica, every request migrated once, pages exported = imported,
    nothing left, tokens identical to one mixed engine's, each migration's
    bytes and ms; (c) a 32-page chain's export and import at Llama-3-8B's
    page geometry over bf16 and int8 pools, bit-exact, a chaos kill at
    ``kvcache/page_import`` leaking nothing, and the fleet prefix fill
    running no prefill chunk; (d) live weights on a 4-layer full-width
    cut: an unshared graph engine swaps from seed 0 to seed 1 capturing
    nothing, the in-flight step stamped version 0, tokens identical to a
    fresh engine on seed 1's weights, then a 2-replica ``rolling_update``
    under traffic; (e) the ``Autopilot`` over (a)'s fleet drains and
    restarts replica 1 on a forced firing edge under traffic.  Every
    decode launch on the decode kernel, every chunk on the wgmma kernel,
    none on the simt kernel.  ``entries``: the kernels-line entries whose
    launches these runs count ("decode", "chunk")."""
    import gc
    import shutil
    import tempfile

    import numpy as np
    import torch

    from neuronx_distributed_tpu_torch import (
        InferenceConfig,
        LlamaConfig,
        LlamaForCausalLM,
        ParallelInferenceModel,
        ServingEngine,
    )
    from neuronx_distributed_tpu_torch.kvcache import (
        BlockAllocator,
        PrefixIndex,
        export_chain,
        import_chain,
        init_page_pool_caches,
        page_keys,
    )
    from neuronx_distributed_tpu_torch.obs import CompileLedger
    from neuronx_distributed_tpu_torch.obs.aggregate import (
        FleetAggregator,
        FleetHealth,
    )
    from neuronx_distributed_tpu_torch.obs.schemas import validate_jsonl
    from neuronx_distributed_tpu_torch.resilience import (
        InjectedFault,
        clear_plan,
        install_plan,
    )
    from neuronx_distributed_tpu_torch.serving import Request
    from neuronx_distributed_tpu_torch.serving.fleet import (
        Autopilot,
        AutopilotConfig,
        DisaggRouter,
        FleetRouter,
        Replica,
    )
    from neuronx_distributed_tpu_torch.weights import WeightSwapper

    cfg = model_pim.module.config
    L, vocab = cfg.num_layers, cfg.vocab_size
    dev = next(model_pim.module.parameters()).device
    pim = graphed_pim(model_pim)
    tmp = tempfile.mkdtemp(prefix="phase2h_")
    out = {}
    t_phase = time.perf_counter()

    # (a) the reference: one graph engine over the same requests
    reqs = fleet_requests(vocab)
    ref_eng = ServingEngine(pim, page_size=PAGE_SIZE, num_pages=H_PAGES)
    ref = drive(ref_eng, reqs)
    check_served("phase2h(a) single engine", ref, reqs)
    want = {rid: o.token_ids for rid, o in ref.items()}
    ref_eng.close()
    del ref_eng, ref

    led = CompileLedger()
    made = EngineLog(pim, compile_ledger=led)
    health = FleetHealth(path=os.path.join(tmp, "alerts.jsonl"),
                         eval_every=1)
    router = FleetRouter([Replica(i, made, backoff_base_s=0.0)
                          for i in range(2)], policy="prefix_affinity",
                         health=health)
    a = {}
    for run in ("plain", "failover"):
        reqs = fleet_requests(vocab)
        zero_paged_counts()
        calls0, captures0 = made.decode_calls(), pim.graphs.captures
        snap0 = router.registry.snapshot()
        if run == "failover":
            install_plan({"faults": [{
                "point": "fleet/replica_step", "action": "exception",
                "match": {"replica": 0,
                          "step": router.replicas[0].steps + H_FAULT_STEP},
                "count": 1}]})
        t0 = time.perf_counter()
        gids = {}
        try:
            outs = drive(router, reqs, gids=gids)
        finally:
            clear_plan()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_served(f"phase2h(a) {run}", outs, reqs, want)
        routes = check_routes(f"phase2h(a) {run}",
                              (made.decode_calls() - calls0) * L, 0)
        snap = router.registry.snapshot()
        delta = {k: snap[k] - snap0.get(k, 0.0) for k in (
            "router/requeued_total", "router/failovers_total",
            "router/restarts_total", "router/affinity_hits_total")}
        placed = {}
        for gid in gids.values():
            rid = router._tracked[gid].replica_id
            placed[rid] = placed.get(rid, 0) + 1
        shared_on = {router._tracked[gids[cid]].replica_id
                     for cid in gids if cid >= N_REQUESTS}
        per_replica = {rid: len(r.engine.graph_templates())
                       for rid, r in router.replicas.items() if r.alive}
        if run == "plain":
            if len(shared_on) != 1 or delta["router/affinity_hits_total"] \
                    < H_SHARED - 1:
                raise AssertionError(f"phase2h(a): the shared-preamble "
                                     f"requests landed on {shared_on}")
            set_launches([entries["decode"]], routes, "2h(a)")
            led.declare_warmup_done()
        else:
            if (delta["router/failovers_total"] != 1
                    or delta["router/restarts_total"] != 1
                    or not delta["router/requeued_total"]
                    or snap["router/replicas_alive"] != 2):
                raise AssertionError(f"phase2h(a) failover: {delta}, "
                                     f"alive {snap['router/replicas_alive']}")
            if led.storms:
                raise AssertionError(f"phase2h(a): {led.storms} compile "
                                     "storms after the restart")
        a[run] = {"wall_s": wall, "placements": placed,
                  "shared_preamble_on": sorted(shared_on),
                  "requeues": delta["router/requeued_total"],
                  "restarts": delta["router/restarts_total"],
                  "affinity_hits": delta["router/affinity_hits_total"],
                  "launches_by_route": routes,
                  "captures": pim.graphs.captures - captures0,
                  "graphs_per_replica": per_replica}
        log(f"phase2h(a) {run}: {len(reqs)} requests over 2 replicas "
            f"(prefix_affinity) in {wall:.3f} s, tokens identical to one "
            f"graph engine's; placements by replica {placed}, the "
            f"{H_SHARED} shared-preamble requests on replica "
            f"{sorted(shared_on)} ({int(delta['router/affinity_hits_total'])}"
            f" affinity hits); requeues "
            f"{int(delta['router/requeued_total'])}, restarts "
            f"{int(delta['router/restarts_total'])}; captures "
            f"{pim.graphs.captures - captures0}, graphs per live replica "
            f"{per_replica}; launches by route {routes}; compile storms "
            f"{led.storms}")

    # the fleet step, every slot of both replicas decoding
    for r in make_requests(vocab, 2 * SLOTS, 3 * H_PROFILE_STEPS + 8,
                           SEED + 31):
        router.submit(r)
    for _ in range(40):
        router.step()
        if all(len(r.engine._decoding()) == SLOTS
               for r in router.replicas.values()):
            break
    else:
        raise AssertionError("phase2h(a): the slots never all decoded")
    walls = []

    def steps():
        t0 = time.perf_counter()
        for _ in range(H_PROFILE_STEPS):
            router.step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)

    events = trace(steps, router.step)
    busy = sum(dev_us(e) for e in events) / 1e3 / H_PROFILE_STEPS
    step_ms = walls[0] / H_PROFILE_STEPS * 1e3
    launches = sum(e.count for e in events) / H_PROFILE_STEPS
    decode = sum(e.count for e in events if PAGED_DECODE_KERNEL in e.key)
    router.run_until_complete(max_steps=1_000)
    a["fleet_step"] = {"step_ms": step_ms, "device_busy_ms": busy,
                       "busy_share": busy / step_ms,
                       "launches_per_step": launches,
                       "decode_kernel_per_step": decode / H_PROFILE_STEPS}
    log(f"phase2h(a) fleet step (2 replicas x {SLOTS} slots decoding, one "
        f"host thread, one stream): {step_ms:.2f} ms a step under the "
        f"profiler, device busy {busy:.3f} ms ({busy / step_ms:.1%}), "
        f"{launches:.0f} device launches a step, "
        f"{decode / H_PROFILE_STEPS:.0f} of them the decode kernel")
    text = FleetAggregator.for_router(router).prometheus_text()
    log(f"phase2h(a): fleet metrics exposition {len(text.splitlines())} "
        f"lines, replica-labelled")
    out["a"] = a

    # (e) the autopilot over (a)'s fleet: a forced firing edge drains and
    # restarts replica 1 under traffic
    reqs = fleet_requests(vocab)
    actions = os.path.join(tmp, "autopilot_actions.jsonl")
    pilot = Autopilot(router, health, config=AutopilotConfig(fire_after=1),
                      actions_path=actions)
    zero_paged_counts()
    calls0 = made.decode_calls()
    restarts0 = router.registry.counter("router/restarts_total").value
    fired = []

    def force(step):
        if step == 3:
            pilot._drain_restart(
                {"rule": "compile_storm", "key": "", "severity": "page",
                 "replica": 1, "state": "firing", "window": 0.0,
                 "observed": 1.0, "bound": 0.0, "since": 0.0},
                now=time.monotonic(), emitted=fired)

    outs = drive(router, reqs, force)
    check_served("phase2h(e)", outs, reqs, want)
    routes = check_routes("phase2h(e)", (made.decode_calls() - calls0) * L, 0)
    restarts = router.registry.counter("router/restarts_total").value
    pilot.close()
    if ([f["action"] for f in fired] != ["restart"] or fired[0]["replica"]
            != 1 or restarts != restarts0 + 1 or led.storms):
        raise AssertionError(f"phase2h(e): actions {fired}, restarts "
                             f"{restarts0} -> {restarts}, storms "
                             f"{led.storms}")
    n_actions = validate_jsonl("autopilot_action", actions)
    edges = [e["rule"] for e in health.edges()]
    out["e"] = {"actions": [f["action"] for f in fired],
                "records": n_actions, "launches_by_route": routes,
                "alert_rules": sorted(set(edges))}
    log(f"phase2h(e): the autopilot drained and restarted replica 1 on a "
        f"forced compile_storm edge under {len(reqs)} requests: zero lost, "
        f"tokens identical to one graph engine's; {n_actions} valid "
        f"autopilot_action record; restarts {int(restarts0)} -> "
        f"{int(restarts)}; compile storms 0; launches by route {routes}; "
        f"alert rules seen {sorted(set(edges))}")
    router.close()
    health.close()
    pim.compile_ledger = None  # (b) books no compile rows
    del router, made

    # (b) disaggregated prefill and decode
    reqs = make_requests(vocab, N_REQUESTS, NEW_TOKENS, SEED)
    mixed = ServingEngine(pim, page_size=PAGE_SIZE, num_pages=H_PAGES,
                          prefill_chunk_tokens=CHUNK_TOKENS)
    ref = drive(mixed, reqs, every=H_ARRIVE)
    check_served("phase2h(b) mixed engine", ref, reqs)
    want_b = {rid: o.token_ids for rid, o in ref.items()}
    mixed.close()
    del mixed, ref
    made_b = EngineLog(pim, timed=True, prefill_chunk_tokens=CHUNK_TOKENS)
    router = DisaggRouter([Replica(0, made_b, role="prefill"),
                           Replica(1, made_b, role="decode")])
    pre, dec = made_b.made
    reqs = make_requests(vocab, N_REQUESTS, NEW_TOKENS, SEED)
    zero_paged_counts()
    t0 = time.perf_counter()
    outs = drive(router, reqs, every=H_ARRIVE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_served("phase2h(b)", outs, reqs, want_b)
    routes = check_routes("phase2h(b)", made_b.decode_calls() * L,
                          made_b.chunks() * L)
    set_launches([entries["chunk"]], routes, "2h(b)")
    migrations = [router._tracked[g].migrations for g in router._tracked]
    exported = pre.registry.counter("kvcache/pages_exported_total").value
    imported = dec.registry.counter("kvcache/pages_imported_total").value
    skipped = dec.registry.counter("kvcache/prefill_skipped_total").value
    if (migrations != [1] * N_REQUESTS or exported != imported
            or dec.prefill_chunks or skipped != N_REQUESTS):
        raise AssertionError(
            f"phase2h(b): migrations {migrations}, pages exported "
            f"{exported} vs imported {imported}, decode-replica chunks "
            f"{dec.prefill_chunks}, full hits {skipped}")
    ex = [t for t in made_b.transfers if t[0] == "export"]
    im = [t for t in made_b.transfers if t[0] == "import"]
    b = {"wall_s": wall, "launches_by_route": routes,
         "pages_exported": exported, "pages_imported": imported,
         "migrations": [{"pages": e[1], "bytes": e[2], "export_ms": e[3],
                         "import_ms": i[3]} for e, i in zip(ex, im)]}
    gbs = [m["bytes"] / m["export_ms"] / 1e6 for m in b["migrations"]]
    gbs_i = [m["bytes"] / m["import_ms"] / 1e6 for m in b["migrations"]]
    log(f"phase2h(b): 1 prefill replica ({CHUNK_TOKENS}-token chunks) + 1 "
        f"decode replica, {N_REQUESTS} requests (one every {H_ARRIVE} "
        f"steps) in {wall:.3f} s, each "
        f"migrated once, tokens identical to one mixed engine's; pages "
        f"exported {int(exported)} = imported {int(imported)}; the decode "
        f"replica ran 0 chunks, {int(skipped)} full hits; launches by route "
        f"{routes}")
    log("phase2h(b) migrations (pages, bytes, export D2H ms, import H2D + "
        "index_copy_ ms): " + "; ".join(
            f"{m['pages']} p {m['bytes']} B {m['export_ms']:.3f} / "
            f"{m['import_ms']:.3f}" for m in b["migrations"]))
    b["export_ms_median"] = float(np.median([m["export_ms"]
                                             for m in b["migrations"]]))
    b["import_ms_median"] = float(np.median([m["import_ms"]
                                             for m in b["migrations"]]))
    log(f"phase2h(b): export {min(gbs):.2f}..{max(gbs):.2f} GB/s, import "
        f"{min(gbs_i):.2f}..{max(gbs_i):.2f} GB/s; median export "
        f"{b['export_ms_median']:.3f} ms, import "
        f"{b['import_ms_median']:.3f} ms (the first exports of a size "
        f"allocate their pinned block)")

    # (b) again with all the requests submitted at once: the prefill
    # replica chunks prompts side by side, splits the chunk budget and
    # migrates several requests in one step.  Tokens are counted against
    # the serial run, not checked: the mixed reference would split its
    # budget differently (its slots stay busy decoding), and a chunk's
    # width sets its bf16 arithmetic
    check_pools("phase2h(b) serial", made_b.made)  # a cold prefix cache
    for rid, r in router.replicas.items():
        router.directory.resync(rid, r.prefix_fingerprints())
    reqs = make_requests(vocab, N_REQUESTS, NEW_TOKENS, SEED)
    counted = ((pre, "kvcache/pages_exported_total"),
               (dec, "kvcache/pages_imported_total"),
               (dec, "kvcache/prefill_skipped_total"))
    base = [eng.registry.counter(k).value for eng, k in counted]
    last = {"moves": len(made_b.transfers), "chunks": pre.prefill_chunks}
    conc = {"chunking": 0, "chunks": 0, "migrations": 0}

    def most_at_once(step):
        moved = sum(t[0] == "export"
                    for t in made_b.transfers[last["moves"]:])
        conc["chunking"] = max(conc["chunking"], len(pre._chunking))
        conc["chunks"] = max(conc["chunks"],
                             pre.prefill_chunks - last["chunks"])
        conc["migrations"] = max(conc["migrations"], moved)
        last.update(moves=len(made_b.transfers), chunks=pre.prefill_chunks)

    gids = {}
    zero_paged_counts()
    calls0, ch0 = made_b.decode_calls(), made_b.chunks()
    t0 = time.perf_counter()
    outs = drive(router, reqs, most_at_once, gids=gids)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_served("phase2h(b) at once", outs, reqs)
    routes = check_routes("phase2h(b) at once",
                          (made_b.decode_calls() - calls0) * L,
                          (made_b.chunks() - ch0) * L)
    migrations = [router._tracked[g].migrations for g in gids.values()]
    exported, imported, skipped = (eng.registry.counter(k).value - v
                                   for (eng, k), v in zip(counted, base))
    same = sum(tuple(o.token_ids) == tuple(want_b[rid])
               for rid, o in outs.items())
    if (migrations != [1] * N_REQUESTS or exported != imported
            or skipped != N_REQUESTS or dec.prefill_chunks
            or conc["chunking"] < 2 or conc["chunks"] < 2):
        raise AssertionError(
            f"phase2h(b) at once: migrations {migrations}, pages exported "
            f"{exported} vs imported {imported}, full hits {skipped}, "
            f"decode-replica chunks {dec.prefill_chunks}, most at once "
            f"{conc}")
    check_pools("phase2h(b) at once", made_b.made)
    b["at_once"] = {"wall_s": wall, "pages_exported": exported,
                    "pages_imported": imported, "most_at_once": dict(conc),
                    "tokens_as_serial": same, "launches_by_route": routes}
    log(f"phase2h(b) at once: {N_REQUESTS} requests submitted together in "
        f"{wall:.3f} s, zero lost, each migrated once; pages exported "
        f"{int(exported)} = imported {int(imported)}, nothing left on "
        f"either side; on the prefill replica at most {conc['chunking']} "
        f"prompts chunking and {conc['chunks']} chunks in one step, "
        f"{conc['migrations']} migrations in one step; {same}/{N_REQUESTS} "
        f"requests' tokens as in the serial run (not checked: chunk widths "
        f"differ); launches by route {routes}")

    # (c) the fleet prefix fill: a prompt cached on the prefill replica,
    # submitted as batch traffic, lands on the decode replica full-hit
    router.migrate_after_prefill = False
    prompt = np.random.RandomState(SEED + 34).randint(
        1, vocab, size=H_PROMPT).tolist()
    first = drive(router, [Request(request_id=0, prompt_ids=prompt,
                                   max_new_tokens=H_NEW)])
    chunks0 = dec.prefill_chunks
    skipped0 = dec.registry.counter("kvcache/prefill_skipped_total").value
    again = drive(router, [Request(request_id=0, prompt_ids=prompt,
                                   max_new_tokens=H_NEW, priority="batch")])
    hits = router.registry.counter("kvcache/fleet_prefix_hits_total").value
    skipped = dec.registry.counter("kvcache/prefill_skipped_total").value
    if (again[0].token_ids != first[0].token_ids or hits != 1
            or dec.prefill_chunks != chunks0 or skipped != skipped0 + 1):
        raise AssertionError(f"phase2h(c) prefix fill: hits {hits}, decode "
                             f"chunks {chunks0} -> {dec.prefill_chunks}")
    check_pools("phase2h(b)", made_b.made)
    router.close()
    del router, made_b, pre, dec
    out["b"] = b

    # (c) the transfer alone at Llama-3-8B's page geometry
    c = {}
    nkv, hd = cfg.num_kv_heads, cfg.head_dim_
    g = torch.Generator(device=dev).manual_seed(SEED)
    ids = np.arange(1, H_CHAIN * PAGE_SIZE + 1, dtype=np.int64)
    keys = page_keys(ids, np.ones(len(ids), np.int32), PAGE_SIZE)
    for quant in (None, "int8"):
        pools = [init_page_pool_caches(L, H_CHAIN + 2, PAGE_SIZE, nkv, hd,
                                       torch.bfloat16, device=dev,
                                       quant=quant) for _ in range(2)]
        for layer in pools[0]:
            for leaf in layer:
                if leaf.dtype == torch.int8:
                    leaf.copy_(torch.randint(-128, 128, leaf.shape,
                                             generator=g, device=dev,
                                             dtype=torch.int8))
                else:
                    leaf.copy_(torch.randn(leaf.shape, generator=g,
                                           device=dev))
        chain = BlockAllocator(H_CHAIN + 2).alloc(H_CHAIN)
        payload = torch.randn(1, vocab, generator=g, device=dev)
        export_ms = []  # the first allocates its pinned block, the second
        for _ in range(2):  # reuses it
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            export = export_chain(pools[0], keys, chain, PAGE_SIZE,
                                  payload=payload)
            export_ms.append((time.perf_counter() - t0) * 1e3)
        index = PrefixIndex(BlockAllocator(H_CHAIN + 2))
        install_plan({"faults": [{"point": "kvcache/page_import",
                                  "action": "exception", "count": 1}]})
        try:
            import_chain(pools[1], index, export)
        except InjectedFault:
            pass
        else:
            raise AssertionError("phase2h(c): the chaos kill did not fire")
        finally:
            clear_plan()
        if index.alloc.free_count != H_CHAIN + 1 or len(index):
            raise AssertionError(f"phase2h(c) chaos kill leaked: free "
                                 f"{index.alloc.free_count}, nodes "
                                 f"{len(index)}")
        ptrs = [t.data_ptr() for layer in pools[1] for t in layer]
        import_ms = []
        for attempt in range(2):  # into a cold index each time
            if attempt:
                index = PrefixIndex(BlockAllocator(H_CHAIN + 2))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            import_chain(pools[1], index, export)
            torch.cuda.synchronize()
            import_ms.append((time.perf_counter() - t0) * 1e3)
        matched, got = index.peek(keys)
        same = all(torch.equal(b_[matched].view(torch.uint8),
                               a_[chain].view(torch.uint8))
                   for la, lb in zip(*pools) for a_, b_ in zip(la, lb))
        if (not same or not torch.equal(got, payload)
                or [t.data_ptr() for layer in pools[1] for t in layer]
                != ptrs):
            raise AssertionError(f"phase2h(c) {quant or 'bf16'}: the round "
                                 "trip is not bit-exact in place")
        page_b = (export.nbytes - payload.numel() * 4) // H_CHAIN
        c[quant or "bf16"] = {"bytes": export.nbytes, "page_bytes": page_b,
                              "export_ms": export_ms, "import_ms": import_ms}
        log(f"phase2h(c) {quant or 'bf16'} pool: a {H_CHAIN}-page chain "
            f"({page_b} B a page across {L} layers; {export.nbytes} B with "
            f"the {vocab}-float payload) round trip bit-exact, in place; "
            f"export {export_ms[0]:.3f} ms (its pinned block allocated), "
            f"{export_ms[1]:.3f} ms (reused); import {import_ms[0]:.3f} / "
            f"{import_ms[1]:.3f} ms; a chaos "
            f"kill at kvcache/page_import left {index.alloc.capacity} pages "
            f"free, no node")
        del pools, export, index
    c["prefix_fill"] = {"fleet_prefix_hits": hits, "decode_chunks": 0}
    log(f"phase2h(c): a {H_PROMPT}-token prompt cached on the prefill "
        f"replica, submitted as batch traffic, landed on the decode replica "
        f"through the fleet prefix fill: 1 hit, no prefill chunk there, "
        f"tokens identical")
    out["c"] = c

    # (d) live weights on a full-width cut: seed 0 -> seed 1
    cut = LlamaConfig.llama3_8b(num_layers=H_LAYERS)
    icfg = InferenceConfig(SLOTS, CONTEXT, MAX_TOTAL, torch.bfloat16)
    m0 = LlamaForCausalLM(cut, device=dev).init_random(SEED)
    m1 = LlamaForCausalLM(cut, device=dev).init_random(SEED + 1)
    new = dict(m1.named_parameters())
    d = {}
    # a 2-replica rolling update over one shared model, under traffic
    shared = ParallelInferenceModel(m0, icfg)
    led_d = CompileLedger()
    made_d = EngineLog(shared, ledgers=True, compile_ledger=led_d)
    health = FleetHealth(path=os.path.join(tmp, "alerts_roll.jsonl"),
                         eval_every=1)
    router = FleetRouter([Replica(i, made_d) for i in range(2)],
                         policy="round_robin", health=health)
    drive(router, make_requests(vocab, 2 * SLOTS, 8, SEED + 32))
    led_d.declare_warmup_done()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params0 = [e.memory_ledger.subsystems()["params"]["bytes"]
               for e in made_d.made]
    zero_paged_counts()
    calls0 = made_d.decode_calls()
    seen = []
    swaps = os.path.join(tmp, "swaps")
    os.makedirs(swaps)

    def roll(step):
        if step == 2:
            router.rolling_update(new, swaps_dir=swaps)
        if router.roll_status() is not None:
            seen.append(tuple(r.describe()["weights_version"]
                              for r in router.replicas.values()))

    reqs = make_requests(vocab, 2 * SLOTS, H_NEW, SEED + 33)
    t0 = time.perf_counter()
    outs = drive(router, reqs, roll)
    torch.cuda.synchronize()
    roll_s = time.perf_counter() - t0
    check_served("phase2h(d) roll", outs, reqs)
    routes = check_routes("phase2h(d) roll",
                          (made_d.decode_calls() - calls0) * H_LAYERS, 0)
    while router.roll_status() is not None:
        router.step()
    versions = [r.describe()["weights_version"]
                for r in router.replicas.values()]
    mem1 = torch.cuda.memory_allocated()
    peak_roll = torch.cuda.max_memory_allocated()
    params1 = [e.memory_ledger.subsystems()["params"]["bytes"]
               for e in made_d.made]
    recs = []
    for rid in range(2):
        path = os.path.join(swaps, f"replica{rid}_weight_swaps.jsonl")
        validate_jsonl("weight_swap", path)
        recs += [json.loads(line) for line in open(path)]
    storm_edges = [e for e in health.edges() if e["rule"] == "compile_storm"]
    if (sorted(router.last_roll["done"]) != [0, 1] or versions != [1, 1]
            or not any(len(set(v)) > 1 for v in seen) or led_d.storms
            or storm_edges):
        raise AssertionError(f"phase2h(d) roll: {router.last_roll}, "
                             f"versions {versions}, mid-roll {seen}, storms "
                             f"{led_d.storms}, edges {storm_edges}")
    d["roll"] = {"wall_s": roll_s, "versions_seen": sorted(set(seen)),
                 "swap_ms": [r["swap_ms"] for r in recs],
                 "mem_allocated_before": mem0, "mem_allocated_after": mem1,
                 "mem_allocated_peak": peak_roll,
                 "params_bytes_before": params0,
                 "params_bytes_after": params1, "launches_by_route": routes}
    log(f"phase2h(d) rolling update: 2 replicas over one {H_LAYERS}-layer "
        f"full-width model, {len(reqs)} requests in {roll_s:.3f} s, zero "
        f"lost; versions seen mid-roll {sorted(set(seen))}, every replica "
        f"on version 1; swap ms (host clock, each a private copy and its "
        f"captures) {[round(r['swap_ms'], 1) for r in recs]}; no compile "
        f"storm, no compile_storm edge; device memory allocated "
        f"{mem0 / 2**30:.2f} -> {mem1 / 2**30:.2f} GiB (peak "
        f"{peak_roll / 2**30:.2f} GiB), the ledgers' params "
        f"{params0} -> {params1} B; launches by route {routes}")
    router.close()
    health.close()
    del router, made_d, shared, m0
    gc.collect()
    torch.cuda.empty_cache()

    # one warmed graph engine that owns its model swaps in place: a module
    # of its own (the roll's replicas shared m0's for good), seed 0 again
    own = ParallelInferenceModel(
        LlamaForCausalLM(cut, device=dev).init_random(SEED), icfg)
    led_u = CompileLedger()
    eng = ServingEngine(own, page_size=PAGE_SIZE, compile_ledger=led_u)
    for r in make_requests(vocab, SLOTS, 8, SEED + 35):
        eng.submit(r)
    eng.run_until_complete(max_steps=1_000)
    eng.declare_warmup_done()
    mark, captures = led_u.mark(), own.graphs.captures
    stamps = []
    eng.submit(Request(request_id=100, prompt_ids=list(range(1, 65)),
                       max_new_tokens=H_NEW,
                       stream_cb=lambda r, t: stamps.append(
                           r.weights_version)))
    for _ in range(3):
        eng.step()
    if eng._pending is None or eng.shares_model:
        raise AssertionError("phase2h(d): no step in flight at the swap, "
                             f"or a shared module ({eng.shares_model})")
    before = len(stamps)
    path = os.path.join(tmp, "weight_swaps.jsonl")
    sw = WeightSwapper(eng, path=path)
    torch.cuda.synchronize()
    mem_own = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sw.swap(new)
    torch.cuda.synchronize()
    swap_ms = (time.perf_counter() - t0) * 1e3
    # the in-place swap copies from the caller's tensors: no second set
    peak_own = torch.cuda.max_memory_allocated() - mem_own
    param_bytes = sum(p.numel() * p.element_size()
                      for p in own.module.parameters())
    if peak_own > param_bytes // 2:
        raise AssertionError(f"phase2h(d): the in-place swap held "
                             f"{peak_own} B more at its peak (weights "
                             f"{param_bytes} B)")
    sw.close()
    eng.run_until_complete(max_steps=1_000)
    if (stamps[:before + 1] != [0] * (before + 1)
            or set(stamps[before + 1:]) != {1}):
        raise AssertionError(f"phase2h(d): version stamps {stamps}")
    reqs = make_requests(vocab, SLOTS, H_NEW, SEED + 36)
    zero_paged_counts()
    steps0 = eng.decode_steps
    for r in reqs:
        eng.submit(r)
    got = {o.request_id: o.token_ids
           for o in eng.run_until_complete(max_steps=1_000)}
    routes = check_routes("phase2h(d) swapped engine",
                          (eng.decode_steps - steps0) * H_LAYERS, 0)
    compiles = led_u.compiles_since(mark)
    if compiles or own.graphs.captures != captures or led_u.storms:
        raise AssertionError(f"phase2h(d): the swap on an engine owning its "
                             f"model booked {compiles} compile rows, "
                             f"{own.graphs.captures - captures} captures")
    n_recs = validate_jsonl("weight_swap", path)
    eng.close()
    del eng, own
    fresh = ServingEngine(ParallelInferenceModel(m1, icfg),
                          page_size=PAGE_SIZE)
    for r in make_requests(vocab, SLOTS, H_NEW, SEED + 36):
        fresh.submit(r)
    want_d = {o.request_id: o.token_ids
              for o in fresh.run_until_complete(max_steps=1_000)}
    fresh.close()
    del fresh
    diff = [rid for rid in want_d if tuple(got[rid]) != tuple(want_d[rid])]
    if diff or n_recs != 1:
        raise AssertionError(f"phase2h(d): swapped tokens differ from a "
                             f"fresh engine on seed 1's weights for {diff}; "
                             f"{n_recs} swap records")
    d["own"] = {"swap_ms": swap_ms, "compile_rows_after_warmup": compiles,
                "peak_over_before_bytes": peak_own,
                "param_bytes": param_bytes,
                "in_flight_stamp": stamps[before], "launches_by_route": routes}
    log(f"phase2h(d) one warmed graph engine that owns its model: swap to "
        f"seed 1 in {swap_ms:.3f} ms (the in-place copies from the caller's "
        f"tensors, synchronized), peak device memory {peak_own} B over the "
        f"{mem_own} B before it (weights {param_bytes} B), 0 compile rows "
        f"and 0 captures after warm-up; the "
        f"step in flight stamped version {stamps[before]}, later tokens 1; "
        f"{len(reqs)} requests after the swap identical to a fresh engine "
        f"on seed 1's weights; 1 valid weight_swap record; launches by route "
        f"{routes}")
    out["d"] = d
    del m1, new
    shutil.rmtree(tmp, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase2h: {out['wall_s']:.1f} s")
    del pim
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- phase 2i -----------------------------------------------------------------

# serving at tensor-parallel degree 2: two processes share the one card over
# gloo (NCCL refuses two ranks on one device), each holding half of the
# weights and of the pool
TP = 2
# the int8 check's depth cut, and its chunk path's
TP_INT8_LAYERS = 4
# prefill logits at tp = 2 against tp = 1: relative L2 (bf16, the partial
# sums of the row layers added in another order)
TP_PREFILL_REL_TOL = 2e-2
# the greedy streams' least common-prefix share with phase 2's: bf16
# near-ties of the random weights flip a stream's argmax somewhere under
# any change of summation order.  A reorder alone (phase 2's traffic on
# the gather path against the kernel path at tp = 1) keeps 0.245-0.3125
# over weight seeds 0-2, and the floor is its least share less that
# spread, 0.1777, rounded up (tools/torch_tp_divergence.py; tp = 2 kept
# 0.228-0.346 there; NVIDIA H100 80GB HBM3 at 700 W, PERF.md section 6).
# A broken decode keeps only the first tokens, 1/64
TP_PREFIX_SHARE_MIN = 0.178
# one decode step's logits at tp = 2 against tp = 1's after the same 8
# admissions, both fed tp = 1's first tokens (each engine's own first
# tokens differ at near-ties): relative L2, the prefill's bound.  Over
# weight seeds 0-2 tp = 2 reads 1.822e-2-1.875e-2 with every argmax equal,
# and the gather path at tp = 1, a reorder alone, 1.731e-2-1.795e-2
# (tools/torch_tp_divergence.py, NVIDIA H100 80GB HBM3 at 700 W, PERF.md
# section 6)
TP_DECODE_REL_TOL = 2e-2
# the world's wall-clock limit
TP_WORLD_TIMEOUT_S = 600
# the prompt tokens of 2i(e)'s steady requests
TP_STEADY_PROMPT = 64
# the new tokens of 2i(a)'s and 2i(d)'s requests, half of phase 2's 64
# (the time limit pays for phase 7); over a shorter stream a common-prefix
# share can only rise (min(p, 32) / 32 >= min(p, 64) / 64), so the floor
# set over 64 tokens still holds
TP_NEW_TOKENS = 32
# the prompts whose prefill logits 2i(c) holds against tp = 1's (the
# first half of phase 2's: each prefill at tp = 2 pays 64 host-staged
# collectives)
TP_PREFILL_PROMPTS = 8


def left_padded(prompt):
    """A prompt as the engine prefills it: left-padded to CONTEXT, with its
    validity row."""
    import numpy as np

    ids = np.zeros((1, CONTEXT), np.int64)
    ids[0, CONTEXT - len(prompt):] = prompt
    valid = (np.arange(CONTEXT) >= CONTEXT - len(prompt)).astype(np.int32)
    return ids, valid[None]


def prefix_share(streams: dict, ref: dict) -> float:
    """The tokens each stream shares with its reference before they first
    differ, as a share of all the streams' tokens."""
    same = 0
    for rid, toks in streams.items():
        for a, b in zip(toks, ref[rid]):
            if a != b:
                break
            same += 1
    return same / sum(len(t) for t in streams.values())


def phase2i_refs(model_pim, whole_tokens) -> dict:
    """The tp = 1 references phase 2i holds the tp = 2 ranks to: phase 2's
    model's prefill logits of phase 2's 16 prompts, phase 2's tokens, its
    first tokens and next decode step's logits after 8 admissions, and the
    int8 pool's decode logits of the 4-layer cut after the same admissions
    as 2i(d)'s."""
    import numpy as np
    import torch

    from neuronx_distributed_tpu_torch import (
        InferenceConfig,
        LlamaConfig,
        LlamaForCausalLM,
        ParallelInferenceModel,
    )

    cfg = model_pim.module.config
    prefill = []
    requests = make_requests(cfg.vocab_size, N_REQUESTS, NEW_TOKENS, SEED)
    for r in requests[:TP_PREFILL_PROMPTS]:
        logits, _ = model_pim.prefill_one(*left_padded(r.prompt_ids))
        prefill.append(logits.float().cpu().numpy()[0])
    eng = admitted_engine(model_pim, cfg.vocab_size)
    first = eng._next_tok.copy()
    decode = decode_logits(model_pim, eng, True).cpu().numpy()
    eng.close()
    del eng
    cut = LlamaForCausalLM(LlamaConfig.llama3_8b(num_layers=TP_INT8_LAYERS),
                           device="cuda").init_random(SEED)
    pim = ParallelInferenceModel(cut, InferenceConfig(
        SLOTS, CONTEXT, MAX_TOTAL, torch.bfloat16), cuda_graphs=False)
    eng = admitted_engine(pim, cfg.vocab_size, kv_quant="int8")
    int8 = decode_logits(pim, eng, True).cpu().numpy()
    del eng, pim, cut
    return {"prefill": np.stack(prefill), "tokens": whole_tokens,
            "decode_first": first, "decode_logits": decode,
            "int8_logits": int8}


def phase2i_kernels() -> dict:
    """B4 at one tp = 2 rank's local heads (16 q on 4 kv heads, G = 4):
    the decode route at phase 1's decode shape and the wgmma route at the
    served chunk call, over bf16 and int8 pools, each held to its plain
    version and timed beside the plain version, the library call and the
    bound."""
    geom = dict(nq=NQ // TP, nkv=NKV // TP)
    csrc = "neuronx_distributed_tpu_torch/ops/csrc/"
    entries = {}
    for key, S, int8, route, kw in (
            ("decode", 1, False, "decode", {}),
            ("decode_int8", 1, True, "decode", {}),
            ("chunk", CHUNK_TOKENS, False, "wgmma",
             dict(chunk_offset=CHUNK_OFFSET)),
            ("chunk_int8", CHUNK_TOKENS, True, "wgmma",
             dict(chunk_offset=CHUNK_OFFSET))):
        label = f"phase2i {key} at tp = {TP} local heads"
        t = time_paged(S, int8, (route,), 200 if S == 1 else 100, label,
                       **kw, **geom)
        nb = 1 if kw else B
        name = ("paged_attention_decode" if route == "decode"
                else "paged_attention_wgmma")
        entries[key] = {
            "name": f"{name}{'_int8' if int8 else ''}_tp{TP}",
            "route": "cuda",
            "source": csrc + ("paged_attention_decode.cuh"
                              if route == "decode"
                              else "paged_attention_wgmma.cuh"),
            "replaces": "neuronx_distributed_tpu/ops/paged_attention.py:"
                        + ("211" if int8 else "164"),
            "launches": None, "max_abs_err": t["errs"][route],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library_call": "gather + " + ("kvcache.quant.dequantize_page + "
                                           if int8 else "")
            + "F.scaled_dot_product_attention",
            "split_k": t["split_k"][route],
            "shapes": {"q": [nb, S, NQ // TP, D],
                       "pool": [nb * PP + 1, PAGE, NKV // TP, D],
                       "pool_dtype": "int8" if int8 else "bfloat16",
                       "block_table": [nb, PP], "dtype": "bfloat16",
                       "tp": TP}}
    return entries


def tp_serve(engine, requests, digests):
    """:func:`serve`, with a digest of the engine's block tables after
    each step (the ranks hold the same tables iff the digests agree)."""
    import hashlib

    def step():
        out = engine.step()
        digests.append(hashlib.blake2b(engine._kv.tables.tobytes(),
                                       digest_size=8).hexdigest())
        return out

    outs = {}
    half = len(requests) // 2
    for r in requests[:half]:
        engine.submit(r)
    for r in requests[half:]:
        for o in step():
            outs[o.request_id] = o
        engine.submit(r)
    steps = 0
    while engine.has_work:
        for o in step():
            outs[o.request_id] = o
        steps += 1
        if steps > 10_000:
            raise AssertionError("the tp = 2 engine did not drain")
    return outs


def tp2_rank(refs: dict) -> dict:
    """One rank of phase 2i: Llama-3-8B at full width and depth at tp = 2
    on the shared card, phase 2's traffic, then the int8 and bf16 chunked
    runs on the 4-layer cut.  Every rank makes the same calls; each checks
    its own launches and returns what the parent compares across ranks."""
    import gc

    import numpy as np
    import torch
    import torch.distributed as dist

    from neuronx_distributed_tpu_torch import (
        InferenceConfig,
        LlamaConfig,
        LlamaForCausalLM,
        ParallelInferenceModel,
        ServingEngine,
    )
    from neuronx_distributed_tpu_torch.ops.paged_attention import paged_attention
    from neuronx_distributed_tpu_torch.parallel import mappings, mesh
    from neuronx_distributed_tpu_torch.utils.distributed import (
        initialize_distributed,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(device="cuda", backend="gloo", timeout_s=300)
    mesh.initialize_model_parallel(tensor_parallel_size=TP)
    rank = dist.get_rank()
    tag = f"phase2i rank {rank}"
    cfg = LlamaConfig.llama3_8b()
    L = cfg.num_layers
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda").init_random(SEED)
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    pim = ParallelInferenceModel(model, InferenceConfig(
        SLOTS, CONTEXT, MAX_TOTAL, torch.bfloat16))
    if pim.cuda_graphs or not pim.paged_kernel:
        raise AssertionError(f"{tag}: graphs {pim.cuda_graphs}, kernel "
                             f"{pim.paged_kernel} (want off, on)")
    heads = (model.model.layer_0.attn.qkv.q_kernel.shape[1],
             pim.num_kv_heads)
    torch.cuda.synchronize()
    log(f"{tag}: Llama-3-8B at tp = {TP}, {L} layers, local heads "
        f"{heads[0]} q / {heads[1]} kv, {weight_bytes / 1e9:.3f} GB of "
        f"weights on this rank, random init in "
        f"{time.perf_counter() - t0:.1f} s")

    # (a) phase 2's prompts, TP_NEW_TOKENS each, on the async engine,
    # graphs off
    engine = ServingEngine(pim, page_size=PAGE_SIZE)
    pool_bytes = engine._kv.alloc.num_pages * engine._page_bytes
    requests = make_requests(cfg.vocab_size, N_REQUESTS, TP_NEW_TOKENS, SEED)
    zero_paged_counts()
    mappings.reset_counts()
    lock = engine.lockstep
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    digests: list = []
    outs = tp_serve(engine, requests, digests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = engine.decode_steps
    bad = [(o.request_id, o.state, len(o.token_ids)) for o in outs.values()
           if o.state != "finished" or len(o.token_ids) != TP_NEW_TOKENS]
    if len(outs) != N_REQUESTS or bad:
        raise AssertionError(f"{tag}: requests not served in full: {bad}")
    routes = check_routes(tag, steps * L, 0)
    if paged_attention.launches != steps * L:
        raise AssertionError(f"{tag}: launches {paged_attention.launches}")
    engine._kv.assert_invariants()
    if engine._kv.leaked_pages():
        raise AssertionError(f"{tag}: KV pages leaked")
    tokens = {rid: list(o.token_ids) for rid, o in outs.items()}
    coll_s = sum(mappings.SECONDS.values())
    coll = dict(mappings.COUNTS)
    log(f"{tag}: served {N_REQUESTS} requests, "
        f"{sum(len(t) for t in tokens.values())} tokens in {wall:.3f} s "
        f"over {steps} decode steps ({wall / steps * 1e3:.2f} ms/step incl. "
        f"admissions, two processes time-sliced on one card); decode kernel "
        f"launches {routes['decode']} = {steps} x {L}, by route {routes}; "
        f"collectives {coll} taking {coll_s:.3f} s of host time; clock "
        f"agreement {lock.reads} readings, {lock.seconds:.3f} s; pool "
        f"{engine._kv.alloc.num_pages} pages x {engine._page_bytes} B = "
        f"{pool_bytes / 1e9:.3f} GB on this rank")
    engine.close()
    del engine

    # (c) the prefill logits against tp = 1 (phase 2's model)
    rels = []
    for i, r in enumerate(requests[:TP_PREFILL_PROMPTS]):
        logits, _ = pim.prefill_one(*left_padded(r.prompt_ids))
        got = logits.float().cpu().numpy()[0]
        want = refs["prefill"][i]
        rels.append(float(np.linalg.norm(got - want) / np.linalg.norm(want)))
    first_equal = sum(tokens[rid][0] == refs["tokens"][rid][0]
                      for rid in tokens)
    share = prefix_share(tokens, refs["tokens"])
    # one decode step after 8 admissions, fed tp = 1's first tokens
    eng = admitted_engine(pim, cfg.vocab_size)
    own_first = int((eng._next_tok == refs["decode_first"]).sum())
    lg = decode_logits(pim, eng, True, refs["decode_first"]).cpu().numpy()
    eng.close()
    del eng
    want = refs["decode_logits"]
    decode_rel = float(np.linalg.norm(lg - want) / np.linalg.norm(want))
    decode_agree = int((lg.argmax(-1) == want.argmax(-1)).sum())
    log(f"{tag}: prefill logits against tp = 1, relative L2 max "
        f"{max(rels):.3e} (tol {TP_PREFILL_REL_TOL}); first tokens equal to "
        f"phase 2's {first_equal}/{N_REQUESTS}; greedy streams' common "
        f"prefix with phase 2's {share:.3f} of the tokens (floor "
        f"{TP_PREFIX_SHARE_MIN}); a decode step after {SLOTS} admissions "
        f"fed tp = 1's first tokens (its own equal {own_first}/{SLOTS}): "
        f"relative L2 {decode_rel:.3e} (tol {TP_DECODE_REL_TOL}), argmax "
        f"equal {decode_agree}/{SLOTS}")

    # (e) the steady decode step: host clock, then one profiled pass (no
    # retry: a rank that stepped once more would leave its peer behind)
    eng = ServingEngine(pim, page_size=PAGE_SIZE)
    # short prompts: the decode step is what is timed, and each prefill's
    # collectives go through the host
    for r in make_requests(cfg.vocab_size, SLOTS, 40, SEED + 3):
        r.prompt_ids = r.prompt_ids[:TP_STEADY_PROMPT]
        eng.submit(r)
    for _ in range(2):
        eng.step()
    mappings.reset_counts()
    reads0, lock_s0 = eng.lockstep.reads, eng.lockstep.seconds
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = 10
    for _ in range(n):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / n * 1e3
    coll_ms = sum(mappings.SECONDS.values()) / n * 1e3
    lock_ms = (eng.lockstep.seconds - lock_s0) / n * 1e3
    reads = (eng.lockstep.reads - reads0) / n
    from torch.profiler import ProfilerActivity, profile

    # a short device-only trace: its events are summed on the host
    n_prof = 2
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            eng.step()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) / n_prof * 1e3
    busy_ms = sum(dev_us(e) for e in device_events(prof)) / 1e3 / n_prof
    eng.close()
    del eng
    log(f"{tag}: steady decode step (B={SLOTS}, all slots decoding, two "
        f"processes time-sliced on one card, not tp speed): {step_ms:.2f} "
        f"ms/step host clock; collectives {coll_ms:.2f} ms/step of it "
        f"(gloo, staged through the host), clock agreement {lock_ms:.3f} "
        f"ms/step over {reads:.1f} readings; under the profiler "
        f"{prof_ms:.2f} ms/step with this rank's device busy "
        f"{busy_ms:.3f} ms/step ({busy_ms / prof_ms:.1%})"
        + ("" if busy_ms > 0 else " (the profiler saw no device time: "
           "busy share not measured)"))
    del pim, model
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the 4-layer cut: int8 pages with 128-token chunks, then bf16
    # chunks; the int8 decode logits against tp = 1's
    cut = LlamaForCausalLM(LlamaConfig.llama3_8b(num_layers=TP_INT8_LAYERS),
                           device="cuda").init_random(SEED)
    pim = ParallelInferenceModel(cut, InferenceConfig(
        SLOTS, CONTEXT, MAX_TOTAL, torch.bfloat16))
    cut_runs = {}
    # the bf16 run only puts the wgmma route at the local heads on the
    # path: a quarter of the requests, the int8 run half (the time limit
    # pays for phase 7)
    for label, kw, n in (("int8", dict(kv_quant="int8"), N_REQUESTS // 2),
                         ("bf16", {}, N_REQUESTS // 4)):
        eng = ServingEngine(pim, page_size=PAGE_SIZE,
                            prefill_chunk_tokens=CHUNK_TOKENS, **kw)
        zero_paged_counts()
        got = tp_serve(eng, make_requests(cfg.vocab_size, n, TP_NEW_TOKENS,
                                          SEED), [])
        if any(o.state != "finished" for o in got.values()):
            raise AssertionError(f"{tag}: {label} chunked run unfinished")
        r = check_routes(f"{tag} {label} chunked", eng.decode_steps
                         * TP_INT8_LAYERS, eng.prefill_chunks * TP_INT8_LAYERS)
        if label == "int8" and not (
                paged_attention.int8_launches == paged_attention.launches):
            raise AssertionError(f"{tag}: an int8 run launched a bf16 kernel")
        cut_runs[label] = {"routes": r,
                           "tokens": {i: list(o.token_ids)
                                      for i, o in got.items()},
                           "quant_pages": eng.quant_pages}
        eng._kv.assert_invariants()
        eng.close()
    eng8 = admitted_engine(pim, cfg.vocab_size, kv_quant="int8")
    lg = decode_logits(pim, eng8, True).cpu().numpy()
    eng8.close()
    drift = float(np.linalg.norm(lg - refs["int8_logits"])
                  / np.linalg.norm(refs["int8_logits"]))
    log(f"{tag}: {TP_INT8_LAYERS}-layer cut, {CHUNK_TOKENS}-token chunks: "
        f"int8 launches by route {cut_runs['int8']['routes']} "
        f"({cut_runs['int8']['quant_pages']} pages quantized on write), "
        f"bf16 {cut_runs['bf16']['routes']}; int8 decode logits against "
        f"tp = 1's after the same admissions: relative L2 {drift:.3e} (max "
        f"{INT8_DRIFT_REL_MAX})")
    del eng8, pim, cut
    dist.barrier()
    return {"rank": rank, "tokens": tokens, "digests": digests,
            "routes": routes, "steps": steps, "wall_s": wall,
            "heads": heads, "weight_bytes": weight_bytes,
            "pool_bytes": pool_bytes, "prefill_rel": rels,
            "first_equal": first_equal, "prefix_share": share,
            "decode_rel": decode_rel, "decode_argmax_equal": decode_agree,
            "decode_own_first_equal": own_first,
            "collectives": coll, "collective_s": coll_s,
            "lockstep_reads": lock.reads, "step_ms": step_ms,
            "collective_ms_per_step": coll_ms,
            "clock_agreement_ms_per_step": lock_ms,
            "readings_per_step": reads, "profiled_step_ms": prof_ms,
            "device_busy_ms": busy_ms, "cut": cut_runs, "int8_drift": drift}


def phase2i(refs: dict, entries: dict) -> dict:
    """Serving at tp = 2 on the one card (two processes over gloo):
    Llama-3-8B at full width and depth, phase 2's traffic, the kernels at
    the local heads, the ranks against each other and against tp = 1."""
    from neuronx_distributed_tpu_torch.utils.distributed import spawn

    t_phase = time.perf_counter()
    ranks = spawn(tp2_rank, TP, (refs,), timeout_s=TP_WORLD_TIMEOUT_S,
                  echo=True)
    r0, r1 = ranks
    for key in ("tokens", "digests", "routes", "steps"):
        if r0[key] != r1[key]:
            raise AssertionError(f"phase2i: the ranks disagree on {key}")
    for label in ("int8", "bf16"):
        for key in ("tokens", "routes"):
            if r0["cut"][label][key] != r1["cut"][label][key]:
                raise AssertionError(f"phase2i: the ranks disagree on the "
                                     f"{label} cut's {key}")
    if r0["heads"] != (NQ // TP, NKV // TP):
        raise AssertionError(f"phase2i: local heads {r0['heads']}")
    for r in ranks:
        if not max(r["prefill_rel"]) <= TP_PREFILL_REL_TOL:
            raise AssertionError(f"phase2i: prefill logits off tp = 1's: "
                                 f"{max(r['prefill_rel'])}")
        if r["first_equal"] != N_REQUESTS:
            raise AssertionError(f"phase2i: first tokens equal to phase 2's "
                                 f"{r['first_equal']}/{N_REQUESTS}")
        if not r["prefix_share"] >= TP_PREFIX_SHARE_MIN:
            raise AssertionError(
                f"phase2i: common prefix share {r['prefix_share']} under "
                f"{TP_PREFIX_SHARE_MIN}")
        if not r["decode_rel"] <= TP_DECODE_REL_TOL:
            raise AssertionError(
                f"phase2i: teacher-forced decode logits off tp = 1's: "
                f"{r['decode_rel']} > {TP_DECODE_REL_TOL}")
        if not 0.0 < r["int8_drift"] <= INT8_DRIFT_REL_MAX:
            raise AssertionError(f"phase2i: int8 drift {r['int8_drift']}")
    cut = r0["cut"]
    entries["decode"]["launches"] = r0["routes"]["decode"]
    entries["decode_int8"]["launches"] = cut["int8"]["routes"]["decode"]
    entries["chunk_int8"]["launches"] = cut["int8"]["routes"]["wgmma"]
    entries["chunk"]["launches"] = cut["bf16"]["routes"]["wgmma"]
    for e, phase in ((entries["decode"], "2i"),
                     (entries["decode_int8"], "2i(d)"),
                     (entries["chunk_int8"], "2i(d)"),
                     (entries["chunk"], "2i(d)")):
        e["launches_by_phase"] = {phase: e["launches"]}
    seconds = time.perf_counter() - t_phase
    log(f"phase2i: both ranks served identical tokens and tables; "
        f"weights {r0['weight_bytes'] / 1e9:.3f} + pool "
        f"{r0['pool_bytes'] / 1e9:.3f} GB a rank; phase 2i took "
        f"{seconds:.1f} s")
    keep = ("weight_bytes", "pool_bytes", "steps", "wall_s", "step_ms",
            "collective_ms_per_step", "clock_agreement_ms_per_step",
            "readings_per_step", "profiled_step_ms", "device_busy_ms",
            "collectives", "lockstep_reads", "first_equal", "prefix_share",
            "decode_rel", "decode_argmax_equal", "decode_own_first_equal",
            "int8_drift")
    return {"seconds": seconds,
            "prefill_rel_max": max(max(r["prefill_rel"]) for r in ranks),
            "routes": r0["routes"], "cut_routes": {
                k: v["routes"] for k, v in cut.items()},
            "ranks": [{k: r[k] for k in keep} for r in ranks]}


# -- phase 3 ------------------------------------------------------------------

# the training path's attention shape: Llama-3-8B heads at batch 4 x 2048
FB, FHQ, FHKV, FS, FD = 4, 32, 8, 2048, 128
# the flash cases: (name, B, HQ, HKV, S, T, D, causal, window, softcap,
# sm_scale, segments, lse cotangent[, model layout]); the first is the
# path's own shape.  Model layout: q, k, v and dO are [B, H, S, D] views of
# [B, S, H, D] memory, as the model passes them (o inherits the strides)
FLASH_CASES = [
    ("path_shape", FB, FHQ, FHKV, FS, FS, FD, True, None, None, None, False,
     False),
    ("path_shape_model_layout", FB, FHQ, FHKV, FS, FS, FD, True, None, None,
     None, False, False, True),
    # Gemma-2B's MQA (8 q heads on one kv head) with a window and a softcap
    # together: interior and edge tiles under both options at once
    ("mqa_g8_window_softcap", 1, 8, 1, 1000, 1000, 128, True, 256, 50.0,
     SOFTCAP_SCALE, False, False),
    # T < S: the first S - T queries come before every key and see none
    ("no_key_rows", 2, 8, 2, 700, 300, 128, True, None, None, None, False,
     False),
    ("causal_gqa4", 2, 32, 8, 1000, 1000, 128, True, None, None, None, False,
     False),
    ("noncausal_g1", 2, 8, 8, 520, 520, 128, False, None, None, None, False,
     False),
    ("t_gt_s", 2, 8, 2, 300, 700, 128, True, None, None, None, False, False),
    # sm_scale 2.0 makes the softmax near one-hot, so dropping the window
    # changes which key wins (at D^-0.5 it only reweighs a wide average)
    ("window256", 1, 8, 2, 1100, 1100, 128, True, 256, None, SOFTCAP_SCALE,
     False, False),
    ("softcap50", 1, 8, 2, 512, 512, 128, True, None, 50.0, SOFTCAP_SCALE,
     False, False),
    ("segments", 2, 8, 2, 777, 777, 128, True, None, None, None, True, False),
    ("lse_cotangent", 2, 8, 2, 400, 400, 128, True, None, None, None, True,
     True),
    ("causal_d64", 2, 8, 2, 333, 333, 64, True, None, None, None, False,
     False),
    # packed documents under a window at D = 64: segmented tiles and window
    # edges of the 128-key dk/dv blocks together
    ("segments_window_d64", 2, 8, 2, 777, 777, 64, True, 128, None, None,
     True, False),
]
# Gemma-2-2B's training attention: batch 1 x 8192, 8 q heads on 4 kv
# heads, head_dim 256, score scale 1/16; even layers slide over 4096 keys
GB, GHQ, GHKV, GS, GD, G2_WINDOW = 1, 8, 4, 8192, 256, 4096
FLASH_CASES_D256 = [
    ("gemma2_path_global", GB, GHQ, GHKV, GS, GS, GD, True, None, None,
     G2_SCALE, False, False),
    ("gemma2_path_window", GB, GHQ, GHKV, GS, GS, GD, True, G2_WINDOW, None,
     G2_SCALE, False, False),
    ("softcap50_d256", 1, 8, 4, 1024, 1024, GD, True, None, G2_CAP,
     SOFTCAP_SCALE, False, False),
    ("gemma_mqa_g8_d256", 2, 8, 1, 1000, 1000, GD, True, None, None, None,
     False, False),
    ("segments_d256", 2, 8, 4, 777, 777, GD, True, None, None, None, True,
     False),
    ("t_gt_s_d256", 1, 8, 4, 300, 700, GD, True, None, None, None, False,
     False),
    ("lse_cotangent_d256", 2, 8, 4, 400, 400, GD, True, None, None, None,
     True, True),
    ("no_key_rows_d256", 1, 8, 4, 500, 200, GD, True, None, None, None, False,
     False, True),
    # MQA at D = 256 with window and softcap: the in-kernel sum over G = 8 q
    # heads, the dk/dv hand-over between the consumers, ragged key tiles
    ("mqa_g8_window_softcap_d256", 1, 8, 1, 1000, 1000, GD, True, 256,
     G2_CAP, SOFTCAP_SCALE, False, False),
]
FLASH_KERNELS = {
    "fwd": ("flash_attention_fwd", WGMMA_KERNELS["fwd"][1], 4, 154),
    "dq": ("flash_attention_dq", WGMMA_KERNELS["dq"][1], 6, 311),
    "dkv": ("flash_attention_dkv", WGMMA_KERNELS["dkv"][1], 8, 368),
}


def row_norms(ref):
    """L2 norm of every row (over D) of a reference, and the median
    nonzero row's norm."""
    import torch

    norms = ref.float().norm(dim=-1)
    nonzero = norms[norms > 0]
    return norms, (nonzero.median() if nonzero.numel() else torch.ones(()))


def row_err(out, ref) -> float:
    """The largest relative L2 error of one row (over D): ``|out - ref| /
    max(|ref|, median / 10)`` per q row (o, dq) or key row (dk, dv).
    Each row is held to its own size, so a late row whose values are
    small (o over ~1000 keys, a late key's dk/dv) is held as tightly as
    an early one.  The floor covers rows that are zero or nearly so:
    empty query rows, padded keys, and the dq of a row whose softmax is
    one-hot (the window case at sm_scale 2.0), where dS sums to zero and
    what is left is rounding, in the fp32 plain version as well."""
    norms, median = row_norms(ref)
    diff = (out.float() - ref.float()).norm(dim=-1)
    return (diff / norms.clamp(min=median / 10)).max().item()


def median_row_rms(ref) -> float:
    """The typical size of a reference's elements: the median nonzero
    row's RMS over D."""
    return (row_norms(ref)[1] / ref.shape[-1] ** 0.5).item()


def flash_inputs(case, dtype, device, seed):
    """Seeded inputs of one case; segment ids are three documents and a
    padding run (id 0) at random cut points."""
    import numpy as np
    import torch

    _, B, HQ, HKV, S, T, D = case[:7]
    segs, lse_cot = case[11], case[12]
    model_layout = len(case) > 13 and case[13]
    rs = np.random.RandomState(seed)

    def f(*shape):
        x = torch.from_numpy(rs.standard_normal(shape).astype(
            np.float32)).to(device, dtype)
        return (x.transpose(1, 2).contiguous().transpose(1, 2)
                if model_layout else x)

    q, k, v, do = f(B, HQ, S, D), f(B, HKV, T, D), f(B, HKV, T, D), \
        f(B, HQ, S, D)
    qs = ks = None
    if segs:
        ids = np.zeros((B, T), np.int32)
        cuts = sorted(rs.choice(np.arange(16, T - 16), 3, replace=False))
        for i, (a, b) in enumerate(zip([0] + cuts[:2], cuts)):
            ids[:, a:b] = i + 1
        ks = torch.from_numpy(ids).to(device)
        qs = ks[:, T - S:].contiguous()
    dlse = (torch.from_numpy(rs.standard_normal((B, HQ, S)).astype(
        np.float32)).to(device) if lse_cot else None)
    return q, k, v, do, qs, ks, dlse


def flash_bound_ms(B, HQ, HKV, S, T, D, item, which, window=None) -> tuple:
    """Least time for one kernel call at a causal shape.  Operations: per
    visible (q, k) pair 4D (q.k and p.v), 6D for dq (q.k, dO.v, dS.k) and
    8D for dk/dv (q.k, dO.v, p^T.dO, dS^T.q), at the peak of the inputs'
    type; ``which="bwd"`` is one call producing dq, dk and dv together
    (SDPA's backward), 10D per pair (q.k, dO.v, p^T.dO, dS.k, dS^T.q).
    Bytes: each input read once, each output written once."""
    from neuronx_distributed_tpu_torch.ops.flash_attention import (
        visible_pairs,
    )

    pairs = B * HQ * visible_pairs(S, T, True, window)
    per = {"bwd": 10}.get(which) or FLASH_KERNELS[which][2]
    flops = per * D * pairs
    qd, kd = B * HQ * S * D * item, B * HKV * T * D * item
    rows = B * HQ * S * 4
    nbytes = {"fwd": qd + 2 * kd + qd + rows,           # q k v -> o lse
              "dq": 2 * qd + 2 * kd + 2 * rows + qd,    # q k v do lse delta -> dq
              "dkv": 2 * qd + 2 * kd + 2 * rows + 2 * kd,
              # q k v o do lse -> dq dk dv
              "bwd": 3 * qd + 2 * kd + rows + qd + 2 * kd}[which]
    t_ops = flops / PEAK_FLOPS["bfloat16" if item == 2 else "float32"]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", flops, nbytes)


def hold_flash_cases(cases, worst: dict, worst_lse: dict,
                     seed0: int = 0) -> None:
    """Each case in bf16 and fp32: the three kernels against their plain
    versions row by row (TOL), the lse (LSE_TOL), finite outputs, empty
    rows zero, and each option of the case biting (BITE).  ``worst``
    (bf16, per kernel) and ``worst_lse`` (per dtype) collect the largest
    errors.  Case ``i`` draws its inputs from seed ``SEED + seed0 + i``."""
    import torch

    from neuronx_distributed_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    for ci, case in enumerate(cases):
        name, B, HQ, HKV, S, T, D, causal, window, softcap, scale = case[:11]
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).replace("torch.", "")
            q, k, v, do, qs, ks, dlse = flash_inputs(case, dtype, dev,
                                                     SEED + seed0 + ci)
            opts = dict(causal=causal, sm_scale=scale, window=window,
                        softcap=softcap)
            o, lse = fa.flash_attention_fwd(q, k, v, qs, ks, **opts)
            delta = (do.float() * o.float()).sum(-1)
            if dlse is not None:
                delta = delta - dlse
            dq = fa.flash_attention_dq(q, k, v, do, lse, delta, qs, ks,
                                       **opts)
            dk, dv = fa.flash_attention_dkv(q, k, v, do, lse, delta, qs, ks,
                                            **opts)
            torch.cuda.synchronize()
            f32 = [x.float() for x in (q, k, v)]
            ro, rlse = fa.flash_fwd_reference(*f32, qs, ks, **opts)
            rdq = fa.flash_dq_reference(*f32, do.float(), lse, delta, qs, ks,
                                        **opts)
            rdk, rdv = fa.flash_dkv_reference(*f32, do.float(), lse, delta,
                                              qs, ks, **opts)
            live = rlse > fa.NEG_INF / 2
            errs = {"fwd": [row_err(o, ro)], "dq": [row_err(dq, rdq)],
                    "dkv": [row_err(dk, rdk), row_err(dv, rdv)]}
            lse_err = (lse[live] - rlse[live]).abs().max().item()
            typical = {n: median_row_rms(r) for n, r in (
                ("o", ro), ("dq", rdq), ("dk", rdk), ("dv", rdv))}
            abs_errs = {
                "fwd": (o.float() - ro.float()).abs().max().item(),
                "dq": (dq.float() - rdq.float()).abs().max().item(),
                "dkv": max((dk.float() - rdk.float()).abs().max().item(),
                           (dv.float() - rdv.float()).abs().max().item())}
            finite = all(bool(torch.isfinite(x.float()).all())
                         for x in (o, lse, dq, dk, dv))
            # rows with no visible key (padding, a segment absent from the
            # keys, queries before every key): o = 0 and dq = 0 exactly,
            # lse NEG_INF
            empty_ok = bool((lse[~live] <= -1e29).all()) and bool(
                (o.float()[~live] == 0).all()) and bool(
                (dq.float()[~live] == 0).all())
            bites = {}
            for opt in ("window", "softcap"):
                if opts[opt] is not None:
                    without = dict(opts, **{opt: None})
                    bites[opt] = row_err(fa.flash_fwd_reference(
                        *f32, qs, ks, **without)[0], ro)
            if qs is not None:
                bites["segments"] = row_err(fa.flash_fwd_reference(
                    *f32, **opts)[0], ro)
            log(f"phase3: {name} {dn} B={B} HQ={HQ} HKV={HKV} S={S} T={T} "
                f"D={D} largest row rel err o {errs['fwd'][0]:.3e} dq "
                f"{errs['dq'][0]:.3e} dk {errs['dkv'][0]:.3e} dv "
                f"{errs['dkv'][1]:.3e} (tol {TOL[dn]}); lse abs err "
                f"{lse_err:.3e} (tol {LSE_TOL[dn]}); median row rms "
                + " ".join(f"{n} {t:.3e}" for n, t in typical.items())
                + f"; max abs err o {abs_errs['fwd']:.3e} dq "
                f"{abs_errs['dq']:.3e} dk/dv {abs_errs['dkv']:.3e}; "
                f"empty rows {int((~live).sum())}" + "".join(
                    f"; without {o_} the plain output moves {d:.3e}"
                    for o_, d in bites.items()))
            for w, es in errs.items():
                if not max(es) <= TOL[dn]:
                    raise AssertionError(
                        f"flash {w} disagrees with its plain version: "
                        f"{es} > {TOL[dn]} in {name} {dn}")
                if dtype == torch.bfloat16:
                    worst[w]["row_rel"] = max(worst[w]["row_rel"], max(es))
                    worst[w]["abs"] = max(worst[w]["abs"], abs_errs[w])
            if not lse_err <= LSE_TOL[dn]:
                raise AssertionError(f"flash fwd lse disagrees with its plain "
                                     f"version: {lse_err} > {LSE_TOL[dn]} in "
                                     f"{name} {dn}")
            worst_lse[dn] = max(worst_lse[dn], lse_err)
            if not finite or not empty_ok:
                raise AssertionError(f"non-finite output or nonzero o or dq "
                                     f"in rows that see no key in {name} "
                                     f"{dn}")
            for opt, d in bites.items():
                if not d > BITE * TOL[dn]:
                    raise AssertionError(
                        f"{opt} moves the plain output by only {d} in "
                        f"{name}: the case cannot catch a kernel that "
                        f"ignores it")
            del q, k, v, do, o, lse, dq, dk, dv, ro, rdq, rdk, rdv, f32
            torch.cuda.empty_cache()


def variant_key(window, softcap) -> str:
    """The kernels-line key of a timing variant: ``window4096``,
    ``softcap50``, ``window4096_softcap50``."""
    return "_".join(f"{n}{v:g}" for n, v in (("window", window),
                                              ("softcap", softcap))
                    if v is not None)


def time_flash(shape, sm_scale=None, variants=((None, None),), worst=None,
               source="neuronx_distributed_tpu_torch/ops/csrc/"
                      "flash_attention.cu", suffix="") -> dict:
    """B1-B3 at one causal bf16 ``shape = (B, HQ, HKV, S, D)``, ROTATE
    input copies: device ms per call of each kernel for every ``(window,
    softcap)`` in ``variants`` (the first is the entry's own, and has
    neither, like the yardstick), of its plain version and of the library
    yardstick (SDPA forward for B1, its autograd backward, dq, dk and dv
    together, for B2 and B3; causal, no window or softcap), each held to
    its bound.  Returns one kernels-line entry per kernel (``launches``
    filled in by the training phase)."""
    import torch
    import torch.nn.functional as F

    from neuronx_distributed_tpu_torch.ops import flash_attention as fa

    Bt, HQ, HKV, S, Dt = shape
    dev = torch.device("cuda")
    copies = {}
    # the inputs do not depend on the variant: each copy's q, k, v and dO
    # are made once (on the host, the slow part at 8192 keys) and shared
    case = ("timing", Bt, HQ, HKV, S, S, Dt, True, None, None, sm_scale,
            False, False)
    inputs = [flash_inputs(case, torch.bfloat16, dev, SEED + 100 + i)[:4]
              for i in range(ROTATE)]
    for window, softcap in variants:
        opts = dict(sm_scale=sm_scale, window=window, softcap=softcap)
        copies[window, softcap] = []
        for q, k, v, do in inputs:
            o, lse = fa.flash_attention_fwd(q, k, v, **opts)
            delta = (do.float() * o.float()).sum(-1)
            copies[window, softcap].append((q, k, v, do, lse, delta))
    torch.cuda.synchronize()
    first = copies[variants[0]]
    lib_fwd = [lambda c=c: F.scaled_dot_product_attention(
        c[0], c[1], c[2], is_causal=True, scale=sm_scale, enable_gqa=True)
        for c in first]
    lib_bwd = []
    for c in first[:2]:
        leaves = [x.detach().requires_grad_() for x in c[:3]]
        out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                             scale=sm_scale, enable_gqa=True)
        lib_bwd.append(lambda out=out, leaves=leaves, do=c[3]:
                       torch.autograd.grad(out, leaves, do,
                                           retain_graph=True))
    lib_err = row_err(lib_fwd[0](), fa.flash_attention_fwd(
        *first[0][:3], sm_scale=sm_scale)[0])
    label = f"B={Bt} HQ={HQ} HKV={HKV} S=T={S} D={Dt} bf16 causal"
    fwd_names, bwd_names = [], []
    lib_fwd_ms = device_ms(lib_fwd, 20, show=f"phase3 SDPA forward {label}",
                           names=fwd_names)
    lib_bwd_ms = device_ms(lib_bwd, 10, show=f"phase3 SDPA backward {label}",
                           names=bwd_names)
    lib_fwd_ms = check_events("SDPA forward", lib_fwd_ms, lib_fwd[0], 20,
                              retrace=lambda: device_ms(lib_fwd, 20))
    lib_bwd_ms = check_events("SDPA backward", lib_bwd_ms, lib_bwd[0], 10,
                              retrace=lambda: device_ms(lib_bwd, 10))
    lib_fwd_ms = check_bound(
        "SDPA forward", {"library": lib_fwd_ms},
        flash_bound_ms(Bt, HQ, HKV, S, S, Dt, 2, "fwd")[0],
        retake={"library": lambda: device_ms(lib_fwd, 20)})["library"]
    lib_bwd_ms = check_bound(
        "SDPA backward", {"library": lib_bwd_ms},
        flash_bound_ms(Bt, HQ, HKV, S, S, Dt, 2, "bwd")[0],
        retake={"library": lambda: device_ms(lib_bwd, 10)})["library"]
    log(f"phase3 ({label}): library forward agrees with the kernel to "
        f"{lib_err:.2e} (largest row relative error, scale {sm_scale})")
    entries = {}
    for w, (fn_name, kname, _, line) in FLASH_KERNELS.items():
        kernel = getattr(fa, fn_name)
        plain = {"fwd": fa.flash_fwd_reference, "dq": fa.flash_dq_reference,
                 "dkv": fa.flash_dkv_reference}[w]
        nargs = 3 if w == "fwd" else 6
        by_variant = {}
        for window, softcap in variants:
            opts = dict(sm_scale=sm_scale, window=window, softcap=softcap)
            cs = copies[window, softcap]
            calls = [lambda c=c: kernel(*c[:nargs], **opts) for c in cs]
            count = lambda: kernel.launches  # noqa: E731
            retake = {"kernel": lambda: device_ms(calls, 20, expect=kname,
                                                  launched=count)}
            b_ms, b_by, flops, nbytes = flash_bound_ms(
                Bt, HQ, HKV, S, S, Dt, 2, w, window)
            k_ms = check_events(
                fn_name, retake["kernel"](),
                lambda: kernel(*cs[0][:nargs], **opts), 20,
                retrace=retake["kernel"])
            times = {"kernel": k_ms}
            if (window, softcap) == variants[0]:
                retake["plain"] = lambda: device_ms(
                    [lambda c=c: plain(*c[:nargs], **opts) for c in cs[:2]],
                    2)
                times["plain"] = retake["plain"]()
            times = check_bound(f"{fn_name} {label} window {window} softcap "
                                f"{softcap}", times, b_ms, retake=retake)
            k_ms = times["kernel"]
            log(f"phase3 timing {fn_name} ({label}, window {window}, "
                f"softcap {softcap}), "
                f"device ms per call from torch.profiler: kernel "
                f"{k_ms:.5f}" + (f", plain {times['plain']:.5f}"
                                 if "plain" in times else "")
                + f", library {lib_fwd_ms if w == 'fwd' else lib_bwd_ms:.5f}"
                f" ({'SDPA forward' if w == 'fwd' else 'SDPA backward, dq+dk+dv'}"
                f", causal, no window); bound {b_ms:.5f} ({b_by}: "
                f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB), kernel / "
                f"bound {k_ms / b_ms:.2f}, "
                f"{flops / (k_ms * 1e-3) / 1e12:.1f} TFLOP/s")
            by_variant[window, softcap] = dict(times, bound_ms=b_ms,
                                               bound_by=b_by, flops=flops)
        own = by_variant[variants[0]]
        entries[w] = {
            "name": fn_name + suffix,
            "route": "cuda",
            "source": source,
            "replaces": f"neuronx_distributed_tpu/ops/flash_attention.py:{line}",
            "launches": None,
            "max_abs_err": worst[w]["abs"],
            "max_err": worst[w]["row_rel"],
            "max_err_is": "largest relative L2 error of one row, bf16",
            "tolerance": TOL["bfloat16"],
            "ms": own["kernel"],
            "plain_ms": own["plain"],
            "bound_ms": own["bound_ms"],
            "bound_by": own["bound_by"],
            "library_ms": lib_fwd_ms if w == "fwd" else lib_bwd_ms,
            "library_call": ("F.scaled_dot_product_attention forward"
                             if w == "fwd" else
                             "F.scaled_dot_product_attention backward "
                             "(dq, dk and dv together)"),
            "library_kernel": (fwd_names if w == "fwd" else bwd_names)[0],
            "shapes": {"q": [Bt, HQ, S, Dt], "kv": [Bt, HKV, S, Dt],
                       "dtype": "bfloat16", "causal": True,
                       "sm_scale": sm_scale},
        }
        for var in variants[1:]:
            entries[w][variant_key(*var)] = {
                "ms": by_variant[var]["kernel"],
                "bound_ms": by_variant[var]["bound_ms"],
                "bound_by": by_variant[var]["bound_by"]}
    log(f"phase3 ({label}): dq + dk/dv {entries['dq']['ms'] + entries['dkv']['ms']:.5f}"
        f" ms against SDPA's backward {lib_bwd_ms:.5f} ms: "
        f"{(entries['dq']['ms'] + entries['dkv']['ms']) / lib_bwd_ms:.2f}x")
    del copies, lib_fwd, lib_bwd
    torch.cuda.empty_cache()
    return entries


def phase3():
    """The flash kernels held against their plain versions (the D 64/128
    cases and the D 256 cases of the Gemma slice), then timed at the Llama
    training shape (D 128) and at Gemma-2-2B's (D 256, global and
    sliding-window layers)."""
    import torch

    new_worst = lambda: {w: {"abs": 0.0, "row_rel": 0.0}  # noqa: E731
                         for w in FLASH_KERNELS}
    worst, worst256 = new_worst(), new_worst()
    worst_lse = {"bfloat16": 0.0, "float32": 0.0}
    hold_flash_cases(FLASH_CASES, worst, worst_lse)
    hold_flash_cases(FLASH_CASES_D256, worst256, worst_lse,
                     seed0=len(FLASH_CASES))
    entries = time_flash((FB, FHQ, FHKV, FS, FD), worst=worst)
    entries["fwd"]["lse_max_abs_err"] = worst_lse
    # both layer kinds, and each with Gemma-2's softcap, which the training
    # path runs (the no-softcap global layer is the one held to SDPA)
    gemma = time_flash(
        (GB, GHQ, GHKV, GS, GD), G2_SCALE,
        ((None, None), (G2_WINDOW, None), (None, G2_CAP), (G2_WINDOW, G2_CAP)),
        worst256,
        "neuronx_distributed_tpu_torch/ops/csrc/flash_attention_d256.cu",
        "_d256")
    torch.cuda.empty_cache()
    return entries, gemma


# -- phase 4 ------------------------------------------------------------------

TRAIN_LAYERS, TRAIN_B, TRAIN_S, TRAIN_CHUNK = 4, 4, 2048, 512
WARMUP_STEPS, TIMED_STEPS = 2, 10
# one step through the flash and the dense core on the same weights and
# batch, in bf16 compute (the path's) and in fp32: relative difference of
# the loss, of the grad norm, and the largest relative L2 difference of
# one attention projection's gradient (qkv, o_proj: these depend on the
# flash kernels, where the loss at random init hardly does).  bf16 limits
# are about 10x the readings for loss and norm; the projection gradients
# read 1-2.3e-2 in bf16 (rounding through 4 layers, summed over 2048
# tokens), so the tight check of them is the fp32 one
FLASH_DENSE_RTOL = {"bfloat16": (5e-4, 6e-4, 5e-2),
                    "float32": (1e-4, 1e-4, 1e-4)}


def loss_and_grads(model, loss_fn, batch) -> tuple:
    """One forward and backward: the loss, the global grad norm and the
    gradients of the attention projections by name."""
    from neuronx_distributed_tpu_torch.parallel.grads import get_grad_norm

    loss_sum, tok = loss_fn(model, batch)
    loss = loss_sum / tok
    loss.backward()
    norm = get_grad_norm([p.grad for p in model.parameters()])
    attn = {n: p.grad.clone() for n, p in model.named_parameters()
            if ".qkv." in n or ".o_proj." in n}
    model.zero_grad(set_to_none=True)
    return loss.item(), norm.item(), attn


def flash_vs_dense(label, model_cls, cfg, state, loss_fn, batch,
                   dtype) -> list:
    """One step's loss, grad norm and attention-projection gradients
    through the flash and the dense core, on ``model_cls`` models loaded
    with the same weights ``state`` and computing in ``dtype``; fails
    beyond :data:`FLASH_DENSE_RTOL`."""
    import dataclasses

    import torch

    runs = {}
    for impl in ("flash", "dense"):
        model = model_cls(dataclasses.replace(
            cfg, attention_impl=impl, dtype=dtype),
            device=batch["ids"].device)
        model.load_state_dict(state)
        runs[impl] = loss_and_grads(model, loss_fn, batch)
        del model
        torch.cuda.empty_cache()
    f, d = runs["flash"], runs["dense"]
    rel = [abs(a - b) / abs(b) for a, b in zip(f[:2], d[:2])]
    attn_rel = {n: ((g - d[2][n]).norm() / d[2][n].norm()).item()
                for n, g in f[2].items()}
    worst_leaf = max(attn_rel, key=attn_rel.get)
    rel.append(attn_rel[worst_leaf])
    name = str(dtype).replace("torch.", "")
    tol = FLASH_DENSE_RTOL[name]
    log(f"{label}: one step at batch {tuple(batch['ids'].shape)} in {name} "
        f"compute, {cfg.num_layers} layers, flash vs dense core: loss "
        f"{f[0]:.6f} vs {d[0]:.6f} (rel {rel[0]:.2e}, tol {tol[0]}), grad "
        f"norm {f[1]:.6f} vs {d[1]:.6f} (rel {rel[1]:.2e}, tol {tol[1]}); "
        f"attention projection gradients, relative L2 difference: "
        + ", ".join(f"{n} {r:.2e}" for n, r in attn_rel.items())
        + f" (largest {worst_leaf}, tol {tol[2]})")
    if not all(r <= t for r, t in zip(rel, tol)):
        raise AssertionError(f"flash and dense cores disagree in {name}: "
                             f"{rel} against {tol}")
    return rel


def train_steps(label, config, model, loss_fn, batch, fwd_per_layer,
                flash_entries, generator=None, flops=None) -> dict:
    """The training main path after ``initialize_parallel_model``: the
    optimizer, ``make_train_step``, WARMUP_STEPS + TIMED_STEPS steps on
    ``batch`` (each given ``generator``, the dropout stream) with every
    launch count set to 0 first.  Checks finite and falling losses and the
    flash launches (``fwd_per_layer`` forwards, one dq and one dk/dv per
    layer and step; written into ``flash_entries``; None: the path runs
    the dense core, so no flash launch at all), then reports tokens/s, MFU
    (``flops``: ``(flops_per_token, formula)``, default the Llama family's
    ``transformer_flops_per_token``), peak memory and where a profiled
    step's device time goes."""
    import torch

    from neuronx_distributed_tpu_torch.ops import flash_attention as fa
    from neuronx_distributed_tpu_torch.ops.paged_attention import paged_attention
    from neuronx_distributed_tpu_torch.trainer import (
        initialize_parallel_optimizer,
        make_train_step,
        mfu,
        transformer_flops_per_token,
    )

    cfg = model.module.config
    Bt, St = batch["ids"].shape
    opt = initialize_parallel_optimizer(config, model)
    train = make_train_step(config, model, opt, loss_fn)

    def step(b):
        return train(b, generator)

    torch.cuda.reset_peak_memory_stats()
    # the main path: every launch count from 0 over the 12 steps
    for fn in (fa.flash_attention_fwd, fa.flash_attention_dq,
               fa.flash_attention_dkv, paged_attention):
        fn.launches = 0
    losses, norms = [], []
    for _ in range(WARMUP_STEPS):
        m = step(batch)
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        m = step(batch)
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {w: getattr(fa, FLASH_KERNELS[w][0]).launches
                for w in FLASH_KERNELS}
    steps = WARMUP_STEPS + TIMED_STEPS
    losses = [x.item() for x in losses]
    norms = [x.item() for x in norms]
    peak = torch.cuda.max_memory_allocated()
    tok_s = Bt * St * TIMED_STEPS / wall
    if flops is None:
        flops = (transformer_flops_per_token(
            cfg.num_layers, cfg.hidden_size, cfg.intermediate_size,
            cfg.vocab_size, St, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim_), "6N + attention")
    fpt, formula = flops
    util = mfu(tok_s, fpt, PEAK_FLOPS["bfloat16"])
    L = cfg.num_layers
    want = ({w: 0 for w in FLASH_KERNELS} if fwd_per_layer is None else
            {"fwd": steps * L * fwd_per_layer, "dq": steps * L,
             "dkv": steps * L})
    log(f"{label}: {steps} steps at batch {Bt} x {St}, remat {cfg.remat}, "
        f"lr {config.optimizer.learning_rate}, clip "
        f"{config.optimizer.max_grad_norm}: losses "
        + ", ".join(f"{x:.4f}" for x in losses) + "; grad norms "
        + ", ".join(f"{x:.3f}" for x in norms))
    log(f"{label}: {TIMED_STEPS} timed steps in {wall:.3f} s = "
        f"{wall / TIMED_STEPS * 1e3:.1f} ms/step, {tok_s:.1f} tokens/s, "
        f"MFU {util:.4f} ({fpt / 1e9:.3f} GFLOP/token, {formula}, "
        f"against 989 TFLOP/s bf16); peak memory {peak / 2**30:.2f} GiB; "
        f"flash launches {launches}, expected {want} ({steps} steps x {L} "
        f"layers, {fwd_per_layer} forward(s) per layer under remat "
        f"{cfg.remat})")
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"non-finite loss or grad norm: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    if launches != want:
        raise AssertionError(f"flash launches {launches}, expected {want}")
    for w, n in launches.items():
        if flash_entries is not None:
            flash_entries[w]["launches"] = n

    # where a step's device time goes
    prof_wall = []

    def run():
        t0 = time.perf_counter()
        for _ in range(2):
            step(batch)
        torch.cuda.synchronize()
        prof_wall.append(time.perf_counter() - t0)

    for attempt in range(1, TRACE_TRIES + 1):  # see device_ms
        events = trace(run, lambda: step(batch))
        busy_ms = sum(dev_us(e) for e in events) / 1e3 / 2
        if busy_ms > 0:
            break
        log(f"{label}: torch.profiler trace {attempt}/{TRACE_TRIES} of two "
            f"steps shows no device time")
    else:
        raise AssertionError("the profiler saw no device time")
    prof_ms = prof_wall[-1] / 2 * 1e3
    flash_ms = sum(dev_us(e) for e in events if "flash_" in e.key) / 1e3 / 2
    flash_by = {w: sum(dev_us(e) for e in events
                       if FLASH_KERNELS[w][1] in e.key) / 1e3 / 2
                for w in FLASH_KERNELS}
    top = sorted(events, key=dev_us, reverse=True)[:8]
    log(f"{label} profiled step: {prof_ms:.1f} ms wall, device busy "
        f"{busy_ms:.1f} ms ({busy_ms / prof_ms:.1%}), flash kernels "
        f"{flash_ms:.2f} ms ({flash_ms / busy_ms:.1%} of device time)"
        + ("" if fwd_per_layer is None else ": " + ", ".join(
            f"{w} ({FLASH_KERNELS[w][1]}) {ms:.2f} ms"
            for w, ms in flash_by.items()) + " per step"))
    log(f"{label} top device time per step: " + "; ".join(
        f"{e.key[:60]} {dev_us(e) / 1e3 / 2:.2f} ms" for e in top))
    del opt, train, step
    return {"layers": L, "params": model.num_parameters(), "steps": steps,
            "batch": [Bt, St], "remat": cfg.remat, "losses": losses,
            "grad_norms": norms, "step_ms": wall / TIMED_STEPS * 1e3,
            "tok_s": tok_s, "mfu": util, "flops_per_token": fpt,
            "flops_formula": formula,
            "peak_gib": peak / 2**30, "profiled_step_ms": prof_ms,
            "device_busy_ms": busy_ms, "device_busy_share": busy_ms / prof_ms,
            "flash_ms": flash_ms, "flash_ms_by_kernel": flash_by,
            "launches": launches}


def train_batch(vocab: int, B_: int, S_: int):
    import numpy as np

    ids = np.random.RandomState(SEED).randint(0, vocab, size=(B_, S_))
    return {"ids": ids, "labels": np.roll(ids, -1, axis=1)}


def phase4(flash_entries):
    import gc

    import torch

    from neuronx_distributed_tpu_torch.config import training_config
    from neuronx_distributed_tpu_torch.models.common import (
        make_causal_lm_loss_sum,
    )
    from neuronx_distributed_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaForCausalLM,
    )
    from neuronx_distributed_tpu_torch.trainer import initialize_parallel_model

    # what earlier phases left (reference cycles hold their models and
    # page pools until a collection) is not this phase's memory
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    cfg = LlamaConfig.llama3_8b(num_layers=TRAIN_LAYERS,
                                attention_impl="flash", remat="none",
                                dtype=torch.bfloat16,
                                param_dtype=torch.float32)
    config = training_config(learning_rate=1e-4, max_grad_norm=1.0,
                             seed=SEED)
    t0 = time.perf_counter()
    model = initialize_parallel_model(
        config, lambda d: LlamaForCausalLM(cfg, device=d), seed=SEED)
    torch.cuda.synchronize()
    log(f"phase4: Llama-3-8B width, {cfg.num_layers} layers (cut from 32), "
        f"vocab {cfg.vocab_size}, {model.num_parameters() / 1e9:.3f}B params "
        f"fp32 masters, bf16 compute, flash attention, remat none; random "
        f"init in {time.perf_counter() - t0:.1f} s")
    loss_fn = make_causal_lm_loss_sum(TRAIN_CHUNK)
    batch = train_batch(cfg.vocab_size, TRAIN_B, TRAIN_S)

    # flash core vs dense core: one step at batch 1, on copies of the
    # trainer's weights
    one = {k: torch.as_tensor(v[:1]).cuda() for k, v in batch.items()}
    rel = {str(dt).replace("torch.", ""): flash_vs_dense(
        "phase4", LlamaForCausalLM, cfg, model.module.state_dict(), loss_fn,
        one, dt) for dt in (torch.bfloat16, torch.float32)}
    summary = train_steps("phase4", config, model, loss_fn, batch, 1,
                          flash_entries)
    del model
    torch.cuda.empty_cache()
    return dict(summary, base_gib=base / 2**30, flash_vs_dense_rel=rel)


# -- phase 5 ------------------------------------------------------------------

# Gemma-2-2B training: full width and depth, batch 1 x 8192 (the window of
# the even layers masks keys), the JAX default remat, the chunked loss head
G2_TRAIN_B, G2_TRAIN_S, G2_REMAT = 1, 8192, "selective"


def phase5(flash_entries):
    """Gemma-2-2B (26 layers, tied 256000 x 2304 table, head_dim 256) trains
    WARMUP_STEPS + TIMED_STEPS steps through the trainer's entry points at
    1 x 8192 with fp32 masters, bf16 compute and the flash kernels at
    D = 256.  Flash vs dense is held on the same width cut to 2 layers (one
    sliding, one global): a 26-layer dense core at 8192 does not fit."""
    import gc

    import torch

    from neuronx_distributed_tpu_torch.config import training_config
    from neuronx_distributed_tpu_torch.models.common import (
        make_causal_lm_loss_sum,
    )
    from neuronx_distributed_tpu_torch.models.gemma import (
        Gemma2Config,
        Gemma2ForCausalLM,
    )
    from neuronx_distributed_tpu_torch.trainer import initialize_parallel_model

    gc.collect()
    torch.cuda.empty_cache()
    cfg = Gemma2Config.gemma2_2b(attention_impl="flash", remat=G2_REMAT,
                                 dtype=torch.bfloat16,
                                 param_dtype=torch.float32)
    config = training_config(learning_rate=1e-4, max_grad_norm=1.0,
                             seed=SEED)
    loss_fn = make_causal_lm_loss_sum(TRAIN_CHUNK)
    batch = train_batch(cfg.vocab_size, G2_TRAIN_B, G2_TRAIN_S)

    two = Gemma2Config.gemma2_2b(num_layers=2, attention_impl="flash",
                                 remat=G2_REMAT, dtype=torch.bfloat16,
                                 param_dtype=torch.float32)
    state = Gemma2ForCausalLM(two, device="cuda").init_random(SEED
                                                               ).state_dict()
    dev_batch = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}
    rel = {str(dt).replace("torch.", ""): flash_vs_dense(
        "phase5", Gemma2ForCausalLM, two, state, loss_fn, dev_batch, dt)
        for dt in (torch.bfloat16, torch.float32)}
    del state, dev_batch
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model = initialize_parallel_model(
        config, lambda d: Gemma2ForCausalLM(cfg, device=d), seed=SEED)
    torch.cuda.synchronize()
    log(f"phase5: Gemma-2-2B, {cfg.num_layers} layers (full depth), vocab "
        f"{cfg.vocab_size} (tied head), {model.num_parameters() / 1e9:.3f}B "
        f"params fp32 masters, bf16 compute, flash attention at head_dim "
        f"{cfg.head_dim}, window {cfg.sliding_window} on even layers, "
        f"softcaps {cfg.attn_softcap}/{cfg.final_softcap}, remat "
        f"{cfg.remat}; random init in {time.perf_counter() - t0:.1f} s")
    summary = train_steps("phase5", config, model, loss_fn, batch,
                          1 if cfg.remat == "none" else 2, flash_entries)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return dict(summary, flash_vs_dense_rel=rel)


# -- phase 5b -----------------------------------------------------------------

G2_REQUESTS, G2_NEW_TOKENS = 8, 32


def phase5b(entries):
    """Gemma-2-2B serving: full width and depth with random bf16 weights,
    ``ServingEngine`` in paged mode over a bf16 pool; the decode kernel at
    head_dim 256 with the softcap on every decode step of every layer."""
    import gc

    import torch

    from neuronx_distributed_tpu_torch import (
        InferenceConfig,
        ParallelInferenceModel,
        ServingEngine,
    )
    from neuronx_distributed_tpu_torch.models.gemma import (
        Gemma2Config,
        Gemma2ForCausalLM,
    )
    from neuronx_distributed_tpu_torch.ops.paged_attention import paged_attention

    cfg = Gemma2Config.gemma2_2b()
    t0 = time.perf_counter()
    model = Gemma2ForCausalLM(cfg, device="cuda").init_random(SEED)
    pim = ParallelInferenceModel(
        model, InferenceConfig(SLOTS, CONTEXT, MAX_TOTAL, torch.bfloat16),
        cuda_graphs=False)
    if not pim.paged_kernel:
        raise AssertionError("paged_kernel did not resolve to the kernel")
    torch.cuda.synchronize()
    log(f"phase5b: Gemma-2-2B {cfg.num_layers} layers, "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f}B params "
        f"bf16, random init in {time.perf_counter() - t0:.1f} s")
    engine = ServingEngine(pim, page_size=PAGE_SIZE, async_decode=False)
    requests = make_requests(cfg.vocab_size, G2_REQUESTS, G2_NEW_TOKENS,
                             SEED)
    torch.cuda.reset_peak_memory_stats()
    zero_paged_counts()
    t0 = time.perf_counter()
    outs = serve(engine, requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, steps = paged_attention.launches, engine.decode_steps
    peak = torch.cuda.max_memory_allocated()
    tokens = sum(len(o.token_ids) for o in outs.values())
    bad = [(o.request_id, o.state, len(o.token_ids)) for o in outs.values()
           if o.state != "finished" or len(o.token_ids) != G2_NEW_TOKENS]
    if len(outs) != G2_REQUESTS or bad:
        raise AssertionError(f"requests not served in full: {bad}, "
                             f"{len(outs)}/{G2_REQUESTS} outputs")
    routes = check_routes("phase5b", steps * cfg.num_layers, 0)
    engine._kv.assert_invariants()
    leaks = engine._kv.leaked_pages()
    if leaks:
        raise AssertionError(f"{leaks} KV pages leaked")
    log(f"phase5b: served {G2_REQUESTS} requests, {tokens} tokens in "
        f"{wall:.3f} s ({tokens / wall:.1f} tok/s overall, {steps} batched "
        f"decode steps, {wall / steps * 1e3:.2f} ms/step incl. admissions); "
        f"kernel launches {launches} = {steps} x {cfg.num_layers}, by route "
        f"{routes}; page leaks 0; peak memory {peak / 2**30:.2f} GiB")
    set_launches(entries, routes, "5b")
    del engine

    eng = admitted_engine(pim, cfg.vocab_size)
    lg_k = decode_logits(pim, eng, True)
    lg_g = decode_logits(pim, eng, False)
    del eng
    rel, agree = compare_logits(lg_k, lg_g)
    log(f"phase5b: kernel vs gather logits, one decode step at full width: "
        f"rel L2 {rel:.3e} (tol {LOGITS_REL_TOL}), argmax agreement "
        f"{agree:.3f}, max |logit| {lg_g.abs().max().item():.3e} (final "
        f"softcap {cfg.final_softcap})")
    if not rel <= LOGITS_REL_TOL or not torch.isfinite(lg_k).all():
        raise AssertionError(f"kernel and gather logits disagree: rel {rel}")
    busy = steady_decode_profile(pim, cfg.vocab_size, label="phase5b",
                                 async_decode=False)

    # phase 2c(e): the same requests on the async graph engine
    gpim = graphed_pim(pim)
    eng = ServingEngine(gpim, page_size=PAGE_SIZE)
    zero_paged_counts()
    _, g_wall = serve_checked(
        "phase2c(e) Gemma-2-2B", eng,
        make_requests(cfg.vocab_size, G2_REQUESTS, G2_NEW_TOKENS, SEED),
        {rid: o.token_ids for rid, o in outs.items()})
    g_routes = check_routes("phase2c(e)", eng.decode_steps * cfg.num_layers,
                            0)
    log(f"phase2c(e): Gemma-2-2B on async decode + CUDA graphs: tokens "
        f"identical to the eager synchronous run, {G2_REQUESTS} requests in "
        f"{g_wall:.3f} s (eager {wall:.3f} s), launches by route {g_routes}")
    del eng
    g_busy = steady_decode_profile(gpim, cfg.vocab_size,
                                   label="phase2c(e) Gemma-2-2B")

    # phase 2d(e): the same requests over adapters 0..G2_ADAPTERS
    store = make_store(gpim, {aid: adapter_factors(cfg, aid)
                                 for aid in range(1, G2_ADAPTERS + 1)})
    eng = ServingEngine(gpim, page_size=PAGE_SIZE, adapter_store=store)
    zero_paged_counts()
    d_outs, d_wall = serve_checked(
        "phase2d(e) Gemma-2-2B", eng,
        make_requests(cfg.vocab_size, G2_REQUESTS, G2_NEW_TOKENS, SEED,
                      G2_ADAPTERS))
    d_routes = check_routes("phase2d(e)", eng.decode_steps * cfg.num_layers,
                            0)
    leaked = [rid for rid, o in d_outs.items()
              if rid % (G2_ADAPTERS + 1) == 0
              and tuple(o.token_ids) != tuple(outs[rid].token_ids)]
    if leaked:
        raise AssertionError(f"phase2d(e): adapter-0 requests {leaked} "
                             "differ from phase 2c(e)'s tokens")
    store.assert_invariants()
    set_launches([e for e in entries if "decode" in e["name"]], d_routes,
                 "2d(e)")
    log(f"phase2d(e): Gemma-2-2B over adapters 0..{G2_ADAPTERS} (rank "
        f"{LORA_RANK}, {store.layout.pages_per_adapter} pages an adapter) "
        f"on the async graph engine: {G2_REQUESTS} requests in "
        f"{d_wall:.3f} s, adapter-0 requests identical to 2c(e)'s; "
        f"launches by route {d_routes}; loads {store.loads}, hits "
        f"{store.hits}")
    del eng, store
    del pim, gpim, model
    gc.collect()
    torch.cuda.empty_cache()
    return {**busy, "wall_s": wall, "tokens": tokens, "tok_s": tokens / wall,
            "decode_steps": steps, "launches": launches,
            "launches_by_route": routes,
            "peak_gib": peak / 2**30, "logits_rel_l2": rel,
            "argmax_agreement": agree,
            "graphs_async": {**g_busy, "wall_s": g_wall,
                             "launches_by_route": g_routes},
            "adapters": {"wall_s": d_wall, "launches_by_route": d_routes}}


# -- phase 6 ------------------------------------------------------------------

# GPT-NeoX-20B's width (hidden 6144, 64 heads of head_dim 96, MLP 24576,
# vocab 50432, 24 of 96 dims rotated) cut to NEOX_LAYERS layers, batch 1 x
# 2048 (max_seq_len), the JAX default remat "selective"; BERT-large at full
# depth (24 post-LN layers, hidden 1024), batch 16 x 512 with 15 % of the
# tokens masked as examples/training/bert_pretrain.py builds its batches
# (ids from 999 up, [MASK] = 103), NSP labels, dropout 0.1 drawn from a
# step generator
NEOX_LAYERS, NEOX_B, NEOX_S = 4, 1, 2048
BERT_B, BERT_S, BERT_MASK_PROB, BERT_MASK_ID, BERT_LOW_ID = 16, 512, 0.15, 103, 999
# the bf16 forward against the fp32 forward of the same weights, both on the
# card, on the width cut to 2 layers: the largest relative L2 difference of
# an output (logits; BERT's MLM and NSP logits).  bf16 rounds each of ~8
# products and norms a layer to 2^-9 relative; through 2 layers and the head
# that is ~1e-2; a wrong cast or a dropped fp32 widening gives far more
BF16_FWD_REL_TOL = 5e-2
# dropout: one seed gives one loss (the forward has no atomics), to this
# relative difference; another seed, or no generator, moves the loss by
# more than DROPOUT_MOVES_RTOL (a 10 % mask changes a 24-layer loss by far
# more)
DROPOUT_SAME_RTOL, DROPOUT_MOVES_RTOL = 1e-6, 1e-4


def dense_flops_per_token(L, H, I, V, S, extra=0.0) -> float:
    """Training FLOPs a token of a GPT-NeoX or BERT layer stack, 3x the
    forward's matmul FLOPs (remat's recompute not counted): a layer's fused
    QKV 6H^2 and output projection 2H^2, its two-matmul MLP 4HI and its
    dense attention core 4SH (QK^T and PV over all S keys, 4 B S^2 H a
    layer over the batch; the causal half not discounted), then the head
    2HV and ``extra``."""
    return 3.0 * (L * (8 * H * H + 4 * H * I + 4 * S * H) + 2 * H * V
                  + extra)


def bf16_vs_fp32(label, model_cls, cfg, forward) -> list:
    """``forward(model)`` (a tuple of outputs) of ``cfg`` cut to 2 layers,
    once in fp32 and once in bf16 compute over the same fp32 weights, on
    the card; fails beyond :data:`BF16_FWD_REL_TOL` or on a non-finite
    output.  Returns the relative L2 difference of each output."""
    import dataclasses

    import torch

    two = dataclasses.replace(cfg, num_layers=2, remat="none")
    model = model_cls(dataclasses.replace(two, dtype=torch.float32),
                      device="cuda").init_random(SEED)
    with torch.no_grad():
        ref = [x.float() for x in forward(model)]
    state = model.state_dict()
    del model
    model = model_cls(dataclasses.replace(two, dtype=torch.bfloat16),
                      device="cuda")
    model.load_state_dict(state)
    with torch.no_grad():
        out = forward(model)
    del model, state
    rel = [((o.float() - r).norm() / r.norm()).item()
           for o, r in zip(out, ref)]
    finite = all(torch.isfinite(o).all().item() for o in out)
    log(f"{label}: bf16 forward vs fp32 forward of the same weights, width "
        f"cut to 2 layers: relative L2 " + ", ".join(
            f"{tuple(o.shape)} {o.dtype} {r:.3e}" for o, r in zip(out, rel))
        + f" (tol {BF16_FWD_REL_TOL}); finite {finite}")
    if not finite or not max(rel) <= BF16_FWD_REL_TOL:
        raise AssertionError(f"{label}: bf16 and fp32 forwards disagree: "
                             f"{rel}, finite {finite}")
    torch.cuda.empty_cache()
    return rel


def bert_batch(vocab: int, B_: int, S_: int, seed: int = SEED) -> dict:
    """An MLM + NSP batch as examples/training/bert_pretrain.py builds one:
    ids from BERT_LOW_ID up, 15 % of them replaced by [MASK] and labelled,
    the rest labelled -100, random NSP labels."""
    import numpy as np

    rs = np.random.RandomState(seed)
    ids = rs.randint(BERT_LOW_ID, vocab, size=(B_, S_))
    masked = rs.rand(B_, S_) < BERT_MASK_PROB
    return {"ids": np.where(masked, BERT_MASK_ID, ids),
            "mlm_labels": np.where(masked, ids, -100),
            "nsp_labels": rs.randint(0, 2, size=(B_,))}


def dropout_invariants(model, batch) -> dict:
    """On the trained BERT: one generator seed gives one loss twice,
    ``generator=None`` gives one loss twice, and another seed or no
    generator moves the loss (dropout is on)."""
    import torch

    from neuronx_distributed_tpu_torch.models.bert import pretraining_loss

    dev = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}

    def loss_at(seed):
        g = None if seed is None else torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return pretraining_loss(model, dev, g).item()

    got = {"seed1": loss_at(1), "seed1_again": loss_at(1),
           "seed2": loss_at(2), "none": loss_at(None),
           "none_again": loss_at(None)}

    def rel(a, b):
        return abs(got[a] - got[b]) / abs(got[b])

    checks = {"same_seed_rel": rel("seed1_again", "seed1"),
              "no_generator_rel": rel("none_again", "none"),
              "other_seed_rel": rel("seed2", "seed1"),
              "dropout_on_rel": rel("seed1", "none")}
    log("phase6(b) dropout: losses " + ", ".join(
        f"{k} {v:.6f}" for k, v in got.items()) + "; relative differences "
        + ", ".join(f"{k} {v:.3e}" for k, v in checks.items())
        + f" (same: <= {DROPOUT_SAME_RTOL}; moved: > {DROPOUT_MOVES_RTOL})")
    if not (all(math.isfinite(v) for v in got.values())
            and checks["same_seed_rel"] <= DROPOUT_SAME_RTOL
            and checks["no_generator_rel"] <= DROPOUT_SAME_RTOL
            and checks["other_seed_rel"] > DROPOUT_MOVES_RTOL
            and checks["dropout_on_rel"] > DROPOUT_MOVES_RTOL):
        raise AssertionError(f"dropout invariants broken: {got}")
    return {"losses": got, **checks}


def phase6():
    """GPT-NeoX and BERT pretraining through the trainer's entry points
    (ROADMAP A9e): (a) GPT-NeoX-20B's width cut to NEOX_LAYERS layers at 1
    x 2048, (b) BERT-large at 16 x 512 with dropout under a step
    generator.  Both run the dense attention core (no flash launch).  Each
    holds a bf16 forward against the fp32 forward of the same weights on a
    2-layer cut first."""
    import gc

    import numpy as np
    import torch

    from neuronx_distributed_tpu_torch.config import training_config
    from neuronx_distributed_tpu_torch.models.bert import (
        BertConfig,
        BertForPreTraining,
        pretraining_loss,
    )
    from neuronx_distributed_tpu_torch.models.common import (
        make_causal_lm_loss_sum,
    )
    from neuronx_distributed_tpu_torch.models.gpt_neox import (
        GPTNeoXConfig,
        GPTNeoXForCausalLM,
    )
    from neuronx_distributed_tpu_torch.trainer import initialize_parallel_model

    gc.collect()
    torch.cuda.empty_cache()
    config = training_config(learning_rate=1e-4, max_grad_norm=1.0,
                             seed=SEED)
    out = {}

    # (a) GPT-NeoX-20B width
    cfg = GPTNeoXConfig.neox_20b(num_layers=NEOX_LAYERS, remat="selective",
                                 dtype=torch.bfloat16,
                                 param_dtype=torch.float32)
    batch = train_batch(cfg.vocab_size, NEOX_B, NEOX_S)
    ids = torch.as_tensor(batch["ids"]).cuda()
    rel = bf16_vs_fp32("phase6(a)", GPTNeoXForCausalLM, cfg,
                       lambda m: (m(ids),))
    t0 = time.perf_counter()
    model = initialize_parallel_model(
        config, lambda d: GPTNeoXForCausalLM(cfg, device=d), seed=SEED)
    torch.cuda.synchronize()
    H, I, V, L = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
                  cfg.num_layers)
    log(f"phase6(a): GPT-NeoX-20B width (hidden {H}, {cfg.num_heads} heads "
        f"of {cfg.head_dim}, MLP {I}, vocab {V}, rotary "
        f"{int(cfg.head_dim * cfg.rotary_pct)} of {cfg.head_dim} dims, "
        f"parallel residual), {L} layers (cut from 44), "
        f"{model.num_parameters() / 1e9:.3f}B params fp32 masters, bf16 "
        f"compute, dense attention core, remat {cfg.remat}; random init in "
        f"{time.perf_counter() - t0:.1f} s")
    fpt = dense_flops_per_token(L, H, I, V, NEOX_S)
    out["neox"] = dict(train_steps(
        "phase6(a)", config, model, make_causal_lm_loss_sum(TRAIN_CHUNK),
        batch, None, None,
        flops=(fpt, "3 x (L (8H^2 + 4HI + 4SH) + 2HV)")), bf16_vs_fp32_rel=rel)
    del model, ids
    gc.collect()
    torch.cuda.empty_cache()

    # (b) BERT-large
    cfg = BertConfig.bert_large(dtype=torch.bfloat16,
                                param_dtype=torch.float32)
    check = bert_batch(cfg.vocab_size, 4, BERT_S, seed=SEED + 1)
    tt = np.zeros((4, BERT_S), np.int64)
    tt[:, BERT_S // 2:] = 1
    am = np.ones((4, BERT_S), np.int64)
    am[:, BERT_S - 64:] = 0   # the last 64 positions padding
    fwd_in = [torch.as_tensor(a).cuda() for a in (check["ids"], tt, am)]
    rel = bf16_vs_fp32("phase6(b)", BertForPreTraining, cfg,
                       lambda m: m(*fwd_in))
    batch = bert_batch(cfg.vocab_size, BERT_B, BERT_S)
    t0 = time.perf_counter()
    model = initialize_parallel_model(
        config, lambda d: BertForPreTraining(cfg, device=d), seed=SEED)
    torch.cuda.synchronize()
    H, I, V, L = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
                  cfg.num_layers)
    log(f"phase6(b): BERT-large ({L} post-LN layers, hidden {H}, "
        f"{cfg.num_heads} heads, vocab {V}, tied MLM decoder, NSP head), "
        f"{model.num_parameters() / 1e9:.3f}B params fp32 masters, bf16 "
        f"compute, dense attention core, remat {cfg.remat}, dropout "
        f"{cfg.hidden_dropout} from a step generator; batch {BERT_B} x "
        f"{BERT_S}, {int((batch['mlm_labels'] >= 0).sum())} MLM labels; "
        f"random init in {time.perf_counter() - t0:.1f} s")
    fpt = dense_flops_per_token(L, H, I, V, BERT_S,
                                2 * H * H + (2 * H * H + 4 * H) / BERT_S)
    gen = torch.Generator().manual_seed(SEED)
    out["bert"] = dict(train_steps(
        "phase6(b)", config, model, pretraining_loss, batch, None, None,
        generator=gen,
        flops=(fpt, "3 x (L (8H^2 + 4HI + 4SH) + 2HV + 2H^2 MLM transform "
                    "+ (2H^2 + 4H) / S pooler and NSP)")),
        bf16_vs_fp32_rel=rel,
        dropout=dropout_invariants(model.module, batch))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- phase 7 -----------------------------------------------------------------

# training past one rank: two processes share the card over gloo (NCCL
# refuses two ranks on one device), so this proves correctness, launches
# and per-rank memory of the sharded step, not tp or dp speed.  (a) tp = 2
# with sequence parallelism on Llama-3-8B's width cut to 4 layers; (b) dp
# = 2 with ZeRO-1 on and off on a 2-layer cut; (c) tp = 2 with kvr = 2 on
# a 2-layer cut
P7_TP_LAYERS, P7_SMALL_LAYERS, P7_S, P7_CHUNK = 4, 2, 2048, 512
P7_WARMUP, P7_TIMED, P7_DP_STEPS = 2, 3, 3
# the first step's loss and grad norm at tp = 2 against tp = 1 from the
# same seed and batch (bf16 compute: the row layers' fp32 partials and the
# vocab-parallel loss sum in other orders)
P7_LOSS_RTOL, P7_NORM_RTOL = 1e-2, 5e-2
P7_WORLD_TIMEOUT_S = 600
# B1-B3 at a tp = 2 rank's local heads: 16 q on 4 kv heads (G = 4, kvr =
# 1, and kvr = 2 too: a rank's 16 q heads read 4 of its 8 replicated kv
# heads), model layout; and 16 q on 8 kv heads (G = 2), a group size no
# other phase holds
P7_FLASH_CASES = [
    ("tp2_local_heads_g4", 1, NQ // TP, NKV // TP, P7_S, P7_S, D, True, None,
     None, None, False, False, True),
    ("tp2_g2", 1, NQ // TP, NKV, P7_S, P7_S, D, True, None, None, None, False,
     False, True),
]


def phase7_kernels() -> dict:
    """B1-B3 held at the tp = 2 local-head shapes (G = 4 and G = 2) against
    their plain versions, and timed at both beside SDPA and the bound."""
    new_worst = lambda: {w: {"abs": 0.0, "row_rel": 0.0}  # noqa: E731
                         for w in FLASH_KERNELS}
    worst = {"g4": new_worst(), "g2": new_worst()}
    worst_lse = {"bfloat16": 0.0, "float32": 0.0}
    hold_flash_cases(P7_FLASH_CASES[:1], worst["g4"], worst_lse, seed0=200)
    hold_flash_cases(P7_FLASH_CASES[1:], worst["g2"], worst_lse, seed0=201)
    entries = time_flash((1, NQ // TP, NKV // TP, P7_S, D), worst=worst["g4"],
                         suffix="_tp2")
    g2 = time_flash((1, NQ // TP, NKV, P7_S, D), worst=worst["g2"],
                    suffix="_tp2_g2")
    for w in FLASH_KERNELS:
        entries[w]["shapes"]["tp"] = TP
        entries[w]["lse_max_abs_err"] = worst_lse
        g2[w]["shapes"]["tp"] = TP
    return {"g4": entries, "g2": g2}


def phase7_refs() -> dict:
    """The tp = 1 references of 7(a) and 7(c): the first step's loss and
    grad norm of the 4- and 2-layer cuts from the seed and batch the ranks
    use (init is tp-invariant, so a tp = 2 rank holds this model's
    shard)."""
    import gc

    import torch

    from neuronx_distributed_tpu_torch.config import training_config
    from neuronx_distributed_tpu_torch.models.common import (
        make_causal_lm_loss_sum,
    )
    from neuronx_distributed_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaForCausalLM,
    )
    from neuronx_distributed_tpu_torch.trainer import initialize_parallel_model

    refs = {}
    batch = train_batch(128256, 1, P7_S)
    one = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}
    for layers in (P7_TP_LAYERS, P7_SMALL_LAYERS):
        cfg = LlamaConfig.llama3_8b(num_layers=layers, attention_impl="flash",
                                    remat="selective", dtype=torch.bfloat16,
                                    param_dtype=torch.float32)
        model = initialize_parallel_model(
            training_config(seed=SEED),
            lambda d, c=cfg: LlamaForCausalLM(c, device=d), seed=SEED)
        loss, norm, _ = loss_and_grads(model.module,
                                       make_causal_lm_loss_sum(P7_CHUNK), one)
        refs[layers] = {"loss": loss, "grad_norm": norm}
        log(f"phase7 tp = 1 reference, {layers} layers: first-step loss "
            f"{loss:.6f}, grad norm {norm:.6f}")
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return refs


def p7_train(label, config, cfg, batch, steps, warmup=0, profile=False):
    """One rank's training through the entry points: the model, its
    optimizer and step, ``warmup`` + ``steps`` steps on ``batch`` with the
    launch and collective counts set to 0 first.  Returns the losses, grad
    norms, launches, per-step collectives, memory and times; the model and
    optimizer are dropped."""
    import gc

    import torch

    from neuronx_distributed_tpu_torch.models.common import (
        make_causal_lm_loss_sum,
    )
    from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM
    from neuronx_distributed_tpu_torch.ops import flash_attention as fa
    from neuronx_distributed_tpu_torch.ops.paged_attention import paged_attention
    from neuronx_distributed_tpu_torch.optimizer.zero1 import state_bytes
    from neuronx_distributed_tpu_torch.parallel import mappings, mesh
    from neuronx_distributed_tpu_torch.trainer import (
        initialize_parallel_model,
        initialize_parallel_optimizer,
        make_train_step,
    )

    torch.cuda.reset_peak_memory_stats()
    model = initialize_parallel_model(
        config, lambda d: LlamaForCausalLM(cfg, device=d), seed=SEED)
    module = model.module
    opt = initialize_parallel_optimizer(config, model)
    step = make_train_step(config, model, opt,
                           make_causal_lm_loss_sum(P7_CHUNK))
    for fn in (fa.flash_attention_fwd, fa.flash_attention_dq,
               fa.flash_attention_dkv, paged_attention):
        fn.launches = 0
    losses, norms, counts, coll_s, times = [], [], [], [], []
    for i in range(warmup + steps):
        mappings.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(batch)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        torch.cuda.synchronize()
        if i >= warmup:
            times.append(time.perf_counter() - t0)
        counts.append(dict(mappings.COUNTS))
        coll_s.append(sum(mappings.SECONDS.values()))
    out = {"losses": losses, "grad_norms": norms,
           "counts": counts, "collective_s": coll_s,
           "step_ms": sum(times) / max(len(times), 1) * 1e3,
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in module.parameters()),
           "state_bytes": state_bytes(opt.optimizer),
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "tp": (module.tp.size, module.tp.rank, module.tp.kvr),
           "dp": (mesh.get_data_parallel_size(),
                  mesh.get_data_parallel_rank()),
           "zero1": opt.zero1 is not None,
           "local_heads": (module.model.layer_0.attn.qkv.q_kernel.shape[1],
                           module.model.layer_0.attn.qkv.kv_heads[1])}
    if opt.zero1 is not None:
        out["shard_bytes"] = sum(s.numel() * s.element_size()
                                 for s, lay in zip(opt.zero1.shards,
                                                   opt.zero1.layout)
                                 if lay is not None)
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof_ctx

        with prof_ctx(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(batch)
            torch.cuda.synchronize()
            out["profiled_step_ms"] = (time.perf_counter() - t0) * 1e3
        out["device_busy_ms"] = sum(dev_us(e) for e in
                                    device_events(prof)) / 1e3
    # every step above ran the main path, the profiled one too
    launches = out["launches"] = {w: getattr(fa, FLASH_KERNELS[w][0]).launches
                                  for w in FLASH_KERNELS}
    launches["paged"] = paged_attention.launches
    out["params"] = ({n: p.detach().clone() for n, p in
                      module.named_parameters()} if label == "keep" else None)
    log(f"phase7 {label} rank tp {out['tp']} dp {out['dp']}: losses "
        + ", ".join(f"{x:.4f}" for x in losses) + "; grad norms "
        + ", ".join(f"{x:.3f}" for x in norms)
        + f"; {out['step_ms']:.1f} ms a step (host clock, two processes "
        f"time-sliced on one card); collectives a step {counts[-1]}, "
        f"{coll_s[-1] * 1e3:.1f} ms; launches {launches}; parameters "
        f"{out['param_bytes'] / 2**30:.3f} GiB, AdamW state "
        f"{out['state_bytes'] / 2**30:.3f} GiB, peak "
        f"{out['peak_bytes'] / 2**30:.3f} GiB")
    del step, opt, model, module
    mesh.destroy_model_parallel()
    gc.collect()
    torch.cuda.empty_cache()
    return out


def p7_rank(task: dict) -> dict:
    """One rank of phase 7: (a), (b) and (c) in turn, each laying its ranks
    out from its ``TrainingConfig`` (``initialize_parallel_model``)."""
    import torch
    import torch.distributed as dist

    from neuronx_distributed_tpu_torch.config import training_config
    from neuronx_distributed_tpu_torch.models.llama import LlamaConfig
    from neuronx_distributed_tpu_torch.utils.distributed import (
        initialize_distributed,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(device="cuda", backend="gloo", timeout_s=300)
    out = {"rank": dist.get_rank()}

    def cfg(layers):
        return LlamaConfig.llama3_8b(num_layers=layers, attention_impl="flash",
                                     remat="selective", dtype=torch.bfloat16,
                                     param_dtype=torch.float32)

    one = train_batch(128256, 1, P7_S)
    # (a) tp = 2, sequence parallelism (the config's default), kvr = 1
    out["a"] = p7_train("(a) tp = 2 SP", training_config(
        tensor_parallel_size=TP, learning_rate=1e-4, max_grad_norm=1.0,
        seed=SEED), cfg(P7_TP_LAYERS), one, P7_TIMED, P7_WARMUP,
        profile=True)
    # (b) dp = 2, one row of 2048 a rank, ZeRO-1 on and off; clipping off:
    # the global norm sums the slices in another order under ZeRO-1, and
    # a clip coefficient an ulp apart would scale every gradient
    two = train_batch(128256, 2, P7_S)
    b = {}
    for z in (True, False):
        b[z] = p7_train("keep", training_config(
            data_parallel_size=2, learning_rate=1e-4, grad_clipping=False,
            zero_one_enabled=z, seed=SEED), cfg(P7_SMALL_LAYERS), two,
            P7_DP_STEPS)
    pz, pr = b[True].pop("params"), b[False].pop("params")
    unequal = sum(int((pz[n] != pr[n]).sum().item()) for n in pz)
    max_diff = max((pz[n] - pr[n]).abs().max().item() for n in pz)
    log(f"phase7 (b) rank {out['rank']}: ZeRO-1 against replicated AdamW "
        f"after {P7_DP_STEPS} steps: {unequal} of "
        f"{sum(v.numel() for v in pz.values())} parameters differ, largest "
        f"difference {max_diff:.3e}")
    del pz, pr
    torch.cuda.empty_cache()
    out["b"] = {"zero1": b[True], "replicated": b[False],
                "unequal": unequal, "max_diff": max_diff}
    # (c) tp = 2 with kvr = 2: one step
    out["c"] = p7_train("(c) tp = 2 kvr = 2", training_config(
        tensor_parallel_size=TP, kv_size_multiplier=2, learning_rate=1e-4,
        max_grad_norm=1.0, seed=SEED), cfg(P7_SMALL_LAYERS), one, 1)
    dist.barrier()
    return out


def phase7(refs: dict, entries: dict) -> dict:
    """Training past one rank on the one card: (a) tp = 2 with sequence
    parallelism, (b) dp = 2 with ZeRO-1 against replicated AdamW, (c) tp =
    2 with kvr = 2; the ranks against each other and against tp = 1."""
    from neuronx_distributed_tpu_torch.utils.distributed import spawn

    t_phase = time.perf_counter()
    ranks = spawn(p7_rank, TP, ({},), timeout_s=P7_WORLD_TIMEOUT_S,
                  echo=True)
    a0, a1 = ranks[0]["a"], ranks[1]["a"]
    L = P7_TP_LAYERS
    steps = P7_WARMUP + P7_TIMED + 1    # the profiled step too
    want = {"fwd": steps * L * 2, "dq": steps * L, "dkv": steps * L,
            "paged": 0}   # selective remat runs each forward twice
    for r in ranks:
        a = r["a"]
        if a["launches"] != want:
            raise AssertionError(f"phase7(a): launches {a['launches']}, "
                                 f"expected {want}")
        if a["local_heads"] != (NQ // TP, NKV // TP):
            raise AssertionError(f"phase7(a): local heads {a['local_heads']}")
        if not all(math.isfinite(x) for x in a["losses"] + a["grad_norms"]):
            raise AssertionError(f"phase7(a): non-finite {a['losses']}")
        if not a["losses"][-1] < a["losses"][0]:
            raise AssertionError(f"phase7(a): loss did not fall: "
                                 f"{a['losses']}")
        for key, ref, tol in (("losses", "loss", P7_LOSS_RTOL),
                              ("grad_norms", "grad_norm", P7_NORM_RTOL)):
            want_v = refs[P7_TP_LAYERS][ref]
            rel = abs(a[key][0] - want_v) / abs(want_v)
            if not rel <= tol:
                raise AssertionError(f"phase7(a): first-step {ref} "
                                     f"{a[key][0]} against tp = 1's {want_v}:"
                                     f" rel {rel} > {tol}")
    if a0["counts"] != a1["counts"] or a0["losses"] != a1["losses"]:
        raise AssertionError("phase7(a): the ranks disagree on the collectives "
                             "or the losses")
    for r in ranks:
        bz, br = r["b"]["zero1"], r["b"]["replicated"]
        if not (bz["zero1"] and not br["zero1"] and bz["dp"][0] == 2):
            raise AssertionError(f"phase7(b): layout {bz['dp']}")
        if r["b"]["unequal"]:
            raise AssertionError(f"phase7(b): ZeRO-1 parameters differ from "
                                 f"replicated AdamW's in {r['b']['unequal']} "
                                 f"elements (largest {r['b']['max_diff']})")
        if bz["losses"] != br["losses"]:
            raise AssertionError("phase7(b): ZeRO-1 losses differ")
        if not bz["state_bytes"] < 0.55 * br["state_bytes"]:
            raise AssertionError(f"phase7(b): ZeRO-1 state "
                                 f"{bz['state_bytes']} not about half of "
                                 f"{br['state_bytes']}")
        c = r["c"]
        if c["tp"][2] != 2 or c["local_heads"] != (NQ // TP, NKV // TP):
            raise AssertionError(f"phase7(c): layout {c['tp']}, local heads "
                                 f"{c['local_heads']}")
        for key, ref, tol in (("losses", "loss", P7_LOSS_RTOL),
                              ("grad_norms", "grad_norm", P7_NORM_RTOL)):
            want_v = refs[P7_SMALL_LAYERS][ref]
            rel = abs(c[key][0] - want_v) / abs(want_v)
            if not rel <= tol:
                raise AssertionError(f"phase7(c): first-step {ref} "
                                     f"{c[key][0]} against tp = 1's {want_v}:"
                                     f" rel {rel} > {tol}")
        if c["launches"] != {"fwd": 2 * P7_SMALL_LAYERS,
                             "dq": P7_SMALL_LAYERS, "dkv": P7_SMALL_LAYERS,
                             "paged": 0}:
            raise AssertionError(f"phase7(c): launches {c['launches']}")
    g4 = entries["g4"]
    for w in FLASH_KERNELS:
        g4[w]["launches"] = a0["launches"][w]
        g4[w]["launches_by_phase"] = {"7(a)": a0["launches"][w],
                                      "7(c)": ranks[0]["c"]["launches"][w]}
    seconds = time.perf_counter() - t_phase
    busy = a0.get("device_busy_ms", 0.0)
    log(f"phase7: (a) {a0['step_ms']:.1f} ms a step a rank, collectives "
        f"{a0['collective_s'][-1] * 1e3:.1f} ms of it, busy {busy:.1f} of "
        f"{a0.get('profiled_step_ms', 0.0):.1f} ms profiled; (b) ZeRO-1 "
        f"state {ranks[0]['b']['zero1']['state_bytes'] / 2**30:.3f} against "
        f"{ranks[0]['b']['replicated']['state_bytes'] / 2**30:.3f} GiB a "
        f"rank, parameters equal to the bit; phase 7 took {seconds:.1f} s")
    keep = ("losses", "grad_norms", "launches", "step_ms", "collective_s",
            "param_bytes", "state_bytes", "peak_bytes", "tp", "dp",
            "local_heads", "profiled_step_ms", "device_busy_ms",
            "shard_bytes")
    slim = lambda d: {k: d[k] for k in keep if k in d}  # noqa: E731
    return {"seconds": seconds, "refs": refs,
            "a": [dict(slim(r["a"]), counts=r["a"]["counts"][-1])
                  for r in ranks],
            "b": [{"zero1": slim(r["b"]["zero1"]),
                   "replicated": slim(r["b"]["replicated"]),
                   "unequal": r["b"]["unequal"],
                   "max_diff": r["b"]["max_diff"]} for r in ranks],
            "c": [slim(r["c"]) for r in ranks],
            "g2_kernels": {w: {k: entries["g2"][w][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "max_abs_err", "max_err")} for w in FLASH_KERNELS}}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the "
              "GPU only", file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "neuronx_distributed_tpu_torch")):
        print("chip_smoke: the neuronx_distributed_tpu_torch package is not "
              "beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, repo)
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        smi = nvidia_smi_line()
        log(f"device: {torch.cuda.get_device_name(0)} x "
            f"{torch.cuda.device_count()}; torch {torch.__version__} cuda "
            f"{torch.version.cuda}")
        log(f"nvidia-smi: {smi}")
        from neuronx_distributed_tpu_torch.ops import _build

        t0 = time.perf_counter()
        paths = _build.build_all()
        log(f"phase0: kernels built in {time.perf_counter() - t0:.1f} s "
            f"(one nvcc per source, in parallel)")
        for name, report in _build.build_logs.items():
            log(f"phase0: nvcc -Xptxas -v for {name}:\n{report}")
        guards = check_build_guards(paths)
        dec, simt = phase1()
        dec["build"] = guards["paged_decode"]
        dec8, simt8 = phase1_int8()
        long = phase1_long()
        entry_w = phase1_chunks()
        entry_w["build"] = guards["paged_wgmma"]
        verify = phase1_verify()
        serving, model_pim, whole_tokens = phase2([dec, simt, long["bf16"]])
        log(f"phase2 summary: {json.dumps(serving)}")
        quantized, int8_tokens = phase2b(
            model_pim, [dec8, simt8, long["int8"], entry_w], whole_tokens)
        log(f"phase2b summary: {json.dumps(quantized)}")
        graphed = phase2c(model_pim, whole_tokens, int8_tokens, verify)
        log(f"phase2c summary: {json.dumps(graphed)}")
        tenancy = phase2d(model_pim, whole_tokens, {
            "decode": dec, "decode_int8": dec8, "chunk": entry_w,
            "verify": verify})
        log(f"phase2d summary: {json.dumps(tenancy)}")
        slo = phase2e(model_pim, graphed["a"]["steady_step_ms"], {
            "decode": dec, "decode_int8": dec8, "chunk": entry_w})
        log(f"phase2e summary: {json.dumps(slo)}")
        telemetry = phase2f(model_pim, {"decode": dec})
        log(f"phase2f summary: {json.dumps(telemetry)}")
        part2 = phase2g(model_pim, whole_tokens, {"decode": dec})
        log(f"phase2g summary: {json.dumps(part2)}")
        fleet = phase2h(model_pim, {"decode": dec, "chunk": entry_w})
        log(f"phase2h summary: {json.dumps(fleet)}")
        tp_entries = phase2i_kernels()
        tp_refs = phase2i_refs(model_pim, whole_tokens)
        del model_pim
        gc.collect()
        torch.cuda.empty_cache()
        tp = phase2i(tp_refs, tp_entries)
        log(f"phase2i summary: {json.dumps(tp)}")
        dec256, simt256 = phase1_gemma()
        flash, flash256 = phase3()
        training = phase4(flash)
        log(f"phase4 summary: {json.dumps(training)}")
        gemma_training = phase5(flash256)
        log(f"phase5 summary: {json.dumps(gemma_training)}")
        gemma_serving = phase5b([dec256, simt256])
        log(f"phase5b summary: {json.dumps(gemma_serving)}")
        pretraining = phase6()
        log(f"phase6 summary: {json.dumps(pretraining)}")
        tp_train_entries = phase7_kernels()
        p7_refs = phase7_refs()
        gc.collect()
        torch.cuda.empty_cache()
        tp_training = phase7(p7_refs, tp_train_entries)
        log(f"phase7 summary: {json.dumps(tp_training)}")
        for w in FLASH_KERNELS:
            flash[w]["build"] = {d: guards[w][d] for d in (64, 128)}
            flash256[w]["build"] = {256: guards[w][256]}
        kernels = ([dec, dec8, dec256, long["bf16"], long["int8"], simt,
                    simt8, simt256, entry_w, verify]
                   + [tp_entries[k] for k in ("decode", "decode_int8",
                                              "chunk", "chunk_int8")]
                   + [flash[w] for w in FLASH_KERNELS]
                   + [flash256[w] for w in FLASH_KERNELS]
                   + [tp_train_entries["g4"][w] for w in FLASH_KERNELS])
        for k in kernels:
            if not all(math.isfinite(k[f]) for f in ("ms", "plain_ms",
                                                     "library_ms",
                                                     "bound_ms")):
                raise AssertionError(f"non-finite timing in {k['name']}")
            if not isinstance(k["launches"], int):
                raise AssertionError(f"no main-path launch count for "
                                     f"{k['name']}")
        log(f"chip_smoke: every phase passed in "
            f"{time.perf_counter() - t_start:.1f} s")
        log(f"nvidia-smi: {nvidia_smi_line()}")
        print(json.dumps({"kernels": kernels}), flush=True)
    except Exception:  # noqa: BLE001 - any failed phase fails the run
        traceback.print_exc()
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
