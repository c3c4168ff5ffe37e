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
async graph engine.  Phase 1 also holds and times the verify call (B =
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
logits.  A device time below the least time its work needs fails the run.

Any failed check exits non-zero without the result line.  The line before
the last is ``{"kernels": [...]}``; the last is ``{"ok": true, "device":
...}``.  Without CUDA, or without the package beside this file, the script
exits non-zero at once.
"""

from __future__ import annotations

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


def log(msg: str) -> None:
    print(msg, flush=True)


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


def device_ms(fns, iters: int, expect: str = "", show: str = "",
              names=None) -> float:
    """Device time per call of the kernels (and copies) that ``iters``
    calls put on the card, as ``torch.profiler`` reads them.  The calls
    cycle through ``fns``, one per copy of the inputs, so that a call
    finds its inputs in device memory and not in the 50 MB L2 the
    previous call filled.  Every call launches the same kernels, ``n =
    round(count / iters)`` of each; a kernel's time per call is its mean
    recorded duration times ``n``, so a call whose kernels the profiler
    dropped (the count falls short of ``n * iters``, and is logged)
    does not read the time low.  ``expect`` names a kernel that must be
    among those seen; a trace with no device time, or without that
    kernel, is taken again, up to TRACE_TRIES times (the profiler has
    returned an empty trace of 20 calls that launched a kernel each).
    ``show`` logs every device event per call under that label; ``names``,
    a list, receives the event names, longest first."""
    def run():
        for i in range(iters):
            fns[i % len(fns)]()

    def warm():
        for fn in fns:
            fn()

    warm()
    for attempt in range(1, TRACE_TRIES + 1):
        events = trace(run, warm)
        per_call = [dev_us(e) / e.count * round(e.count / iters)
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
        raise RuntimeError(f"torch.profiler saw no device time (or no "
                           f"{expect or 'kernel'}) in {TRACE_TRIES} traces")
    lost = [f"{e.key[:60]} {e.count}/{round(e.count / iters) * iters}"
            for e in events if e.count != round(e.count / iters) * iters]
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


def check_bound(name: str, times: dict, bound: float) -> None:
    """A device time below the least time the card needs for the work
    means the profiler missed device work: fail rather than report it."""
    for what, ms in times.items():
        if not ms >= bound:
            raise AssertionError(
                f"{name}: {what} reads {ms:.5f} ms, below its bound "
                f"{bound:.5f} ms; the profiler missed device work")


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


def sass_functions(lib_path: str) -> dict:
    """``{mangled name: SASS text}`` of a built library, from the
    toolkit's ``cuobjdump -sass``."""
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
    ``dtype``, default bf16) over ROTATE copies, each held to the bound of its work; the first
    route's time is ``ms``.  ``opts`` (sm_scale, softcap) go to the routes
    and the plain version.  Each route's output at its default split is
    held against the plain version within TOL first (``errs``).
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
    del out, ref, args
    copies = [(q.clone(), tuple(p.clone() for p in pool))
              for _ in range(ROTATE)]

    def over_copies(fn, *pre, **kw):
        return [lambda qc=qc, pc=pc: fn(*pre, qc, pc, bt, off, start, **kw)
                for qc, pc in copies]

    times = {f"{r}_ms": device_ms(over_copies(_paged_attention_on, r, **opts),
                                  iters, expect=PAGED_KERNELS[r])
             for r in routes}
    times["plain_ms"] = device_ms(over_copies(paged_attention_reference,
                                              **opts), 10)
    lib_scale = {"sm_scale": opts["sm_scale"]} if "sm_scale" in opts else {}
    times["library_ms"] = device_ms(over_copies(library_call, **lib_scale), 50)
    split_ms = {sk: device_ms(over_copies(_paged_attention_on, routes[0],
                                          split_k=sk, **opts), iters,
                              expect=PAGED_KERNELS[routes[0]])
                for sk in sweep}
    b_ms, b_by = bound_ms(S, name, off.cpu(), start.cpu(), int8=int8,
                          pp=pp, **geom)
    check_bound(label, {**times, **{f"split_k {sk}": ms
                                    for sk, ms in split_ms.items()}}, b_ms)
    if parked:
        off_p = torch.full_like(off, T)
        times["parked_ms"] = device_ms(
            [lambda qc=qc, pc=pc: _paged_attention_on(
                routes[0], qc, pc, bt, off_p, start, **opts)
             for qc, pc in copies], iters, expect=PAGED_KERNELS[routes[0]])
        check_bound(label + " parked", {"parked": times["parked_ms"]},
                    bound_ms(S, name, off_p.cpu(), start.cpu(),
                             int8=int8, pp=pp, **geom)[0])
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
    gathered pages to q's type, as the kernels do): q in bf16 and fp32, D
    64/128/256, S 1/4/128 (bf16 q takes the decode route at S = 1 and the
    wgmma route at S > 1 by the rule, and is held on the simt route as
    well), split-K 1 and the default (and at S = 1 the largest cluster), a
    parked slot and a constant page in every case, plus a window and a
    softcap case.  All three routes timed at the decode shape."""
    import torch

    bf16, fp32 = torch.bfloat16, torch.float32
    cases = [dict(S=S, d=d, split_k=sk, dtype=dt, int8=True)
             for dt in (bf16, fp32) for d in INT8_DIMS for S in INT8_WIDTHS
             for sk in (1, None)]
    cases += [dict(S=1, d=d, split_k=CLUSTER_MAX, dtype=bf16, int8=True)
              for d in INT8_DIMS]
    cases += [dict(S=1, d=D, split_k=None, dtype=dt, int8=True, window=256)
              for dt in (bf16, fp32)]
    cases += [dict(S=1, d=D, split_k=None, dtype=dt, int8=True, softcap=50.0,
                   sm_scale=SOFTCAP_SCALE) for dt in (bf16, fp32)]
    cases += [dict(S=S, d=d, split_k=sk, dtype=bf16, int8=True, route="simt")
              for d in INT8_DIMS for S in INT8_WIDTHS for sk in (1, None)]
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
# fewest query rows share a kv head
SWEEP_WIDTHS = {NQ: (2, 3, 4, 16, 32, 64, 128), NKV: (2, 3, 4, 16)}


def phase1_chunks():
    """The multi-row route (paged_attention_wgmma_kernel, bf16 q): held
    against the plain version over bf16 and int8 pools at D 64/128/256, S
    16/32/128, split-K 1 and the default, a parked slot, a constant int8
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
    cases = [dict(S=S, d=d, split_k=sk, int8=i8, **w) for i8 in (False, True)
             for d in INT8_DIMS for S in (16, 128) for sk in (1, None)]
    cases += [dict(S=32, split_k=None, int8=i8, **w) for i8 in (False, True)]
    cases += [dict(S=128, split_k=None, int8=i8, window=256, **w)
              for i8 in (False, True)]
    cases += [dict(S=128, split_k=None, int8=i8, softcap=50.0,
                   sm_scale=SOFTCAP_SCALE, **w) for i8 in (False, True)]
    narrow = [dict(S=S, d=d, split_k=None, int8=i8, **w)
              for i8 in (False, True) for d in INT8_DIMS for S in (2, 3)]
    worst = max(held[("wgmma", "bfloat16")] for held in (
        hold_paged_cases(cases, "phase1 wgmma"),
        hold_paged_cases(narrow, "phase1 wgmma"),
        hold_paged_cases(narrow, "phase1 wgmma G=1", nq=NKV, nkv=NKV)))

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
                            expect=PAGED_KERNELS[r])
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


def make_requests(vocab: int, n: int, new_tokens: int, seed: int):
    import numpy as np

    from neuronx_distributed_tpu_torch.serving import Request

    rs = np.random.RandomState(seed)
    return [Request(request_id=i,
                    prompt_ids=rs.randint(1, vocab,
                                          size=rs.randint(32, CONTEXT + 1)
                                          ).tolist(),
                    max_new_tokens=new_tokens) for i in range(n)]


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


def steady_decode_profile(model_pim, vocab: int, steps: int = 10,
                          label: str = "phase2", **engine_kw) -> dict:
    """Where a steady decode step's time goes: the host clock over
    ``steps`` engine steps with all slots decoding (no admissions), then
    the same steps under ``torch.profiler``: the device's busy share and
    the share spent in the paged-attention kernels.  ``engine_kw`` goes to
    the engine (``kv_quant="int8"``: the int8 pool)."""
    import torch

    from neuronx_distributed_tpu_torch import ServingEngine

    eng = ServingEngine(model_pim, page_size=PAGE_SIZE, **engine_kw)
    for r in make_requests(vocab, SLOTS, 3 * steps + 4, SEED + 3):
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


def set_launches(entries, routes: dict) -> None:
    """The main path's launch counts into kernels-line entries: each
    decode-route entry gets the decode kernel's, each simt entry the simt
    kernel's, each wgmma entry the wgmma kernel's."""
    for e in entries:
        route = ("decode" if "decode" in e["name"] else
                 "wgmma" if "wgmma" in e["name"] else "simt")
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
    set_launches(entries, routes)

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


def admitted_engine(model_pim, vocab: int, **kw):
    """An engine whose 8 slots hold freshly prefilled requests and has not
    decoded yet (the engine's admission, without ``step()``'s decode)."""
    from neuronx_distributed_tpu_torch import ServingEngine

    eng = ServingEngine(model_pim, page_size=PAGE_SIZE, prefix_cache=False,
                        **kw)
    for r in make_requests(vocab, SLOTS, 8, SEED + 1):
        eng.submit(r)
    for slot, req in eng.scheduler.admit(eng._clock()):
        eng._prefill_into_slot(slot, req, [])
    return eng


def decode_logits(model_pim, eng, paged_kernel: bool):
    """The engine's next decode step's logits over a copy of its pool."""
    caches = [tuple(t.clone() for t in entry) for entry in eng.caches]
    lg, _, _ = model_pim.decode_pages(
        eng._next_tok[:, None], eng._offsets, eng._kv.tables, caches,
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
    set_launches(entries, routes)
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
    verify_entry["launches"] = out["d_self"]["launches_by_route"]["wgmma"]
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


def visible_pairs(S: int, T: int, causal: bool = True, window=None) -> int:
    """(query, key) pairs one head sees: query i (at kv position i + T - S)
    sees keys up to its own position and, with a window, no further back
    than window - 1 positions."""
    import numpy as np

    if not causal:
        return S * T
    hi = np.arange(S, dtype=np.int64) + (T - S)
    return int(np.minimum(hi + 1, window or T).sum())


def flash_bound_ms(B, HQ, HKV, S, T, D, item, which, window=None) -> tuple:
    """Least time for one kernel call at a causal shape.  Operations: per
    visible (q, k) pair 4D (q.k and p.v), 6D for dq (q.k, dO.v, dS.k) and
    8D for dk/dv (q.k, dO.v, p^T.dO, dS^T.q), at the peak of the inputs'
    type; ``which="bwd"`` is one call producing dq, dk and dv together
    (SDPA's backward), 10D per pair (q.k, dO.v, p^T.dO, dS.k, dS^T.q).
    Bytes: each input read once, each output written once."""
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
    for window, softcap in variants:
        case = ("timing", Bt, HQ, HKV, S, S, Dt, True, window, softcap,
                sm_scale, False, False)
        opts = dict(sm_scale=sm_scale, window=window, softcap=softcap)
        copies[window, softcap] = []
        for i in range(ROTATE):
            q, k, v, do, _, _, _ = flash_inputs(case, torch.bfloat16, dev,
                                                SEED + 100 + i)
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
    check_bound("SDPA forward", {"library": lib_fwd_ms},
                flash_bound_ms(Bt, HQ, HKV, S, S, Dt, 2, "fwd")[0])
    check_bound("SDPA backward", {"library": lib_bwd_ms},
                flash_bound_ms(Bt, HQ, HKV, S, S, Dt, 2, "bwd")[0])
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
            k_ms = device_ms(calls, 20, expect=kname)
            b_ms, b_by, flops, nbytes = flash_bound_ms(
                Bt, HQ, HKV, S, S, Dt, 2, w, window)
            k_ms = check_events(
                fn_name, k_ms, lambda: kernel(*cs[0][:nargs], **opts), 20,
                retrace=lambda: device_ms(calls, 20, expect=kname))
            times = {"kernel": k_ms}
            if (window, softcap) == variants[0]:
                times["plain"] = device_ms(
                    [lambda c=c: plain(*c[:nargs], **opts) for c in cs[:2]],
                    2)
            check_bound(f"{fn_name} {label} window {window} softcap "
                        f"{softcap}", times, b_ms)
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
                flash_entries) -> dict:
    """The training main path after ``initialize_parallel_model``: the
    optimizer, ``make_train_step``, WARMUP_STEPS + TIMED_STEPS steps on
    ``batch`` with every launch count set to 0 first.  Checks finite and
    falling losses and the flash launches (``fwd_per_layer`` forwards, one
    dq and one dk/dv per layer and step; written into ``flash_entries``),
    then reports tokens/s, MFU, peak memory and where a profiled step's
    device time goes."""
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
    step = make_train_step(config, model, opt, loss_fn)
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
    fpt = transformer_flops_per_token(
        cfg.num_layers, cfg.hidden_size, cfg.intermediate_size,
        cfg.vocab_size, St, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_)
    util = mfu(tok_s, fpt, PEAK_FLOPS["bfloat16"])
    L = cfg.num_layers
    want = {"fwd": steps * L * fwd_per_layer, "dq": steps * L,
            "dkv": steps * L}
    log(f"{label}: {steps} steps at batch {Bt} x {St}, remat {cfg.remat}, "
        f"lr {config.optimizer.learning_rate}, clip "
        f"{config.optimizer.max_grad_norm}: losses "
        + ", ".join(f"{x:.4f}" for x in losses) + "; grad norms "
        + ", ".join(f"{x:.3f}" for x in norms))
    log(f"{label}: {TIMED_STEPS} timed steps in {wall:.3f} s = "
        f"{wall / TIMED_STEPS * 1e3:.1f} ms/step, {tok_s:.1f} tokens/s, "
        f"MFU {util:.4f} ({fpt / 1e9:.3f} GFLOP/token, 6N + attention, "
        f"against 989 TFLOP/s bf16); peak memory {peak / 2**30:.2f} GiB; "
        f"launches {launches}, expected {want} ({steps} steps x {L} layers, "
        f"{fwd_per_layer} forward(s) per layer under remat {cfg.remat})")
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"non-finite loss or grad norm: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    if launches != want:
        raise AssertionError(f"flash launches {launches}, expected {want}")
    for w, n in launches.items():
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
        f"{flash_ms:.2f} ms ({flash_ms / busy_ms:.1%} of device time): "
        + ", ".join(f"{w} ({FLASH_KERNELS[w][1]}) {ms:.2f} ms"
                    for w, ms in flash_by.items()) + " per step")
    log(f"{label} top device time per step: " + "; ".join(
        f"{e.key[:60]} {dev_us(e) / 1e3 / 2:.2f} ms" for e in top))
    del opt, step
    return {"layers": L, "params": model.num_parameters(), "steps": steps,
            "batch": [Bt, St], "remat": cfg.remat, "losses": losses,
            "grad_norms": norms, "step_ms": wall / TIMED_STEPS * 1e3,
            "tok_s": tok_s, "mfu": util, "flops_per_token": fpt,
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
    set_launches(entries, routes)
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
    del pim, gpim, model
    gc.collect()
    torch.cuda.empty_cache()
    return {**busy, "wall_s": wall, "tokens": tokens, "tok_s": tokens / wall,
            "decode_steps": steps, "launches": launches,
            "launches_by_route": routes,
            "peak_gib": peak / 2**30, "logits_rel_l2": rel,
            "argmax_agreement": agree,
            "graphs_async": {**g_busy, "wall_s": g_wall,
                             "launches_by_route": g_routes}}


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
        del model_pim
        dec256, simt256 = phase1_gemma()
        flash, flash256 = phase3()
        training = phase4(flash)
        log(f"phase4 summary: {json.dumps(training)}")
        gemma_training = phase5(flash256)
        log(f"phase5 summary: {json.dumps(gemma_training)}")
        gemma_serving = phase5b([dec256, simt256])
        log(f"phase5b summary: {json.dumps(gemma_serving)}")
        for w in FLASH_KERNELS:
            flash[w]["build"] = {d: guards[w][d] for d in (64, 128)}
            flash256[w]["build"] = {256: guards[w][256]}
        kernels = ([dec, dec8, dec256, long["bf16"], long["int8"], simt,
                    simt8, simt256, entry_w, verify]
                   + [flash[w] for w in FLASH_KERNELS]
                   + [flash256[w] for w in FLASH_KERNELS])
        for k in kernels:
            if not all(math.isfinite(k[f]) for f in ("ms", "plain_ms",
                                                     "library_ms",
                                                     "bound_ms")):
                raise AssertionError(f"non-finite timing in {k['name']}")
            if not isinstance(k["launches"], int):
                raise AssertionError(f"no main-path launch count for "
                                     f"{k['name']}")
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
