#!/usr/bin/env python3
"""Drive the PyTorch port (``neuronx_distributed_tpu_torch``) on one NVIDIA
GPU and check it end to end.

    python3 chip_smoke.py

Phase 0 prints the card and builds every CUDA kernel from the sources in
the checkout, one ``nvcc`` per source started together (``-Xptxas -v``
report included).  Phase 1 holds the paged-attention kernel against its
plain PyTorch version at the serving path's shapes (Llama-3-8B attention
geometry), over fp pools and over int8 pools (the kernel's dequant
branch), and times the kernel, the plain version and one PyTorch library
call doing the same work.  Phase 2 serves 16 requests through
``ServingEngine`` on a full-width, full-depth Llama-3-8B with random bf16
weights from a seed, counts the kernel's launches on that run, checks page
accounting, and compares the kernel path's logits with the gather path's.
Phase 2b serves the same requests on the same model with int8 KV pages and
128-token prefill chunks (``kv_quant="int8"``, ``prefill_chunk_tokens``),
counts the kernel's launches (every decode step and every chunk of every
layer), checks page accounting and the int8 pool's size, compares the
kernel's logits with the gather path's on the int8 pool and the int8
pool's logits with the bf16 pool's after the same prefill, and serves the
requests once more with chunked prefill over a bf16 pool.  Phase 1 then
holds the fp-pool kernel at head_dim 256 and Gemma-2-2B's geometry (8 q
on 4 kv heads, softcap 50) and times it there.  Phase 3 holds the
flash-attention forward, dq and dk/dv kernels against their plain
versions row by row (the training paths' own shapes, causal and not, GQA
4 and 1, MQA, sliding windows, softcaps, packed segments with padding,
T > S, an lse cotangent, D 64, 128 and 256, bf16 and fp32) and times them
at Llama's training shape and at Gemma-2-2B's (global and sliding-window
layers).  Phase 4 trains a Llama-3-8B-width model cut to 4 layers (fp32
masters, bf16 compute, flash attention) for 12 steps through the
trainer's entry points, counts the flash kernels' launches on that run,
compares one step's loss, gradient norm and attention-projection
gradients through the flash and the dense core, and reports tokens/s,
MFU, peak memory and the device-busy share of a profiled step.  Phase 5
does the same for Gemma-2-2B at full width and depth (26 layers, batch
1 x 8192, selective remat: the flash kernels at D = 256), with flash vs
dense held on a 2-layer cut.  Phase 5b serves 8 requests through
``ServingEngine`` on Gemma-2-2B with random bf16 weights (the paged
kernel at D = 256 with the softcap), counts launches, checks page
accounting and compares kernel and gather logits.  A device time below
the least time its work needs fails the run.

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


def check_events(name: str, profiler_ms: float, fn, iters: int) -> None:
    """For a call of a quarter millisecond and more, the wall time between
    CUDA events over ``iters`` calls of ``fn`` that the device runs back
    to back (:func:`queued_time_ms`) is the device time plus launch gaps
    of microseconds: a profiler sum below 90 % of it lost device work.
    Where the host could not issue the calls ahead of the device, the
    event time says nothing of the device: the check is logged and
    skipped."""
    event_ms, host_ms = queued_time_ms(fn, iters)
    if event_ms is None:
        log(f"{name}: the host could not issue {iters} calls ahead of the "
            f"device ({host_ms:.5f} ms per call); no event check")
        return
    log(f"{name}: device ms per call {profiler_ms:.5f} from torch.profiler, "
        f"{event_ms:.5f} between CUDA events with the calls queued, host "
        f"{host_ms:.5f} to issue")
    if not profiler_ms >= 0.9 * event_ms:
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


# -- phase 1 ------------------------------------------------------------------


def paged_inputs(S: int, dtype, device, d: int = D, int8: bool = False,
                 nq: int = NQ, nkv: int = NKV):
    """Seeded inputs at the served geometry (``nq`` q heads on ``nkv`` kv
    heads): ragged offsets, one parked slot, non-zero kv_start, a shuffled
    physical block table.  ``int8``: the pool is the int8 six-tuple that
    ``quantize_page`` makes of the fp pool, with the first page slot 0
    attends made constant first (scale 0)."""
    import numpy as np
    import torch

    from neuronx_distributed_tpu_torch.kvcache.quant import quantize_page

    rs = np.random.RandomState(SEED + S + (0 if d == D else d))
    T = PP * PAGE
    NP = B * PP + 1
    q = torch.from_numpy(rs.standard_normal((B, S, nq, d)).astype(np.float32))
    k = torch.from_numpy(rs.standard_normal((NP, PAGE, nkv, d)).astype(np.float32))
    v = torch.from_numpy(rs.standard_normal((NP, PAGE, nkv, d)).astype(np.float32))
    bt = (rs.permutation(NP - 1) + 1).reshape(B, PP).astype(np.int32)
    off = rs.randint(40, T - S, size=B).astype(np.int32)
    off[PARKED] = T
    start = np.minimum(rs.randint(0, 40, size=B), off).astype(np.int32)
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
             int8: bool = False, nq: int = NQ, nkv: int = NKV) -> tuple:
    """Least time for the work these inputs need.  Bytes, each moved once
    over the memory rate: K and V at the positions [lo, hi] each live slot
    attends (the range the kernel walks; 1 byte an element in an int8
    pool, plus 16 bytes of page params for every page that range touches),
    q read, out written, the block table, offsets and starts read.
    Operations over the peak rate of q's type: the q.K and p.V of every
    key each query row sees."""
    T = PP * PAGE
    item = 2 if dtype_name == "bfloat16" else 4
    kv_item = 1 if int8 else item
    G = nq // nkv
    nbytes = 2 * B * S * nq * d * item + B * PP * 4 + 2 * B * 4
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
    S, d, nkv = q.shape[1], q.shape[3], k.shape[-2]
    kg = k.reshape(B, T, nkv, d).transpose(1, 2)
    vg = v.reshape(B, T, nkv, d).transpose(1, 2)
    qpos = off.long()[:, None] + torch.arange(S, device=q.device)[None]
    kpos = torch.arange(T, device=q.device)
    mask = (kpos[None, None] <= qpos[..., None]) & (
        kpos[None, None] >= start.long()[:, None, None])
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), kg, vg, attn_mask=mask[:, None], scale=sm_scale,
        enable_gqa=True).transpose(1, 2)


def hold_paged_cases(cases, label: str, d: int = D, nq: int = NQ,
                     nkv: int = NKV) -> dict:
    """Each fp-pool case: the kernel against its plain version (fp32 from
    the same inputs) within TOL, the parked slot exact zeros, and each
    option of the case (window, softcap) moving the plain output by more
    than BITE tolerances.  Returns the worst error per dtype name."""
    import torch

    from neuronx_distributed_tpu_torch.ops.paged_attention import (
        paged_attention,
        paged_attention_reference,
    )

    live = [b for b in range(B) if b != PARKED]
    worst = {"bfloat16": 0.0, "float32": 0.0}
    for case in cases:
        S, dtype = case["S"], case["dtype"]
        kw = {k: case[k] for k in ("window", "softcap", "sm_scale")
              if k in case}
        q, pool, bt, off, start = paged_inputs(S, dtype, "cuda", d, nq=nq,
                                               nkv=nkv)
        out = paged_attention(q, pool, bt, off, start,
                              split_k=case["split_k"], **kw)
        torch.cuda.synchronize()
        args = (q.float(), tuple(p.float() for p in pool), bt, off, start)
        ref = paged_attention_reference(*args, **kw)
        err = (out.float() - ref).abs().max().item()
        name = str(dtype).replace("torch.", "")
        parked_zero = bool((out[PARKED] == 0).all().item())
        bites = {}
        for opt in ("window", "softcap"):
            if opt in kw:  # the output without the option, to show it bites
                without = {k: v for k, v in kw.items() if k != opt}
                bites[opt] = (paged_attention_reference(*args, **without)
                              - ref)[live].abs().max().item()
        log(f"{label}: S={S} D={d} NQ={nq} NKV={nkv} split_k="
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
        worst[name] = max(worst[name], err)
        del q, pool, out, ref
    return worst


def phase1():
    import torch

    from neuronx_distributed_tpu_torch.ops.paged_attention import (
        paged_attention,
        paged_attention_reference,
    )

    dev = torch.device("cuda")
    bf16, fp32 = torch.bfloat16, torch.float32
    cases = [dict(S=S, split_k=sk, dtype=dt)
             for dt in (bf16, fp32) for S in (1, 4) for sk in (1, 4)]
    cases += [dict(S=1, split_k=None, dtype=dt, window=256)
              for dt in (bf16, fp32)]
    cases += [dict(S=1, split_k=None, dtype=dt, softcap=50.0,
                   sm_scale=SOFTCAP_SCALE) for dt in (bf16, fp32)]
    cases += [dict(S=1, split_k=None, dtype=bf16)]
    live = [b for b in range(B) if b != PARKED]
    worst = hold_paged_cases(cases, "phase1")["bfloat16"]

    # timing at the decode shape the served path runs: S=1, bf16, default
    # split; ROTATE copies of the inputs so reads come from device memory
    q, pool, bt, off, start = paged_inputs(1, bf16, dev)
    copies = [(q.clone(), tuple(p.clone() for p in pool))
              for _ in range(ROTATE)]

    def over_copies(fn, **kw):
        return [lambda qc=qc, pc=pc: fn(qc, pc, bt, off, start, **kw)
                for qc, pc in copies]

    kernel_ms = device_ms(over_copies(paged_attention), 200,
                          expect="paged_attention_kernel")
    plain_ms = device_ms(over_copies(paged_attention_reference), 20)
    lib_ms = device_ms(over_copies(library_call), 50)
    event_ms = {
        "kernel": cuda_time_ms(
            lambda: paged_attention(q, pool, bt, off, start), iters=200),
        "plain": cuda_time_ms(
            lambda: paged_attention_reference(q, pool, bt, off, start),
            iters=20),
        "library": cuda_time_ms(lambda: library_call(q, pool, bt, off, start),
                                iters=50)}
    lib_err = (library_call(q, pool, bt, off, start).float()
               - paged_attention_reference(q, pool, bt, off, start).float()
               )[live].abs().max().item()
    sweep = {sk: device_ms(over_copies(paged_attention, split_k=sk), 200,
                           expect="paged_attention_kernel")
             for sk in (1, 2, 4, 8)}
    log("phase1 split_k sweep, device ms per call: " + ", ".join(
        f"{sk}: {ms:.5f}" for sk, ms in sweep.items()))
    b_ms, b_by = bound_ms(1, "bfloat16", off.cpu(), start.cpu())
    check_bound("paged_attention", {"kernel": kernel_ms, "plain": plain_ms,
                                    "library": lib_ms, **{
                                        f"split_k {sk}": ms
                                        for sk, ms in sweep.items()}}, b_ms)
    log(f"phase1 timing (S=1 bf16 B={B} NQ={NQ} NKV={NKV} D={D} page={PAGE} "
        f"PP={PP}), device ms per call from torch.profiler: kernel "
        f"{kernel_ms:.5f}, plain {plain_ms:.5f}, library {lib_ms:.5f} "
        f"(agrees to {lib_err:.2e}); bound {b_ms:.5f} ({b_by}), kernel / "
        f"bound {kernel_ms / b_ms:.2f}; wall ms per call between CUDA events "
        f"over back-to-back calls (host launch rate): " + ", ".join(
            f"{k} {v:.5f}" for k, v in event_ms.items()))
    return {
        "name": "paged_attention",
        "route": "cuda",
        "source": "neuronx_distributed_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": "neuronx_distributed_tpu/ops/paged_attention.py:164",
        "launches": None,
        "max_abs_err": worst,
        "max_err": worst,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": lib_ms,
        "event_ms": event_ms,
        "split_k_ms": sweep,
        "shapes": {"q": [B, 1, NQ, D], "pool": [B * PP + 1, PAGE, NKV, D],
                   "block_table": [B, PP], "dtype": "bfloat16"},
    }


def phase1_int8():
    """The kernel's int8 branch against its plain version (which
    dequantizes the gathered pages to q's type, as the kernel does): q in
    bf16 and fp32, D 64/128/256, S 1/4/128, split-K 1 and the default, a
    parked slot and a constant page in every case, plus a window and a
    softcap case.  Timed at the decode shape and at S = 128."""
    import torch

    from neuronx_distributed_tpu_torch.ops.paged_attention import (
        paged_attention,
        paged_attention_reference,
    )

    dev = torch.device("cuda")
    bf16, fp32 = torch.bfloat16, torch.float32
    cases = [dict(S=S, d=d, split_k=sk, dtype=dt)
             for dt in (bf16, fp32) for d in INT8_DIMS for S in INT8_WIDTHS
             for sk in (1, None)]
    cases += [dict(S=1, d=D, split_k=None, dtype=dt, window=256)
              for dt in (bf16, fp32)]
    cases += [dict(S=1, d=D, split_k=None, dtype=dt, softcap=50.0,
                   sm_scale=SOFTCAP_SCALE) for dt in (bf16, fp32)]
    live = [b for b in range(B) if b != PARKED]
    worst = {"bfloat16": 0.0, "float32": 0.0}
    for case in cases:
        S, d, dtype = case["S"], case["d"], case["dtype"]
        kw = {k: case[k] for k in ("window", "softcap", "sm_scale")
              if k in case}
        q, pool, bt, off, start = paged_inputs(S, dtype, dev, d, int8=True)
        out = paged_attention(q, pool, bt, off, start,
                              split_k=case["split_k"], **kw)
        torch.cuda.synchronize()
        ref = paged_attention_reference(q, pool, bt, off, start, **kw)
        err = (out.float() - ref.float()).abs().max().item()
        name = str(dtype).replace("torch.", "")
        parked_zero = bool((out[PARKED] == 0).all().item())
        bites = {}
        for opt in ("window", "softcap"):
            if opt in kw:
                without = {k: v for k, v in kw.items() if k != opt}
                bites[opt] = (paged_attention_reference(
                    q, pool, bt, off, start, **without).float()
                    - ref.float())[live].abs().max().item()
        log(f"phase1 int8: S={S} D={d} split_k={case['split_k']} {name} "
            f"{kw or ''} max_abs_err={err:.3e} (tol {TOL[name]}) "
            f"parked_zero={parked_zero}" + "".join(
                f"; without {o} the plain output moves {v:.3e}"
                for o, v in bites.items()))
        if not err <= TOL[name]:
            raise AssertionError(f"int8 paged_attention disagrees with its "
                                 f"plain version: {err} > {TOL[name]} in "
                                 f"{case}")
        if not parked_zero:
            raise AssertionError(f"parked slot not exact zeros in {case}")
        for opt, v in bites.items():
            if not v > BITE * TOL[name]:
                raise AssertionError(
                    f"{opt} moves the plain output by only {v} in {case}: "
                    f"the case cannot catch a kernel that ignores it")
        worst[name] = max(worst[name], err)
        del q, pool, out, ref

    times = {}
    for S in (1, 128):
        q, pool, bt, off, start = paged_inputs(S, bf16, dev, int8=True)
        copies = [(q.clone(), tuple(p.clone() for p in pool))
                  for _ in range(ROTATE)]

        def over_copies(fn, **kw):
            return [lambda qc=qc, pc=pc: fn(qc, pc, bt, off, start, **kw)
                    for qc, pc in copies]

        k_ms = device_ms(over_copies(paged_attention), 200 if S == 1 else 50,
                         expect="paged_attention_kernel")
        p_ms = device_ms(over_copies(paged_attention_reference), 10)
        l_ms = device_ms(over_copies(library_call), 50)
        b_ms, b_by = bound_ms(S, "bfloat16", off.cpu(), start.cpu(),
                              int8=True)
        lib_err = (library_call(q, pool, bt, off, start).float()
                   - paged_attention_reference(q, pool, bt, off, start
                                               ).float())[live].abs().max().item()
        check_bound("paged_attention int8", {"kernel": k_ms, "plain": p_ms,
                                             "library": l_ms}, b_ms)
        log(f"phase1 int8 timing (S={S} bf16 q, int8 pool, B={B} NQ={NQ} "
            f"NKV={NKV} D={D} page={PAGE} PP={PP}), device ms per call from "
            f"torch.profiler: kernel {k_ms:.5f}, plain {p_ms:.5f}, library "
            f"{l_ms:.5f} (gather + dequantize_page + SDPA; agrees to "
            f"{lib_err:.2e}); bound {b_ms:.5f} ({b_by}), kernel / bound "
            f"{k_ms / b_ms:.2f}")
        times[S] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                    "bound_ms": b_ms, "bound_by": b_by}
        del copies, q, pool
    return {
        "name": "paged_attention_int8",
        "route": "cuda",
        "source": "neuronx_distributed_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": "neuronx_distributed_tpu/ops/paged_attention.py:211",
        "launches": None,
        "max_abs_err": worst["bfloat16"],
        "max_abs_err_fp32": worst["float32"],
        **times[1],
        "library_call": ("gather + kvcache.quant.dequantize_page + "
                         "F.scaled_dot_product_attention"),
        "chunk_s128": times[128],
        "shapes": {"q": [B, 1, NQ, D], "pool": [B * PP + 1, PAGE, NKV, D],
                   "pool_dtype": "int8", "block_table": [B, PP],
                   "dtype": "bfloat16"},
    }


# Gemma-2-2B decode attention: 8 q heads on 4 kv heads at head_dim 256,
# score scale 256^-0.5, attention softcap 50
G2_NQ, G2_NKV, G2_D, G2_SCALE, G2_CAP = 8, 4, 256, 256.0 ** -0.5, 50.0


def phase1_gemma():
    """The fp-pool kernel at head_dim 256 and the Gemma-2-2B geometry:
    bf16 and fp32 q and pool, S 1 and 4, split-K 1 and the default, the
    softcap 50 in every case (at SOFTCAP_SCALE, where it moves the output;
    at Gemma-2's own 1/16 it hardly does).  Timed at the decode shape with
    Gemma-2's scale and cap; the library call (gather + SDPA) has no
    softcap."""
    import torch

    from neuronx_distributed_tpu_torch.ops.paged_attention import (
        paged_attention,
        paged_attention_reference,
    )

    geom = dict(d=G2_D, nq=G2_NQ, nkv=G2_NKV)
    cases = [dict(S=S, split_k=sk, dtype=dt, softcap=G2_CAP,
                  sm_scale=SOFTCAP_SCALE)
             for dt in (torch.bfloat16, torch.float32) for S in (1, 4)
             for sk in (1, None)]
    worst = hold_paged_cases(cases, "phase1 gemma2", **geom)
    q, pool, bt, off, start = paged_inputs(1, torch.bfloat16, "cuda", **geom)
    copies = [(q.clone(), tuple(p.clone() for p in pool))
              for _ in range(ROTATE)]
    kw = dict(sm_scale=G2_SCALE, softcap=G2_CAP)

    def over_copies(fn, **extra):
        return [lambda qc=qc, pc=pc: fn(qc, pc, bt, off, start, **extra)
                for qc, pc in copies]

    k_ms = device_ms(over_copies(paged_attention, **kw), 200,
                     expect="paged_attention_kernel")
    p_ms = device_ms(over_copies(paged_attention_reference, **kw), 20)
    l_ms = device_ms(over_copies(library_call, sm_scale=G2_SCALE), 50)
    b_ms, b_by = bound_ms(1, "bfloat16", off.cpu(), start.cpu(), **geom)
    check_bound("paged_attention D=256", {"kernel": k_ms, "plain": p_ms,
                                          "library": l_ms}, b_ms)
    log(f"phase1 gemma2 timing (S=1 bf16 B={B} NQ={G2_NQ} NKV={G2_NKV} "
        f"D={G2_D} page={PAGE} PP={PP}, scale 1/16, softcap 50), device ms "
        f"per call from torch.profiler: kernel {k_ms:.5f}, plain "
        f"{p_ms:.5f}, library {l_ms:.5f} (gather + SDPA, no softcap); "
        f"bound {b_ms:.5f} ({b_by}), kernel / bound {k_ms / b_ms:.2f}")
    del copies, q, pool
    return {
        "name": "paged_attention_d256",
        "route": "cuda",
        "source": "neuronx_distributed_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": "neuronx_distributed_tpu/ops/paged_attention.py:164",
        "launches": None,
        "max_abs_err": worst["bfloat16"],
        "max_abs_err_fp32": worst["float32"],
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": l_ms,
        "library_call": "gather + F.scaled_dot_product_attention (no softcap)",
        "shapes": {"q": [B, 1, G2_NQ, G2_D],
                   "pool": [B * PP + 1, PAGE, G2_NKV, G2_D],
                   "block_table": [B, PP], "dtype": "bfloat16",
                   "softcap": G2_CAP},
    }


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


def phase2(kernel_entry):
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
    model_pim = ParallelInferenceModel(
        model, InferenceConfig(SLOTS, CONTEXT, MAX_TOTAL, torch.bfloat16))
    if not model_pim.paged_kernel:
        raise AssertionError("paged_kernel did not resolve to the kernel")
    torch.cuda.synchronize()
    log(f"phase2: Llama-3-8B {cfg.num_layers} layers, vocab "
        f"{cfg.vocab_size}, {n_params / 1e9:.2f}B params bf16, random init "
        f"in {time.perf_counter() - t0:.1f} s")

    engine = ServingEngine(model_pim, page_size=PAGE_SIZE)
    log(f"phase2: pool {engine._kv.alloc.num_pages} pages x {PAGE_SIZE} "
        f"tokens")
    requests = make_requests(cfg.vocab_size, N_REQUESTS, NEW_TOKENS, SEED)
    torch.cuda.reset_peak_memory_stats()
    paged_attention.launches = 0
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
    if launches != steps * cfg.num_layers:
        raise AssertionError(f"paged_attention launches {launches} != decode "
                             f"steps {steps} x {cfg.num_layers} layers")
    engine._kv.assert_invariants()
    leaks = engine._kv.leaked_pages()
    if leaks:
        raise AssertionError(f"{leaks} KV pages leaked")
    decode_tokens = tokens - N_REQUESTS  # each request's first token is prefill's
    log(f"phase2: served {N_REQUESTS} requests, {tokens} tokens in "
        f"{wall:.3f} s ({tokens / wall:.1f} tok/s overall, {decode_tokens} "
        f"decode tokens over {steps} batched decode steps, "
        f"{wall / steps * 1e3:.2f} ms/step incl. admissions); kernel "
        f"launches {launches} = {steps} x {cfg.num_layers}; page leaks 0; "
        f"peak memory {peak / 2**30:.2f} GiB")
    kernel_entry["launches"] = launches

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
    busy = steady_decode_profile(model_pim, cfg.vocab_size)
    summary = {**busy, "wall_s": wall, "tokens": tokens,
               "tok_s": tokens / wall, "decode_steps": steps,
               "ms_per_step": wall / steps * 1e3, "launches": launches,
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


def phase2b(model_pim, int8_entry, whole_tokens):
    """Serving with int8 KV pages and chunked prefill on phase 2's model:
    the slice-3 main path, then its checks."""
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
                           prefill_chunk_tokens=CHUNK_TOKENS)
    for fn in (paged_attention, fa.flash_attention_fwd,
               fa.flash_attention_dq, fa.flash_attention_dkv):
        fn.launches = 0
    paged_attention.int8_launches = 0
    t0 = time.perf_counter()
    outs = serve(engine, make_requests(cfg.vocab_size, N_REQUESTS,
                                       NEW_TOKENS, SEED))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, int8_launches = (paged_attention.launches,
                               paged_attention.int8_launches)
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
        f"x {L}, all int8; {engine.quant_pages} pages quantized on write; "
        f"page leaks 0; greedy tokens equal to phase 2's bf16 whole-prefill "
        f"run {same}/{tokens}")
    int8_entry["launches"] = int8_launches
    quant_pages = engine.quant_pages
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
    paged_attention.launches = 0
    eng = ServingEngine(model_pim, page_size=PAGE_SIZE,
                        prefill_chunk_tokens=CHUNK_TOKENS)
    t0 = time.perf_counter()
    chunked = serve(eng, make_requests(cfg.vocab_size, N_REQUESTS,
                                       NEW_TOKENS, SEED))
    torch.cuda.synchronize()
    fp_wall = time.perf_counter() - t0
    if paged_attention.launches != (eng.decode_steps
                                    + eng.prefill_chunks) * L:
        raise AssertionError("bf16 chunked run: launches != (steps + "
                             "chunks) x layers")
    if any(o.state != "finished" for o in chunked.values()):
        raise AssertionError("bf16 chunked run did not finish")
    fp_same = sum(a == b for rid, o in chunked.items()
                  for a, b in zip(o.token_ids, whole_tokens[rid]))
    first_same = sum(o.token_ids[0] == whole_tokens[rid][0]
                     for rid, o in chunked.items())
    log(f"phase2b: bf16 pool with {CHUNK_TOKENS}-token chunks vs phase 2's "
        f"whole prefill: greedy tokens equal {fp_same}/{tokens}, first "
        f"tokens {first_same}/{N_REQUESTS} ({eng.prefill_chunks} chunk "
        f"dispatches, {eng.decode_steps} decode steps, served in "
        f"{fp_wall:.3f} s)")
    del eng
    busy = steady_decode_profile(model_pim, cfg.vocab_size, label="phase2b",
                                 kv_quant="int8")
    return {**busy, "wall_s": wall, "tokens": tokens, "tok_s": tokens / wall,
            "decode_steps": steps, "chunk_dispatches": chunks,
            "launches": launches, "quant_pages": quant_pages,
            "pool_ratio": ratio, "int8_kernel_vs_gather_rel_l2": rel,
            "int8_kernel_vs_gather_argmax": agree,
            "int8_vs_bf16_rel_l2": drift, "int8_vs_bf16_argmax": drift_agree,
            "int8_tokens_equal_bf16_whole": same,
            "bf16_chunked_tokens_equal_whole": fp_same,
            "bf16_chunked_wall_s": fp_wall}


# -- phase 3 ------------------------------------------------------------------

# the training path's attention shape: Llama-3-8B heads at batch 4 x 2048
FB, FHQ, FHKV, FS, FD = 4, 32, 8, 2048, 128
# the flash cases: (name, B, HQ, HKV, S, T, D, causal, window, softcap,
# sm_scale, segments, lse cotangent); the first is the path's own shape
FLASH_CASES = [
    ("path_shape", FB, FHQ, FHKV, FS, FS, FD, True, None, None, None, False,
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
]
FLASH_KERNELS = {
    "fwd": ("flash_attention_fwd", "flash_fwd_kernel", 4, 154),
    "dq": ("flash_attention_dq", "flash_dq_kernel", 6, 311),
    "dkv": ("flash_attention_dkv", "flash_dkv_kernel", 8, 368),
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
    rs = np.random.RandomState(seed)
    f = lambda *shape: torch.from_numpy(  # noqa: E731
        rs.standard_normal(shape).astype(np.float32)).to(device, dtype)
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
            empty_ok = bool((lse[~live] <= -1e29).all()) and bool(
                (o.float().permute(0, 2, 1, 3)[qs == 0] == 0).all()
                if qs is not None else True)
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
                raise AssertionError(f"non-finite output or non-empty empty "
                                     f"rows in {name} {dn}")
            for opt, d in bites.items():
                if not d > BITE * TOL[dn]:
                    raise AssertionError(
                        f"{opt} moves the plain output by only {d} in "
                        f"{name}: the case cannot catch a kernel that "
                        f"ignores it")
            del q, k, v, do, o, lse, dq, dk, dv, ro, rdq, rdk, rdv, f32
            torch.cuda.empty_cache()


def time_flash(shape, sm_scale=None, windows=(None,), worst=None,
               source="neuronx_distributed_tpu_torch/ops/csrc/"
                      "flash_attention.cu", suffix="") -> dict:
    """B1-B3 at one causal bf16 ``shape = (B, HQ, HKV, S, D)``, ROTATE
    input copies: device ms per call of each kernel for every window in
    ``windows`` (the first is the entry's own), of its plain version and
    of the library yardstick (SDPA forward for B1, its autograd backward,
    dq, dk and dv together, for B2 and B3; causal, no window or softcap),
    each held to its bound.  Returns one kernels-line entry per kernel
    (``launches`` filled in by the training phase)."""
    import torch
    import torch.nn.functional as F

    from neuronx_distributed_tpu_torch.ops import flash_attention as fa

    Bt, HQ, HKV, S, Dt = shape
    dev = torch.device("cuda")
    copies = {}
    for window in windows:
        case = ("timing", Bt, HQ, HKV, S, S, Dt, True, window, None,
                sm_scale, False, False)
        opts = dict(sm_scale=sm_scale, window=window)
        copies[window] = []
        for i in range(ROTATE):
            q, k, v, do, _, _, _ = flash_inputs(case, torch.bfloat16, dev,
                                                SEED + 100 + i)
            o, lse = fa.flash_attention_fwd(q, k, v, **opts)
            delta = (do.float() * o.float()).sum(-1)
            copies[window].append((q, k, v, do, lse, delta))
    torch.cuda.synchronize()
    first = copies[windows[0]]
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
    check_bound("SDPA forward", {"library": lib_fwd_ms},
                flash_bound_ms(Bt, HQ, HKV, S, S, Dt, 2, "fwd")[0])
    check_bound("SDPA backward", {"library": lib_bwd_ms},
                flash_bound_ms(Bt, HQ, HKV, S, S, Dt, 2, "bwd")[0])
    check_events("SDPA forward", lib_fwd_ms, lib_fwd[0], 20)
    check_events("SDPA backward", lib_bwd_ms, lib_bwd[0], 10)
    log(f"phase3 ({label}): library forward agrees with the kernel to "
        f"{lib_err:.2e} (largest row relative error, scale {sm_scale})")
    entries = {}
    for w, (fn_name, kname, _, line) in FLASH_KERNELS.items():
        kernel = getattr(fa, fn_name)
        plain = {"fwd": fa.flash_fwd_reference, "dq": fa.flash_dq_reference,
                 "dkv": fa.flash_dkv_reference}[w]
        nargs = 3 if w == "fwd" else 6
        by_window = {}
        for window in windows:
            opts = dict(sm_scale=sm_scale, window=window)
            cs = copies[window]
            k_ms = device_ms([lambda c=c: kernel(*c[:nargs], **opts)
                              for c in cs], 20, expect=kname)
            b_ms, b_by, flops, nbytes = flash_bound_ms(
                Bt, HQ, HKV, S, S, Dt, 2, w, window)
            times = {"kernel": k_ms}
            if window == windows[0]:
                times["plain"] = device_ms(
                    [lambda c=c: plain(*c[:nargs], **opts) for c in cs[:2]],
                    2)
            check_bound(f"{fn_name} {label} window {window}", times, b_ms)
            check_events(fn_name, k_ms,
                         lambda: kernel(*cs[0][:nargs], **opts), 20)
            log(f"phase3 timing {fn_name} ({label}, window {window}), "
                f"device ms per call from torch.profiler: kernel "
                f"{k_ms:.5f}" + (f", plain {times['plain']:.5f}"
                                 if "plain" in times else "")
                + f", library {lib_fwd_ms if w == 'fwd' else lib_bwd_ms:.5f}"
                f" ({'SDPA forward' if w == 'fwd' else 'SDPA backward, dq+dk+dv'}"
                f", causal, no window); bound {b_ms:.5f} ({b_by}: "
                f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB), kernel / "
                f"bound {k_ms / b_ms:.2f}, "
                f"{flops / (k_ms * 1e-3) / 1e12:.1f} TFLOP/s")
            by_window[window] = dict(times, bound_ms=b_ms, bound_by=b_by,
                                     flops=flops)
        own = by_window[windows[0]]
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
        for window in windows[1:]:
            entries[w][f"window{window}"] = {
                "ms": by_window[window]["kernel"],
                "bound_ms": by_window[window]["bound_ms"],
                "bound_by": by_window[window]["bound_by"]}
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
    gemma = time_flash(
        (GB, GHQ, GHKV, GS, GD), G2_SCALE, (None, G2_WINDOW), worst256,
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
    top = sorted(events, key=dev_us, reverse=True)[:8]
    log(f"{label} profiled step: {prof_ms:.1f} ms wall, device busy "
        f"{busy_ms:.1f} ms ({busy_ms / prof_ms:.1%}), flash kernels "
        f"{flash_ms:.2f} ms ({flash_ms / busy_ms:.1%} of device time)")
    log(f"{label} top device time per step: " + "; ".join(
        f"{e.key[:60]} {dev_us(e) / 1e3 / 2:.2f} ms" for e in top))
    del opt, step
    return {"layers": L, "params": model.num_parameters(), "steps": steps,
            "batch": [Bt, St], "remat": cfg.remat, "losses": losses,
            "grad_norms": norms, "step_ms": wall / TIMED_STEPS * 1e3,
            "tok_s": tok_s, "mfu": util, "flops_per_token": fpt,
            "peak_gib": peak / 2**30, "profiled_step_ms": prof_ms,
            "device_busy_ms": busy_ms, "device_busy_share": busy_ms / prof_ms,
            "flash_ms": flash_ms, "launches": launches}


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


def phase5b(kernel_entry):
    """Gemma-2-2B serving: full width and depth with random bf16 weights,
    ``ServingEngine`` in paged mode over a bf16 pool; the paged kernel at
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
        model, InferenceConfig(SLOTS, CONTEXT, MAX_TOTAL, torch.bfloat16))
    if not pim.paged_kernel:
        raise AssertionError("paged_kernel did not resolve to the kernel")
    torch.cuda.synchronize()
    log(f"phase5b: Gemma-2-2B {cfg.num_layers} layers, "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f}B params "
        f"bf16, random init in {time.perf_counter() - t0:.1f} s")
    engine = ServingEngine(pim, page_size=PAGE_SIZE)
    requests = make_requests(cfg.vocab_size, G2_REQUESTS, G2_NEW_TOKENS,
                             SEED)
    torch.cuda.reset_peak_memory_stats()
    paged_attention.launches = 0
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
    if launches != steps * cfg.num_layers:
        raise AssertionError(f"paged_attention launches {launches} != decode "
                             f"steps {steps} x {cfg.num_layers} layers")
    engine._kv.assert_invariants()
    leaks = engine._kv.leaked_pages()
    if leaks:
        raise AssertionError(f"{leaks} KV pages leaked")
    log(f"phase5b: served {G2_REQUESTS} requests, {tokens} tokens in "
        f"{wall:.3f} s ({tokens / wall:.1f} tok/s overall, {steps} batched "
        f"decode steps, {wall / steps * 1e3:.2f} ms/step incl. admissions); "
        f"kernel launches {launches} = {steps} x {cfg.num_layers}; page "
        f"leaks 0; peak memory {peak / 2**30:.2f} GiB")
    kernel_entry["launches"] = launches
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
    busy = steady_decode_profile(pim, cfg.vocab_size, label="phase5b")
    del pim, model
    gc.collect()
    torch.cuda.empty_cache()
    return {**busy, "wall_s": wall, "tokens": tokens, "tok_s": tokens / wall,
            "decode_steps": steps, "launches": launches,
            "peak_gib": peak / 2**30, "logits_rel_l2": rel,
            "argmax_agreement": agree}


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
        _build.build_all()
        log(f"phase0: kernels built in {time.perf_counter() - t0:.1f} s "
            f"(one nvcc per source, in parallel)")
        for name, report in _build.build_logs.items():
            log(f"phase0: nvcc -Xptxas -v for {name}:\n{report}")
        entry = phase1()
        entry8 = phase1_int8()
        serving, model_pim, whole_tokens = phase2(entry)
        log(f"phase2 summary: {json.dumps(serving)}")
        quantized = phase2b(model_pim, entry8, whole_tokens)
        log(f"phase2b summary: {json.dumps(quantized)}")
        del model_pim
        entry256 = phase1_gemma()
        flash, flash256 = phase3()
        training = phase4(flash)
        log(f"phase4 summary: {json.dumps(training)}")
        gemma_training = phase5(flash256)
        log(f"phase5 summary: {json.dumps(gemma_training)}")
        gemma_serving = phase5b(entry256)
        log(f"phase5b summary: {json.dumps(gemma_serving)}")
        kernels = ([entry, entry8, entry256]
                   + [flash[w] for w in FLASH_KERNELS]
                   + [flash256[w] for w in FLASH_KERNELS])
        for k in kernels:
            if not all(math.isfinite(k[f]) for f in ("ms", "plain_ms",
                                                     "library_ms",
                                                     "bound_ms")):
                raise AssertionError(f"non-finite timing in {k['name']}")
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
