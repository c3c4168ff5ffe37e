#!/usr/bin/env python3
"""Drive the PyTorch port (``neuronx_distributed_tpu_torch``) on one NVIDIA
GPU and check it end to end.

    python3 chip_smoke.py

Phase 0 prints the card and builds every CUDA kernel from the sources in
the checkout (``nvcc -Xptxas -v`` report included).  Phase 1 holds each
kernel against its plain PyTorch version at the serving path's shapes
(Llama-3-8B attention geometry) and times the kernel, the plain version
and one PyTorch library call doing the same work.  Phase 2 serves 16
requests through ``ServingEngine`` on a full-width, full-depth Llama-3-8B
with random bf16 weights from a seed, counts the kernel's launches on that
run, checks page accounting, and compares the kernel path's logits with
the gather path's.

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
# Phase 2: the served engine
SLOTS, CONTEXT, MAX_TOTAL, PAGE_SIZE = 8, 512, 1024, 16
N_REQUESTS, NEW_TOKENS = 16, 64
# Phase 2 kernel-vs-gather logits: relative L2 error of the last decode
# step's logits (bf16 weights and pool, 32 layers of rounding apart)
LOGITS_REL_TOL = 5e-2


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


def dev_us(event) -> float:
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def device_ms(fns, iters: int, expect: str = "") -> float:
    """Device time per call: the summed self time of every kernel (and
    copy) that ``iters`` calls put on the card, as ``torch.profiler``
    reads it, over ``iters``.  The calls cycle through ``fns``, one per
    copy of the inputs, so that a call finds its inputs in device memory
    and not in the 50 MB L2 the previous call filled.  ``expect`` names a
    kernel that must be among those seen."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fns[i % len(fns)]()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(dev_us(e) for e in events)
    if total <= 0:
        raise RuntimeError("torch.profiler saw no device time")
    if expect and not any(expect in e.key for e in events):
        raise RuntimeError(f"no {expect} among the device events: "
                           f"{[e.key[:60] for e in events]}")
    return total / 1e3 / iters


# -- phase 1 ------------------------------------------------------------------


def paged_inputs(S: int, dtype, device):
    """Seeded inputs at the served geometry: ragged offsets, one parked
    slot, non-zero kv_start, a shuffled physical block table."""
    import numpy as np
    import torch

    rs = np.random.RandomState(SEED + S)
    T = PP * PAGE
    NP = B * PP + 1
    q = torch.from_numpy(rs.standard_normal((B, S, NQ, D)).astype(np.float32))
    k = torch.from_numpy(rs.standard_normal((NP, PAGE, NKV, D)).astype(np.float32))
    v = torch.from_numpy(rs.standard_normal((NP, PAGE, NKV, D)).astype(np.float32))
    bt = (rs.permutation(NP - 1) + 1).reshape(B, PP).astype(np.int32)
    off = rs.randint(40, T - S, size=B).astype(np.int32)
    off[PARKED] = T
    start = np.minimum(rs.randint(0, 40, size=B), off).astype(np.int32)
    start[0] = 0
    to = dict(device=device)
    return (q.to(dtype=dtype, **to), (k.to(dtype=dtype, **to),
                                       v.to(dtype=dtype, **to)),
            torch.from_numpy(bt).to(**to), torch.from_numpy(off).to(**to),
            torch.from_numpy(start).to(**to))


def bound_ms(S: int, dtype_name: str, off, start, window=None) -> tuple:
    """Least time for the work these inputs need.  Bytes, each moved once
    over the memory rate: K and V at the positions [lo, hi] each live slot
    attends (the range the kernel walks), q read, out written, the block
    table, offsets and starts read.  Operations over the peak rate of the
    type: the q.K and p.V of every key each query row sees."""
    T = PP * PAGE
    item = 2 if dtype_name == "bfloat16" else 4
    G = NQ // NKV
    nbytes = 2 * B * S * NQ * D * item + B * PP * 4 + 2 * B * 4
    flops = 0
    for o, s0 in zip(off.tolist(), start.tolist()):
        if o >= T:
            continue
        hi = min(o + S - 1, T - 1)
        lo = max(s0, 0 if window is None else o - window + 1)
        nbytes += 2 * max(hi - lo + 1, 0) * NKV * D * item
        for s in range(S):
            qp = min(o + s, T - 1)
            lo_s = max(s0, 0 if window is None else o + s - window + 1)
            flops += 4 * D * NKV * G * max(qp - lo_s + 1, 0)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def library_call(q, pool, bt, off, start):
    """Yardstick only (never used by the port): gather the chains into
    [B, T, NKV, D] and run scaled_dot_product_attention with the band
    mask."""
    import torch
    import torch.nn.functional as F

    k, v = pool
    T = bt.shape[1] * k.shape[1]
    S = q.shape[1]
    kg = k[bt.long()].reshape(B, T, NKV, D).transpose(1, 2)
    vg = v[bt.long()].reshape(B, T, NKV, D).transpose(1, 2)
    qpos = off.long()[:, None] + torch.arange(S, device=q.device)[None]
    kpos = torch.arange(T, device=q.device)
    mask = (kpos[None, None] <= qpos[..., None]) & (
        kpos[None, None] >= start.long()[:, None, None])
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), kg, vg, attn_mask=mask[:, None],
        enable_gqa=True).transpose(1, 2)


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
    worst = 0.0
    for case in cases:
        S, dtype = case["S"], case["dtype"]
        kw = {k: case[k] for k in ("window", "softcap", "sm_scale")
              if k in case}
        q, pool, bt, off, start = paged_inputs(S, dtype, dev)
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
        log(f"phase1: S={S} split_k={case['split_k']} {name} {kw or ''} "
            f"max_abs_err={err:.3e} (tol {TOL[name]}) parked_zero="
            f"{parked_zero}" + "".join(
                f"; without {o} the plain output moves {d:.3e}"
                for o, d in bites.items()))
        if not err <= TOL[name]:
            raise AssertionError(f"paged_attention disagrees with its plain "
                                 f"version: {err} > {TOL[name]} in {case}")
        if not parked_zero:
            raise AssertionError(f"parked slot not exact zeros in {case}")
        for opt, d in bites.items():
            if not d > BITE * TOL[name]:
                raise AssertionError(
                    f"{opt} moves the plain output by only {d} in {case}: "
                    f"the case cannot catch a kernel that ignores it")
        if dtype == bf16:
            worst = max(worst, err)

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


def steady_decode_profile(model_pim, vocab: int, steps: int = 10) -> dict:
    """Where a steady decode step's time goes: the host clock over
    ``steps`` engine steps with all slots decoding (no admissions), then
    the same steps under ``torch.profiler``: the device's busy share and
    the share spent in the paged-attention kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from neuronx_distributed_tpu_torch import ServingEngine

    eng = ServingEngine(model_pim, page_size=PAGE_SIZE)
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) / steps * 1e3
    # device-side rows only (kernels, copies): CPU-op rows repeat their time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]

    busy_ms = sum(dev_us(e) for e in events) / 1e3 / steps
    attn_ms = sum(dev_us(e) for e in events
                  if "paged_attention" in e.key or "merge_splits" in e.key
                  ) / 1e3 / steps
    top = sorted(events, key=dev_us, reverse=True)[:6]
    log(f"phase2 steady decode (B={SLOTS}, all slots decoding): "
        f"{step_ms:.2f} ms/step host clock = {SLOTS * 1e3 / step_ms:.1f} "
        f"decode tokens/s; under the profiler "
        f"{prof_ms:.2f} ms/step with device busy {busy_ms:.3f} ms/step "
        f"({busy_ms / prof_ms:.1%}), paged attention {attn_ms:.3f} ms/step")
    log("phase2 top device time per step: " + "; ".join(
        f"{e.key[:60]} {dev_us(e) / 1e3 / steps:.3f} ms" for e in top))
    if busy_ms <= 0:
        log("phase2: the profiler saw no device time (busy share not "
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
    return {**busy, "wall_s": wall, "tokens": tokens, "tok_s": tokens / wall,
            "decode_steps": steps, "ms_per_step": wall / steps * 1e3,
            "launches": launches, "peak_gib": peak / 2**30,
            "logits_rel_l2": rel, "token_agreement": same / total}


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
        _build.build("paged_attention")
        log(f"phase0: kernel built in {time.perf_counter() - t0:.1f} s")
        for name, report in _build.build_logs.items():
            log(f"phase0: nvcc -Xptxas -v for {name}:\n{report}")
        entry = phase1()
        serving = phase2(entry)
        log(f"phase2 summary: {json.dumps(serving)}")
        if not all(math.isfinite(x) for x in (entry["ms"], entry["plain_ms"],
                                              entry["library_ms"])):
            raise AssertionError("non-finite timing")
        log(f"nvidia-smi: {nvidia_smi_line()}")
        print(json.dumps({"kernels": [entry]}), flush=True)
    except Exception:  # noqa: BLE001 - any failed phase fails the run
        traceback.print_exc()
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
