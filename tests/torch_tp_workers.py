"""Rank bodies of the PyTorch port's multi-rank CPU tests.

Each function runs in every rank of a world that
``neuronx_distributed_tpu_torch.utils.distributed.spawn`` starts (fresh
processes, gloo on the CPU, a 30 s group timeout) and returns plain
Python and numpy values.  This module imports ``torch``, numpy and the
port only: the JAX side of each comparison runs in the test process.
"""

import os
import time

import numpy as np
import torch

GROUP_TIMEOUT_S = 30.0


def _init(**sizes):
    from neuronx_distributed_tpu_torch.parallel import mesh
    from neuronx_distributed_tpu_torch.utils.distributed import (
        initialize_distributed,
    )

    torch.manual_seed(0)
    initialize_distributed(device="cpu", timeout_s=GROUP_TIMEOUT_S)
    return mesh.initialize_model_parallel(**sizes)


# -- spawn helper ------------------------------------------------------------


def raise_on_rank(rank_to_fail: int):
    _init()
    if int(os.environ["RANK"]) == rank_to_fail:
        raise ValueError("planned failure")
    import torch.distributed as dist

    dist.barrier()  # the surviving rank waits here until it is killed
    return "unreachable"


def sleep_forever():
    time.sleep(3600)


# -- parallel state ----------------------------------------------------------


def mesh_world(sizes: dict):
    """The groups of one layout, an all-reduce over every one of them, and
    the host-side helpers."""
    import torch.distributed as dist

    from neuronx_distributed_tpu_torch.parallel import mesh
    from neuronx_distributed_tpu_torch.utils import distributed

    _init(**sizes)
    rank = dist.get_rank()
    out = {"rank": rank, "groups": {}, "sums": {}, "coords": {}}
    for axes in mesh.GROUP_AXES:
        key = axes if isinstance(axes, str) else "+".join(axes)
        ranks = mesh.get_group_ranks(axes)
        t = torch.tensor([float(rank + 1)])
        dist.all_reduce(t, group=mesh.get_group(axes))
        out["groups"][key] = ranks
        out["sums"][key] = float(t)
    out["sizes"] = {
        "tp": mesh.get_tensor_parallel_size(),
        "tp_rank": mesh.get_tensor_parallel_rank(),
        "dp": mesh.get_data_parallel_size(),
        "pp": mesh.get_pipeline_parallel_size(),
        "kvr": mesh.get_kv_size_multiplier()}
    t = torch.tensor([float(rank)])
    dist.all_reduce(t, group=mesh.get_tensor_parallel_cpu_group())
    out["tp_cpu_sum"] = float(t)
    out["host0"] = distributed.broadcast_from_host0({"from": rank})
    distributed.rendezvous("mesh")
    out["primary"] = distributed.is_primary()
    return out


# -- mappings ----------------------------------------------------------------


def _leaf(x):
    return torch.tensor(np.asarray(x), requires_grad=True)


def mappings_cases(inp: dict):
    """The JAX ``tests/test_mappings.py`` programs at tp = 2, forward and
    backward: each rank's loss and its gradients, as numpy."""
    from neuronx_distributed_tpu_torch.parallel import mappings as mp

    _init(tensor_parallel_size=2)
    r = mp.group_rank()

    def cols(a, n=2):
        w = a.shape[-1] // n
        return a[..., r * w:(r + 1) * w]

    def rows(a, n=2):
        h = a.shape[0] // n
        return a[r * h:(r + 1) * h]

    out = {}
    # copy -> column matmul -> row matmul -> reduce (the Megatron MLP)
    x, w1, w2 = (_leaf(inp["x"]), _leaf(cols(inp["w1"])),
                 _leaf(rows(inp["w2"])))
    y = (mp.copy_to_tensor_parallel_region(x) @ w1) @ w2
    loss = (mp.reduce_from_tensor_parallel_region(y)
            * torch.from_numpy(inp["ct"])).sum()
    loss.backward()
    out["mlp"] = (loss.item(), x.grad.numpy(), w1.grad.numpy(),
                  w2.grad.numpy())
    # gather / scatter along the last dim
    xl = _leaf(cols(inp["g_x"]))
    loss = (mp.gather_from_tensor_parallel_region(xl)
            * torch.from_numpy(inp["g_c"])).sum()
    loss.backward()
    out["gather"] = (loss.item(), xl.grad.numpy())
    xf = _leaf(inp["g_x"])
    loss = mp.reduce_from_tensor_parallel_region(
        (mp.scatter_to_tensor_parallel_region(xf)
         * torch.from_numpy(cols(inp["g_c"]))).sum())
    loss.backward()
    out["scatter"] = (loss.item(), xf.grad.numpy())
    # sequence-parallel gather feeding a tensor-parallel matmul
    xs, ws = _leaf(rows(inp["sp_x"])), _leaf(cols(inp["sp_w"]))
    full = mp.gather_from_sequence_parallel_region(xs, 0, True)
    loss = mp.reduce_from_tensor_parallel_region(
        ((full @ ws) * torch.from_numpy(cols(inp["sp_ct"]))).sum())
    loss.backward()
    out["sp_gather"] = (loss.item(), xs.grad.numpy(), ws.grad.numpy())
    # sequence-parallel scatter
    xf = _leaf(inp["ss_x"])
    loss = mp.reduce_from_tensor_parallel_region(
        (mp.scatter_to_sequence_parallel_region(xf, 0)
         * torch.from_numpy(rows(inp["ss_c"]))).sum())
    loss.backward()
    out["sp_scatter"] = (loss.item(), xf.grad.numpy())
    # reduce-scatter of per-rank partial sums onto the sequence
    yp = _leaf(inp["rs_parts"][r])
    red = mp.reduce_scatter_to_sequence_parallel_region(yp, 0)
    loss = mp.reduce_from_tensor_parallel_region(
        (red * torch.from_numpy(rows(inp["rs_c"]))).sum())
    loss.backward()
    out["reduce_scatter"] = (loss.item(), red.detach().numpy(),
                             yp.grad.numpy())
    out["counts"] = dict(mp.COUNTS)
    return out


# -- layers ------------------------------------------------------------------


def _cut(a, dim, r, n=2):
    return np.ascontiguousarray(np.split(np.asarray(a), n, axis=dim)[r])


def layer_cases(inp: dict):
    """The tensor-parallel layers at tp = 2 over each rank's cut of the
    full weights (the JAX partition specs): local outputs, as numpy."""
    from neuronx_distributed_tpu_torch.convert import (
        llama_params_from_jax,
        shard_params_for_rank,
    )
    from neuronx_distributed_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaForCausalLM,
    )
    from neuronx_distributed_tpu_torch.parallel import (
        ColumnParallelLinear,
        GQAQKVColumnParallelLinear,
        ParallelEmbedding,
        RowParallelLinear,
        mesh,
    )
    from neuronx_distributed_tpu_torch.parallel import mappings
    from neuronx_distributed_tpu_torch.parallel.mappings import group_rank

    f32 = dict(dtype=torch.float32, device="cpu")
    t = torch.from_numpy
    # built before the tp = 2 state exists: degree 1 for good
    cfg1 = LlamaConfig.tiny(num_kv_heads=2, dtype=torch.float32)
    solo = LlamaForCausalLM(cfg1, device="cpu").init_random(5)
    solo_col = ColumnParallelLinear(16, 32, gather_output=True, **f32)
    solo_col.reset_parameters(torch.Generator().manual_seed(5))
    ids = t(inp["llama_ids"]).long()
    with torch.no_grad():
        solo_before = solo(ids).numpy()
    _init(tensor_parallel_size=2)
    r = group_rank()
    out = {}
    mappings.reset_counts()
    with torch.no_grad():
        logits = solo(ids)
        gathered = solo.gather_logits(logits)
    x = t(inp["x16"]).clone().requires_grad_(True)
    y = solo_col(x)
    y.sum().backward()
    out["built_at_tp1"] = {
        "before": solo_before, "after": logits.numpy(),
        "gathered_shape": tuple(gathered.shape),
        "column_shape": tuple(y.shape), "x_grad": x.grad.numpy(),
        "column_kernel": solo_col.kernel.detach().numpy(),
        "tp": (solo.tp.size, solo_col.tp.size),
        "collectives": dict(mappings.COUNTS)}
    mappings.reset_counts()
    with torch.no_grad():
        col = ColumnParallelLinear(16, 32, gather_output=True, **f32)
        col.kernel.copy_(t(_cut(inp["col_kernel"], 1, r)))
        col.bias.copy_(t(_cut(inp["col_bias"], 0, r)))
        out["column"] = col(t(inp["x16"])).numpy()
        fused = ColumnParallelLinear(16, 64, n_fused=2, use_bias=False, **f32)
        fused.kernel.copy_(t(_cut(inp["fused_kernel"], 2, r)))
        out["fused"] = fused(t(inp["x16"])).numpy()
        row = RowParallelLinear(32, 16, **f32)
        row.kernel.copy_(t(_cut(inp["row_kernel"], 0, r)))
        row.bias.copy_(t(inp["row_bias"]))
        out["row"] = row(t(_cut(inp["x32"], 2, r))).numpy()
        emb = ParallelEmbedding(64, 16, **f32)
        emb.embedding.copy_(t(_cut(inp["embedding"], 0, r)))
        out["embed"] = emb(t(inp["ids"]).long()).numpy()
        out["attend"] = emb.attend(t(inp["x16"])).numpy()
        qkv = GQAQKVColumnParallelLinear(16, 8, 2, 4, use_bias=True, **f32)
        for n in ("q", "k", "v"):
            getattr(qkv, f"{n}_kernel").copy_(
                t(_cut(inp[f"{n}_kernel"], 1, r)))
            getattr(qkv, f"{n}_bias").copy_(t(_cut(inp[f"{n}_bias"], 0, r)))
        out["qkv"] = tuple(a.numpy() for a in qkv(t(inp["x16"])))
        # the whole tiny Llama from the JAX tree, cut for this rank
        cfg = LlamaConfig.tiny(num_kv_heads=2, dtype=torch.float32)
        model = LlamaForCausalLM(cfg, device="cpu")
        model.load_state_dict(llama_params_from_jax(
            shard_params_for_rank(inp["llama"], 2, r), cfg, tp=2))
        logits = model(t(inp["llama_ids"]).long())
        out["llama_local"] = logits.numpy()
        out["llama"] = model.gather_logits(logits).numpy()
        # tp-invariant random init
        init = LlamaForCausalLM(cfg, device="cpu").init_random(5)
        out["init"] = {k: v.numpy() for k, v in init.state_dict().items()}
    # refusals: heads that do not split, kvr > 1
    errors = {}
    for name, build in (
            ("kv_heads", lambda: GQAQKVColumnParallelLinear(16, 8, 1, 4, **f32)),
            ("q_heads", lambda: GQAQKVColumnParallelLinear(16, 5, 1, 4, **f32)),
            ("vocab", lambda: ParallelEmbedding(63, 16, **f32))):
        try:
            build()
        except ValueError as e:
            errors[name] = str(e)
    mesh.destroy_model_parallel()
    mesh.initialize_model_parallel(tensor_parallel_size=2,
                                   kv_size_multiplier=2)
    # the layers take kvr > 1 (training); serving refuses it
    from neuronx_distributed_tpu_torch.trace import (
        InferenceConfig,
        ParallelInferenceModel,
    )

    kvr_model = LlamaForCausalLM(LlamaConfig.tiny(num_kv_heads=2,
                                                  dtype=torch.float32),
                                 device="cpu")
    out["kvr_heads"] = (kvr_model.model.layer_0.attn.qkv.q_kernel.shape[1],
                        kvr_model.model.layer_0.attn.qkv.k_kernel.shape[1])
    try:
        ParallelInferenceModel(kvr_model, InferenceConfig(1, 4, 8,
                                                          torch.float32),
                               device="cpu")
    except NotImplementedError as e:
        errors["kvr"] = str(e)
    out["errors"] = errors
    return out


# -- serving -----------------------------------------------------------------

# the compose matrix's serving geometry (JAX tests/test_compose_serving.py)
PAGE, NUM_PAGES, SLOTS, CTX, TOTAL = 4, 40, 3, 8, 16


def build_llama(tree, tp: int, rank: int, T: int = TOTAL):
    """The compose matrix's tiny fp32 Llama from the JAX tree, cut for
    ``rank`` at ``tp``, behind a ``ParallelInferenceModel`` on the CPU."""
    from neuronx_distributed_tpu_torch.convert import (
        llama_params_from_jax,
        shard_params_for_rank,
    )
    from neuronx_distributed_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaForCausalLM,
    )
    from neuronx_distributed_tpu_torch.trace import (
        InferenceConfig,
        ParallelInferenceModel,
    )

    cfg = LlamaConfig.tiny(dtype=torch.float32, max_seq_len=32)
    model = LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(llama_params_from_jax(
        shard_params_for_rank(tree, tp, rank), cfg, tp=tp))
    return ParallelInferenceModel(
        model, InferenceConfig(SLOTS, CTX, T, torch.float32), device="cpu")


def make_store(pim, factors):
    from neuronx_distributed_tpu_torch.tenancy import (
        AdapterLayout,
        make_adapter_store,
    )

    per = AdapterLayout.for_model(pim, 2, 2048).pages_per_adapter
    store = make_adapter_store(pim, rank=2, num_pages=2 * per + 1,
                               page_elems=2048)
    for aid, layers in factors.items():
        store.register(aid, layers, alpha=4.0)
    return store


def cell_engine(pim, feats, factors, async_decode, **kw):
    """One compose-matrix cell's engine (the JAX ``_engine``'s kwargs)."""
    from neuronx_distributed_tpu_torch.serving import ServingEngine

    kw = dict(kw, page_size=PAGE, num_pages=NUM_PAGES, seed=7,
              async_decode=async_decode, device="cpu")
    if "kernel" in feats:
        kw["paged_kernel"] = True
    if "spec" in feats:
        kw.update(draft=pim, spec_k=3)
    if "quant" in feats:
        kw["kv_quant"] = "int8"
    if "lora" in feats:
        kw["adapter_store"] = make_store(pim, factors)
    if "chunk" in feats:
        kw["prefill_chunk_tokens"] = 4
    return ServingEngine(pim, **kw)


def serve_cell(eng, prompts, temps, adapters, new_tokens=4):
    """Submit every prompt, drain; ``{request id: tokens}``."""
    from neuronx_distributed_tpu_torch.serving import Request, SamplingParams

    for i, p in enumerate(prompts):
        eng.submit(Request(request_id=i, prompt_ids=list(p),
                           max_new_tokens=new_tokens,
                           adapter_id=adapters[i] if eng._adapters else 0,
                           sampling=SamplingParams(temperature=temps[i])))
    outs = {o.request_id: o for o in eng.run_until_complete(max_steps=400)}
    assert all(o.state == "finished" for o in outs.values()), outs
    return {i: list(o.token_ids) for i, o in sorted(outs.items())}


def _pool(caches):
    return [tuple(t.numpy().copy() for t in entry) for entry in caches]


def _gemma(family, tree, rank, prompt):
    """Gemma / Gemma-2 at tp = 2 from the JAX tree: the greedy generate,
    and the cacheless argmax of every generated position."""
    from neuronx_distributed_tpu_torch.convert import (
        gemma2_params_from_jax,
        gemma_params_from_jax,
        shard_params_for_rank,
    )
    from neuronx_distributed_tpu_torch.models.gemma import (
        Gemma2Config,
        Gemma2ForCausalLM,
        GemmaConfig,
        GemmaForCausalLM,
    )
    from neuronx_distributed_tpu_torch.trace import (
        InferenceConfig,
        ParallelInferenceModel,
    )

    if family == "gemma":
        cfg = GemmaConfig.tiny(dtype=torch.float32, max_seq_len=32)
        model, conv = GemmaForCausalLM(cfg, device="cpu"), gemma_params_from_jax
    else:
        cfg = Gemma2Config.tiny(dtype=torch.float32, max_seq_len=32,
                                sliding_window=8)
        model, conv = Gemma2ForCausalLM(cfg, device="cpu"), gemma2_params_from_jax
    model.load_state_dict(conv(shard_params_for_rank(tree, 2, rank), cfg,
                               tp=2))
    pim = ParallelInferenceModel(model, InferenceConfig(2, 8, 16,
                                                        torch.float32),
                                 device="cpu")
    out = pim.generate(prompt, 6)
    with torch.no_grad():
        full = model.gather_logits(model(out))
    return out.numpy(), full.argmax(-1).numpy()


def serving_cells(inp: dict):
    """Every tp = 2 serving check of ``tests/test_torch_tp_serving.py`` in
    one world: the compose cells, int8 pages, teacher forcing, chunked
    prefill, Gemma, collective counts, rank identity, the lockstep clock,
    the artifacts, the refusals, and last the divergence check."""
    from neuronx_distributed_tpu_torch.parallel import mappings
    from neuronx_distributed_tpu_torch.parallel.mappings import group_rank
    from neuronx_distributed_tpu_torch.serving import Request, ServingEngine
    from neuronx_distributed_tpu_torch.serving.fleet import FleetRouter, Replica
    from neuronx_distributed_tpu_torch.serving.lockstep import DivergedRanks
    from neuronx_distributed_tpu_torch.trace import speculative_generate

    from neuronx_distributed_tpu_torch.kvcache.quant import (
        page_ranges,
        quantize_page,
    )
    from neuronx_distributed_tpu_torch.parallel import mesh

    _init(tensor_parallel_size=2)
    r = group_rank()
    out = {"rank": r, "cells": {}}
    # the cross-shard page code: this rank's half of the heads
    half = torch.from_numpy(_cut(inp["page"], 2, r))
    stats = page_ranges([half], mesh.get_tensor_parallel_group())[0]
    out["page_code"] = tuple(a.numpy() for a in quantize_page(half, stats))
    pim = build_llama(inp["llama"], 2, r)
    factors = inp["factors"]
    for n, feats in enumerate(inp["cells"]):
        eng = cell_engine(pim, feats, factors, async_decode=bool(n % 2))
        key = "+".join(sorted(feats))
        out["cells"][key] = serve_cell(eng, inp["prompts"], inp["temps"],
                                       inp["adapters"])
        if "quant" in feats:
            out["int8_pool"] = _pool(eng.caches)
            out["int8_tables"] = eng._kv.tables.copy()
        eng._kv.assert_invariants()
        snap = eng.registry.snapshot()
        out.setdefault("counters", {})[key] = {
            k: v for k, v in snap.items()
            if isinstance(v, (int, float)) and not k.endswith("_ms")
            and "seconds" not in k}
        out.setdefault("reads", {})[key] = eng.lockstep.reads
        eng.close()

    eng = cell_engine(pim, ("quant",), factors, async_decode=False)
    out["quant_greedy"] = serve_cell(eng, inp["prompts"], [0.0] * 5,
                                     inp["adapters"])
    out["int8_greedy_pool"] = _pool(eng.caches)
    eng.close()

    # one decode step's collectives: 2 all-reduces a layer, 1 for the
    # embedding and 1 gather of the logits
    eng = cell_engine(pim, (), factors, async_decode=False)
    for i in range(SLOTS):
        eng.submit(Request(request_id=i, prompt_ids=[3 + i, 5, 7],
                           max_new_tokens=3))
    eng.step()
    mappings.reset_counts()
    pim.decode_pages(eng._next_tok[:, None], eng._offsets, eng._kv.tables,
                     eng.caches, eng.valid.clone())
    out["decode_collectives"] = dict(mappings.COUNTS)
    eng.close()

    # the solo paths: teacher forcing, speculative decoding, chunked prefill
    prompt = inp["generate_prompt"]
    gen = pim.generate(prompt, 6)
    with torch.no_grad():
        full = pim.module.gather_logits(pim.module(gen))
    out["generate"] = gen.numpy()
    out["teacher"] = full.argmax(-1).numpy()
    out["speculative"] = speculative_generate(pim, pim, prompt, 6,
                                              k=3).numpy()
    ids = inp["chunk_ids"]
    valid = np.ones((1, CTX), np.int32)
    whole, _ = pim.prefill_one(ids, valid)
    pool = pim.make_page_pool(8, PAGE).caches
    table = np.array([[1, 2, 3, 4]], np.int32)
    vrow = np.zeros((1, TOTAL), np.int32)
    vrow[0, :CTX] = 1
    for off in (0, 4):
        chunked, pool = pim.prefill_chunk_pages(ids[:, off:off + 4], off,
                                                table, pool, vrow)
    out["prefill_whole"], out["prefill_chunked"] = (whole.numpy(),
                                                    chunked.numpy())
    out["gemma"] = _gemma("gemma", inp["gemma"], r, inp["gemma_prompt"])
    out["gemma2"] = _gemma("gemma2", inp["gemma2"], r, inp["gemma_prompt"])

    # the lockstep clock: rank 0's readings on every rank, stats from
    # rank 0 only
    stats = os.path.join(inp["tmp"], "serving_stats.jsonl")
    eng = cell_engine(pim, (), factors, async_decode=True,
                      clock=lambda: 1000.0 * (r + 1), stats_path=stats)
    out["clock"] = eng._clock()
    serve_cell(eng, inp["prompts"], [0.0] * 5, inp["adapters"])
    eng.close()
    # the refusals: graphs at tp > 1, a fleet of tp > 1 replicas, the
    # fleet's surface
    refusals = {}
    try:
        FleetRouter([Replica(0, lambda: cell_engine(pim, (), factors, True))])
    except NotImplementedError as e:
        refusals["fleet"] = str(e)
    try:
        cell_engine(pim, (), factors, True).export_prefix(0)
    except NotImplementedError as e:
        refusals["export"] = str(e)
    out["refusals"] = refusals
    # divergence: rank 1 submits another request; every rank raises at the
    # next clock reading instead of pairing collectives wrongly
    eng = cell_engine(pim, (), factors, async_decode=False)
    try:
        eng.submit(Request(request_id=0, prompt_ids=[1, 2, 3 + r],
                           max_new_tokens=2))
        eng.run_until_complete(max_steps=20)
        out["diverged"] = None
    except DivergedRanks as e:
        out["diverged"] = str(e)
    return out


# -- on the card ---------------------------------------------------------------


def cuda_pair(layers: int, prompts: list, new_tokens: int):
    """A full-width Llama-3-8B cut to ``layers`` layers at tp = 2 on one
    card (both ranks share it, over gloo): served runs over a bf16 pool
    (whole prefill) and an int8 pool (64-token chunks), launches by route,
    the decode kernel against the gather path at the local heads, the
    prefill logits, and the refusals."""
    import torch.distributed as dist

    from neuronx_distributed_tpu_torch import (
        InferenceConfig,
        LlamaConfig,
        LlamaForCausalLM,
        ParallelInferenceModel,
        Request,
        ServingEngine,
    )
    from neuronx_distributed_tpu_torch.ops.paged_attention import paged_attention
    from neuronx_distributed_tpu_torch.parallel import mesh
    from neuronx_distributed_tpu_torch.serving.fleet import FleetRouter, Replica
    from neuronx_distributed_tpu_torch.utils.distributed import (
        initialize_distributed,
    )

    initialize_distributed(device="cuda", backend="gloo", timeout_s=120)
    mesh.initialize_model_parallel(tensor_parallel_size=2)
    cfg = LlamaConfig.llama3_8b(num_layers=layers)
    model = LlamaForCausalLM(cfg, device="cuda").init_random(0)
    icfg = InferenceConfig(4, 128, 256, torch.bfloat16)
    pim = ParallelInferenceModel(model, icfg)
    out = {"graphs": pim.cuda_graphs, "paged_kernel": pim.paged_kernel,
           "kv_heads": pim.num_kv_heads,
           "q_heads": model.model.layer_0.attn.qkv.q_kernel.shape[1]}
    try:
        ParallelInferenceModel(model, icfg, cuda_graphs=True)
    except NotImplementedError as e:
        out["graphs_refusal"] = str(e)
    runs = {}
    for label, kw in (("bf16", {}), ("int8", dict(kv_quant="int8",
                                                  prefill_chunk_tokens=64))):
        for c in ("launches", "int8_launches", "wgmma_launches",
                  "decode_launches"):
            setattr(paged_attention, c, 0)
        eng = ServingEngine(pim, page_size=16, **kw)
        for i, p in enumerate(prompts):
            eng.submit(Request(request_id=i, prompt_ids=p,
                               max_new_tokens=new_tokens))
        outs = {o.request_id: list(o.token_ids)
                for o in eng.run_until_complete(max_steps=2000)}
        pa = paged_attention
        runs[label] = {
            "tokens": outs, "steps": eng.decode_steps,
            "chunks": eng.prefill_chunks, "decode": pa.decode_launches,
            "wgmma": pa.wgmma_launches,
            "simt": pa.launches - pa.decode_launches - pa.wgmma_launches,
            "tables": eng._kv.tables.copy()}
        eng._kv.assert_invariants()
        eng.close()
    out["runs"] = runs
    # one decode step at the local heads: the kernel against the gather path
    eng = ServingEngine(pim, page_size=16, async_decode=False)
    for i, p in enumerate(prompts):
        eng.submit(Request(request_id=i, prompt_ids=p, max_new_tokens=4))
    eng.step()
    lg = {}
    for pk in (True, False):
        caches = [tuple(t.clone() for t in e) for e in eng.caches]
        lg[pk], _, _ = pim.decode_pages(
            eng._next_tok[:, None], eng._offsets, eng._kv.tables, caches,
            eng.valid.clone(), paged_kernel=pk)
    out["kernel_vs_gather"] = ((lg[True].float() - lg[False].float()).norm()
                               / lg[False].float().norm()).item()
    eng.close()
    prefill = []
    for p in prompts:
        ids = np.zeros((1, 128), np.int64)
        ids[0, -len(p):] = p
        valid = (np.arange(128) >= 128 - len(p)).astype(np.int32)[None]
        logits, _ = pim.prefill_one(ids, valid)
        prefill.append(logits.float().cpu().numpy()[0])
    out["prefill"] = np.stack(prefill)
    try:
        FleetRouter([Replica(0, lambda: ServingEngine(pim, page_size=16))])
    except NotImplementedError as e:
        out["fleet_refusal"] = str(e)
    dist.barrier()
    return out


# -- GPT-NeoX and BERT at tp = 2 (forward) -----------------------------------


def neox_bert_forward(inp: dict):
    """Each case's model at tp = 2, loaded from this rank's shard of the
    JAX tree: the gathered logits (and BERT's NSP logits) of the case's
    inputs, and the local vocab width the head gives."""
    from neuronx_distributed_tpu_torch.convert import (
        bert_params_from_jax,
        gpt_neox_params_from_jax,
        shard_params_for_rank,
    )
    from neuronx_distributed_tpu_torch.models.bert import (
        BertConfig,
        BertForPreTraining,
    )
    from neuronx_distributed_tpu_torch.models.gpt_neox import (
        GPTNeoXConfig,
        GPTNeoXForCausalLM,
    )

    _init(tensor_parallel_size=2)
    rank = int(os.environ["RANK"])
    out = {}
    for name, case in inp.items():
        shard = shard_params_for_rank(case["tree"], 2, rank)
        if case["family"] == "neox":
            cfg = GPTNeoXConfig.tiny(remat="none", dtype=torch.float32,
                                     **case["config"])
            model = GPTNeoXForCausalLM(cfg, device="cpu")
            model.load_state_dict(gpt_neox_params_from_jax(shard, cfg, tp=2))
            with torch.no_grad():
                local = model(torch.from_numpy(case["ids"]))
            out[name] = {"logits": model.gather_logits(local).numpy(),
                         "local_vocab": local.shape[-1]}
        else:
            cfg = BertConfig.tiny(dtype=torch.float32, **case["config"])
            model = BertForPreTraining(cfg, device="cpu")
            model.load_state_dict(bert_params_from_jax(shard, cfg, tp=2))
            with torch.no_grad():
                mlm, nsp = model(*(torch.from_numpy(case[k]) for k in
                                   ("ids", "token_type_ids",
                                    "attention_mask")))
            out[name] = {"logits": model.gather_logits(mlm).numpy(),
                         "nsp": nsp.numpy(), "local_vocab": mlm.shape[-1]}
    return out


# -- training past one rank: layers, loss, clipping, ZeRO-1 ------------------


def _part(a, dim, r, n=2):
    """Rank ``r``'s slice of ``a`` along ``dim`` (``n`` ranks) as a tensor."""
    return torch.from_numpy(_cut(a, dim, r, n))


def _np(t):
    return t.detach().numpy().copy()


class TinyMLP(torch.nn.Module):
    """The JAX ``tests/test_grads_zero1.py`` MLP: column (64, no bias),
    tanh GELU, row (16, no bias), fp32."""

    def __init__(self):
        from neuronx_distributed_tpu_torch.parallel import (
            ColumnParallelLinear,
            RowParallelLinear,
        )

        super().__init__()
        f32 = dict(dtype=torch.float32, device="cpu", use_bias=False)
        self.col = ColumnParallelLinear(16, 64, **f32)
        self.row = RowParallelLinear(64, 16, **f32)

    def forward(self, x):
        import torch.nn.functional as F

        return self.row(F.gelu(self.col(x), approximate="tanh"))


def _mlp_loss(model, batch):
    return ((model(batch["x"]) - batch["y"]) ** 2).mean()


def layer_training_cases(inp: dict):
    """The training layers at tp = 2 (sequence parallelism, the vocab-
    parallel cross entropy), at tp = 2 with kvr = 2 (the QKV projection,
    grouped attention and the global grad norm) and ZeRO-1 at dp = 2: each
    rank's outputs and gradients, as numpy."""
    import torch.nn.functional as F

    from neuronx_distributed_tpu_torch.config import training_config
    from neuronx_distributed_tpu_torch.convert import (
        llama_params_from_jax,
        shard_params_for_rank,
    )
    from neuronx_distributed_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaForCausalLM,
    )
    from neuronx_distributed_tpu_torch.optimizer.zero1 import state_by_param
    from neuronx_distributed_tpu_torch.parallel import (
        ColumnParallelLinear,
        GQAQKVColumnParallelLinear,
        ParallelEmbedding,
        RowParallelLinear,
        mesh,
    )
    from neuronx_distributed_tpu_torch.parallel.grads import (
        allreduce_kv_replicated_gradients,
        allreduce_sequence_parallel_gradients,
        clip_grad_norm,
        get_grad_norm,
    )
    from neuronx_distributed_tpu_torch.parallel.layers import (
        is_sequence_parallel,
        tp_layout,
    )
    from neuronx_distributed_tpu_torch.parallel.loss import (
        vocab_parallel_cross_entropy,
    )
    from neuronx_distributed_tpu_torch.parallel.mappings import group_rank
    from neuronx_distributed_tpu_torch.trainer import (
        initialize_parallel_model,
        initialize_parallel_optimizer,
        make_train_step,
    )

    f32 = dict(dtype=torch.float32, device="cpu")
    t = torch.from_numpy
    _init(tensor_parallel_size=2)
    r = group_rank()
    out = {}

    # the column -> row MLP with biases under sequence parallelism: x and
    # the output hold this rank's half of the sequence
    col = ColumnParallelLinear(16, 64, sequence_parallel=True, **f32)
    row = RowParallelLinear(64, 16, sequence_parallel=True, **f32)
    with torch.no_grad():
        col.kernel.copy_(_part(inp["w1"], 1, r))
        col.bias.copy_(_part(inp["b1"], 0, r))
        row.kernel.copy_(_part(inp["w2"], 0, r))
        row.bias.copy_(t(inp["b2"]))
    x = _part(inp["sp_x"], 1, r).requires_grad_(True)
    y = row(F.gelu(col(x), approximate="tanh"))
    (y * _part(inp["sp_ct"], 1, r)).sum().backward()
    bias_before = _np(row.bias.grad)
    allreduce_sequence_parallel_gradients([col.kernel, col.bias, row.kernel,
                                           row.bias])
    out["sp_mlp"] = {
        "y": _np(y), "x": _np(x.grad), "w1": _np(col.kernel.grad),
        "b1": _np(col.bias.grad), "w2": _np(row.kernel.grad),
        "b2": _np(row.bias.grad), "b2_own_shard": bias_before,
        "marked": [is_sequence_parallel(p) for p in (
            col.kernel, col.bias, row.kernel, row.bias)],
        "layouts": [tp_layout(p) for p in (col.kernel, col.bias, row.kernel,
                                           row.bias)]}
    # the embedding's sequence-parallel output
    emb = ParallelEmbedding(64, 16, sequence_parallel_output=True, **f32)
    with torch.no_grad():
        emb.embedding.copy_(_part(inp["table"], 0, r))
    e = emb(t(inp["emb_ids"]).long())
    (e * _part(inp["emb_ct"], 1, r)).sum().backward()
    out["sp_embed"] = {"y": _np(e), "table": _np(emb.embedding.grad)}

    # the vocab-parallel cross entropy: values and logit gradients
    for smoothing in (0.0, 0.1):
        lg = _part(inp["ce_logits"], -1, r).requires_grad_(True)
        loss = vocab_parallel_cross_entropy(lg, t(inp["ce_targets"]),
                                            smoothing)
        (loss * t(inp["ce_ct"])).sum().backward()
        out[f"ce_{smoothing}"] = {"loss": _np(loss), "grad": _np(lg.grad)}
    huge = torch.full((2, 32), 1e4)
    out["ce_extreme"] = _np(vocab_parallel_cross_entropy(
        huge, torch.tensor([3, 9])))

    # kvr = 2 at tp = 2: a rank holds 4 of the 8 q heads and both kv heads
    mesh.destroy_model_parallel()
    mesh.initialize_model_parallel(tensor_parallel_size=2,
                                   kv_size_multiplier=2)
    qkv = GQAQKVColumnParallelLinear(16, 8, 2, 4, **f32)
    with torch.no_grad():
        qkv.q_kernel.copy_(_part(inp["q_kernel"], 1, qkv.tp.q_block))
        qkv.k_kernel.copy_(t(inp["k_kernel"]))
        qkv.v_kernel.copy_(t(inp["v_kernel"]))
    x = t(inp["kv_x"]).clone().requires_grad_(True)
    q, k, v = qkv(x)
    B, S, NQ, D = q.shape
    G = NQ // k.shape[2]
    qg = q.reshape(B, S, k.shape[2], G, D)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k) / np.sqrt(D)
    attn = torch.einsum("bkgst,btkd->bskgd", torch.softmax(scores, -1),
                        v).reshape(B, S, NQ, D)
    (attn * _part(inp["kv_ct"], 2, qkv.tp.q_block)).sum().backward()
    k_own = _np(qkv.k_kernel.grad)
    allreduce_kv_replicated_gradients(qkv.parameters())
    out["kvr"] = {"q": _np(q), "k": _np(k), "v": _np(v), "attn": _np(attn),
                  "q_grad": _np(qkv.q_kernel.grad),
                  "k_grad": _np(qkv.k_kernel.grad), "k_own": k_own,
                  "v_grad": _np(qkv.v_kernel.grad), "x_grad": _np(x.grad),
                  "q_block": qkv.tp.q_block, "kv_heads": qkv.kv_heads,
                  "layouts": [tp_layout(p) for p in (
                      qkv.q_kernel, qkv.k_kernel, qkv.v_kernel)]}

    # the global grad norm at tp = 2, kvr = 2 over a Llama's sharded (q,
    # o_proj, MLP, embedding, head), kv-replicated (k, v) and replicated
    # sequence-parallel (norm) gradients, each set to this rank's cut of
    # one full gradient tree
    cfg = LlamaConfig.tiny(num_kv_heads=2, dtype=torch.float32,
                           param_dtype=torch.float32)
    model = LlamaForCausalLM(cfg, device="cpu")
    grads = llama_params_from_jax(
        shard_params_for_rank(inp["grad_tree"], 2, r, kvr=2), cfg, tp=2,
        kvr=2)
    params = list(model.parameters())
    for n, p in model.named_parameters():
        p.grad = grads[n].clone()
    gl = [p.grad for p in params]
    norm = get_grad_norm(gl, params=params)
    _, pre = clip_grad_norm(gl, inp["max_norm"], params=params)
    out["clip"] = {"norm": norm.item(), "pre": pre.item(),
                   "post": get_grad_norm(gl, params=params).item(),
                   "local": get_grad_norm(grads.values()).item(),
                   "kinds": sorted({str(tp_layout(p)) + str(
                       is_sequence_parallel(p)) for p in params})}

    # ZeRO-1 at dp = 2 (tp = 1): the trainer's step with the states sharded
    # against the replicated step, from the same weights and batch
    mesh.destroy_model_parallel()
    mesh.initialize_model_parallel(tensor_parallel_size=1)
    zero = {}
    for z in (True, False):
        config = training_config(learning_rate=1e-2, grad_clipping=False,
                                 compute_dtype="float32",
                                 zero_one_enabled=z)
        model = initialize_parallel_model(config, lambda d: TinyMLP(),
                                          device="cpu")
        with torch.no_grad():
            model.module.col.kernel.copy_(t(inp["z_w1"]))
            model.module.row.kernel.copy_(t(inp["z_w2"]))
        opt = initialize_parallel_optimizer(config, model)
        step = make_train_step(config, model, opt, _mlp_loss)
        losses = [step({"x": inp["z_x"], "y": inp["z_y"]})["loss"].item()
                  for _ in range(inp["z_steps"])]
        names = {p: n for n, p in model.module.named_parameters()}
        zero[z] = {
            "losses": losses,
            "params": {n: _np(p) for n, p in model.module.named_parameters()},
            "state": {n: {k: _np(v) for k, v in st.items()} for n, st in
                      state_by_param(opt.optimizer, opt.zero1, names).items()},
            "zero1": opt.zero1 is not None}
    out["zero1"] = zero
    out["dp"] = (mesh.get_data_parallel_size(), mesh.get_data_parallel_rank())
    from neuronx_distributed_tpu_torch.parallel.grads import (
        psum_over_data_parallel,
    )

    g = [torch.full((3,), float(out["dp"][1] + 1)), torch.ones(2, 2)]
    out["psum"] = [_np(t) for t in psum_over_data_parallel(g)]
    return out


# -- training past one rank: models and the trainer ---------------------------


def _train(config, build, state_fn, loss_fn, batches, generators=None,
           accum=1, counts=False):
    """``initialize_parallel_model`` (which lays out the ranks from
    ``config.mesh``), this rank's weights from ``state_fn(module)``, the
    optimizer and one ``make_train_step`` run over ``batches``; tears the
    layout down after.  Returns losses, grad norms, this rank's final
    parameters, its optimizer state by name and, with ``counts``, each
    step's ``mappings.COUNTS``."""
    from neuronx_distributed_tpu_torch.optimizer.zero1 import state_by_param
    from neuronx_distributed_tpu_torch.parallel import mappings, mesh
    from neuronx_distributed_tpu_torch.trainer import (
        initialize_parallel_model,
        initialize_parallel_optimizer,
        make_eval_step,
        make_train_step,
    )

    model = initialize_parallel_model(config, build, device="cpu")
    module = model.module
    if state_fn is not None:
        module.load_state_dict(state_fn(module))
    opt = initialize_parallel_optimizer(config, model)
    step = make_train_step(config, model, opt, loss_fn,
                           grad_accum_steps=accum)
    eval_loss = make_eval_step(config, model, loss_fn)(batches[0])["loss"]
    losses, norms, per_step = [], [], []
    for i, b in enumerate(batches):
        mappings.reset_counts()
        g = None if generators is None else torch.Generator().manual_seed(
            generators[i])
        m = step(b, g)
        per_step.append(dict(mappings.COUNTS))
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    names = {p: n for n, p in module.named_parameters()}
    out = {"losses": losses, "norms": norms, "eval_loss": eval_loss.item(),
           "params": {n: _np(p) for n, p in module.named_parameters()},
           "state": {n: {k: _np(v) for k, v in st.items()} for n, st in
                     state_by_param(opt.optimizer, opt.zero1, names).items()},
           "tp": (module.tp.size, module.tp.rank),
           "dp": (mesh.get_data_parallel_size(),
                  mesh.get_data_parallel_rank()),
           "zero1": opt.zero1 is not None}
    if counts:
        out["counts"] = per_step
    mesh.destroy_model_parallel()
    return out


def model_training_cases(inp: dict):
    """GPT-NeoX and BERT trained at tp = 2 from this rank's shard of the
    JAX trees, BERT with dropout under one seed at tp = 2, and the
    collectives of one tp = 2 sequence-parallel Llama step at 2 and 4
    layers."""
    from neuronx_distributed_tpu_torch.config import training_config
    from neuronx_distributed_tpu_torch.convert import (
        bert_params_from_jax,
        gpt_neox_params_from_jax,
        shard_params_for_rank,
    )
    from neuronx_distributed_tpu_torch.models import (
        BertConfig,
        BertForPreTraining,
        GPTNeoXConfig,
        GPTNeoXForCausalLM,
        LlamaConfig,
        LlamaForCausalLM,
        pretraining_loss,
    )
    from neuronx_distributed_tpu_torch.models.common import causal_lm_loss
    from neuronx_distributed_tpu_torch.utils.distributed import (
        initialize_distributed,
    )

    initialize_distributed(device="cpu", timeout_s=GROUP_TIMEOUT_S)
    f32 = dict(dtype=torch.float32, param_dtype=torch.float32)
    config = training_config(tensor_parallel_size=2, learning_rate=1e-3,
                             compute_dtype="float32", seed=0)
    out = {}

    def shard(tree, convert, cfg):
        return lambda m: convert(shard_params_for_rank(tree, 2, m.tp.rank),
                                 cfg, tp=2)

    neox = GPTNeoXConfig.tiny(**f32)
    out["neox"] = _train(
        config, lambda d: GPTNeoXForCausalLM(neox, device=d),
        shard(inp["neox_tree"], gpt_neox_params_from_jax, neox),
        causal_lm_loss, inp["neox_batches"])
    for name, kw in (("bert", {}), ("bert_sp", dict(sequence_parallel=True))):
        bcfg = BertConfig.tiny(**f32, **kw)
        out[name] = _train(
            config, lambda d, c=bcfg: BertForPreTraining(c, device=d),
            shard(inp["bert_tree"], bert_params_from_jax, bcfg),
            pretraining_loss, inp["bert_batches"])
    drop = BertConfig.tiny(**f32, hidden_dropout=0.1, sequence_parallel=True)
    out["bert_dropout"] = _train(
        config, lambda d: BertForPreTraining(drop, device=d),
        shard(inp["bert_tree"], bert_params_from_jax, drop),
        pretraining_loss, inp["bert_batches"], inp["dropout_seeds"])
    for layers in (2, 4):
        for remat in ("none", "selective"):
            lcfg = LlamaConfig.tiny(num_layers=layers, num_kv_heads=2,
                                    remat=remat, max_seq_len=64, **f32)
            out[f"budget_{layers}_{remat}"] = _train(
                config, lambda d, c=lcfg: LlamaForCausalLM(c, device=d),
                None, causal_lm_loss, inp["budget_batches"],
                counts=True)["counts"][0]
    return out


def llama_dp_cases(inp: dict):
    """The tiny Llama trained on a world of 4 at each case's layout (tp = 2
    x dp = 2, with or without kvr = 2), from this rank's shard of the JAX
    tree: what ``_train`` returns, by case."""
    from neuronx_distributed_tpu_torch.config import training_config
    from neuronx_distributed_tpu_torch.convert import (
        llama_params_from_jax,
        shard_params_for_rank,
    )
    from neuronx_distributed_tpu_torch.models.common import (
        causal_lm_loss_sum,
        make_causal_lm_loss_sum,
    )
    from neuronx_distributed_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaForCausalLM,
    )
    from neuronx_distributed_tpu_torch.utils.distributed import (
        initialize_distributed,
    )

    initialize_distributed(device="cpu", timeout_s=GROUP_TIMEOUT_S)
    out = {}
    for case in inp["cases"]:
        kvr = case["kvr"]
        config = training_config(tensor_parallel_size=2,
                                 kv_size_multiplier=kvr, seed=0,
                                 compute_dtype="float32", **case["opt"])
        cfg = LlamaConfig.tiny(num_kv_heads=2, dtype=torch.float32,
                               param_dtype=torch.float32,
                               remat=case["remat"], max_seq_len=16,
                               attention_impl=case["attention"])
        loss = (make_causal_lm_loss_sum(case["chunk"]) if case["chunk"]
                else causal_lm_loss_sum)

        def state(m, tree=case["params"], kvr=kvr, cfg=cfg):
            return llama_params_from_jax(shard_params_for_rank(
                tree, 2, m.tp.rank, kvr), cfg, tp=2, kvr=kvr)

        out[case["name"]] = _train(
            config, lambda d, c=cfg: LlamaForCausalLM(c, device=d), state,
            loss, case["batches"], accum=case["accum"], counts=True)
    return out
