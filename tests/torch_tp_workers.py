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
    try:
        GQAQKVColumnParallelLinear(16, 8, 2, 4, **f32)
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
