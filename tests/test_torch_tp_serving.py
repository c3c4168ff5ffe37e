"""PyTorch port: serving at tensor-parallel degree 2 against the JAX
package's tp = 2 engine.

The ``tp2`` cells of JAX ``tests/test_compose_serving.py`` (tp2 alone and
with speculative decoding, int8 pages, LoRA adapters, chunked prefill and
the paged-attention kernel's plain version; greedy and sampled rows mixed
in every cell, sync and async decode alternating) run through the JAX
engine on two virtual CPU devices, through the port's engine at tp = 1,
and through the port's engine at tp = 2 in a spawned 2-rank gloo world
over each rank's cut of the same JAX weights.

- Greedy rows are token-identical to the JAX tp = 2 engine's (the kernel
  cell against JAX's cell without it: the kernel is transparent) and to
  the port's tp = 1 engine's.  Sampled rows (torch's generators cannot
  draw JAX's threefry streams) are compared by their invariants: every
  request finished with its token count, in the vocabulary, the same on
  both ranks and the same as the port's tp = 1 engine (one stream per
  request, the same gathered logits).
- Int8 pages: the cross-shard page code is the JAX one bit for bit on
  the same inputs (one ``(scale, zero)`` over all heads of a page); the
  pool after the int8 cell equals the JAX tp = 2 engine's pool within the
  tp = 1 test's bound (``test_torch_kv_quant.py``: a few codes one step
  apart, the K/V coming from different matmul libraries).
- The solo paths at tp = 2: greedy decode equals the cacheless argmax
  (JAX ``test_trace.py``'s teacher forcing) and JAX's tp = 2 generate;
  speculative decoding with the tp-sharded model as its own draft equals
  generate; a prompt prefilled as two page chunks gives the one-shot
  prefill's logits; Gemma's and Gemma-2's cached decode at tp = 2 equal
  their cacheless argmax and JAX's tp = 2 generate.
- Both ranks' outputs, page tables and registry counters are identical;
  one decode step holds 2 all-reduces a layer, 1 for the embedding and
  1 gather of the logits; every rank reads rank 0's clock; rank 0 alone
  writes the stats file; ranks that submit different requests raise at
  the next clock reading; graphs at tp > 1, a fleet of tp > 1 replicas
  and the fleet's surface raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import sharded_params
from neuronx_distributed_tpu.kvcache import quant as jax_quant
from neuronx_distributed_tpu.models.gemma import (
    Gemma2Config as JaxGemma2Config,
    Gemma2ForCausalLM as JaxGemma2,
    GemmaConfig as JaxGemmaConfig,
    GemmaForCausalLM as JaxGemma,
)
from neuronx_distributed_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig,
    LlamaForCausalLM as JaxLlama,
)
from neuronx_distributed_tpu.parallel.mesh import (
    destroy_model_parallel,
    get_mesh,
    initialize_model_parallel,
)
from neuronx_distributed_tpu.serving import (
    Request as JaxRequest,
    SamplingParams as JaxSamplingParams,
    ServingEngine as JaxServingEngine,
)
from neuronx_distributed_tpu.tenancy import (
    AdapterLayout as JaxAdapterLayout,
    make_adapter_store as jax_make_adapter_store,
)
from neuronx_distributed_tpu.trace import (
    InferenceConfig as JaxInferenceConfig,
    ParallelInferenceModel as JaxInferenceModel,
)
from neuronx_distributed_tpu_torch.trace.engine import resolve_cuda_graphs
from neuronx_distributed_tpu_torch.utils.distributed import spawn
import torch_tp_workers as workers

TEMPS = [0.0, 0.7, 0.0, 0.9, 0.0]
ADAPTERS = [0, 1, 2, 1, 0]
GREEDY = [i for i, t in enumerate(TEMPS) if t == 0.0]
CELLS = [(), ("kernel",), ("spec",), ("quant",), ("lora",), ("chunk",)]
MAX_CODE_FLIPS = 4   # as tests/test_torch_kv_quant.py


def _key(feats):
    return "+".join(sorted(feats))


def _jax_store(pim, factors):
    per = JaxAdapterLayout.for_model(pim, 2, 2048).pages_per_adapter
    st = jax_make_adapter_store(pim, rank=2, num_pages=2 * per + 1,
                                page_elems=2048)
    for aid, layers in factors.items():
        st.register(aid, layers, alpha=4.0)
    return st


def _jax_cell(pim, feats, factors, prompts, async_decode, temps=TEMPS):
    kw = dict(page_size=workers.PAGE, num_pages=workers.NUM_PAGES,
              async_decode=async_decode, rng=jax.random.PRNGKey(7))
    if "spec" in feats:
        kw.update(draft=pim, spec_k=3)
    if "quant" in feats:
        kw["kv_quant"] = "int8"
    if "lora" in feats:
        kw["adapter_store"] = _jax_store(pim, factors)
    if "chunk" in feats:
        kw["prefill_chunk_tokens"] = 4
    eng = JaxServingEngine(pim, **kw)
    for i, p in enumerate(prompts):
        eng.submit(JaxRequest(
            request_id=i, prompt_ids=list(p), max_new_tokens=4,
            adapter_id=ADAPTERS[i] if "lora" in feats else 0,
            sampling=JaxSamplingParams(temperature=temps[i])))
    outs = {o.request_id: o for o in eng.run_until_complete(max_steps=400)}
    assert all(o.state == "finished" for o in outs.values())
    tokens = {i: list(o.token_ids) for i, o in sorted(outs.items())}
    pool = None
    if "quant" in feats:
        pool = [tuple(np.asarray(t) for t in entry) for entry in eng.caches]
    eng.close()
    return tokens, pool


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    destroy_model_parallel()
    initialize_model_parallel(tensor_parallel_size=2,
                              devices=jax.devices()[:2])
    jcfg = JaxLlamaConfig.tiny(sequence_parallel=False, dtype=jnp.float32,
                               param_dtype=jnp.float32, max_seq_len=32,
                               remat="none")
    rs = np.random.RandomState(0)
    prompts = [rs.randint(1, jcfg.vocab_size,
                          size=rs.randint(3, 8)).tolist() for _ in range(5)]
    module = JaxLlama(jcfg)
    params = sharded_params(module.init(jax.random.PRNGKey(0),
                                        jnp.zeros((3, 8), jnp.int32)))
    jpim = JaxInferenceModel(module, params, JaxInferenceConfig(
        batch_size=3, context_len=8, max_total_len=16,
        kv_cache_dtype=jnp.float32))
    H, NQ, NKV, D = (jcfg.hidden_size, jcfg.num_heads, jcfg.num_kv_heads,
                     jcfg.head_dim_)
    factors = {}
    for aid in (1, 2):
        r2 = np.random.RandomState(100 + aid)
        factors[aid] = [{
            "a_q": (r2.randn(H, 2) * 0.2).astype(np.float32),
            "b_q": (r2.randn(2, NQ * D) * 0.2).astype(np.float32),
            "a_v": (r2.randn(H, 2) * 0.2).astype(np.float32),
            "b_v": (r2.randn(2, NKV * D) * 0.2).astype(np.float32),
        } for _ in range(jcfg.num_layers)]
    jax_tokens = {}
    for n, feats in enumerate(CELLS):
        if "kernel" not in feats:
            jax_tokens[_key(feats)], _ = _jax_cell(jpim, feats, factors,
                                                   prompts, bool(n % 2))
    # an all-greedy int8 run: its pool holds only tokens both packages draw
    jax_tokens["quant_greedy"], jax_pool = _jax_cell(
        jpim, ("quant",), factors, prompts, False, [0.0] * 5)
    gen_prompt = rs.randint(0, jcfg.vocab_size, (3, 8)).astype(np.int32)
    jax_gen = np.asarray(jpim.generate(jnp.asarray(gen_prompt), 6))
    tree = jax.tree.map(np.asarray, params)
    # Gemma and Gemma-2 at tp = 2
    gemma_prompt = rs.randint(0, 256, (2, 8)).astype(np.int32)
    gemma = {}
    for family, cls, cfg_cls, extra in (
            ("gemma", JaxGemma, JaxGemmaConfig, {}),
            ("gemma2", JaxGemma2, JaxGemma2Config, {"sliding_window": 8})):
        gcfg = cfg_cls.tiny(dtype=jnp.float32, param_dtype=jnp.float32,
                            sequence_parallel=False, remat="none",
                            max_seq_len=32, **extra)
        gmod = cls(gcfg)
        gp = sharded_params(gmod.init(jax.random.PRNGKey(3),
                                      jnp.zeros((2, 8), jnp.int32)))
        gpim = JaxInferenceModel(gmod, gp, JaxInferenceConfig(
            batch_size=2, context_len=8, max_total_len=16,
            kv_cache_dtype=jnp.float32))
        gemma[family] = (jax.tree.map(np.asarray, gp),
                         np.asarray(gpim.generate(jnp.asarray(gemma_prompt),
                                                  6)))
    # the cross-shard page code on the same inputs
    page = rs.standard_normal((3, 4, 8, 16)).astype(np.float32) * 3 + 1
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharded_page = jax.device_put(page, NamedSharding(
        get_mesh(), P(None, None, "tp", None)))
    # op by op, as GSPMD reduces each page's min/max over the shards (under
    # jit XLA turns the division by 255 into a product, an ulp apart)
    jax_code = tuple(np.asarray(a) for a in
                     jax_quant.quantize_page(sharded_page))
    destroy_model_parallel()

    inp = {"llama": tree, "cells": CELLS, "factors": factors,
           "prompts": prompts, "temps": TEMPS, "adapters": ADAPTERS,
           "generate_prompt": gen_prompt,
           "chunk_ids": rs.randint(1, 256, (1, 8)).astype(np.int32),
           "gemma": gemma["gemma"][0], "gemma2": gemma["gemma2"][0],
           "gemma_prompt": gemma_prompt, "page": page,
           "tmp": str(tmp_path_factory.mktemp("tp_serving"))}
    ranks = spawn(workers.serving_cells, 2, (inp,), timeout_s=240)
    # the port at tp = 1, in this process
    pim1 = workers.build_llama(tree, 1, 0)
    port1 = {}
    for n, feats in enumerate(CELLS):
        eng = workers.cell_engine(pim1, feats, factors, bool(n % 2))
        port1[_key(feats)] = workers.serve_cell(eng, prompts, TEMPS, ADAPTERS)
        if "quant" in feats:
            port1["int8_pool"] = workers._pool(eng.caches)
        eng.close()
    return {"jax": jax_tokens, "jax_pool": jax_pool, "jax_gen": jax_gen,
            "gemma": {f: g[1] for f, g in gemma.items()},
            "jax_code": jax_code, "port1": port1, "ranks": ranks,
            "inp": inp}


@pytest.mark.parametrize("feats", CELLS, ids=[_key(f) or "tp2" for f in CELLS])
def test_tp2_cell_greedy_matches_jax_and_tp1(results, feats):
    key = _key(feats)
    jax_key = _key(f for f in feats if f != "kernel")
    for out in results["ranks"]:
        got = out["cells"][key]
        for i in GREEDY:
            assert got[i] == results["jax"][jax_key][i], (key, i)
            assert got[i] == results["port1"][key][i], (key, i)


@pytest.mark.parametrize("feats", CELLS, ids=[_key(f) or "tp2" for f in CELLS])
def test_tp2_cell_sampled_rows_keep_their_invariants(results, feats):
    key = _key(feats)
    a, b = (out["cells"][key] for out in results["ranks"])
    assert a == b
    for i, toks in a.items():
        assert len(toks) == 4 and all(0 <= t < 256 for t in toks)
        assert toks == results["port1"][key][i], (key, i)


def test_ranks_agree_on_tables_counters_and_reads(results):
    r0, r1 = results["ranks"]
    np.testing.assert_array_equal(r0["int8_tables"], r1["int8_tables"])
    assert r0["counters"] == r1["counters"]
    assert r0["reads"] == r1["reads"]
    assert r0["counters"]["quant"]["kvcache/quant_pages_total"] > 0


def test_int8_page_code_is_the_whole_page_code(results):
    """The same page content, its heads split over two ranks: the port's
    cross-shard code is JAX's GSPMD code, bit for bit."""
    from neuronx_distributed_tpu_torch.kvcache.quant import quantize_page

    page = results["inp"]["page"]
    want = results["jax_code"]
    got = [a.numpy() for a in quantize_page(torch.from_numpy(page))]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # and what each rank computed from its half of the heads
    for r, out in enumerate(results["ranks"]):
        codes, scale, zero = out["page_code"]
        np.testing.assert_array_equal(codes, np.split(want[0], 2, axis=2)[r])
        np.testing.assert_array_equal(scale, want[1])
        np.testing.assert_array_equal(zero, want[2])


def _assert_pools_close(got, want):
    flips = 0
    for g, w in zip(got, want):
        for a, b in zip(g[:2], w[:2]):
            diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert diff.max() <= 1
            flips += int((diff > 0).sum())
        for a, b in zip(g[2:], w[2:]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    assert flips <= MAX_CODE_FLIPS, f"{flips} codes one step apart"


def _joined(ranks, key):
    """The ranks' int8 pools as one: codes joined over the kv heads, the
    page params (one pair per page, on every rank) equal on both."""
    a, b = (r[key] for r in ranks)
    for ea, eb in zip(a, b):
        for i in range(2, 6):
            np.testing.assert_array_equal(ea[i], eb[i])
    return [tuple(np.concatenate([ea[i], eb[i]], axis=2) if i < 2 else ea[i]
                  for i in range(6)) for ea, eb in zip(a, b)]


def test_int8_pool_matches_jax_tp2_and_port_tp1(results):
    ranks = results["ranks"]
    assert ranks[0]["quant_greedy"] == results["jax"]["quant_greedy"]
    _assert_pools_close(_joined(ranks, "int8_greedy_pool"),
                        results["jax_pool"])
    _assert_pools_close(_joined(ranks, "int8_pool"),
                        results["port1"]["int8_pool"])


def test_decode_matches_teacher_forcing_and_jax_generate(results):
    for out in results["ranks"]:
        gen = out["generate"]
        np.testing.assert_array_equal(gen, results["jax_gen"])
        for t in range(8, 14):
            np.testing.assert_array_equal(out["teacher"][:, t - 1], gen[:, t])
        np.testing.assert_array_equal(out["speculative"], gen)


def test_chunked_prefill_matches_one_shot(results):
    for out in results["ranks"]:
        np.testing.assert_allclose(out["prefill_chunked"],
                                   out["prefill_whole"], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("family", ["gemma", "gemma2"])
def test_gemma_cached_decode_at_tp2(results, family):
    for out in results["ranks"]:
        gen, teacher = out[family]
        np.testing.assert_array_equal(gen, results["gemma"][family])
        for t in range(8, 14):
            np.testing.assert_array_equal(teacher[:, t - 1], gen[:, t])


def test_decode_step_collectives(results):
    L = 2
    for out in results["ranks"]:
        assert out["decode_collectives"] == {"all_reduce": 2 * L + 1,
                                             "all_gather": 1}


def test_lockstep_clock_and_rank0_artifacts(results):
    import os

    for out in results["ranks"]:
        assert out["clock"] == 1000.0  # rank 0's reading on every rank
    path = os.path.join(results["inp"]["tmp"], "serving_stats.jsonl")
    with open(path) as f:
        assert len(f.readlines()) == 5  # one record a request, rank 0 only


def test_diverged_ranks_raise(results):
    for out in results["ranks"]:
        assert out["diverged"] is not None
        assert "diverged" in out["diverged"]


def test_tp_refusals(results):
    for out in results["ranks"]:
        assert "A9d" in out["refusals"]["fleet"]
        assert "A9d" in out["refusals"]["export"]
    assert resolve_cuda_graphs("auto", "cuda", 2) is False
    assert resolve_cuda_graphs(False, "cuda", 2) is False
    with pytest.raises(NotImplementedError, match="A9a"):
        resolve_cuda_graphs(True, "cuda", 2)
    assert resolve_cuda_graphs("auto", "cuda", 1) is True
