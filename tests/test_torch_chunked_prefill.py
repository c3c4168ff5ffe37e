"""PyTorch port: chunked prefill and int8 KV serving against the JAX engine.

The tiny pair's shared weights (fp32) serve the same staggered requests
(page 4, slot and page reuse, a repeated prompt for a full prefix hit and
one sharing its first page for a partial hit) through the port's
``ServingEngine`` and the JAX one (``async_decode=False``):

- greedy tokens are token-identical to the JAX engine for int8 pages with
  the kernel on and off, fp pages with chunked prefill, and chunked
  prefill over int8 pages;
- within the port, chunked fp prefill equals whole fp prefill, and chunked
  int8 serving gives the same tokens with the kernel on and off (chunk x
  int8 is NOT token-identical to whole-prefill int8: a whole prefill
  samples its first token from full-precision attention, a chunk attends
  the earlier chunks' already-quantized pages);
- fp and int8 pools fed the same prefill give decode logits within the
  JAX package's drift bound, ``0 < drift < 0.25`` (tests/test_tenancy.py);
- every page an int8 write requantizes is owned by exactly one slot, so
  the page-granular read-modify-write needs no atomics;
- an identical prompt admitted while its twin is still chunking serves
  (the JAX engine raises the prefix index's divergence assertion there,
  so that case is checked within the port).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.serving import (
    Request as JaxRequest,
    ServingEngine as JaxServingEngine,
)
from neuronx_distributed_tpu_torch.models import llama
from neuronx_distributed_tpu_torch.serving import Request, ServingEngine
from torch_port_pair import C, T, build_pair

# a pool large enough that no cached chain is evicted before its hit
PAGE, NUM_PAGES = 4, 40


def _prompts(vocab, n=6, seed=7):
    """A prompt, ``n`` random ones, the first again (a full prefix hit
    once its chain is registered) and one sharing its first page."""
    rs = np.random.RandomState(seed)
    return ([[3, 1, 4, 1, 5]]
            + [rs.randint(1, vocab, size=rs.randint(2, C + 1)).tolist()
               for _ in range(n)] + [[3, 1, 4, 1, 5], [3, 1, 4, 1, 6]])


def _staggered(engine, make_request, prompts):
    """Three requests up front, then one more per step; each of the last
    two (the prefix-hit prompts) once the engine drained, so that the
    chain it may hit is registered (a chunked prefill registers when its
    last chunk lands)."""
    outs = {}

    def step():
        outs.update((o.request_id, o) for o in engine.step())

    for i in range(3):
        engine.submit(make_request(i, prompts[i]))
    for i in range(3, len(prompts)):
        if i >= len(prompts) - 2:
            while engine.has_work:
                step()
        else:
            step()
        engine.submit(make_request(i, prompts[i]))
    while engine.has_work:
        step()
    return outs


def _tokens(outs):
    return {i: list(o.token_ids) for i, o in outs.items()}


_JAX_RUNS: dict = {}


def _jax_tokens(kv_quant, chunk):
    key = (kv_quant, chunk)
    if key not in _JAX_RUNS:
        jpim, _, _, _, cfg = build_pair()
        engine = JaxServingEngine(jpim, page_size=PAGE, num_pages=NUM_PAGES,
                                  async_decode=False, kv_quant=kv_quant,
                                  prefill_chunk_tokens=chunk)
        outs = _staggered(engine, lambda i, p: JaxRequest(
            request_id=i, prompt_ids=p, max_new_tokens=3 + i % 4),
            _prompts(cfg.vocab_size))
        _JAX_RUNS[key] = _tokens(outs)
    return _JAX_RUNS[key]


def _port_run(kv_quant, chunk, paged_kernel, record=None):
    _, tpim, _, _, cfg = build_pair()
    engine = ServingEngine(tpim, page_size=PAGE, num_pages=NUM_PAGES,
                           kv_quant=kv_quant, prefill_chunk_tokens=chunk,
                           paged_kernel=paged_kernel, device="cpu")
    if record is not None:
        record["engine"] = engine
    outs = _staggered(engine, lambda i, p: Request(
        request_id=i, prompt_ids=p, max_new_tokens=3 + i % 4),
        _prompts(cfg.vocab_size))
    engine._kv.assert_invariants()
    engine.scheduler.assert_invariants()
    assert engine._kv.leaked_pages() == 0
    assert all(o.state == "finished" for o in outs.values())
    return engine, outs


@pytest.mark.parametrize("kv_quant,chunk", [("int8", None), (None, 4),
                                            (None, 8), ("int8", 4)])
@pytest.mark.parametrize("paged_kernel", [False, True])
def test_greedy_tokens_identical_to_jax_engine(kv_quant, chunk,
                                               paged_kernel):
    engine, outs = _port_run(kv_quant, chunk, paged_kernel)
    assert _tokens(outs) == _jax_tokens(kv_quant, chunk)
    assert engine.prefill_chunks == sum(o.prefill_chunks
                                        for o in outs.values())
    if chunk is not None:
        assert engine.prefill_chunks > 0
    else:
        assert engine.prefill_chunks == 0
    assert (engine.quant_pages > 0) == (kv_quant == "int8")
    if kv_quant == "int8":
        assert all(len(c) == 6 for c in engine.caches)


def test_chunked_equals_whole_prefill_and_int8_kernel_on_off():
    """Port-internal contracts: chunked fp == whole fp (greedy), and
    within the chunk x int8 cell kernel on == kernel off."""
    _, whole = _port_run(None, None, False)
    _, chunked = _port_run(None, 4, True)
    assert _tokens(chunked) == _tokens(whole)
    assert all(o.prefill_chunks >= 1 for o in chunked.values()
               if o.request_id != 7)  # 7 repeats prompt 0: a full hit
    assert chunked[7].prefill_chunks == 0
    assert chunked[8].prefill_chunks == 1  # its first page hit the cache
    _, on = _port_run("int8", 4, True)
    _, off = _port_run("int8", 4, False)
    assert _tokens(on) == _tokens(off)


def test_requantized_pages_are_owned_by_one_slot(monkeypatch):
    """Every page a decode or chunk write requantizes has refcount 1 and
    sits in exactly one slot's block table, and no page is requantized
    twice in one step."""
    seen = {"calls": 0}
    record = {}
    plan = llama._plan_requant

    def checked(block_table, *args):
        pages, hot, src = plan(block_table, *args)
        kv = record["engine"]._kv
        got = pages.tolist()
        assert len(got) == len(set(got)), f"page requantized twice: {got}"
        for p in got:
            assert p != 0, "the NULL page must never be written"
            assert kv.alloc.refcount(p) == 1, f"page {p} is shared"
            assert int((kv.tables == p).sum()) == 1, f"page {p} in 2 tables"
        seen["calls"] += 1
        return pages, hot, src

    monkeypatch.setattr(llama, "_plan_requant", checked)
    _port_run("int8", 4, True, record)
    assert seen["calls"] > 0


def test_int8_decode_logit_drift_bounded():
    """fp vs int8 pools fed the same prefill pages: decode logits within the
    JAX package's regression bound, and the drift is real (> 0)."""
    _, tpim, _, _, _ = build_pair()
    ids = np.arange(1, C + 1, dtype=np.int64)[None]
    valid = np.ones((1, C), np.int32)
    logits, row = tpim.prefill_one(ids, valid)
    outs = {}
    for quant in (None, "int8"):
        caches = tpim.make_page_pool(NUM_PAGES, PAGE, quant=quant).caches
        for lp, phys in ((0, 1), (1, 2)):
            caches = tpim.write_page(caches, row, lp, phys, row_valid=valid[0])
        table = np.zeros((3, T // PAGE), np.int32)
        table[0] = [1, 2, 3, 0]
        vfull = np.zeros((3, T), np.int32)
        vfull[0, :C] = 1
        tok = np.full((3, 1), int(torch.argmax(logits[0])), np.int64)
        lg, _, _ = tpim.decode_pages(tok, np.array([C, T, T], np.int32),
                                     table, caches, torch.from_numpy(vfull))
        outs[quant] = lg[0].numpy()
    drift = np.abs(outs["int8"] - outs[None]).max()
    assert 0.0 < drift < 0.25, f"int8 decode logit drift {drift}"


def test_identical_prompt_admitted_while_chunking():
    """Two identical prompts admitted in one step both chunk (neither finds
    the other's chain yet); the second registration is skipped, both serve
    the whole-prefill tokens, and no page leaks."""
    _, tpim, _, _, _ = build_pair()
    prompt = [5, 9, 2, 6, 5, 3, 5]
    runs = {}
    for chunk in (None, 4):
        engine = ServingEngine(tpim, page_size=PAGE, num_pages=NUM_PAGES,
                               kv_quant="int8", prefill_chunk_tokens=chunk,
                               device="cpu")
        for i in range(2):
            engine.submit(Request(request_id=i, prompt_ids=prompt,
                                  max_new_tokens=4))
        runs[chunk] = _tokens({o.request_id: o for o in
                               engine.run_until_complete(max_steps=50)})
        engine._kv.assert_invariants()
        assert engine._kv.leaked_pages() == 0
    assert runs[4][0] == runs[4][1]
    assert len(runs[4][0]) == 4


def test_engine_option_errors():
    _, tpim, _, _, _ = build_pair()
    with pytest.raises(ValueError, match="kv_quant"):
        ServingEngine(tpim, page_size=PAGE, kv_quant="fp8", device="cpu")
    for bad in (2, 6, 0, -4):
        with pytest.raises(ValueError, match="multiple of page_size"):
            ServingEngine(tpim, page_size=PAGE, prefill_chunk_tokens=bad,
                          device="cpu")


def test_failed_chunk_fails_one_request_and_reclaims_pages(monkeypatch):
    """A chunk that raises fails its own request, returns every page and
    re-raises; the engine then serves the rest."""
    _, tpim, _, _, cfg = build_pair()
    engine = ServingEngine(tpim, page_size=PAGE, num_pages=NUM_PAGES,
                           kv_quant="int8", prefill_chunk_tokens=4,
                           prefix_cache=False, device="cpu")
    real = tpim.prefill_chunk_pages
    calls = {"n": 0}

    def flaky(*args, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected chunk fault")
        return real(*args, **kw)

    monkeypatch.setattr(tpim, "prefill_chunk_pages", flaky)
    prompts = _prompts(cfg.vocab_size)
    reqs = [Request(request_id=i, prompt_ids=prompts[i], max_new_tokens=3)
            for i in range(2)]
    for r in reqs:
        engine.submit(r)
    with pytest.raises(RuntimeError, match="injected"):
        for _ in range(10):
            engine.step()
    engine._kv.assert_invariants()
    failed = [r for r in reqs if r.state.value == "failed"]
    assert len(failed) == 1
    assert failed[0].finish_reason == "prefill_chunk:RuntimeError"
    monkeypatch.setattr(tpim, "prefill_chunk_pages", real)
    outs = engine.run_until_complete(max_steps=50)
    assert [o.state for o in outs] == ["finished"]
    assert engine._kv.leaked_pages() == 0 and engine._kv.alloc.in_use == 0
