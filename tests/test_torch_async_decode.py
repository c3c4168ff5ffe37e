"""PyTorch port: the asynchronous decode loop and the fixed-shape int8 write.

- The int8 write plans a fixed ``B * n_pg`` page slots (no host sync): the
  pool's codes, scales and zeros after decode, verify and chunk writes
  equal what the earlier plan (the pages holding a hot cell, found with
  ``nonzero``; kept here as the oracle) wrote, and the NULL page is left
  bit for bit.
- The async engine's greedy tokens equal the JAX engine's, async and sync,
  over fp and int8 pools, with chunked prefill on and off and the prefix
  cache on and off, under staggered arrivals; sampled output is the same
  async and sync.
- A request cancelled while its step is in flight is discarded by its
  slot's occupancy generation; the others are untouched and no page leaks.
- A steady decode step makes exactly one packed put and one packed fetch.
- ``cuda_graphs``: "auto" is off on the CPU, ``True`` there raises.
"""

import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.serving import (
    Request as JaxRequest,
    ServingEngine as JaxServingEngine,
)
from neuronx_distributed_tpu_torch.kvcache.quant import (
    dequantize_page,
    quantize_page,
)
from neuronx_distributed_tpu_torch.models import llama
from neuronx_distributed_tpu_torch.serving import (
    Request,
    SamplingParams,
    ServingEngine,
)
from neuronx_distributed_tpu_torch.trace import ParallelInferenceModel
from torch_port_pair import C, T, build_pair

PAGE, NUM_PAGES = 4, 40


# -- the fixed-shape int8 write --------------------------------------------


def _old_requant(kv_cache, k, v, block_table, cache_offset, kv_valid, n_new,
                 page):
    """The variable-shape plan and write this port shipped before: only the
    pages holding a hot cell, found with ``nonzero`` (one host sync)."""
    B, PP = block_table.shape
    Tt = PP * page
    off = cache_offset.long()
    n_pg = (n_new - 1 + page - 1) // page + 1
    lp = (off // page)[:, None] + torch.arange(n_pg)
    pos = lp[..., None] * page + torch.arange(page)
    s_idx = pos - off[:, None, None]
    hot = (s_idx >= 0) & (s_idx < n_new) & (pos < Tt)
    hot &= kv_valid.gather(1, pos.clamp(0, Tt - 1).reshape(B, -1)
                           ).reshape(hot.shape) > 0
    rows, js = hot.any(dim=2).nonzero(as_tuple=True)
    pages = block_table.long()[rows, lp[rows, js].clamp(max=PP - 1)]
    src = rows[:, None] * n_new + s_idx[rows, js].clamp(0, n_new - 1)
    hot = hot[rows, js][..., None, None]
    ck, cv, ks, kz, vs, vz = kv_cache
    for cq, sc, zp, new in ((ck, ks, kz, k), (cv, vs, vz, v)):
        flat = new.reshape(-1, *new.shape[2:])
        pg = dequantize_page(cq[pages], sc[pages], zp[pages])
        pg = torch.where(hot, flat[src].float(), pg)
        cq[pages], sc[pages], zp[pages] = quantize_page(pg)


def _int8_pool(seed, NP, nkv=2, D=8):
    g = torch.Generator().manual_seed(seed)
    k = torch.randn((NP, PAGE, nkv, D), generator=g)
    v = torch.randn((NP, PAGE, nkv, D), generator=g)
    (qk, sk, zk), (qv, sv, zv) = quantize_page(k), quantize_page(v)
    return (qk, qv, sk, zk, sv, zv)


# (name, n_new, offsets, first valid key per row): decode steps with a
# parked slot (offset T) and one on the table's last page; verify chunks
# straddling pages and running past the table; a chunk prefill whose
# first page is part left pad.  Row 1's first page is all left pad and
# rides the NULL page, as the engine's tables do.  The new cells are
# valid, as the engine marks them before a decode or verify write; a
# chunk's row holds the whole prompt's validity.
WRITES = [
    ("decode", 1, [8, 13, 16, 15], [3, 4, 0, 5]),
    ("verify", 5, [9, 11, 16, 12], [2, 4, 0, 0]),
    ("chunk", 8, [0, 0, 16, 8], [3, 4, 0, 0]),
]


@pytest.mark.parametrize("name,n_new,offsets,lo", WRITES)
def test_fixed_int8_plan_writes_the_earlier_plans_bytes(name, n_new, offsets,
                                                        lo):
    B, PP = len(offsets), T // PAGE
    NP = B * PP + 1
    rs = np.random.RandomState(len(name))
    table = (rs.permutation(NP - 1) + 1).reshape(B, PP).astype(np.int32)
    table[1, 0] = 0  # an all-pad page on the NULL page
    bt = torch.from_numpy(table)
    off = torch.tensor(offsets, dtype=torch.int32)
    hi = (torch.full((B,), T) if name == "chunk"
          else (off + n_new).clamp(max=T))
    ar = torch.arange(T)[None, :]
    valid = ((ar >= torch.tensor(lo)[:, None])
             & (ar < hi[:, None])).to(torch.int32)
    k = torch.randn((B, n_new, 2, 8), generator=torch.Generator().manual_seed(1))
    v = torch.randn((B, n_new, 2, 8), generator=torch.Generator().manual_seed(2))
    new_pool = _int8_pool(0, NP)
    old_pool = tuple(t.clone() for t in new_pool)
    paged = llama.plan_paged_step(bt, off, valid, n_new, PAGE, kernel=False,
                                  quantized=True)
    assert paged.rmw_pages.shape == (B * ((n_new + PAGE - 2) // PAGE + 1),)
    live = paged.rmw_hot.any(dim=1)
    assert live.any() and not live.all()
    llama._scatter_paged(new_pool, k, v, paged)
    _old_requant(old_pool, k, v, bt, off, valid, n_new, PAGE)
    for a, b in zip(new_pool, old_pool):
        assert torch.equal(a, b)
    written = set(paged.rmw_pages[live].tolist())
    for a, b in zip(new_pool, _int8_pool(0, NP)):
        assert torch.equal(a[0], b[0])  # the NULL page, bit for bit
        moved = (a != b).reshape(NP, -1).any(dim=1).nonzero().flatten()
        assert set(moved.tolist()) <= written


# -- the async engine against the JAX engine -------------------------------


def _prompts(vocab, n=6, seed=7):
    """A prompt, ``n`` random ones, the first again (a full prefix hit) and
    one sharing its first page."""
    rs = np.random.RandomState(seed)
    return ([[3, 1, 4, 1, 5]]
            + [rs.randint(1, vocab, size=rs.randint(2, C + 1)).tolist()
               for _ in range(n)] + [[3, 1, 4, 1, 5], [3, 1, 4, 1, 6]])


def _staggered(engine, make_request, prompts, on_step=None):
    """Three requests up front, then one per step; each of the last two
    once the engine drained (a chunked prefill registers its prefix chain
    when its last chunk lands)."""
    outs = {}
    steps = [0]

    def step():
        if on_step is not None:
            on_step(engine, steps[0])
        outs.update((o.request_id, o) for o in engine.step())
        steps[0] += 1

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


def _greedy(cls):
    return lambda i, p: cls(request_id=i, prompt_ids=p,
                            max_new_tokens=3 + i % 4)


_JAX_RUNS: dict = {}


def _jax_tokens(kv_quant, chunk, prefix_cache):
    key = (kv_quant, chunk, prefix_cache)
    if key not in _JAX_RUNS:
        jpim, _, _, _, cfg = build_pair()
        engine = JaxServingEngine(jpim, page_size=PAGE, num_pages=NUM_PAGES,
                                  async_decode=False, kv_quant=kv_quant,
                                  prefill_chunk_tokens=chunk,
                                  prefix_cache=prefix_cache)
        outs = _staggered(engine, _greedy(JaxRequest),
                          _prompts(cfg.vocab_size))
        _JAX_RUNS[key] = {i: list(o.token_ids) for i, o in outs.items()}
    return _JAX_RUNS[key]


def _port_engine(**kw):
    _, tpim, _, _, _ = build_pair()
    return ServingEngine(tpim, page_size=PAGE, num_pages=NUM_PAGES,
                         device="cpu", **kw)


def _check_drained(engine, outs):
    engine._kv.assert_invariants()
    engine.scheduler.assert_invariants()
    assert engine._kv.leaked_pages() == 0
    assert engine._pending is None


@pytest.mark.parametrize("kv_quant,chunk,prefix_cache", [
    (None, None, True), ("int8", None, True), (None, 4, True),
    ("int8", 4, True), (None, None, False), ("int8", 8, False)])
@pytest.mark.parametrize("async_decode", [True, False])
def test_greedy_tokens_identical_to_jax_engine(kv_quant, chunk, prefix_cache,
                                               async_decode):
    _, _, _, _, cfg = build_pair()
    engine = _port_engine(kv_quant=kv_quant, prefill_chunk_tokens=chunk,
                          prefix_cache=prefix_cache,
                          async_decode=async_decode)
    streamed = {}

    def make(i, p):
        r = _greedy(Request)(i, p)
        r.stream_cb = lambda req, t: streamed.setdefault(
            req.request_id, []).append(t)
        return r

    outs = _staggered(engine, make, _prompts(cfg.vocab_size))
    got = {i: list(o.token_ids) for i, o in outs.items()}
    assert got == _jax_tokens(kv_quant, chunk, prefix_cache)
    assert streamed == got  # every token streamed once, in order
    assert all(o.state == "finished" for o in outs.values())
    assert 0 < engine.decode_steps <= sum(o.decode_steps
                                          for o in outs.values())
    _check_drained(engine, outs)


def test_sampled_async_equals_sync():
    _, _, _, _, cfg = build_pair()

    def make(i, p):
        return Request(request_id=i, prompt_ids=p, max_new_tokens=3 + i % 4,
                       sampling=SamplingParams(temperature=0.8 + 0.1 * (i % 3),
                                               top_p=0.9 if i % 2 else 1.0))

    runs = {}
    for a in (True, False):
        engine = _port_engine(seed=11, async_decode=a)
        outs = _staggered(engine, make, _prompts(cfg.vocab_size, seed=3))
        runs[a] = {i: list(o.token_ids) for i, o in outs.items()}
    assert runs[True] == runs[False]


def test_cancel_while_step_in_flight():
    """Cancel a decoding request while its next step is in flight: the
    in-flight token is discarded (its slot is re-granted in the same step,
    a fresh occupancy generation), every other request's tokens are the
    synchronous run's, and no page leaks."""
    _, _, _, _, cfg = build_pair()
    prompts = _prompts(cfg.vocab_size)
    victim = {}

    def cancel_at(engine, step):
        if step == 2:
            active = [req for _, req in engine.scheduler.active()
                      if req.state.value == "decode"]
            assert engine._pending is not None
            victim["req"] = active[0]
            victim["gen"] = engine._slot_gen.copy()
            engine.cancel(active[0].request_id)

    def make(i, p):
        return Request(request_id=i, prompt_ids=p, max_new_tokens=6)

    engine = _port_engine()
    outs = _staggered(engine, make, prompts, on_step=cancel_at)
    sync = _staggered(_port_engine(async_decode=False), make, prompts)
    rid = victim["req"].request_id
    assert outs[rid].state == "cancelled"
    want = list(sync[rid].token_ids)
    got = list(outs[rid].token_ids)
    assert got == want[:len(got)] and len(got) < len(want)
    for i, o in outs.items():
        if i != rid:
            assert list(o.token_ids) == list(sync[i].token_ids)
    # the freed slot was re-granted: its generation moved on
    assert (engine._slot_gen > victim["gen"]).any()
    _check_drained(engine, outs)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_one_put_and_one_fetch_per_steady_step(kv_quant):
    _, tpim, _, _, cfg = build_pair()
    engine = ServingEngine(tpim, page_size=PAGE, num_pages=NUM_PAGES,
                           kv_quant=kv_quant, device="cpu")
    for i in range(3):
        engine.submit(Request(request_id=i, prompt_ids=[5 + i, 9, 2],
                              max_new_tokens=T - C))
    engine.step()  # admissions and the first dispatch
    engine.step()  # the first collect: every slot decoding from here
    puts, fetches = engine.puts, engine.fetches
    for _ in range(4):
        engine.step()
    assert engine.puts - puts == 4 and engine.fetches - fetches == 4
    assert engine._tables_dev is not None and not engine._kv.tables_dirty


def test_cuda_graphs_option():
    _, tpim, _, _, cfg = build_pair()
    assert tpim.cuda_graphs is False  # "auto" on the CPU
    with pytest.raises(ValueError, match="cuda_graphs=True needs a CUDA"):
        ParallelInferenceModel(tpim.module, tpim.config, device="cpu",
                               cuda_graphs=True)
    with pytest.raises(ValueError, match="cuda_graphs must be"):
        ParallelInferenceModel(tpim.module, tpim.config, device="cpu",
                               cuda_graphs="yes")
    off = ParallelInferenceModel(tpim.module, tpim.config, device="cpu",
                                 cuda_graphs=False)
    assert off.cuda_graphs is False
