"""PyTorch port: multi-adapter (LoRA) serving against the JAX package.

On the tiny fp32 GQA pair (``torch_port_pair``: B = 3, C = 8, T = 16,
page 4, 16 KV pages, as the JAX ``tenancy_pool``), with the same numpy
factors registered in both stores:

- the adapter layout flattens to the JAX bytes (padding, the folded
  ``alpha/r``) and refuses what JAX refuses; ``factors_from_params``
  walks nested and wrapped trees as JAX does;
- the store's pins, hits, loads, evictions, ``(phys, block)`` load
  sequences and tables equal the JAX store's, op for op, also under a
  randomized churn with zero leaks; a failure mid-acquire (the allocator
  raising) leaks nothing;
- prefix keys are salted per adapter, adapter-0 keys unsalted;
- the engine's greedy tokens equal the JAX engine's: adapter 0 only
  (async and sync), mixed adapters, int8 pages with chunks, speculative
  decoding with a self draft, and Gemma / Gemma-2; ``prefill_one_lora``
  logits equal JAX's and the ``peft.merge_lora`` dense model's within
  2e-4; int8 × adapter decode logits drift within JAX's bound;
- every terminal state releases the pin (an in-flight step on a swept
  slot included); an exhausted adapter pool fails only its request, a
  KV-allocation failure releases the pin; unknown adapters are
  permanent admission errors; prompt pages never cross adapters; a
  steady step makes one put with adapters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from neuronx_distributed_tpu.kvcache.prefix import page_keys as jax_page_keys
from neuronx_distributed_tpu.models.gemma import (
    Gemma2Config as JaxGemma2Config,
    Gemma2ForCausalLM as JaxGemma2,
    GemmaConfig as JaxGemmaConfig,
    GemmaForCausalLM as JaxGemma,
)
from neuronx_distributed_tpu.obs import MetricRegistry
from neuronx_distributed_tpu.serving import (
    Request as JaxRequest,
    ServingEngine as JaxServingEngine,
)
from neuronx_distributed_tpu.tenancy import (
    AdapterLayout as JaxAdapterLayout,
    AdapterStore as JaxAdapterStore,
    factors_from_params as jax_factors_from_params,
    make_adapter_store as jax_make_adapter_store,
)
from neuronx_distributed_tpu.trace import (
    InferenceConfig as JaxInferenceConfig,
    ParallelInferenceModel as JaxInferenceModel,
)
from neuronx_distributed_tpu_torch.convert import (
    gemma2_params_from_jax,
    gemma_params_from_jax,
)
from neuronx_distributed_tpu_torch.kvcache.allocator import PoolExhausted
from neuronx_distributed_tpu_torch.kvcache.prefix import page_keys
from neuronx_distributed_tpu_torch.models.gemma import (
    Gemma2Config,
    Gemma2ForCausalLM,
    GemmaConfig,
    GemmaForCausalLM,
)
from neuronx_distributed_tpu_torch.models.llama import LlamaForCausalLM
from neuronx_distributed_tpu_torch.peft import merge_lora
from neuronx_distributed_tpu_torch.serving import (
    AdmissionError,
    Request,
    SamplingParams,
    ServingEngine,
)
from neuronx_distributed_tpu_torch.tenancy import (
    AdapterLayout,
    AdapterStore,
    factors_from_params,
    make_adapter_store,
)
from neuronx_distributed_tpu_torch.trace import (
    InferenceConfig,
    ParallelInferenceModel,
)
from torch_port_pair import C, build_pair

PAGE, NUM_PAGES = 4, 16
RANK, ALPHA, SCALE = 2, 4.0, 0.2
ATOL = 2e-4


# -- layout ----------------------------------------------------------------


def _layout_kw(**kw):
    return {**dict(num_layers=2, hidden_size=8, q_out=8, v_out=4, rank=4,
                   page_elems=64), **kw}


def _random_factors(kw, rank=None, seed=0):
    rs = np.random.RandomState(seed)
    r = rank or kw["rank"]
    return [{"a_q": rs.randn(kw["hidden_size"], r).astype(np.float32),
             "b_q": rs.randn(r, kw["q_out"]).astype(np.float32),
             "a_v": rs.randn(kw["hidden_size"], r).astype(np.float32),
             "b_v": rs.randn(r, kw["v_out"]).astype(np.float32)}
            for _ in range(kw["num_layers"])]


@pytest.mark.parametrize("rank", [4, 2])
def test_layout_flatten_matches_jax(rank):
    kw = _layout_kw()
    port, ref = AdapterLayout(**kw), JaxAdapterLayout(**kw)
    assert port.layer_entries() == ref.layer_entries()
    assert port.pages_per_adapter == ref.pages_per_adapter
    factors = _random_factors(kw, rank=rank, seed=rank)
    got = port.flatten(factors, alpha=8.0)
    np.testing.assert_array_equal(got, ref.flatten(factors, alpha=8.0))
    # padded columns of A and rows of B are exact zeros
    _, off, shape = port.layer_entries()[0][0]
    a = got.reshape(-1)[off:off + shape[0] * shape[1]].reshape(shape)
    assert (a[:, rank:] == 0).all()


@pytest.mark.parametrize("case,match", [
    ("rank", "exceeds pool rank"), ("missing", "missing factors"),
    ("layers", "layers"), ("pool", "pool holds only")])
def test_layout_refuses_what_jax_refuses(case, match):
    kw = _layout_kw()
    factors = _random_factors(kw)
    calls = {
        "rank": lambda L, S: L(**kw).flatten(_random_factors(kw, rank=8), 1.0),
        "missing": lambda L, S: L(**kw).flatten(
            [{k: v for k, v in f.items() if k != "b_v"} for f in factors],
            1.0),
        "layers": lambda L, S: L(**kw).flatten(factors[:1], 1.0),
        "pool": lambda L, S: S(L(**_layout_kw(page_elems=2)), 3),
    }
    for layout_cls, store_cls in ((AdapterLayout, AdapterStore),
                                  (JaxAdapterLayout, JaxAdapterStore)):
        with pytest.raises(ValueError, match=match):
            calls[case](layout_cls, store_cls)


@pytest.mark.parametrize("wrapped", [False, True])
def test_factors_from_params_matches_jax(wrapped):
    rs = np.random.RandomState(0)
    a = rs.randn(8, 2).astype(np.float32)
    b = rs.randn(2, 4, 2).astype(np.float32)  # module layout [r, heads, dim]
    leaf = (lambda x: {"value": x}) if wrapped else (lambda x: x)

    def layer(i):
        return {"attn": {"qkv": {
            "q_kernel": np.zeros((8, 4, 2), np.float32),
            "lora_a_q": leaf(a + i), "lora_b_q": leaf(b),
            "lora_a_v": leaf(a - i), "lora_b_v": leaf(b[:, :2])}}}

    tree = {"params": {"model": {"layer_0": layer(0), "layer_1": layer(1)}}}
    got, want = factors_from_params(tree), jax_factors_from_params(tree)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
    kw = _layout_kw(num_layers=2, hidden_size=8, q_out=8, v_out=4, rank=2)
    np.testing.assert_array_equal(
        AdapterLayout(**kw).flatten(got, 2.0),
        JaxAdapterLayout(**kw).flatten(want, 2.0))
    with pytest.raises(ValueError, match="no lora_"):
        factors_from_params({"layer_0": {"kernel": a}})


# -- the store, op for op against JAX --------------------------------------


def _store_pair(num_pages):
    kw = _layout_kw()
    reg = MetricRegistry()
    port = AdapterStore(AdapterLayout(**kw), num_pages)
    ref = JaxAdapterStore(JaxAdapterLayout(**kw), num_pages, registry=reg)
    for aid in range(1, 6):
        f = _random_factors(kw, seed=aid)
        port.register(aid, f)
        ref.register(aid, f)
    return port, ref, reg


def _same_loads(got, want):
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _counters_match(port, reg):
    snap = reg.snapshot()
    assert (port.hits, port.loads, port.evictions) == (
        snap.get("tenancy/adapter_hits_total", 0.0),
        snap.get("tenancy/adapter_loads_total", 0.0),
        snap.get("tenancy/adapter_evictions_total", 0.0))


def test_store_pin_release_hit_load_evict_match_jax():
    pp = AdapterLayout(**_layout_kw()).pages_per_adapter
    port, ref, reg = _store_pair(2 * pp + 1)
    ops = [("acquire", 1), ("acquire", 1), ("acquire", 0), ("release", 1),
           ("release", 1), ("acquire", 2), ("acquire", 3), ("acquire", 1),
           ("release", 2), ("acquire", 1), ("release", 3), ("release", 1)]
    for op, aid in ops:
        outcome = []
        for store in (port, ref):
            try:
                outcome.append(getattr(store, op)(aid))
            except PoolExhausted as e:  # the JAX store raises its own class
                outcome.append(type(e).__name__)
            except Exception as e:  # noqa: BLE001 - compared across stores
                outcome.append(type(e).__name__)
        if isinstance(outcome[0], list):
            _same_loads(*outcome)
        else:
            assert outcome[0] == outcome[1], (op, aid, outcome)
        assert port.resident_ids() == ref.resident_ids()
        for a in port.resident_ids() | {0}:
            np.testing.assert_array_equal(port.table(a), ref.table(a))
            assert port.pins(a) == ref.pins(a)
        port.assert_invariants()
    _counters_match(port, reg)
    assert port.evictions >= 2 and port.hits >= 1
    assert port.pages_in_use == ref.alloc.in_use


def test_store_randomized_churn_matches_jax_and_leaks_nothing():
    pp = AdapterLayout(**_layout_kw()).pages_per_adapter
    port, ref, reg = _store_pair(3 * pp + 1)
    rs = np.random.RandomState(0)
    pins = []
    for _ in range(300):
        if rs.rand() < 0.5:
            aid = int(rs.randint(1, 6))
            got = want = None
            try:
                got = port.acquire(aid)
            except PoolExhausted:
                pass
            try:
                want = ref.acquire(aid)
            except Exception as e:  # noqa: BLE001 - JAX's PoolExhausted
                assert type(e).__name__ == "PoolExhausted"
            assert (got is None) == (want is None)
            if got is not None:
                _same_loads(got, want)
                pins.append(aid)
        elif pins:
            aid = pins.pop(rs.randint(len(pins)))
            port.release(aid)
            ref.release(aid)
        port.assert_invariants()
        assert port.resident_ids() == ref.resident_ids()
    _counters_match(port, reg)
    for aid in pins:
        port.release(aid)
    port._ensure_free(port.capacity)  # evict everything evictable
    assert port.alloc.in_use == 0, "adapter pages leaked"
    port.assert_invariants()


@pytest.mark.parametrize("fail_at", [0, 2])
def test_acquire_failure_leaks_nothing(monkeypatch, fail_at):
    """The allocator raises on the ``fail_at``-th pin: every page taken is
    freed, nothing is resident, and the next acquire loads in full."""
    kw = _layout_kw()
    layout = AdapterLayout(**kw)
    store = AdapterStore(layout, 2 * layout.pages_per_adapter + 1)
    store.register(1, _random_factors(kw))
    real_retain = store.alloc.retain
    calls = [0]

    def retain(page):
        calls[0] += 1
        if calls[0] > fail_at:
            raise RuntimeError("injected")
        real_retain(page)

    monkeypatch.setattr(store.alloc, "retain", retain)
    with pytest.raises(RuntimeError, match="injected"):
        store.acquire(1)
    monkeypatch.setattr(store.alloc, "retain", real_retain)
    store.assert_invariants()
    assert store.alloc.in_use == 0 and not store.resident_ids()
    assert len(store.acquire(1)) == layout.pages_per_adapter
    store.release(1)
    store.assert_invariants()


def test_store_registration_refusals():
    kw = _layout_kw()
    store = AdapterStore(AdapterLayout(**kw), 8)
    with pytest.raises(ValueError, match="reserved"):
        store.register(0, _random_factors(kw))
    store.register(1, _random_factors(kw))
    with pytest.raises(ValueError, match="already registered"):
        store.register(1, _random_factors(kw))
    with pytest.raises(KeyError, match="not registered"):
        store.acquire(7)
    with pytest.raises(ValueError, match="non-resident"):
        store.release(1)


@pytest.mark.parametrize("aid", [0, 3])
def test_prefix_keys_salted_per_adapter(aid):
    _, tpim, _, _, _ = build_pair()
    eng = ServingEngine(tpim, page_size=PAGE, num_pages=NUM_PAGES,
                        device="cpu")
    ids = np.array([0, 0, 5, 6, 7, 8, 9, 10])
    valid = (ids > 0).astype(np.int32)
    req = Request(request_id=0, prompt_ids=[5, 6, 7, 8, 9, 10],
                  max_new_tokens=2, adapter_id=aid)
    eng._kv.admit_slot(0, req, ids, valid)
    want = jax_page_keys(ids, valid, PAGE, salt=aid)
    assert eng._kv._slot_keys[0] == want == page_keys(ids, valid, PAGE,
                                                      salt=aid)
    if aid == 0:
        assert want == jax_page_keys(ids, valid, PAGE)
    eng._kv.release_slot(0)


# -- the engine against the JAX engine -------------------------------------


def _factors(cfg, aid, layers=None):
    """Adapter ``aid``'s factors, the JAX tests' ``_model_store`` stream."""
    H, NQ, NKV, D = (cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
                     cfg.head_dim_)
    rs = np.random.RandomState(100 + aid)
    return [{
        "a_q": (rs.randn(H, RANK) * SCALE).astype(np.float32),
        "b_q": (rs.randn(RANK, NQ * D) * SCALE).astype(np.float32),
        "a_v": (rs.randn(H, RANK) * SCALE).astype(np.float32),
        "b_v": (rs.randn(RANK, NKV * D) * SCALE).astype(np.float32),
    } for _ in range(layers or cfg.num_layers)]


def _stores(jpim, tpim, n_adapters=2, extra_pages=0):
    """A JAX and a port store over the same registered factors."""
    pp = AdapterLayout.for_model(tpim, RANK).pages_per_adapter
    num_pages = n_adapters * pp + 1 + extra_pages
    out = []
    for make, pim in ((jax_make_adapter_store, jpim),
                      (make_adapter_store, tpim)):
        store = make(pim, rank=RANK, num_pages=num_pages)
        for aid in range(1, n_adapters + 1):
            store.register(aid, _factors(tpim.module.config, aid),
                           alpha=ALPHA)
        out.append(store)
    return out


def _prompts(vocab, n=6, seed=1):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, vocab, size=rs.randint(2, C + 1)).tolist()
            for _ in range(n)]


def _staggered(engine, make_request, prompts, on_step=None):
    """Three requests up front, then one more per step."""
    outs = {}
    for i in range(3):
        engine.submit(make_request(i, prompts[i]))
    steps = 0
    for i in range(3, len(prompts)):
        if on_step is not None:
            on_step(engine, steps)
        outs.update((o.request_id, o) for o in engine.step())
        steps += 1
        engine.submit(make_request(i, prompts[i]))
    while engine.has_work:
        if on_step is not None:
            on_step(engine, steps)
        outs.update((o.request_id, o) for o in engine.step())
        steps += 1
    return outs


def _maker(cls, adapters, max_new=4):
    return lambda i, p: cls(request_id=i, prompt_ids=p,
                            max_new_tokens=max_new + i % 3,
                            adapter_id=adapters[i % len(adapters)])


def _tokens(outs):
    return {i: list(o.token_ids) for i, o in outs.items()}


def _drained(engine, store):
    engine._kv.assert_invariants()
    engine.scheduler.assert_invariants()
    assert engine._kv.leaked_pages() == 0
    store.assert_invariants()
    assert all(store.pins(a) == 0 for a in store.resident_ids())
    assert engine._pending is None
    assert not any(engine._slot_adapter)


_JAX_RUNS: dict = {}


def _jax_run(key, adapters, T=16, num_pages=NUM_PAGES, prompts_seed=1,
             **engine_kw):
    """JAX engine tokens (synchronous), cached per configuration."""
    if key not in _JAX_RUNS:
        jpim, tpim, _, _, cfg = build_pair(3, T, 0)
        jstore, _ = _stores(jpim, tpim)
        engine = JaxServingEngine(jpim, page_size=PAGE, num_pages=num_pages,
                                  async_decode=False, adapter_store=jstore,
                                  **engine_kw)
        outs = _staggered(engine, _maker(JaxRequest, adapters),
                          _prompts(cfg.vocab_size, seed=prompts_seed))
        _JAX_RUNS[key] = (_tokens(outs), jstore)
    return _JAX_RUNS[key]


MIXED = [0, 1, 2, 1, 0, 2]


@pytest.mark.parametrize("async_decode", [True, False])
def test_zero_adapter_engine_token_identical(async_decode):
    jpim, tpim, _, _, cfg = build_pair()
    want, _ = _jax_run("zero", [0])
    _, store = _stores(jpim, tpim)
    eng = ServingEngine(tpim, page_size=PAGE, num_pages=NUM_PAGES,
                        adapter_store=store, async_decode=async_decode,
                        device="cpu")
    got = _staggered(eng, _maker(Request, [0]), _prompts(cfg.vocab_size))
    assert _tokens(got) == want
    assert store.resident_ids() == frozenset()  # nobody paid adapter pages
    _drained(eng, store)

    # sampled rows: the store changes nothing either
    def sampled(i, p):
        return Request(request_id=i, prompt_ids=p, max_new_tokens=4 + i % 3,
                       sampling=SamplingParams(temperature=0.8 + 0.2 * i))

    runs = []
    for st in (None, _stores(jpim, tpim)[1]):
        e = ServingEngine(tpim, page_size=PAGE, num_pages=NUM_PAGES, seed=5,
                          adapter_store=st, async_decode=async_decode,
                          device="cpu")
        runs.append(_tokens(_staggered(e, sampled,
                                       _prompts(cfg.vocab_size))))
    assert runs[0] == runs[1]


@pytest.mark.parametrize("paged_kernel", [True, False])
@pytest.mark.parametrize("async_decode", [True, False])
def test_mixed_adapters_token_identical_to_jax(async_decode, paged_kernel):
    jpim, tpim, _, _, cfg = build_pair()
    want, _ = _jax_run("mixed", MIXED)
    base, _ = _jax_run("zero", [0])
    _, store = _stores(jpim, tpim)
    eng = ServingEngine(tpim, page_size=PAGE, num_pages=NUM_PAGES,
                        adapter_store=store, async_decode=async_decode,
                        paged_kernel=paged_kernel, device="cpu")
    got = _tokens(_staggered(eng, _maker(Request, MIXED),
                             _prompts(cfg.vocab_size)))
    assert got == want
    for i, aid in enumerate(MIXED):
        if aid == 0:
            assert got[i] == base[i]  # no adapter row leaks into another
    assert any(got[i] != base[i] for i, aid in enumerate(MIXED) if aid)
    assert store.loads == 2 and store.hits >= 1
    _drained(eng, store)


def _nest(flat):
    tree: dict = {}
    for name, t in flat.items():
        *parents, leaf = name.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return tree


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _merged_dense(tpim, aid):
    """The port model with adapter ``aid`` folded into its q/v kernels by
    ``peft.merge_lora``."""
    cfg = tpim.module.config
    tree = _nest({k: v.clone() for k, v in tpim.module.state_dict().items()})
    for i, lay in enumerate(_factors(cfg, aid)):
        qkv = tree["model"][f"layer_{i}"]["attn"]["qkv"]
        qkv["lora_a_q"] = torch.from_numpy(lay["a_q"])
        qkv["lora_b_q"] = torch.from_numpy(lay["b_q"])
        qkv["lora_a_v"] = torch.from_numpy(lay["a_v"])
        qkv["lora_b_v"] = torch.from_numpy(lay["b_v"])
    dense = LlamaForCausalLM(cfg, device="cpu")
    dense.load_state_dict(_flatten(merge_lora(tree, alpha=ALPHA)))
    return ParallelInferenceModel(dense, InferenceConfig(1, C, 16,
                                                         torch.float32),
                                  device="cpu")


def test_prefill_one_lora_matches_jax_and_merged_dense():
    jpim, tpim, _, _, cfg = build_pair()
    jstore, store = _stores(jpim, tpim, n_adapters=1)
    apool = tpim.make_adapter_pool(store.layout, store.num_pages)
    japool = jpim.make_adapter_pool(jstore.layout, jstore.num_pages)
    for (phys, block), (jphys, jblock) in zip(store.acquire(1),
                                              jstore.acquire(1)):
        assert phys == jphys
        tpim.write_adapter_page(apool, block, phys)
        japool = jpim.write_adapter_page(japool, jblock, jphys)
    np.testing.assert_array_equal(apool.numpy(), np.asarray(japool))
    ids = np.zeros((1, C), np.int64)
    ids[0, 2:] = [5, 6, 7, 8, 9, 10]
    valid = (np.arange(C) >= 2).astype(np.int32)[None, :]
    got, _ = tpim.prefill_one_lora(ids, valid, apool, store.table(1)[None, :])
    want, _ = jpim.prefill_one_lora(jnp.asarray(ids, jnp.int32),
                                    jnp.asarray(valid), japool,
                                    jstore.table(1)[None, :])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ATOL,
                               atol=ATOL)
    dense, _ = _merged_dense(tpim, 1).prefill_one(ids, valid)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=ATOL,
                               atol=ATOL)
    base, _ = tpim.prefill_one(ids, valid)
    assert (got - base).abs().max() > 100 * ATOL  # the delta is really there


def test_terminal_states_release_pins():
    jpim, tpim, _, _, cfg = build_pair()
    _, store = _stores(jpim, tpim)
    t = [0.0]
    eng = ServingEngine(tpim, page_size=PAGE, num_pages=NUM_PAGES,
                        adapter_store=store, clock=lambda: t[0],
                        device="cpu")
    prompts = _prompts(cfg.vocab_size, 3, seed=2)
    eng.submit(Request(request_id=0, prompt_ids=prompts[0], max_new_tokens=6,
                       adapter_id=1))
    eng.submit(Request(request_id=1, prompt_ids=prompts[1], max_new_tokens=6,
                       adapter_id=2))
    eng.submit(Request(request_id=2, prompt_ids=prompts[2], max_new_tokens=6,
                       adapter_id=1, deadline_s=0.5))
    outs = {o.request_id: o for o in eng.step()}
    assert store.pins(1) == 2 and store.pins(2) == 1
    eng.cancel(1)
    t[0] = 1.0  # request 2's deadline passes
    outs.update((o.request_id, o)
                for o in eng.run_until_complete(max_steps=100))
    assert outs[0].state == "finished" and outs[0].adapter_id == 1
    assert outs[1].state == "cancelled" and outs[2].state == "timed_out"
    _drained(eng, store)
    # warm reuse: the next adapter-1 request is a hit, not a load
    loads, hits = store.loads, store.hits
    eng.submit(Request(request_id=9, prompt_ids=prompts[0], max_new_tokens=2,
                       adapter_id=1))
    eng.run_until_complete(max_steps=50)
    assert store.loads == loads and store.hits == hits + 1
    _drained(eng, store)


def test_swept_in_flight_step_releases_the_pin_once():
    """Cancel an adapter request while its async step is in flight: the
    pin drops once, the slot's next occupant pins its own adapter, and the
    other requests' tokens are the synchronous run's."""
    jpim, tpim, _, _, cfg = build_pair()
    prompts = _prompts(cfg.vocab_size)
    victim = {}

    def cancel_at(engine, step):
        if step == 2:
            assert engine._pending is not None
            slot, req = next((s, r) for s, r in engine.scheduler.active()
                             if r.state.value == "decode" and r.adapter_id)
            victim.update(rid=req.request_id, aid=req.adapter_id,
                          pins=engine._adapters.pins(req.adapter_id))
            engine.cancel(req.request_id)

    make = _maker(Request, MIXED, max_new=6)
    _, store = _stores(jpim, tpim)
    eng = ServingEngine(tpim, page_size=PAGE, num_pages=NUM_PAGES,
                        adapter_store=store, device="cpu")
    outs = _tokens(_staggered(eng, make, prompts, on_step=cancel_at))
    _, sstore = _stores(jpim, tpim)
    sync = _tokens(_staggered(ServingEngine(
        tpim, page_size=PAGE, num_pages=NUM_PAGES, adapter_store=sstore,
        async_decode=False, device="cpu"), make, prompts))
    rid = victim["rid"]
    assert victim["pins"] >= 1
    assert outs[rid] == sync[rid][:len(outs[rid])]
    assert len(outs[rid]) < len(sync[rid])
    assert {i: t for i, t in outs.items() if i != rid} == {
        i: t for i, t in sync.items() if i != rid}
    _drained(eng, store)


def test_pool_exhausted_fails_only_that_request():
    """Room for one adapter: while adapter 1 is pinned, an adapter-2
    request fails at admission (as in the JAX engine), the adapter-1
    request finishes, and adapter 2 serves once the pool drains."""
    jpim, tpim, _, _, cfg = build_pair()
    prompts = _prompts(cfg.vocab_size, 3, seed=4)
    results = []
    for cls, engine_cls, idx in ((JaxRequest, JaxServingEngine, 0),
                                 (Request, ServingEngine, 1)):
        pp = AdapterLayout.for_model(tpim, RANK).pages_per_adapter
        store = (jax_make_adapter_store(jpim, rank=RANK, num_pages=pp + 1)
                 if idx == 0 else
                 make_adapter_store(tpim, rank=RANK, num_pages=pp + 1))
        for aid in (1, 2):
            store.register(aid, _factors(cfg, aid), alpha=ALPHA)
        kw = {} if idx == 0 else {"device": "cpu"}
        eng = engine_cls(jpim if idx == 0 else tpim, page_size=PAGE,
                         num_pages=NUM_PAGES, adapter_store=store,
                         async_decode=False, **kw)
        eng.submit(cls(request_id=0, prompt_ids=prompts[0], max_new_tokens=4,
                       adapter_id=1))
        eng.submit(cls(request_id=1, prompt_ids=prompts[1], max_new_tokens=4,
                       adapter_id=2))
        outs = {o.request_id: o for o in eng.run_until_complete(max_steps=50)}
        eng.submit(cls(request_id=2, prompt_ids=prompts[2], max_new_tokens=4,
                       adapter_id=2))
        outs.update((o.request_id, o)
                    for o in eng.run_until_complete(max_steps=50))
        results.append({i: (o.state, o.finish_reason, list(o.token_ids))
                        for i, o in outs.items()})
        store.assert_invariants()
    assert results[1] == results[0]
    assert results[1][1][:2] == ("failed", "adapter:PoolExhausted")
    assert results[1][0][0] == results[1][2][0] == "finished"


def test_kv_allocation_failure_releases_the_pin(monkeypatch):
    jpim, tpim, _, _, cfg = build_pair()
    _, store = _stores(jpim, tpim)
    eng = ServingEngine(tpim, page_size=PAGE, num_pages=NUM_PAGES,
                        adapter_store=store, device="cpu")
    real = eng._kv.admit_slot

    def fail_once(*a, **k):
        monkeypatch.setattr(eng._kv, "admit_slot", real)
        raise RuntimeError("injected page fault")

    monkeypatch.setattr(eng._kv, "admit_slot", fail_once)
    eng.submit(Request(request_id=0, prompt_ids=[1, 2, 3, 4],
                       max_new_tokens=4, adapter_id=1))
    with pytest.raises(RuntimeError, match="injected"):
        eng.step()
    assert store.pins(1) == 0 and 1 in store.resident_ids()
    store.assert_invariants()
    eng._kv.assert_invariants()
    eng.submit(Request(request_id=1, prompt_ids=[1, 2, 3, 4],
                       max_new_tokens=3, adapter_id=1))
    [out] = eng.run_until_complete(max_steps=50)
    assert out.state == "finished" and store.hits == 1
    _drained(eng, store)


def test_unknown_adapter_and_validation_errors():
    jpim, tpim, _, _, cfg = build_pair()
    _, store = _stores(jpim, tpim)
    eng = ServingEngine(tpim, page_size=PAGE, num_pages=NUM_PAGES,
                        adapter_store=store, device="cpu")
    with pytest.raises(AdmissionError, match="unregistered"):
        eng.submit(Request(request_id=0, prompt_ids=[1, 2], max_new_tokens=2,
                           adapter_id=9))
    storeless = ServingEngine(tpim, page_size=PAGE, num_pages=NUM_PAGES,
                              device="cpu")
    with pytest.raises(AdmissionError, match="no adapter_store"):
        storeless.submit(Request(request_id=0, prompt_ids=[1, 2],
                                 max_new_tokens=2, adapter_id=1))
    with pytest.raises(ValueError, match="adapter_id must be >= 0"):
        Request(request_id=0, prompt_ids=[1], max_new_tokens=1,
                adapter_id=-1)
    wrong = AdapterStore(AdapterLayout(**_layout_kw()), 8)
    with pytest.raises(ValueError, match="does not fit the model"):
        ServingEngine(tpim, page_size=PAGE, adapter_store=wrong,
                      device="cpu")
    # the port's engine is paged only: there is no unpaged engine to refuse
    with pytest.raises(TypeError, match="page_size"):
        ServingEngine(tpim, adapter_store=store, device="cpu")


def test_prefix_pages_never_cross_adapters():
    """An identical page-aligned prompt under another adapter prefills
    afresh; under the same adapter it is a full-prompt hit whose tokens
    equal a cold run's, and the JAX engine's."""
    jpim, tpim, _, _, cfg = build_pair()
    prompt = [3, 4, 5, 6, 7, 8, 9, 10]
    runs = []
    for cls, engine_cls, pim, kw in (
            (JaxRequest, JaxServingEngine, jpim, {}),
            (Request, ServingEngine, tpim, {"device": "cpu"})):
        store = _stores(jpim, tpim)[0 if cls is JaxRequest else 1]
        eng = engine_cls(pim, page_size=PAGE, num_pages=NUM_PAGES,
                         adapter_store=store, async_decode=False, **kw)
        toks = []
        for rid, aid in enumerate((1, 2, 1)):
            eng.submit(cls(request_id=rid, prompt_ids=prompt,
                           max_new_tokens=3, adapter_id=aid))
            [out] = eng.run_until_complete(max_steps=50)
            toks.append(list(out.token_ids))
            if cls is Request:
                assert eng._kv.prefill_skipped == (rid == 2)
        runs.append(toks)
    assert runs[1] == runs[0]
    assert runs[1][0] == runs[1][2] != runs[1][1]


@pytest.mark.parametrize("chunk", [None, 4])
def test_int8_chunked_adapters_token_identical_to_jax(chunk):
    jpim, tpim, _, _, cfg = build_pair()
    want, _ = _jax_run(("int8", chunk), MIXED, kv_quant="int8",
                       prefill_chunk_tokens=chunk)
    _, store = _stores(jpim, tpim)
    eng = ServingEngine(tpim, page_size=PAGE, num_pages=NUM_PAGES,
                        adapter_store=store, kv_quant="int8",
                        prefill_chunk_tokens=chunk, device="cpu")
    got = _tokens(_staggered(eng, _maker(Request, MIXED),
                             _prompts(cfg.vocab_size)))
    assert got == want
    if chunk:
        assert eng.prefill_chunks > 0
    _drained(eng, store)


def test_int8_adapter_decode_drift_within_jax_bound():
    """fp and int8 pools fed the same adapter prefill: decode logits under
    the adapter drift by more than 0 and less than JAX's 0.25."""
    jpim, tpim, _, _, cfg = build_pair()
    _, store = _stores(jpim, tpim, n_adapters=1)
    apool = tpim.make_adapter_pool(store.layout, store.num_pages)
    for phys, block in store.acquire(1):
        tpim.write_adapter_page(apool, block, phys)
    ids = np.arange(1, C + 1)[None, :]
    valid = np.ones((1, C), np.int32)
    logits, row = tpim.prefill_one_lora(ids, valid, apool,
                                        store.table(1)[None, :])
    atables = np.stack([store.table(1), store.table(0), store.table(0)])
    outs = {}
    for quant in (None, "int8"):
        caches = tpim.make_page_pool(16, PAGE, quant=quant).caches
        for lp, phys in ((0, 1), (1, 2)):
            tpim.write_page(caches, row, lp, phys, row_valid=valid[0])
        table = np.zeros((3, 4), np.int32)
        table[0] = [1, 2, 3, 0]
        vfull = torch.zeros((3, 16), dtype=torch.int32)
        vfull[0, :C] = 1
        tok = torch.full((3, 1), int(logits[0].argmax()))
        lg, _, _ = tpim.decode_pages_lora(tok, [C, 16, 16], table, caches,
                                          vfull, apool, atables)
        outs[quant] = lg[0].numpy()
    drift = np.abs(outs["int8"] - outs[None]).max()
    assert 0.0 < drift < 0.25, drift


@pytest.mark.parametrize("family", ["gemma", "gemma2"])
def test_gemma_engine_serves_adapters_like_jax(family):
    jcls, jcfg_cls, pcls, pcfg_cls, conv = {
        "gemma": (JaxGemma, JaxGemmaConfig, GemmaForCausalLM, GemmaConfig,
                  gemma_params_from_jax),
        "gemma2": (JaxGemma2, JaxGemma2Config, Gemma2ForCausalLM,
                   Gemma2Config, gemma2_params_from_jax)}[family]
    T = 16
    module = jcls(jcfg_cls.tiny(dtype=jnp.float32, param_dtype=jnp.float32,
                                sequence_parallel=False, remat="none",
                                max_seq_len=32))
    params = nn.unbox(module.init(jax.random.PRNGKey(0),
                                  jnp.zeros((3, C), jnp.int32)))
    jpim = JaxInferenceModel(module, params, JaxInferenceConfig(
        batch_size=3, context_len=C, max_total_len=T,
        kv_cache_dtype=jnp.float32))
    cfg = pcfg_cls.tiny(dtype=torch.float32, max_seq_len=32)
    model = pcls(cfg, device="cpu")
    model.load_state_dict(conv(jax.tree.map(np.asarray, params), cfg))
    tpim = ParallelInferenceModel(model, InferenceConfig(3, C, T,
                                                         torch.float32),
                                  device="cpu")
    jstore, store = _stores(jpim, tpim)
    prompts = _prompts(cfg.vocab_size, 5, seed=3)
    jeng = JaxServingEngine(jpim, page_size=PAGE, num_pages=NUM_PAGES,
                            adapter_store=jstore, async_decode=False)
    want = _tokens(_staggered(jeng, _maker(JaxRequest, MIXED), prompts))
    eng = ServingEngine(tpim, page_size=PAGE, num_pages=NUM_PAGES,
                        adapter_store=store, device="cpu")
    assert _tokens(_staggered(eng, _maker(Request, MIXED), prompts)) == want
    _drained(eng, store)


def test_one_put_per_steady_step_with_adapters():
    jpim, tpim, _, _, cfg = build_pair()
    _, store = _stores(jpim, tpim)
    eng = ServingEngine(tpim, page_size=PAGE, num_pages=NUM_PAGES,
                        adapter_store=store, device="cpu")
    for i in range(3):
        eng.submit(Request(request_id=i, prompt_ids=[5 + i, 9, 2],
                           max_new_tokens=8, adapter_id=i))
    eng.step()
    eng.step()
    puts, fetches = eng.puts, eng.fetches
    for _ in range(4):
        eng.step()
    assert eng.puts - puts == 4 and eng.fetches - fetches == 4
    assert not eng._adapter_dirty
    np.testing.assert_array_equal(eng._atables_dev.numpy(),
                                  eng._adapter_tables)


@pytest.mark.parametrize("async_decode", [True, False])
def test_spec_self_draft_adapters_token_identical_to_jax(async_decode):
    jpim, tpim, _, _, cfg = build_pair(3, 32, 0)
    want, _ = _jax_run("spec", MIXED, T=32, num_pages=40, draft=jpim,
                       spec_k=3)
    plain, _ = _jax_run("spec-plain", MIXED, T=32, num_pages=40)
    assert want == plain  # the JAX engine: spec equals plain under adapters
    _, store = _stores(jpim, tpim)
    eng = ServingEngine(tpim, page_size=PAGE, num_pages=40, draft=tpim,
                        spec_k=3, adapter_store=store,
                        async_decode=async_decode, device="cpu")
    assert eng._draft_lora
    got = _tokens(_staggered(eng, _maker(Request, MIXED),
                             _prompts(cfg.vocab_size)))
    assert got == want
    assert eng.spec_accepted == eng.spec_proposed  # a self draft, fp32
    _drained(eng, store)
