"""PyTorch port: the fleet's device paths, on the card.

Every test needs an NVIDIA GPU (``cuda`` marker) and skips without one.
The file imports nothing of JAX:

    python -m pytest --noconftest tests/test_torch_cuda_fleet.py -m cuda

- A KV page-chain export and import round trip is bit-exact over bf16 and
  int8 pools on the card, and the import writes the destination pool in
  place.
- An import into a serving engine whose decode graph is captured leaves
  every graph key unchanged and the next step replays it (no capture),
  with the imported chain served by a full hit.
- A weight swap on a warmed graph engine that owns its model captures
  nothing, and its tokens equal a fresh engine's on the new weights.
- A 3-replica fleet over one shared graph model, with one replica killed
  and restarted, holds exactly three decode graphs (the closed engine's
  graph was dropped; the restarted one took its predecessor's phase as
  warm-up) and evicts none.
"""

import numpy as np
import pytest
import torch

from neuronx_distributed_tpu_torch import (
    InferenceConfig,
    LlamaConfig,
    LlamaForCausalLM,
    ParallelInferenceModel,
    Request,
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
from neuronx_distributed_tpu_torch.resilience import clear_plan, install_plan
from neuronx_distributed_tpu_torch.serving.fleet import FleetRouter, Replica
from neuronx_distributed_tpu_torch.weights import WeightSwapper

pytestmark = pytest.mark.cuda

SLOTS, CTX, TOTAL, PAGE = 4, 32, 96, 16


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fleet's graphs and pools are "
                    "CUDA state")
    return torch.device("cuda")


def _module(dev, seed=0):
    cfg = LlamaConfig.tiny(hidden_size=256, num_heads=8, num_kv_heads=2,
                           head_dim=128, dtype=torch.bfloat16)
    return cfg, LlamaForCausalLM(cfg, device=dev).init_random(seed)


def _pim(module):
    return ParallelInferenceModel(
        module, InferenceConfig(SLOTS, CTX, TOTAL, torch.bfloat16),
        cuda_graphs=True)


def _prompts(vocab, n, seed):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, vocab, size=int(rs.randint(17, CTX))).tolist()
            for _ in range(n)]


def _ptrs(caches):
    return [leaf.data_ptr() for layer in caches for leaf in layer]


@pytest.mark.parametrize("quant", [None, "int8"])
def test_transfer_round_trip_bit_exact_on_card(dev, quant):
    layers, pages, nkv, d = 4, 12, 8, 128
    src = init_page_pool_caches(layers, pages, PAGE, nkv, d, torch.bfloat16,
                                device=dev, quant=quant)
    g = torch.Generator(device=dev).manual_seed(0)
    for layer in src:
        for leaf in layer:
            if leaf.dtype == torch.int8:
                leaf.copy_(torch.randint(-128, 128, leaf.shape, generator=g,
                                         device=dev, dtype=torch.int8))
            else:
                leaf.copy_(torch.randn(leaf.shape, generator=g, device=dev))
    alloc = BlockAllocator(pages)
    ids = np.arange(1, 3 * PAGE + 1, dtype=np.int64)
    keys = page_keys(ids, np.ones(len(ids), np.int32), PAGE)
    chain = list(alloc.alloc(len(keys)))
    payload = torch.randn(1, 512, device=dev, dtype=torch.bfloat16)
    export = export_chain(src, keys, chain, PAGE, payload=payload)
    assert export.leaves[0][0].device.type == "cpu"
    dst = init_page_pool_caches(layers, pages, PAGE, nkv, d, torch.bfloat16,
                                device=dev, quant=quant)
    before = _ptrs(dst)
    index = PrefixIndex(BlockAllocator(pages))
    import_chain(dst, index, export)
    torch.cuda.synchronize()
    assert _ptrs(dst) == before
    matched, got = index.peek(keys)
    for ls, ld in zip(src, dst):
        for a, b in zip(ls, ld):
            assert torch.equal(b[matched].view(torch.uint8),
                               a[chain].view(torch.uint8))
    assert got.device.type == "cuda"
    assert torch.equal(got.view(torch.int16), payload.view(torch.int16))


def test_import_keeps_graph_keys_and_replays(dev):
    cfg, module = _module(dev)
    pim = _pim(module)
    donor = ServingEngine(pim, page_size=PAGE)
    prompt = _prompts(cfg.vocab_size, 1, 3)[0]
    donor.submit(Request(request_id=0, prompt_ids=prompt, max_new_tokens=4))
    want = donor.run_until_complete(max_steps=100)[0].token_ids
    fp = max(donor._kv.prefix_fingerprints(),
             key=lambda f: donor.export_prefix(f).n_pages)
    export = donor.export_prefix(fp)
    eng = ServingEngine(pim, page_size=PAGE)
    eng.submit(Request(request_id=1, prompt_ids=_prompts(cfg.vocab_size, 1,
                                                         4)[0],
                       max_new_tokens=4))
    eng.run_until_complete(max_steps=100)  # warm: the decode graph exists
    keys = list(pim.graphs._graphs)
    captures, replays = pim.graphs.captures, pim.graphs.replays
    assert eng.import_prefix(export) == export.n_pages
    assert list(pim.graphs._graphs) == keys
    eng.submit(Request(request_id=2, prompt_ids=prompt, max_new_tokens=4))
    got = eng.run_until_complete(max_steps=100)[0].token_ids
    assert pim.graphs.captures == captures
    assert pim.graphs.replays > replays
    assert eng.registry.snapshot()["kvcache/prefill_skipped_total"] == 1.0
    assert list(got) == list(want)


def test_swap_on_unshared_graph_engine_captures_nothing(dev):
    cfg, module = _module(dev)
    _, other = _module(dev, seed=1)
    pim = _pim(module)
    led = CompileLedger()
    eng = ServingEngine(pim, page_size=PAGE, compile_ledger=led)
    prompts = _prompts(cfg.vocab_size, 2, 5)
    for i, p in enumerate(prompts):
        eng.submit(Request(request_id=i, prompt_ids=p, max_new_tokens=4))
    eng.run_until_complete(max_steps=100)
    eng.declare_warmup_done()
    captures = pim.graphs.captures
    WeightSwapper(eng).swap(dict(other.named_parameters()))
    assert eng.model is pim
    for i, p in enumerate(prompts):
        eng.submit(Request(request_id=10 + i, prompt_ids=p,
                           max_new_tokens=4))
    got = {o.request_id - 10: list(o.token_ids)
           for o in eng.run_until_complete(max_steps=100)}
    assert pim.graphs.captures == captures and led.storms == 0
    fresh = ServingEngine(_pim(other), page_size=PAGE)
    for i, p in enumerate(prompts):
        fresh.submit(Request(request_id=i, prompt_ids=p, max_new_tokens=4))
    want = {o.request_id: list(o.token_ids)
            for o in fresh.run_until_complete(max_steps=100)}
    assert got == want


def test_swap_through_one_wrapper_keeps_the_other_wrappers_graphs(dev):
    """Two graph wrappers over one module: the engine on the second keeps
    replaying its graphs over the old weights after a swap through the
    first, token for token."""
    cfg, module = _module(dev)
    _, other = _module(dev, seed=1)
    first, second = _pim(module), _pim(module)
    a = ServingEngine(first, page_size=PAGE)
    b = ServingEngine(second, page_size=PAGE)
    prompts = _prompts(cfg.vocab_size, 2, 9)

    def serve(eng, base):
        for i, p in enumerate(prompts):
            eng.submit(Request(request_id=base + i, prompt_ids=p,
                               max_new_tokens=4))
        return {o.request_id - base: list(o.token_ids)
                for o in eng.run_until_complete(max_steps=100)}

    before = serve(b, 0)
    captures = second.graphs.captures
    WeightSwapper(a).swap(dict(other.named_parameters()))
    assert a.model is not first and b.model is second
    assert serve(b, 10) == before
    assert second.graphs.captures == captures
    assert serve(a, 20) != before


def test_three_replica_fleet_with_a_restart_holds_three_graphs(dev):
    cfg, module = _module(dev)
    pim = _pim(module)
    led = CompileLedger()
    router = FleetRouter(
        [Replica(i, lambda: ServingEngine(pim, page_size=PAGE,
                                          compile_ledger=led),
                 backoff_base_s=0.0) for i in range(3)],
        policy="round_robin")
    prompts = _prompts(cfg.vocab_size, 12, 7)
    for i, p in enumerate(prompts[:6]):
        router.submit(Request(request_id=i, prompt_ids=p, max_new_tokens=4))
    router.run_until_complete(max_steps=200)
    assert len(pim.graphs._graphs) == 3
    led.declare_warmup_done()
    install_plan({"faults": [{"point": "fleet/replica_step",
                              "action": "exception",
                              "match": {"replica": 1}, "count": 1}]})
    try:
        for i, p in enumerate(prompts[6:]):
            router.submit(Request(request_id=6 + i, prompt_ids=p,
                                  max_new_tokens=4))
        outs = router.run_until_complete(max_steps=300)
    finally:
        clear_plan()
    assert len(outs) == 6 and all(o.state == "finished" for o in outs)
    assert router.registry.snapshot()["router/restarts_total"] == 1.0
    assert len(pim.graphs._graphs) == 3
    assert led.cache_evictions == 0 and led.storms == 0
    router.close()
    assert len(pim.graphs._graphs) == 0
