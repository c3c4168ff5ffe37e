"""PyTorch port: the serving phase functions under CUDA graphs, on the card.

Every test needs an NVIDIA GPU (``cuda`` marker) and skips without one.
The file imports nothing of JAX:

    python -m pytest --noconftest tests/test_torch_cuda_graphs.py -m cuda

- A captured ``decode_pages`` (S = 1, the decode kernel) and
  ``verify_pages`` (S = k + 1, the wgmma kernel) replay bit for bit what
  the same call gives eagerly -- logits, pool codes and page params, the
  validity mask -- over bf16 and int8 pools, at a Llama geometry (head_dim
  128, 4 q heads a kv head) and a Gemma-2 one (head_dim 256, softcap,
  sliding window); so does the draft's ``decode_slots``.
- A replay adds each kernel's launches to its route's counter, as an
  eager call does.
- A steady dispatch of the async engine (graph replay, sampler, packed put
  and fetch) makes no host sync (``torch.cuda.set_sync_debug_mode``).
- The async graph engine's greedy tokens equal the synchronous eager
  engine's, plain and speculative.
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
from neuronx_distributed_tpu_torch.models.gemma import Gemma2Config, Gemma2ForCausalLM
from neuronx_distributed_tpu_torch.ops.paged_attention import paged_attention

pytestmark = pytest.mark.cuda

SLOTS, CTX, TOTAL, PAGE = 4, 32, 96, 16


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _model(geom, dev):
    if geom == "llama":
        cfg = LlamaConfig.tiny(hidden_size=256, num_heads=8, num_kv_heads=2,
                               head_dim=128, dtype=torch.bfloat16)
        module = LlamaForCausalLM(cfg, device=dev).init_random(0)
    else:
        cfg = Gemma2Config.tiny(hidden_size=256, num_heads=4, num_kv_heads=2,
                                head_dim=256, query_pre_attn_scalar=256.0,
                                attn_softcap=50.0, sliding_window=24,
                                dtype=torch.bfloat16)
        module = Gemma2ForCausalLM(cfg, device=dev).init_random(0)
    icfg = InferenceConfig(SLOTS, CTX, TOTAL, torch.bfloat16)
    return (cfg, ParallelInferenceModel(module, icfg, cuda_graphs=False),
            ParallelInferenceModel(module, icfg, cuda_graphs=True))


def _prompts(vocab, n, seed):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, vocab, size=rs.randint(4, CTX + 1)).tolist()
            for _ in range(n)]


def _admitted(pim, vocab, kv_quant):
    """A synchronous eager engine with three slots prefilled and decoded
    once, and one slot parked."""
    eng = ServingEngine(pim, page_size=PAGE, kv_quant=kv_quant,
                        async_decode=False)
    for i, p in enumerate(_prompts(vocab, 3, 1)):
        eng.submit(Request(request_id=i, prompt_ids=p, max_new_tokens=20))
    eng.step()
    return eng


def _copy_state(eng):
    return ([tuple(t.clone() for t in e) for e in eng.caches],
            eng.valid.clone())


def _counts():
    return (paged_attention.decode_launches, paged_attention.wgmma_launches,
            paged_attention.launches)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
@pytest.mark.parametrize("geom", ["llama", "gemma2"])
def test_replayed_phases_are_bit_identical_to_eager(dev, geom, kv_quant):
    cfg, eager, graphed = _model(geom, dev)
    eng = _admitted(eager, cfg.vocab_size, kv_quant)
    tables = torch.from_numpy(eng._kv.tables).to(dev)
    L = cfg.num_layers
    rs = np.random.RandomState(2)
    for phase, S, route in (("decode_pages", 1, 0), ("verify_pages", 5, 1)):
        state = {m: _copy_state(eng) for m in ("eager", "graph")}
        offsets = torch.from_numpy(eng._offsets.copy()).to(dev)
        for call in range(3):  # eager + capture, then two replays
            toks = torch.from_numpy(rs.randint(
                1, cfg.vocab_size, size=(SLOTS, S))).to(dev)
            out = {}
            for mode, pim in (("eager", eager), ("graph", graphed)):
                caches, valid = state[mode]
                before = _counts()
                out[mode], _, _ = getattr(pim, phase)(
                    toks, offsets, tables, caches, valid)
                torch.cuda.synchronize()
                moved = [a - b for a, b in zip(_counts(), before)]
                assert moved[route] == L and moved[2] == L, (mode, moved)
            assert torch.equal(out["eager"], out["graph"]), (phase, call)
            for e_entry, g_entry in zip(state["eager"][0], state["graph"][0]):
                for a, b in zip(e_entry, g_entry):
                    assert torch.equal(a, b)
            assert torch.equal(state["eager"][1], state["graph"][1])
            parked = offsets >= TOTAL
            offsets = torch.where(parked, offsets, offsets + S)
    assert graphed.graphs.captures == 2 and graphed.graphs.replays == 4


@pytest.mark.parametrize("geom", ["llama", "gemma2"])
def test_replayed_draft_decode_slots_is_bit_identical(dev, geom):
    cfg, eager, graphed = _model(geom, dev)
    rs = np.random.RandomState(3)
    caches = {m: eager.empty_caches() for m in ("eager", "graph")}
    valid = {m: torch.zeros((SLOTS, TOTAL), dtype=torch.int32, device=dev)
             for m in caches}
    offsets = torch.tensor([0, 5, TOTAL, 9], dtype=torch.int32, device=dev)
    for _ in range(3):
        tok = torch.from_numpy(rs.randint(1, cfg.vocab_size,
                                          size=(SLOTS, 1))).to(dev)
        out = {m: pim.decode_slots(tok, offsets, caches[m], valid[m])[0]
               for m, pim in (("eager", eager), ("graph", graphed))}
        assert torch.equal(out["eager"], out["graph"])
        for a, b in zip(caches["eager"], caches["graph"]):
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        offsets = torch.where(offsets >= TOTAL, offsets, offsets + 1)
    assert graphed.graphs.replays == 2


def _steady(eng, vocab, n):
    for i, p in enumerate(_prompts(vocab, n, 4)):
        eng.submit(Request(request_id=i, prompt_ids=p, max_new_tokens=40))
    for _ in range(3):
        eng.step()  # admissions, the eager call and capture, a replay
    return eng._decoding()


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_steady_dispatch_makes_no_host_sync(dev, kv_quant):
    cfg, _, graphed = _model("llama", dev)
    for spec in (False, True):
        kw = dict(draft=graphed, spec_k=3) if spec else {}
        eng = ServingEngine(graphed, page_size=PAGE, kv_quant=kv_quant, **kw)
        active = _steady(eng, cfg.vocab_size, SLOTS)
        assert len(active) == SLOTS and eng._pending is not None
        eng._finish_decode((eng._spec_collect if spec
                            else eng._collect_decode)(), [])
        active = eng._decoding()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            (eng._spec_dispatch if spec else eng._dispatch_decode)(active)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        eng.run_until_complete(max_steps=200)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_async_graph_engine_tokens_equal_sync_eager(dev, kv_quant):
    cfg, eager, graphed = _model("llama", dev)
    prompts = _prompts(cfg.vocab_size, 7, 5)

    def run(pim, **kw):
        eng = ServingEngine(pim, page_size=PAGE, kv_quant=kv_quant, **kw)
        for i, p in enumerate(prompts):
            eng.submit(Request(request_id=i, prompt_ids=p, max_new_tokens=24))
        outs = eng.run_until_complete(max_steps=500)
        eng._kv.assert_invariants()
        assert eng._kv.leaked_pages() == 0
        return eng, {o.request_id: o.token_ids for o in outs}

    _, want = run(eager, async_decode=False)
    before = _counts()
    eng, got = run(graphed)
    moved = [a - b for a, b in zip(_counts(), before)]
    assert got == want
    assert moved == [eng.decode_steps * cfg.num_layers, 0,
                     eng.decode_steps * cfg.num_layers]
    # speculative, self draft: the verify rounds on the wgmma route
    before = _counts()
    spec, got_spec = run(graphed, draft=graphed, spec_k=3)
    moved = [a - b for a, b in zip(_counts(), before)]
    assert moved == [0, spec.spec_rounds * cfg.num_layers,
                     spec.spec_rounds * cfg.num_layers]
    assert spec.spec_accepted > 0
    assert all(len(t) == 24 for t in got_spec.values())
