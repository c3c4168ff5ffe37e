"""PyTorch port: the hand-written CUDA kernels on the card.

Every test here needs an NVIDIA GPU (``cuda`` marker) and skips without
one.  The file imports nothing of JAX, so on a machine with a card and no
JAX it runs on its own:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -m cuda

Tolerances: the kernel against its plain version in fp32 computed from the
same (possibly bf16) inputs -- 1e-4 for fp32 inputs, 2e-2 for bf16 (one
bf16 rounding of outputs of magnitude ~1).  Over int8 pools the kernel and
the plain version dequantize the same codes to the same K/V values in q's
type, and are held to the same tolerances.
"""

import numpy as np
import pytest
import torch

from neuronx_distributed_tpu_torch.kvcache.quant import quantize_page
from neuronx_distributed_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(seed, B, S, nq, nkv, D, page, PP, NP, dtype, device):
    rs = np.random.RandomState(seed)
    T = PP * page
    f = lambda shape: torch.from_numpy(  # noqa: E731
        rs.standard_normal(shape).astype(np.float32)).to(device, dtype)
    q = f((B, S, nq, D))
    pool = (f((NP, page, nkv, D)), f((NP, page, nkv, D)))
    bt = rs.randint(1, NP, size=(B, PP)).astype(np.int32)
    off = rs.randint(2, T - S, size=B).astype(np.int32)
    off[1] = T  # parked slot
    start = np.minimum(rs.randint(0, 6, size=B), off).astype(np.int32)
    ints = [torch.from_numpy(a).to(device) for a in (bt, off, start)]
    return q, pool, *ints


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("S,split_k", [(1, 1), (1, 3), (4, 1), (4, 2),
                                       (20, 2)])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_kernel_matches_plain(dev, D, S, split_k, dtype, tol):
    """D in {64, 128, 256}, decode and wide rows (S = 20 spans two row
    tiles), split-K, a sliding window, a parked slot."""
    q, pool, bt, off, start = _inputs(D + S, 3, S, 8, 2, D, 16, 8, 25, dtype,
                                      dev)
    before = paged_attention.launches
    out = paged_attention(q, pool, bt, off, start, split_k=split_k,
                          window=40)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    ref = paged_attention_reference(q.float(), tuple(p.float() for p in pool),
                                    bt, off, start, window=40)
    assert (out.float() - ref).abs().max().item() <= tol
    assert torch.all(out[1] == 0)


def _int8(pool):
    """The int8 six-tuple of an fp pool, page 2 made constant first."""
    k, v = (p.float().clone() for p in pool)
    k[2], v[2] = 0.5, -0.25
    (qk, ks, kz), (qv, vs, vz) = quantize_page(k), quantize_page(v)
    return qk, qv, ks, kz, vs, vz


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("S,split_k", [(1, 1), (1, 3), (4, 2), (20, 1)])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_int8_kernel_matches_plain(dev, D, S, split_k, dtype, tol):
    """The int8 branch: D in {64, 128, 256}, decode and wide rows,
    split-K, a sliding window, a parked slot, a constant page."""
    q, pool, bt, off, start = _inputs(D + S + 1, 3, S, 8, 2, D, 16, 8, 25,
                                      dtype, dev)
    bt[0, 0] = 2
    start[0] = 0
    six = _int8(pool)
    before = paged_attention.launches
    out = paged_attention(q, six, bt, off, start, split_k=split_k, window=40)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    ref = paged_attention_reference(q, six, bt, off, start, window=40)
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert torch.all(out[1] == 0)


@pytest.mark.parametrize("page", [1, 5, 16, 64])
def test_any_page_size_and_softcap(dev, page):
    q, pool, bt, off, start = _inputs(page, 4, 2, 8, 8, 64, page, 96 // page,
                                      40, torch.float32, dev)
    out = paged_attention(q, pool, bt, off, start, softcap=30.0, sm_scale=0.2)
    ref = paged_attention_reference(q, pool, bt, off, start, softcap=30.0,
                                    sm_scale=0.2)
    assert (out - ref).abs().max().item() <= 1e-4


def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    q, pool, bt, off, start = _inputs(0, 2, 2, 4, 2, 64, 4, 4, 9,
                                      torch.float32, dev)
    with pytest.raises(TypeError, match="int32"):
        paged_attention(q, pool, bt.long(), off, start)
    with pytest.raises(TypeError, match="dtype"):
        paged_attention(q, tuple(p.bfloat16() for p in pool), bt, off, start)
    with pytest.raises(ValueError, match="head_dim"):
        paged_attention(q[..., :48].contiguous(),
                        tuple(p[..., :48].contiguous() for p in pool),
                        bt, off, start)
    with pytest.raises(ValueError, match="contiguous"):
        paged_attention(q.transpose(1, 2), pool, bt, off, start)
    with pytest.raises(ValueError, match="on cpu"):
        paged_attention(q, pool, bt.cpu(), off, start)
    with pytest.raises(ValueError, match="six-tuple"):
        paged_attention(q, pool * 2, bt, off, start)
    six = _int8(pool)
    out = paged_attention(q, six, bt, off, start)  # the int8 pool launches
    torch.cuda.synchronize()
    assert out.shape == q.shape and out.dtype == q.dtype
    with pytest.raises(TypeError, match="int8"):
        paged_attention(q, tuple(p.float() if i < 2 else p
                                 for i, p in enumerate(six)), bt, off, start)
    with pytest.raises(TypeError, match="float32"):
        paged_attention(q, six[:2] + (six[2].double(),) + six[3:], bt, off,
                        start)
    with pytest.raises(ValueError, match="one param per physical page"):
        paged_attention(q, six[:2] + (six[2][:-1].contiguous(),) + six[3:],
                        bt, off, start)
    with pytest.raises(ValueError, match="contiguous"):
        paged_attention(q, six[:5] + (torch.zeros(
            (six[5].shape[0], 2), device=dev)[:, 0],), bt, off, start)


def test_served_tokens_kernel_equal_gather_fp32(dev):
    """A tiny fp32 Llama served on the card: the kernel path and the gather
    path give the same greedy tokens, and the kernel ran once per layer
    per decode step."""
    from neuronx_distributed_tpu_torch import (
        InferenceConfig,
        LlamaConfig,
        LlamaForCausalLM,
        ParallelInferenceModel,
        Request,
        ServingEngine,
    )

    cfg = LlamaConfig.tiny(num_kv_heads=2, head_dim=64, dtype=torch.float32)
    model = LlamaForCausalLM(cfg, device=dev).init_random(0)
    pim = ParallelInferenceModel(model, InferenceConfig(3, 16, 48,
                                                        torch.float32))
    rs = np.random.RandomState(1)
    prompts = [rs.randint(1, cfg.vocab_size, size=rs.randint(2, 17)).tolist()
               for _ in range(6)]
    runs = {}
    for pk in (True, False):
        eng = ServingEngine(pim, page_size=8, paged_kernel=pk)
        before = paged_attention.launches
        for i, p in enumerate(prompts):
            eng.submit(Request(request_id=i, prompt_ids=p, max_new_tokens=12))
        runs[pk] = {o.request_id: o.token_ids
                    for o in eng.run_until_complete(max_steps=200)}
        launched = paged_attention.launches - before
        assert launched == (eng.decode_steps * cfg.num_layers if pk else 0)
    assert runs[True] == runs[False]


def test_served_tokens_int8_chunked_kernel_equal_gather(dev):
    """The int8, chunked-prefill engine on the card: kernel and gather path
    give the same greedy tokens, and the kernel ran once per layer per
    decode step and per chunk."""
    from neuronx_distributed_tpu_torch import (
        InferenceConfig,
        LlamaConfig,
        LlamaForCausalLM,
        ParallelInferenceModel,
        Request,
        ServingEngine,
    )

    cfg = LlamaConfig.tiny(num_kv_heads=2, head_dim=64, dtype=torch.float32)
    model = LlamaForCausalLM(cfg, device=dev).init_random(0)
    pim = ParallelInferenceModel(model, InferenceConfig(3, 16, 48,
                                                        torch.float32))
    rs = np.random.RandomState(2)
    prompts = [rs.randint(1, cfg.vocab_size, size=rs.randint(2, 17)).tolist()
               for _ in range(6)]
    runs = {}
    for pk in (True, False):
        eng = ServingEngine(pim, page_size=8, paged_kernel=pk,
                            kv_quant="int8", prefill_chunk_tokens=8)
        before = paged_attention.launches
        for i, p in enumerate(prompts):
            eng.submit(Request(request_id=i, prompt_ids=p, max_new_tokens=12))
        runs[pk] = {o.request_id: o.token_ids
                    for o in eng.run_until_complete(max_steps=200)}
        launched = paged_attention.launches - before
        assert eng.prefill_chunks > 0 and eng.quant_pages > 0
        assert launched == ((eng.decode_steps + eng.prefill_chunks)
                            * cfg.num_layers if pk else 0)
    assert runs[True] == runs[False]
