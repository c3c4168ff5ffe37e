"""PyTorch port: the hand-written CUDA kernels on the card.

Every test here needs an NVIDIA GPU (``cuda`` marker) and skips without
one.  The file imports nothing of JAX, so on a machine with a card and no
JAX it runs on its own:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -m cuda

Tolerances: the kernel against its plain version in fp32 computed from the
same (possibly bf16) inputs -- 1e-4 for fp32 inputs, 2e-2 for bf16 (one
bf16 rounding of outputs of magnitude ~1).  Over int8 pools the kernel and
the plain version dequantize the same codes to the same K/V values in q's
type, and are held to the same tolerances.  All three routes are held:
the simt kernel (``paged_attention_kernel``: fp32 q by the routing rule,
so the bf16 cases of the first two tests run the decode kernel at S = 1
and the wgmma kernel at S > 1; its bf16 multi-row code is forced by
``test_simt_route_bf16_multirow``), the wgmma kernel
(``paged_attention_wgmma_kernel``, bf16 q at S > 1) and the decode kernel
(``paged_attention_decode_kernel``, bf16 q at S = 1, at most 8 q heads a
kv head).  The decode kernel multiplies bf16 P (the TPU kernel's
``p.astype(v.dtype)``), so it is held at 2e-2 like every bf16 case.
"""

import numpy as np
import pytest
import torch

from neuronx_distributed_tpu_torch.kvcache.quant import quantize_page
from neuronx_distributed_tpu_torch.ops.paged_attention import (
    DECODE_MAX_CLUSTER,
    _paged_attention_on,
    paged_attention,
    paged_attention_reference,
    paged_route,
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


@pytest.mark.parametrize("split_k", [1, None])
@pytest.mark.parametrize("pool_kind", ["bf16", "int8"])
@pytest.mark.parametrize("S,G", [(16, 4), (32, 4), (128, 4), (2, 4), (3, 4),
                                 (2, 1), (3, 2)])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_wgmma_kernel_matches_plain(dev, D, S, G, pool_kind, split_k):
    """The wgmma route, as the rule picks it, at chunk widths down to two
    query rows a kv head: D in {64, 128, 256}, bf16 and int8 pools (a
    constant page), split-K 1 and the default, a sliding window,
    kv_start, a parked slot."""
    q, pool, bt, off, start = _inputs(3 * D + S + G, 3, S, 2 * G, 2, D, 16,
                                      16, 50, torch.bfloat16, dev)
    if pool_kind == "int8":
        bt[0, 0] = 2
        start[0] = 0
        pool = _int8(pool)
    before = (paged_attention.launches, paged_attention.wgmma_launches)
    out = paged_attention(q, pool, bt, off, start, split_k=split_k,
                          window=100)
    torch.cuda.synchronize()
    assert (paged_attention.launches, paged_attention.wgmma_launches) == (
        before[0] + 1, before[1] + 1)
    args = ((q, pool) if pool_kind == "int8" else
            (q.float(), tuple(p.float() for p in pool)))
    ref = paged_attention_reference(*args, bt, off, start, window=100)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    assert torch.all(out[1] == 0)


@pytest.mark.parametrize("pool_kind", ["bf16", "int8"])
@pytest.mark.parametrize("page", [1, 5, 16, 64])
def test_wgmma_any_page_size_and_softcap(dev, page, pool_kind):
    """A key tile spans many pages (page 1, 5) or lies inside one (64)."""
    q, pool, bt, off, start = _inputs(page + 7, 4, 32, 8, 2, 128, page,
                                      192 // page, 40, torch.bfloat16, dev)
    if pool_kind == "int8":
        pool = _int8(pool)
    out = paged_attention(q, pool, bt, off, start, softcap=30.0,
                          sm_scale=0.2)
    args = ((q, pool) if pool_kind == "int8" else
            (q.float(), tuple(p.float() for p in pool)))
    ref = paged_attention_reference(*args, bt, off, start, softcap=30.0,
                                    sm_scale=0.2)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


def _decode_inputs(seed, D, G, page, pool_kind, dev):
    """bf16 q at S = 1 over 2 kv heads (2G q heads), a 320-key chain in
    pages of ``page``: slots 0, 2, 4 live, slot 1 parked, slot 3 with
    kv_start past its offset (no visible key); an int8 pool has page 2
    constant (scale 0) and slot 0's first page is it."""
    T = 320
    q, pool, bt, off, start = _inputs(seed, 5, 1, 2 * G, 2, D, page,
                                      T // page, 40, torch.bfloat16, dev)
    start[3] = off[3] + 1
    if pool_kind == "int8":
        bt[0, 0] = 2
        start[0] = 0
        pool = _int8(pool)
    return q, pool, bt, off, start


@pytest.mark.parametrize("split_k", [1, None, DECODE_MAX_CLUSTER,
                                     DECODE_MAX_CLUSTER + 3])
@pytest.mark.parametrize("pool_kind", ["bf16", "int8"])
@pytest.mark.parametrize("page", [1, 5, 16, 64])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_decode_kernel_matches_plain(dev, D, G, page, pool_kind, split_k):
    """The decode route, as the rule picks it: D in {64, 128, 256}, G up
    to one full N tile, pages of 1 to 64 keys, bf16 and int8 pools (a
    constant page), a sliding window with a softcap, split-K 1, the
    default, a full cluster and past a cluster (the workspace merge);
    parked slots and rows that see no key are exact zeros."""
    q, pool, bt, off, start = _decode_inputs(D + G + page, D, G, page,
                                             pool_kind, dev)
    kw = dict(window=100, softcap=30.0, sm_scale=0.2)
    before = (paged_attention.launches, paged_attention.decode_launches)
    out = paged_attention(q, pool, bt, off, start, split_k=split_k, **kw)
    torch.cuda.synchronize()
    assert (paged_attention.launches, paged_attention.decode_launches) == (
        before[0] + 1, before[1] + 1)
    args = ((q, pool) if pool_kind == "int8" else
            (q.float(), tuple(p.float() for p in pool)))
    ref = paged_attention_reference(*args, bt, off, start, **kw)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    assert torch.all(out[1] == 0) and torch.all(out[3] == 0)
    assert torch.all(ref[1] == 0) and torch.all(ref[3] == 0)


@pytest.mark.parametrize("split_k", [1, DECODE_MAX_CLUSTER])
@pytest.mark.parametrize("pool_kind", ["bf16", "int8"])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_decode_kernel_passes_one_key_through_exactly(dev, D, pool_kind,
                                                      split_k):
    """Every live slot sees one key (kv_start = offset), so the output is
    that key's V row as the plain version dequantizes it, bit for bit:
    slot 0's key on a constant page (scale 0), slot 2's on a page with a
    large zero point (values near 500, where bf16's step is 2)."""
    q, pool, bt, off, start = _decode_inputs(D, D, 4, 16, "bf16", dev)
    if pool_kind == "int8":
        k, v = (p.float().clone() for p in pool)
        k[2], v[2] = 0.5, -0.25
        k[3] += 500.0
        v[3] += 500.0
        (qk, ks, kz), (qv, vs, vz) = quantize_page(k), quantize_page(v)
        pool = (qk, qv, ks, kz, vs, vz)
        bt[0, off[0] // 16] = 2
        bt[2, off[2] // 16] = 3
    start[:] = torch.minimum(off, torch.full_like(off, 319))
    out = paged_attention(q, pool, bt, off, start, split_k=split_k)
    torch.cuda.synchronize()
    ref = paged_attention_reference(q, pool, bt, off, start)
    assert torch.equal(out, ref)
    assert torch.any(out[0] != 0) and torch.all(out[1] == 0)


def test_decode_call_adds_no_host_sync(dev):
    """A default-split decode call (a cluster of splits) under
    torch.cuda.set_sync_debug_mode("error"): the route and split come from
    shapes alone, so nothing waits on the device."""
    q, pool, bt, off, start = _inputs(11, 8, 1, 32, 8, 128, 16, 64, 600,
                                      torch.bfloat16, dev)
    paged_attention(q, pool, bt, off, start)  # builds and loads the kernel
    torch.cuda.synchronize()
    before = paged_attention.decode_launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = paged_attention(q, pool, bt, off, start)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert paged_attention.decode_launches == before + 1
    ref = paged_attention_reference(q.float(), tuple(p.float() for p in pool),
                                    bt, off, start)
    assert (out.float() - ref).abs().max().item() <= 2e-2


ROUTE_KERNELS = {"simt": "paged_attention_kernel",
                 "wgmma": "paged_attention_wgmma_kernel",
                 "decode": "paged_attention_decode_kernel"}


@pytest.mark.parametrize("dtype,S,kernel", [
    (torch.bfloat16, 1, "paged_attention_decode_kernel"),
    (torch.bfloat16, 128, "paged_attention_wgmma_kernel"),
    (torch.bfloat16, 2, "paged_attention_wgmma_kernel"),
    (torch.float32, 128, "paged_attention_kernel"),
    (torch.float32, 1, "paged_attention_kernel"),
])
def test_profiler_names_the_routed_kernel(dev, dtype, S, kernel):
    """The rule's route is the kernel the card runs, by the name
    torch.profiler records: bf16 decode on the decode kernel, bf16 chunks
    on the wgmma kernel, fp32 q on the simt kernel."""
    from torch.profiler import ProfilerActivity, profile

    q, pool, bt, off, start = _inputs(S, 2, S, 32, 8, 128, 16, 16, 40,
                                      dtype, dev)
    assert ROUTE_KERNELS[paged_route(dtype, S, 4)] == kernel
    paged_attention(q, pool, bt, off, start)
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler has returned an empty trace
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            paged_attention(q, pool, bt, off, start)
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()]
        if names:
            break
    assert any(kernel in n for n in names), names
    for other in set(ROUTE_KERNELS.values()) - {kernel}:
        assert not any(other in n for n in names), names


@pytest.mark.parametrize("pool_kind", ["bf16", "int8"])
@pytest.mark.parametrize("S,split_k", [(2, 1), (3, 2), (4, 2), (20, 1)])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_simt_route_bf16_multirow(dev, D, S, split_k, pool_kind):
    """The simt kernel's bf16 multi-row code, forced (the rule sends bf16
    q at S > 1 to the wgmma kernel): bf16 and int8 pools, split-K, a
    sliding window, a parked slot."""
    q, pool, bt, off, start = _inputs(D + S + 2, 3, S, 8, 2, D, 16, 8, 25,
                                      torch.bfloat16, dev)
    if pool_kind == "int8":
        bt[0, 0] = 2
        start[0] = 0
        pool = _int8(pool)
    before = (paged_attention.launches, paged_attention.wgmma_launches)
    out = _paged_attention_on("simt", q, pool, bt, off, start,
                              split_k=split_k, window=40)
    torch.cuda.synchronize()
    assert (paged_attention.launches, paged_attention.wgmma_launches) == (
        before[0] + 1, before[1])
    args = ((q, pool) if pool_kind == "int8" else
            (q.float(), tuple(p.float() for p in pool)))
    ref = paged_attention_reference(*args, bt, off, start, window=40)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    assert torch.all(out[1] == 0)


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
    with pytest.raises(TypeError, match="bfloat16"):
        _paged_attention_on("wgmma", q, pool, bt, off, start)
    with pytest.raises(TypeError, match="bfloat16"):
        _paged_attention_on("decode", q, pool, bt, off, start)
    bq, bpool = q.bfloat16(), tuple(p.bfloat16() for p in pool)
    with pytest.raises(ValueError, match="one query position"):
        _paged_attention_on("decode", bq, bpool, bt, off, start)
    wide = torch.zeros((2, 1, 18, 64), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="at most 8"):  # G = 9
        _paged_attention_on("decode", wide, bpool, bt, off, start)
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
