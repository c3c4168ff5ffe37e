"""PyTorch port: int8 KV pages against the JAX package.

- ``kvcache.quant``: the same seeded pages through both packages' page
  codes -- codes equal exactly (both divide in fp32 and round half to
  even), scale and zero to 1e-7 relative, the round trip within
  ``quant_error_bound``, a constant page exact; page bytes and budget
  sizing equal.
- ``paged_attention`` over an int8 six-tuple pool: the port's plain
  version against the JAX Pallas kernel (interpret mode) and the JAX
  reference, atol 1e-5 in fp32 (three fp32 implementations of one
  softmax over identical dequantized K/V, summed in different orders);
  at chunk widths with bf16 q, which both sides dequantize to, atol 2e-2
  (each side rounds outputs of magnitude up to ~4 once to bf16).
- The pool after the model's writes (prefill pages, two prefill chunks,
  the second straddling a page it requantizes, two decode steps), on the
  tiny pair's shared weights: codes equal, with at most
  ``MAX_CODE_FLIPS`` codes one step apart (the K/V themselves come from
  XLA's and PyTorch's fp32 matmuls, which differ in the last bits, so a
  value on a rounding boundary may round the other way), scale and zero
  to 1e-5 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.kvcache import pool as jax_pool
from neuronx_distributed_tpu.kvcache import quant as jax_quant
from neuronx_distributed_tpu.ops.paged_attention import (
    paged_attention as jax_paged_attention,
    paged_attention_reference as jax_paged_reference,
)
from neuronx_distributed_tpu_torch.kvcache import quant
from neuronx_distributed_tpu_torch.kvcache.pool import PagePool
from neuronx_distributed_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_route,
)
from torch_port_pair import C, T, build_pair

ATOL = 1e-5
ATOL_BF16 = 2e-2
MAX_CODE_FLIPS = 4


def _pages(seed, n=5, page=4, nkv=2, D=16):
    """Pages of several scales and offsets, the last one constant."""
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((n, page, nkv, D)).astype(np.float32)
    x *= rs.uniform(0.01, 30.0, size=(n, 1, 1, 1)).astype(np.float32)
    x += rs.uniform(-5, 5, size=(n, 1, 1, 1)).astype(np.float32)
    x[-1] = np.float32(1.7)
    return x


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_page_matches_jax(seed):
    x = _pages(seed)
    q, s, z = quant.quantize_page(torch.from_numpy(x))
    jq, js, jz = (np.asarray(a) for a in jax_quant.quantize_page(
        jnp.asarray(x)))
    assert q.dtype == torch.int8 and s.shape == (x.shape[0],)
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_allclose(s.numpy(), js, rtol=1e-7, atol=0)
    np.testing.assert_allclose(z.numpy(), jz, rtol=1e-7, atol=0)
    back = quant.dequantize_page(q, s, z)
    np.testing.assert_allclose(
        back.numpy(), np.asarray(jax_quant.dequantize_page(
            jnp.asarray(jq), jnp.asarray(js), jnp.asarray(jz))),
        rtol=1e-7, atol=1e-7)
    for i in range(x.shape[0]):
        err = np.abs(back[i].numpy() - x[i]).max()
        assert err <= quant.quant_error_bound(x[i])
        assert quant.quant_error_bound(x[i]) == jax_quant.quant_error_bound(
            x[i])
    # the constant page: scale 0, exact round trip through zero
    assert s[-1].item() == 0.0
    assert torch.equal(back[-1], torch.from_numpy(x[-1]))
    bf16 = quant.dequantize_page(q, s, z, torch.bfloat16)
    assert bf16.dtype == torch.bfloat16 and torch.equal(bf16,
                                                        back.bfloat16())


def test_page_bytes_and_budget_match_jax():
    for q_, dt, jdt in ((None, torch.bfloat16, jnp.bfloat16),
                        (None, torch.float32, jnp.float32),
                        ("int8", torch.bfloat16, jnp.bfloat16)):
        assert quant.page_layer_bytes(16, 8, 128, q_, dt) == \
            jax_quant.page_layer_bytes(16, 8, 128, q_, jdt)
        assert PagePool.pages_for_budget(1 << 30, 32, 16, 8, 128, dt,
                                         quant=q_) == \
            jax_pool.PagePool.pages_for_budget(1 << 30, 32, 16, 8, 128, jdt,
                                               quant=q_)
        pool = PagePool(2, 5, 4, 2, 8, dtype=dt, quant=q_, device="cpu")
        assert pool.page_bytes == jax_pool.PagePool(
            2, 5, 4, 2, 8, dtype=jdt, quant=q_).page_bytes
    int8 = PagePool.pages_for_budget(1 << 30, 32, 16, 8, 128, quant="int8")
    assert int8 >= 1.99 * PagePool.pages_for_budget(1 << 30, 32, 16, 8, 128)
    with pytest.raises(ValueError, match="int8"):
        quant.page_layer_bytes(16, 8, 128, "fp8", torch.bfloat16)


def _int8_inputs(seed, B, S, nq, nkv, D, page, PP, NP):
    rs = np.random.RandomState(seed)
    Tk = PP * page
    q = rs.standard_normal((B, S, nq, D)).astype(np.float32)
    pool = []
    for _ in range(2):
        x = rs.standard_normal((NP, page, nkv, D)).astype(np.float32)
        x[3] = np.float32(0.25)  # a constant page among the attended ones
        pool.append(x)
    qk, ks, kz = quant.quantize_page(torch.from_numpy(pool[0]))
    qv, vs, vz = quant.quantize_page(torch.from_numpy(pool[1]))
    six = tuple(t.numpy() for t in (qk, qv, ks, kz, vs, vz))
    bt = rs.randint(1, NP, size=(B, PP)).astype(np.int32)
    bt[0, 0] = 3
    off = rs.randint(2, Tk - S, size=B).astype(np.int32)
    off[1] = Tk  # parked slot
    start = np.minimum(rs.randint(0, 6, size=B), off).astype(np.int32)
    start[0] = 0
    return q, six, bt, off, start


CASES = [  # (S, split_k, nq, nkv, options)
    (1, 1, 8, 8, {}), (1, 2, 8, 2, {}), (3, 1, 8, 1, {}),
    (3, 2, 8, 2, dict(window=6)), (8, 1, 8, 2, dict(softcap=30.0)),
    (8, 2, 8, 1, dict(window=5, softcap=20.0, sm_scale=0.3)),
    (1, 2, 8, 1, {}),  # decode at G = 8, the decode kernel's widest N tile
]


@pytest.mark.parametrize("S,split_k,nq,nkv,kw", CASES)
def test_int8_pool_matches_jax_kernel_and_reference(S, split_k, nq, nkv, kw):
    """Decode (S = 1), verify and chunk widths (3, 8), split-K 1 and 2,
    GQA 1/4/8, a parked slot, a constant page, window and softcap."""
    q, six, bt, off, start = _int8_inputs(S * 10 + nq // nkv, B=3, S=S,
                                          nq=nq, nkv=nkv, D=16, page=4,
                                          PP=6, NP=20)
    out = paged_attention(
        torch.from_numpy(q), tuple(torch.from_numpy(a) for a in six),
        torch.from_numpy(bt), torch.from_numpy(off), torch.from_numpy(start),
        split_k=split_k, **kw).numpy()
    jargs = (jnp.asarray(q), tuple(jnp.asarray(a) for a in six),
             jnp.asarray(bt), jnp.asarray(off), jnp.asarray(start))
    ref = np.asarray(jax_paged_reference(*jargs, **kw))
    ker = np.asarray(jax_paged_attention(*jargs, block_pages=2,
                                         split_k=split_k, interpret=True,
                                         **kw))
    np.testing.assert_allclose(out, ref, atol=ATOL)
    np.testing.assert_allclose(out, ker, atol=ATOL)
    assert np.all(out[1] == 0.0), "parked slot must be exact zeros"
    assert np.any(out[0] != 0.0)


@pytest.mark.parametrize("kw", [dict(window=40),
                                dict(softcap=30.0, sm_scale=0.2)])
@pytest.mark.parametrize("S", [2, 32])
@pytest.mark.parametrize("B", [1, 2])
def test_int8_chunk_widths_match_jax_kernel(B, S, kw):
    """int8 pools at chunk widths (G = 4: G * S = 8 and 128), bf16 q,
    page 16, D 64, a constant page,
    kv_start, window and softcap: the plain version both CUDA routes are
    held to against the JAX kernel and reference."""
    q, six, bt, off, start = _int8_inputs(90 + 10 * B + S, B=2, S=S, nq=8,
                                          nkv=2, D=64, page=16, PP=8, NP=20)
    off[:] = [8 * 16 - S, 40]  # slot 0's chunk ends at the last page
    start[:] = [3, 0]
    q, bt, off, start = q[:B], bt[:B], off[:B], start[:B]
    assert paged_route(torch.bfloat16, S, 4) == "wgmma"
    tq = torch.from_numpy(q).bfloat16()
    out = paged_attention(
        tq, tuple(torch.from_numpy(a) for a in six), torch.from_numpy(bt),
        torch.from_numpy(off), torch.from_numpy(start), split_k=2, **kw)
    assert out.dtype == torch.bfloat16
    jargs = (jnp.asarray(q, jnp.bfloat16), tuple(jnp.asarray(a) for a in six),
             jnp.asarray(bt), jnp.asarray(off), jnp.asarray(start))
    ker = jax_paged_attention(*jargs, block_pages=2, split_k=2,
                              interpret=True, **kw)
    ref = jax_paged_reference(*jargs, **kw)
    got = out.float().numpy()
    np.testing.assert_allclose(got, np.asarray(ker, np.float32),
                               atol=ATOL_BF16)
    np.testing.assert_allclose(got, np.asarray(ref, np.float32),
                               atol=ATOL_BF16)
    assert np.any(got[0] != 0.0)


def _assert_pools_equal(tcaches, jcaches):
    flips = 0
    for tc, jc in zip(tcaches, jcaches):
        assert len(tc) == len(jc) == 6
        for t, j in zip(tc[:2], jc[:2]):
            diff = np.abs(t.numpy().astype(np.int32)
                          - np.asarray(j).astype(np.int32))
            assert diff.max() <= 1
            flips += int((diff > 0).sum())
        for t, j in zip(tc[2:], jc[2:]):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                       atol=1e-7)
    assert flips <= MAX_CODE_FLIPS, f"{flips} codes one step apart"


def test_int8_pool_after_writes_equals_jax():
    """Whole-prefill pages (left pads zeroed before quantizing), two prefill
    chunks of one prompt -- the second starts mid-page and requantizes the
    page the first wrote -- and two decode steps: the port's int8 pool
    equals the JAX pool after every write."""
    jpim, tpim, _, _, cfg = build_pair()
    rs = np.random.RandomState(3)
    B = 3
    PP, NP = T // 4, 16
    ids = np.zeros((1, C), np.int32)
    ids[0, 1:] = rs.randint(1, cfg.vocab_size, size=C - 1)  # one left pad
    valid = np.zeros((1, T), np.int32)
    valid[0, 1:C] = 1
    table = np.zeros((1, PP), np.int32)
    table[0] = [1, 2, 3, 4]

    # whole prefill of the prompt into pages 5, 6 (garbage pad cell zeroed)
    jl, jrow = jpim.prefill_one(jnp.asarray(ids), jnp.asarray(valid[:, :C]))
    _, trow = tpim.prefill_one(ids, valid[:, :C])
    jc = jpim.make_page_pool(NP, 4, quant="int8").caches
    tc = tpim.make_page_pool(NP, 4, quant="int8").caches
    for lp, phys in ((0, 5), (1, 6)):
        jc = jpim.write_page(jc, jrow, lp, phys, row_valid=valid[0, :C])
        tc = tpim.write_page(tc, trow, lp, phys, row_valid=valid[0, :C])
    _assert_pools_equal(tc, jc)

    # the same prompt in two chunks into pages 1, 2: [0, 3) then [3, 8)
    for off, width in ((0, 3), (3, 5)):
        chunk = ids[:, off:off + width]
        jlog, jc = jpim.prefill_chunk_pages(jnp.asarray(chunk), off, table,
                                            jc, jnp.asarray(valid),
                                            paged_kernel=False)
        tlog, tc = tpim.prefill_chunk_pages(chunk, off, table, tc, valid,
                                            paged_kernel=False)
        _assert_pools_equal(tc, jc)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4)

    # two decode steps of slot 0 (slots 1, 2 parked) on the kernel path
    tables = np.zeros((B, PP), np.int32)
    tables[0] = table[0]
    vfull = np.zeros((B, T), np.int32)
    vfull[0] = valid[0]
    jvalid, tvalid = jnp.asarray(vfull), torch.from_numpy(vfull.copy())
    toks = np.zeros((B, 1), np.int32)
    toks[0, 0] = int(np.argmax(np.asarray(jlog)[0]))
    offsets = np.array([C, T, T], np.int32)
    for _ in range(2):
        jl, jc, jvalid = jpim.decode_pages(
            jnp.asarray(toks), jnp.asarray(offsets), jnp.asarray(tables), jc,
            jvalid, paged_kernel=False)
        tl, tc, tvalid = tpim.decode_pages(toks, offsets, tables, tc, tvalid,
                                           paged_kernel=True)
        _assert_pools_equal(tc, jc)
        np.testing.assert_allclose(tl.numpy()[0], np.asarray(jl)[0],
                                   atol=1e-4)
        toks[0, 0] = int(np.argmax(np.asarray(jl)[0]))
        offsets[0] += 1
    # the copy-on-write device half copies codes and page params
    tc = tpim.copy_page(tc, 2, 9)
    for entry in tc:
        assert all(torch.equal(a[9], a[2]) for a in entry)


def test_int8_errors():
    """An unknown quantization raises; a six-tuple cache on the contiguous
    path raises."""
    _, tpim, _, _, _ = build_pair()
    with pytest.raises(ValueError, match="int8"):
        PagePool(2, 5, 4, 2, 8, quant="fp8", device="cpu")
    with pytest.raises(ValueError, match="int8"):
        tpim.make_page_pool(8, 4, quant="int4")
    caches = tpim.make_page_pool(8, 4, quant="int8").caches
    ids = torch.zeros((1, 2), dtype=torch.long)
    with pytest.raises(ValueError, match="page pools"):
        tpim.module(ids, None, caches, 0)
