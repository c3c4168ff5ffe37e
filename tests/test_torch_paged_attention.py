"""PyTorch port: ``ops.paged_attention`` against the JAX package.

The same seeded numpy inputs go through the JAX Pallas kernel (interpret
mode on the CPU), the JAX dense reference, and the port's
``paged_attention`` -- on CPU tensors the port runs its plain version,
split-K partials and logsumexp merge included.
Tolerance: atol 1e-5 in fp32 (three fp32 implementations of one softmax,
summed in different orders); 2e-2 in bf16 (both sides round outputs of
magnitude up to ~4 once to bf16, a step of up to 1.6e-2).  The CUDA
kernels themselves are checked on the card by
``tests/test_torch_cuda_kernels.py``; the routing rule, what each forced
route takes, and the wgmma and decode routes' split policies are pure
functions, held here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.ops.paged_attention import (
    paged_attention as jax_paged_attention,
    paged_attention_reference as jax_paged_reference,
)
from neuronx_distributed_tpu_torch.ops.paged_attention import (
    DECODE_MAX_G,
    _check_route,
    _paged_attention_on,
    decode_split_k,
    merge_splits,
    paged_attention,
    paged_attention_reference,
    paged_route,
    resolve_paged_kernel,
    wgmma_split_k,
)

ATOL = 1e-5
ATOL_BF16 = 2e-2


def _inputs(seed, B, S, nq, nkv, D, page, PP, NP):
    rs = np.random.RandomState(seed)
    T = PP * page
    q = rs.standard_normal((B, S, nq, D)).astype(np.float32)
    k = rs.standard_normal((NP, page, nkv, D)).astype(np.float32)
    v = rs.standard_normal((NP, page, nkv, D)).astype(np.float32)
    bt = rs.randint(1, NP, size=(B, PP)).astype(np.int32)
    off = rs.randint(2, T - S, size=B).astype(np.int32)
    off[1] = T  # parked slot
    start = np.minimum(rs.randint(0, 6, size=B), off).astype(np.int32)
    return q, (k, v), bt, off, start


def _jax(fn, q, pool, bt, off, start, **kw):
    return np.asarray(fn(jnp.asarray(q), tuple(jnp.asarray(p) for p in pool),
                         jnp.asarray(bt), jnp.asarray(off),
                         jnp.asarray(start), **kw))


def _torch(q, pool, bt, off, start, **kw):
    return paged_attention(
        torch.from_numpy(q), tuple(torch.from_numpy(p) for p in pool),
        torch.from_numpy(bt), torch.from_numpy(off), torch.from_numpy(start),
        **kw).numpy()


@pytest.mark.parametrize("split_k", [1, 2])
@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("nq,nkv", [(8, 8), (8, 2), (4, 1), (8, 1)])
def test_matches_jax_kernel_and_reference(nq, nkv, S, split_k):
    """MHA/GQA/MQA, decode and verify-width rows, ragged offsets, a parked
    slot, non-zero kv_start, with and without split-K; (8, 1) is G = 8,
    the decode kernel's widest N tile."""
    q, pool, bt, off, start = _inputs(nq * 10 + nkv + S, B=4, S=S, nq=nq,
                                      nkv=nkv, D=16, page=4, PP=6, NP=20)
    out = _torch(q, pool, bt, off, start, split_k=split_k)
    ref = _jax(jax_paged_reference, q, pool, bt, off, start)
    ker = _jax(jax_paged_attention, q, pool, bt, off, start, block_pages=2,
               split_k=split_k, interpret=True)
    np.testing.assert_allclose(out, ref, atol=ATOL)
    np.testing.assert_allclose(out, ker, atol=ATOL)
    assert np.all(out[1] == 0.0), "parked slot must be exact zeros"
    assert np.any(out[0] != 0.0)


@pytest.mark.parametrize("kw", [dict(window=6), dict(softcap=50.0),
                                dict(window=5, softcap=30.0, sm_scale=0.2)])
def test_window_softcap_scale(kw):
    """Sliding window, logit softcap and a decoupled scale (the Gemma-2
    hybrid-layer combination), with split-K."""
    q, pool, bt, off, start = _inputs(5, B=3, S=2, nq=8, nkv=2, D=16,
                                      page=4, PP=8, NP=20)
    out = _torch(q, pool, bt, off, start, split_k=2, **kw)
    ref = _jax(jax_paged_reference, q, pool, bt, off, start, **kw)
    ker = _jax(jax_paged_attention, q, pool, bt, off, start, interpret=True,
               **kw)
    np.testing.assert_allclose(out, ref, atol=ATOL)
    np.testing.assert_allclose(out, ker, atol=ATOL)


def test_row_without_visible_key_is_zero():
    """kv_start past a row's causal bound leaves it no key: l = 0 and the
    merge writes exact zeros (the kernel's safe_l contract)."""
    q, pool, bt, off, start = _inputs(7, B=2, S=1, nq=4, nkv=2, D=8, page=4,
                                      PP=4, NP=9)
    off[:] = [5, 9]
    start[:] = [6, 0]
    out = _torch(q, pool, bt, off, start, split_k=2)
    assert np.all(out[0] == 0.0) and np.any(out[1] != 0.0)


def test_merge_of_empty_split_is_exact():
    """An empty split (m = NEG_INF, l = 0, acc = 0) changes nothing."""
    rs = np.random.RandomState(3)
    acc = torch.from_numpy(rs.standard_normal((1, 2, 1, 4, 8)).astype(np.float32))
    m = torch.from_numpy(rs.standard_normal((1, 2, 1, 4)).astype(np.float32))
    l = torch.rand((1, 2, 1, 4), generator=torch.Generator().manual_seed(0)) + 0.5
    one = merge_splits(acc, m, l, 2, torch.float32)
    two = merge_splits(torch.cat([acc, torch.zeros_like(acc)], 2),
                       torch.cat([m, torch.full_like(m, -1e30)], 2),
                       torch.cat([l, torch.zeros_like(l)], 2), 2,
                       torch.float32)
    assert torch.equal(one, two)


def test_pool_arity_and_device_errors():
    q = torch.zeros((1, 1, 2, 8))
    bt, off = torch.zeros((1, 2), dtype=torch.int32), torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="six-tuple"):
        paged_attention(q, (torch.zeros((2, 4, 2, 8)),) * 3, bt, off)
    # an int8 six-tuple runs: all-zero codes with scale 1 and zero -128
    # dequantize to 0, so the one visible key gives exact zeros
    six = (torch.zeros((2, 4, 2, 8), dtype=torch.int8),) * 2 + (
        torch.ones(2), torch.full((2,), -128.0)) * 2
    out = paged_attention(q + 1.0, six, bt, off)
    assert out.shape == q.shape and torch.equal(out, torch.zeros_like(q))
    with pytest.raises(ValueError, match="group"):
        paged_attention(torch.zeros((1, 1, 3, 8)), (torch.zeros((2, 4, 2, 8)),) * 2,
                        bt, off)
    meta = torch.zeros((1, 1, 2, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        paged_attention(meta, (torch.zeros((2, 4, 2, 8), device="meta"),) * 2,
                        bt.to("meta"), off.to("meta"))


def test_resolve_paged_kernel():
    assert resolve_paged_kernel("auto", "cpu") is False
    assert resolve_paged_kernel("auto", "cuda") is True
    assert resolve_paged_kernel(True, "cpu") is True
    assert resolve_paged_kernel(False, "cuda") is False
    with pytest.raises(ValueError, match="paged_kernel"):
        resolve_paged_kernel("yes", "cpu")


@pytest.mark.parametrize("dtype,S,G,route", [
    (torch.bfloat16, 1, 4, "decode"),   # Llama-3-8B decode
    (torch.bfloat16, 1, 1, "decode"),   # MHA decode
    (torch.bfloat16, 1, 2, "decode"),   # Gemma-2 decode
    (torch.bfloat16, 1, 8, "decode"),   # one full N tile of the products
    (torch.bfloat16, 1, 9, "simt"),     # past the decode kernel's maximum
    (torch.bfloat16, 1, 128, "simt"),
    (torch.float32, 1, 4, "simt"),      # neither tensor-core kernel: fp32
    (torch.bfloat16, 2, 4, "wgmma"),    # a 2-token last chunk, G * S = 8
    (torch.bfloat16, 3, 4, "wgmma"),    # G * S = 12
    (torch.bfloat16, 4, 4, "wgmma"),    # verify width, G * S = 16
    (torch.bfloat16, 8, 1, "wgmma"),    # MHA, G * S = 8
    (torch.bfloat16, 2, 1, "wgmma"),    # the fewest rows: G * S = 2
    (torch.bfloat16, 16, 4, "wgmma"),   # the smallest 16-token chunk
    (torch.bfloat16, 32, 2, "wgmma"),
    (torch.bfloat16, 128, 4, "wgmma"),  # the served 128-token chunk
    (torch.bfloat16, 64, 1, "wgmma"),
    (torch.float32, 128, 4, "simt"),    # wgmma has no fp32 mode
])
def test_route_rule(dtype, S, G, route):
    """The kernel a CUDA call takes follows from dtype, S and the number G
    of q heads a kv head serves: wgmma for every bf16 S > 1, decode for
    bf16 S = 1 up to DECODE_MAX_G, the scalar kernel for the rest."""
    assert paged_route(dtype, S, G) == route
    assert (route == "wgmma") == (dtype == torch.bfloat16 and S > 1)
    assert (route == "decode") == (dtype == torch.bfloat16 and S == 1
                                   and G <= DECODE_MAX_G)
    _check_route(route, dtype, S, G)  # the rule's pick takes its inputs


@pytest.mark.parametrize("B,NKV,rows,T,D,sms,split", [
    (1, 8, 512, 1024, 128, 132, 4),   # the served chunk call: 32 blocks
    (8, 8, 512, 1024, 128, 132, 1),   # 256 blocks fill the card already
    (1, 8, 512, 128, 128, 132, 1),    # a short pool: two tiles a split
    (1, 4, 64, 1024, 256, 132, 16),   # D = 256 tiles hold 32 keys
    (1, 1, 16, 4096, 64, 132, 32),
    (2, 2, 1024, 64, 64, 8, 1),
])
def test_wgmma_split_policy(B, NKV, rows, T, D, sms, split):
    """About one 128-row block per SM, at least two key tiles a split."""
    assert wgmma_split_k(B, NKV, rows, T, D, sms) == split


@pytest.mark.parametrize("B,NKV,T,sms,split", [
    (8, 8, 1024, 132, 4),    # the served Llama-3-8B decode: 256 blocks
    (8, 8, 8192, 132, 8),    # an 8192-key chain: 1024 keys a split
    (8, 8, 2048, 132, 4),
    (8, 4, 1024, 132, 8),    # Gemma-2-2B decode: one full cluster
    (1, 8, 1024, 132, 8),    # one slot: capped at a cluster
    (1, 8, 65536, 132, 8),   # a cluster, however long the chain
    (8, 8, 256, 132, 2),     # a short chain: 128 keys a split at least
    (8, 8, 64, 132, 1),
    (32, 8, 1024, 132, 1),   # 256 pairs fill the card without splitting
    (32, 8, 4096, 132, 4),   # but a long chain is still cut
])
def test_decode_split_policy(B, NKV, T, sms, split):
    """About two blocks per SM, no split past DECODE_MAX_KEYS keys where a
    cluster allows, at most one cluster of splits, at least
    DECODE_MIN_KEYS keys a split; the offsets never enter."""
    assert decode_split_k(B, NKV, T, sms) == split


@pytest.mark.parametrize("route,dtype,S,G,err", [
    ("decode", torch.float32, 1, 4, TypeError),    # bf16 q only
    ("decode", torch.bfloat16, 2, 4, ValueError),  # one position a slot
    ("decode", torch.bfloat16, 1, DECODE_MAX_G + 1, ValueError),
    ("wgmma", torch.float32, 4, 4, TypeError),     # bf16 q only
])
def test_forced_route_refuses_what_its_kernel_does_not_take(route, dtype, S,
                                                            G, err):
    """A forced route checks its inputs before any launch."""
    with pytest.raises(err):
        _check_route(route, dtype, S, G)


def _chunk_inputs(seed, B, S, page=16, PP=8, NP=20, nq=8, nkv=2, D=64):
    """bf16 q and pool at chunk widths: slot 0 with kv_start 3 and its
    chunk ending at the last page, slot 1 (B = 2) at offset 40."""
    rs = np.random.RandomState(seed)
    T = PP * page
    q = rs.standard_normal((B, S, nq, D)).astype(np.float32)
    k = rs.standard_normal((NP, page, nkv, D)).astype(np.float32)
    v = rs.standard_normal((NP, page, nkv, D)).astype(np.float32)
    bt = rs.randint(1, NP, size=(B, PP)).astype(np.int32)
    off = np.array([T - S, 40][:B], np.int32)
    start = np.array([3, 0][:B], np.int32)
    return q, (k, v), bt, off, start


@pytest.mark.parametrize("kw", [{}, dict(window=40),
                                dict(softcap=30.0, sm_scale=0.2)])
@pytest.mark.parametrize("S", [2, 32])
@pytest.mark.parametrize("B", [1, 2])
def test_chunk_widths_bf16_match_jax_kernel(B, S, kw):
    """Chunk widths (G = 4: G * S = 8 and 128), bf16 q and pool,
    kv_start, window and softcap: the plain version both CUDA routes are
    held to against the JAX kernel and reference on the same bf16
    inputs."""
    q, pool, bt, off, start = _chunk_inputs(70 + 10 * B + S, B, S)
    tq = torch.from_numpy(q).bfloat16()
    tpool = tuple(torch.from_numpy(p).bfloat16() for p in pool)
    targs = (torch.from_numpy(bt), torch.from_numpy(off),
             torch.from_numpy(start))
    out = paged_attention(tq, tpool, *targs, split_k=2, **kw)
    assert out.dtype == torch.bfloat16
    jq = jnp.asarray(q, jnp.bfloat16)
    jpool = tuple(jnp.asarray(p, jnp.bfloat16) for p in pool)
    jargs = (jnp.asarray(bt), jnp.asarray(off), jnp.asarray(start))
    ker = jax_paged_attention(jq, jpool, *jargs, block_pages=2, split_k=2,
                              interpret=True, **kw)
    ref = jax_paged_reference(jq, jpool, *jargs, **kw)
    got = out.float().numpy()
    np.testing.assert_allclose(got, np.asarray(ker, np.float32),
                               atol=ATOL_BF16)
    np.testing.assert_allclose(got, np.asarray(ref, np.float32),
                               atol=ATOL_BF16)
    assert np.any(got[0] != 0.0)


def test_route_argument_is_checked():
    """Forcing a route names a CUDA kernel: an unknown name, or CPU
    tensors (whose plain version has no routes), raise."""
    q = torch.zeros((1, 1, 2, 8))
    pool = (torch.zeros((2, 4, 2, 8)),) * 2
    bt = torch.zeros((1, 2), dtype=torch.int32)
    off = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="route must be"):
        _paged_attention_on("tensor", q, pool, bt, off)
    with pytest.raises(ValueError, match="CUDA kernel"):
        _paged_attention_on("wgmma", q, pool, bt, off)
    for dtype in (torch.bfloat16, torch.float32):  # the decode route, too
        with pytest.raises(ValueError, match="CUDA kernel"):
            _paged_attention_on("decode", q.to(dtype),
                                tuple(p.to(dtype) for p in pool), bt, off)
