"""PyTorch port: ``ops.paged_attention`` against the JAX package.

The same seeded numpy inputs go through the JAX Pallas kernel (interpret
mode on the CPU), the JAX dense reference, and the port's
``paged_attention`` -- on CPU tensors the port runs its plain version,
split-K partials and logsumexp merge included.  Tolerance: atol 1e-5 in
fp32 (three fp32 implementations of one softmax, summed in different
orders).  The CUDA kernel itself is checked on the card by
``tests/test_torch_cuda_kernels.py``.
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
    merge_splits,
    paged_attention,
    paged_attention_reference,
    resolve_paged_kernel,
)

ATOL = 1e-5


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
@pytest.mark.parametrize("nq,nkv", [(8, 8), (8, 2), (4, 1)])
def test_matches_jax_kernel_and_reference(nq, nkv, S, split_k):
    """MHA/GQA/MQA, decode and verify-width rows, ragged offsets, a parked
    slot, non-zero kv_start, with and without split-K."""
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
