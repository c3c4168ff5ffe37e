"""PyTorch port: the paged KV cache's host side against the JAX package.

``kvcache.allocator``/``kvcache.prefix`` are copies in behaviour: page keys
and chain fingerprints must equal the JAX values, and the same randomized
allocate/share/free/evict churn run on both packages in lockstep must hand
out the same page ids and keep both sets of invariants.  The serving-side
``PagedKVManager`` is held to the JAX one the same way.  Pure host code:
exact equality, no tolerance.
"""

import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.kvcache import allocator as jax_alloc
from neuronx_distributed_tpu.kvcache import pool as jax_pool
from neuronx_distributed_tpu.kvcache import prefix as jax_prefix
from neuronx_distributed_tpu.serving.paged import PagedKVManager as JaxKV
from neuronx_distributed_tpu.serving.request import Request as JaxRequest
from neuronx_distributed_tpu_torch.kvcache import allocator, prefix
from neuronx_distributed_tpu_torch.kvcache.pool import PagePool
from neuronx_distributed_tpu_torch.serving.paged import PagedKVManager
from neuronx_distributed_tpu_torch.serving.request import Request


def _row(rs, C, L, vocab=50):
    ids = np.zeros(C, np.int32)
    ids[C - L:] = rs.randint(1, vocab, size=L)
    return ids, (np.arange(C) >= C - L).astype(np.int32)


@pytest.mark.parametrize("salt", [0, 3])
def test_page_keys_and_fingerprints_equal_jax(salt):
    rs = np.random.RandomState(salt)
    for L in (1, 5, 8, 16):
        ids, valid = _row(rs, 16, L)
        keys = prefix.page_keys(ids, valid, 4, salt=salt)
        assert keys == jax_prefix.page_keys(ids, valid, 4, salt=salt)
        assert [prefix.is_padding_key(k) for k in keys] == \
            [jax_prefix.is_padding_key(k) for k in keys]
        assert prefix.prefix_fingerprints(keys) == \
            jax_prefix.prefix_fingerprints(keys)
        assert prefix.chain_fingerprint(7, keys[-1]) == \
            jax_prefix.chain_fingerprint(7, keys[-1])
    with pytest.raises(ValueError, match="multiple"):
        prefix.page_keys(ids[:7], valid[:7], 4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_prefix_churn_lockstep_with_jax(seed):
    """Random lookups, inserts, retains, frees, cows and evictions on both
    packages at once: identical results, invariants after every op."""
    rs = np.random.RandomState(seed)
    pa, ja = allocator.BlockAllocator(24), jax_alloc.BlockAllocator(24)
    pi, ji = prefix.PrefixIndex(pa), jax_prefix.PrefixIndex(ja)
    held = []  # references this "client" holds (same on both sides)
    for step in range(300):
        op = rs.randint(6)
        if op == 0:  # prompt admission: lookup then allocate the rest
            ids, valid = _row(rs, 16, rs.randint(1, 17), vocab=4)
            keys = prefix.page_keys(ids, valid, 4)
            pm, pp = pi.lookup(keys)
            jm, jp = ji.lookup(keys)
            assert pm == jm and pp == jp
            held += [p for p in pm if p]
            need = len(keys) - len(pm)
            if need <= pa.free_count:
                new = pa.alloc(need)
                assert new == ja.alloc(need)
                pages = pm + new
                pi.insert(keys, pages, payload=step)
                ji.insert(keys, pages, payload=step)
                held += new
            else:
                with pytest.raises(allocator.PoolExhausted):
                    pa.alloc(need)
                with pytest.raises(jax_alloc.PoolExhausted):
                    ja.alloc(need)
        elif op == 1 and held:
            p = held.pop(rs.randint(len(held)))
            pa.free(p)
            ja.free(p)
        elif op == 2 and held:
            p = held[rs.randint(len(held))]
            pa.retain(p)
            ja.retain(p)
            held.append(p)
        elif op == 3 and held and pa.free_count:
            i = rs.randint(len(held))
            got = pa.cow(held[i])
            assert got == ja.cow(held[i])
            held[i] = got[0]
        elif op == 4:
            n = rs.randint(1, 4)
            assert pi.evict(n) == ji.evict(n)
        elif op == 5 and held:
            k = rs.randint(len(held) + 1)
            assert pa.free_tail(held[:k]) == ja.free_tail(held[:k])
            held = held[k:]
        assert pa.free_count == ja.free_count and pa.in_use == ja.in_use
        assert pi.evictable_pages() == ji.evictable_pages()
        assert pi.chain_fingerprints() == ji.chain_fingerprints()
        pa.assert_invariants()
        pi.assert_invariants()
    assert pa.cow_copies >= 0 and pi.evictions >= 0
    with pytest.raises(ValueError, match="double free"):
        pa.free(max(set(range(1, 24)) - set(pa._refs)))


@pytest.mark.parametrize("prefix_cache", [True, False])
def test_paged_kv_manager_lockstep_with_jax(prefix_cache):
    """Admissions (with repeated prompts for prefix hits) and releases:
    identical block tables, fresh pages and full-hit payloads."""
    rs = np.random.RandomState(5)
    kw = dict(num_slots=3, context_len=8, max_total_len=16, page_size=4,
              num_pages=14, prefix_cache=prefix_cache)
    pk, jk = PagedKVManager(**kw), JaxKV(**kw)
    prompts = [rs.randint(1, 9, size=rs.randint(1, 9)).tolist()
               for _ in range(4)]
    live = {}
    for step in range(60):
        slot = rs.randint(3)
        if slot in live:
            pk.release_slot(slot)
            jk.release_slot(slot)
            del live[slot]
        else:
            prompt = prompts[rs.randint(len(prompts))]
            new = int(rs.randint(1, 9))
            preq = Request(request_id=step, prompt_ids=prompt,
                           max_new_tokens=new)
            jreq = JaxRequest(request_id=step, prompt_ids=prompt,
                              max_new_tokens=new)
            assert pk.pages_needed(preq) == jk.pages_needed(jreq)
            if pk.pages_needed(preq) > pk.pages_free():
                continue
            ids, valid = np.zeros(8, np.int32), np.zeros(8, np.int32)
            ids[8 - len(prompt):], valid[8 - len(prompt):] = prompt, 1
            p_hit = pk.admit_slot(slot, preq, ids, valid)
            j_hit = jk.admit_slot(slot, jreq, ids, valid)
            assert p_hit == j_hit
            assert pk.fresh_pages(slot) == jk.fresh_pages(slot)
            pk.finish_insert(slot, f"logits{step}")
            jk.finish_insert(slot, f"logits{step}")
            live[slot] = step
        np.testing.assert_array_equal(pk.tables, jk.tables)
        assert pk.pages_free() == jk.pages_free()
        pk.assert_invariants()
    for slot in list(live):
        pk.release_slot(slot)
    pk.assert_invariants()
    assert pk.leaked_pages() == 0
    assert pk.alloc.in_use == 0 or prefix_cache


def test_page_pool_sizing_matches_jax():
    import jax.numpy as jnp

    pool = PagePool(2, 5, 4, 2, 8, dtype=torch.float32, device="cpu")
    assert [tuple(k.shape) for k, _ in pool.caches] == [(5, 4, 2, 8)] * 2
    assert pool.page_bytes == jax_pool.PagePool(
        2, 5, 4, 2, 8, dtype=jnp.float32).page_bytes
    assert PagePool.pages_for_budget(1 << 20, 32, 16, 8, 128) == \
        jax_pool.PagePool.pages_for_budget(1 << 20, 32, 16, 8, 128)
    q8 = PagePool(2, 5, 4, 2, 8, quant="int8", device="cpu")
    assert [tuple(t.shape) for t in q8.caches[0]] == \
        [(5, 4, 2, 8)] * 2 + [(5,)] * 4
    assert [t.dtype for t in q8.caches[0]] == \
        [torch.int8] * 2 + [torch.float32] * 4
    assert q8.page_bytes == jax_pool.PagePool(
        2, 5, 4, 2, 8, quant="int8").page_bytes
    assert PagePool.pages_for_budget(1 << 20, 32, 16, 8, 128,
                                     quant="int8") == \
        jax_pool.PagePool.pages_for_budget(1 << 20, 32, 16, 8, 128,
                                           quant="int8")
    with pytest.raises(ValueError, match="NULL"):
        PagePool(2, 1, 4, 2, 8, device="cpu")
