"""PyTorch port: the Llama model and the inference engine against the JAX
package.

One tiny GQA Llama (``LlamaConfig.tiny(num_kv_heads=2)``, fp32, 2 layers)
is initialised by JAX; ``convert.llama_params_from_jax`` moves the same
weights into the port.  Seeded numpy inputs then go through both: the full
forward, ``prefill_one``, four paged ``decode_pages`` steps over the same
pool on the kernel-flag path and the gather path, the contiguous per-slot
decode, and the solo ``generate``.  Tolerance: atol 1e-4 on logits (fp32
on both sides; XLA and PyTorch sum the matmuls in different orders);
greedy tokens must be identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu_torch.convert import llama_params_from_jax
from neuronx_distributed_tpu_torch.models.llama import (
    LlamaConfig,
    apply_rope,
    llama3_scale_freqs,
    rope_sin_cos,
)
from torch_port_pair import C, T, build_pair

ATOL = 1e-4
B, PAGE = 3, 4
NUM_PAGES = 16


def _prompt(rs, vocab, L):
    ids = np.zeros((1, C), np.int32)
    ids[0, C - L:] = rs.randint(1, vocab, size=L)
    valid = (np.arange(C) >= C - L).astype(np.int32)[None]
    return ids, valid


def test_full_forward_logits():
    _, tpim, module, params, cfg = build_pair()
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, size=(2, C))
    ref = np.asarray(module.apply(params, jnp.asarray(ids)))
    out = tpim.module(torch.from_numpy(ids).long()).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_prefill_one_logits_and_caches():
    jpim, tpim, _, _, cfg = build_pair()
    ids, valid = _prompt(np.random.RandomState(1), cfg.vocab_size, 5)
    jl, jc = jpim.prefill_one(jnp.asarray(ids), jnp.asarray(valid))
    tl, tc = tpim.prefill_one(ids, valid)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    # only the written (valid) prompt positions carry meaning
    for (jk, jv), (tk, tv) in zip(jc, tc):
        np.testing.assert_allclose(tk[0, C - 5:C].numpy(),
                                   np.asarray(jk)[0, C - 5:C], atol=ATOL)
        np.testing.assert_allclose(tv[0, C - 5:C].numpy(),
                                   np.asarray(jv)[0, C - 5:C], atol=ATOL)


@pytest.mark.parametrize("paged_kernel", [False, True])
def test_decode_pages_four_steps(paged_kernel):
    """Two prompts prefilled into a shared pool (slot 1 parked), four paged
    decode steps on both sides; logits and the written pool must agree."""
    jpim, tpim, _, _, cfg = build_pair()
    rs = np.random.RandomState(2)
    jcaches = jpim.make_page_pool(NUM_PAGES, PAGE).caches
    tcaches = tpim.make_page_pool(NUM_PAGES, PAGE).caches
    jvalid = jnp.zeros((B, T), jnp.int32)
    tvalid = torch.zeros((B, T), dtype=torch.int32)
    table = np.zeros((B, T // PAGE), np.int32)
    table[0] = [1, 2, 3, 4]
    table[2] = [5, 6, 7, 8]
    toks = np.zeros((B, 1), np.int32)
    for slot, L in ((0, 6), (2, 3)):
        ids, valid = _prompt(rs, cfg.vocab_size, L)
        row_valid = np.concatenate([valid, np.zeros((1, T - C), np.int32)], 1)
        jl, jrow = jpim.prefill_one(jnp.asarray(ids), jnp.asarray(valid))
        tl, trow = tpim.prefill_one(ids, valid)
        for lp in range(C // PAGE):
            jcaches = jpim.write_page(jcaches, jrow, lp, table[slot, lp])
            tcaches = tpim.write_page(tcaches, trow, lp, table[slot, lp])
        jvalid = jpim.insert_valid(jvalid, jnp.asarray(row_valid), slot)
        tvalid = tpim.insert_valid(tvalid, row_valid, slot)
        toks[slot, 0] = int(np.argmax(np.asarray(jl)[0]))
        assert int(torch.argmax(tl[0])) == toks[slot, 0]
    offsets = np.array([C, T, C], np.int32)  # slot 1 parked
    for _ in range(4):
        jl, jcaches, jvalid = jpim.decode_pages(
            jnp.asarray(toks), jnp.asarray(offsets), jnp.asarray(table),
            jcaches, jvalid, paged_kernel=paged_kernel)
        tl, tcaches, tvalid = tpim.decode_pages(
            toks, offsets, table, tcaches, tvalid, paged_kernel=paged_kernel)
        live = [0, 2]
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   atol=ATOL)
        toks = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)[:, None]
        assert (tl.numpy()[live].argmax(-1) == toks[live, 0]).all()
        offsets[live] += 1
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    # the copy-on-write device half: duplicate a written page
    jcaches = jpim.copy_page(jcaches, 2, 9)
    tcaches = tpim.copy_page(tcaches, 2, 9)
    for (jk, jv), (tk, tv) in zip(jcaches, tcaches):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)
        assert torch.equal(tk[9], tk[2]) and torch.equal(tv[9], tv[2])


def test_decode_slots_contiguous():
    """insert_slot + per-slot masked-write decode over contiguous caches."""
    jpim, tpim, _, _, cfg = build_pair()
    rs = np.random.RandomState(3)
    jcaches, tcaches = jpim.empty_caches(), tpim.empty_caches()
    jvalid = jnp.zeros((B, T), jnp.int32)
    tvalid = torch.zeros((B, T), dtype=torch.int32)
    toks = np.zeros((B, 1), np.int32)
    for slot, L in ((0, 7), (1, 2)):
        ids, valid = _prompt(rs, cfg.vocab_size, L)
        row_valid = np.concatenate([valid, np.zeros((1, T - C), np.int32)], 1)
        jl, jrow = jpim.prefill_one(jnp.asarray(ids), jnp.asarray(valid))
        _, trow = tpim.prefill_one(ids, valid)
        jcaches, jvalid = jpim.insert_slot(jcaches, jrow, jvalid,
                                           jnp.asarray(row_valid), slot)
        tcaches, tvalid = tpim.insert_slot(tcaches, trow, tvalid, row_valid,
                                           slot)
        toks[slot, 0] = int(np.argmax(np.asarray(jl)[0]))
    offsets = np.array([C, C, T], np.int32)
    for _ in range(3):
        jl, jcaches, jvalid = jpim.decode_slots(
            jnp.asarray(toks), jnp.asarray(offsets), jcaches, jvalid)
        tl, tcaches, tvalid = tpim.decode_slots(toks, offsets, tcaches, tvalid)
        np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2],
                                   atol=ATOL)
        toks = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)[:, None]
        offsets[:2] += 1


def test_generate_greedy_tokens_identical():
    jpim, tpim, _, _, cfg = build_pair()
    rs = np.random.RandomState(4)
    lens = np.array([8, 5, 2], np.int32)
    ids = np.zeros((B, C), np.int32)
    for b, L in enumerate(lens):
        ids[b, C - L:] = rs.randint(1, cfg.vocab_size, size=L)
    ref = np.asarray(jpim.generate(jnp.asarray(ids), 6,
                                   prompt_lens=jnp.asarray(lens)))
    out = tpim.generate(ids, 6, prompt_lens=lens).numpy()
    np.testing.assert_array_equal(out, ref)


def test_rope_matches_jax():
    from neuronx_distributed_tpu.models import llama as jl

    pos = np.arange(40, dtype=np.int32).reshape(2, 20)
    x = np.random.RandomState(5).standard_normal((2, 20, 3, 16)).astype(np.float32)
    for scaling in (None, (8.0, 1.0, 4.0, 64)):
        js, jc = jl.rope_sin_cos(jnp.asarray(pos), 16, 500000.0, scaling)
        ts, tc = rope_sin_cos(torch.from_numpy(pos), 16, 500000.0, scaling)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
        np.testing.assert_allclose(
            apply_rope(torch.from_numpy(x), ts, tc).numpy(),
            np.asarray(jl.apply_rope(jnp.asarray(x), js, jc)), atol=1e-5)
    inv = 1.0 / (500000.0 ** (np.arange(0, 128, 2, dtype=np.float32) / 128))
    np.testing.assert_allclose(
        llama3_scale_freqs(torch.from_numpy(inv), 8.0).numpy(),
        np.asarray(jl.llama3_scale_freqs(jnp.asarray(inv), 8.0)), rtol=1e-6)


def test_converter_rejects_mismatched_tree():
    _, _, _, params, cfg = build_pair()
    tree = jax.tree.map(np.asarray, params)
    with pytest.raises(ValueError, match="does not fit"):
        llama_params_from_jax(tree, LlamaConfig.tiny(num_kv_heads=2,
                                                     num_layers=3))
    bad = LlamaConfig.tiny(num_kv_heads=4)
    with pytest.raises(ValueError, match="shape"):
        llama_params_from_jax(tree, bad)
