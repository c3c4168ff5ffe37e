"""PyTorch port: Gemma and Gemma-2 trained at tensor-parallel degree 2
with sequence parallelism, against the JAX package (the cell of JAX
``tests/test_gemma.py:90``, with Gemma-2 beside it).

One 4-rank world (``torch_gemma_pair.run``) trains, at tp = 2 x dp = 2,
Gemma-1 on the mean loss and Gemma-2 on the chunked loss head (its tied
head softcapped a chunk at a time), 3 steps each against JAX's train step,
and holds Gemma-2's tp = 2 logits, cacheless and cached (what the serving
engine reads through ``gather_logits``), against JAX's: the final softcap
applied once, in ``head``, at every tp.
"""

import numpy as np
import pytest

import torch_gemma_pair as pair

NAMES = ("gemma_tp2_sp", "gemma2_tp2_sp")


@pytest.fixture(scope="module")
def world():
    def logits(trees, rs):
        ids = rs.randint(0, 256, (2, pair.S)).astype(np.int32)
        return pair.gemma2_logits_case(trees["gemma2_tp2_sp"], ids)

    return pair.run(NAMES, forward=[logits])


@pytest.mark.parametrize("name", NAMES)
def test_gemma_sequence_parallel_training_matches_jax(world, name):
    pair.check_training(*world, name)


def test_gemma2_loss_at_tp2_is_softcapped(world):
    """Gemma-2's head caps its vocab slice: the first-step loss at tp = 2
    is JAX's capped loss (the head returned uncapped slices before, and
    the uncapped loss lies far outside the bound)."""
    pair.check_capped_loss(*world, "gemma2_tp2_sp")


def test_gemma_norms_are_sequence_parallel(world):
    """Under SP every norm weight (two a Gemma block, four a Gemma-2
    block, and the final norm) is marked, so its gradient joins the one
    coalesced SP sum; the tied table and the projections are not."""
    _, ranks = world
    for name, per_block in (("gemma_tp2_sp", 2), ("gemma2_tp2_sp", 4)):
        marked = ranks[0][name]["sp_marked"]
        assert len(marked) == 2 * per_block + 1
        assert all(n.endswith("norm.weight") for n in marked), marked
        assert "final_norm.weight" in marked


def test_gemma2_served_logits_capped_once(world):
    """Gemma-2 at tp = 2: the cacheless forward and the cached one give
    JAX's logits after ``gather_logits``, which only joins the slices."""
    want, ranks = world
    ref = want["gemma2_tp2_logits"]["logits"]
    assert np.abs(ref).max() < pair.CAP["final_softcap"]
    for r in ranks:
        got = r["gemma2_tp2_logits"]
        np.testing.assert_allclose(got["logits"], ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["cached_logits"], ref, rtol=1e-5,
                                   atol=1e-5)
