"""PyTorch port: the dense attention core at context-parallel degree > 1,
and Gemma on the zigzag ring, against the JAX package.

At cp > 1 the dense core all-gathers every rank's keys and values over the
cp group (their gradients reduce-scattered back) and masks this rank's
query rows at their global offsets: what GSPMD computes for JAX's dense
core on a sequence cut over cp.  One 4-rank world
(``torch_gemma_pair.run``) holds, at tp = 2 x cp = 2 with sequence
parallelism:

- the tiny Llama's dense core (JAX ``tests/test_attention.py:191``'s
  cell): each rank's logits and its gradients of ``mean(logits ** 2)``,
  summed over cp and SP, against JAX's; in the zigzag layout (ids and
  positions in ``zigzag_permute`` order, each half chunk masked at its own
  offset) the chunks, put back in order, give the same;
- Gemma-2 trained on the dense core (JAX's default core) and Gemma-1 on
  the flash path's zigzag ring, 3 steps each against JAX's train step.
"""

import numpy as np
import pytest

import torch_gemma_pair as pair
from neuronx_distributed_tpu_torch.convert import shard_params_for_rank
from neuronx_distributed_tpu_torch.ops.ring_attention import zigzag_unpermute

NAMES = ("gemma2_cp2_dense", "gemma_cp2_zigzag")
DENSE = ("llama_dense_cp2", "llama_dense_cp2_zigzag")


@pytest.fixture(scope="module")
def world():
    def dense(zigzag):
        def make(trees, rs):
            ids = np.random.RandomState(5).randint(
                0, 256, (2, pair.S)).astype(np.int32)
            return pair.llama_dense_case(ids, zigzag)
        return make

    return pair.run(NAMES, forward=[dense(False), dense(True)], seed=2)


@pytest.mark.parametrize("name", NAMES)
def test_training_on_the_dense_core_and_zigzag_matches_jax(world, name):
    pair.check_training(*world, name)


def test_gemma2_dense_cp_loss_is_softcapped(world):
    pair.check_capped_loss(*world, "gemma2_cp2_dense")


@pytest.mark.parametrize("name", DENSE)
def test_dense_core_at_cp2_matches_jax(world, name):
    want, ranks = world
    ref = want[name]
    chunks = {}
    for r in ranks:
        got = r[name]
        chunks[got["cp"][1]] = got["logits"]
        # k and v a layer, 2 layers; the backward's reduce-scatters
        assert got["counts"]["cp_all_gather"] == 2 * 2
        assert got["counts"]["cp_reduce_scatter"] == 2 * 2
        cut = pair.flat(shard_params_for_rank(ref["grads"], 2, got["tp"][1]))
        assert set(cut) == set(got["grads"])
        for n, g in got["grads"].items():
            np.testing.assert_allclose(g, cut[n], rtol=2e-3, atol=2e-5,
                                       err_msg=n)
    logits = np.concatenate([chunks[0], chunks[1]], axis=1)
    if name.endswith("zigzag"):
        logits = np.asarray(zigzag_unpermute(logits, 2, axis=1))
    np.testing.assert_allclose(logits, ref["logits"], rtol=2e-4, atol=2e-4)
