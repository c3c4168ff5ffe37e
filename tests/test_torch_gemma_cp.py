"""PyTorch port: Gemma-2 trained at tensor-parallel degree 2 x
context-parallel degree 2 on the flash path, against the JAX package.

One 4-rank world (``torch_gemma_pair.run``) trains Gemma-2 with sequence
parallelism, 3 steps each against JAX's train step at the same mesh:

- on the contiguous ring: the even (sliding) layers on the window
  schedule at W = C = 16, where rank 0's wrapped left block holds future
  tokens and must contribute nothing (JAX ``tests/test_swa.py:163,
  :190``), the odd (global) layers on the full ring, the attention
  softcap riding every chunk call, under selective remat;
- on ulysses with 8 q / 4 kv heads: 2 q / 1 kv heads a rank once tp and
  cp have cut them (the GQA group kept whole).

The same world holds what stays refused at cp > 1: an MoE block, and a
forward with KV caches (serving).
"""

import pytest

import torch_gemma_pair as pair

NAMES = ("gemma2_cp2_ring", "gemma2_cp2_ulysses")


@pytest.fixture(scope="module")
def world():
    return pair.run(NAMES, refusals=True, seed=1)


@pytest.mark.parametrize("name", NAMES)
def test_gemma2_context_parallel_training_matches_jax(world, name):
    pair.check_training(*world, name)


def test_ring_calls_and_exchanges(world):
    """A step's ring traffic at cp = 2: the window layer one exchange
    forward, again in the selective remat's recompute, and one back; the
    global layer one forward, again in the recompute, then one kv and two
    dk/dv sends backward; ulysses all-to-alls and no sends."""
    _, ranks = world
    for r in ranks:
        ring = r["gemma2_cp2_ring"]["counts"][0]
        assert ring["cp_send"] == (1 + 1 + 1) + (1 + 1 + 1 + 2)
        assert "all_to_all" not in ring
        uly = r["gemma2_cp2_ulysses"]["counts"][0]
        assert uly["all_to_all"] == 2 * 8 and "cp_send" not in uly


def test_refusals_that_stay_at_cp2(world):
    """MoE and serving (KV caches) at cp > 1 still raise, naming why."""
    _, ranks = world
    for r in ranks:
        assert "routing set would span" in r["refused"]["moe"]
        assert "serving at cp > 1" in r["refused"]["serving"]
