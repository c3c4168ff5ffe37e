"""PyTorch port: serving at tensor-parallel degree 2 on the card.

Needs an NVIDIA GPU (``cuda`` marker) and skips without one.  The file
imports nothing of JAX:

    python -m pytest --noconftest tests/test_torch_cuda_tp.py -m cuda

Two ranks share the one card over gloo (NCCL refuses two ranks on one
device), each holding half of a full-width Llama-3-8B cut to 2 layers:

- every decode step launches the decode kernel at the local heads (16 q
  on 4 kv heads) once a layer, every int8 chunk the wgmma kernel, and
  nothing falls to the plain version or the simt kernel;
- the decode kernel's logits equal the gather path's within 2e-2 (bf16);
- both ranks serve the same tokens and hold the same page tables;
- the prefill logits equal the tp = 1 model's within 2e-2;
- ``cuda_graphs=True`` and a fleet of tp > 1 replicas raise.
"""

import numpy as np
import pytest
import torch

from neuronx_distributed_tpu_torch import (
    InferenceConfig,
    LlamaConfig,
    LlamaForCausalLM,
    ParallelInferenceModel,
)
from neuronx_distributed_tpu_torch.ops import _build
from neuronx_distributed_tpu_torch.utils.distributed import spawn
import torch_tp_workers as workers

pytestmark = pytest.mark.cuda

LAYERS, NEW = 2, 8


@pytest.fixture(scope="module")
def pair():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels and the two ranks' "
                    "pools are CUDA state")
    _build.build_all(["paged_attention"])  # once, before the ranks start
    rs = np.random.RandomState(0)
    prompts = [rs.randint(1, 128256, size=rs.randint(32, 129)).tolist()
               for _ in range(4)]
    ranks = spawn(workers.cuda_pair, 2, (LAYERS, prompts, NEW),
                  timeout_s=600)
    return prompts, ranks


def test_launches_by_route_at_local_heads(pair):
    _, ranks = pair
    for out in ranks:
        assert out["graphs"] is False and out["paged_kernel"] is True
        assert (out["q_heads"], out["kv_heads"]) == (16, 4)
        bf16, int8 = out["runs"]["bf16"], out["runs"]["int8"]
        assert bf16["decode"] == bf16["steps"] * LAYERS > 0
        assert bf16["wgmma"] == bf16["simt"] == 0
        assert int8["decode"] == int8["steps"] * LAYERS > 0
        assert int8["wgmma"] == int8["chunks"] * LAYERS > 0
        assert int8["simt"] == 0


def test_kernel_matches_gather_at_local_heads(pair):
    for out in pair[1]:
        assert out["kernel_vs_gather"] <= 2e-2


def test_ranks_serve_identically(pair):
    a, b = pair[1]
    for label in ("bf16", "int8"):
        assert a["runs"][label]["tokens"] == b["runs"][label]["tokens"]
        np.testing.assert_array_equal(a["runs"][label]["tables"],
                                      b["runs"][label]["tables"])
        assert all(len(t) == NEW for t in a["runs"][label]["tokens"].values())


def test_prefill_logits_match_tp1(pair):
    prompts, ranks = pair
    model = LlamaForCausalLM(LlamaConfig.llama3_8b(num_layers=LAYERS),
                             device="cuda").init_random(0)
    pim = ParallelInferenceModel(model, InferenceConfig(
        4, 128, 256, torch.bfloat16), cuda_graphs=False)
    for i, p in enumerate(prompts):
        ids = np.zeros((1, 128), np.int64)
        ids[0, -len(p):] = p
        valid = (np.arange(128) >= 128 - len(p)).astype(np.int32)[None]
        want = pim.prefill_one(ids, valid)[0].float().cpu().numpy()[0]
        for out in ranks:
            got = out["prefill"][i]
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert rel <= 2e-2, (i, rel)


def test_refusals(pair):
    for out in pair[1]:
        assert "A9a" in out["graphs_refusal"]
        assert "A9d" in out["fleet_refusal"]


def test_fp32_partial_product_has_the_plain_gradients():
    """The row layers' fp32-partial product (``torch.mm(out_dtype=)``,
    which has no derivative of its own) gives the output of the fp32
    product and the gradients of the bf16 product, bit for bit: its
    backward runs the same bf16 products as autograd of ``x @ w``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from neuronx_distributed_tpu_torch.parallel.layers import _matmul_fp32

    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(2, 64, 256, device="cuda", generator=g).bfloat16()
    w = torch.randn(256, 512, device="cuda", generator=g).bfloat16()
    ct = torch.randn(2, 64, 512, device="cuda", generator=g).bfloat16()
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = _matmul_fp32(xa, wa)
    assert y.dtype == torch.float32
    torch.testing.assert_close(y, x.float() @ w.float(), rtol=1e-5,
                               atol=1e-4)
    y.backward(ct.float())
    xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
    (xb @ wb).backward(ct)
    assert torch.equal(xa.grad, xb.grad)
    assert torch.equal(wa.grad, wb.grad)
