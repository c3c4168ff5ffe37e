"""PyTorch port: the resource ledgers and the perf attribution on the card.

Every test needs an NVIDIA GPU (``cuda`` marker) and skips without one.
The file imports nothing of JAX:

    python -m pytest --noconftest tests/test_torch_cuda_ledgers.py -m cuda

- The memory ledger's device truth: ``poll_device`` reads the caching
  allocator (a tensor's bytes show in ``device_bytes_in_use``) and the
  driver (free and total), and the remainder is the allocated bytes no
  subsystem accounts for.
- ``device_spec`` maps an H100 SXM card to 989e12 / 3.35e12 and raises
  naming any other card.
- A phase-graph capture under a compile ledger books one ``cuda_graph``
  row whose cost is the counter's over the eager first call (the decode
  kernel's declared pages included, nothing counted during the capture),
  and replays are cache hits.
"""

import pytest
import torch

from neuronx_distributed_tpu_torch import (
    InferenceConfig,
    LlamaConfig,
    LlamaForCausalLM,
    ParallelInferenceModel,
)
from neuronx_distributed_tpu_torch.obs import CompileLedger, MemoryLedger
from neuronx_distributed_tpu_torch.obs.perf import device_spec
from neuronx_distributed_tpu_torch.ops.paged_attention import (
    paged_attention_cost,
)
from neuronx_distributed_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the allocator statistics and the "
                    "CUDA graphs have no CPU mode")
    return torch.device("cuda")


def test_memory_ledger_polls_the_allocator(dev):
    led = MemoryLedger(device=dev)
    before = led.poll_device()["device_bytes_in_use"]
    x = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    led.set("params", x.numel())
    d = led.poll_device()
    assert d["device_bytes_in_use"] >= before + x.numel()
    assert 0 < d["device_free_bytes"] <= d["device_bytes_limit"]
    assert d["device_peak_bytes"] >= d["device_bytes_in_use"]
    assert led.remainder_bytes == d["device_bytes_in_use"] - x.numel()
    assert led.headroom_bytes() >= d["device_free_bytes"]
    assert led.breakdown()["device"] == d
    del x


def test_device_spec_matches_only_the_h100_sxm(dev):
    name = torch.cuda.get_device_name(dev)
    if name.lower() == "nvidia h100 80gb hbm3":
        spec = device_spec(dev)
        assert (spec.peak_flops, spec.hbm_bytes_per_s) == (989e12, 3.35e12)
    else:
        with pytest.raises(ValueError, match=name.lower()):
            device_spec(dev)


def test_capture_cost_under_the_counter(dev):
    from neuronx_distributed_tpu_torch.ops import _build

    _build.build_all(["paged_attention"])
    cfg = LlamaConfig.tiny(num_kv_heads=2, dtype=torch.bfloat16,
                           head_dim=128)
    model = LlamaForCausalLM(cfg, device=dev).init_random(0)
    led = CompileLedger()
    pim = ParallelInferenceModel(model, InferenceConfig(2, 16, 32),
                                 device=dev, compile_ledger=led)
    pool = pim.make_page_pool(9, 16)
    valid = torch.zeros((2, 32), dtype=torch.int32, device=dev)
    valid[:, 10:17] = 1
    bt = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32, device=dev)
    off = torch.tensor([16, 16], dtype=torch.int32, device=dev)
    tok = torch.ones((2, 1), dtype=torch.long, device=dev)
    for _ in range(3):
        pim.decode_pages(tok, off, bt, pool.caches, valid)
    torch.cuda.synchronize()
    rows = [r for r in led.rows if r["event"] == "compile"]
    assert len(rows) == pim.graphs.captures == 1
    assert rows[0]["kind"] == "cuda_graph" and rows[0]["family"] == \
        "decode_pages"
    assert led.cache_hits == 2 and pim.graphs.replays == 2
    # the kernel's declared pages are inside the row's bytes, one layer
    # each (q [2, 1, NQ, D] at the offsets the first call saw)
    q = torch.zeros((2, 1, cfg.num_heads, 128), dtype=torch.bfloat16,
                    device=dev)
    kstart = torch.tensor([10, 10], dtype=torch.int32, device=dev)
    fl, by = paged_attention_cost(q, pool.caches[0], bt, off, kstart)
    assert rows[0]["flops"] >= cfg.num_layers * fl > 0
    assert rows[0]["bytes_accessed"] >= cfg.num_layers * by > 0
    assert profiling.ACTIVE is None
