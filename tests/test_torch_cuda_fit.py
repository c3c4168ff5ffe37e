"""PyTorch port: ``fit()`` on the card.

Needs an NVIDIA GPU (``cuda`` marker) and skips without one.  The file
imports nothing of JAX:

    python -m pytest --noconftest tests/test_torch_cuda_fit.py -m cuda

A Llama of 2 narrow layers with the flash core, bf16 compute and fp32
masters, selective remat:

- ``prefetch=2`` with deferred metrics under ``transfer_guard="forbid"``
  (``torch.cuda.set_sync_debug_mode("error")`` around every step) raises
  no sync error, and its losses equal a synchronous run's to the bit;
- a run stopped after 3 steps with its final checkpoint, then resumed to
  6, equals the uninterrupted 6-step run's losses to the bit;
- the flash kernels ran: B1 twice a layer a step under remat, B2 and B3
  once.
"""

import numpy as np
import pytest
import torch

from neuronx_distributed_tpu_torch.config import training_config
from neuronx_distributed_tpu_torch.models.common import make_causal_lm_loss_sum
from neuronx_distributed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from neuronx_distributed_tpu_torch.ops import _build
from neuronx_distributed_tpu_torch.ops import flash_attention as flash
from neuronx_distributed_tpu_torch.trainer import (
    fit,
    initialize_parallel_model,
    initialize_parallel_optimizer,
)

pytestmark = pytest.mark.cuda

LAYERS, S = 2, 512


@pytest.fixture(scope="module", autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash kernels and the staged "
                    "batches are CUDA state")
    _build.build_all(["flash_attention"])


def data(step):
    ids = np.random.RandomState(step).randint(0, 32000, (2, S)).astype(
        np.int32)
    return {"ids": ids, "labels": np.roll(ids, -1, axis=1)}


def run(steps, **kw):
    config = training_config(learning_rate=1e-4, warmup_steps=2,
                             lr_schedule="cosine", total_steps=8, seed=0,
                             compute_dtype="bfloat16",
                             param_dtype="float32")
    cfg = LlamaConfig(vocab_size=32000, hidden_size=1024,
                      intermediate_size=2048, num_layers=LAYERS,
                      num_heads=8, num_kv_heads=4, max_seq_len=S,
                      attention_impl="flash", remat="selective",
                      dtype=torch.bfloat16, param_dtype=torch.float32)
    model = initialize_parallel_model(
        config, lambda d: LlamaForCausalLM(cfg, device=d))
    opt = initialize_parallel_optimizer(config, model)
    losses = []
    res = fit(config, model, opt, data, steps=steps,
              loss_fn=make_causal_lm_loss_sum(256), log_every=0,
              on_step=lambda s, m: losses.append((s, m["loss"])), **kw)
    return losses, res


def test_prefetch_deferred_forbid_equals_sync():
    sync, _ = run(6)
    for k in ("fwd", "dq", "dkv"):
        getattr(flash, f"flash_attention_{k}").launches = 0
    fast, res = run(6, prefetch=2, defer_metrics=True,
                    transfer_guard="forbid")
    assert fast == sync and res.steps_run == 6
    assert flash.flash_attention_fwd.launches == 6 * LAYERS * 2
    assert flash.flash_attention_dq.launches == 6 * LAYERS
    assert flash.flash_attention_dkv.launches == 6 * LAYERS
    assert torch.cuda.get_sync_debug_mode() == 0


def test_resume_identity(tmp_path):
    full, _ = run(6)
    ck = str(tmp_path / "ck")
    first, _ = run(3, ckpt_dir=ck, ckpt_every=100)
    rest, res = run(6, ckpt_dir=ck, resume=True, prefetch=2)
    assert res.start_step == 3
    assert first + rest == full
