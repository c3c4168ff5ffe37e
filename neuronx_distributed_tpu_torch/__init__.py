"""neuronx_distributed_tpu_torch -- the PyTorch/CUDA port of
``neuronx_distributed_tpu``, for one NVIDIA H100.

Slice 1 is paged continuous-batching serving of Llama: the model
(:mod:`.models.llama`), the inference engine (:mod:`.trace.engine`), the
paged KV cache (:mod:`.kvcache`), the serving engine (:mod:`.serving`) and
the hand-written CUDA paged-attention kernel (:mod:`.ops.paged_attention`).
Slice 2 is the Llama training step at every parallel degree 1: the config
(:mod:`.config`), the losses and remat (:mod:`.models.common`), AdamW and
its schedules (:mod:`.optimizer`), gradient clipping
(:mod:`.parallel.grads`), the trainer (:mod:`.trainer`) and the
hand-written CUDA flash-attention forward, dq and dk/dv kernels
(:mod:`.ops.flash_attention`).  Slice 3 adds int8 KV pages
(:mod:`.kvcache.quant`, ``ServingEngine(kv_quant="int8")``, the kernel's
int8 dequant branch) and chunked prefill
(``ServingEngine(prefill_chunk_tokens=...)``).  Slice 4 adds Gemma and
Gemma-2 (:mod:`.models.gemma`: Gemma-2-2B trains and serves through the
same entry points) and the flash kernels at head_dim 256.  Serving decodes
asynchronously, replays its per-step phase functions from CUDA graphs on
the card (``ParallelInferenceModel(cuda_graphs=...)``) and serves
draft-k-verify speculative decoding (``ServingEngine(draft=, spec_k=)``,
:func:`.trace.speculative_generate`), and serves many LoRA adapters
through the same phase functions (:mod:`.tenancy`,
``ServingEngine(adapter_store=)``; :mod:`.peft`).  Its scheduler serves
interactive ahead of batch requests, preempting batch requests with
resumable page chains, shedding dead deadlines and rate-limiting tenants;
:mod:`.resilience` holds the fault-injection plane threaded through
serving and the restart-on-crash supervisor.  :mod:`.obs` is the
observability core (metrics registry, artifact schemas, flight ring,
request tracer, transfer audit, metrics server) the serving engine
reports through, in the JAX package's artifact formats.  The serving
fleet (:mod:`.serving.fleet`) puts engine replicas behind one router:
routing policies, zero-loss failover, prefill/decode disaggregation with
KV page-chain transfer (:mod:`.kvcache.transfer`), live weight swaps and
rolling updates (:mod:`.weights`) and the alert-driven autopilot.  The port
imports ``torch`` and nothing of JAX or of the JAX package.  Entry points
run on the card unless the caller passes ``device="cpu"``.
"""

from neuronx_distributed_tpu_torch.config import TrainingConfig, training_config
from neuronx_distributed_tpu_torch.kvcache import PagePool
from neuronx_distributed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from neuronx_distributed_tpu_torch.ops.flash_attention import flash_attention
from neuronx_distributed_tpu_torch.ops.paged_attention import paged_attention
from neuronx_distributed_tpu_torch.serving import Request, SamplingParams, ServingEngine
from neuronx_distributed_tpu_torch.trace import InferenceConfig, ParallelInferenceModel
from neuronx_distributed_tpu_torch.trainer import (
    initialize_parallel_model,
    initialize_parallel_optimizer,
    make_train_step,
)
from neuronx_distributed_tpu_torch.utils.device import resolve_device
from neuronx_distributed_tpu_torch.version import __version__

__all__ = [
    "InferenceConfig",
    "LlamaConfig",
    "LlamaForCausalLM",
    "PagePool",
    "ParallelInferenceModel",
    "Request",
    "SamplingParams",
    "ServingEngine",
    "TrainingConfig",
    "__version__",
    "flash_attention",
    "initialize_parallel_model",
    "initialize_parallel_optimizer",
    "make_train_step",
    "paged_attention",
    "resolve_device",
    "training_config",
]
