"""neuronx_distributed_tpu_torch -- the PyTorch/CUDA port of
``neuronx_distributed_tpu``, for one NVIDIA H100.

Slice 1 is paged continuous-batching serving of Llama: the model
(:mod:`.models.llama`), the inference engine (:mod:`.trace.engine`), the
paged KV cache (:mod:`.kvcache`), the serving engine (:mod:`.serving`) and
the hand-written CUDA paged-attention kernel (:mod:`.ops.paged_attention`).
The port imports ``torch`` and nothing of JAX or of the JAX package.  Entry
points run on the card unless the caller passes ``device="cpu"``.
"""

from neuronx_distributed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from neuronx_distributed_tpu_torch.ops.paged_attention import paged_attention
from neuronx_distributed_tpu_torch.serving import Request, SamplingParams, ServingEngine
from neuronx_distributed_tpu_torch.trace import InferenceConfig, ParallelInferenceModel
from neuronx_distributed_tpu_torch.utils.device import resolve_device
from neuronx_distributed_tpu_torch.version import __version__

__all__ = [
    "InferenceConfig",
    "LlamaConfig",
    "LlamaForCausalLM",
    "ParallelInferenceModel",
    "Request",
    "SamplingParams",
    "ServingEngine",
    "__version__",
    "paged_attention",
    "resolve_device",
]
