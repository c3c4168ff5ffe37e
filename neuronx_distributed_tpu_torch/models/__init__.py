"""Model families of the PyTorch port."""

from neuronx_distributed_tpu_torch.models.gemma import (
    Gemma2Config,
    Gemma2ForCausalLM,
    GemmaConfig,
    GemmaForCausalLM,
)
from neuronx_distributed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

__all__ = ["Gemma2Config", "Gemma2ForCausalLM", "GemmaConfig",
           "GemmaForCausalLM", "LlamaConfig", "LlamaForCausalLM"]
