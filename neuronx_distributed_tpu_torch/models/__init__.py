"""Model families of the PyTorch port."""

from neuronx_distributed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

__all__ = ["LlamaConfig", "LlamaForCausalLM"]
