"""Weight conversion into the PyTorch port."""

from neuronx_distributed_tpu_torch.convert.jax_params import llama_params_from_jax

__all__ = ["llama_params_from_jax"]
