"""Weight conversion into the PyTorch port."""

from neuronx_distributed_tpu_torch.convert.jax_params import (
    bert_params_from_jax,
    gemma2_params_from_jax,
    gemma_params_from_jax,
    gpt_neox_params_from_jax,
    llama_params_from_jax,
    shard_dim,
    shard_params_for_rank,
    zero1_shard_for_rank,
)

__all__ = ["bert_params_from_jax", "gemma2_params_from_jax",
           "gemma_params_from_jax", "gpt_neox_params_from_jax",
           "llama_params_from_jax", "shard_dim", "shard_params_for_rank",
           "zero1_shard_for_rank"]
