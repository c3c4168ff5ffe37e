"""Weight conversion into and out of the PyTorch port: JAX param trees
(``jax_params``), Hugging Face state dicts and files (``hf``), and the
reference's per-rank checkpoints (``nxd``)."""

from neuronx_distributed_tpu_torch.convert.hf import (
    bert_params_from_hf,
    bert_params_to_hf,
    gemma2_params_from_hf,
    gemma2_params_to_hf,
    gemma_params_from_hf,
    gemma_params_to_hf,
    gpt_neox_params_from_hf,
    gpt_neox_params_from_pipelined,
    gpt_neox_params_to_hf,
    llama_params_from_hf,
    llama_params_from_pipelined,
    llama_params_to_hf,
    llama_stack_layers,
    llama_unstack_layers,
    load_hf_state_dict,
    mistral_params_from_hf,
    mistral_params_to_hf,
    read_safetensors,
    save_hf_state_dict,
    write_safetensors,
)
from neuronx_distributed_tpu_torch.convert.jax_params import (
    bert_params_from_jax,
    ep_shard_for_rank,
    fsdp_shard_for_rank,
    gemma2_params_from_jax,
    gemma_params_from_jax,
    gpt_neox_params_from_jax,
    llama_params_from_jax,
    pipelined_grads_from_jax,
    pipelined_params_from_jax,
    shard_dim,
    shard_params_for_rank,
    tp_cut,
    zero1_shard_for_rank,
)
from neuronx_distributed_tpu_torch.convert.nxd import (
    GPT_NEOX_TP_RULES,
    LLAMA_TP_RULES,
    fuse_split_llama,
    load_nxd_checkpoint,
    merge_tp_shards,
    save_nxd_checkpoint,
    shard_for_rank,
    split_fused_llama,
)

__all__ = [
    # the reference's checkpoints
    "GPT_NEOX_TP_RULES", "LLAMA_TP_RULES", "fuse_split_llama",
    "load_nxd_checkpoint", "merge_tp_shards", "save_nxd_checkpoint",
    "shard_for_rank", "split_fused_llama",
    # Hugging Face
    "bert_params_from_hf", "bert_params_to_hf", "gemma_params_from_hf",
    "gemma_params_to_hf", "gemma2_params_from_hf", "gemma2_params_to_hf",
    "gpt_neox_params_from_hf", "gpt_neox_params_from_pipelined",
    "gpt_neox_params_to_hf", "llama_params_from_hf",
    "llama_params_from_pipelined", "llama_params_to_hf",
    "llama_stack_layers", "llama_unstack_layers", "load_hf_state_dict",
    "mistral_params_from_hf", "mistral_params_to_hf", "read_safetensors",
    "save_hf_state_dict", "write_safetensors",
    # JAX param trees
    "bert_params_from_jax", "ep_shard_for_rank", "fsdp_shard_for_rank",
    "gemma2_params_from_jax", "gemma_params_from_jax",
    "gpt_neox_params_from_jax", "llama_params_from_jax",
    "pipelined_grads_from_jax", "pipelined_params_from_jax", "shard_dim",
    "shard_params_for_rank", "tp_cut", "zero1_shard_for_rank",
]
