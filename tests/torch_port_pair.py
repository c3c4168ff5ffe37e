"""The tiny GQA Llama shared by the PyTorch-port parity tests: one JAX
``ParallelInferenceModel`` and one port ``ParallelInferenceModel`` over the
same weights (JAX initialises them; ``convert.llama_params_from_jax`` moves
them), built once per process and batch size."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import linen as nn

from neuronx_distributed_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig,
    LlamaForCausalLM as JaxLlama,
)
from neuronx_distributed_tpu.trace import (
    InferenceConfig as JaxInferenceConfig,
    ParallelInferenceModel as JaxInferenceModel,
)
from neuronx_distributed_tpu_torch.convert import llama_params_from_jax
from neuronx_distributed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from neuronx_distributed_tpu_torch.trace import InferenceConfig, ParallelInferenceModel

C, T = 8, 16

_CACHE: dict = {}


def build_pair(batch_size=3):
    """``(jax wrapper, port wrapper, jax module, jax params, port config)``
    (the JAX wrapper compiles its executables, so it is built once)."""
    if batch_size not in _CACHE:
        jcfg = JaxLlamaConfig.tiny(num_kv_heads=2, dtype=jnp.float32,
                                   param_dtype=jnp.float32,
                                   sequence_parallel=False, remat="none",
                                   max_seq_len=32)
        module = JaxLlama(jcfg)
        params = nn.unbox(module.init(jax.random.PRNGKey(0),
                                      jnp.zeros((batch_size, C), jnp.int32)))
        jpim = JaxInferenceModel(
            module, params, JaxInferenceConfig(
                batch_size=batch_size, context_len=C, max_total_len=T,
                kv_cache_dtype=jnp.float32))
        cfg = LlamaConfig.tiny(num_kv_heads=2, dtype=torch.float32)
        model = LlamaForCausalLM(cfg, device="cpu")
        model.load_state_dict(llama_params_from_jax(
            jax.tree.map(np.asarray, params), cfg))
        tpim = ParallelInferenceModel(
            model, InferenceConfig(batch_size, C, T, torch.float32),
            device="cpu")
        _CACHE[batch_size] = (jpim, tpim, module, params, cfg)
    return _CACHE[batch_size]
