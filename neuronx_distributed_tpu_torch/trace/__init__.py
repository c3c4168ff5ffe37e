"""Inference engine of the PyTorch port."""

from neuronx_distributed_tpu_torch.trace.engine import (
    SPEC_ACCEPT_SALT,
    SPEC_RESIDUAL_SALT,
    InferenceConfig,
    ParallelInferenceModel,
    PhaseGraphs,
    init_kv_caches,
    pack_tokens,
    propose_rows,
    request_key,
    sample_rows,
    speculative_generate,
    token_generator,
)
from neuronx_distributed_tpu_torch.trace.export import (
    LoadedInferenceModel,
    parallel_model_load,
    parallel_model_save,
)

__all__ = ["SPEC_ACCEPT_SALT", "SPEC_RESIDUAL_SALT", "InferenceConfig",
           "LoadedInferenceModel", "ParallelInferenceModel", "PhaseGraphs",
           "init_kv_caches", "parallel_model_load", "parallel_model_save",
           "pack_tokens", "propose_rows", "request_key", "sample_rows",
           "speculative_generate", "token_generator"]
