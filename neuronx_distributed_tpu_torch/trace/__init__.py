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

__all__ = ["SPEC_ACCEPT_SALT", "SPEC_RESIDUAL_SALT", "InferenceConfig",
           "ParallelInferenceModel", "PhaseGraphs", "init_kv_caches",
           "pack_tokens", "propose_rows", "request_key", "sample_rows",
           "speculative_generate", "token_generator"]
