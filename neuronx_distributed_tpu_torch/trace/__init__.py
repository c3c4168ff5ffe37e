"""Inference engine of the PyTorch port."""

from neuronx_distributed_tpu_torch.trace.engine import (
    InferenceConfig,
    ParallelInferenceModel,
    init_kv_caches,
    request_key,
    token_generator,
)

__all__ = ["InferenceConfig", "ParallelInferenceModel", "init_kv_caches",
           "request_key", "token_generator"]
