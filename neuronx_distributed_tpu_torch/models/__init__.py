"""Model families of the PyTorch port."""

from neuronx_distributed_tpu_torch.models.bert import (
    BertConfig,
    BertForPreTraining,
    pretraining_loss,
)
from neuronx_distributed_tpu_torch.models.gemma import (
    Gemma2Config,
    Gemma2ForCausalLM,
    GemmaConfig,
    GemmaForCausalLM,
)
from neuronx_distributed_tpu_torch.models.gpt_neox import (
    GPTNeoXConfig,
    GPTNeoXForCausalLM,
)
from neuronx_distributed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

__all__ = ["BertConfig", "BertForPreTraining", "GPTNeoXConfig",
           "GPTNeoXForCausalLM", "Gemma2Config", "Gemma2ForCausalLM",
           "GemmaConfig", "GemmaForCausalLM", "LlamaConfig",
           "LlamaForCausalLM", "pretraining_loss"]
