"""Serialize / load a serving model's phase programs (counterpart of
``neuronx_distributed_tpu/trace/export.py``).

:func:`parallel_model_save` writes one artifact directory:

- ``params.pt``: ``torch.save`` of the module's state dict (the names the
  programs take their parameters by);
- ``context.pt2`` and ``decode.pt2``: the context and decode phase
  functions of :class:`~.engine.ParallelInferenceModel`
  (``_context_fn``, ``_decode_fn``) through ``torch.export`` and
  ``torch.export.save``, with the parameters as an INPUT of each program
  (a dict), so the weights are stored once, in ``params.pt``;
- ``meta.json``: the JAX package's fields (the serving shapes and the
  cache type).

The decode program takes its cache offset as a 0-d int tensor and writes
the new key through ``index_copy_`` (``models/llama.py``), as JAX exports
the offset as an array: an offset baked in as an int would make the loaded
program serve one position only.  Its in-place cache and validity updates
come back as the program's mutated inputs, so the loaded decode updates
the caller's tensors as the model's own does.

These dense-cache programs reach no hand-written kernel: prefill into
fresh caches and the contiguous decode run ``core_attention``, so no
ctypes launch stands in ``torch.export``'s way.  The paged programs (and
their CUDA graphs) are not exported, as in JAX.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import torch

from neuronx_distributed_tpu_torch.trace.engine import (
    InferenceConfig,
    ParallelInferenceModel,
    _ServingBase,
)
from neuronx_distributed_tpu_torch.utils.device import resolve_device
from neuronx_distributed_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

_CONTEXT = "context.pt2"
_DECODE = "decode.pt2"
_PARAMS = "params.pt"
_META = "meta.json"

_DTYPES = {str(d).replace("torch.", ""): d
           for d in (torch.float32, torch.bfloat16, torch.float16)}


class _Program(torch.nn.Module):
    """One phase function of a serving model as an exportable module whose
    first input is the parameter dict: the model is held outside the
    module tree, so ``torch.export`` lifts no weights into the program."""

    def __init__(self, pim: ParallelInferenceModel, which: str):
        super().__init__()
        object.__setattr__(self, "_pim", pim)
        self.which = which

    def forward(self, params: Dict[str, torch.Tensor], *args):
        pim = self._pim
        fn = pim._context_fn if self.which == "context" else pim._decode_fn
        with torch.nn.utils.stateless._reparametrize_module(
                pim.module, params):
            if self.which == "context":
                return fn(*args)
            tok, offset, caches, valid = args
            logits, _, _ = fn(tok, offset, caches, valid)
            return logits


def parallel_model_save(path: str, model: ParallelInferenceModel) -> str:
    """Save a serving model's parameters, its context and decode programs
    and their shapes under ``path`` (the JAX ``parallel_model_save``)."""
    os.makedirs(path, exist_ok=True)
    cfg = model.config
    B, C, T = cfg.batch_size, cfg.context_len, cfg.max_total_len
    dev = model.device
    params = model.module.state_dict()
    ids = torch.zeros((B, C), dtype=torch.long, device=dev)
    valid_ctx = torch.ones((B, C), dtype=torch.int32, device=dev)
    with torch.no_grad():
        ctx = torch.export.export(_Program(model, "context"),
                                  (params, ids, valid_ctx), strict=False)
        caches = model.empty_caches()
        valid = torch.zeros((B, T), dtype=torch.int32, device=dev)
        dec = torch.export.export(
            _Program(model, "decode"),
            (params, torch.zeros((B, 1), dtype=torch.long, device=dev),
             torch.tensor(C, dtype=torch.int64, device=dev), caches, valid),
            strict=False)
    for ep, name in ((ctx, _CONTEXT), (dec, _DECODE)):
        # the example inputs hold the parameters: keep them out of the
        # program files (params.pt has them once)
        ep.example_inputs = None
        torch.export.save(ep, os.path.join(path, name))
    torch.save(params, os.path.join(path, _PARAMS))
    meta = {
        "batch_size": B, "context_len": C, "max_total_len": T,
        "kv_cache_dtype": _dtype_name(cfg.kv_cache_dtype),
        "chunked_prefill": False,
    }
    with open(os.path.join(path, _META), "w") as f:
        json.dump(meta, f)
    logger.info("saved serving model to %s", path)
    return path


def _dtype_name(d: torch.dtype) -> str:
    return str(d).replace("torch.", "")


class LoadedInferenceModel(_ServingBase):
    """Serving wrapper over loaded phase programs: the same ``generate`` as
    :class:`~.engine.ParallelInferenceModel` (greedy or sampled, ragged
    prompts), each decode step one call of the ONE loaded decode program
    at a 0-d offset tensor."""

    def __init__(self, context, decode, params: Dict[str, torch.Tensor],
                 config: InferenceConfig, device):
        self.config = config
        self.device = device
        self.params = params
        self.context = context
        self.decode = decode

    @torch.no_grad()
    def _context_fn(self, ids, valid):
        logits, caches = self.context(self.params,
                                      self._tensor(ids, torch.long),
                                      self._tensor(valid))
        return logits, [tuple(entry) for entry in caches]

    @torch.no_grad()
    def _decode_fn(self, tok, offset, caches, valid):
        off = torch.as_tensor(offset, dtype=torch.int64, device=self.device)
        logits = self.decode(self.params, self._tensor(tok, torch.long), off,
                             caches, valid)
        return logits, caches, valid


def parallel_model_load(path: str, device=None) -> LoadedInferenceModel:
    """Load a model saved by :func:`parallel_model_save` onto ``device``
    (default CUDA; raises without it)."""
    device = resolve_device(device)
    with open(os.path.join(path, _META)) as f:
        meta = json.load(f)
    params = torch.load(os.path.join(path, _PARAMS), map_location=device)
    config = InferenceConfig(meta["batch_size"], meta["context_len"],
                             meta["max_total_len"],
                             _DTYPES[meta["kv_cache_dtype"]])
    context = torch.export.load(os.path.join(path, _CONTEXT)).module()
    decode = torch.export.load(os.path.join(path, _DECODE)).module()
    logger.info("loaded serving model from %s", path)
    return LoadedInferenceModel(context, decode, params, config, device)
