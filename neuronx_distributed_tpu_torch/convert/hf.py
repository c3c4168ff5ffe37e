"""Hugging Face state dicts <-> the port's state dicts (counterpart of
``neuronx_distributed_tpu/convert/hf.py``).

The interesting work is layout algebra, not IO:

- torch ``nn.Linear`` stores ``weight [out, in]``; the port's kernels are
  the JAX package's ``[in, out]`` -> a transpose everywhere;
- fused projections: the gate/up kernel carries an explicit fused axis
  ``[H, 2, I]``, Llama's QKV module per-head kernels ``[H, heads, D]``;
- GPT-NeoX's QKV rows are interleaved per head (``[q0, k0, v0, q1, ...]``)
  while the port keeps a clean fused axis ``[H, 3, H]``: a reshape and
  permute take them apart;
- Gemma's RMSNorm computes ``x * (1 + w)`` in HF and ``x * w`` here: the
  ``+ 1`` is folded into the stored weight, in fp32, and the folded norms
  stay fp32 (in bf16 ``w + 1`` would round); on the way out the ``1`` is
  taken off in fp32 and the result cast to the checkpoint's type, so a
  bf16 checkpoint goes round bit for bit;
- GQA: HF and the port both give q head ``h`` kv head ``h // G``, so no
  head is permuted.

Each ``*_params_from_hf`` builds the JAX package's param tree and hands it
to the matching ``convert.jax_params.*_params_from_jax``, which flattens it
into the port's ``state_dict`` names and checks every shape against the
config; each ``*_params_to_hf`` takes such a ``state_dict`` (or the nested
tree).  Tensors go in and tensors come out, on the input's device and in
its dtype (numpy arrays are taken too); transposes and reshapes stay views
until ``load_state_dict`` copies them into a module.

The file side: :func:`load_hf_state_dict` reads an HF directory's
``*.safetensors`` files (the format read here, BF16 included, without the
``safetensors`` package) or its ``pytorch_model*.bin`` / ``*.pt`` files
(``torch.load(weights_only=True)``); :func:`save_hf_state_dict` writes one
``model.safetensors``.
"""

from __future__ import annotations

import glob
import json
import math
import mmap
import os
import sys
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from neuronx_distributed_tpu_torch.convert.jax_params import (
    _PIPELINED_NAMES,
    _flatten,
    bert_params_from_jax,
    gemma2_params_from_jax,
    gemma_params_from_jax,
    gpt_neox_params_from_jax,
    llama_params_from_jax,
)

# -- safetensors ---------------------------------------------------------------

# the format's dtype names (an 8-byte little-endian header length, a JSON
# header of {name: {dtype, shape, data_offsets}}, then the raw bytes)
SAFETENSORS_DTYPES = {
    name: getattr(torch, attr) for name, attr in (
        ("F64", "float64"), ("F32", "float32"), ("F16", "float16"),
        ("BF16", "bfloat16"), ("I64", "int64"), ("I32", "int32"),
        ("I16", "int16"), ("I8", "int8"), ("U8", "uint8"), ("BOOL", "bool"),
        ("U16", "uint16"), ("U32", "uint32"), ("U64", "uint64"),
        ("F8_E4M3", "float8_e4m3fn"), ("F8_E5M2", "float8_e5m2"))
    if hasattr(torch, attr)}
_DTYPE_NAMES = {dt: name for name, dt in SAFETENSORS_DTYPES.items()}


def _t(x) -> torch.Tensor:
    """``x`` as a tensor: a tensor as it is, anything else (numpy) over its
    memory, copied only when numpy marks it read-only."""
    if isinstance(x, torch.Tensor):
        return x.detach()
    a = np.asarray(x)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _tensors(state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    return {k: _t(v) for k, v in state_dict.items()}


def read_safetensors(path: str, device=None) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file as ``{name: tensor}``: the tensors lie over a
    private memory map of the file (pages read as they are touched), or on
    ``device`` when given."""
    if sys.byteorder != "little":  # pragma: no cover - every card's host
        raise ValueError("safetensors holds little-endian bytes")
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        size = os.fstat(f.fileno()).st_size
        buf = (mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
               if size > 8 + n else None)
    out = {}
    for name, rec in header.items():
        if name == "__metadata__":
            continue
        if rec["dtype"] not in SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: {name} has dtype {rec['dtype']!r}, not "
                             f"one of {sorted(SAFETENSORS_DTYPES)}")
        dtype = SAFETENSORS_DTYPES[rec["dtype"]]
        shape = [int(s) for s in rec["shape"]]
        begin, end = rec["data_offsets"]
        count = math.prod(shape)
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - begin != count * itemsize or 8 + n + end > size:
            raise ValueError(f"{path}: {name}'s data_offsets {rec['data_offsets']}"
                             f" do not hold {shape} {rec['dtype']}")
        t = (torch.frombuffer(buf, dtype=dtype, count=count,
                              offset=8 + n + begin) if count else
             torch.empty(0, dtype=dtype)).reshape(shape)
        out[name] = t if device is None else t.to(device)
    return out


def write_safetensors(path: str, tensors: Mapping[str, Any],
                      metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write ``{name: tensor or array}`` as a ``.safetensors`` file: the
    header padded to 8 bytes, the tensors by falling element size, then
    name, so each starts aligned to its own size."""
    ts = {k: _t(v) for k, v in tensors.items()}
    for k, t in ts.items():
        if t.dtype not in _DTYPE_NAMES:
            raise ValueError(f"{k}: dtype {t.dtype} has no safetensors name")
    order = sorted(ts, key=lambda k: (-ts[k].element_size(), k))
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for k in order:
        nbytes = ts[k].numel() * ts[k].element_size()
        header[k] = {"dtype": _DTYPE_NAMES[ts[k].dtype],
                     "shape": list(ts[k].shape),
                     "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for k in order:
            t = ts[k].to("cpu").contiguous().reshape(-1)
            if t.numel():
                f.write(memoryview(t.view(torch.uint8).numpy()))
    os.replace(tmp, path)


def load_hf_state_dict(path: str, device=None) -> Dict[str, torch.Tensor]:
    """An HF checkpoint (a directory, or one file) as ``{key: tensor}``:
    every ``*.safetensors`` file when there is one, else every
    ``pytorch_model*.bin`` (or ``*.pt``) file through ``torch.load(
    weights_only=True)``.  Tensors land on ``device`` (default: where the
    file puts them: a memory map, or the CPU)."""
    if os.path.isfile(path):
        files = [path]
    else:
        files = (sorted(glob.glob(os.path.join(path, "*.safetensors")))
                 or sorted(glob.glob(os.path.join(path, "pytorch_model*.bin")))
                 or sorted(glob.glob(os.path.join(path, "*.pt"))))
    if not files:
        raise FileNotFoundError(
            f"no *.safetensors or pytorch_model*.bin under {path}")
    sd: Dict[str, torch.Tensor] = {}
    for f in files:
        if f.endswith(".safetensors"):
            sd.update(read_safetensors(f, device))
            continue
        blob = torch.load(f, map_location=device or "cpu", weights_only=True)
        sd.update({k: _t(v) for k, v in blob.items()})
    return sd


def save_hf_state_dict(state_dict: Mapping[str, Any], path: str) -> str:
    """Write ``state_dict`` as ``path/model.safetensors``; returns the
    file's path."""
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, "model.safetensors")
    write_safetensors(out, state_dict, {"format": "pt"})
    return out


# -- layer stacks ---------------------------------------------------------------


def _stack(xs: Sequence[Any]):
    xs = list(xs)
    if any(isinstance(x, torch.Tensor) for x in xs):
        return torch.stack([_t(x) for x in xs])
    return np.stack([np.asarray(x) for x in xs])


def _map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _zip_map(fn, trees):
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: _zip_map(fn, [t[k] for t in trees]) for k in first}
    return fn(trees)


def llama_stack_layers(params: Mapping[str, Any],
                       num_layers: int) -> Dict[str, Any]:
    """The per-layer tree (``model.layer_i...``) -> the scanned layout
    (``model.layers...`` with a leading ``[L]`` axis on every leaf), as
    plain dicts of tensors or arrays (the port itself never builds a
    scanned model)."""
    tree = params.get("params", params)
    model = dict(tree["model"])
    layers = [model.pop(f"layer_{i}") for i in range(num_layers)]
    model["layers"] = _zip_map(_stack, layers)
    out = dict(tree)
    out["model"] = model
    return {"params": out} if "params" in params else out


def llama_unstack_layers(params: Mapping[str, Any],
                         num_layers: int) -> Dict[str, Any]:
    """Inverse of :func:`llama_stack_layers`."""
    tree = params.get("params", params)
    model = dict(tree["model"])
    stacked = model.pop("layers")
    for i in range(num_layers):
        model[f"layer_{i}"] = _map(lambda x, i=i: x[i], stacked)
    out = dict(tree)
    out["model"] = model
    return {"params": out} if "params" in params else out


# -- Llama ------------------------------------------------------------------------


def _fold(w: torch.Tensor, offset: float) -> torch.Tensor:
    """A norm weight with ``offset`` added in fp32 (kept fp32), or as it is
    when the offset is 0."""
    return w.float() + offset if offset else w


def _unfold(w, offset: float, dtype) -> torch.Tensor:
    """Inverse of :func:`_fold`: ``offset`` taken off in fp32, then cast to
    ``dtype`` (the checkpoint's type)."""
    w = _t(w)
    return (w.float() - offset).to(dtype) if offset else w


def _decoder_layer_from_hf(sd: Mapping[str, torch.Tensor], p: str, cfg,
                           norm_offset: float = 0.0) -> Dict[str, Any]:
    """One HF Llama-layout decoder layer (prefix ``p``) -> the JAX
    package's ``LlamaBlock`` subtree.  ``norm_offset`` folds Gemma's
    ``(1 + w)`` norm into the stored weight."""
    H, D = cfg.hidden_size, cfg.head_dim_
    NQ, NKV = cfg.num_heads, cfg.num_kv_heads
    qkv = {
        "q_kernel": sd[p + "self_attn.q_proj.weight"].T.reshape(H, NQ, D),
        "k_kernel": sd[p + "self_attn.k_proj.weight"].T.reshape(H, NKV, D),
        "v_kernel": sd[p + "self_attn.v_proj.weight"].T.reshape(H, NKV, D),
    }
    if getattr(cfg, "qkv_bias", False):
        # Qwen2: biased q/k/v projections
        qkv["q_bias"] = sd[p + "self_attn.q_proj.bias"].reshape(NQ, D)
        qkv["k_bias"] = sd[p + "self_attn.k_proj.bias"].reshape(NKV, D)
        qkv["v_bias"] = sd[p + "self_attn.v_proj.bias"].reshape(NKV, D)
    elif p + "self_attn.q_proj.bias" in sd:
        raise ValueError(
            "HF checkpoint carries QKV biases (Qwen2-style) but the "
            "config has qkv_bias=False — converting would silently zero "
            "them; build the config with qkv_bias=True"
        )
    return {
        "attn": {
            "qkv": qkv,
            "o_proj": {"kernel": sd[p + "self_attn.o_proj.weight"].T},
        },
        "mlp": {
            "gate_up": {"kernel": torch.stack(
                [sd[p + "mlp.gate_proj.weight"].T,
                 sd[p + "mlp.up_proj.weight"].T], dim=1)},  # [H, 2, I]
            "down": {"kernel": sd[p + "mlp.down_proj.weight"].T},
        },
        "input_norm": {"weight": _fold(sd[p + "input_layernorm.weight"],
                                       norm_offset)},
        "post_attn_norm": {"weight": _fold(
            sd[p + "post_attention_layernorm.weight"], norm_offset)},
    }


def _decoder_layer_to_hf(flat: Mapping[str, torch.Tensor], src: str,
                         p: str, H: int, norm_offset: float = 0.0,
                         norm_dtype=None) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`_decoder_layer_from_hf` for the port's layer
    ``src`` (its ``state_dict`` prefix)."""
    gu = flat[src + "mlp.gate_up.kernel"]  # [H, 2, I]
    out = {
        p + "self_attn.q_proj.weight":
            flat[src + "attn.qkv.q_kernel"].reshape(H, -1).T,
        p + "self_attn.k_proj.weight":
            flat[src + "attn.qkv.k_kernel"].reshape(H, -1).T,
        p + "self_attn.v_proj.weight":
            flat[src + "attn.qkv.v_kernel"].reshape(H, -1).T,
        p + "self_attn.o_proj.weight": flat[src + "attn.o_proj.kernel"].T,
        p + "mlp.gate_proj.weight": gu[:, 0, :].T,
        p + "mlp.up_proj.weight": gu[:, 1, :].T,
        p + "mlp.down_proj.weight": flat[src + "mlp.down.kernel"].T,
        p + "input_layernorm.weight": _unfold(
            flat[src + "input_norm.weight"], norm_offset, norm_dtype),
        p + "post_attention_layernorm.weight": _unfold(
            flat[src + "post_attn_norm.weight"], norm_offset, norm_dtype),
    }
    if src + "attn.qkv.q_bias" in flat:  # Qwen2 biased projections
        for n in "qkv":
            out[p + f"self_attn.{n}_proj.bias"] = \
                flat[src + f"attn.qkv.{n}_bias"].reshape(-1)
    return out


def _flat_tensors(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A port ``state_dict`` (flat) or a nested tree (with or without the
    ``params`` level) as ``{dotted name: tensor}``."""
    return _tensors(_flatten(params.get("params", params)))


def llama_params_from_hf(state_dict: Mapping[str, Any], cfg
                         ) -> Dict[str, torch.Tensor]:
    """HF ``LlamaForCausalLM.state_dict()`` (or a Qwen2 or Mistral one) ->
    a ``state_dict`` for the port's ``LlamaForCausalLM`` with config
    ``cfg``.  A checkpoint without ``lm_head.weight`` (a tied embedding)
    gets the embedding as its head."""
    sd = _tensors(state_dict)
    model: Dict[str, Any] = {
        "embed": {"embedding": sd["model.embed_tokens.weight"]},
        "final_norm": {"weight": sd["model.norm.weight"]},
    }
    for i in range(cfg.num_layers):
        model[f"layer_{i}"] = _decoder_layer_from_hf(sd, f"model.layers.{i}.",
                                                     cfg)
    lm_head = sd.get("lm_head.weight")
    if lm_head is None:  # tied-embedding HF checkpoints omit it
        lm_head = sd["model.embed_tokens.weight"]
    return llama_params_from_jax(
        {"model": model, "lm_head": {"kernel": lm_head.T}}, cfg)


def llama_params_to_hf(params: Mapping[str, Any], cfg
                       ) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`llama_params_from_hf` (the port's ``state_dict``
    -> HF keys)."""
    flat = _flat_tensors(params)
    H = cfg.hidden_size
    out = {
        "model.embed_tokens.weight": flat["model.embed.embedding"],
        "model.norm.weight": flat["model.final_norm.weight"],
        "lm_head.weight": flat["lm_head.kernel"].T,
    }
    for i in range(cfg.num_layers):
        out.update(_decoder_layer_to_hf(flat, f"model.layer_{i}.",
                                        f"model.layers.{i}.", H))
    return out


# Mistral: the HF layout is Llama's (the sliding window is config-only)
mistral_params_from_hf = llama_params_from_hf
mistral_params_to_hf = llama_params_to_hf


# -- GPT-NeoX -------------------------------------------------------------------


def _neox_deinterleave(w_qkv: torch.Tensor, b_qkv: torch.Tensor,
                       num_heads: int, head_dim: int):
    """HF NeoX fused QKV rows are per-head interleaved ``[n, (q|k|v), d]``;
    the port's fused axis is ``[in, 3, n * d]``."""
    H_in = w_qkv.shape[1]
    w = w_qkv.T.reshape(H_in, num_heads, 3, head_dim).permute(0, 2, 1, 3)
    w = w.reshape(H_in, 3, num_heads * head_dim)
    b = b_qkv.reshape(num_heads, 3, head_dim).permute(1, 0, 2).reshape(3, -1)
    return w, b


def _neox_interleave(w: torch.Tensor, b: torch.Tensor, num_heads: int,
                     head_dim: int):
    H_in = w.shape[0]
    wq = w.reshape(H_in, 3, num_heads, head_dim).permute(0, 2, 1, 3)
    wq = wq.reshape(H_in, 3 * num_heads * head_dim).T
    bq = b.reshape(3, num_heads, head_dim).permute(1, 0, 2).reshape(-1)
    return wq, bq


def _biased(sd, key: str) -> Dict[str, torch.Tensor]:
    return {"weight": sd[key + ".weight"], "bias": sd[key + ".bias"]}


def _dense(sd, key: str) -> Dict[str, torch.Tensor]:
    """An HF ``nn.Linear`` as a kernel ``[in, out]`` and its bias."""
    return {"kernel": sd[key + ".weight"].T, "bias": sd[key + ".bias"]}


def gpt_neox_params_from_hf(state_dict: Mapping[str, Any], cfg
                            ) -> Dict[str, torch.Tensor]:
    """HF ``GPTNeoXForCausalLM.state_dict()`` -> a ``state_dict`` for the
    port's ``GPTNeoXForCausalLM``."""
    sd = _tensors(state_dict)
    N, D = cfg.num_heads, cfg.head_dim
    tree: Dict[str, Any] = {
        "embed_in": {"embedding": sd["gpt_neox.embed_in.weight"]},
        "final_norm": _biased(sd, "gpt_neox.final_layer_norm"),
        "embed_out": {"kernel": sd["embed_out.weight"].T},
    }
    for i in range(cfg.num_layers):
        p = f"gpt_neox.layers.{i}."
        wq, bq = _neox_deinterleave(
            sd[p + "attention.query_key_value.weight"],
            sd[p + "attention.query_key_value.bias"], N, D)
        tree[f"layer_{i}"] = {
            "ln_1": _biased(sd, p + "input_layernorm"),
            "ln_2": _biased(sd, p + "post_attention_layernorm"),
            "attn": {"qkv": {"kernel": wq, "bias": bq},
                     "dense": _dense(sd, p + "attention.dense")},
            "mlp": {"dense_h_to_4h": _dense(sd, p + "mlp.dense_h_to_4h"),
                    "dense_4h_to_h": _dense(sd, p + "mlp.dense_4h_to_h")},
        }
    return gpt_neox_params_from_jax(tree, cfg)


def gpt_neox_params_to_hf(params: Mapping[str, Any], cfg
                          ) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`gpt_neox_params_from_hf`."""
    flat = _flat_tensors(params)
    N, D = cfg.num_heads, cfg.head_dim
    out = {
        "gpt_neox.embed_in.weight": flat["embed_in.embedding"],
        "gpt_neox.final_layer_norm.weight": flat["final_norm.weight"],
        "gpt_neox.final_layer_norm.bias": flat["final_norm.bias"],
        "embed_out.weight": flat["embed_out.kernel"].T,
    }
    for i in range(cfg.num_layers):
        s, p = f"layer_{i}.", f"gpt_neox.layers.{i}."
        wq, bq = _neox_interleave(flat[s + "attn.qkv.kernel"],
                                  flat[s + "attn.qkv.bias"], N, D)
        out.update({
            p + "input_layernorm.weight": flat[s + "ln_1.weight"],
            p + "input_layernorm.bias": flat[s + "ln_1.bias"],
            p + "post_attention_layernorm.weight": flat[s + "ln_2.weight"],
            p + "post_attention_layernorm.bias": flat[s + "ln_2.bias"],
            p + "attention.query_key_value.weight": wq,
            p + "attention.query_key_value.bias": bq,
        })
        for hf, port in (("attention.dense", "attn.dense"),
                         ("mlp.dense_h_to_4h", "mlp.dense_h_to_4h"),
                         ("mlp.dense_4h_to_h", "mlp.dense_4h_to_h")):
            out[p + hf + ".weight"] = flat[s + port + ".kernel"].T
            out[p + hf + ".bias"] = flat[s + port + ".bias"]
    return out


# -- BERT ---------------------------------------------------------------------------

_BERT_QKV = ("query", "key", "value")


def bert_params_from_hf(state_dict: Mapping[str, Any], cfg
                        ) -> Dict[str, torch.Tensor]:
    """HF ``BertForPreTraining.state_dict()`` -> a ``state_dict`` for the
    port's ``BertForPreTraining``: the separate q/k/v linears fuse onto the
    ``[H, 3, H]`` kernel; the MLM decoder is the tied word embedding on
    both sides, so only its bias moves."""
    sd = _tensors(state_dict)
    bert: Dict[str, Any] = {
        "word_embeddings": {
            "embedding": sd["bert.embeddings.word_embeddings.weight"]},
        "position_embeddings":
            sd["bert.embeddings.position_embeddings.weight"],
        "token_type_embeddings":
            sd["bert.embeddings.token_type_embeddings.weight"],
        "embed_norm": _biased(sd, "bert.embeddings.LayerNorm"),
        "pooler": _dense(sd, "bert.pooler.dense"),
    }
    for i in range(cfg.num_layers):
        p = f"bert.encoder.layer.{i}."
        wq = torch.stack([sd[p + f"attention.self.{n}.weight"].T
                          for n in _BERT_QKV], dim=1)  # [H, 3, H]
        bq = torch.stack([sd[p + f"attention.self.{n}.bias"]
                          for n in _BERT_QKV], dim=0)
        bert[f"layer_{i}"] = {
            "attention": {"qkv": {"kernel": wq, "bias": bq},
                          "dense": _dense(sd, p + "attention.output.dense")},
            "attention_norm": _biased(sd, p + "attention.output.LayerNorm"),
            "intermediate": _dense(sd, p + "intermediate.dense"),
            "output": _dense(sd, p + "output.dense"),
            "output_norm": _biased(sd, p + "output.LayerNorm"),
        }
    tree: Dict[str, Any] = {"bert": bert}
    if "cls.predictions.transform.dense.weight" in sd:
        tree["mlm_transform"] = _dense(sd, "cls.predictions.transform.dense")
        tree["mlm_norm"] = _biased(sd, "cls.predictions.transform.LayerNorm")
        tree["mlm_bias"] = sd["cls.predictions.bias"]
        tree["nsp_classifier"] = _dense(sd, "cls.seq_relationship")
    return bert_params_from_jax(tree, cfg)


def bert_params_to_hf(params: Mapping[str, Any], cfg
                      ) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`bert_params_from_hf`; HF's tied decoder is written
    out as its own keys (the word embedding and the MLM bias)."""
    flat = _flat_tensors(params)
    out = {
        "bert.embeddings.word_embeddings.weight":
            flat["bert.word_embeddings.embedding"],
        "bert.embeddings.position_embeddings.weight":
            flat["bert.position_embeddings"],
        "bert.embeddings.token_type_embeddings.weight":
            flat["bert.token_type_embeddings"],
        "bert.embeddings.LayerNorm.weight": flat["bert.embed_norm.weight"],
        "bert.embeddings.LayerNorm.bias": flat["bert.embed_norm.bias"],
        "bert.pooler.dense.weight": flat["bert.pooler.kernel"].T,
        "bert.pooler.dense.bias": flat["bert.pooler.bias"],
    }
    for i in range(cfg.num_layers):
        s, p = f"bert.layer_{i}.", f"bert.encoder.layer.{i}."
        wq, bq = flat[s + "attention.qkv.kernel"], flat[s + "attention.qkv.bias"]
        for j, n in enumerate(_BERT_QKV):
            out[p + f"attention.self.{n}.weight"] = wq[:, j, :].T
            out[p + f"attention.self.{n}.bias"] = bq[j]
        for hf, port in (("attention.output.dense", "attention.dense"),
                         ("intermediate.dense", "intermediate"),
                         ("output.dense", "output")):
            out[p + hf + ".weight"] = flat[s + port + ".kernel"].T
            out[p + hf + ".bias"] = flat[s + port + ".bias"]
        for hf, port in (("attention.output.LayerNorm", "attention_norm"),
                         ("output.LayerNorm", "output_norm")):
            out[p + hf + ".weight"] = flat[s + port + ".weight"]
            out[p + hf + ".bias"] = flat[s + port + ".bias"]
    if "mlm_transform.kernel" in flat:
        out.update({
            "cls.predictions.transform.dense.weight":
                flat["mlm_transform.kernel"].T,
            "cls.predictions.transform.dense.bias": flat["mlm_transform.bias"],
            "cls.predictions.transform.LayerNorm.weight":
                flat["mlm_norm.weight"],
            "cls.predictions.transform.LayerNorm.bias": flat["mlm_norm.bias"],
            "cls.predictions.bias": flat["mlm_bias"],
            # HF materializes the tied decoder as its own (shared) tensors
            "cls.predictions.decoder.weight":
                flat["bert.word_embeddings.embedding"],
            "cls.predictions.decoder.bias": flat["mlm_bias"],
            "cls.seq_relationship.weight": flat["nsp_classifier.kernel"].T,
            "cls.seq_relationship.bias": flat["nsp_classifier.bias"],
        })
    return out


# -- pipelined models --------------------------------------------------------------


def _from_pipelined(stages, layer_rows, family: str
                    ) -> Dict[str, torch.Tensor]:
    embed_path, block_path, head_places = _PIPELINED_NAMES[family]
    if isinstance(stages, Mapping):
        stages = [stages]
    out: Dict[str, torch.Tensor] = {}
    for stage in stages:
        for k, v in _flat_tensors(stage).items():
            if k in out:
                raise ValueError(f"{k} is held by more than one stage")
            out[k] = v
    L = len(layer_rows)
    blocks = [block_path.format(i) + "." for i in range(L)]
    heads = tuple(p + "." for p in head_places.values())
    missing = [b for b in blocks if not any(k.startswith(b) for k in out)]
    if not any(k.startswith(embed_path + ".") for k in out):
        missing.append(embed_path)
    missing += [h for h in heads if not any(k.startswith(h) for k in out)]
    stray = [k for k in out if not k.startswith(
        (embed_path + ".",) + tuple(blocks) + heads)]
    if missing or stray:
        raise ValueError(f"the stages do not make a {L}-layer {family} "
                         f"model: missing {missing[:5]}, unexpected "
                         f"{stray[:5]}")
    return out


def llama_params_from_pipelined(stages, layer_rows
                                ) -> Dict[str, torch.Tensor]:
    """A pipelined Llama's stages -> the pp = 1 ``state_dict``.  A port
    stage holds only its real layers, under the pp = 1 names (JAX's stacked
    ``[L', ...]`` tree goes through ``jax_params.pipelined_params_from_jax``
    instead), so the stages' ``state_dict`` s merge by name: each name from
    one stage, and together the embedding, layers ``0 .. len(layer_rows) -
    1`` and the head, or this raises.  ``layer_rows`` keeps JAX's signature
    (``PipelinedModel.layer_rows``): only its length, the number of real
    layers, is read, since the port's names need no stack row."""
    return _from_pipelined(stages, layer_rows, "llama")


def gpt_neox_params_from_pipelined(stages, layer_rows
                                   ) -> Dict[str, torch.Tensor]:
    """The GPT-NeoX form of :func:`llama_params_from_pipelined`."""
    return _from_pipelined(stages, layer_rows, "gpt_neox")


# -- Gemma: Llama-layout layers, the tied embedding head, (1 + w) norms --------


def gemma_params_from_hf(state_dict: Mapping[str, Any], cfg
                         ) -> Dict[str, torch.Tensor]:
    """HF ``GemmaForCausalLM.state_dict()`` -> a ``state_dict`` for the
    port's ``GemmaForCausalLM``: every norm weight gets ``+ 1`` folded in,
    in fp32 (see the module docstring); the head is the tied embedding, so
    neither layout has a head tensor."""
    sd = _tensors(state_dict)
    block_cfg = cfg.block_config()
    tree: Dict[str, Any] = {
        "embed": {"embedding": sd["model.embed_tokens.weight"]},
        "final_norm": {"weight": _fold(sd["model.norm.weight"], 1.0)},
    }
    for i in range(cfg.num_layers):
        tree[f"layer_{i}"] = _decoder_layer_from_hf(
            sd, f"model.layers.{i}.", block_cfg, norm_offset=1.0)
    return gemma_params_from_jax(tree, cfg)


def gemma_params_to_hf(params: Mapping[str, Any], cfg
                       ) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`gemma_params_from_hf`: the norms' ``1`` taken off
    in fp32, then cast to the embedding's type."""
    flat = _flat_tensors(params)
    dt = flat["embed.embedding"].dtype
    out = {"model.embed_tokens.weight": flat["embed.embedding"],
           "model.norm.weight": _unfold(flat["final_norm.weight"], 1.0, dt)}
    for i in range(cfg.num_layers):
        out.update(_decoder_layer_to_hf(flat, f"layer_{i}.",
                                        f"model.layers.{i}.", cfg.hidden_size,
                                        1.0, dt))
    return out


def gemma2_params_from_hf(state_dict: Mapping[str, Any], cfg
                          ) -> Dict[str, torch.Tensor]:
    """HF ``Gemma2ForCausalLM.state_dict()`` -> a ``state_dict`` for the
    port's ``Gemma2ForCausalLM`` (the tied head; every norm, the two
    feed-forward sandwich norms included, gets the ``+ 1`` fold; HF's
    ``post_attention_layernorm`` is the post-attention sandwich norm)."""
    sd = _tensors(state_dict)
    block_cfg = cfg.block_config(sliding=False)  # layout only
    tree: Dict[str, Any] = {
        "embed": {"embedding": sd["model.embed_tokens.weight"]},
        "final_norm": {"weight": _fold(sd["model.norm.weight"], 1.0)},
    }
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        lyr = _decoder_layer_from_hf(sd, p, block_cfg, norm_offset=1.0)
        lyr["pre_ffw_norm"] = {"weight": _fold(
            sd[p + "pre_feedforward_layernorm.weight"], 1.0)}
        lyr["post_ffw_norm"] = {"weight": _fold(
            sd[p + "post_feedforward_layernorm.weight"], 1.0)}
        tree[f"layer_{i}"] = lyr
    return gemma2_params_from_jax(tree, cfg)


def gemma2_params_to_hf(params: Mapping[str, Any], cfg
                        ) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`gemma2_params_from_hf`."""
    out = gemma_params_to_hf(params, cfg)
    flat = _flat_tensors(params)
    dt = flat["embed.embedding"].dtype
    for i in range(cfg.num_layers):
        for hf, port in (("pre_feedforward_layernorm", "pre_ffw_norm"),
                         ("post_feedforward_layernorm", "post_ffw_norm")):
            out[f"model.layers.{i}.{hf}.weight"] = _unfold(
                flat[f"layer_{i}.{port}.weight"], 1.0, dt)
    return out
