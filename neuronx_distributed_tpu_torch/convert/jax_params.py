"""JAX param tree -> the port's ``state_dict``.

The port's module tree mirrors the JAX package's param tree (see
``neuronx_distributed_tpu/convert/hf.py:llama_params_to_hf`` for the
layout: ``model/embed/embedding [V, H]``, ``model/layer_i/attn/qkv/
{q,k,v}_kernel [H, heads, D]``, ``attn/o_proj/kernel [NQ*D, H]``,
``mlp/gate_up/kernel [H, 2, I]``, ``mlp/down/kernel [I, H]``, the norm
``weight``s, ``lm_head/kernel [H, V]``), so the conversion is a flatten of
the tree's paths with a shape check against the config.  Gemma and Gemma-2
trees (``neuronx_distributed_tpu/models/gemma.py``) have no ``model/`` level
and no ``lm_head`` (the head is the tied embedding); Gemma-2 layers carry
four norm weights.  Arrays move as
they are and ``load_state_dict`` casts them to the model's types, so a
model built with ``param_dtype=torch.float32`` (training) keeps the JAX
package's fp32 masters bit for bit, and a serving model (weights in the
compute type) takes them rounded once.

At tensor-parallel degree > 1 a rank's model holds its shard of each
tensor: :func:`shard_params_for_rank` cuts the JAX tree (numpy) by the JAX
package's partition specs (:func:`shard_dim` names the sharded dim of a
parameter, None for a replicated one), and the converters take ``tp=`` to
check the shard's shapes.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

# the sharded dim of each parameter kind, by name suffix (the JAX partition
# specs: q/k/v heads over ('tp', 'kvr') / 'tp', a column kernel's and the
# LM head's last dim, a row kernel's and the embedding's first dim); norms
# are replicated
_SHARD_DIMS = (
    ("attn.qkv.q_kernel", 1), ("attn.qkv.k_kernel", 1),
    ("attn.qkv.v_kernel", 1), ("attn.qkv.q_bias", 0),
    ("attn.qkv.k_bias", 0), ("attn.qkv.v_bias", 0),
    ("attn.o_proj.kernel", 0), ("mlp.gate_up.kernel", -1),
    ("mlp.down.kernel", 0), ("embed.embedding", 0), ("lm_head.kernel", -1),
)


def shard_dim(name: str) -> Optional[int]:
    """The dim along which ``name`` (a dotted parameter path) is sharded
    over the tensor-parallel ranks, or None when it is replicated."""
    for suffix, dim in _SHARD_DIMS:
        if name.endswith(suffix):
            return dim
    return None


def _cut(arr, dim: Optional[int], tp: int, rank: int):
    if dim is None or tp == 1:
        return arr
    n = arr.shape[dim]
    if n % tp:
        raise ValueError(f"dim {dim} of size {n} does not split over "
                         f"tensor-parallel degree {tp}")
    idx = [slice(None)] * arr.ndim
    idx[dim] = slice(rank * (n // tp), (rank + 1) * (n // tp))
    return arr[tuple(idx)]


def shard_params_for_rank(params: Mapping[str, Any], tp: int, rank: int
                          ) -> Dict[str, Any]:
    """Rank ``rank``'s shard of a JAX param tree at tensor-parallel degree
    ``tp``: the same nesting, each sharded leaf cut to its slice (numpy,
    a copy), replicated leaves as they are."""
    def walk(tree, prefix):
        out = {}
        for key, val in tree.items():
            path = f"{prefix}{key}"
            if isinstance(val, Mapping):
                out[key] = walk(val, path + ".")
            else:
                out[key] = np.array(_cut(np.asarray(val), shard_dim(path),
                                         tp, rank))
        return out
    return walk(params, "")


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(_flatten(val, path + "."))
        else:
            out[path] = val
    return out


def _expected_shapes(cfg, prefix: str = "model.", lm_head: bool = True,
                     norms=("input_norm", "post_attn_norm"), tp: int = 1
                     ) -> Dict[str, tuple]:
    H, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    NQ, NKV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    shapes = {prefix + "embed.embedding": (V, H),
              prefix + "final_norm.weight": (H,)}
    if lm_head:
        shapes["lm_head.kernel"] = (H, V)
    for i in range(cfg.num_layers):
        p = f"{prefix}layer_{i}."
        shapes.update({
            p + "attn.qkv.q_kernel": (H, NQ, D),
            p + "attn.qkv.k_kernel": (H, NKV, D),
            p + "attn.qkv.v_kernel": (H, NKV, D),
            p + "attn.o_proj.kernel": (NQ * D, H),
            p + "mlp.gate_up.kernel": (H, 2, I),
            p + "mlp.down.kernel": (I, H),
            **{f"{p}{n}.weight": (H,) for n in norms},
        })
        if getattr(cfg, "qkv_bias", False):
            shapes.update({p + "attn.qkv.q_bias": (NQ, D),
                           p + "attn.qkv.k_bias": (NKV, D),
                           p + "attn.qkv.v_bias": (NKV, D)})
    if tp > 1:
        for name, shape in shapes.items():
            dim = shard_dim(name)
            if dim is not None:
                shape = list(shape)
                shape[dim] //= tp
                shapes[name] = tuple(shape)
    return shapes


def llama_params_from_jax(tree: Mapping[str, Any], cfg,
                          tp: int = 1) -> Dict[str, torch.Tensor]:
    """A JAX Llama param tree (unboxed, leaves convertible to numpy; with or
    without the leading ``params`` level) -> a ``state_dict`` for the
    port's ``LlamaForCausalLM`` with config ``cfg`` (a rank's shard of
    the tree, from :func:`shard_params_for_rank`, at ``tp > 1``).  Raises
    on a missing, extra or wrongly shaped parameter."""
    return _convert(tree, _expected_shapes(cfg, tp=tp))


def gemma_params_from_jax(tree: Mapping[str, Any], cfg,
                          tp: int = 1) -> Dict[str, torch.Tensor]:
    """A JAX ``GemmaForCausalLM`` param tree -> a ``state_dict`` for the
    port's ``GemmaForCausalLM`` with config ``cfg`` (a ``GemmaConfig``).
    The tree has no ``lm_head``: the head is the tied embedding."""
    return _convert(tree, _expected_shapes(cfg, prefix="", lm_head=False,
                                           tp=tp))


def gemma2_params_from_jax(tree: Mapping[str, Any], cfg,
                           tp: int = 1) -> Dict[str, torch.Tensor]:
    """A JAX ``Gemma2ForCausalLM`` param tree -> a ``state_dict`` for the
    port's ``Gemma2ForCausalLM``; each layer carries the four sandwich-norm
    weights."""
    return _convert(tree, _expected_shapes(
        cfg, prefix="", lm_head=False,
        norms=("input_norm", "post_attn_norm", "pre_ffw_norm",
               "post_ffw_norm"), tp=tp))


def _convert(tree: Mapping[str, Any], want: Dict[str, tuple]
             ) -> Dict[str, torch.Tensor]:
    flat = _flatten(tree.get("params", tree))
    if set(flat) != set(want):
        missing = sorted(set(want) - set(flat))
        extra = sorted(set(flat) - set(want))
        raise ValueError(f"param tree does not fit the config: missing "
                         f"{missing[:5]}, unexpected {extra[:5]}")
    sd = {}
    for name, shape in want.items():
        arr = np.asarray(flat[name])
        if arr.shape != shape:
            raise ValueError(f"{name}: shape {arr.shape}, config wants {shape}")
        sd[name] = torch.from_numpy(np.array(arr))  # a writable copy
    return sd
