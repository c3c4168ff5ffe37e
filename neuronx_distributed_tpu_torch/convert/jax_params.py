"""JAX param tree -> the port's ``state_dict``.

The port's module tree mirrors the JAX package's param tree (see
``neuronx_distributed_tpu/convert/hf.py:llama_params_to_hf`` for the
layout: ``model/embed/embedding [V, H]``, ``model/layer_i/attn/qkv/
{q,k,v}_kernel [H, heads, D]``, ``attn/o_proj/kernel [NQ*D, H]``,
``mlp/gate_up/kernel [H, 2, I]``, ``mlp/down/kernel [I, H]``, the norm
``weight``s, ``lm_head/kernel [H, V]``), so the conversion is a flatten of
the tree's paths with a shape check against the config.  Arrays move as
they are and ``load_state_dict`` casts them to the model's types, so a
model built with ``param_dtype=torch.float32`` (training) keeps the JAX
package's fp32 masters bit for bit, and a serving model (weights in the
compute type) takes them rounded once.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(_flatten(val, path + "."))
        else:
            out[path] = val
    return out


def _expected_shapes(cfg) -> Dict[str, tuple]:
    H, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    NQ, NKV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    shapes = {"model.embed.embedding": (V, H),
              "model.final_norm.weight": (H,),
              "lm_head.kernel": (H, V)}
    for i in range(cfg.num_layers):
        p = f"model.layer_{i}."
        shapes.update({
            p + "attn.qkv.q_kernel": (H, NQ, D),
            p + "attn.qkv.k_kernel": (H, NKV, D),
            p + "attn.qkv.v_kernel": (H, NKV, D),
            p + "attn.o_proj.kernel": (NQ * D, H),
            p + "mlp.gate_up.kernel": (H, 2, I),
            p + "mlp.down.kernel": (I, H),
            p + "input_norm.weight": (H,),
            p + "post_attn_norm.weight": (H,),
        })
        if cfg.qkv_bias:
            shapes.update({p + "attn.qkv.q_bias": (NQ, D),
                           p + "attn.qkv.k_bias": (NKV, D),
                           p + "attn.qkv.v_bias": (NKV, D)})
    return shapes


def llama_params_from_jax(tree: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """A JAX Llama param tree (unboxed, leaves convertible to numpy; with or
    without the leading ``params`` level) -> a ``state_dict`` for the
    port's ``LlamaForCausalLM`` with config ``cfg``.  Raises on a missing,
    extra or wrongly shaped parameter."""
    flat = _flatten(tree.get("params", tree))
    want = _expected_shapes(cfg)
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
