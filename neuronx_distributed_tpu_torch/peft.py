"""LoRA parameter utilities (counterpart of
``neuronx_distributed_tpu/peft.py``) on nested trees: dicts, lists and
tuples whose leaves are numpy arrays or tensors, the JAX param tree as
numpy.  The JAX package walks the tree with ``jax.tree_util``; the port
walks it itself.

- :func:`lora_trainable` -- the ``trainable=`` predicate (train the
  adapters, freeze the base; PEFT training is ROADMAP A13);
- :func:`lora_params` / :func:`strip_lora` -- split a tree into the
  adapter-only tree and the base;
- :func:`merge_lora` -- fold adapters into their base kernels
  (``kernel += (alpha/r) * A @ B``), giving a dense tree for a model
  without adapters.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import numpy as np
import torch


def lora_trainable(path: str) -> bool:
    """``trainable=`` predicate: only LoRA adapter params update."""
    return "lora_" in path


def _is_lora_leaf_path(path_keys) -> bool:
    """True when ANY path component names a LoRA factor, not just the
    leaf: wrappers (optimizer-state mirrors, restore shims) nest extra
    levels under the ``lora_a``/``lora_b`` key (``.../lora_a/value``)."""
    return any("lora_" in str(getattr(k, "key", k)) for k in path_keys)


def map_with_path(fn: Callable[[Tuple, Any], Any], node: Any,
                  path: Tuple = ()) -> Any:
    """``fn(path, leaf)`` over every leaf of a tree of dicts, lists and
    tuples, rebuilding the containers; ``path`` holds the dict keys and
    sequence indices from the root."""
    if isinstance(node, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(node))
    return fn(path, node)


def lora_params(params: Any) -> Any:
    """The adapter-only tree: non-adapter leaves are replaced with None."""
    return map_with_path(
        lambda p, leaf: leaf if _is_lora_leaf_path(p) else None, params)


def strip_lora(params: Any) -> Any:
    """Discard the adapters WITHOUT merging: the base tree a model without
    adapters expects."""

    def strip(node):
        if isinstance(node, dict):
            return {k: strip(v) for k, v in node.items() if "lora_" not in k}
        return node

    return strip(params)


def _merge_pair(kernel, a, b, alpha: float):
    """``kernel + (alpha/r) * a @ b`` in the kernel's type and kind (tensor
    or numpy).  ``a [..., in, r]``, ``b [..., r, *rest]``, ``kernel [...,
    in, *rest]``: the leading dims cover stacked ``[L, ...]`` params."""
    is_tensor = isinstance(kernel, torch.Tensor)
    k, a, b = (x if isinstance(x, torch.Tensor)
               else torch.from_numpy(np.array(x)) for x in (kernel, a, b))
    dt = torch.promote_types(torch.promote_types(k.dtype, a.dtype),
                             torch.promote_types(b.dtype, torch.float32))
    r = a.shape[-1]
    lead = a.shape[:-2]
    delta = torch.einsum("...ir,...rk->...ik", a.to(dt),
                         b.to(dt).reshape(*lead, r, -1)).reshape(k.shape)
    out = (k.to(dt) + (alpha / r) * delta).to(k.dtype)
    return out if is_tensor else out.numpy()


def merge_lora(params: Any, alpha: float) -> Any:
    """Fold adapters into their base kernels and drop them.

    Handles the two layouts: plain linears (``lora_a``/``lora_b`` beside
    ``kernel``; fused kernels merge through a reshape) and the GQA QKV
    module (``lora_a_q``/``lora_b_q`` beside ``q_kernel`` etc.).
    ``alpha`` must equal the modules' ``lora_alpha``: a wrong value
    mis-scales every merged kernel.  Returns a new tree."""

    def walk(node):
        if not isinstance(node, dict):
            return node
        out = {key: walk(val) for key, val in node.items()
               if "lora_" not in key}
        if "lora_a" in node and "lora_b" in node and "kernel" in node:
            out["kernel"] = _merge_pair(node["kernel"], node["lora_a"],
                                        node["lora_b"], alpha)
        for t in ("q", "k", "v"):
            if f"lora_a_{t}" in node and f"{t}_kernel" in node:
                out[f"{t}_kernel"] = _merge_pair(
                    node[f"{t}_kernel"], node[f"lora_a_{t}"],
                    node[f"lora_b_{t}"], alpha)
        return out

    return walk(params)
