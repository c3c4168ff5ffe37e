"""Dtype policy helpers: a floating-only tree cast and a dtype audit
(counterpart of ``neuronx_distributed_tpu/utils/dtypes.py``).

A tree is a nested dict (a ``state_dict`` is a flat one), list or tuple
whose leaves are tensors or anything else; only floating-point tensors are
cast or audited, so token ids, step counters and other integer or bool
leaves pass through.  Audit paths are written as JAX's
``jax.tree_util.keystr`` writes them (``['layer']['weight']``, ``[0]``),
dict keys in sorted order as JAX flattens them, and dtypes by their JAX
names (``bfloat16``, ``float32``).
"""

from __future__ import annotations

from typing import Any, List, Tuple, Union

import torch

DtypeLike = Union[torch.dtype, str]


def _dtype(d: DtypeLike) -> torch.dtype:
    if isinstance(d, torch.dtype):
        return d
    out = getattr(torch, str(d), None)
    if not isinstance(out, torch.dtype):
        raise TypeError(f"not a dtype: {d!r}")
    return out


def dtype_name(d: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``bfloat16``, the name JAX prints."""
    return str(d).replace("torch.", "")


def _is_float(x: Any) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def cast_floating(tree: Any, dtype: DtypeLike) -> Any:
    """The tree with every floating-point tensor cast to ``dtype``;
    integer and bool tensors and non-tensor leaves pass through untouched.
    The structure (dict key order included) is kept."""
    dtype = _dtype(dtype)
    if isinstance(tree, dict):
        return type(tree)((k, cast_floating(v, dtype))
                          for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floating(v, dtype) for v in tree)
    return tree.to(dtype) if _is_float(tree) else tree


def _leaves(tree: Any, path: str = ""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def audit_dtypes(tree: Any, expected: DtypeLike, *,
                 raise_on_mismatch: bool = False
                 ) -> List[Tuple[str, torch.dtype]]:
    """``[(path, actual_dtype), ...]`` of the floating tensors whose dtype
    is not ``expected`` (empty: clean).  With ``raise_on_mismatch`` a
    non-empty report raises ``TypeError`` listing the first ten offenders.
    Non-floating leaves are never audited (an int32 token table is not a
    policy violation)."""
    expected = _dtype(expected)
    bad = [(p, leaf.dtype) for p, leaf in _leaves(tree)
           if _is_float(leaf) and leaf.dtype != expected]
    if bad and raise_on_mismatch:
        listing = ", ".join(f"{p}: {dtype_name(d)}" for p, d in bad[:10])
        more = f" (+{len(bad) - 10} more)" if len(bad) > 10 else ""
        raise TypeError(
            f"dtype audit: {len(bad)} floating leaves are not "
            f"{dtype_name(expected)}: {listing}{more}")
    return bad
