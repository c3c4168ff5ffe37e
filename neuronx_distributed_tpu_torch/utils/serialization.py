"""Tree serialization helpers (counterpart of
``neuronx_distributed_tpu/utils/serialization.py``).

A tree is a nested dict, list or tuple whose leaves are tensors, numpy
arrays or anything else.  :func:`serialize_tree` splits it into a picklable
skeleton, arrays replaced by :class:`TensorMeta` stubs, and the array list,
in JAX's traversal order (dict keys sorted), so both packages list a
tree's arrays in the same order; :func:`deserialize_tree` puts them back
and checks each against its stub.  :func:`find_loss_from_output_and_spec`
picks the loss out of a model output by a parallel spec tree, and
:func:`encode_obj` / :func:`decode_obj` are the base64-pickle codec for
trusted in-job metadata (checkpoint manifests, host-side agreement).
"""

from __future__ import annotations

import base64
import dataclasses
import pickle
from typing import Any, Callable, List, Tuple

import numpy as np
import torch

from neuronx_distributed_tpu_torch.utils.dtypes import dtype_name


@dataclasses.dataclass(frozen=True)
class TensorMeta:
    """Shape and dtype stub standing in for an array; the dtype by its JAX
    name (``float32``, ``bfloat16``, ``int32``)."""

    shape: Tuple[int, ...]
    dtype: str

    @staticmethod
    def of(x) -> "TensorMeta":
        if isinstance(x, torch.Tensor):
            return TensorMeta(tuple(x.shape), dtype_name(x.dtype))
        x = np.asarray(x)
        return TensorMeta(tuple(x.shape), x.dtype.name)


def _is_array(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def tree_map(fn: Callable[[Any], Any], tree: Any,
             is_leaf: Callable[[Any], bool] = lambda x: False) -> Any:
    """``fn`` over the leaves of a nested dict / list / tuple, the
    structure kept (dict keys visited in sorted order)."""
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], is_leaf) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, is_leaf) for v in tree]
        return type(tree)(out) if isinstance(tree, list) else tuple(out)
    return fn(tree)


def serialize_tree(tree: Any) -> Tuple[Any, List[Any]]:
    """Split ``tree`` into a picklable skeleton (arrays -> :class:`TensorMeta`)
    and the array list, in traversal order."""
    arrays: List[Any] = []

    def one(leaf):
        if _is_array(leaf):
            arrays.append(leaf)
            return TensorMeta.of(leaf)
        return leaf

    return tree_map(one, tree), arrays


def deserialize_tree(skeleton: Any, arrays: List[Any]) -> Any:
    """Inverse of :func:`serialize_tree`: ``arrays`` substituted for the
    :class:`TensorMeta` stubs, in order; raises on a mismatch, a missing
    or an unconsumed array."""
    it = iter(arrays)
    end = object()

    def one(x):
        if isinstance(x, TensorMeta):
            arr = next(it, end)
            if arr is end:
                raise ValueError("fewer arrays than TensorMeta stubs")
            got = TensorMeta.of(arr)
            if got != x:
                raise ValueError(f"array mismatch: expected {x}, got {got}")
            return arr
        return x

    out = tree_map(one, skeleton, is_leaf=lambda x: isinstance(x, TensorMeta))
    rest = list(it)
    if rest:
        raise ValueError(f"{len(rest)} unconsumed arrays")
    return out


def find_loss_from_output_and_spec(output: Any, spec: Any):
    """The loss inside ``output``, marked by the single ``True`` leaf of the
    parallel ``spec`` tree; ``spec=True`` returns ``output`` itself."""
    if spec is True:
        return output
    found: List[Any] = []

    def visit(s, o):
        if s is True:
            found.append(o)
        elif isinstance(s, dict) and isinstance(o, dict):
            for k in sorted(s):
                visit(s[k], o[k])
        elif isinstance(s, (list, tuple)) and isinstance(o, (list, tuple)):
            for a, b in zip(s, o):
                visit(a, b)

    visit(spec, output)
    if len(found) != 1:
        raise ValueError(
            f"loss spec must select exactly one leaf, selected {len(found)}")
    return found[0]


def encode_obj(obj: Any) -> str:
    """Pickle -> base64 string.  Only for trusted in-job metadata, never
    external input."""
    return base64.b64encode(pickle.dumps(obj)).decode("ascii")


def decode_obj(s: str) -> Any:
    return pickle.loads(base64.b64decode(s.encode("ascii")))
