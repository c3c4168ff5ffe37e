"""PyTorch port: ``utils.dtypes`` against the JAX package's.

One numpy tree (nested dicts and a list; fp32, fp16, bf16, int32, bool
and an int64 step counter) goes to JAX as arrays and to the port as
tensors: ``cast_floating`` must cast the same leaves (integer and bool
leaves untouched) and ``audit_dtypes`` must report the same paths and
dtype names, and raise the same ``TypeError`` text.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.utils.dtypes import (
    audit_dtypes as jax_audit,
    cast_floating as jax_cast,
)
from neuronx_distributed_tpu_torch.utils.dtypes import (
    audit_dtypes,
    cast_floating,
    dtype_name,
)


def numpy_tree(n_extra=0):
    rs = np.random.RandomState(0)
    tree = {
        "layer": {"weight": rs.standard_normal((3, 4)).astype(np.float32),
                  "bias": rs.standard_normal(4).astype(np.float16)},
        "embed": rs.standard_normal((5, 2)).astype(ml_dtypes.bfloat16),
        "ids": rs.randint(0, 9, (2, 3)).astype(np.int32),
        "mask": rs.rand(2, 3) > 0.5,
        "step": np.array(7, np.int64),
        "stack": [rs.standard_normal(2).astype(np.float32),
                  rs.standard_normal(2).astype(np.float16)],
    }
    for i in range(n_extra):
        tree[f"extra_{i:02d}"] = np.zeros(1, np.float16)
    return tree


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_torch(v) for v in tree]
    if tree.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(tree.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(tree))


def _names(report):
    return [(p, dtype_name(d) if isinstance(d, torch.dtype) else
             jnp.dtype(d).name) for p, d in report]


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}[{i}]")
    else:
        yield path, tree


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float16"])
def test_cast_floating_matches_jax(dtype):
    np_tree = numpy_tree()
    want = dict(_flat(jax_cast(np_tree, getattr(jnp, dtype))))
    got = dict(_flat(cast_floating(to_torch(np_tree), getattr(torch, dtype))))
    assert set(got) == set(want)
    for path, leaf in got.items():
        ref = want[path]
        assert dtype_name(leaf.dtype) == jnp.dtype(ref.dtype).name, path
        np.testing.assert_array_equal(
            leaf.float().numpy() if leaf.is_floating_point() else
            leaf.numpy(), np.asarray(ref).astype(
                np.float32 if leaf.is_floating_point() else ref.dtype), path)
    assert cast_floating(to_torch(np_tree), dtype)["ids"].dtype == torch.int32


@pytest.mark.parametrize("expected", ["float32", "bfloat16", "float16"])
def test_audit_matches_jax(expected):
    np_tree = numpy_tree()
    want = _names(jax_audit(np_tree, getattr(jnp, expected)))
    got = _names(audit_dtypes(to_torch(np_tree), getattr(torch, expected)))
    assert got == want and got
    assert all("ids" not in p and "mask" not in p and "step" not in p
               for p, _ in got)
    assert audit_dtypes(cast_floating(to_torch(np_tree), expected),
                        expected) == []


@pytest.mark.parametrize("n_extra", [0, 12], ids=["short", "more_than_ten"])
def test_audit_raises_jax_text(n_extra):
    np_tree = numpy_tree(n_extra)
    with pytest.raises(TypeError) as jax_err:
        jax_audit(np_tree, jnp.float32, raise_on_mismatch=True)
    with pytest.raises(TypeError) as port_err:
        audit_dtypes(to_torch(np_tree), torch.float32, raise_on_mismatch=True)
    assert str(port_err.value) == str(jax_err.value)
    assert audit_dtypes({"w": torch.zeros(2)}, torch.float32,
                        raise_on_mismatch=True) == []


def test_state_dict_and_refusal():
    sd = torch.nn.Linear(2, 3).state_dict()
    assert audit_dtypes(sd, torch.float32) == []
    assert [p for p, _ in audit_dtypes(sd, "bfloat16")] == ["['bias']",
                                                            "['weight']"]
    cast = cast_floating(sd, torch.bfloat16)
    assert list(cast) == list(sd) and cast["weight"].dtype == torch.bfloat16
    with pytest.raises(TypeError, match="not a dtype"):
        cast_floating(sd, "float33")
