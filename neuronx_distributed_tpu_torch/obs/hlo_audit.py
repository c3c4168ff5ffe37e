"""Compile-time communication audit (counterpart of
``neuronx_distributed_tpu/obs/hlo_audit.py``).

PyTorch has no HLO.  The port's counterpart of a compiled program is a
``torch.fx.GraphModule`` (``make_fx``, ``symbolic_trace``) or a
``torch.export.ExportedProgram``: :func:`comm_audit` walks its graph for
the collective nodes (``torch.ops._c10d_functional.*``, the older
``c10d_functional.*`` and the in-place ``c10d.*`` forms), counts them by
kind under the JAX package's names (``all-reduce``, ``all-gather``,
``reduce-scatter``, ``collective-permute``, ``all-to-all``) and sums the
bytes of their results from each node's tensor metadata.  The record is
the JAX ``hlo_audit_v1`` record, so one reader serves both packages.

As in JAX, the bytes are the result-shape volume (for all-reduce the
tensor reduced, for all-gather the gathered output, for reduce-scatter the
scattered shard): a per-execution lower bound on the interconnect traffic
that stays stable whatever algorithm the library picks.  A serving
program at tensor-parallel degree 1 holds no collective.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Tuple

HLO_AUDIT_SCHEMA = "hlo_audit_v1"

COLLECTIVE_OPS = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "collective-permute",
    "all-to-all",
)

_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d")
# op name (overload dropped) -> collective kind
_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "allreduce_": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "recv_any_source_": "collective-permute",
}


def _graph(program: Any):
    """The ``torch.fx.Graph`` of a GraphModule, an ExportedProgram or a
    Graph."""
    import torch

    if isinstance(program, torch.fx.Graph):
        return program
    gm = getattr(program, "graph_module", program)
    graph = getattr(gm, "graph", None)
    if not isinstance(graph, torch.fx.Graph):
        raise TypeError(f"comm_audit takes a torch.fx.GraphModule, an "
                        f"ExportedProgram or a Graph, got "
                        f"{type(program).__name__}")
    return graph


def _kind(target: Any):
    """The collective kind of a call target, or None."""
    parts = str(target).split(".")
    if len(parts) < 2 or parts[0] not in _NAMESPACES:
        return None
    return _KINDS.get(parts[1])


def _result_bytes(node) -> int:
    """Bytes of a node's tensor results, from ``meta["val"]`` (fake or real
    tensors) or ``meta["tensor_meta"]``; 0 when the graph carries no
    metadata."""
    import torch

    val = node.meta.get("val", node.meta.get("tensor_meta"))
    vals = val if isinstance(val, (list, tuple)) else [val]
    total = 0
    for v in vals:
        if isinstance(v, torch.Tensor):
            total += v.numel() * v.element_size()
        elif v is not None and hasattr(v, "shape") and hasattr(v, "dtype"):
            n = 1
            for d in v.shape:
                n *= int(d)
            total += n * torch.empty((), dtype=v.dtype).element_size()
    return total


def _walk(program: Any) -> Tuple[Dict[str, int], Dict[str, int]]:
    counts = {op: 0 for op in COLLECTIVE_OPS}
    volumes = {op: 0 for op in COLLECTIVE_OPS}
    for node in _graph(program).nodes:
        if node.op != "call_function":
            continue
        kind = _kind(node.target)
        if kind is None:
            continue
        counts[kind] += 1
        volumes[kind] += _result_bytes(node)
    return counts, volumes


def collective_counts(program: Any) -> Dict[str, int]:
    """Count each collective kind in the program's graph."""
    return _walk(program)[0]


def collective_bytes(program: Any) -> Dict[str, int]:
    """Sum the result bytes of each collective kind in the program's
    graph."""
    return _walk(program)[1]


def comm_audit(program: Any, name: str = "program") -> dict:
    """One ``hlo_audit_v1`` record for a program: collective counts and
    result-byte volumes by kind, and their totals."""
    counts, volumes = _walk(program)
    return {
        "schema": HLO_AUDIT_SCHEMA,
        "name": name,
        "time": time.time(),
        "collective_counts": counts,
        "collective_bytes": volumes,
        "total_collective_count": sum(counts.values()),
        "total_collective_bytes": sum(volumes.values()),
    }


def append_audit(path: str, record: dict) -> None:
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")


def read_audits(path: str) -> List[dict]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
