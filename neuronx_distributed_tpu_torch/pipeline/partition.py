"""Stage partitioning for pipeline parallelism (a copy of
``neuronx_distributed_tpu/pipeline/partition.py``, pure logic).

A partition assigns contiguous spans of layer indices to stages.  The JAX
engine realises it as a padded ``[L', ...]`` layer stack sharded over
``pp`` (the ``*_layout*`` functions give each real layer's stack row and
the padding mask); the port's stages hold their real layers only
(:mod:`.engine`), and keeps the row of each layer as
``PipelinedModel.layer_rows``, which is what the converter
(``convert.jax_params.pipelined_params_from_jax``) indexes JAX's stack
with.  Interleaved placement is Megatron's: virtual stage ``s = v * P +
r`` lives on rank ``r`` as its chunk ``v``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


def partition_uniform(num_layers: int, num_stages: int) -> List[Tuple[int, int]]:
    """Balanced contiguous ``[start, end)`` layer spans, one per stage.

    When ``num_layers`` is not divisible, earlier stages receive the extra
    layers — they also hold more in-flight microbatches under 1F1B, but the
    imbalance is at most one layer (matching the reference's convention of
    user-chosen ``pipeline_cuts``)."""
    if num_stages < 1:
        raise ValueError("num_stages must be >= 1")
    if num_layers < num_stages:
        raise ValueError(f"cannot split {num_layers} layers into {num_stages} stages")
    base, extra = divmod(num_layers, num_stages)
    spans = []
    start = 0
    for s in range(num_stages):
        size = base + (1 if s < extra else 0)
        spans.append((start, start + size))
        start += size
    return spans


def spans_from_cuts(cuts: Sequence[int], num_layers: int) -> List[Tuple[int, int]]:
    """Spans from explicit cut points (the reference's ``pipeline_cuts``:
    layer indices that begin a new stage)."""
    bounds = [0, *cuts, num_layers]
    if bounds != sorted(bounds) or len(set(bounds)) != len(bounds):
        raise ValueError(f"cuts {cuts} must be strictly increasing within (0, {num_layers})")
    return [(bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)]


def layers_per_stage(num_layers: int, num_stages: int) -> int:
    """Uniform layer count per stage; raises unless evenly divisible (the
    stacked-parameter engine requires homogeneous stages).  Non-divisible
    models are padded first — see :func:`padded_layer_layout`."""
    if num_layers % num_stages != 0:
        raise ValueError(
            f"num_layers={num_layers} must be divisible by num_stages={num_stages} "
            "for the stacked pipeline engine; pad the model or choose another pp size"
        )
    return num_layers // num_stages


def layout_from_spans(
    spans: Sequence[Tuple[int, int]], num_stages: int
) -> Tuple[int, List[int], List[int]]:
    """Padded stack layout realizing an arbitrary contiguous stage partition.

    The engine's "partition" is a sharding of a homogeneous ``[L', ...]``
    layer stack over ``pp``; ``L' = max-span * P`` with padded rows holding
    zero parameters and an ``active=0`` flag: the engine computes them
    uniformly (SPMD) but selects the identity, so numerics equal the
    unpadded model exactly and the ``where`` transpose zeroes their
    gradients.  Real layers fill each stage's leading rows.

    Returns ``(padded_len, row_of_layer, mask)``: ``row_of_layer[i]`` is the
    stack row of real layer ``i`` (execution order preserved), ``mask[r]``
    is 1 for real rows, 0 for padding; ``mask is None`` never happens here —
    callers drop the mask themselves when every span is full.
    """
    if len(spans) != num_stages:
        raise ValueError(f"{len(spans)} spans for {num_stages} stages")
    per = max(hi - lo for lo, hi in spans)
    padded = per * num_stages
    row_of_layer: List[int] = []
    mask = [0] * padded
    for s, (lo, hi) in enumerate(spans):
        for j in range(hi - lo):
            row = s * per + j
            row_of_layer.append(row)
            mask[row] = 1
    return padded, row_of_layer, mask


def interleaved_layout_from_spans(
    spans: Sequence[Tuple[int, int]], num_stages: int, num_chunks: int
) -> Tuple[int, List[int], List[int]]:
    """Padded stack layout for the interleaved (virtual-stage) assignment
    with arbitrary contiguous virtual-stage spans — what lets
    ``pipeline_cuts`` compose with ``virtual_stages`` (VERDICT r4 #3).

    ``spans`` has one ``[lo, hi)`` entry per *virtual* stage in execution
    order; virtual stage ``s = v*P + r`` (Megatron assignment) lives on rank
    ``r`` as its chunk ``v``.  Every chunk is padded to the widest span
    (``per``), so each rank's local stack is a uniform ``V*per`` rows —
    chunk ``v`` at local rows ``[v*per, (v+1)*per)`` — and the engine's
    dynamic chunk slicing stays shape-uniform; the mask marks real rows
    exactly as :func:`layout_from_spans` does for the contiguous layout.

    Returns ``(padded_len, row_of_layer, mask)`` with
    ``padded_len = P*V*per``; for uniform divisible spans the mask is all
    ones and the rows reproduce the classic interleaved assignment."""
    P, V = num_stages, num_chunks
    if len(spans) != P * V:
        raise ValueError(
            f"{len(spans)} spans for {P}*{V} virtual stages")
    per = max(hi - lo for lo, hi in spans)
    padded = per * P * V
    row_of_layer: List[int] = []
    mask = [0] * padded
    for s, (lo, hi) in enumerate(spans):
        v, r = divmod(s, P)
        for j in range(hi - lo):
            row = r * (V * per) + v * per + j
            row_of_layer.append(row)
            mask[row] = 1
    return padded, row_of_layer, mask


def padded_layer_layout(num_layers: int, num_stages: int) -> Tuple[int, List[int], List[int]]:
    """:func:`layout_from_spans` over the balanced :func:`partition_uniform`
    spans — the default layout for a non-divisible layer count (earlier
    stages take the extra layers, the reference's ``pipeline_cuts``
    convention, reference ``pipeline/partition.py:17-42``)."""
    return layout_from_spans(partition_uniform(num_layers, num_stages), num_stages)
