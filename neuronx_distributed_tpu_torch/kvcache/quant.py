"""Int8 page quantization for the paged KV cache (counterpart of
``neuronx_distributed_tpu/kvcache/quant.py``).

A quantized page pool stores each ``[page, NKV, D]`` page as int8 plus ONE
fp32 ``(scale, zero)`` pair per page: the asymmetric affine code ``x ≈ (q +
128) * scale + zero``.  A page then costs half of a bf16 page plus 16 bytes
of params, so the same device memory holds about twice the pages.  The
quantization unit is the page, the unit the allocator refcounts: pages are
quantized where they are written (``write_page`` at admission, the
block-table scatter of decode steps and prefill chunks) and dequantized
where they are read (the gather path, and the paged-attention kernel's int8
branch).

Error model: half a quantization step, ``(max - min) / 255 / 2`` per page
(:func:`quant_error_bound`).  A constant page gets ``scale == 0`` and
round-trips exactly through ``zero``.  ``torch.round`` rounds half to even,
as ``jnp.round`` does, so codes equal the JAX package's.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from neuronx_distributed_tpu_torch.parallel.mappings import all_reduce, group_size

# int8 codes span [-128, 127]; the affine form uses the unsigned view
_LEVELS = 255.0
_OFFSET = 128.0
QUANTS = ("int8",)

# registry counter: pages written through a quantize-on-write path
QUANT_PAGES_TOTAL = "kvcache/quant_pages_total"


def page_ranges(pages: Sequence[torch.Tensor], group=None) -> list:
    """``(min, max)`` over the trailing ``[page, NKV, D]`` axes of each
    tensor of ``pages``, fp32.  A tensor-parallel rank holds ``NKV / tp``
    heads of every page, and a page's code is over ALL its heads (the JAX
    package's GSPMD reduces the page's min/max across the shards): with a
    ``group`` of more than one rank, the statistics of every tensor are
    reduced over it in ONE all-reduce (None: this rank's own range) (``MAX`` of ``[max, -min]``), so each
    rank's codes are the tp = 1 page's codes for its heads."""
    mins = [x.float().amin(dim=(-3, -2, -1)) for x in pages]
    maxs = [x.float().amax(dim=(-3, -2, -1)) for x in pages]
    if group is None or group_size(group) == 1:
        return list(zip(mins, maxs))
    sizes = [m.numel() for m in mins]
    packed = torch.cat([m.reshape(-1) for m in maxs]
                       + [-m.reshape(-1) for m in mins])
    packed = all_reduce(packed, group, op=dist.ReduceOp.MAX,
                        kind="page_stats")
    n = sum(sizes)
    out, at = [], 0
    for m, k in zip(mins, sizes):
        out.append((-packed[n + at:n + at + k].reshape(m.shape),
                    packed[at:at + k].reshape(m.shape)))
        at += k
    return out


def quantize_page(x: torch.Tensor, stats=None):
    """Quantize pages over their trailing ``[page, NKV, D]`` axes.

    ``x`` is ``[..., page, NKV, D]`` float; returns ``(q int8, scale fp32,
    zero fp32)`` with ``scale``/``zero`` shaped like the leading axes:
    ``zero = min(x)``, ``scale = (max - min) / 255``.  ``stats``: the
    page's ``(min, max)`` from :func:`page_ranges` (a tensor-parallel
    shard's whole-page range); None computes them from ``x``."""
    xf = x.float()
    mn, mx = page_ranges([xf])[0] if stats is None else stats
    scale = (mx - mn) / _LEVELS
    safe = torch.where(scale > 0.0, scale, torch.ones_like(scale))
    q = torch.round((xf - mn[..., None, None, None])
                    / safe[..., None, None, None])
    q = q.clamp(0.0, _LEVELS) - _OFFSET
    return q.to(torch.int8), scale, mn


def dequantize_page(q: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Invert :func:`quantize_page`: ``q`` is ``[..., page, NKV, D]`` int8,
    ``scale``/``zero`` its leading-axes fp32 params; the fp32 result is
    rounded once to ``dtype``."""
    xf = (q.float() + _OFFSET) * scale[..., None, None, None] \
        + zero[..., None, None, None]
    return xf.to(dtype)


def quant_error_bound(x) -> float:
    """Largest round-trip error the page code permits for the given page
    content: half a quantization step, plus fp32 rounding slack."""
    xf = np.asarray(x, np.float32)
    return float((xf.max() - xf.min()) / _LEVELS / 2.0 + 1e-6)


def check_quant(quant: Optional[str]) -> None:
    if quant is not None and quant not in QUANTS:
        raise ValueError(f"unknown KV quantization {quant!r} "
                         "(supported: 'int8')")


def page_layer_bytes(page_size: int, num_kv_heads: int, head_dim: int,
                     quant: Optional[str], dtype: torch.dtype) -> int:
    """Device bytes ONE page costs for ONE layer's k + v: the fp pool pays
    ``2 * page * NKV * D * itemsize``; the int8 pool 1 byte per element
    plus four fp32 page params (k/v scale and zero)."""
    check_quant(quant)
    elems = page_size * num_kv_heads * head_dim
    if quant is None:
        return 2 * elems * (torch.finfo(dtype).bits // 8)
    return 2 * elems + 4 * 4
