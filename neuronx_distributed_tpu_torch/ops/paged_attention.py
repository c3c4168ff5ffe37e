"""Block-table-native paged-attention decode (hand-written CUDA on Hopper).

Counterpart of ``neuronx_distributed_tpu/ops/paged_attention.py``.  The
gather decode path rematerializes every slot's page chain into a contiguous
``[B, T, NKV, D]`` view before attending over it; this op walks the block
table in device memory instead, so a decode step reads only the pages each
slot attends.

- On a CUDA tensor :func:`paged_attention` launches a kernel of
  ``csrc/paged_attention.cu`` (built by ``nvcc`` at first use, bound with
  ``ctypes``) or raises; it never falls back.  :func:`paged_route` picks
  the kernel from the shape alone: ``"decode"``, the tensor-core decode
  kernel of ``csrc/paged_attention_decode.cuh``, for bf16 q at S = 1 with
  at most :data:`DECODE_MAX_G` q heads a kv head; ``"wgmma"``, the
  tensor-core kernel of ``csrc/paged_attention_wgmma.cuh``, for bf16 q
  with S > 1 (prefill chunks, verify rows); ``"simt"``, the scalar kernel
  ``paged_attention_kernel``, for fp32 q and wider kv-head groups.
- On a CPU tensor it runs :func:`paged_attention_reference`, the plain
  PyTorch version of the same arithmetic: gather, band-mask, per-split
  online-softmax partials and the split-K logsumexp merge.

Layout as in the JAX package: ``q [B, S, NQ, D]``; one layer's pool, the
fp pair ``(k, v)`` each ``[NP, page, NKV, D]`` or the int8 six-tuple ``(k,
v, k_scale, k_zero, v_scale, v_zero)`` with int8 pages and ``[NP]`` fp32
page params (``kvcache.quant``: ``x = (code + 128) * scale + zero``,
dequantized inside the kernel); ``block_table [B, PP]``; ``cache_offset
[B]`` (row ``s`` attends positions ``<= offset + s``; an offset ``>= PP *
page`` parks the slot, whose rows come back exact zeros); ``kv_start [B]``
(first valid key, the left-pad count).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch

from neuronx_distributed_tpu_torch.kvcache.quant import dequantize_page
from neuronx_distributed_tpu_torch.ops.flash_attention import NEG_INF

# keys per kernel tile and query rows per block (csrc/paged_attention.cu)
TILE_KEYS = 32
MAX_ROWS = 16
# query rows per block of the wgmma kernel (csrc/paged_attention_wgmma.cuh)
WGMMA_ROWS = 128
# the decode kernel (csrc/paged_attention_decode.cuh): q heads a kv head
# (one N tile of its m16n8k16 products), splits merged inside one
# thread-block cluster, and the keys a split walks at the least and, where
# the cluster allows, at the most
DECODE_MAX_G = 8
DECODE_MAX_CLUSTER = 8
DECODE_MIN_KEYS = 128
DECODE_MAX_KEYS = 1024
ROUTES = ("simt", "wgmma", "decode")
HEAD_DIMS = (64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
PARAM_NAMES = ("k_scale", "k_zero", "v_scale", "v_zero")


def resolve_paged_kernel(flag, device) -> bool:
    """Resolve the ``paged_kernel`` knob (``"auto"`` | ``True`` |
    ``False``): auto picks the kernel on a CUDA device and the gather path
    on the CPU.  An explicit value is honored anywhere; on the CPU the
    kernel flag runs the kernel's plain version."""
    if flag is True or flag is False:
        return flag
    if flag not in ("auto", None):
        raise ValueError(
            f"paged_kernel must be 'auto', True or False, got {flag!r}")
    return torch.device(device).type == "cuda"


def _check_pool(q, kv_pages):
    if len(kv_pages) not in (2, 6):
        raise ValueError(
            f"kv_pages must be a layer's fp pair or int8 six-tuple, got "
            f"{len(kv_pages)} arrays")
    if q.shape[2] % kv_pages[0].shape[2]:
        raise ValueError(
            f"q heads ({q.shape[2]}) must group over kv heads "
            f"({kv_pages[0].shape[2]})")


def gather_pages(kv_pages, block_table: torch.Tensor,
                 dtype: torch.dtype = torch.float32):
    """The gather path's ``[B, T, NKV, D]`` K/V views of one layer's pool
    through the block table.  An int8 pool's gathered pages are
    dequantized to ``dtype``, the compute type (its page params gathered
    alongside); an fp pool's come back in the pool's type."""
    bt = block_table.long()
    B, T = bt.shape[0], bt.shape[1] * kv_pages[0].shape[1]
    ck, cv = kv_pages[:2]
    if len(kv_pages) == 6:
        ks, kz, vs, vz = kv_pages[2:]
        k = dequantize_page(ck[bt], ks[bt], kz[bt], dtype)
        v = dequantize_page(cv[bt], vs[bt], vz[bt], dtype)
    else:
        k, v = ck[bt], cv[bt]
    return (k.reshape(B, T, ck.shape[2], ck.shape[3]),
            v.reshape(B, T, cv.shape[2], cv.shape[3]))


def merge_splits(acc, m, l, S: int, dtype) -> torch.Tensor:
    """Flash-Decoding epilogue: merge split-K partials ``acc [B, NKV, sk,
    G*S, D]``, ``m``/``l [B, NKV, sk, G*S]`` by logsumexp weight into
    ``[B, S, NQ, D]``.  An empty split (``m = NEG_INF, l = 0, acc = 0``)
    contributes nothing; a row with ``l* = 0`` (parked slot, or no visible
    key) comes out exact zeros."""
    B, NKV, _, rows, D = acc.shape
    G = rows // S
    m_star = m.max(dim=2, keepdim=True).values
    w = torch.exp(m - m_star)
    l_star = (l * w).sum(dim=2)                      # [B, NKV, rows]
    o = (acc * w[..., None]).sum(dim=2)              # [B, NKV, rows, D]
    safe_l = torch.where(l_star == 0.0, torch.ones_like(l_star), l_star)
    o = o / safe_l[..., None]
    return o.reshape(B, NKV, S, G, D).permute(0, 2, 1, 3, 4).reshape(
        B, S, NKV * G, D).to(dtype)


def paged_attention_reference(q, kv_pages, block_table, cache_offset,
                              kv_start=None, *, sm_scale=None, window=None,
                              softcap=None, split_k: int = 1) -> torch.Tensor:
    """The plain version, in fp32 from the given inputs: gather the chain
    into the contiguous ``[B, T]`` view (the gather path's math; int8 pages
    dequantized to ``q.dtype`` first, as the kernel does), band-mask,
    compute unnormalized online-softmax partials over ``split_k`` equal
    pieces of the chain, and merge them with :func:`merge_splits`.  Parked
    slots and rows that see no key are exact zeros, as in the kernel."""
    _check_pool(q, kv_pages)
    B, S, NQ, D = q.shape
    NKV = kv_pages[0].shape[2]
    G = NQ // NKV
    T = block_table.shape[1] * kv_pages[0].shape[1]
    k, v = (x.float() for x in gather_pages(kv_pages, block_table, q.dtype))
    scale = (D ** -0.5) if sm_scale is None else sm_scale
    qg = q.float().reshape(B, S, NKV, G, D)
    s = torch.einsum("bskgd,btkd->bksgt", qg, k).reshape(B, NKV, S * G, T)
    s = s * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    off = cache_offset.long()
    qpos = off[:, None] + torch.arange(S, device=q.device)[None, :]   # [B, S]
    kpos = torch.arange(T, device=q.device)
    mask = kpos[None, None, :] <= qpos[:, :, None]                    # [B, S, T]
    if window is not None:
        mask = mask & (kpos[None, None, :] > qpos[:, :, None] - window)
    if kv_start is not None:
        mask = mask & (kpos[None, None, :] >= kv_start.long()[:, None, None])
    mask = mask & (off < T)[:, None, None]
    mask = mask[:, None, :, None, :].expand(B, 1, S, G, T).reshape(
        B, 1, S * G, T)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    accs, ms, ls = [], [], []
    for idx in torch.arange(T, device=q.device).tensor_split(
            max(1, min(int(split_k), T))):
        sj, mj = s[..., idx], mask[..., idx]
        m_j = sj.max(dim=-1).values
        p = torch.where(mj, torch.exp(sj - m_j[..., None]),
                        torch.zeros_like(sj))
        ls.append(p.sum(dim=-1))
        ms.append(m_j)
        accs.append(torch.einsum("bkrt,btkd->bkrd", p, v[:, idx]))
    return merge_splits(torch.stack(accs, 2), torch.stack(ms, 2),
                        torch.stack(ls, 2), S, q.dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def default_split_k(B: int, NKV: int, rows: int, T: int,
                    sm_count: int) -> int:
    """The simt kernel's default split: enough splits for about two blocks
    per SM, and never so many that a split walks fewer than four key tiles
    of the chain."""
    blocks = B * NKV * -(-rows // MAX_ROWS)
    return max(1, min(2 * sm_count // max(blocks, 1), T // (4 * TILE_KEYS)))


def paged_route(dtype: torch.dtype, S: int, G: int) -> str:
    """The kernel a CUDA call runs, from its shape alone (``G`` q heads a
    kv head): for bf16 q, ``"decode"`` at S = 1 with G <= DECODE_MAX_G and
    ``"wgmma"`` at S > 1 (chip_smoke.py's route sweep, PERF.md, times it
    against the scalar kernel down to two query rows a kv head); else
    ``"simt"`` (fp32 q, which neither tensor-core kernel has a mode for,
    and decode of wider groups)."""
    if dtype == torch.bfloat16 and S > 1:
        return "wgmma"
    if dtype == torch.bfloat16 and G <= DECODE_MAX_G:
        return "decode"
    return "simt"


def _check_route(route: str, dtype: torch.dtype, S: int, G: int) -> None:
    """Raise unless the named kernel takes q of this dtype, width ``S``
    and ``G`` q heads a kv head."""
    if route != "simt" and dtype != torch.bfloat16:
        raise TypeError(f"the {route} paged kernel takes bfloat16 q, got "
                        f"{dtype}")
    if route == "decode" and S != 1:
        raise ValueError(f"the decode paged kernel takes one query position "
                         f"a slot, got S = {S}")
    if route == "decode" and G > DECODE_MAX_G:
        raise ValueError(f"the decode paged kernel takes at most "
                         f"{DECODE_MAX_G} q heads a kv head, got {G}")


def wgmma_tile_keys(D: int) -> int:
    """Keys per tile of the wgmma kernel at head dim ``D``."""
    return 32 if D >= 256 else 64


def wgmma_split_k(B: int, NKV: int, rows: int, T: int, D: int,
                  sm_count: int) -> int:
    """The wgmma kernel's default split: about one block per SM (a block
    of 384 threads and ~170 KB of shared memory fills one), and never so
    many that a split walks fewer than two key tiles of the chain."""
    blocks = B * NKV * -(-rows // WGMMA_ROWS)
    return max(1, min(sm_count // max(blocks, 1),
                      T // (2 * wgmma_tile_keys(D))))


def decode_split_k(B: int, NKV: int, T: int, sm_count: int) -> int:
    """The decode kernel's default split, from shapes alone (never the
    offsets, which live on the device): enough splits for about two
    blocks per SM and for no split of a T-key chain to walk more than
    DECODE_MAX_KEYS; at most one cluster (DECODE_MAX_CLUSTER), and never
    so many that a split walks fewer than DECODE_MIN_KEYS keys.  Neither
    D nor G enters: every G <= DECODE_MAX_G is one N tile, and the ring
    is sized to <= 64 KB at every head dim and pool type (three blocks
    fit an SM, so all of a call's clusters fit at once)."""
    fill = 2 * sm_count // max(B * NKV, 1)
    return max(1, min(max(fill, -(-T // DECODE_MAX_KEYS)),
                      DECODE_MAX_CLUSTER, T // DECODE_MIN_KEYS))


def _launch(q, kv_pages, bt, off, start, scale, window, softcap, split_k,
            route):
    """Validate, allocate and launch on the current stream; raises on any
    input the kernel does not take and on a refused launch.  An fp pool
    shares q's type; an int8 pool takes bf16 or fp32 q and four contiguous
    ``[NP]`` fp32 page-param arrays."""
    dev = q.device
    quant = len(kv_pages) == 6
    ck, cv = kv_pages[:2]
    params = tuple(kv_pages[2:])
    named = (("q", q), ("k pool", ck), ("v pool", cv), ("block_table", bt),
             ("cache_offset", off), ("kv_start", start)) + tuple(
                 zip(PARAM_NAMES, params))
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in named[1:3]:  # the kernel reads pages as 16-byte vectors
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"paged_attention kernel takes float32 or bfloat16 "
                        f"q, got {q.dtype}")
    pool_dtype = torch.int8 if quant else q.dtype
    if ck.dtype != pool_dtype or cv.dtype != pool_dtype:
        raise TypeError(f"pool dtype ({ck.dtype}, {cv.dtype}) must be "
                        f"{pool_dtype} for {len(kv_pages)} pool arrays and "
                        f"q {q.dtype}")
    for name, t in named[3:6]:
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    B, S, NQ, D = q.shape
    NP, page, NKV, Dk = ck.shape
    if cv.shape != ck.shape or Dk != D:
        raise ValueError(f"pool shapes {tuple(ck.shape)}/{tuple(cv.shape)} "
                         f"do not fit q {tuple(q.shape)}")
    for name, t in named[6:]:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.shape != (NP,):
            raise ValueError(f"{name} shape {tuple(t.shape)} != ({NP},): "
                             "one param per physical page")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    PP = bt.shape[1]
    if bt.shape[0] != B or off.shape != (B,) or start.shape != (B,):
        raise ValueError(
            f"block_table {tuple(bt.shape)}, cache_offset "
            f"{tuple(off.shape)}, kv_start {tuple(start.shape)} do not fit "
            f"batch {B}")
    G = NQ // NKV
    rows = G * S
    route = paged_route(q.dtype, S, G) if route is None else route
    _check_route(route, q.dtype, S, G)
    if route == "decode" and q.data_ptr() % 16:  # q rows as 16-byte vectors
        raise ValueError("q must be 16-byte aligned")
    if split_k is None:
        sms = _sm_count(dev.index if dev.index is not None
                        else torch.cuda.current_device())
        if route == "wgmma":
            split_k = wgmma_split_k(B, NKV, rows, PP * page, D, sms)
        elif route == "decode":
            split_k = decode_split_k(B, NKV, PP * page, sms)
        else:
            split_k = default_split_k(B, NKV, rows, PP * page, sms)
    split_k = int(split_k)
    if split_k < 1:
        raise ValueError(f"split_k must be >= 1, got {split_k}")
    from neuronx_distributed_tpu_torch.ops._build import load

    lib = load("paged_attention")
    out = torch.empty_like(q)
    acc = m = l = None
    # the split-K workspace the epilogue merges (the decode kernel merges
    # up to a cluster's splits in shared memory)
    if split_k > (DECODE_MAX_CLUSTER if route == "decode" else 1):
        acc = torch.empty((B, NKV, split_k, rows, D), dtype=torch.float32,
                          device=dev)
        m = torch.empty((B, NKV, split_k, rows), dtype=torch.float32,
                        device=dev)
        l = torch.empty_like(m)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    ks, kz, vs, vz = params if quant else (None,) * 4
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        pointers = (ptr(q), ptr(ck), ptr(cv), ptr(ks), ptr(kz), ptr(vs),
                    ptr(vz), ptr(bt), ptr(off), ptr(start), ptr(out),
                    ptr(acc), ptr(m), ptr(l))
        sizes = (B, S, NQ, NKV, D, NP, page, PP, float(scale),
                 int(window or 0), float(softcap or 0.0), split_k, stream)
        if route == "wgmma":
            rc = lib.paged_attention_wgmma_fwd(int(quant), *pointers, *sizes)
        elif route == "decode":
            rc = lib.paged_attention_decode_fwd(int(quant), *pointers, *sizes)
        else:
            rc = lib.paged_attention_fwd(_DTYPE_CODE[q.dtype], int(quant),
                                         *pointers, *sizes)
    if rc != 0:
        raise RuntimeError(f"paged_attention {route} kernel launch failed "
                           f"(code {rc})")
    paged_attention.launches += 1
    paged_attention.int8_launches += int(quant)
    paged_attention.wgmma_launches += int(route == "wgmma")
    paged_attention.decode_launches += int(route == "decode")
    return out


def paged_attention(q: torch.Tensor, kv_pages: Sequence[torch.Tensor],
                    block_table: torch.Tensor, cache_offset: torch.Tensor,
                    kv_start: Optional[torch.Tensor] = None, *,
                    sm_scale: Optional[float] = None,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    split_k: Optional[int] = None) -> torch.Tensor:
    """Attention straight over one layer's page pool (the fp pair or the
    int8 six-tuple); returns ``[B, S, NQ, D]`` in ``q.dtype``.
    ``window``/``softcap``/``sm_scale`` are the sliding window, logit
    softcap and score scale (default ``D ** -0.5``).  ``split_k`` splits
    each slot's key range over that many blocks (default: from the card's
    SM count, by the route's own policy) whose partials are merged by
    logsumexp weight.  CUDA tensors launch the kernel :func:`paged_route`
    picks (and count in ``paged_attention.launches``, int8 pools also in
    ``paged_attention.int8_launches``, the wgmma and decode routes also in
    ``paged_attention.wgmma_launches`` and ``.decode_launches``); CPU
    tensors run :func:`paged_attention_reference`."""
    return _paged_attention(q, kv_pages, block_table, cache_offset, kv_start,
                            sm_scale, window, softcap, split_k, None)


def _paged_attention_on(route: str, q, kv_pages, block_table, cache_offset,
                        kv_start=None, *, sm_scale=None, window=None,
                        softcap=None, split_k=None) -> torch.Tensor:
    """:func:`paged_attention` on CUDA tensors through the named kernel
    (one of :data:`ROUTES`) instead of :func:`paged_route`'s pick, so that
    one shape can be held and timed on each; a route that does not take
    the inputs raises."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if q.device.type != "cuda":
        raise ValueError(f"the {route} route is a CUDA kernel; q is on "
                         f"{q.device}")
    return _paged_attention(q, kv_pages, block_table, cache_offset, kv_start,
                            sm_scale, window, softcap, split_k, route)


def _paged_attention(q, kv_pages, block_table, cache_offset, kv_start,
                     sm_scale, window, softcap, split_k, route):
    _check_pool(q, kv_pages)
    if window is not None and window < 1:
        raise ValueError(f"sliding window must be >= 1, got {window}")
    scale = (q.shape[-1] ** -0.5) if sm_scale is None else sm_scale
    if q.device.type == "cpu":
        return paged_attention_reference(
            q, kv_pages, block_table, cache_offset, kv_start,
            sm_scale=scale, window=window, softcap=softcap,
            split_k=split_k or 1)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu, got "
                         f"{q.device}")
    if kv_start is None:
        kv_start = torch.zeros(q.shape[0], dtype=torch.int32,
                               device=q.device)
    return _launch(q, tuple(kv_pages), block_table, cache_offset, kv_start,
                   scale, window, softcap, split_k, route)


paged_attention.launches = 0
paged_attention.int8_launches = 0
paged_attention.wgmma_launches = 0
paged_attention.decode_launches = 0
