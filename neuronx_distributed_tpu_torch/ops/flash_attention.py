"""Flash attention (hand-written CUDA on Hopper), forward and backward, with
GQA, causal/sliding-window/segment masks and logit softcapping.

Counterpart of ``neuronx_distributed_tpu/ops/flash_attention.py``.  Layout
as in the JAX package: ``q [B, HQ, S, D]``, ``k/v [B, HKV, T, D]`` with
``HQ = G * HKV`` (q head ``h`` reads kv head ``h // G``); with ``causal``
and ``T > S`` the queries sit at the last ``S`` positions of the kv
timeline.  The four public entries are ``torch.autograd.Function``s over
three kernels, each with a plain PyTorch version beside it:

- :func:`flash_attention_fwd` (TPU ``_fwd_kernel``): o and the per-row
  logsumexp ``lse [B, HQ, S]`` (fp32); plain version
  :func:`flash_fwd_reference`;
- :func:`flash_attention_dq` (TPU ``_dq_kernel``): dq from o's lse and
  ``delta = rowsum(dO * O)``; plain version :func:`flash_dq_reference`;
- :func:`flash_attention_dkv` (TPU ``_dkv_kernel``): dk and dv, summed over
  each kv head's G q heads inside the kernel; plain version
  :func:`flash_dkv_reference`.

Under an active cost counter (:mod:`~..utils.profiling`) each wrapper
declares :func:`flash_cost` for its call, on either route, and its own ops
are not counted.

On a CUDA tensor a wrapper launches its kernel (``csrc/flash_attention.cuh``,
built by ``nvcc`` at first use into one library for head_dim 64 and 128 and
one for 256, bound with ``ctypes``) or raises, and counts the launch in its
``launches``; on a CPU tensor it runs its plain version.  bf16 runs the
Hopper kernels (TMA, ``wgmma``, warp-specialised: ``flash_fwd_wgmma_kernel``,
``flash_dq_wgmma_kernel``, ``flash_dkv_wgmma_kernel``), fp32 the
``mma.sync``-shaped ones (``wgmma`` has no fp32 mode).
A masked key has probability exactly 0, so a row with no visible key
(segment id 0, or a segment absent from the keys) gets o = 0 and lse =
``NEG_INF``; the JAX kernels leave such rows' o undefined, and they are
compared on valid rows only.  The TPU kernels' block-size limit
(``_block_sizes``) is Pallas-only: any S and T work here.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import numpy as np
import torch

from neuronx_distributed_tpu_torch.utils import profiling

NEG_INF = float(-1e30)  # large-negative instead of -inf: keeps exp/where NaN-free
# the kernel library built for each head dim (csrc/<name>.cu)
_LIBRARY = {64: "flash_attention", 128: "flash_attention",
            256: "flash_attention_d256"}
HEAD_DIMS = tuple(_LIBRARY)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def band_mask(q_len: int, kv_len: int,
              q_offset: Union[int, torch.Tensor] = 0,
              window: Optional[int] = None,
              device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """Boolean ``[q_len, kv_len]`` causal(+sliding-window) mask, True =
    attend: q position i (global ``i + q_offset``) attends kv positions
    ``<=`` its own and, with ``window``, no further back than ``window - 1``
    positions.  A ``[B]`` tensor ``q_offset`` gives one mask per row,
    ``[B, q_len, kv_len]``."""
    if window is not None and window < 1:
        raise ValueError(f"sliding window must be >= 1, got {window}")
    q_pos = torch.arange(q_len, device=device)[:, None]
    if isinstance(q_offset, torch.Tensor) and q_offset.ndim == 1:
        q_pos = q_pos[None] + q_offset.to(device)[:, None, None]
    else:
        q_pos = q_pos + q_offset
    kv_pos = torch.arange(kv_len, device=device)
    mask = kv_pos <= q_pos
    if window is not None:
        mask = mask & (kv_pos > q_pos - window)
    return mask


def _check_options(causal: bool, window: Optional[int],
                   softcap: Optional[float]) -> None:
    if window is not None and (not causal or window < 1):
        raise ValueError("window requires causal=True and window >= 1")
    if softcap is not None and softcap <= 0.0:
        raise ValueError(f"softcap must be > 0, got {softcap}")


def _scale(q: torch.Tensor, sm_scale: Optional[float]) -> float:
    return (q.shape[-1] ** -0.5) if sm_scale is None else float(sm_scale)


def mha_reference(q, k, v, causal: bool = True,
                  sm_scale: Optional[float] = None,
                  window: Optional[int] = None,
                  softcap: Optional[float] = None) -> torch.Tensor:
    """Dense oracle (same math, full score matrix): fp32 scores, ``softcap *
    tanh(s / softcap)`` before the causal(+window) mask, softmax, and the
    probabilities cast to ``v.dtype`` before ``p.V``."""
    _check_options(causal, window, softcap)
    G = q.shape[1] // k.shape[1]
    kk = k.repeat_interleave(G, dim=1)
    vv = v.repeat_interleave(G, dim=1)
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), kk.float()) * _scale(
        q, sm_scale)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    if causal:
        S, T = q.shape[2], k.shape[2]
        mask = band_mask(S, T, T - S, window, device=q.device)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", p.to(v.dtype), vv).to(q.dtype)


# ---------------------------------------------------------------------------
# plain versions of the three kernels (fp32, blockless)
# ---------------------------------------------------------------------------


def attention_mask(S: int, T: int, causal: bool, window: Optional[int],
                   q_seg: Optional[torch.Tensor] = None,
                   kv_seg: Optional[torch.Tensor] = None,
                   device="cpu") -> torch.Tensor:
    """Boolean ``[1 or B, 1, S, T]`` mask of visible (query, key) pairs:
    causal at kv offset ``T - S`` (with the window), and with segment ids
    only equal nonzero ids."""
    if causal:
        mask = band_mask(S, T, T - S, window, device=device)
    else:
        mask = torch.ones((S, T), dtype=torch.bool, device=device)
    mask = mask[None, None]
    if q_seg is not None:
        qs = q_seg.to(device)[:, :, None]
        same = (qs == kv_seg.to(device)[:, None, :]) & (qs > 0)
        mask = mask & same[:, None]
    return mask


def _scores(q, k, scale, softcap):
    """fp32 scores ``[B, HQ, S, T]`` after scale and cap, and ``tanh(x /
    softcap)`` (None without a cap)."""
    G = q.shape[1] // k.shape[1]
    s = torch.einsum("bhsd,bhtd->bhst", q.float(),
                     k.float().repeat_interleave(G, dim=1)) * scale
    if softcap is None:
        return s, None
    th = torch.tanh(s / softcap)
    return softcap * th, th


def flash_fwd_reference(q, k, v, q_seg=None, kv_seg=None, *,
                        causal: bool = True, sm_scale: Optional[float] = None,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's plain version: ``(o [B, HQ, S, D] in q.dtype,
    lse [B, HQ, S] fp32)``.  Masked keys get p = 0; a row with no visible
    key has o = 0 and lse = ``NEG_INF``."""
    _check_options(causal, window, softcap)
    S, T = q.shape[2], k.shape[2]
    G = q.shape[1] // k.shape[1]
    s, _ = _scores(q, k, _scale(q, sm_scale), softcap)
    mask = attention_mask(S, T, causal, window, q_seg, kv_seg, q.device)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.einsum("bhst,bhtd->bhsd", p,
                     v.float().repeat_interleave(G, dim=1)) / safe
    return o.to(q.dtype), (m + torch.log(safe))[..., 0]


def _probs_and_ds(q, k, v, do, lse, delta, q_seg, kv_seg, causal, scale,
                  window, softcap):
    """``P = exp(S - lse)`` on visible pairs (0 elsewhere) and ``dS =
    scale * P * (dO.V^T - delta)`` (times ``1 - tanh^2`` under a cap),
    both fp32 ``[B, HQ, S, T]``."""
    _check_options(causal, window, softcap)
    S, T = q.shape[2], k.shape[2]
    G = q.shape[1] // k.shape[1]
    s, th = _scores(q, k, scale, softcap)
    mask = attention_mask(S, T, causal, window, q_seg, kv_seg, q.device)
    p = torch.where(mask, torch.exp(s - lse.float()[..., None]),
                    torch.zeros_like(s))
    dp = torch.einsum("bhsd,bhtd->bhst", do.float(),
                      v.float().repeat_interleave(G, dim=1))
    ds = p * (dp - delta.float()[..., None])
    if th is not None:
        ds = ds * (1.0 - th * th)
    return p, ds * scale


def flash_dq_reference(q, k, v, do, lse, delta, q_seg=None, kv_seg=None, *,
                       causal: bool = True, sm_scale: Optional[float] = None,
                       window: Optional[int] = None,
                       softcap: Optional[float] = None) -> torch.Tensor:
    """The dq kernel's plain version: ``dq = dS . K`` in q.dtype."""
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, q_seg, kv_seg, causal,
                          _scale(q, sm_scale), window, softcap)
    G = q.shape[1] // k.shape[1]
    return torch.einsum("bhst,bhtd->bhsd", ds,
                        k.float().repeat_interleave(G, dim=1)).to(q.dtype)


def flash_dkv_reference(q, k, v, do, lse, delta, q_seg=None, kv_seg=None, *,
                        causal: bool = True, sm_scale: Optional[float] = None,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv kernel's plain version: ``dk = dS^T . Q`` and ``dv =
    P^T . dO``, each summed over the G q heads of a kv head, in k.dtype."""
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, q_seg, kv_seg, causal,
                          _scale(q, sm_scale), window, softcap)
    B, HKV, T, D = k.shape
    G = q.shape[1] // HKV
    dv = torch.einsum("bhst,bhsd->bhtd", p, do.float())
    dk = torch.einsum("bhst,bhsd->bhtd", ds, q.float())
    return (dk.reshape(B, HKV, G, T, D).sum(2).to(k.dtype),
            dv.reshape(B, HKV, G, T, D).sum(2).to(v.dtype))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_operands(q, k, v, q_seg, kv_seg):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"q [B, HQ, S, D], k/v [B, HKV, T, D] expected, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, HQ, _, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or HQ % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}"
                         f" (q heads must group over kv heads)")
    if (q_seg is None) != (kv_seg is None):
        raise ValueError("pass both segment-id arrays or neither")
    if q_seg is not None and (tuple(q_seg.shape) != (B, q.shape[2]) or
                              tuple(kv_seg.shape) != (B, k.shape[2])):
        raise ValueError(f"segment ids {tuple(q_seg.shape)} / "
                         f"{tuple(kv_seg.shape)} do not fit q/k")


def _kernel_readable(t: torch.Tensor) -> bool:
    """Whether the kernels read ``t`` in place: a unit stride on D and
    16-byte aligned rows (every (b, h, s) stride a whole vector)."""
    vec = 16 // t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % vec == 0 for s in t.stride()[:3]))


def _strides(t: Optional[torch.Tensor]):
    return (ctypes.c_longlong * 3)(*(t.stride()[:3] if t is not None
                                     else (0, 0, 0)))


def _launch(which: str, q, k, v, *, o=None, lse=None, do=None, delta=None,
            dq=None, dk=None, dv=None, q_seg=None, kv_seg=None, causal=True,
            scale=1.0, window=None, softcap=None) -> None:
    """Validate every operand, fill ``FlashParams`` and launch ``which`` on
    the current stream; raises on what the kernel does not take and on a
    refused launch.  [.., D] operands may be strided views (unit D stride,
    16-byte aligned rows); lse, delta and segment ids are contiguous."""
    from neuronx_distributed_tpu_torch.ops import _build

    dev = q.device
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"the flash kernels take float32 or bfloat16, got "
                        f"{q.dtype}")
    D = q.shape[-1]
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    rows ={"q": q, "k": k, "v": v, "o": o, "do": do, "dq": dq, "dk": dk,
            "dv": dv}
    for name, t in rows.items():
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} differs from q's "
                            f"{q.dtype}")
        if not _kernel_readable(t):
            raise ValueError(
                f"{name} must have a unit stride on D and 16-byte aligned "
                f"rows (strides {t.stride()}); pass .contiguous()")
    B, HQ, S, _ = q.shape
    HKV, T = k.shape[1], k.shape[2]
    for name, t, shape, dtype in (("lse", lse, (B, HQ, S), torch.float32),
                                  ("delta", delta, (B, HQ, S), torch.float32),
                                  ("q_segment_ids", q_seg, (B, S), torch.int32),
                                  ("kv_segment_ids", kv_seg, (B, T),
                                   torch.int32)):
        if t is None:
            continue
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} {shape} "
                             f"tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    params = _build.FlashParams(
        q=ptr(q), k=ptr(k), v=ptr(v), o=ptr(o), dout=ptr(do), lse=ptr(lse),
        delta=ptr(delta), qseg=ptr(q_seg), kseg=ptr(kv_seg), dq=ptr(dq),
        dk=ptr(dk), dv=ptr(dv), q_st=_strides(q), k_st=_strides(k),
        v_st=_strides(v), o_st=_strides(o), do_st=_strides(do),
        dq_st=_strides(dq), dk_st=_strides(dk), dv_st=_strides(dv),
        B=B, HQ=HQ, HKV=HKV, S=S, T=T, D=D, scale=float(scale),
        softcap=float(softcap or 0.0), causal=int(bool(causal)),
        window=int(window or 0), dtype=_DTYPE_CODE[q.dtype])
    lib = _build.load(_LIBRARY[D])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, f"flash_attention_{which}")(ctypes.byref(params),
                                                      stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_{which} kernel launch failed "
                           f"(code {rc})")


def _route(q) -> bool:
    """True: run the kernel (CUDA); False: the plain version (CPU)."""
    if q.device.type == "cuda":
        return True
    if q.device.type == "cpu":
        return False
    raise ValueError(f"flash attention runs on cuda or cpu, got {q.device}")


def visible_pairs(S: int, T: int, causal: bool = True,
                  window: Optional[int] = None) -> int:
    """(query, key) pairs one head sees: query i (at kv position i + T - S)
    sees keys up to its own position and, with a window, no further back
    than window - 1 positions."""
    if not causal:
        return S * T
    hi = np.arange(S, dtype=np.int64) + (T - S)
    return int(np.minimum(hi + 1, window or T).sum())


# operations per visible (q, k) pair, in units of D: fwd q.k and p.v; dq
# q.k, dO.v and dS.k; dk/dv q.k, dO.v, p^T.dO and dS^T.q
_PAIR_OPS = {"fwd": 4, "dq": 6, "dkv": 8}


def flash_cost(which: str, q, k, causal: bool = True,
               window: Optional[int] = None, q_seg=None,
               kv_seg=None) -> tuple:
    """``(flops, bytes)`` of one ``which`` call (``"fwd"``, ``"dq"`` or
    ``"dkv"``) at these shapes: the pairs the causal band and window leave
    visible (segment masks not subtracted), and each input read once and
    each output written once (q, k, v, o, dO, dq, dk, dv in q's type; lse
    and delta fp32; segment ids int32)."""
    B, HQ, S, D = q.shape
    HKV, T = k.shape[1], k.shape[2]
    item = q.element_size()
    flops = _PAIR_OPS[which] * D * B * HQ * visible_pairs(S, T, causal,
                                                          window)
    qd, kd, rows = B * HQ * S * D * item, B * HKV * T * D * item, B * HQ * S * 4
    nbytes = {"fwd": qd + 2 * kd + qd + rows,         # q k v -> o lse
              "dq": 2 * qd + 2 * kd + 2 * rows + qd,  # q k v do lse delta -> dq
              "dkv": 2 * qd + 2 * kd + 2 * rows + 2 * kd}[which]
    if q_seg is not None:
        nbytes += (q_seg.numel() + kv_seg.numel()) * 4
    return float(flops), float(nbytes)


def flash_attention_fwd(q, k, v, q_seg=None, kv_seg=None, *,
                        causal: bool = True, sm_scale: Optional[float] = None,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kernel B1: ``(o, lse)``; o has q's memory layout."""
    _check_operands(q, k, v, q_seg, kv_seg)
    _check_options(causal, window, softcap)
    opts = (q, k, v, q_seg, kv_seg, causal, sm_scale, window, softcap)
    if profiling.ACTIVE is not None:
        with profiling.declared(*flash_cost("fwd", q, k, causal, window,
                                            q_seg, kv_seg)):
            return _fwd(*opts)
    return _fwd(*opts)


def _fwd(q, k, v, q_seg, kv_seg, causal, sm_scale, window, softcap):
    if not _route(q):
        return flash_fwd_reference(q, k, v, q_seg, kv_seg, causal=causal,
                                   sm_scale=sm_scale, window=window,
                                   softcap=softcap)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _launch("fwd", q, k, v, o=o, lse=lse, q_seg=q_seg, kv_seg=kv_seg,
            causal=causal, scale=_scale(q, sm_scale), window=window,
            softcap=softcap)
    flash_attention_fwd.launches += 1
    return o, lse


def flash_attention_dq(q, k, v, do, lse, delta, q_seg=None, kv_seg=None, *,
                       causal: bool = True, sm_scale: Optional[float] = None,
                       window: Optional[int] = None,
                       softcap: Optional[float] = None) -> torch.Tensor:
    """dq kernel B2; ``delta [B, HQ, S]`` is ``rowsum(dO * O)`` (minus the
    lse cotangent), computed by the caller."""
    _check_operands(q, k, v, q_seg, kv_seg)
    _check_options(causal, window, softcap)
    opts = (q, k, v, do, lse, delta, q_seg, kv_seg, causal, sm_scale, window,
            softcap)
    if profiling.ACTIVE is not None:
        with profiling.declared(*flash_cost("dq", q, k, causal, window,
                                            q_seg, kv_seg)):
            return _dq(*opts)
    return _dq(*opts)


def _dq(q, k, v, do, lse, delta, q_seg, kv_seg, causal, sm_scale, window,
        softcap):
    if not _route(q):
        return flash_dq_reference(q, k, v, do, lse, delta, q_seg, kv_seg,
                                  causal=causal, sm_scale=sm_scale,
                                  window=window, softcap=softcap)
    dq = torch.empty_like(q)
    _launch("dq", q, k, v, do=do, lse=lse, delta=delta, dq=dq, q_seg=q_seg,
            kv_seg=kv_seg, causal=causal, scale=_scale(q, sm_scale),
            window=window, softcap=softcap)
    flash_attention_dq.launches += 1
    return dq


def flash_attention_dkv(q, k, v, do, lse, delta, q_seg=None, kv_seg=None, *,
                        causal: bool = True, sm_scale: Optional[float] = None,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk/dv kernel B3: ``(dk, dv)`` in k's layout, already summed over
    each kv head's q heads."""
    _check_operands(q, k, v, q_seg, kv_seg)
    _check_options(causal, window, softcap)
    opts = (q, k, v, do, lse, delta, q_seg, kv_seg, causal, sm_scale, window,
            softcap)
    if profiling.ACTIVE is not None:
        with profiling.declared(*flash_cost("dkv", q, k, causal, window,
                                            q_seg, kv_seg)):
            return _dkv(*opts)
    return _dkv(*opts)


def _dkv(q, k, v, do, lse, delta, q_seg, kv_seg, causal, sm_scale, window,
         softcap):
    if not _route(q):
        return flash_dkv_reference(q, k, v, do, lse, delta, q_seg, kv_seg,
                                   causal=causal, sm_scale=sm_scale,
                                   window=window, softcap=softcap)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("dkv", q, k, v, do=do, lse=lse, delta=delta, dk=dk, dv=dv,
            q_seg=q_seg, kv_seg=kv_seg, causal=causal,
            scale=_scale(q, sm_scale), window=window, softcap=softcap)
    flash_attention_dkv.launches += 1
    return dk, dv


flash_attention_fwd.launches = 0
flash_attention_dq.launches = 0
flash_attention_dkv.launches = 0


# ---------------------------------------------------------------------------
# public entries (custom autograd over the kernels)
# ---------------------------------------------------------------------------


class _FlashAttention(torch.autograd.Function):
    """Forward B1; backward ``delta = rowsum(dO * O) - dlse`` in plain
    torch (as in JAX), then B2 and B3."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, causal, sm_scale, window,
                softcap):
        opts = dict(causal=causal, sm_scale=sm_scale, window=window,
                    softcap=softcap)
        o, lse = flash_attention_fwd(q, k, v, q_seg, kv_seg, **opts)
        ctx.save_for_backward(q, k, v, o, lse, q_seg, kv_seg)
        ctx.opts = opts
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse, q_seg, kv_seg = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        else:  # an incoming gradient may be any view
            do = do.to(q.dtype)
            do = do if _kernel_readable(do) else do.contiguous()
        delta = (do.float() * o.float()).sum(dim=-1)
        if dlse is not None:
            delta = delta - dlse.float()
        delta = delta.contiguous()
        dq = flash_attention_dq(q, k, v, do, lse, delta, q_seg, kv_seg,
                                **ctx.opts)
        dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, q_seg, kv_seg,
                                     **ctx.opts)
        return dq, dk, dv, None, None, None, None, None, None


def _segments(ids: torch.Tensor, device) -> torch.Tensor:
    return ids.to(device=device, dtype=torch.int32).contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, sm_scale: Optional[float] = None,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """Fused attention ``q [B, HQ, S, D]``, ``k/v [B, HKV, T, D]`` ->
    ``[B, HQ, S, D]`` with a kernel backward.  ``window`` (causal only) is
    Mistral-style sliding-window attention (query at p sees keys ``[p -
    window + 1, p]``); ``softcap`` is Gemma-2 logit softcapping (``cap *
    tanh(s / cap)`` before the mask).  Runs where q lies: the kernels on
    CUDA, their plain versions on the CPU."""
    return _FlashAttention.apply(q, k, v, None, None, causal, sm_scale,
                                 window, softcap)[0]


def flash_attention_with_lse(q, k, v, causal: bool = True,
                             sm_scale: Optional[float] = None,
                             window: Optional[int] = None,
                             softcap: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention` that also returns the per-row logsumexp
    ``[B, HQ, S]`` (fp32); its cotangent enters the backward as ``delta -=
    dlse`` (``d lse_i / d s_ij = p_ij``)."""
    return _FlashAttention.apply(q, k, v, None, None, causal, sm_scale,
                                 window, softcap)


def flash_attention_segmented(q, k, v, q_segment_ids, kv_segment_ids,
                              causal: bool = True,
                              sm_scale: Optional[float] = None,
                              window: Optional[int] = None,
                              softcap: Optional[float] = None
                              ) -> torch.Tensor:
    """:func:`flash_attention` with document-segment masking (packed
    pretraining): a query sees only keys of its own nonzero segment id;
    id 0 is padding, blocked both ways.  Ids are ``[B, S]`` / ``[B, T]``
    integers."""
    return _FlashAttention.apply(
        q, k, v, _segments(q_segment_ids, q.device),
        _segments(kv_segment_ids, q.device), causal, sm_scale, window,
        softcap)[0]


def flash_attention_segmented_with_lse(q, k, v, q_segment_ids,
                                       kv_segment_ids, causal: bool = True,
                                       sm_scale: Optional[float] = None,
                                       window: Optional[int] = None,
                                       softcap: Optional[float] = None
                                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_segmented` that also returns the lse; a row
    with no visible key reports ``lse = NEG_INF``."""
    return _FlashAttention.apply(
        q, k, v, _segments(q_segment_ids, q.device),
        _segments(kv_segment_ids, q.device), causal, sm_scale, window,
        softcap)
