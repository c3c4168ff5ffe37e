"""Sequence packing: fixed-length training rows from ragged documents
(counterpart of ``neuronx_distributed_tpu/data/packing.py``).

- :func:`pack_documents`: window-bounded first-fit packing of documents
  (each with an EOS separator) into ``[N, seq_len]`` rows, with ``labels``
  (IGNORE over padding and separators) and ``segment_ids`` for the
  segmented attention of the port's flash entries;
- :func:`segment_positions`: per-document RoPE positions;
- :func:`concat_and_chunk`: concatenate everything and chunk, documents
  flowing across row boundaries.

Outputs are numpy int32 arrays, as the JAX package's; the row assignment
runs in the native library (``csrc/loader.cpp:nxd_pack_assign``) when it
is available, with a bit-identical Python loop as the fallback.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

import numpy as np

IGNORE = -100


def concat_and_chunk(docs: Iterable[np.ndarray], seq_len: int,
                     eos_id: int) -> Tuple[np.ndarray, np.ndarray]:
    """``docs`` (1-D int arrays) joined by EOS separators and chunked into
    ``[N, seq_len]`` rows of ``ids`` and next-token ``labels``; the tail
    that does not fill a row is dropped."""
    stream: List[np.ndarray] = []
    for d in docs:
        stream.append(np.asarray(d, np.int32).ravel())
        stream.append(np.asarray([eos_id], np.int32))
    if not stream:
        return (np.zeros((0, seq_len), np.int32),
                np.zeros((0, seq_len), np.int32))
    flat = np.concatenate(stream)
    n = (len(flat) - 1) // seq_len  # one extra token labels the last position
    ids = flat[:n * seq_len].reshape(n, seq_len).astype(np.int32)
    labels = flat[1:n * seq_len + 1].reshape(n, seq_len).astype(np.int32)
    return ids, labels


def pack_documents(docs: Iterable[np.ndarray], seq_len: int, eos_id: int,
                   pad_id: int = 0, mask_separators: bool = False
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """First-fit packing: each document (+1 EOS) goes whole into the first
    row with room among the last 64 opened; a document longer than
    ``seq_len`` is split into ``seq_len`` pieces first, with no fake EOS
    (labels are computed over the whole document, so a piece's last
    position predicts the document's true next token).  Returns ``(ids,
    labels, segment_ids)``, each ``[N, seq_len]``: labels are IGNORE (-100)
    on padding, on the EOS position and, with ``mask_separators``, on the
    position that predicts EOS; segment ids number a row's pieces from 1
    (0 = padding)."""
    pieces: List[Tuple[np.ndarray, np.ndarray]] = []
    for d in docs:
        d = np.asarray(d, np.int32).ravel()
        toks = np.concatenate([d, np.asarray([eos_id], np.int32)])
        labs = np.concatenate([toks[1:], np.asarray([IGNORE], np.int32)])
        if mask_separators and len(toks) >= 2:
            labs[len(toks) - 2] = IGNORE
        for i in range(0, len(toks), seq_len):
            pieces.append((toks[i:i + seq_len], labs[i:i + seq_len]))

    window = 64
    lengths = np.asarray([len(p[0]) for p in pieces], np.int32)
    from neuronx_distributed_tpu_torch.data.loader import native_pack_assign

    assigned = native_pack_assign(lengths, seq_len, window)
    if assigned is None:
        assigned = _assign_rows_py(lengths, seq_len, window)
    row_of_piece, n_rows = assigned

    ids = np.full((n_rows, seq_len), pad_id, np.int32)
    labels = np.full((n_rows, seq_len), IGNORE, np.int32)
    segs = np.zeros((n_rows, seq_len), np.int32)
    pos = [0] * n_rows
    nseg = [0] * n_rows
    for (ptoks, plabs), r in zip(pieces, row_of_piece):
        n, p = len(ptoks), pos[r]
        nseg[r] += 1
        ids[r, p:p + n] = ptoks
        labels[r, p:p + n] = plabs
        segs[r, p:p + n] = nseg[r]
        pos[r] += n
    return ids, labels, segs


def _assign_rows_py(lengths: np.ndarray, seq_len: int,
                    window: int) -> Tuple[np.ndarray, int]:
    """Window-bounded first fit in Python: the semantics the native
    ``nxd_pack_assign`` matches bit for bit."""
    space: List[int] = []
    out = np.empty(len(lengths), np.int32)
    for i, need in enumerate(lengths):
        lo = max(0, len(space) - window)
        for r in range(lo, len(space)):
            if space[r] >= need:
                out[i] = r
                space[r] -= need
                break
        else:
            out[i] = len(space)
            space.append(seq_len - int(need))
    return out, len(space)


def segment_positions(segment_ids: np.ndarray) -> np.ndarray:
    """Per-document RoPE positions from ``[N, S]`` segment ids: the offset
    within each contiguous run (the trailing padding run restarts from 0;
    its positions are inert)."""
    segment_ids = np.asarray(segment_ids)
    S = segment_ids.shape[-1]
    start = np.zeros_like(segment_ids)
    changes = segment_ids[..., 1:] != segment_ids[..., :-1]
    start[..., 1:] = np.where(changes, np.arange(1, S), 0)
    start = np.maximum.accumulate(start, axis=-1)
    return (np.arange(S) - start).astype(np.int32)
