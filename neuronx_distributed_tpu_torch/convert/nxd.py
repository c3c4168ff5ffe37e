"""Reference (neuronx-distributed) checkpoints into and out of the port
(counterpart of ``neuronx_distributed_tpu/convert/nxd.py``).

The reference saves one torch ``state_dict`` per rank as
``<ckpt>/<tag>/model/dp_rank_00_tp_rank_{TT}_pp_rank_{PP}.pt``.  A
tensor-parallel parameter holds only its rank's shard: the full tensor cut
into ``tp * stride`` chunks along its partition dim, rank ``r`` holding
chunks ``[r::tp]`` (the fused-QKV / gate-up ``stride`` convention).
Pipeline ranks hold disjoint name subsets under the original names.

:func:`load_nxd_checkpoint` reverses that: every rank file is read
(``torch.load(weights_only=True)``), pipeline ranks are merged by name and
tensor-parallel shards by the inverse chunk interleave, into one full
``{name: tensor}`` dict, which :mod:`.hf` then takes into the port
(``split_fused_llama`` first for the fused Llama layout).
:func:`save_nxd_checkpoint` writes the other way.  The files are torch
files, so the port works on tensors throughout and keeps their stored
dtype (the JAX package reads them into fp32 numpy arrays).

The files do not store the partition dim or the stride: the reference
reapplies them from its live modules.  Import therefore takes a rule table
mapping name patterns to ``(partition_dim, stride)``;
``LLAMA_TP_RULES`` / ``GPT_NEOX_TP_RULES`` cover the reference's example
models.  A parameter that matches no rule must be identical on every tp
rank (replicated); anything else raises, so a missing rule cannot corrupt
a merge.
"""

from __future__ import annotations

import hashlib
import os
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from neuronx_distributed_tpu_torch.convert.hf import _t
from neuronx_distributed_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

# (regex, (partition_dim, stride)): the first match wins.  Weights are
# torch [out_features, in_features]: column-parallel shards dim 0,
# row-parallel shards dim 1
LLAMA_TP_RULES: Sequence[Tuple[str, Tuple[int, int]]] = (
    (r"\.qkv_proj\.weight$", (0, 3)),       # fused q/k/v, stride 3
    (r"\.gate_up_proj\.weight$", (0, 2)),   # fused gate/up, stride 2
    (r"\.(q_proj|k_proj|v_proj)\.weight$", (0, 1)),
    (r"\.(weight_q|weight_k|weight_v)$", (0, 1)),  # GQA qkv module
    (r"\.(bias_q|bias_k|bias_v)$", (0, 1)),  # GQA qkv biases (Qwen2-style)
    (r"\.gate_proj\.weight$", (0, 1)),
    (r"\.up_proj\.weight$", (0, 1)),
    (r"\.o_proj\.weight$", (1, 1)),
    (r"\.down_proj\.weight$", (1, 1)),
    (r"embed_tokens\.weight$", (0, 1)),     # vocab-parallel embedding
    (r"lm_head\.weight$", (0, 1)),
)

GPT_NEOX_TP_RULES: Sequence[Tuple[str, Tuple[int, int]]] = (
    (r"\.query_key_value\.weight$", (0, 3)),
    (r"\.query_key_value\.bias$", (0, 3)),
    (r"\.dense\.weight$", (1, 1)),
    (r"\.dense_h_to_4h\.weight$", (0, 1)),
    (r"\.dense_h_to_4h\.bias$", (0, 1)),
    (r"\.dense_4h_to_h\.weight$", (1, 1)),
    (r"embed_in\.weight$", (0, 1)),
    (r"embed_out\.weight$", (0, 1)),
)

# the GQA module's k/v entries, which the reference tiles under
# kv_size_multiplier > 1
_KV_NAME = r"\.(weight_k|weight_v|bias_k|bias_v)$"


def _rank_files(model_dir: str) -> Dict[Tuple[int, int], str]:
    """``{(tp_rank, pp_rank): path}`` of the dp_rank_00 files."""
    pat = re.compile(r"^dp_rank_00_tp_rank_(\d+)_pp_rank_(\d+)\.pt$")
    out = {}
    for fname in sorted(os.listdir(model_dir)):
        m = pat.match(fname)
        if m:
            path = os.path.join(model_dir, fname)
            # the reference's use_xser=True serializer writes a ref-data .pt
            # file plus a '<name>.pt.tensors/' directory of the tensors; the
            # .pt file alone holds stubs, not data
            if os.path.isdir(path + ".tensors"):
                raise ValueError(
                    f"{fname} is an xser-serialized checkpoint (sibling "
                    f"'{fname}.tensors/' directory found); xser layouts are "
                    "not supported — re-save from the reference with "
                    "use_xser=False"
                )
            out[(int(m.group(1)), int(m.group(2)))] = path
    if not out:
        raise FileNotFoundError(
            f"no dp_rank_00_tp_rank_*_pp_rank_*.pt files in {model_dir} — "
            "expected the reference trainer checkpoint layout"
        )
    return out


def _split(t: torch.Tensor, parts: int, dim: int) -> Tuple[torch.Tensor, ...]:
    """``t`` cut into ``parts`` equal pieces along ``dim`` (views)."""
    size = t.shape[dim]
    if size % parts:
        raise ValueError(f"dim {dim} of size {size} does not divide into "
                         f"{parts} equal chunks")
    return t.split(size // parts, dim)


def merge_tp_shards(shards: List[Any], partition_dim: int,
                    stride: int = 1) -> torch.Tensor:
    """Inverse of the reference's ``create_local_weight``: each rank's
    shard is ``stride`` contiguous chunks; full chunk ``j`` (of ``tp *
    stride``) came from rank ``j % tp``, position ``j // tp``."""
    tp = len(shards)
    pieces = [_split(_t(s), stride, partition_dim) for s in shards]
    ordered = [pieces[j % tp][j // tp] for j in range(tp * stride)]
    return torch.cat(ordered, dim=partition_dim)


def rule_for(name: str, rules: Sequence[Tuple[str, Tuple[int, int]]]):
    """``(partition_dim, stride)`` of the first rule matching ``name``, or
    None."""
    for pat, ds in rules:
        if re.search(pat, name):
            return ds
    return None


def _same(a, b) -> bool:
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return False
    return bool(np.array_equal(np.asarray(a), np.asarray(b)))


def load_nxd_checkpoint(
    model_dir: str,
    tp_rules: Sequence[Tuple[str, Tuple[int, int]]] = LLAMA_TP_RULES,
    extra_rules: Optional[Sequence[Tuple[str, Tuple[int, int]]]] = None,
    allow_pickle: bool = False,
    allow_replicated_kv: bool = False,
    kv_size_multiplier: Optional[int] = None,
) -> Dict[str, Any]:
    """Read a reference per-rank model checkpoint directory into one full
    ``{name: tensor}`` dict (the original names, the stored dtypes, on the
    CPU).

    ``extra_rules`` go before ``tp_rules``, for custom modules.  A
    parameter matching no rule must be identical on every tp rank, else
    this raises naming it (add a rule rather than guess).

    Files are read with ``weights_only=True``: reference model state dicts
    are plain tensors, and third-party files must not run code.  A
    checkpoint that needs full pickle takes ``allow_pickle=True`` (a
    malicious file can then run arbitrary code).

    GQA ``weight_k/weight_v/bias_k/bias_v`` entries saved under the
    reference's ``kv_size_multiplier > 1`` (found by identical tp shards)
    are un-tiled: the replication tiles the master KV block, so the merge's
    first ``1 / m`` is the original (:func:`_strip_kv_replication`).
    ``kv_size_multiplier=`` pins the factor (needed where it is ambiguous,
    e.g. constant biases); duplicates with no clean tiling raise;
    ``allow_replicated_kv=True`` keeps the raw merge."""
    rules = tuple(extra_rules or ()) + tuple(tp_rules)
    files = _rank_files(model_dir)
    tp_ranks = sorted({t for t, _ in files})
    pp_ranks = sorted({p for _, p in files})
    expect = {(t, p) for t in tp_ranks for p in pp_ranks}
    if set(files) != expect:
        raise ValueError(
            f"ragged rank grid in {model_dir}: have {sorted(files)}, "
            f"expected the full {len(tp_ranks)}x{len(pp_ranks)} grid"
        )

    full: Dict[str, Any] = {}
    for p in pp_ranks:
        per_tp = [torch.load(files[(t, p)], map_location="cpu",
                             weights_only=not allow_pickle)
                  for t in tp_ranks]
        names = list(per_tp[0])
        for d in per_tp[1:]:
            if list(d) != names:
                raise ValueError(
                    f"pp_rank {p}: tp ranks disagree on param names")
        for name in names:
            shards = [d[name] for d in per_tp]
            if name in full:
                raise ValueError(
                    f"param {name} appears in more than one pp rank")
            ds = rule_for(name, rules)
            if ds is None:
                for s in shards[1:]:
                    if not _same(s, shards[0]):
                        raise ValueError(
                            f"{name}: differs across tp ranks but matches no "
                            "TP rule — pass extra_rules=[(pattern, (dim, "
                            "stride))] for it"
                        )
                full[name] = shards[0]
                continue
            dim, stride = ds
            merged = merge_tp_shards(shards, dim, stride)
            if (not allow_replicated_kv and re.search(_KV_NAME, name)
                    and _has_duplicate_shards(shards)):
                merged = _strip_kv_replication(
                    name, merged, tp=len(shards),
                    multiplier=kv_size_multiplier)
            full[name] = merged
    return full


def _has_duplicate_shards(shards: List[torch.Tensor]) -> bool:
    """Any two tp shards bit-identical?  One digest of each shard's bytes
    (O(tp) compares; replicas are bit copies, so NaNs match too)."""
    seen = set()
    for s in shards:
        s = _t(s).detach().cpu().contiguous()
        raw = s.reshape(-1).view(torch.uint8).numpy() if s.numel() else b""
        digest = hashlib.sha256(repr((tuple(s.shape), str(s.dtype))).encode()
                                + bytes(raw)).hexdigest()
        if digest in seen:
            return True
        seen.add(digest)
    return False


def _tile(t: torch.Tensor, m: int) -> torch.Tensor:
    return t.repeat((m,) + (1,) * (t.ndim - 1))


def _strip_kv_replication(name: str, merged: torch.Tensor, tp: int,
                          multiplier: Optional[int] = None) -> torch.Tensor:
    """Invert the reference's GQA KV replication.

    ``GQAQKVColumnParallelLinear`` with ``kv_size_multiplier = m`` tiles
    the whole master KV weight ``m`` times along dim 0 (and the bias)
    before the plain contiguous shard, so the ``(0, 1)`` merge rebuilds the
    tiled tensor and the original is its first ``rows / m``.

    ``m`` is not in the files.  With ``multiplier`` given, that factor is
    checked and stripped.  Otherwise it is the largest divisor of ``tp``
    whose tiling holds bit for bit (the reference asks ``tp % m == 0``):
    for a master that does not repeat itself this is the one factor whose
    base does not tile again.  A base that still tiles (constant values)
    raises for the explicit ``kv_size_multiplier``.  One corner cannot be
    told apart from the bytes: a master that itself repeats kv head blocks
    (a freshly MHA-to-GQA upcycled checkpoint) looks like a larger factor
    over the deduplicated block; pass ``kv_size_multiplier=`` there."""

    def tiles_as(arr, m):
        if arr.shape[0] % m != 0:
            return False
        return torch.equal(arr, _tile(arr[: arr.shape[0] // m], m))

    rows = merged.shape[0]
    if multiplier is not None:
        if multiplier == 1:
            return merged  # explicit "no replication": keep the plain merge
        if multiplier < 1 or not tiles_as(merged, multiplier):
            raise ValueError(
                f"{name}: merged KV tensor ({rows} rows) is not a clean "
                f"{multiplier}x tiling — kv_size_multiplier={multiplier} "
                "does not match this checkpoint"
            )
        return merged[: rows // multiplier]

    for m in sorted((d for d in range(2, tp + 1) if tp % d == 0),
                    reverse=True):
        if not tiles_as(merged, m):
            continue
        base = merged[: rows // m]
        if any(tiles_as(base, d) for d in range(2, base.shape[0] + 1)
               if base.shape[0] % d == 0):
            raise ValueError(
                f"{name}: KV replication factor is ambiguous — the tensor "
                f"tiles at multiple factors (constant-init values or a "
                "master that itself repeats KV heads). Pass "
                "kv_size_multiplier= explicitly, or "
                "allow_replicated_kv=True to keep the raw merge"
            )
        logger.info(
            "%s: inverted GQA KV replication (kv_size_multiplier=%d, "
            "%d -> %d rows)", name, m, rows, rows // m)
        return base
    raise ValueError(
        f"{name}: tp ranks hold bit-identical KV shards but the merged "
        "tensor is not a clean tiling by any divisor of tp — cannot invert "
        "the replication layout. Re-save from the reference with "
        "kv_size_multiplier=1, or pass allow_replicated_kv=True to keep "
        "the raw merge if the duplicates are genuine"
    )


def shard_for_rank(full: Any, rank: int, tp: int, partition_dim: int,
                   stride: int = 1) -> torch.Tensor:
    """Inverse of :func:`merge_tp_shards` for ONE rank: ``full`` cut into
    ``tp * stride`` chunks along ``partition_dim``, rank ``r`` holding
    chunks ``[r::tp]`` (the reference's ``create_local_weight``)."""
    full = _t(full)
    size = full.shape[partition_dim]
    if size % (tp * stride) != 0:
        raise ValueError(
            f"dim {partition_dim} of size {size} does not divide into "
            f"tp * stride = {tp} * {stride} chunks")
    chunks = _split(full, tp * stride, partition_dim)
    return torch.cat(chunks[rank::tp], dim=partition_dim)


def fuse_split_llama(state: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`split_fused_llama`: HF-style ``q/k/v_proj`` rows
    fused into the reference's ``qkv_proj`` (``[q; k; v]`` on dim 0) and
    ``gate/up_proj`` into ``gate_up_proj``, the layout the reference's
    fused modules save."""
    out = dict(state)
    for name in list(out):
        if name.endswith(".q_proj.weight"):
            base = name[: -len("q_proj.weight")]
            q, k, v = (_t(out.pop(base + f"{n}_proj.weight")) for n in "qkv")
            out[base + "qkv_proj.weight"] = torch.cat([q, k, v], dim=0)
        elif name.endswith(".gate_proj.weight"):
            base = name[: -len("gate_proj.weight")]
            g = _t(out.pop(base + "gate_proj.weight"))
            u = _t(out.pop(base + "up_proj.weight"))
            out[base + "gate_up_proj.weight"] = torch.cat([g, u], dim=0)
    return out


def _owned(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the CPU in a storage of its own: ``torch.save`` writes a
    view's whole storage, so a slice or a shard view is copied first."""
    t = t.detach().cpu()
    if (not t.is_contiguous() or t.storage_offset()
            or t.untyped_storage().nbytes() != t.numel() * t.element_size()):
        t = t.clone(memory_format=torch.contiguous_format)
    return t


def save_nxd_checkpoint(
    model_dir: str,
    state: Dict[str, Any],
    tp: int = 1,
    pp: int = 1,
    tp_rules: Sequence[Tuple[str, Tuple[int, int]]] = LLAMA_TP_RULES,
    extra_rules: Optional[Sequence[Tuple[str, Tuple[int, int]]]] = None,
    kv_size_multiplier: int = 1,
    pp_assign: Optional[Dict[str, int]] = None,
    fuse_llama: bool = False,
) -> List[str]:
    """Write a full ``{name: tensor}`` dict as a reference per-rank
    checkpoint directory: the inverse of :func:`load_nxd_checkpoint` (train
    here, serve on the reference stack).

    Every ``(tp_rank, pp_rank)`` gets one torch file
    ``dp_rank_00_tp_rank_{TT}_pp_rank_{PP}.pt`` (the ``use_xser=False``
    layout) of CPU tensors.  A parameter matching a rule is cut by the
    ``create_local_weight`` interleave (:func:`shard_for_rank`, with the
    fused modules' ``stride``); the others are written whole to every tp
    rank, as the importer expects, so ``load_nxd_checkpoint(
    save_nxd_checkpoint(...))`` gives the state back.

    ``kv_size_multiplier > 1`` applies the reference's GQA KV replication
    (the master tiled ``m`` times on dim 0) to ``weight_k/weight_v/bias_k/
    bias_v`` before the cut; ``fuse_llama=True`` fuses split q/k/v and
    gate/up first (:func:`fuse_split_llama`); ``pp_assign`` maps names to
    pp ranks (default: everything on pp rank 0).  Returns the paths
    written."""
    if tp < 1 or pp < 1:
        raise ValueError(f"tp and pp must be >= 1 (got tp={tp}, pp={pp})")
    if fuse_llama:
        state = fuse_split_llama(state)
    rules = tuple(extra_rules or ()) + tuple(tp_rules)
    pp_assign = pp_assign or {}
    bad = {n: r for n, r in pp_assign.items() if not 0 <= r < pp}
    if bad:
        raise ValueError(f"pp_assign ranks out of range [0, {pp}): {bad}")

    per_pp: Dict[int, Dict[str, torch.Tensor]] = {p: {} for p in range(pp)}
    for name, arr in state.items():
        arr = _t(arr)
        if kv_size_multiplier > 1 and re.search(_KV_NAME, name):
            arr = _tile(arr, kv_size_multiplier)
        per_pp[pp_assign.get(name, 0)][name] = arr

    os.makedirs(model_dir, exist_ok=True)
    written = []
    for p in range(pp):
        for t in range(tp):
            rank_sd = {}
            for name, arr in per_pp[p].items():
                ds = rule_for(name, rules)
                shard = arr if ds is None else shard_for_rank(
                    arr, t, tp, ds[0], ds[1])
                rank_sd[name] = _owned(shard)
            path = os.path.join(
                model_dir, f"dp_rank_00_tp_rank_{t:02d}_pp_rank_{p:02d}.pt")
            torch.save(rank_sd, path)
            written.append(path)
    logger.info("exported %d params as %d rank files (tp=%d pp=%d) to %s",
                len(state), len(written), tp, pp, model_dir)
    return written


def split_fused_llama(state: Dict[str, Any], num_heads: int,
                      num_kv_heads: int, head_dim: int) -> Dict[str, Any]:
    """The reference's fused ``qkv_proj`` / ``gate_up_proj`` weights split
    into HF-style q/k/v and gate/up entries (views), so the merged dict
    feeds :func:`.hf.llama_params_from_hf` directly."""
    out = {}
    q_rows = num_heads * head_dim
    kv_rows = num_kv_heads * head_dim
    for name, w in state.items():
        if name.endswith(".qkv_proj.weight"):
            base = name[: -len("qkv_proj.weight")]
            w = _t(w)
            out[base + "q_proj.weight"] = w[:q_rows]
            out[base + "k_proj.weight"] = w[q_rows:q_rows + kv_rows]
            out[base + "v_proj.weight"] = w[q_rows + kv_rows:]
        elif name.endswith(".gate_up_proj.weight"):
            base = name[: -len("gate_up_proj.weight")]
            g, u = _split(_t(w), 2, 0)
            out[base + "gate_proj.weight"] = g
            out[base + "up_proj.weight"] = u
        else:
            out[name] = w
    return out
