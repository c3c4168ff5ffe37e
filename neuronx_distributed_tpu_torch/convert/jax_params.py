"""JAX param tree -> the port's ``state_dict``.

The port's module tree mirrors the JAX package's param tree (see
``neuronx_distributed_tpu/convert/hf.py:llama_params_to_hf`` for the
layout: ``model/embed/embedding [V, H]``, ``model/layer_i/attn/qkv/
{q,k,v}_kernel [H, heads, D]``, ``attn/o_proj/kernel [NQ*D, H]``,
``mlp/gate_up/kernel [H, 2, I]``, ``mlp/down/kernel [I, H]``, the norm
``weight``s, ``lm_head/kernel [H, V]``), so the conversion is a flatten of
the tree's paths with a shape check against the config.  Gemma and Gemma-2
trees (``neuronx_distributed_tpu/models/gemma.py``) have no ``model/`` level
and no ``lm_head`` (the head is the tied embedding); Gemma-2 layers carry
four norm weights.  GPT-NeoX and BERT trees
(``neuronx_distributed_tpu/models/{gpt_neox,bert}.py``) hold fused QKV
kernels ``[H, 3, H]`` with biases ``[3, H]``, biased linears, LayerNorm
``weight``/``bias`` pairs and, in BERT, flax ``nn.Dense`` kernels ``[in,
out]`` (pooler, MLM transform, NSP classifier).  Arrays move as
they are (a tensor leaf, as :mod:`.hf` passes them, keeps its device,
dtype and view) and ``load_state_dict`` casts them to the model's types, so a
model built with ``param_dtype=torch.float32`` (training) keeps the JAX
package's fp32 masters bit for bit, and a serving model (weights in the
compute type) takes them rounded once.

At tensor-parallel degree > 1 a rank's model holds its shard of each
tensor: :func:`shard_params_for_rank` cuts the JAX tree (numpy) by the JAX
package's partition specs (:func:`shard_dim` names the sharded dim of a
parameter, None for a replicated one), and the converters take ``tp=`` to
check the shard's shapes.  Under KV replication (``kvr > 1``) the q heads
and the attention output's rows are cut into ``tp`` blocks taken in the
JAX ``('tp', 'kvr')`` order (rank ``(kvr = o, tp = i)`` holds block ``i *
kvr + o``) and the k/v heads into ``tp / kvr`` blocks, the same on the kvr
replicas.  :func:`zero1_shard_for_rank` cuts a rank's tree again for its
ZeRO-1 slice (the optimizer state a data-parallel rank holds), and
:func:`fsdp_shard_for_rank` for its FSDP piece (the parameters, gradients
and states a data-parallel rank holds under ``fsdp=True``, cut tp-major:
``optimizer/zero1.py``).  :func:`tp_cut` gives a parameter's cut by
name.

JAX's pipelined models keep ``{embed, layers, head}`` with the layers
stacked ``[L', ...]`` in a padded, possibly permuted row layout
(``pipeline/partition.py``; ``layer_rows[i]`` is real layer ``i``'s row):
:func:`pipelined_params_from_jax` gives one pipeline stage's parameters
(any layers, with or without the embedding and the head, at any tp or
kvr rank) under the pp = 1 model's names, and
:func:`pipelined_grads_from_jax` the same for JAX's pipelined gradients.

An MoE Llama's layers hold ``moe_mlp.router [H, E]`` (replicated),
``moe_mlp.gate_up [E, H, 2, I]`` and ``moe_mlp.down [E, I, H]`` in place of
``mlp``: their I cut over tp like the dense MLP's, their experts over ep
by :func:`ep_shard_for_rank`; ZeRO-1 and FSDP leave them whole.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

# the sharded dim of each parameter kind, by name suffix (the JAX partition
# specs: q/k/v heads over ('tp', 'kvr') / 'tp', a column kernel's, a column
# bias's and the LM head's last dim, a row kernel's and the embedding's
# first dim); norms, row biases (added once, after the reduce) and flax
# Dense layers are replicated.  BERT's mlm_bias is cut by vocab with the
# tied table whose logits it shifts (JAX keeps it whole).  Each suffix
# starts at a module boundary, so none captures another family's name
_SHARD_DIMS = (
    ("attn.qkv.q_kernel", 1), ("attn.qkv.k_kernel", 1),
    ("attn.qkv.v_kernel", 1), ("attn.qkv.q_bias", 0),
    ("attn.qkv.k_bias", 0), ("attn.qkv.v_bias", 0),
    ("attn.o_proj.kernel", 0), ("mlp.gate_up.kernel", -1),
    ("mlp.down.kernel", 0), ("embed.embedding", 0), ("lm_head.kernel", -1),
    # an MoE layer's experts: [E, H, 2, I] and [E, I, H], I over tp (the
    # experts over ep: _EXPERT_LEAVES)
    ("moe_mlp.gate_up", -1), ("moe_mlp.down", 1),
    # LoRA: a column layer's lora_b on its output dim, a row layer's
    # lora_a on its input dim, the QKV lora_b_* on heads; the other
    # factors are replicated
    ("attn.qkv.lora_b_q", 1), ("attn.qkv.lora_b_k", 1),
    ("attn.qkv.lora_b_v", 1), ("attn.o_proj.lora_a", 0),
    ("mlp.gate_up.lora_b", -1), ("mlp.down.lora_a", 0),
    ("lm_head.lora_b", -1),
    # GPT-NeoX
    ("attn.qkv.kernel", -1), ("attn.qkv.bias", -1), ("attn.dense.kernel", 0),
    ("mlp.dense_h_to_4h.kernel", -1), ("mlp.dense_h_to_4h.bias", -1),
    ("mlp.dense_4h_to_h.kernel", 0), ("embed_in.embedding", 0),
    ("embed_out.kernel", -1),
    # BERT
    ("attention.qkv.kernel", -1), ("attention.qkv.bias", -1),
    ("attention.dense.kernel", 0), ("intermediate.kernel", -1),
    ("intermediate.bias", -1), ("output.kernel", 0),
    ("word_embeddings.embedding", 0), ("mlm_bias", 0),
)


# an MoE layer's expert tensors, cut over ep on dim 0 (the experts)
_EXPERT_LEAVES = ("moe_mlp.gate_up", "moe_mlp.down")


def is_expert_leaf(name: str) -> bool:
    """Whether ``name`` (a dotted parameter path) is an MoE expert tensor:
    cut over ep, never over dp by ZeRO-1 or FSDP."""
    return _ends(name, _EXPERT_LEAVES)


def shard_dim(name: str) -> Optional[int]:
    """The dim along which ``name`` (a dotted parameter path) is sharded
    over the tensor-parallel ranks, or None when it is replicated."""
    for suffix, dim in _SHARD_DIMS:
        if name == suffix or name.endswith("." + suffix):
            return dim
    return None


# the parameters cut in q-head blocks, and the k/v heads (replicated over
# kvr), by name suffix
_Q_BLOCKS = ("attn.qkv.q_kernel", "attn.qkv.q_bias", "attn.o_proj.kernel",
             "attn.qkv.lora_b_q", "attn.o_proj.lora_a")
_KV_BLOCKS = ("attn.qkv.k_kernel", "attn.qkv.v_kernel", "attn.qkv.k_bias",
              "attn.qkv.v_bias", "attn.qkv.lora_b_k", "attn.qkv.lora_b_v")


def _ends(name: str, suffixes) -> bool:
    return any(name == s or name.endswith("." + s) for s in suffixes)


def _cut(arr, dim: Optional[int], tp: int, rank: int):
    if dim is None or tp == 1:
        return arr
    n = arr.shape[dim]
    if n % tp:
        raise ValueError(f"dim {dim} of size {n} does not split over "
                         f"tensor-parallel degree {tp}")
    idx = [slice(None)] * arr.ndim
    idx[dim] = slice(rank * (n // tp), (rank + 1) * (n // tp))
    return arr[tuple(idx)]


def _block(name: str, tp: int, rank: int, kvr: int):
    """``(blocks, block)``: how many blocks ``name``'s sharded dim is cut
    into, and which one ``rank`` holds."""
    inner = tp // kvr
    if _ends(name, _Q_BLOCKS):
        return tp, (rank % inner) * kvr + rank // inner
    if _ends(name, _KV_BLOCKS):
        return inner, rank % inner
    return tp, rank


def tp_cut(name: str, ndim: int, tp: int, rank: int, kvr: int = 1
           ) -> Optional[tuple]:
    """``(dim, blocks, block)``: how ``name``'s global tensor is cut over
    the tensor-parallel ranks (``dim`` >= 0, into ``blocks`` pieces, of
    which ``rank`` holds ``block``), or None when it is replicated over
    tp."""
    dim = shard_dim(name)
    if dim is None or tp == 1:
        return None
    return (dim % ndim, *_block(name, tp, rank, kvr))


def _walk(tree, prefix, leaf):
    out = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        out[key] = (_walk(val, path + ".", leaf) if isinstance(val, Mapping)
                    else leaf(path, np.asarray(val)))
    return out


def shard_params_for_rank(params: Mapping[str, Any], tp: int, rank: int,
                          kvr: int = 1) -> Dict[str, Any]:
    """Rank ``rank``'s shard of a JAX param tree at tensor-parallel degree
    ``tp`` (the full degree, KV replication ``kvr``; ``rank`` in the
    tensor-parallel group, kvr-major): the same nesting, each sharded leaf
    cut to its slice (numpy, a copy), replicated leaves as they are."""
    if tp % kvr:
        raise ValueError(f"tensor-parallel degree {tp} not divisible by "
                         f"kv_size_multiplier {kvr}")

    def leaf(path, arr):
        return np.array(_cut(arr, shard_dim(path), *_block(path, tp, rank,
                                                           kvr)))
    return _walk(params, "", leaf)


def ep_shard_for_rank(tree: Mapping[str, Any], ep: int, rank: int
                      ) -> Dict[str, Any]:
    """Expert-parallel rank ``rank``'s cut of a tree at ep degree ``ep``:
    each MoE expert tensor (``moe_mlp.gate_up``/``down``) keeps experts
    ``rank * E / ep`` on (dim 0), every other leaf as it is."""
    def leaf(path, arr):
        return np.array(_cut(arr, 0 if is_expert_leaf(path) else None, ep,
                             rank))
    return _walk(tree, "", leaf)


def zero1_shard_for_rank(tree: Mapping[str, Any], dp: int, rank: int
                         ) -> Dict[str, Any]:
    """Data-parallel rank ``rank``'s ZeRO-1 slice of a (tensor-parallel
    rank's) tree: each leaf cut along the first dim whose size divides
    ``dp``, into ``dp`` pieces, or whole when none does (an MoE expert
    tensor stays whole, as JAX leaves a spec naming ``ep``) -- what that
    rank's optimizer state holds of a JAX ``mu``/``nu`` tree cut by
    :func:`shard_params_for_rank` (:mod:`..optimizer.zero1`)."""
    def leaf(path, arr):
        dim = next((i for i, n in enumerate(arr.shape) if n % dp == 0),
                   None) if dp > 1 and not is_expert_leaf(path) else None
        return np.array(_cut(arr, dim, dp, rank))
    return _walk(tree, "", leaf)


def fsdp_shard_for_rank(tree: Mapping[str, Any], dp: int, rank: int,
                        tp: int = 1, kvr: int = 1) -> Dict[str, Any]:
    """Data-parallel rank ``rank``'s FSDP piece of a tensor-parallel rank's
    tree (from :func:`shard_params_for_rank` at degree ``tp``, KV
    replication ``kvr``; the tree's leaves have that rank's shapes): each
    leaf cut into ``dp`` pieces along the dim ``optimizer.zero1.fsdp_dim``
    picks (the largest global dim whose local size divides ``dp``), or
    whole when none does (an MoE expert tensor too).  What a rank's FSDP
    parameters hold of a JAX param tree, and its AdamW moments of a JAX
    ``mu``/``nu`` tree."""
    from neuronx_distributed_tpu_torch.optimizer.zero1 import fsdp_dim

    def leaf(path, arr):
        if is_expert_leaf(path):
            return np.array(arr)
        cut = tp_cut(path, arr.ndim, tp, 0, kvr)
        full = list(arr.shape)
        if cut is not None:
            full[cut[0]] *= cut[1]
        return np.array(_cut(arr, fsdp_dim(arr.shape, full, dp), dp, rank))
    return _walk(tree, "", leaf)


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(_flatten(val, path + "."))
        else:
            out[path] = val
    return out


def _expected_shapes(cfg, prefix: str = "model.", lm_head: bool = True,
                     norms=("input_norm", "post_attn_norm"), tp: int = 1,
                     kvr: int = 1, ep: int = 1) -> Dict[str, tuple]:
    H, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    NQ, NKV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    E = getattr(cfg, "num_experts", 1)
    shapes = {prefix + "embed.embedding": (V, H),
              prefix + "final_norm.weight": (H,)}
    if lm_head:
        shapes["lm_head.kernel"] = (H, V)
    for i in range(cfg.num_layers):
        p = f"{prefix}layer_{i}."
        shapes.update({
            p + "attn.qkv.q_kernel": (H, NQ, D),
            p + "attn.qkv.k_kernel": (H, NKV, D),
            p + "attn.qkv.v_kernel": (H, NKV, D),
            p + "attn.o_proj.kernel": (NQ * D, H),
            **{f"{p}{n}.weight": (H,) for n in norms},
        })
        if E > 1:
            if E % ep:
                raise ValueError(f"num_experts ({E}) must divide by the "
                                 f"expert-parallel degree ({ep})")
            shapes.update({p + "moe_mlp.router": (H, E),
                           p + "moe_mlp.gate_up": (E // ep, H, 2, I),
                           p + "moe_mlp.down": (E // ep, I, H)})
        else:
            shapes.update({p + "mlp.gate_up.kernel": (H, 2, I),
                           p + "mlp.down.kernel": (I, H)})
        if getattr(cfg, "qkv_bias", False):
            shapes.update({p + "attn.qkv.q_bias": (NQ, D),
                           p + "attn.qkv.k_bias": (NKV, D),
                           p + "attn.qkv.v_bias": (NKV, D)})
        shapes.update(_lora_shapes(cfg, p, H, I, NQ, NKV, D))
    if lm_head:
        shapes.update(_lora_shapes(cfg, "", H, I, NQ, NKV, D, head=True))
    return _sharded(shapes, tp, kvr)


def _lora_shapes(cfg, p: str, H: int, I: int, NQ: int, NKV: int, D: int,
                 head: bool = False) -> Dict[str, tuple]:
    """The adapters of layer prefix ``p`` (or of the LM head) under
    ``cfg.lora_rank`` and ``cfg.lora_targets`` (the QKV adapters on q and
    v, JAX's default)."""
    r = getattr(cfg, "lora_rank", 0)
    targets = getattr(cfg, "lora_targets", ())
    if not r:
        return {}
    if head:
        return ({"lm_head.lora_a": (H, r),
                 "lm_head.lora_b": (r, cfg.vocab_size)}
                if "lm_head" in targets else {})
    out = {}
    if "qkv" in targets:
        out.update({p + "attn.qkv.lora_a_q": (H, r),
                    p + "attn.qkv.lora_b_q": (r, NQ, D),
                    p + "attn.qkv.lora_a_v": (H, r),
                    p + "attn.qkv.lora_b_v": (r, NKV, D)})
    if "o_proj" in targets:
        out.update({p + "attn.o_proj.lora_a": (NQ * D, r),
                    p + "attn.o_proj.lora_b": (r, H)})
    if "mlp" in targets and getattr(cfg, "num_experts", 1) == 1:
        out.update({p + "mlp.gate_up.lora_a": (H, r),
                    p + "mlp.gate_up.lora_b": (r, 2, I),
                    p + "mlp.down.lora_a": (I, r),
                    p + "mlp.down.lora_b": (r, H)})
    return out


def _sharded(shapes: Dict[str, tuple], tp: int,
             kvr: int = 1) -> Dict[str, tuple]:
    """``shapes`` with each sharded dim cut to its ``1 / tp`` (k/v heads
    to ``kvr / tp``)."""
    if tp > 1:
        for name, shape in shapes.items():
            dim = shard_dim(name)
            if dim is not None:
                shape = list(shape)
                shape[dim] //= _block(name, tp, 0, kvr)[0]
                shapes[name] = tuple(shape)
    return shapes


def _norm(shapes: Dict[str, tuple], name: str, H: int) -> None:
    shapes[name + ".weight"] = (H,)
    shapes[name + ".bias"] = (H,)


def _gpt_neox_shapes(cfg, tp: int) -> Dict[str, tuple]:
    H, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    shapes = {"embed_in.embedding": (V, H), "embed_out.kernel": (H, V)}
    _norm(shapes, "final_norm", H)
    for i in range(cfg.num_layers):
        p = f"layer_{i}."
        shapes.update({
            p + "attn.qkv.kernel": (H, 3, H), p + "attn.qkv.bias": (3, H),
            p + "attn.dense.kernel": (H, H), p + "attn.dense.bias": (H,),
            p + "mlp.dense_h_to_4h.kernel": (H, I),
            p + "mlp.dense_h_to_4h.bias": (I,),
            p + "mlp.dense_4h_to_h.kernel": (I, H),
            p + "mlp.dense_4h_to_h.bias": (H,)})
        _norm(shapes, p + "ln_1", H)
        _norm(shapes, p + "ln_2", H)
    return _sharded(shapes, tp)


def _bert_shapes(cfg, tp: int) -> Dict[str, tuple]:
    H, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    shapes = {
        "bert.word_embeddings.embedding": (V, H),
        "bert.position_embeddings": (cfg.max_position_embeddings, H),
        "bert.token_type_embeddings": (cfg.type_vocab_size, H),
        "bert.pooler.kernel": (H, H), "bert.pooler.bias": (H,),
        "mlm_transform.kernel": (H, H), "mlm_transform.bias": (H,),
        "mlm_bias": (V,),
        "nsp_classifier.kernel": (H, 2), "nsp_classifier.bias": (2,)}
    _norm(shapes, "bert.embed_norm", H)
    _norm(shapes, "mlm_norm", H)
    for i in range(cfg.num_layers):
        p = f"bert.layer_{i}."
        shapes.update({
            p + "attention.qkv.kernel": (H, 3, H),
            p + "attention.qkv.bias": (3, H),
            p + "attention.dense.kernel": (H, H),
            p + "attention.dense.bias": (H,),
            p + "intermediate.kernel": (H, I), p + "intermediate.bias": (I,),
            p + "output.kernel": (I, H), p + "output.bias": (H,)})
        _norm(shapes, p + "attention_norm", H)
        _norm(shapes, p + "output_norm", H)
    return _sharded(shapes, tp)


def llama_params_from_jax(tree: Mapping[str, Any], cfg, tp: int = 1,
                          kvr: int = 1, ep: int = 1
                          ) -> Dict[str, torch.Tensor]:
    """A JAX Llama param tree (unboxed, leaves convertible to numpy; with or
    without the leading ``params`` level) -> a ``state_dict`` for the
    port's ``LlamaForCausalLM`` with config ``cfg`` (a rank's shard of
    the tree, from :func:`shard_params_for_rank`, at ``tp > 1`` and KV
    replication ``kvr``; an MoE config's ``moe_mlp.{router, gate_up,
    down}`` leaves, their experts cut by :func:`ep_shard_for_rank` at
    ``ep > 1``).  Raises on a missing, extra or wrongly shaped
    parameter."""
    return _convert(tree, _expected_shapes(cfg, tp=tp, kvr=kvr, ep=ep))


def gemma_params_from_jax(tree: Mapping[str, Any], cfg,
                          tp: int = 1) -> Dict[str, torch.Tensor]:
    """A JAX ``GemmaForCausalLM`` param tree -> a ``state_dict`` for the
    port's ``GemmaForCausalLM`` with config ``cfg`` (a ``GemmaConfig``).
    The tree has no ``lm_head``: the head is the tied embedding."""
    return _convert(tree, _expected_shapes(cfg, prefix="", lm_head=False,
                                           tp=tp))


def gemma2_params_from_jax(tree: Mapping[str, Any], cfg,
                           tp: int = 1) -> Dict[str, torch.Tensor]:
    """A JAX ``Gemma2ForCausalLM`` param tree -> a ``state_dict`` for the
    port's ``Gemma2ForCausalLM``; each layer carries the four sandwich-norm
    weights."""
    return _convert(tree, _expected_shapes(
        cfg, prefix="", lm_head=False,
        norms=("input_norm", "post_attn_norm", "pre_ffw_norm",
               "post_ffw_norm"), tp=tp))


def gpt_neox_params_from_jax(tree: Mapping[str, Any], cfg,
                             tp: int = 1) -> Dict[str, torch.Tensor]:
    """A JAX ``GPTNeoXForCausalLM`` param tree -> a ``state_dict`` for the
    port's ``GPTNeoXForCausalLM`` with config ``cfg`` (a rank's shard at
    ``tp > 1``): fused QKV, biased linears, LayerNorm pairs, the untied
    ``embed_out``."""
    return _convert(tree, _gpt_neox_shapes(cfg, tp))


def bert_params_from_jax(tree: Mapping[str, Any], cfg,
                         tp: int = 1) -> Dict[str, torch.Tensor]:
    """A JAX ``BertForPreTraining`` param tree -> a ``state_dict`` for the
    port's ``BertForPreTraining`` with config ``cfg`` (a rank's shard at
    ``tp > 1``, ``mlm_bias`` cut by vocab)."""
    return _convert(tree, _bert_shapes(cfg, tp))


def _convert(tree: Mapping[str, Any], want: Dict[str, tuple]
             ) -> Dict[str, torch.Tensor]:
    flat = _flatten(tree.get("params", tree))
    if set(flat) != set(want):
        missing = sorted(set(want) - set(flat))
        extra = sorted(set(flat) - set(want))
        raise ValueError(f"param tree does not fit the config: missing "
                         f"{missing[:5]}, unexpected {extra[:5]}")
    sd = {}
    for name, shape in want.items():
        val = flat[name]
        # a tensor stays as it is (its device, its dtype, a view stays a
        # view); anything else becomes a tensor over a writable copy
        arr = val if isinstance(val, torch.Tensor) else np.asarray(val)
        if tuple(arr.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(arr.shape)}, config "
                             f"wants {shape}")
        sd[name] = val if isinstance(val, torch.Tensor) else \
            torch.from_numpy(np.array(arr))
    return sd


# the pp = 1 names of a pipelined tree's parts, by family: the embedding's
# path, a layer's path, and the head's children's paths
_PIPELINED_NAMES = {
    "llama": ("model.embed", "model.layer_{}",
              {"final_norm": "model.final_norm", "lm_head": "lm_head"}),
    "gpt_neox": ("embed_in", "layer_{}",
                 {"final_norm": "final_norm", "embed_out": "embed_out"}),
}


def _pipelined_flat(tree: Mapping[str, Any], layer_rows, layers, embed: bool,
                    head: bool, family: str, tp: int, rank: int,
                    kvr: int, ep: int = 1, ep_rank: int = 0
                    ) -> Dict[str, np.ndarray]:
    if family not in _PIPELINED_NAMES:
        raise ValueError(f"unknown pipelined family {family!r} (one of "
                         f"{sorted(_PIPELINED_NAMES)})")
    embed_path, block_path, head_places = _PIPELINED_NAMES[family]
    tree = tree.get("params", tree)
    out: Dict[str, np.ndarray] = {}
    if embed:
        for k, v in _flatten(tree["embed"]).items():
            out[f"{embed_path}.{k}"] = np.asarray(v)
    stack = _flatten(tree["layers"])
    for i in layers:
        for k, v in stack.items():
            out[f"{block_path.format(i)}.{k}"] = np.asarray(v)[layer_rows[i]]
    if head:
        for k, v in _flatten(tree["head"]).items():
            child, rest = k.split(".", 1)
            out[f"{head_places[child]}.{rest}"] = np.asarray(v)
    return ep_shard_for_rank(shard_params_for_rank(out, tp, rank, kvr), ep,
                             ep_rank)


def pipelined_params_from_jax(tree: Mapping[str, Any], layer_rows,
                              layers, *, embed: bool, head: bool,
                              family: str = "llama", tp: int = 1,
                              rank: int = 0, kvr: int = 1, ep: int = 1,
                              ep_rank: int = 0
                              ) -> Dict[str, torch.Tensor]:
    """One pipeline stage's ``state_dict`` from a JAX pipelined param tree
    (``{embed, layers: [L', ...], head}``, leaves convertible to numpy):
    real layer ``i`` of ``layers`` is row ``layer_rows[i]`` of the stack,
    the embedding and the head are included when ``embed``/``head``, and
    every name is the pp = 1 model's (``model.layer_2.attn...`` for
    ``family="llama"``, ``layer_2...`` for ``"gpt_neox"``), cut for
    tensor-parallel rank ``rank`` at degree ``tp`` and KV replication
    ``kvr``, an MoE layer's experts for ep rank ``ep_rank`` at degree
    ``ep``.  ``layers=range(L)`` with both flags gives the whole pp = 1
    model.  ``load_state_dict`` checks the names and shapes."""
    flat = _pipelined_flat(tree, layer_rows, layers, embed, head, family, tp,
                           rank, kvr, ep, ep_rank)
    return {k: torch.from_numpy(np.array(v)) for k, v in flat.items()}


def pipelined_grads_from_jax(grads: Mapping[str, Any], layer_rows, layers,
                             *, embed: bool, head: bool,
                             family: str = "llama", tp: int = 1,
                             rank: int = 0, kvr: int = 1, ep: int = 1,
                             ep_rank: int = 0) -> Dict[str, np.ndarray]:
    """JAX's pipelined gradients (the param tree's structure) under the
    same names and cuts as :func:`pipelined_params_from_jax`, as numpy
    arrays (the padded rows' zero gradients are dropped)."""
    return _pipelined_flat(grads, layer_rows, layers, embed, head, family,
                           tp, rank, kvr, ep, ep_rank)
