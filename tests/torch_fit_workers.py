"""Rank bodies for the port's FSDP and checkpoint worlds (spawned by
``tests/test_torch_{fsdp,checkpoint}.py`` through
``utils.distributed.spawn``).  This module imports no JAX: the workers run
the port alone, on the CPU over gloo, and return numpy results."""

import numpy as np
import torch

GROUP_TIMEOUT_S = 30.0


def _np(t):
    return t.detach().float().numpy().copy()


def _world():
    from neuronx_distributed_tpu_torch.utils.distributed import (
        initialize_distributed,
    )

    initialize_distributed(device="cpu", timeout_s=GROUP_TIMEOUT_S)


def _llama(cfg_kw):
    from neuronx_distributed_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaForCausalLM,
    )

    cfg = LlamaConfig.tiny(num_kv_heads=2, dtype=torch.float32,
                           param_dtype=torch.float32, max_seq_len=16,
                           **cfg_kw)
    return cfg, (lambda d: LlamaForCausalLM(cfg, device=d))


def _fsdp_train(config, build, params, loss_fn, batches, ckpt_dir=None):
    """One tensor-parallel x data-parallel run: the model from ``build``,
    loaded with this rank's cut of the JAX tree ``params`` (and under FSDP
    its dp piece of that: the port's names, so no converter), trained
    on ``batches``; then with ``ckpt_dir`` a checkpoint of step 3.
    Returns the losses, norms, this rank's parameters with their boxes in
    the global tensors, its parameter and AdamW-state bytes, each step's
    collectives and its AdamW first moments."""
    from neuronx_distributed_tpu_torch.convert import (
        fsdp_shard_for_rank,
        shard_params_for_rank,
    )
    from neuronx_distributed_tpu_torch.optimizer.zero1 import state_bytes
    from neuronx_distributed_tpu_torch.parallel import fsdp, mappings, mesh
    from neuronx_distributed_tpu_torch.trainer import (
        initialize_parallel_model,
        initialize_parallel_optimizer,
        make_train_step,
        model_shards,
        optimizer_shards,
        save_checkpoint,
    )

    model = initialize_parallel_model(config, build, device="cpu")
    module = model.module
    tp_rank = module.tp.rank
    dp, dp_rank = (mesh.get_data_parallel_size(),
                   mesh.get_data_parallel_rank())
    tree = shard_params_for_rank(params, 2, tp_rank)
    if config.fsdp:
        tree = fsdp_shard_for_rank(tree, dp, dp_rank, tp=2)
    module.load_state_dict({n: torch.from_numpy(np.array(v))
                            for n, v in _flat(tree)})
    opt = initialize_parallel_optimizer(config, model)
    step = make_train_step(config, model, opt, loss_fn)
    losses, norms, counts = [], [], []
    for b in batches:
        mappings.reset_counts()
        m = step(b)
        counts.append(dict(mappings.COUNTS))
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    out = {
        "losses": losses, "norms": norms, "counts": counts,
        "pieces": {n: (_np(s.tensor), s.box())
                   for n, s in model_shards(model).items()},
        "sharded": sorted(n for n, p in module.named_parameters()
                          if fsdp.is_sharded(p)),
        "param_bytes": sum(p.numel() * p.element_size()
                           for p in module.parameters()),
        "state_bytes": state_bytes(opt.optimizer),
        "tp_rank": tp_rank, "dp_rank": dp_rank,
        "moments": {n: _np(s.tensor) for n, s in
                    optimizer_shards(model, opt)["exp_avg"].items()},
    }
    if ckpt_dir is not None:
        save_checkpoint(ckpt_dir, "step_3", model_shards(model),
                        optimizer_shards(model, opt),
                        user_content={"step": 3})
    mesh.destroy_model_parallel()
    return out


def fsdp_world(inp: dict):
    """The tiny Llama trained at tp = 2 x dp = 2 from this rank's cut of the
    JAX tree, with FSDP and replicated (no ZeRO-1), each with the whole
    loss head and with the chunked one; the first FSDP run then saves a
    checkpoint into ``inp["ckpt_dir"]``.  Per case: :func:`_fsdp_train`'s
    results."""
    from neuronx_distributed_tpu_torch.config import training_config
    from neuronx_distributed_tpu_torch.models.common import (
        causal_lm_loss_sum,
        make_causal_lm_loss_sum,
    )

    _world()
    out = {}
    for case in ("fsdp", "replicated", "fsdp_chunked", "replicated_chunked"):
        config = training_config(
            tensor_parallel_size=2, seed=0, compute_dtype="float32",
            fsdp=case.startswith("fsdp"), zero_one_enabled=False,
            grad_clipping=False, **inp["opt"])
        _, build = _llama(inp["cfg"])
        loss_fn = (make_causal_lm_loss_sum(inp["chunk"])
                   if case.endswith("chunked") else causal_lm_loss_sum)
        out[case] = _fsdp_train(
            config, build, inp["params"], loss_fn, inp["batches"],
            inp["ckpt_dir"] if case == "fsdp" else None)
    return out


def fsdp_tied_world(inp: dict):
    """Gemma with the chunked loss head (the tied table read by
    ``attend`` once a chunk and in each chunk's recompute) and BERT (its
    MLM decoder tied to the word table), trained with FSDP at tp = 2 x dp
    = 2 from this rank's cut of the JAX trees: :func:`_fsdp_train`'s
    results by model."""
    from neuronx_distributed_tpu_torch.config import training_config
    from neuronx_distributed_tpu_torch.models import (
        BertConfig,
        BertForPreTraining,
        GemmaConfig,
        GemmaForCausalLM,
        pretraining_loss,
    )
    from neuronx_distributed_tpu_torch.models.common import (
        make_causal_lm_loss_sum,
    )

    _world()
    f32 = dict(dtype=torch.float32, param_dtype=torch.float32)
    gemma = GemmaConfig.tiny(max_seq_len=16, sequence_parallel=False, **f32)
    bert = BertConfig.tiny(**f32)
    models = {
        "gemma": (lambda d: GemmaForCausalLM(gemma, device=d),
                  make_causal_lm_loss_sum(inp["chunk"])),
        "bert": (lambda d: BertForPreTraining(bert, device=d),
                 pretraining_loss)}
    out = {}
    for name, (build, loss_fn) in models.items():
        config = training_config(
            tensor_parallel_size=2, seed=0, compute_dtype="float32",
            fsdp=True, zero_one_enabled=False, grad_clipping=False,
            **inp["opt"])
        out[name] = _fsdp_train(config, build, inp[name]["params"],
                                loss_fn, inp[name]["batches"])
    return out


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def load_world(inp: dict):
    """Load ``inp["ckpt_dir"]``'s newest tag into a tiny Llama laid out at
    this world's degrees (``inp["tp"]``), parameters and AdamW moments:
    this rank's pieces and the count."""
    from neuronx_distributed_tpu_torch.config import training_config
    from neuronx_distributed_tpu_torch.parallel import mesh
    from neuronx_distributed_tpu_torch.trainer import (
        initialize_parallel_model,
        initialize_parallel_optimizer,
        load_checkpoint,
        model_shards,
        optimizer_shards,
        restore_model,
        restore_optimizer,
    )

    _world()
    config = training_config(tensor_parallel_size=inp["tp"], seed=1,
                             compute_dtype="float32", **inp["opt"])
    _, build = _llama(inp["cfg"])
    model = initialize_parallel_model(config, build, device="cpu")
    opt = initialize_parallel_optimizer(config, model)
    mstate, ostate, _, user = load_checkpoint(
        inp["ckpt_dir"], model_template=model_shards(model),
        optimizer_template=optimizer_shards(model, opt))
    restore_model(model, mstate, opt)
    restore_optimizer(model, opt, ostate)
    out = {"params": {n: (_np(s.tensor), s.box())
                      for n, s in model_shards(model).items()},
           "moments": {n: (_np(s.tensor), s.box()) for n, s in
                       optimizer_shards(model, opt)["exp_avg"].items()},
           "count": opt.update_count, "user": user,
           "tp_rank": model.module.tp.rank}
    mesh.destroy_model_parallel()
    return out


def ckpt_race(inp: dict):
    """Two ranks over one shared directory (JAX
    ``tests/dist_ckpt_worker.py``): sync saves with rotation and an
    overwritten tag, an async save finalised by ``wait_for_checkpoint``,
    and a restore of this rank's dp piece and of the whole tensor."""
    import os

    from neuronx_distributed_tpu_torch.trainer.checkpoint import (
        Shard,
        load_checkpoint,
        newest_tag,
        save_checkpoint,
        wait_for_checkpoint,
    )
    from neuronx_distributed_tpu_torch.utils import distributed

    _world()
    rank = distributed.get_rank()
    ckpt_dir = inp["ckpt_dir"]

    def state(scale):
        w = torch.arange(32.0).reshape(8, 4) * scale
        return {"w": Shard(w[rank * 4:(rank + 1) * 4].clone(),
                           ((0, 2, rank),)),
                "b": torch.arange(8.0) * scale}

    for step, scale in ((1, 1.0), (2, 2.0), (2, 2.5), (3, 3.0)):
        save_checkpoint(ckpt_dir, f"step_{step}", state(scale),
                        user_content={"step": step}, num_kept_ckpts=2)
    distributed.rendezvous("saved")
    tags = sorted(d for d in os.listdir(ckpt_dir)
                  if os.path.isdir(os.path.join(ckpt_dir, d)))
    newest = newest_tag(ckpt_dir)
    # rank 0 makes the next tag's directory as its save starts: no rank
    # may start it before every rank has listed
    distributed.rendezvous("listed")
    save_checkpoint(ckpt_dir, "step_4", state(4.0),
                    user_content={"step": 4}, num_kept_ckpts=2,
                    async_save=True)
    wait_for_checkpoint()
    after_async = newest_tag(ckpt_dir)
    piece, _, _, user = load_checkpoint(ckpt_dir, model_template=state(0.0))
    whole, _, _, _ = load_checkpoint(
        ckpt_dir, model_template={"w": torch.zeros(8, 4),
                                  "b": torch.zeros(8)})
    return {"tags": tags, "newest": newest, "after_async": after_async,
            "user": user, "piece": _np(piece["w"]), "b": _np(piece["b"]),
            "whole": _np(whole["w"])}
