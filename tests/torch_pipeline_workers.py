"""Rank bodies of the PyTorch port's pipeline tests.

Each function runs in every rank of a world that
``neuronx_distributed_tpu_torch.utils.distributed.spawn`` starts (fresh
processes, gloo on the CPU) and returns plain Python and numpy values.
This module imports ``torch``, numpy and the port only: the JAX side of
each comparison runs in the test process.
"""

import numpy as np
import torch

GROUP_TIMEOUT_S = 30.0


def _np(t):
    return t.detach().cpu().numpy().copy()


def _build(config, cfg, family="llama"):
    from neuronx_distributed_tpu_torch.models import (
        GPTNeoXForCausalLM,
        LlamaForCausalLM,
    )
    from neuronx_distributed_tpu_torch.trainer import initialize_parallel_model

    cls = LlamaForCausalLM if family == "llama" else GPTNeoXForCausalLM
    return initialize_parallel_model(config, lambda d: cls(cfg, device=d),
                                     device="cpu")


def _load(model, case, family="llama"):
    """This rank's stage from the JAX pipelined tree of ``case``."""
    from neuronx_distributed_tpu_torch.convert import (
        pipelined_params_from_jax,
    )

    stage = model.module
    tp = stage.parts["tp"]
    stage.load_state_dict(pipelined_params_from_jax(
        case["params"], case["rows"], stage.layer_ids, embed=stage.has_embed,
        head=stage.has_head, family=family, tp=tp.size, rank=tp.rank,
        kvr=tp.kvr))


def _grads(model):
    """This rank's complete gradients: the cp, sequence-parallel, kvr and
    dp sums the train step would take."""
    from neuronx_distributed_tpu_torch.parallel import mesh
    from neuronx_distributed_tpu_torch.parallel.grads import (
        allreduce_kv_replicated_gradients,
        allreduce_sequence_parallel_gradients,
        coalesced_all_reduce,
        psum_over_data_parallel,
    )

    params = list(model.module.parameters())
    if mesh.get_context_parallel_size() > 1:
        coalesced_all_reduce([p.grad for p in params],
                             mesh.get_context_parallel_group())
    allreduce_sequence_parallel_gradients(params)
    allreduce_kv_replicated_gradients(params)
    psum_over_data_parallel([p.grad for p in params], mean=False)
    return {n: _np(p.grad) for n, p in model.module.named_parameters()}


def _config(**kw):
    from neuronx_distributed_tpu_torch.config import training_config

    return training_config(pipeline_parallel_size=2, compute_dtype="float32",
                           seed=0, **kw)


def _llama(case):
    from neuronx_distributed_tpu_torch.models import LlamaConfig

    return LlamaConfig.tiny(dtype=torch.float32, param_dtype=torch.float32,
                            max_seq_len=16, **case["cfg"])


def _where(model):
    from neuronx_distributed_tpu_torch.parallel import mesh

    stage = model.module
    return {"pp": (mesh.get_pipeline_parallel_size(),
                   mesh.get_pipeline_parallel_rank()),
            "tp": (stage.parts["tp"].size, stage.parts["tp"].rank,
                   stage.parts["tp"].kvr),
            "dp": (mesh.get_data_parallel_size(),
                   mesh.get_data_parallel_rank()),
            "cp": (mesh.get_context_parallel_size(),
                   mesh.get_context_parallel_rank()),
            "layers": stage.chunks, "rows": model.layer_rows,
            "embed": stage.has_embed, "head": stage.has_head}


def schedule_case(case, family="llama"):
    """One schedule's loss, token count and complete gradients on the JAX
    weights, with the peak of live microbatch graphs and the transfers."""
    from neuronx_distributed_tpu_torch.models import GPTNeoXConfig
    from neuronx_distributed_tpu_torch.parallel import mappings, mesh

    kw = dict(num_microbatches=case["M"], schedule=case["schedule"],
              virtual_stages=case.get("V", 1),
              pipeline_cuts=case.get("cuts"),
              packed_inputs=case.get("packed", False),
              tensor_parallel_size=case.get("tp", 1),
              kv_size_multiplier=case.get("kvr", 1),
              context_parallel_size=case.get("cp", 1))
    cfg = (_llama(case) if family == "llama" else GPTNeoXConfig.tiny(
        dtype=torch.float32, param_dtype=torch.float32, max_seq_len=16,
        **case["cfg"]))
    model = _build(_config(**kw), cfg, family)
    _load(model, case, family)
    b = case["batch"]
    args = [torch.as_tensor(b[k]) for k in ("ids", "labels",
                                            *model.extra_keys)]
    mappings.reset_counts()
    loss_sum, tok = model.loss_and_grad_fn(*args)
    out = dict(_where(model), loss=loss_sum.item(), tok=tok.item(),
               grads=_grads(model), stats=dict(model.stats),
               counts=dict(mappings.COUNTS), bytes=dict(mappings.BYTES))
    if case.get("forward"):
        out["logits"] = _np(model.forward_fn(args[0], *args[2:]))
    if case.get("oracle"):
        # GPipe's differentiable loss: backward on every rank
        model.module.zero_grad(set_to_none=True)
        ls, _ = model.loss_fn(*args)
        ls.backward()
        out["oracle_loss"] = ls.item()
        out["oracle_grads"] = _grads(model)
    mesh.destroy_model_parallel()
    return out


def train_case(case):
    """``case["steps"]`` AdamW steps through ``make_train_step`` and one
    ``make_eval_step`` on the JAX weights: losses, grad norms, eval loss,
    final parameters."""
    from neuronx_distributed_tpu_torch.parallel import mesh
    from neuronx_distributed_tpu_torch.trainer import (
        initialize_parallel_optimizer,
        make_eval_step,
        make_train_step,
    )

    config = _config(num_microbatches=case["M"], learning_rate=1e-3,
                     schedule=case.get("schedule", "1f1b"),
                     zero_one_enabled=case.get("zero1", True),
                     context_parallel_size=case.get("cp", 1))
    model = _build(config, _llama(case))
    _load(model, case)
    trainable = None
    if case.get("lora"):
        from neuronx_distributed_tpu_torch import peft

        trainable = peft.lora_trainable
    opt = initialize_parallel_optimizer(config, model, trainable=trainable)
    step = make_train_step(config, model, opt)
    eval_loss = make_eval_step(config, model)(case["batches"][0])["loss"]
    logits = None
    if case.get("forward"):
        logits = _np(model.forward_fn(torch.as_tensor(
            case["batches"][0]["ids"])))
    losses, norms = [], []
    for b in case["batches"]:
        m = step(b)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    out = dict(_where(model), losses=losses, norms=norms,
               eval_loss=eval_loss.item(), logits=logits,
               zero1=opt.zero1 is not None,
               params={n: _np(p) for n, p in model.module.named_parameters()},
               stateful=sorted(names_with_state(model, opt)))
    mesh.destroy_model_parallel()
    return out


def names_with_state(model, opt):
    """The parameters that hold AdamW state."""
    names = {p: n for n, p in model.module.named_parameters()}
    return [names[p] for p in opt.optimizer.state if p in names]


def fit_case(case):
    """``fit`` at pp = 2 with checkpoints: a continuous run, a run stopped
    at the middle and resumed, and the pp = 1 checkpoint ``case["pp1"]``
    loaded into the stages."""
    from neuronx_distributed_tpu_torch.parallel import mesh
    from neuronx_distributed_tpu_torch.trainer import (
        Callback,
        fit,
        initialize_parallel_optimizer,
        load_checkpoint,
        model_shards,
        optimizer_shards,
        restore_model,
        restore_optimizer,
    )

    config = _config(num_microbatches=case["M"], learning_rate=1e-3)
    batches = case["batches"]

    class Losses(Callback):
        def __init__(self):
            self.losses = []

        def on_step(self, step, metrics):
            self.losses.append(metrics["loss"])

    def run(ckpt_dir, steps, resume, obs=None):
        model = _build(config, _llama(case))
        opt = initialize_parallel_optimizer(config, model)
        rec = Losses()
        res = fit(config, model, opt, lambda i: batches[i], steps=steps,
                  ckpt_dir=ckpt_dir, ckpt_every=2, resume=resume,
                  log_every=0, callbacks=[rec], async_save=False, obs=obs)
        params = {n: _np(p) for n, p in model.module.named_parameters()}
        mesh.destroy_model_parallel()
        return {"losses": rec.losses, "start": res.start_step,
                "params": params}

    from neuronx_distributed_tpu_torch.obs import Observability
    from neuronx_distributed_tpu_torch.utils.distributed import get_rank

    hub = Observability(f"{case['dir_whole']}_obs{get_rank()}")

    out = {"whole": run(case["dir_whole"], len(batches), False, hub),
           "first": run(case["dir_resume"], len(batches) // 2, False),
           "resumed": run(case["dir_resume"], len(batches), True)}
    out["gauges"] = {k: v for k, v in hub.registry.snapshot().items()
                     if k.startswith("pipeline/")}
    hub.close()
    model = _build(config, _llama(case))
    opt = initialize_parallel_optimizer(config, model)
    mstate, ostate, _, user = load_checkpoint(
        case["pp1"], model_template=model_shards(model),
        optimizer_template=optimizer_shards(model, opt))
    restore_model(model, mstate, opt)
    restore_optimizer(model, opt, ostate)
    st = opt.optimizer.state
    names = {p: n for n, p in model.module.named_parameters()}
    out["from_pp1"] = {
        "params": {n: _np(p) for n, p in model.module.named_parameters()},
        "exp_avg": {names[p]: _np(s["exp_avg"]) for p, s in st.items()},
        "count": opt.update_count, "user": user}
    out.update(_where(model))
    mesh.destroy_model_parallel()
    return out


def pp2_cases(inp: dict):
    """The 2-rank world: every schedule case, the training steps and the
    fit / checkpoint case."""
    from neuronx_distributed_tpu_torch.utils.distributed import (
        initialize_distributed,
    )

    initialize_distributed(device="cpu", timeout_s=GROUP_TIMEOUT_S)
    out = {name: schedule_case(case) for name, case in inp["cases"].items()}
    out["train"] = train_case(inp["train"])
    out["fit"] = fit_case(inp["fit"])
    out["refused"] = refused_family()
    return out


def refused_family() -> str:
    """The error of a pp = 2 model without ``build_pipelined``."""
    from neuronx_distributed_tpu_torch.models import (
        GemmaConfig,
        GemmaForCausalLM,
    )
    from neuronx_distributed_tpu_torch.parallel import mesh

    cfg = GemmaConfig.tiny(dtype=torch.float32, param_dtype=torch.float32)
    try:
        from neuronx_distributed_tpu_torch.trainer import (
            initialize_parallel_model,
        )

        initialize_parallel_model(_config(), lambda d: GemmaForCausalLM(
            cfg, device=d), device="cpu")
    except ValueError as e:
        return str(e)
    finally:
        mesh.destroy_model_parallel()
    return ""


def pp4_cases(inp: dict):
    """The 4-rank world: pp = 2 with tp = 2 (SP; kvr = 2), GPT-NeoX at pp
    = 2 x tp = 2, and pp = 2 x dp = 2 training with ZeRO-1."""
    from neuronx_distributed_tpu_torch.utils.distributed import (
        initialize_distributed,
    )

    initialize_distributed(device="cpu", timeout_s=GROUP_TIMEOUT_S)
    out = {}
    for name, case in inp["cases"].items():
        out[name] = schedule_case(case, case.get("family", "llama"))
    out["dp_train"] = train_case(inp["dp_train"])
    return out


def resume_case(case):
    """``fit`` at pp = 2 x cp = ``case["cp"]`` with checkpoints: a
    continuous run, and a run stopped at the middle and resumed from its
    checkpoint: the losses, the final parameters, and the ranks that wrote
    each payload's pieces of the last checkpoint."""
    import json
    import os

    from neuronx_distributed_tpu_torch.parallel import mesh
    from neuronx_distributed_tpu_torch.trainer import (
        Callback,
        fit,
        initialize_parallel_optimizer,
    )

    config = _config(num_microbatches=case["M"], learning_rate=1e-3,
                     context_parallel_size=case["cp"])
    batches = case["batches"]

    class Losses(Callback):
        def __init__(self):
            self.losses = []

        def on_step(self, step, metrics):
            self.losses.append(metrics["loss"])

    def run(ckpt_dir, steps, resume):
        model = _build(config, _llama(case))
        opt = initialize_parallel_optimizer(config, model)
        rec = Losses()
        res = fit(config, model, opt, lambda i: batches[i], steps=steps,
                  ckpt_dir=ckpt_dir, ckpt_every=2, resume=resume,
                  log_every=0, callbacks=[rec], async_save=False)
        params = {n: _np(p) for n, p in model.module.named_parameters()}
        where = _where(model)
        mesh.destroy_model_parallel()
        return {"losses": rec.losses, "start": res.start_step,
                "params": params, "where": where}

    out = {"whole": run(case["dir_whole"], len(batches), False),
           "first": run(case["dir_resume"], len(batches) // 2, False),
           "resumed": run(case["dir_resume"], len(batches), True)}
    with open(os.path.join(case["dir_whole"], f"step_{len(batches)}",
                           "meta.json")) as f:
        index = json.load(f)["tensors"]
    # the ranks whose files hold each payload's pieces
    out["writers"] = {name: sorted({sh["rank"] for rec in recs.values()
                                    for sh in rec["shards"]})
                      for name, recs in index.items()}
    return out


def ppcp_cases(inp: dict):
    """The 4-rank world at pp = 2 x cp = 2: each schedule case (Llama on
    the ring and on the dense core, GPT-NeoX), the training steps (with
    and without LoRA) and the checkpoint resume."""
    from neuronx_distributed_tpu_torch.utils.distributed import (
        initialize_distributed,
    )

    initialize_distributed(device="cpu", timeout_s=GROUP_TIMEOUT_S)
    out = {}
    for name, case in inp["cases"].items():
        out[name] = schedule_case(case, case.get("family", "llama"))
    for name, case in inp["train"].items():
        out[name] = train_case(case)
    out["resume"] = resume_case(inp["resume"])
    return out
