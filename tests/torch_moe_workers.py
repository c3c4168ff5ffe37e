"""Rank bodies of the PyTorch port's MoE tests (``tests/test_torch_moe.py``).

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


def _f32():
    return dict(dtype=torch.float32, param_dtype=torch.float32)


def _complete(params, named):
    """The gradients the train step sums before its update: sequence-
    parallel and kvr sums over tp, every non-expert gradient over dp x ep,
    every expert's over the pure dp axis."""
    from neuronx_distributed_tpu_torch.parallel.grads import (
        allreduce_expert_gradients,
        allreduce_kv_replicated_gradients,
        allreduce_sequence_parallel_gradients,
        psum_over_data_parallel,
    )
    from neuronx_distributed_tpu_torch.parallel.moe import is_expert_parallel

    params = list(params)
    allreduce_sequence_parallel_gradients(params)
    allreduce_kv_replicated_gradients(params)
    psum_over_data_parallel([p.grad for p in params
                             if not is_expert_parallel(p)], mean=False)
    allreduce_expert_gradients([p.grad for p in params
                                if is_expert_parallel(p)])
    return {n: _np(p.grad) for n, p in named}


def _where():
    from neuronx_distributed_tpu_torch.parallel import mesh

    return {"tp": (mesh.get_tensor_parallel_size(),
                   mesh.get_tensor_parallel_rank()),
            "ep": (mesh.get_expert_parallel_size(),
                   mesh.get_expert_parallel_rank()),
            "dp": (mesh.get_data_parallel_size(),
                   mesh.get_data_parallel_rank()),
            "pp": (mesh.get_pipeline_parallel_size(),
                   mesh.get_pipeline_parallel_rank())}


def _cut(tree, tp: int, tp_rank: int, ep: int, ep_rank: int):
    from neuronx_distributed_tpu_torch.convert import (
        ep_shard_for_rank,
        shard_params_for_rank,
    )

    return ep_shard_for_rank(shard_params_for_rank(tree, tp, tp_rank), ep,
                             ep_rank)


# -- the layer ------------------------------------------------------------------


def layer_case(case):
    """One ``ExpertParallelMLP`` on this rank's rows of ``case["x"]``
    (the batch split over dp x ep): its output rows, aux, the input's
    gradient rows and the complete parameter gradients of ``sum(y^2) +
    aux`` (each rank adds its token share of the aux, so the sum over the
    batch ranks is the whole loss once)."""
    from neuronx_distributed_tpu_torch.parallel import mesh
    from neuronx_distributed_tpu_torch.parallel.mesh import (
        ExpertParallel,
        TensorParallel,
    )
    from neuronx_distributed_tpu_torch.parallel.moe import ExpertParallelMLP

    tp, ep = TensorParallel.current(), ExpertParallel.current()
    x = case["x"]
    H = x.shape[-1]
    mod = ExpertParallelMLP(
        H, case["E"], case["I"], top_k=case["K"],
        capacity_factor=case["cap"], dispatch=case["dispatch"],
        router_type=case["router"], device="cpu", **_f32())
    tree = _cut({"moe_mlp": case["params"]}, tp.size, tp.rank, ep.size,
                ep.rank)["moe_mlp"]
    mod.load_state_dict({k: torch.from_numpy(v) for k, v in tree.items()})
    nb, r = mesh.get_data_parallel_size(), mesh.get_data_parallel_rank()
    b = x.shape[0] // nb
    xl = torch.from_numpy(x[r * b:(r + 1) * b].copy()).requires_grad_()
    y, aux = mod(xl)
    ((y * y).sum() + aux * (b / x.shape[0])).backward()
    return dict(_where(), y=_np(y), aux=aux.item(), rows=(r * b, (r + 1) * b),
                x_grad=_np(xl.grad), local_experts=mod.num_local,
                grads=_complete(mod.parameters(), mod.named_parameters()))


def layer_cases(inp):
    """Every layer case at tp = 2 x ep = 2."""
    from neuronx_distributed_tpu_torch.parallel import mesh

    mesh.initialize_model_parallel(tensor_parallel_size=2,
                                   expert_parallel_size=2)
    out = {name: layer_case(case) for name, case in inp.items()}
    mesh.destroy_model_parallel()
    return out


# -- the model under the train step ---------------------------------------------


def _llama(case):
    from neuronx_distributed_tpu_torch.models import LlamaConfig

    return LlamaConfig.tiny(**_f32(), **case["cfg"])


def _load_llama(module, cfg, tree):
    """JAX's weights, this rank's tp and ep cut (and under FSDP its dp
    piece, the experts whole)."""
    from neuronx_distributed_tpu_torch.convert import (
        fsdp_shard_for_rank,
        llama_params_from_jax,
    )
    from neuronx_distributed_tpu_torch.parallel import fsdp, mesh

    tp, ep = module.tp, mesh.get_expert_parallel_size()
    sd = llama_params_from_jax(
        _cut(tree, tp.size, tp.rank, ep, mesh.get_expert_parallel_rank()),
        cfg, tp=tp.size, ep=ep)
    st = fsdp.fsdp_state(module)
    if st is not None:
        nested = {}
        for name, t in sd.items():
            *path, leaf = name.split(".")
            d = nested
            for k in path:
                d = d.setdefault(k, {})
            d[leaf] = t.numpy()
        sd = {}

        def flat(tree, prefix=""):
            for k, v in tree.items():
                if isinstance(v, dict):
                    flat(v, f"{prefix}{k}.")
                else:
                    sd[prefix + k] = torch.from_numpy(np.array(v))

        flat(fsdp_shard_for_rank(nested, st.size, st.rank, tp=tp.size))
    module.load_state_dict(sd)


def _first_grads(module, loss_fn, batch):
    """The complete gradients of ``batch``'s loss, normalised as the step
    normalises them (the token contract: over the global token count; the
    mean contract: over the batch ranks)."""
    from neuronx_distributed_tpu_torch.parallel import mappings, mesh
    from neuronx_distributed_tpu_torch.trainer import data_parallel_slice

    nb, r = mesh.get_data_parallel_size(), mesh.get_data_parallel_rank()
    local = {k: torch.as_tensor(v) for k, v in data_parallel_slice(
        batch, nb, r).items()}
    out = loss_fn(module, local)
    if isinstance(out, tuple):
        out[0].backward()
        scale = 1.0 / mappings.all_reduce(out[1].detach(),
                                          mesh.get_data_parallel_group())
    else:
        out.backward()
        scale = torch.tensor(1.0 / nb)
    for p in module.parameters():
        p.grad.mul_(scale)
    grads = _complete(module.parameters(), module.named_parameters())
    module.zero_grad(set_to_none=True)
    return grads


def train_case(case):
    """The MoE Llama from JAX's initial weights: the complete gradients
    of the first batch's loss (normalised as the step normalises them),
    then ``len(case["batches"])`` steps through ``make_train_step``
    (losses, grad norms), the final parameters and the AdamW moments."""
    from neuronx_distributed_tpu_torch.config import training_config
    from neuronx_distributed_tpu_torch.models import LlamaForCausalLM
    from neuronx_distributed_tpu_torch.models import common
    from neuronx_distributed_tpu_torch.optimizer.zero1 import state_by_param
    from neuronx_distributed_tpu_torch.parallel import fsdp, mappings, mesh
    from neuronx_distributed_tpu_torch.trainer import (
        initialize_parallel_model,
        initialize_parallel_optimizer,
        make_train_step,
    )

    config = training_config(**case["mesh"], learning_rate=case["lr"],
                             compute_dtype="float32", seed=0)
    cfg = _llama(case)
    model = initialize_parallel_model(
        config, lambda d: LlamaForCausalLM(cfg, device=d), device="cpu")
    module = model.module
    _load_llama(module, cfg, case["params"])
    loss_fn = getattr(common, case["loss"])
    grads = None
    if case.get("grads", True):
        grads = _first_grads(module, loss_fn, case["batches"][0])
    opt = initialize_parallel_optimizer(config, model)
    step = make_train_step(config, model, opt, loss_fn)
    losses, norms, counts = [], [], []
    for b in case["batches"]:
        mappings.reset_counts()
        m = step(b)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        counts.append(dict(mappings.COUNTS))
    names = {p: n for n, p in module.named_parameters()}
    moments = {n: {k: _np(v) for k, v in st.items()}
               for n, st in state_by_param(opt.optimizer, opt.zero1,
                                           names).items()}
    stats = [{k: float(v) for k, v in blk.moe_mlp.stats.items()}
             for blk in module.model.layers()]
    res = dict(_where(), grads=grads, losses=losses, norms=norms,
               counts=counts, moments=moments, stats=stats,
               zero1=opt.zero1 is not None,
               fsdp=fsdp.fsdp_state(module) is not None,
               params={n: _np(p) for n, p in module.named_parameters()})
    mesh.destroy_model_parallel()
    return res


def swa_case(case):
    """Logits of the MoE Llama with a sliding window through the flash
    core and the dense core on the same weights (full vocab)."""
    from neuronx_distributed_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from neuronx_distributed_tpu_torch.parallel import mesh

    mesh.initialize_model_parallel(tensor_parallel_size=2,
                                   expert_parallel_size=2)
    nb, r = mesh.get_data_parallel_size(), mesh.get_data_parallel_rank()
    ids = case["ids"]
    b = ids.shape[0] // nb
    mine = torch.as_tensor(ids[r * b:(r + 1) * b])
    out = {}
    for impl in ("dense", "flash"):
        cfg = LlamaConfig.tiny(attention_impl=impl, **_f32(), **case["cfg"])
        model = LlamaForCausalLM(cfg, device="cpu")
        _load_llama(model, cfg, case["params"])
        with torch.no_grad():
            out[impl] = _np(model.gather_logits(model(mine)))
    mesh.destroy_model_parallel()
    return dict(out, rows=(r * b, (r + 1) * b))


# -- the pipelined MoE ------------------------------------------------------------


def pipeline_case(case):
    """The pipelined MoE Llama from JAX's pipelined tree at ``case["mesh"]``:
    the schedule's loss sum, token count and complete gradient sums, and
    GPipe's differentiable loss and gradients (its autodiff)."""
    from neuronx_distributed_tpu_torch.convert import pipelined_params_from_jax
    from neuronx_distributed_tpu_torch.models.llama import build_pipelined_llama
    from neuronx_distributed_tpu_torch.parallel import mesh

    mesh.initialize_model_parallel(**case["mesh"])
    cfg = _llama(case)
    pm = build_pipelined_llama(cfg, num_microbatches=case["M"], seed=3,
                               schedule=case["schedule"],
                               num_chunks=case.get("V", 1),
                               pipeline_cuts=case.get("cuts"), device="cpu")
    stage = pm.module
    tp = stage.parts["tp"]
    stage.load_state_dict(pipelined_params_from_jax(
        case["params"], case["rows"], stage.layer_ids,
        embed=stage.has_embed, head=stage.has_head, tp=tp.size, rank=tp.rank,
        ep=mesh.get_expert_parallel_size(),
        ep_rank=mesh.get_expert_parallel_rank()))
    ids, labels = (torch.as_tensor(case[k]) for k in ("ids", "labels"))
    loss_sum, tok = pm.loss_and_grad_fn(ids, labels)
    named = list(stage.named_parameters())
    out = dict(_where(), loss=loss_sum.item(), tok=tok.item(),
               layers=stage.chunks, rows=pm.layer_rows,
               grads=_complete(stage.parameters(), named),
               local_experts={n: p.shape[0] for n, p in named
                              if n.endswith("moe_mlp.gate_up")})
    stage.zero_grad(set_to_none=True)
    ls, _ = pm.loss_fn(ids, labels)
    ls.backward()
    out["oracle_loss"] = ls.item()
    out["oracle_grads"] = _complete(stage.parameters(), named)
    mesh.destroy_model_parallel()
    return out


def pipeline_train_case(case):
    """``len(case["batches"])`` steps of the pipelined MoE through the
    trainer at ``case["mesh"]`` (the stage from the seed): losses and grad
    norms, and the experts each rank holds."""
    from neuronx_distributed_tpu_torch.config import training_config
    from neuronx_distributed_tpu_torch.convert import pipelined_params_from_jax
    from neuronx_distributed_tpu_torch.models import LlamaForCausalLM
    from neuronx_distributed_tpu_torch.parallel import mesh
    from neuronx_distributed_tpu_torch.trainer import (
        initialize_parallel_model,
        initialize_parallel_optimizer,
        make_train_step,
    )

    config = training_config(**case["mesh"], learning_rate=1e-3,
                             compute_dtype="float32", seed=0,
                             num_microbatches=case["M"])
    cfg = _llama(case)
    model = initialize_parallel_model(
        config, lambda d: LlamaForCausalLM(cfg, device=d), device="cpu")
    stage = model.module
    tp = stage.parts["tp"]
    stage.load_state_dict(pipelined_params_from_jax(
        case["params"], case["rows"], stage.layer_ids,
        embed=stage.has_embed, head=stage.has_head, tp=tp.size, rank=tp.rank,
        ep=mesh.get_expert_parallel_size(),
        ep_rank=mesh.get_expert_parallel_rank()))
    opt = initialize_parallel_optimizer(config, model)
    step = make_train_step(config, model, opt)
    losses, norms = [], []
    for b in case["batches"]:
        m = step(b)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    out = dict(_where(), losses=losses, norms=norms,
               local_experts=sorted({p.shape[0] for n, p in
                                     stage.named_parameters()
                                     if n.endswith("moe_mlp.gate_up")}))
    mesh.destroy_model_parallel()
    return out


def world4_cases(inp):
    """The 4-rank world: the layer at tp = 2 x ep = 2, the MoE Llama's
    train step at tp = 2 x ep = 2 and at dp = 2 x ep = 2, SWA + MoE, and
    the pipelined MoE (tp = 2 x pp = 2 schedules, pp = 2 x ep = 2)."""
    from neuronx_distributed_tpu_torch.utils.distributed import (
        initialize_distributed,
    )

    initialize_distributed(device="cpu", timeout_s=GROUP_TIMEOUT_S)
    out = {"layer": layer_cases(inp["layer"])}
    for name, case in inp["train"].items():
        out[name] = train_case(case)
    out["swa"] = swa_case(inp["swa"])
    out["pipeline"] = {name: pipeline_case(case)
                       for name, case in inp["pipeline"].items()}
    return out


def world8_cases(inp):
    """The 8-rank world: tp = 2 x pp = 2 x ep = 2 training (the Mixtral
    ratio, and expert-choice routing)."""
    from neuronx_distributed_tpu_torch.utils.distributed import (
        initialize_distributed,
    )

    initialize_distributed(device="cpu", timeout_s=GROUP_TIMEOUT_S)
    return {name: pipeline_train_case(case) for name, case in inp.items()}
