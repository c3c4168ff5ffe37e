"""PyTorch port: pipeline parallelism (ROADMAP A15) against the JAX
package.

In process, against JAX's pure functions: ``partition.py`` and
``scheduler.py`` (copied whole) give the same spans, layouts, task lists,
slot tables, bubble figures, gauges and errors over grids of (layers,
stages, cuts, M, P, V), and ``microbatch`` the same shapes and errors.
The port's own per-rank programs (:func:`..pipeline.engine.train_program`
and ``forward_program``) are simulated with sends that never block and
receives that wait for their send: every schedule finishes, every
transfer is received once, and 1F1B keeps ``num_in_flight()`` graphs.

One spawned 2-rank gloo world (``torch_pipeline_workers.pp2_cases``) runs
the tiny Llama at pp = 2 from JAX's pipelined trees (the same fp32
weights through ``convert.pipelined_params_from_jax``) against JAX's
pipelined model at pp = 2 on two virtual CPU devices: 1F1B, GPipe and the
interleaved schedule (V = 2), ``pipeline_cuts=(1,)``, 3 layers (JAX pads
its stack), packed extras, ``sliding_window=6``, ``forward_fn``'s logits,
GPipe's differentiable loss as the oracle, the eval step, 4 AdamW steps
through ``make_train_step``, and ``fit`` with checkpoints (resumed at pp =
2 bit for bit, loaded at pp = 1, and a pp = 1 checkpoint loaded at pp =
2).  Losses agree within ``rel 1e-5`` and the gradients of the mean loss
(each sum over the token count, as the train step takes them) within
``rtol 1e-4, atol 1e-5`` (JAX's own, ``tests/test_models.py:254-265``);
training losses within ``rtol 2e-5, atol 2e-6`` and parameters within a
tenth of the learning rate (``tests/test_torch_tp_train.py``).  JAX's
GPipe is its ``value_and_grad`` of the fill-drain loss, which is what its
``schedule="gpipe"`` model runs.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neuronx_distributed_tpu as nxd
from neuronx_distributed_tpu.data.packing import (
    pack_documents,
    segment_positions,
)
from neuronx_distributed_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig,
    build_pipelined_llama as jax_build_llama,
)
from neuronx_distributed_tpu.obs import MetricRegistry as JaxRegistry
from neuronx_distributed_tpu.parallel.mesh import (
    destroy_model_parallel,
    initialize_model_parallel,
)
from neuronx_distributed_tpu.pipeline import engine as jax_engine
from neuronx_distributed_tpu.pipeline import partition as jax_partition
from neuronx_distributed_tpu.pipeline import scheduler as jax_scheduler
from neuronx_distributed_tpu.trainer import (
    initialize_parallel_optimizer as jax_init_opt,
    make_eval_step as jax_make_eval_step,
    make_train_step as jax_make_train_step,
)
from neuronx_distributed_tpu_torch.config import training_config
from neuronx_distributed_tpu_torch.convert import (
    pipelined_grads_from_jax,
    pipelined_params_from_jax,
)
from neuronx_distributed_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from neuronx_distributed_tpu_torch.obs import MetricRegistry
from neuronx_distributed_tpu_torch.pipeline import engine, partition, scheduler
from neuronx_distributed_tpu_torch.trainer import (
    initialize_parallel_model,
    initialize_parallel_optimizer,
    load_checkpoint,
    make_train_step,
    model_shards,
    optimizer_shards,
    restore_model,
    restore_optimizer,
    save_checkpoint,
)
from neuronx_distributed_tpu_torch.utils.distributed import spawn
import torch_pipeline_workers as workers

LOSS_REL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
STEP_TOL = dict(rtol=2e-5, atol=2e-6)
M, MB, S = 4, 2, 16


def _same(port_fn, jax_fn, *args):
    """Both functions give the same value, or raise the same error."""
    try:
        want = jax_fn(*args)
    except Exception as e:  # noqa: BLE001 - the error is the value
        with pytest.raises(type(e)) as got:
            port_fn(*args)
        assert str(got.value) == str(e)
        return None
    got = port_fn(*args)
    if dataclasses.is_dataclass(want):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    else:
        assert got == want
    return got


# -- partition ----------------------------------------------------------------


@pytest.mark.parametrize("L,P", [(4, 2), (3, 2), (5, 2), (8, 4), (7, 4),
                                 (1, 1), (2, 4), (6, 1), (4, 0)])
def test_partition_matches_jax(L, P):
    for name in ("partition_uniform", "layers_per_stage",
                 "padded_layer_layout"):
        _same(getattr(partition, name), getattr(jax_partition, name), L, P)
    if P >= 1 and L >= P:
        spans = jax_partition.partition_uniform(L, P)
        _same(partition.layout_from_spans, jax_partition.layout_from_spans,
              spans, P)
        _same(partition.layout_from_spans, jax_partition.layout_from_spans,
              spans, P + 1)


@pytest.mark.parametrize("cuts,L", [((1,), 4), ((2,), 4), ((3,), 4),
                                    ((1, 3), 4), ((3, 1), 4), ((0,), 4),
                                    ((4,), 4), ((1, 1), 4), ((2, 5), 8)])
def test_spans_from_cuts_match_jax(cuts, L):
    spans = _same(partition.spans_from_cuts, jax_partition.spans_from_cuts,
                  cuts, L)
    if spans is not None:
        _same(partition.layout_from_spans, jax_partition.layout_from_spans,
              spans, len(spans))


@pytest.mark.parametrize("L,P,V", [(4, 2, 2), (8, 2, 2), (8, 4, 2),
                                   (6, 2, 3), (5, 2, 2), (12, 2, 3)])
def test_interleaved_layout_matches_jax(L, P, V):
    spans = jax_partition.partition_uniform(L, P * V)
    _same(partition.interleaved_layout_from_spans,
          jax_partition.interleaved_layout_from_spans, spans, P, V)
    _same(partition.interleaved_layout_from_spans,
          jax_partition.interleaved_layout_from_spans, spans, P, V + 1)


# -- schedules ----------------------------------------------------------------


def _tasks(sched):
    return [(type(t).__name__, getattr(t, "microbatch", None))
            for t in sched.tasks()]


@pytest.mark.parametrize("Mb,P", [(1, 1), (1, 2), (2, 2), (4, 2), (3, 4),
                                  (8, 4), (5, 3), (16, 4)])
def test_schedules_match_jax(Mb, P):
    for s in range(P):
        for cls in ("TrainSchedule", "InferenceSchedule"):
            port = getattr(scheduler, cls)(Mb, P, s)
            want = getattr(jax_scheduler, cls)(Mb, P, s)
            assert _tasks(port) == _tasks(want), (cls, s)
            assert port.num_in_flight() == want.num_in_flight()
            assert (port.is_first_stage, port.is_last_stage) == \
                (want.is_first_stage, want.is_last_stage)
        assert scheduler.TrainSchedule(Mb, P, s).num_warmup == \
            jax_scheduler.TrainSchedule(Mb, P, s).num_warmup
    for kind in ("eager", "sync_1f1b"):
        _same(scheduler.bubble_fraction, jax_scheduler.bubble_fraction, Mb,
              P, kind)
    for fn in ("build_slot_tables", "build_sync_slot_tables"):
        _same(getattr(scheduler, fn), getattr(jax_scheduler, fn), Mb, P)


@pytest.mark.parametrize("Mb,P,V", [(4, 2, 2), (2, 2, 2), (3, 2, 2),
                                    (8, 4, 2), (5, 4, 3), (4, 2, 1),
                                    (1, 2, 2)])
def test_interleaved_tables_match_jax(Mb, P, V):
    for fn in ("build_interleaved_sync_tables",
               "build_interleaved_fwd_tables"):
        _same(getattr(scheduler, fn), getattr(jax_scheduler, fn), Mb, P, V)
    _same(scheduler.bubble_fraction, jax_scheduler.bubble_fraction, Mb, P,
          "sync_interleaved", V)


@pytest.mark.parametrize("call", [
    ("PipeSchedule", 1, 2, 2), ("PipeSchedule", 1, 2, -1),
    ("TrainSchedule", 0, 2, 0), ("InferenceSchedule", 0, 1, 0),
    ("build_interleaved_sync_tables", 4, 2, 0),
    ("build_interleaved_sync_tables", 0, 2, 2),
    ("build_interleaved_fwd_tables", 0, 2, 2),
    ("bubble_fraction", 4, 2, "bogus")])
def test_schedule_errors_match_jax(call):
    name, *args = call
    _same(getattr(scheduler, name), getattr(jax_scheduler, name), *args)


@pytest.mark.parametrize("L,P,H,V,I", [(32, 4, 4096, 32000, 11008),
                                       (80, 4, 8192, 32000, 28672),
                                       (4, 2, 64, 256, None)])
def test_head_overhead_matches_jax(L, P, H, V, I):
    _same(scheduler.sync_1f1b_head_overhead,
          jax_scheduler.sync_1f1b_head_overhead, L, P, H, V, I)


@pytest.mark.parametrize("kind,V", [("eager", 1), ("sync_1f1b", 1),
                                    ("sync_interleaved", 2)])
def test_schedule_metrics_match_jax(kind, V):
    """``export_schedule_metrics`` sets the same gauges in the port's
    registry as JAX's in its own."""
    reg, jreg = MetricRegistry(), JaxRegistry()
    vals = scheduler.export_schedule_metrics(reg, 8, 4, kind, V)
    assert vals == jax_scheduler.export_schedule_metrics(jreg, 8, 4, kind, V)
    for name, v in vals.items():
        assert reg.gauge(name).value == v


@pytest.mark.parametrize("shape,n", [((8, 16), 4), ((6,), 3), ((4, 2, 3), 4),
                                     ((8, 16), 3), ((5,), 2)])
def test_microbatch_matches_jax(shape, n):
    x = np.arange(int(np.prod(shape))).reshape(shape)
    got = _same(lambda a, k: engine.microbatch(torch.as_tensor(a), k).numpy(
    ).tolist(), lambda a, k: np.asarray(jax_engine.microbatch(
        jnp.asarray(a), k)).tolist(), x, n)
    if got is not None:
        assert np.asarray(got).shape == (n, shape[0] // n, *shape[1:])


def test_microbatch_dp_error_matches_jax():
    """A microbatch size the data-parallel degree does not divide: JAX's
    message (its dp from a mesh of 2 devices, the port's given)."""
    destroy_model_parallel()
    initialize_model_parallel(tensor_parallel_size=1,
                              devices=jax.devices()[:2])
    try:
        x = np.zeros((6, 4))
        with pytest.raises(ValueError) as want:
            jax_engine.microbatch(jnp.asarray(x), 2, nxd.get_mesh())
        with pytest.raises(ValueError) as got:
            engine.microbatch(torch.as_tensor(x), 2, dp=2)
        assert str(got.value) == str(want.value)
    finally:
        destroy_model_parallel()


# -- the port's per-rank programs ---------------------------------------------


def _simulate(programs, Mb, P, V):
    """Run every rank's ticks with sends that never block and receives
    that wait for their send; returns each rank's peak of forwards whose
    backward has not run.  Fails on a deadlock, a computation before its
    input's receive was posted, or a transfer not received exactly
    once."""
    S = P * V
    sent, taken = {}, set()
    posted = [set() for _ in range(P)]
    pos = [[0, 0] for _ in range(P)]   # (tick, computation) cursor
    live, peak = [0] * P, [0] * P

    def tag(d, vs, m):
        return (d, vs, m)

    def needs(r, kind, v, m):
        vs = v * P + r
        if kind == "F" and vs > 0:
            return ("F", v, m), tag("F", vs, m), (r - 1) % P
        if kind == "B" and vs < S - 1:
            return ("B", v, m), tag("B", vs, m), (r + 1) % P
        return None

    done = False
    while not done:
        moved, done = False, True
        for r in range(P):
            ticks = programs[r]
            while pos[r][0] < len(ticks):
                done = False
                comp, recvs, sends = ticks[pos[r][0]]
                if pos[r][1] < len(comp):
                    kind, v, m = comp[pos[r][1]]
                    need = needs(r, kind, v, m)
                    if need is not None:
                        key, t, src = need
                        assert key in posted[r], (r, kind, v, m)
                        if (src, r, t) not in sent:
                            break
                        assert (src, r, t) not in taken
                        taken.add((src, r, t))
                    live[r] += 1 if kind == "F" else -1
                    peak[r] = max(peak[r], live[r])
                    pos[r][1] += 1
                    moved = True
                    continue
                for d, v, m in recvs:
                    posted[r].add((d, v, m))
                for d, v, m in sends:
                    vs = v * P + r
                    dst = (r + 1) % P if d == "F" else (r - 1) % P
                    key = (r, dst, tag(d, vs + 1 if d == "F" else vs - 1, m))
                    assert key not in sent
                    sent[key] = True
                pos[r] = [pos[r][0] + 1, 0]
                moved = True
        assert done or moved, f"deadlock at {pos}"
    assert taken == set(sent), set(sent) - taken
    return peak


@pytest.mark.parametrize("schedule,Mb,P,V", [
    ("1f1b", 1, 2, 1), ("1f1b", 4, 2, 1), ("1f1b", 8, 4, 1),
    ("1f1b", 3, 4, 1), ("1f1b", 5, 3, 1), ("1f1b", 4, 1, 1),
    ("interleaved", 4, 2, 2), ("interleaved", 3, 2, 2),
    ("interleaved", 8, 4, 2), ("interleaved", 5, 4, 3),
    ("interleaved", 1, 2, 2)])
def test_programs_finish_and_bound_the_stash(schedule, Mb, P, V):
    train = [engine.train_program(schedule, Mb, P, r, V) for r in range(P)]
    peak = _simulate(train, Mb, P, V)
    if schedule == "1f1b":
        assert peak == [scheduler.TrainSchedule(Mb, P, r).num_in_flight()
                        for r in range(P)]
    fwd = [engine.forward_program(schedule, Mb, P, r, V) for r in range(P)]
    assert _simulate(fwd, Mb, P, V) == [Mb * V] * P


@pytest.mark.parametrize("L,P,schedule,cuts,V", [
    (4, 2, "1f1b", None, 1), (3, 2, "1f1b", None, 1), (4, 2, "1f1b", (1,), 1),
    (8, 4, "gpipe", (1, 2, 6), 1), (4, 2, "interleaved", None, 2),
    (8, 2, "interleaved", (1, 2, 5), 2), (5, 2, "interleaved", None, 2)])
def test_stage_layout_holds_every_layer_once(L, P, schedule, cuts, V):
    chunks, rows = engine.stage_layout(L, P, schedule, cuts, V)
    flat = sorted(i for rank in chunks for c in rank for i in c)
    assert flat == list(range(L))
    assert len(rows) == L and len(set(rows)) == L
    # a chunk is a contiguous span, and chunk v of rank r runs virtual
    # stage v * P + r: the spans in virtual-stage order are the layers
    order = [i for v in range(V) for r in range(P) for i in chunks[r][v]]
    assert order == list(range(L))


def test_schedule_functions_at_one_stage():
    """At pp = 1 (no world) a stage holds the whole model with the pp = 1
    model's weights from the seed: GPipe's differentiable loss, the 1F1B
    schedule over the same stage and the forward path give the model's
    loss, gradients and logits; the interleaved functions need a chunked
    stage; the train step refuses ``grad_accum_steps``; a packed model
    names its extras; an unknown schedule raises with JAX's message."""
    cfg = LlamaConfig.tiny(num_layers=3, num_kv_heads=2, dtype=torch.float32,
                           param_dtype=torch.float32, max_seq_len=S)
    pm = engine_build(cfg, "gpipe")
    full = LlamaForCausalLM(cfg, device="cpu").init_random(4)
    assert pm.module.layer_ids == (0, 1, 2) and pm.layer_rows == (0, 1, 2)
    b = _batch(2)
    ids, labels = torch.as_tensor(b["ids"]), torch.as_tensor(b["labels"])
    from neuronx_distributed_tpu_torch.models.common import causal_lm_loss_sum

    want, want_tok = causal_lm_loss_sum(full, {"ids": ids, "labels": labels})
    want.backward()
    ref = dict(full.named_parameters())
    loss_sum, tok = engine.make_pipelined_loss_fn(pm)(ids, labels)
    loss_sum.backward()
    assert tok.item() == want_tok.item()
    for fn in (None, engine.make_1f1b_loss_and_grad_fn(pm)):
        if fn is not None:
            pm.module.zero_grad(set_to_none=True)
            loss_sum, _ = fn(ids, labels)
        assert loss_sum.item() == pytest.approx(want.item(), rel=LOSS_REL)
        check_grads({n: p.grad.numpy() for n, p in
                     pm.module.named_parameters()},
                    {n: p.grad.numpy() for n, p in ref.items()}, tok.item())
    with torch.no_grad():
        np.testing.assert_allclose(
            engine.make_pipelined_forward_fn(pm)(ids).numpy(),
            full(ids).numpy(), rtol=1e-5, atol=1e-6)
    for make in (engine.make_interleaved_1f1b_loss_and_grad_fn,
                 engine.make_interleaved_fwd_fn):
        with pytest.raises(ValueError, match="interleaved"):
            make(pm)
    config = training_config(compute_dtype="float32")
    opt = initialize_parallel_optimizer(config, pm)
    with pytest.raises(ValueError, match="grad_accum_steps"):
        make_train_step(config, pm, opt, grad_accum_steps=2)
    packed = engine_build(cfg, "1f1b", packed=True)
    assert packed.extra_keys == ("positions", "segment_ids")
    with pytest.raises(TypeError, match="positions, segment_ids"):
        packed.loss_and_grad_fn(ids, labels)
    with pytest.raises(ValueError, match="unknown pipeline schedule "
                       "'inference' \\(1f1b \\| gpipe \\| interleaved\\)"):
        engine_build(cfg, "inference")


def engine_build(cfg, schedule, packed=False):
    from neuronx_distributed_tpu_torch.models.llama import (
        build_pipelined_llama,
    )

    return build_pipelined_llama(cfg, M, seed=4, schedule=schedule,
                                 packed=packed, device="cpu")


# -- the 2-rank world against JAX's pipelined model ----------------------------


def _packed_batch():
    rng = np.random.RandomState(0)
    docs = [rng.randint(1, 250, size=rng.randint(3, 12)) for _ in range(30)]
    ids, labels, segs = pack_documents(docs, seq_len=S, eos_id=255)
    n = M * MB
    return {"ids": ids[:n].astype(np.int32), "labels": labels[:n],
            "positions": segment_positions(segs[:n]).astype(np.int32),
            "segment_ids": segs[:n].astype(np.int32)}


def _batch(seed):
    ids = np.random.RandomState(seed).randint(0, 256, (M * MB, S)).astype(
        np.int32)
    labels = np.roll(ids, -1, axis=1)
    labels[:, -1] = -100
    return {"ids": ids, "labels": labels}


# name: (port case, JAX build overrides); every case at M = 4 microbatches
# of 2 on the tiny Llama with 2 kv heads
CASES = {
    "1f1b": dict(schedule="1f1b", forward=True, oracle=True),
    "gpipe": dict(schedule="gpipe"),
    "interleaved": dict(schedule="interleaved", V=2, forward=True,
                        oracle=True),
    "cuts": dict(schedule="1f1b", cuts=(1,)),
    "pad3": dict(schedule="1f1b", layers=3),
    "packed": dict(schedule="1f1b", packed=True),
    "window": dict(schedule="interleaved", V=2, window=6),
}


def _jax_model(case, seed=3):
    cfg = JaxLlamaConfig.tiny(
        num_layers=case.get("layers", 4), num_kv_heads=2,
        sequence_parallel=False, remat="none", dtype=jnp.float32,
        param_dtype=jnp.float32, max_seq_len=S,
        sliding_window=case.get("window"))
    return jax_build_llama(cfg, num_microbatches=M, seed=seed,
                           schedule=case["schedule"],
                           num_chunks=case.get("V", 1),
                           pipeline_cuts=case.get("cuts"),
                           packed=case.get("packed", False))


def _port_case(case, pm, batch):
    return {"schedule": case["schedule"], "V": case.get("V", 1), "M": M,
            "cuts": case.get("cuts"), "packed": case.get("packed", False),
            "forward": case.get("forward", False),
            "oracle": case.get("oracle", False),
            "cfg": dict(num_layers=case.get("layers", 4), num_kv_heads=2,
                        sliding_window=case.get("window")),
            "params": jax.tree.map(np.asarray, pm.params),
            "rows": tuple(pm.layer_rows), "batch": batch}


def _jax_refs(case, pm, batch):
    keys = ("ids", "labels", *pm.extra_keys)
    args = [jnp.asarray(batch[k]) for k in keys]
    fn = pm.loss_and_grad_fn
    if case["schedule"] == "gpipe":
        fn = jax.value_and_grad(pm.loss_fn, has_aux=True)
    (ls, tok), grads = jax.jit(fn)(pm.params, *args)
    out = {"loss": float(ls), "tok": float(tok),
           "grads": jax.tree.map(np.asarray, grads)}
    if case.get("forward"):
        out["logits"] = np.asarray(jax.jit(pm.forward_fn)(
            pm.params, args[0], *args[2:]))
    return out


def _jax_train(pm, batches):
    config = nxd.training_config(pipeline_parallel_size=2,
                                 num_microbatches=M, learning_rate=1e-3,
                                 compute_dtype="float32", seed=0)
    params0 = jax.tree.map(np.asarray, pm.params)
    eval_loss = float(jax_make_eval_step(config, pm)(
        pm.params, {k: jnp.asarray(v) for k, v in batches[0].items()})[
            "loss"])
    opt = jax_init_opt(config, pm)
    step = jax_make_train_step(config, pm, opt)
    params, state, metrics = pm.params, opt.state, []
    for b in batches:
        params, state, m = step(params, state,
                                {k: jnp.asarray(v) for k, v in b.items()},
                                None)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return {"params0": params0, "metrics": np.array(metrics),
            "eval_loss": eval_loss,
            "params": jax.tree.map(np.asarray, params)}


def _pp1_checkpoint(path, batches):
    """A pp = 1 checkpoint written in this process (one AdamW step from
    seed 7), and what it holds."""
    cfg = LlamaConfig.tiny(num_layers=4, num_kv_heads=2, dtype=torch.float32,
                           param_dtype=torch.float32, max_seq_len=S)
    config = training_config(compute_dtype="float32", learning_rate=1e-3,
                             seed=7)
    model = initialize_parallel_model(
        config, lambda d: LlamaForCausalLM(cfg, device=d), device="cpu")
    opt = initialize_parallel_optimizer(config, model)
    from neuronx_distributed_tpu_torch.models.common import causal_lm_loss_sum

    make_train_step(config, model, opt, causal_lm_loss_sum)(batches[0])
    save_checkpoint(path, "step_1", model_shards(model),
                    optimizer_shards(model, opt), user_content={"step": 1})
    names = {p: n for n, p in model.module.named_parameters()}
    return {"params": {n: p.detach().numpy().copy()
                       for n, p in model.module.named_parameters()},
            "exp_avg": {names[p]: s["exp_avg"].numpy().copy()
                        for p, s in opt.optimizer.state.items()}}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    destroy_model_parallel()
    initialize_model_parallel(tensor_parallel_size=1,
                              pipeline_parallel_size=2,
                              devices=jax.devices()[:2])
    tmp = tmp_path_factory.mktemp("pp2")
    models, inp = {}, {"cases": {}}
    for name, case in CASES.items():
        batch = _packed_batch() if case.get("packed") else _batch(1)
        # GPipe runs on the 1F1B build's weights and loss
        pm = models["1f1b"][0] if name == "gpipe" else _jax_model(case)
        models[name] = (pm, batch)
        inp["cases"][name] = _port_case(case, *models[name])
    train_pm = models["1f1b"][0]
    train_batches = [_batch(10 + i) for i in range(4)]
    inp["train"] = dict(_port_case({"schedule": "1f1b"}, train_pm,
                                   train_batches[0]),
                        batches=train_batches)
    fit_batches = [_batch(20 + i) for i in range(6)]
    pp1 = _pp1_checkpoint(str(tmp / "pp1"), fit_batches)
    inp["fit"] = {"M": M, "batches": fit_batches,
                  "cfg": dict(num_layers=4, num_kv_heads=2),
                  "dir_whole": str(tmp / "whole"),
                  "dir_resume": str(tmp / "resume"), "pp1": str(tmp / "pp1")}
    # the port's world runs while JAX computes its side
    ranks = {}

    def run():
        ranks["out"] = spawn(workers.pp2_cases, 2, (inp,), timeout_s=240)

    th = threading.Thread(target=run)
    th.start()
    try:
        want = {name: _jax_refs(CASES[name], *models[name])
                for name in CASES}
        want["train"] = _jax_train(train_pm, train_batches)
        want["rows"] = {name: tuple(pm.layer_rows)
                        for name, (pm, _) in models.items()}
    finally:
        th.join()
        destroy_model_parallel()
    if "out" not in ranks:
        pytest.fail("the pp = 2 world did not finish")
    return inp, want, ranks["out"], pp1


def _stage_grads(want_grads, rows, r, family="llama"):
    return pipelined_grads_from_jax(
        want_grads, rows, [i for c in r["layers"] for i in c],
        embed=r["embed"], head=r["head"], family=family, tp=r["tp"][0],
        rank=r["tp"][1], kvr=r["tp"][2])


def check_grads(got, want, tok, what=""):
    """The gradients of the mean loss: both sums over the token count."""
    assert set(got) == set(want), what
    for n in got:
        np.testing.assert_allclose(got[n] / tok, want[n] / tok,
                                   err_msg=f"{what} {n}", **GRAD_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_schedule_matches_jax(world, name):
    """Each case's loss, token count and every gradient on both ranks
    equal JAX's pipelined model's; the port places the layers where JAX's
    ``layer_rows`` put them; the embedding on rank 0, the head on rank
    1."""
    inp, want, ranks, _ = world
    w = want[name]
    assert inp["cases"][name]["rows"] == want["rows"][name]
    for rank in ranks:
        r = rank[name]
        assert r["rows"] == want["rows"][name]
        assert r["embed"] == (r["pp"][1] == 0)
        assert r["head"] == (r["pp"][1] == 1)
        assert r["tok"] == w["tok"]
        assert r["loss"] == pytest.approx(w["loss"], rel=LOSS_REL)
        check_grads(r["grads"], _stage_grads(w["grads"], r["rows"], r),
                    w["tok"], name)
    assert ranks[0][name]["loss"] == ranks[1][name]["loss"]


@pytest.mark.parametrize("name", ["1f1b", "interleaved"])
def test_gpipe_oracle_and_forward_match_jax(world, name):
    """GPipe's differentiable loss (``loss_fn``, backward on every rank)
    gives JAX's loss and gradients, and ``forward_fn`` JAX's logits on
    every rank (the last stage's, broadcast once)."""
    _, want, ranks, _ = world
    w = want[name]
    for r in ranks:
        o = r[name]
        assert o["oracle_loss"] == pytest.approx(w["loss"], rel=LOSS_REL)
        check_grads(o["oracle_grads"], _stage_grads(w["grads"], o["rows"],
                                                    o), w["tok"], name)
        np.testing.assert_allclose(o["logits"], w["logits"], rtol=1e-5,
                                   atol=1e-5)


def test_stash_bound(world):
    """1F1B keeps at most ``TrainSchedule.num_in_flight()`` microbatch
    graphs alive on each rank (P - r), GPipe all M; each rank's transfers
    match its role."""
    _, _, ranks, _ = world
    for r in ranks:
        rank = r["1f1b"]["pp"][1]
        assert r["1f1b"]["stats"]["peak_in_flight"] == \
            scheduler.TrainSchedule(M, 2, rank).num_in_flight() == 2 - rank
        assert r["gpipe"]["stats"]["peak_in_flight"] == M
        c = r["1f1b"]["counts"]
        if rank == 0:
            assert (c["pp_send_forward"], c["pp_recv_backward"]) == (M, M)
            assert "pp_recv_forward" not in c
        else:
            assert (c["pp_recv_forward"], c["pp_send_backward"]) == (M, M)
            assert "pp_send_forward" not in c


def test_train_steps_match_jax(world):
    """4 AdamW steps through ``make_train_step`` at pp = 2: losses and
    grad norms equal JAX's pipelined train step's, the eval step its eval
    loss, and each stage's parameters JAX's within a tenth of the
    learning rate."""
    inp, want, ranks, _ = world
    w = want["train"]
    for r in ranks:
        t = r["train"]
        got = np.stack([t["losses"], t["norms"]], axis=1)
        np.testing.assert_allclose(got, w["metrics"], **STEP_TOL)
        assert t["eval_loss"] == pytest.approx(w["eval_loss"], rel=LOSS_REL)
        cut = {k: v.numpy() for k, v in pipelined_params_from_jax(
            w["params"], t["rows"], [i for c in t["layers"] for i in c],
            embed=t["embed"], head=t["head"]).items()}
        assert set(cut) == set(t["params"])
        for n, p in t["params"].items():
            np.testing.assert_allclose(p, cut[n], rtol=0, atol=1e-4,
                                       err_msg=n)
    assert w["metrics"][-1, 0] < w["metrics"][0, 0]


def test_fit_checkpoints_resume_and_reshard(world):
    """``fit`` at pp = 2: a run stopped at step 3 and resumed gives the
    continuous run's losses and parameters bit for bit; the continuous
    run's checkpoint loads at pp = 1 (each parameter the stage's that held
    it, bit for bit), and a pp = 1 checkpoint loads into the stages;
    ``fit(obs=)`` sets the eager schedule's bubble gauges."""
    inp, _, ranks, pp1 = world
    fit = [r["fit"] for r in ranks]
    half = len(inp["fit"]["batches"]) // 2
    joined = {}
    for f in fit:
        # fit(obs=) publishes the schedule the port runs: the eager bubble
        assert f["gauges"] == {
            "pipeline/num_microbatches": M, "pipeline/num_stages": 2.0,
            "pipeline/num_chunks": 1.0,
            "pipeline/bubble_fraction": scheduler.bubble_fraction(
                M, 2, "eager")}
        assert f["resumed"]["start"] == half
        assert f["first"]["losses"] == f["whole"]["losses"][:half]
        assert f["resumed"]["losses"] == f["whole"]["losses"][half:]
        for n, p in f["whole"]["params"].items():
            assert np.array_equal(p, f["resumed"]["params"][n]), n
            joined[n] = p
        for n, p in f["from_pp1"]["params"].items():
            assert np.array_equal(p, pp1["params"][n]), n
        for n, m in f["from_pp1"]["exp_avg"].items():
            assert np.array_equal(m, pp1["exp_avg"][n]), n
        assert f["from_pp1"]["count"] == 1
        assert f["from_pp1"]["user"] == {"step": 1}
    assert fit[0]["whole"]["losses"] == fit[1]["whole"]["losses"]
    cfg = LlamaConfig.tiny(num_layers=4, num_kv_heads=2, dtype=torch.float32,
                           param_dtype=torch.float32, max_seq_len=S)
    config = training_config(compute_dtype="float32", learning_rate=1e-3)
    model = initialize_parallel_model(
        config, lambda d: LlamaForCausalLM(cfg, device=d), device="cpu")
    opt = initialize_parallel_optimizer(config, model)
    mstate, ostate, _, user = load_checkpoint(
        inp["fit"]["dir_whole"], model_template=model_shards(model),
        optimizer_template=optimizer_shards(model, opt))
    restore_model(model, mstate, opt)
    restore_optimizer(model, opt, ostate)
    assert set(joined) == {n for n, _ in model.module.named_parameters()}
    for n, p in model.module.named_parameters():
        assert np.array_equal(p.detach().numpy(), joined[n]), n
    assert opt.update_count == len(inp["fit"]["batches"])
    assert user["step"] == len(inp["fit"]["batches"])


def test_pipeline_needs_a_pipelined_family(world):
    """At pp = 2 a model without ``build_pipelined`` (Gemma) is refused
    with JAX's reason."""
    _, _, ranks, _ = world
    for r in ranks:
        assert "has no build_pipelined()" in r["refused"]
        assert r["refused"].startswith("pipeline_parallel_size=2 but "
                                       "GemmaForCausalLM")
