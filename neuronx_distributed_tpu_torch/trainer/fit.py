"""``fit()``: the training loop (counterpart of
``neuronx_distributed_tpu/trainer/fit.py``).

One function owns the loop: train and eval cadence, checkpoint cadence
with rotation and a final checkpoint, resume, scalar and throughput
logging, callbacks, checkpoint on SIGTERM/SIGINT, the anomaly policy,
the device-prefetch pipeline, deferred metrics and the telemetry hub.

- **The data source is step-indexed.**  ``data(step) -> batch`` makes an
  exact resume free: restoring ``step`` from the checkpoint and going on
  IS skipping the consumed batches.  Iterators are accepted too and
  fast-forwarded ``start_step`` times on resume.
- **One step function.**  ``make_train_step``'s step updates the model and
  the optimizer in place (JAX donates and returns new ones); the loop
  touches device data only through the metric scalars it reads.
- **The hot path is asynchronous.**  ``prefetch=N`` stages batches on the
  device ahead of the step that consumes them
  (:class:`~..data.prefetch.DevicePrefetcher`), and ``defer_metrics``
  reads step N's loss and grad norm in ONE packed device-to-host copy
  after step N+1 is dispatched.  ``transfer_guard="forbid"`` runs each
  step under ``torch.cuda.set_sync_debug_mode("error")``
  (:mod:`~..obs.transfer_audit`): a hidden host sync inside the step
  raises.  The deferred loop's losses equal the synchronous loop's.
- **The update count lives in the optimizer**, and is checkpointed with
  it, so the LR schedule continues exactly on resume.
- **A pipelined model trains the same way.**  A
  :class:`~..pipeline.engine.PipelinedModel` (``initialize_parallel_model``
  at pp > 1) runs its schedule's step and eval; each stage saves its own
  pieces under the pp = 1 model's parameter names, so a checkpoint written
  at pp = 2 resumes at pp = 2 and loads at pp = 1, and the reverse
  (:mod:`.checkpoint`'s re-shard on load).  ``transfer_guard="forbid"``
  on the card needs the stages' transfers off the host (NCCL): under gloo
  they are staged through host memory, a synchronizing copy.
"""

from __future__ import annotations

import dataclasses
import json
import signal as _signal
import threading
import time
from typing import Any, Callable, Iterable, List, Optional

import torch

from neuronx_distributed_tpu_torch.config import TrainingConfig
from neuronx_distributed_tpu_torch.models.common import seeded_generator
from neuronx_distributed_tpu_torch.obs.transfer_audit import TransferAudit
from neuronx_distributed_tpu_torch.parallel import mesh
from neuronx_distributed_tpu_torch.pipeline.engine import PipelinedModel
from neuronx_distributed_tpu_torch.pipeline.scheduler import (
    export_schedule_metrics,
)
from neuronx_distributed_tpu_torch.resilience.faults import fault_point, perturb
from neuronx_distributed_tpu_torch.trainer.checkpoint import (
    load_checkpoint,
    model_shards,
    newest_tag,
    optimizer_shards,
    restore_model,
    restore_optimizer,
    save_checkpoint,
    wait_for_checkpoint,
)
from neuronx_distributed_tpu_torch.trainer.metrics import Throughput, mfu
from neuronx_distributed_tpu_torch.trainer.trainer import (
    make_eval_step,
    make_train_step,
)
from neuronx_distributed_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


@dataclasses.dataclass
class FitResult:
    """Outcome of :func:`fit`: the trained model and optimizer (the same
    objects, updated in place) and summary numbers."""

    model: Any
    optimizer: Any
    final_loss: float
    steps_run: int
    start_step: int
    peak_seq_per_sec: float
    eval_history: list  # [(step, eval_loss)]
    policy_events: list = dataclasses.field(default_factory=list)
    # [{"action", "reason", "step", "message"}] of the AnomalyPolicy


class Callback:
    """Extension hooks for :func:`fit`; override any subset (all default
    to no-ops).  Metric dicts carry host floats for ``loss``,
    ``grad_norm`` and ``seq_per_sec``.  Setting ``self.should_stop = True``
    in any hook ends the loop after the current step; the final checkpoint
    and summary are still written."""

    should_stop: bool = False

    def on_fit_start(self, step: int, model: Any, optimizer: Any) -> None:
        """Once before the first step; ``step`` is the resume start step."""

    def on_step(self, step: int, metrics: dict) -> None:
        """After every optimizer step, with its metrics."""

    def on_params(self, step: int, model: Any, optimizer: Any) -> None:
        """After every optimizer step with the LIVE model (even when its
        metrics are deferred): the hand-off point for co-located serving
        (``WeightSwapper.swap``).  Do not mutate it."""

    def on_eval(self, step: int, metrics: dict) -> None:
        """After each eval-cadence evaluation (``eval_loss`` key)."""

    def on_checkpoint(self, step: int, path: str) -> None:
        """After each checkpoint save (cadence and final)."""

    def on_fit_end(self, result: "FitResult") -> None:
        """Once with the final :class:`FitResult`."""


class _Fetch:
    """The sanctioned metric read: a step's scalars packed into one tensor
    and copied into pinned host memory without blocking; :meth:`wait`
    waits on the copy's event (the audit lifts the guard around it)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def start(self, *scalars: torch.Tensor):
        packed = torch.stack([s.detach().float().reshape(()) for s in scalars])
        if not self.cuda:
            return packed, None
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    @staticmethod
    def wait(handle) -> List[float]:
        host, event = handle
        if event is not None:
            event.synchronize()
        return host.tolist()


def _step_generator(seed: int, step: int) -> torch.Generator:
    """The step's dropout stream (JAX folds the step into the seed key): a
    CPU generator seeded from ``(seed, step)``, the same on a resume."""
    return seeded_generator((seed * 0x9E3779B1 + step) % (1 << 62), "cpu")


def fit(
    config: TrainingConfig,
    model: Any,
    optimizer: Any,
    data: "Callable[[int], dict] | Iterable[dict]",
    *,
    steps: int,
    loss_fn: Optional[Callable] = None,
    batch_spec: Optional[Any] = None,
    grad_accum_steps: int = 1,
    eval_data: "Callable[[int], dict] | None" = None,
    eval_every: int = 0,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 0,
    keep_ckpts: int = 3,
    resume: bool = False,
    async_save: bool = True,
    ckpt_save_dtype: Optional[Any] = None,
    log_every: int = 10,
    scalar_dir: Optional[str] = None,
    metrics: Optional[Any] = None,
    timeline: Optional[Any] = None,
    obs: "Any | str | None" = None,
    flops_per_token: Optional[float] = None,
    peak_flops: Optional[float] = None,
    step_rng: bool = False,
    on_step: Optional[Callable[[int, dict], None]] = None,
    callbacks: "tuple[Callback, ...] | list" = (),
    checkpoint_on_signal: bool = False,
    policy: "Any | None" = None,
    prefetch: int = 0,
    defer_metrics: "bool | str" = "auto",
    transfer_guard: str = "off",
) -> FitResult:
    """Run the training loop over a ``ParallelModel`` (or a
    ``PipelinedModel``) and ``ParallelOptimizer`` (both updated in
    place).

    Args:
      data: ``data(step) -> batch`` (exact resume for free) or an iterable
        of batches (fast-forwarded on resume); a batch is the GLOBAL host
        batch (numpy arrays or tensors), as ``make_train_step`` takes it.
      steps: total global steps (the loop runs ``start_step..steps``).
      loss_fn / batch_spec / grad_accum_steps: for ``make_train_step``.
      eval_data / eval_every: ``make_eval_step`` on ``eval_data(step)``
        every ``eval_every`` steps, in ``FitResult.eval_history``.
      ckpt_dir / ckpt_every / keep_ckpts: tagged ``step_N`` checkpoints
        with rotation; a final checkpoint is always written when
        ``ckpt_dir`` is set.  ``resume=True`` restores the newest tag's
        parameters, AdamW state and update count, and continues from its
        step.  ``async_save``: cadence saves finish in the background.
      ckpt_save_dtype: e.g. ``torch.bfloat16``: downcast the MODEL payload
        on save (the optimizer's fp32 state stays fp32).
      metrics: a ``TrainingMetrics`` to fill with the summary numbers.
      timeline: a ``utils.Timeline`` for per-step host events (forces the
        synchronous metric path).
      obs: an ``obs.Observability`` or a directory (one is built there):
        per-step flight records with the host / device / data-wait split,
        the anomaly detectors, the compile ledger's ``train_step`` row,
        the perf attribution's ``train_step`` phase time, the memory
        ledger's parameter and optimizer bytes, registry dumps every
        ``log_every`` and a flight dump on a crash, a signal and at exit.
      flops_per_token / peak_flops: enable the MFU summary.
      step_rng: give the step a per-step ``torch.Generator`` (dropout).
      on_step / callbacks: :class:`Callback` hooks.
      checkpoint_on_signal: SIGTERM/SIGINT finish the current step, write
        the final checkpoint and return (a second signal is not caught).
        Needs ``ckpt_dir`` and the main thread.
      policy: an :class:`~..resilience.AnomalyPolicy`: NaN or spiking
        steps are skipped (the pre-step state restored) or rolled back to
        the newest checkpoint (needs ``ckpt_dir`` and step-indexed data);
        budgets raise ``RetriesExhausted``.  Forces synchronous metrics.
      prefetch: staged-ahead depth of the device-prefetch pipeline (0 =
        off); rewound on a rollback; closed on every exit path.
      defer_metrics: ``"auto"`` / True / False.  Deferred: step N's loss
        and grad norm are read in one packed copy after step N+1 is
        dispatched; every per-step consumer still sees every step, one
        dispatch late.  ``"auto"`` defers only when nothing needs
        same-step floats (no policy, no timeline, no callbacks, no armed
        flight detectors).  True with ``policy`` or ``timeline`` raises.
      transfer_guard: ``"off"`` / ``"forbid"``: every step runs under the
        transfer audit's guard (on CUDA, a synchronizing call inside
        raises); metric reads go through the audit and are counted.
    """
    if checkpoint_on_signal:
        if not ckpt_dir:
            raise ValueError("checkpoint_on_signal requires ckpt_dir")
        if threading.current_thread() is not threading.main_thread():
            raise ValueError(
                "checkpoint_on_signal requires the main thread (Python "
                "signal handlers cannot be installed elsewhere); run fit() "
                "on the main thread or drop the flag")
    step_fn = make_train_step(config, model, optimizer, loss_fn,
                              grad_accum_steps=grad_accum_steps,
                              batch_spec=batch_spec)
    eval_fn = None
    if eval_data is not None and eval_every > 0:
        eval_fn = make_eval_step(config, model, loss_fn, batch_spec=batch_spec)
    device = model.device

    def load(tag_dir):
        mstate, ostate, _, user = load_checkpoint(
            tag_dir, model_template=model_shards(model),
            optimizer_template=optimizer_shards(model, optimizer))
        restore_model(model, mstate, optimizer)
        if ostate is not None:
            restore_optimizer(model, optimizer, ostate)
        return dict(user or {})

    def save(tag_step, async_=False):
        return save_checkpoint(
            ckpt_dir, f"step_{tag_step}", model_shards(model),
            optimizer_shards(model, optimizer),
            user_content={"step": tag_step, "batches_consumed": tag_step},
            num_kept_ckpts=keep_ckpts, async_save=async_,
            save_dtype=ckpt_save_dtype)

    start_step = 0
    resumed_user: dict = {}
    if resume and ckpt_dir and newest_tag(ckpt_dir):
        resumed_user = load(ckpt_dir)
        start_step = int(resumed_user.get("step", 0))
        logger.info("resumed from step %d (%s)", start_step,
                    newest_tag(ckpt_dir))

    from neuronx_distributed_tpu_torch.trainer.scalar_log import ScalarWriter

    scalars = ScalarWriter(scalar_dir) if scalar_dir else None

    obs_rt = None
    if obs is not None:
        from neuronx_distributed_tpu_torch.obs import Observability

        obs_rt = obs if isinstance(obs, Observability) else Observability(
            str(obs), timeline=timeline)
    if obs_rt is not None and isinstance(model, PipelinedModel):
        # the host-driven executor runs the eager schedule: its bubble
        export_schedule_metrics(
            obs_rt.registry, model.num_microbatches,
            mesh.get_pipeline_parallel_size(), "eager", model.num_chunks)
    compile_led = getattr(obs_rt, "compile_ledger", None)
    memory_led = getattr(obs_rt, "memory_ledger", None)
    perf_rt = getattr(obs_rt, "perf", None)
    if memory_led is not None:
        memory_led.account_tree(
            "params", [p for p in model.module.parameters()])
        memory_led.account_tree(
            "opt_state", [v for st in optimizer.optimizer.state.values()
                          for v in st.values()
                          if isinstance(v, torch.Tensor)])
        memory_led.poll_device()

    policy_rt = None
    if policy is not None:
        from neuronx_distributed_tpu_torch.resilience.policy import (
            PolicyEngine,
        )

        if policy.wants_rollback:
            if not ckpt_dir:
                raise ValueError("policy rollback requires ckpt_dir (the "
                                 "newest checkpoint is the rollback target)")
            if not callable(data):
                raise ValueError(
                    "policy rollback requires step-indexed data(step): an "
                    "iterator's consumed batches cannot be re-wound")
        policy_rt = PolicyEngine(
            policy, registry=obs_rt.registry if obs_rt is not None else None)
        if policy.wants_rollback and newest_tag(ckpt_dir) is None:
            # a rollback target before the first cadence save
            save(start_step)

    if callable(data):
        next_batch = data
    else:
        it = iter(data)
        for consumed in range(start_step):  # iterator resume: skip consumed
            try:
                next(it)
            except StopIteration:
                raise ValueError(
                    f"resume fast-forward: the data iterator was exhausted "
                    f"after {consumed} batches while seeking start step "
                    f"{start_step}; the checkpoint records batches_consumed="
                    f"{resumed_user.get('batches_consumed', 'unrecorded')} - "
                    "the resumed data source is shorter than the one the "
                    "checkpointed run consumed (wrong data file, un-reset "
                    "epoch, or a differently-seeded shuffle)") from None

        def next_batch(step):
            return next(it)

    if transfer_guard not in ("off", "forbid"):
        raise ValueError(
            f"transfer_guard must be 'off' or 'forbid', got {transfer_guard!r}")
    audit = TransferAudit(
        obs_rt.registry if obs_rt is not None else None,
        mode="forbid" if transfer_guard == "forbid" else "observe",
        device=device)
    fetcher = _Fetch(device)

    prefetcher = None
    if prefetch:
        from neuronx_distributed_tpu_torch.data.prefetch import DevicePrefetcher

        prefetcher = DevicePrefetcher(
            next_batch, depth=prefetch, device=device,
            registry=obs_rt.registry if obs_rt is not None else None)
        next_batch = prefetcher.get

    thr: Optional[Throughput] = None
    tokens_per_batch = None
    eval_history: list = []
    loss = float("nan")

    cbs = list(callbacks)
    if on_step is not None:
        legacy = Callback()
        legacy.on_step = on_step  # type: ignore[method-assign]
        cbs.append(legacy)
    for cb in cbs:
        cb.should_stop = False  # instances are reusable across fit() calls
        cb.on_fit_start(start_step, model, optimizer)

    if defer_metrics not in ("auto", True, False):
        raise ValueError(
            f"defer_metrics must be 'auto', True or False, got "
            f"{defer_metrics!r}")
    if defer_metrics is True and policy is not None:
        raise ValueError(
            "defer_metrics=True is incompatible with policy=: skip/rollback "
            "decisions need the step's loss on the host BEFORE the next "
            "step is dispatched; drop the policy or use "
            "defer_metrics='auto'")
    if defer_metrics is True and timeline is not None:
        raise ValueError(
            "defer_metrics=True is incompatible with timeline=: the "
            "timeline's per-step device attribution is the in-event sync "
            "the deferred mode removes; drop the timeline or use "
            "defer_metrics='auto'")
    if defer_metrics == "auto":
        deferred = (policy is None and timeline is None and not cbs
                    and (obs_rt is None or not obs_rt.flight.detectors))
    else:
        deferred = bool(defer_metrics)

    # at most one pending train step and one pending eval, each read with
    # ONE explicit packed copy after the next step's dispatch
    pending: list = []       # [(step, handle, timing dict)]
    pending_eval: list = []  # [(eval_step, handle)]

    def _publish(pstep, ploss, pgrad, seqs, step_time_s, host_s, device_s,
                 data_wait_s):
        if obs_rt is not None:
            obs_rt.observe_step(
                pstep, loss=ploss, grad_norm=pgrad, seq_per_sec=seqs,
                step_time_s=step_time_s, host_s=host_s, device_s=device_s,
                data_wait_s=data_wait_s)
            if perf_rt is not None:
                perf_rt.note_phase("train_step", step_time_s * 1e3)
                perf_rt.update_metrics()

    def _emit(pstep, ploss, pgrad, seqs):
        if scalars:
            scalars.scalars(pstep, loss=ploss, grad_norm=pgrad,
                            seq_per_sec=seqs)
        step_metrics = {"loss": ploss, "grad_norm": pgrad,
                        "seq_per_sec": seqs}
        for cb in cbs:
            cb.on_step(pstep, step_metrics)
        if log_every and (pstep % log_every == 0 or pstep == steps - 1):
            if obs_rt is not None:
                obs_rt.dump_scalars(pstep)
            print(json.dumps({
                "step": pstep, "loss": round(ploss, 4),
                "seq_per_sec": round(seqs, 2),
                "grad_norm": round(pgrad, 4),
            }), flush=True)

    def _flush_step_metrics() -> None:
        nonlocal loss
        if not pending:
            return
        pstep, handle, pt = pending.pop()
        t_w = time.perf_counter()
        fetched = audit.fetch(fetcher, handle, label="train")
        wait_s = time.perf_counter() - t_w
        ploss = perturb("fit/loss", float(fetched[0]), step=pstep)
        pgrad = float(fetched[1])
        loss = ploss
        _publish(pstep, ploss, pgrad, pt["seqs"], pt["dispatch_s"] + wait_s,
                 pt["dispatch_s"], wait_s, pt["data_wait_s"])
        _emit(pstep, ploss, pgrad, pt["seqs"])

    def _flush_eval() -> None:
        if not pending_eval:
            return
        estep, handle = pending_eval.pop()
        eval_loss = float(audit.fetch(fetcher, handle, label="train")[0])
        eval_history.append((estep, eval_loss))
        if scalars:
            scalars.scalars(estep - 1, eval_loss=eval_loss)
        for cb in cbs:
            cb.on_eval(estep, {"eval_loss": eval_loss})

    prev_handlers = {}
    signal_seen: list = []
    if checkpoint_on_signal:
        def _on_signal(signum, frame):
            # append only (async-signal-safe); restore the previous handlers
            # so a second signal terminates as usual
            signal_seen.append(signum)
            for s, h in prev_handlers.items():
                _signal.signal(s, h if h is not None else _signal.SIG_DFL)

        for sig in (_signal.SIGTERM, _signal.SIGINT):
            prev_handlers[sig] = _signal.signal(sig, _on_signal)

    final_step = steps
    last_saved_step = -1
    ran_any = start_step < steps
    try:
        step = start_step
        while step < steps:
            if signal_seen:
                final_step = step
                logger.info("stopping on signal %s after step %d "
                            "(checkpoint follows)", signal_seen[0], final_step)
                if obs_rt is not None:
                    obs_rt.dump_flight(f"signal_{signal_seen[0]}")
                break
            fault_point("fit/step_start", step=step, start_step=start_step)
            t_data = time.perf_counter()
            batch = next_batch(step)
            data_wait_s = time.perf_counter() - t_data
            snap = None
            if policy_rt is not None and policy.wants_snapshot:
                # a skip restores the pre-step state: keep a device copy
                snap = ({k: s.tensor.detach().clone()
                         for k, s in model_shards(model).items()},
                        _clone_opt(optimizer_shards(model, optimizer)))
            if thr is None:
                first = next(v for v in batch.values() if v is not None)
                bsz = first.shape[0]
                two_d = [v for v in batch.values()
                         if v is not None and len(v.shape) >= 2]
                tokens_per_batch = bsz * two_d[0].shape[1] if two_d else None
                thr = Throughput(bsz)
                if perf_rt is not None and compile_led is None \
                        and flops_per_token and tokens_per_batch:
                    perf_rt.note_cost("train_step",
                                      flops_per_token * tokens_per_batch, 0.0)
            gen = _step_generator(config.seed, step) if step_rng else None
            t0 = time.perf_counter()
            if timeline is not None:
                with timeline.event("train_step"):
                    m = step_fn(batch, gen)
                    t_dispatch = time.perf_counter()
                    fetched = audit.fetch(
                        fetcher, fetcher.start(m["loss"], m["grad_norm"]),
                        label="train")
                t_done = time.perf_counter()
                timeline.mark_step_end(step)
                loss = perturb("fit/loss", float(fetched[0]), step=step)
                grad_norm = float(fetched[1])
                seqs = thr.step()
            else:
                with audit.section("fit/step"):
                    m = step_fn(batch, gen)
                    handle = fetcher.start(m["loss"], m["grad_norm"])
                t_dispatch = time.perf_counter()
                seqs = thr.step()
                if deferred:
                    # publish step N-1 now that step N is in flight
                    _flush_step_metrics()
                    pending.append((step, handle, {
                        "seqs": seqs, "dispatch_s": t_dispatch - t0,
                        "data_wait_s": data_wait_s}))
                else:
                    fetched = audit.fetch(fetcher, handle, label="train")
                    loss = perturb("fit/loss", float(fetched[0]), step=step)
                    grad_norm = float(fetched[1])
                    t_done = time.perf_counter()
            if compile_led is not None and step == start_step:
                # the first step's wall time holds its one-time work (kernel
                # loads, cuBLAS heuristics, the allocator's growth): the
                # eager port's compile row; everything after is warm
                compile_led.record_compile(
                    "train_step", "step0", (t_dispatch - t0) * 1e3,
                    kind="eager")
                compile_led.declare_warmup_done("fit_step0")
            if not deferred:
                _publish(step, loss, grad_norm, seqs, t_done - t0,
                         t_dispatch - t0, t_done - t_dispatch, data_wait_s)
            if policy_rt is not None:
                decision = policy_rt.decide(step, loss=loss,
                                            grad_norm=grad_norm,
                                            step_time_s=t_done - t0)
                if decision is not None and decision.action == "skip":
                    # discard the update: the pre-step state back, the
                    # batch counted as consumed; nothing fires for the step
                    _flush_eval()
                    restore_model(model, snap[0], optimizer)
                    restore_optimizer(model, optimizer, snap[1])
                    step += 1
                    continue
                if decision is not None and decision.action == "rollback":
                    _flush_eval()
                    wait_for_checkpoint()
                    user = load(ckpt_dir)
                    rb_step = int(user.get("step", 0))
                    if rb_step > step:
                        raise RuntimeError(
                            f"policy rollback loaded step {rb_step} > current "
                            f"step {step} from {newest_tag(ckpt_dir)}: "
                            f"{ckpt_dir} holds checkpoints this run did not "
                            "write (stale dir? missing resume=True?)")
                    step = rb_step
                    logger.warning("policy: rolled back to step %d (%s)",
                                   step, newest_tag(ckpt_dir))
                    continue
            if not deferred:
                _emit(step, loss, grad_norm, seqs)
            for cb in cbs:
                cb.on_params(step, model, optimizer)
            _flush_eval()  # last cadence's eval, read one iteration late
            if eval_fn is not None and (step + 1) % eval_every == 0:
                ev = eval_fn(eval_data(step))
                pending_eval.append((step + 1, fetcher.start(ev["loss"])))
            if ckpt_dir and ckpt_every and (step + 1) % ckpt_every == 0 \
                    and step + 1 < steps:
                # the step's scalars land before the checkpoint that
                # supersedes them
                _flush_step_metrics()
                _flush_eval()
                path = save(step + 1, async_save)
                last_saved_step = step + 1
                for cb in cbs:
                    cb.on_checkpoint(step + 1, path)
            if any(cb.should_stop for cb in cbs):
                final_step = step + 1
                logger.info("callback requested stop after step %d",
                            final_step)
                break
            step += 1

        _flush_step_metrics()
        _flush_eval()
        if not ran_any:
            logger.info("resume step %d >= steps %d: nothing to do",
                        start_step, steps)
        if ckpt_dir and ran_any:
            if last_saved_step != final_step:
                path = save(final_step)
                for cb in cbs:
                    cb.on_checkpoint(final_step, path)
            else:
                wait_for_checkpoint()  # a cadence save may be async
    except BaseException as e:
        try:
            _flush_step_metrics()
            _flush_eval()
        except Exception as flush_err:
            logger.warning("deferred-metric flush failed during crash "
                           "handling: %s", flush_err)
        if memory_led is not None:
            try:
                memory_led.oom_dump(e)
            except Exception as dump_err:
                logger.warning("obs: OOM breakdown dump failed: %s", dump_err)
        if obs_rt is not None:
            try:
                obs_rt.close(f"crash:{type(e).__name__}")
            except Exception as dump_err:
                logger.warning("obs: crash dump failed: %s", dump_err)
        raise
    finally:
        if prefetcher is not None:
            prefetcher.close()
        for sig, h in prev_handlers.items():
            _signal.signal(sig, h if h is not None else _signal.SIG_DFL)
    if scalars:
        scalars.close()
    if obs_rt is not None:
        obs_rt.close(f"signal_{signal_seen[0]}" if signal_seen else "fit_end")
    if metrics is not None and ran_any:
        summary = {
            "final_loss": loss,
            "steps": steps,
            "completed_steps": final_step,
            "resumed_from_step": start_step,
            "peak_seq_per_sec": thr.peak if thr else 0.0,
        }
        if policy_rt is not None:
            summary["policy_skipped_updates"] = policy_rt.skips
            summary["policy_rollbacks"] = policy_rt.rollbacks
        if flops_per_token and peak_flops and thr and thr.window \
                and tokens_per_batch:
            toks_per_sec = thr.batch_size * len(thr.window) / max(
                sum(thr.window), 1e-9) * (tokens_per_batch / thr.batch_size)
            summary["mfu"] = mfu(toks_per_sec, flops_per_token, peak_flops)
        if perf_rt is not None:
            roll = perf_rt.rollup()
            if roll is not None:
                summary["mfu_model"] = roll["mfu"]
                summary["pct_roofline"] = roll["pct_roofline"]
        metrics.update(**summary)
        metrics.write()

    result = FitResult(
        model=model, optimizer=optimizer, final_loss=loss,
        steps_run=max(0, final_step - start_step), start_step=start_step,
        peak_seq_per_sec=thr.peak if thr else 0.0, eval_history=eval_history,
        policy_events=list(policy_rt.events) if policy_rt is not None else [])
    for cb in cbs:
        cb.on_fit_end(result)
    return result


def _clone_opt(tree: dict) -> dict:
    return {"count": tree["count"],
            **{m: {k: s.tensor.detach().clone() for k, s in tree[m].items()}
               for m in ("exp_avg", "exp_avg_sq")}}
