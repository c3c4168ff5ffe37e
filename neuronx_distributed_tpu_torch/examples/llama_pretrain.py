"""Llama pretraining launcher (counterpart of the JAX package's
``examples/training/llama_pretrain.py``): tensor x sequence x pipeline x
context x data parallelism with ZeRO-1, checkpoints and resume, the
native token loader (or synthetic data), packing, throughput and MFU,
all through ``fit()``.

Run it as a module; it trains on the card unless ``--device cpu``::

  python -m neuronx_distributed_tpu_torch.examples.llama_pretrain \\
      --preset tiny --device cpu --steps 20 --batch-size 8 --seq-len 64

  python -m neuronx_distributed_tpu_torch.examples.llama_pretrain \\
      --preset llama3_8b --num-layers 2 --attention flash --bf16 \\
      --data corpus.nxdt --batch-size 1 --seq-len 2048 \\
      --ckpt-dir ckpts --resume

Past one rank, start one process a rank with ``torchrun`` (the world comes
from its environment; the data-parallel degree is the world over ``--tp``
x ``--pp`` x ``--cp``).  Every rank reads the same global batch, as
``make_train_step`` takes it.  ``--pp 2 --microbatches 4`` trains two
pipeline stages under 1F1B (``--pp-schedule gpipe | interleaved``,
``--virtual-stages V`` with the interleaved schedule)::

  torchrun --nproc-per-node 2 -m \\
      neuronx_distributed_tpu_torch.examples.llama_pretrain --device cpu \\
      --preset tiny --num-layers 4 --pp 2 --microbatches 4 --steps 20

``--pp`` composes with ``--cp``: each stage holds its cp rank's chunk of
every microbatch (``--pp 2 --cp 2`` on four ranks).

``--preset mixtral_8x7b`` trains the Mixtral-8x7B-shaped MoE (8 experts,
top-2, scatter dispatch; MFU over its active FLOPs); the experts shard
over the expert-parallel degree of a ``TrainingConfig`` built in code
(JAX's launcher has no ep flag either).

The loop stages batches 2 steps ahead on the device and reads each step's
loss and grad norm one step late (``fit``'s ``prefetch=2`` and deferred
metrics): the same losses as a synchronous loop, without a wait a step.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

# JAX flags whose feature the port does not have yet, by the ROADMAP item
# that brings it
DEFERRED_FLAGS = {
    "scan_layers": "a stacked layer scan: each port layer is its own module "
                   "(ROADMAP, \"not faults\")",
}

PRESETS = ("tiny", "llama3_8b", "mixtral_8x7b")
H100_BF16_PEAK_FLOPS = 989e12  # H100 SXM dense bf16 peak


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--preset", default="tiny", choices=PRESETS)
    p.add_argument("--num-layers", type=int, default=None,
                   help="cut the preset's depth (widths stay)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--tp", type=int, default=1, help="tensor parallel degree")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline parallel degree")
    p.add_argument("--microbatches", type=int, default=1,
                   help="pipeline microbatches (pp > 1)")
    p.add_argument("--pp-schedule", default="1f1b",
                   choices=["1f1b", "gpipe", "interleaved"])
    p.add_argument("--virtual-stages", type=int, default=1,
                   help="interleaved virtual stages a pp rank (with "
                        "--pp-schedule interleaved)")
    p.add_argument("--cp", type=int, default=1,
                   help="context parallel degree (ring attention)")
    p.add_argument("--scan-layers", action="store_true",
                   help="not ported: each port layer is its own module")
    p.add_argument("--kv-multiplier", type=int, default=1,
                   help="KV replication when num_kv_heads < tp")
    p.add_argument("--no-sp", action="store_true",
                   help="disable sequence parallelism")
    p.add_argument("--no-zero1", action="store_true",
                   help="disable ZeRO-1 state sharding")
    p.add_argument("--loss-chunk", type=int, default=0,
                   help="chunked lm-head + CE over N-token sequence chunks "
                        "(0 = off)")
    p.add_argument("--attention", default="dense", choices=["dense", "flash"])
    p.add_argument("--remat", default="selective",
                   choices=["none", "selective", "full"])
    p.add_argument("--batch-size", type=int, default=8,
                   help="global batch size")
    p.add_argument("--seq-len", type=int, default=2048)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--warmup-steps", type=int, default=10)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--data", default=None,
                   help="NXDT token file (synthetic data if unset)")
    p.add_argument("--packed", action="store_true",
                   help="treat --data as an eos-joined document stream: "
                        "split, first-fit pack with segment ids and "
                        "per-document RoPE positions (data.packing)")
    p.add_argument("--packed-eos-id", type=int, default=None,
                   help="eos id separating documents in --data (required "
                        "with --packed)")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--keep-ckpts", type=int, default=3)
    p.add_argument("--ckpt-bf16", action="store_true",
                   help="downcast the model payload to bfloat16 on save "
                        "(optimizer state stays fp32)")
    p.add_argument("--ckpt-on-signal", action="store_true",
                   help="on SIGTERM/SIGINT finish the step, write the final "
                        "checkpoint and exit cleanly (pair with --resume)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--metrics-file", default=None, help="JSON results file")
    p.add_argument("--scalar-dir", default=None,
                   help="TensorBoard/JSONL scalar stream dir (rank 0 only)")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute (the default on the card; fp32 on the "
                        "CPU)")
    args = p.parse_args(argv)
    for flag, item in DEFERRED_FLAGS.items():
        value = getattr(args, flag)
        if value is True or (not isinstance(value, bool) and value != 1):
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} is not ported yet: {item}")
    if args.ckpt_on_signal and not args.ckpt_dir:
        p.error("--ckpt-on-signal requires --ckpt-dir")
    if args.loss_chunk and args.pp > 1:
        p.error("--loss-chunk has no effect with --pp > 1: the pipeline "
                "engine owns the head+loss (its last stage computes per-"
                "microbatch logits already bounded by the microbatch size)")
    if args.packed and not args.data:
        p.error("--packed requires --data (an eos-joined NXDT document "
                "stream)")
    if args.packed and args.packed_eos_id is None:
        p.error("--packed requires --packed-eos-id")
    return args


def _packed_source(args, vocab_size: int):
    from neuronx_distributed_tpu_torch.data import TokenDataset, read_token_file
    from neuronx_distributed_tpu_torch.data.packing import (
        pack_documents,
        segment_positions,
    )

    TokenDataset(args.data).validate_vocab(vocab_size)
    toks = np.asarray(read_token_file(args.data))
    cuts = np.where(toks == args.packed_eos_id)[0]
    docs = [d[d != args.packed_eos_id] for d in np.split(toks, cuts + 1)]
    docs = [d for d in docs if d.size]
    ids_all, labels_all, segs_all = pack_documents(
        docs, seq_len=args.seq_len, eos_id=args.packed_eos_id)
    pos_all = segment_positions(segs_all)
    n_rows = ids_all.shape[0]
    if n_rows < args.batch_size:
        raise SystemExit(f"packing produced {n_rows} rows < batch size "
                         f"{args.batch_size}")
    print(f"packed {len(docs)} documents into {n_rows} rows of "
          f"{args.seq_len}", flush=True)
    perms = {}

    def epoch_perm(e):
        if e not in perms:
            if len(perms) > 2:
                perms.clear()
            perms[e] = np.random.RandomState(args.seed + int(e)).permutation(
                n_rows)
        return perms[e]

    def next_batch(step):
        # element i of the batch is global sample step * B + i, through its
        # own epoch's permutation: one pass an epoch, nothing repeated
        B = args.batch_size
        idxs = np.arange(step * B, (step + 1) * B)
        epochs = idxs // n_rows
        sel = np.empty(B, np.int64)
        for e in np.unique(epochs):
            m = epochs == e
            sel[m] = epoch_perm(e)[idxs[m] % n_rows]
        return {"ids": ids_all[sel], "labels": labels_all[sel],
                "positions": pos_all[sel], "segment_ids": segs_all[sel]}

    return next_batch


def _data_source(args, vocab_size: int):
    if args.data and args.packed:
        return _packed_source(args, vocab_size)
    if args.data:
        from neuronx_distributed_tpu_torch.data import (
            TokenDataLoader,
            TokenDataset,
            step_indexed,
        )

        ds = TokenDataset(args.data)
        ds.validate_vocab(vocab_size)
        loader = TokenDataLoader(ds, batch_size=args.batch_size,
                                 seq_len=args.seq_len, dp_rank=0, dp_size=1,
                                 seed=args.seed)
        source = step_indexed(loader)
        source.dataset = ds
        return source

    def synthetic(step):
        rng = np.random.default_rng([args.seed, step])
        ids = rng.integers(0, vocab_size, (args.batch_size, args.seq_len),
                           dtype=np.int32)
        return {"ids": ids, "labels": np.roll(ids, -1, axis=1)}

    return synthetic


def prepare(argv: Optional[Sequence[str]] = None) -> Tuple:
    """Parse ``argv`` and build what ``fit`` takes: ``(config, model,
    optimizer, data, kwargs)``, the launcher's run being ``fit(config,
    model, optimizer, data, **kwargs)``.  ``data`` is the step-indexed
    batch source (``.dataset``: the token file's ``TokenDataset`` when
    ``--data`` is an unpacked file)."""
    args = parse_args(argv)
    from neuronx_distributed_tpu_torch.config import training_config
    from neuronx_distributed_tpu_torch.models.common import (
        make_causal_lm_loss_sum,
    )
    from neuronx_distributed_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaForCausalLM,
    )
    from neuronx_distributed_tpu_torch.trainer import (
        TrainingMetrics,
        initialize_parallel_model,
        initialize_parallel_optimizer,
        transformer_flops_per_token,
    )
    from neuronx_distributed_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world % (args.tp * args.pp * args.cp):
        raise ValueError(f"world size {world} is not a multiple of tp "
                         f"{args.tp} x pp {args.pp} x cp {args.cp}")
    on_card = device.type == "cuda"
    config = training_config(
        tensor_parallel_size=args.tp, kv_size_multiplier=args.kv_multiplier,
        context_parallel_size=args.cp, pipeline_parallel_size=args.pp,
        num_microbatches=args.microbatches, schedule=args.pp_schedule,
        virtual_stages=args.virtual_stages,
        packed_inputs=args.packed and args.pp > 1,
        data_parallel_size=world // (args.tp * args.pp * args.cp),
        learning_rate=args.lr,
        lr_schedule="cosine", warmup_steps=args.warmup_steps,
        total_steps=max(args.steps, args.warmup_steps + 1),
        zero_one_enabled=not args.no_zero1,
        compute_dtype="bfloat16" if (args.bf16 or on_card) else "float32",
        param_dtype="float32", seed=args.seed)
    overrides = dict(max_seq_len=args.seq_len,
                     sequence_parallel=not args.no_sp,
                     attention_impl=args.attention, remat=args.remat,
                     dtype=config.torch_compute_dtype,
                     param_dtype=config.torch_param_dtype)
    if args.num_layers is not None:
        overrides["num_layers"] = args.num_layers
    cfg = getattr(LlamaConfig, args.preset)(**overrides)
    model = initialize_parallel_model(
        config, lambda d: LlamaForCausalLM(cfg, device=d), seed=args.seed,
        device=device)
    opt = initialize_parallel_optimizer(config, model)
    data = _data_source(args, cfg.vocab_size)
    flops_tok = transformer_flops_per_token(
        cfg.num_layers, cfg.hidden_size, cfg.intermediate_size,
        cfg.vocab_size, args.seq_len, cfg.num_heads, cfg.num_kv_heads,
        cfg.head_dim_, cfg.num_experts, cfg.moe_top_k)
    kwargs = dict(
        steps=args.steps, loss_fn=make_causal_lm_loss_sum(args.loss_chunk),
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        keep_ckpts=args.keep_ckpts,
        ckpt_save_dtype=torch.bfloat16 if args.ckpt_bf16 else None,
        checkpoint_on_signal=args.ckpt_on_signal, resume=args.resume,
        scalar_dir=args.scalar_dir,
        metrics=TrainingMetrics(args.metrics_file) if args.metrics_file
        else None,
        flops_per_token=flops_tok,
        peak_flops=H100_BF16_PEAK_FLOPS if on_card else 1e12,
        log_every=10, prefetch=2, defer_metrics=True)
    return config, model, opt, data, kwargs


def main(argv: Optional[Sequence[str]] = None, callbacks: Sequence = (),
         obs=None):
    """Parse ``argv``, train, print the final loss; returns the
    ``FitResult`` (with ``.data``: the data source).  ``callbacks`` and
    ``obs`` go to ``fit`` (for a caller that drives the launcher in
    process)."""
    from neuronx_distributed_tpu_torch.trainer import fit

    config, model, opt, data, kwargs = prepare(argv)
    res = fit(config, model, opt, data, callbacks=list(callbacks), obs=obs,
              **kwargs)
    res.data = data
    print(json.dumps({"done": True, "final_loss": res.final_loss,
                      "steps_run": res.steps_run,
                      "start_step": res.start_step}), flush=True)
    return res


if __name__ == "__main__":
    main()
