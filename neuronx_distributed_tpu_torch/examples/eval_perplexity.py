"""Token-exact perplexity over a token file (counterpart of the JAX
package's ``examples/eval_perplexity.py``).

Streams a ``data.write_token_file`` file through the native loader and the
loss sum (``models.common.causal_lm_loss_sum``) and reports ``exp(sum loss
/ sum tokens)``: the corpus perplexity, not a mean of batch means.  Run it
as a module; it evaluates on the card (bf16 compute over fp32 weights,
flash attention) unless ``--device cpu`` (fp32, the dense core)::

  python -m neuronx_distributed_tpu_torch.examples.eval_perplexity \\
      --data tokens.nxdt --preset tiny --batch 8 --seq 128 --device cpu
  python -m neuronx_distributed_tpu_torch.examples.eval_perplexity \\
      --data corpus.nxdt --preset llama2_7b --ckpt ckpts/run1  # newest tag

``--tp N`` evaluates at tensor-parallel degree N, one process a rank under
``torchrun``, as the Llama launcher trains.  The weights come from a port
checkpoint (``--ckpt``, ``--tag``: the launcher's, or one that
``convert_checkpoints to-framework`` wrote), else from seed 0.  Prints
ONE JSON line::

  {"metric": "eval_perplexity", "value": ..., "loss": ..., "tokens": N}
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data", required=True,
                   help="token file (data.write_token_file)")
    p.add_argument("--family", default="llama",
                   choices=["llama", "gemma", "gemma2"])
    p.add_argument("--preset", default="tiny",
                   help="config preset of the family's config class (tiny, "
                        "llama2_7b, qwen2_7b, gemma_7b, gemma2_9b, ...)")
    p.add_argument("--num-layers", type=int, default=None,
                   help="cut the preset's depth (widths stay)")
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--max-batches", type=int, default=0, help="0 = whole file")
    p.add_argument("--ckpt", default=None, help="checkpoint directory")
    p.add_argument("--tag", default=None, help="checkpoint tag (default newest)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p.parse_args(argv)


def build_model(args):
    """This rank's ``ParallelModel`` of ``args``' family and preset, its
    weights from ``--ckpt`` (resharded to ``--tp``) or from seed 0."""
    import torch

    from neuronx_distributed_tpu_torch.config import training_config
    from neuronx_distributed_tpu_torch.models import (
        Gemma2Config,
        Gemma2ForCausalLM,
        GemmaConfig,
        GemmaForCausalLM,
        LlamaConfig,
        LlamaForCausalLM,
    )
    from neuronx_distributed_tpu_torch.trainer import (
        initialize_parallel_model,
        load_checkpoint,
        model_shards,
    )
    from neuronx_distributed_tpu_torch.trainer.checkpoint import restore_model
    from neuronx_distributed_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    cfg_cls, model_cls = {
        "llama": (LlamaConfig, LlamaForCausalLM),
        "gemma": (GemmaConfig, GemmaForCausalLM),
        "gemma2": (Gemma2Config, Gemma2ForCausalLM),
    }[args.family]
    overrides = dict(max_seq_len=args.seq, remat="none",
                     attention_impl="flash" if on_card else "dense",
                     dtype=torch.bfloat16 if on_card else torch.float32,
                     param_dtype=torch.float32)
    overrides["sequence_parallel"] = args.tp > 1
    if args.num_layers is not None:
        overrides["num_layers"] = args.num_layers
    cfg = getattr(cfg_cls, args.preset)(**overrides)
    config = training_config(
        tensor_parallel_size=args.tp,
        compute_dtype="bfloat16" if on_card else "float32",
        param_dtype="float32", seed=0)
    model = initialize_parallel_model(
        config, lambda d: model_cls(cfg, device=d), device=device)
    if args.ckpt:
        state = load_checkpoint(args.ckpt, tag=args.tag,
                                model_template=model_shards(model))[0]
        restore_model(model, state)
    model.module.eval()
    return model


def evaluate(argv: Optional[Sequence[str]] = None) -> dict:
    """Parse ``argv`` and evaluate: ``{"metric", "value", "loss", "tokens",
    "batches"}`` at full precision (``loss``: the mean over every token)."""
    import torch

    from neuronx_distributed_tpu_torch.data import TokenDataLoader, TokenDataset
    from neuronx_distributed_tpu_torch.models.common import causal_lm_loss_sum

    args = parse_args(argv)
    model = build_model(args)
    ds = TokenDataset(args.data)
    loader = TokenDataLoader(ds, args.batch, args.seq, seed=0)
    total_sum, total_tok, batches = 0.0, 0, 0
    with torch.no_grad():
        for batch in loader:
            batch = {k: v.to(model.device) for k, v in batch.items()}
            loss_sum, tok = causal_lm_loss_sum(model.module, batch)
            total_sum += float(loss_sum.double())
            total_tok += int(tok)
            batches += 1
            if args.max_batches and batches >= args.max_batches:
                break
    loader.close()
    if total_tok == 0:
        return {"metric": "eval_perplexity", "value": float("nan"),
                "loss": float("nan"), "tokens": 0, "batches": batches}
    mean = total_sum / total_tok
    return {"metric": "eval_perplexity", "value": math.exp(mean),
            "loss": mean, "tokens": total_tok, "batches": batches}


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Evaluate and print the JSON line (JAX's rounding); 1 when the file
    gave no token."""
    out = evaluate(argv)
    if out["tokens"]:
        out = dict(out, value=round(out["value"], 4),
                   loss=round(out["loss"], 6))
    if int(os.environ.get("RANK", "0")) == 0:
        print(json.dumps(out), flush=True)
    return 0 if out["tokens"] else 1


if __name__ == "__main__":
    sys.exit(main())
