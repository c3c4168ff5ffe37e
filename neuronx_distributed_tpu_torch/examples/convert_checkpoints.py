"""HF <-> port checkpoint conversion CLI (counterpart of the JAX package's
``examples/convert_checkpoints.py``), built on
:mod:`neuronx_distributed_tpu_torch.convert`.  Run it as a module; it
converts on the card unless ``--device cpu``::

  # HF -> the port's checkpoint format (what trainer.load_checkpoint,
  # the launcher's --resume and eval_perplexity --ckpt read)
  python -m neuronx_distributed_tpu_torch.examples.convert_checkpoints \\
      to-framework --family llama --hf /path/to/hf_model_dir \\
      --out /tmp/port_ckpt --config llama2_7b

  # the port's checkpoint -> HF (one model.safetensors)
  python -m neuronx_distributed_tpu_torch.examples.convert_checkpoints \\
      to-hf --family llama --ckpt /tmp/port_ckpt --out /tmp/hf_out \\
      --config llama2_7b

The HF side is a directory of ``*.safetensors`` files (read without the
``safetensors`` package) or ``pytorch_model*.bin`` shards.  ``--config``
is a preset of the family's config class (``tiny``, ``llama2_7b``,
``qwen2_7b``, ``gemma2_9b``, ...) or a JSON file of config fields over the
class defaults; ``--num-layers`` cuts its depth.  Tensors keep the
checkpoint's dtype.  A checkpoint written at pp > 1 holds each stage's
layers under the pp = 1 names; ``to-hf`` checks that the stages make the
whole model.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import torch

FAMILIES = ("llama", "gpt_neox", "bert", "gemma", "gemma2")


def _family(name: str):
    """``(config class, from_hf, to_hf, from_pipelined or None)``."""
    from neuronx_distributed_tpu_torch import convert as C
    from neuronx_distributed_tpu_torch.models import (
        BertConfig,
        Gemma2Config,
        GemmaConfig,
        GPTNeoXConfig,
        LlamaConfig,
    )

    return {
        "llama": (LlamaConfig, C.llama_params_from_hf, C.llama_params_to_hf,
                  C.llama_params_from_pipelined),
        "gpt_neox": (GPTNeoXConfig, C.gpt_neox_params_from_hf,
                     C.gpt_neox_params_to_hf,
                     C.gpt_neox_params_from_pipelined),
        "bert": (BertConfig, C.bert_params_from_hf, C.bert_params_to_hf,
                 None),
        "gemma": (GemmaConfig, C.gemma_params_from_hf, C.gemma_params_to_hf,
                  None),
        "gemma2": (Gemma2Config, C.gemma2_params_from_hf,
                   C.gemma2_params_to_hf, None),
    }[name]


def build_config(cls, config: Optional[str], num_layers: Optional[int] = None):
    """``cls`` from a preset name or a JSON file of fields (None: the class
    defaults), with ``num_layers`` cutting the depth."""
    overrides = {} if num_layers is None else {"num_layers": num_layers}
    if not config:
        return cls(**overrides)
    if config.endswith(".json") or os.path.exists(config):
        with open(config) as f:
            return cls(**{**json.load(f), **overrides})
    preset = getattr(cls, config, None)
    if preset is None:
        raise SystemExit(f"{cls.__name__} has no preset {config!r}")
    return preset(**overrides)


def cmd_to_framework(args) -> dict:
    from neuronx_distributed_tpu_torch.convert import load_hf_state_dict
    from neuronx_distributed_tpu_torch.trainer.checkpoint import save_checkpoint
    from neuronx_distributed_tpu_torch.utils.device import resolve_device

    cls, from_hf, _, _ = _family(args.family)
    cfg = build_config(cls, args.config, args.num_layers)
    device = resolve_device(args.device)
    params = from_hf(load_hf_state_dict(args.hf, device=device), cfg)
    save_checkpoint(args.out, "hf_import", params, user_content={
        "source": "hf", "family": args.family, "config": args.config,
        "num_layers": cfg.num_layers})
    n = sum(t.numel() for t in params.values())
    return {"params": n, "tensors": len(params), "out": args.out,
            "tag": "hf_import"}


def cmd_to_hf(args) -> dict:
    from neuronx_distributed_tpu_torch.convert import save_hf_state_dict
    from neuronx_distributed_tpu_torch.trainer.checkpoint import (
        load_checkpoint,
        newest_tag,
    )
    from neuronx_distributed_tpu_torch.utils.device import resolve_device

    cls, _, to_hf, from_pipelined = _family(args.family)
    cfg = build_config(cls, args.config, args.num_layers)
    device = resolve_device(args.device)
    tag = args.tag or newest_tag(args.ckpt)
    if tag is None:
        raise SystemExit(f"no completed checkpoint under {args.ckpt}")
    with open(os.path.join(args.ckpt, tag, "meta.json")) as f:
        meta = json.load(f)
    # every stored tensor whole, on the device, at its stored dtype
    template = {k: torch.empty(rec["shape"], dtype=getattr(torch, rec["dtype"]),
                               device=device)
                for k, rec in meta["tensors"]["model"].items()}
    state = load_checkpoint(args.ckpt, tag, model_template=template)[0]
    pp = meta.get("mesh", {}).get("pipeline_parallel_size", 1)
    if pp > 1:
        if from_pipelined is None:
            raise SystemExit(f"pipelined checkpoints unsupported for "
                             f"{args.family}")
        state = from_pipelined(state, range(cfg.num_layers))
    sd = to_hf(state, cfg)
    path = save_hf_state_dict(sd, args.out)
    return {"tensors": len(sd), "out": path, "tag": tag}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn in (("to-framework", cmd_to_framework), ("to-hf", cmd_to_hf)):
        sp = sub.add_parser(name)
        sp.add_argument("--family", required=True, choices=FAMILIES)
        sp.add_argument("--config", default=None,
                        help="a preset of the family's config (tiny, "
                             "llama2_7b, qwen2_7b, ...) or a JSON file of "
                             "config fields")
        sp.add_argument("--num-layers", type=int, default=None,
                        help="cut the config's depth (widths stay)")
        sp.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
        sp.add_argument("--out", required=True)
        if name == "to-framework":
            sp.add_argument("--hf", required=True, help="HF model directory")
        else:
            sp.add_argument("--ckpt", required=True,
                            help="the port's checkpoint directory")
            sp.add_argument("--tag", default=None,
                            help="checkpoint tag (default: the newest)")
        sp.set_defaults(fn=fn)
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Parse ``argv``, convert, print one JSON line; returns it."""
    args = parse_args(argv)
    out = args.fn(args)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
