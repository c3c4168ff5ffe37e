"""Where the gap between phase 12(a)'s kernel and gather logits comes from,
at two draws of its random Qwen2-7B checkpoint.

``chip_smoke.py`` phase 12(a) serves Qwen2-7B (28 layers, full width) from
a random bf16 HF state dict and holds one decode step's logits on the paged
decode kernel against the gather path within phase 2's relative L2 bound
(5e-2). For each draw named in ``--draws`` (``init``: the port's init
scales, phase 12(a)'s draw; ``uniform``: every projection and the head at
N(0, 0.02^2) as well) this computes that decode step, after the same 8
admissions, three ways:

- bf16 on the paged decode kernel (``kernel``);
- bf16 on the gather path (``gather``);
- fp32 on the gather path (``fp32``): the same bf16 weights, upcast, with
  an fp32 KV pool, fed the bf16 engine's tokens.

It prints the relative L2 and the argmax agreement of each pair. If the
kernel and the gather path stand about as far from fp32 as from each
other, their gap is bf16 rounding carried through the layers; if one sits
near fp32 and the other far from it, the far one is at fault.

Run on one CUDA card from the repo root::

    python tools/torch_qwen2_draw_witness.py [--draws init,uniform] [--seed 0]

The last line of standard output is one JSON object with every reading.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

DRAWS = {"init": None, "uniform": 0.02}  # the projections' std (None: 1/fan_in)


def _served(cfg, sd, dtype):
    """``sd`` loaded into a ``cfg`` model at ``dtype``, and an engine whose
    8 slots hold phase 12(a)'s admitted requests."""
    import torch

    from neuronx_distributed_tpu_torch import (
        InferenceConfig,
        LlamaForCausalLM,
        ParallelInferenceModel,
    )
    from neuronx_distributed_tpu_torch.convert import llama_params_from_hf
    import chip_smoke as cs

    model = LlamaForCausalLM(cfg, device="cuda")
    model.load_state_dict(llama_params_from_hf(sd, cfg))
    pim = ParallelInferenceModel(model, InferenceConfig(
        cs.SLOTS, cs.CONTEXT, cs.MAX_TOTAL, dtype), cuda_graphs=False)
    return pim, cs.admitted_engine(pim, cfg.vocab_size)


def one_draw(name: str, seed: int) -> dict:
    import torch

    from neuronx_distributed_tpu_torch import LlamaConfig
    import chip_smoke as cs

    t0 = time.perf_counter()
    cfg = LlamaConfig.qwen2_7b()
    sd = cs.p12_hf_state(cfg, seed, proj_std=DRAWS[name])
    pim, eng = _served(cfg, sd, torch.bfloat16)
    if not pim.paged_kernel:
        raise AssertionError("paged_kernel did not resolve to the kernel")
    tokens = eng._next_tok.copy()
    logits = {"kernel": cs.decode_logits(pim, eng, True),
              "gather": cs.decode_logits(pim, eng, False)}
    del pim, eng
    gc.collect()
    torch.cuda.empty_cache()

    cfg32 = LlamaConfig.qwen2_7b(dtype=torch.float32,
                                 param_dtype=torch.float32)
    pim, eng = _served(cfg32, sd, torch.float32)
    del sd
    logits["fp32"] = cs.decode_logits(pim, eng, False, tokens=tokens)
    del pim, eng
    gc.collect()
    torch.cuda.empty_cache()

    out = {"draw": name, "proj_std": DRAWS[name],
           "max_abs_logit_fp32": logits["fp32"].abs().max().item()}
    for a, b in (("kernel", "gather"), ("kernel", "fp32"),
                 ("gather", "fp32")):
        rel, agree = cs.compare_logits(logits[a], logits[b])
        out[f"{a}_vs_{b}"] = {"rel_l2": rel, "argmax_agreement": agree}
    out["seconds"] = time.perf_counter() - t0
    cs.log(f"draw_witness: {json.dumps(out)}")
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--draws", default="init,uniform")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_qwen2_draw_witness: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from neuronx_distributed_tpu_torch.ops import _build

    cs.log(f"nvidia-smi: {cs.nvidia_smi_line()}")
    _build.build_all(["paged_attention"])  # the rest build at first use
    runs = [one_draw(d, args.seed) for d in args.draws.split(",")]
    print(json.dumps({"device": cs.nvidia_smi_line(), "seed": args.seed,
                      "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
