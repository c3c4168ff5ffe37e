"""How far Llama-3-8B's bf16 greedy streams at tensor-parallel degree 2
follow tp = 1's, over several weight seeds, beside a reorder at tp = 1.

For each seed the PyTorch port serves ``chip_smoke.py``'s phase-2 traffic
(16 greedy requests of 32-512 prompt tokens, 64 new tokens, staggered; 8
slots, page 16) on Llama-3-8B at full width and depth with random bf16
weights from the seed, three ways:

- tp = 1 on the paged decode kernel (phase 2's engine, the reference);
- tp = 1 on the gather path (the same model, attention summed in another
  order: a reorder alone);
- tp = 2, two processes sharing the card over gloo (phase 2i's engine).

It prints, for the gather path and for tp = 2 against the reference, the
greedy streams' common-prefix share (``chip_smoke.prefix_share``) and one
decode step's logits after the same 8 admissions (relative L2 and the
share of rows whose argmax agrees): on each engine's own first tokens,
and at tp = 2 also on the reference's first tokens (teacher-forced, so a
first token that flips at a bf16 near-tie does not change the step's
input).  These readings set phase 2i(c)'s bounds in ``chip_smoke.py``.

Run on one CUDA card from the repo root::

    python tools/torch_tp_divergence.py [--seeds 0,1,2]

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

TP = 2


def _model(seed: int):
    import torch

    from neuronx_distributed_tpu_torch import (
        InferenceConfig,
        LlamaConfig,
        LlamaForCausalLM,
        ParallelInferenceModel,
    )
    import chip_smoke as cs

    model = LlamaForCausalLM(LlamaConfig.llama3_8b(),
                             device="cuda").init_random(seed)
    return ParallelInferenceModel(model, InferenceConfig(
        cs.SLOTS, cs.CONTEXT, cs.MAX_TOTAL, torch.bfloat16),
        cuda_graphs=False)


def tp2_rank(seed: int, forced) -> dict:
    """One rank of the tp = 2 world: phase 2i's engine on phase 2's
    traffic, then one decode step after the 8 admissions, on its own first
    tokens and on ``forced`` (tp = 1's)."""
    import torch

    from neuronx_distributed_tpu_torch import ServingEngine
    from neuronx_distributed_tpu_torch.parallel import mesh
    from neuronx_distributed_tpu_torch.utils.distributed import (
        initialize_distributed,
    )
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    initialize_distributed(device="cuda", backend="gloo", timeout_s=300)
    mesh.initialize_model_parallel(tensor_parallel_size=TP)
    pim = _model(seed)
    vocab = pim.module.config.vocab_size
    engine = ServingEngine(pim, page_size=cs.PAGE_SIZE)
    outs = cs.tp_serve(engine, cs.make_requests(
        vocab, cs.N_REQUESTS, cs.NEW_TOKENS, seed), [])
    engine.close()
    eng = cs.admitted_engine(pim, vocab, seed=seed + 1)
    logits = cs.decode_logits(pim, eng, True).cpu().numpy()
    forced_logits = cs.decode_logits(pim, eng, True, forced).cpu().numpy()
    first = eng._next_tok.copy()
    eng.close()
    return {"tokens": {rid: list(o.token_ids) for rid, o in outs.items()},
            "decode_logits": logits, "forced_logits": forced_logits,
            "first": first}


def one_seed(seed: int) -> dict:
    import torch

    from neuronx_distributed_tpu_torch import ServingEngine
    from neuronx_distributed_tpu_torch.utils.distributed import spawn
    import chip_smoke as cs

    t0 = time.perf_counter()
    pim = _model(seed)
    vocab = pim.module.config.vocab_size
    streams = {}
    for label, kernel in (("kernel", True), ("gather", False)):
        outs = cs.serve(ServingEngine(pim, page_size=cs.PAGE_SIZE,
                                      async_decode=False,
                                      paged_kernel=kernel),
                        cs.make_requests(vocab, cs.N_REQUESTS,
                                         cs.NEW_TOKENS, seed))
        streams[label] = {rid: list(o.token_ids) for rid, o in outs.items()}
    eng = cs.admitted_engine(pim, vocab, seed=seed + 1)
    logits = {label: cs.decode_logits(pim, eng, kernel).cpu()
              for label, kernel in (("kernel", True), ("gather", False))}
    first = eng._next_tok.copy()
    eng.close()
    del eng, pim
    gc.collect()
    torch.cuda.empty_cache()
    ranks = spawn(tp2_rank, TP, (seed, first), timeout_s=600)
    if ranks[0]["tokens"] != ranks[1]["tokens"]:
        raise AssertionError(f"seed {seed}: the tp = 2 ranks disagree")
    streams["tp2"] = ranks[0]["tokens"]
    logits["tp2"] = torch.from_numpy(ranks[0]["decode_logits"])
    ref = streams["kernel"]
    out = {"seed": seed}
    for label in ("gather", "tp2"):
        rel, agree = cs.compare_logits(logits[label], logits["kernel"])
        out[label] = {
            "prefix_share": cs.prefix_share(streams[label], ref),
            "first_equal": sum(streams[label][r][0] == ref[r][0]
                               for r in ref),
            "decode_rel_l2": rel, "decode_argmax_agree": agree}
    rel, agree = cs.compare_logits(
        torch.from_numpy(ranks[0]["forced_logits"]), logits["kernel"])
    out["tp2"].update(
        admitted_first_equal=int((ranks[0]["first"] == first).sum()),
        forced_decode_rel_l2=rel, forced_decode_argmax_agree=agree)
    out["seconds"] = time.perf_counter() - t0
    cs.log(f"tp_divergence: {json.dumps(out)}")
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="0,1,2")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_tp_divergence: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from neuronx_distributed_tpu_torch.ops import _build

    cs.log(f"nvidia-smi: {cs.nvidia_smi_line()}")
    _build.build_all()
    runs = [one_seed(int(s)) for s in args.seeds.split(",")]
    summary = {}
    for label in ("gather", "tp2"):
        shares = [r[label]["prefix_share"] for r in runs]
        rels = [r[label]["decode_rel_l2"] for r in runs]
        summary[label] = {"prefix_share_min": min(shares),
                          "prefix_share_max": max(shares),
                          "decode_rel_l2_max": max(rels)}
    summary["tp2"]["forced_decode_rel_l2_max"] = max(
        r["tp2"]["forced_decode_rel_l2"] for r in runs)
    result = {"device": cs.nvidia_smi_line(), "runs": runs,
              "summary": summary}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
