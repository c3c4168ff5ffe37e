"""PyTorch port: the serving slice as a whole against the JAX package.

The port's ``ServingEngine`` (paged, page_size 4, staggered arrivals, slot
and page reuse) must produce greedy tokens identical to the JAX
``ServingEngine`` on the same requests and weights, on both the kernel-flag
path and the gather path, and end with zero leaked pages.  Sampled output
is checked within the port only (JAX threefry and torch Philox streams
cannot match): a request's tokens must not depend on its co-batch.
"""

import numpy as np
import pytest

from neuronx_distributed_tpu.serving import (
    Request as JaxRequest,
    ServingEngine as JaxServingEngine,
)
from neuronx_distributed_tpu_torch.serving import (
    AdmissionError,
    BackpressureError,
    Request,
    SamplingParams,
    ServingEngine,
    poisson_arrivals,
    replay,
    summarize_outputs,
)
from torch_port_pair import C, build_pair

PAGE, NUM_PAGES = 4, 16


def _prompts(vocab, n=7, seed=7):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, vocab, size=rs.randint(2, C + 1)).tolist()
            for _ in range(n)] + [[3, 1, 4, 1, 5]] * 2  # a repeated prompt


def _staggered(engine, make_request, prompts):
    """Three requests up front, then one more per step: slots and pages
    turn over while others decode."""
    outs = {}
    for i in range(3):
        engine.submit(make_request(i, prompts[i]))
    for i in range(3, len(prompts)):
        for o in engine.step():
            outs[o.request_id] = o
        engine.submit(make_request(i, prompts[i]))
    for o in engine.run_until_complete(max_steps=400):
        outs[o.request_id] = o
    return {i: list(o.token_ids) for i, o in outs.items()}


_JAX_RUNS: dict = {}


def _jax_tokens(prefix_cache):
    if prefix_cache not in _JAX_RUNS:
        jpim, _, _, _, cfg = build_pair()
        engine = JaxServingEngine(jpim, page_size=PAGE, num_pages=NUM_PAGES,
                                  async_decode=False,
                                  prefix_cache=prefix_cache)
        _JAX_RUNS[prefix_cache] = _staggered(
            engine, lambda i, p: JaxRequest(request_id=i, prompt_ids=p,
                                            max_new_tokens=3 + i % 4),
            _prompts(cfg.vocab_size))
    return _JAX_RUNS[prefix_cache]


@pytest.mark.parametrize("prefix_cache", [True, False])
@pytest.mark.parametrize("paged_kernel", [False, True])
def test_greedy_tokens_identical_to_jax_engine(paged_kernel, prefix_cache):
    _, tpim, _, _, cfg = build_pair()
    engine = ServingEngine(tpim, page_size=PAGE, num_pages=NUM_PAGES,
                           paged_kernel=paged_kernel,
                           prefix_cache=prefix_cache, device="cpu")
    got = _staggered(
        engine, lambda i, p: Request(request_id=i, prompt_ids=p,
                                     max_new_tokens=3 + i % 4),
        _prompts(cfg.vocab_size))
    assert got == _jax_tokens(prefix_cache)
    kv = engine._kv
    kv.assert_invariants()
    engine.scheduler.assert_invariants()
    assert kv.leaked_pages() == 0
    if prefix_cache:
        assert kv.prefill_skipped >= 1  # the repeated prompt skipped prefill


def test_greedy_equals_solo_generate():
    _, tpim, _, _, cfg = build_pair()
    prompts = _prompts(cfg.vocab_size)[:3]
    engine = ServingEngine(tpim, page_size=PAGE, device="cpu")
    for i, p in enumerate(prompts):
        engine.submit(Request(request_id=i, prompt_ids=p, max_new_tokens=5))
    outs = {o.request_id: list(o.token_ids)
            for o in engine.run_until_complete(max_steps=100)}
    for i, p in enumerate(prompts):
        ids = np.zeros((3, C), np.int64)
        ids[:, C - len(p):] = p
        solo = tpim.generate(ids, 5, prompt_lens=[len(p)] * 3)
        assert outs[i] == solo[0, C:].tolist()


def test_sampled_output_independent_of_co_batch():
    _, tpim, _, _, cfg = build_pair()
    prompts = _prompts(cfg.vocab_size, seed=11)
    sampling = SamplingParams(temperature=0.9, top_k=20, top_p=0.95)

    def run(rids, seed=42):
        engine = ServingEngine(tpim, page_size=PAGE, seed=seed, device="cpu")
        for rid in rids:
            engine.submit(Request(request_id=rid, prompt_ids=prompts[rid],
                                  max_new_tokens=6, sampling=sampling))
        return {o.request_id: list(o.token_ids)
                for o in engine.run_until_complete(max_steps=200)}

    alone = run([2])
    crowded = run([0, 2, 4, 5])
    assert crowded[2] == alone[2]
    assert run([2], seed=43)[2] != alone[2] or run([2], seed=44)[2] != alone[2]


def test_stop_tokens_cancel_timeout_and_admission():
    _, tpim, _, _, cfg = build_pair()
    t = [0.0]
    engine = ServingEngine(tpim, page_size=PAGE, device="cpu",
                           clock=lambda: t[0], eos_token_id=None)
    p = [3, 1, 4, 1, 5]
    first = tpim.generate(np.array([[0, 0, 0] + p] * 3), 1,
                          prompt_lens=[5] * 3)[0, C].item()
    engine.submit(Request(request_id=0, prompt_ids=p, max_new_tokens=6,
                          stop_token_ids=(first,)))
    engine.submit(Request(request_id=1, prompt_ids=p, max_new_tokens=6))
    engine.submit(Request(request_id=2, prompt_ids=p, max_new_tokens=6,
                          deadline_s=0.5))
    engine.submit(Request(request_id=3, prompt_ids=p, max_new_tokens=6))
    outs = {o.request_id: o for o in engine.step()}
    assert outs[0].finish_reason == "stop_token" and outs[0].token_ids == (first,)
    assert engine.cancel(1)
    t[0] = 1.0
    outs.update({o.request_id: o for o in engine.run_until_complete(50)})
    assert outs[1].state == "cancelled" and outs[2].state == "timed_out"
    assert outs[3].state == "finished" and len(outs[3].token_ids) == 6
    engine._kv.assert_invariants()
    with pytest.raises(AdmissionError, match="context_len"):
        engine.submit(Request(request_id=9, prompt_ids=[1] * (C + 1),
                              max_new_tokens=1))
    with pytest.raises(ValueError, match="seed"):
        engine.submit(Request(request_id=10, prompt_ids=p, max_new_tokens=2,
                              sampling=SamplingParams(temperature=1.0)))
    small = ServingEngine(tpim, page_size=PAGE, device="cpu", max_queue=1)
    for i in range(4):
        small.submit(Request(request_id=i, prompt_ids=p, max_new_tokens=2))
    with pytest.raises(BackpressureError):
        small.submit(Request(request_id=4, prompt_ids=p, max_new_tokens=2))


def test_replay_driver_serves_everything():
    _, tpim, _, _, cfg = build_pair()
    prompts = _prompts(cfg.vocab_size)
    engine = ServingEngine(tpim, page_size=PAGE, device="cpu")
    reqs = [Request(request_id=i, prompt_ids=p, max_new_tokens=3)
            for i, p in enumerate(prompts)]
    arrivals = poisson_arrivals(len(reqs), float("inf"),
                                np.random.RandomState(0))
    assert not arrivals.any()  # an infinite rate is a burst at t = 0
    outs = replay(engine, arrivals, reqs)
    summary = summarize_outputs(outs, wall_s=1.0)
    assert summary["requests"] == summary["finished"] == len(reqs)
    assert summary["tokens"] == 3 * len(reqs)
