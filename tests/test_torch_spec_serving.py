"""PyTorch port: speculative decoding against the JAX package.

On the tiny fp32 GQA pair (``torch_port_pair``, cache length 32; the
adversarial draft is the same architecture from another seed):

- ``verify_pages`` (the ``S = k + 1`` paged step) gives the JAX
  ``verify_pages``'s logits within 1e-4 over fp and int8 pools, with the
  kernel flag on (its plain version on the CPU) and off;
- the port's ``_spec_accept`` commits what the JAX ``_spec_accept`` commits
  on greedy rows; sampled rows cannot match token for token (torch Philox
  against JAX threefry streams), so they are held by invariants: a self
  draft accepts every proposal, an adversarial q is rejected at the first
  proposal, and the corrective token is drawn from ``norm(max(p - q,
  0))``;
- the speculative engine's greedy tokens equal the JAX speculative
  engine's and the plain engine's, for a self draft and an adversarial
  draft, async and sync, over fp and int8 pools, with no page held after
  the drain; a self draft accepts every proposal over an fp pool (over an
  int8 pool the draft's fp caches and the target's int8 pages disagree at
  near-ties); a sampled self draft reproduces plain sampled serving;
- ``speculative_generate`` gives the JAX function's greedy output, and
  with a self draft the sampled output of ``generate``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.serving import (
    Request as JaxRequest,
    ServingEngine as JaxServingEngine,
)
from neuronx_distributed_tpu.serving.engine import _spec_accept as jax_spec_accept
from neuronx_distributed_tpu.trace.engine import (
    speculative_generate as jax_speculative_generate,
)
from neuronx_distributed_tpu_torch.serving import (
    Request,
    SamplingParams,
    ServingEngine,
)
from neuronx_distributed_tpu_torch.serving.engine import _spec_accept
from neuronx_distributed_tpu_torch.trace import speculative_generate
from neuronx_distributed_tpu_torch.trace.engine import _filtered_logits
from torch_port_pair import C, build_pair

T_SPEC, K = 32, 3
PAGE, NUM_PAGES = 4, 40
ATOL = 1e-4


def _pairs():
    """(target pair, adversarial draft pair) at cache length 32."""
    return build_pair(3, T_SPEC, 0), build_pair(3, T_SPEC, 11)


def _prompts(vocab, n=5, seed=7):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, vocab, size=rs.randint(3, C + 1)).tolist()
            for _ in range(n)]


def _staggered(engine, make_request, prompts):
    """Three requests up front, the rest after the first step (slot and
    page reuse)."""
    outs = {}
    for i in range(3):
        engine.submit(make_request(i, prompts[i]))
    outs.update((o.request_id, o) for o in engine.step())
    for i in range(3, len(prompts)):
        engine.submit(make_request(i, prompts[i]))
    while engine.has_work:
        outs.update((o.request_id, o) for o in engine.step())
    return outs


def _greedy(i, p, cls):
    return cls(request_id=i, prompt_ids=p, max_new_tokens=4 + 2 * i)


def _assert_drained(engine):
    engine._kv.assert_invariants()
    engine.scheduler.assert_invariants()
    assert all(not pages for pages in engine._kv._slot_pages)
    assert engine._kv.leaked_pages() == 0


# -- verify_pages ----------------------------------------------------------


def _stepped(engine, prompts, cls):
    """One request per slot, admitted and decoded once (offsets C + 1, so
    a verify chunk straddles two pages)."""
    for i, p in enumerate(prompts[:3]):
        engine.submit(_greedy(i, p, cls))
    engine.step()
    return engine


@pytest.mark.parametrize("kv_quant", [None, "int8"])
@pytest.mark.parametrize("paged_kernel", [False, True])
def test_verify_pages_logits_match_jax(kv_quant, paged_kernel):
    (jpim, tpim, _, _, cfg), _ = _pairs()
    prompts = _prompts(cfg.vocab_size)
    jeng = _stepped(JaxServingEngine(
        jpim, page_size=PAGE, num_pages=NUM_PAGES, async_decode=False,
        kv_quant=kv_quant, prefix_cache=False), prompts, JaxRequest)
    teng = _stepped(ServingEngine(
        tpim, page_size=PAGE, num_pages=NUM_PAGES, kv_quant=kv_quant,
        prefix_cache=False, async_decode=False, device="cpu"), prompts,
        Request)
    np.testing.assert_array_equal(teng._kv.tables, jeng._kv.tables)
    offsets = teng._offsets.copy()
    np.testing.assert_array_equal(offsets, jeng._offsets)
    assert (offsets == C + 1).all()
    rs = np.random.RandomState(3)
    chunk = rs.randint(1, cfg.vocab_size, size=(3, K + 1)).astype(np.int32)
    jl, jcaches, _ = jpim.verify_pages(
        jnp.asarray(chunk), jnp.asarray(offsets),
        jnp.asarray(jeng._kv.tables), jeng.caches, jeng.valid,
        paged_kernel=False)
    tl, tcaches, _ = tpim.verify_pages(
        chunk, offsets, teng._kv.tables, teng.caches, teng.valid,
        paged_kernel=paged_kernel)
    assert tl.shape == (3, K + 1, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    # the pool writes agree too (int8: codes exactly, page params to fp32)
    for jentry, tentry in zip(jcaches, tcaches):
        for j, t in zip(jentry, tentry):
            np.testing.assert_allclose(t.float().numpy(),
                                       np.asarray(j, np.float32),
                                       atol=ATOL if t.dtype != torch.int8
                                       else 1, rtol=0)


# -- accept math -----------------------------------------------------------


def _port_accept(vlogits, q, props, temps, keys=None, tok_idx=None):
    B, Kp = props.shape
    keys = keys if keys is not None else [None] * B
    tok_idx = tok_idx if tok_idx is not None else [0] * B
    packed = _spec_accept(
        torch.as_tensor(vlogits, dtype=torch.float32),
        torch.as_tensor(q, dtype=torch.float32),
        torch.as_tensor(props, dtype=torch.long), keys, tok_idx, temps,
        [0] * B, [1.0] * B, torch.ones(B, dtype=torch.bool)).numpy()
    assert packed.shape == (Kp + 3, B) and packed.dtype == np.int32
    return packed[:Kp + 1], packed[Kp + 1], packed[Kp + 2]


def _jax_accept(vlogits, q, props, temps):
    B, Kp = props.shape
    packed = np.asarray(jax_spec_accept(
        jnp.asarray(vlogits, jnp.float32), jnp.asarray(q, jnp.float32),
        jnp.asarray(props, jnp.int32), jnp.zeros((B, 2), jnp.uint32),
        jnp.zeros((B,), jnp.int32), jnp.asarray(temps, jnp.float32),
        jnp.zeros((B,), jnp.int32), jnp.ones((B,), jnp.float32),
        jnp.ones((B,), bool)))
    return packed[:Kp + 1], packed[Kp + 1], packed[Kp + 2]


def _same_commits(port, jax_):
    """Equal accept counts and finite flags, and equal commit rows up to
    each slot's extra token (rows past it are garbage in both)."""
    (pc, pa, pf), (jc, ja, jf) = port, jax_
    np.testing.assert_array_equal(pa, ja)
    np.testing.assert_array_equal(pf, jf)
    for b, a in enumerate(pa):
        np.testing.assert_array_equal(pc[:a + 1, b], jc[:a + 1, b])


def test_accept_greedy_agreement_and_corrective_matches_jax():
    """The JAX test's case: accept while the target argmax agrees, the
    target's own token at the first disagreement, the bonus on a full
    accept."""
    V = 7
    vlogits = np.full((1, K + 1, V), -10.0, np.float32)
    for s, t in enumerate([2, 5, 1, 4]):
        vlogits[0, s, t] = 10.0
    q = np.zeros((1, K, V), np.float32)
    for props, want_a, want in (([[2, 3, 1]], 1, [2, 5]),
                                ([[2, 5, 1]], K, [2, 5, 1, 4]),
                                ([[0, 5, 1]], 0, [2])):
        props = np.array(props, np.int64)
        port = _port_accept(vlogits, q, props, [0.0])
        _same_commits(port, _jax_accept(vlogits, q, props, [0.0]))
        assert int(port[1][0]) == want_a
        assert port[0][:want_a + 1, 0].tolist() == want


def test_accept_greedy_random_rows_match_jax():
    """Random greedy rounds over 6 slots, proposals agreeing with the
    target for a random prefix, a non-finite row among them."""
    rs = np.random.RandomState(0)
    B, V = 6, 11
    vlogits = rs.randn(B, K + 1, V).astype(np.float32)
    tgt = vlogits.argmax(-1)
    props = rs.randint(0, V, size=(B, K))
    for b in range(B):
        n = b % (K + 1)
        props[b, :n] = tgt[b, :n]
    vlogits[4, 1, 3] = np.nan
    q = rs.randn(B, K, V).astype(np.float32)
    port = _port_accept(vlogits, q, props, [0.0] * B)
    _same_commits(port, _jax_accept(vlogits, q, props, [0.0] * B))
    assert port[2].tolist() == [1, 1, 1, 1, 0, 1]


def test_accept_sampled_self_draft_accepts_all():
    """q == p (the filtered draft distribution IS the target's): every
    coin accepts, and the bonus comes from the plain token-index stream."""
    rs = np.random.RandomState(0)
    B, V = 2, 11
    temps = [0.8, 1.3]
    vlogits = rs.randn(B, K + 1, V).astype(np.float32)
    q = torch.stack([_filtered_logits(torch.from_numpy(vlogits[b, :K]),
                                      temps[b]) for b in range(B)])
    props = rs.randint(0, V, size=(B, K))
    _, acc, finite = _port_accept(vlogits, q, props, temps, keys=[5, 6],
                                  tok_idx=[0, 4])
    assert acc.tolist() == [K, K] and finite.tolist() == [1, 1]


def test_accept_sampled_adversarial_rejects_and_resamples_residual():
    """A draft that puts its mass where the target has ~none is rejected at
    the first proposal, and the corrective token is the residual's."""
    V, Kp = 8, 2
    vlogits = np.full((1, Kp + 1, V), -12.0, np.float32)
    vlogits[0, :, 4] = 12.0
    q = np.full((1, Kp, V), -12.0, np.float32)
    q[0, :, 1] = 12.0
    commit, acc, _ = _port_accept(vlogits, q, np.array([[1, 1]]), [1.0],
                                  keys=[3])
    assert int(acc[0]) == 0 and int(commit[0, 0]) == 4


def test_accept_sampled_corrective_follows_residual():
    """p = (.5, .3, .2, 0), q = (.1, .1, .8, 0), proposal 2: accepted with
    probability p/q = 1/4; a rejection draws from norm(max(p - q, 0)) =
    (2/3, 1/3, 0, 0).  Over 400 slots (400 request streams) both rates
    fall inside 5 standard errors."""
    n = 400
    lp = np.log(np.array([0.5, 0.3, 0.2, 1e-30], np.float32))
    lq = np.log(np.array([0.1, 0.1, 0.8, 1e-30], np.float32))
    vlogits = np.broadcast_to(lp, (n, 2, 4)).copy()
    q = np.broadcast_to(lq, (n, 1, 4)).copy()
    commit, acc, _ = _port_accept(vlogits, q, np.full((n, 1), 2), [1.0] * n,
                                  keys=list(range(100, 100 + n)))
    rejected = acc == 0
    rate = rejected.mean()
    assert abs(rate - 0.75) < 5 * np.sqrt(0.75 * 0.25 / n)
    corr = commit[0, rejected]
    assert set(corr.tolist()) <= {0, 1}
    share0 = (corr == 0).mean()
    m = rejected.sum()
    assert abs(share0 - 2 / 3) < 5 * np.sqrt(2 / 9 / m)
    assert (commit[0, ~rejected] == 2).all()


# -- the speculative engine ------------------------------------------------

_JAX_RUNS: dict = {}


def _jax_tokens(kv_quant, draft):
    key = (kv_quant, draft)
    if key not in _JAX_RUNS:
        (jpim, _, _, _, cfg), (jdraft, _, _, _, _) = _pairs()
        kw = ({} if draft is None else
              dict(draft=jpim if draft == "self" else jdraft, spec_k=K))
        engine = JaxServingEngine(jpim, page_size=PAGE, num_pages=NUM_PAGES,
                                  async_decode=False, kv_quant=kv_quant, **kw)
        outs = _staggered(engine, lambda i, p: _greedy(i, p, JaxRequest),
                          _prompts(cfg.vocab_size))
        _JAX_RUNS[key] = {i: list(o.token_ids) for i, o in outs.items()}
    return _JAX_RUNS[key]


@pytest.mark.parametrize("kv_quant", [None, "int8"])
@pytest.mark.parametrize("async_decode", [True, False])
@pytest.mark.parametrize("draft", ["self", "other"])
def test_spec_greedy_tokens_identical_to_jax_and_plain(draft, async_decode,
                                                       kv_quant):
    (_, tpim, _, _, cfg), (_, tdraft, _, _, _) = _pairs()
    engine = ServingEngine(tpim, page_size=PAGE, num_pages=NUM_PAGES,
                           kv_quant=kv_quant, async_decode=async_decode,
                           draft=tpim if draft == "self" else tdraft,
                           spec_k=K, device="cpu")
    streamed = {}

    def make(i, p):
        r = _greedy(i, p, Request)
        r.stream_cb = lambda req, t: streamed.setdefault(
            req.request_id, []).append(t)
        return r

    outs = _staggered(engine, make, _prompts(cfg.vocab_size))
    got = {i: list(o.token_ids) for i, o in outs.items()}
    assert got == _jax_tokens(kv_quant, draft)
    assert got == _jax_tokens(kv_quant, None)  # the plain engine's
    assert streamed == got
    assert all(o.finish_reason == "length" and o.spec_proposed > 0
               for o in outs.values())
    assert engine.spec_rounds > 0 and engine.decode_steps == 0
    assert sum(o.spec_proposed for o in outs.values()) \
        == engine.spec_proposed
    if draft == "self" and kv_quant is None:
        assert engine.spec_accepted == engine.spec_proposed
        assert all(o.acceptance_rate == 1.0 for o in outs.values())
        assert engine.spec_committed > engine.spec_rounds
    elif draft == "self":
        # the draft's contiguous caches hold fp keys, the target's pool
        # int8 ones: the two disagree at the odd near-tie
        assert engine.spec_accepted >= 0.8 * engine.spec_proposed
    else:
        assert engine.spec_accepted < engine.spec_proposed
    _assert_drained(engine)


def test_spec_sampled_self_draft_bit_identical_to_plain_sampling():
    """draft == target under sampling: every proposal accepted, and the
    output is plain sampled serving's (mixed greedy and sampled rows)."""
    (_, tpim, _, _, cfg), _ = _pairs()
    temps = [0.9, 0.0, 0.7, 1.1, 0.8]

    def make(i, p):
        return Request(request_id=i, prompt_ids=p, max_new_tokens=4 + 2 * i,
                       sampling=SamplingParams(temperature=temps[i],
                                               top_k=5 if i == 2 else 0))

    def run(**kw):
        engine = ServingEngine(tpim, page_size=PAGE, num_pages=NUM_PAGES,
                               seed=42, device="cpu", **kw)
        outs = _staggered(engine, make, _prompts(cfg.vocab_size, seed=5))
        return engine, {i: list(o.token_ids) for i, o in outs.items()}

    _, plain = run()
    engine, spec = run(draft=tpim, spec_k=K)
    assert spec == plain
    assert engine.spec_accepted == engine.spec_proposed
    _assert_drained(engine)


def test_spec_sampled_adversarial_draft_rolls_back_without_leaks():
    (_, tpim, _, _, cfg), (_, tdraft, _, _, _) = _pairs()
    engine = ServingEngine(tpim, page_size=PAGE, num_pages=NUM_PAGES,
                           seed=1, draft=tdraft, spec_k=K, device="cpu")
    outs = _staggered(engine, lambda i, p: Request(
        request_id=i, prompt_ids=p, max_new_tokens=4 + 2 * i,
        sampling=SamplingParams(temperature=1.0)),
        _prompts(cfg.vocab_size, seed=9))
    assert all(o.state == "finished" for o in outs.values())
    assert engine.spec_accepted < engine.spec_proposed
    _assert_drained(engine)


def test_spec_stop_token_inside_accepted_run():
    """A stop token inside an accepted run ends the request there, as the
    plain engine does."""
    (_, tpim, _, _, _), _ = _pairs()
    prompt = [3, 1, 4, 1, 5]

    def run(eos, **kw):
        engine = ServingEngine(tpim, page_size=PAGE, num_pages=NUM_PAGES,
                               eos_token_id=eos, device="cpu", **kw)
        engine.submit(Request(request_id=0, prompt_ids=prompt,
                              max_new_tokens=8))
        [out] = engine.run_until_complete(max_steps=50)
        return engine, out

    _, full = run(None)
    eos = full.token_ids[2]
    _, plain = run(eos)
    engine, spec = run(eos, draft=tpim, spec_k=K)
    assert spec.token_ids == plain.token_ids == full.token_ids[:3]
    assert spec.finish_reason == "stop_token"
    _assert_drained(engine)


def test_spec_option_errors():
    (_, tpim, _, _, _), (_, tdraft, _, _, _) = _pairs()
    _, short, _, _, _ = build_pair(3)  # cache length 16
    kw = dict(page_size=PAGE, num_pages=NUM_PAGES, device="cpu")
    with pytest.raises(ValueError, match="BOTH draft"):
        ServingEngine(tpim, draft=tpim, **kw)
    with pytest.raises(ValueError, match="BOTH draft"):
        ServingEngine(tpim, spec_k=2, **kw)
    with pytest.raises(ValueError, match="spec_k must be"):
        ServingEngine(tpim, draft=tpim, spec_k=-1, **kw)
    with pytest.raises(ValueError, match="max_total_len"):
        ServingEngine(tpim, draft=short, spec_k=2, **kw)
    from neuronx_distributed_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaForCausalLM,
    )
    from neuronx_distributed_tpu_torch.trace import (
        InferenceConfig,
        ParallelInferenceModel,
    )

    other_vocab = ParallelInferenceModel(
        LlamaForCausalLM(LlamaConfig.tiny(num_kv_heads=2, vocab_size=300,
                                          dtype=torch.float32),
                         device="cpu").init_random(0),
        InferenceConfig(3, C, T_SPEC, torch.float32), device="cpu")
    with pytest.raises(ValueError, match="vocab_size differ"):
        ServingEngine(tpim, draft=other_vocab, spec_k=2, **kw)
    with pytest.raises(ValueError, match="vocab_size differ"):
        speculative_generate(tpim, other_vocab, np.ones((3, C)), 4)
    engine = ServingEngine(tpim, draft=tpim, spec_k=K, **kw)
    from neuronx_distributed_tpu_torch.serving import AdmissionError

    with pytest.raises(AdmissionError, match="spec reserve"):
        engine.submit(Request(request_id=0, prompt_ids=[1, 2],
                              max_new_tokens=T_SPEC - C - K + 1))


# -- solo speculative_generate ---------------------------------------------


def _left_padded(prompts):
    ids = np.zeros((3, C), np.int32)
    lens = []
    for b, p in enumerate(prompts[:3]):
        ids[b, C - len(p):] = p
        lens.append(len(p))
    return ids, np.array(lens, np.int32)


@pytest.mark.parametrize("draft", ["self", "other"])
def test_speculative_generate_greedy_matches_jax(draft):
    (jpim, tpim, _, _, cfg), (jdraft, tdraft, _, _, _) = _pairs()
    ids, lens = _left_padded(_prompts(cfg.vocab_size))
    want = np.asarray(jax_speculative_generate(
        jpim, jpim if draft == "self" else jdraft, jnp.asarray(ids), 12,
        k=K, prompt_lens=jnp.asarray(lens)))
    got, stats = speculative_generate(
        tpim, tpim if draft == "self" else tdraft, ids, 12, k=K,
        prompt_lens=lens, return_stats=True)
    np.testing.assert_array_equal(got.numpy(), want)
    plain = tpim.generate(ids, 12, prompt_lens=lens)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    if draft == "self":
        assert stats["acceptance_rate"] == 1.0
    else:
        assert stats["accepted"] < stats["proposed"]


def test_speculative_generate_sampled_self_draft_is_generate():
    (_, tpim, _, _, cfg), (_, tdraft, _, _, _) = _pairs()
    ids, lens = _left_padded(_prompts(cfg.vocab_size))
    kw = dict(temperature=0.9, top_k=6, seed=3, request_ids=[7, 8, 9],
              prompt_lens=lens)
    got = speculative_generate(tpim, tpim, ids, 12, k=K, **kw)
    want = tpim.generate(ids, 12, **kw)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    adv = speculative_generate(tpim, tdraft, ids, 12, k=K, **kw)
    assert adv.shape == want.shape
    with pytest.raises(ValueError, match="seed"):
        speculative_generate(tpim, tpim, ids, 4, temperature=1.0)
    with pytest.raises(ValueError, match="k must be"):
        speculative_generate(tpim, tpim, ids, 4, k=0)
    with pytest.raises(ValueError, match="exceeds"):
        speculative_generate(tpim, tpim, ids, T_SPEC)
