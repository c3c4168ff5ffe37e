"""PyTorch port: Gemma-2 training steps and serving against the JAX package.

Training: a tiny Gemma-2 (one sliding and one global layer, S = 32 over a
16-token window) is initialised by the JAX trainer (tp = 1 on one CPU
device) and moved into the port with ``convert.gemma2_params_from_jax``;
both ``make_train_step``s take the same seeded batch through the chunked
loss head (the final softcap inside ``head``).  The port runs the flash
core under ``remat="selective"``, JAX the dense core.  Losses and gradient
norms agree to 1e-5 relative over 4 steps, parameters to a tenth of the
learning rate (AdamW amplifies the rounding of near-zero gradients, see
``tests/test_torch_train.py``), nearly all elements to 2e-6.

Serving: greedy tokens of the port's paged ``ServingEngine`` over the same
tiny Gemma-2 (bf16 nowhere: fp32 weights and pool) equal the JAX engine's
(``async_decode=False``) under staggered arrivals, with the paged-kernel
flag on (the kernel's plain version on the CPU) and off (the gather path),
with zero leaked pages.  Prompts and outputs run past the 16-token window.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

import neuronx_distributed_tpu as nxd
from neuronx_distributed_tpu.models.common import (
    make_causal_lm_loss_sum as jax_make_causal_lm_loss_sum,
)
from neuronx_distributed_tpu.models.gemma import (
    Gemma2Config as JaxGemma2Config,
    Gemma2ForCausalLM as JaxGemma2,
)
from neuronx_distributed_tpu.parallel import mesh as mesh_lib
from neuronx_distributed_tpu.serving import (
    Request as JaxRequest,
    ServingEngine as JaxServingEngine,
)
from neuronx_distributed_tpu.trace import (
    InferenceConfig as JaxInferenceConfig,
    ParallelInferenceModel as JaxInferenceModel,
)
from neuronx_distributed_tpu.trainer import (
    initialize_parallel_model as jax_init_model,
    initialize_parallel_optimizer as jax_init_opt,
    make_train_step as jax_make_train_step,
)
from neuronx_distributed_tpu_torch.config import training_config
from neuronx_distributed_tpu_torch.convert import gemma2_params_from_jax
from neuronx_distributed_tpu_torch.models.common import make_causal_lm_loss_sum
from neuronx_distributed_tpu_torch.models.gemma import (
    Gemma2Config,
    Gemma2ForCausalLM,
)
from neuronx_distributed_tpu_torch.serving import Request, ServingEngine
from neuronx_distributed_tpu_torch.trace import (
    InferenceConfig,
    ParallelInferenceModel,
)
from neuronx_distributed_tpu_torch.trainer import (
    initialize_parallel_model,
    initialize_parallel_optimizer,
    make_train_step,
)

B, S, STEPS, LR = 2, 32, 4, 1e-3
SLOTS, C, T, PAGE, NUM_PAGES = 3, 16, 32, 4, 32


def _jax_cfg():
    return JaxGemma2Config.tiny(dtype=jnp.float32, param_dtype=jnp.float32,
                                sequence_parallel=False, remat="none",
                                max_seq_len=T)


def test_train_steps_match_jax():
    mesh_lib.initialize_model_parallel(tensor_parallel_size=1,
                                       devices=jax.devices()[:1])
    jconfig = nxd.training_config(tensor_parallel_size=1, seed=0,
                                  param_dtype="float32",
                                  compute_dtype="float32", learning_rate=LR)
    jmodel = jax_init_model(jconfig, lambda: JaxGemma2(_jax_cfg()),
                            (jnp.zeros((1, S), jnp.int32),))
    params = jax.tree.map(np.asarray, jmodel.params)  # before donation
    config = training_config(seed=0, compute_dtype="float32",
                             learning_rate=LR)
    cfg = Gemma2Config.tiny(dtype=torch.float32, param_dtype=torch.float32,
                            attention_impl="flash", remat="selective")
    model = initialize_parallel_model(
        config, lambda d: Gemma2ForCausalLM(cfg, device=d), device="cpu")
    model.module.load_state_dict(gemma2_params_from_jax(params, cfg))

    # one batch, four steps: the loss must fall
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, size=(B, S))
    data = [{"ids": ids.astype(np.int32),
             "labels": np.roll(ids, -1, axis=1).astype(np.int32)}] * STEPS
    jopt = jax_init_opt(jconfig, jmodel)
    jstep = jax_make_train_step(jconfig, jmodel, jopt,
                                jax_make_causal_lm_loss_sum(8))
    pstep = make_train_step(config, model,
                            initialize_parallel_optimizer(config, model),
                            make_causal_lm_loss_sum(8))
    jp, jopt_state = jmodel.params, jopt.state
    jm, pm, snaps = [], [], {}
    for i, b in enumerate(data, 1):
        jp, jopt_state, m = jstep(jp, jopt_state,
                                  {k: jnp.asarray(v) for k, v in b.items()},
                                  None)
        jm.append((float(m["loss"]), float(m["grad_norm"])))
        out = pstep(b)
        pm.append((out["loss"].item(), out["grad_norm"].item()))
        if i in (1, STEPS):
            flat = {".".join(str(getattr(k, "key", k)) for k in path):
                    np.asarray(v) for path, v in
                    jax.tree_util.tree_flatten_with_path(jp["params"])[0]}
            snaps[i] = (flat, {k: v.detach().numpy().copy() for k, v in
                               model.module.state_dict().items()})
    np.testing.assert_allclose(np.array(pm), np.array(jm), rtol=1e-5, atol=0)
    assert pm[-1][0] < pm[0][0]
    for i, (want, got) in snaps.items():
        assert set(want) == set(got)
        for name, w in want.items():
            np.testing.assert_allclose(got[name], w, atol=0.1 * LR, rtol=0,
                                       err_msg=f"{name} after {i}")
            close = np.abs(got[name] - w) <= 2e-6
            assert close.mean() >= 0.999, (name, i, close.mean())


_PAIR: dict = {}


def _serving_pair():
    """JAX and port inference models over the same tiny Gemma-2 weights."""
    if not _PAIR:
        module = JaxGemma2(_jax_cfg())
        params = nn.unbox(module.init(jax.random.PRNGKey(3),
                                      jnp.zeros((SLOTS, C), jnp.int32)))
        jpim = JaxInferenceModel(module, params, JaxInferenceConfig(
            batch_size=SLOTS, context_len=C, max_total_len=T,
            kv_cache_dtype=jnp.float32))
        cfg = Gemma2Config.tiny(dtype=torch.float32, max_seq_len=T)
        model = Gemma2ForCausalLM(cfg, device="cpu")
        model.load_state_dict(gemma2_params_from_jax(
            jax.tree.map(np.asarray, params), cfg))
        tpim = ParallelInferenceModel(
            model, InferenceConfig(SLOTS, C, T, torch.float32), device="cpu")
        _PAIR.update(jax=jpim, port=tpim, vocab=cfg.vocab_size)
    return _PAIR


def _prompts(vocab, n=6, seed=11):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, vocab, size=rs.randint(3, C + 1)).tolist()
            for _ in range(n)]


def _staggered(engine, make_request, prompts):
    outs = {}
    for i in range(2):
        engine.submit(make_request(i, prompts[i]))
    for i in range(2, len(prompts)):
        for o in engine.step():
            outs[o.request_id] = o
        engine.submit(make_request(i, prompts[i]))
    for o in engine.run_until_complete(max_steps=400):
        outs[o.request_id] = o
    return {i: list(o.token_ids) for i, o in outs.items()}


def _new_tokens(i):
    return 6 + 3 * (i % 3)  # up to 12: C + 12 > the 16-token window


_JAX_TOKENS: dict = {}


@pytest.mark.parametrize("paged_kernel", [False, True])
def test_greedy_tokens_identical_to_jax_engine(paged_kernel):
    pair = _serving_pair()
    prompts = _prompts(pair["vocab"])
    if not _JAX_TOKENS:
        engine = JaxServingEngine(pair["jax"], page_size=PAGE,
                                  num_pages=NUM_PAGES, async_decode=False)
        _JAX_TOKENS.update(_staggered(
            engine, lambda i, p: JaxRequest(request_id=i, prompt_ids=p,
                                            max_new_tokens=_new_tokens(i)),
            prompts))
    engine = ServingEngine(pair["port"], page_size=PAGE, num_pages=NUM_PAGES,
                           paged_kernel=paged_kernel, device="cpu")
    got = _staggered(
        engine, lambda i, p: Request(request_id=i, prompt_ids=p,
                                     max_new_tokens=_new_tokens(i)),
        prompts)
    assert got == _JAX_TOKENS
    assert max(len(p) + _new_tokens(i) for i, p in enumerate(prompts)) > 16
    engine._kv.assert_invariants()
    assert engine._kv.leaked_pages() == 0
