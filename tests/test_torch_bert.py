"""PyTorch port: BERT pretraining, LayerNorm and dropout under an explicit
generator, against the JAX package.

JAX ``BertForPreTraining`` (tiny, fp32) initialises the weights;
``convert.bert_params_from_jax`` moves them into the port.  Seeded numpy
ids, token types and a padding mask go through both forwards.
Tolerances, fp32 on both sides: MLM and NSP logits 2e-5 absolute;
``pretraining_loss`` 1e-5 relative; padding isolation 1e-5 (JAX's);
remat against no remat 1e-5 in the loss and 1e-4 in the gradient norm
(JAX's), and the port against itself 1e-6; LayerNorm 1e-6 in fp32 and one
bf16 step at BERT's eps 1e-12; the tp = 2 world's gathered logits 5e-4
(JAX's dense-vs-tp8 tolerance).  Dropout streams cannot match threefry,
so dropout is held by invariants: the same generator seed gives the same
loss and gradients (with and without remat), another seed another loss,
no generator the dropout-free model's loss, and a mask keeps 1 - rate of
the elements, scaled by 1 / (1 - rate).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from neuronx_distributed_tpu.models.bert import (
    BertConfig as JaxConfig,
    BertForPreTraining as JaxBert,
    pretraining_loss as jax_pretraining_loss,
)
from neuronx_distributed_tpu.parallel.norm import LayerNorm as JaxLayerNorm
from neuronx_distributed_tpu_torch.config import training_config
from neuronx_distributed_tpu_torch.convert import (
    bert_params_from_jax,
    shard_dim,
)
from neuronx_distributed_tpu_torch.models.bert import (
    BertConfig,
    BertForPreTraining,
    pretraining_loss,
)
from neuronx_distributed_tpu_torch.models.common import dropout
from neuronx_distributed_tpu_torch.parallel.norm import LayerNorm
from neuronx_distributed_tpu_torch.trainer import (
    initialize_parallel_model,
    initialize_parallel_optimizer,
    make_train_step,
)
from neuronx_distributed_tpu_torch.utils.distributed import spawn
import torch_tp_workers as workers

B, S, V = 2, 16, 256
ATOL = 2e-5

_CACHE: dict = {}


def jax_side(remat="none"):
    """``(jax module, params as numpy)``: tiny fp32 BERT, seed 1."""
    if remat not in _CACHE:
        module = JaxBert(JaxConfig.tiny(remat=remat, dtype=jnp.float32,
                                       param_dtype=jnp.float32))
        params = nn.unbox(module.init(jax.random.PRNGKey(1),
                                      jnp.zeros((B, S), jnp.int32)))
        _CACHE[remat] = (module, jax.tree.map(np.asarray, params))
    return _CACHE[remat]


def port_model(params=None, **kw):
    cfg = BertConfig.tiny(dtype=torch.float32, **kw)
    model = BertForPreTraining(cfg, device="cpu")
    if params is None:
        return model.init_random(3)
    model.load_state_dict(bert_params_from_jax(params, cfg))
    return model


def make_batch(seed=0, b=B, padded=4):
    """Ids, two token-type segments, the last ``padded`` positions padding,
    15 % of the rest masked for MLM (labels -100 elsewhere), NSP labels."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, V, size=(b, S))
    tt = np.zeros((b, S), np.int64)
    tt[:, S // 2:] = 1
    am = np.ones((b, S), np.int64)
    am[:, S - padded:] = 0
    pick = (rs.rand(b, S) < 0.15) & (am > 0)
    pick[:, 1] = True   # at least one MLM label a row
    labels = np.where(pick, ids, -100)
    return {"ids": np.where(pick, 103, ids), "token_type_ids": tt,
            "attention_mask": am, "mlm_labels": labels,
            "nsp_labels": rs.randint(0, 2, size=(b,))}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    """fp32 statistics at BERT's eps 1e-12, also for a bf16 input whose
    spread is a few steps of bf16's resolution at its mean (1000)."""
    rs = np.random.RandomState(0)
    offset = 1000.0 if dtype == "bfloat16" else 0.0
    x = (offset + 8 * rs.standard_normal((3, 5, 64))).astype(np.float32)
    w = rs.standard_normal(64).astype(np.float32)
    b = rs.standard_normal(64).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = JaxLayerNorm(eps=1e-12, dtype=jdt).apply(
        {"params": {"weight": w, "bias": b}}, jnp.asarray(x).astype(jdt))
    ln = LayerNorm(64, 1e-12, dtype=tdt, device="cpu")
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(w))
        ln.bias.copy_(torch.from_numpy(b))
    out = ln(torch.from_numpy(x).to(tdt)).detach()
    assert out.dtype == tdt
    ref = np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=0)
    else:
        # one bf16 step at most (both round the same fp32 result once)
        np.testing.assert_allclose(out.float().numpy(), ref, rtol=2 ** -8,
                                   atol=0)
    no_bias = LayerNorm(64, 1e-5, use_bias=False, dtype=torch.float32,
                        device="cpu")
    assert no_bias.bias is None and len(list(no_bias.parameters())) == 1


def test_logits_match_jax():
    module, params = jax_side()
    model = port_model(params)
    batch = make_batch()
    keys = ("ids", "token_type_ids", "attention_mask")
    ref = module.apply(params, *(jnp.asarray(batch[k]) for k in keys))
    out = model(*(torch.from_numpy(batch[k]) for k in keys))
    for got, want in zip(out, ref):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=ATOL, rtol=0)
    assert out[0].shape == (B, S, V) and out[1].dtype == torch.float32


@pytest.mark.parametrize("nsp", [True, False], ids=["mlm_nsp", "mlm_only"])
def test_pretraining_loss_matches_jax(nsp):
    module, params = jax_side()
    model = port_model(params)
    batch = make_batch(seed=1)
    if not nsp:
        del batch["nsp_labels"]
    want = float(jax_pretraining_loss(module, params, _jnp(batch)))
    got = pretraining_loss(model, _t(batch)).item()
    assert got == pytest.approx(want, rel=1e-5)


def test_attention_mask_isolates_padding():
    """Padded positions do not reach the unpadded outputs."""
    _, params = jax_side()
    model = port_model(params)
    batch = make_batch(seed=2)
    ids = torch.from_numpy(batch["ids"])
    am = torch.from_numpy(batch["attention_mask"])
    mlm_a, nsp_a = model(ids, None, am)
    ids_b = ids.clone()
    ids_b[:, S - 4:] = 7   # other garbage in the padded slots
    mlm_b, nsp_b = model(ids_b, None, am)
    np.testing.assert_allclose(mlm_a[:, :S - 4].detach().numpy(),
                               mlm_b[:, :S - 4].detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(nsp_a.detach().numpy(),
                               nsp_b.detach().numpy(), rtol=1e-5, atol=1e-5)
    moved = (model(ids_b)[0] - mlm_a).abs().max().item()
    assert moved > 1e-3, "without the mask the padding must move the logits"


def _square_loss(outs):
    mlm, nsp = outs
    return mlm.float().square().mean() + nsp.square().mean()


@pytest.mark.parametrize("remat", ["selective", "full"])
def test_remat_matches_no_remat(remat):
    """Dropout 0: the port under remat equals its no-remat run and JAX's
    remat run (loss and gradient norm)."""
    module, params = jax_side(remat)
    batch = make_batch(seed=3)
    ids, am = batch["ids"], batch["attention_mask"]

    def jloss(p):
        mlm, nsp = module.apply(p, jnp.asarray(ids), None, jnp.asarray(am))
        return jnp.mean(mlm.astype(jnp.float32) ** 2) + jnp.mean(nsp ** 2)

    jval, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
    jnorm = float(jnp.sqrt(sum(jnp.sum(g ** 2)
                               for g in jax.tree.leaves(jgrads))))
    runs = {}
    for mode in ("none", remat):
        model = port_model(params, remat=mode)
        loss = _square_loss(model(torch.from_numpy(ids), None,
                                  torch.from_numpy(am)))
        loss.backward()
        runs[mode] = (loss.item(), [p.grad for p in model.parameters()])
    assert runs[remat][0] == pytest.approx(runs["none"][0], rel=1e-6)
    for x, y in zip(runs[remat][1], runs["none"][1]):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-7)
    norm = torch.sqrt(sum((g ** 2).sum() for g in runs[remat][1])).item()
    assert runs[remat][0] == pytest.approx(float(jval), rel=1e-5)
    assert norm == pytest.approx(jnorm, rel=1e-4)


def _dropout_run(remat, seed, rate=0.1):
    model = port_model(remat=remat, hidden_dropout=rate)
    g = None
    if seed is not None:
        g = torch.Generator()
        g.manual_seed(seed)
    loss = pretraining_loss(model, _t(make_batch(seed=4)), generator=g)
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in
                         model.named_parameters()}


@pytest.mark.parametrize("remat", ["selective", "full"])
def test_remat_keeps_the_dropout_masks(remat):
    """Dropout 0.1 with one generator seed: the gradients under remat are
    the no-remat gradients (the recompute draws the same masks; drawing
    from the step's generator inside the block would not)."""
    loss0, grads0 = _dropout_run("none", 11)
    loss1, grads1 = _dropout_run(remat, 11)
    assert loss1 == pytest.approx(loss0, rel=1e-6)
    for n, g in grads0.items():
        torch.testing.assert_close(grads1[n], g, rtol=1e-6, atol=1e-7,
                                   msg=n)


def test_dropout_invariants():
    same = [_dropout_run("none", 5)[0] for _ in range(2)]
    assert same[0] == same[1], "one seed must give one loss"
    other = _dropout_run("none", 6)[0]
    assert abs(other - same[0]) > 1e-4, "another seed must move the loss"
    none = [_dropout_run("none", None)[0] for _ in range(2)]
    assert none[0] == none[1]
    assert none[0] == _dropout_run("none", None, rate=0.0)[0]
    assert abs(none[0] - same[0]) > 1e-4, "dropout must be on with a generator"
    x = torch.ones(200, 500)
    g = torch.Generator()
    g.manual_seed(0)
    y = dropout(x, 0.1, g)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.9))
    assert dropout(x, 0.1, None) is x and dropout(x, 0.0, g) is x
    assert not dropout(x, 1.0, g).any()


def test_train_step_generator_contract():
    """No generator: ``loss_fn(model, batch)`` (a two-argument loss keeps
    working); a generator: ``loss_fn(model, batch, generator=g)`` with the
    step's generator itself, or one stream a microbatch under
    grad_accum_steps > 1, the same streams from the same seed."""
    cfg = BertConfig.tiny(dtype=torch.float32)
    config = training_config(learning_rate=1e-3, compute_dtype="float32")
    model = initialize_parallel_model(
        config, lambda d: BertForPreTraining(cfg, device=d), device="cpu")
    opt = initialize_parallel_optimizer(config, model)
    calls = []

    def two_args(m, batch):
        calls.append(None)
        return pretraining_loss(m, batch)

    def with_gen(m, batch, generator=None):
        calls.append(torch.rand(1, generator=generator).item())
        return pretraining_loss(m, batch, generator)

    batch = make_batch(seed=5, b=4)
    make_train_step(config, model, opt, two_args)(batch)
    assert calls == [None]
    calls.clear()
    g = torch.Generator()
    g.manual_seed(1)
    make_train_step(config, model, opt, with_gen)(batch, g)
    g.manual_seed(1)
    assert calls == [torch.rand(1, generator=g).item()]
    runs = []
    for _ in range(2):
        calls.clear()
        g.manual_seed(2)
        make_train_step(config, model, opt, with_gen,
                        grad_accum_steps=2)(batch, g)
        runs.append(list(calls))
    assert runs[0] == runs[1] and runs[0][0] != runs[0][1]


def test_train_loss_decreases_with_dropout():
    """The trainer drives BERT with dropout 0.1 through a step generator
    and two microbatches: the loss falls by 10 % over six steps on a fixed
    batch (JAX tests/test_models.py, which trains with a step key)."""
    cfg = BertConfig.tiny(dtype=torch.float32, hidden_dropout=0.1,
                          remat="selective")
    config = training_config(learning_rate=1e-3, compute_dtype="float32")
    model = initialize_parallel_model(
        config, lambda d: BertForPreTraining(cfg, device=d), device="cpu")
    step = make_train_step(config, model,
                           initialize_parallel_optimizer(config, model),
                           pretraining_loss, grad_accum_steps=2)
    batch = make_batch(seed=42, b=8, padded=0)
    g = torch.Generator()
    g.manual_seed(0)
    losses = [step(batch, g)["loss"].item() for _ in range(6)]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] * 0.9, losses


def test_tp2_forward_matches_tp1_and_jax():
    """One 2-rank gloo world with a padding mask: heads, intermediate
    columns, the word table and mlm_bias cut by vocab; gathered MLM logits
    and the NSP logits equal tp = 1 and JAX within 5e-4."""
    module, params = jax_side()
    batch = make_batch(seed=7)
    keys = ("ids", "token_type_ids", "attention_mask")
    inp = {"bert": {"family": "bert", "tree": params, "config": {},
                    **{k: batch[k] for k in keys}}}
    ref = [np.asarray(x) for x in module.apply(
        params, *(jnp.asarray(batch[k]) for k in keys))]
    tp1 = [x.detach().numpy() for x in port_model(params)(
        *(torch.from_numpy(batch[k]) for k in keys))]
    ranks = spawn(workers.neox_bert_forward, 2, (inp,), timeout_s=120)
    for out in ranks:
        got = out["bert"]
        assert got["local_vocab"] == V // 2
        for have, want in ((got["logits"], ref[0]), (got["nsp"], ref[1]),
                           (got["logits"], tp1[0]), (got["nsp"], tp1[1])):
            np.testing.assert_allclose(have, want, rtol=5e-4, atol=5e-4)


def test_converter_names_and_refusals():
    _, params = jax_side()
    cfg = BertConfig.tiny(dtype=torch.float32)
    sd = bert_params_from_jax(params, cfg)
    assert set(sd) == set(BertForPreTraining(cfg, device="cpu").state_dict())
    assert sd["bert.pooler.kernel"].shape == (64, 64)   # flax Dense [in, out]
    assert sd["nsp_classifier.kernel"].shape == (64, 2)
    for name, dim in (("bert.layer_0.attention.qkv.kernel", -1),
                      ("bert.layer_0.attention.qkv.bias", -1),
                      ("bert.layer_0.attention.dense.kernel", 0),
                      ("bert.layer_0.attention.dense.bias", None),
                      ("bert.layer_0.intermediate.kernel", -1),
                      ("bert.layer_0.intermediate.bias", -1),
                      ("bert.layer_0.output.kernel", 0),
                      ("bert.layer_0.output.bias", None),
                      ("bert.word_embeddings.embedding", 0),
                      ("mlm_bias", 0), ("bert.pooler.kernel", None),
                      ("mlm_transform.kernel", None),
                      ("bert.position_embeddings", None),
                      ("bert.layer_0.output_norm.weight", None)):
        assert shard_dim(name) == dim, name
    bad = jax.tree.map(lambda x: x, params)
    bad["params"]["mlm_bias"] = np.zeros(V + 1, np.float32)
    with pytest.raises(ValueError, match="mlm_bias: shape"):
        bert_params_from_jax(bad, cfg)


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        BertForPreTraining(BertConfig.tiny())
    assert BertForPreTraining(BertConfig.tiny(), device="cpu"
                              ).mlm_bias.device.type == "cpu"
    with pytest.raises(ValueError, match="remat"):
        BertConfig.tiny(remat="some")
