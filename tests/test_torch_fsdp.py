"""PyTorch port: FSDP (ZeRO-3 as placement) against the JAX package's
``fsdp=True`` and against the port's replicated run, and a sharded
checkpoint re-sharded to other layouts.

One world of 4 gloo ranks (``torch_fit_workers.fsdp_world``) trains the
tiny Llama at tp = 2 x dp = 2 with sequence parallelism and selective
remat, from this rank's cut of the JAX tree, with FSDP and replicated
(clipping off), each with the whole loss head and the chunked one, then
saves the FSDP run's checkpoint.  JAX trains the same model with
``fsdp=True`` on 4 CPU devices at the same mesh.  A second world
(``torch_fit_workers.fsdp_tied_world``) trains the tiny Gemma (its tied
head under the chunked loss) and BERT (its tied MLM decoder) with FSDP
against JAX's FSDP runs of the same models.  Losses and
grad norms agree within ``rtol=2e-5, atol=2e-6`` (JAX
``tests/test_fsdp.py:_train``), parameters to a tenth of the learning
rate (1e-5 on 99.9 % of the elements, ``tests/test_torch_tp_train.py``
says why).  FSDP computes the replicated run's numbers: losses to the
bit, and the parameters to the bit except the sequence-parallel norm
weights, whose gradient is summed over dp before tp there and after it
here (one rounding apart).  The checkpoint loads bit-equal at tp = 1 in
this process and at tp = 2, dp = 1 in a world of 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neuronx_distributed_tpu as nxd
from neuronx_distributed_tpu.models.bert import (
    BertConfig as JaxBertConfig,
    BertForPreTraining as JaxBert,
    pretraining_loss as jax_pretraining_loss,
)
from neuronx_distributed_tpu.models.common import (
    causal_lm_loss_sum as jax_causal_lm_loss_sum,
)
from neuronx_distributed_tpu.models.gemma import (
    GemmaConfig as JaxGemmaConfig,
    GemmaForCausalLM as JaxGemma,
)
from neuronx_distributed_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig,
    LlamaForCausalLM as JaxLlama,
)
from neuronx_distributed_tpu.parallel.mesh import (
    destroy_model_parallel,
    initialize_model_parallel,
)
from neuronx_distributed_tpu.trainer import (
    initialize_parallel_model as jax_init_model,
)
from neuronx_distributed_tpu_torch.config import training_config
from neuronx_distributed_tpu_torch.convert import (
    fsdp_shard_for_rank,
    shard_dim,
    shard_params_for_rank,
)
from neuronx_distributed_tpu_torch.convert.jax_params import (
    _KV_BLOCKS,
    _Q_BLOCKS,
    _ends,
)
from neuronx_distributed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from neuronx_distributed_tpu_torch.optimizer.zero1 import fsdp_dim, fsdp_spec
from neuronx_distributed_tpu_torch.trainer import (
    initialize_parallel_model,
    initialize_parallel_optimizer,
    load_checkpoint,
    model_shards,
    optimizer_shards,
)
from neuronx_distributed_tpu_torch.utils.distributed import spawn
from test_torch_tp_train import (
    S,
    STEP_TOL,
    _flat,
    bert_batches,
    jax_train,
    lm_batches,
    port_metrics,
)
import torch_fit_workers as workers

LR = 1e-3
OPT = dict(learning_rate=LR)
CFG = dict(remat="selective")
# the chunked loss head's chunk: 4 chunks of the 16 positions
CHUNK = 4


def tp_spec(name, ndim):
    """The JAX partition-spec entries of the port's tensor-parallel cut of
    ``name``: q heads and the attention output's rows over ``('tp',
    'kvr')``, k/v heads over ``'tp'``, every other sharded dim over
    ``('kvr', 'tp')``."""
    entries = [None] * ndim
    dim = shard_dim(name)
    if dim is not None:
        entries[dim % ndim] = (("tp", "kvr") if _ends(name, _Q_BLOCKS) else
                               "tp" if _ends(name, _KV_BLOCKS) else
                               ("kvr", "tp"))
    return tuple(entries)


def assemble(pieces):
    """The global arrays from every rank's ``(piece, (global, start,
    size))``, by name."""
    out = {}
    for per_rank in pieces:
        for name, (arr, (g, start, size)) in per_rank.items():
            full = out.setdefault(name, np.zeros(g, np.float32))
            idx = tuple(slice(s, s + n) for s, n in zip(start, size))
            full[idx] = arr
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    rs = np.random.RandomState(3)
    destroy_model_parallel()
    initialize_model_parallel(tensor_parallel_size=2,
                              devices=jax.devices()[:4])
    config = nxd.training_config(tensor_parallel_size=2, fsdp=True, seed=0,
                                 param_dtype="float32",
                                 compute_dtype="float32",
                                 grad_clipping=False, **OPT)
    jcfg = JaxLlamaConfig.tiny(num_kv_heads=2, dtype=jnp.float32,
                               param_dtype=jnp.float32,
                               sequence_parallel=True, remat="selective",
                               max_seq_len=S)
    batches = lm_batches(rs, 4)
    want = jax_train(config, lambda: JaxLlama(jcfg), jax_causal_lm_loss_sum,
                     batches)
    destroy_model_parallel()
    ckpt = str(tmp_path_factory.mktemp("fsdp_ckpt"))
    ranks = spawn(workers.fsdp_world, 4, ({
        "params": want["params0"], "batches": batches, "opt": OPT,
        "cfg": CFG, "ckpt_dir": ckpt, "chunk": CHUNK},), timeout_s=200)
    return want, ranks, ckpt


@pytest.fixture(scope="module")
def tied_world():
    """JAX's FSDP runs of the tiny Gemma and BERT at tp = 2 x dp = 2 and
    the port's (``torch_fit_workers.fsdp_tied_world``) from the same
    initial trees and batches."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    rs = np.random.RandomState(5)
    f32 = dict(dtype=jnp.float32, param_dtype=jnp.float32)
    models = {
        "gemma": (lambda: JaxGemma(JaxGemmaConfig.tiny(
            sequence_parallel=False, max_seq_len=S, **f32)),
            jax_causal_lm_loss_sum, lm_batches(rs, 4)),
        "bert": (lambda: JaxBert(JaxBertConfig.tiny(**f32)),
                 jax_pretraining_loss, bert_batches(rs))}
    want, inp = {}, {"opt": OPT, "chunk": CHUNK}
    for name, (ctor, loss, batches) in models.items():
        destroy_model_parallel()
        initialize_model_parallel(tensor_parallel_size=2,
                                  devices=jax.devices()[:4])
        config = nxd.training_config(tensor_parallel_size=2, fsdp=True,
                                     seed=0, param_dtype="float32",
                                     compute_dtype="float32",
                                     grad_clipping=False, **OPT)
        want[name] = jax_train(config, ctor, loss, batches)
        inp[name] = {"params": want[name]["params0"], "batches": batches}
    destroy_model_parallel()
    ranks = spawn(workers.fsdp_tied_world, 4, (inp,), timeout_s=200)
    return want, ranks


@pytest.mark.parametrize("kvr", [1, 2])
def test_fsdp_spec_matches_jax_param_specs(kvr):
    """The port's spec of every Llama parameter (its tp cut's entries
    extended by ``fsdp_spec`` over its global shape) is JAX's FSDP
    ``param_specs`` entry, and the dim it cuts over dp is the one
    ``fsdp_dim`` picks on the rank's local shard."""
    destroy_model_parallel()
    initialize_model_parallel(tensor_parallel_size=2, kv_size_multiplier=kvr,
                              devices=jax.devices()[:4])
    jcfg = JaxLlamaConfig.tiny(num_kv_heads=2 // kvr, dtype=jnp.float32,
                               param_dtype=jnp.float32,
                               sequence_parallel=False, remat="none")
    config = nxd.training_config(tensor_parallel_size=2,
                                 kv_size_multiplier=kvr, fsdp=True,
                                 compute_dtype="float32")
    model = jax_init_model(config, lambda: JaxLlama(jcfg),
                           (jnp.zeros((1, 16), jnp.int32),))
    specs = jax.tree_util.tree_flatten_with_path(
        model.param_specs["params"],
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    shapes = {".".join(str(getattr(k, "key", k)) for k in path): np.shape(v)
              for path, v in jax.tree_util.tree_flatten_with_path(
                  model.params["params"])[0]}
    sizes = {"dp": 2, "ep": 1, "pp": 1, "cp": 1, "kvr": kvr, "tp": 2 // kvr}
    assert len(specs) == len(shapes) > 10
    for path, spec in specs:
        name = ".".join(str(getattr(k, "key", k)) for k in path)
        shape = shapes[name]
        jax_entries = tuple(spec) + (None,) * (len(shape) - len(spec))
        port = fsdp_spec(tp_spec(name, len(shape)), shape, sizes)
        assert port == jax_entries, (name, port, jax_entries)
        dp_dims = [i for i, e in enumerate(port) if e and "dp" in e]
        local = list(shape)
        for i, e in enumerate(tp_spec(name, len(shape))):
            if e is not None:
                local[i] //= 2
        assert dp_dims == [fsdp_dim(local, shape, 2)], name
    destroy_model_parallel()


def test_fsdp_matches_jax_at_tp2_dp2(world):
    """Every rank's losses and norms equal JAX's FSDP run's; the
    parameters, joined from the four ranks' pieces, equal JAX's."""
    want, ranks, _ = world
    for r in ranks:
        np.testing.assert_allclose(port_metrics(r["fsdp"]), want["metrics"],
                                   **STEP_TOL)
    got = assemble([r["fsdp"]["pieces"] for r in ranks])
    for n, p in _flat(want["params"]).items():
        np.testing.assert_allclose(got[n], p, rtol=0, atol=0.1 * LR,
                                   err_msg=n)
        assert (np.abs(got[n] - p) <= 1e-5).mean() >= 0.999, n


def test_fsdp_equals_replicated(world):
    """FSDP is a placement: its losses are the replicated run's to the
    bit, and its joined parameters equal the replicated run's (to the bit
    but for the sequence-parallel norm weights, one rounding apart)."""
    _, ranks, _ = world
    for r in ranks:
        assert r["fsdp"]["losses"] == r["replicated"]["losses"]
        np.testing.assert_allclose(r["fsdp"]["norms"], r["replicated"]["norms"],
                                   rtol=1e-6)
    fs = assemble([r["fsdp"]["pieces"] for r in ranks])
    rep = assemble([r["replicated"]["pieces"] for r in ranks])
    assert set(fs) == set(rep)
    for n in fs:
        if "norm" in n:
            np.testing.assert_allclose(fs[n], rep[n], rtol=1e-6, err_msg=n)
        else:
            np.testing.assert_array_equal(fs[n], rep[n], err_msg=n)


def test_fsdp_equals_replicated_chunked_head(world):
    """Under the chunked loss head FSDP still computes the replicated
    run's numbers: the head is gathered once for its 4 chunks and their
    recomputes, and its gradient, summed over the chunks, reduce-scattered
    once, so its dp sum is the replicated run's one sum (losses to the
    bit, parameters as in ``test_fsdp_equals_replicated``); and the
    chunked run's losses equal the whole head's within ``STEP_TOL``."""
    _, ranks, _ = world
    for r in ranks:
        assert r["fsdp_chunked"]["losses"] == \
            r["replicated_chunked"]["losses"]
        np.testing.assert_allclose(
            port_metrics(r["fsdp_chunked"]), port_metrics(r["fsdp"]),
            **STEP_TOL)
    fs = assemble([r["fsdp_chunked"]["pieces"] for r in ranks])
    rep = assemble([r["replicated_chunked"]["pieces"] for r in ranks])
    for n in fs:
        if "norm" in n:
            np.testing.assert_allclose(fs[n], rep[n], rtol=1e-6, err_msg=n)
        else:
            np.testing.assert_array_equal(fs[n], rep[n], err_msg=n)


@pytest.mark.parametrize("name", ["gemma", "bert"])
def test_fsdp_tied_heads_match_jax(tied_world, name):
    """A head tied to the embedding table reads the table outside the
    embedding's forward (``ParallelEmbedding.attend``), and FSDP gathers
    it there too: Gemma under the chunked loss and BERT train with FSDP
    to JAX's FSDP losses, norms and parameters (the tolerances of
    ``test_fsdp_matches_jax_at_tp2_dp2``), the table cut over dp.

    One exception: BERT's key bias (row 1 of each ``attention.qkv.bias``)
    has a zero gradient in exact arithmetic (adding it to every key adds
    one constant to a query's scores, which the softmax drops), so its
    float gradient is rounding noise that AdamW's ``m / sqrt(v)`` turns
    into a step of up to ``lr`` either way in each framework; it is held
    to that bound, twice the steps times ``lr``."""
    want, ranks = tied_world
    table = {"gemma": "embed.embedding",
             "bert": "bert.word_embeddings.embedding"}[name]
    for r in ranks:
        np.testing.assert_allclose(port_metrics(r[name]),
                                   want[name]["metrics"], **STEP_TOL)
        assert table in r[name]["sharded"]
    got = assemble([r[name]["pieces"] for r in ranks])
    steps = len(want[name]["metrics"])
    for n, p in _flat(want[name]["params"]).items():
        g = got[n]
        if n.endswith("attention.qkv.bias"):
            np.testing.assert_allclose(g[1], p[1], rtol=0,
                                       atol=2 * steps * LR, err_msg=n)
            g, p = g[[0, 2]], p[[0, 2]]
        np.testing.assert_allclose(g, p, rtol=0, atol=0.1 * LR, err_msg=n)
        assert (np.abs(g - p) <= 1e-5).mean() >= 0.999, n


def test_fsdp_rank_holds_under_half(world):
    """A rank holds under half the replicated run's parameter and AdamW
    bytes: every tiny-Llama parameter has an eligible dim."""
    _, ranks, _ = world
    for r in ranks:
        f, rep = r["fsdp"], r["replicated"]
        assert f["param_bytes"] * 2 <= rep["param_bytes"]
        assert f["state_bytes"] < 0.55 * rep["state_bytes"]
        assert len(f["sharded"]) == 19 and rep["sharded"] == []


def test_fsdp_collectives(world):
    """A step gathers every piece once in forward and each layer's again
    in the selective recompute (19 + 2 x 8), reduce-scatters each
    gradient once (19), and adds no data-parallel gradient sum; the same
    counts on every rank, every step."""
    _, ranks, _ = world
    first = ranks[0]["fsdp"]["counts"]
    for r in ranks:
        assert r["fsdp"]["counts"] == first
    for c in first:
        assert c["fsdp_all_gather"] == 19 + 16
        assert c["fsdp_reduce_scatter"] == 19
    # the chunked head: gathered and reduce-scattered once, as the whole
    # (the vocab-parallel loss adds its all-reduces a chunk)
    for c in ranks[0]["fsdp_chunked"]["counts"]:
        assert (c["fsdp_all_gather"], c["fsdp_reduce_scatter"]) == (35, 19)
    rep = ranks[0]["replicated"]["counts"][0]
    assert "fsdp_all_gather" not in rep


def test_fsdp_moments_are_pieces_of_jax_state(world):
    """Each rank's AdamW first moments are its FSDP piece of its tp shard of
    JAX's ``mu`` (``convert.fsdp_shard_for_rank``), to fp32 reordering
    noise: 1e-4 relative, 1e-6 absolute on moments of order 0.1."""
    want, ranks, _ = world
    for r in ranks:
        f = r["fsdp"]
        cut = _flat(fsdp_shard_for_rank(shard_params_for_rank(
            want["mu"], 2, f["tp_rank"]), 2, f["dp_rank"], tp=2))
        for n, m in f["moments"].items():
            np.testing.assert_allclose(m, cut[n], rtol=1e-4, atol=1e-6,
                                       err_msg=n)


def test_fsdp_refuses_pipeline():
    config = training_config(tensor_parallel_size=1,
                             pipeline_parallel_size=2, fsdp=True,
                             compute_dtype="float32")
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    with pytest.raises(ValueError, match="fsdp.*pipeline"):
        initialize_parallel_model(
            config, lambda d: LlamaForCausalLM(cfg, device=d), device="cpu")


def test_checkpoint_reshards_to_tp1(world):
    """The tp = 2 x dp = 2 FSDP checkpoint loads into one tp = 1 process:
    every parameter and moment bit-equal to the pieces joined."""
    _, ranks, ckpt = world
    config = training_config(seed=1, compute_dtype="float32", **OPT)
    cfg = LlamaConfig.tiny(num_kv_heads=2, dtype=torch.float32,
                           param_dtype=torch.float32, max_seq_len=16, **CFG)
    model = initialize_parallel_model(
        config, lambda d: LlamaForCausalLM(cfg, device=d), device="cpu")
    opt = initialize_parallel_optimizer(config, model)
    mstate, ostate, _, user = load_checkpoint(
        ckpt, model_template=model_shards(model),
        optimizer_template=optimizer_shards(model, opt))
    assert user == {"step": 3} and ostate["count"] == 3
    want = assemble([r["fsdp"]["pieces"] for r in ranks])
    for n, t in mstate.items():
        np.testing.assert_array_equal(t.numpy(), want[n], err_msg=n)
    mu = {}
    for r in ranks:
        f = r["fsdp"]
        for n, m in f["moments"].items():
            g, start, size = f["pieces"][n][1]
            full = mu.setdefault(n, np.zeros(g, np.float32))
            full[tuple(slice(s, s + k) for s, k in zip(start, size))] = m
    for n, t in ostate["exp_avg"].items():
        np.testing.assert_array_equal(t.numpy(), mu[n], err_msg=n)


def test_checkpoint_reshards_to_tp2_dp1(world):
    """The same checkpoint in a world of 2 at tp = 2, dp = 1: each rank's
    parameters are its tp shard of the joined ones, bit for bit, and the
    update count carries over."""
    _, ranks, ckpt = world
    out = spawn(workers.load_world, 2, ({"ckpt_dir": ckpt, "tp": 2,
                                          "opt": OPT, "cfg": CFG},),
                timeout_s=120)
    want = assemble([r["fsdp"]["pieces"] for r in ranks])
    nested = {}
    for n, v in want.items():
        d = nested
        *head, leaf = n.split(".")
        for h in head:
            d = d.setdefault(h, {})
        d[leaf] = v
    for r in out:
        assert r["count"] == 3 and r["user"] == {"step": 3}
        cut = _flat(shard_params_for_rank(nested, 2, r["tp_rank"]))
        for n, (p, _) in r["params"].items():
            np.testing.assert_array_equal(p, cut[n], err_msg=n)
