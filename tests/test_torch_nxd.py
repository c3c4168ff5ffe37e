"""PyTorch port: reference (neuronx-distributed) checkpoints
(``convert/nxd.py``) against the JAX package's ``convert/nxd.py``.

Mirrors JAX ``tests/test_nxd_import.py`` and the exporter tests of
``tests/test_weights.py``, with both packages on the same files: files
fabricated in the reference's layout (``dp_rank_00_tp_rank_TT_pp_rank_PP.pt``
holding tp shards cut by the ``tp * stride`` chunk ``[rank::tp]`` rule)
load exactly as JAX's loader loads them; files that JAX's
``save_nxd_checkpoint`` writes load in the port, and files that the port's
writes load in JAX, back to the source bit for bit; the kv-replication,
pickle, xser, unmatched-rule and indivisible refusals carry JAX's words;
and a reference checkpoint imported into the port's Llama gives JAX's
logits (fp32, 1e-5).
"""

import os
import pickle

import numpy as np
import pytest
import torch

import neuronx_distributed_tpu.convert as jconv
import neuronx_distributed_tpu_torch.convert as conv

RULES = conv.LLAMA_TP_RULES


def _reference_shard(full, rank, tp, dim, stride):
    chunks = np.split(full, tp * stride, axis=dim)
    return np.concatenate(chunks[rank::tp], axis=dim)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def assert_loads_alike(mdir, want=None, **kw):
    """The port's and JAX's loaders give the same dict (and ``want`` when
    given); returns the port's."""
    port = conv.load_nxd_checkpoint(mdir, **kw)
    jax_ = jconv.load_nxd_checkpoint(mdir, **kw)
    assert set(port) == set(jax_)
    for k in jax_:
        assert isinstance(port[k], torch.Tensor), k
        np.testing.assert_array_equal(_np(port[k]), jax_[k], err_msg=k)
        if want is not None:
            np.testing.assert_array_equal(_np(port[k]), want[k], err_msg=k)
    return port


def test_merge_inverts_reference_sharding():
    rng = np.random.RandomState(0)
    for dim, stride in [(0, 1), (1, 1), (0, 3), (0, 2)]:
        full = rng.randn(24, 8).astype(np.float32)
        for tp in (2, 4):
            shards = [_reference_shard(full, r, tp, dim, stride)
                      for r in range(tp)]
            got = conv.merge_tp_shards([torch.from_numpy(s) for s in shards],
                                       dim, stride)
            np.testing.assert_array_equal(got.numpy(), full)
            np.testing.assert_array_equal(
                got.numpy(), jconv.merge_tp_shards(shards, dim, stride))


def _fake_ckpt(tmp_path, tp=2, pp=2):
    rng = np.random.RandomState(1)
    H, I, V = 8, 16, 32
    full = {
        0: {  # pp stage 0: embedding + layer 0
            "model.embed_tokens.weight": (rng.randn(V, H), 0, 1),
            "model.layers.0.self_attn.qkv_proj.weight":
                (rng.randn(3 * H, H), 0, 3),
            "model.layers.0.self_attn.o_proj.weight": (rng.randn(H, H), 1, 1),
            "model.layers.0.mlp.gate_up_proj.weight":
                (rng.randn(2 * I, H), 0, 2),
            "model.layers.0.mlp.down_proj.weight": (rng.randn(H, I), 1, 1),
            "model.layers.0.input_layernorm.weight": (rng.randn(H), None, 1),
            "model.layers.0.post_attention_layernorm.weight":
                (rng.randn(H), None, 1),
        },
        1: {  # pp stage 1: final norm + head
            "model.norm.weight": (rng.randn(H), None, 1),
            "lm_head.weight": (rng.randn(V, H), 0, 1),
        },
    }
    if pp == 1:
        full = {0: {**full[0], **full[1]}}
    mdir = str(tmp_path / "model")
    os.makedirs(mdir)
    for p in range(pp):
        for t in range(tp):
            sd = {}
            for name, (w, dim, stride) in full[p].items():
                w = w.astype(np.float32)
                sd[name] = torch.tensor(
                    w if dim is None else _reference_shard(w, t, tp, dim,
                                                           stride))
            torch.save(sd, os.path.join(
                mdir, f"dp_rank_00_tp_rank_{t:02d}_pp_rank_{p:02d}.pt"))
    flat = {k: v[0].astype(np.float32) for d in full.values()
            for k, v in d.items()}
    return mdir, flat


def test_load_nxd_checkpoint_roundtrip(tmp_path):
    mdir, truth = _fake_ckpt(tmp_path)
    state = assert_loads_alike(mdir, truth, tp_rules=RULES)
    hf = conv.split_fused_llama(state, num_heads=2, num_kv_heads=2,
                                head_dim=4)
    jhf = jconv.split_fused_llama(jconv.load_nxd_checkpoint(mdir, RULES),
                                  num_heads=2, num_kv_heads=2, head_dim=4)
    assert set(hf) == set(jhf)
    for k in jhf:
        np.testing.assert_array_equal(_np(hf[k]), jhf[k], err_msg=k)
    np.testing.assert_array_equal(
        _np(hf["model.layers.0.self_attn.q_proj.weight"]),
        truth["model.layers.0.self_attn.qkv_proj.weight"][:8])


def test_unmatched_sharded_param_raises(tmp_path):
    mdir = str(tmp_path / "model")
    os.makedirs(mdir)
    g = torch.Generator().manual_seed(0)
    for t in range(2):
        torch.save({"custom.weird.weight": torch.randn(4, 4, generator=g)},
                   os.path.join(mdir,
                                f"dp_rank_00_tp_rank_{t:02d}_pp_rank_00.pt"))
    with pytest.raises(ValueError, match="matches no") as port:
        conv.load_nxd_checkpoint(mdir, RULES)
    with pytest.raises(ValueError, match="matches no") as jax_:
        jconv.load_nxd_checkpoint(mdir, RULES)
    assert str(port.value) == str(jax_.value)
    state = assert_loads_alike(
        mdir, tp_rules=RULES,
        extra_rules=[(r"custom\.weird\.weight$", (0, 1))])
    assert tuple(state["custom.weird.weight"].shape) == (8, 4)


class Sneaky:
    def __reduce__(self):
        return (str, ("pwned",))


def test_pickle_payload_rejected_by_default(tmp_path):
    mdir = str(tmp_path / "model")
    os.makedirs(mdir)
    for t in range(2):
        torch.save({"model.norm.weight": torch.ones(4), "meta": Sneaky()},
                   os.path.join(mdir,
                                f"dp_rank_00_tp_rank_{t:02d}_pp_rank_00.pt"))
    with pytest.raises(pickle.UnpicklingError):
        conv.load_nxd_checkpoint(mdir, RULES)
    with pytest.raises(pickle.UnpicklingError):
        jconv.load_nxd_checkpoint(mdir, RULES)
    state = conv.load_nxd_checkpoint(mdir, RULES, allow_pickle=True)
    assert torch.equal(state["model.norm.weight"], torch.ones(4))
    assert state["meta"] == "pwned"


def test_replicated_gqa_kv_checkpoint_inverts(tmp_path):
    rng = np.random.RandomState(5)
    master = rng.randn(4, 8).astype(np.float32)
    bias = rng.randn(4).astype(np.float32)
    for tp, m in [(2, 2), (4, 2), (4, 4)]:
        mdir = str(tmp_path / f"model_tp{tp}_m{m}")
        os.makedirs(mdir)
        tiled_w, tiled_b = np.tile(master, (m, 1)), np.tile(bias, m)
        for t in range(tp):
            torch.save({"a.qkv.weight_k": torch.tensor(
                            _reference_shard(tiled_w, t, tp, 0, 1)),
                        "a.qkv.bias_v": torch.tensor(
                            _reference_shard(tiled_b, t, tp, 0, 1))},
                       os.path.join(mdir, f"dp_rank_00_tp_rank_{t:02d}_"
                                          "pp_rank_00.pt"))
        assert_loads_alike(mdir, {"a.qkv.weight_k": master,
                                  "a.qkv.bias_v": bias}, tp_rules=RULES)
        raw = assert_loads_alike(mdir, tp_rules=RULES,
                                 allow_replicated_kv=True)
        assert tuple(raw["a.qkv.weight_k"].shape) == (4 * m, 8)


def test_constant_kv_bias_is_ambiguous_and_explicit_multiplier_resolves(
        tmp_path):
    tiled = np.tile(np.zeros(8, np.float32), 2)
    mdir = str(tmp_path / "model")
    os.makedirs(mdir)
    for t in range(4):
        torch.save({"a.qkv.bias_k": torch.tensor(
            _reference_shard(tiled, t, 4, 0, 1))},
            os.path.join(mdir, f"dp_rank_00_tp_rank_{t:02d}_pp_rank_00.pt"))
    for load in (conv.load_nxd_checkpoint, jconv.load_nxd_checkpoint):
        with pytest.raises(ValueError, match="ambiguous"):
            load(mdir, RULES)
        with pytest.raises(ValueError, match="does not match"):
            load(mdir, RULES, kv_size_multiplier=3)
    state = assert_loads_alike(mdir, tp_rules=RULES, kv_size_multiplier=2)
    assert tuple(state["a.qkv.bias_k"].shape) == (8,)


def test_ambiguous_kv_duplicates_raise(tmp_path):
    rng = np.random.RandomState(7)
    a, b, c = (rng.randn(4, 8).astype(np.float32) for _ in range(3))
    mdir = str(tmp_path / "model")
    os.makedirs(mdir)
    for t, shard in enumerate([a, a, b, c]):
        torch.save({"a.qkv.weight_v": torch.tensor(shard)},
                   os.path.join(mdir,
                                f"dp_rank_00_tp_rank_{t:02d}_pp_rank_00.pt"))
    for load in (conv.load_nxd_checkpoint, jconv.load_nxd_checkpoint):
        with pytest.raises(ValueError, match="not a clean tiling"):
            load(mdir, RULES)


def test_xser_layout_rejected(tmp_path):
    mdir = str(tmp_path / "model")
    os.makedirs(mdir)
    fname = "dp_rank_00_tp_rank_00_pp_rank_00.pt"
    torch.save({"model.norm.weight": torch.ones(4)}, os.path.join(mdir, fname))
    os.makedirs(os.path.join(mdir, fname + ".tensors"))
    with pytest.raises(ValueError, match="xser") as port:
        conv.load_nxd_checkpoint(mdir, RULES)
    with pytest.raises(ValueError, match="xser") as jax_:
        jconv.load_nxd_checkpoint(mdir, RULES)
    assert str(port.value) == str(jax_.value)


def test_import_feeds_port_llama(tmp_path):
    """Reference per-rank files -> merged -> split -> the port's Llama:
    logits equal JAX's on the same import (fp32, 1e-5)."""
    import jax.numpy as jnp

    from neuronx_distributed_tpu.models.llama import (
        LlamaConfig as JaxLlamaConfig,
        LlamaForCausalLM as JaxLlama,
    )
    from neuronx_distributed_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaForCausalLM,
    )

    mdir, _ = _fake_ckpt(tmp_path, tp=2, pp=1)
    dims = dict(vocab_size=32, hidden_size=8, intermediate_size=16,
                num_layers=1, num_heads=2, num_kv_heads=2, head_dim=4,
                max_seq_len=8)
    jcfg = JaxLlamaConfig(**dims, sequence_parallel=False, remat="none",
                          dtype=jnp.float32, param_dtype=jnp.float32)
    jparams = jconv.llama_params_from_hf(jconv.split_fused_llama(
        jconv.load_nxd_checkpoint(mdir, RULES), 2, 2, 4), jcfg)
    ids = np.random.RandomState(3).randint(0, 32, (2, 8))
    want = np.asarray(JaxLlama(jcfg).apply(jparams, jnp.asarray(ids)))

    cfg = LlamaConfig(**dims, sequence_parallel=False, remat="none",
                      dtype=torch.float32, param_dtype=torch.float32)
    model = LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(conv.llama_params_from_hf(conv.split_fused_llama(
        conv.load_nxd_checkpoint(mdir, RULES), 2, 2, 4), cfg))
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
    assert np.isfinite(got).all() and np.abs(got).max() > 0
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


# -- the exporter ---------------------------------------------------------------


def _roundtrip_state(rng):
    H, I, V = 8, 16, 32
    return {
        "model.embed_tokens.weight": rng.randn(V, H).astype(np.float32),
        "model.layers.0.self_attn.qkv_proj.weight":
            rng.randn(3 * H, H).astype(np.float32),
        "model.layers.0.self_attn.o_proj.weight":
            rng.randn(H, H).astype(np.float32),
        "model.layers.0.mlp.gate_up_proj.weight":
            rng.randn(2 * I, H).astype(np.float32),
        "model.layers.0.mlp.down_proj.weight":
            rng.randn(H, I).astype(np.float32),
        "model.layers.0.input_layernorm.weight":
            rng.randn(H).astype(np.float32),
        "model.norm.weight": rng.randn(H).astype(np.float32),
        "lm_head.weight": rng.randn(V, H).astype(np.float32),
    }


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_save_nxd_checkpoint_roundtrips_through_both_importers(tmp_path, tp):
    """The port's files load in JAX and in the port, JAX's files load in
    the port, all back to the source bit for bit."""
    state = _roundtrip_state(np.random.RandomState(2))
    files = conv.save_nxd_checkpoint(str(tmp_path / "port"),
                                     {k: torch.from_numpy(v)
                                      for k, v in state.items()}, tp=tp)
    assert sorted(os.path.basename(f) for f in files) == [
        f"dp_rank_00_tp_rank_{t:02d}_pp_rank_00.pt" for t in range(tp)]
    assert_loads_alike(str(tmp_path / "port"), state, tp_rules=RULES)
    jconv.save_nxd_checkpoint(str(tmp_path / "jax"), state, tp=tp)
    assert_loads_alike(str(tmp_path / "jax"), state, tp_rules=RULES)
    # rank by rank, the two writers' files hold the same shards
    for f in files:
        a = torch.load(f, weights_only=True)
        b = torch.load(os.path.join(tmp_path / "jax", os.path.basename(f)),
                       weights_only=True)
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
            # a shard is stored alone, not as a view of the whole tensor
            assert a[k].untyped_storage().nbytes() == \
                a[k].numel() * a[k].element_size()


def test_save_nxd_checkpoint_shards_match_reference_interleave(tmp_path):
    state = _roundtrip_state(np.random.RandomState(4))
    mdir = str(tmp_path / "model")
    conv.save_nxd_checkpoint(mdir, state, tp=2)
    for name, stride in [("model.layers.0.self_attn.qkv_proj.weight", 3),
                         ("model.layers.0.mlp.gate_up_proj.weight", 2)]:
        chunks = np.split(state[name], 2 * stride, axis=0)
        for r in range(2):
            sd = torch.load(os.path.join(
                mdir, f"dp_rank_00_tp_rank_{r:02d}_pp_rank_00.pt"),
                weights_only=True)
            np.testing.assert_array_equal(
                sd[name].numpy(), np.concatenate(chunks[r::2], axis=0))
            np.testing.assert_array_equal(sd["model.norm.weight"].numpy(),
                                          state["model.norm.weight"])


def test_save_nxd_checkpoint_fuses_and_replicates_gqa_kv(tmp_path):
    rng = np.random.RandomState(6)
    H = 8
    split_state = {
        f"model.layers.0.self_attn.{n}_proj.weight":
            rng.randn(H, H).astype(np.float32) for n in "qkv"}
    split_state.update({
        "model.layers.0.mlp.gate_proj.weight":
            rng.randn(16, H).astype(np.float32),
        "model.layers.0.mlp.up_proj.weight":
            rng.randn(16, H).astype(np.float32),
        "model.norm.weight": rng.randn(H).astype(np.float32)})
    mdir = str(tmp_path / "fused")
    conv.save_nxd_checkpoint(mdir, split_state, tp=2, fuse_llama=True)
    fused = jconv.fuse_split_llama(split_state)
    assert_loads_alike(mdir, fused, tp_rules=RULES)
    port_fused = conv.fuse_split_llama(split_state)
    for k in fused:
        np.testing.assert_array_equal(_np(port_fused[k]), fused[k])

    kv_state = {"model.layers.0.self_attn.weight_k":
                rng.randn(4, H).astype(np.float32),
                "model.norm.weight": rng.randn(H).astype(np.float32)}
    kdir = str(tmp_path / "kv")
    conv.save_nxd_checkpoint(kdir, kv_state, tp=2, kv_size_multiplier=2)
    assert_loads_alike(kdir, kv_state, tp_rules=RULES, kv_size_multiplier=2)


def test_save_nxd_checkpoint_pp_split(tmp_path):
    state = _roundtrip_state(np.random.RandomState(8))
    assign = {k: (1 if k in ("model.norm.weight", "lm_head.weight") else 0)
              for k in state}
    mdir = str(tmp_path / "model")
    files = conv.save_nxd_checkpoint(mdir, state, tp=2, pp=2,
                                     pp_assign=assign)
    assert len(files) == 4
    assert_loads_alike(mdir, state, tp_rules=RULES)
    for save in (conv.save_nxd_checkpoint, jconv.save_nxd_checkpoint):
        with pytest.raises(ValueError, match="out of range"):
            save(str(tmp_path / "bad"), state, pp=2,
                 pp_assign={k: 5 for k in state})


def test_shard_for_rank_indivisible_raises():
    full = np.zeros((10, 4), np.float32)
    with pytest.raises(ValueError, match="divide") as port:
        conv.shard_for_rank(torch.from_numpy(full), 0, tp=4, partition_dim=0)
    with pytest.raises(ValueError, match="divide") as jax_:
        jconv.shard_for_rank(full, 0, tp=4, partition_dim=0)
    assert str(port.value) == str(jax_.value)
    full = np.arange(48, dtype=np.float32).reshape(12, 4)
    for r in range(2):
        np.testing.assert_array_equal(
            conv.shard_for_rank(full, r, 2, 0, 3).numpy(),
            jconv.shard_for_rank(full, r, 2, 0, 3))


def test_bf16_checkpoint_keeps_its_dtype(tmp_path):
    """The port keeps a bf16 checkpoint's dtype (JAX reads it into fp32
    numpy): the merge equals the source bit for bit, in bf16."""
    state = {k: torch.from_numpy(v).to(torch.bfloat16)
             for k, v in _roundtrip_state(np.random.RandomState(9)).items()}
    mdir = str(tmp_path / "bf16")
    conv.save_nxd_checkpoint(mdir, state, tp=2)
    back = conv.load_nxd_checkpoint(mdir)
    jax_ = jconv.load_nxd_checkpoint(mdir)
    for k, v in state.items():
        assert back[k].dtype == torch.bfloat16 and torch.equal(back[k], v), k
        np.testing.assert_array_equal(back[k].float().numpy(), jax_[k])
