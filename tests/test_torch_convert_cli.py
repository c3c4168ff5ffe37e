"""PyTorch port: the conversion and perplexity CLIs
(``examples/convert_checkpoints.py``, ``examples/eval_perplexity.py``),
called in process with ``--device cpu``.

``to-framework`` then ``to-hf`` gives a bf16 HF checkpoint back to the bit
(Llama by preset, Gemma-2 from a JSON config).  ``eval_perplexity --ckpt``
on a port checkpoint of a JAX-initialised tiny Llama equals JAX's
``causal_lm_loss_sum`` over the same loader order within rtol 1e-5 (fp32
on both sides).  Without ``--device cpu`` both CLIs raise on a machine
with no card.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neuronx_distributed_tpu as nxd
from neuronx_distributed_tpu.data import (
    TokenDataLoader as JaxLoader,
    TokenDataset as JaxDataset,
)
from neuronx_distributed_tpu.models import causal_lm_loss_sum as jax_loss_sum
from neuronx_distributed_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig,
    LlamaForCausalLM as JaxLlama,
)
from neuronx_distributed_tpu.parallel import mesh as jax_mesh
from neuronx_distributed_tpu.trainer import (
    initialize_parallel_model as jax_init_model,
)
from neuronx_distributed_tpu_torch.convert import (
    llama_params_from_jax,
    load_hf_state_dict,
    save_hf_state_dict,
)
from neuronx_distributed_tpu_torch.data import write_token_file
from neuronx_distributed_tpu_torch.examples import (
    convert_checkpoints,
    eval_perplexity,
)
from neuronx_distributed_tpu_torch.models.gemma import (
    Gemma2Config,
    Gemma2ForCausalLM,
)
from neuronx_distributed_tpu_torch.models.llama import LlamaConfig
from neuronx_distributed_tpu_torch.trainer.checkpoint import save_checkpoint
from neuronx_distributed_tpu_torch.utils.distributed import spawn
import torch_tp_workers as workers

B, S = 4, 32


def hf_state(cfg, seed, family="llama"):
    """A seeded bf16 HF-layout state dict at ``cfg``'s shapes."""
    g = torch.Generator().manual_seed(seed)
    H, I, D = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim_
    NQ, NKV = cfg.num_heads, cfg.num_kv_heads

    def w(*shape):
        return torch.randn(shape, generator=g).to(torch.bfloat16)

    sd = {"model.embed_tokens.weight": w(cfg.vocab_size, H),
          "model.norm.weight": w(H)}
    if family == "llama":
        sd["lm_head.weight"] = w(cfg.vocab_size, H)
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        sd.update({p + "self_attn.q_proj.weight": w(NQ * D, H),
                   p + "self_attn.k_proj.weight": w(NKV * D, H),
                   p + "self_attn.v_proj.weight": w(NKV * D, H),
                   p + "self_attn.o_proj.weight": w(H, NQ * D),
                   p + "mlp.gate_proj.weight": w(I, H),
                   p + "mlp.up_proj.weight": w(I, H),
                   p + "mlp.down_proj.weight": w(H, I),
                   p + "input_layernorm.weight": w(H),
                   p + "post_attention_layernorm.weight": w(H)})
        if family == "gemma2":
            sd[p + "pre_feedforward_layernorm.weight"] = w(H)
            sd[p + "post_feedforward_layernorm.weight"] = w(H)
    return sd


def assert_same(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def round_trip(tmp_path, family, config, sd, *extra):
    save_hf_state_dict(sd, str(tmp_path / "hf"))
    common = ["--family", family, "--config", config, "--device", "cpu",
              *extra]
    out = convert_checkpoints.main(
        ["to-framework", "--hf", str(tmp_path / "hf"), "--out",
         str(tmp_path / "ckpt"), *common])
    assert out["tag"] == "hf_import" and out["tensors"] > 0
    back = convert_checkpoints.main(
        ["to-hf", "--ckpt", str(tmp_path / "ckpt"), "--out",
         str(tmp_path / "hf_back"), *common])
    assert back["tag"] == "hf_import"
    return load_hf_state_dict(str(tmp_path / "hf_back"))


def test_convert_round_trip_llama_preset(tmp_path):
    sd = hf_state(LlamaConfig.tiny(num_layers=3), 0)
    assert_same(round_trip(tmp_path, "llama", "tiny", sd, "--num-layers",
                           "3"), sd)


def test_convert_round_trip_gemma2_json_config(tmp_path):
    """A JSON config file of fields; the bf16 norms go through the fp32
    ``+ 1`` fold and come back to the bit."""
    cfg = Gemma2Config.tiny()
    path = tmp_path / "gemma2.json"
    path.write_text(json.dumps(dict(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size, num_layers=cfg.num_layers,
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim)))
    sd = hf_state(cfg, 1, "gemma2")
    assert_same(round_trip(tmp_path, "gemma2", str(path), sd), sd)


def test_to_hf_checks_a_pipelined_checkpoints_stages(tmp_path):
    """A checkpoint written at pp > 1 exports when its stages make the
    whole model, and is refused when a stage's layers are missing."""
    sd = hf_state(LlamaConfig.tiny(), 2)
    round_trip(tmp_path, "llama", "tiny", sd)
    meta_path = tmp_path / "ckpt" / "hf_import" / "meta.json"
    meta = json.loads(meta_path.read_text())
    meta.setdefault("mesh", {})["pipeline_parallel_size"] = 2
    meta_path.write_text(json.dumps(meta))
    args = ["to-hf", "--ckpt", str(tmp_path / "ckpt"), "--out",
            str(tmp_path / "x"), "--family", "llama", "--config", "tiny",
            "--device", "cpu"]
    convert_checkpoints.main(args)
    assert_same(load_hf_state_dict(str(tmp_path / "x")), sd)
    # the second stage's layer gone from the checkpoint
    model = meta["tensors"]["model"]
    meta["tensors"]["model"] = {k: v for k, v in model.items()
                                if ".layer_1." not in k}
    assert len(meta["tensors"]["model"]) < len(model)
    meta_path.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match=r"missing \['model.layer_1.'\]"):
        convert_checkpoints.main(args)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_clis_raise_without_a_card(tmp_path):
    write_token_file(str(tmp_path / "t.nxdt"),
                     np.arange(512, dtype=np.int32) % 256)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_perplexity.main(["--data", str(tmp_path / "t.nxdt")])
    save_hf_state_dict(hf_state(LlamaConfig.tiny(), 3), str(tmp_path / "hf"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert_checkpoints.main(
            ["to-framework", "--family", "llama", "--config", "tiny",
             "--hf", str(tmp_path / "hf"), "--out", str(tmp_path / "c")])


def jax_tiny_llama():
    """A seed-0 JAX tiny Llama at tp = 1 on one device (fp32): ``(module,
    params)``."""
    jax_mesh.destroy_model_parallel()
    jax_mesh.initialize_model_parallel(tensor_parallel_size=1,
                                       devices=jax.devices()[:1])
    cfg = JaxLlamaConfig.tiny(max_seq_len=S, sequence_parallel=False,
                              remat="none", attention_impl="dense",
                              dtype=jnp.float32, param_dtype=jnp.float32)
    model = jax_init_model(
        nxd.training_config(tensor_parallel_size=1, seed=0,
                            compute_dtype="float32", param_dtype="float32"),
        lambda: JaxLlama(cfg), (jnp.zeros((1, S), jnp.int32),))
    return model.module, model.params


def test_eval_perplexity_matches_jax_loss_sum(tmp_path, capsys):
    module, params = jax_tiny_llama()
    cfg = LlamaConfig.tiny(max_seq_len=S, dtype=torch.float32,
                           param_dtype=torch.float32)
    save_checkpoint(str(tmp_path / "ckpt"), "step_0", llama_params_from_jax(
        jax.tree.map(np.asarray, params), cfg))
    data = str(tmp_path / "tokens.nxdt")
    write_token_file(data, np.random.default_rng(0).integers(
        0, 256, size=4096, dtype=np.int32))
    argv = ["--data", data, "--preset", "tiny", "--batch", str(B), "--seq",
            str(S), "--ckpt", str(tmp_path / "ckpt"), "--device", "cpu"]
    assert eval_perplexity.main(argv) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "eval_perplexity"

    total, tok_n = 0.0, 0
    loader = JaxLoader(JaxDataset(data), B, S, seed=0)
    for batch in loader:
        s, t = jax_loss_sum(module, params,
                            {k: jnp.asarray(v) for k, v in batch.items()},
                            None)
        total += float(s)
        tok_n += int(t)
    loader.close()
    assert line["tokens"] == tok_n > 0
    np.testing.assert_allclose(line["loss"], total / tok_n, rtol=1e-5)
    np.testing.assert_allclose(line["value"], np.exp(total / tok_n),
                               rtol=1e-5)
    # the checkpoint's weights were used, not the seed's
    seeded = eval_perplexity.evaluate(argv[:-4] + ["--device", "cpu"])
    assert abs(seeded["loss"] - total / tok_n) > 1e-3


def test_eval_perplexity_gemma2_from_the_seed(tmp_path):
    data = str(tmp_path / "t.nxdt")
    write_token_file(data, np.random.default_rng(1).integers(
        0, 256, size=2048, dtype=np.int32))
    out = eval_perplexity.evaluate(
        ["--data", data, "--family", "gemma2", "--preset", "tiny",
         "--batch", str(B), "--seq", str(S), "--device", "cpu"])
    assert out["tokens"] > 0 and np.isfinite(out["value"])
    assert out["value"] > 1


def test_eval_perplexity_gemma2_at_tp2_is_softcapped(tmp_path):
    """Gemma-2 at tp = 2 evaluates through the softcapped head: a tiny
    checkpoint whose tied table is scaled until the logits pass the final
    softcap (30) well gives the tp = 1 loss in a 2-rank world (a head that
    left the shards uncapped gave a loss far from it)."""
    cfg = Gemma2Config.tiny(max_seq_len=S, dtype=torch.float32,
                            param_dtype=torch.float32)
    model = Gemma2ForCausalLM(cfg, device="cpu").init_random(0)
    with torch.no_grad():
        model.embed.embedding.mul_(200.0)
    save_checkpoint(str(tmp_path / "ckpt"), "step_0", model.state_dict())
    data = str(tmp_path / "t.nxdt")
    write_token_file(data, np.random.default_rng(2).integers(
        0, 256, size=1024, dtype=np.int32))
    argv = ["--data", data, "--family", "gemma2", "--preset", "tiny",
            "--batch", str(B), "--seq", str(S), "--ckpt",
            str(tmp_path / "ckpt"), "--device", "cpu"]
    one = eval_perplexity.evaluate(argv)
    with torch.no_grad():
        ids = torch.as_tensor(np.random.default_rng(3).integers(
            0, 256, (1, S)))
        assert model.embed.attend(model.hidden(ids)).abs().max() > 60.0
    for loss, tokens in spawn(workers.eval_rank, 2, (argv + ["--tp", "2"],),
                              timeout_s=170):
        assert tokens == one["tokens"] > 0
        assert loss == pytest.approx(one["loss"], rel=1e-5)
