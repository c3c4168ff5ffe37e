"""PyTorch port: Hugging Face conversion (``convert/hf.py``) against the
JAX package.

Seeded numpy HF-layout state dicts go through JAX's
``convert.hf.*_params_from_hf`` (then the port's ``*_params_from_jax``) and
through the port's ``*_params_from_hf``: the two ``state_dict`` s must be
equal bit for bit, for Llama with GQA, Qwen2 with QKV biases, the Mistral
alias, GPT-NeoX, BERT, Gemma and Gemma-2, and so must the ``*_to_hf``
exports.  Tiny ``transformers`` models (configs written here, random
init, no download) check the layouts end to end: the port's fp32 forward
on the converted weights matches their logits within 2e-4, Gemma-2 with
``query_pre_attn_scalar`` apart from ``head_dim`` included.  Round trips
are bit-equal in fp32, and in bf16 for Gemma (whose ``+ 1`` norm fold is
done in fp32).  Also: the QKV-bias refusal, layer stacking, the pipelined
exports, the safetensors reader and writer against the ``safetensors``
package, and the Llama-family presets against JAX's.
"""

import dataclasses
import os

# transformers loads TensorFlow, where it is installed, unless told not to;
# set before anything imports it
os.environ.setdefault("USE_TF", "0")

import numpy as np
import pytest
import torch

import neuronx_distributed_tpu.convert as jconv
from neuronx_distributed_tpu.models import bert as jbert
from neuronx_distributed_tpu.models import gemma as jgemma
from neuronx_distributed_tpu.models import gpt_neox as jneox
from neuronx_distributed_tpu.models import llama as jllama
from neuronx_distributed_tpu.pipeline.partition import (
    layout_from_spans,
    spans_from_cuts,
)
import neuronx_distributed_tpu_torch.convert as conv
from neuronx_distributed_tpu_torch.convert import hf as phf
from neuronx_distributed_tpu_torch.models.bert import BertConfig, BertForPreTraining
from neuronx_distributed_tpu_torch.models.gemma import (
    Gemma2Config,
    Gemma2ForCausalLM,
    GemmaConfig,
    GemmaForCausalLM,
)
from neuronx_distributed_tpu_torch.models.gpt_neox import (
    GPTNeoXConfig,
    GPTNeoXForCausalLM,
)
from neuronx_distributed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

ATOL = 2e-4
H, I, V, L, NQ, NKV, D = 32, 48, 64, 2, 4, 2, 8


def _w(rs, *shape):
    return rs.standard_normal(shape).astype(np.float32)


def _llama_layer(rs, p, nq=NQ, nkv=NKV, bias=False):
    sd = {p + "self_attn.q_proj.weight": _w(rs, nq * D, H),
          p + "self_attn.k_proj.weight": _w(rs, nkv * D, H),
          p + "self_attn.v_proj.weight": _w(rs, nkv * D, H),
          p + "self_attn.o_proj.weight": _w(rs, H, nq * D),
          p + "mlp.gate_proj.weight": _w(rs, I, H),
          p + "mlp.up_proj.weight": _w(rs, I, H),
          p + "mlp.down_proj.weight": _w(rs, H, I),
          p + "input_layernorm.weight": _w(rs, H),
          p + "post_attention_layernorm.weight": _w(rs, H)}
    if bias:
        for n, rows in (("q", nq), ("k", nkv), ("v", nkv)):
            sd[p + f"self_attn.{n}_proj.bias"] = _w(rs, rows * D)
    return sd


def llama_sd(seed, bias=False, head=True, gemma2=False, layers=L):
    rs = np.random.RandomState(seed)
    sd = {"model.embed_tokens.weight": _w(rs, V, H),
          "model.norm.weight": _w(rs, H)}
    for i in range(layers):
        p = f"model.layers.{i}."
        sd.update(_llama_layer(rs, p, bias=bias))
        if gemma2:
            sd[p + "pre_feedforward_layernorm.weight"] = _w(rs, H)
            sd[p + "post_feedforward_layernorm.weight"] = _w(rs, H)
    if head:
        sd["lm_head.weight"] = _w(rs, V, H)
    return sd


def neox_sd(seed, layers=L):
    rs = np.random.RandomState(seed)
    sd = {"gpt_neox.embed_in.weight": _w(rs, V, H),
          "gpt_neox.final_layer_norm.weight": _w(rs, H),
          "gpt_neox.final_layer_norm.bias": _w(rs, H),
          "embed_out.weight": _w(rs, V, H)}
    for i in range(layers):
        p = f"gpt_neox.layers.{i}."
        for n in ("input_layernorm", "post_attention_layernorm"):
            sd[p + n + ".weight"], sd[p + n + ".bias"] = _w(rs, H), _w(rs, H)
        for n, (o, k) in (("attention.query_key_value", (3 * H, H)),
                          ("attention.dense", (H, H)),
                          ("mlp.dense_h_to_4h", (I, H)),
                          ("mlp.dense_4h_to_h", (H, I))):
            sd[p + n + ".weight"], sd[p + n + ".bias"] = _w(rs, o, k), _w(rs, o)
    return sd


def bert_sd(seed):
    rs = np.random.RandomState(seed)
    sd = {"bert.embeddings.word_embeddings.weight": _w(rs, V, H),
          "bert.embeddings.position_embeddings.weight": _w(rs, 16, H),
          "bert.embeddings.token_type_embeddings.weight": _w(rs, 2, H)}

    def lin(key, o, k):
        sd[key + ".weight"], sd[key + ".bias"] = _w(rs, o, k), _w(rs, o)

    def norm(key):
        sd[key + ".weight"], sd[key + ".bias"] = _w(rs, H), _w(rs, H)

    norm("bert.embeddings.LayerNorm")
    lin("bert.pooler.dense", H, H)
    for i in range(L):
        p = f"bert.encoder.layer.{i}."
        for n in ("query", "key", "value"):
            lin(p + f"attention.self.{n}", H, H)
        lin(p + "attention.output.dense", H, H)
        norm(p + "attention.output.LayerNorm")
        lin(p + "intermediate.dense", I, H)
        lin(p + "output.dense", H, I)
        norm(p + "output.LayerNorm")
    lin("cls.predictions.transform.dense", H, H)
    norm("cls.predictions.transform.LayerNorm")
    sd["cls.predictions.bias"] = _w(rs, V)
    lin("cls.seq_relationship", 2, H)
    return sd


_LLAMA = dict(vocab_size=V, hidden_size=H, intermediate_size=I, num_layers=L,
              num_heads=NQ, num_kv_heads=NKV)
_GEMMA = dict(_LLAMA, head_dim=D)
_WIDTHS = dict(vocab_size=V, hidden_size=H, intermediate_size=I,
               num_layers=L, num_heads=NQ)

# family -> (HF state dict, JAX config, port config, JAX from/to, port
# from/to)
FAMILIES = {
    "llama_gqa": (lambda: llama_sd(0), jllama.LlamaConfig(**_LLAMA),
                  LlamaConfig(**_LLAMA), jconv.llama_params_from_hf,
                  jconv.llama_params_to_hf, conv.llama_params_from_hf,
                  conv.llama_params_to_hf),
    "llama_tied": (lambda: llama_sd(1, head=False),
                   jllama.LlamaConfig(**_LLAMA), LlamaConfig(**_LLAMA),
                   jconv.llama_params_from_hf, jconv.llama_params_to_hf,
                   conv.llama_params_from_hf, conv.llama_params_to_hf),
    "qwen2": (lambda: llama_sd(2, bias=True),
              jllama.LlamaConfig(**_LLAMA, qkv_bias=True),
              LlamaConfig(**_LLAMA, qkv_bias=True),
              jconv.llama_params_from_hf, jconv.llama_params_to_hf,
              conv.llama_params_from_hf, conv.llama_params_to_hf),
    "mistral": (lambda: llama_sd(3),
                jllama.LlamaConfig(**_LLAMA, sliding_window=8),
                LlamaConfig(**_LLAMA, sliding_window=8),
                jconv.mistral_params_from_hf, jconv.mistral_params_to_hf,
                conv.mistral_params_from_hf, conv.mistral_params_to_hf),
    "gpt_neox": (lambda: neox_sd(4), jneox.GPTNeoXConfig(**_WIDTHS),
                 GPTNeoXConfig(**_WIDTHS), jconv.gpt_neox_params_from_hf,
                 jconv.gpt_neox_params_to_hf, conv.gpt_neox_params_from_hf,
                 conv.gpt_neox_params_to_hf),
    "bert": (lambda: bert_sd(5),
             jbert.BertConfig(**_WIDTHS, max_position_embeddings=16),
             BertConfig(**_WIDTHS, max_position_embeddings=16),
             jconv.bert_params_from_hf, jconv.bert_params_to_hf,
             conv.bert_params_from_hf, conv.bert_params_to_hf),
    "gemma": (lambda: llama_sd(6, head=False), jgemma.GemmaConfig(**_GEMMA),
              GemmaConfig(**_GEMMA), jconv.gemma_params_from_hf,
              jconv.gemma_params_to_hf, conv.gemma_params_from_hf,
              conv.gemma_params_to_hf),
    "gemma2": (lambda: llama_sd(7, head=False, gemma2=True),
               jgemma.Gemma2Config(**_GEMMA), Gemma2Config(**_GEMMA),
               jconv.gemma2_params_from_hf, jconv.gemma2_params_to_hf,
               conv.gemma2_params_from_hf, conv.gemma2_params_to_hf),
}
_JAX_TREE_TO_PORT = {"llama_gqa": conv.llama_params_from_jax,
                     "llama_tied": conv.llama_params_from_jax,
                     "qwen2": conv.llama_params_from_jax,
                     "mistral": conv.llama_params_from_jax,
                     "gpt_neox": conv.gpt_neox_params_from_jax,
                     "bert": conv.bert_params_from_jax,
                     "gemma": conv.gemma_params_from_jax,
                     "gemma2": conv.gemma2_params_from_jax}


def assert_same(got: dict, want: dict):
    """Same keys; every tensor equal to the bit, same dtype and shape."""
    assert set(got) == set(want), (sorted(set(got) ^ set(want)))[:6]
    for k, w in want.items():
        w = torch.from_numpy(np.ascontiguousarray(w)) \
            if not isinstance(w, torch.Tensor) else w
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert torch.equal(g, w), k


@pytest.mark.parametrize("family", list(FAMILIES))
def test_from_hf_matches_jax(family):
    make, jcfg, pcfg, jfrom, _, pfrom, _ = FAMILIES[family]
    sd = make()
    want = _JAX_TREE_TO_PORT[family](jfrom(sd, jcfg), pcfg)
    got = pfrom(sd, pcfg)
    assert_same(got, want)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_to_hf_matches_jax(family):
    make, jcfg, pcfg, jfrom, jto, pfrom, pto = FAMILIES[family]
    tree = jfrom(make(), jcfg)
    want = jto(tree, jcfg)
    got = pto(_JAX_TREE_TO_PORT[family](tree, pcfg), pcfg)
    assert_same(got, want)


@pytest.mark.parametrize("family", [f for f in FAMILIES
                                    if not f.startswith("gemma")])
def test_round_trip_is_bit_equal_fp32(family):
    make, _, pcfg, _, _, pfrom, pto = FAMILIES[family]
    sd = make()
    back = pto(pfrom(sd, pcfg), pcfg)
    if family == "llama_tied":  # the head comes back as its own key
        assert torch.equal(back.pop("lm_head.weight"),
                           torch.from_numpy(sd["model.embed_tokens.weight"]))
    if family == "bert":  # HF's tied decoder comes back as its own keys
        back.pop("cls.predictions.decoder.weight")
        back.pop("cls.predictions.decoder.bias")
    assert_same(back, sd)


@pytest.mark.parametrize("family", ["gemma", "gemma2"])
def test_gemma_round_trip_bf16_is_bit_equal(family):
    """The ``+ 1`` norm fold runs in fp32 and the folded norms stay fp32:
    a bf16 checkpoint's weights come back to the bit (``w + 1 - 1`` is
    exact in fp32 for a bf16 ``w`` of these sizes), in bf16."""
    make, _, pcfg, _, _, pfrom, pto = FAMILIES[family]
    sd = {k: torch.from_numpy(v).to(torch.bfloat16)
          for k, v in make().items()}
    port = pfrom(sd, pcfg)
    norm = "final_norm.weight"
    assert port[norm].dtype == torch.float32
    assert torch.equal(port[norm], sd["model.norm.weight"].float() + 1)
    assert port["embed.embedding"].dtype == torch.bfloat16
    assert_same(pto(port, pcfg), sd)


@pytest.mark.parametrize("family", ["gemma", "gemma2"])
def test_gemma_round_trip_fp32_within_the_fold(family):
    """In fp32 ``(w + 1) - 1`` rounds ``w`` to the grid of ``1 + w`` (as
    JAX's fold does): a norm weight comes back within half an ulp of ``1 +
    |w|``, every other weight to the bit."""
    make, _, pcfg, _, _, pfrom, pto = FAMILIES[family]
    sd = make()
    back = pto(pfrom(sd, pcfg), pcfg)
    assert set(back) == set(sd)
    eps = torch.finfo(torch.float32).eps
    for k, v in sd.items():
        v = torch.from_numpy(v)
        bound = eps * (1 + v.abs()) / 2 if "norm" in k else 0.0
        assert ((back[k] - v).abs() <= bound).all(), k


def test_qkv_bias_refusal():
    sd = llama_sd(8, bias=True)
    with pytest.raises(ValueError, match="qkv_bias") as port:
        conv.llama_params_from_hf(sd, LlamaConfig(**_LLAMA))
    with pytest.raises(ValueError, match="qkv_bias") as jax_:
        jconv.llama_params_from_hf(sd, jllama.LlamaConfig(**_LLAMA))
    assert str(port.value) == str(jax_.value)


def test_tensors_keep_their_device_dtype_and_views():
    """Tensors in, tensors out: bf16 stays bf16, a transpose is a view of
    the source's memory until a module loads it."""
    sd = {k: torch.from_numpy(v).to(torch.bfloat16)
          for k, v in llama_sd(9).items()}
    port = conv.llama_params_from_hf(sd, LlamaConfig(**_LLAMA))
    q = port["model.layer_0.attn.qkv.q_kernel"]
    assert q.dtype == torch.bfloat16
    assert q.data_ptr() == \
        sd["model.layers.0.self_attn.q_proj.weight"].data_ptr()
    model = LlamaForCausalLM(LlamaConfig(**_LLAMA, dtype=torch.bfloat16),
                             device="cpu")
    model.load_state_dict(port)
    back = conv.llama_params_to_hf(model.state_dict(), model.config)
    for k, v in sd.items():
        assert torch.equal(back[k].to(v.dtype), v), k


# -- logits against transformers ------------------------------------------------

S = 20  # past the 8-token windows below, so they bite


@pytest.fixture
def transformers():
    """Only these tests need ``transformers``; without it they skip and
    the parity tests against JAX still run."""
    return pytest.importorskip("transformers")


def _hf_logits(hf, ids):
    with torch.no_grad():
        out = hf(ids)
    return out


def _port_model(cls, cfg, sd):
    model = cls(cfg, device="cpu")
    model.load_state_dict(sd)
    return model.eval()


def _llama_case(transformers, kind):
    common = dict(vocab_size=128, hidden_size=64, intermediate_size=96,
                  num_hidden_layers=2, num_attention_heads=8,
                  num_key_value_heads=2, max_position_embeddings=64,
                  tie_word_embeddings=False)
    port = dict(vocab_size=128, hidden_size=64, intermediate_size=96,
                num_layers=2, num_heads=8, num_kv_heads=2, max_seq_len=64,
                sequence_parallel=False, remat="none", dtype=torch.float32,
                param_dtype=torch.float32)
    if kind == "llama":
        hf_cfg = transformers.LlamaConfig(**common, rms_norm_eps=1e-5,
                                          rope_theta=10000.0)
        return transformers.LlamaForCausalLM, hf_cfg, LlamaConfig(**port)
    if kind == "qwen2":
        hf_cfg = transformers.Qwen2Config(**common, rms_norm_eps=1e-6,
                                          rope_theta=10000.0,
                                          use_sliding_window=False)
        return (transformers.Qwen2ForCausalLM, hf_cfg,
                LlamaConfig(**port, rms_eps=1e-6, qkv_bias=True))
    hf_cfg = transformers.MistralConfig(**common, rms_norm_eps=1e-5,
                                        sliding_window=8)
    return (transformers.MistralForCausalLM, hf_cfg,
            LlamaConfig(**port, sliding_window=8))


@pytest.mark.parametrize("kind", ["llama", "qwen2", "mistral"])
def test_llama_family_logits_match_transformers(transformers, kind):
    hf_cls, hf_cfg, cfg = _llama_case(transformers, kind)
    hf_cfg._attn_implementation = "eager"
    torch.manual_seed(0)
    hf = hf_cls(hf_cfg).eval().float()
    if kind == "qwen2":  # HF zero-inits the biases: make them matter
        with torch.no_grad():
            for n, p in hf.named_parameters():
                if n.endswith("proj.bias"):
                    p.normal_()
    ids = torch.randint(0, 128, (2, S))
    want = _hf_logits(hf, ids).logits
    model = _port_model(LlamaForCausalLM, cfg,
                        conv.llama_params_from_hf(hf.state_dict(), cfg))
    with torch.no_grad():
        got = model(ids)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=ATOL)


def test_gpt_neox_logits_match_transformers(transformers):
    hf_cfg = transformers.GPTNeoXConfig(
        vocab_size=128, hidden_size=64, intermediate_size=256,
        num_hidden_layers=2, num_attention_heads=8,
        max_position_embeddings=64, rotary_pct=0.25, rotary_emb_base=10000,
        use_parallel_residual=True, layer_norm_eps=1e-5, hidden_act="gelu")
    torch.manual_seed(1)
    hf = transformers.GPTNeoXForCausalLM(hf_cfg).eval().float()
    ids = torch.randint(0, 128, (2, S))
    want = _hf_logits(hf, ids).logits
    cfg = GPTNeoXConfig(vocab_size=128, hidden_size=64, intermediate_size=256,
                        num_layers=2, num_heads=8, max_seq_len=64,
                        rotary_pct=0.25, use_parallel_residual=True,
                        sequence_parallel=False, remat="none",
                        dtype=torch.float32)
    model = _port_model(GPTNeoXForCausalLM, cfg,
                        conv.gpt_neox_params_from_hf(hf.state_dict(), cfg))
    with torch.no_grad():
        got = model(ids)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=ATOL)


def test_bert_logits_match_transformers(transformers):
    hf_cfg = transformers.BertConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=8,
        max_position_embeddings=64, type_vocab_size=2,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        layer_norm_eps=1e-12, hidden_act="gelu")
    torch.manual_seed(2)
    hf = transformers.BertForPreTraining(hf_cfg).eval().float()
    ids = torch.randint(0, 128, (2, S))
    out = _hf_logits(hf, ids)
    cfg = BertConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                     num_layers=2, num_heads=8, max_position_embeddings=64,
                     hidden_dropout=0.0, dtype=torch.float32)
    model = _port_model(BertForPreTraining, cfg,
                        conv.bert_params_from_hf(hf.state_dict(), cfg))
    with torch.no_grad():
        mlm, nsp = model(ids)
    torch.testing.assert_close(mlm, out.prediction_logits, atol=ATOL,
                               rtol=ATOL)
    torch.testing.assert_close(nsp, out.seq_relationship_logits, atol=ATOL,
                               rtol=ATOL)


# Gemma-2 at query_pre_attn_scalar 24 against head_dim 16: the score scale
# is 24 ** -0.5, not 16 ** -0.5 (the 27B model's case, which no other
# parity test covers)
@pytest.mark.parametrize("kind", ["gemma", "gemma2", "gemma2_qpas24"])
def test_gemma_logits_match_transformers(transformers, kind):
    common = dict(vocab_size=128, hidden_size=64, intermediate_size=96,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, head_dim=16,
                  max_position_embeddings=64, rms_norm_eps=1e-6,
                  hidden_activation="gelu_pytorch_tanh")
    port = dict(vocab_size=128, hidden_size=64, intermediate_size=96,
                num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                max_seq_len=64, remat="none", dtype=torch.float32,
                param_dtype=torch.float32)
    if kind == "gemma":
        hf_cls = transformers.GemmaForCausalLM
        hf_cfg = transformers.GemmaConfig(**common)
        cfg, cls, from_hf = GemmaConfig(**port), GemmaForCausalLM, \
            conv.gemma_params_from_hf
    else:
        qpas = 24.0 if kind.endswith("24") else 16.0
        hf_cls = transformers.Gemma2ForCausalLM
        hf_cfg = transformers.Gemma2Config(
            **common, query_pre_attn_scalar=qpas, sliding_window=8,
            attn_logit_softcapping=50.0, final_logit_softcapping=30.0)
        cfg = Gemma2Config(**port, query_pre_attn_scalar=qpas,
                           sliding_window=8, attn_softcap=50.0,
                           final_softcap=30.0)
        cls, from_hf = Gemma2ForCausalLM, conv.gemma2_params_from_hf
    hf_cfg._attn_implementation = "eager"
    torch.manual_seed(3)
    hf = hf_cls(hf_cfg).eval().float()
    with torch.no_grad():
        for n, p in hf.named_parameters():
            if "norm" in n:  # HF zero-inits the (1 + w) norms
                p.normal_(0.0, 0.5)
            elif n.endswith(("q_proj.weight", "k_proj.weight")):
                p.normal_(0.0, 0.3)  # scores far from uniform
    ids = torch.randint(0, 128, (2, S))
    want = _hf_logits(hf, ids).logits
    model = _port_model(cls, cfg, from_hf(hf.state_dict(), cfg))
    with torch.no_grad():
        got = model(ids)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=ATOL)
    if kind == "gemma2_qpas24":  # the scale bites: 16 ** -0.5 is far off
        wrong = _port_model(
            cls, dataclasses.replace(cfg, query_pre_attn_scalar=16.0),
            from_hf(hf.state_dict(), cfg))
        with torch.no_grad():
            assert (wrong(ids) - want).abs().max().item() > 100 * ATOL


def test_hf_models_round_trip(transformers):
    """A ``transformers`` state dict back to the bit, old buffers
    (``rotary_emb.inv_freq``, ``position_ids``) skipped as JAX's test
    skips them."""
    torch.manual_seed(4)
    hf_cfg, cfg = _llama_case(transformers, "qwen2")[1:]
    hf = transformers.Qwen2ForCausalLM(hf_cfg).eval().float()
    sd = hf.state_dict()
    back = conv.llama_params_to_hf(conv.llama_params_from_hf(sd, cfg), cfg)
    for k, v in sd.items():
        if k.endswith("rotary_emb.inv_freq") or "position_ids" in k:
            continue
        assert torch.equal(back[k], v), k


# -- layer stacks, pipelined exports ---------------------------------------------


def test_stack_and_unstack_match_jax():
    cfg = jllama.LlamaConfig(**_LLAMA)
    tree = jconv.llama_params_from_hf(llama_sd(10), cfg)
    want = jconv.llama_stack_layers(tree, L)
    got = conv.llama_stack_layers(tree, L)
    flat_w = phf._flatten(want["params"])
    flat_g = phf._flatten(got["params"])
    assert set(flat_w) == set(flat_g)
    for k in flat_w:
        np.testing.assert_array_equal(flat_g[k], flat_w[k], err_msg=k)
    back = conv.llama_unstack_layers(got, L)
    for k, v in phf._flatten(jconv.llama_unstack_layers(want, L)["params"]
                             ).items():
        np.testing.assert_array_equal(phf._flatten(back["params"])[k], v)
    # tensors stack as tensors
    ttree = {k: torch.from_numpy(np.asarray(v))
             for k, v in phf._flatten(tree["params"]).items()}
    nested = {"model": {}, "lm_head": {"kernel": ttree["lm_head.kernel"]}}
    for k, v in ttree.items():
        if k.startswith("model."):
            node = nested["model"]
            *dirs, leaf = k[len("model."):].split(".")
            for d_ in dirs:
                node = node.setdefault(d_, {})
            node[leaf] = v
    st = conv.llama_stack_layers(nested, L)
    assert isinstance(st["model"]["layers"]["attn"]["qkv"]["q_kernel"],
                      torch.Tensor)


def _pipelined_tree(family, rows, padded):
    """A JAX-package pipelined tree: ``{embed, layers: [padded, ...],
    head}`` with real layer ``i`` at row ``rows[i]`` and zeros elsewhere."""
    import jax

    n = len(rows)
    if family == "llama":
        tree = jconv.llama_params_from_hf(
            llama_sd(11, layers=n),
            jllama.LlamaConfig(**dict(_LLAMA, num_layers=n)))["params"]
        body = tree["model"]
        embed = body["embed"]
        head = {"final_norm": body["final_norm"], "lm_head": tree["lm_head"]}
    else:
        body = jconv.gpt_neox_params_from_hf(
            neox_sd(11, layers=n),
            jneox.GPTNeoXConfig(**dict(_WIDTHS, num_layers=n)))["params"]
        embed = body["embed_in"]
        head = {"final_norm": body["final_norm"],
                "embed_out": body["embed_out"]}

    def stack(*leaves):
        out = np.zeros((padded,) + leaves[0].shape, np.float32)
        for leaf, r in zip(leaves, rows):
            out[r] = leaf
        return out

    layers = jax.tree.map(stack, *[body[f"layer_{i}"] for i in range(n)])
    return {"embed": embed, "layers": layers, "head": head}


@pytest.mark.parametrize("family", ["llama", "gpt_neox"])
def test_pipelined_exports_match_jax(family):
    """A pipelined tree with uneven cuts (layers 0-3 on stage 0, 4-5 on
    stage 1, padded to 4 rows a stage): JAX's export of the tree, and the
    port's merge of the two stages' ``state_dict`` s (each only its real
    layers, under the pp = 1 names), are one ``state_dict``."""
    num_layers, cuts = 6, (4,)
    spans = spans_from_cuts(cuts, num_layers)
    padded, rows, _ = layout_from_spans(spans, 2)
    tree = _pipelined_tree(family, rows, padded)
    if family == "llama":
        cfg = LlamaConfig(**dict(_LLAMA, num_layers=num_layers))
        want = conv.llama_params_from_jax(
            jconv.llama_params_from_pipelined(tree, rows), cfg)
        export = conv.llama_params_from_pipelined
    else:
        cfg = GPTNeoXConfig(**dict(_WIDTHS, num_layers=num_layers))
        want = conv.gpt_neox_params_from_jax(
            jconv.gpt_neox_params_from_pipelined(tree, rows), cfg)
        export = conv.gpt_neox_params_from_pipelined
    stages = [conv.pipelined_params_from_jax(
        tree, rows, range(*span), embed=r == 0, head=r == 1, family=family)
        for r, span in enumerate(spans)]
    assert_same(export(stages, rows), want)
    with pytest.raises(ValueError, match="more than one stage"):
        export(stages + stages[1:], rows)
    with pytest.raises(ValueError, match="missing"):
        export(stages[:1], rows)


# -- files ----------------------------------------------------------------------


def _file_tensors():
    g = torch.Generator().manual_seed(13)
    return {"f32": torch.randn(3, 5, generator=g),
            "bf16": torch.randn(4, 7, generator=g).to(torch.bfloat16),
            "f16": torch.randn(6, generator=g).to(torch.float16),
            "i64": torch.arange(5, dtype=torch.int64),
            "i32": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "u8": torch.arange(7, dtype=torch.uint8),
            "bool": torch.tensor([True, False, True]),
            "scalar": torch.tensor(2.5),
            "empty": torch.zeros(0, 4),
            "view": torch.randn(5, 3, generator=g).T}


def test_safetensors_writer_reads_back_through_the_package(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    ts = _file_tensors()
    path = str(tmp_path / "ours.safetensors")
    conv.write_safetensors(path, ts, {"format": "pt"})
    back = st.load_file(path)
    assert set(back) == set(ts)
    for k, v in ts.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


def test_safetensors_reader_reads_the_package(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    ts = {k: v.contiguous() for k, v in _file_tensors().items()}
    path = str(tmp_path / "theirs.safetensors")
    st.save_file(ts, path, metadata={"format": "pt"})
    back = conv.read_safetensors(path)
    assert set(back) == set(ts)
    for k, v in ts.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


def test_hf_directory_round_trip(tmp_path):
    """``save_hf_state_dict`` then ``load_hf_state_dict``; a directory of
    ``pytorch_model.bin`` reads with ``weights_only``; an empty one
    raises."""
    sd = {k: torch.from_numpy(v).to(torch.bfloat16)
          for k, v in llama_sd(14).items()}
    path = conv.save_hf_state_dict(sd, str(tmp_path / "st"))
    assert path.endswith("model.safetensors")
    back = conv.load_hf_state_dict(str(tmp_path / "st"))
    assert_same(back, sd)
    os.makedirs(tmp_path / "bin")
    torch.save(sd, tmp_path / "bin" / "pytorch_model.bin")
    assert_same(conv.load_hf_state_dict(str(tmp_path / "bin")), sd)
    os.makedirs(tmp_path / "none")
    with pytest.raises(FileNotFoundError, match="safetensors"):
        conv.load_hf_state_dict(str(tmp_path / "none"))


# -- presets ----------------------------------------------------------------------


@pytest.mark.parametrize("preset", ["llama2_7b", "llama2_13b", "llama2_70b",
                                    "llama31_8b", "qwen2_7b", "mistral_7b"])
def test_presets_match_jax(preset):
    port = getattr(LlamaConfig, preset)()
    jax_ = getattr(jllama.LlamaConfig, preset)()
    shared = ({f.name for f in dataclasses.fields(port)}
              & {f.name for f in dataclasses.fields(jax_)}) - {
        "dtype", "param_dtype"}
    assert len(shared) > 20
    for name in sorted(shared):
        assert getattr(port, name) == getattr(jax_, name), name
    assert port.head_dim_ == jax_.head_dim_
    assert port.rope_scaling_ == jax_.rope_scaling_
