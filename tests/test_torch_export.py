"""PyTorch port: ``trace/export.py`` and the collective audit
(``obs/hlo_audit.py``) against the JAX package.

- ``parallel_model_save`` / ``parallel_model_load`` on the tiny pair: the
  loaded model's greedy tokens over every decode position equal the
  original port model's and the JAX ``parallel_model_load``'s (exact: the
  token ids), ragged prompts included, and sampled tokens equal the
  original's; ONE loaded decode program serves every position (the offset
  is a 0-d tensor input, not a constant baked into the graph); the
  parameters are stored once (``params.pt``), not in the programs.
- ``comm_audit``: the exported decode program holds no collective (the
  JAX decode program on a one-device mesh holds none either); an FX graph
  with functional ``all_reduce`` and ``all_gather`` on a one-rank gloo
  group counts one of each, with the result bytes of each (exact).
"""

import json
import os
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

import neuronx_distributed_tpu.obs.hlo_audit as jax_hlo
from neuronx_distributed_tpu.trace import (
    parallel_model_load as jax_load,
    parallel_model_save as jax_save,
)
from neuronx_distributed_tpu_torch.obs.hlo_audit import (
    COLLECTIVE_OPS,
    collective_bytes,
    collective_counts,
    comm_audit,
)
from neuronx_distributed_tpu_torch.trace.export import (
    LoadedInferenceModel,
    parallel_model_load,
    parallel_model_save,
)
from torch_port_pair import C, build_pair


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    jpim, tpim, _, _, cfg = build_pair(2, 24, 0)
    root = tmp_path_factory.mktemp("export")
    path = parallel_model_save(str(root / "port"), tpim)
    return jpim, tpim, cfg, path, str(root)


def test_loaded_model_matches_original_and_jax(saved):
    jpim, tpim, cfg, path, root = saved
    loaded = parallel_model_load(path, device="cpu")
    assert isinstance(loaded, LoadedInferenceModel)
    assert sorted(os.listdir(path)) == ["context.pt2", "decode.pt2",
                                        "meta.json", "params.pt"]
    meta = json.load(open(os.path.join(path, "meta.json")))
    assert {k: meta[k] for k in ("batch_size", "context_len",
                                 "max_total_len", "kv_cache_dtype")} == {
        "batch_size": 2, "context_len": C, "max_total_len": 24,
        "kv_cache_dtype": "float32"}
    # the programs hold no weights: params.pt has them once
    params = os.path.getsize(os.path.join(path, "params.pt"))
    assert params > 0.9 * sum(p.numel() * 4
                              for p in tpim.module.parameters())
    rs = np.random.RandomState(4)
    prompt = rs.randint(1, cfg.vocab_size, size=(2, C))
    n = 24 - C  # every decode position of the cache
    want = tpim.generate(prompt, n).numpy()
    got = loaded.generate(prompt, n).numpy()
    np.testing.assert_array_equal(got, want)
    jpath = jax_save(os.path.join(root, "jax"), jpim)
    np.testing.assert_array_equal(
        np.asarray(jax_load(jpath).generate(prompt, n)), got)
    # ragged left-padded prompts and sampled tokens take the same program
    lens = np.array([3, C])
    np.testing.assert_array_equal(
        loaded.generate(prompt, 6, prompt_lens=lens).numpy(),
        tpim.generate(prompt, 6, prompt_lens=lens).numpy())
    np.testing.assert_array_equal(
        loaded.generate(prompt, 6, temperature=0.8, seed=3).numpy(),
        tpim.generate(prompt, 6, temperature=0.8, seed=3).numpy())


def test_one_decode_program_serves_every_position(saved):
    _, tpim, cfg, path, _ = saved
    loaded = parallel_model_load(path, device="cpu")
    rs = np.random.RandomState(5)
    ids = rs.randint(1, cfg.vocab_size, size=(2, C))
    valid0 = torch.ones((2, C), dtype=torch.int32)
    T = 24
    ref_logits, ref_caches = tpim._context_fn(ids, valid0)
    got_logits, got_caches = loaded._context_fn(ids, valid0)
    torch.testing.assert_close(got_logits, ref_logits, rtol=0, atol=0)
    vr = torch.cat([valid0, torch.zeros((2, T - C), dtype=torch.int32)], 1)
    vg = vr.clone()
    tok = torch.from_numpy(rs.randint(1, cfg.vocab_size, size=(2, 1)))
    for off in range(C, T):
        lr, ref_caches, vr = tpim._decode_fn(tok, off, ref_caches, vr)
        lg, got_caches, vg = loaded._decode_fn(tok, off, got_caches, vg)
        # the same ops on the same inputs: bit for bit
        torch.testing.assert_close(lg, lr, rtol=0, atol=0)
        assert torch.equal(vg, vr)
        for (a, b), (c, d) in zip(got_caches, ref_caches):
            assert torch.equal(a, c) and torch.equal(b, d)
        tok = torch.argmax(lr, dim=-1, keepdim=True)


def test_exported_decode_holds_no_collective(saved):
    _, _, _, path, _ = saved
    ep = torch.export.load(os.path.join(path, "decode.pt2"))
    rec = comm_audit(ep, name="decode")
    assert rec["total_collective_count"] == 0
    assert rec["collective_counts"] == {op: 0 for op in COLLECTIVE_OPS}
    assert tuple(COLLECTIVE_OPS) == tuple(jax_hlo.COLLECTIVE_OPS)
    assert rec["schema"] == jax_hlo.HLO_AUDIT_SCHEMA


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_comm_audit_counts_functional_collectives():
    from torch.distributed import _functional_collectives as fc
    from torch.fx.experimental.proxy_tensor import make_fx

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        group = dist.group.WORLD

        def step(x):
            y = fc.all_reduce(x, "sum", group)
            return fc.all_gather_tensor(y * 2, 0, group)

        x = torch.ones(4, 8)
        gm = make_fx(step)(x)
        np.testing.assert_array_equal(gm(x).numpy(), step(x).numpy())
    finally:
        dist.destroy_process_group()
    counts = collective_counts(gm)
    assert counts == {"all-reduce": 1, "all-gather": 1, "reduce-scatter": 0,
                      "collective-permute": 0, "all-to-all": 0}
    # one rank: the gathered result is the input's size
    assert collective_bytes(gm) == {"all-reduce": 128, "all-gather": 128,
                                    "reduce-scatter": 0,
                                    "collective-permute": 0,
                                    "all-to-all": 0}
    rec = comm_audit(gm, name="tp_step")
    assert rec["total_collective_count"] == 2
    assert rec["total_collective_bytes"] == 256
