"""PyTorch port: the data pipeline against the JAX package's.

The port reads NXDT files the JAX package writes (and the reverse), and
its loader yields, for every data-parallel rank, epoch and resume skip,
the JAX loader's batches exactly (the same splitmix64 Fisher-Yates in both
native libraries and both numpy fallbacks), as CPU int32 tensors.  The
native path equals the fallback; packing rows, labels, segment ids and
``segment_positions`` equal JAX's.  The prefetcher stages step-indexed
batches, rewinds on a non-sequential step and closes cleanly; the tree
serialization, the scalar log and the convergence comparator give JAX's
answers on the same inputs.
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.data import (
    TokenDataLoader as JaxLoader,
    TokenDataset as JaxDataset,
    write_token_file as jax_write_token_file,
)
from neuronx_distributed_tpu.data.packing import (
    concat_and_chunk as jax_concat_and_chunk,
    pack_documents as jax_pack_documents,
    segment_positions as jax_segment_positions,
)
from neuronx_distributed_tpu.testing import (
    compare_curves as jax_compare_curves,
    smoothed as jax_smoothed,
)
from neuronx_distributed_tpu.utils.serialization import (
    serialize_tree as jax_serialize_tree,
)
from neuronx_distributed_tpu_torch.data import (
    DevicePrefetcher,
    TokenDataLoader,
    TokenDataset,
    read_token_file,
    step_indexed,
    write_token_file,
)
from neuronx_distributed_tpu_torch.data import loader as loader_mod
from neuronx_distributed_tpu_torch.data.packing import (
    IGNORE,
    _assign_rows_py,
    concat_and_chunk,
    pack_documents,
    segment_positions,
)
from neuronx_distributed_tpu_torch.obs import MetricRegistry
from neuronx_distributed_tpu_torch.testing import (
    compare_curves,
    compare_scalar_logs,
    smoothed,
)
from neuronx_distributed_tpu_torch.trainer.scalar_log import ScalarWriter, read_scalars
from neuronx_distributed_tpu_torch.utils.serialization import (
    TensorMeta,
    decode_obj,
    deserialize_tree,
    encode_obj,
    find_loss_from_output_and_spec,
    serialize_tree,
)


@pytest.fixture
def token_file(tmp_path):
    """A corpus the JAX package writes (int32: ids past 65535)."""
    toks = (np.arange(1, 4097, dtype=np.int64) * 37) % 70000
    path = str(tmp_path / "corpus.nxdt")
    jax_write_token_file(path, toks)
    return path, toks


def _all(loader):
    return [(np.asarray(b["ids"]), np.asarray(b["labels"])) for b in loader]


def test_native_library_builds_and_reads_jax_files(token_file):
    path, toks = token_file
    assert loader_mod._load_native() is not None
    ds = TokenDataset(path)
    assert ds.is_native and ds.num_tokens == toks.size
    np.testing.assert_array_equal(read_token_file(path), toks)
    assert ds.max_token_id() == toks.max()
    with pytest.raises(ValueError, match="vocab_size"):
        ds.validate_vocab(int(toks.max()))
    ds.close()


@pytest.mark.parametrize("dtype", [np.uint16, np.int32])
def test_jax_reads_port_files(tmp_path, dtype):
    toks = np.arange(1000).astype(dtype)
    path = str(tmp_path / "t.nxdt")
    write_token_file(path, toks)
    ds = JaxDataset(path)
    assert ds.num_tokens == 1000
    from neuronx_distributed_tpu.data import read_token_file as jax_read

    back = jax_read(path)
    assert back.dtype == dtype
    np.testing.assert_array_equal(back, toks)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("dp_size,epoch,skip", [
    (1, 0, 0), (2, 1, 0), (4, 3, 2), (2, 0, 5)])
def test_batches_equal_jax(token_file, native, dp_size, epoch, skip,
                           monkeypatch):
    """Every rank's batches (ids and shifted labels) equal the JAX
    loader's, native and fallback alike, and come out as int32 tensors."""
    path, _ = token_file
    jds = JaxDataset(path)
    if not native:
        monkeypatch.setattr(loader_mod, "_lib", None)
        monkeypatch.setattr(loader_mod, "_lib_tried", True)
    ds = TokenDataset(path)
    assert ds.is_native == native
    for rank in range(dp_size):
        jl = JaxLoader(jds, batch_size=2, seq_len=32, dp_rank=rank,
                       dp_size=dp_size, seed=11)
        pl = TokenDataLoader(ds, batch_size=2, seq_len=32, dp_rank=rank,
                             dp_size=dp_size, seed=11)
        assert len(jl) == len(pl)
        jl.set_epoch(epoch, skip_batches=skip)
        pl.set_epoch(epoch, skip_batches=skip)
        want, got = _all(jl), list(pl)
        assert len(got) == len(want) > 0
        for (wi, wl), b in zip(want, got):
            assert b["ids"].dtype == torch.int32 and b["ids"].device.type == "cpu"
            np.testing.assert_array_equal(b["ids"].numpy(), wi)
            np.testing.assert_array_equal(b["labels"].numpy(), wl)
        jl.close()
        pl.close()
    ds.close()
    jds.close()


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_fallback_warns_and_native_equals_fallback(token_file, monkeypatch):
    """Without the native library the dataset says so in a warning and
    reports ``is_native`` False; both paths yield the same batches."""
    path, _ = token_file
    monkeypatch.setattr(loader_mod, "_lib", None)
    monkeypatch.setattr(loader_mod, "_lib_tried", True)
    seen = _Records()
    loader_mod.logger.addHandler(seen)
    try:
        fb = TokenDataset(path)
    finally:
        loader_mod.logger.removeHandler(seen)
    assert not fb.is_native
    assert any("numpy fallback" in m for m in seen.messages)
    monkeypatch.undo()
    nat = TokenDataset(path)
    assert nat.is_native
    a = TokenDataLoader(nat, 3, 16, dp_rank=1, dp_size=3, seed=4)
    b = TokenDataLoader(fb, 3, 16, dp_rank=1, dp_size=3, seed=4)
    for e in (0, 2):
        a.set_epoch(e)
        b.set_epoch(e)
        for x, y in zip(a, b):
            assert torch.equal(x["ids"], y["ids"])
            assert torch.equal(x["labels"], y["labels"])
    a.close()
    nat.close()


def test_epoch_exhausts_until_set_epoch_and_step_indexed(token_file):
    """A loader is single-shot between ``set_epoch`` calls; the step-indexed
    facade crosses epochs and re-seeks on any jump, so step ``s`` is
    always the same batch."""
    path, _ = token_file
    ds = TokenDataset(path)
    dl = TokenDataLoader(ds, batch_size=4, seq_len=64, seed=2)
    dl.set_epoch(0)
    n = len(list(dl))
    assert n == len(dl) and list(dl) == []
    data = step_indexed(dl)
    seq = [data(s)["ids"] for s in range(2 * n + 3)]
    again = step_indexed(dl)
    for s in (2 * n + 1, 1, n + 2, 0):
        assert torch.equal(again(s)["ids"], seq[s])
    assert not torch.equal(seq[0], seq[n])  # a new epoch reshuffles
    dl.close()
    ds.close()


def test_native_pack_assign_matches_python():
    rng = np.random.RandomState(0)
    for n, seq_len, window in [(500, 128, 64), (2000, 64, 8), (100, 32, 0)]:
        lengths = rng.randint(1, seq_len + 1, size=n).astype(np.int32)
        rows_n, count_n = loader_mod.native_pack_assign(lengths, seq_len,
                                                        window)
        rows_p, count_p = _assign_rows_py(lengths, seq_len, window)
        assert count_n == count_p
        np.testing.assert_array_equal(rows_n, rows_p)
    with pytest.raises(ValueError, match="length <= seq_len"):
        loader_mod.native_pack_assign(np.asarray([40], np.int32), 32, 64)


@pytest.mark.parametrize("mask_separators", [False, True])
def test_packing_equals_jax(mask_separators):
    rng = np.random.RandomState(1)
    docs = [rng.randint(1, 500, size=rng.randint(1, 90)) for _ in range(60)]
    want = jax_pack_documents(docs, seq_len=32, eos_id=7, pad_id=0,
                              mask_separators=mask_separators)
    got = pack_documents(docs, seq_len=32, eos_id=7, pad_id=0,
                         mask_separators=mask_separators)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(segment_positions(got[2]),
                                  jax_segment_positions(want[2]))
    assert (got[1][got[2] == 0] == IGNORE).all()
    for w, g in zip(jax_concat_and_chunk(docs, 32, 7),
                    concat_and_chunk(docs, 32, 7)):
        np.testing.assert_array_equal(g, w)


def test_packing_small_cases():
    ids, labels, segs = pack_documents(
        [np.array([1, 2, 3]), np.array([4, 5]), np.array([6])], seq_len=8,
        eos_id=99)
    np.testing.assert_array_equal(ids[0], [1, 2, 3, 99, 4, 5, 99, 0])
    np.testing.assert_array_equal(segs[0], [1, 1, 1, 1, 2, 2, 2, 0])
    np.testing.assert_array_equal(segment_positions(segs)[0],
                                  [0, 1, 2, 3, 0, 1, 2, 0])
    ids, labels, _ = pack_documents([np.arange(1, 12)], seq_len=6, eos_id=99)
    np.testing.assert_array_equal(labels[0], [2, 3, 4, 5, 6, 7])


def test_prefetcher_stages_rewinds_and_closes():
    """Step-indexed delivery, a rewind on a non-sequential step (counted),
    the registry's gauges and counters, and a clean close; an iterator
    source cannot rewind."""
    calls = []

    def source(step):
        calls.append(step)
        return {"ids": np.full((2, 3), step, np.int32)}

    reg = MetricRegistry()
    pf = DevicePrefetcher(source, depth=2, device="cpu", registry=reg)
    for s in range(4):
        assert int(pf.get(s)["ids"][0, 0]) == s
    assert int(pf.get(1)["ids"][0, 0]) == 1   # a rollback
    assert int(pf.get(2)["ids"][0, 0]) == 2
    assert pf.rewinds == 1
    snap = reg.snapshot()
    assert snap["data/prefetch_rewinds_total"] == 1
    assert snap["data/prefetch_batches_staged_total"] >= 6
    pf.close()
    assert pf._thread is None and pf._queue.empty()
    with pytest.raises(RuntimeError, match="closed"):
        pf.get(3)
    it = DevicePrefetcher(iter([{"x": np.zeros(1)}] * 3), depth=1,
                          device="cpu")
    it.get(0)
    with pytest.raises(RuntimeError, match="cannot rewind"):
        it.get(0)
    it.close()


def test_prefetcher_surfaces_source_errors():
    def source(step):
        if step == 2:
            raise KeyError("bad batch")
        return {"x": np.zeros(1)}

    with DevicePrefetcher(source, depth=3, device="cpu") as pf:
        pf.get(0)
        pf.get(1)
        with pytest.raises(KeyError, match="bad batch"):
            pf.get(2)


def test_serialize_tree_roundtrip_and_order():
    """The skeleton keeps non-array leaves; arrays come out in JAX's
    traversal order (sorted dict keys)."""
    tree = {"b": {"d": "meta", "c": np.ones((4,), np.float32), "e": 7},
            "a": torch.arange(6).reshape(2, 3).int()}
    skeleton, arrays = serialize_tree(tree)
    _, jax_arrays = jax_serialize_tree({"b": {"d": "meta", "c": np.ones(4),
                                              "e": 7},
                                        "a": np.zeros((2, 3))})
    assert [tuple(np.shape(a)) for a in arrays] == \
        [tuple(np.shape(a)) for a in jax_arrays]
    assert skeleton["a"] == TensorMeta((2, 3), "int32")
    assert skeleton["b"]["d"] == "meta" and skeleton["b"]["e"] == 7
    back = deserialize_tree(skeleton, arrays)
    assert torch.equal(back["a"], tree["a"])
    with pytest.raises(ValueError, match="mismatch"):
        deserialize_tree(skeleton, [arrays[1], arrays[0]])
    out = {"loss": torch.tensor(1.5), "logits": torch.zeros(2, 3)}
    assert float(find_loss_from_output_and_spec(
        out, {"loss": True, "logits": None})) == 1.5
    with pytest.raises(ValueError, match="exactly one"):
        find_loss_from_output_and_spec(out, {"loss": True, "logits": True})
    obj = {"shapes": [(1, 2), (3,)], "tag": "step_5"}
    assert decode_obj(encode_obj(obj)) == obj


def test_scalar_log_and_convergence_equal_jax(tmp_path):
    """The JSONL stream round-trips, and the comparator's answers are
    JAX's on the same curves (and on the two packages' streams)."""
    rng = np.random.RandomState(0)
    golden = list(3.0 - np.linspace(0, 1, 40) + 0.01 * rng.randn(40))
    cand = [g * (1 + 0.004 * rng.randn()) for g in golden]
    assert smoothed(cand, 0.6) == jax_smoothed(cand, 0.6)
    for warm, tol in ((0, 1.0), (5, 0.2)):
        a = compare_curves(cand, golden, warm, tol)
        b = jax_compare_curves(cand, golden, warm, tol)
        assert (a.ok, a.worst_step, a.compared_points) == \
            (b.ok, b.worst_step, b.compared_points)
        assert a.max_deviation_pct == pytest.approx(b.max_deviation_pct)
    for name, curve in (("cand", cand), ("gold", golden)):
        with ScalarWriter(str(tmp_path / name), use_tensorboard=False) as w:
            for s, v in enumerate(curve):
                w.scalars(s, loss=v, grad_norm=1.0)
    assert [r["value"] for r in read_scalars(str(tmp_path / "cand"),
                                             "loss")] == cand
    res = compare_scalar_logs(str(tmp_path / "cand"), str(tmp_path / "gold"),
                              warmup_steps=5, tolerance_pct=0.2)
    assert res.compared_points == 35
    from neuronx_distributed_tpu.testing import (
        compare_scalar_logs as jax_compare_scalar_logs,
    )

    assert jax_compare_scalar_logs(
        str(tmp_path / "cand"), str(tmp_path / "gold"), warmup_steps=5,
        tolerance_pct=0.2).max_deviation_pct == pytest.approx(
            res.max_deviation_pct)
    with open(os.path.join(str(tmp_path / "cand"), "scalars.jsonl")) as f:
        assert set(json.loads(f.readline())) == {"step", "tag", "value",
                                                 "time"}
