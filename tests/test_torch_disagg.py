"""PyTorch port: disaggregated serving -- KV page-chain transfer, roles,
the fleet prefix directory, KV migration and the fleet prefix fill --
against the JAX package.

Every JAX oracle test of ``tests/test_disagg.py`` has a counterpart here
(its ``fleet_bench --disagg`` CLI rung excepted), run through both
packages over a side's namespace (:mod:`torch_fleet_pair`) with the two
logs compared:

- transfer over bare pools, fp and int8, page sizes 2 and 4: the export's
  leaves, layout, page count, bytes and fingerprint equal JAX's, and the
  round trip is bit-exact; the port's import writes the pool IN PLACE (the
  same ``data_ptr`` per leaf before and after: captured CUDA graphs keep
  their pool); a bf16 pool's round trip is bit-exact (its leaves are CPU
  tensors of the pool's dtype); a reused prefix, a geometry mismatch and a
  chaos kill at ``kvcache/page_import`` leave the allocator's free count
  and the index exactly as JAX's do;
- roles, the directory and the role-aware policy, op for op;
- the tiny fp32 Llama (page 4, 9 pages, B = 2): a prefill replica and two
  decode replicas give JAX's greedy tokens, placements and one migration
  per migrated request, the same pages exported and imported, no page
  left behind, and the destination prefills nothing for a migrated
  request (its full-hit admission samples the imported payload); an
  engine's ``export_prefix`` leaves are within 1e-5 of JAX's after the
  same prefill; the fleet prefix fill, a chaos kill mid-migration and a
  preempted request's resume go as in JAX.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_fleet_pair import (
    SIDES,
    by_client,
    engine_factory,
    ns,
    pair,
)

ATOL = 1e-5  # export leaves (fp32 KV) after the same prefill


@pytest.fixture(autouse=True)
def _no_plans():
    for side in SIDES:
        ns(side).clear_plan()
    yield
    for side in SIDES:
        ns(side).clear_plan()


def both(fn, *args):
    logs = {}
    for side in SIDES:
        logs[side] = []
        fn(ns(side), logs[side], *args)
    assert logs["port"] == logs["jax"]
    return logs


# -- bare pools ---------------------------------------------------------------------


def _pool(n, num_pages, page_size, quant=None, layers=2, heads=2, dim=4,
          dtype=None):
    if n.side == "jax":
        caches = n.pool.init_page_pool_caches(
            layers, num_pages, page_size, heads, dim,
            dtype=dtype or jnp.float32, quant=quant)
    else:
        caches = n.pool.init_page_pool_caches(
            layers, num_pages, page_size, heads, dim,
            dtype=dtype or torch.float32, device="cpu", quant=quant)
    alloc = n.allocator.BlockAllocator(num_pages)
    return caches, alloc, n.prefix.PrefixIndex(alloc)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      and x.dtype == torch.bfloat16 else x)


def _fill_pages(n, caches, pages, seed=0):
    """The oracle's distinctive content (small integers, exact in int8)."""
    rs = np.random.RandomState(seed)
    out = []
    for layer in caches:
        leaves = []
        for leaf in layer:
            arr = _np(leaf).copy()
            for p in pages:
                arr[p] = rs.randint(1, 20, size=arr.shape[1:]).astype(arr.dtype)
            if n.side == "jax":
                leaves.append(jnp.asarray(arr))
            else:
                leaf.copy_(torch.from_numpy(arr).to(leaf.dtype))
                leaves.append(leaf)
        out.append(tuple(leaves))
    return out


def _committed_chain(n, alloc, index, page_size, n_pages, seed=1):
    rs = np.random.RandomState(seed)
    ids = rs.randint(1, 1000, size=n_pages * page_size).astype(np.int64)
    keys = n.prefix.page_keys(ids, np.ones(len(ids), np.int32), page_size)
    pages = list(alloc.alloc(len(keys)))
    payload = rs.rand(4).astype(np.float32)
    if n.side == "port":
        payload = torch.from_numpy(payload)
    index.insert(keys, pages, payload=payload)
    alloc.free_tail(pages)
    return keys, pages, payload


def _ptrs(caches):
    return [leaf.data_ptr() for layer in caches for leaf in layer]


def _export_log(export):
    return (export.layout, export.n_pages, export.nbytes, export.fingerprint,
            export.pages, [[_np(leaf).tolist() for leaf in layer]
                           for layer in export.leaves])


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("page_size", [2, 4])
def test_export_import_round_trip_bit_exact(quant, page_size):
    def run(n, log):
        src, src_alloc, src_idx = _pool(n, 8, page_size, quant=quant)
        keys, pages, payload = _committed_chain(n, src_alloc, src_idx,
                                                page_size, 3)
        src = _fill_pages(n, src, pages)
        export = n.transfer.export_chain(src, keys, pages,
                                         page_size=page_size,
                                         payload=payload,
                                         registry=n.MetricRegistry())
        assert export.layout == ("int8" if quant else "fp")
        assert export.n_pages == 3 and export.nbytes > 0
        assert export.fingerprint == n.prefix.prefix_fingerprints(
            list(keys))[-1]
        log.append(_export_log(export))
        dst, dst_alloc, dst_idx = _pool(n, 8, page_size, quant=quant)
        before = _ptrs(dst) if n.side == "port" else None
        reg = n.MetricRegistry()
        out = n.transfer.import_chain(dst, dst_idx, export, registry=reg)
        if n.side == "port":
            assert out is dst and _ptrs(dst) == before  # in place
        matched, got = dst_idx.peek(keys)
        assert all(p != 0 for p in matched)
        np.testing.assert_array_equal(_np(got), _np(payload))
        for ls, ld in zip(src, out):
            for a, b in zip(ls, ld):
                np.testing.assert_array_equal(_np(b)[matched], _np(a)[pages])
        assert reg.snapshot()["kvcache/pages_imported_total"] == 3.0
        assert dst_alloc.in_use == 3
        dst_idx.evict(dst_alloc.capacity)
        assert dst_alloc.in_use == 0
        dst_alloc.assert_invariants()
        log.append((matched, dst_alloc.free_count))

    both(run)


def test_bf16_round_trip_bit_exact_in_place():
    """A bf16 pool (no numpy dtype) ships CPU tensors of its own dtype: the
    round trip is bit for bit, into the same storage."""
    n = ns("port")
    src, src_alloc, src_idx = _pool(n, 8, 4, dtype=torch.bfloat16)
    keys, pages, payload = _committed_chain(n, src_alloc, src_idx, 4, 3)
    g = torch.Generator().manual_seed(0)
    for layer in src:
        for leaf in layer:
            leaf.copy_(torch.randn(leaf.shape, generator=g).to(leaf.dtype))
    export = n.transfer.export_chain(src, keys, pages, page_size=4,
                                     payload=payload.to(torch.bfloat16))
    assert export.leaves[0][0].dtype == torch.bfloat16
    assert export.nbytes == 2 * 2 * 3 * (4 * 2 * 4 * 2) + 4 * 2
    dst, _, dst_idx = _pool(n, 8, 4, dtype=torch.bfloat16)
    before = _ptrs(dst)
    n.transfer.import_chain(dst, dst_idx, export)
    assert _ptrs(dst) == before
    matched, got = dst_idx.peek(keys)
    for ls, ld in zip(src, dst):
        for a, b in zip(ls, ld):
            assert torch.equal(b[matched].view(torch.int16),
                               a[pages].view(torch.int16))
    assert torch.equal(got.view(torch.int16),
                       payload.to(torch.bfloat16).view(torch.int16))


def test_import_reuses_cached_prefix_and_is_idempotent():
    def run(n, log):
        src, src_alloc, src_idx = _pool(n, 8, 4)
        keys, pages, payload = _committed_chain(n, src_alloc, src_idx, 4, 3)
        src = _fill_pages(n, src, pages)
        export = n.transfer.export_chain(src, keys, pages, page_size=4,
                                         payload=payload)
        dst, dst_alloc, dst_idx = _pool(n, 8, 4)
        reg = n.MetricRegistry()
        dst = n.transfer.import_chain(dst, dst_idx, export, registry=reg)
        assert dst_alloc.in_use == 3
        dst = n.transfer.import_chain(dst, dst_idx, export, registry=reg)
        assert dst_alloc.in_use == 3
        assert reg.snapshot()["kvcache/pages_imported_total"] == 3.0
        dst_idx.assert_invariants()
        dst_alloc.assert_invariants()
        log.append((dst_alloc.free_count, list(dst_alloc._free)))

    both(run)


def test_import_geometry_mismatch_refuses_before_mutation():
    def run(n, log):
        src, src_alloc, src_idx = _pool(n, 8, 4)
        keys, pages, _ = _committed_chain(n, src_alloc, src_idx, 4, 2)
        export = n.transfer.export_chain(src, keys, pages, page_size=4)
        for bad in (dict(heads=4), dict(layers=3), dict(quant="int8")):
            dst, dst_alloc, dst_idx = _pool(n, 8, 4, **bad)
            with pytest.raises(n.transfer.TransferError) as e:
                n.transfer.import_chain(dst, dst_idx, export)
            assert dst_alloc.in_use == 0 and len(dst_idx) == 0
            log.append(str(e.value).split(":")[0])

    both(run)
    # the port also refuses a dtype it would have to convert silently
    n = ns("port")
    src, src_alloc, src_idx = _pool(n, 8, 4)
    keys, pages, _ = _committed_chain(n, src_alloc, src_idx, 4, 2)
    export = n.transfer.export_chain(src, keys, pages, page_size=4)
    dst, dst_alloc, dst_idx = _pool(n, 8, 4, dtype=torch.bfloat16)
    with pytest.raises(n.transfer.TransferError, match="dtype"):
        n.transfer.import_chain(dst, dst_idx, export)
    assert dst_alloc.in_use == 0 and len(dst_idx) == 0


def test_chaos_kill_mid_import_leaks_nothing_on_either_side():
    def run(n, log):
        src, src_alloc, src_idx = _pool(n, 8, 4)
        keys, pages, payload = _committed_chain(n, src_alloc, src_idx, 4, 3)
        src = _fill_pages(n, src, pages)
        export = n.transfer.export_chain(src, keys, pages, page_size=4,
                                         payload=payload)
        src_in_use = src_alloc.in_use
        dst, dst_alloc, dst_idx = _pool(n, 8, 4)
        free0 = (dst_alloc.free_count, sorted(dst_alloc._free))
        n.install_plan({"faults": [{"point": "kvcache/page_import",
                                    "action": "exception", "count": 1}]})
        try:
            with pytest.raises(Exception) as e:
                n.transfer.import_chain(dst, dst_idx, export)
        finally:
            n.clear_plan()
        assert (dst_alloc.free_count, sorted(dst_alloc._free)) == free0
        assert dst_alloc.in_use == 0 and len(dst_idx) == 0
        dst_alloc.assert_invariants()
        assert src_alloc.in_use == src_in_use
        src_idx.assert_invariants()
        dst = n.transfer.import_chain(dst, dst_idx, export)
        matched, _ = dst_idx.peek(keys)
        assert all(p != 0 for p in matched)
        log.append((type(e.value).__name__, free0, list(dst_alloc._free),
                    matched))

    both(run)


# -- roles, directory, policy ---------------------------------------------------------


def sc_role_envelope(n, log):
    a = {"context_len": 8, "page_size": 4, "kv_pages": 9,
         "kv_page_bytes": 1024, "adapter_pages": 4, "kv_quant": None}
    b = dict(a, kv_pages=33, adapter_pages=8)
    assert n.role_compatible(a, b)
    assert "kv_pages" not in n.role_envelope(a)
    assert not n.role_compatible(a, dict(a, page_size=8))
    assert not n.role_compatible(a, dict(a, kv_quant="int8"))
    n.validate_role(n.ROLE_PREFILL)
    with pytest.raises(ValueError, match="unknown replica role"):
        n.validate_role("prefil")
    log.append((sorted(n.role_envelope(a)), sorted(n.CAPACITY_KEYS)))


def sc_directory_lifecycle(n, log):
    d = n.FleetPrefixDirectory()
    d.credit(0, [10, 20])
    d.credit(1, [20])
    assert d.holders(20) == [0, 1] and d.holders(20, exclude={0}) == [1]
    assert d.holders(99) == []
    d.uncredit(0, 10)
    assert len(d) == 1 and d.holders(10) == []
    d.forget_replica(1)
    assert d.holders(20) == [0]
    d.resync(0, [30])
    assert d.holders(20) == [] and d.holders(30) == [0]
    log.append(len(d))


def _role_views(spec):
    return {rid: {"replica_id": rid, "queue_depth": q, "active": a,
                  "slots": 2, "pages_free": pf,
                  "host_blocked_ms_mean": None, "role": role}
            for rid, (q, a, pf, role) in spec.items()}


def sc_role_aware_policy(n, log):
    views = _role_views({0: (0, 0, 8, "prefill"), 1: (0, 0, 8, "decode"),
                         2: (5, 2, 1, "mixed")})
    shadows = {r: n.ReplicaShadow() for r in views}
    p = n.RoleAwarePolicy()
    assert p.needs_priority and p.needs_fps
    picks = [p.choose([0, 1, 2], views, shadows, [], priority="interactive"),
             p.choose([0, 1, 2], views, shadows, [], priority="batch")]
    shadows[2].credit([7, 8])
    picks.append(p.choose([0, 1, 2], views, shadows, [7, 8],
                          priority="batch"))
    views = _role_views({0: (0, 0, 8, "prefill"), 1: (1, 1, 2, "prefill")})
    picks.append(p.choose([0, 1], views,
                          {0: n.ReplicaShadow(), 1: n.ReplicaShadow()}, [],
                          priority="batch"))
    log.append([(d.replica_id, d.affinity_pages) for d in picks])
    assert log[-1] == [(0, 0), (1, 0), (2, 2), (0, 0)]


def sc_rejects_unknown_role(n, log):
    class Eng:
        def close(self):
            pass

    with pytest.raises(ValueError, match="unknown replica role") as e:
        n.DisaggRouter([n.Replica(0, Eng, role="fast")])
    log.append(str(e.value))


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_role_envelope, sc_directory_lifecycle, sc_role_aware_policy,
    sc_rejects_unknown_role)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_disagg_host_scenario_matches_jax(name):
    both(SCENARIOS[name])


# -- the tiny Llama disaggregated fleet ------------------------------------------------


def _bimodal(vocab, count, rs):
    prompts = [rs.randint(1, vocab, size=int(rs.randint(6, 9))).tolist()
               for _ in range(count)]
    return prompts


def _reqs(n, prompts):
    return [n.Request(request_id=i, prompt_ids=p, max_new_tokens=4,
                      priority="interactive" if i % 2 == 0 else "batch")
            for i, p in enumerate(prompts)]


def _engine_counts(router, name):
    return {rid: r.engine.registry.snapshot().get(name, 0.0)
            for rid, r in router.replicas.items()}


def test_disagg_fleet_migrates_and_equals_jax(tmp_path):
    """A prefill replica and two decode replicas: JAX's tokens, placements
    and migrations; pages exported = pages imported; no page left; router
    records v2 equal JAX's; and a migrated request's destination ran no
    prefill (its admission full-hit the imported chain)."""
    prompts = _bimodal(pair()[4].vocab_size, 6, np.random.RandomState(17))

    def run(n, log):
        stats = str(tmp_path / f"router_stats.{n.side}.jsonl")
        router = n.DisaggRouter(
            [n.Replica(0, engine_factory(n.side), role=n.ROLE_PREFILL),
             n.Replica(1, engine_factory(n.side), role=n.ROLE_DECODE),
             n.Replica(2, engine_factory(n.side), role=n.ROLE_DECODE)],
            stats_path=stats)
        assert router.roles() == {0: "prefill", 1: "decode", 2: "decode"}
        outs = n.replay(router, np.zeros(len(prompts)), _reqs(n, prompts),
                        sleep=lambda s: None)
        got = by_client(router, outs)
        assert len(got) == len(prompts)
        assert all(v[1] == "finished" for v in got.values())
        log.append(got)
        snap = router.registry.snapshot()
        assert snap["router/migrations_total"] >= 1.0
        exported = _engine_counts(router, "kvcache/pages_exported_total")
        imported = _engine_counts(router, "kvcache/pages_imported_total")
        assert sum(exported.values()) == sum(imported.values()) >= 2.0
        skipped = _engine_counts(router, "kvcache/prefill_skipped_total")
        migrated_to = {}
        for v in got.values():
            if v[4]:
                migrated_to[v[2]] = migrated_to.get(v[2], 0) + 1
        for rid, count in migrated_to.items():
            assert skipped[rid] >= count  # no prefill for a migrated request
        log.append((snap["router/migrations_total"], exported, imported,
                    skipped))
        router.assert_invariants()
        for r in router.replicas.values():
            r.engine._kv.assert_invariants()
            assert r.engine._kv.alloc.in_use == len(
                [p for p in r.engine._kv.index._iter() if p.page])
        router.close()
        assert n.validate_jsonl("router_stats", stats) == len(prompts)
        recs = [json.loads(line) for line in open(stats)]
        for r in recs:
            r.pop("time")
        assert all(r["schema"] == "router_stats/2" for r in recs)
        assert all(r["role"] == "decode" for r in recs if r["migrations"])
        log.append(recs)

    both(run)


def test_engine_export_leaves_within_tolerance_of_jax():
    """After the same prefill, an engine's ``export_prefix`` ships leaves
    within 1e-5 of the JAX engine's, with the same keys, pages, bytes and
    fingerprint; the export is one explicit fetch, the import one put."""
    cfg = pair()[4]
    prompt = np.random.RandomState(5).randint(1, cfg.vocab_size,
                                              size=7).tolist()
    exports = {}
    for side in SIDES:
        n = ns(side)
        eng = engine_factory(side)()
        eng.submit(n.Request(request_id=0, prompt_ids=prompt,
                             max_new_tokens=2))
        eng.run_until_complete(max_steps=50)
        (fp,) = [f for f in eng._kv.prefix_fingerprints()
                 if eng.export_prefix(f).n_pages == 2]
        exports[side] = eng.export_prefix(fp)
        if side == "port":
            reg = eng.registry.snapshot()
            fetches = reg["transfer/explicit_fetches_total"]
            dst = engine_factory(side)()
            assert dst.import_prefix(exports[side]) == 2
            assert dst.registry.snapshot()[
                "transfer/explicit_puts_total"] == 1.0
            assert dst.puts == 1
            eng.export_prefix(fp)
            assert eng.registry.snapshot()[
                "transfer/explicit_fetches_total"] == fetches + 1
        eng.close()
    j, p = exports["jax"], exports["port"]
    assert (p.keys, p.pages, p.layout, p.n_pages, p.nbytes, p.fingerprint) \
        == (j.keys, j.pages, j.layout, j.n_pages, j.nbytes, j.fingerprint)
    for lj, lp in zip(j.leaves, p.leaves):
        for a, b in zip(lj, lp):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL)
    np.testing.assert_allclose(p.payload.numpy().reshape(-1),
                               np.asarray(j.payload).reshape(-1), atol=1e-4)


def test_disagg_fleet_prefix_fill_prefills_once_fleet_wide():
    cfg = pair()[4]
    popular = np.random.RandomState(23).randint(1, cfg.vocab_size,
                                                size=8).tolist()

    def run(n, log):
        router = n.DisaggRouter(
            [n.Replica(0, engine_factory(n.side), role=n.ROLE_PREFILL),
             n.Replica(1, engine_factory(n.side), role=n.ROLE_DECODE)],
            migrate_after_prefill=False)
        router.submit(n.Request(request_id=0, prompt_ids=popular,
                                max_new_tokens=4, priority="interactive"))
        first = router.run_until_complete(max_steps=200)
        g1 = router.submit(n.Request(request_id=1, prompt_ids=popular,
                                     max_new_tokens=4, priority="batch"))
        outs = {o.request_id: o for o in router.run_until_complete(200)}
        snap = router.registry.snapshot()
        assert snap["kvcache/fleet_prefix_hits_total"] >= 1.0
        assert outs[g1].state == "finished"
        assert list(outs[g1].token_ids) == list(first[0].token_ids)
        dec = router.replicas[1].engine.registry.snapshot()
        assert dec.get("kvcache/prefix_hits_total", 0.0) >= 1.0
        assert dec.get("kvcache/prefill_skipped_total", 0.0) == 1.0
        router.assert_invariants()
        log.append((list(outs[g1].token_ids), router._tracked[g1].replica_id,
                    snap["kvcache/fleet_prefix_hits_total"],
                    dec.get("kvcache/prefix_hits_total")))
        router.close()

    both(run)


def test_disagg_chaos_kill_mid_migration_aborts_cleanly():
    prompts = _bimodal(pair()[4].vocab_size, 4, np.random.RandomState(29))

    def run(n, log):
        n.install_plan({"faults": [{"point": "kvcache/page_import",
                                    "action": "exception", "count": 1}]})
        try:
            router = n.DisaggRouter(
                [n.Replica(0, engine_factory(n.side), role=n.ROLE_PREFILL),
                 n.Replica(1, engine_factory(n.side), role=n.ROLE_DECODE)])
            outs = n.replay(router, np.zeros(len(prompts)),
                            _reqs(n, prompts), sleep=lambda s: None)
            router.assert_invariants()
        finally:
            n.clear_plan()
        got = by_client(router, outs)
        assert len(got) == len(prompts)
        assert all(v[1] == "finished" for v in got.values())
        for r in router.replicas.values():
            r.engine._kv.assert_invariants()
        log.append(got)
        router.close()

    both(run)


def test_preempted_request_resumes_without_reprefill():
    cfg = pair()[4]
    rs = np.random.RandomState(31)
    prompts = [rs.randint(1, cfg.vocab_size, size=7).tolist()
               for _ in range(3)]

    def run(n, log):
        eng = engine_factory(n.side, num_pages=17)()
        eng.submit(n.Request(request_id=0, prompt_ids=prompts[0],
                             max_new_tokens=6, priority="batch"))
        eng.submit(n.Request(request_id=1, prompt_ids=prompts[1],
                             max_new_tokens=6, priority="batch"))
        outs = eng.step() + eng.step()
        eng.submit(n.Request(request_id=2, prompt_ids=prompts[2],
                             max_new_tokens=4, priority="interactive"))
        while eng.has_work:
            outs += eng.step()
        by = {o.request_id: o for o in outs}
        assert len(by) == 3 and all(o.state == "finished"
                                    for o in by.values())
        snap = eng.registry.snapshot()
        assert snap["serving/preemptions_total"] >= 1.0
        assert snap["kvcache/prefill_skipped_total"] >= 1.0
        eng._kv.assert_invariants()
        log.append(({k: list(o.token_ids) for k, o in by.items()},
                    snap["serving/preemptions_total"],
                    snap["kvcache/prefill_skipped_total"]))
        eng.close()

    both(run)
