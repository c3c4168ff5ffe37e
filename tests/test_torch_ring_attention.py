"""PyTorch port: context-parallel attention against the JAX package's.

One spawned 4-rank gloo world (``torch_tp_workers.ring_cases``) runs the
port's ``ring_attention`` on each rank's chunk of the same global inputs
at cp = 4, then at cp = 2 (x dp = 2): the contiguous ring (causal and
full), zigzag (inputs in ``zigzag_permute`` order), ulysses (with the kv
heads split over cp, and expanded when they do not split), the
one-neighbour sliding window on the ring (JAX ``tests/test_swa.py:144-242``)
and under ulysses, packed segments on every schedule, softcap and GQA.
The chunks are put back together and held against JAX ``ring_attention``
on virtual CPU devices over the same cp (``use_flash=False`` as JAX
``tests/test_attention.py:139-387`` runs it; the flash chunks, interpreted,
where JAX takes only them: segments and the ring's window) and against
the dense oracle, values and the gradients of ``sum(o * w)``, fp32 at
1e-5 (values) and 1e-4 (gradients, JAX's own bounds).

In this process: the ``S != T`` chunk call (``[C]`` queries against
``2C`` keys, the window schedule's call) of the port's kernel wrappers
against JAX's kernel and dense chunk at the same shapes, which would
differ if the port placed queries at offset 0 instead of ``T - S``; the
zigzag round trip against JAX's permutation; the schedule's chunk calls
(the launches the card counts); and every error JAX raises.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuronx_distributed_tpu.ops.flash_attention import (
    flash_attention_with_lse as jax_flash_with_lse,
)
from neuronx_distributed_tpu.ops.ring_attention import (
    _dense_chunk_attn as jax_dense_chunk,
    ring_attention as jax_ring,
    zigzag_indices as jax_zigzag_indices,
    zigzag_permute as jax_zigzag_permute,
)
from neuronx_distributed_tpu.parallel.mesh import (
    destroy_model_parallel,
    initialize_model_parallel,
)
from neuronx_distributed_tpu_torch.parallel.mesh import ContextParallel
from neuronx_distributed_tpu_torch.utils.distributed import spawn
import torch_tp_workers as workers

fa = importlib.import_module("neuronx_distributed_tpu_torch.ops.flash_attention")
# the module (``ops`` re-exports the function under the module's name)
port_ring = importlib.import_module(
    "neuronx_distributed_tpu_torch.ops.ring_attention")

B, S, D = 2, 32, 8
VAL_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(seed, nq=4, nkv=2, segs=False):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, S, nq, D).astype(np.float32)
    k = rs.randn(B, S, nkv, D).astype(np.float32)
    v = rs.randn(B, S, nkv, D).astype(np.float32)
    w = rs.randn(B, S, nq, D).astype(np.float32)
    out = dict(q=q, k=k, v=v, w=w)
    if segs:
        row = np.zeros(S, np.int32)
        row[:11], row[11:27] = 1, 2     # the tail [27:] is padding
        out["segs"] = np.broadcast_to(row, (B, S)).copy()
        # JAX's kernels leave a row with no visible key undefined: no
        # cotangent enters there
        w[:, row == 0] = 0.0
    return out


# name: (cp, impl, layout, causal, kwargs, input kwargs)
CASES = {
    "ring4_causal": (4, "ring", "contiguous", True, {}, {}),
    "ring4_full": (4, "ring", "contiguous", False, {}, {}),
    "ring4_softcap": (4, "ring", "contiguous", True,
                      dict(softcap=2.0, scale=0.3), {}),
    "ring4_mha": (4, "ring", "contiguous", True, {}, dict(nkv=4)),
    "zigzag4": (4, "ring", "zigzag", True, {}, {}),
    "ulysses4_expand": (4, "ulysses", "contiguous", True, {}, {}),
    "window4": (4, "ring", "contiguous", True, dict(window=6), {}),
    "window4_whole_chunk": (4, "ring", "contiguous", True, dict(window=8),
                            {}),
    "window4_segs": (4, "ring", "contiguous", True, dict(window=5),
                     dict(segs=True)),
    "ring4_segs": (4, "ring", "contiguous", True, {}, dict(segs=True)),
    "ring2_causal": (2, "ring", "contiguous", True, {}, {}),
    "ring2_full": (2, "ring", "contiguous", False, {}, {}),
    "zigzag2": (2, "ring", "zigzag", True, {}, {}),
    "zigzag2_segs": (2, "ring", "zigzag", True, {}, dict(segs=True)),
    "ulysses2": (2, "ulysses", "contiguous", True, {}, {}),
    "ulysses2_window": (2, "ulysses", "contiguous", True, dict(window=7),
                        {}),
    "ulysses2_segs": (2, "ulysses", "contiguous", True,
                      dict(softcap=3.0), dict(segs=True)),
}


def _case(name):
    cp, impl, layout, causal, kw, ikw = CASES[name]
    inp = _inputs(sorted(CASES).index(name), **ikw)
    if layout == "zigzag":
        inp = {k: np.asarray(port_ring.zigzag_permute(v, cp, axis=1))
               for k, v in inp.items()}
    return dict(name=name, cp=cp, impl=impl, layout=layout, causal=causal,
                **kw, **inp)


@pytest.fixture(scope="module")
def world():
    cases = [_case(n) for n in CASES]
    return spawn(workers.ring_cases, 4,
                 ({"degrees": [4, 2], "cases": cases},), timeout_s=170)


def _joined(world, name, key):
    """Each cp rank's chunk of ``key`` in rank order."""
    cp = CASES[name][0]
    parts = {}
    for r in world:
        parts[r[name]["rank"]] = r[name][key]
    assert sorted(parts) == list(range(cp))
    return np.concatenate([parts[i] for i in range(cp)], axis=1)


def _jax_run(case, use_flash):
    """JAX ``ring_attention`` on ``case['cp']`` virtual devices: the output
    and the gradients of ``sum(o * w)``."""
    destroy_model_parallel()
    initialize_model_parallel(context_parallel_size=case["cp"],
                              devices=jax.devices()[:case["cp"]])
    kw = dict(causal=case["causal"], layout=case["layout"],
              cp_impl=case["impl"], window=case.get("window"),
              softcap=case.get("softcap"), sm_scale=case.get("scale"),
              use_flash=use_flash, block_q=8, block_k=8)
    if case.get("segs") is not None:
        kw["segment_ids"] = jnp.asarray(case["segs"])

    def loss(q, k, v):
        return jnp.sum(jax_ring(q, k, v, **kw) * case["w"])

    args = [jnp.asarray(case[x]) for x in "qkv"]
    o = jax.jit(lambda q, k, v: jax_ring(q, k, v, **kw))(*args)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*args)
    destroy_model_parallel()
    return np.asarray(o), [np.asarray(g) for g in grads]


def _dense(case):
    """The dense oracle over the whole sequence (in natural order), its
    output and gradients, put back in the case's layout."""
    t = lambda x: torch.tensor(x).transpose(1, 2)  # noqa: E731
    q, k, v = (t(case[x]).requires_grad_() for x in "qkv")
    nat = case["layout"] == "zigzag"
    cp = case["cp"]
    if nat:
        q, k, v = (port_ring.zigzag_unpermute(x, cp, axis=2).detach()
                   .requires_grad_() for x in (q, k, v))
    w = t(case["w"])
    if nat:
        w = port_ring.zigzag_unpermute(w, cp, axis=2)
    segs = case.get("segs")
    if segs is not None:
        segs = torch.tensor(segs)
        if nat:
            segs = port_ring.zigzag_unpermute(segs, cp, axis=1)
        o = fa.flash_attention_segmented(
            q, k, v, segs, segs, case["causal"], case.get("scale"),
            case.get("window"), case.get("softcap"))
    else:
        o = fa.mha_reference(q, k, v, case["causal"], case.get("scale"),
                             case.get("window"), case.get("softcap"))
    (o * w).sum().backward()
    outs = [o.detach(), q.grad, k.grad, v.grad]
    if nat:
        outs = [port_ring.zigzag_permute(x, cp, axis=2) for x in outs]
    return [x.transpose(1, 2).numpy() for x in outs]


def _live(case):
    """Rows with a visible key: all, or the nonzero segments'."""
    segs = case.get("segs")
    return np.ones((B, S), bool) if segs is None else segs > 0


@pytest.mark.parametrize("name", sorted(CASES))
def test_ring_attention_matches_jax_and_dense(world, name):
    case = _case(name)
    got = [_joined(world, name, key) for key in ("o", "dq", "dk", "dv")]
    flash = case.get("segs") is not None or (
        case.get("window") is not None and case["impl"] == "ring")
    want_o, want_g = _jax_run(case, use_flash=flash)
    dense = _dense(case)
    live = _live(case)
    np.testing.assert_allclose(got[0][live], want_o[live], **VAL_TOL)
    np.testing.assert_allclose(got[0][live], dense[0][live], **VAL_TOL)
    assert np.all(got[0][~live] == 0.0)     # the port's o = 0 rows
    for g, wj, wd, n in zip(got[1:], want_g, dense[1:], "qkv"):
        np.testing.assert_allclose(g, wd, err_msg=f"d{n} vs dense",
                                   **GRAD_TOL)
        if n == "q":   # JAX leaves no-key rows undefined: their dq too
            np.testing.assert_allclose(g[live], wj[live],
                                       err_msg=f"d{n} vs JAX", **GRAD_TOL)
        else:
            np.testing.assert_allclose(g, wj, err_msg=f"d{n} vs JAX",
                                       **GRAD_TOL)


def test_ring_collectives_by_schedule(world):
    """The ring passes KV cp - 1 times forward and again backward, with
    the dk/dv sums cp times; the window schedule one exchange each way;
    ulysses 3 + 3 all-to-alls (q, k, v, then o; the conjugates in
    backward) and no send."""
    for r in world:
        ring = r["ring4_causal"]["counts"]
        assert ring == {"cp_send": 3 + 3 + 4}, ring
        assert r["window4"]["counts"] == {"cp_send": 2}
        uly = r["ulysses4_expand"]["counts"]
        assert uly == {"all_to_all": 8}, uly
        assert r["ulysses2_segs"]["counts"] == {"all_to_all": 8,
                                                "all_gather": 1}


@pytest.mark.parametrize("window", [None, 5])
def test_s_ne_t_chunk_alignment(window):
    """``[C]`` queries against ``2C`` keys (the window schedule's call):
    queries sit at kv offset ``T - S`` in the port's kernels as in JAX's
    kernel and dense chunk.  Top-left alignment (offset 0) would hide
    most keys: the last query would see C keys, not 2C."""
    rs = np.random.RandomState(3)
    C = 16
    q = rs.randn(1, 4, C, D).astype(np.float32)
    k = rs.randn(1, 2, 2 * C, D).astype(np.float32)
    v = rs.randn(1, 2, 2 * C, D).astype(np.float32)
    o, lse = fa.flash_attention_fwd(*(torch.tensor(x) for x in (q, k, v)),
                                    causal=True, window=window)
    jo, jlse = jax_flash_with_lse(*(jnp.asarray(x) for x in (q, k, v)),
                                  True, None, 8, 8, None, window)
    do, dlse = jax_dense_chunk(*(jnp.asarray(x) for x in (q, k, v)), True,
                               D ** -0.5, window)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **VAL_TOL)
    np.testing.assert_allclose(o.numpy(), np.asarray(do), **VAL_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **VAL_TOL)
    po, plse = port_ring._dense_chunk_attn(
        *(torch.tensor(x) for x in (q, k, v)), True, D ** -0.5, window)
    np.testing.assert_allclose(po.numpy(), np.asarray(do), **VAL_TOL)
    np.testing.assert_allclose(plse.numpy(), np.asarray(dlse), **VAL_TOL)
    top_left = fa.mha_reference(*(torch.tensor(x) for x in (
        q, k[:, :, :C], v[:, :, :C])), True, None, window)
    assert not np.allclose(o.numpy(), top_left.numpy(), atol=1e-3)


@pytest.mark.parametrize("cp", [1, 2, 4])
def test_zigzag_round_trip(cp):
    x = np.arange(2 * 48 * 3).reshape(2, 48, 3)
    np.testing.assert_array_equal(
        port_ring.zigzag_indices(48, cp).numpy(),
        np.asarray(jax_zigzag_indices(48, cp)))
    z = port_ring.zigzag_permute(torch.tensor(x), cp, axis=1)
    np.testing.assert_array_equal(z.numpy(), np.asarray(
        jax_zigzag_permute(jnp.asarray(x), cp, axis=1)))
    np.testing.assert_array_equal(
        port_ring.zigzag_unpermute(z, cp, axis=1).numpy(), x)
    np.testing.assert_array_equal(port_ring.zigzag_permute(x, cp, 1),
                                  z.numpy())
    with pytest.raises(ValueError, match="2\\*cp"):
        port_ring.zigzag_indices(50, 4)


def test_schedule_chunk_calls():
    """Calls a rank makes over the whole ring: contiguous causal ``1 +
    rank`` (its own chunk, then each earlier block), full ``cp``, zigzag
    ``3 + 2 (cp - 1)`` on every rank, half chunks each."""
    calls = port_ring.ring_calls
    for cp in (2, 4):
        for r in range(cp):
            n = lambda **kw: sum(len(calls(r, cp, t, 16, **kw))  # noqa
                                 for t in range(cp))
            assert n(causal=True, zigzag=False) == 1 + r
            assert n(causal=False, zigzag=False) == cp
            assert n(causal=True, zigzag=True) == 3 + 2 * (cp - 1)
            rows = {c.q.stop - c.q.start for t in range(cp) for c in
                    calls(r, cp, t, 16, True, True)}
            assert rows == {8}


def test_ring_cp1_is_flash_attention():
    x = _inputs(9)
    q, k, v = (torch.tensor(x[n]) for n in "qkv")
    o = port_ring.ring_attention(q, k, v, cp=ContextParallel())
    ref = fa.flash_attention(*(t.transpose(1, 2) for t in (q, k, v)))
    np.testing.assert_array_equal(o.numpy(), ref.transpose(1, 2).numpy())


def _raises(match, cp=4, **kw):
    x = _inputs(1, **kw.pop("ikw", {}))
    C = S // cp
    q, k, v = (torch.tensor(x[n][:, :kw.pop("rows", C)]) for n in "qkv")
    with pytest.raises(ValueError, match=match):
        port_ring.ring_attention(q, k, v, cp=ContextParallel(cp, 0), **kw)


def test_errors_match_jax():
    """Every refusal of the JAX module, before any communication (a cp
    context without a group)."""
    _raises("unknown layout", layout="spiral")
    _raises("unknown cp_impl", cp_impl="tree")
    _raises("requires causal=True", causal=False,
            segment_ids=torch.ones(B, 8, dtype=torch.int32))
    _raises("window >= 1", window=0)
    _raises("requires causal=True", causal=False, window=4)
    _raises("contiguous", window=4, layout="zigzag")
    _raises("ulysses", window=9)            # > C = 8
    _raises("no load balancing", cp_impl="ulysses", layout="zigzag")
    _raises("divisible by cp", cp_impl="ulysses", ikw=dict(nq=2, nkv=2))
    _raises("causal-only", causal=False, layout="zigzag")
    _raises("2\\*cp", layout="zigzag", rows=7, cp=2)


def test_jax_raises_the_same(devices8):
    """The JAX messages the port keeps (the head-starved ulysses case is
    JAX ``tests/test_attention.py:380``)."""
    initialize_model_parallel(context_parallel_size=4, devices=devices8[:4])
    x = _inputs(1, nq=2, nkv=2)
    q, k, v = (jnp.asarray(x[n]) for n in "qkv")
    with pytest.raises(ValueError, match="divisible by cp"):
        jax_ring(q, k, v, cp_impl="ulysses")
    with pytest.raises(ValueError, match="ulysses"):
        jax_ring(q, k, v, window=9)
    destroy_model_parallel()
