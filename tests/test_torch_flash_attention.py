"""PyTorch port: flash attention on the CPU against the JAX kernels.

The same seeded numpy inputs go through the JAX ``flash_attention*`` entries
(the Pallas kernels in interpret mode, as the JAX package's own tests run
them on the CPU) and the port's entries, whose CPU path is the kernels'
plain versions (``flash_fwd_reference``, ``flash_dq_reference``,
``flash_dkv_reference``) under the same ``torch.autograd.Function`` the
card uses, at head_dim 32 and at 256 (the Gemma width).  Forward output,
lse and dq/dk/dv are compared in fp32 to 2e-5 absolute: both sides compute
in fp32 and differ only in summation order.

Rows with no visible key (packing id 0) are compared only where they are
defined: the JAX kernels leave their output undefined (uniform weights over
masked scores), the port writes zeros.  Their upstream gradient is zero in
both, as a packed batch's ignored labels make it, so dk and dv compare in
full.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the modules themselves (each package's ops/__init__ may export a function
# of the same name)
jfa = importlib.import_module("neuronx_distributed_tpu.ops.flash_attention")
fa = importlib.import_module("neuronx_distributed_tpu_torch.ops.flash_attention")

ATOL = 2e-5

# (name, B, HQ, HKV, S, T, causal, window, softcap, sm_scale, segments,
#  lse cotangent)
CASES = [
    ("causal_gqa2", 2, 4, 2, 32, 32, True, None, None, None, False, False),
    ("causal_gqa4_lse", 1, 4, 1, 32, 32, True, None, None, None, False, True),
    ("noncausal_g1", 2, 2, 2, 16, 32, False, None, None, None, False, False),
    ("t_gt_s", 1, 4, 2, 16, 48, True, None, None, None, False, False),
    ("window", 1, 4, 2, 32, 32, True, 8, None, None, False, False),
    ("softcap", 1, 4, 2, 32, 32, True, None, 5.0, 2.0, False, False),
    ("segments", 2, 4, 2, 32, 32, True, None, None, None, True, False),
    ("segments_window_lse", 1, 4, 2, 32, 32, True, 6, None, None, True, True),
    ("window_softcap_lse", 1, 4, 2, 32, 32, True, 8, 5.0, 2.0, False, True),
]


def make_inputs(case, D=32, seed=0):
    """Seeded inputs; q, k, v and dO shrink by ``(32 / D) ** 0.25`` so that
    q.k and dO.v have the same spread at every D (a case's sm_scale and
    softcap bite as at D = 32, and the gradients keep the size ATOL was
    set for)."""
    _, B, HQ, HKV, S, T, *_ = case
    segments, lse_cot = case[10], case[11]
    rs = np.random.RandomState(seed)
    f = lambda *shape: rs.standard_normal(shape).astype(np.float32)  # noqa
    q, k, v, do = f(B, HQ, S, D), f(B, HKV, T, D), f(B, HKV, T, D), \
        f(B, HQ, S, D)
    q, k, v, do = (x * np.float32((32 / D) ** 0.25) for x in (q, k, v, do))
    dlse = f(B, HQ, S) if lse_cot else np.zeros((B, HQ, S), np.float32)
    seg = None
    if segments:  # two documents, then a padding run; batches differ
        seg = np.zeros((B, S), np.int32)
        for b in range(B):
            cut, end = 9 + 3 * b, S - 5 - b
            seg[b, :cut], seg[b, cut:end] = 1, 2
        valid = seg > 0
        do = do * valid[:, None, :, None]
        dlse = dlse * valid[:, None, :]
    return q, k, v, do, dlse, seg


def jax_run(case, q, k, v, do, dlse, seg):
    causal, window, softcap, scale = case[6:10]

    def fn(q, k, v):
        if seg is None:
            return jfa.flash_attention_with_lse(q, k, v, causal, scale, 512,
                                                512, True, window, softcap)
        s = jnp.asarray(seg)
        return jfa.flash_attention_segmented_with_lse(
            q, k, v, s, s, causal, scale, 512, 512, True, window, softcap)

    (o, lse), vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    grads = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    return [np.asarray(x) for x in (o, lse, *grads)]


def port_run(case, q, k, v, do, dlse, seg):
    causal, window, softcap, scale = case[6:10]
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    if seg is None:
        o, lse = fa.flash_attention_with_lse(*leaves, causal, scale, window,
                                             softcap)
    else:
        s = torch.from_numpy(seg)
        o, lse = fa.flash_attention_segmented_with_lse(
            *leaves, s, s, causal, scale, window, softcap)
    ((o * torch.from_numpy(do)).sum()
     + (lse * torch.from_numpy(dlse)).sum()).backward()
    return [x.detach().numpy() for x in (o, lse, *(l.grad for l in leaves))]


@pytest.mark.parametrize(
    "case,D", [pytest.param(c, 32, id=c[0]) for c in CASES]
    + [pytest.param(c, 256, id=f"{c[0]}-d256") for c in CASES])
def test_entries_match_jax_kernels_forward_and_backward(case, D):
    inputs = make_inputs(case, D)
    seg = inputs[-1]
    (jo, jlse, jdq, jdk, jdv) = jax_run(case, *inputs)
    (po, plse, pdq, pdk, pdv) = port_run(case, *inputs)
    rows = (np.ones(po.shape[:1] + po.shape[2:3], bool) if seg is None
            else seg > 0)                                   # [B, S]
    sel = lambda x: x.transpose(0, 2, 1, *range(3, x.ndim))[rows]  # noqa
    np.testing.assert_allclose(sel(po), sel(jo), atol=ATOL, rtol=0)
    np.testing.assert_allclose(sel(plse), sel(jlse), atol=ATOL, rtol=0)
    np.testing.assert_allclose(sel(pdq), sel(jdq), atol=ATOL, rtol=0)
    np.testing.assert_allclose(pdk, jdk, atol=ATOL, rtol=0)
    np.testing.assert_allclose(pdv, jdv, atol=ATOL, rtol=0)
    if seg is not None:  # rows with no visible key: zeros, lse NEG_INF
        pad = ~rows
        o_pad = po.transpose(0, 2, 1, 3)[pad]
        assert np.all(o_pad == 0.0)
        assert np.all(plse.transpose(0, 2, 1)[pad] <= -1e29)
        assert np.all(np.isfinite(pdq)) and np.all(
            pdq.transpose(0, 2, 1, 3)[pad] == 0.0)


@pytest.mark.parametrize("case", [c for c in CASES if not c[10]],
                         ids=[c[0] for c in CASES if not c[10]])
def test_entries_match_mha_reference(case):
    """The port's entry against autograd through the port's dense
    ``mha_reference`` (which holds the JAX ``mha_reference``'s math)."""
    q, k, v, do, _, _ = make_inputs(case, seed=1)
    causal, window, softcap, scale = case[6:10]
    outs = []
    for fn in (fa.flash_attention, fa.mha_reference):
        leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        o = fn(*leaves, causal, scale, window, softcap)
        (o * torch.from_numpy(do)).sum().backward()
        outs.append([o.detach()] + [x.grad for x in leaves])
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_reference_matches_jax(dtype):
    """fp32 to 2e-5; bf16 to 2e-2 (the probabilities are rounded to bf16
    before p.V on both sides, and the outputs are bf16)."""
    case = CASES[3]  # causal, GQA, T > S
    q, k, v, *_ = make_inputs(case, seed=2)
    jd = getattr(jnp, dtype)
    td = getattr(torch, dtype)
    for window, softcap in ((None, None), (5, 3.0)):
        j = jfa.mha_reference(*(jnp.asarray(x, jd) for x in (q, k, v)),
                              True, None, window, softcap)
        t = fa.mha_reference(*(torch.from_numpy(x).to(td) for x in (q, k, v)),
                             True, None, window, softcap)
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j, np.float32),
                                   atol=ATOL if dtype == "float32" else 2e-2,
                                   rtol=0)


def test_cpu_wrappers_run_the_plain_versions_without_counting():
    case = CASES[0]
    q, k, v, do, _, _ = make_inputs(case)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    before = (fa.flash_attention_fwd.launches, fa.flash_attention_dq.launches,
              fa.flash_attention_dkv.launches)
    o, lse = fa.flash_attention_fwd(tq, tk, tv)
    ro, rlse = fa.flash_fwd_reference(tq, tk, tv)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    delta = (tdo * o).sum(-1)
    assert torch.equal(fa.flash_attention_dq(tq, tk, tv, tdo, lse, delta),
                       fa.flash_dq_reference(tq, tk, tv, tdo, lse, delta))
    dk, dv = fa.flash_attention_dkv(tq, tk, tv, tdo, lse, delta)
    rdk, rdv = fa.flash_dkv_reference(tq, tk, tv, tdo, lse, delta)
    assert torch.equal(dk, rdk) and torch.equal(dv, rdv)
    assert (fa.flash_attention_fwd.launches, fa.flash_attention_dq.launches,
            fa.flash_attention_dkv.launches) == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_attention_fwd(tq.to("meta"), tk.to("meta"), tv.to("meta"))


def test_option_and_shape_refusals():
    q, k, v, *_ = (torch.from_numpy(x) for x in make_inputs(CASES[0])[:3])
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, k, v, causal=False, window=4)
    with pytest.raises(ValueError, match="softcap"):
        fa.flash_attention(q, k, v, softcap=0.0)
    with pytest.raises(ValueError, match="group"):
        fa.flash_attention(q[:, :3], k, v)
    with pytest.raises(ValueError, match="segment"):
        fa.flash_attention_segmented(q, k, v, torch.ones(2, 5), torch.ones(2, 32))
