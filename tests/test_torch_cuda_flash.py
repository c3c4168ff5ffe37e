"""PyTorch port: the hand-written CUDA flash-attention kernels on the card.

Every test here needs an NVIDIA GPU (``cuda`` marker) and skips without
one.  The file imports nothing of JAX, so on a machine with a card it runs
on its own:

    python -m pytest --noconftest tests/test_torch_cuda_flash.py -m cuda

Each kernel is held to its plain PyTorch version (fp32, from the same
inputs) row by row: the largest relative L2 error of one row over D,
``|out - ref| / max(|ref|, median row norm / 10)``, so that a late row
whose values are small is held as tightly as an early one (the floor
covers rows that are zero, or near zero by cancellation).  1e-4 for fp32
inputs (the kernels sum in another order), 2e-2 for bf16 (probabilities
and dS are rounded to bf16 before their products, and outputs are bf16).
The lse is fp32 arithmetic on the same inputs in both and is held to
1e-3 absolute.  Rows with no visible key are compared too: the kernels and
the plain versions both give them zeros.
"""

import numpy as np
import pytest
import torch

from neuronx_distributed_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LSE_TOL = 1e-3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def row_err(out, ref):
    ref = ref.float()
    norms = ref.norm(dim=-1)
    nonzero = norms[norms > 0]
    floor = nonzero.median() / 10 if nonzero.numel() else 1.0
    diff = (out.float() - ref).norm(dim=-1)
    return (diff / norms.clamp(min=floor)).max().item()


def rel_l2(out, ref):
    ref = ref.float()
    return ((out.float() - ref).norm() / ref.norm()).item()


def inputs(seed, B, HQ, HKV, S, T, D, dtype, device, segments=False):
    rs = np.random.RandomState(seed)
    f = lambda *shape: torch.from_numpy(  # noqa: E731
        rs.standard_normal(shape).astype(np.float32)).to(device, dtype)
    q, k, v, do = f(B, HQ, S, D), f(B, HKV, T, D), f(B, HKV, T, D), \
        f(B, HQ, S, D)
    seg = None
    if segments:  # three documents, then a padding run (id 0)
        ids = np.zeros((B, T), np.int32)
        cuts = sorted(rs.choice(np.arange(8, T - 8), 3, replace=False))
        for i, (a, b) in enumerate(zip([0] + cuts[:2], cuts)):
            ids[:, a:b] = i + 1
        seg = torch.from_numpy(ids).to(device)
    return q, k, v, do, seg


CASES = [
    # (name, B, HQ, HKV, S, T, causal, window, softcap, sm_scale, segments)
    ("causal_gqa4", 2, 8, 2, 300, 300, True, None, None, None, False),
    ("causal_g1", 2, 4, 4, 200, 200, True, None, None, None, False),
    ("noncausal", 2, 8, 2, 130, 170, False, None, None, None, False),
    ("t_gt_s", 1, 8, 2, 100, 333, True, None, None, None, False),
    ("window", 1, 4, 1, 400, 400, True, 100, None, None, False),
    ("softcap", 1, 4, 2, 150, 150, True, None, 50.0, 2.0, False),
    ("segments", 2, 4, 2, 260, 260, True, None, None, None, True),
    # Gemma-2B's MQA (8 q heads on one kv head) with Gemma-2's window and
    # softcap together
    ("mqa_g8_window_softcap", 1, 8, 1, 230, 230, True, 70, 50.0, 2.0, False),
    # T < S: the first 170 queries come before every key and see none
    ("no_key_rows", 2, 4, 2, 300, 130, True, None, None, None, False),
]


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_kernels_match_plain(dev, case, dtype, D):
    _, B, HQ, HKV, S, T, causal, window, softcap, scale, segs = case
    q, k, v, do, seg = inputs(D + S, B, HQ, HKV, S, T, D, dtype, dev, segs)
    qs = ks = None
    if segs:
        qs, ks = seg[:, :S].contiguous(), seg
    opts = dict(causal=causal, sm_scale=scale, window=window, softcap=softcap)
    n = (fa.flash_attention_fwd.launches, fa.flash_attention_dq.launches,
         fa.flash_attention_dkv.launches)
    o, lse = fa.flash_attention_fwd(q, k, v, qs, ks, **opts)
    delta = (do.float() * o.float()).sum(-1)
    dq = fa.flash_attention_dq(q, k, v, do, lse, delta, qs, ks, **opts)
    dk, dv = fa.flash_attention_dkv(q, k, v, do, lse, delta, qs, ks, **opts)
    torch.cuda.synchronize()
    assert (fa.flash_attention_fwd.launches, fa.flash_attention_dq.launches,
            fa.flash_attention_dkv.launches) == tuple(x + 1 for x in n)
    f32 = [x.float() for x in (q, k, v)]
    ro, rlse = fa.flash_fwd_reference(*f32, qs, ks, **opts)
    # the backward references read the kernel's own o/lse/delta
    rdq = fa.flash_dq_reference(*f32, do.float(), lse, delta, qs, ks, **opts)
    rdk, rdv = fa.flash_dkv_reference(*f32, do.float(), lse, delta, qs, ks,
                                      **opts)
    tol = TOL[dtype]
    for name, out, ref in (("o", o, ro), ("dq", dq, rdq), ("dk", dk, rdk),
                           ("dv", dv, rdv)):
        assert torch.isfinite(out.float()).all(), name
        assert row_err(out, ref) <= tol, (name, row_err(out, ref))
    live = rlse > fa.NEG_INF / 2
    assert (lse[live] - rlse[live]).abs().max().item() <= LSE_TOL
    assert torch.all(lse[~live] <= -1e29)
    assert torch.all(o.float()[~live] == 0)  # rows that see no key
    if case[0] == "no_key_rows":
        assert (~live).sum().item() == B * HQ * (S - T)
    if segs:  # padding rows: zeros in o and dq
        pad = qs == 0
        assert torch.all(o.float().permute(0, 2, 1, 3)[pad] == 0)
        assert torch.all(dq.float().permute(0, 2, 1, 3)[pad] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_autograd_through_kernels_with_lse_cotangent(dev, dtype):
    """``flash_attention_with_lse`` on the card against the same entry on
    the CPU (plain versions, same inputs and types: o is rounded to the
    input type before it enters delta on both), forward and gradients,
    with an lse cotangent; the model's [B, S, N, D] views pass as
    strided inputs."""
    q, k, v, do, _ = inputs(7, 2, 8, 2, 192, 192, 128, dtype, dev)
    qm, km, vm = (x.transpose(1, 2).contiguous().transpose(1, 2)
                  for x in (q, k, v))  # [B, S, N, D] memory, kernel view
    w = torch.from_numpy(np.random.RandomState(8).standard_normal(
        (2, 8, 192)).astype(np.float32))
    grads = {}
    for device in (dev, torch.device("cpu")):
        leaves = [x.detach().to(device) for x in (qm, km, vm)]
        for x in leaves:
            x.requires_grad_()
        o, lse = fa.flash_attention_with_lse(*leaves)
        ((o.float() * do.to(device).float()).sum()
         + (lse * w.to(device)).sum()).backward()
        grads[device.type] = [o.detach()] + [x.grad for x in leaves]
    for name, a, b in zip(("o", "dq", "dk", "dv"), grads["cuda"],
                          grads["cpu"]):
        assert row_err(a.cpu(), b) <= TOL[dtype], name


def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    q, k, v, do, _ = inputs(0, 1, 4, 2, 64, 64, 64, torch.float32, dev)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention_fwd(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_attention_fwd(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_fwd(q[..., :48].contiguous(),
                               k[..., :48].contiguous(),
                               v[..., :48].contiguous())
    z = torch.zeros(1, 4, 8, 256, device=dev)
    n = fa.flash_attention_fwd.launches
    o, _ = fa.flash_attention_fwd(z, z[:, :2], z[:, :2])  # D = 256 launches
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == n + 1
    assert torch.all(o == 0)
    with pytest.raises(ValueError, match="unit stride"):
        fa.flash_attention_fwd(q.transpose(2, 3), k, v)
    with pytest.raises(ValueError, match="on cpu"):
        fa.flash_attention_fwd(q, k.cpu(), v)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention_fwd(q, k, v, causal=False, window=8)
    with pytest.raises(ValueError, match="segment"):
        fa.flash_attention_fwd(q, k, v, torch.ones(1, 64, dtype=torch.int32,
                                                   device=dev), None)
    o, lse = fa.flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_dq(q, k, v, do, lse.double(), lse)


@pytest.mark.parametrize("remat,fwd_per_layer", [("none", 1), ("selective", 2),
                                                 ("full", 2)])
def test_llama_step_through_the_kernels_under_remat(dev, remat, fwd_per_layer):
    """A tiny fp32 Llama on the card: the flash core's loss and every
    parameter's gradient equal the dense core's (1e-4 relative L2: fp32,
    two attention algorithms), and one forward + backward launches the
    forward kernel once per layer, twice under ``selective``/``full``
    remat (the backward recomputes the block), and dq and dk/dv once per
    layer."""
    import dataclasses

    from neuronx_distributed_tpu_torch.models.common import causal_lm_loss
    from neuronx_distributed_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaForCausalLM,
    )

    cfg = LlamaConfig.tiny(num_heads=4, num_kv_heads=2, head_dim=64,
                           dtype=torch.float32, param_dtype=torch.float32,
                           attention_impl="flash", remat=remat)
    rs = np.random.RandomState(0)
    ids = torch.from_numpy(rs.randint(0, cfg.vocab_size, (2, 96))).to(dev)
    batch = {"ids": ids, "labels": torch.roll(ids, -1, 1)}
    runs = {}
    for impl in ("flash", "dense"):
        model = LlamaForCausalLM(dataclasses.replace(cfg, attention_impl=impl),
                                 device=dev).init_random(0)
        n = [fa.flash_attention_fwd.launches, fa.flash_attention_dq.launches,
             fa.flash_attention_dkv.launches]
        loss = causal_lm_loss(model, batch)
        loss.backward()
        torch.cuda.synchronize()
        runs[impl] = (loss.item(), [p.grad.clone() for p in model.parameters()])
        if impl == "flash":
            L = cfg.num_layers
            assert [fa.flash_attention_fwd.launches - n[0],
                    fa.flash_attention_dq.launches - n[1],
                    fa.flash_attention_dkv.launches - n[2]] == [
                        fwd_per_layer * L, L, L]
    assert abs(runs["flash"][0] - runs["dense"][0]) <= 1e-4 * abs(
        runs["dense"][0])
    for g_flash, g_dense in zip(runs["flash"][1], runs["dense"][1]):
        assert rel_l2(g_flash, g_dense) <= 1e-4


def test_gemma2_step_through_the_kernels_at_head_dim_256(dev):
    """A tiny Gemma-2 at head_dim 256 on the card (layer 0 slides over a
    40-token window at S = 96, layer 1 is global; attention softcap 50 and
    the final softcap): the flash core's loss and every parameter's
    gradient equal the dense core's (1e-4 relative L2, fp32), and one
    forward + backward under ``selective`` remat launches the forward
    kernel twice per layer and dq and dk/dv once."""
    import dataclasses

    from neuronx_distributed_tpu_torch.models.common import causal_lm_loss
    from neuronx_distributed_tpu_torch.models.gemma import (
        Gemma2Config,
        Gemma2ForCausalLM,
    )

    cfg = Gemma2Config.tiny(head_dim=256, query_pre_attn_scalar=256.0,
                            sliding_window=40, dtype=torch.float32,
                            param_dtype=torch.float32, remat="selective")
    rs = np.random.RandomState(1)
    ids = torch.from_numpy(rs.randint(0, cfg.vocab_size, (2, 96))).to(dev)
    batch = {"ids": ids, "labels": torch.roll(ids, -1, 1)}
    runs = {}
    for impl in ("flash", "dense"):
        model = Gemma2ForCausalLM(dataclasses.replace(
            cfg, attention_impl=impl), device=dev).init_random(0)
        n = [fa.flash_attention_fwd.launches, fa.flash_attention_dq.launches,
             fa.flash_attention_dkv.launches]
        loss = causal_lm_loss(model, batch)
        loss.backward()
        torch.cuda.synchronize()
        runs[impl] = (loss.item(), [p.grad.clone() for p in model.parameters()])
        if impl == "flash":
            L = cfg.num_layers
            assert [fa.flash_attention_fwd.launches - n[0],
                    fa.flash_attention_dq.launches - n[1],
                    fa.flash_attention_dkv.launches - n[2]] == [2 * L, L, L]
    assert abs(runs["flash"][0] - runs["dense"][0]) <= 1e-4 * abs(
        runs["dense"][0])
    for g_flash, g_dense in zip(runs["flash"][1], runs["dense"][1]):
        assert rel_l2(g_flash, g_dense) <= 1e-4


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_kernels_take_model_layout_views(dev, dtype, D):
    """q, k, v and dO as the model passes them: [B, H, S, D] views of
    [B, S, H, D] memory (TMA maps in the bf16 forward, plain strides in
    the others); o inherits q's strides.  Held to the plain version as in
    test_kernels_match_plain, with a window and a softcap."""
    q, k, v, do, _ = inputs(D + 5, 2, 8, 2, 333, 333, D, dtype, dev)
    q, k, v, do = (x.transpose(1, 2).contiguous().transpose(1, 2)
                   for x in (q, k, v, do))
    assert not q.is_contiguous()
    opts = dict(causal=True, sm_scale=2.0, window=90, softcap=50.0)
    o, lse = fa.flash_attention_fwd(q, k, v, **opts)
    assert o.stride() == q.stride()
    delta = (do.float() * o.float()).sum(-1)
    dq = fa.flash_attention_dq(q, k, v, do, lse, delta, **opts)
    dk, dv = fa.flash_attention_dkv(q, k, v, do, lse, delta, **opts)
    torch.cuda.synchronize()
    f32 = [x.float() for x in (q, k, v)]
    ro, rlse = fa.flash_fwd_reference(*f32, **opts)
    rdq = fa.flash_dq_reference(*f32, do.float(), lse, delta, **opts)
    rdk, rdv = fa.flash_dkv_reference(*f32, do.float(), lse, delta, **opts)
    for name, out, ref in (("o", o, ro), ("dq", dq, rdq), ("dk", dk, rdk),
                           ("dv", dv, rdv)):
        assert row_err(out, ref) <= TOL[dtype], (name, row_err(out, ref))
    assert (lse - rlse).abs().max().item() <= LSE_TOL


@pytest.mark.parametrize("dtype,kernels,others", [
    (torch.bfloat16,
     ("flash_fwd_wgmma_kernel", "flash_dq_wgmma_kernel",
      "flash_dkv_wgmma_kernel"),
     ("flash_fwd_kernel<", "flash_dq_kernel<", "flash_dkv_kernel<")),
    (torch.float32,
     ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel"),
     ("flash_fwd_wgmma_kernel", "flash_dq_wgmma_kernel",
      "flash_dkv_wgmma_kernel"))],
    ids=["bf16", "fp32"])
def test_profiler_names_the_forward_kernel(dev, dtype, kernels, others):
    """A bf16 forward, dq and dk/dv run the warp-specialised wgmma
    kernels, fp32 the mma.sync ones, at every head dim: the device
    kernels that torch.profiler records name them."""
    from torch.profiler import ProfilerActivity, profile

    names = []
    for D in (64, 128, 256):
        q, k, v, do, _ = inputs(D, 1, 4, 2, 256, 256, D, dtype, dev)

        def run():
            o, lse = fa.flash_attention_fwd(q, k, v)
            delta = (do.float() * o.float()).sum(-1)
            fa.flash_attention_dq(q, k, v, do, lse, delta)
            fa.flash_attention_dkv(q, k, v, do, lse, delta)

        run()  # built and warm
        torch.cuda.synchronize()
        for _ in range(3):  # the profiler has returned an empty trace
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize()
            keys = [e.key for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA]
            if all(any(kn in n for n in keys) for kn in kernels):
                break
        for kn in kernels:
            assert any(kn in n for n in keys), (D, kn, keys)
        for kn in others:
            assert not any(kn in n for n in keys), (D, kn, keys)
        names += keys
    assert names


@pytest.mark.parametrize("D", [64, 128, 256])
def test_bf16_dkv_is_deterministic(dev, D):
    """Two bf16 dk/dv calls on the same inputs give bit-identical dk and
    dv: the sums over q rows and over the group's q heads run in
    registers in a fixed order, with no atomics (MQA, G = 8, over several
    q tiles, with a window)."""
    q, k, v, do, _ = inputs(D + 11, 2, 8, 1, 300, 300, D, torch.bfloat16,
                            dev)
    opts = dict(causal=True, window=200)
    _, lse = fa.flash_attention_fwd(q, k, v, **opts)
    delta = torch.randn(lse.shape, generator=torch.Generator().manual_seed(
        D), dtype=torch.float32).to(dev)
    dk1, dv1 = fa.flash_attention_dkv(q, k, v, do, lse, delta, **opts)
    dk2, dv2 = fa.flash_attention_dkv(q, k, v, do, lse, delta, **opts)
    torch.cuda.synchronize()
    assert torch.equal(dk1, dk2) and torch.equal(dv1, dv2)
    assert dk1.abs().max().item() > 0 and dv1.abs().max().item() > 0
