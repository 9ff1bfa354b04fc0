"""CUDA kernel tests of the port; they need a card and skip without one.

Run them on a GPU machine with ``python -m pytest -m cuda tests/test_torch_cuda.py``.
The selective-scan kernels are held against their plain PyTorch versions on
the same card: the forward (K1) on all three outputs, the backward (K2) on
every gradient.  Tolerance per element: |got - ref| <= ulp * |ref| + floor *
max |ref|, where ulp is 2^-7 for bf16 outputs (one bf16 rounding of the same
fp32 value may land a bf16 ulp away) and 0 for fp32 ones, and the floor
covers summation order and exp/log1p ulps in fp32: 1e-4 for K1, 1e-5 for K2
(its first run on the H100 measured at most 1.3e-6), 3e-5 for K2 at long
memory (see TOL_BWD_LONG).  K2's dbias in a bf16 run sums ddelta after its
rounding to bf16, where single roundings may flip: floor 1e-3 (measured at
most 1.4e-4).  Two K2 launches are bit-equal.
"""

import math
import os
import sys

import pytest
import torch

from zigma_tpu_torch.models import ZigMa
from zigma_tpu_torch.ops import scan_cuda
from zigma_tpu_torch.ops.selective_scan import (selective_scan,
                                                selective_scan_bwd_ref,
                                                selective_scan_ref)

pytestmark = pytest.mark.cuda
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(0)


def _inputs(gen, batch, L, D, N, dtype):
    r = lambda *s: torch.randn(s, generator=gen, device="cuda")
    return dict(u=r(batch, L, D).to(dtype), delta=(0.5 * r(batch, L, D)).to(dtype),
                A=-torch.exp(0.5 * r(D, N)), B=r(batch, L, N).to(dtype),
                C=r(batch, L, N).to(dtype), bias=0.1 * r(D), Dskip=r(D),
                z=r(batch, L, D).to(dtype), x0=r(batch, N, D))


def _long_memory_inputs(gen, batch, L, D, N, dtype):
    """The flagship's own init (models/mamba.py): dt = softplus(delta +
    bias) in about 0.001-0.1 and A = -(1 ... N), so decays sit near 0.999."""
    d = _inputs(gen, batch, L, D, N, dtype)
    dt = torch.exp(torch.rand(D, generator=gen, device="cuda")
                   * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    d["bias"] = dt + torch.log(-torch.expm1(-dt))
    d["delta"] = (0.1 * torch.randn(batch, L, D, generator=gen,
                                    device="cuda")).to(dtype)
    d["A"] = -torch.arange(1, N + 1, dtype=torch.float32,
                           device="cuda").repeat(D, 1)
    return d


TOL_FP32 = 1e-4
TOL_BWD = 1e-5
TOL_DBIAS_BF16 = 1e-3
# K2 vs plain at long memory, as chip_smoke.TOL_BWD_LONG: both carry each
# decay's rounding over about a thousand steps.  At this file's size
# (2, 1024, 64, 16), chip_smoke's fp32 cases read 8.1e-6 (fused) and 9.0e-6
# (unfused) of max |ref| on dx0, the flagship bf16 one 9.5e-6 (H100 80GB
# HBM3, 700 W); the plain version's own dx0 error against the float64
# adjoint reached 7.5e-6 of max |truth| there, K2's 3.2e-6
TOL_BWD_LONG = 3e-5
TOL_TRUTH_MULT = 4.0
BF16_ULP = 2.0 ** -7
BWD_NAMES = ("du", "ddelta", "dA", "dB", "dC", "dbias", "dx0", "dz", "dD")


def _rel(a, b, ulp=0.0):
    """max over elements of |a - b| - ulp * |b|, over max |b|"""
    a, b = a.float(), b.float()
    return (((a - b).abs() - ulp * b.abs()).max()
            / b.abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("with_x0", [True, False])
@pytest.mark.parametrize("L,D,N", [
    (300, 96, 16), (129, 64, 64), (40, 32, 256), (7, 50, 5),
    # the edges of K1's tiling: L below, at and just past a 128-step chunk
    # (and a single step), D not a multiple of a block's channels, d_state
    # 1 and 17 (one lane, 7 states padded; 4 lanes, 15 states padded)
    (1, 64, 16), (127, 64, 16), (128, 100, 16), (129, 100, 16),
    (50, 70, 1), (50, 40, 17)])
def test_kernel_matches_plain_version(gen, dtype, fused, with_x0, L, D, N):
    d = _inputs(gen, 2, L, D, N, dtype)
    Dk, zk = (d["Dskip"], d["z"]) if fused else (None, None)
    x0 = d["x0"] if with_x0 else None
    with torch.inference_mode():
        got = scan_cuda.selective_scan_fwd_cuda(
            d["u"], d["delta"], d["A"], d["B"], d["C"], d["bias"], Dk, zk, x0)
        ref = selective_scan_ref(d["u"], d["delta"], d["A"], d["B"], d["C"],
                                 Dk, zk, d["bias"], True, x0)
    torch.cuda.synchronize()
    ulp = BF16_ULP if dtype == torch.bfloat16 else 0.0
    assert _rel(got[0], ref[0], ulp) <= TOL_FP32
    assert _rel(got[1], ref[1]) <= TOL_FP32
    assert _rel(got[2], ref[2]) <= TOL_FP32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fused", [True, False])
def test_kernel_matches_plain_version_long_memory(gen, dtype, fused):
    """Decays near 0.999 over L = 1024: the decay's fast exponential adds
    up its error over about a thousand steps."""
    d = _long_memory_inputs(gen, 2, 1024, 64, 16, dtype)
    Dk, zk = (d["Dskip"], d["z"]) if fused else (None, None)
    with torch.inference_mode():
        got = scan_cuda.selective_scan_fwd_cuda(
            d["u"], d["delta"], d["A"], d["B"], d["C"], d["bias"], Dk, zk)
        ref = selective_scan_ref(d["u"], d["delta"], d["A"], d["B"], d["C"],
                                 Dk, zk, d["bias"], True)
    torch.cuda.synchronize()
    ulp = BF16_ULP if dtype == torch.bfloat16 else 0.0
    assert _rel(got[0], ref[0], ulp) <= TOL_FP32
    assert _rel(got[1], ref[1]) <= TOL_FP32
    assert _rel(got[2], ref[2]) <= TOL_FP32


@pytest.mark.parametrize("given", ["D", "z"])
def test_no_grad_scan_with_only_D_or_only_z(gen, given):
    """Without a gradient, D alone or z alone runs K1's core scan and adds
    the skip term or the gate in fp32 torch ops.  fp32, so the comparison
    sees the kernel and not a bf16 rounding of the core output."""
    d = _inputs(gen, 2, 200, 96, 16, torch.float32)
    Dk = d["Dskip"] if given == "D" else None
    zk = d["z"] if given == "z" else None
    args = (d["u"], d["delta"], d["A"], d["B"], d["C"], Dk, zk, d["bias"])
    launches, calls = (scan_cuda.selective_scan_fwd_cuda.launches,
                       selective_scan_ref.calls)
    with torch.inference_mode():
        got, x_last = selective_scan(*args, delta_softplus=True,
                                     return_last_state=True)
        assert scan_cuda.selective_scan_fwd_cuda.launches == launches + 1
        assert selective_scan_ref.calls == calls
        ref, x_ref = selective_scan(*args, delta_softplus=True,
                                    return_last_state=True, backend="ref")
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert _rel(got, ref) <= TOL_FP32
    assert _rel(x_last, x_ref) <= TOL_FP32


def test_flagship_instance_launch_info(gen):
    """The flagship's K1 instance (d_state 16, L 1024, bf16) keeps its
    state in registers without spilling and fits more than one block an
    SM."""
    info = scan_cuda.selective_scan_fwd_launch_info(16, 1024, torch.bfloat16)
    assert info["spill_bytes"] == 0
    assert info["blocks_per_sm"] >= 2
    assert info["threads"] % 32 == 0 and 128 % info["steps_per_chunk"] == 0


def test_cuda_tensor_dispatches_to_kernel(gen):
    d = _inputs(gen, 1, 64, 32, 16, torch.bfloat16)
    launches, calls = scan_cuda.selective_scan_fwd_cuda.launches, selective_scan_ref.calls
    with torch.inference_mode():
        selective_scan(d["u"], d["delta"], d["A"], d["B"], d["C"], d["Dskip"],
                       d["z"], d["bias"], delta_softplus=True)
    assert scan_cuda.selective_scan_fwd_cuda.launches == launches + 1
    assert selective_scan_ref.calls == calls
    with pytest.raises(NotImplementedError, match="later slice"):
        selective_scan(d["u"], d["delta"], d["A"], d["B"], d["C"], d["Dskip"],
                       d["z"], d["bias"], delta_softplus=False)


def test_kernel_refuses_what_it_does_not_take(gen):
    d = _inputs(gen, 1, 8, 8, 257, torch.float32)
    args = (d["u"], d["delta"], d["A"], d["B"], d["C"], d["bias"])
    with pytest.raises(NotImplementedError, match="later slice"):
        scan_cuda.selective_scan_fwd_cuda(*args)
    d = _inputs(gen, 1, 8, 8, 4, torch.float32)
    with pytest.raises(NotImplementedError, match="does not record a gradient"):
        scan_cuda.selective_scan_fwd_cuda(
            d["u"].requires_grad_(), d["delta"], d["A"], d["B"], d["C"],
            d["bias"])
    with pytest.raises(ValueError, match="dtype"):
        scan_cuda.selective_scan_fwd_cuda(
            d["u"].detach().half(), d["delta"].half(), d["A"], d["B"].half(),
            d["C"].half(), d["bias"])


def test_tiny_model_kernel_matches_plain_scan(gen):
    model = ZigMa(in_channels=4, embed_dim=64, depth=2, img_dim=8,
                  scan_type="zigzagN8", use_pe=2, device="cuda", generator=gen)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen, device="cuda"))
    x = torch.randn(2, 4, 8, 8, generator=gen, device="cuda")
    t = torch.rand(2, generator=gen, device="cuda")
    with torch.inference_mode():
        out = model(x, t)
        for blk in model.blocks:
            blk.mixer.scan_backend = "ref"
        ref = model(x, t)
    assert _rel(out, ref) <= TOL_FP32


def _bwd_case(gen, batch, L, D, N, dtype, fused, with_g_last,
              long_memory=False, strided=False):
    d = (_long_memory_inputs if long_memory else _inputs)(gen, batch, L, D, N,
                                                          dtype)
    if strided:
        import chip_smoke
        d = chip_smoke.strided_like_the_model(d)
    d["gy"] = torch.randn(batch, L, D, generator=gen, device="cuda").to(dtype)
    d["g_last"] = torch.randn(batch, N, D, generator=gen, device="cuda")
    Dk, zk = (d["Dskip"], d["z"]) if fused else (None, None)
    gl = d["g_last"] if with_g_last else None
    with torch.no_grad():
        _, carries, _ = scan_cuda.selective_scan_fwd_cuda(
            d["u"], d["delta"], d["A"], d["B"], d["C"], d["bias"], Dk, zk)
        args = (d["u"], d["delta"], d["bias"], d["A"], d["B"], d["C"],
                carries, d["gy"], gl, Dk, zk)
        got = scan_cuda.selective_scan_bwd_cuda(*args)
        again = scan_cuda.selective_scan_bwd_cuda(*args)
        ref = selective_scan_bwd_ref(*args)
    torch.cuda.synchronize()
    return got, again, ref


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("with_g_last", [True, False])
@pytest.mark.parametrize("L,D,N", [
    (300, 96, 16), (129, 64, 64), (40, 32, 256), (7, 50, 5),
    # the edges of K2's tiling: L below, at and just past a 128-step chunk
    # (and a single step), D not a multiple of a block's channels, d_state
    # 1 and 17 (4 lanes of 4 states padded from 1; 8 lanes padded from 17)
    (1, 70, 1), (127, 100, 16), (128, 100, 17), (129, 100, 17)])
def test_backward_kernel_matches_plain_version(gen, dtype, fused, with_g_last,
                                               L, D, N):
    _check_bwd(dtype, fused, *_bwd_case(gen, 2, L, D, N, dtype, fused,
                                        with_g_last))


def _check_bwd(dtype, fused, got, again, ref, tol_fp32=TOL_BWD):
    assert len(got) == len(ref) == (9 if fused else 7)
    for name, g, a, r in zip(BWD_NAMES, got, again, ref):
        assert g.shape == r.shape and g.dtype == r.dtype, name
        assert torch.equal(g, a), name  # no atomics: bit-equal repeats
        ulp = BF16_ULP if g.dtype == torch.bfloat16 else 0.0
        tol = (TOL_DBIAS_BF16 if name == "dbias" and dtype == torch.bfloat16
               else tol_fp32)
        assert _rel(g, r, ulp) <= tol, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fused", [True, False])
def test_backward_kernel_matches_plain_version_long_memory(gen, dtype, fused):
    """Decays near 0.999 over L = 1024: K2 recomputes each state from K1's
    chunk starts with the same fast exponential, and the adjoint carries
    every decay's rounding over about a thousand steps -- the plain
    version's as much as K2's.  So against each other the floor is
    TOL_BWD_LONG; K2 against the float64 adjoint is held in chip_smoke.py
    (and in test_backward_kernel_long_memory_against_float64)."""
    got, again, ref = _bwd_case(gen, 2, 1024, 64, 16, dtype, fused, True,
                                long_memory=True)
    _check_bwd(dtype, fused, got, again, ref, TOL_BWD_LONG)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_long_memory_against_float64(gen, dtype):
    """K2 and the plain fp32 version against chip_smoke.truth_bwd_f64 (the
    fused adjoint in float64) at long memory: K2's error at most
    TOL_TRUTH_MULT times the plain version's on every output (bf16 outputs
    after one bf16 ulp of |truth|; bf16 dbias, which sums the rounded
    ddelta, is left to the test above)."""
    import chip_smoke
    d = _long_memory_inputs(gen, 2, 1024, 64, 16, dtype)
    d["gy"] = torch.randn(2, 1024, 64, generator=gen, device="cuda").to(dtype)
    f32 = {k: v.float() for k, v in d.items()}
    names = ("u", "delta", "bias", "A", "B", "C")
    with torch.no_grad():
        _, carries, _ = scan_cuda.selective_scan_fwd_cuda(
            d["u"], d["delta"], d["A"], d["B"], d["C"], d["bias"], d["Dskip"],
            d["z"])
        got = scan_cuda.selective_scan_bwd_cuda(
            *(d[k] for k in names), carries, d["gy"], None, d["Dskip"], d["z"])
        _, carries_p, _ = selective_scan_ref(
            f32["u"], f32["delta"], f32["A"], f32["B"], f32["C"],
            f32["Dskip"], f32["z"], f32["bias"], True)
        plain = selective_scan_bwd_ref(*(f32[k] for k in names), carries_p,
                                       f32["gy"], None, f32["Dskip"], f32["z"])
        truth = chip_smoke.truth_bwd_f64(
            {k: d[k] for k in ("u", "delta", "A", "B", "C", "bias", "Dskip",
                               "z", "gy")})
    for name, k, p, t in zip(BWD_NAMES, got, plain, truth):
        if name == "dbias" and dtype == torch.bfloat16:
            continue
        scale = t.abs().max().item()
        ulp = BF16_ULP if k.dtype == torch.bfloat16 else 0.0
        e_k = ((k.double() - t).abs() - ulp * t.abs()).max().item() / scale
        e_p = (p.double() - t).abs().max().item() / scale
        assert e_k <= TOL_TRUTH_MULT * max(e_p, 2.0 ** -23), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_strided_inputs(gen, dtype):
    """z, B and C as the model passes them (slices of xz and x_dbl), with
    rows only 2-byte aligned in bf16."""
    _check_bwd(dtype, True, *_bwd_case(gen, 2, 300, 96, 16, dtype, True, True,
                                       strided=True))


def test_backward_flagship_instance_launch_info(gen):
    """The flagship's K2 instance (d_state 16, L 1024, bf16) keeps at most
    128 registers a thread, spills nothing and keeps at least 12 warps
    resident an SM."""
    info = scan_cuda.selective_scan_bwd_launch_info(16, 1024, torch.bfloat16)
    assert info["registers"] <= 128 and info["spill_bytes"] == 0
    assert info["blocks_per_sm"] * info["threads"] // 32 >= 12
    assert 128 % info["steps_per_tile"] == 0


def test_cuda_tensors_under_autograd_run_both_kernels(gen):
    """A gradient through selective_scan on the card launches K1 (with the
    carries) and K2 once each, and the plain versions never."""
    d = _inputs(gen, 1, 200, 32, 16, torch.bfloat16)
    for k in ("u", "delta", "B", "C", "z"):
        d[k].requires_grad_()
    counts = lambda: (scan_cuda.selective_scan_fwd_cuda.launches,
                      scan_cuda.selective_scan_bwd_cuda.launches,
                      selective_scan_ref.calls, selective_scan_bwd_ref.calls)
    before = counts()
    out = selective_scan(d["u"], d["delta"], d["A"], d["B"], d["C"],
                         d["Dskip"], d["z"], d["bias"], delta_softplus=True)
    out.float().sum().backward()
    torch.cuda.synchronize()
    after = counts()
    assert [a - b for a, b in zip(after, before)] == [1, 1, 0, 0]
    assert d["u"].grad.dtype == torch.bfloat16


def test_tiny_model_gradients_kernels_match_plain(gen):
    """Loss and gradients of a perturbed tiny ZigMa (fp32, drop-path 0.1,
    remat) through K1/K2 against the same through the plain versions, with
    the same generator seed (so the same draws and masks)."""
    from zigma_tpu_torch.train import LATENT_SCALE, make_diffusion_loss_fn
    from zigma_tpu_torch.transport import create_transport

    model = ZigMa(in_channels=4, embed_dim=64, depth=2, img_dim=8,
                  scan_type="zigzagN8", use_pe=2, use_checkpoint=True,
                  device="cuda", generator=gen)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen, device="cuda"))
    x = torch.randn(2, 4, 8, 8, generator=gen, device="cuda")
    loss_fn = make_diffusion_loss_fn(model, create_transport(),
                                     latent_scale=LATENT_SCALE)
    results = []
    for backend in ("auto", "ref"):
        for blk in model.blocks:
            blk.mixer.scan_backend = backend
        model.zero_grad(set_to_none=True)
        loss = loss_fn({"x": x}, torch.Generator(device="cuda").manual_seed(3))
        loss.backward()
        results.append((loss.item(), {n: p.grad.clone()
                                      for n, p in model.named_parameters()}))
    (loss_k, gk), (loss_r, gr) = results
    assert abs(loss_k - loss_r) <= TOL_FP32 * abs(loss_r)
    for n in gr:
        assert _rel(gk[n], gr[n]) <= TOL_FP32, n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,L", [(256, 16), (8, 256)])
def test_kernels_at_video_shapes(gen, dtype, batch, L):
    """K1 and K2 at a temporal video layer's length (16: shorter than a
    staged chunk and a forward-pass tile, one reverse tile) with many
    sequences, and at a spatial layer's (256), fused, with z, B and C
    strided as the model passes them."""
    import chip_smoke
    d = chip_smoke.strided_like_the_model(_inputs(gen, batch, L, 96, 16,
                                                  dtype))
    with torch.inference_mode():
        got = scan_cuda.selective_scan_fwd_cuda(
            d["u"], d["delta"], d["A"], d["B"], d["C"], d["bias"],
            d["Dskip"], d["z"])
        ref = selective_scan_ref(d["u"], d["delta"], d["A"], d["B"], d["C"],
                                 d["Dskip"], d["z"], d["bias"], True)
    torch.cuda.synchronize()
    ulp = BF16_ULP if dtype == torch.bfloat16 else 0.0
    assert _rel(got[0], ref[0], ulp) <= TOL_FP32
    assert _rel(got[1], ref[1]) <= TOL_FP32
    assert _rel(got[2], ref[2]) <= TOL_FP32
    _check_bwd(dtype, True, *_bwd_case(gen, batch, L, 96, 16, dtype, True,
                                       True, strided=True))


def test_batch_beyond_the_grid_limit_raises_before_launch(gen):
    """65537 sequences, two past the kernels' gridDim.y limit (a guided
    batch of 128 videos' temporal layers reaches 65536): one wrapper call
    each, which launches on slices of the batch, and every output against
    the plain version; K2 bit-equal over two calls."""
    B, L, D, N = 65537, 4, 16, 4
    d = _inputs(gen, B, L, D, N, torch.bfloat16)
    d["gy"] = torch.randn(B, L, D, generator=gen, device="cuda").to(torch.bfloat16)
    before = (scan_cuda.selective_scan_fwd_cuda.launches,
              scan_cuda.selective_scan_bwd_cuda.launches)
    with torch.no_grad():
        got = scan_cuda.selective_scan_fwd_cuda(
            d["u"], d["delta"], d["A"], d["B"], d["C"], d["bias"], d["Dskip"],
            d["z"])
        ref = selective_scan_ref(d["u"], d["delta"], d["A"], d["B"], d["C"],
                                 d["Dskip"], d["z"], d["bias"], True)
        args = (d["u"], d["delta"], d["bias"], d["A"], d["B"], d["C"], got[1],
                d["gy"], None, d["Dskip"], d["z"])
        bgot = scan_cuda.selective_scan_bwd_cuda(*args)
        again = scan_cuda.selective_scan_bwd_cuda(*args)
        bref = selective_scan_bwd_ref(*args)
    torch.cuda.synchronize()
    assert (scan_cuda.selective_scan_fwd_cuda.launches,
            scan_cuda.selective_scan_bwd_cuda.launches) == (before[0] + 1,
                                                            before[1] + 2)
    assert _rel(got[0], ref[0], BF16_ULP) <= TOL_FP32
    assert _rel(got[1], ref[1]) <= TOL_FP32 and _rel(got[2], ref[2]) <= TOL_FP32
    # the last slice's sequences were written, not left as allocated
    assert _rel(got[2][-2:], ref[2][-2:]) <= TOL_FP32
    _check_bwd(torch.bfloat16, True, bgot, again, bref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_without_bias_and_with_cast_A_D(gen, dtype):
    """delta_bias None, A a transposed view in bf16, D in bf16: K1 without a
    gradient, K1 and K2 under autograd, against the plain versions on the
    same card (the fp32 values of the same A and D); no bias gradient, the
    gradients of A and D in bf16."""
    d = _inputs(gen, 2, 300, 96, 16, dtype)
    A_bf = d["A"].t().contiguous().t().to(torch.bfloat16)  # (96, 16) view
    D_bf = d["Dskip"].to(torch.bfloat16)
    assert not A_bf.is_contiguous()
    launches = scan_cuda.selective_scan_fwd_cuda.launches
    with torch.no_grad():
        got = selective_scan(d["u"], d["delta"], A_bf, d["B"], d["C"], D_bf,
                             d["z"], None, delta_softplus=True)
        ref = selective_scan(d["u"], d["delta"], A_bf, d["B"], d["C"], D_bf,
                             d["z"], None, delta_softplus=True, backend="ref")
    assert scan_cuda.selective_scan_fwd_cuda.launches == launches + 1
    ulp = BF16_ULP if dtype == torch.bfloat16 else 0.0
    assert _rel(got, ref, ulp) <= TOL_FP32
    grads = []
    for backend in ("auto", "ref"):
        u = d["u"].clone().requires_grad_()
        A = A_bf.detach().clone().t().contiguous().t().requires_grad_()
        Dv = D_bf.detach().clone().requires_grad_()
        out = selective_scan(u, d["delta"], A, d["B"], d["C"], Dv, d["z"],
                             None, delta_softplus=True, backend=backend)
        assert out.grad_fn.apply(torch.ones_like(out))[5] is None
        out.float().square().sum().backward()
        grads.append((out.detach(), u.grad, A.grad, Dv.grad))
    torch.cuda.synchronize()
    for g, r in zip(*grads):
        assert g.dtype == r.dtype
        assert _rel(g, r, BF16_ULP if g.dtype == torch.bfloat16 else 0.0) <= TOL_FP32
    assert grads[0][2].dtype == grads[0][3].dtype == torch.bfloat16


def test_ssd_chunked_on_the_card_against_float64(gen):
    """The chunked SSD in fp32 on the card (TF32 off) against the float64
    sequential form: within chip_smoke.TOL_SSD_FP32_MULT of the fp32
    sequential form's error (its first run here read 7.6x; TF32- or
    bf16-class error would read thousands of times)."""
    import chip_smoke
    from zigma_tpu_torch.device import set_precision_flags
    from zigma_tpu_torch.ops.ssd import ssd_scan, ssd_scan_ref
    set_precision_flags()
    b, L, H, P, N = 2, 300, 4, 64, 64
    r = lambda *s: torch.randn(s, generator=gen, device="cuda")
    ins = dict(x=r(b, L, H, P), dt=0.5 * r(b, L, H), A=-torch.exp(0.5 * r(H)),
               B=r(b, L, 1, N), C=r(b, L, 1, N), D=r(H), z=r(b, L, H, P),
               dt_bias=0.1 * r(H))
    truth = ssd_scan_ref(**{k: v.double() for k, v in ins.items()},
                         dt_softplus=True)
    plain = ssd_scan_ref(**ins, dt_softplus=True)
    chunked = ssd_scan(**ins, dt_softplus=True)
    e_p = _rel(plain, truth)
    e_c = _rel(chunked, truth)
    assert e_c <= chip_smoke.TOL_SSD_FP32_MULT * max(e_p, 2.0 ** -23), (e_c,
                                                                       e_p)


def test_tiny_video_model_kernels_match_plain(gen):
    """A perturbed small-width class-conditional video ZigMa (s, s, t
    layers, 4 frames, label drop and remat): forward, loss and gradients
    through K1/K2 against the same through the plain versions, with the
    same generator seed."""
    from zigma_tpu_torch.train import make_diffusion_loss_fn
    from zigma_tpu_torch.transport import create_transport

    model = ZigMa(in_channels=4, embed_dim=64, depth=3, img_dim=8,
                  patch_size=2, scan_type="zzvideo_sst", video_frames=4,
                  tpe=True, use_pe=2, num_classes=5, class_dropout_prob=0.5,
                  use_checkpoint=True, device="cuda", generator=gen)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen, device="cuda"))
    batch = {"x": torch.randn(3, 4, 4, 8, 8, generator=gen, device="cuda"),
             "y": torch.randint(0, 5, (3,), generator=gen, device="cuda")}
    loss_fn = make_diffusion_loss_fn(model, create_transport())
    results = []
    for backend in ("auto", "ref"):
        for blk in model.blocks:
            blk.mixer.scan_backend = backend
        with torch.inference_mode():
            fwd = model(batch["x"], torch.full((3,), 0.3, device="cuda"),
                        batch["y"])
        model.zero_grad(set_to_none=True)
        loss = loss_fn(batch, torch.Generator(device="cuda").manual_seed(3))
        loss.backward()
        results.append((fwd, loss.item(), {
            n: p.grad.clone() for n, p in model.named_parameters()}))
    (fk, loss_k, gk), (fr, loss_r, gr) = results
    assert _rel(fk, fr) <= TOL_FP32
    assert abs(loss_k - loss_r) <= TOL_FP32 * abs(loss_r)
    for n in gr:
        assert _rel(gk[n], gr[n]) <= TOL_FP32, n


@pytest.mark.parametrize("kind", ["text_pe3", "ssm2"])
def test_tiny_text_and_ssm2_models_on_the_card(gen, kind):
    """A perturbed small-width text model (use_pe 3, cross-attention) with
    remat: forward, loss and gradients through K1/K2 against the same
    through the plain versions.  An ssm2 model launches neither kernel, and
    its forward on the card matches the CPU's."""
    from zigma_tpu_torch.device import set_precision_flags
    from zigma_tpu_torch.train import make_diffusion_loss_fn
    from zigma_tpu_torch.transport import create_transport

    set_precision_flags()  # the patch-embed conv in fp32, not TF32
    kw = (dict(has_text=True, d_context=48, use_pe=3) if kind == "text_pe3"
          else dict(ssm_cfg=dict(ssm_version=2, d_state=16, headdim=32),
                    use_pe=2))
    model = ZigMa(in_channels=4, embed_dim=64, depth=2, img_dim=8,
                  scan_type="zigzagN8", use_checkpoint=True, device="cuda",
                  generator=gen, **kw)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen, device="cuda"))
    batch = {"x": torch.randn(3, 4, 8, 8, generator=gen, device="cuda")}
    if kind == "text_pe3":
        batch["y"] = torch.randn(3, 77, 48, generator=gen, device="cuda")
    t = torch.full((3,), 0.3, device="cuda")
    loss_fn = make_diffusion_loss_fn(model, create_transport())
    if kind == "ssm2":
        launches = (scan_cuda.selective_scan_fwd_cuda.launches,
                    scan_cuda.selective_scan_bwd_cuda.launches)
        with torch.inference_mode():
            out = model(batch["x"], t)
        cpu = ZigMa(in_channels=4, embed_dim=64, depth=2, img_dim=8,
                    scan_type="zigzagN8", device="cpu", **kw)
        cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        with torch.inference_mode():
            ref = cpu(batch["x"].cpu(), t.cpu())
        assert _rel(out.cpu(), ref) <= TOL_FP32
        loss_fn(batch, torch.Generator(device="cuda").manual_seed(3)).backward()
        assert (scan_cuda.selective_scan_fwd_cuda.launches,
                scan_cuda.selective_scan_bwd_cuda.launches) == launches
        return
    results = []
    for backend in ("auto", "ref"):
        for blk in model.blocks:
            blk.mixer.scan_backend = backend
        with torch.inference_mode():
            fwd = model(batch["x"], t, batch["y"])
        model.zero_grad(set_to_none=True)
        loss = loss_fn(batch, torch.Generator(device="cuda").manual_seed(3))
        loss.backward()
        results.append((fwd, loss.item(), {
            n: p.grad.clone() for n, p in model.named_parameters()}))
    (fk, loss_k, gk), (fr, loss_r, gr) = results
    assert _rel(fk, fr) <= TOL_FP32
    assert abs(loss_k - loss_r) <= TOL_FP32 * abs(loss_r)
    for n in gr:
        assert _rel(gk[n], gr[n]) <= TOL_FP32, n
