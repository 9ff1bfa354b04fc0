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
from zigma_tpu_torch.ops.selective_scan import (kernel_params,
                                                selective_scan,
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
    # without softplus too (dt = delta + bias, delta positive so that the
    # decays stay below 1): K1, against the plain version
    delta = d["delta"].abs() + 0.5
    with torch.inference_mode():
        got = selective_scan(d["u"], delta, d["A"], d["B"], d["C"],
                             d["Dskip"], d["z"], d["bias"],
                             delta_softplus=False)
        ref = selective_scan(d["u"], delta, d["A"], d["B"], d["C"],
                             d["Dskip"], d["z"], d["bias"],
                             delta_softplus=False, backend="ref")
    assert scan_cuda.selective_scan_fwd_cuda.launches == launches + 2
    assert selective_scan_ref.calls == calls + 1
    assert _rel(got, ref, BF16_ULP) <= TOL_FP32


def test_kernel_refuses_what_it_does_not_take(gen):
    d = _inputs(gen, 1, 8, 8, 257, torch.float32)
    args = (d["u"], d["delta"], d["A"], d["B"], d["C"], d["bias"])
    with pytest.raises(NotImplementedError, match="chunked"):
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


def _grouped(gen, d, G, mixed=False):
    """d with B and C grouped (batch, L, G, N); with ``mixed`` B stays
    (batch, L, N), shared by every group."""
    batch, L, N = d["B"].shape
    r = lambda *s: torch.randn(s, generator=gen, device="cuda").to(
        d["B"].dtype)
    return dict(d, B=d["B"] if mixed else r(batch, L, G, N),
                C=r(batch, L, G, N))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("softplus", [True, False])
@pytest.mark.parametrize("G,L,D,N,mixed", [
    (2, 300, 96, 16, False), (4, 129, 64, 64, False), (2, 40, 100, 17, False),
    # a group's tail block (H = 48 against 64 and 32 channels a block)
    (32, 50, 1536, 16, False), (4, 77, 96, 8, True)])
def test_grouped_and_no_softplus_kernels_match_plain(gen, dtype, softplus, G,
                                                     L, D, N, mixed):
    """K1 and K2 with grouped B / C (batch, L, G, N), and without softplus
    (delta positive: dt = delta + bias), against their plain versions, one
    launch each, K2 bit-equal twice."""
    d = _grouped(gen, _inputs(gen, 2, L, D, N, dtype), G, mixed)
    if not softplus:
        d["delta"] = d["delta"].abs() + 0.5
    d["gy"] = torch.randn(2, L, D, generator=gen, device="cuda").to(dtype)
    fwd = (d["u"], d["delta"], d["A"], d["B"], d["C"])
    k1, k2 = (scan_cuda.selective_scan_fwd_cuda.launches,
              scan_cuda.selective_scan_bwd_cuda.launches)
    with torch.no_grad():
        got = scan_cuda.selective_scan_fwd_cuda(
            *fwd, d["bias"], d["Dskip"], d["z"], d["x0"],
            delta_softplus=softplus)
        ref = selective_scan_ref(*fwd, d["Dskip"], d["z"], d["bias"],
                                 softplus, d["x0"])
        args = (d["u"], d["delta"], d["bias"], *fwd[2:], got[1], d["gy"],
                d["x0"], d["Dskip"], d["z"], softplus)
        bwd = scan_cuda.selective_scan_bwd_cuda(*args)
        again = scan_cuda.selective_scan_bwd_cuda(*args)
        ref_b = selective_scan_bwd_ref(*args)
    torch.cuda.synchronize()
    assert scan_cuda.selective_scan_fwd_cuda.launches == k1 + 1
    assert scan_cuda.selective_scan_bwd_cuda.launches == k2 + 2
    ulp = BF16_ULP if dtype == torch.bfloat16 else 0.0
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert _rel(g, r, ulp if g.dtype == torch.bfloat16 else 0.0) <= TOL_FP32
    assert bwd[3].shape == d["B"].shape and bwd[4].shape == d["C"].shape
    _check_bwd(dtype, True, bwd, again, ref_b)


@pytest.mark.parametrize("case", ["complex", "wide_state", "static"])
def test_auto_torch_backends_on_the_card(gen, case):
    """``auto`` on CUDA tensors sends complex A and d_state 300 to the
    chunked backend and static B / C to the associative one: no K1 / K2
    launch; output and gradients against autograd through the plain
    forward on the card (fp32, 1e-5 of max)."""
    from zigma_tpu_torch.ops.scan_chunked import (selective_scan_assoc,
                                                  selective_scan_chunked)
    d = _inputs(gen, 2, 150, 32, 300 if case == "wide_state" else 8,
                torch.float32)
    r = lambda *s: torch.randn(s, generator=gen, device="cuda")
    if case == "complex":
        d["A"] = torch.complex(d["A"], r(*d["A"].shape))
        d["B"] = torch.complex(d["B"], r(*d["B"].shape))
    if case == "static":
        d["B"], d["C"] = r(32, 8), r(32, 8)
    counter = selective_scan_assoc if case == "static" else \
        selective_scan_chunked
    names = ("u", "delta", "A", "B", "C", "Dskip", "z", "bias")
    grads = []
    for backend in ("auto", "ref"):
        leaves = [d[k].detach().requires_grad_() for k in names]
        k1, calls = scan_cuda.selective_scan_fwd_cuda.launches, counter.calls
        y = selective_scan(*leaves[:5], leaves[5], leaves[6], leaves[7],
                           True, backend=backend, chunk=32)
        if backend == "auto":
            assert counter.calls == calls + 1
            assert scan_cuda.selective_scan_fwd_cuda.launches == k1
        grads.append((y, *torch.autograd.grad(y, leaves, d["z"])))
    for a, b in zip(*grads):
        if a.is_complex():  # both parts
            a, b = torch.view_as_real(a), torch.view_as_real(b)
        assert _rel(a, b) <= TOL_BWD


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
    same card (the fp32 values of the same A and D); the missing bias is a
    zero tensor that gets no gradient, the gradients of A and D in bf16."""
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
        assert not kernel_params(A, Dv, None)[2].requires_grad
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


def test_lm_prefill_runs_k1_and_matches_the_plain_scan(gen):
    """A small fp32 LM on the card: the prefill launches K1 once a layer
    (with the final state) and no plain scan; its logits and caches match
    the same model with the plain scan, and prefill + steps match steps
    from empty caches; decode steps launch no K1."""
    from zigma_tpu_torch.models.lm import MambaLMHeadModel, generate
    model = MambaLMHeadModel(64, 3, 100, ssm_cfg={"d_state": 16},
                             rms_norm=True, residual_in_fp32=True,
                             device="cuda", generator=gen).eval()
    ids = torch.randint(0, 100, (2, 20), generator=gen, device="cuda")
    scan_cuda.selective_scan_fwd_cuda.launches = 0
    selective_scan_ref.calls = 0
    with torch.inference_mode():
        logits, caches = model.prefill(ids)
        assert scan_cuda.selective_scan_fwd_cuda.launches == 3
        assert selective_scan_ref.calls == 0
        for layer in model.backbone.layers:
            layer.mixer.scan_backend = "ref"
        ref_logits, ref_caches = model.prefill(ids)
        for layer in model.backbone.layers:
            layer.mixer.scan_backend = "auto"
        torch.testing.assert_close(logits, ref_logits, atol=1e-4, rtol=1e-4)
        for i, ((a0, a1), (b0, b1)) in enumerate(zip(caches, ref_caches)):
            if i == 0:  # the first window precedes every scan
                assert torch.equal(a0, b0)
            torch.testing.assert_close(a0, b0, atol=1e-4, rtol=1e-4)
            torch.testing.assert_close(a1, b1, atol=1e-4, rtol=1e-4)
        step_caches = model.init_caches(2)
        for t in range(20):
            step_logits, step_caches = model.step(ids[:, t:t + 1],
                                                  step_caches)
        torch.testing.assert_close(step_logits[:, 0], logits, atol=1e-4,
                                   rtol=1e-4)
    scan_cuda.selective_scan_fwd_cuda.launches = 0
    out = generate(model, ids, 5)
    assert out.shape == (2, 25)
    assert scan_cuda.selective_scan_fwd_cuda.launches == 3


def test_decode_ops_on_the_card_match_the_cpu(gen):
    from zigma_tpu_torch.ops import causal_conv1d_update, selective_state_update
    r = lambda *s: torch.randn(s, generator=gen, device="cuda")
    state, x, dt, A = r(4, 96, 16), r(4, 96), 0.5 * r(4, 96), -torch.exp(r(96, 16))
    B, C, D, z, bias = r(4, 16), r(4, 16), r(96), r(4, 96), 0.1 * r(96)
    args = (state, x, dt, A, B, C, D, z, bias, True)
    y, st = selective_state_update(*args)
    y_c, st_c = selective_state_update(*(a.cpu() if torch.is_tensor(a) else a
                                         for a in args))
    torch.testing.assert_close(y.cpu(), y_c, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(st.cpu(), st_c, atol=1e-5, rtol=1e-5)
    win, w, b = r(4, 4, 96), r(96, 4), r(96)
    out, new = causal_conv1d_update(x, win, w, b)
    out_c, new_c = causal_conv1d_update(x.cpu(), win.cpu(), w.cpu(), b.cpu())
    torch.testing.assert_close(out.cpu(), out_c, atol=1e-5, rtol=1e-5)
    assert torch.equal(new.cpu(), new_c)


def test_server_worker_on_the_card(gen, tmp_path):
    """The serving worker on the card at a tiny size: unguided and guided
    requests, each exactly depth x (steps - 1) K1 launches, and equal
    arrays for equal seeds."""
    from zigma_tpu_torch.cli import sample as sample_cli
    from zigma_tpu_torch.cli.serve import GenerationWorker
    over = ["data=synthetic", "data.num_classes=5",
            "model.params.class_dropout_prob=0.1", "model.params.embed_dim=64",
            "model.params.depth=2", "model.params.img_dim=8",
            "sample_mode=ODE", "ode.sampling_method=euler",
            "ode.num_sampling_steps=4", "vae_kind=identity"]
    cfg = sample_cli.load_config(sample_cli.DEFAULT_CONFIG_DIR, "default", over)
    model = sample_cli.build_model(cfg, device="cuda", generator=gen)
    path = str(tmp_path / "tiny.pt")
    torch.save({"ema": {k: v.cpu() for k, v in model.state_dict().items()}},
               path)
    w = GenerationWorker(sample_cli.load_config(
        sample_cli.DEFAULT_CONFIG_DIR, "default", over + [f"ckpt={path}"]),
        max_batch=4)
    try:
        for scale in (1.0, 3.0):
            scan_cuda.selective_scan_fwd_cuda.launches = 0
            a = w.submit(n=2, seed=3, cls=1, cfg_scale=scale)
            assert scan_cuda.selective_scan_fwd_cuda.launches == 2 * 3
            b = w.submit(n=2, seed=3, cls=1, cfg_scale=scale)
            assert a.shape == (2, 4, 8, 8)
            assert (a == b).all()
    finally:
        w.close()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("loss", ["both", "y_only", "last_only"])
def test_core_x0_and_core_full_kernels_match_plain(gen, dtype, loss):
    """The seeded scan with its final state under autograd: K1 with x0
    returning x_last, K2 from g_last returning dx0 (one launch each), against
    the plain versions through the same Function; a loss on y alone or on
    the final state alone leaves the other cotangent None."""
    from zigma_tpu_torch.ops.selective_scan import core_full, core_x0
    d = _inputs(gen, 2, 300, 96, 16, dtype)
    gy = torch.randn(2, 300, 96, generator=gen, device="cuda")
    g_last = torch.randn(2, 16, 96, generator=gen, device="cuda")
    keys = ("u", "delta", "A", "B", "C", "bias", "x0")
    res = {}
    for backend in ("auto", "ref"):
        t = {k: d[k].clone().requires_grad_() for k in keys}
        counts = (scan_cuda.selective_scan_fwd_cuda.launches,
                  scan_cuda.selective_scan_bwd_cuda.launches)
        if loss == "y_only":
            y, last = core_x0(*(t[k] for k in keys), backend=backend), None
        else:
            y, last = core_full(*(t[k] for k in keys), backend=backend)
        total = 0.0
        if loss != "last_only":
            total = (y.float() * gy).sum()
        if last is not None and loss != "y_only":
            total = total + (last * g_last).sum()
        total.backward()
        launched = (scan_cuda.selective_scan_fwd_cuda.launches - counts[0],
                    scan_cuda.selective_scan_bwd_cuda.launches - counts[1])
        assert launched == ((1, 1) if backend == "auto" else (0, 0))
        res[backend] = (y.detach(), None if last is None else last.detach(),
                        {k: t[k].grad for k in keys})
    (y, last, g), (yr, lr, gr) = res["auto"], res["ref"]
    ulp = BF16_ULP if dtype == torch.bfloat16 else 0.0
    assert _rel(y, yr, ulp) <= TOL_FP32
    if last is not None:
        assert _rel(last, lr) <= TOL_FP32
    for k in keys:
        ulp = BF16_ULP if g[k].dtype == torch.bfloat16 else 0.0
        tol = (TOL_DBIAS_BF16 if k == "bias" and dtype == torch.bfloat16
               else TOL_BWD)
        assert g[k].dtype == gr[k].dtype, k
        assert _rel(g[k], gr[k], ulp) <= tol, k


def test_virtual_shard_seq_parallel_kernels_match_plain(gen):
    """The sequence-parallel scan over 4 virtual shards on the card (fp32,
    fused gate, long memory): 8 K1 and 8 K2 launches, outputs and gradients
    against the same passes through the plain versions, and the SSD's over
    4 shards against the unsharded chunked SSD.  (In bf16 the gradients
    that sum both passes' bf16 values round three times on either side, so
    an element-wise bound against the plain versions would measure the
    cancellation, not the kernels: ``chip_smoke.py`` holds bf16 against
    the float64 truth.)"""
    from zigma_tpu_torch.ops.ssd import ssd_scan
    from zigma_tpu_torch.parallel import (selective_scan_sharded,
                                          ssd_scan_sharded)
    # long memory: a shard's incoming state reaches the next shard
    d = _long_memory_inputs(gen, 2, 512, 96, 16, torch.float32)
    gy = torch.randn(2, 512, 96, generator=gen, device="cuda")
    keys = ("u", "delta", "A", "B", "C", "Dskip", "z", "bias")
    res = {}
    for backend in ("auto", "ref"):
        t = {k: d[k].clone().requires_grad_() for k in keys}
        before = (scan_cuda.selective_scan_fwd_cuda.launches,
                  scan_cuda.selective_scan_bwd_cuda.launches)
        y = selective_scan_sharded(*(t[k] for k in keys), delta_softplus=True,
                                   n_shards=4, backend=backend)
        (y.float() * gy).sum().backward()
        launched = (scan_cuda.selective_scan_fwd_cuda.launches - before[0],
                    scan_cuda.selective_scan_bwd_cuda.launches - before[1])
        assert launched == ((8, 8) if backend == "auto" else (0, 0))
        res[backend] = (y.detach(), {k: t[k].grad for k in keys})
    (y, g), (yr, gr) = res["auto"], res["ref"]
    assert _rel(y, yr) <= TOL_FP32
    for k in keys:
        assert _rel(g[k], gr[k]) <= TOL_BWD_LONG, k
    r = lambda *s: torch.randn(s, generator=gen, device="cuda")
    x, B, C = r(2, 256, 4, 16), r(2, 256, 1, 16), r(2, 256, 1, 16)
    dt = 0.1 * r(2, 256, 4) - 4.0  # dt about 0.02: the state carries
    A, Dh, dtb = -torch.exp(r(4)), r(4), 0.1 * r(4)
    want = ssd_scan(x, dt, A, B, C, Dh, dt_bias=dtb, dt_softplus=True, chunk=64)
    got = ssd_scan_sharded(x, dt, A, B, C, Dh, dt_bias=dtb, dt_softplus=True,
                           n_shards=4, chunk=64)
    assert _rel(got, want) <= TOL_FP32


@pytest.mark.parametrize("policy,k1", [(None, 4), ("scan_out", 2),
                                       ("dots", 4), ("scan_out+dots", 2)])
def test_selective_remat_on_the_card(gen, policy, k1):
    """A tiny fp32 ZigMa (depth 2, remat) under each ``remat_policy``: the
    recompute launches no K1 where the policy keeps the registered op's
    outputs; K2 once a block; gradients bit-equal to full remat's."""
    model = ZigMa(in_channels=4, embed_dim=64, depth=2, img_dim=8,
                  scan_type="zigzagN8", use_pe=2, use_checkpoint=True,
                  device="cuda", generator=gen)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen, device="cuda"))
    x = torch.randn(2, 4, 8, 8, generator=gen, device="cuda")
    t = torch.rand(2, generator=gen, device="cuda")
    grads = []
    for pol in (None, policy):
        m = ZigMa(in_channels=4, embed_dim=64, depth=2, img_dim=8,
                  scan_type="zigzagN8", use_pe=2, use_checkpoint=True,
                  remat_policy=pol, device="cuda")
        m.load_state_dict(model.state_dict())
        before = (scan_cuda.selective_scan_fwd_cuda.launches,
                  scan_cuda.selective_scan_bwd_cuda.launches)
        (m(x, t) ** 2).sum().backward()
        torch.cuda.synchronize()
        launched = (scan_cuda.selective_scan_fwd_cuda.launches - before[0],
                    scan_cuda.selective_scan_bwd_cuda.launches - before[1])
        grads.append({n: p.grad for n, p in m.named_parameters()})
    assert launched == (k1, 2)
    for n, g in grads[0].items():
        assert torch.equal(grads[1][n], g), n


def test_pipelined_stage_on_the_card(gen):
    """``zigma_pipelined_apply`` over a group of one with 4 microbatches on
    the card: 4 K1 launches a block (8 with the remat recompute), the
    output and gradients against the plain model's."""
    import copy

    import torch.distributed as dist
    from zigma_tpu_torch.parallel import split_stage, zigma_pipelined_apply

    ref = ZigMa(in_channels=4, embed_dim=64, depth=2, img_dim=8,
                scan_type="zigzagN8", use_pe=2, use_checkpoint=True,
                drop_path_rate=0.0, device="cuda", generator=gen)
    with torch.no_grad():
        for p in ref.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen, device="cuda"))
    stage = split_stage(copy.deepcopy(ref), 0, 1)
    x = torch.randn(4, 4, 8, 8, generator=gen, device="cuda")
    t = torch.rand(4, generator=gen, device="cuda")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        before = scan_cuda.selective_scan_fwd_cuda.launches
        got = zigma_pipelined_apply(stage, x, t, group=dist.group.WORLD,
                                    n_microbatches=4)
        (got ** 2).sum().backward()
        torch.cuda.synchronize()
        assert scan_cuda.selective_scan_fwd_cuda.launches - before == 16
    finally:
        dist.destroy_process_group()
    want = ref(x, t)
    (want ** 2).sum().backward()
    assert _rel(got, want) <= TOL_FP32
    params = dict(stage.named_parameters())
    for n, p in ref.named_parameters():
        assert _rel(params[n].grad, p.grad) <= TOL_FP32, n


# the model configurations a chain is captured over: full remat with a label
# drop, selective remat, no remat, text with use_pe 3, Mamba-2, the chunked
# scan backend, video
CHAIN_KINDS = {
    "remat": dict(num_classes=10, class_dropout_prob=0.1),
    "scan_out": dict(num_classes=10, class_dropout_prob=0.1,
                     remat_policy="scan_out"),
    "no_remat": dict(num_classes=10, class_dropout_prob=0.1,
                     use_checkpoint=False),
    "text_pe3": dict(has_text=True, d_context=48, use_pe=3),
    "ssm2": dict(ssm_cfg=dict(ssm_version=2, d_state=16, headdim=32)),
    "chunked": dict(scan_backend="chunked", scan_chunk=16),
    "video": dict(depth=3, patch_size=2, scan_type="zzvideo_sst",
                  video_frames=4, tpe=True, num_classes=5,
                  class_dropout_prob=0.5),
}


def _tiny_trainer(kind, capturable):
    """A tiny fp32 ZigMa of ``CHAIN_KINDS[kind]`` (depth 2 unless it says,
    remat, drop-path 0.1) on the card, with its state and loss."""
    from zigma_tpu_torch.train import TrainState, make_diffusion_loss_fn
    from zigma_tpu_torch.transport import create_transport
    kw = dict(in_channels=4, embed_dim=64, depth=2, img_dim=8,
              scan_type="zigzagN8", use_pe=2, use_checkpoint=True,
              drop_path_rate=0.1)
    kw.update(CHAIN_KINDS[kind])
    model = ZigMa(**kw, device="cuda",
                  generator=torch.Generator(device="cuda").manual_seed(3))
    state = TrainState.create(model, capturable=capturable)
    return state, make_diffusion_loss_fn(model, create_transport())


def _tiny_batches(kind, n):
    """``n`` host batches of ``kind``'s model: latents, and class labels or
    caption features."""
    g, cfg = torch.Generator().manual_seed(4), CHAIN_KINDS[kind]
    shape = (4, 4, 4, 8, 8) if "video_frames" in cfg else (4, 4, 8, 8)
    out = []
    for _ in range(n):
        b = {"x": torch.randn(shape, generator=g)}
        if "num_classes" in cfg:
            b["y"] = torch.randint(0, cfg["num_classes"], (4,), generator=g)
        elif cfg.get("has_text"):
            b["y"] = torch.randn(4, 77, cfg["d_context"], generator=g)
        out.append(b)
    return out


def _k_counts():
    return (scan_cuda.selective_scan_fwd_cuda.launches,
            scan_cuda.selective_scan_bwd_cuda.launches)


@pytest.mark.parametrize("kind", list(CHAIN_KINDS))
def test_captured_chain_matches_plain_steps(gen, kind):
    """Three chains of 2 through ``CapturedChain`` (the eager warm-up
    chain, the capture, two replays) against 6 ``train_step`` calls with the
    same capturable AdamW and step generator seed: losses at the chain
    ends, every parameter and EMA tensor and the generator's state
    bit-equal.  The wrappers count the eager chain's launches (those of
    the first two plain steps) and nothing under the capture, and a replay
    calls no wrapper (K1 / K2 are in the graph).  The text model's
    attention runs SDPA's math backend here: the fused backward
    accumulates with atomics and differs from run to run in the last bits,
    graph or not (its capture is
    ``test_captured_text_chain_with_fused_attention``)."""
    from contextlib import nullcontext

    from torch.nn.attention import SDPBackend, sdpa_kernel

    from zigma_tpu_torch.train import CapturedChain, train_step
    batches = _tiny_batches(kind, 6)
    with (sdpa_kernel(SDPBackend.MATH) if kind == "text_pe3"
          else nullcontext()):
        state, loss_fn = _tiny_trainer(kind, True)
        g_chain = torch.Generator(device="cuda").manual_seed(5)
        chain = CapturedChain(state, loss_fn, 2, g_chain)
        got, counted = [], []
        for i in range(3):
            before = _k_counts()
            got.append(chain(batches[2 * i:2 * i + 2])["loss"].item())
            counted.append(tuple(a - b for a, b in zip(_k_counts(), before)))
        assert state.step == 6 and chain.capture_seconds > 0
        ref, ref_loss = _tiny_trainer(kind, True)
        g_ref = torch.Generator(device="cuda").manual_seed(5)
        want = []
        before = _k_counts()
        for i, b in enumerate(batches):
            m = train_step(ref, ref_loss,
                           {k: v.cuda() for k, v in b.items()}, g_ref)
            if i == 1:
                eager = tuple(a - b for a, b in zip(_k_counts(), before))
            if i % 2:
                want.append(m["loss"].item())
    assert counted == [eager, (0, 0), (0, 0)]
    assert got == want
    for which in ("model", "ema"):
        for p, q in zip(getattr(state, which).parameters(),
                        getattr(ref, which).parameters()):
            assert torch.equal(p, q), which
    assert torch.equal(g_chain.get_state(), g_ref.get_state())


def test_captured_text_chain_with_fused_attention(gen):
    """The text model's chain captured and replayed under SDPA's default
    backends, as a user's run takes them (the fused attention inside the
    graph): finite losses, the model stepped, and a replay calls no kernel
    wrapper."""
    from zigma_tpu_torch.train import CapturedChain
    batches = _tiny_batches("text_pe3", 6)
    state, loss_fn = _tiny_trainer("text_pe3", True)
    start = [p.detach().clone() for p in state.model.parameters()]
    chain = CapturedChain(state, loss_fn, 2,
                          torch.Generator(device="cuda").manual_seed(5))
    losses = [chain(batches[:2])["loss"].item()]
    for i in (1, 2):
        before = _k_counts()
        losses.append(chain(batches[2 * i:2 * i + 2])["loss"].item())
        assert _k_counts() == before
    assert state.step == 6 and all(map(math.isfinite, losses))
    assert any(not torch.equal(p, q)
               for p, q in zip(state.model.parameters(), start))


def test_captured_chain_refusals_and_checkpoints_both_ways(gen, tmp_path):
    """A default AdamW is refused; a stale graph (an optimizer state dict
    loaded after the capture) raises; a chained checkpoint resumes with a
    default AdamW (step counts on the host) and a plain one under a new
    chain (step counts on the card)."""
    from zigma_tpu_torch.train import (CapturedChain, restore_checkpoint,
                                       save_checkpoint, train_step)
    state, loss_fn = _tiny_trainer("remat", False)
    with pytest.raises(ValueError, match="capturable=True"):
        CapturedChain(state, loss_fn, 2,
                      torch.Generator(device="cuda").manual_seed(0))
    chained, c_loss = _tiny_trainer("remat", True)
    chain = CapturedChain(chained, c_loss, 2,
                          torch.Generator(device="cuda").manual_seed(0))
    batches = _tiny_batches("remat", 4)
    chain(batches[:2])
    chain(batches[2:])
    path = save_checkpoint(str(tmp_path / "c"), chained)
    # the file's moments are new tensors: the graph's would be freed
    chained.opt.load_state_dict(torch.load(path, weights_only=False)["opt"])
    with pytest.raises(RuntimeError, match="replaced since the capture"):
        chain(batches[:2])
    restore_checkpoint(path, state)
    assert state.step == 4 and not state.opt.param_groups[0]["capturable"]
    assert {st["step"].device.type for st in state.opt.state.values()} == {
        "cpu"}
    train_step(state, loss_fn, {k: v.cuda() for k, v in batches[0].items()})
    fresh, f_loss = _tiny_trainer("remat", True)
    restore_checkpoint(save_checkpoint(str(tmp_path / "p"), state), fresh)
    assert fresh.opt.param_groups[0]["capturable"]
    assert {st["step"].device.type for st in fresh.opt.state.values()} == {
        "cuda"}
    again = CapturedChain(fresh, f_loss, 2,
                          torch.Generator(device="cuda").manual_seed(1))
    for _ in range(2):
        assert math.isfinite(again(batches[:2])["loss"].item())
    assert fresh.step == 9


def test_profiling_helpers_on_the_card(gen):
    """``device_memory_stats`` per card (read with a tensor on the card, so
    that the test holds when it runs first) and ``differential_time`` by
    CUDA events."""
    from zigma_tpu_torch.utils.profiling import (device_memory_stats,
                                                 differential_time)
    x = torch.randn(1024, 1024, generator=gen, device="cuda")
    stats = device_memory_stats()
    assert set(stats) == {f"cuda:{i}"
                          for i in range(torch.cuda.device_count())}
    assert stats["cuda:0"]["bytes_limit"] > stats["cuda:0"]["bytes_in_use"] > 0
    assert differential_time(lambda a: a @ a / 1024, x) > 0


def _device_ops(prof):
    """(name, start_ns, end_ns) of a profile's device operations."""
    from torch.autograd import DeviceType
    return sorted((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() != DeviceType.CPU and e.duration_ns() > 0)


def test_span_shares_the_device_traces_clock(gen):
    """A span around ``torch.cuda._sleep`` and the synchronise after it
    contains the kernel's interval in a trace of the device's activity
    alone, and opens at most 100 us before the kernel starts.  The first
    span and launch of a profiler session take 50-140 us more, once: a
    warm-up span goes first."""
    from torch.profiler import ProfilerActivity, profile
    from zigma_tpu_torch.utils.profiling import recording, span
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        with recording() as spans:
            with span("warm-up"):
                torch.cuda._sleep(1000)
                torch.cuda.synchronize()
            with span("sleep") as s:
                torch.cuda._sleep(20_000_000)  # ~10 ms
                torch.cuda.synchronize()
    ops = _device_ops(prof)
    name, a, b = max(ops, key=lambda op: op[2] - op[1])
    assert b - a > 1_000_000, ops
    assert s in spans and s.start_ns <= a and b <= s.end_ns, (s, a, b)
    assert a - s.start_ns <= 100_000, (s, a, b)


def test_spans_of_a_step_on_the_card(gen):
    """A tiny remat step recorded on the card: the recompute runs on the
    autograd engine's device thread and nests under
    ``train_step.backward``; the root counts 2 K1 launches a block (the
    forward and the recompute) and one K2, as many conv forward and
    backward launches, and the allocator's counts."""
    from zigma_tpu_torch.train import train_step
    from zigma_tpu_torch.utils.profiling import ALLOCATOR_COUNTS, recording
    state, loss_fn = _tiny_trainer("remat", capturable=False)
    batch = {k: v.cuda() for k, v in _tiny_batches("remat", 1)[0].items()}
    step_gen = torch.Generator(device="cuda").manual_seed(5)
    train_step(state, loss_fn, batch, step_gen)
    torch.cuda.synchronize()
    with recording() as spans:
        train_step(state, loss_fn, batch, step_gen)
        torch.cuda.synchronize()
    spans = [s for s in spans if s.name != "host.gc"]
    root, = [s for s in spans if s.parent is None]
    parts = sorted((s for s in spans if s.parent == root.id),
                   key=lambda s: s.start_ns)
    assert [s.name for s in parts] == [
        "train_step.forward", "train_step.backward", "train_step.clip",
        "train_step.optimizer", "train_step.ema"]
    backward = parts[1]
    recomputed = [s for s in spans if s.name == "model.block"
                  and s.parent == backward.id]
    depth = state.model.depth
    assert sorted(s.attrs["index"] for s in recomputed) == list(range(depth))
    assert all(s.thread != root.thread and s.unit == root.id
               for s in recomputed)
    assert all(backward.start_ns <= s.start_ns <= s.end_ns <= backward.end_ns
               for s in recomputed)
    assert root.counters["k1_launches"] == 2 * depth
    assert root.counters["k2_launches"] == depth
    assert root.counters["conv_launches"] == 2 * depth
    assert root.counters["conv_bwd_launches"] == depth
    stats = torch.cuda.memory_stats()
    for k in ALLOCATOR_COUNTS:
        assert (root.counters[k] is None) == (k not in stats), k


# ---------------------------------------------------------------------------
# The causal conv1d kernels (csrc/causal_conv1d.cu): the forward bit-equal to
# the plain version on the card, the backward against float64 autograd.

def _conv_case(gen, batch, L, d, W, dtype, bias=True, init=False,
               strided=False):
    """x (batch, L, d) in ``dtype``, a slice of a (batch, L, 2d) ``xz`` when
    ``strided``; fp32 taps and bias at the models' init scale; an optional
    left context; a cotangent."""
    r = lambda *s: torch.randn(s, generator=gen, device="cuda")
    x = (r(batch, L, 2 * d)[..., :d] if strided else r(batch, L, d)).to(dtype)
    bound = W ** -0.5
    w = (2 * torch.rand(d, W, generator=gen, device="cuda") - 1) * bound
    b = ((2 * torch.rand(d, generator=gen, device="cuda") - 1) * bound
         if bias else None)
    return dict(x=x, w=w, b=b, init=r(batch, W - 1, d).to(dtype) if init
                else None, dy=r(batch, L, d).to(dtype))


CONV_SHAPES = [(2, 1), (2, 3), (2, 16), (2, 255), (2, 1024), (1, 4096),
               (5120, 16)]


@pytest.mark.parametrize("d", [1536, 1792, 1537])
@pytest.mark.parametrize("batch,L", CONV_SHAPES)
@pytest.mark.parametrize("W", [2, 3, 4])
def test_conv_kernel_forward_bit_equal_across_shapes(gen, W, batch, L, d):
    """bf16, strided x out of xz (read in place; the odd width ragged and
    unaligned), bias and SiLU, as the Mamba mixer calls it: the kernel's
    output equals the plain version's on the card bit for bit, and one
    launch is counted."""
    from zigma_tpu_torch.ops import conv_cuda
    from zigma_tpu_torch.ops.causal_conv1d import (causal_conv1d,
                                                   causal_conv1d_ref)
    t = _conv_case(gen, batch, L, d, W, torch.bfloat16, strided=True)
    before = conv_cuda.causal_conv1d_fwd_cuda.launches
    with torch.no_grad():
        got = causal_conv1d(t["x"], t["w"], t["b"])
    assert conv_cuda.causal_conv1d_fwd_cuda.launches == before + 1
    assert torch.equal(got, causal_conv1d_ref(t["x"], t["w"], t["b"]))


@pytest.mark.parametrize("accum", [None, torch.float32])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("act", ["silu", None])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("strided", [True, False])
def test_conv_kernel_forward_bit_equal_across_modes(gen, strided, bias, act,
                                                    init, dtype, accum):
    """Every mode at (2, 256, 1536), W 4: strided or contiguous x, with or
    without bias, SiLU or none, a left context or zeros, bf16 or fp32
    inputs, accumulated in x's dtype or fp32 (``conv_fp32_taps``)."""
    from zigma_tpu_torch.ops.causal_conv1d import (causal_conv1d,
                                                   causal_conv1d_ref)
    t = _conv_case(gen, 2, 256, 1536, 4, dtype, bias, init, strided)
    args = (t["x"], t["w"], t["b"], act, t["init"], accum)
    with torch.no_grad():
        assert torch.equal(causal_conv1d(*args), causal_conv1d_ref(*args))


def _f64_grads(t, act, accum, plain):
    """Autograd of the plain forward: on the float64 copies of the inputs
    (``plain`` False, the truth) or on the inputs themselves."""
    from zigma_tpu_torch.ops.causal_conv1d import causal_conv1d_ref
    leaves = {k: (v.double() if not plain else v).detach().clone()
              .requires_grad_(True)
              for k, v in t.items() if v is not None and k != "dy"}
    y = causal_conv1d_ref(leaves["x"], leaves["w"], leaves.get("b"), act,
                          leaves.get("init"), None if not plain else accum)
    y.backward(t["dy"].to(y.dtype))
    return [None if k not in leaves else leaves[k].grad
            for k in ("x", "w", "b", "init")]


def _norm_gap(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("accum", [None, torch.float32])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("act", ["silu", None])
@pytest.mark.parametrize("batch,L,d,W", [(4, 256, 1536, 4), (320, 16, 1537, 3),
                                         (3, 1, 64, 2)])
def test_conv_backward_kernel_against_float64(gen, batch, L, d, W, act, init,
                                              dtype, accum):
    """The registered operator's backward (the kernel) against float64
    autograd of the plain forward: each gradient (dx, dw, dbias, the left
    context's) no farther from it (norm of the difference over the norm)
    than the plain autograd chain in the working dtype, within 1% and 1e-6;
    two backward launches give the same bits; one backward launch."""
    from zigma_tpu_torch.ops import conv_cuda
    from zigma_tpu_torch.ops.causal_conv1d import causal_conv1d
    t = _conv_case(gen, batch, L, d, W, dtype, True, init)
    truth = _f64_grads(t, act, accum, plain=False)
    plain = _f64_grads(t, act, accum, plain=True)
    runs = []
    for _ in range(2):
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in t.items() if v is not None
                  and k not in ("x", "dy")}
        # x read in place out of a wider leaf, as in_proj's xz
        xz = torch.cat([t["x"], t["x"]], -1).detach().requires_grad_(True)
        before = conv_cuda.causal_conv1d_bwd_cuda.launches
        y = causal_conv1d(xz[..., :d], leaves["w"], leaves.get("b"), act,
                          leaves.get("init"), accum)
        y.backward(t["dy"])
        assert conv_cuda.causal_conv1d_bwd_cuda.launches == before + 1
        runs.append([xz.grad[..., :d]] + [
            None if k not in leaves else leaves[k].grad
            for k in ("w", "b", "init")])
    for name, k, p, tr, again in zip(("dx", "dw", "dbias", "dinit"), runs[0],
                                     plain, truth, runs[1]):
        if tr is None:
            continue
        assert k.dtype == p.dtype and k.shape == p.shape, name
        assert torch.equal(k, again), name
        assert _norm_gap(k, tr) <= 1.01 * _norm_gap(p, tr) + 1e-6, name


def test_conv_kernel_refuses_what_it_does_not_take(gen):
    """W outside 2 to 4, a channel stride other than 1, tokens not evenly
    spaced, float16, a tensor on another device: each raises before a
    launch."""
    from zigma_tpu_torch.ops import conv_cuda
    from zigma_tpu_torch.ops.causal_conv1d import causal_conv1d
    t = _conv_case(gen, 2, 32, 64, 4, torch.bfloat16)
    before = conv_cuda.causal_conv1d_fwd_cuda.launches
    for W in (1, 5):
        with pytest.raises(NotImplementedError, match=f"width {W}"):
            causal_conv1d(t["x"], torch.ones(64, W, device="cuda"), t["b"])
    wide = torch.zeros(2, 32, 128, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unit channel stride"):
        causal_conv1d(wide[..., ::2], t["w"], t["b"])
    longer = torch.zeros(2, 33, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="evenly spaced"):
        causal_conv1d(longer[:, :32], t["w"], t["b"])
    with pytest.raises(ValueError, match="float16"):
        causal_conv1d(t["x"].half(), t["w"], t["b"])
    with pytest.raises(ValueError, match="is on cpu"):
        causal_conv1d(t["x"], t["w"].cpu(), t["b"])
    assert conv_cuda.causal_conv1d_fwd_cuda.launches == before
    info = {bwd: conv_cuda.causal_conv1d_launch_info(bwd, torch.bfloat16)
            for bwd in (False, True)}
    print("conv kernel instances (forward, backward):", info)
    assert all(i["spill_bytes"] == 0 and i["blocks_per_sm"] >= 1
               for i in info.values())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_conv_update_matches_the_kernel_at_every_position(gen, dtype):
    """``causal_conv1d_update`` (plain, the decode step) from a zero window
    gives the kernel's output at every position, bit for bit."""
    from zigma_tpu_torch.ops.causal_conv1d import (causal_conv1d,
                                                   causal_conv1d_update)
    t = _conv_case(gen, 3, 24, 96, 4, dtype)
    with torch.no_grad():
        y = causal_conv1d(t["x"], t["w"], t["b"])
        state = torch.zeros(3, 4, 96, dtype=dtype, device="cuda")
        for i in range(24):
            yi, state = causal_conv1d_update(t["x"][:, i], state, t["w"],
                                             t["b"])
            assert torch.equal(yi, y[:, i]), i


def test_tiny_model_gradients_conv_kernel_against_plain(gen, monkeypatch):
    """A tiny fp32 ZigMa (remat): loss and gradients with the conv kernels
    against the same model with the plain conv (its autograd chain), one
    conv and one conv backward launch a block and pass."""
    from zigma_tpu_torch.models import mamba
    from zigma_tpu_torch.ops import conv_cuda
    from zigma_tpu_torch.ops.causal_conv1d import causal_conv1d_ref
    model = ZigMa(in_channels=4, embed_dim=64, depth=2, img_dim=8,
                  scan_type="zigzagN8", use_pe=2, use_checkpoint=True,
                  device="cuda", generator=gen)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen, device="cuda"))
    x = torch.randn(2, 4, 8, 8, generator=gen, device="cuda")
    t = torch.rand(2, generator=gen, device="cuda")
    before = (conv_cuda.causal_conv1d_fwd_cuda.launches,
              conv_cuda.causal_conv1d_bwd_cuda.launches)
    got = model(x, t)
    (got ** 2).sum().backward()
    assert (conv_cuda.causal_conv1d_fwd_cuda.launches - before[0],
            conv_cuda.causal_conv1d_bwd_cuda.launches - before[1]) == (4, 2)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad()
    monkeypatch.setattr(mamba, "causal_conv1d", causal_conv1d_ref)
    want = model(x, t)
    (want ** 2).sum().backward()
    assert _rel(got, want) <= TOL_FP32
    for n, p in model.named_parameters():
        assert _rel(grads[n], p.grad) <= TOL_FP32, n
