"""CUDA kernel tests of the port; they need a card and skip without one.

Run them on a GPU machine with ``python -m pytest -m cuda tests/test_torch_cuda.py``.
The selective-scan kernels are held against their plain PyTorch versions on
the same card: the forward (K1) on all three outputs, the backward (K2) on
every gradient.  Tolerance per element: |got - ref| <= ulp * |ref| + floor *
max |ref|, where ulp is 2^-7 for bf16 outputs (one bf16 rounding of the same
fp32 value may land a bf16 ulp away) and 0 for fp32 ones, and the floor
covers summation order and exp/log1p ulps in fp32: 1e-4 for K1, 1e-5 for K2
(its first run on the H100 measured at most 1.3e-6).  K2's dbias in a bf16
run sums ddelta after its rounding to bf16, where single roundings may flip:
floor 1e-3 (measured at most 1.4e-4).
"""

import math

import pytest
import torch

from zigma_tpu_torch.models import ZigMa
from zigma_tpu_torch.ops import scan_cuda
from zigma_tpu_torch.ops.selective_scan import (selective_scan,
                                                selective_scan_bwd_ref,
                                                selective_scan_ref)

pytestmark = pytest.mark.cuda


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


def _bwd_case(gen, batch, L, D, N, dtype, fused, with_g_last):
    d = _inputs(gen, batch, L, D, N, dtype)
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
@pytest.mark.parametrize("L,D,N", [(300, 96, 16), (129, 64, 64), (40, 32, 256),
                                   (7, 50, 5)])
def test_backward_kernel_matches_plain_version(gen, dtype, fused, with_g_last,
                                               L, D, N):
    got, again, ref = _bwd_case(gen, 2, L, D, N, dtype, fused, with_g_last)
    assert len(got) == len(ref) == (9 if fused else 7)
    for name, g, a, r in zip(BWD_NAMES, got, again, ref):
        assert g.shape == r.shape and g.dtype == r.dtype, name
        assert torch.equal(g, a), name  # no atomics: bit-equal repeats
        ulp = BF16_ULP if g.dtype == torch.bfloat16 else 0.0
        tol = (TOL_DBIAS_BF16 if name == "dbias" and dtype == torch.bfloat16
               else TOL_BWD)
        assert _rel(g, r, ulp) <= tol, name


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
