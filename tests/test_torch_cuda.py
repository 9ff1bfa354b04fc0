"""CUDA kernel tests of the port; they need a card and skip without one.

Run them on a GPU machine with ``python -m pytest -m cuda tests/test_torch_cuda.py``.
The selective-scan forward kernel is held against its plain PyTorch version
on the same card, on all three outputs.  Tolerance per element:
|got - ref| <= ulp * |ref| + 1e-4 * max |ref|, where the floor covers
summation order and exp/log1p ulps in fp32, and ulp is 2^-7 for bf16 outputs
(one bf16 rounding of the same fp32 value may land a bf16 ulp away) and 0
for fp32 ones.
"""

import pytest
import torch

from zigma_tpu_torch.models import ZigMa
from zigma_tpu_torch.ops import scan_cuda
from zigma_tpu_torch.ops.selective_scan import selective_scan, selective_scan_ref

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


TOL_FP32 = 1e-4
BF16_ULP = 2.0 ** -7


def _rel(a, b, ulp=0.0):
    """max over elements of |a - b| - ulp * |b|, over max |b|"""
    a, b = a.float(), b.float()
    return (((a - b).abs() - ulp * b.abs()).max()
            / b.abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("with_x0", [True, False])
@pytest.mark.parametrize("L,D,N", [(300, 96, 16), (129, 64, 64), (40, 32, 256)])
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
    with pytest.raises(NotImplementedError, match="training slice"):
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
