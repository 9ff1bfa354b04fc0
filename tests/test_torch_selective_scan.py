"""Port selective scan vs the JAX package's Pallas kernel and golden model.

The port's plain scan (``selective_scan_ref``, which ``selective_scan``
runs for CPU tensors) is held against ``scan_core_fwd_pallas`` in interpret
mode -- the same TPU kernel the CUDA kernel replaces -- on all three outputs
(y, chunk-start states, final state).  The CUDA kernel itself runs only on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerance: fp32 max abs 1e-4 at unit-scale inputs; the two sides differ
only in exp/log1p implementations and summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zigma_tpu.ops.scan_pallas import scan_core_fwd_pallas, selective_scan_pallas
from zigma_tpu.ops.selective_scan import selective_scan_ref as jax_scan_ref
from zigma_tpu_torch.ops import scan_cuda
from zigma_tpu_torch.ops.selective_scan import (SelectiveScanFn,
                                                kernel_params, selective_scan,
                                                selective_scan_ref)

TOL = 1e-4


def _inputs(seed, batch=2, L=256, D=128, N=16):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(u=f(batch, L, D), delta=0.5 * f(batch, L, D),
                A=-np.exp(0.5 * f(D, N)), B=f(batch, L, N), C=f(batch, L, N),
                bias=0.1 * f(D), Dskip=f(D), z=f(batch, L, D),
                x0=f(batch, N, D))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


@pytest.mark.parametrize("with_x0", [False, True])
def test_plain_scan_matches_pallas_all_outputs(with_x0):
    d = _inputs(0)
    x0 = d["x0"] if with_x0 else None
    y_p, c_p, xl_p = scan_core_fwd_pallas(
        jnp.asarray(d["u"]), jnp.asarray(d["delta"]), jnp.asarray(d["bias"]),
        jnp.asarray(d["A"]), jnp.asarray(d["B"]), jnp.asarray(d["C"]),
        None if x0 is None else jnp.asarray(x0),
        softplus=True, block_d=128, interpret=True)
    y, c, xl = selective_scan_ref(
        _t(d["u"]), _t(d["delta"]), _t(d["A"]), _t(d["B"]), _t(d["C"]),
        delta_bias=_t(d["bias"]), delta_softplus=True,
        x0=None if x0 is None else _t(x0))
    assert tuple(c.shape) == tuple(c_p.shape) == (2, 2, 16, 128)
    assert _err(y, y_p) <= TOL
    assert _err(c, c_p) <= TOL
    assert _err(xl, xl_p) <= TOL


def test_fused_gate_matches_pallas_and_golden_model():
    d = _inputs(1)
    j = {k: jnp.asarray(v) for k, v in d.items()}
    y_pal = selective_scan_pallas(j["u"], j["delta"], j["A"], j["B"], j["C"],
                                  j["Dskip"], j["z"], j["bias"],
                                  delta_softplus=True, fuse_gate=True)
    y_gold = jax_scan_ref(j["u"], j["delta"], j["A"], j["B"], j["C"],
                          j["Dskip"], j["z"], j["bias"], delta_softplus=True)
    y, _, _ = selective_scan_ref(
        _t(d["u"]), _t(d["delta"]), _t(d["A"]), _t(d["B"]), _t(d["C"]),
        _t(d["Dskip"]), _t(d["z"]), _t(d["bias"]), delta_softplus=True)
    assert _err(y, y_pal) <= TOL
    assert _err(y, y_gold) <= TOL


def test_ragged_length_and_last_state_layout():
    """L=200 (not a multiple of the 128-step chunk): y and the final state
    against the JAX golden model, in its (batch, d, N) state layout."""
    d = _inputs(2, L=200, D=64, N=8)
    j = {k: jnp.asarray(v) for k, v in d.items()}
    y_g, xl_g = jax_scan_ref(j["u"], j["delta"], j["A"], j["B"], j["C"],
                             j["Dskip"], None, j["bias"], delta_softplus=True,
                             return_last_state=True)
    y, xl = selective_scan(_t(d["u"]), _t(d["delta"]), _t(d["A"]), _t(d["B"]),
                           _t(d["C"]), _t(d["Dskip"]), None, _t(d["bias"]),
                           delta_softplus=True, return_last_state=True)
    assert tuple(xl.shape) == tuple(xl_g.shape) == (2, 64, 8)
    assert _err(y, y_g) <= TOL
    assert _err(xl, xl_g) <= TOL


def test_bf16_inputs_match_golden_model():
    """bf16 in, fp32 state inside, bf16 out on both sides: the outputs
    agree to one bf16 rounding."""
    d = _inputs(3, L=64, D=32, N=16)
    bf = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in d.items()}
    y = selective_scan(bf["u"], bf["delta"], _t(d["A"]), bf["B"], bf["C"],
                       _t(d["Dskip"]), bf["z"], _t(d["bias"]),
                       delta_softplus=True)
    assert y.dtype == torch.bfloat16
    jb = {k: jnp.asarray(v.float().numpy(), jnp.bfloat16) for k, v in bf.items()}
    y_g = jax_scan_ref(jb["u"], jb["delta"], jnp.asarray(d["A"]), jb["B"],
                       jb["C"], jnp.asarray(d["Dskip"]), jb["z"],
                       jnp.asarray(d["bias"]), delta_softplus=True)
    yf, ygf = y.float().numpy(), np.asarray(y_g, np.float32)
    np.testing.assert_allclose(yf, ygf, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("given", ["D", "z"])
def test_only_D_or_only_z_matches_jax(given):
    """The skip term without the gate, or the gate without the skip term,
    without a gradient: the port's selective_scan against the JAX
    function's plain path, fp32, TOL."""
    from zigma_tpu.ops.selective_scan import selective_scan as jax_scan
    d = _inputs(7, L=160, D=48, N=16)
    Dk = d["Dskip"] if given == "D" else None
    zk = d["z"] if given == "z" else None
    j = lambda a: None if a is None else jnp.asarray(a)
    y_j = jax_scan(j(d["u"]), j(d["delta"]), j(d["A"]), j(d["B"]), j(d["C"]),
                   j(Dk), j(zk), j(d["bias"]), delta_softplus=True,
                   backend="ref")
    with torch.no_grad():
        y = selective_scan(_t(d["u"]), _t(d["delta"]), _t(d["A"]), _t(d["B"]),
                           _t(d["C"]), None if Dk is None else _t(Dk),
                           None if zk is None else _t(zk), _t(d["bias"]),
                           delta_softplus=True)
    assert tuple(y.shape) == tuple(y_j.shape)
    assert _err(y, y_j) <= TOL


def test_cpu_tensor_dispatches_to_plain_version():
    d = _inputs(4, L=32, D=16, N=4)
    calls, launches = selective_scan_ref.calls, scan_cuda.selective_scan_fwd_cuda.launches
    selective_scan(_t(d["u"]), _t(d["delta"]), _t(d["A"]), _t(d["B"]),
                   _t(d["C"]), _t(d["Dskip"]), _t(d["z"]), _t(d["bias"]),
                   delta_softplus=True)
    assert selective_scan_ref.calls == calls + 1
    assert scan_cuda.selective_scan_fwd_cuda.launches == launches


def test_kernel_wrapper_refuses_cpu_tensors_and_gradients():
    d = _inputs(5, L=32, D=16, N=4)
    args = (_t(d["u"]), _t(d["delta"]), _t(d["A"]), _t(d["B"]), _t(d["C"]),
            _t(d["bias"]))
    launches = scan_cuda.selective_scan_fwd_cuda.launches
    launches_bwd = scan_cuda.selective_scan_bwd_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        scan_cuda.selective_scan_fwd_cuda(*args)
    # the raw forward records no gradient: autograd goes through
    # SelectiveScanFn (selective_scan), whose backward is K2
    with pytest.raises(NotImplementedError, match="does not record a gradient"):
        scan_cuda.selective_scan_fwd_cuda(args[0].clone().requires_grad_(),
                                          *args[1:])
    with pytest.raises(ValueError, match="CUDA tensors"):
        scan_cuda.selective_scan_bwd_cuda(
            args[0], args[1], args[5], *args[2:5],
            torch.zeros(1, 1, 4, 16), args[0])
    with pytest.raises(ValueError, match="unknown backend"):
        selective_scan(*args[:5], backend="pallas")
    assert scan_cuda.selective_scan_fwd_cuda.launches == launches
    assert scan_cuda.selective_scan_bwd_cuda.launches == launches_bwd


def test_kernel_params_normalise_A_D_and_a_missing_bias():
    """What the CUDA path hands the kernels: contiguous fp32 A and D (cast
    and copied from bf16 and from a transposed view), zeros of shape (d,)
    for a missing bias, D None when not given."""
    d = _inputs(8, L=16, D=8, N=4)
    A_view = _t(np.ascontiguousarray(d["A"].T)).t()  # (8, 4), not contiguous
    A, D, bias = kernel_params(A_view, _t(d["Dskip"]).to(torch.bfloat16), None)
    assert not A_view.is_contiguous()
    for t in (A, D, bias):
        assert t.dtype == torch.float32 and t.is_contiguous()
    assert torch.equal(A, A_view)
    assert torch.equal(D, _t(d["Dskip"]).to(torch.bfloat16).float())
    assert torch.equal(bias, torch.zeros(8))
    A_in, bias_in = _t(d["A"]), _t(d["bias"])
    A2, D2, bias2 = kernel_params(A_in, None, bias_in)
    assert A2 is A_in and bias2 is bias_in and D2 is None  # nothing to copy


def test_missing_bias_has_no_gradient_and_cast_params_keep_their_dtype():
    """SelectiveScanFn without delta_bias returns no bias gradient; A given
    in bf16 as a transposed view, and D in bf16, get their gradients in
    bf16; the values equal the fp32 run's rounded to bf16."""
    d = _inputs(9, L=40, D=8, N=4)
    A_view = _t(np.ascontiguousarray(d["A"].T)).t().to(torch.bfloat16)
    A_view.requires_grad_()
    Dk = _t(d["Dskip"]).to(torch.bfloat16).requires_grad_()
    A32 = A_view.detach().float().requires_grad_()
    D32 = Dk.detach().float().requires_grad_()
    u = _t(d["u"]).requires_grad_()
    outs = []
    for A, Dv in ((A_view, Dk), (A32, D32)):
        out = SelectiveScanFn.apply(u, _t(d["delta"]), A, _t(d["B"]),
                                    _t(d["C"]), None, Dv, _t(d["z"]), True,
                                    False)
        assert out.grad_fn.apply(torch.ones_like(out))[5] is None
        out.sum().backward()
        outs.append(out.detach())
    assert torch.equal(outs[0], outs[1])
    assert A_view.grad.dtype == Dk.grad.dtype == torch.bfloat16
    assert A_view.grad.shape == (8, 4)
    assert torch.equal(A_view.grad, A32.grad.to(torch.bfloat16))
    assert torch.equal(Dk.grad, D32.grad.to(torch.bfloat16))


@pytest.mark.parametrize("case", ["complex_A", "grouped_BC"])
def test_later_slice_shapes_raise(case):
    d = _inputs(6, L=16, D=8, N=4)
    u, delta, A, B, C = (_t(d[k]) for k in ("u", "delta", "A", "B", "C"))
    if case == "complex_A":
        A = A.to(torch.complex64)
    else:
        B, C = B[:, :, None], C[:, :, None]
    with pytest.raises(NotImplementedError, match="later slice"):
        selective_scan(u, delta, A, B, C)
