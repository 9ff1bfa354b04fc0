"""The causal conv1d's backward reference and registered operator on the CPU.

``causal_conv1d_bwd_ref`` is the plain version of the conv backward kernel
(``csrc/causal_conv1d.cu``): it is held against autograd of the plain
forward over the width, length, bias, activation, left context and
accumulation dtype.  The operator ``zigma::causal_conv1d_fwd`` runs the
plain forward and this backward for a CPU tensor (a float64 gradcheck);
``causal_conv1d`` itself keeps a CPU tensor on the plain torch ops, with no
kernel call.  The kernels' own tests need a card (``test_torch_cuda.py``).
"""

import pytest
import torch

from zigma_tpu_torch.ops import conv_cuda
from zigma_tpu_torch.ops.causal_conv1d import (causal_conv1d,
                                               causal_conv1d_bwd_ref,
                                               causal_conv1d_fwd_op)


def _inputs(batch, L, d, W, bias, init, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, dtype=torch.float64)
    return dict(x=r(batch, L, d).to(dtype), w=(0.5 * r(d, W)).float(),
                b=(0.5 * r(d)).float() if bias else None,
                init=r(batch, W - 1, d).to(dtype) if init else None,
                dy=r(batch, L, d).to(dtype))


def _autograd(t, act, accum):
    """Gradients of the plain forward by autograd, in the inputs' dtypes."""
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in t.items() if v is not None and k != "dy"}
    y = causal_conv1d(leaves["x"], leaves["w"], leaves.get("b"), act,
                      leaves.get("init"), accum)
    y.backward(t["dy"])
    return tuple(None if k not in leaves else leaves[k].grad
                 for k in ("x", "w", "b", "init"))


def _gap(a, b):
    """||a - b|| / ||b|| in float64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


@pytest.mark.parametrize("case", ["fp32", "bf16_acc32"])
@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("act", ["silu", None])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("L", [1, 3, 16])
@pytest.mark.parametrize("W", [2, 3, 4])
def test_bwd_ref_matches_autograd_of_the_plain_forward(W, L, bias, act,
                                                       init, case):
    """Against autograd of the plain forward at a ragged width (d 5): in
    float32 throughout, and with bf16 inputs accumulated in float32
    (``conv_fp32_taps``), where autograd too runs the taps' backward in
    float32 and rounds dx to bf16 once (one bf16 ulp apart at most)."""
    dtype, accum = ((torch.float32, None) if case == "fp32"
                    else (torch.bfloat16, torch.float32))
    t = _inputs(2, L, 5, W, bias, init, dtype)
    got = causal_conv1d_bwd_ref(t["x"], t["w"], t["b"], t["dy"], t["init"],
                                act, accum)
    want = _autograd(t, act, accum)
    for name, a, b in zip(("dx", "dw", "db", "dinit"), got, want):
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, name
        ulp = 2.0 ** -7 if a.dtype == torch.bfloat16 else 0.0
        torch.testing.assert_close(a.double(), b.double(), atol=1e-5,
                                   rtol=max(ulp, 1e-5), msg=name)


@pytest.mark.parametrize("act", ["silu", None])
@pytest.mark.parametrize("W", [2, 4])
def test_bwd_ref_in_bf16_is_no_worse_than_plain_autograd(W, act):
    """bf16 inputs accumulated in bf16 (the models' default): against the
    float64 autograd of the same values, the reference's gradients (fp32
    sums from the bf16-rounded pre-activation) are no farther than plain
    bf16 autograd's (every tap's product and sum rounded to bf16)."""
    t = _inputs(4, 64, 48, W, True, True, torch.bfloat16, seed=1)
    truth = _autograd({k: None if v is None else v.double()
                       for k, v in t.items()}, act, None)
    plain = _autograd(t, act, None)
    got = causal_conv1d_bwd_ref(t["x"], t["w"], t["b"], t["dy"], t["init"],
                                act, None)
    for name, a, p, tr in zip(("dx", "dw", "db", "dinit"), got, plain,
                              truth):
        assert _gap(a, tr) <= _gap(p, tr), name


@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("W", [1, 2, 3, 4])
def test_operator_on_the_cpu_gradcheck(W, init, silu):
    """The registered operator on CPU tensors: the plain forward, bit for
    bit, and ``causal_conv1d_bwd_ref`` as its backward (float64
    gradcheck), the left context's gradient included."""
    t = _inputs(2, 5, 3, W, True, init, torch.float64)
    args = [t["x"], t["w"].double(), t["b"].double(), t["init"]]
    args = [None if a is None else a.requires_grad_(True) for a in args]
    y = causal_conv1d_fwd_op(*args, silu, None)
    assert torch.equal(y, causal_conv1d(*(None if a is None else a.detach()
                                          for a in args[:3]),
                                        "silu" if silu else None,
                                        None if args[3] is None
                                        else args[3].detach()))
    assert torch.autograd.gradcheck(
        lambda *a: causal_conv1d_fwd_op(*a, silu, None), tuple(args))


def test_cpu_tensor_stays_on_the_plain_ops():
    """``causal_conv1d`` on a CPU tensor, with a gradient or without,
    records plain torch ops and calls no kernel wrapper; the wrappers
    refuse a CPU tensor."""
    t = _inputs(2, 7, 6, 4, True, False, torch.float32)
    w = t["w"].clone().requires_grad_(True)
    before = (conv_cuda.causal_conv1d_fwd_cuda.launches,
              conv_cuda.causal_conv1d_bwd_cuda.launches)
    y = causal_conv1d(t["x"], w, t["b"])
    y.sum().backward()
    assert "Silu" in type(y.grad_fn).__name__
    assert (conv_cuda.causal_conv1d_fwd_cuda.launches,
            conv_cuda.causal_conv1d_bwd_cuda.launches) == before
    with pytest.raises(ValueError, match="on cpu"):
        conv_cuda.causal_conv1d_fwd_cuda(t["x"], t["w"], t["b"])
    with pytest.raises(ValueError, match="on cpu"):
        conv_cuda.causal_conv1d_bwd_cuda(t["x"], t["w"], t["b"], t["dy"])
