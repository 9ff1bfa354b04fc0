"""Port scan backward vs the JAX package: the plain adjoint, the autograd
Function and the token permutation's gradient.

- ``selective_scan_bwd_ref`` (K2's plain version) against
  ``scan_core_bwd_pallas`` in interpret mode -- the TPU kernel K2 replaces --
  on every output, core and fused gate, with and without ``g_last``, from
  the same numpy inputs and the same chunk-start states.
- ``selective_scan_bwd_ref`` against ``torch.autograd`` through
  ``selective_scan_ref`` (ragged L, seeded state, final-state cotangent).
- ``selective_scan`` under autograd on the CPU (``scan_with_grad``) against
  ``jax.grad`` of ``selective_scan_pallas`` (interpret), with the final
  state too (``return_last_state``).
- ``core_x0`` / ``core_full`` (the seed and the final state under
  autograd) against the JAX custom VJPs ``_core_x0`` / ``_core_full``
  (interpret): outputs and every gradient, ``dx0`` included, with the loss
  on both outputs, on y alone and on the final state alone.
- ``permute_tokens``' gradient against JAX's and against torch indexing's
  scatter-add gradient.

Tolerance: fp32, per element |port - jax| <= 1e-5 * max |jax| for each
output (measured below 4e-7 of max: the two sides differ in exp/log1p ulps
and summation order only).  The permutation gradients are bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zigma_tpu.models.mamba import permute_tokens as jax_permute_tokens
from zigma_tpu.ops.scan_pallas import (_core_full, _core_x0,
                                       scan_core_bwd_pallas,
                                       scan_core_fwd_pallas,
                                       selective_scan_pallas)
from zigma_tpu_torch.models.mamba import permute_tokens
from zigma_tpu_torch.ops import scan_cuda
from zigma_tpu_torch.ops.paths import build_layer_paths
from zigma_tpu_torch.ops.selective_scan import (core_full, core_x0,
                                                selective_scan,
                                                selective_scan_bwd_ref,
                                                selective_scan_ref)

TOL = 1e-5
NAMES = ("du", "ddelta", "dA", "dB", "dC", "dbias", "dx0", "dz", "dD")


def _inputs(seed, batch=2, L=256, D=128, N=16):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(u=f(batch, L, D), delta=0.5 * f(batch, L, D),
                A=-np.exp(0.5 * f(D, N)), B=f(batch, L, N), C=f(batch, L, N),
                bias=0.1 * f(D), Dskip=f(D), z=f(batch, L, D),
                gy=f(batch, L, D), g_last=f(batch, N, D), x0=f(batch, N, D))


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _assert_close(name, got, ref, tol=TOL):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, name
    err = np.max(np.abs(got - ref))
    assert err <= tol * np.max(np.abs(ref)), (name, err, np.max(np.abs(ref)))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("with_g_last", [False, True])
def test_plain_backward_matches_pallas_kernel(fused, with_g_last):
    d = _inputs(0)
    j = {k: jnp.asarray(v) for k, v in d.items()}
    gl = j["g_last"] if with_g_last else None
    Dk, zk = (j["Dskip"], j["z"]) if fused else (None, None)
    _, carries, _ = scan_core_fwd_pallas(
        j["u"], j["delta"], j["bias"], j["A"], j["B"], j["C"], None, Dk, zk,
        block_d=128, interpret=True)
    ref = scan_core_bwd_pallas(
        j["u"], j["delta"], j["bias"], j["A"], j["B"], j["C"], carries,
        j["gy"], gl, Dk, zk, block_d=128, interpret=True)
    t = {k: _t(v) for k, v in d.items()}
    got = selective_scan_bwd_ref(
        t["u"], t["delta"], t["bias"], t["A"], t["B"], t["C"],
        _t(carries), t["gy"], t["g_last"] if with_g_last else None,
        t["Dskip"] if fused else None, t["z"] if fused else None)
    assert len(got) == len(ref) == (9 if fused else 7)
    for name, g, r in zip(NAMES, got, ref):
        _assert_close(name, g.numpy(), r)


@pytest.mark.parametrize("fused", [False, True])
def test_plain_backward_matches_autograd(fused):
    """Ragged L = 200 (a short second chunk), a seed state and a cotangent
    on the final state: every output against torch.autograd through the
    plain forward."""
    d = _inputs(1, L=200, D=24, N=8)
    t = {k: _t(v, grad=True) for k, v in d.items()}
    Dk, zk = (t["Dskip"], t["z"]) if fused else (None, None)
    y, carries, x_last = selective_scan_ref(
        t["u"], t["delta"], t["A"], t["B"], t["C"], Dk, zk, t["bias"], True,
        x0=t["x0"])
    loss = (y * t["gy"]).sum() + (x_last * t["g_last"]).sum()
    wrt = ["u", "delta", "A", "B", "C", "bias", "x0"] + (["z", "Dskip"]
                                                        if fused else [])
    ref = torch.autograd.grad(loss, [t[k] for k in wrt])
    with torch.no_grad():
        got = selective_scan_bwd_ref(
            t["u"], t["delta"], t["bias"], t["A"], t["B"], t["C"], carries,
            t["gy"], t["g_last"], Dk, zk)
    for name, g, r in zip(NAMES, got, ref):
        _assert_close(name, g, r)


# (D and z to the port, D and z to JAX, JAX fuses the gate into its kernel)
VARIANTS = {"fused_gate": (True, True, True),
            "jax_gate_outside": (True, True, False),
            "skip_only": (True, False, False),
            "core": (False, False, False)}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_autograd_function_matches_jax_grad(variant):
    """selective_scan under autograd on the CPU (scan_with_grad over the
    plain versions) vs jax.grad of selective_scan_pallas in interpret mode:
    the gate fused into the Function (against JAX's fused kernel and its
    jnp epilogue), the skip term alone around it, and the bare core."""
    with_D, with_z, fuse = VARIANTS[variant]
    d = _inputs(2)
    gy = d["gy"]
    keys = ["u", "delta", "A", "B", "C", "bias"] + (["Dskip"] if with_D
                                                     else [])
    keys += ["z"] if with_z else []

    def jax_loss(*args):
        a = dict(zip(keys, args))
        out = selective_scan_pallas(
            a["u"], a["delta"], a["A"], a["B"], a["C"], a.get("Dskip"),
            a.get("z"), a["bias"], delta_softplus=True, fuse_gate=fuse,
            interpret=True)
        return jnp.sum(out * gy)

    ref = jax.grad(jax_loss, argnums=tuple(range(len(keys))))(
        *(jnp.asarray(d[k]) for k in keys))
    t = {k: _t(d[k], grad=True) for k in keys}
    out = selective_scan(t["u"], t["delta"], t["A"], t["B"], t["C"],
                         t.get("Dskip"), t.get("z"), t["bias"],
                         delta_softplus=True)
    (out * _t(gy)).sum().backward()
    for k, r in zip(keys, ref):
        _assert_close(k, t[k].grad, r)


def test_autograd_function_routes_and_types():
    """Under a gradient the scan goes through the Function (the plain
    forward with carries, then the plain backward); the gradients come in
    the JAX types: du/ddelta/dz/dB/dC in the input dtype, dA/dbias/dD
    fp32; the final state under autograd takes the same one call each
    way (its values: ``test_return_last_state_matches_jax_grad``)."""
    d = _inputs(3, L=64, D=16, N=4)
    bf = {k: _t(d[k]).to(torch.bfloat16).requires_grad_()
          for k in ("u", "delta", "B", "C", "z")}
    f32 = {k: _t(d[k], grad=True) for k in ("A", "Dskip", "bias")}
    calls = selective_scan_ref.calls, selective_scan_bwd_ref.calls
    launches = (scan_cuda.selective_scan_fwd_cuda.launches,
                scan_cuda.selective_scan_bwd_cuda.launches)
    out = selective_scan(bf["u"], bf["delta"], f32["A"], bf["B"], bf["C"],
                         f32["Dskip"], bf["z"], f32["bias"],
                         delta_softplus=True)
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert (selective_scan_ref.calls, selective_scan_bwd_ref.calls) == (
        calls[0] + 1, calls[1] + 1)
    assert (scan_cuda.selective_scan_fwd_cuda.launches,
            scan_cuda.selective_scan_bwd_cuda.launches) == launches
    for k, v in bf.items():
        assert v.grad.dtype == torch.bfloat16, k
    for k, v in f32.items():
        assert v.grad.dtype == torch.float32, k
    # the final state under autograd: one forward and one backward, the
    # state in fp32 and the reference's (batch, d, N) layout
    calls = selective_scan_ref.calls, selective_scan_bwd_ref.calls
    out, last = selective_scan(bf["u"], bf["delta"], f32["A"], bf["B"],
                               bf["C"], delta_bias=f32["bias"],
                               delta_softplus=True, return_last_state=True)
    assert out.dtype == torch.bfloat16 and last.dtype == torch.float32
    assert last.shape == (2, 16, 4)
    (out.float().sum() + last.sum()).backward()
    assert (selective_scan_ref.calls, selective_scan_bwd_ref.calls) == (
        calls[0] + 1, calls[1] + 1)


@pytest.mark.parametrize("scan_type", ["zigzagN8", "hilbertN8"])
def test_permute_tokens_gradient(scan_type):
    """The inverse-gather backward equals JAX's custom VJP and torch
    indexing's scatter-add, bit for bit (each row receives one row)."""
    perms, revs, _ = build_layer_paths(scan_type, 3, 8, seed=1)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 64, 16)).astype(np.float32)
    w = rng.standard_normal((2, 64, 16)).astype(np.float32)
    for perm, rev in zip(perms, revs):
        ref = jax.grad(lambda a: jnp.sum(
            jax_permute_tokens(a, jnp.asarray(perm), jnp.asarray(rev))
            * w))(jnp.asarray(x))
        xt = _t(x, grad=True)
        out = permute_tokens(xt, torch.as_tensor(perm), torch.as_tensor(rev))
        (out * _t(w)).sum().backward()
        np.testing.assert_array_equal(out.detach().numpy(), x[:, perm])
        np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(ref))
        xs = _t(x, grad=True)
        (xs[:, torch.as_tensor(perm)] * _t(w)).sum().backward()
        np.testing.assert_array_equal(xt.grad.numpy(), xs.grad.numpy())


# which outputs the loss reads: both, y alone, the final state alone
LOSSES = {"both": (True, True), "y_only": (True, False),
          "last_only": (False, True)}


@pytest.mark.parametrize("loss", list(LOSSES))
@pytest.mark.parametrize("seeded", [False, True])
def test_core_x0_and_core_full_match_jax(loss, seeded):
    """core_full (and core_x0 where the loss reads y alone) against the JAX
    custom VJPs on the same numpy inputs: y, the final state and the
    gradients of u, delta, A, B, C, the bias and the seed.  A loss on one
    output alone leaves the other's cotangent None in autograd; the
    Function turns that into no seed or a zero cotangent, exactly."""
    use_y, use_last = LOSSES[loss]
    d = _inputs(5, L=256, D=24, N=8)
    keys = ["u", "delta", "A", "B", "C", "bias", "x0"]
    zero = np.zeros_like(d["x0"])
    x0 = d["x0"] if seeded else zero
    wy = d["gy"] if use_y else np.zeros_like(d["gy"])
    wl = d["g_last"] if use_last else zero

    def jax_fn(u, delta, A, B, C, bias, x0_):
        y, x_last = _core_full((True, True), u, delta, A, B, C, bias, x0_)
        return y, x_last, jnp.sum(y * wy) + jnp.sum(x_last * wl)

    y_ref, last_ref, _ = jax_fn(*(jnp.asarray(d[k]) for k in keys[:-1]),
                                jnp.asarray(x0))
    ref = jax.grad(lambda *a: jax_fn(*a)[2], argnums=tuple(range(7)))(
        *(jnp.asarray(d[k]) for k in keys[:-1]), jnp.asarray(x0))
    t = {k: _t(d[k], grad=True) for k in keys[:-1]}
    t["x0"] = _t(x0, grad=True)
    args = [t[k] for k in keys]
    if loss == "y_only":
        y = core_x0(*args)
        loss_t = (y * _t(wy)).sum()
        y_jx0 = _core_x0((True, True), *(jnp.asarray(d[k])
                                         for k in keys[:-1]), jnp.asarray(x0))
        _assert_close("y_x0", y.detach(), y_jx0)
    else:
        y, x_last = core_full(*args)
        _assert_close("x_last", x_last.detach(), last_ref)
        loss_t = (x_last * _t(wl)).sum()
        if use_y:
            loss_t = loss_t + (y * _t(wy)).sum()
    _assert_close("y", y.detach(), y_ref)
    loss_t.backward()
    for k, r in zip(keys, ref):
        _assert_close(k, t[k].grad, r)


def test_return_last_state_matches_jax_grad():
    """selective_scan(..., return_last_state=True) under autograd, the gate
    fused, against jax.grad of selective_scan_pallas with the final state
    (its _core_full from a zero seed): the output, the (batch, d, N) state
    and every gradient of a loss on both."""
    d = _inputs(6, L=256, D=16, N=8)
    keys = ["u", "delta", "A", "B", "C", "Dskip", "z", "bias"]
    g_last = np.transpose(d["g_last"], (0, 2, 1))

    def jax_loss(*a):
        a = dict(zip(keys, a))
        out, last = selective_scan_pallas(
            a["u"], a["delta"], a["A"], a["B"], a["C"], a["Dskip"], a["z"],
            a["bias"], delta_softplus=True, return_last_state=True,
            interpret=True)
        return jnp.sum(out * d["gy"]) + jnp.sum(last * g_last), (out, last)

    (_, (out_ref, last_ref)), ref = jax.value_and_grad(
        jax_loss, argnums=tuple(range(len(keys))), has_aux=True)(
        *(jnp.asarray(d[k]) for k in keys))
    t = {k: _t(d[k], grad=True) for k in keys}
    out, last = selective_scan(t["u"], t["delta"], t["A"], t["B"], t["C"],
                               t["Dskip"], t["z"], t["bias"],
                               delta_softplus=True, return_last_state=True)
    _assert_close("out", out.detach(), out_ref)
    _assert_close("last", last.detach(), last_ref)
    ((out * _t(d["gy"])).sum() + (last * _t(g_last)).sum()).backward()
    for k, r in zip(keys, ref):
        _assert_close(k, t[k].grad, r)
