"""The selective scan's whole contract in the port against the JAX package.

The same numpy inputs from a seed go through the JAX function (jitted) and
the port's counterpart:

- the plain versions: ``selective_scan_ref`` on grouped (G 2 and 4), mixed
  rank, static and complex (complex A, real or complex B / C) B / C and
  without softplus, against the JAX ``selective_scan_ref``;
- the plain adjoint ``selective_scan_bwd_ref`` (K2's plain version),
  grouped and without softplus, against ``jax.grad`` through the JAX
  ``selective_scan(..., backend="pallas")``: off the TPU that is the
  vmapped Pallas kernels in interpret mode, the TPU kernels themselves;
- the chunked and associative backends, forward, final state and every
  gradient, against the JAX ``backend="chunked"`` / ``"assoc"``, at a
  ragged L with chunks of 16, real and complex, grouped, and at d_state
  300;
- one decode step, complex;
- the dispatch: which backend ``auto`` takes (the ``.calls`` counters) and
  the JAX package's ValueErrors;
- (``tests/test_torch_zigma_modes.py``: the model's scan backends and the
  conditioned ``FinalLayer``).

Tolerances.  Real fp32 at unit scale: max abs 1e-4 (TOL), the two sides
differing in exp / log1p ulps and summation order only.  Complex outputs
and every gradient: max abs over max |JAX| at most 1e-5 (REL).  Torch's
gradient of a complex leaf is the conjugate of JAX's (``jax.grad`` of
``2 Re(k w)`` is ``2k``, torch's ``2 conj(k)``), so a complex gradient is
held against ``conj(jax_grad)``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zigma_tpu.ops.selective_scan import selective_scan as jax_selective_scan
from zigma_tpu.ops.selective_scan import \
    selective_state_update as jax_state_update
from zigma_tpu_torch.ops import scan_cuda
from zigma_tpu_torch.ops.scan_chunked import (selective_scan_assoc,
                                              selective_scan_chunked)
from zigma_tpu_torch.ops.selective_scan import (scan_backend, selective_scan,
                                                selective_scan_bwd_ref,
                                                selective_scan_ref,
                                                selective_state_update)

TOL = 1e-4
REL = 1e-5
GRAD_NAMES = ("u", "delta", "A", "B", "C", "D", "z", "bias")


@functools.partial(jax.jit, static_argnames=(
    "delta_softplus", "return_last_state", "backend", "chunk"))
def _jax_scan(u, delta, A, B, C, D, z, bias, delta_softplus,
              return_last_state=False, backend="ref", chunk=128):
    return jax_selective_scan(u, delta, A, B, C, D, z, bias,
                                  delta_softplus, return_last_state,
                                  backend, chunk)


def _inputs(seed, batch=2, L=40, d=16, N=8, B_shape="var", C_shape=None,
            complex_A=False, complex_BC=False, softplus=True):
    """numpy inputs; B / C: "var" (batch, L, N), "static" (d, N) or an int
    G for (batch, L, G, N).  Without softplus delta is positive (dt = delta
    + bias stays a decay)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)

    def bc(kind):
        shape = {"var": (batch, L, N), "static": (d, N)}.get(
            kind, (batch, L, kind, N))
        m = f(*shape)
        return (m + 1j * f(*shape)).astype(np.complex64) if complex_BC else m

    A = -np.exp(0.5 * f(d, N))
    if complex_A:
        A = (A + 1j * np.pi * f(d, N)).astype(np.complex64)
    delta = (np.abs(0.5 * f(batch, L, d)) + 0.5 if not softplus
             else 0.5 * f(batch, L, d))
    return dict(u=f(batch, L, d), delta=delta.astype(np.float32), A=A,
                B=bc(B_shape), C=bc(B_shape if C_shape is None else C_shape),
                D=f(d), z=f(batch, L, d), bias=0.1 * f(d))


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _close(name, got, ref, rel=None):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    err = np.max(np.abs(got - ref))
    limit = TOL if rel is None else rel * max(np.max(np.abs(ref)), 1e-30)
    assert err <= limit, (name, err, limit)


PLAIN_CASES = {
    "grouped_G2": dict(B_shape=2),
    "grouped_G4": dict(B_shape=4),
    "mixed_B3_C4": dict(B_shape="var", C_shape=4),
    "mixed_B4_C3": dict(B_shape=2, C_shape="var"),
    "static": dict(B_shape="static"),
    "complex_A_real_BC": dict(complex_A=True),
    "complex_A_complex_BC": dict(complex_A=True, complex_BC=True),
    "no_softplus_grouped": dict(B_shape=4, softplus=False),
}


@pytest.mark.parametrize("case", list(PLAIN_CASES))
def test_plain_scan_matches_jax(case):
    kw = PLAIN_CASES[case]
    d = _inputs(0, **kw)
    sp = kw.get("softplus", True)
    y_j, last_j = _jax_scan(*(jnp.asarray(d[k]) for k in GRAD_NAMES), sp,
                            True, "ref")
    y, _, x_last = selective_scan_ref(*(_t(d[k]) for k in GRAD_NAMES), sp)
    cplx = "complex" in case
    _close("y", y, y_j, REL if cplx else None)
    _close("x_last", x_last.transpose(1, 2), last_j, REL if cplx else None)


ADJOINT_CASES = {
    # grouped B / C with the fused gate: the vmapped Pallas kernels
    "grouped_G2_fused": dict(inputs=dict(B_shape=2), fused=True),
    # without softplus, grouped, the core scan alone
    "no_softplus_G4": dict(inputs=dict(B_shape=4, softplus=False),
                           fused=False),
}


@pytest.mark.parametrize("case", list(ADJOINT_CASES))
def test_plain_adjoint_matches_pallas_grad(case):
    cfg = ADJOINT_CASES[case]
    d = _inputs(1, **cfg["inputs"])
    sp, fused = cfg["inputs"].get("softplus", True), cfg["fused"]
    gy = np.random.default_rng(2).standard_normal(d["u"].shape).astype(
        np.float32)
    names = GRAD_NAMES if fused else ("u", "delta", "A", "B", "C", "bias")

    def loss(*args):
        kw = dict(zip(names, args))
        y = jax_selective_scan(
            kw["u"], kw["delta"], kw["A"], kw["B"], kw["C"], kw.get("D"),
            kw.get("z"), kw["bias"], sp, backend="pallas")
        return jnp.sum(y * gy)

    ref = jax.jit(jax.grad(loss, argnums=tuple(range(len(names)))))(
        *(jnp.asarray(d[k]) for k in names))
    t = {k: _t(v) for k, v in d.items()}
    Dk, zk = (t["D"], t["z"]) if fused else (None, None)
    _, carries, _ = selective_scan_ref(t["u"], t["delta"], t["A"], t["B"],
                                       t["C"], Dk, zk, t["bias"], sp)
    got = selective_scan_bwd_ref(t["u"], t["delta"], t["bias"], t["A"],
                                 t["B"], t["C"], carries, _t(gy), None, Dk,
                                 zk, sp)
    got = dict(zip(("u", "delta", "A", "B", "C", "bias", "x0", "z", "D"),
                   got))
    for name, r in zip(names, ref):
        _close(f"d{name}", got[name], r, REL)


BACKEND_CASES = {
    # ragged L = 50 over chunks of 16, the final state under the loss
    "chunked_real_last_state": dict(backend="chunked", L=50, last=True),
    "chunked_grouped_G2_no_softplus": dict(backend="chunked", L=50,
                                           inputs=dict(B_shape=2,
                                                       softplus=False)),
    # complex A, B and C, B grouped and C shared (mixed rank)
    "chunked_complex_mixed_last_state": dict(
        backend="chunked", L=50, last=True,
        inputs=dict(complex_A=True, complex_BC=True, B_shape=2,
                    C_shape="var")),
    # d_state 300: past the kernels' 256, auto's route to chunked
    "chunked_N300": dict(backend="chunked", L=16, d=4, N=300, last=True),
    "assoc_static_last_state": dict(backend="assoc", L=50, last=True,
                                    inputs=dict(B_shape="static")),
}


@pytest.mark.parametrize("case", list(BACKEND_CASES))
def test_torch_backends_match_jax(case):
    cfg = BACKEND_CASES[case]
    kw = cfg.get("inputs", {})
    d = _inputs(3, L=cfg["L"], d=cfg.get("d", 16), N=cfg.get("N", 8), **kw)
    sp, last, backend = kw.get("softplus", True), cfg.get("last", False), \
        cfg["backend"]
    rng = np.random.default_rng(4)
    gy = rng.standard_normal(d["u"].shape).astype(np.float32)
    shape_last = (d["u"].shape[0], d["u"].shape[2], d["A"].shape[1])
    g_last = (rng.standard_normal(shape_last)
              + 1j * rng.standard_normal(shape_last)).astype(np.complex64)

    def loss(*args):
        res = jax_selective_scan(*args[:5], args[5], args[6], args[7],
                                 sp, last, backend, 16)
        y, x = res if last else (res, None)
        out = jnp.sum(y * gy)
        return (out + jnp.sum(jnp.real(x * g_last)) if last else out), res

    jargs = [jnp.asarray(d[k]) for k in GRAD_NAMES]
    (_, fwd), ref = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(8)), has_aux=True))(*jargs)

    leaves = [_t(d[k], grad=True) for k in GRAD_NAMES]
    counter = {"chunked": selective_scan_chunked,
               "assoc": selective_scan_assoc}[backend]
    calls = counter.calls
    res = selective_scan(*leaves[:5], leaves[5], leaves[6], leaves[7], sp,
                         last, backend, 16)
    assert counter.calls == calls + 1
    y, x = res if last else (res, None)
    cplx = np.iscomplexobj(d["A"])
    _close("y", y, fwd[0] if last else fwd, REL if cplx else None)
    loss_t = (y * _t(gy)).sum()
    if last:
        _close("x_last", x, fwd[1], REL)
        loss_t = loss_t + (x * _t(g_last)).real.sum()
    loss_t.backward()
    for name, leaf, r in zip(GRAD_NAMES, leaves, ref):
        r = np.asarray(r)
        _close(f"d{name}", leaf.grad, np.conj(r) if leaf.is_complex() else r,
               REL)


def test_complex_decode_step_matches_jax():
    """``selective_state_update`` on a complex64 state with complex A / B /
    C (y = 2 Re<state', C>) against the JAX step."""
    rng = np.random.default_rng(5)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    c = lambda *s: (f(*s) + 1j * f(*s)).astype(np.complex64)
    batch, d, N = 3, 16, 8
    args = dict(state=c(batch, d, N), x=f(batch, d), dt=f(batch, d),
                A=(-np.exp(f(d, N)) + 1j * f(d, N)).astype(np.complex64),
                B=c(batch, N), C=c(batch, N), D=f(d), z=f(batch, d),
                dt_bias=0.1 * f(d))
    y_j, s_j = jax.jit(jax_state_update,
                       static_argnames="dt_softplus")(
        **{k: jnp.asarray(v) for k, v in args.items()}, dt_softplus=True)
    y, s = selective_state_update(**{k: _t(v) for k, v in args.items()},
                                  dt_softplus=True)
    assert s.dtype == torch.complex64 and y.dtype == torch.float32
    _close("y", y, y_j, REL)
    _close("state", s, s_j, REL)


def test_auto_dispatch_and_refusals():
    """``auto`` on CPU tensors: a real variable or grouped scan runs the
    plain versions, complex A and d_state 300 the chunked backend, static
    B / C the associative one; the JAX package's ValueErrors on both
    sides."""
    counters = (selective_scan_ref, selective_scan_chunked,
                selective_scan_assoc)
    for kw, N, want in ((dict(B_shape=2), 8, selective_scan_ref),
                        (dict(complex_A=True), 8, selective_scan_chunked),
                        (dict(), 300, selective_scan_chunked),
                        (dict(B_shape="static"), 8, selective_scan_assoc)):
        d = _inputs(6, L=16, d=4, N=N, **kw)
        t = {k: _t(v) for k, v in d.items()}
        before = [c.calls for c in counters]
        selective_scan(t["u"], t["delta"], t["A"], t["B"], t["C"], t["D"],
                       t["z"], t["bias"], True)
        after = [c.calls for c in counters]
        assert [a - b for a, b in zip(after, before)] == [
            int(c is want) for c in counters], (kw, N)
    assert scan_backend(t["u"], t["A"], t["B"], t["C"], "cuda") == "cuda"
    # (a (batch, L, 1, N) pair is the ungrouped scan, as in JAX)
    d = _inputs(6, L=16, d=4, B_shape=1)
    assert scan_backend(_t(d["u"]), _t(d["A"]), _t(d["B"]), _t(d["C"])) \
        == "ref"

    bad = {
        "complex B/C require complex A": _inputs(7, L=16, complex_BC=True),
        "not divisible": _inputs(7, L=16, B_shape=3),
        "agree on n_groups": _inputs(7, L=16, B_shape=2, C_shape=4),
    }
    for msg, d in bad.items():
        with pytest.raises(ValueError, match=msg):
            jax_selective_scan(*(jnp.asarray(d[k]) for k in GRAD_NAMES))
        for backend in ("auto", "ref"):
            with pytest.raises(ValueError, match=msg):
                selective_scan(*(_t(d[k]) for k in GRAD_NAMES),
                               backend=backend)
    d = _inputs(7, L=16, complex_A=True)
    with pytest.raises(ValueError, match="real-only"):
        selective_scan(*(_t(d[k]) for k in GRAD_NAMES), backend="cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        selective_scan(*(_t(d[k]) for k in GRAD_NAMES), backend="pallas")
    assert scan_cuda.cuda_shape_supported(1024, 1536, 256, torch.bfloat16)
    assert not scan_cuda.cuda_shape_supported(16, 4, 257, torch.float32)
    assert not scan_cuda.cuda_shape_supported(16, 4, 16, torch.float16)
