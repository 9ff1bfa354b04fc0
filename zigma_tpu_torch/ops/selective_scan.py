"""Mamba selective scan: the plain sequential versions, autograd and dispatch.

Counterpart of ``zigma_tpu/ops/selective_scan.py`` and of the custom VJPs
``_core`` / ``_fused`` in ``zigma_tpu/ops/scan_pallas.py``.  The recurrence,
per batch row and channel d, with an fp32 state of N values:

    x_t = exp(dt_t * A) * x_{t-1} + dt_t * u_t * B_t
    y_t = <C_t, x_t> (+ D * u_t) (* silu(z_t))

``selective_scan`` sends CUDA tensors to the hand-written kernels and CPU
tensors to the plain versions; ``backend="ref"`` forces the plain versions on
any device (the tests and ``chip_smoke.py`` compare the two that way).
Without a gradient it calls the forward alone (``selective_scan_fwd_cuda`` or
``selective_scan_ref``).  When a gradient is needed it goes through
``SelectiveScanFn``, whose forward keeps the chunk-start states and whose
backward is ``selective_scan_bwd_cuda`` (CUDA) or ``selective_scan_bwd_ref``
(CPU).  This slice covers real A with variable (batch, L, N) B/C -- the
ZigMa path; complex A, grouped or static B/C, and the last state or a seed
state under autograd are later slices and raise.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from zigma_tpu_torch.ops.scan_cuda import (CARRY_EVERY, selective_scan_bwd_cuda,
                                           selective_scan_fwd_cuda)

__all__ = ["selective_scan", "selective_scan_ref", "selective_scan_bwd_ref",
           "SelectiveScanFn", "kernel_params"]


def _check_supported(A, B, C):
    if A.is_complex() or B.is_complex() or C.is_complex():
        raise NotImplementedError("complex A/B/C (the S4D-complex mode) lands "
                                  "in a later slice of the port")
    if B.dim() != 3 or C.dim() != 3:
        raise NotImplementedError(
            f"variable B/C of shape (batch, L, N) only; grouped or static B/C "
            f"(got {tuple(B.shape)}, {tuple(C.shape)}) land in a later slice")


def _dt(delta, delta_bias, delta_softplus):
    """(dt, d dt / d pre) in fp32, pre = delta + bias."""
    pre = delta.float()
    if delta_bias is not None:
        pre = pre + delta_bias.float()
    if not delta_softplus:
        return pre, torch.ones_like(pre)
    return F.softplus(pre), torch.sigmoid(pre)  # threshold 20, as the kernels


def selective_scan_ref(u, delta, A, B, C,
                       D: Optional[torch.Tensor] = None,
                       z: Optional[torch.Tensor] = None,
                       delta_bias: Optional[torch.Tensor] = None,
                       delta_softplus: bool = False,
                       x0: Optional[torch.Tensor] = None):
    """Plain sequential scan in fp32, step by step over L.

    u, delta: (batch, L, d); A: (d, N); B, C: (batch, L, N); D: (d,);
    z: (batch, L, d); delta_bias: (d,); x0: optional (batch, N, d) seed.
    Returns ``(out, carries, x_last)`` with the kernel's layouts: out in u's
    dtype, carries (batch, ceil(L/128), N, d) fp32 chunk-start states,
    x_last (batch, N, d) fp32.  Counts its calls in
    ``selective_scan_ref.calls``.
    """
    _check_supported(A, B, C)
    selective_scan_ref.calls += 1
    batch, L, d = u.shape
    N = A.shape[1]
    uf = u.float()
    dt, _ = _dt(delta, delta_bias, delta_softplus)
    At = A.float().t()  # (N, d)
    Bf, Cf = B.float(), C.float()
    x = (torch.zeros((batch, N, d), dtype=torch.float32, device=u.device)
         if x0 is None else x0.float().clone())
    carries, ys = [], []
    for t in range(L):
        if t % CARRY_EVERY == 0:
            carries.append(x)
        x = (torch.exp(dt[:, t, None, :] * At) * x
             + (dt[:, t] * uf[:, t])[:, None, :] * Bf[:, t, :, None])
        ys.append(torch.einsum("bnd,bn->bd", x, Cf[:, t]))
    out = torch.stack(ys, dim=1)
    if D is not None:
        out = out + uf * D.float()
    if z is not None:
        out = out * F.silu(z.float())
    return out.to(u.dtype), torch.stack(carries, dim=1), x


selective_scan_ref.calls = 0


def selective_scan_bwd_ref(u, delta, delta_bias, A, B, C, carries, gy,
                           g_last: Optional[torch.Tensor] = None,
                           D: Optional[torch.Tensor] = None,
                           z: Optional[torch.Tensor] = None,
                           delta_softplus: bool = True):
    """Plain sequential adjoint of the scan; the signature and return values
    of ``scan_core_bwd_pallas``.

    carries: the forward's (batch, ceil(L/128), N, d) chunk-start states;
    gy: cotangent of the output (batch, L, d) -- of the gated output when D
    and z are given (the fused gate), else of the raw scan output; g_last:
    optional (batch, N, d) cotangent of the final state.  Each chunk's
    states are recomputed from its carry, then the adjoint
    ``g_t = gy_t * C_t + exp(dt_{t+1} A) g_{t+1}`` walks it in reverse.

    Returns ``(du, ddelta, dA, dB, dC, dbias, dx0)`` and, fused, also
    ``(dz, dD)``: du, ddelta, dz in the dtype of u, delta, z; dB, dC in B's
    and C's dtype; dA (d, N), dbias (d,), dx0 (batch, N, d), dD (d,) fp32.
    dbias sums ddelta after its rounding to delta's dtype, as the JAX kernel
    does.  Counts its calls in ``selective_scan_bwd_ref.calls``.
    """
    _check_supported(A, B, C)
    if (D is None) != (z is None):
        raise ValueError("the fused gate needs D and z together")
    selective_scan_bwd_ref.calls += 1
    batch, L, d = u.shape
    N = A.shape[1]
    uf = u.float()
    dt, sig = _dt(delta, delta_bias, delta_softplus)
    dtu = dt * uf
    At = A.float().t()  # (N, d)
    Bf, Cf = B.float(), C.float()
    g_out = gy.float()
    fused = z is not None
    if fused:
        zf = z.float()
        sig_z = torch.sigmoid(zf)
        gyr = g_out * zf * sig_z  # cotangent of the raw scan output
        Df = D.float()
        y = torch.empty_like(uf)
    else:
        gyr = g_out
    du = torch.empty_like(uf)
    dd = torch.empty_like(uf)
    dB = torch.empty((batch, L, N), dtype=torch.float32, device=u.device)
    dC = torch.empty_like(dB)
    dA = torch.zeros((N, d), dtype=torch.float32, device=u.device)
    c = (torch.zeros((batch, N, d), dtype=torch.float32, device=u.device)
         if g_last is None else g_last.float().clone())
    n_chunks = -(-L // CARRY_EVERY)
    for k in reversed(range(n_chunks)):
        l0, l1 = k * CARRY_EVERY, min(L, (k + 1) * CARRY_EVERY)
        xs, decays = [carries[:, k].float()], []  # xs[j]: state before l0+j
        for t in range(l0, l1):
            decay = torch.exp(dt[:, t, None, :] * At)
            xs.append(decay * xs[-1] + dtu[:, t, None, :] * Bf[:, t, :, None])
            decays.append(decay)
        for j in reversed(range(l1 - l0)):
            t = l0 + j
            g = gyr[:, t, None, :] * Cf[:, t, :, None] + c  # (batch, N, d)
            dla = g * decays[j] * xs[j]  # d loss / d (dt * A)
            gB = (g * Bf[:, t, :, None]).sum(1)
            dd[:, t] = ((dla * At).sum(1) + gB * uf[:, t]) * sig[:, t]
            du[:, t] = dt[:, t] * gB
            dA += (dla * dt[:, t, None, :]).sum(0)
            dB[:, t] = (g * dtu[:, t, None, :]).sum(2)
            dC[:, t] = (gyr[:, t, None, :] * xs[j + 1]).sum(2)
            if fused:
                y[:, t] = (Cf[:, t, :, None] * xs[j + 1]).sum(1)
            c = decays[j] * g
    dd = dd.to(delta.dtype)
    rest = (dA.t().contiguous(), dB.to(B.dtype), dC.to(C.dtype),
            dd.float().sum((0, 1)), c)
    if not fused:
        return (du.to(u.dtype), dd, *rest)
    dz = g_out * (y + uf * Df) * (sig_z * (1 + zf * (1 - sig_z)))
    return ((du + gyr * Df).to(u.dtype), dd, *rest, dz.to(z.dtype),
            (gyr * uf).sum((0, 1)))


selective_scan_bwd_ref.calls = 0


class SelectiveScanFn(torch.autograd.Function):
    """The scan with both directions: the counterpart of the JAX package's
    ``_core`` (D and z None) and ``_fused`` (D and z given) custom VJPs.

    forward: the K1 kernel on CUDA, ``selective_scan_ref`` on the CPU (or
    with ``use_ref``), keeping the chunk-start states; backward: the K2
    kernel on CUDA, ``selective_scan_bwd_ref`` on the CPU (or with
    ``use_ref``).  The kernels take only dt = softplus(delta + bias), and
    A, D and the bias through ``kernel_params``: a missing bias is zeros
    and gets no gradient, and the gradients of A, D and the bias come back
    in the caller's dtypes.
    """

    @staticmethod
    def forward(ctx, u, delta, A, B, C, delta_bias, D, z, delta_softplus,
                use_ref):
        ctx.dtypes = tuple(None if t is None else t.dtype
                           for t in (A, delta_bias, D))
        if not use_ref and u.device.type == "cuda":
            if not delta_softplus:
                raise NotImplementedError(
                    "the CUDA kernels always take dt = softplus(delta + "
                    "delta_bias); a scan without softplus lands in a later "
                    "slice of the port")
            A, D, bias = kernel_params(A, D, delta_bias)
            out, carries, _ = selective_scan_fwd_cuda(
                u, delta, A, B, C, bias, D, z, return_carries=True)
        else:
            bias = delta_bias
            out, carries, _ = selective_scan_ref(u, delta, A, B, C, D, z,
                                                 delta_bias, delta_softplus)
        ctx.save_for_backward(u, delta, A, B, C, bias, D, z, carries)
        ctx.delta_softplus, ctx.use_ref = delta_softplus, use_ref
        return out

    @staticmethod
    def backward(ctx, gy):
        u, delta, A, B, C, delta_bias, D, z, carries = ctx.saved_tensors
        if not ctx.use_ref and u.device.type == "cuda":
            g = selective_scan_bwd_cuda(u, delta, delta_bias, A, B, C,
                                        carries, gy, None, D, z)
        else:
            g = selective_scan_bwd_ref(u, delta, delta_bias, A, B, C, carries,
                                       gy, None, D, z, ctx.delta_softplus)
        du, dd, dA, dB, dC, dbias = g[:6]
        dz, dD = g[7:] if z is not None else (None, None)
        # the parameters' gradients in the caller's dtypes (the kernels took
        # fp32 copies); none for a bias the caller did not give
        A_t, bias_t, D_t = ctx.dtypes
        return (du, dd, dA.to(A_t), dB, dC,
                None if bias_t is None else dbias.to(bias_t),
                None if dD is None else dD.to(D_t), dz, None, None)


def selective_scan(u, delta, A, B, C,
                   D: Optional[torch.Tensor] = None,
                   z: Optional[torch.Tensor] = None,
                   delta_bias: Optional[torch.Tensor] = None,
                   delta_softplus: bool = False,
                   return_last_state: bool = False,
                   backend: str = "auto"):
    """Selective scan with backend dispatch (the JAX function's signature).

    backend: "auto" (CUDA tensor -> the kernels, CPU tensor -> the plain
    versions) or "ref" (the plain versions anywhere).  On a CUDA tensor
    "auto" has no fallback: the kernels launch or raise (they need
    delta_softplus).  With D and z both given the gate is fused into the
    kernels; with only one of them the skip term or the gate is composed
    around the core scan in torch ops, as ``selective_scan_pallas`` does in
    jnp, with a gradient or without.  When a gradient is needed the scan
    goes through ``SelectiveScanFn``.
    Returns out (batch, L, d) in u's dtype, and with ``return_last_state``
    also the final state (batch, d, N) fp32 (the JAX function's layout).
    """
    if backend not in ("auto", "ref"):
        raise ValueError(f"unknown backend {backend!r} (auto | ref)")
    _check_supported(A, B, C)
    use_ref = backend == "ref" or u.device.type == "cpu"
    if not use_ref and not delta_softplus:
        raise NotImplementedError(
            "the CUDA kernels always take dt = softplus(delta + delta_bias); "
            "a scan without softplus lands in a later slice of the port")
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad
        for t in (u, delta, A, B, C, D, z, delta_bias))
    if needs_grad:
        if return_last_state:
            raise NotImplementedError(
                "the final state under autograd (the JAX _core_full) serves "
                "sequence parallelism and prefill, which land in a later "
                "slice of the port")
        if D is not None and z is not None:
            return SelectiveScanFn.apply(u, delta, A, B, C, delta_bias, D, z,
                                         delta_softplus, use_ref)
        y = SelectiveScanFn.apply(u, delta, A, B, C, delta_bias, None, None,
                                  delta_softplus, use_ref)
        return _skip_and_gate(y, u, D, z)
    if use_ref:
        out, _, x_last = selective_scan_ref(u, delta, A, B, C, D, z,
                                            delta_bias, delta_softplus)
    else:
        # the kernel fuses the skip term and the gate only together
        fused = (D is None) == (z is None)
        A32, D32, bias = kernel_params(A, D if fused else None, delta_bias)
        out, _, x_last = selective_scan_fwd_cuda(
            u, delta, A32, B, C, bias, D32, z if fused else None,
            return_carries=False)
        if not fused:
            out = _skip_and_gate(out, u, D, z)
    return (out, x_last.transpose(1, 2)) if return_last_state else out


def kernel_params(A, D, delta_bias):
    """``(A, D, delta_bias)`` as the CUDA kernels take them: contiguous fp32
    copies where the caller's are of another dtype or layout, and zeros of
    shape (d,) for a missing bias, as the JAX Pallas entry puts them
    (``zigma_tpu/ops/scan_pallas.py::selective_scan_pallas``).  D stays
    None when not given."""
    f32 = lambda t: t.to(torch.float32).contiguous()
    bias = (torch.zeros(A.shape[0], dtype=torch.float32, device=A.device)
            if delta_bias is None else f32(delta_bias))
    return f32(A), None if D is None else f32(D), bias


def _skip_and_gate(y, u, D, z):
    """``(y + u * D) * silu(z)`` in fp32, each factor only where given, as
    ``selective_scan_pallas`` composes it around the core scan in jnp;
    returns u's dtype."""
    y = y.float()
    if D is not None:
        y = y + u.float() * D.float()
    if z is not None:
        y = y * F.silu(z.float())
    return y.to(u.dtype)
