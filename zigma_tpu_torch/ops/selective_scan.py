"""Mamba selective scan: the plain sequential versions, autograd and dispatch.

Counterpart of ``zigma_tpu/ops/selective_scan.py`` and of the custom VJPs
``_core`` / ``_fused`` in ``zigma_tpu/ops/scan_pallas.py``.  The recurrence,
per batch row and channel d, with an fp32 state of N values:

    x_t = exp(dt_t * A) * x_{t-1} + dt_t * u_t * B_t
    y_t = <C_t, x_t> (+ D * u_t) (* silu(z_t))

The whole contract of the JAX function: dt = softplus(delta + bias) or,
without ``delta_softplus``, delta + bias; B and C static (d, N), variable
(batch, L, N) or grouped (batch, L, G, N) (group g over the d/G consecutive
channels [g d/G, (g+1) d/G)), of mixed rank too; real A, or complex A with
real or complex B / C (the S4D-complex mode: the state in complex64, ``y =
2 Re<C, x>``).

``selective_scan``'s backends mirror the JAX dispatch (``scan_backend``):
``cuda`` (the hand-written kernels K1 / K2, the counterpart of ``pallas``)
for a real variable or grouped scan that ``cuda_shape_supported`` accepts,
on a CUDA tensor; ``ref`` (the plain sequential versions) for the same scan
on a CPU tensor, or on request anywhere (the tests and ``chip_smoke.py``
compare the two that way); ``chunked`` (``ops/scan_chunked.py``) for complex
A and for d_state above what the kernels hold; ``assoc`` for static B / C.
The choice follows shapes and dtypes alone: an explicit ``backend="cuda"``
that the kernels cannot take raises.

On ``cuda`` and ``ref``, without a gradient the forward runs alone
(``selective_scan_fwd_cuda`` or ``selective_scan_ref``).  When a gradient is
needed it goes through ``scan_with_grad``: the registered operator
``zigma::selective_scan_fwd`` (``selective_scan_fwd_op``), whose forward
keeps the chunk-start states and whose backward, attached by
``register_autograd``, is ``selective_scan_bwd_cuda`` (CUDA) or
``selective_scan_bwd_ref`` (CPU).  As an operator the forward is visible to
a selective-checkpoint policy, which can keep its outputs for the backward
instead of recomputing them.  The same operator runs ``core_x0`` /
``core_full`` (a seed state, the final state under autograd), which
sequence parallelism runs.  A complex scan under autograd on ``ref``
differentiates through the plain forward with torch autograd (as JAX's
``ref`` autodiffs through its ``lax.scan``).

``selective_state_update`` is one decode step of the same recurrence in
plain fp32 (complex64) torch ops (the JAX package writes it in jnp, not
Pallas).  An LM prefill is ``selective_scan(..., return_last_state=True)``,
which on CUDA is one K1 launch (and one K2 launch under a gradient).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from zigma_tpu_torch.ops.scan_chunked import (check_complex, delta_prep, f32,
                                              selective_scan_assoc,
                                              selective_scan_chunked,
                                              skip_and_gate)
from zigma_tpu_torch.ops.scan_cuda import (CARRY_EVERY, cuda_shape_supported,
                                           selective_scan_bwd_cuda,
                                           selective_scan_fwd_cuda)

__all__ = ["selective_scan", "selective_scan_ref", "selective_scan_bwd_ref",
           "selective_scan_fwd_op", "scan_with_grad", "core_x0", "core_full",
           "kernel_params", "selective_state_update", "scan_backend",
           "selective_scan_flops", "BACKENDS"]

BACKENDS = ("auto", "cuda", "chunked", "assoc", "ref")


def check_bc(A, B, C, d: int):
    """The JAX function's checks of B and C against A and d_inner: complex
    B / C need complex A, a grouped one's G divides d, grouped B and C agree
    on G."""
    check_complex(A, B, C)
    for M in (B, C):
        if M.dim() not in (2, 3, 4):
            raise ValueError(f"bad B/C shape {tuple(M.shape)}")
        if M.dim() == 4 and d % M.shape[2]:
            raise ValueError(f"d_inner {d} not divisible by {M.shape[2]} "
                             f"B/C groups")
    if B.dim() == 4 and C.dim() == 4 and B.shape[2] != C.shape[2]:
        raise ValueError(
            f"grouped B/C must agree on n_groups (got {B.shape[2]} vs "
            f"{C.shape[2]}; the reference kernel checks C against B's "
            "n_groups, selective_scan.cpp)")


def _bc_at(M, d: int):
    """``t -> M``'s values at step t, broadcastable against a (batch, N, d)
    state: static (d, N) the same at every step, (batch, L, N) shared by
    every channel, grouped (batch, L, G, N) repeated over each group's d/G
    channels."""
    M = f32(M)
    if M.dim() == 2:
        Mt = M.t()
        return lambda t: Mt
    if M.dim() == 3:
        return lambda t: M[:, t, :, None]
    Mg = M.transpose(2, 3)  # (batch, L, N, G)
    return lambda t: Mg[:, t].repeat_interleave(d // M.shape[2], dim=-1)


def _bc_grad_add(dM, t: int, g):
    """Add g (batch, N, d), the gradient of step t's per-channel B (or C),
    into dM in M's layout: summed over batch and accumulated for static
    (d, N), over channels for (batch, L, N), over each group's channels
    for (batch, L, G, N)."""
    if dM.dim() == 2:
        dM += g.sum(0).t()
    elif dM.dim() == 3:
        dM[:, t] = g.sum(2)
    else:
        dM[:, t] = g.unflatten(2, (dM.shape[2], -1)).sum(3).transpose(1, 2)


def selective_scan_ref(u, delta, A, B, C,
                       D: Optional[torch.Tensor] = None,
                       z: Optional[torch.Tensor] = None,
                       delta_bias: Optional[torch.Tensor] = None,
                       delta_softplus: bool = False,
                       x0: Optional[torch.Tensor] = None):
    """Plain sequential scan in fp32 (complex64 with complex A), step by
    step over L: the counterpart of the JAX ``selective_scan_ref`` and K1's
    plain version.

    u, delta: (batch, L, d); A: (d, N), real or complex; B, C: static
    (d, N), variable (batch, L, N) or grouped (batch, L, G, N), each of its
    own rank, complex only with complex A; D: (d,); z: (batch, L, d);
    delta_bias: (d,); x0: optional (batch, N, d) seed.  With complex A,
    ``y = 2 Re<C, x>``.  Returns ``(out, carries, x_last)`` with the
    kernel's layouts: out in u's dtype, carries (batch, ceil(L/128), N, d)
    chunk-start states, x_last (batch, N, d), both fp32 (complex64).  Counts
    its calls in ``selective_scan_ref.calls``.
    """
    batch, L, d = u.shape
    check_bc(A, B, C, d)
    selective_scan_ref.calls += 1
    N = A.shape[1]
    uf = u.float()
    dt, _ = delta_prep(delta, delta_bias, delta_softplus)
    At = f32(A).t()  # (N, d)
    B_at, C_at = _bc_at(B, d), _bc_at(C, d)
    cplx = A.is_complex()
    x = (torch.zeros((batch, N, d), dtype=At.dtype, device=u.device)
         if x0 is None else f32(x0).clone())
    carries, ys = [], []
    for t in range(L):
        if t % CARRY_EVERY == 0:
            carries.append(x)
        x = (torch.exp(dt[:, t, None, :] * At) * x
             + (dt[:, t] * uf[:, t])[:, None, :] * B_at(t))
        y = (x * C_at(t)).sum(1)
        ys.append(2.0 * y.real if cplx else y)
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
    """Plain sequential adjoint of the real scan; the signature and return
    values of ``scan_core_bwd_pallas``, with B and C of any rank
    ``selective_scan_ref`` takes.

    carries: the forward's (batch, ceil(L/128), N, d) chunk-start states;
    gy: cotangent of the output (batch, L, d) -- of the gated output when D
    and z are given (the fused gate), else of the raw scan output; g_last:
    optional (batch, N, d) cotangent of the final state.  Each chunk's
    states are recomputed from its carry, then the adjoint
    ``g_t = gy_t * C_t + exp(dt_{t+1} A) g_{t+1}`` walks it in reverse.

    Without ``delta_softplus`` ``ddelta = <dla, A> + u <g, B>`` (no sigmoid
    factor).  Returns ``(du, ddelta, dA, dB, dC, dbias, dx0)`` and, fused,
    also ``(dz, dD)``: du, ddelta, dz in the dtype of u, delta, z; dB, dC
    in B's and C's shapes and dtypes (a grouped one summed over each
    group's channels); dA (d, N), dbias (d,), dx0 (batch, N, d), dD (d,)
    fp32.  dbias sums ddelta after its rounding to delta's dtype, as the JAX
    kernel does.  Counts its calls in ``selective_scan_bwd_ref.calls``.
    """
    batch, L, d = u.shape
    check_bc(A, B, C, d)
    if A.is_complex():
        raise ValueError("the plain adjoint is real, as K2: a complex scan's "
                         "gradient runs on the chunked backend, or through "
                         "torch autograd on backend='ref'")
    if (D is None) != (z is None):
        raise ValueError("the fused gate needs D and z together")
    selective_scan_bwd_ref.calls += 1
    N = A.shape[1]
    uf = u.float()
    dt, sig = delta_prep(delta, delta_bias, delta_softplus)
    dtu = dt * uf
    At = A.float().t()  # (N, d)
    B_at, C_at = _bc_at(B, d), _bc_at(C, d)
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
    dB = torch.zeros(B.shape, dtype=torch.float32, device=u.device)
    dC = torch.zeros(C.shape, dtype=torch.float32, device=u.device)
    dA = torch.zeros((N, d), dtype=torch.float32, device=u.device)
    c = (torch.zeros((batch, N, d), dtype=torch.float32, device=u.device)
         if g_last is None else g_last.float().clone())
    n_chunks = -(-L // CARRY_EVERY)
    for k in reversed(range(n_chunks)):
        l0, l1 = k * CARRY_EVERY, min(L, (k + 1) * CARRY_EVERY)
        xs, decays = [carries[:, k].float()], []  # xs[j]: state before l0+j
        for t in range(l0, l1):
            decay = torch.exp(dt[:, t, None, :] * At)
            xs.append(decay * xs[-1] + dtu[:, t, None, :] * B_at(t))
            decays.append(decay)
        for j in reversed(range(l1 - l0)):
            t = l0 + j
            Bt, Ct = B_at(t), C_at(t)
            g = gyr[:, t, None, :] * Ct + c  # (batch, N, d)
            dla = g * decays[j] * xs[j]  # d loss / d (dt * A)
            gB = (g * Bt).sum(1)
            dd[:, t] = ((dla * At).sum(1) + gB * uf[:, t]) * sig[:, t]
            du[:, t] = dt[:, t] * gB
            dA += (dla * dt[:, t, None, :]).sum(0)
            _bc_grad_add(dB, t, g * dtu[:, t, None, :])
            _bc_grad_add(dC, t, gyr[:, t, None, :] * xs[j + 1])
            if fused:
                y[:, t] = (Ct * xs[j + 1]).sum(1)
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


# K1 as a registered operator: a selective-checkpoint policy decides per
# dispatched op, so it can name this one (``models/zigma.remat_policy_fn``'s
# ``scan_out``) and keep its outputs instead of launching K1 again in the
# recompute.  Its backward is K2 (``register_autograd`` below).
@torch.library.custom_op("zigma::selective_scan_fwd", mutates_args=())
def selective_scan_fwd_op(u: torch.Tensor, delta: torch.Tensor,
                          A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                          delta_bias: torch.Tensor, D: Optional[torch.Tensor],
                          z: Optional[torch.Tensor], x0: Optional[torch.Tensor],
                          delta_softplus: bool, use_ref: bool
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The scan forward keeping what its backward needs: ``(out, carries,
    x_last)`` as ``selective_scan_fwd_cuda`` returns them.  A, D and the
    bias as ``kernel_params`` gives them (the bias always a tensor), B and C
    (batch, L, N) or (batch, L, G, N) (static too with ``use_ref``), x0 an
    optional (batch, N, d) fp32 seed.  K1 on a CUDA tensor; the plain
    version on the CPU or with ``use_ref``."""
    with torch.no_grad():
        if use_ref or u.device.type != "cuda":
            return selective_scan_ref(u, delta, A, B, C, D, z, delta_bias,
                                      delta_softplus, x0=x0)
        return selective_scan_fwd_cuda(u, delta, A, B, C, delta_bias, D, z,
                                       x0=x0, return_carries=True,
                                       delta_softplus=delta_softplus)


@selective_scan_fwd_op.register_fake
def _(u, delta, A, B, C, delta_bias, D, z, x0, delta_softplus, use_ref):
    batch, L, d = u.shape
    N = A.shape[1]
    f32 = dict(dtype=torch.float32)
    return (u.new_empty((batch, L, d)),
            u.new_empty((batch, -(-L // CARRY_EVERY), N, d), **f32),
            u.new_empty((batch, N, d), **f32))


def _scan_setup(ctx, inputs, output):
    u, delta, A, B, C, delta_bias, D, z, x0, delta_softplus, use_ref = inputs
    ctx.save_for_backward(u, delta, A, B, C, delta_bias, D, z, output[1])
    ctx.delta_softplus, ctx.use_ref = delta_softplus, use_ref
    ctx.has_x0 = x0 is not None
    # an output no loss reads gets None, not a zero tensor
    ctx.set_materialize_grads(False)


def _scan_backward(ctx, gy, g_carries, g_last):
    """K2 (the plain adjoint on the CPU or with ``use_ref``), seeded by the
    final state's cotangent; a missing output cotangent is a zero tensor,
    a missing ``g_last`` no seed."""
    del g_carries  # the chunk starts are for the backward only
    u, delta, A, B, C, delta_bias, D, z, carries = ctx.saved_tensors
    if gy is None:  # only the final state reached the loss
        gy = torch.zeros_like(u)
    if g_last is not None:
        g_last = g_last.to(torch.float32).contiguous()
    if not ctx.use_ref and u.device.type == "cuda":
        g = selective_scan_bwd_cuda(u, delta, delta_bias, A, B, C, carries,
                                    gy, g_last, D, z, ctx.delta_softplus)
    else:
        g = selective_scan_bwd_ref(u, delta, delta_bias, A, B, C, carries, gy,
                                   g_last, D, z, ctx.delta_softplus)
    du, dd, dA, dB, dC, dbias, dx0 = g[:7]
    dz, dD = g[7:] if z is not None else (None, None)
    return (du, dd, dA, dB, dC, dbias, dD, dz, dx0 if ctx.has_x0 else None,
            None, None)


selective_scan_fwd_op.register_autograd(_scan_backward,
                                        setup_context=_scan_setup)


def scan_with_grad(u, delta, A, B, C, delta_bias, D, z, delta_softplus: bool,
                   use_ref: bool, x0=None, return_last_state: bool = False):
    """The scan with both directions through ``selective_scan_fwd_op``: the
    counterpart of the JAX package's custom VJPs ``_core`` (D and z None),
    ``_fused`` (D and z given), ``_core_x0`` (a seed ``x0``) and
    ``_core_full`` (the final state as a second output,
    ``return_last_state``).

    Forward: K1 on CUDA, keeping the chunk-start states, whose first chunk
    is the seed, so the backward's recompute starts from it; backward: K2,
    seeded by the final state's cotangent and giving x0's (``dx0``); the
    plain versions on the CPU or with ``use_ref``.  A, D and the bias go in
    through ``kernel_params``, so a missing bias is zeros that get no
    gradient and the gradients of A, D, the bias and x0 come back in the
    caller's dtypes through the casts.

    Returns out (batch, L, d) in u's dtype, and with ``return_last_state``
    also the final state (batch, N, d) fp32.  Real A, B, C only (the
    kernels' contract; complex scans run on the chunked backend).
    """
    if A.is_complex() or B.is_complex() or C.is_complex():
        raise ValueError("the scan operator is real, as K1 / K2: complex A "
                         "runs on selective_scan's chunked backend")
    A, D, bias = kernel_params(A, D, delta_bias)
    if x0 is not None:
        x0 = x0.to(torch.float32).contiguous()
    out, _, x_last = selective_scan_fwd_op(u, delta, A, B, C, bias, D, z, x0,
                                           delta_softplus, use_ref)
    return (out, x_last) if return_last_state else out


def core_x0(u, delta, A, B, C, delta_bias=None, x0=None,
            delta_softplus: bool = True, backend: str = "auto"):
    """The scan seeded with the state ``x0`` (batch, N, d) fp32: the
    counterpart of ``zigma_tpu/ops/scan_pallas.py::_core_x0``.  Returns y
    (batch, L, d) in u's dtype; under autograd x0 gets its gradient
    (K2's ``dx0``).  One K1 launch forward and one K2 launch backward on
    CUDA (``backend="ref"``: the plain versions)."""
    check_bc(A, B, C, u.shape[2])
    return scan_with_grad(u, delta, A, B, C, delta_bias, None, None,
                          delta_softplus, _use_ref(u, backend), x0)


def core_full(u, delta, A, B, C, delta_bias=None, x0=None,
              delta_softplus: bool = True, backend: str = "auto"):
    """``core_x0`` that also returns the final state: the counterpart of
    ``_core_full``.  Returns ``(y, x_last)``, x_last (batch, N, d) fp32,
    both differentiable: the final state's cotangent seeds K2's reverse
    walk (``g_last``)."""
    check_bc(A, B, C, u.shape[2])
    return scan_with_grad(u, delta, A, B, C, delta_bias, None, None,
                          delta_softplus, _use_ref(u, backend), x0, True)


def _use_ref(u, backend):
    if backend not in ("auto", "ref"):
        raise ValueError(f"unknown backend {backend!r} (auto | ref)")
    return backend == "ref" or u.device.type == "cpu"


def scan_backend(u, A, B, C, backend: str = "auto") -> str:
    """The backend ``selective_scan`` runs for these inputs: ``backend``
    itself unless it is "auto"; else, as the JAX dispatch, ``chunked`` for
    complex A with variable B / C, ``assoc`` for static B / C (complex or
    not), and for a real variable or grouped scan the kernels (``cuda`` on a
    CUDA tensor, their plain versions ``ref`` on a CPU one) where
    ``cuda_shape_supported`` accepts its shape and dtype, else
    ``chunked``."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} "
                         f"({' | '.join(BACKENDS)})")
    if backend != "auto":
        return backend
    variable = B.dim() >= 3 and C.dim() >= 3
    if not variable:
        return "assoc"
    if A.is_complex():
        return "chunked"
    G = max(M.shape[2] if M.dim() == 4 else 1 for M in (B, C))
    _, L, d = u.shape
    if cuda_shape_supported(L, d // G, A.shape[1], u.dtype):
        return "cuda" if u.device.type == "cuda" else "ref"
    return "chunked"


def _squeeze_groups(B, C):
    """(batch, L, 1, N) B / C as (batch, L, N), as the JAX dispatch does,
    unless the other one is grouped."""
    if all(M.dim() != 4 or M.shape[2] == 1 for M in (B, C)):
        B, C = (M[:, :, 0] if M.dim() == 4 else M for M in (B, C))
    return B, C


def selective_scan(u, delta, A, B, C,
                   D: Optional[torch.Tensor] = None,
                   z: Optional[torch.Tensor] = None,
                   delta_bias: Optional[torch.Tensor] = None,
                   delta_softplus: bool = False,
                   return_last_state: bool = False,
                   backend: str = "auto",
                   chunk: int = 128):
    """Selective scan with backend dispatch (the JAX function's signature,
    ``cuda`` in place of ``pallas``).

    backend: "auto" | "cuda" | "chunked" | "assoc" | "ref", resolved by
    ``scan_backend``; ``chunk`` is the chunked backend's steps a chunk.  On
    a CUDA tensor "auto" has no fallback: what it sends to the kernels
    launches or raises.  On ``cuda`` / ``ref``: with D and z both given the
    gate is fused into the kernels; with only one of them the skip term or
    the gate is composed around the core scan in torch ops, as
    ``selective_scan_pallas`` does in jnp, with a gradient or without; when
    a gradient is needed the scan goes through ``scan_with_grad`` (the
    registered op, K1 / K2 back).  Returns out (batch, L, d) in u's dtype,
    and with ``return_last_state`` also the final state (batch, d, N) fp32
    (complex64 with complex A; the JAX function's layout).
    """
    check_bc(A, B, C, u.shape[2])
    B, C = _squeeze_groups(B, C)
    backend = scan_backend(u, A, B, C, backend)
    if backend == "chunked":
        return selective_scan_chunked(u, delta, A, B, C, D, z, delta_bias,
                                      delta_softplus, return_last_state, chunk)
    if backend == "assoc":
        return selective_scan_assoc(u, delta, A, B, C, D, z, delta_bias,
                                    delta_softplus, return_last_state)
    if backend == "cuda" and A.is_complex():
        raise ValueError("backend='cuda' is real-only; complex A runs on "
                         "'chunked', 'assoc' or 'ref' (auto picks chunked)")
    use_ref = backend == "ref"
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad
        for t in (u, delta, A, B, C, D, z, delta_bias))
    if needs_grad and not A.is_complex():
        # the final state from a zero seed, as selective_scan_pallas runs
        # _core_full; the gate is fused where D and z come together
        fused = D is not None and z is not None
        res = scan_with_grad(
            u, delta, A, B, C, delta_bias, D if fused else None,
            z if fused else None, delta_softplus, use_ref, None,
            return_last_state)
        y, x_last = res if return_last_state else (res, None)
        if not fused:
            y = skip_and_gate(y, u, D, z)
        return (y, x_last.transpose(1, 2)) if return_last_state else y
    if use_ref:
        out, _, x_last = selective_scan_ref(u, delta, A, B, C, D, z,
                                            delta_bias, delta_softplus)
    else:
        # the kernel fuses the skip term and the gate only together
        fused = (D is None) == (z is None)
        A32, D32, bias = kernel_params(A, D if fused else None, delta_bias)
        out, _, x_last = selective_scan_fwd_cuda(
            u, delta, A32, B, C, bias, D32, z if fused else None,
            return_carries=False, delta_softplus=delta_softplus)
        if not fused:
            out = skip_and_gate(out, u, D, z)
    return (out, x_last.transpose(1, 2)) if return_last_state else out


def selective_state_update(state, x, dt, A, B, C,
                           D: Optional[torch.Tensor] = None,
                           z: Optional[torch.Tensor] = None,
                           dt_bias: Optional[torch.Tensor] = None,
                           dt_softplus: bool = False):
    """One decode step, the counterpart of ``zigma_tpu/ops/selective_scan.py
    ::selective_state_update``.  state: (batch, d, N); x, dt, z: (batch, d);
    A: (d, N); B, C: (batch, N); D, dt_bias: (d,).  In fp32 (complex64 where
    A, B, C or the state is complex): ``dA = exp(dt A)``, ``state' = state dA
    + dt x B``, ``y = <state', C>`` (``2 Re<state', C>`` when complex, as
    every scan backend, so a prefill and the steps after it agree)
    ``(+ D x) (* silu(z))``.  Returns ``(y in x's dtype, state')``."""
    dtf = dt.float()
    if dt_bias is not None:
        dtf = dtf + dt_bias.float()
    if dt_softplus:
        dtf = F.softplus(dtf)
    dA = torch.exp(dtf[..., None] * f32(A))                    # (batch, d, N)
    dBx = (dtf * x.float())[..., None] * f32(B)[:, None, :]
    state = f32(state) * dA + dBx
    y = torch.einsum("bdn,bn->bd", state, f32(C).to(state.dtype))
    if y.is_complex():
        y = 2.0 * y.real
    if D is not None:
        y = y + D.float() * x.float()
    if z is not None:
        y = y * F.silu(z.float())
    return y.to(x.dtype), state


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


def selective_scan_flops(batch: int, L: int, d_inner: int, N: int,
                         with_D: bool = True, with_z: bool = False) -> int:
    """Analytic FLOP count per scan, matching the reference's fvcore rule
    (model_zigma.py:1140-1170): 9*B*L*D*N plus skip/gate terms."""
    flops = 9 * batch * L * d_inner * N
    if with_D:
        flops += batch * d_inner * L
    if with_z:
        flops += batch * d_inner * L
    return flops
