"""Mamba selective scan: the plain sequential version and the dispatch.

Counterpart of ``zigma_tpu/ops/selective_scan.py``.  The recurrence, per
batch row and channel d, with an fp32 state of N values:

    x_t = exp(dt_t * A) * x_{t-1} + dt_t * u_t * B_t
    y_t = <C_t, x_t> (+ D * u_t) (* silu(z_t))

``selective_scan`` sends CUDA tensors to the hand-written kernel
(``scan_cuda.selective_scan_fwd_cuda``) and CPU tensors to
``selective_scan_ref``; ``backend="ref"`` forces the plain version on any
device (the tests and ``chip_smoke.py`` compare the two that way).  This
slice covers real A with variable (batch, L, N) B/C -- the ZigMa path;
complex A and grouped or static B/C are a later slice and raise.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from zigma_tpu_torch.ops.scan_cuda import CARRY_EVERY, selective_scan_fwd_cuda

__all__ = ["selective_scan", "selective_scan_ref"]


def _check_supported(A, B, C):
    if A.is_complex() or B.is_complex() or C.is_complex():
        raise NotImplementedError("complex A/B/C (the S4D-complex mode) lands "
                                  "in a later slice of the port")
    if B.dim() != 3 or C.dim() != 3:
        raise NotImplementedError(
            f"variable B/C of shape (batch, L, N) only; grouped or static B/C "
            f"(got {tuple(B.shape)}, {tuple(C.shape)}) land in a later slice")


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
    dt = delta.float()
    if delta_bias is not None:
        dt = dt + delta_bias.float()
    if delta_softplus:
        dt = F.softplus(dt)  # threshold 20, as the kernel
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


def selective_scan(u, delta, A, B, C,
                   D: Optional[torch.Tensor] = None,
                   z: Optional[torch.Tensor] = None,
                   delta_bias: Optional[torch.Tensor] = None,
                   delta_softplus: bool = False,
                   return_last_state: bool = False,
                   backend: str = "auto"):
    """Selective scan with backend dispatch (the JAX function's signature).

    backend: "auto" (CUDA tensor -> the kernel, CPU tensor -> the plain
    version) or "ref" (the plain version anywhere).  On a CUDA tensor
    "auto" has no fallback: the kernel launches or raises (it needs
    delta_bias with delta_softplus, and D and z together or neither).
    Returns out (batch, L, d) in u's dtype, and with ``return_last_state``
    also the final state (batch, d, N) fp32 (the JAX function's layout).
    """
    if backend not in ("auto", "ref"):
        raise ValueError(f"unknown backend {backend!r} (auto | ref)")
    _check_supported(A, B, C)
    if backend == "ref" or u.device.type == "cpu":
        out, _, x_last = selective_scan_ref(u, delta, A, B, C, D, z,
                                            delta_bias, delta_softplus)
    else:
        if not delta_softplus:
            raise NotImplementedError(
                "the CUDA kernel always takes dt = softplus(delta + "
                "delta_bias); a scan without softplus lands in a later slice "
                "of the port")
        out, _, x_last = selective_scan_fwd_cuda(
            u, delta, A, B, C, delta_bias, D, z, return_carries=False)
    return (out, x_last.transpose(1, 2)) if return_last_state else out
