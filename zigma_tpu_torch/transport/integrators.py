"""ODE and SDE integrators: fixed-step Euler / Heun, adaptive dopri5, and
Euler-Maruyama / Heun for the SDE.

Counterpart of ``zigma_tpu/transport/integrators.py``, as Python loops
(PyTorch runs eagerly).  Each returns the trajectory stacked on a leading
axis, as the JAX functions do.

Precision trap: JAX keeps the ODE state in float32, because a float32 step
``dt`` times a bf16 drift promotes to float32.  In torch a 0-dim float32
tensor times a bf16 tensor stays bf16, so every drift is cast to float32
before it enters an update; otherwise every step would re-quantise x.

dopri5 keeps its step-size bookkeeping (t, dt, the error norm and the PI
factor) in float32 on the host, as the JAX solver keeps it in float32
scalars, so both take the same steps.  The accept decision is read on the
host once per attempted step: one synchronisation per 7 drift calls.
"""

from __future__ import annotations

import itertools
import math
from typing import Callable, Optional

import numpy as np
import torch

from zigma_tpu_torch.utils.profiling import span

__all__ = ["odeint_fixed", "odeint_dopri5", "sdeint"]

f32 = np.float32


def _t_batch(t, x: torch.Tensor) -> torch.Tensor:
    """(B,) float32 time vector of x's batch from a scalar t."""
    return torch.full((x.shape[0],), float(t), dtype=torch.float32,
                      device=x.device)


def odeint_fixed(drift: Callable, x0: torch.Tensor, t0: float, t1: float,
                 num_steps: int, method: str = "euler") -> torch.Tensor:
    """Integrate dx/dt = drift(x, t_batch) over linspace(t0, t1, num_steps).

    Returns all ``num_steps`` save points including x(t0), stacked on a
    leading axis (the torchdiffeq / JAX convention).
    """
    method = method.lower()
    if method not in ("euler", "heun"):
        raise ValueError(f"unknown fixed-step method {method!r}")
    ts = torch.linspace(t0, t1, num_steps, dtype=torch.float32)
    x = x0
    traj = [x0]
    for i in range(num_steps - 1):
        with span("sampler.step", i=i):
            t, dt = ts[i], ts[i + 1] - ts[i]
            k1 = drift(x, _t_batch(t, x))
            if method == "euler":
                x = x + float(dt) * k1.float()
            else:
                xp = x + float(dt) * k1.float()
                k2 = drift(xp, _t_batch(t + dt, x))
                # (k1 + k2) in the drift's dtype, as JAX adds the two bf16
                # drifts before the float32 scale
                x = x + 0.5 * float(dt) * (k1 + k2).float()
        traj.append(x)
    return torch.stack(traj)


# Dormand-Prince RK45 tableau, float32 as the JAX solver holds it
_DOPRI_C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0], f32)
_DOPRI_A = [
    [],
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
    [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
]
_DOPRI_B5 = np.array([35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784,
                      11 / 84, 0.0], f32)
_DOPRI_B4 = np.array([5179 / 57600, 0.0, 7571 / 16695, 393 / 640,
                      -92097 / 339200, 187 / 2100, 1 / 40], f32)


def _axpy(a, xs, ys):
    """a * x + y leaf by leaf; ``a`` a float32 scalar."""
    return tuple(float(a) * x + y for x, y in zip(xs, ys))


def _dopri_step(drift, x, t, dt):
    """One RK45 step of the tuple state x: (5th-order x, error estimate)."""
    ks = []
    for i in range(7):
        xi = x
        for j, aij in enumerate(_DOPRI_A[i]):
            xi = _axpy(dt * f32(aij), ks[j], xi)
        k = drift(xi, t + dt * _DOPRI_C[i])
        ks.append(tuple(kk.float() for kk in k))
    x5, err = x, tuple(torch.zeros_like(v) for v in x)
    for i in range(7):
        x5 = _axpy(dt * _DOPRI_B5[i], ks[i], x5)
        err = _axpy(dt * (_DOPRI_B5[i] - _DOPRI_B4[i]), ks[i], err)
    return x5, err


def _error_norm(err, x0, x1, atol, rtol) -> torch.Tensor:
    """RMS of err / (atol + rtol max(|x0|, |x1|)) per leaf, then the root of
    the leaves' mean square (a 0-dim float32 tensor)."""
    sq = [torch.mean((e / (atol + rtol * torch.maximum(a.abs(), b.abs()))) ** 2)
          for e, a, b in zip(err, x0, x1)]
    return torch.sqrt(sum(sq) / len(sq))


def odeint_dopri5(drift: Callable, x0, t0: float, t1: float, num_steps: int,
                  atol: float = 1e-6, rtol: float = 1e-3,
                  max_steps_per_segment: int = 1000,
                  stats: Optional[dict] = None):
    """Adaptive Dormand-Prince RK45 saving at linspace(t0, t1, num_steps).

    ``x0`` is a tensor or a tuple of tensors (likelihood's ``(x, logp)``);
    ``drift(x, t_batch)`` returns the same structure.  Each segment between
    two save points is stepped with a PI controller (factor 0.9 err^-1/5
    clipped to [0.2, 10]), the last step clamped to land on the save point
    exactly.  A segment that does not reach its save point (a NaN drift, or
    ``max_steps_per_segment`` attempts) poisons the state with NaN from
    there on, and the drift is not called again.  Seven drift calls an
    attempted step, with no first-same-as-last reuse, as in the JAX solver.

    Returns the stacked trajectory (tensor or tuple, like ``x0``).  ``stats``
    (a dict) receives ``accepted``, ``rejected`` and ``drift_calls``.
    """
    single = isinstance(x0, torch.Tensor)
    x = (x0,) if single else tuple(x0)
    ts = np.linspace(f32(t0), f32(t1), num_steps, dtype=f32)
    direction = f32(np.sign(ts[-1] - ts[0]))

    stages = itertools.count()

    def f(state, t):
        with span("sampler.step", i=next(stages)):
            out = drift(state[0] if single else state, _t_batch(t, state[0]))
        return (out,) if single else tuple(out)

    accepted = rejected = 0
    t, dt = ts[0], (ts[-1] - ts[0]) / f32(4.0 * num_steps)
    traj = [x]
    poisoned = False
    for t_next in ts[1:]:
        i = 0
        while (not poisoned and direction * (t_next - t) > 1e-9
               and i < max_steps_per_segment and math.isfinite(dt)):
            if direction * (t + dt - t_next) > 0:
                dt = t_next - t
            x_new, err = _dopri_step(f, x, t, dt)
            enorm = f32(_error_norm(err, x, x_new, atol, rtol).item())
            if enorm <= 1.0:
                x, t = x_new, f32(t + dt)
                accepted += 1
            else:
                rejected += 1
            factor = np.clip(f32(0.9) * (enorm + f32(1e-10)) ** f32(-1 / 5),
                             f32(0.2), f32(10.0))
            dt = f32(dt * factor)
            i += 1
        if poisoned or direction * (t_next - t) > 1e-9:
            poisoned = True
            x = tuple(torch.full_like(v, float("nan")) for v in x)
        t = t_next
        traj.append(x)
    if stats is not None:
        stats.update(accepted=accepted, rejected=rejected,
                     drift_calls=7 * (accepted + rejected))
    out = tuple(torch.stack(leaf) for leaf in zip(*traj))
    return out[0] if single else out


def sdeint(drift: Callable, diffusion: Callable, x0: torch.Tensor, t0: float,
           t1: float, num_steps: int, method: str = "Euler",
           generator: Optional[torch.Generator] = None,
           noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Integrate the reverse SDE over linspace(t0, t1, num_steps):
    ``num_steps - 1`` Euler-Maruyama or Heun steps.  Returns the
    ``num_steps - 1`` states after each step, stacked (the initial point is
    dropped, as in the reference loop).

    The Brownian increments are ``w * sqrt(dt)`` with w standard normal:
    ``noise`` injects all of them, a ``(num_steps - 1, *x0.shape)`` tensor,
    else each step draws its w from ``generator``.  With neither it raises:
    every call would otherwise reuse one stream silently.
    """
    if method not in ("Euler", "Heun"):
        raise NotImplementedError(f"unknown SDE sampling_method {method!r} "
                                  f"(Euler | Heun)")
    if noise is None and generator is None:
        raise ValueError(
            "sdeint: give a generator or inject the Brownian increments via "
            "noise=...; without either, every call would reuse the same "
            "draws")
    if noise is not None and tuple(noise.shape) != (num_steps - 1,
                                                    *x0.shape):
        raise ValueError(f"noise shape {tuple(noise.shape)} != "
                         f"{(num_steps - 1, *x0.shape)}")
    ts = torch.linspace(t0, t1, num_steps, dtype=torch.float32)
    dt = float(ts[1] - ts[0])
    sqrt_dt = float(torch.sqrt(ts[1] - ts[0]))
    x, traj = x0, []
    for i in range(num_steps - 1):
        with span("sampler.step", i=i):
            w = (noise[i] if noise is not None else torch.randn(
                x.shape, generator=generator, dtype=x.dtype, device=x.device))
            tb = _t_batch(ts[i], x)
            if method == "Euler":
                d = drift(x, tb).float()
                g = diffusion(x, tb)
                x = (x + dt * d) + torch.sqrt(2 * g) * w * sqrt_dt
            else:
                g = diffusion(x, tb)
                xhat = x + torch.sqrt(2 * g) * w * sqrt_dt
                k1 = drift(xhat, tb).float()
                xp = xhat + dt * k1
                k2 = drift(xp, _t_batch(ts[i] + (ts[1] - ts[0]), x)).float()
                x = xhat + 0.5 * dt * (k1 + k2)
        traj.append(x)
    return torch.stack(traj)
