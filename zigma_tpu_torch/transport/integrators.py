"""Fixed-step ODE integrators (Euler, Heun).

Counterpart of ``zigma_tpu/transport/integrators.py::odeint_fixed``, as a
Python loop (PyTorch runs eagerly).  The adaptive dopri5 solver and the SDE
integrators are a later slice of the port.

Precision trap: JAX keeps the ODE state in float32, because a float32 step
``dt`` times a bf16 drift promotes to float32.  In torch a 0-dim float32
tensor times a bf16 tensor stays bf16, so the drift is cast to float32
before each update; otherwise every step would re-quantise x.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["odeint_fixed"]


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
        t, dt = ts[i], ts[i + 1] - ts[i]
        tb = torch.full((x.shape[0],), float(t), dtype=torch.float32,
                        device=x.device)
        k1 = drift(x, tb)
        if method == "euler":
            x = x + float(dt) * k1.float()
        else:
            xp = x + float(dt) * k1.float()
            tb2 = torch.full((x.shape[0],), float(t + dt), dtype=torch.float32,
                             device=x.device)
            k2 = drift(xp, tb2)
            # (k1 + k2) in the drift's dtype, as JAX adds the two bf16
            # drifts before the float32 scale
            x = x + 0.5 * float(dt) * (k1 + k2).float()
        traj.append(x)
    return torch.stack(traj)
