"""Faults planted under the program's timed path, to show that the check
catches them: each a context manager that patches one entry point of the
program while it is active.  A job class lists those its kind of work can
have (``faults``, ``jobs/``):

- ``unchanged_state``: a training step that returns the parameters as it
  found them;
- ``ema_unchanged``: a training step that leaves the EMA as it found it;
- ``half_batch``: the loss over the first half of each batch alone, its
  mean taken over that half;
- ``altered_answer``: one value of every sample the ODE sampler returns
  changed by 1.
"""

from __future__ import annotations

from unittest import mock

import torch

__all__ = ["unchanged_state", "ema_unchanged", "half_batch",
           "altered_answer"]


def unchanged_state():
    from zigma_tpu_torch.train import state as S
    real = S.train_step

    def step(state, *args, **kwargs):
        kept = [p.detach().clone() for p in state.model.parameters()]
        out = real(state, *args, **kwargs)
        with torch.no_grad():
            for p, k in zip(state.model.parameters(), kept):
                p.copy_(k)
        return out

    return mock.patch.object(S, "train_step", step)


def ema_unchanged():
    from zigma_tpu_torch.train import state as S
    return mock.patch.object(S, "update_ema", lambda *a, **k: None)


def half_batch():
    import zigma_tpu_torch.train as T
    real = T.make_diffusion_loss_fn

    def make(model, transport, latent_scale=None):
        loss_fn = real(model, transport, latent_scale)

        def half(batch, generator=None, t=None, x0=None):
            n = batch["x"].shape[0] // 2
            return loss_fn({k: v[:n] for k, v in batch.items()}, generator,
                           t=None if t is None else t[:n],
                           x0=None if x0 is None else x0[:n])

        return half

    return mock.patch.object(T, "make_diffusion_loss_fn", make)


def altered_answer():
    from zigma_tpu_torch.transport import transport as TR
    real = TR.odeint_fixed

    def odeint(*args, **kwargs):
        traj = real(*args, **kwargs)
        traj[-1].view(traj.shape[1], -1)[:, 0] += 1.0
        return traj

    return mock.patch.object(TR, "odeint_fixed", odeint)
