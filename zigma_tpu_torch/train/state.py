"""Train state, optimizer, EMA and the training step.

Counterpart of ``zigma_tpu/train/state.py``:

- AdamW(lr 1e-4, betas (0.9, 0.999), eps 1e-8, weight decay 0 from
  ``configs/optim/default.yaml``), passed explicitly: ``torch.optim.AdamW``
  defaults to weight_decay=0.01.
- The global-norm clip at 2.0 runs *before* ``opt.step()``.  The reference
  clips after the step, where it changes nothing (SURVEY.md section 7.4);
  the JAX package fixed that and the port keeps the fix.
- EMA 0.9999 of the float32 master weights into a frozen copy of the model.
- One eager step: loss, backward, clip, AdamW, EMA.  ``grad_norm`` is the
  norm before clipping, as ``optax.global_norm(grads)`` in the JAX step.

The model keeps float32 parameters and casts them per GEMM to its compute
dtype (``dense``), so there is no separate master copy to keep in sync.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch import nn

__all__ = ["LATENT_SCALE", "TrainState", "create_optimizer", "update_ema",
           "make_diffusion_loss_fn", "train_step"]

LATENT_SCALE = 0.18215  # SD VAE latent scaling (own copy of the JAX constant)


def create_optimizer(params, lr: float = 1e-4, weight_decay: float = 0.0,
                     b1: float = 0.9, b2: float = 0.999) -> torch.optim.AdamW:
    """AdamW with optax's defaults (eps 1e-8) and an explicit weight decay."""
    return torch.optim.AdamW(params, lr=lr, betas=(b1, b2), eps=1e-8,
                             weight_decay=weight_decay)


@torch.no_grad()
def update_ema(ema: nn.Module, model: nn.Module, decay: float = 0.9999):
    """``e = e * decay + (1 - decay) * p`` for every parameter, in place."""
    e = [p for p in ema.parameters()]
    m = [p.detach() for p in model.parameters()]
    torch._foreach_mul_(e, decay)
    torch._foreach_add_(e, m, alpha=1.0 - decay)


@dataclass
class TrainState:
    """The reference checkpoint's content {model, ema, opt, train_steps,
    best_fid} as live objects."""

    model: nn.Module
    ema: nn.Module
    opt: torch.optim.Optimizer
    step: int = 0
    best_fid: float = math.inf

    @classmethod
    def create(cls, model: nn.Module, lr: float = 1e-4,
               weight_decay: float = 0.0) -> "TrainState":
        ema = copy.deepcopy(model).requires_grad_(False)
        return cls(model=model, ema=ema,
                   opt=create_optimizer(model.parameters(), lr, weight_decay))


def make_diffusion_loss_fn(model: nn.Module, transport,
                           latent_scale: Optional[float] = None) -> Callable:
    """``loss_fn(batch, generator=None, t=None, x0=None)``: scale the
    latents, then the mean flow-matching loss of ``model`` in training mode
    (drop-path on).  ``t`` and ``x0`` inject the transport's draw (the tests
    feed JAX's)."""

    def loss_fn(batch, generator=None, t=None, x0=None):
        x = batch["x"]
        if latent_scale is not None:
            x = x * latent_scale
        y = batch.get("y")
        model_fn = lambda xt, tt: model(xt, tt, y, train=True,
                                        generator=generator)
        terms = transport.training_losses(model_fn, x, generator, t=t, x0=x0)
        return terms["loss"].mean()

    return loss_fn


def train_step(state: TrainState, loss_fn: Callable, batch,
               generator: Optional[torch.Generator] = None,
               max_grad_norm: float = 2.0, ema_decay: float = 0.9999,
               **loss_kw) -> dict:
    """One step in place: loss, backward, clip (before the update), AdamW,
    EMA.  Returns ``{"loss", "grad_norm"}`` as 0-dim tensors on the model's
    device (reading them synchronises; the caller decides when)."""
    state.opt.zero_grad(set_to_none=True)
    loss = loss_fn(batch, generator, **loss_kw)
    loss.backward()
    params = [p for p in state.model.parameters() if p.grad is not None]
    if max_grad_norm and max_grad_norm > 0:
        grad_norm = torch.nn.utils.clip_grad_norm_(params, max_grad_norm)
    else:
        grad_norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(p.grad) for p in params]))
    state.opt.step()
    update_ema(state.ema, state.model, ema_decay)
    state.step += 1
    return {"loss": loss.detach(), "grad_norm": grad_norm.detach()}
