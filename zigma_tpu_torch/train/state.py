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
  norm before clipping, as ``optax.global_norm(grads)`` in the JAX step,
  and the global one across processes (DDP, FSDP2, tensor parallelism:
  ``parallel/mesh.py``).
- N steps a call (the JAX package's ``create_chained_train_step``, one
  jitted ``lax.scan``): ``train_chain`` runs them eagerly, ``CapturedChain``
  as one CUDA graph replayed behind one host launch.
- Spans (``utils.profiling.span``): ``train_step`` around its five parts
  ``train_step.{forward,backward,clip,optimizer,ema}``, and
  ``train_chain.replay`` around a graph's replay (the steps' own spans are
  recorded once, while it is captured).

The model keeps float32 parameters and casts them per GEMM to its compute
dtype (``dense``), so there is no separate master copy to keep in sync.
"""

from __future__ import annotations

import copy
import math
import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch import nn

from zigma_tpu_torch.utils.profiling import span

__all__ = ["LATENT_SCALE", "TrainState", "create_optimizer", "update_ema",
           "make_diffusion_loss_fn", "train_step", "train_chain",
           "CapturedChain"]

LATENT_SCALE = 0.18215  # SD VAE latent scaling (own copy of the JAX constant)


def create_optimizer(params, lr: float = 1e-4, weight_decay: float = 0.0,
                     b1: float = 0.9, b2: float = 0.999,
                     capturable: bool = False) -> torch.optim.AdamW:
    """AdamW with optax's defaults (eps 1e-8) and an explicit weight decay.
    ``capturable`` keeps the step counts on the card and computes the bias
    corrections there, so that a CUDA graph can hold ``step()``
    (``CapturedChain``); the default keeps them on the host."""
    return torch.optim.AdamW(params, lr=lr, betas=(b1, b2), eps=1e-8,
                             weight_decay=weight_decay, capturable=capturable)


@torch.no_grad()
def update_ema(ema: nn.Module, model: nn.Module, decay: float = 0.9999):
    """``e = e * decay + (1 - decay) * p`` for every parameter, in place,
    on whatever the parameters are (local tensors, or FSDP2's shards, the
    EMA's placed as the model's)."""
    pairs = list(zip(ema.parameters(), model.parameters()))
    for sharded in (False, True):  # foreach takes one tensor kind a call
        e = [a for a, b in pairs if _is_dtensor(b) == sharded]
        m = [b.detach() for a, b in pairs if _is_dtensor(b) == sharded]
        if e:
            torch._foreach_mul_(e, decay)
            torch._foreach_add_(e, m, alpha=1.0 - decay)


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


@dataclass
class TrainState:
    """The reference checkpoint's content {model, ema, opt, train_steps,
    best_fid} as live objects, and, across processes, their placement
    (``parallel.mesh.ParallelLayout``; None in one process)."""

    model: nn.Module
    ema: nn.Module
    opt: torch.optim.Optimizer
    step: int = 0
    best_fid: float = math.inf
    layout: Optional[object] = None

    @classmethod
    def create(cls, model: nn.Module, lr: float = 1e-4,
               weight_decay: float = 0.0, ema: Optional[nn.Module] = None,
               layout=None, capturable: bool = False) -> "TrainState":
        """``ema``: the EMA copy, already placed like ``model`` when a
        ``layout`` is given (default: a frozen deep copy of ``model``);
        ``capturable``: ``create_optimizer``'s."""
        if ema is None:
            ema = copy.deepcopy(model)
        params = (model.parameters() if layout is None
                  else layout.param_groups(model))
        return cls(model=model, ema=ema.requires_grad_(False),
                   opt=create_optimizer(params, lr, weight_decay,
                                        capturable=capturable),
                   layout=layout)

    @property
    def train_module(self) -> nn.Module:
        """What the loss calls: the layout's (the DDP wrapper) or the
        model."""
        return self.model if self.layout is None else self.layout.module


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
               keep_grads: bool = False, **loss_kw) -> dict:
    """One step in place: loss, backward, clip (before the update), AdamW,
    EMA.  Returns ``{"loss", "grad_norm"}`` as 0-dim tensors on the model's
    device (reading them synchronises; the caller decides when).
    ``keep_grads`` zeroes the ``.grad`` tensors in place instead of freeing
    them (a CUDA graph holds their addresses).

    Across processes ``loss_fn`` calls ``state.train_module`` (DDP averages
    the gradients over ``data`` in the backward, FSDP2 reduce-scatters
    them); the parameters FSDP2 leaves whole are averaged here, and the
    norm is the global one (``ParallelLayout.clip_grad_norm_``)."""
    with span("train_step", step=state.step):
        # under DDP the gradients stay views of its buckets (zeroed in
        # place), so the backward writes into them without a copy a parameter
        ddp = state.layout is not None and not state.layout.fsdp
        state.opt.zero_grad(set_to_none=not (ddp or keep_grads))
        with span("train_step.forward"):
            loss = loss_fn(batch, generator, **loss_kw)
        with span("train_step.backward"):
            loss.backward()
        with span("train_step.clip"):
            if state.layout is not None:
                state.layout.sync_replicated_grads()
                grad_norm = state.layout.clip_grad_norm_(
                    list(state.model.named_parameters()), max_grad_norm)
            else:
                params = [p for p in state.model.parameters()
                          if p.grad is not None]
                if max_grad_norm and max_grad_norm > 0:
                    grad_norm = torch.nn.utils.clip_grad_norm_(
                        params, max_grad_norm)
                else:
                    grad_norm = torch.linalg.vector_norm(torch.stack(
                        [torch.linalg.vector_norm(p.grad) for p in params]))
        with span("train_step.optimizer"):
            state.opt.step()
        with span("train_step.ema"):
            update_ema(state.ema, state.model, ema_decay)
        state.step += 1
    return {"loss": loss.detach(), "grad_norm": grad_norm.detach()}


def train_chain(state: TrainState, loss_fn: Callable, batches,
                generator: Optional[torch.Generator] = None,
                max_grad_norm: float = 2.0, ema_decay: float = 0.9999,
                loss_kws=None) -> dict:
    """``len(batches)`` training steps in order, each a ``train_step`` on its
    batch with, where ``loss_kws`` gives them, its own injected draws (one
    dict a step, e.g. ``t`` and ``x0``).  Returns the last step's ``{"loss",
    "grad_norm"}``, JAX's ``metrics[-1]``.  The plain version of
    ``CapturedChain``: the chain on the CPU and under a parallel layout,
    the first chain of a captured run and a run's shorter tail."""
    if not batches:
        raise ValueError("train_chain needs at least one batch")
    if loss_kws is None:
        loss_kws = [{}] * len(batches)
    if len(loss_kws) != len(batches):
        raise ValueError(f"{len(loss_kws)} loss_kws for {len(batches)} "
                         f"batches")
    for batch, kw in zip(batches, loss_kws):
        metrics = train_step(state, loss_fn, batch, generator, max_grad_norm,
                             ema_decay, **kw)
    return metrics


class CapturedChain:
    """``n_steps`` whole training steps (loss, backward, clip, AdamW, EMA)
    as one CUDA graph: the counterpart of the JAX package's
    ``create_chained_train_step``, whose N steps are one jitted
    ``lax.scan``.  A call copies ``n_steps`` host batches into the graph's
    static batch slots on the card (one pinned copy a key) and replays the
    graph: one host launch for N steps.

    The first call is the warm-up that torch's whole-network capture asks
    for, made of real steps of the run: ``train_chain`` runs the N steps
    eagerly on the slots, on the capture's side stream (the kernels build,
    AdamW creates its moments, every ``.grad`` is allocated); the graph is
    captured on that stream right after, without running.  The draws (t,
    x0, label drops, drop-path masks) come from ``generator``, registered
    with the graph: a replay starts from the generator's state and advances
    it by the N steps' draws, so the chain draws what N plain steps would
    and leaves the generator where they leave it.  Inside the graph
    ``.grad`` is zeroed in place, not freed.

    Needs one process on one card (``state.layout`` None), the model and
    ``generator`` on it, and an AdamW built with ``capturable=True``;
    anything else raises ``ValueError`` naming it.  A failed capture raises
    ``RuntimeError`` with its reason; nothing steps eagerly in the graph's
    place.  The graph holds the addresses of the parameters, their
    ``.grad``, the optimizer's moments and step counts and the EMA: a
    replay checks that they are still the tensors it captured (loading an
    optimizer state dict replaces the moments) and raises otherwise.

    ``capture_seconds`` is the capture's host time (None before it).  The
    metrics a replay returns are the graph's own tensors, overwritten by
    the next replay: read or clone them first.
    """

    def __init__(self, state: TrainState, loss_fn: Callable, n_steps: int,
                 generator: torch.Generator, max_grad_norm: float = 2.0,
                 ema_decay: float = 0.9999):
        if n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        if state.layout is not None:
            raise ValueError("CapturedChain runs one process on one card; "
                             "under a parallel layout the chain runs "
                             "eagerly (train_chain)")
        device = next(state.model.parameters()).device
        if device.type != "cuda":
            raise ValueError(f"CapturedChain needs the model on a CUDA card, "
                             f"not on {device} (train_chain runs anywhere)")
        if generator is None or generator.device.type != "cuda":
            raise ValueError("CapturedChain needs a CUDA torch.Generator for "
                             "the steps' draws (the graph registers it)")
        if not all(g.get("capturable") for g in state.opt.param_groups):
            raise ValueError("CapturedChain needs an AdamW built with "
                             "capturable=True (create_optimizer(..., "
                             "capturable=True)): the default one keeps its "
                             "step counts on the host")
        self.state, self.loss_fn, self.n_steps = state, loss_fn, n_steps
        self.generator, self.device = generator, device
        self.max_grad_norm, self.ema_decay = max_grad_norm, ema_decay
        self.stream = torch.cuda.Stream(device)
        self.graph = self.capture_seconds = None
        self.slots, self._out, self._held = None, None, None

    def __call__(self, batches) -> dict:
        """Run ``n_steps`` steps on ``batches`` (dicts of numpy arrays or CPU
        tensors, one a step); returns the last step's ``{"loss",
        "grad_norm"}``."""
        if len(batches) != self.n_steps:
            raise ValueError(f"a chain takes {self.n_steps} batches, got "
                             f"{len(batches)}")
        self._load(batches)
        if self.graph is None:
            return self._warm_up_and_capture()
        now = self._tensors()
        if len(now) != len(self._held) or any(
                a is not b for a, b in zip(now, self._held)):
            raise RuntimeError(
                "the parameters' .grad or the optimizer's state were replaced "
                "since the capture (a state dict loaded into the optimizer?): "
                "the graph would write into freed memory; build a new "
                "CapturedChain")
        with span("train_chain.replay", n_steps=self.n_steps):
            self.graph.replay()
        self.state.step += self.n_steps
        return dict(self._out)

    def _load(self, batches):
        stacked = {}
        for k in batches[0]:
            v = torch.stack([torch.as_tensor(b[k]) for b in batches])
            stacked[k] = v.float() if v.is_floating_point() else v
        if self.slots is None:
            self.slots = {k: torch.empty(v.shape, dtype=v.dtype,
                                         device=self.device)
                          for k, v in stacked.items()}
        got = {k: (tuple(v.shape), v.dtype) for k, v in stacked.items()}
        want = {k: (tuple(v.shape), v.dtype) for k, v in self.slots.items()}
        if got != want:
            raise ValueError(f"a chain's batches keep the keys, shapes and "
                             f"dtypes of the first (the graph's static "
                             f"slots): got {got}, captured {want}")
        for k, v in stacked.items():
            self.slots[k].copy_(v.pin_memory(), non_blocking=True)

    def _batches(self):
        return [{k: v[i] for k, v in self.slots.items()}
                for i in range(self.n_steps)]

    def _tensors(self) -> list:
        """What the graph writes outside its own pool: every ``.grad`` and
        the optimizer's state tensors."""
        opt = self.state.opt
        return [t for g in opt.param_groups for p in g["params"]
                for t in (p.grad, *opt.state[p].values())
                if torch.is_tensor(t)]

    def _warm_up_and_capture(self) -> dict:
        state, batches = self.state, self._batches()
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            metrics = train_chain(state, self.loss_fn, batches,
                                  self.generator, self.max_grad_norm,
                                  self.ema_decay)
        torch.cuda.current_stream(self.device).wait_stream(self.stream)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        step, t0 = state.step, time.perf_counter()
        try:
            with torch.cuda.graph(graph, stream=self.stream):
                for batch in batches:
                    out = train_step(state, self.loss_fn, batch,
                                     self.generator, self.max_grad_norm,
                                     self.ema_decay, keep_grads=True)
        except RuntimeError as e:
            raise RuntimeError(f"capturing {self.n_steps} training steps as "
                               f"one CUDA graph failed: {e}") from e
        finally:
            state.step = step  # the capture ran no step
        self.capture_seconds = time.perf_counter() - t0
        # held, they stay alive as long as the graph that writes them
        self.graph, self._out, self._held = graph, out, self._tensors()
        return metrics
