"""Flow-matching transport and its ODE sampler.

Counterpart of ``zigma_tpu/transport/transport.py`` for the sampling and
training paths: ``create_transport``, ``mean_flat``, ``Transport.sample`` /
``training_losses`` / ``check_interval`` / ``get_drift`` and
``Sampler.sample_ode`` with euler and heun.  dopri5, the SDE sampler and
likelihood are later slices of the port; the sampler raises for them at
construction, as the JAX one does for unknown methods.

Random draws take an explicit ``torch.Generator``.  Its stream is not
``jax.random``'s, so ``training_losses`` also takes injected ``t`` and
``x0`` (the tests feed it the JAX draw).

Model interface: ``model_fn(x, t, **model_kwargs)`` with x (B, ...) and
t (B,) in [0, 1].
"""

from __future__ import annotations

import enum
from typing import Callable, Optional

import torch

from zigma_tpu_torch.transport import path as path_mod
from zigma_tpu_torch.transport.integrators import odeint_fixed
from zigma_tpu_torch.transport.path import expand_t_like_x

__all__ = ["ModelType", "PathType", "WeightType", "Transport", "Sampler",
           "create_transport", "mean_flat"]


class ModelType(enum.Enum):
    NOISE = enum.auto()
    SCORE = enum.auto()
    VELOCITY = enum.auto()


class PathType(enum.Enum):
    LINEAR = enum.auto()
    GVP = enum.auto()
    VP = enum.auto()


class WeightType(enum.Enum):
    NONE = enum.auto()
    VELOCITY = enum.auto()
    LIKELIHOOD = enum.auto()


def mean_flat(x):
    """Mean over all non-batch dims."""
    return x.mean(dim=tuple(range(1, x.dim())))


class Transport:
    """Interpolant, loss and drift wrappers."""

    def __init__(self, *, model_type: ModelType, path_type: PathType,
                 loss_type: WeightType, train_eps: float, sample_eps: float):
        path_options = {
            PathType.LINEAR: path_mod.ICPlan,
            PathType.GVP: path_mod.GVPCPlan,
            PathType.VP: path_mod.VPCPlan,
        }
        self.model_type = model_type
        self.path_type = path_type
        self.loss_type = loss_type
        self.path_sampler = path_options[path_type]()
        self.train_eps = train_eps
        self.sample_eps = sample_eps

    def check_interval(self, train_eps, sample_eps, *, diffusion_form="SBDM",
                       sde=False, reverse=False, eval=False,
                       last_step_size=0.0):
        t0, t1 = 0.0, 1.0
        eps = train_eps if not eval else sample_eps
        if isinstance(self.path_sampler, path_mod.VPCPlan):
            t1 = 1 - eps if (not sde or last_step_size == 0) else 1 - last_step_size
        elif (isinstance(self.path_sampler, (path_mod.ICPlan, path_mod.GVPCPlan))
              and (self.model_type != ModelType.VELOCITY or sde)):
            t0 = (eps if (diffusion_form == "SBDM" and sde)
                  or self.model_type != ModelType.VELOCITY else 0)
            t1 = 1 - eps if (not sde or last_step_size == 0) else 1 - last_step_size
        if reverse:
            t0, t1 = 1 - t0, 1 - t1
        return t0, t1

    def sample(self, x1, generator: Optional[torch.Generator] = None):
        """Draw (t, x0, x1) for a batch: x0 standard normal like x1, t
        uniform float32 on the training interval."""
        x0 = torch.randn(x1.shape, generator=generator, dtype=x1.dtype,
                         device=x1.device)
        t0, t1 = self.check_interval(self.train_eps, self.sample_eps)
        t = torch.rand((x1.shape[0],), generator=generator,
                       dtype=torch.float32, device=x1.device) * (t1 - t0) + t0
        return t, x0, x1

    def training_losses(self, model_fn: Callable, x1,
                        generator: Optional[torch.Generator] = None,
                        model_kwargs=None, t=None, x0=None):
        """Velocity / noise / score flow-matching loss.  Returns a dict
        with 'loss' (B,) and 'pred'.  ``t`` and ``x0`` replace the draw
        when given (both together)."""
        model_kwargs = model_kwargs or {}
        if (t is None) != (x0 is None):
            raise ValueError("inject t and x0 together")
        if t is None:
            t, x0, x1 = self.sample(x1, generator)
        t, xt, ut = self.path_sampler.plan(t, x0, x1)
        model_output = model_fn(xt, t, **model_kwargs)

        terms = {"pred": model_output}
        if self.model_type == ModelType.VELOCITY:
            terms["loss"] = mean_flat((model_output - ut) ** 2)
        else:
            _, drift_var = self.path_sampler.compute_drift(xt, t)
            sigma_t, _ = self.path_sampler.compute_sigma_t(
                expand_t_like_x(t, xt))
            if self.loss_type == WeightType.VELOCITY:
                weight = (drift_var / sigma_t) ** 2
            elif self.loss_type == WeightType.LIKELIHOOD:
                weight = drift_var / (sigma_t ** 2)
            else:
                weight = 1.0
            if self.model_type == ModelType.NOISE:
                terms["loss"] = mean_flat(weight * (model_output - x0) ** 2)
            else:
                terms["loss"] = mean_flat(
                    weight * (model_output * sigma_t + x0) ** 2)
        return terms

    def get_drift(self):
        def score_ode(x, t, model_fn, **kw):
            drift_mean, drift_var = self.path_sampler.compute_drift(x, t)
            return -drift_mean + drift_var * model_fn(x, t, **kw)

        def noise_ode(x, t, model_fn, **kw):
            drift_mean, drift_var = self.path_sampler.compute_drift(x, t)
            sigma_t, _ = self.path_sampler.compute_sigma_t(expand_t_like_x(t, x))
            score = model_fn(x, t, **kw) / -sigma_t
            return -drift_mean + drift_var * score

        def velocity_ode(x, t, model_fn, **kw):
            return model_fn(x, t, **kw)

        return {
            ModelType.NOISE: noise_ode,
            ModelType.SCORE: score_ode,
            ModelType.VELOCITY: velocity_ode,
        }[self.model_type]


class Sampler:
    """Fixed-step ODE sampler (euler, heun)."""

    def __init__(self, transport: Transport):
        self.transport = transport
        self.drift = transport.get_drift()

    def sample_ode(self, *, sampling_method="euler", num_steps=50,
                   reverse=False):
        """Returns ``sample_fn(z, model_fn, **model_kwargs)`` -> trajectory
        (num_steps, B, ...); trajectory[-1] is the sample."""
        method = sampling_method.lower()
        if method not in ("euler", "heun"):
            raise NotImplementedError(
                f"ODE sampling_method {sampling_method!r}: this slice of the "
                f"port has euler and heun; dopri5 lands in a later slice")
        if reverse:
            base_drift = lambda x, t, model_fn, **kw: self.drift(
                x, 1 - t, model_fn, **kw)
        else:
            base_drift = self.drift
        t0, t1 = self.transport.check_interval(
            self.transport.train_eps, self.transport.sample_eps,
            sde=False, eval=True, reverse=reverse, last_step_size=0.0)

        def sample_fn(z, model_fn, **model_kwargs):
            drift = lambda x, t: base_drift(x, t, model_fn, **model_kwargs)
            return odeint_fixed(drift, z, t0, t1, num_steps, method=method)

        return sample_fn

    def sample_sde(self, **_):
        raise NotImplementedError("the SDE sampler lands in a later slice of "
                                  "the port")

    def sample_ode_likelihood(self, **_):
        raise NotImplementedError("ODE likelihood lands in a later slice of "
                                  "the port")


def create_transport(path_type="Linear", prediction="velocity",
                     loss_weight=None, train_eps=None, sample_eps=None):
    """Factory with the reference's default-eps rules (and the JAX
    package's fix: the sample_eps default applies when sample_eps is None)."""
    model_type = {
        "noise": ModelType.NOISE,
        "score": ModelType.SCORE,
        "velocity": ModelType.VELOCITY,
    }[prediction]
    loss_type = {
        "velocity": WeightType.VELOCITY,
        "likelihood": WeightType.LIKELIHOOD,
        None: WeightType.NONE,
    }[loss_weight]
    ptype = {"Linear": PathType.LINEAR, "GVP": PathType.GVP,
             "VP": PathType.VP}[path_type]
    if ptype == PathType.VP:
        train_eps = 1e-5 if train_eps is None else train_eps
        sample_eps = 1e-3 if sample_eps is None else sample_eps
    elif (ptype in (PathType.GVP, PathType.LINEAR)
          and model_type != ModelType.VELOCITY):
        train_eps = 1e-3 if train_eps is None else train_eps
        sample_eps = 1e-3 if sample_eps is None else sample_eps
    else:  # velocity & [GVP, LINEAR] is stable everywhere
        train_eps = 0
        sample_eps = 0
    return Transport(model_type=model_type, path_type=ptype,
                     loss_type=loss_type, train_eps=train_eps,
                     sample_eps=sample_eps)
