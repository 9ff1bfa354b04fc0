"""Flow-matching transport: training losses and the ODE, SDE and
likelihood samplers.

Counterpart of ``zigma_tpu/transport/transport.py``: ``create_transport``,
``mean_flat``, ``Transport`` (``sample``, ``training_losses``,
``check_interval``, ``get_drift``, ``get_score``, ``prior_logp``) and
``Sampler`` (``sample_ode`` with euler, heun and dopri5, ``sample_sde`` with
Euler-Maruyama or Heun and its last steps, ``sample_ode_likelihood``).

Random draws take an explicit ``torch.Generator``.  Its stream is not
``jax.random``'s, so every draw can also be injected: ``t`` and ``x0`` of
``training_losses``, the SDE's Brownian increments (``noise``) and the
likelihood's Rademacher probes (``probes``); the tests feed the JAX draws.

The SDE drift is ``drift + diffusion * score``, both from one model output:
the JAX code calls the model twice for it and leaves XLA to merge the two
under ``jit``; run eagerly that would be two forwards.  The numbers are the
same.

Model interface: ``model_fn(x, t, **model_kwargs)`` with x (B, ...) and
t (B,) in [0, 1].

A batch of the ODE or SDE sampler is a span ``sampler.sample`` (its
``method`` and ``num_steps``) around one ``sampler.step`` a step, or a
dopri5 stage (``utils.profiling.span``).
"""

from __future__ import annotations

import enum
import math
from typing import Callable, Optional

import torch

from zigma_tpu_torch.transport import path as path_mod
from zigma_tpu_torch.transport.integrators import (odeint_dopri5,
                                                   odeint_fixed, sdeint)
from zigma_tpu_torch.transport.path import expand_t_like_x
from zigma_tpu_torch.utils.profiling import span

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

    def drift_from_output(self, out, x, t):
        """The probability-flow drift from the model's output at (x, t)."""
        if self.model_type == ModelType.VELOCITY:
            return out
        drift_mean, drift_var = self.path_sampler.compute_drift(x, t)
        if self.model_type == ModelType.SCORE:
            return -drift_mean + drift_var * out
        sigma_t, _ = self.path_sampler.compute_sigma_t(expand_t_like_x(t, x))
        return -drift_mean + drift_var * (out / -sigma_t)

    def score_from_output(self, out, x, t):
        """The score from the model's output at (x, t)."""
        if self.model_type == ModelType.NOISE:
            return out / -(self.path_sampler.compute_sigma_t(
                expand_t_like_x(t, x))[0])
        if self.model_type == ModelType.SCORE:
            return out
        return self.path_sampler.get_score_from_velocity(out, x, t)

    def get_drift(self):
        return lambda x, t, model_fn, **kw: self.drift_from_output(
            model_fn(x, t, **kw), x, t)

    def get_score(self):
        return lambda x, t, model_fn, **kw: self.score_from_output(
            model_fn(x, t, **kw), x, t)

    def prior_logp(self, z):
        """log N(z; 0, I) per batch element."""
        N = math.prod(z.shape[1:])
        return (-N / 2.0 * math.log(2 * math.pi)
                - (z.reshape(z.shape[0], -1) ** 2).sum(-1) / 2.0)


_ODE_METHODS = ("euler", "heun", "dopri5")


class Sampler:
    """ODE / SDE / likelihood samplers."""

    def __init__(self, transport: Transport):
        self.transport = transport
        self.drift = transport.get_drift()
        self.score = transport.get_score()

    def sample_ode(self, *, sampling_method="dopri5", num_steps=50,
                   atol=1e-6, rtol=1e-3, reverse=False):
        """Returns ``sample_fn(z, model_fn, stats=None, **model_kwargs)`` ->
        trajectory (num_steps, B, ...); trajectory[-1] is the sample.
        dopri5 fills ``stats`` (a dict) with its accepted and rejected
        steps and drift calls."""
        method = sampling_method.lower()
        if method not in _ODE_METHODS:
            raise NotImplementedError(
                f"unknown ODE sampling_method {sampling_method!r} "
                f"(euler | heun | dopri5)")
        if reverse:
            base_drift = lambda x, t, model_fn, **kw: self.drift(
                x, 1 - t, model_fn, **kw)
        else:
            base_drift = self.drift
        t0, t1 = self.transport.check_interval(
            self.transport.train_eps, self.transport.sample_eps,
            sde=False, eval=True, reverse=reverse, last_step_size=0.0)

        def sample_fn(z, model_fn, stats=None, **model_kwargs):
            drift = lambda x, t: base_drift(x, t, model_fn, **model_kwargs)
            with span("sampler.sample", method=method, num_steps=num_steps):
                if method == "dopri5":
                    return odeint_dopri5(drift, z, t0, t1, num_steps,
                                         atol=atol, rtol=rtol, stats=stats)
                return odeint_fixed(drift, z, t0, t1, num_steps,
                                    method=method)

        return sample_fn

    def _sde_drift_and_diffusion(self, diffusion_form, diffusion_norm):
        tr = self.transport

        def diffusion_fn(x, t):
            return tr.path_sampler.compute_diffusion(
                x, t, form=diffusion_form, norm=diffusion_norm)

        def sde_drift(x, t, model_fn, **kw):
            out = model_fn(x, t, **kw)  # one forward for drift and score
            return (tr.drift_from_output(out, x, t)
                    + diffusion_fn(x, t) * tr.score_from_output(out, x, t))

        return sde_drift, diffusion_fn

    def _last_step_fn(self, sde_drift, last_step, last_step_size):
        ps = self.transport.path_sampler
        if last_step is None:
            return lambda x, t, model_fn, **kw: x
        if last_step == "Mean":
            return lambda x, t, model_fn, **kw: (
                x + sde_drift(x, t, model_fn, **kw) * last_step_size)
        if last_step == "Tweedie":
            def tweedie(x, t, model_fn, **kw):
                a = ps.compute_alpha_t(t[0])[0]
                s = ps.compute_sigma_t(t[0])[0]
                return x / a + (s ** 2) / a * self.score(x, t, model_fn, **kw)
            return tweedie
        if last_step == "Euler":
            return lambda x, t, model_fn, **kw: (
                x + self.drift(x, t, model_fn, **kw) * last_step_size)
        raise NotImplementedError(last_step)

    def sample_sde(self, *, sampling_method="Euler", diffusion_form="SBDM",
                   diffusion_norm=1.0, last_step="Mean", last_step_size=0.04,
                   num_steps=250):
        """Returns ``sample_fn(z, model_fn, generator=None, noise=None,
        **model_kwargs)`` -> trajectory (num_steps, B, ...): num_steps - 1
        SDE steps and the configured last step.  ``noise`` injects the
        (num_steps - 1, *z.shape) standard-normal draws, else they come
        from ``generator``; with neither it raises."""
        if sampling_method not in ("Euler", "Heun"):
            raise NotImplementedError(
                f"unknown SDE sampling_method {sampling_method!r} "
                f"(Euler | Heun)")
        if last_step is None:
            last_step_size = 0.0
        sde_drift, sde_diffusion = self._sde_drift_and_diffusion(
            diffusion_form, diffusion_norm)
        t0, t1 = self.transport.check_interval(
            self.transport.train_eps, self.transport.sample_eps,
            diffusion_form=diffusion_form, sde=True, eval=True,
            reverse=False, last_step_size=last_step_size)
        if diffusion_form == "SBDM" and t0 == 0:
            # the SBDM coefficient divides by t: a first step at t0 = 0 is
            # inf and NaN-poisons the trajectory; start at the eps used for
            # every other singular path
            t0 = 1e-3
        last_fn = self._last_step_fn(sde_drift, last_step, last_step_size)

        def sample_fn(z, model_fn, generator=None, noise=None,
                      **model_kwargs):
            drift = lambda x, t: sde_drift(x, t, model_fn, **model_kwargs)
            with span("sampler.sample", method=sampling_method,
                      num_steps=num_steps):
                traj = sdeint(drift, sde_diffusion, z, t0, t1, num_steps,
                              method=sampling_method, generator=generator,
                              noise=noise)
                ts = torch.full((z.shape[0],), t1, dtype=torch.float32,
                                device=z.device)
                x_last = last_fn(traj[-1], ts, model_fn, **model_kwargs)
                return torch.cat([traj, x_last[None]])

        return sample_fn

    def sample_ode_likelihood(self, *, sampling_method="dopri5", num_steps=50,
                              atol=1e-6, rtol=1e-3):
        """Returns ``fn(x, model_fn, generator=None, probes=None, stats=None,
        **model_kwargs)`` -> (logp (B,), z (B, ...)).

        The data x is carried back to noise z by the probability flow, and
        the divergence of the drift is integrated beside it by Hutchinson's
        estimator with Rademacher probes: one vector-Jacobian product a
        drift evaluation, through ``torch.autograd.grad`` (so the model runs
        its backward too; callers must not be in ``inference_mode``).
        euler and heun take a fresh probe each drift evaluation (1 and 2 a
        step); ``probes`` injects them, a ``(n_evals * (num_steps - 1),
        *x.shape)`` +-1 tensor.  dopri5 takes one probe for the whole
        trajectory, from ``generator``."""
        method = sampling_method.lower()
        if method not in _ODE_METHODS:
            raise NotImplementedError(
                f"unknown likelihood sampling_method {sampling_method!r} "
                f"(euler | heun | dopri5)")
        t0, t1 = self.transport.check_interval(
            self.transport.train_eps, self.transport.sample_eps,
            sde=False, eval=True, reverse=False, last_step_size=0.0)

        def drift_with_probe(state, t, eps, model_fn, model_kwargs):
            xi = state[0]
            with torch.enable_grad():
                xg = xi.detach().requires_grad_(True)
                drift = self.drift(xg, 1 - t, model_fn, **model_kwargs)
                grad = None
                if drift.requires_grad:  # else the drift ignores x
                    (grad,) = torch.autograd.grad(
                        drift, xg, eps.to(drift.dtype), allow_unused=True)
            if grad is None:
                grad = torch.zeros_like(xi)
            logp_grad = (grad * eps).reshape(xi.shape[0], -1).sum(-1)
            return (-drift.detach(), logp_grad)

        def rademacher(shape, x, generator):
            return (torch.randint(0, 2, shape, generator=generator,
                                  device=x.device).to(x.dtype) * 2 - 1)

        def sample_fn(x, model_fn, generator=None, probes=None, stats=None,
                      **model_kwargs):
            init_logp = torch.zeros((x.shape[0],), dtype=x.dtype,
                                    device=x.device)
            if method == "dopri5":
                eps = rademacher(x.shape, x, generator)
                drift = lambda st, t: drift_with_probe(
                    st, t, eps, model_fn, model_kwargs)
                z, delta_logp = (traj[-1] for traj in odeint_dopri5(
                    drift, (x, init_logp), t0, t1, num_steps, atol=atol,
                    rtol=rtol, stats=stats))
            else:
                n_evals = 1 if method == "euler" else 2
                want = (n_evals * (num_steps - 1), *x.shape)
                if probes is None:
                    probes = rademacher(want, x, generator)
                if tuple(probes.shape) != want:
                    raise ValueError(
                        f"probes shape {tuple(probes.shape)} != {want}: "
                        f"{method} makes {n_evals} drift evaluations a step "
                        f"over {num_steps - 1} steps; the leading axis "
                        f"counts evaluations")
                probes = probes.reshape(num_steps - 1, n_evals, *x.shape)
                ts = torch.linspace(t0, t1, num_steps, dtype=torch.float32)
                z, delta_logp = x, init_logp
                for i in range(num_steps - 1):
                    t, dt = ts[i], ts[i + 1] - ts[i]
                    tb = torch.full((x.shape[0],), float(t),
                                    dtype=torch.float32, device=x.device)
                    dx, dlogp = drift_with_probe(
                        (z, delta_logp), tb, probes[i, 0], model_fn,
                        model_kwargs)
                    pred = (z + float(dt) * dx.float(),
                            delta_logp + float(dt) * dlogp)
                    if n_evals == 1:
                        z, delta_logp = pred
                        continue
                    # heun: the corrector drift at the Euler predictor
                    tb2 = torch.full((x.shape[0],), float(t + dt),
                                     dtype=torch.float32, device=x.device)
                    dx2, dlogp2 = drift_with_probe(
                        pred, tb2, probes[i, 1], model_fn, model_kwargs)
                    # (dx + dx2) in the drift's dtype, as odeint_fixed adds
                    z = z + 0.5 * float(dt) * (dx + dx2).float()
                    delta_logp = delta_logp + 0.5 * float(dt) * (dlogp + dlogp2)
            return self.transport.prior_logp(z) - delta_logp, z

        return sample_fn


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
