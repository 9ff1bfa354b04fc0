"""Port samplers vs the JAX package: dopri5, the SDE sampler and its last
steps, the ODE likelihood, the transport's score and diffusion helpers, and
the sample CLI for each kind.

The frameworks' random streams differ, so every draw is injected: the
starting noise, the SDE's Brownian increments and the likelihood's
Rademacher probes go into both samplers as the same numpy arrays.  Two kinds
of model run on both sides: the perturbed tiny ZigMa of the sample tests
(weights carried by ``state_dict_from_jax``) and a cheap closed-form
velocity field, which lets every sampler option run without a compile per
model.  Analytic cases need no JAX: a linear ODE, and a linear velocity
whose flow and log-density are known in closed form.

Tolerances (fp32): against JAX, 1e-3 of max |jax| on the tiny ZigMa's
samples (per-forward differences of ~1e-5 summed over the steps; dopri5 may
take its steps at float32-rounded times that differ by an ulp) and 1e-5 on
the closed-form field (a few float32 roundings a step); logp within 1e-5 of
|jax logp|.  Against the analytic answers, 2e-3 relative, the size of the
solver's rtol (1e-3).
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zigma_tpu.models import ZigMa as JaxZigMa
from zigma_tpu.transport import Sampler as JaxSampler
from zigma_tpu.transport import create_transport as jax_create_transport
from zigma_tpu.transport.integrators import odeint_dopri5 as jax_dopri5
from zigma_tpu_torch.cli import sample as sample_cli
from zigma_tpu_torch.convert import state_dict_from_jax
from zigma_tpu_torch.models import ZigMa
from zigma_tpu_torch.transport import Sampler, create_transport
from zigma_tpu_torch.transport.integrators import odeint_dopri5

CFG = dict(in_channels=4, embed_dim=32, depth=2, img_dim=8, patch_size=2,
           scan_type="zigzagN8", use_pe=2)


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(11)
    jmodel = JaxZigMa(**CFG, scan_layers=False)
    x = np.zeros((2, 4, 8, 8), np.float32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), x, np.zeros(2))
    params = jax.tree.map(
        lambda p: np.asarray(p, np.float32)
        + 0.05 * rng.standard_normal(p.shape).astype(np.float32), params)
    model = ZigMa(**CFG, device="cpu")
    model.load_state_dict(state_dict_from_jax(params))
    return jmodel, params, model


def _z(seed=5, shape=(2, 4, 8, 8), scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _field(lib):
    """A closed-form nonlinear velocity field on either side."""
    def f(x, t):
        tt = t.reshape(-1, 1, 1, 1)
        return lib.tanh(x) * (0.5 + tt) - 0.3 * x
    return f


def _close(got, ref, tol):
    """Within tol of max |ref|; NaN exactly where the reference has NaN
    (Heun's last drift at t = 1 divides by sigma_1 = 0 on both sides)."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(got), nan)
    got, ref = got[~nan], ref[~nan]
    assert np.max(np.abs(got - ref)) <= tol * np.max(np.abs(ref)), (
        np.max(np.abs(got - ref)), np.max(np.abs(ref)))


# --------------------------------------------------------------- dopri5 ----

def test_dopri5_matches_jax_on_the_tiny_model(models):
    jmodel, params, model = models
    z = _z()
    jfn = JaxSampler(jax_create_transport()).sample_ode(
        sampling_method="dopri5", num_steps=3)
    ref = np.asarray(jax.jit(
        lambda z: jfn(z, lambda x, t: jmodel.apply(params, x, t))[-1])(z))
    fn = Sampler(create_transport()).sample_ode(sampling_method="dopri5",
                                                num_steps=3)
    stats, calls = {}, [0]

    def model_fn(x, t):
        calls[0] += 1
        return model(x, t)

    with torch.inference_mode():
        traj = fn(torch.from_numpy(z), model_fn, stats=stats)
    assert traj.shape == (3, 2, 4, 8, 8) and traj.dtype == torch.float32
    _close(traj[-1].numpy(), ref, 1e-3)
    assert stats["accepted"] >= 2
    assert calls[0] == stats["drift_calls"] == 7 * (stats["accepted"]
                                                    + stats["rejected"])


def test_dopri5_linear_ode_and_tuple_state():
    """dx/dt = a x and dy/dt = -2 y, as one tuple state, against exp;
    every save point on the grid."""
    x0 = torch.from_numpy(_z(shape=(3, 2, 2, 2)))
    y0 = torch.linspace(0.5, 2.0, 3)
    stats = {}
    xs, ys = odeint_dopri5(lambda s, t: (0.7 * s[0], -2.0 * s[1]), (x0, y0),
                           0.0, 1.0, 5, stats=stats)
    ts = torch.linspace(0.0, 1.0, 5)
    for k in range(5):
        want_x = x0 * math.exp(0.7 * float(ts[k]))
        want_y = y0 * math.exp(-2.0 * float(ts[k]))
        assert torch.allclose(xs[k], want_x, rtol=2e-3, atol=1e-6)
        assert torch.allclose(ys[k], want_y, rtol=2e-3, atol=1e-6)
    assert stats["drift_calls"] == 7 * (stats["accepted"] + stats["rejected"])
    # a single tensor state returns a single tensor trajectory
    single = odeint_dopri5(lambda x, t: 0.7 * x, x0, 0.0, 1.0, 5)
    torch.testing.assert_close(single, xs, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["nan_drift", "max_steps"])
def test_dopri5_poisons_the_state_and_stops_calling_the_drift(case):
    """A segment that never reaches its save point (a NaN drift, or one
    attempt allowed and rejected) leaves NaN from there on, as JAX's does;
    the port then calls the drift no more."""
    x0 = _z(shape=(2, 3))
    if case == "nan_drift":
        jf = lambda x, t: x * jnp.nan
        pf = lambda x, t: x * float("nan")
        kw = {}
    else:
        jf = lambda x, t: 60.0 * x
        pf = lambda x, t: 60.0 * x
        kw = dict(max_steps_per_segment=1)
    ref = np.asarray(jax.jit(lambda x: jax_dopri5(jf, x, 0.0, 1.0, 4, **kw))(
        x0))
    calls = [0]

    def counted(x, t):
        calls[0] += 1
        return pf(x, t)

    got = odeint_dopri5(counted, torch.from_numpy(x0), 0.0, 1.0, 4,
                        **kw).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert np.isnan(got[1:]).all() and np.isfinite(got[0]).all()
    assert calls[0] == 7


# ------------------------------------------------------------------ SDE ----

def _noise(steps, shape, seed=9):
    return _z(seed, (steps - 1, *shape))


@pytest.mark.parametrize("method", ["Euler", "Heun"])
@pytest.mark.parametrize("last_step", ["Mean", "Tweedie", "Euler", None])
def test_sde_matches_jax_with_injected_noise(method, last_step):
    z, noise = _z(shape=(2, 3, 4, 4)), _noise(6, (2, 3, 4, 4))
    kw = dict(sampling_method=method, num_steps=6, diffusion_form="sigma",
              last_step=last_step, last_step_size=0.04)
    jfn = JaxSampler(jax_create_transport()).sample_sde(**kw)
    ref = np.asarray(jax.jit(lambda z, n: jfn(None, z, _field(jnp),
                                              noise=n))(z, noise))
    fn = Sampler(create_transport()).sample_sde(**kw)
    got = fn(torch.from_numpy(z), _field(torch), noise=torch.from_numpy(noise))
    assert got.shape == (6, 2, 3, 4, 4)
    _close(got.numpy(), ref, 1e-5)


@pytest.mark.parametrize("path_type", ["Linear", "GVP", "VP"])
@pytest.mark.parametrize("form", ["SBDM", "constant", "linear", "decreasing",
                                  "inccreasing-decreasing"])
def test_sde_diffusion_forms_and_paths_match_jax(path_type, form):
    """Every diffusion form on every path (SBDM starts at the t0 = 1e-3
    guard on the velocity paths); the velocity, noise and score model
    types."""
    z, noise = _z(shape=(2, 3, 4, 4)), _noise(5, (2, 3, 4, 4))
    for prediction in ("velocity", "noise", "score"):
        kw = dict(num_steps=5, diffusion_form=form, diffusion_norm=0.5)
        jfn = JaxSampler(jax_create_transport(path_type, prediction)
                         ).sample_sde(**kw)
        ref = np.asarray(jax.jit(lambda z, n: jfn(None, z, _field(jnp),
                                                  noise=n))(z, noise))
        fn = Sampler(create_transport(path_type, prediction)).sample_sde(**kw)
        got = fn(torch.from_numpy(z), _field(torch),
                 noise=torch.from_numpy(noise))
        assert np.isfinite(ref).all(), (prediction, ref)
        _close(got.numpy(), ref, 1e-5)


def test_sde_default_config_matches_jax_on_the_tiny_model(models):
    jmodel, params, model = models
    z, noise = _z(), _noise(5, (2, 4, 8, 8))
    kw = dict(num_steps=5, diffusion_form="sigma", last_step="Mean",
              last_step_size=0.04)
    jfn = JaxSampler(jax_create_transport()).sample_sde(**kw)
    ref = np.asarray(jax.jit(lambda z, n: jfn(
        None, z, lambda x, t: jmodel.apply(params, x, t), noise=n)[-1])(
            z, noise))
    fn = Sampler(create_transport()).sample_sde(**kw)
    with torch.inference_mode():
        got = fn(torch.from_numpy(z), lambda x, t: model(x, t),
                 noise=torch.from_numpy(noise))[-1]
    _close(got.numpy(), ref, 1e-3)


@pytest.mark.parametrize("method,last_step,want", [
    ("Euler", "Mean", 7), ("Euler", "Tweedie", 7), ("Euler", "Euler", 7),
    ("Euler", None, 6), ("Heun", "Mean", 13)])
def test_one_model_call_per_sde_drift(method, last_step, want):
    """7 steps: 6 SDE steps (Heun: 2 drifts a step) and the last step; each
    drift evaluation is one model call, not one for the drift and one for
    the score."""
    calls = [0]

    def model_fn(x, t):
        calls[0] += 1
        return _field(torch)(x, t)

    fn = Sampler(create_transport()).sample_sde(
        sampling_method=method, num_steps=7, diffusion_form="SBDM",
        last_step=last_step)
    fn(torch.from_numpy(_z(shape=(2, 3, 4, 4))), model_fn,
       generator=torch.Generator().manual_seed(0))
    assert calls[0] == want


# ------------------------------------------------------------ likelihood ----

@pytest.mark.parametrize("method,steps", [("euler", 5), ("heun", 4)])
def test_likelihood_matches_jax_with_injected_probes(method, steps):
    n_evals = 1 if method == "euler" else 2
    x = _z(shape=(3, 2, 4, 4))
    probes = (2 * np.random.default_rng(2).integers(
        0, 2, (n_evals * (steps - 1), *x.shape)) - 1).astype(np.float32)
    jfn = JaxSampler(jax_create_transport()).sample_ode_likelihood(
        sampling_method=method, num_steps=steps)
    jlogp, jz = jax.jit(lambda x, p: jfn(None, x, _field(jnp), probes=p))(
        x, probes)
    fn = Sampler(create_transport()).sample_ode_likelihood(
        sampling_method=method, num_steps=steps)
    logp, z = fn(torch.from_numpy(x), _field(torch),
                 probes=torch.from_numpy(probes))
    _close(z.numpy(), jz, 1e-5)
    _close(logp.numpy(), jlogp, 1e-5)
    with pytest.raises(ValueError, match="leading axis counts evaluations"):
        fn(torch.from_numpy(x), _field(torch),
           probes=torch.from_numpy(probes[:-1]))


def test_likelihood_matches_jax_on_the_tiny_model(models):
    jmodel, params, model = models
    x = _z(seed=6)
    probes = (2 * np.random.default_rng(3).integers(0, 2, (2, *x.shape))
              - 1).astype(np.float32)
    jfn = JaxSampler(jax_create_transport()).sample_ode_likelihood(
        sampling_method="euler", num_steps=3)
    jlogp, jz = jax.jit(lambda x, p: jfn(
        None, x, lambda a, t: jmodel.apply(params, a, t), probes=p))(x, probes)
    fn = Sampler(create_transport()).sample_ode_likelihood(
        sampling_method="euler", num_steps=3)
    logp, z = fn(torch.from_numpy(x), lambda a, t: model(a, t),
                 probes=torch.from_numpy(probes))
    _close(z.numpy(), jz, 1e-3)
    _close(logp.numpy(), jlogp, 1e-5)


@pytest.mark.parametrize("velocity", ["zero", "linear"])
def test_dopri5_likelihood_against_the_analytic_log_density(velocity):
    """Zero velocity: z = x and logp = the prior's.  v = a(t) x with
    a(t) = 0.2 + 0.6 t: the flow scales by exp(-A), A = 0.5, and the
    Rademacher estimate of div v = a(t) * dim is exact, so logp =
    prior(x exp(-A)) - dim * A."""
    tr = create_transport()
    x = torch.from_numpy(_z(seed=2, shape=(3, 2, 2, 2), scale=0.5))
    if velocity == "zero":
        field, A = (lambda a, t: torch.zeros_like(a)), 0.0
    else:
        field, A = (lambda a, t: (0.2 + 0.6 * t).reshape(-1, 1, 1, 1) * a), 0.5
    stats = {}
    logp, z = Sampler(tr).sample_ode_likelihood(num_steps=4)(
        x, field, generator=torch.Generator().manual_seed(1), stats=stats)
    want_z = x * math.exp(-A)
    want = tr.prior_logp(want_z) - 8 * A
    torch.testing.assert_close(z, want_z, rtol=2e-3, atol=1e-6)
    torch.testing.assert_close(logp, want, rtol=2e-3, atol=0)
    assert stats["accepted"] >= 3


# -------------------------------------------------------- transport maths ----

@pytest.mark.parametrize("path_type", ["Linear", "GVP", "VP"])
@pytest.mark.parametrize("prediction", ["velocity", "noise", "score"])
def test_score_prior_and_conversions_match_jax(path_type, prediction):
    rng = np.random.default_rng(4)
    x, v = (rng.standard_normal((3, 2, 4, 4)).astype(np.float32)
            for _ in "ab")
    t = rng.uniform(0.1, 0.9, 3).astype(np.float32)
    jtr = jax_create_transport(path_type, prediction)
    tr = create_transport(path_type, prediction)
    tx, tv, tt = (torch.from_numpy(a) for a in (x, v, t))
    mf = lambda a, b: 0.5 * a + b.reshape(-1, 1, 1, 1)
    _close(tr.get_score()(tx, tt, mf), jtr.get_score()(x, t, mf), 1e-6)
    _close(tr.prior_logp(tx), jtr.prior_logp(x), 1e-6)
    ps, jps = tr.path_sampler, jtr.path_sampler
    for name in ("get_noise_from_velocity", "get_velocity_from_score",
                 "get_score_from_velocity"):
        _close(getattr(ps, name)(tv, tx, tt),
               getattr(jps, name)(v, x, t), 1e-6)
    for form in ("constant", "SBDM", "sigma", "linear", "decreasing",
                 "inccreasing-decreasing"):
        _close(ps.compute_diffusion(tx, tt, form=form, norm=0.7),
               jps.compute_diffusion(x, t, form=form, norm=0.7), 1e-6)


# ---------------------------------------------------------------- the CLI ----

def _ckpt(tmp_path):
    cfg = sample_cli.load_config(sample_cli.DEFAULT_CONFIG_DIR, "default",
                                 TINY)
    model = sample_cli.build_model(cfg, device="cpu",
                                   generator=torch.Generator().manual_seed(0))
    with torch.no_grad():  # off the zero-init, so the gates are open
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape,
                                      generator=torch.Generator().manual_seed(1)))
    path = os.path.join(tmp_path, "ckpt.pt")
    torch.save({"ema": model.state_dict()}, path)
    return path


TINY = ["model.params.embed_dim=32", "model.params.depth=2",
        "model.params.img_dim=8", "model.params.patch_size=2"]


def _sample(tmp_path, ckpt, *extra):
    return sample_cli.main([f"ckpt={ckpt}", *TINY, "num_fid_samples=2",
                            "offline_sample_local_bs=2",
                            f"sample_dir={tmp_path}", "device=cpu", *extra])


def test_sample_cli_every_kind(tmp_path, capsys):
    ckpt = _ckpt(tmp_path)
    # the repo's default ode config is dopri5: fewer save points here
    res = _sample(tmp_path, ckpt, "ode.num_sampling_steps=3")
    assert res["kind"] == "ode" and res["n_nonfinite"] == 0
    assert res["out_dir"].endswith("zigzagN8_b1_pe2_ode_dopri5_n3")
    (st,) = res["dopri5"]
    assert res["model_calls"] == [7 * (st["accepted"] + st["rejected"])]
    res = _sample(tmp_path, ckpt, "sample_mode=SDE",
                  "sde.num_sampling_steps=4")
    assert res["out_dir"].endswith("zigzagN8_b1_pe2_sde_Euler_n4")
    assert res["model_calls"] == [4] and res["n_nonfinite"] == 0
    capsys.readouterr()
    res = _sample(tmp_path, ckpt, "likelihood=true",
                  "ode.sampling_method=euler", "ode.num_sampling_steps=3")
    assert res["out_dir"].endswith("zigzagN8_b1_pe2_likelihood_euler_n3")
    assert res["model_calls"] == [2] and res["n_nonfinite"] == 0
    (logp,) = res["logp"]
    assert logp.shape == (2,) and np.isfinite(logp).all()
    assert "scores gaussian noise" in capsys.readouterr().err
    assert len([f for f in os.listdir(res["out_dir"])
                if f.endswith(".png")]) == 2
    with pytest.raises(ValueError, match="cfg_scale == 1"):
        _sample(tmp_path, ckpt, "likelihood=true", "cfg_scale=2")
    with pytest.raises(ValueError, match="class_dropout_prob"):
        _sample(tmp_path, ckpt, "data.num_classes=5", "cfg_scale=2")
