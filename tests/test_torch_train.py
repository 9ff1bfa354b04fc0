"""Port training path vs the JAX package: drop-path, remat, the transport's
losses, loss and gradients, AdamW + clip + EMA steps, logging, checkpoints
and the train CLI.

The same perturbed tiny ZigMa (depth 2, embed 32, 8x8 latents, zigzagN8,
drop-path 0.1) runs in both packages, its weights carried over by
``state_dict_from_jax``.  The frameworks' random streams differ, so the JAX
draws are recorded in the test -- the flow-matching ``(t, x0)`` from
``Transport.sample`` and every drop-path keep mask from ``drop_path`` -- and
replayed in the port (``jax.debug.callback`` hands them out of the jitted
JAX loss).

Tolerances (fp32): loss 1e-5 relative; each parameter's gradient within
1e-4 of its max |jax| (the scans and convs sum in another order; measured
below 6e-6); after the AdamW steps params and EMA within 1e-6 absolute and
grad_norm 1e-5 relative.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import zigma_tpu.models.zigma as jax_zigma_mod
from zigma_tpu.models import ZigMa as JaxZigMa
from zigma_tpu.train import create_optimizer as jax_create_optimizer
from zigma_tpu.train import make_diffusion_loss_fn as jax_loss_fn
from zigma_tpu.train import update_ema as jax_update_ema
from zigma_tpu.transport import create_transport as jax_create_transport
from zigma_tpu.transport.transport import Transport as JaxTransport
from zigma_tpu_torch.cli import sample as sample_cli
from zigma_tpu_torch.cli import train as train_cli
from zigma_tpu_torch.convert import state_dict_from_jax
from zigma_tpu_torch.models import ZigMa
from zigma_tpu_torch.models import zigma as port_zigma_mod
from zigma_tpu_torch.models.zigma import drop_path_rates
from zigma_tpu_torch.train import (LATENT_SCALE, TrainState,
                                   make_diffusion_loss_fn, train_step)
from zigma_tpu_torch.transport import create_transport

JAX_SAMPLE, JAX_DROP_PATH = JaxTransport.sample, jax_zigma_mod.drop_path
PORT_DROP_PATH = port_zigma_mod.drop_path
CFG = dict(in_channels=4, embed_dim=32, depth=2, img_dim=8, patch_size=1,
           scan_type="zigzagN8", use_pe=2, drop_path_rate=0.1)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(21)
    jmodel = JaxZigMa(**CFG, scan_layers=False)
    x = np.zeros((4, 4, 8, 8), np.float32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), x, np.zeros(4))
    params = jax.tree.map(
        lambda p: np.asarray(p, np.float32)
        + 0.02 * rng.standard_normal(p.shape).astype(np.float32), params)
    batch = {"x": rng.standard_normal((4, 4, 8, 8)).astype(np.float32)}
    return jmodel, params, batch


class _Recorder:
    """Records the JAX draws of a jitted loss through ``jax.debug.callback``
    (in program order), and replays the drop-path masks in the port in the
    same order (blocks, then the final one)."""

    def __init__(self, mp):
        self.draws, self.masks, self._replay = [], [], []

        def sample(tr, rng, x1):
            t, x0, x1 = JAX_SAMPLE(tr, rng, x1)
            jax.debug.callback(lambda a, b: self.draws.append(
                (np.array(a), np.array(b))), t, x0, ordered=True)
            return t, x0, x1

        def drop_path(x, rate, rng, scale_by_keep=True):
            keep = jax.random.bernoulli(rng, 1.0 - rate, (x.shape[0],))
            jax.debug.callback(lambda k, r=float(rate): self.masks.append(
                (r, np.array(k))), keep, ordered=True)
            return JAX_DROP_PATH(x, rate, rng, scale_by_keep)

        def port_drop_path(x, rate, keep_mask):
            if not self._replay:  # nothing queued: the port's own mask
                return PORT_DROP_PATH(x, rate, keep_mask)
            jrate, jmask = self._replay.pop(0)
            assert abs(rate - jrate) < 1e-7
            return PORT_DROP_PATH(x, rate, torch.from_numpy(jmask))

        mp.setattr(JaxTransport, "sample", sample)
        mp.setattr(jax_zigma_mod, "drop_path", drop_path)
        mp.setattr(port_zigma_mod, "drop_path", port_drop_path)

    def run(self, vg, params, key, batch):
        """JAX loss and grads, with this call's draws and masks; the masks
        are queued for the port's next forward."""
        self.draws.clear()
        self.masks.clear()
        loss, grads = vg(params, key, batch)
        jax.effects_barrier()
        self._replay = list(self.masks)
        (t, x0), = self.draws
        return loss, grads, torch.from_numpy(t), torch.from_numpy(x0)


@pytest.fixture(scope="module")
def jax_run(setup):
    """(recorder, jitted value_and_grad of the JAX loss), traced once with
    the recording drop_path and sample in place."""
    jmodel, _, _ = setup
    loss_fn = jax_loss_fn(jmodel, jax_create_transport(),
                          latent_scale=LATENT_SCALE)
    with pytest.MonkeyPatch.context() as mp:
        rec = _Recorder(mp)
        yield rec, jax.jit(jax.value_and_grad(loss_fn))


def _port_model(params):
    model = ZigMa(**CFG, device="cpu")
    model.load_state_dict(state_dict_from_jax(params))
    return model


def test_drop_path_schedule_and_masks_match_jax(setup, jax_run):
    """The per-block rates JAX applies (block 0 at 0, then linspace, the
    last hidden state at the full rate) and drop_path's values for a given
    keep mask."""
    _, params, batch = setup
    rec, vg = jax_run
    rec.run(vg, params, jax.random.PRNGKey(1), batch)
    rates = [r for r, _ in rec.masks]
    np.testing.assert_allclose(
        rates, [*drop_path_rates(0.1, CFG["depth"]), 0.1], rtol=0, atol=1e-7)
    x = np.random.default_rng(2).standard_normal((4, 3, 5)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        ref = JAX_DROP_PATH(jnp.asarray(x, jdtype), 0.3, key)
        mask = np.array(jax.random.bernoulli(key, 0.7, (4,)))
        got = PORT_DROP_PATH(torch.from_numpy(x).to(dtype), 0.3,
                             torch.from_numpy(mask))
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(ref, np.float32))


def _grads(model, batch, seed, remat):
    model.use_checkpoint = remat
    model.zero_grad(set_to_none=True)
    loss_fn = make_diffusion_loss_fn(model, create_transport(),
                                     latent_scale=LATENT_SCALE)
    gen = torch.Generator().manual_seed(seed)
    loss = loss_fn({"x": torch.from_numpy(batch["x"])}, gen)
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}


def test_remat_on_and_off_give_equal_gradients(setup):
    """Drop-path 0.1 under remat: the masks are drawn before the block
    stack, so the recompute sees the same ones and the gradients agree
    bit for bit with remat off (same generator seed)."""
    _, params, batch = setup
    model = _port_model(params)
    loss_a, ga = _grads(model, batch, 5, remat=False)
    loss_b, gb = _grads(model, batch, 5, remat=True)
    assert loss_a == loss_b
    for n in ga:
        torch.testing.assert_close(ga[n], gb[n], rtol=0, atol=0, msg=n)
    # and drop-path really acts: another seed draws other masks
    loss_c, _ = _grads(model, batch, 6, remat=True)
    assert loss_c != loss_a


def test_loss_and_gradients_match_jax(setup, jax_run):
    _, params, batch = setup
    rec, vg = jax_run
    for k in range(3, 40):  # the first key whose masks drop a sample
        jloss, jgrads, t, x0 = rec.run(vg, params, jax.random.PRNGKey(k),
                                       batch)
        if any(not m.all() for _, m in rec.masks):
            break
    assert any(not m.all() for _, m in rec.masks)
    model = _port_model(params)
    loss_fn = make_diffusion_loss_fn(model, create_transport(),
                                     latent_scale=LATENT_SCALE)
    loss = loss_fn({"x": torch.from_numpy(batch["x"])}, t=t, x0=x0)
    loss.backward()
    assert rec._replay == []  # every JAX mask was used
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    ref = state_dict_from_jax(jax.tree.map(np.array, jgrads))
    assert set(ref) == {n for n, _ in model.named_parameters()}
    for n, p in model.named_parameters():
        r = ref[n].numpy()
        err = np.max(np.abs(p.grad.numpy() - r))
        assert err <= 1e-4 * max(np.max(np.abs(r)), 1e-8), (n, err)


def test_train_step_matches_jax_optimizer_and_ema(setup, jax_run):
    """Two steps of loss -> grads -> clip 2.0 -> AdamW -> EMA 0.9999 on both
    sides; the JAX step is assembled from its public pieces."""
    _, params, batch = setup
    rec, vg = jax_run
    opt = jax_create_optimizer(lr=1e-4)
    jp = jax.tree.map(jnp.asarray, params)
    jema, jopt = jp, opt.init(jp)
    model = _port_model(params)
    state = TrainState.create(model)
    loss_fn = make_diffusion_loss_fn(model, create_transport(),
                                     latent_scale=LATENT_SCALE)
    for i in range(2):
        jloss, jg, t, x0 = rec.run(vg, jp, jax.random.PRNGKey(10 + i), batch)
        updates, jopt = opt.update(jg, jopt, jp)
        jp = optax.apply_updates(jp, updates)
        jema = jax_update_ema(jema, jp, 0.9999)
        jnorm = float(optax.global_norm(jg))
        m = train_step(state, loss_fn, {"x": torch.from_numpy(batch["x"])},
                       t=t, x0=x0)
        assert abs(m["loss"].item() - float(jloss)) <= 1e-5 * float(jloss)
        assert abs(m["grad_norm"].item() - jnorm) <= 1e-5 * jnorm
    assert jnorm > 2.0  # the clip acted
    assert state.step == 2
    for which, tree, mod in (("params", jp, state.model),
                             ("ema", jema, state.ema)):
        ref = state_dict_from_jax(jax.tree.map(np.array, tree))
        for n, p in mod.named_parameters():
            assert p.dtype == torch.float32
            err = np.max(np.abs(p.detach().numpy() - ref[n].numpy()))
            assert err <= 1e-6, (which, n, err)


@pytest.mark.parametrize("path_type", ["Linear", "GVP", "VP"])
@pytest.mark.parametrize("prediction,loss_weight", [
    ("velocity", None), ("noise", None), ("score", "velocity"),
    ("score", "likelihood")])
def test_training_losses_match_jax(path_type, prediction, loss_weight):
    """Every plan's (xt, ut) and every loss form, with the same injected
    (t, x0) and the same model function on both sides; fp32 within 1e-6
    relative (one rounding of each elementwise op)."""
    rng = np.random.default_rng(8)
    x1, x0 = rng.standard_normal((2, 3, 4, 4, 4)).astype(np.float32)
    jtr = jax_create_transport(path_type, prediction, loss_weight)
    t0, t1 = jtr.check_interval(jtr.train_eps, jtr.sample_eps)
    t = (rng.uniform(size=3) * (t1 - t0) + t0).astype(np.float32)
    jtr.sample = lambda key, x: (jnp.asarray(t), jnp.asarray(x0), x)
    ref = jtr.training_losses(lambda x, tt: 0.5 * x + tt[:, None, None, None],
                              jax.random.PRNGKey(0), jnp.asarray(x1))
    got = create_transport(path_type, prediction, loss_weight).training_losses(
        lambda x, tt: 0.5 * x + tt[:, None, None, None], torch.from_numpy(x1),
        t=torch.from_numpy(t), x0=torch.from_numpy(x0))
    for k in ("pred", "loss"):
        r = np.asarray(ref[k])
        np.testing.assert_allclose(got[k].numpy(), r, rtol=1e-6,
                                   atol=1e-6 * np.max(np.abs(r)))


TINY = ["model=zigzag8_b1_pe2", "data=synthetic", "data.batch_size=2",
        "model.params.depth=2", "model.params.embed_dim=32",
        "model.params.img_dim=8"]


def _train(tmp_path, *extra):
    return train_cli.main([*TINY, f"results_dir={tmp_path}", "device=cpu",
                           *extra])


def test_train_cli_checkpoints_and_resumes(tmp_path):
    res = _train(tmp_path, "data.train_steps=3", "ckpt_every=2",
                 "log_every=1", "sample_every=3", "ode.sampling_method=euler",
                 "ode.num_sampling_steps=3")
    ckdir = os.path.join(res["run_dir"], "checkpoints")
    assert sorted(os.listdir(ckdir)) == ["0000002.pt", "0000003.pt"]
    assert os.path.exists(os.path.join(res["run_dir"], "vis", "0000003.png"))
    assert [r["step"] for r in res["records"]] == [1, 2, 3]
    with open(os.path.join(res["run_dir"], "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    assert [r["step"] for r in logged] == [1, 2, 3]
    assert [r["loss"] for r in logged] == [r["loss"] for r in res["records"]]
    assert all(np.isfinite(r["loss"]) for r in res["records"])
    ck = torch.load(res["checkpoint"], weights_only=False)
    assert set(ck) == {"model", "ema", "opt", "args", "train_steps",
                       "best_fid"}
    assert ck["train_steps"] == 3 and ck["best_fid"] == float("inf")
    assert ck["args"]["model"]["params"]["depth"] == 2
    model = res["state"].model
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32  # master weights never cast
        torch.testing.assert_close(ck["model"][name], p.detach())

    # resume from the largest step: everything restored, two more steps
    res2 = _train(tmp_path, "data.train_steps=5", "ckpt_every=100",
                  "log_every=1")
    assert [r["step"] for r in res2["records"]] == [4, 5]
    assert sorted(os.listdir(ckdir))[-1] == "0000005.pt"
    opt_state = res2["state"].opt.state_dict()["state"]
    assert all(int(s["step"]) == 5 for s in opt_state.values())


def test_trainer_checkpoint_loads_into_the_sampler(tmp_path):
    res = _train(tmp_path, "data.train_steps=1")
    cfg = sample_cli.load_config(sample_cli.DEFAULT_CONFIG_DIR, "default",
                                 TINY)
    model = sample_cli.build_model(cfg, device="cpu")
    model.load_state_dict(sample_cli.load_state_dict(res["checkpoint"]),
                          strict=True)
    for name, p in res["state"].ema.named_parameters():
        torch.testing.assert_close(model.state_dict()[name], p.detach())
    out = sample_cli.main([f"ckpt={res['checkpoint']}", *TINY[:1],
                           *TINY[3:], "sample_mode=ODE",
                           "ode.sampling_method=euler",
                           "ode.num_sampling_steps=3", "num_fid_samples=2",
                           "offline_sample_local_bs=2",
                           f"sample_dir={tmp_path}", "device=cpu"])
    assert out["n_nonfinite"] == 0


def test_logging_utils_match_jax(tmp_path):
    """The image grid bit for bit, and the JSONL records field for field
    (the time stamps aside)."""
    from zigma_tpu.utils import logging_utils as jax_lu
    from zigma_tpu_torch.utils import logging_utils as lu

    x = np.random.default_rng(3).uniform(-1.2, 1.2, (5, 3, 6, 6))
    np.testing.assert_array_equal(lu.array_to_image_grid(x),
                                  jax_lu.array_to_image_grid(x))
    recs = []
    for mod, sub in ((lu, "port"), (jax_lu, "jax")):
        mlog = mod.MetricLogger(str(tmp_path / sub))
        mlog.log(3, loss=np.float32(0.5), steps_per_sec=2.0, note="x")
        mlog.close()
        with open(tmp_path / sub / "metrics.jsonl") as f:
            rec = json.loads(f.read())
        rec.pop("time")
        recs.append(rec)
    assert recs[0] == recs[1] == {"step": 3, "loss": 0.5,
                                  "steps_per_sec": 2.0, "note": "x"}


def test_train_cli_refuses_what_this_slice_lacks(tmp_path):
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="device=cpu"):
            train_cli.main([*TINY, f"results_dir={tmp_path}"])
    for extra in (["data=churches256"], ["data.sample_fid_n=8"],
                  ["parallel.fsdp=true"], ["parallel.tp=2"]):
        with pytest.raises(NotImplementedError, match="later slice"):
            _train(tmp_path, *extra)
    with pytest.raises(NotImplementedError, match="not ported"):
        _train(tmp_path, "chain_steps=4")
    # in-training sampling with the configured ODE method, the default
    # dopri5 included (fewer save points than the config's 250)
    res = _train(tmp_path, "data.train_steps=2", "sample_every=1",
                 "ode.num_sampling_steps=3")
    assert sorted(os.listdir(os.path.join(res["run_dir"], "vis"))) == [
        "0000001.png", "0000002.png"]
