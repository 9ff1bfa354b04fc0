"""The port's chained training (``chain_steps``) against its own plain
steps and against the JAX package's chained step.

On the CPU a chain is ``train_chain``: N eager ``train_step`` calls on N
batches, so a chained run takes the plain run's batches, draws and
arithmetic; params and EMA are expected bit-equal (the JAX tests allow 1e-6
for XLA's reassociation inside one jitted scan).  The periodic actions fire
at the first chain boundary at or after each multiple of their cadence, as
the JAX trainer's ``crossed``: the same arguments give the JAX run's logged
steps.  Across packages, 3 steps of ``train_chain`` replay the draws of
``zigma_tpu.train.create_chained_train_step(n_steps=3)`` (recorded from
the jitted scan, as ``test_torch_train.py`` records one step's) on the same
perturbed weights and batches, at EMA decay 0.9 so that the EMA moves far
above its rounding: params within 1e-6 absolute, loss and grad_norm 1e-5
relative, the one-step test's tolerances; the EMA within 1e-6 or, where
larger, 3 fp32 ulps of its largest |value| (the dt biases, about -7 to -2,
take that to 1.43e-6), and its change within a tenth of the reference's
change, so that a missing or wrong EMA update fails.  The ulps are the
rounding of the EMA update, shown on its own by
``test_ema_update_rounding_of_both_packages``: XLA and torch's foreach
ops each land within 1.5 ulp of the float64 update and round one ulp apart
on some 20% of the values, so 3 updates may leave them 3 ulps apart.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import CFG, _port_model, _Recorder
from zigma_tpu.cli.train import main as jax_main
from zigma_tpu.models import ZigMa as JaxZigMa
from zigma_tpu.train import TrainState as JaxTrainState
from zigma_tpu.train import create_chained_train_step
from zigma_tpu.train import create_optimizer as jax_create_optimizer
from zigma_tpu.train import make_diffusion_loss_fn as jax_loss_fn
from zigma_tpu.transport import create_transport as jax_create_transport
from zigma_tpu_torch.cli import train as train_cli
from zigma_tpu_torch.convert import state_dict_from_jax
from zigma_tpu_torch.train import (LATENT_SCALE, TrainState,
                                   make_diffusion_loss_fn, train_chain)
from zigma_tpu_torch.transport import create_transport

# tests/test_chained_train.py's tiny config
TINY = ["data=synthetic", "data.batch_size=8", "model.params.embed_dim=32",
        "model.params.depth=2", "model.params.img_dim=8",
        "model.params.patch_size=2", "model.params.scan_type=zigzagN2",
        "mixed_precision=fp32", "ckpt_every=1000000", "sample_every=1000000"]
# the cross-package test's EMA decay: the EMA moves far above its rounding
EMA_DECAY = 0.9


def _run(tmp_path, chain, steps, *extra):
    return train_cli.main(TINY + [
        f"data.train_steps={steps}", f"chain_steps={chain}",
        f"results_dir={tmp_path / f'c{chain}_s{steps}'}", "log_every=2",
        "device=cpu", *extra])


def _max_delta(a, b):
    return max(float((p - q).detach().abs().max())
               for p, q in zip(a.parameters(), b.parameters()))


def _logged_steps(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [r["step"] for r in map(json.loads, f) if "loss" in r]


class TestChainedEquivalence:
    def test_chained_matches_plain_final_state(self, tmp_path):
        """4 steps as 2 chains of 2 against 4 plain steps."""
        s1, s2 = _run(tmp_path, 1, 4), _run(tmp_path, 2, 4)
        assert s1["state"].step == s2["state"].step == 4
        assert s2["chain"] is None  # the CPU's chain is train_chain
        for which in ("model", "ema"):
            assert _max_delta(getattr(s1["state"], which),
                              getattr(s2["state"], which)) == 0.0, which
        assert [r["loss"] for r in s1["records"]] == [
            r["loss"] for r in s2["records"]]
        assert torch.equal(s1["generator"].get_state(),
                           s2["generator"].get_state())

    def test_tail_shorter_than_chain(self, tmp_path):
        """5 steps with chain 2: 2 + 2 chained and a plain tail of 1."""
        s1, s2 = _run(tmp_path, 1, 5), _run(tmp_path, 2, 5)
        assert s2["state"].step == 5
        assert _max_delta(s1["state"].model, s2["state"].model) == 0.0
        ck = torch.load(s2["checkpoint"], weights_only=False)
        assert ck["train_steps"] == 5

    def test_periodic_actions_fire_at_chain_boundaries(self, tmp_path):
        """log_every=3 with chain 2 logs at steps 4 and 6 (the first
        boundaries at or after 3 and 6), as the JAX run of the same
        arguments does."""
        args = TINY + ["data.train_steps=6", "chain_steps=2", "log_every=3"]
        res = train_cli.main(args + [f"results_dir={tmp_path / 'port'}",
                                     "device=cpu"])
        jax_main(args + [f"results_dir={tmp_path / 'jax'}"])
        (jax_run,) = os.listdir(tmp_path / "jax")
        jax_steps = _logged_steps(tmp_path / "jax" / jax_run)
        assert jax_steps == [4, 6]
        assert [r["step"] for r in res["records"]] == jax_steps
        assert _logged_steps(res["run_dir"]) == jax_steps

    def test_bad_chain_steps_raises(self, tmp_path):
        with pytest.raises(ValueError, match="chain_steps"):
            _run(tmp_path, 0, 2)


def test_train_chain_matches_jax_chained_step():
    """3 steps of ``train_chain`` against one dispatch of JAX's
    ``create_chained_train_step(n_steps=3)``, the JAX draws of every step
    ((t, x0) and the drop-path masks) replayed in the port.  The EMA decay
    is 0.9 so that the EMA moves by some 1e-5 in 3 steps, far above its
    rounding: the port's change of each EMA leaf (from the weights both
    start with) within 5% of the reference's change, as well as the 3-ulp
    bound, so a missing or wrong EMA update fails (at the trainer's 0.9999
    the EMA moves about 1e-8, below one ulp)."""
    rng = np.random.default_rng(21)
    jmodel = JaxZigMa(**CFG, scan_layers=False)
    x = np.zeros((4, 4, 8, 8), np.float32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), x, np.zeros(4))
    params = jax.tree.map(
        lambda p: np.asarray(p, np.float32)
        + 0.02 * rng.standard_normal(p.shape).astype(np.float32), params)
    batches = [{"x": rng.standard_normal((4, 4, 8, 8)).astype(np.float32)}
               for _ in range(3)]
    stacked = {"x": jnp.asarray(np.stack([b["x"] for b in batches]))}
    opt = jax_create_optimizer(lr=1e-4)
    with pytest.MonkeyPatch.context() as mp:
        rec = _Recorder(mp)
        chained = create_chained_train_step(
            jax_loss_fn(jmodel, jax_create_transport(),
                        latent_scale=LATENT_SCALE), opt,
            ema_decay=EMA_DECAY, n_steps=3)
        for k in range(11, 60):  # the first keys whose masks drop a sample
            rec.draws.clear()
            rec.masks.clear()
            jstate, jmetrics = chained(
                JaxTrainState.create(jax.tree.map(jnp.asarray, params), opt),
                jax.random.split(jax.random.PRNGKey(k), 3), stacked)
            jax.effects_barrier()
            if any(not m.all() for _, m in rec.masks):
                break
        assert len(rec.draws) == 3
        assert len(rec.masks) == 3 * (CFG["depth"] + 1)
        assert any(not m.all() for _, m in rec.masks)
        rec._replay = list(rec.masks)
        model = _port_model(params)
        state = TrainState.create(model)
        metrics = train_chain(
            state, make_diffusion_loss_fn(model, create_transport(),
                                          latent_scale=LATENT_SCALE),
            [{"x": torch.from_numpy(b["x"])} for b in batches],
            ema_decay=EMA_DECAY,
            loss_kws=[{"t": torch.from_numpy(t), "x0": torch.from_numpy(x0)}
                      for t, x0 in rec.draws])
        assert rec._replay == []  # every JAX mask was used, in order
    assert state.step == 3 and int(jstate.step) == 3
    for key in ("loss", "grad_norm"):
        ref = float(jmetrics[key][-1])
        assert abs(metrics[key].item() - ref) <= 1e-5 * ref, key
    start = state_dict_from_jax(jax.tree.map(np.array, params))
    for which, tree, mod in (("params", jstate.params, state.model),
                             ("ema", jstate.ema_params, state.ema)):
        ref = state_dict_from_jax(jax.tree.map(np.array, tree))
        for n, p in mod.named_parameters():
            r = ref[n].numpy()
            err = np.max(np.abs(p.detach().numpy() - r))
            if which == "params":
                assert err <= 1e-6, (which, n, err)
                continue
            moved = np.max(np.abs(r - start[n].numpy()))
            tol = max(1e-6, 3 * float(np.spacing(np.max(np.abs(r)))))
            assert err <= tol and err <= 0.1 * moved, (which, n, err, moved)


@pytest.mark.parametrize("decay", [0.9, 0.9999])
def test_ema_update_rounding_of_both_packages(decay):
    """The cause of the EMA's 3-ulp bound above: one EMA update of the same
    fp32 values near the dt biases' (-7 to -2), by the JAX package's
    ``update_ema`` under jit and by the port's foreach ops.  Each lands
    within 1.5 ulp of the float64 update and the two at most one ulp apart,
    but they round differently on some 20% of the values (XLA rounds
    ``e * decay + (1 - decay) * p`` once more or less than a multiply
    then an add), so 3 updates may leave them up to 3 ulps apart."""
    from torch import nn

    from zigma_tpu.train.state import update_ema as jax_update_ema
    from zigma_tpu_torch.train import update_ema
    rng = np.random.default_rng(3)
    e = rng.uniform(-7, -2, 100_000).astype(np.float32)
    p = (e + 1e-4 * rng.standard_normal(e.shape)).astype(np.float32)
    jax_new = np.asarray(jax.jit(
        lambda a, b: jax_update_ema(a, b, decay))(e, p), np.float64)
    ema, model = nn.Module(), nn.Module()
    ema.w = nn.Parameter(torch.from_numpy(e.copy()), requires_grad=False)
    model.w = nn.Parameter(torch.from_numpy(p))
    update_ema(ema, model, decay)
    port_new = ema.w.detach().numpy().astype(np.float64)
    truth = e.astype(np.float64) * decay + (1 - decay) * p.astype(np.float64)
    ulp = np.spacing(np.abs(truth).astype(np.float32)).astype(np.float64)
    assert np.max(np.abs(jax_new - truth) / ulp) <= 1.5
    assert np.max(np.abs(port_new - truth) / ulp) <= 1.5
    apart = np.abs(jax_new - port_new) / ulp
    assert np.max(apart) <= 1.0 and 0.05 < np.mean(apart > 0) < 0.5


def test_captured_chain_refuses_what_it_cannot_capture():
    """``CapturedChain`` needs one process, a model on a card, a CUDA step
    generator and a capturable AdamW: each refusal names what is missing
    (on the card see tests/test_torch_cuda.py)."""
    from zigma_tpu_torch.models import ZigMa
    from zigma_tpu_torch.train import CapturedChain

    model = ZigMa(**CFG, device="cpu")
    state = TrainState.create(model)
    loss_fn = make_diffusion_loss_fn(model, create_transport())
    with pytest.raises(ValueError, match="n_steps"):
        CapturedChain(state, loss_fn, 0, torch.Generator())
    with pytest.raises(ValueError, match="CUDA card"):
        CapturedChain(state, loss_fn, 2, torch.Generator())
    state.layout = object()
    with pytest.raises(ValueError, match="parallel layout"):
        CapturedChain(state, loss_fn, 2, torch.Generator())
