"""Selective remat (``remat_policy``) in the port vs the JAX package's.

The same perturbed weights (``state_dict_from_jax``) and numpy inputs go
through the JAX ZigMa with ``use_checkpoint`` and each ``remat_policy``
and through the port's: the gradients of sum(out * w) agree within 1e-4
of each one's max |jax| (the model tests' tolerance: float32 summation
order), and equal the port's full-block remat exactly (a kept value is the
one the recompute would make).  On the CPU the plain scan counts its
calls: a training step runs it ``depth`` times under ``scan_out`` (the
registered K1 operator's outputs kept) and ``2 depth`` times under full
remat and ``dots``.  A Mamba-2 model keeps its SSD outputs under
``scan_out`` with full remat's gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zigma_tpu.models import ZigMa as JaxZigMa
from zigma_tpu_torch.convert import state_dict_from_jax
from zigma_tpu_torch.models import ZigMa
from zigma_tpu_torch.models.zigma import remat_policy_fn
from zigma_tpu_torch.ops.selective_scan import (selective_scan_bwd_ref,
                                                selective_scan_ref)
from zigma_tpu_torch.train import (LATENT_SCALE, TrainState,
                                   make_diffusion_loss_fn, train_step)
from zigma_tpu_torch.transport import create_transport

BASE = dict(in_channels=4, embed_dim=32, depth=2, img_dim=8, patch_size=1,
            scan_type="zigzagN8", use_pe=2, use_checkpoint=True)
SSM2 = dict(ssm_version=2, d_state=16, headdim=16)
POLICIES = ("scan_out", "dots", "scan_out+dots")


def _grads(model, x, t, w):
    (model(x, t) * w).sum().backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_grads_match_jax_and_full_remat(policy):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    t = rng.uniform(0.05, 0.95, (2,)).astype(np.float32)
    w = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    jmodel = JaxZigMa(**BASE, remat_policy=policy, scan_layers=False)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), x, t)
    params = jax.tree.map(
        lambda p: np.asarray(p, np.float32)
        + 0.02 * rng.standard_normal(p.shape).astype(np.float32), params)
    g_jax = jax.jit(jax.grad(lambda p: jnp.sum(jmodel.apply(p, x, t) * w)))(
        jax.tree.map(jnp.asarray, params))
    g_jax = state_dict_from_jax(jax.tree.map(np.array, g_jax))
    sd = state_dict_from_jax(params)
    xt, tt, wt = (torch.from_numpy(a) for a in (x, t, w))
    got = {}
    for pol in (policy, None):
        model = ZigMa(**BASE, remat_policy=pol, device="cpu")
        model.load_state_dict(sd)
        got[pol] = _grads(model, xt, tt, wt)
    for n, g in got[policy].items():
        ref = g_jax[n].numpy()
        assert np.max(np.abs(g.numpy() - ref)) <= 1e-4 * max(
            np.max(np.abs(ref)), 1e-8), n
        assert torch.equal(g, got[None][n]), n


@pytest.mark.parametrize("policy,calls", [(None, 2), ("scan_out", 1),
                                          ("dots", 2), ("scan_out+dots", 1)])
def test_scan_out_runs_the_plain_scan_once_a_block(policy, calls):
    """One training step: the plain forward runs ``calls`` x depth times,
    its adjoint depth times, whatever the policy."""
    g = torch.Generator().manual_seed(2)
    model = ZigMa(**BASE, remat_policy=policy, device="cpu", generator=g)
    state = TrainState.create(model)
    loss_fn = make_diffusion_loss_fn(model, create_transport(),
                                     latent_scale=LATENT_SCALE)
    batch = {"x": torch.randn(2, 4, 8, 8, generator=g)}
    selective_scan_ref.calls = selective_scan_bwd_ref.calls = 0
    train_step(state, loss_fn, batch, g)
    assert selective_scan_ref.calls == calls * BASE["depth"]
    assert selective_scan_bwd_ref.calls == BASE["depth"]


def test_scan_out_keeps_the_ssd_output_of_a_mamba2_block():
    """A Mamba-2 model under ``scan_out`` names each SSD output
    (``zigma::scan_out``) and its gradients are full remat's."""
    cfg = dict(BASE, ssm_cfg=SSM2)
    g = torch.Generator().manual_seed(4)
    x, t = torch.randn(2, 4, 8, 8, generator=g), torch.rand(2, generator=g)
    w = torch.randn(2, 4, 8, 8, generator=g)
    full = ZigMa(**cfg, device="cpu", generator=g)
    with torch.no_grad():  # off the DiT zero-init, so the mixers count
        for p in full.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=g))
    kept = ZigMa(**cfg, remat_policy="scan_out", device="cpu")
    kept.load_state_dict(full.state_dict())
    assert all(b.mixer.name_scan_out for b in kept.blocks)
    assert not any(b.mixer.name_scan_out for b in full.blocks)
    got, ref = _grads(kept, x, t, w), _grads(full, x, t, w)
    assert all(torch.equal(got[n], ref[n]) for n in ref)


def test_policy_names():
    with pytest.raises(ValueError, match="unknown remat_policy"):
        ZigMa(**BASE, remat_policy="everything", device="cpu")
    assert remat_policy_fn(None) is None
    # without use_checkpoint a policy does nothing, as in JAX
    plain = ZigMa(**dict(BASE, use_checkpoint=False), remat_policy="dots",
                  device="cpu")
    assert plain._remat_context is None
