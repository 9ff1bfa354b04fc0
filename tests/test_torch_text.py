"""Port text-conditioned ZigMa (cross-attention, use_pe 3) vs the JAX package.

The same numpy inputs (latents, times and (B, 77, d_context) caption
features from a seed) go through both packages, the weights through
``state_dict_from_jax`` after a 0.02 perturbation that opens every adaLN
gate (the mixer and the cross-attention are then on the path).  JAX runs
its sequential CPU scan.

Tolerances (fp32, summation order only): CrossAttention and the text block
within 1e-5 of max |jax|; model forwards within 1e-4 max abs (as
``tests/test_torch_model.py``); each parameter's gradient of a velocity
loss within 1e-4 of its max |jax|.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zigma_tpu.convert import convert_state_dict
from zigma_tpu.models import ZigMa as JaxZigMa
from zigma_tpu.models.zigma import CrossAttention as JaxCrossAttention
from zigma_tpu.models.zigma import ZigMaBlock as JaxZigMaBlock
from zigma_tpu_torch.cli import sample as sample_cli
from zigma_tpu_torch.cli import train as train_cli
from zigma_tpu_torch.convert import state_dict_from_jax
from zigma_tpu_torch.convert.from_jax import _block
from zigma_tpu_torch.models import CrossAttention, ZigMa, ZigMaBlock

TOL_MOD, TOL_FWD, TOL_GRAD = 1e-5, 1e-4, 1e-4
N_CTX, D_CTX = 77, 24  # 77 caption tokens, as CLIP gives: not a multiple of 8
BASE = dict(in_channels=4, embed_dim=32, img_dim=8, patch_size=1,
            has_text=True, d_context=D_CTX, n_context_token=N_CTX)
CASES = {
    # per-layer blocks_{i} and pos_embed_{i}
    "layers_pe3_zigzagN8": dict(depth=2, scan_type="zigzagN8", use_pe=3,
                                scan_layers=False),
    # scan over layers: the stacked blocks and (depth, 1, n_pe, E)
    # pos_embed_layers (scan_layers=True forces it for use_pe 3)
    "stacked_pe3_v2": dict(depth=2, scan_type="v2", use_pe=3,
                           scan_layers=True),
}


def _perturb(params, seed=7):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: np.asarray(p, np.float32)
        + 0.02 * rng.standard_normal(p.shape).astype(np.float32), params)


def _inputs(seed=3, batch=2):
    rng = np.random.default_rng(seed)
    x1, x0 = (rng.standard_normal((batch, 4, 8, 8)).astype(np.float32)
              for _ in "ab")
    t = rng.uniform(0.05, 0.95, (batch,)).astype(np.float32)
    y = rng.standard_normal((batch, N_CTX, D_CTX)).astype(np.float32)
    return x1, x0, t, y


def _velocity_loss(out, x0, x1):
    return ((out - (x1 - x0)) ** 2).mean()


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def jax_runs():
    """Per case: JAX model, perturbed params, inputs, forward and the loss
    gradients (by ``jax.grad``, as port names)."""
    out = {}
    for name, cfg in CASES.items():
        cfg = dict(cfg)
        jmodel = JaxZigMa(**BASE, **cfg, scan_backend="ref")
        x1, x0, t, y = _inputs()
        params = _perturb(jax.jit(jmodel.init)(jax.random.PRNGKey(0), x1, t, y))
        xt = t[:, None, None, None] * x1 + (1 - t[:, None, None, None]) * x0

        def loss(p):
            o = jmodel.apply(p, xt, t, y)
            return _velocity_loss(o, x0, x1), o

        (_, ref), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
        out[name] = (jmodel, params, (x1, x0, t, y, xt), np.asarray(ref),
                     state_dict_from_jax(jax.tree.map(np.array, grads)))
    return out


def _port(name, params, **kw):
    cfg = {k: v for k, v in CASES[name].items() if k != "scan_layers"}
    model = ZigMa(**BASE, **cfg, device="cpu", **kw)
    model.load_state_dict(state_dict_from_jax(params))
    return model


def test_cross_attention_matches_jax():
    """77 context tokens, 8 heads of 64 over a 32-wide query."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 32)).astype(np.float32)
    ctx = rng.standard_normal((2, N_CTX, 32)).astype(np.float32)
    jmod = JaxCrossAttention(query_dim=32, context_dim=32)
    params = _perturb(jax.jit(jmod.init)(jax.random.PRNGKey(1), x, ctx))
    ref = np.asarray(jax.jit(jmod.apply)(params, x, ctx))
    mod = CrossAttention(32, 32, device="cpu")
    p = params["params"]
    mod.load_state_dict({
        **{f"{n}.weight": _t(p[n]["kernel"].T) for n in ("to_q", "to_k", "to_v")},
        "to_out.0.weight": _t(p["to_out"]["kernel"].T),
        "to_out.0.bias": _t(p["to_out"]["bias"])})
    with torch.no_grad():
        got = mod(_t(x), _t(ctx)).numpy()
    assert mod.to_q.weight.shape == (512, 32) and mod.to_q.bias is None
    assert np.max(np.abs(got - ref)) <= TOL_MOD * np.max(np.abs(ref))
    with pytest.raises(ValueError, match="context_dim=32"):
        mod(_t(x), _t(ctx[..., :16]))


def test_text_block_matches_jax():
    """One text block (6-part adaLN, mixer, LayerNorm, cross-attention,
    gated residuals) on a residual stream, against the JAX block."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 32)).astype(np.float32)
    res = rng.standard_normal((2, 16, 32)).astype(np.float32)
    c = rng.standard_normal((2, 32)).astype(np.float32)
    text = rng.standard_normal((2, N_CTX, 32)).astype(np.float32)
    mixer_cfg = dict(scan_type="v2", scan_backend="ref")
    jblk = JaxZigMaBlock(dim=32, mixer_cfg=mixer_cfg, has_text=True)
    params = _perturb(jax.jit(jblk.init)(jax.random.PRNGKey(2), x, res, c,
                                         text))
    ref_x, ref_res = (np.asarray(a) for a in jax.jit(jblk.apply)(
        params, x, res, c, text))
    sd = {}
    _block(sd, "b", params["params"])
    blk = ZigMaBlock(32, mixer_cfg, has_text=True, device="cpu")
    blk.load_state_dict({k[2:]: v for k, v in sd.items()})
    assert blk.adaLN_modulation[1].weight.shape == (6 * 32, 32)
    with torch.no_grad():
        got_x, got_res = blk(_t(x), _t(res), _t(c), text=_t(text))
    assert np.max(np.abs(got_x.numpy() - ref_x)) <= TOL_MOD * np.max(np.abs(ref_x))
    np.testing.assert_allclose(got_res.numpy(), ref_res, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", list(CASES))
def test_text_model_forward_and_gradients_match_jax(name, jax_runs):
    jmodel, params, (x1, x0, t, y, xt), ref, gref = jax_runs[name]
    assert ("pos_embed_layers" in params["params"]) == jmodel.effective_scan_layers
    model = _port(name, params)
    model.zero_grad(set_to_none=True)
    out = model(_t(xt), _t(t), _t(y))
    _velocity_loss(out, _t(x0), _t(x1)).backward()
    assert out.shape == ref.shape == x1.shape
    assert np.max(np.abs(out.detach().numpy() - ref)) <= TOL_FWD
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(grads) == set(gref)
    assert "blocks.0.msa.to_q.weight" in grads and "pos_embed_layers.1" in grads
    for n, g in grads.items():
        r = gref[n].numpy()
        assert np.max(np.abs(g - r)) <= TOL_GRAD * max(np.max(np.abs(r)), 1e-8), n
    # the reference's msa names carry back to the JAX per-layer tree
    if not jmodel.effective_scan_layers:
        back = convert_state_dict(
            {k: v for k, v in model.state_dict().items()
             if not k.startswith("pos_embed_layers")}, scan_layers=False)
        for i in range(2):
            np.testing.assert_array_equal(
                back["params"][f"blocks_{i}"]["msa"]["to_out"]["kernel"],
                params["params"][f"blocks_{i}"]["msa"]["to_out"]["kernel"])


def test_text_forward_with_cfg_matches_jax(jax_runs):
    """Guidance against the default null features (zeros)."""
    name = "layers_pe3_zigzagN8"
    jmodel, params, (x1, x0, t, y, xt), _, _ = jax_runs[name]
    model = _port(name, params)
    ref = np.asarray(jax.jit(lambda p, a, b, c: jmodel.apply(
        p, a, b, c, 4.0, method=JaxZigMa.forward_with_cfg))(params, xt, t, y))
    with torch.inference_mode():
        got = model.forward_with_cfg(_t(xt), _t(t), _t(y), 4.0).numpy()
    assert got.shape == ref.shape == xt.shape
    assert np.max(np.abs(got - ref)) <= TOL_FWD


def test_use_pe3_tables_are_per_layer_and_zero_init():
    model = ZigMa(**BASE, depth=3, use_pe=3, device="cpu")
    names = [n for n, _ in model.named_parameters() if "pos_embed" in n]
    assert names == [f"pos_embed_layers.{i}" for i in range(3)]
    assert all(float(p.detach().abs().max()) == 0.0
               for p in model.pos_embed_layers)
    assert model.pos_embed_layers[0].shape == (1, 64, 32)
    with pytest.raises(ValueError, match="d_context"):
        ZigMa(**{**BASE, "d_context": 0}, depth=1, device="cpu")


TEXT_TINY = ["model=zigzag8_b1_pe2", "data=synthetic", "data.has_text=true",
             f"data.d_context={D_CTX}", "data.n_context_token=5",
             "model.params.depth=2", "model.params.embed_dim=32",
             "model.params.img_dim=8", "model.params.use_pe=3"]


def test_text_train_and_sample_clis(tmp_path):
    """cli.train 2 steps on synthetic caption features (the JAX trainer's
    draws), then cli.sample one guided batch with null features."""
    res = train_cli.main([*TEXT_TINY, "data.batch_size=2",
                          "data.train_steps=2", "log_every=1",
                          f"results_dir={tmp_path}", "device=cpu"])
    assert [r["step"] for r in res["records"]] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in res["records"])
    model = res["state"].model
    assert model.has_text and model.y_embedder.weight.shape == (32, D_CTX)
    out = sample_cli.main([
        f"ckpt={res['checkpoint']}", *TEXT_TINY, "cfg_scale=4",
        "sample_mode=ODE", "ode.sampling_method=euler",
        "ode.num_sampling_steps=3", "num_fid_samples=2",
        "offline_sample_local_bs=2", f"sample_dir={tmp_path}", "device=cpu"])
    assert out["n_nonfinite"] == 0 and out["model_calls"] == [2]
    assert sorted(os.listdir(out["out_dir"])) == ["000000.png", "000001.png"]


def test_synthetic_text_batches_match_jax():
    from zigma_tpu.cli.train import synthetic_batches as jax_batches
    from zigma_tpu_torch.config import load_config

    cfg = load_config(sample_cli.DEFAULT_CONFIG_DIR, "default",
                      TEXT_TINY + ["data.batch_size=3"])
    got, ref = next(train_cli.synthetic_batches(cfg, 4)), next(
        jax_batches(cfg, None, 4))
    assert got["y"].shape == (3, 5, D_CTX)
    for k in ("x", "y"):
        np.testing.assert_array_equal(got[k], ref[k])
