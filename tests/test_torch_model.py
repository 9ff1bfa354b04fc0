"""Port ZigMa forward vs the JAX package's, with the weights carried over.

JAX params are perturbed first: under the DiT zero-init the adaLN gates
switch every mixer off and parity at init would not touch the Mamba path.
They then go through ``state_dict_from_jax`` into the port model, which
must (a) give the same forward on the same inputs -- fp32 max abs 1e-4,
float32 summation order being the only difference -- and (b) map back onto
the JAX tree through ``zigma_tpu.convert.convert_state_dict``, which pins
the reference state-dict names.  Both JAX param layouts are covered:
stacked ``blocks`` (scan over layers, the default at depth >= 8) and
per-layer ``blocks_{i}``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zigma_tpu.convert import convert_state_dict
from zigma_tpu.models import ZigMa as JaxZigMa
from zigma_tpu.utils.inference import cast_params_for_inference
from zigma_tpu_torch.convert import state_dict_from_jax
from zigma_tpu_torch.models import ZigMa
from zigma_tpu_torch.utils.inference import cast_for_inference

BASE = dict(in_channels=4, embed_dim=32, img_dim=8, patch_size=1, use_pe=2)


def _perturbed_params(model, x, t, y, seed=7):
    params = jax.jit(model.init)(jax.random.PRNGKey(0), x, t, y)
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: np.asarray(p, np.float32)
        + 0.02 * rng.standard_normal(p.shape).astype(np.float32), params)


def _inputs(num_classes=-1, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    t = rng.uniform(0.05, 0.95, (2,)).astype(np.float32)
    y = rng.integers(0, num_classes, (2,)) if num_classes > 0 else None
    return x, t, y


def _port(cfg, params, dtype=torch.float32):
    model = ZigMa(**BASE, **cfg, dtype=dtype, device="cpu")
    model.load_state_dict(state_dict_from_jax(params))
    return model


def _run_port(model, x, t, y):
    with torch.inference_mode():
        return model(torch.from_numpy(x), torch.from_numpy(t),
                     None if y is None else torch.from_numpy(y))


def _assert_same_tree(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for u, v in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


CASES = {
    # depth 8: the JAX model stacks its blocks (scan over layers)
    "stacked_depth8_zigzagN8": dict(depth=8, scan_type="zigzagN8"),
    # depth 2 per-layer blocks_{i}; the Pallas kernel in interpret mode
    "layers_depth2_zigzagN8_pallas": dict(depth=2, scan_type="zigzagN8",
                                          scan_layers=False,
                                          jax_backend="pallas"),
    # depth 2 per-layer, bidirectional v2 with class labels
    "layers_depth2_v2_class": dict(depth=2, scan_type="v2", scan_layers=False,
                                   num_classes=5),
}


@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_jax_and_names_round_trip(name):
    cfg = dict(CASES[name])
    scan_layers = cfg.pop("scan_layers", None)
    backend = cfg.pop("jax_backend", "auto")
    x, t, y = _inputs(cfg.get("num_classes", -1))
    jmodel = JaxZigMa(**BASE, **cfg, scan_layers=scan_layers,
                      scan_backend=backend)
    params = _perturbed_params(jmodel, x, t, y)
    assert ("blocks" in params["params"]) == (cfg["depth"] >= 8)
    ref = np.asarray(jax.jit(jmodel.apply)(params, x, t, y))

    model = _port(cfg, params)
    out = _run_port(model, x, t, y).numpy()
    assert out.shape == ref.shape == (2, 4, 8, 8)
    assert np.max(np.abs(out - ref)) <= 1e-4

    back = convert_state_dict(model.state_dict(),
                              scan_layers=jmodel.effective_scan_layers)
    _assert_same_tree(back, params)


def test_bf16_inference_cast_matches_jax():
    cfg = dict(depth=2, scan_type="zigzagN8")
    x, t, y = _inputs()
    jmodel = JaxZigMa(**BASE, **cfg, scan_layers=False, dtype=jnp.bfloat16)
    params = _perturbed_params(jmodel, x, t, y)
    jcast = cast_params_for_inference(jax.tree.map(jnp.asarray, params))
    ref = np.asarray(jax.jit(jmodel.apply)(jcast, x, t), np.float32)

    model = cast_for_inference(_port(cfg, params, torch.bfloat16))
    # the same leaves are cast on both sides: carry a 1/0 "was cast" mark
    # through the layout converter and read it back per port parameter
    mark = state_dict_from_jax(jax.tree.map(
        lambda p: np.full(p.shape, float(p.dtype == jnp.bfloat16), np.float32),
        jcast))
    n_cast = 0
    for pname, p in model.named_parameters():
        was_cast = bool(mark[pname].flatten()[0])
        assert p.dtype == (torch.bfloat16 if was_cast else torch.float32), pname
        n_cast += was_cast
    assert n_cast > 0

    out = _run_port(model, x, t, None)
    assert out.dtype == torch.bfloat16
    err = np.max(np.abs(out.float().numpy() - ref))
    # bf16 rounds at different places in the two frameworks
    assert err <= 5e-2 * np.max(np.abs(ref))


def test_later_slice_options_raise():
    """Selective remat still raises; text, use_pe 3 and Mamba-2 build now
    (held against JAX in test_torch_text.py and test_torch_ssd.py), and so
    do video models and the training label drop (test_torch_video.py)."""
    for kw in (dict(has_text=True, d_context=16), dict(use_pe=3),
               dict(ssm_cfg=dict(ssm_version=2, d_state=16, headdim=16))):
        model = ZigMa(**{**BASE, **kw}, depth=1, device="cpu")
        x = torch.zeros(2, 4, 8, 8)
        y = torch.zeros(2, 5, 16) if kw.get("has_text") else None
        assert model(x, torch.full((2,), 0.5), y).shape == (2, 4, 8, 8)
    with pytest.raises(NotImplementedError, match="later slice"):
        ZigMa(**BASE, depth=1, remat_policy="scan_out", device="cpu")
    video = ZigMa(**BASE, depth=1, video_frames=4, device="cpu")
    assert video.pos_embed.shape == (1, 4 * 64, 32)
    vx = torch.zeros(2, 4, 4, 8, 8)
    assert video(vx, torch.full((2,), 0.5)).shape == (2, 4, 4, 8, 8)
    # training runs (drop-path, remat), with the label drop
    model = ZigMa(**BASE, depth=1, scan_type="zigzagN8", use_checkpoint=True,
                  device="cpu")
    x, t, _ = _inputs()
    out = model(torch.from_numpy(x), torch.from_numpy(t), train=True,
                generator=torch.Generator().manual_seed(0))
    assert out.shape == (2, 4, 8, 8) and out.requires_grad
    model = ZigMa(**BASE, depth=1, num_classes=5, class_dropout_prob=0.1,
                  device="cpu")
    out = model(torch.from_numpy(x), torch.from_numpy(t),
                torch.zeros(2, dtype=torch.long), train=True,
                generator=torch.Generator().manual_seed(0))
    assert out.shape == (2, 4, 8, 8) and bool(torch.isfinite(out).all())
