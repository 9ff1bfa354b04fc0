"""ZigMa's scan arguments and the conditioned FinalLayer in the port
against the JAX package, weights carried by ``from_jax``.

- a tiny ``ZigMa(scan_backend="chunked", scan_chunk=16)`` on both sides:
  the output, and the gradients of every parameter and of the input;
- ``FinalLayer(cond=True)`` (the adaLN perturbed off its zero init)
  against JAX's, through ``from_jax``; a state dict with
  ``final_layer.adaLN_modulation.1.*`` through
  ``zigma_tpu.convert.convert_state_dict`` and back;
- ``scan_layers`` refused with the reason, ``zigma_model`` over the
  presets.

Tolerances: outputs fp32 max abs 1e-4 (TOL), float32 summation order being
the only difference; gradients max abs over max |JAX| at most 1e-4
(REL_MODEL: two stacked fp32 layers' roundings).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zigma_tpu.convert import convert_state_dict
from zigma_tpu.models import ZigMa as JaxZigMa
from zigma_tpu.models.zigma import FinalLayer as JaxFinalLayer
from zigma_tpu.models.zigma import ZIGMA_PRESETS as JAX_PRESETS
from zigma_tpu_torch.convert import state_dict_from_jax
from zigma_tpu_torch.models import FinalLayer, ZigMa, zigma_model
from zigma_tpu_torch.ops.scan_chunked import selective_scan_chunked

TOL = 1e-4
REL_MODEL = 1e-4


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _close(name, got, ref, rel=None):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    err = np.max(np.abs(got - ref))
    limit = TOL if rel is None else rel * max(np.max(np.abs(ref)), 1e-30)
    assert err <= limit, (name, err, limit)


def _perturb(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: np.asarray(p, np.float32)
        + 0.02 * rng.standard_normal(p.shape).astype(np.float32), tree)


def test_chunked_zigma_matches_jax_forward_and_gradients():
    """A tiny ZigMa through the chunked backend (chunks of 16 over 64
    tokens) on both sides, weights carried by ``from_jax``: the output and
    the gradients of every parameter and of the input."""
    cfg = dict(in_channels=4, embed_dim=32, depth=2, img_dim=8, patch_size=1,
               scan_type="zigzagN8", use_pe=2, scan_backend="chunked",
               scan_chunk=16)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    t = rng.uniform(0.05, 0.95, (2,)).astype(np.float32)
    g = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    jmodel = JaxZigMa(**cfg, scan_layers=False)
    params = _perturb(jax.jit(jmodel.init)(jax.random.PRNGKey(0), x, t), 9)

    def loss(p, xx):
        return jnp.sum(jmodel.apply(p, xx, t) * g)

    out_j = jax.jit(jmodel.apply)(params, x, t)
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, x)

    model = ZigMa(**cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params))
    calls = selective_scan_chunked.calls
    xt = _t(x, grad=True)
    out = model(xt, _t(t))
    assert selective_scan_chunked.calls == calls + 2  # one scan a layer
    _close("out", out, out_j)
    (out * _t(g)).sum().backward()
    _close("dx", xt.grad, gx, REL_MODEL)
    want = state_dict_from_jax(jax.tree.map(np.asarray, gp))
    for name, p in model.named_parameters():
        _close(f"d {name}", p.grad, want[name].numpy(), REL_MODEL)


def test_conditioned_final_layer_through_from_jax():
    """``FinalLayer(cond=True)`` against JAX's with the adaLN perturbed off
    its zero init, through ``from_jax`` (``final_layer/adaLN`` ->
    ``final_layer.adaLN_modulation.1``); a ZigMa state dict holding that
    entry goes through ``zigma_tpu.convert.convert_state_dict`` and back
    unchanged."""
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 64, 32)).astype(np.float32)
    c = rng.standard_normal((2, 32)).astype(np.float32)
    jlayer = JaxFinalLayer(patch_size=2, out_channels=4, cond=True)
    p = _perturb(jax.jit(jlayer.init)(jax.random.PRNGKey(1), x, c), 11)
    ref = jax.jit(jlayer.apply)(p, x, c)

    # the layer's tree as a ZigMa's final_layer
    jmodel = JaxZigMa(in_channels=4, embed_dim=32, depth=1, img_dim=8,
                      patch_size=2, scan_type="v1", scan_layers=False)
    xi = np.zeros((1, 4, 8, 8), np.float32)
    tree = jax.tree.map(np.asarray,
                        jax.jit(jmodel.init)(jax.random.PRNGKey(2), xi,
                                             np.zeros((1,), np.float32)))
    tree["params"]["final_layer"] = p["params"]
    sd = state_dict_from_jax(tree)
    layer = FinalLayer(32, 2, 4, cond=True, device="cpu")
    layer.load_state_dict({k[len("final_layer."):]: v for k, v in sd.items()
                           if k.startswith("final_layer.")})
    with torch.no_grad():
        _close("out", layer(_t(x), _t(c)), ref)
        # without c (as ZigMa calls it) the adaLN is skipped, as in JAX
        _close("uncond", layer(_t(x)), jlayer.apply(p, x))

    back = convert_state_dict(sd)
    assert set(back["params"]["final_layer"]) == {"linear", "adaLN"}
    sd2 = state_dict_from_jax(back)
    assert sd2.keys() == sd.keys()
    for k in sd:
        assert torch.equal(sd2[k], sd[k]), k


def test_scan_layers_refused_and_presets():
    """``scan_layers=True`` (nn.scan over the blocks, a TPU workaround) is
    refused with the reason; False is the port's own per-layer layout.
    ``zigma_model`` builds the JAX package's presets."""
    kw = dict(in_channels=4, embed_dim=32, depth=1, img_dim=8)
    with pytest.raises(NotImplementedError, match="TPU compile-size"):
        ZigMa(**kw, scan_layers=True)
    assert len(ZigMa(**kw, scan_layers=False).blocks) == 1
    from zigma_tpu_torch.models.zigma import ZIGMA_PRESETS
    assert ZIGMA_PRESETS == JAX_PRESETS
    with torch.device("meta"):
        m = zigma_model("zigma_s_4", in_channels=4, img_dim=32,
                        scan_backend="chunked", scan_chunk=32)
    assert (m.embed_dim, m.depth, m.patch_size) == (368, 24, 4)
    mixer = m.blocks[0].mixer
    assert (mixer.scan_backend, mixer.scan_chunk) == ("chunked", 32)
