"""The port's SD-VAE (``data/sd_vae.py``) and latent codec against the JAX
package's ``data/vae_jax.py``.

Weights: ``vae_jax.random_params(scale=4)`` (channels 32-128, every block of
the real net) through ``convert.vae_state_dict_from_jax``.  On 2 x 3 x 32 x
32 images the posterior mean, the decode and a posterior sample with the
JAX noise injected must agree within 1e-4 of max |JAX output|: the two run
the same fp32 convolutions in another summation order (measured ~1e-6).
"""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from zigma_tpu.data import vae_jax as vj
from zigma_tpu_torch.cli import sample as sample_cli
from zigma_tpu_torch.convert import vae_state_dict_from_jax
from zigma_tpu_torch.data import (IdentityCodec, VAECodec, decode_maybe_video,
                                  get_codec)
from zigma_tpu_torch.data.sd_vae import AutoencoderKL, normalize_state_dict
from zigma_tpu_torch.data.weights import WeightsNotFound

TOL = 1e-4  # of max |JAX output|


@pytest.fixture(scope="module")
def nets():
    params = vj.random_params(seed=0, scale=4)
    sd = vae_state_dict_from_jax(jax.tree.map(np.asarray, params))
    x = np.random.default_rng(1).uniform(-1, 1, (2, 3, 32, 32)).astype(
        np.float32)
    key = jax.random.PRNGKey(3)
    ref = {"mean": np.asarray(vj.vae_encode(params, jnp.asarray(x))),
           "sample": np.asarray(vj.vae_encode(params, jnp.asarray(x),
                                              rng=key)),
           # the noise vae_encode draws from that key, NHWC -> NCHW
           "noise": np.transpose(np.asarray(
               jax.random.normal(key, (2, 4, 4, 4))), (0, 3, 1, 2))}
    ref["decode"] = np.asarray(vj.vae_decode(params, jnp.asarray(ref["mean"])))
    return params, sd, x, ref


def _close(got, ref, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= tol, err


def test_encode_decode_match_jax(nets):
    _, sd, x, ref = nets
    model = AutoencoderKL.from_state_dict(sd)
    with torch.no_grad():
        mean, logvar = model.encode(torch.from_numpy(x))
        _close(mean, ref["mean"])
        assert logvar.shape == (2, 4, 4, 4)
        sample = model.sample(mean, logvar, torch.from_numpy(
            np.ascontiguousarray(ref["noise"])))
        _close(sample, ref["sample"])
        _close(model.decode(torch.from_numpy(ref["mean"])), ref["decode"])
    assert ref["decode"].shape == (2, 3, 32, 32)


def test_downsample_pads_right_and_bottom(nets):
    """diffusers' (0, 1) pad then a stride-2 conv: with a symmetric pad the
    shapes still fit and only the numbers differ."""
    params, sd, _, _ = nets
    model = AutoencoderKL.from_state_dict(sd)
    p = params["encoder"]["down0_conv"]
    x = np.random.default_rng(2).standard_normal((1, 8, 8, 32)).astype(
        np.float32)
    want = np.asarray(vj._conv(jnp.asarray(x), p, stride=2,
                               pad=[(0, 1), (0, 1)]))
    down = model.encoder.down_blocks[0].downsamplers[0]
    with torch.no_grad():
        got = down(torch.from_numpy(np.ascontiguousarray(
            np.transpose(x, (0, 3, 1, 2)))))
        sym = F.conv2d(torch.from_numpy(np.ascontiguousarray(
            np.transpose(x, (0, 3, 1, 2)))), down.conv.weight, down.conv.bias,
            stride=2, padding=1)
    _close(got, np.transpose(want, (0, 3, 1, 2)), 1e-5)
    assert sym.shape == got.shape and not torch.allclose(sym, got)


@pytest.mark.parametrize("layout", ["newer", "older"])
def test_both_attention_layouts_load_strictly(nets, layout):
    """to_q/to_k/to_v/to_out.0 Linear weights, or query/key/value/proj_attn
    as 1x1 convs (diffusers < 0.15): the same model either way."""
    _, sd, x, ref = nets
    if layout == "older":
        names = {"to_q": "query", "to_k": "key", "to_v": "value",
                 "to_out.0": "proj_attn"}
        old = {}
        for k, v in sd.items():
            for new, o in names.items():
                if f".attentions.0.{new}." in k:
                    k = k.replace(f".{new}.", f".{o}.")
                    if v.ndim == 2:
                        v = v[:, :, None, None]
            old[k] = v
        assert any(".proj_attn.weight" in k for k in old)
        sd = old
    model = AutoencoderKL(scale=4)
    model.load_state_dict(normalize_state_dict(sd), strict=True)
    with torch.no_grad():
        _close(model.decode(torch.from_numpy(ref["mean"])), ref["decode"])
    with pytest.raises(RuntimeError, match="Missing key"):
        AutoencoderKL(scale=4).load_state_dict(
            {k: v for k, v in normalize_state_dict(sd).items()
             if "attentions" not in k}, strict=True)


@pytest.fixture
def weights(tmp_path, monkeypatch, nets):
    """A diffusers-layout weights file named by ZIGMA_VAE_WEIGHTS."""
    path = str(tmp_path / "vae.pt")
    torch.save(nets[1], path)
    monkeypatch.setenv("ZIGMA_VAE_WEIGHTS", path)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    return path


def test_codec(weights, nets, monkeypatch, caplog):
    _, _, x, ref = nets
    codec = get_codec("sd-vae", device="cpu")
    assert isinstance(codec, VAECodec) and codec.weights_path == weights
    z1 = codec.encode(x)  # a posterior sample: mean + std * noise
    z2 = get_codec("sd-vae", device="cpu").encode(x)  # same seed, same draw
    np.testing.assert_array_equal(z1, z2)
    assert np.abs(z1 - ref["mean"]).max() > 1e-3
    mean = VAECodec(sample_posterior=False, device="cpu").encode(x)
    _close(mean, ref["mean"])
    dec = codec.decode(torch.from_numpy(ref["mean"]))
    _close(dec, np.clip(ref["decode"], -1, 1))
    assert dec.dtype == np.float32 and np.abs(dec).max() <= 1.0
    video = np.stack([ref["mean"], ref["mean"][::-1]])  # (B=2, T=2, 4, 4, 4)
    frames = decode_maybe_video(codec, video)
    assert frames.shape == (2, 2, 3, 32, 32)
    np.testing.assert_allclose(frames[1, 1], dec[0], rtol=0, atol=1e-6)
    assert isinstance(get_codec("identity"), IdentityCodec)
    with pytest.raises(ValueError, match="unknown codec"):
        get_codec("vq")

    monkeypatch.delenv("ZIGMA_VAE_WEIGHTS")
    with pytest.raises(WeightsNotFound, match="nothing is downloaded"):
        get_codec("sd-vae", device="cpu")
    # the CLIs' logger does not propagate (create_logger): listen on it
    zlog = logging.getLogger("zigma_torch")
    zlog.addHandler(caplog.handler)
    try:
        assert isinstance(get_codec("auto", device="cpu"), IdentityCodec)
    finally:
        zlog.removeHandler(caplog.handler)
    assert "falling back to IdentityCodec" in caplog.text
    # the hub cache layout is searched too
    snap = os.path.join(os.environ["HF_HOME"], "hub",
                        "models--stabilityai--sd-vae-ft-ema", "snapshots", "a")
    os.makedirs(snap)
    torch.save(nets[1], os.path.join(snap, "diffusion_pytorch_model.bin"))
    assert get_codec("sd-vae", device="cpu").weights_path.startswith(snap)


TINY = ["model.params.embed_dim=32", "model.params.depth=2",
        "model.params.img_dim=8", "model.params.patch_size=2"]


def test_sample_cli_writes_decoded_pngs(tmp_path, weights, monkeypatch):
    """``decode_latents=true vae_kind=sd-vae``: 8x8 latents become 64x64
    RGB PNGs; without weights the CLI raises before sampling."""
    from PIL import Image

    cfg = sample_cli.load_config(sample_cli.DEFAULT_CONFIG_DIR, "default",
                                 TINY)
    model = sample_cli.build_model(cfg, device="cpu",
                                   generator=torch.Generator().manual_seed(0))
    ckpt = str(tmp_path / "ckpt.pt")
    torch.save({"ema": model.state_dict()}, ckpt)
    args = [f"ckpt={ckpt}", *TINY, "decode_latents=true", "vae_kind=sd-vae",
            "sample_mode=ODE", "ode.sampling_method=euler",
            "ode.num_sampling_steps=3", "num_fid_samples=4",
            "offline_sample_local_bs=2", f"sample_dir={tmp_path}",
            "device=cpu"]
    res = sample_cli.main(args)
    pngs = sorted(f for f in os.listdir(res["out_dir"]) if f.endswith(".png"))
    assert pngs == [f"{i:06d}.png" for i in range(4)]
    img = Image.open(os.path.join(res["out_dir"], pngs[0]))
    assert img.size == (64, 64) and img.mode == "RGB"
    assert len(res["decode_seconds"]) == 2 and res["n_nonfinite"] == 0
    monkeypatch.delenv("ZIGMA_VAE_WEIGHTS")
    with pytest.raises(RuntimeError, match="not found locally"):
        sample_cli.main(args)
