"""Port ODE sampling vs the JAX Sampler, and the port's sample CLI.

Both samplers start from the same injected noise ``z`` (the frameworks'
random streams differ) and drive the same perturbed tiny ZigMa.  Tolerance:
fp32 max abs 1e-3 on the sample -- per-forward differences of ~1e-5 summed
over the steps.
"""

import os

import jax
import numpy as np
import pytest
import torch

from zigma_tpu.models import ZigMa as JaxZigMa
from zigma_tpu.transport import Sampler as JaxSampler
from zigma_tpu.transport import create_transport as jax_create_transport
from zigma_tpu_torch.cli import sample as sample_cli
from zigma_tpu_torch.convert import state_dict_from_jax
from zigma_tpu_torch.models import ZigMa
from zigma_tpu_torch.transport import Sampler, create_transport

CFG = dict(in_channels=4, embed_dim=32, depth=2, img_dim=8, patch_size=1,
           scan_type="zigzagN8", use_pe=2)


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(11)
    jmodel = JaxZigMa(**CFG, scan_layers=False)
    x = np.zeros((2, 4, 8, 8), np.float32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), x, np.zeros(2))
    params = jax.tree.map(
        lambda p: np.asarray(p, np.float32)
        + 0.02 * rng.standard_normal(p.shape).astype(np.float32), params)
    model = ZigMa(**CFG, device="cpu")
    model.load_state_dict(state_dict_from_jax(params))
    return jmodel, params, model


@pytest.mark.parametrize("method,steps", [("euler", 10), ("heun", 6)])
def test_ode_sample_matches_jax(models, method, steps):
    jmodel, params, model = models
    z = np.random.default_rng(5).standard_normal((2, 4, 8, 8)).astype(np.float32)
    jfn = JaxSampler(jax_create_transport()).sample_ode(
        sampling_method=method, num_steps=steps)
    ref = np.asarray(jax.jit(
        lambda z: jfn(z, lambda x, t: jmodel.apply(params, x, t))[-1])(z))
    fn = Sampler(create_transport()).sample_ode(sampling_method=method,
                                                num_steps=steps)
    with torch.inference_mode():
        traj = fn(torch.from_numpy(z), lambda x, t: model(x, t))
    assert traj.shape == (steps, 2, 4, 8, 8)
    assert traj.dtype == torch.float32
    assert np.max(np.abs(traj[-1].numpy() - ref)) <= 1e-3


def test_unported_samplers_raise():
    """dopri5 and the SDE sampler run now (held against JAX in
    test_torch_samplers.py); unknown methods raise at construction, as in
    the JAX sampler, and an SDE with no source of noise raises."""
    sampler = Sampler(create_transport())
    z = torch.zeros(2, 4, 2, 2)
    traj = sampler.sample_ode(sampling_method="dopri5", num_steps=3)(
        z, lambda x, t: -x)
    assert traj.shape == (3, 2, 4, 2, 2)
    sde = sampler.sample_sde(num_steps=3, diffusion_form="sigma")
    traj = sde(z, lambda x, t: -x, generator=torch.Generator().manual_seed(0))
    assert traj.shape == (3, 2, 4, 2, 2)
    with pytest.raises(ValueError, match="generator"):
        sde(z, lambda x, t: -x)
    with pytest.raises(NotImplementedError, match="unknown ODE"):
        sampler.sample_ode(sampling_method="rk4")
    with pytest.raises(NotImplementedError, match="unknown SDE"):
        sampler.sample_sde(sampling_method="Milstein")


def _overrides(tmp_path, ckpt):
    return [f"ckpt={ckpt}", "model.params.embed_dim=32",
            "model.params.depth=2", "model.params.img_dim=8",
            "sample_mode=ODE", "ode.sampling_method=euler",
            "ode.num_sampling_steps=3", "offline_sample_local_bs=2",
            "num_fid_samples=4", f"sample_dir={tmp_path}"]


def _write_ckpt(tmp_path):
    cfg = sample_cli.load_config(sample_cli.DEFAULT_CONFIG_DIR, "default",
                                 _overrides(tmp_path, "x")[1:4])
    model = sample_cli.build_model(cfg, device="cpu",
                                   generator=torch.Generator().manual_seed(0))
    path = os.path.join(tmp_path, "ckpt.pt")
    torch.save({"ema": {f"module.{k}": v for k, v in
                        model.state_dict().items()}}, path)
    return path


def test_sample_cli_writes_pngs_on_cpu(tmp_path):
    ckpt = _write_ckpt(tmp_path)
    res = sample_cli.main(_overrides(tmp_path, ckpt) + ["device=cpu"])
    pngs = sorted(f for f in os.listdir(res["out_dir"]) if f.endswith(".png"))
    assert pngs == [f"{i:06d}.png" for i in range(4)]
    assert len(res["batch_seconds"]) == 2
    assert res["n_nonfinite"] == 0
    from PIL import Image
    assert Image.open(os.path.join(res["out_dir"], pngs[0])).size == (8, 8)


def test_sample_cli_refuses_cpu_unless_asked(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="device=cpu"):
        sample_cli.main(_overrides(tmp_path, "unused.pt"))
    # metrics are ported: fvd on an image run raises before the checkpoint
    # is read
    with pytest.raises(ValueError, match="video run"):
        sample_cli.main(_overrides(tmp_path, "unused.pt")
                        + ["device=cpu", "sample_mode=SDE", "metrics=[fvd]"])
    # decoding is ported: the SD-VAE without local weights raises first
    monkeypatch.delenv("ZIGMA_VAE_WEIGHTS", raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    with pytest.raises(RuntimeError, match="not found locally"):
        sample_cli.main(_overrides(tmp_path, "unused.pt")
                        + ["device=cpu", "decode_latents=true",
                           "vae_kind=sd-vae"])
