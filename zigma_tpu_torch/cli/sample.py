"""Sampling entry point: ``python -m zigma_tpu_torch.cli.sample ckpt=... [k=v ...]``

Counterpart of ``zigma_tpu/cli/sample.py`` for the serving slice: loads a
reference ``.pt`` checkpoint (``{"ema"|"model": state_dict}`` or a bare state
dict, ``module.`` prefixes stripped) straight into the port's ZigMa, applies
the bf16 inference cast, draws ``num_fid_samples`` samples by fixed-step ODE
(euler or heun) in batches of ``offline_sample_local_bs`` and writes PNGs of
the first three latent channels with the JAX package's uint8 rule.

Runs on CUDA unless ``device=cpu`` is given; asking for CUDA on a machine
without it raises.  The SDE sampler, likelihood, dopri5, classifier-free
guidance (``cfg_scale != 1``), VAE decoding and metrics are later slices of
the port and raise ``NotImplementedError``.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from zigma_tpu_torch.config import Config, load_config
from zigma_tpu_torch.device import resolve_device
from zigma_tpu_torch.models import ZigMa
from zigma_tpu_torch.train.state import LATENT_SCALE
from zigma_tpu_torch.transport import Sampler, create_transport
from zigma_tpu_torch.utils.inference import cast_for_inference

__all__ = ["DEFAULT_CONFIG_DIR", "LATENT_SCALE", "build_model",
           "load_state_dict", "to_uint8_images", "main"]

DEFAULT_CONFIG_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "configs")


def to_uint8_images(arr: np.ndarray) -> np.ndarray:
    """[-1, 1] float images -> uint8 [0, 255] (own copy of
    ``zigma_tpu.metrics.facade.to_uint8_images``)."""
    return np.clip(127.5 * np.asarray(arr, np.float32) + 128.0,
                   0, 255).astype(np.uint8)


def build_model(cfg: Config, device=None,
                generator: torch.Generator = None) -> ZigMa:
    """ZigMa from config; conditioning flags come from the data group and
    the compute dtype from ``mixed_precision``, as in the JAX package's CLI."""
    params = dict(cfg.model.params)
    data = cfg.data
    if data.get("has_text"):
        params.setdefault("has_text", True)
    if data.get("num_classes", -1) > 0:
        params.setdefault("num_classes", data["num_classes"])
    if data.get("video_frames", 0) > 0:
        params.setdefault("video_frames", data["video_frames"])
    if cfg.get("mixed_precision") == "bf16":
        params.setdefault("dtype", torch.bfloat16)
    return ZigMa(**params, device=device, generator=generator)


def load_state_dict(path: str) -> dict:
    """The EMA (else model) state dict of a reference ``.pt`` checkpoint,
    with DDP ``module.`` prefixes stripped.  The file is unpickled in full
    (reference checkpoints carry their training args), so load only
    checkpoints you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    for which in ("ema", "model"):
        if isinstance(ckpt, dict) and which in ckpt:
            ckpt = ckpt[which]
            break
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in ckpt.items()}


def _check_supported(cfg: Config) -> str:
    """The ODE method this slice runs; raises for the later slices."""
    mode = (cfg.get("sample_mode") or "ODE").upper()
    later = []
    if mode != "ODE":
        later.append(f"sample_mode={mode}")
    if cfg.get("likelihood"):
        later.append("likelihood")
    if float(cfg.get("cfg_scale", 1.0)) != 1.0:
        later.append("cfg_scale != 1")
    if cfg.get("decode_latents"):
        later.append("decode_latents")
    if cfg.get("metrics"):
        later.append("metrics")
    if later:
        raise NotImplementedError(
            f"{', '.join(later)}: lands in a later slice of the port (this "
            f"slice samples by fixed-step ODE, euler or heun)")
    return cfg.ode.get("sampling_method", "dopri5")


def main(argv=None) -> dict:
    """Run the sampler.  Returns ``{"out_dir", "batch_seconds",
    "n_nonfinite"}``: each batch's host-clock seconds (noise to samples on
    the host) and the count of non-finite sample values."""
    argv = list(sys.argv[1:] if argv is None else argv)
    config_dir = DEFAULT_CONFIG_DIR
    if argv and argv[0].startswith("--config-dir="):
        config_dir = argv.pop(0).split("=", 1)[1]
    cfg = load_config(config_dir, "default", argv)
    device = resolve_device(cfg.get("device"))
    method = _check_supported(cfg)
    path = cfg.get("ckpt")
    if not path:
        raise ValueError("sampling requires ckpt=<path>")

    model = build_model(cfg, device=device)
    model.load_state_dict(load_state_dict(path))
    if model.dtype != torch.float32:
        cast_for_inference(model, model.dtype)
    model.eval()

    p = cfg.model.params
    bs = int(cfg.get("offline_sample_local_bs", 4))
    shape = (bs, p["in_channels"], p["img_dim"], p["img_dim"])
    transport = create_transport(
        cfg.train.get("path_type", "Linear"),
        cfg.train.get("prediction", "velocity"),
        cfg.train.get("loss_weight"),
        cfg.train.get("train_eps"), cfg.train.get("sample_eps"))
    n_steps = int(cfg.ode.get("num_sampling_steps", 250))
    sample_fn = Sampler(transport).sample_ode(
        sampling_method=method, num_steps=n_steps,
        reverse=bool(cfg.ode.get("reverse", False)))

    num = int(cfg.get("num_fid_samples", 64))
    out_dir = os.path.join(
        cfg.get("sample_dir", "samples"),
        f"{cfg.model.get('name', 'm')}_ode_{method}_n{n_steps}")
    os.makedirs(out_dir, exist_ok=True)
    latent_scale = LATENT_SCALE if cfg.get("is_latent", True) else None
    gen = torch.Generator(device=device).manual_seed(
        int(cfg.get("global_seed", 0)))
    n_classes = int(cfg.data.get("num_classes", -1))

    from PIL import Image

    made, it, seconds, n_nonfinite = 0, 0, [], 0
    while made < num:
        t0 = time.perf_counter()
        z = torch.randn(shape, generator=gen, device=device)
        y = (torch.randint(0, n_classes, (bs,), generator=gen, device=device)
             if n_classes > 0 else None)
        with torch.inference_mode():
            samples = sample_fn(z, lambda x, t: model(x, t, y))[-1]
            if latent_scale:
                samples = samples / latent_scale
            arr = samples.float().cpu().numpy()
        seconds.append(time.perf_counter() - t0)
        n_nonfinite += int((~np.isfinite(arr)).sum())
        for i, img in enumerate(to_uint8_images(arr)):
            Image.fromarray(np.transpose(img[:3], (1, 2, 0))).save(
                os.path.join(out_dir, f"{it * bs + i:06d}.png"))
        made += bs
        it += 1
        print(f"generated {made}/{num} ({seconds[-1]:.3f} s)", flush=True)
    return {"out_dir": out_dir, "batch_seconds": seconds,
            "n_nonfinite": n_nonfinite}


if __name__ == "__main__":
    main()
