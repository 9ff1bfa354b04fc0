"""Sampling entry point: ``python -m zigma_tpu_torch.cli.sample ckpt=... [k=v ...]``

Counterpart of ``zigma_tpu/cli/sample.py``: loads a reference ``.pt``
checkpoint (``{"ema"|"model": state_dict}`` or a bare state dict,
``module.`` prefixes stripped) straight into the port's ZigMa, applies the
bf16 inference cast, builds the configured sampler -- ODE (euler, heun or
dopri5, the ``ode`` group), SDE (``sample_mode=SDE``, the ``sde`` group) or
the ODE likelihood (``likelihood=true``) -- and draws ``num_fid_samples``
samples in batches of ``offline_sample_local_bs``, with classifier-free
guidance when ``cfg_scale != 1``.  Images are written as PNGs of the first
three latent channels with the JAX package's uint8 rule; video latents as
``video_{it}_{rank}.npy`` per batch and one animated ``.gif`` per sample.
The likelihood has no data loader here, so it scores the Gaussian noise it
starts from (the reference's behaviour, with the JAX CLI's warning), and a
text model samples with zero (null) caption features, as the JAX CLI does
without a loader (guidance then guides against the same zeros).

Runs on CUDA unless ``device=cpu`` is given; asking for CUDA on a machine
without it raises.  VAE decoding and metrics are later slices of the port
and raise ``NotImplementedError``.
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
from zigma_tpu_torch.utils.logging_utils import create_logger, write_video_grid

__all__ = ["DEFAULT_CONFIG_DIR", "LATENT_SCALE", "build_model",
           "build_sample_fn", "load_state_dict", "to_uint8_images", "main"]

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
        params.setdefault("d_context", data.get("d_context", 768))
        params.setdefault("n_context_token", data.get("n_context_token", 77))
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


def build_sample_fn(cfg: Config, sampler: Sampler):
    """``(kind, sample_fn)`` for the config: kind "ode", "sde" or
    "likelihood", and the sampler's function, as the JAX CLI builds
    them."""
    mode = (cfg.get("sample_mode") or "ODE").upper()
    if mode == "ODE" and cfg.get("likelihood"):
        if float(cfg.get("cfg_scale", 1.0)) != 1.0:
            raise ValueError("likelihood mode requires cfg_scale == 1")
        return "likelihood", sampler.sample_ode_likelihood(
            sampling_method=cfg.ode.get("sampling_method", "dopri5"),
            num_steps=int(cfg.ode.get("num_sampling_steps", 250)),
            atol=float(cfg.ode.get("atol", 1e-6)),
            rtol=float(cfg.ode.get("rtol", 1e-3)))
    if mode == "ODE":
        return "ode", sampler.sample_ode(
            sampling_method=cfg.ode.get("sampling_method", "dopri5"),
            num_steps=int(cfg.ode.get("num_sampling_steps", 250)),
            atol=float(cfg.ode.get("atol", 1e-6)),
            rtol=float(cfg.ode.get("rtol", 1e-3)),
            reverse=bool(cfg.ode.get("reverse", False)))
    if mode == "SDE":
        return "sde", sampler.sample_sde(
            sampling_method=cfg.sde.get("sampling_method", "Euler"),
            diffusion_form=cfg.sde.get("diffusion_form", "sigma"),
            diffusion_norm=float(cfg.sde.get("diffusion_norm", 1.0)),
            last_step=cfg.sde.get("last_step", "Mean"),
            last_step_size=float(cfg.sde.get("last_step_size", 0.04)),
            num_steps=int(cfg.sde.get("num_sampling_steps", 250)))
    raise ValueError(f"unknown sample_mode {mode!r}")


def _check_supported(cfg: Config):
    later = [k for k in ("decode_latents", "metrics") if cfg.get(k)]
    if later:
        raise NotImplementedError(
            f"{', '.join(later)}: lands in a later slice of the port")


def main(argv=None) -> dict:
    """Run the sampler.  Returns ``{"out_dir", "kind", "batch_seconds",
    "n_nonfinite", "model_calls", "dopri5", "logp"}``: each batch's
    host-clock seconds (noise to samples on the host), the count of
    non-finite sample values, each batch's model calls (a guided call
    runs one doubled batch), dopri5's accepted / rejected steps a batch
    and the likelihood's logp a batch (numpy)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    config_dir = DEFAULT_CONFIG_DIR
    if argv and argv[0].startswith("--config-dir="):
        config_dir = argv.pop(0).split("=", 1)[1]
    cfg = load_config(config_dir, "default", argv)
    device = resolve_device(cfg.get("device"))
    _check_supported(cfg)
    path = cfg.get("ckpt")
    if not path:
        raise ValueError("sampling requires ckpt=<path>")
    logger = create_logger(None, "zigma_torch.sample")

    model = build_model(cfg, device=device)
    n_classes = int(cfg.data.get("num_classes", -1))
    cfg_scale = float(cfg.get("cfg_scale", 1.0))
    if cfg_scale != 1.0 and n_classes > 0 and model.class_dropout_prob <= 0:
        raise ValueError(
            "cfg_scale != 1 with integer class labels requires a model "
            "trained with class_dropout_prob > 0 (no null-class row exists "
            "otherwise)")
    model.load_state_dict(load_state_dict(path))
    if model.dtype != torch.float32:
        cast_for_inference(model, model.dtype)
    model.eval().requires_grad_(False)

    p = cfg.model.params
    bs = int(cfg.get("offline_sample_local_bs", 4))
    shape = (bs, p["in_channels"], p["img_dim"], p["img_dim"])
    if cfg.data.get("video_frames", 0) > 0:
        shape = (bs, cfg.data["video_frames"], *shape[1:])
    transport = create_transport(
        cfg.train.get("path_type", "Linear"),
        cfg.train.get("prediction", "velocity"),
        cfg.train.get("loss_weight"),
        cfg.train.get("train_eps"), cfg.train.get("sample_eps"))
    kind, sample_fn = build_sample_fn(cfg, Sampler(transport))

    num = int(cfg.get("num_fid_samples", 64))
    group = cfg.sde if kind == "sde" else cfg.ode
    out_dir = os.path.join(
        cfg.get("sample_dir", "samples"),
        f"{cfg.model.get('name', 'm')}_{kind}_"
        f"{group.get('sampling_method')}_n{group.get('num_sampling_steps')}")
    os.makedirs(out_dir, exist_ok=True)
    latent_scale = LATENT_SCALE if cfg.get("is_latent", True) else None
    gen = torch.Generator(device=device).manual_seed(
        int(cfg.get("global_seed", 0)))
    calls = [0]

    def model_fn(y):
        def fn(x, t):
            calls[0] += 1
            if y is not None and cfg_scale != 1.0:
                return model.forward_with_cfg(x, t, y, cfg_scale)
            return model(x, t, y)
        return fn

    from PIL import Image

    res = dict(out_dir=out_dir, kind=kind, batch_seconds=[], n_nonfinite=0,
               model_calls=[], dopri5=[], logp=[])
    made, it = 0, 0
    while made < num:
        t0 = time.perf_counter()
        calls[0] = 0
        stats = {}
        z = torch.randn(shape, generator=gen, device=device)
        y = None
        if n_classes > 0:
            y = torch.randint(0, n_classes, (bs,), generator=gen, device=device)
        elif model.has_text:  # no caption loader: null (zero) features
            y = torch.zeros((bs, model.n_context_token or 77,
                             model.d_context), device=device)
        if kind == "likelihood":
            logger.warning(
                "likelihood mode without a validation loader scores "
                "gaussian noise, not data (reference parity quirk)")
            with torch.enable_grad():
                logp, samples = sample_fn(z, model_fn(y), generator=gen,
                                          stats=stats)
            res["logp"].append(logp.cpu().numpy())
            logger.info("mean logp: %.2f", float(logp.mean()))
        else:
            with torch.inference_mode():
                if kind == "ode":
                    samples = sample_fn(z, model_fn(y), stats=stats)[-1]
                else:
                    samples = sample_fn(z, model_fn(y), generator=gen)[-1]
        with torch.inference_mode():
            if latent_scale:
                samples = samples / latent_scale
            arr = samples.float().cpu().numpy()
        res["batch_seconds"].append(time.perf_counter() - t0)
        res["model_calls"].append(calls[0])
        if stats:
            res["dopri5"].append(stats)
            logger.info("dopri5: %d accepted, %d rejected steps",
                        stats["accepted"], stats["rejected"])
        res["n_nonfinite"] += int((~np.isfinite(arr)).sum())
        if arr.ndim == 5:
            np.save(os.path.join(out_dir, f"video_{it}_0.npy"), arr)
            for i in range(arr.shape[0]):
                write_video_grid(arr[i:i + 1, :, :3],
                                 os.path.join(out_dir, f"{it * bs + i:06d}.gif"))
        else:
            for i, img in enumerate(to_uint8_images(arr)):
                Image.fromarray(np.transpose(img[:3], (1, 2, 0))).save(
                    os.path.join(out_dir, f"{it * bs + i:06d}.png"))
        made += bs
        it += 1
        logger.info("generated %d/%d (%.3f s, %d model calls)", made, num,
                    res["batch_seconds"][-1], calls[0])
    logger.info("samples written to %s", out_dir)
    return res


if __name__ == "__main__":
    main()
