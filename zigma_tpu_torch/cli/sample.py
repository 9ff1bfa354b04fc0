"""Sampling entry point: ``python -m zigma_tpu_torch.cli.sample ckpt=... [k=v ...]``

Counterpart of ``zigma_tpu/cli/sample.py``: loads a reference ``.pt``
checkpoint (``{"ema"|"model": state_dict}`` or a bare state dict,
``module.`` prefixes stripped) straight into the port's ZigMa, applies the
bf16 inference cast, builds the configured sampler -- ODE (euler, heun or
dopri5, the ``ode`` group), SDE (``sample_mode=SDE``, the ``sde`` group) or
the ODE likelihood (``likelihood=true``) -- and draws ``num_fid_samples``
samples in batches of ``offline_sample_local_bs``, with classifier-free
guidance when ``cfg_scale != 1``.

``decode_latents=true`` decodes the samples through the latent codec
(``vae_kind``: ``sd-vae`` needs local VAE weights and raises without them,
``auto`` falls back to the identity with a warning), video latents frame by
frame.  Images are written as PNGs (decoded pixels, or the first three
latent channels) with the JAX package's uint8 rule; videos as
``video_{it}_{rank}.npy`` per batch and one animated ``.gif`` per sample.

When the data group has a ``validation`` split and is not synthetic, its
shards serve as real batches, as in the JAX CLI: the likelihood scores
them (latents times 0.18215) and a text model takes their caption
features.  Without one the likelihood scores the Gaussian noise it starts
from (the reference's behaviour, with the JAX CLI's warning), and a text
model samples with zero (null) caption features.

``metrics=[fid,kid,...]`` scores the samples against the validation split,
as the JAX CLI does (sample_acc.py:359-385, 454-462): the suite is built
after the codec and keyed on whether it gives pixels (the canonical nets
from local weights on the sampling device, else each choice degrades as
``metrics/menu.py`` says; ``fvd`` on an image run or an unknown name
raises before anything is loaded); each sampled batch is paired with the
next validation batch (decoded the same way) until the split runs out, and
the scores go to ``metrics.json`` beside the samples.

Runs on CUDA unless ``device=cpu`` is given; asking for CUDA on a machine
without it raises.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from zigma_tpu_torch.config import Config, load_config
from zigma_tpu_torch.data.vae import (IdentityCodec, decode_maybe_video,
                                      get_codec)
from zigma_tpu_torch.device import resolve_device
from zigma_tpu_torch.metrics.facade import to_uint8_images
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


def main(argv=None) -> dict:
    """Run the sampler.  Returns ``{"out_dir", "kind", "batch_seconds",
    "decode_seconds", "n_nonfinite", "model_calls", "dopri5", "logp",
    "real_batches", "metrics", "scores", "metric_suite"}``: each batch's
    host-clock seconds (noise to samples, decoded when asked, on the host)
    and the decode's share of them, the count of non-finite output values,
    each batch's model calls (a guided call runs one doubled batch),
    dopri5's accepted / rejected steps a batch, the likelihood's logp a
    batch (numpy), the number of validation batches used, the metric
    suite's surviving choices, its scores (also in ``metrics.json``; {}
    without paired batches) and the suite itself (None without
    ``metrics``)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    config_dir = DEFAULT_CONFIG_DIR
    if argv and argv[0].startswith("--config-dir="):
        config_dir = argv.pop(0).split("=", 1)[1]
    cfg = load_config(config_dir, "default", argv)
    metric_choices = list(cfg.get("metrics") or [])
    video = cfg.data.get("video_frames", 0) > 0
    if metric_choices:  # unknown names and fvd on images fail first
        from zigma_tpu_torch.metrics import validate_choices

        validate_choices(metric_choices, video=video)
    device = resolve_device(cfg.get("device"))
    path = cfg.get("ckpt")
    if not path:
        raise ValueError("sampling requires ckpt=<path>")
    logger = create_logger(None, "zigma_torch.sample")
    codec = None  # first: a missing VAE fails before any sampling
    if cfg.get("decode_latents"):
        codec = get_codec(cfg.get("vae_kind", "auto"), device=device)
    # pixels only from a real codec: 'auto' may fall back to the identity,
    # whose float latents take the patch-statistics route
    in_pixels = codec is not None and not isinstance(codec, IdentityCodec)
    metric = None
    if metric_choices:
        from zigma_tpu_torch.metrics import build_metric_suite

        suite = build_metric_suite(choices=metric_choices, video=video,
                                   in_pixels=in_pixels, logger=logger,
                                   device=device)
        if suite.empty:
            logger.warning("metrics unavailable: every requested choice "
                           "was dropped (%s)", list(suite.dropped))
        else:
            logger.info("metrics: %s%s", suite.choices,
                        f" (dropped: {list(suite.dropped)})"
                        if suite.dropped else "")
            metric = suite

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

    # the validation split, started only when a batch is first asked for
    real_gen = None
    if cfg.data.get("validation") and not cfg.data.get("synthetic"):
        from zigma_tpu_torch.cli.train import wds_batches

        real_gen = wds_batches(cfg, split="validation")
    res = dict(out_dir=out_dir, kind=kind, batch_seconds=[],
               decode_seconds=[], n_nonfinite=0, model_calls=[], dopri5=[],
               logp=[], real_batches=0,
               metrics=metric.choices if metric is not None else [],
               scores={}, metric_suite=metric)
    n_pairs = 0

    def next_real():
        """The next validation batch, or None once the finite split is
        exhausted (or there is none)."""
        nonlocal real_gen
        if real_gen is None:
            return None
        try:
            batch = next(real_gen)
        except StopIteration:
            logger.warning(
                "validation split exhausted; remaining iterations run "
                "without real batches (text conditioning falls back to "
                "null features)")
            real_gen = None
            return None
        res["real_batches"] += 1
        return batch

    def real(arr):
        return torch.as_tensor(arr).to(device, torch.float32)

    from PIL import Image

    made, it = 0, 0
    while made < num:
        t0 = time.perf_counter()
        calls[0] = 0
        stats = {}
        z = torch.randn(shape, generator=gen, device=device)
        y = None
        if n_classes > 0:
            y = torch.randint(0, n_classes, (bs,), generator=gen, device=device)
        elif model.has_text:
            # caption features from the validation split when it has them,
            # else null (zero) features
            batch = next_real()
            if batch is not None and batch.get("y") is not None:
                y = real(batch["y"][:bs])
                z = z[:y.shape[0]]
            else:
                y = torch.zeros((bs, model.n_context_token or 77,
                                 model.d_context), device=device)
        if kind == "likelihood":
            batch = next_real()  # the likelihood scores data where it can
            if batch is not None:
                z = real(batch["x"][:bs])
                if latent_scale:
                    z = z * latent_scale
                if "y" in batch and y is not None:
                    y = torch.as_tensor(batch["y"][:bs]).to(device)
                    if y.is_floating_point():
                        y = y.float()
            else:
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
        t_dec = time.perf_counter()
        if codec is not None:  # video latents frame by frame
            arr = decode_maybe_video(codec, arr)
        res["decode_seconds"].append(time.perf_counter() - t_dec)
        res["batch_seconds"].append(time.perf_counter() - t0)
        res["model_calls"].append(calls[0])
        if stats:
            res["dopri5"].append(stats)
            logger.info("dopri5: %d accepted, %d rejected steps",
                        stats["accepted"], stats["rejected"])
        res["n_nonfinite"] += int((~np.isfinite(arr)).sum())
        if metric is not None:
            # paired updates only: once the split runs out the metric
            # freezes at the pairs seen, while sampling goes on
            batch = next_real()
            if batch is not None:
                real_arr = np.asarray(batch["x"])[:bs]
                if codec is not None:
                    real_arr = decode_maybe_video(codec, real_arr)
                metric.update_fake(to_uint8_images(arr) if in_pixels else arr)
                metric.update_real(to_uint8_images(real_arr) if in_pixels
                                   else real_arr)
                n_pairs += 1
        if arr.ndim == 5:
            np.save(os.path.join(out_dir, f"video_{it}_0.npy"), arr)
            for i in range(arr.shape[0]):
                write_video_grid(arr[i:i + 1, :, :3],
                                 os.path.join(out_dir, f"{it * bs + i:06d}.gif"))
        else:
            for i, img in enumerate(to_uint8_images(arr)):
                Image.fromarray(np.transpose(img[:3], (1, 2, 0))).save(
                    os.path.join(out_dir, f"{it * bs + i:06d}.png"))
        made += arr.shape[0]
        it += 1
        logger.info("generated %d/%d (%.3f s, %d model calls)", made, num,
                    res["batch_seconds"][-1], calls[0])
    if metric is not None and n_pairs > 0:
        import json

        res["scores"] = metric.compute()
        logger.info("metrics: %s", res["scores"])
        with open(os.path.join(out_dir, "metrics.json"), "w") as f:
            json.dump(res["scores"], f)
    logger.info("samples written to %s", out_dir)
    return res


if __name__ == "__main__":
    main()
