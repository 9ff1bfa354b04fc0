"""Latent codec: the SD-VAE's encode / decode behind a uniform interface.

Counterpart of ``zigma_tpu/data/vae.py``.  The reference treats the SD VAE
as a frozen black box through diffusers (train_acc.py:229-241; decode at
sample_acc.py:365 with the 0.18215 scale).  Here:

- ``VAECodec``: the port's ``AutoencoderKL`` (``data/sd_vae.py``) on the
  card (or the CPU when asked), from a locally cached diffusers state dict
  (``ZIGMA_VAE_WEIGHTS``, then the Hugging Face hub cache).  It takes the
  place of both ``JAXVAECodec`` and ``TorchVAECodec``; diffusers is not
  used.
- ``IdentityCodec``: pass-through, for shards that already hold latents.

Codecs work on RAW latents; ``LATENT_SCALE`` is applied by the CLIs.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from zigma_tpu_torch.data.sd_vae import AutoencoderKL
from zigma_tpu_torch.data.weights import WeightsNotFound, find_state_dict
from zigma_tpu_torch.device import resolve_device
from zigma_tpu_torch.train.state import LATENT_SCALE

__all__ = ["LatentCodec", "IdentityCodec", "VAECodec", "get_codec",
           "decode_maybe_video", "LATENT_SCALE"]

# images a VAE call takes at once: bounds the decoder's activations (a
# 256^2 image holds 128 x 256 x 256 fp32 values in its last up block)
CHUNK = 16
VAE_FILES = ("diffusion_pytorch_model*", "*.safetensors", "*.bin")


class LatentCodec:
    def encode(self, images) -> np.ndarray:  # (B, C, H, W) in [-1, 1]
        raise NotImplementedError

    def decode(self, latents) -> np.ndarray:  # -> (B, C, H, W) in [-1, 1]
        raise NotImplementedError


def decode_maybe_video(codec: LatentCodec, arr) -> np.ndarray:
    """``codec.decode`` that also takes video batches: (B, T, C, H, W)
    latents are folded to frames for the 2-D VAE and unfolded after, as the
    reference decodes video latents frame-wise (train_acc.py:345,365)."""
    if arr.ndim == 5:
        B, T = arr.shape[:2]
        dec = codec.decode(arr.reshape((-1,) + tuple(arr.shape[2:])))
        return dec.reshape((B, T) + dec.shape[1:])
    return codec.decode(arr)


class IdentityCodec(LatentCodec):
    def encode(self, images):
        return np.asarray(images)

    def decode(self, latents):
        return np.asarray(latents)


class VAECodec(LatentCodec):
    """The SD-VAE from a local diffusers-layout state dict, on ``device``
    (None: CUDA).  ``encode`` samples the posterior (noise from a
    ``torch.Generator`` seeded with ``seed``), as the reference's shard prep
    does with ``latent_dist.sample()``; ``sample_posterior=False`` gives the
    mean.  ``decode`` clips to [-1, 1].  Both take numpy arrays or tensors
    and return numpy float32."""

    def __init__(self, model_id: str = "stabilityai/sd-vae-ft-ema",
                 sample_posterior: bool = True, seed: int = 0, device=None):
        sd, self.weights_path = find_state_dict(model_id, VAE_FILES,
                                                env="ZIGMA_VAE_WEIGHTS")
        self.device = resolve_device(device)
        self.vae = AutoencoderKL.from_state_dict(sd, self.device).eval()
        self.vae.requires_grad_(False)
        self.sample_posterior = sample_posterior
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def _chunks(self, arr):
        x = torch.as_tensor(arr).to(self.device, torch.float32)
        return x.split(CHUNK)

    @torch.inference_mode()
    def encode(self, images):
        out = []
        for x in self._chunks(images):
            mean, logvar = self.vae.encode(x)
            if self.sample_posterior:
                noise = torch.randn(mean.shape, generator=self.generator,
                                    device=self.device)
                mean = self.vae.sample(mean, logvar, noise)
            out.append(mean.cpu())
        return torch.cat(out).numpy()

    @torch.inference_mode()
    def decode(self, latents):
        out = [self.vae.decode(z).clamp_(-1.0, 1.0).cpu()
               for z in self._chunks(latents)]
        return torch.cat(out).numpy()


def get_codec(kind: str = "auto", **kw) -> LatentCodec:
    """'identity' | 'sd-vae' (raises ``WeightsNotFound``, a RuntimeError,
    without local weights) | 'auto' (sd-vae if its weights are cached, else
    identity with a warning).  ``kw`` go to ``VAECodec`` (the identity
    takes none)."""
    if kind == "identity":
        return IdentityCodec()
    if kind == "sd-vae":
        return VAECodec(**kw)
    if kind != "auto":
        raise ValueError(f"unknown codec {kind!r}")
    try:
        return VAECodec(**kw)
    except WeightsNotFound:
        logging.getLogger("zigma_torch").warning(
            "no local SD-VAE weights; falling back to IdentityCodec "
            "(outputs stay in latent space)")
        return IdentityCodec()
