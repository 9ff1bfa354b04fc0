"""The SD-VAE (``AutoencoderKL``, f8 / 4 latent channels), encoder and decoder.

Counterpart of ``zigma_tpu/data/vae_jax.py`` as an ``nn.Module`` in NCHW,
with the diffusers ``AutoencoderKL`` parameter names, so a diffusers state
dict (sd-vae-ft-ema, the SD-1.x VAE) loads with ``strict=True`` after
``normalize_state_dict`` has given its attention weights one layout.
diffusers itself is not needed.

Architecture (the reference's codec, train_acc.py:229-241):

- Encoder: conv_in 3->128; down blocks at [128, 256, 512, 512] with 2
  resnets each and, between levels, a stride-2 conv after an asymmetric
  (0, 1) pad; mid resnet / attention / resnet; GroupNorm(32, eps 1e-6) +
  silu + conv_out -> 8 (mean ++ logvar); quant_conv 1x1.
- Decoder: post_quant_conv 1x1; conv_in 4->512; mid resnet / attention /
  resnet; up blocks at [512, 512, 256, 128] with 3 resnets each and a
  nearest x2 upsample + conv between levels; GroupNorm + silu + conv_out
  -> 3.
- ResnetBlock: GN + silu + conv3x3, twice; 1x1 shortcut on a channel
  change.  Attention: GN, 1x1 q / k / v as Linear over channels, one head
  over every position (in fp32, by ``scaled_dot_product_attention``, which
  need not hold the (HW, HW) scores), Linear out projection, residual.

Latents are RAW: the 0.18215 scale belongs to the CLIs, as in the JAX
package and the shard contract (train_acc.py:432).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["AutoencoderKL", "CHANNELS", "Z_CH", "normalize_state_dict"]

CHANNELS: Sequence[int] = (128, 256, 512, 512)
Z_CH = 4
GROUPS, EPS = 32, 1e-6


def _channels(scale: int) -> list:
    """The channel plan; ``scale`` shrinks it for tiny test nets (channels
    stay multiples of the 32 GroupNorm groups, as ``random_params`` of the
    JAX package keeps them)."""
    return [max(c // scale, GROUPS) for c in CHANNELS]


def _norm(c: int) -> nn.GroupNorm:
    return nn.GroupNorm(GROUPS, c, eps=EPS)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = _norm(cin)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2 = _norm(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.group_norm = _norm(c)
        self.to_q = nn.Linear(c, c)
        self.to_k = nn.Linear(c, c)
        self.to_v = nn.Linear(c, c)
        self.to_out = nn.ModuleList([nn.Linear(c, c)])

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.group_norm(x).flatten(2).transpose(1, 2).float()
        q, k, v = (proj(h)[:, None] for proj in (self.to_q, self.to_k,
                                                 self.to_v))
        o = F.scaled_dot_product_attention(q, k, v)[:, 0]  # scale 1/sqrt(C)
        o = self.to_out[0](o).to(x.dtype)
        return x + o.transpose(1, 2).reshape(B, C, H, W)


class MidBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(c, c), ResnetBlock(c, c)])
        self.attentions = nn.ModuleList([Attention(c)])

    def forward(self, x):
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class Downsample(nn.Module):
    """diffusers ``Downsample2D``: pad right and bottom by one, then a
    stride-2 3x3 conv without padding."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class DownBlock(nn.Module):
    def __init__(self, cin: int, cout: int, n: int, down: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock(cin if j == 0 else cout, cout) for j in range(n)])
        self.downsamplers = nn.ModuleList([Downsample(cout)] if down else [])

    def forward(self, x):
        for m in (*self.resnets, *self.downsamplers):
            x = m(x)
        return x


class UpBlock(nn.Module):
    def __init__(self, cin: int, cout: int, n: int, up: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock(cin if j == 0 else cout, cout) for j in range(n)])
        self.upsamplers = nn.ModuleList([Upsample(cout)] if up else [])

    def forward(self, x):
        for m in (*self.resnets, *self.upsamplers):
            x = m(x)
        return x


class Encoder(nn.Module):
    def __init__(self, chs: list):
        super().__init__()
        self.conv_in = nn.Conv2d(3, chs[0], 3, padding=1)
        cins = [chs[0], *chs[:-1]]
        self.down_blocks = nn.ModuleList(
            [DownBlock(cin, c, 2, i < len(chs) - 1)
             for i, (cin, c) in enumerate(zip(cins, chs))])
        self.mid_block = MidBlock(chs[-1])
        self.conv_norm_out = _norm(chs[-1])
        self.conv_out = nn.Conv2d(chs[-1], 2 * Z_CH, 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for blk in self.down_blocks:
            x = blk(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class Decoder(nn.Module):
    def __init__(self, chs: list):
        super().__init__()
        dchs = chs[::-1]
        self.conv_in = nn.Conv2d(Z_CH, dchs[0], 3, padding=1)
        self.mid_block = MidBlock(dchs[0])
        cins = [dchs[0], *dchs[:-1]]
        self.up_blocks = nn.ModuleList(
            [UpBlock(cin, c, 3, i < len(dchs) - 1)
             for i, (cin, c) in enumerate(zip(cins, dchs))])
        self.conv_norm_out = _norm(dchs[-1])
        self.conv_out = nn.Conv2d(dchs[-1], 3, 3, padding=1)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            x = blk(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class AutoencoderKL(nn.Module):
    """The SD f8 KL autoencoder.  ``scale`` divides the channel plan (1 is
    the real SD-VAE; the JAX package's tests use 4)."""

    def __init__(self, scale: int = 1, device=None):
        super().__init__()
        chs = _channels(scale)
        self.encoder = Encoder(chs)
        self.decoder = Decoder(chs)
        self.quant_conv = nn.Conv2d(2 * Z_CH, 2 * Z_CH, 1)
        self.post_quant_conv = nn.Conv2d(Z_CH, Z_CH, 1)
        if device is not None:
            self.to(device)

    @classmethod
    def from_state_dict(cls, state_dict: dict, device=None) -> "AutoencoderKL":
        """A model of the state dict's channel plan with its weights
        (``normalize_state_dict`` first; ``strict=True``)."""
        sd = normalize_state_dict(state_dict)
        scale = CHANNELS[0] // sd["encoder.conv_in.weight"].shape[0]
        model = cls(scale=scale)
        model.load_state_dict(sd, strict=True)
        return model.to(device) if device is not None else model

    def encode(self, images: torch.Tensor):
        """(B, 3, H, W) in [-1, 1] -> the posterior's RAW (mean, logvar),
        each (B, 4, H/8, W/8)."""
        moments = self.quant_conv(self.encoder(images.float()))
        return moments.chunk(2, dim=1)

    @staticmethod
    def sample(mean: torch.Tensor, logvar: torch.Tensor,
               noise: torch.Tensor) -> torch.Tensor:
        """A posterior sample, ``mean + exp(logvar / 2) * noise`` with logvar
        clipped to [-30, 20] (diffusers' ``DiagonalGaussianDistribution``)."""
        return mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * noise

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """RAW latents (B, 4, h, w) -> images (B, 3, 8h, 8w), unclipped."""
        return self.decoder(self.post_quant_conv(latents.float()))


_OLD_ATTN = {"query": "to_q", "key": "to_k", "value": "to_v",
             "proj_attn": "to_out.0"}


def normalize_state_dict(state_dict: dict) -> dict:
    """A diffusers ``AutoencoderKL`` state dict with its mid-block attention
    in the newer layout: the older names (``query``, ``key``, ``value``,
    ``proj_attn``, diffusers < 0.15) become ``to_q``, ``to_k``, ``to_v``,
    ``to_out.0``, and 1x1-conv weights (out, in, 1, 1) become Linear (out,
    in), as ``vae_jax.load_torch_state_dict`` reads them."""
    out = {}
    for k, v in state_dict.items():
        v = torch.as_tensor(v)
        parts = k.split(".")
        if "attentions" in parts and len(parts) >= 2:
            if parts[-2] in _OLD_ATTN:
                k = ".".join(parts[:-2] + [_OLD_ATTN[parts[-2]], parts[-1]])
            if parts[-1] == "weight" and v.ndim == 4:
                v = v[:, :, 0, 0]
        out[k] = v
    return out
