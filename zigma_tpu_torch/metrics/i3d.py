"""InceptionI3d as a torch module, for FVD.

Counterpart of ``zigma_tpu/metrics/i3d_jax.py``.  The reference computes FVD
with a Kinetics-400 I3D: the StyleGAN-V TorchScript archive
(utils/torchmetric_fvd.py:169-186) or the videogpt ``pytorch_i3d``
state dict (video_metrics/fvd/videogpt/pytorch_i3d.py, fvd.py:8-19).  This
module has pytorch-i3d's state-dict names (``Conv3d_1a_7x7.conv3d.weight``,
``Mixed_3b.b1b.bn.running_var``, ``logits.conv3d.bias``) and the JAX net's
numerics:

- every conv and pool pads TF-SAME, split asymmetrically (``same_pads``:
  the smaller half in front), by ``F.pad`` before a ``padding=0`` conv or
  pool;
- the SAME max pools pad with zeros, not -inf (``F.pad``'s default; the
  inputs are post-ReLU);
- Unit3D = conv3d (no bias) + BatchNorm3d (eps 1e-5, inference statistics)
  + ReLU; ``logits`` has a bias and no BN or activation;
- output: the logits conv after the [2, 7, 7] average pool (clamped for
  small inputs), averaged over time and space: (B, 400).

Preprocessing: ``fvd_preprocess`` (videogpt fvd.py:21-60: shorter side to
224 by ``F.interpolate(mode="bilinear")``, the function the JAX package
emulates, centre crop, [-1, 1]) and ``styleganv_gating_preprocess``
(my_metrics.py:58-69: each frame straight to 224 x 224, values left in
[0, 255]).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["InceptionI3d", "i3d_extractor", "styleganv_extractor",
           "from_state_dict", "fvd_preprocess", "styleganv_gating_preprocess",
           "same_pads", "max_pool_same", "UNIT_SPECS", "NUM_CLASSES"]

NUM_CLASSES = 400

# InceptionModule output channels (pytorch_i3d.py:230-275)
_MIXED = {
    "Mixed_3b": (192, (64, 96, 128, 16, 32, 32)),
    "Mixed_3c": (256, (128, 128, 192, 32, 96, 64)),
    "Mixed_4b": (480, (192, 96, 208, 16, 48, 64)),
    "Mixed_4c": (512, (160, 112, 224, 24, 64, 64)),
    "Mixed_4d": (512, (128, 128, 256, 24, 64, 64)),
    "Mixed_4e": (512, (112, 144, 288, 32, 64, 64)),
    "Mixed_4f": (528, (256, 160, 320, 32, 128, 128)),
    "Mixed_5b": (832, (256, 160, 320, 32, 128, 128)),
    "Mixed_5c": (832, (384, 192, 384, 48, 128, 128)),
}


def _unit_specs() -> Dict[str, tuple]:
    """name -> (in_ch, out_ch, (kt, kh, kw), (st, sh, sw))."""
    specs = {
        "Conv3d_1a_7x7": (3, 64, (7, 7, 7), (2, 2, 2)),
        "Conv3d_2b_1x1": (64, 64, (1, 1, 1), (1, 1, 1)),
        "Conv3d_2c_3x3": (64, 192, (3, 3, 3), (1, 1, 1)),
    }
    for name, (cin, (b0, b1a, b1b, b2a, b2b, b3b)) in _MIXED.items():
        specs[f"{name}.b0"] = (cin, b0, (1, 1, 1), (1, 1, 1))
        specs[f"{name}.b1a"] = (cin, b1a, (1, 1, 1), (1, 1, 1))
        specs[f"{name}.b1b"] = (b1a, b1b, (3, 3, 3), (1, 1, 1))
        specs[f"{name}.b2a"] = (cin, b2a, (1, 1, 1), (1, 1, 1))
        specs[f"{name}.b2b"] = (b2a, b2b, (3, 3, 3), (1, 1, 1))
        specs[f"{name}.b3b"] = (cin, b3b, (1, 1, 1), (1, 1, 1))
    return specs


UNIT_SPECS = _unit_specs()


def same_pads(size: int, k: int, s: int):
    """TF SAME pad split (pytorch_i3d.py compute_pad + front/back split)."""
    pad = max(k - s, 0) if size % s == 0 else max(k - (size % s), 0)
    return pad // 2, pad - pad // 2


def _pad_same(x, kernel, stride):
    """Zero-pad NCTHW ``x`` TF-SAME for ``kernel`` / ``stride``."""
    pads = []
    for i in (2, 1, 0):  # F.pad lists the last dimension first
        pads += same_pads(x.shape[2 + i], kernel[i], stride[i])
    return F.pad(x, pads)


def max_pool_same(x, kernel, stride):
    """Zero-pad TF-SAME max pool (MaxPool3dSamePadding)."""
    return F.max_pool3d(_pad_same(x, kernel, stride), kernel, stride)


class Unit3D(nn.Module):
    """SAME-padded conv3d (no bias) + BatchNorm3d (eps 1e-5) + ReLU."""

    def __init__(self, cin, cout, kernel, stride):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.conv3d = nn.Conv3d(cin, cout, kernel, stride, bias=False)
        self.bn = nn.BatchNorm3d(cout, eps=1e-5)

    def forward(self, x):
        x = self.conv3d(_pad_same(x, self.kernel, self.stride))
        bn = self.bn
        x = F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                         bn.bias, False, 0.0, bn.eps)
        return F.relu(x)


class Logits(nn.Module):
    """The ``logits`` Unit3D: a 1x1x1 conv with a bias, nothing else."""

    def __init__(self):
        super().__init__()
        self.conv3d = nn.Conv3d(1024, NUM_CLASSES, 1)

    def forward(self, x):
        return self.conv3d(x)


class InceptionModule(nn.Module):
    def __init__(self, prefix):
        super().__init__()
        for b in ("b0", "b1a", "b1b", "b2a", "b2b", "b3b"):
            cin, cout, k, s = UNIT_SPECS[f"{prefix}.{b}"]
            setattr(self, b, Unit3D(cin, cout, k, s))

    def forward(self, x):
        b0 = self.b0(x)
        b1 = self.b1b(self.b1a(x))
        b2 = self.b2b(self.b2a(x))
        b3 = self.b3b(max_pool_same(x, (3, 3, 3), (1, 1, 1)))
        return torch.cat([b0, b1, b2, b3], 1)


class InceptionI3d(nn.Module):
    """``forward(videos)``: (B, C, T, H, W) float -> (B, 400) FVD logits."""

    def __init__(self):
        super().__init__()
        for name in ("Conv3d_1a_7x7", "Conv3d_2b_1x1", "Conv3d_2c_3x3"):
            setattr(self, name, Unit3D(*UNIT_SPECS[name]))
        for name in _MIXED:
            setattr(self, name, InceptionModule(name))
        self.logits = Logits()

    def forward(self, x):
        x = self.Conv3d_1a_7x7(x.float())
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Mixed_3c(self.Mixed_3b(x))
        x = max_pool_same(x, (3, 3, 3), (2, 2, 2))
        for m in ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f"):
            x = getattr(self, m)(x)
        x = max_pool_same(x, (2, 2, 2), (2, 2, 2))
        x = self.Mixed_5c(self.Mixed_5b(x))
        T, H, W = x.shape[2:]
        x = F.avg_pool3d(x, (min(2, T), min(7, H), min(7, W)), stride=1)
        return self.logits(x).mean((2, 3, 4))


def fvd_preprocess(videos: torch.Tensor, resolution: int = 224):
    """uint8 (B, T, H, W, C) [0, 255] -> (B, C, T, res, res) in [-1, 1]
    (fvd.py:21-60): /255, shorter-side bilinear resize, centre crop,
    -0.5, x2."""
    B, T, H, W, C = videos.shape
    v = videos.float().reshape(B * T, H, W, C).permute(0, 3, 1, 2) / 255.0
    scale = resolution / min(H, W)
    th = int(np.ceil(H * scale)) if W < H else resolution
    tw = int(np.ceil(W * scale)) if H <= W else resolution
    v = F.interpolate(v, size=(th, tw), mode="bilinear", align_corners=False,
                      antialias=False)
    h0, w0 = (th - resolution) // 2, (tw - resolution) // 2
    v = (v[:, :, h0:h0 + resolution, w0:w0 + resolution] - 0.5) * 2.0
    return v.reshape(B, T, C, resolution, resolution).transpose(1, 2)


def styleganv_gating_preprocess(videos: torch.Tensor, resolution: int = 224):
    """uint8 (B, T, H, W, C) -> (B, C, T, res, res) float32 in [0, 255]:
    each frame bilinear-resized straight to res x res (no crop), values
    never rescaled (the reference's gating FVD feed, my_metrics.py:58-69,
    with the detector's ``rescale=False``)."""
    B, T, H, W, C = videos.shape
    v = videos.float().reshape(B * T, H, W, C).permute(0, 3, 1, 2)
    v = F.interpolate(v, size=(resolution, resolution), mode="bilinear",
                      align_corners=False, antialias=False)
    return v.reshape(B, T, C, resolution, resolution).transpose(1, 2)


def from_state_dict(state_dict: dict, device=None) -> InceptionI3d:
    """An ``InceptionI3d`` on ``device`` (default CPU) from a pytorch-i3d
    state dict (a DataParallel ``module.`` prefix is dropped; everything
    else must match, ``strict=True``, ``num_batches_tracked`` optional)."""
    sd = {(k[len("module."):] if k.startswith("module.") else k):
          torch.as_tensor(v if torch.is_tensor(v) else np.asarray(v))
          for k, v in state_dict.items()}
    net = InceptionI3d()
    net.load_state_dict(sd, strict=True)
    return net.to(device or "cpu").eval().requires_grad_(False)


def _make_extractor(name, net, preprocess, batch, resolution):
    from zigma_tpu_torch.metrics.features import NetExtractor

    return NetExtractor(name, net, lambda v: net(preprocess(v, resolution)),
                        next(net.parameters()).device, batch, image=False)


def i3d_extractor(net: InceptionI3d, batch: int = 8, resolution: int = 224):
    """(B, T, H, W, C) uint8 videos -> (B, 400) FVD logits on the net's
    device, videogpt preprocessing."""
    return _make_extractor("i3d", net, fvd_preprocess, batch, resolution)


def styleganv_extractor(net: InceptionI3d, batch: int = 8,
                        resolution: int = 224):
    """(B, T, H, W, C) uint8 videos -> (B, 400) features on the net's
    device through the StyleGAN-V gating preprocessing."""
    return _make_extractor("i3d_styleganv", net, styleganv_gating_preprocess,
                           batch, resolution)
