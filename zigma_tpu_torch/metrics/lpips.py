"""LPIPS (linearly calibrated AlexNet) as torch modules, for video
perceptual similarity.

Counterpart of ``zigma_tpu/metrics/lpips_jax.py``.  The reference scores
videos with ``lpips.LPIPS(net='alex')`` (video_metrics/calculate_lpips.py:
12,58): AlexNet features at the five ReLU taps, unit-normalised over
channels, squared difference, per-layer 1x1 calibration weights, spatial
mean, summed.  ``torchvision`` is not a dependency: ``AlexNetFeatures`` is
the port's own module with torchvision's state-dict names
(``features.{0,3,6,8,10}.{weight,bias}``), and ``LPIPS`` holds it as
``alex`` beside the lpips package's heads ``lin{i}.model.1.weight``.

- ScalingLayer: inputs in [-1, 1], ``(x - shift) / scale``;
- taps after each ReLU: conv1 (11x11 s4 p2), max pool (3, 2), conv2 (5x5
  p2), max pool, conv3, conv4, conv5 (3x3 p1);
- ``normalize_tensor``: x / sqrt(sum_c x^2 + 1e-10);
- heads: non-negative 1x1 convs (no bias), spatial mean, summed over the
  five layers.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["LPIPS", "AlexNetFeatures", "lpips", "lpips_video",
           "lpips_per_timestep", "from_state_dicts"]

_CHANNELS = [64, 192, 384, 256, 256]
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
_TAPS = (1, 4, 7, 9, 11)  # the ReLUs of torchvision's alexnet.features


class AlexNetFeatures(nn.Module):
    """torchvision's ``alexnet().features`` (the 13-layer Sequential)."""

    def __init__(self):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2d(3, 64, 11, 4, 2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(64, 192, 5, 1, 2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(192, 384, 3, 1, 1), nn.ReLU(),
            nn.Conv2d(384, 256, 3, 1, 1), nn.ReLU(),
            nn.Conv2d(256, 256, 3, 1, 1), nn.ReLU(), nn.MaxPool2d(3, 2))

    def taps(self, x):
        out = []
        for i, layer in enumerate(self.features[:_TAPS[-1] + 1]):
            x = layer(x)
            if i in _TAPS:
                out.append(x)
        return out


class NetLinLayer(nn.Module):
    """lpips' calibration head: Dropout (inactive at inference) + a 1x1
    conv without bias."""

    def __init__(self, chn_in):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(), nn.Conv2d(chn_in, 1, 1,
                                                           bias=False))


class LPIPS(nn.Module):
    """``forward(img0, img1)``: (B, C, H, W) in [-1, 1] -> (B,) distances."""

    def __init__(self):
        super().__init__()
        self.alex = AlexNetFeatures()
        for i, c in enumerate(_CHANNELS):
            setattr(self, f"lin{i}", NetLinLayer(c))
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1),
                             persistent=False)

    def forward(self, img0, img1):
        f0, f1 = (self.alex.taps((x.float() - self.shift) / self.scale)
                  for x in (img0, img1))
        total = 0.0
        for i, (a, b) in enumerate(zip(f0, f1)):
            na = a * torch.rsqrt((a * a).sum(1, keepdim=True) + 1e-10)
            nb = b * torch.rsqrt((b * b).sum(1, keepdim=True) + 1e-10)
            w = getattr(self, f"lin{i}").model[1].weight.view(1, -1, 1, 1)
            total = total + ((na - nb) ** 2 * w).sum(1).mean((1, 2))
        return total


def _tensor(x, model):
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           device=model.shift.device)


@torch.inference_mode()
def lpips(model: LPIPS, img0, img1) -> torch.Tensor:
    """LPIPS distance for image batches (B, C, H, W) in [-1, 1] -> (B,)."""
    return model(_tensor(img0, model), _tensor(img1, model))


def lpips_video(model: LPIPS, vid0, vid1) -> torch.Tensor:
    """Per-video LPIPS averaged over frames: (B, T, C, H, W) in [0, 1]
    (shifted to [-1, 1], calculate_lpips.py:30-58) -> (B,)."""
    v0, v1 = _tensor(vid0, model), _tensor(vid1, model)
    B, T = v0.shape[:2]
    flat = lpips(model, v0.reshape((B * T,) + v0.shape[2:]) * 2.0 - 1.0,
                 v1.reshape((B * T,) + v1.shape[2:]) * 2.0 - 1.0)
    return flat.reshape(B, T).mean(1)


def lpips_per_timestep(model: LPIPS, videos1, videos2) -> dict:
    """The reference ``calculate_lpips`` layout: per-timestep mean/std over
    the batch plus global mean/std (video_metrics/calculate_lpips.py:
    25-77); videos (B, T, C, H, W) in [0, 1]."""
    v1, v2 = _tensor(videos1, model), _tensor(videos2, model)
    B, T = v1.shape[:2]
    flat = lpips(model, v1.reshape((B * T,) + v1.shape[2:]) * 2.0 - 1.0,
                 v2.reshape((B * T,) + v2.shape[2:]) * 2.0 - 1.0)
    per_t = flat.reshape(B, T).double().cpu().numpy()
    return {
        "value": {t: float(per_t[:, t].mean()) for t in range(T)},
        "value_std": {t: float(per_t[:, t].std()) for t in range(T)},
        "mean": float(per_t.mean()),
        "std": float(per_t.std()),
    }


def from_state_dicts(alexnet_sd: dict, lpips_sd: dict, device=None) -> LPIPS:
    """An ``LPIPS`` on ``device`` (default CPU) from a torchvision AlexNet
    state dict (its ``features.*``; the classifier is not used) and the
    lpips package's ``alex.pth`` (``lin{i}.model.1.weight``, or the newer
    ``lins.{i}.model.1.weight``), each loaded with ``strict=True``."""
    def t(v):
        return torch.as_tensor(v if torch.is_tensor(v) else np.asarray(v))

    model = LPIPS()
    model.alex.load_state_dict(
        {k: t(v) for k, v in alexnet_sd.items() if k.startswith("features.")},
        strict=True)
    heads = {}
    for k, v in lpips_sd.items():
        if k.startswith("lins."):
            k = "lin" + k[len("lins."):]
        if k.startswith("lin"):
            heads[k] = t(v)
    model.load_state_dict({**{f"alex.{k}": v for k, v in
                              model.alex.state_dict().items()}, **heads},
                          strict=True)
    return model.to(device or "cpu").eval().requires_grad_(False)
