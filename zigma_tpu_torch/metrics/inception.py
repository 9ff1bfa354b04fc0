"""The FID InceptionV3 as a torch module (NCHW).

Counterpart of ``zigma_tpu/metrics/inception_jax.py``: torch-fidelity's
``FeatureExtractorInceptionV3``, the TensorFlow-ported graph the published
FID numbers depend on (reference: utils/torchmetric_sfid.py:63-170), with
torch-fidelity's state-dict names (``Conv2d_1a_3x3.conv.weight``,
``Mixed_5b.branch5x5_2.bn.running_var``, ``fc.weight``), so a
``pt_inception-2015-12-05`` file loads with ``strict=True``.

Where a plain torch rewrite would differ from it:

- the TF1 bilinear resize to 299 (``tf1_bilinear_resize``) has no
  half-pixel centres: integer taps and fractional weights per axis, as the
  JAX function computes them, not ``F.interpolate``;
- ``BasicConv2d`` = conv (no bias) + BatchNorm with eps 1e-3 (inference
  statistics always) + ReLU;
- InceptionA/C and E_1 average-pool with ``count_include_pad=False``;
  Mixed_7c (E_2) max-pools in its pool branch;
- taps: "64" (after the stem's first max pool), "192" (after the second),
  "768" = the first 7 channels of Mixed_6e flattened in NCHW order (7 x 17
  x 17 = 2023, the sFID feature), "2048" (final average pool) and
  "logits_unbiased" = pooled @ fc.weight.T (no bias, 1008 classes).

Weights are never downloaded: ``from_state_dict`` takes a local file's
state dict (``features.py`` finds it).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["InceptionV3", "inception_extractor", "from_state_dict",
           "tf1_bilinear_resize", "FEATURE_NAMES", "CONV_SPECS",
           "NUM_CLASSES"]

FEATURE_NAMES = ("64", "192", "768", "2048", "logits_unbiased")
NUM_CLASSES = 1008  # the TF-ported FID net keeps the original 1008 classes


# name -> (in_ch, out_ch, (kh, kw), (sh, sw), (ph, pw)), every BasicConv2d
def _a(prefix: str, in_ch: int, pool: int):
    return {
        f"{prefix}.branch1x1": (in_ch, 64, (1, 1), (1, 1), (0, 0)),
        f"{prefix}.branch5x5_1": (in_ch, 48, (1, 1), (1, 1), (0, 0)),
        f"{prefix}.branch5x5_2": (48, 64, (5, 5), (1, 1), (2, 2)),
        f"{prefix}.branch3x3dbl_1": (in_ch, 64, (1, 1), (1, 1), (0, 0)),
        f"{prefix}.branch3x3dbl_2": (64, 96, (3, 3), (1, 1), (1, 1)),
        f"{prefix}.branch3x3dbl_3": (96, 96, (3, 3), (1, 1), (1, 1)),
        f"{prefix}.branch_pool": (in_ch, pool, (1, 1), (1, 1), (0, 0)),
    }


def _b(prefix: str, in_ch: int):
    return {
        f"{prefix}.branch3x3": (in_ch, 384, (3, 3), (2, 2), (0, 0)),
        f"{prefix}.branch3x3dbl_1": (in_ch, 64, (1, 1), (1, 1), (0, 0)),
        f"{prefix}.branch3x3dbl_2": (64, 96, (3, 3), (1, 1), (1, 1)),
        f"{prefix}.branch3x3dbl_3": (96, 96, (3, 3), (2, 2), (0, 0)),
    }


def _c(prefix: str, in_ch: int, c7: int):
    return {
        f"{prefix}.branch1x1": (in_ch, 192, (1, 1), (1, 1), (0, 0)),
        f"{prefix}.branch7x7_1": (in_ch, c7, (1, 1), (1, 1), (0, 0)),
        f"{prefix}.branch7x7_2": (c7, c7, (1, 7), (1, 1), (0, 3)),
        f"{prefix}.branch7x7_3": (c7, 192, (7, 1), (1, 1), (3, 0)),
        f"{prefix}.branch7x7dbl_1": (in_ch, c7, (1, 1), (1, 1), (0, 0)),
        f"{prefix}.branch7x7dbl_2": (c7, c7, (7, 1), (1, 1), (3, 0)),
        f"{prefix}.branch7x7dbl_3": (c7, c7, (1, 7), (1, 1), (0, 3)),
        f"{prefix}.branch7x7dbl_4": (c7, c7, (7, 1), (1, 1), (3, 0)),
        f"{prefix}.branch7x7dbl_5": (c7, 192, (1, 7), (1, 1), (0, 3)),
        f"{prefix}.branch_pool": (in_ch, 192, (1, 1), (1, 1), (0, 0)),
    }


def _d(prefix: str, in_ch: int):
    return {
        f"{prefix}.branch3x3_1": (in_ch, 192, (1, 1), (1, 1), (0, 0)),
        f"{prefix}.branch3x3_2": (192, 320, (3, 3), (2, 2), (0, 0)),
        f"{prefix}.branch7x7x3_1": (in_ch, 192, (1, 1), (1, 1), (0, 0)),
        f"{prefix}.branch7x7x3_2": (192, 192, (1, 7), (1, 1), (0, 3)),
        f"{prefix}.branch7x7x3_3": (192, 192, (7, 1), (1, 1), (3, 0)),
        f"{prefix}.branch7x7x3_4": (192, 192, (3, 3), (2, 2), (0, 0)),
    }


def _e(prefix: str, in_ch: int):
    return {
        f"{prefix}.branch1x1": (in_ch, 320, (1, 1), (1, 1), (0, 0)),
        f"{prefix}.branch3x3_1": (in_ch, 384, (1, 1), (1, 1), (0, 0)),
        f"{prefix}.branch3x3_2a": (384, 384, (1, 3), (1, 1), (0, 1)),
        f"{prefix}.branch3x3_2b": (384, 384, (3, 1), (1, 1), (1, 0)),
        f"{prefix}.branch3x3dbl_1": (in_ch, 448, (1, 1), (1, 1), (0, 0)),
        f"{prefix}.branch3x3dbl_2": (448, 384, (3, 3), (1, 1), (1, 1)),
        f"{prefix}.branch3x3dbl_3a": (384, 384, (1, 3), (1, 1), (0, 1)),
        f"{prefix}.branch3x3dbl_3b": (384, 384, (3, 1), (1, 1), (1, 0)),
        f"{prefix}.branch_pool": (in_ch, 192, (1, 1), (1, 1), (0, 0)),
    }


CONV_SPECS: Dict[str, tuple] = {
    "Conv2d_1a_3x3": (3, 32, (3, 3), (2, 2), (0, 0)),
    "Conv2d_2a_3x3": (32, 32, (3, 3), (1, 1), (0, 0)),
    "Conv2d_2b_3x3": (32, 64, (3, 3), (1, 1), (1, 1)),
    "Conv2d_3b_1x1": (64, 80, (1, 1), (1, 1), (0, 0)),
    "Conv2d_4a_3x3": (80, 192, (3, 3), (1, 1), (0, 0)),
    **_a("Mixed_5b", 192, 32), **_a("Mixed_5c", 256, 64),
    **_a("Mixed_5d", 288, 64),
    **_b("Mixed_6a", 288),
    **_c("Mixed_6b", 768, 128), **_c("Mixed_6c", 768, 160),
    **_c("Mixed_6d", 768, 160), **_c("Mixed_6e", 768, 192),
    **_d("Mixed_7a", 768),
    **_e("Mixed_7b", 1280), **_e("Mixed_7c", 2048),
}


def tf1_bilinear_resize(x: torch.Tensor, size: int = 299) -> torch.Tensor:
    """TF1 ``resize_bilinear(align_corners=False)`` on NCHW input: source
    coordinate = dst * (in/out), corner = floor, linear blend with the
    fractional part, upper neighbour clamped to in - 1."""
    H, W = (int(d) for d in x.shape[-2:])  # ints under torch.jit.trace too

    def axis(in_size):
        src = np.arange(size, dtype=np.float64) * (in_size / size)
        lo = np.minimum(np.floor(src).astype(np.int64), in_size - 1)
        hi = np.minimum(lo + 1, in_size - 1)
        return (torch.as_tensor(lo, device=x.device),
                torch.as_tensor(hi, device=x.device),
                torch.as_tensor(src - lo, dtype=torch.float32,
                                device=x.device))

    ylo, yhi, yf = axis(H)
    xlo, xhi, xf = axis(W)
    x = x.float()
    top, bot = x[..., ylo, :], x[..., yhi, :]
    rows = top + (bot - top) * yf[:, None]
    left, right = rows[..., xlo], rows[..., xhi]
    return left + (right - left) * xf


class BasicConv2d(nn.Module):
    """conv (no bias) + BatchNorm (eps 1e-3, inference statistics) + ReLU."""

    def __init__(self, cin, cout, kernel, stride, pad):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, pad, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x):
        bn = self.bn
        x = F.batch_norm(self.conv(x), bn.running_mean, bn.running_var,
                         bn.weight, bn.bias, False, 0.0, bn.eps)
        return F.relu(x)


class _Block(nn.Module):
    """A Mixed_* block: its BasicConv2d branches by name (the graph that
    joins them is ``InceptionV3``'s)."""


def _max_pool(x, k=3, s=2, pad=0):
    return F.max_pool2d(x, k, s, pad)


def _avg_pool_nopad(x):
    """3x3 stride-1 average pool, pad 1, ``count_include_pad=False``."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


class InceptionV3(nn.Module):
    """torch-fidelity's FID InceptionV3; ``forward(x, features)`` takes
    NCHW images in [0, 255] (uint8 or float) and returns a dict of the
    requested taps, each (B, F) float32."""

    def __init__(self):
        super().__init__()
        for name, (cin, cout, k, s, p) in CONV_SPECS.items():
            parent = self
            if "." in name:
                block, name = name.split(".")
                if not hasattr(self, block):
                    setattr(self, block, _Block())
                parent = getattr(self, block)
            setattr(parent, name, BasicConv2d(cin, cout, k, s, p))
        self.fc = nn.Linear(2048, NUM_CLASSES)

    def _run(self, name, x):
        return self.get_submodule(name)(x)

    def _block_a(self, m, x):
        b1 = self._run(f"{m}.branch1x1", x)
        b5 = self._run(f"{m}.branch5x5_2", self._run(f"{m}.branch5x5_1", x))
        b3 = x
        for tail in ("_1", "_2", "_3"):
            b3 = self._run(f"{m}.branch3x3dbl{tail}", b3)
        bp = self._run(f"{m}.branch_pool", _avg_pool_nopad(x))
        return torch.cat([b1, b5, b3, bp], 1)

    def _block_b(self, m, x):
        b3 = self._run(f"{m}.branch3x3", x)
        bd = x
        for tail in ("_1", "_2", "_3"):
            bd = self._run(f"{m}.branch3x3dbl{tail}", bd)
        return torch.cat([b3, bd, _max_pool(x)], 1)

    def _block_c(self, m, x):
        b1 = self._run(f"{m}.branch1x1", x)
        b7 = x
        for tail in ("_1", "_2", "_3"):
            b7 = self._run(f"{m}.branch7x7{tail}", b7)
        bd = x
        for tail in ("_1", "_2", "_3", "_4", "_5"):
            bd = self._run(f"{m}.branch7x7dbl{tail}", bd)
        bp = self._run(f"{m}.branch_pool", _avg_pool_nopad(x))
        return torch.cat([b1, b7, bd, bp], 1)

    def _block_d(self, m, x):
        b3 = self._run(f"{m}.branch3x3_2", self._run(f"{m}.branch3x3_1", x))
        b7 = x
        for tail in ("_1", "_2", "_3", "_4"):
            b7 = self._run(f"{m}.branch7x7x3{tail}", b7)
        return torch.cat([b3, b7, _max_pool(x)], 1)

    def _block_e(self, m, x, pool: str):
        b1 = self._run(f"{m}.branch1x1", x)
        b3 = self._run(f"{m}.branch3x3_1", x)
        b3 = torch.cat([self._run(f"{m}.branch3x3_2a", b3),
                        self._run(f"{m}.branch3x3_2b", b3)], 1)
        bd = self._run(f"{m}.branch3x3dbl_2",
                       self._run(f"{m}.branch3x3dbl_1", x))
        bd = torch.cat([self._run(f"{m}.branch3x3dbl_3a", bd),
                        self._run(f"{m}.branch3x3dbl_3b", bd)], 1)
        if pool == "avg":   # FIDInceptionE_1 (Mixed_7b)
            bp = _avg_pool_nopad(x)
        else:               # FIDInceptionE_2 (Mixed_7c): max pool, pad 1
            bp = _max_pool(x, k=3, s=1, pad=1)
        bp = self._run(f"{m}.branch_pool", bp)
        return torch.cat([b1, b3, bd, bp], 1)

    def forward(self, x: torch.Tensor, features: Sequence[str] = ("2048",),
                resize: bool = True) -> Dict[str, torch.Tensor]:
        want = set(features)
        unknown = want - set(FEATURE_NAMES)
        if unknown:
            raise ValueError(f"unknown features {sorted(unknown)}")
        out = {}
        x = x.float()
        if resize:
            x = tf1_bilinear_resize(x, 299)
        x = (x - 128.0) / 128.0
        for name in ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3"):
            x = self._run(name, x)
        x = _max_pool(x)
        if "64" in want:
            out["64"] = x.mean((2, 3))
            if len(out) == len(want):
                return out
        x = self._run("Conv2d_4a_3x3", self._run("Conv2d_3b_1x1", x))
        x = _max_pool(x)
        if "192" in want:
            out["192"] = x.mean((2, 3))
            if len(out) == len(want):
                return out
        for m in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
            x = self._block_a(m, x)
        x = self._block_b("Mixed_6a", x)
        for m in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            x = self._block_c(m, x)
        if "768" in want:
            # sFID feature: first 7 channels, flattened in NCHW order
            out["768"] = x[:, :7].reshape(x.shape[0], -1)
            if len(out) == len(want):
                return out
        x = self._block_d("Mixed_7a", x)
        x = self._block_e("Mixed_7b", x, pool="avg")
        x = self._block_e("Mixed_7c", x, pool="max")
        pooled = x.mean((2, 3))
        if "2048" in want:
            out["2048"] = pooled
        if "logits_unbiased" in want:
            out["logits_unbiased"] = pooled @ self.fc.weight.T
        return out


def from_state_dict(state_dict: dict, device=None) -> InceptionV3:
    """An ``InceptionV3`` on ``device`` (default CPU) from a torch
    FID-Inception state dict: a leading ``base.`` / ``model.`` is dropped,
    as the JAX loader does; everything else must match (``strict=True``),
    ``num_batches_tracked`` optional."""
    sd = {}
    for k, v in state_dict.items():
        for prefix in ("base.", "model."):
            if k.startswith(prefix):
                k = k[len(prefix):]
                break
        sd[k] = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                else v)
    net = InceptionV3()
    net.load_state_dict(sd, strict=True)
    return net.to(device or "cpu").eval().requires_grad_(False)


def inception_extractor(net: InceptionV3, feature: str = "2048",
                        batch: int = 64):
    """(B, C, H, W) numpy [0, 255] -> (B, F) numpy features, in chunks of
    ``batch`` on the net's device."""
    from zigma_tpu_torch.metrics.features import NetExtractor

    if feature not in FEATURE_NAMES:
        raise ValueError(f"unknown feature {feature!r}")
    return NetExtractor(f"inception:{feature}", net,
                        lambda x: net(x, features=(feature,))[feature],
                        next(net.parameters()).device, batch)
