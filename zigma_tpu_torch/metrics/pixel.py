"""Per-frame reference metrics: PSNR and SSIM (and per-timestep video stats).

Ports of the reference's video metric scripts
(reference: video_metrics/calculate_psnr.py, calculate_ssim.py — which
operate on [0,1] videos shaped (B, T, C, H, W) and report per-timestep
mean/std).  LPIPS, which needs AlexNet and lpips weights, is in lpips.py.

The port's own copy of ``zigma_tpu/metrics/pixel.py`` (numpy / scipy only):
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

__all__ = ["psnr", "ssim", "video_metric_per_timestep"]


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    """PSNR over one image/frame pair in [0, data_range]
    (reference: video_metrics/calculate_psnr.py:10-15 uses MSE on [0,1])."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(20 * np.log10(data_range) - 10 * np.log10(mse))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2 * sigma**2))
    g /= g.sum()
    return np.outer(g, g)


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    """SSIM with the standard 11x11 Gaussian window, per channel, averaged
    (reference: video_metrics/calculate_ssim.py:12-48)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 2:
        a, b = a[None], b[None]
    if a.shape[0] not in (1, 3) and a.shape[-1] in (1, 3):  # HWC -> CHW
        a, b = a.transpose(2, 0, 1), b.transpose(2, 0, 1)

    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    win = _gaussian_window()

    def conv2(img):
        from scipy.signal import convolve2d

        return convolve2d(img, win, mode="valid")

    vals = []
    for ch in range(a.shape[0]):
        x, y = a[ch], b[ch]
        mu_x, mu_y = conv2(x), conv2(y)
        mu_x2, mu_y2, mu_xy = mu_x**2, mu_y**2, mu_x * mu_y
        sx = conv2(x * x) - mu_x2
        sy = conv2(y * y) - mu_y2
        sxy = conv2(x * y) - mu_xy
        m = ((2 * mu_xy + c1) * (2 * sxy + c2)) / (
            (mu_x2 + mu_y2 + c1) * (sx + sy + c2))
        vals.append(m.mean())
    return float(np.mean(vals))


def video_metric_per_timestep(videos1, videos2, metric_fn) -> dict:
    """Apply a frame metric across (B, T, C, H, W) pairs; report the
    reference's per-timestep mean/std dict layout
    (video_metrics/calculate_psnr.py:18-51)."""
    videos1 = np.asarray(videos1)
    videos2 = np.asarray(videos2)
    assert videos1.shape == videos2.shape, (videos1.shape, videos2.shape)
    B, T = videos1.shape[:2]
    per_t = np.zeros((B, T))
    for i in range(B):
        for t in range(T):
            per_t[i, t] = metric_fn(videos1[i, t], videos2[i, t])
    return {
        "value": {t: float(per_t[:, t].mean()) for t in range(T)},
        "value_std": {t: float(per_t[:, t].std()) for t in range(T)},
        "mean": float(per_t.mean()),
        "std": float(per_t.std()),
    }
