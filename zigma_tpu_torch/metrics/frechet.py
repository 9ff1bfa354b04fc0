"""Fréchet-distance machinery shared by FID / sFID / FDD / FVD.

The reference computes these through torchmetrics' FrechetInceptionDistance
and custom subclasses (reference: utils/torchmetric_sfid.py,
utils/torchmetric_fdd.py, utils/torchmetric_fvd.py, my_metrics.py:13-115).
Here the statistic itself is dependency-free numpy/scipy (float64, matching
torchmetrics' internal accumulation), with feature extraction pluggable —
the same Fréchet math serves images (Inception/DINOv2 features) and video
(I3D features).

The port's own copy of ``zigma_tpu/metrics/frechet.py`` (numpy / scipy only):
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np
from scipy import linalg

__all__ = ["RunningMoments", "frechet_distance"]


class RunningMoments:
    """Streaming mean/covariance accumulator in float64.

    Same accumulation scheme as torchmetrics FID (sum, outer-product sum,
    count), so results match bit-for-bit given the same features.
    """

    def __init__(self, dim: int):
        self.dim = dim
        self.reset()

    def reset(self):
        self.n = 0
        self.sum = np.zeros(self.dim, np.float64)
        self.outer = np.zeros((self.dim, self.dim), np.float64)

    def update(self, feats: np.ndarray):
        feats = np.asarray(feats, np.float64)
        assert feats.ndim == 2 and feats.shape[1] == self.dim, feats.shape
        self.n += feats.shape[0]
        self.sum += feats.sum(axis=0)
        self.outer += feats.T @ feats

    def merge(self, other: "RunningMoments"):
        """Combine accumulators (the distributed all-gather reduction)."""
        self.n += other.n
        self.sum += other.sum
        self.outer += other.outer

    def state(self):
        return {"n": np.asarray(self.n), "sum": self.sum, "outer": self.outer}

    def load_state(self, state):
        self.n = int(state["n"])
        self.sum = np.asarray(state["sum"], np.float64)
        self.outer = np.asarray(state["outer"], np.float64)

    def finalize(self):
        if self.n < 2:
            raise ValueError(f"need >= 2 samples, got {self.n}")
        mu = self.sum / self.n
        # unbiased covariance, as torchmetrics
        cov = (self.outer - self.n * np.outer(mu, mu)) / (self.n - 1)
        return mu, cov


def frechet_distance(mu1, cov1, mu2, cov2, eps: float = 1e-6) -> float:
    """||mu1-mu2||^2 + Tr(C1 + C2 - 2 sqrt(C1 C2)).

    Matrix sqrt via scipy sqrtm with the standard jitter fallback —
    numerically identical to torch-fidelity/torchmetrics' approach.
    """
    mu1, mu2 = np.asarray(mu1), np.asarray(mu2)
    cov1, cov2 = np.asarray(cov1), np.asarray(cov2)
    diff = mu1 - mu2

    covmean = linalg.sqrtm(cov1 @ cov2)
    if not np.isfinite(covmean).all():
        offset = np.eye(cov1.shape[0]) * eps
        covmean = linalg.sqrtm((cov1 + offset) @ (cov2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2)
                 - 2 * np.trace(covmean))
