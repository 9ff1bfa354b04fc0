"""Distributional sample-quality metrics: KID, Inception Score, PRDC.

Dependency-free ports of the vendored torchmetrics implementations the
reference uses (reference: utils/torchmetric_kid.py,
utils/torchmetric_inception.py, utils/torchmetric_prdc.py:32-108).
Feature extraction is pluggable (see features.py); the statistics here take
raw feature / logit arrays.

The port's own copy of ``zigma_tpu/metrics/distributional.py`` (numpy / scipy only):
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

__all__ = ["kid", "inception_score", "prdc"]


def _poly_kernel(x, y, degree=3, gamma=None, coef=1.0):
    if gamma is None:
        gamma = 1.0 / x.shape[1]
    return (x @ y.T * gamma + coef) ** degree


def _mmd2(kxx, kyy, kxy):
    m = kxx.shape[0]
    diag_x = np.trace(kxx)
    diag_y = np.trace(kyy)
    kt_xx = (kxx.sum() - diag_x) / (m * (m - 1))
    kt_yy = (kyy.sum() - diag_y) / (m * (m - 1))
    k_xy = kxy.sum() / (m * m)
    return kt_xx + kt_yy - 2 * k_xy


def kid(real_feats, fake_feats, subsets: int = 100, subset_size: int = 1000,
        degree: int = 3, gamma=None, coef: float = 1.0, seed: int = 0):
    """Kernel Inception Distance (polynomial-kernel MMD^2 over subsets).

    Matches torchmetrics KernelInceptionDistance defaults; the reference
    uses subset_size=50 (my_metrics.py:34-38).
    Returns (mean, std) over subsets.
    """
    real = np.asarray(real_feats, np.float64)
    fake = np.asarray(fake_feats, np.float64)
    n = min(real.shape[0], fake.shape[0])
    subset_size = min(subset_size, n)
    rng = np.random.default_rng(seed)
    vals = []
    for _ in range(subsets):
        ri = rng.choice(real.shape[0], subset_size, replace=False)
        fi = rng.choice(fake.shape[0], subset_size, replace=False)
        x, y = real[ri], fake[fi]
        kxx = _poly_kernel(x, x, degree, gamma, coef)
        kyy = _poly_kernel(y, y, degree, gamma, coef)
        kxy = _poly_kernel(x, y, degree, gamma, coef)
        vals.append(_mmd2(kxx, kyy, kxy))
    vals = np.asarray(vals)
    return float(vals.mean()), float(vals.std())


def inception_score(logits, splits: int = 10):
    """IS from classifier logits: exp(E_x KL(p(y|x) || p(y))).

    Matches torchmetrics InceptionScore (reference vendored copy
    utils/torchmetric_inception.py).  Returns (mean, std) over splits.
    """
    logits = np.asarray(logits, np.float64)
    logits = logits - logits.max(axis=1, keepdims=True)
    probs = np.exp(logits)
    probs /= probs.sum(axis=1, keepdims=True)
    n = probs.shape[0]
    scores = []
    for part in np.array_split(probs, splits):
        if len(part) == 0:
            continue
        py = part.mean(axis=0, keepdims=True)
        kl = (part * (np.log(part + 1e-16) - np.log(py + 1e-16))).sum(axis=1)
        scores.append(np.exp(kl.mean()))
    scores = np.asarray(scores)
    return float(scores.mean()), float(scores.std())


def prdc(real_feats, fake_feats, nearest_k: int = 5):
    """Precision / recall / density / coverage via kNN radii
    (reference: utils/torchmetric_prdc.py:32-108, k=5 per my_metrics.py:43).
    """
    real = np.asarray(real_feats, np.float64)
    fake = np.asarray(fake_feats, np.float64)
    n = min(real.shape[0], fake.shape[0])
    if n < 2:
        raise ValueError(f"prdc needs >= 2 real and fake samples, got {n}")
    # small in-training eval sets (sample_fid_n) may hold fewer than k+1
    # samples; clamp like kid clamps subset_size instead of IndexError-ing
    nearest_k = min(nearest_k, n - 1)

    def pairwise(a, b):
        return np.sqrt(np.maximum(
            (a**2).sum(1)[:, None] + (b**2).sum(1)[None] - 2 * a @ b.T, 0))

    def knn_radius(x, k):
        d = pairwise(x, x)
        return np.sort(d, axis=1)[:, k]  # k-th NN excluding self (col 0)

    r_real = knn_radius(real, nearest_k)
    r_fake = knn_radius(fake, nearest_k)
    d_rf = pairwise(real, fake)

    precision = float((d_rf < r_real[:, None]).any(axis=0).mean())
    recall = float((d_rf < r_fake[None]).any(axis=1).mean())
    density = float((d_rf < r_real[:, None]).sum(axis=0).mean() / nearest_k)
    coverage = float((d_rf.min(axis=1) < r_real).mean())
    return {"precision": precision, "recall": recall,
            "density": density, "coverage": coverage}
