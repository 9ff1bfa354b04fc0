"""RMSNorm / LayerNorm with the Mamba prenorm-residual contract.

Counterpart of ``zigma_tpu/ops/norms.py``:

    residual = x (+ residual)      kept in float32 when residual_in_fp32
    out      = norm(residual)      returned in x's dtype

``prenorm=True`` returns ``(out, residual)``.  Plain torch ops: JAX has no
kernel here either (XLA fuses the chain).
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["rms_norm", "layer_norm", "add_norm"]


def rms_norm(x, weight, bias=None, eps: float = 1e-5):
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def layer_norm(x, weight=None, bias=None, eps: float = 1e-5):
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def add_norm(x, weight, bias=None, residual: Optional[torch.Tensor] = None, *,
             kind: str = "rms", eps: float = 1e-5, prenorm: bool = False,
             residual_in_fp32: bool = True):
    """``residual = x (+ residual); out = norm(residual)``; returns
    ``(out, residual)`` when prenorm, else ``out``."""
    res = x if residual is None else x.to(residual.dtype) + residual
    if residual_in_fp32:
        res = res.float()
    norm_fn = rms_norm if kind == "rms" else layer_norm
    # normalise the (possibly fp32) residual itself, as the JAX package does
    out = norm_fn(res, weight, bias, eps).to(x.dtype)
    return (out, res) if prenorm else out
