"""Causal depthwise 1-D convolution with optional fused SiLU.

Counterpart of ``zigma_tpu/ops/causal_conv1d.py``: layout (batch, L, d),
weight (d, W) with tap W-1 on the current step.  W shifted multiply-adds,
accumulated in ``x.dtype`` by default -- the JAX package's choice, not the
CUDA reference's fp32 (PARITY.md "Documented divergences");
``accum_dtype=torch.float32`` is the ``conv_fp32_taps`` escape hatch.  Plain
torch ops: JAX has no kernel here.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["causal_conv1d"]


def causal_conv1d(x, weight, bias: Optional[torch.Tensor] = None,
                  activation: Optional[str] = "silu",
                  initial_state: Optional[torch.Tensor] = None,
                  accum_dtype: Optional[torch.dtype] = None):
    """x: (batch, L, d); weight: (d, W); bias: (d,); initial_state:
    optional (batch, W-1, d) left context (zeros by default).  Returns
    (batch, L, d) in x's dtype."""
    if activation not in (None, "silu", "swish"):
        raise ValueError(f"unsupported activation {activation!r}")
    B, L, D = x.shape
    W = weight.shape[-1]
    cdtype = x.dtype if accum_dtype is None else accum_dtype
    xf = x.to(cdtype)
    wf = weight.to(cdtype)
    if initial_state is None:
        pad = torch.zeros((B, W - 1, D), dtype=cdtype, device=x.device)
    else:
        pad = initial_state.to(cdtype)
    xp = torch.cat([pad, xf], dim=1)  # (B, L+W-1, D)
    y = torch.zeros((B, L, D), dtype=cdtype, device=x.device)
    for k in range(W):
        y = y + xp[:, k:k + L] * wf[:, k]
    if bias is not None:
        y = y + bias.to(cdtype)
    if activation is not None:
        y = F.silu(y)
    return y.to(x.dtype)
