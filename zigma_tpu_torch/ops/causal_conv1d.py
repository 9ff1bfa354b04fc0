"""Causal depthwise 1-D convolution with optional fused SiLU.

Counterpart of ``zigma_tpu/ops/causal_conv1d.py``: layout (batch, L, d),
weight (d, W) with tap W-1 on the current step.  W shifted multiply-adds,
accumulated in ``x.dtype`` by default -- the JAX package's choice, not the
CUDA reference's fp32 (PARITY.md "Documented divergences");
``accum_dtype=torch.float32`` is the ``conv_fp32_taps`` escape hatch.  Plain
torch ops: JAX has no kernel here.

``causal_conv1d_update`` is the one-token decode step over a rolling window
of the last W inputs, with the same taps in the same order and the same
accumulation dtype, so a prefill and the steps that follow it compute each
position alike.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["causal_conv1d", "causal_conv1d_update"]


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


def causal_conv1d_update(x, conv_state, weight,
                         bias: Optional[torch.Tensor] = None,
                         activation: Optional[str] = "silu",
                         accum_dtype: Optional[torch.dtype] = None):
    """One decode token.  x: (batch, d); conv_state: (batch, W, d), the
    last W inputs with the newest last.  Returns ``(y (batch, d) in x's
    dtype, the new window)``; the window is a new tensor in the promoted
    dtype of x and conv_state, as ``zigma_tpu/ops/causal_conv1d.py::
    causal_conv1d_update`` returns it."""
    if activation not in (None, "silu", "swish"):
        raise ValueError(f"unsupported activation {activation!r}")
    W = weight.shape[-1]
    new_state = torch.cat([conv_state[:, 1:], x[:, None]], dim=1)
    cdtype = x.dtype if accum_dtype is None else accum_dtype
    wf = weight.to(cdtype)
    st = new_state.to(cdtype)
    y = torch.zeros_like(st[:, 0])
    for k in range(W):  # the order of causal_conv1d's taps
        y = y + st[:, k] * wf[:, k]
    if bias is not None:
        y = y + bias.to(cdtype)
    if activation is not None:
        y = F.silu(y)
    return y.to(x.dtype), new_state
