"""Causal depthwise 1-D convolution with optional fused SiLU.

Counterpart of ``zigma_tpu/ops/causal_conv1d.py``: layout (batch, L, d),
weight (d, W) with tap W-1 on the current step.  W shifted multiply-adds,
accumulated in ``x.dtype`` by default -- the JAX package's choice, not the
CUDA reference's fp32 (PARITY.md "Documented divergences");
``accum_dtype=torch.float32`` is the ``conv_fp32_taps`` escape hatch.

On a CUDA tensor ``causal_conv1d`` runs the hand-written kernels of
``csrc/causal_conv1d.cu`` (``conv_cuda``): the forward in one pass,
bit-equal to the plain version on the card, and under autograd the
registered operator ``zigma::causal_conv1d_fwd``, whose backward is the
backward kernel.  What the kernels do not take (W outside 2 to 4, a
channel stride other than 1, tokens not evenly spaced) raises; nothing
falls back.  A CPU tensor runs the plain torch ops of
``causal_conv1d_ref`` (JAX has no kernel here: XLA fuses them);
``causal_conv1d_bwd_ref`` is the backward kernel's plain version.

``causal_conv1d_update`` is the one-token decode step over a rolling window
of the last W inputs, with the same taps in the same order and the same
accumulation dtype, so a prefill and the steps that follow it compute each
position alike.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from zigma_tpu_torch.ops.conv_cuda import (causal_conv1d_bwd_cuda,
                                           causal_conv1d_fwd_cuda)

__all__ = ["causal_conv1d", "causal_conv1d_ref", "causal_conv1d_update",
           "causal_conv1d_bwd_ref", "causal_conv1d_fwd_op"]


def causal_conv1d(x, weight, bias: Optional[torch.Tensor] = None,
                  activation: Optional[str] = "silu",
                  initial_state: Optional[torch.Tensor] = None,
                  accum_dtype: Optional[torch.dtype] = None):
    """x: (batch, L, d); weight: (d, W); bias: (d,); initial_state:
    optional (batch, W-1, d) left context (zeros by default).  Returns
    (batch, L, d) in x's dtype: the kernel's on a CUDA tensor (through the
    registered operator when a gradient is needed), ``causal_conv1d_ref``'s
    on a CPU one."""
    if activation not in (None, "silu", "swish"):
        raise ValueError(f"unsupported activation {activation!r}")
    if x.device.type != "cuda":
        return causal_conv1d_ref(x, weight, bias, activation, initial_state,
                                 accum_dtype)
    silu = activation is not None
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, weight, bias, initial_state)):
        return causal_conv1d_fwd_op(x, weight, bias, initial_state, silu,
                                    accum_dtype)
    return causal_conv1d_fwd_cuda(x, weight, bias, initial_state, silu,
                                  accum_dtype)


def causal_conv1d_ref(x, weight, bias: Optional[torch.Tensor] = None,
                      activation: Optional[str] = "silu",
                      initial_state: Optional[torch.Tensor] = None,
                      accum_dtype: Optional[torch.dtype] = None):
    """The plain version, on any device: the arguments and result of
    ``causal_conv1d``."""
    if activation not in (None, "silu", "swish"):
        raise ValueError(f"unsupported activation {activation!r}")
    _, _, y = _taps(x, weight, bias, initial_state,
                    x.dtype if accum_dtype is None else accum_dtype)
    if activation is not None:
        y = F.silu(y)
    return y.to(x.dtype)


def _taps(x, weight, bias, initial_state, cdtype):
    """The plain version's padded input (batch, L+W-1, d), taps (d, W) and
    pre-activation (batch, L, d), all in ``cdtype``: W shifted
    multiply-adds from tap 0, then the bias."""
    B, L, D = x.shape
    W = weight.shape[-1]
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
    return xp, wf, y


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


def causal_conv1d_bwd_ref(x, weight, bias, dy,
                          initial_state: Optional[torch.Tensor] = None,
                          activation: Optional[str] = "silu",
                          accum_dtype: Optional[torch.dtype] = None):
    """The backward kernel's plain version: the pre-activation recomputed as
    ``causal_conv1d`` rounds it (in the accumulation dtype), then, in
    float32 (float64 for float64 inputs), dpre = dy * silu'(pre), dx
    (tap by tap within the sequence), dw over the padded input, dbias and
    the left context's cotangent.  Returns ``(dx, dw, dbias, dinit)`` in
    the dtypes of x, weight, bias and initial_state (None for a missing
    bias or initial_state)."""
    if activation not in (None, "silu", "swish"):
        raise ValueError(f"unsupported activation {activation!r}")
    B, L, D = x.shape
    W = weight.shape[-1]
    cdtype = x.dtype if accum_dtype is None else accum_dtype
    gdtype = torch.promote_types(cdtype, torch.float32)
    with torch.no_grad():
        xp, wf, pre = _taps(x, weight, bias, initial_state, cdtype)
        pre, g = pre.to(gdtype), dy.to(gdtype)
        if activation is not None:
            s = torch.sigmoid(pre)
            g = g * (s * (1 + pre * (1 - s)))
        wg, xg = wf.to(gdtype), xp.to(gdtype)
        dxp = torch.zeros((B, L + W - 1, D), dtype=gdtype, device=x.device)
        for k in range(W):
            dxp[:, k:k + L] += g * wg[:, k]
        dw = torch.stack([(g * xg[:, k:k + L]).sum((0, 1)) for k in range(W)],
                         dim=-1)
        return (dxp[:, W - 1:].to(x.dtype), dw.to(weight.dtype),
                None if bias is None else g.sum((0, 1)).to(bias.dtype),
                None if initial_state is None
                else dxp[:, :W - 1].to(initial_state.dtype))


# The conv as a registered operator: autograd records it as one node whose
# backward is the backward kernel, remat recomputes it as one op, and a
# selective-checkpoint policy sees it by name.  A CPU tensor runs the plain
# version forward and ``causal_conv1d_bwd_ref`` backward.
@torch.library.custom_op("zigma::causal_conv1d_fwd", mutates_args=())
def causal_conv1d_fwd_op(x: torch.Tensor, weight: torch.Tensor,
                         bias: Optional[torch.Tensor],
                         initial_state: Optional[torch.Tensor], silu: bool,
                         accum_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``causal_conv1d``'s output (batch, L, d) in x's dtype, SiLU or none."""
    with torch.no_grad():
        if x.device.type != "cuda":
            return causal_conv1d_ref(x, weight, bias,
                                     "silu" if silu else None, initial_state,
                                     accum_dtype)
        return causal_conv1d_fwd_cuda(x, weight, bias, initial_state, silu,
                                      accum_dtype)


@causal_conv1d_fwd_op.register_fake
def _(x, weight, bias, initial_state, silu, accum_dtype):
    return x.new_empty(x.shape)


def _conv_setup(ctx, inputs, output):
    x, weight, bias, initial_state, silu, accum_dtype = inputs
    ctx.save_for_backward(x, weight, bias, initial_state)
    ctx.silu, ctx.accum_dtype = silu, accum_dtype


def _conv_backward(ctx, dy):
    x, weight, bias, initial_state = ctx.saved_tensors
    if x.device.type == "cuda":
        dx, dw, db, dinit = causal_conv1d_bwd_cuda(
            x, weight, bias, dy, initial_state, ctx.silu, ctx.accum_dtype)
    else:
        dx, dw, db, dinit = causal_conv1d_bwd_ref(
            x, weight, bias, dy, initial_state,
            "silu" if ctx.silu else None, ctx.accum_dtype)
    return dx, dw, db, dinit, None, None


causal_conv1d_fwd_op.register_autograd(_conv_backward,
                                       setup_context=_conv_setup)
