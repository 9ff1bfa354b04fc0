"""Wrappers of the hand-written CUDA causal depthwise conv1d kernels,
``csrc/causal_conv1d.cu``: the forward (taps, bias, SiLU in one pass) and
the backward (dx in one pass, dw / dbias as per-block partials summed in a
fixed order).  No TPU kernel stands behind them: the JAX package leaves the
taps to XLA, which fuses them.  Their plain PyTorch versions are
``causal_conv1d.causal_conv1d`` (on a CPU tensor) and
``causal_conv1d.causal_conv1d_bwd_ref``.

``causal_conv1d`` sends every CUDA tensor here; these wrappers only ever
launch their kernel and raise on anything it does not take: W outside 2 to
``MAX_WIDTH``, a channel stride other than 1, tokens not evenly spaced, a
dtype other than float32 / bfloat16.  Each checks device, dtype, shape and
layout, allocates every output with ``torch.empty``, launches on
``torch.cuda.current_stream()`` without synchronising, raises if
``cudaGetLastError()`` reports a failed launch, and counts its calls in
``<wrapper>.launches`` (the backward's call launches the pass and the
partials' sum, and counts one).  A call made while the stream is captured
into a CUDA graph counts nothing; a replay launches the kernels without
calling the wrapper.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from zigma_tpu_torch.ops import _build

__all__ = ["causal_conv1d_fwd_cuda", "causal_conv1d_bwd_cuda",
           "causal_conv1d_launch_info", "MAX_WIDTH"]

SOURCE = "causal_conv1d.cu"
MAX_WIDTH = 4
_BF16 = {torch.float32: 0, torch.bfloat16: 1}
_fns = {}


def _lib_fn(name: str, argtypes, restype=ctypes.c_int):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load(SOURCE), name)
        fn.argtypes, fn.restype = argtypes, restype
        _fns[name] = fn
    return fn


_VP, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FWD_ARGS = [_VP] * 5 + [_I64, _I32, _I32, _I32, _I64] + [_I32] * 6 + [_VP]
_BWD_ARGS = ([_VP] * 10 + [_I64, _I32, _I32, _I32, _I64, _I64] + [_I32] * 7
             + [_VP])
_ROWS_ARGS = [_VP] * 4 + [_I64, _I32, _I32, _I32, _I64, _I64] + [_I32] * 3


def _flag(name: str, t: Optional[torch.Tensor]) -> int:
    if t is None:
        return 0
    if t.dtype not in _BF16:
        raise ValueError(f"{name} dtype {t.dtype}: the kernel takes float32 "
                         f"or bfloat16")
    return _BF16[t.dtype]


def _row_stride(name: str, t: torch.Tensor) -> int:
    """Elements between consecutive tokens of a (batch, L, d) tensor whose
    channels are contiguous and whose tokens are evenly spaced (a plain
    contiguous tensor, or a slice along the last dim such as ``x`` out of
    in_proj's ``xz``)."""
    s = t.stride()
    if s[2] != 1 or s[0] != t.shape[1] * s[1]:
        raise ValueError(f"{name}: the conv kernel needs unit channel stride "
                         f"and evenly spaced tokens, got strides {s}")
    return s[1]


def _check(x, weight, bias, initial_state, accum_dtype):
    """The checks both kernels share.  Returns ``(batch, L, d, W,
    initial_state contiguous or None, acc_bf16)``."""
    for name, t in (("x", x), ("weight", weight), ("bias", bias),
                    ("initial_state", initial_state)):
        if t is not None and t.device != x.device:
            raise ValueError(f"causal_conv1d kernel: {name} is on {t.device}, "
                             f"x on {x.device}; the kernel takes CUDA tensors "
                             f"on one card (a CPU tensor runs the plain "
                             f"version)")
    if x.device.type != "cuda":
        raise ValueError(f"causal_conv1d kernel: x is on {x.device}")
    if x.dim() != 3:
        raise ValueError(f"x: shape {tuple(x.shape)}, not (batch, L, d)")
    batch, L, d = x.shape
    if weight.dim() != 2 or weight.shape[0] != d:
        raise ValueError(f"weight: shape {tuple(weight.shape)}, not ({d}, W)")
    W = weight.shape[1]
    if not 2 <= W <= MAX_WIDTH:
        raise NotImplementedError(
            f"conv width {W}: the kernel takes 2 to {MAX_WIDTH} taps")
    if not weight.is_contiguous():
        raise ValueError("weight must be a contiguous (d, W) tensor")
    if bias is not None and (tuple(bias.shape) != (d,)
                             or not bias.is_contiguous()):
        raise ValueError(f"bias: shape {tuple(bias.shape)}, not a "
                         f"contiguous ({d},)")
    if initial_state is not None:
        if tuple(initial_state.shape) != (batch, W - 1, d):
            raise ValueError(f"initial_state: shape "
                             f"{tuple(initial_state.shape)} != "
                             f"{(batch, W - 1, d)}")
        initial_state = initial_state.contiguous()
    if accum_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"accum_dtype {accum_dtype}: the kernel accumulates "
                         f"in float32 or bfloat16")
    acc = x.dtype if accum_dtype is None else accum_dtype
    for name, t in (("x", x), ("weight", weight), ("bias", bias),
                    ("initial_state", initial_state)):
        _flag(name, t)
    if batch == 0 or L == 0 or d == 0:
        raise ValueError(f"x: empty shape {tuple(x.shape)}")
    return batch, L, d, W, initial_state, _BF16[acc]


def causal_conv1d_fwd_cuda(x, weight, bias: Optional[torch.Tensor] = None,
                           initial_state: Optional[torch.Tensor] = None,
                           silu: bool = True,
                           accum_dtype: Optional[torch.dtype] = None):
    """Launch the forward kernel.

    x: (batch, L, d) float32 or bfloat16, unit channel stride, evenly
    spaced tokens (read in place); weight: (d, W) contiguous, 2 <= W <= 4;
    bias: (d,); initial_state: (batch, W - 1, d) left context (zeros
    without one); weight, bias, initial_state float32 or bfloat16, rounded
    to the accumulation dtype (``accum_dtype``, else x's) as the plain
    version casts them.  Returns y (batch, L, d) contiguous in x's dtype,
    bit-equal to ``causal_conv1d``'s plain version on the card.
    """
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, weight, bias, initial_state)):
        raise NotImplementedError(
            "causal_conv1d_fwd_cuda does not record a gradient: call "
            "causal_conv1d, whose backward is the conv backward kernel, or "
            "run under torch.no_grad()")
    batch, L, d, W, init, acc_bf16 = _check(x, weight, bias, initial_state,
                                            accum_dtype)
    x_row = _row_stride("x", x)
    y = torch.empty((batch, L, d), dtype=x.dtype, device=x.device)
    fn = _lib_fn("zt_causal_conv1d_fwd", _FWD_ARGS)
    err = fn(x.data_ptr(), weight.data_ptr(), _ptr(bias), _ptr(init),
             y.data_ptr(), batch, L, d, W, x_row, _BF16[x.dtype],
             _BF16[weight.dtype], _flag("bias", bias), _flag("init", init),
             acc_bf16, int(silu), _stream(x))
    if err != 0:
        raise RuntimeError(f"causal_conv1d_fwd kernel launch failed: CUDA "
                           f"error {err} at shape {(batch, L, d)}, W {W}, "
                           f"{x.dtype}")
    if not torch.cuda.is_current_stream_capturing():
        causal_conv1d_fwd_cuda.launches += 1
    return y


causal_conv1d_fwd_cuda.launches = 0


def causal_conv1d_bwd_cuda(x, weight, bias: Optional[torch.Tensor], dy,
                           initial_state: Optional[torch.Tensor] = None,
                           silu: bool = True,
                           accum_dtype: Optional[torch.dtype] = None):
    """Launch the backward kernel and the sum of its partials.

    The inputs of ``causal_conv1d_fwd_cuda`` and dy (batch, L, d), the
    cotangent of its output, in x's dtype (made contiguous where its
    channels are not).  Returns ``(dx, dw, dbias, dinit)``: dx (batch, L,
    d) contiguous in x's dtype, dw (d, W) in weight's dtype, dbias (d,) in
    bias's (None without a bias), dinit (batch, W - 1, d) in
    initial_state's (None without one); all summed in float32 and rounded
    once, the same bits in every run.
    """
    batch, L, d, W, init, acc_bf16 = _check(x, weight, bias, initial_state,
                                            accum_dtype)
    if tuple(dy.shape) != (batch, L, d) or dy.dtype != x.dtype:
        raise ValueError(f"dy: {tuple(dy.shape)} {dy.dtype}, not "
                         f"{(batch, L, d)} {x.dtype}")
    if dy.stride(-1) != 1 or dy.stride(0) != L * dy.stride(1):
        dy = dy.contiguous()
    x_row, dy_row = _row_stride("x", x), _row_stride("dy", dy)
    dev = x.device
    dx = torch.empty((batch, L, d), dtype=x.dtype, device=dev)
    rows = _lib_fn("zt_causal_conv1d_bwd_rows", _ROWS_ARGS, _I64)(
        x.data_ptr(), _ptr(init), dy.data_ptr(), dx.data_ptr(), batch, L, d, W,
        x_row, dy_row, _BF16[x.dtype], acc_bf16, int(silu))
    partials = torch.empty((rows, W + 1, d), dtype=torch.float32, device=dev)
    dw = torch.empty((d, W), dtype=weight.dtype, device=dev)
    db = None if bias is None else torch.empty_like(bias)
    dinit = None if init is None else torch.empty_like(init)
    fn = _lib_fn("zt_causal_conv1d_bwd", _BWD_ARGS)
    err = fn(x.data_ptr(), weight.data_ptr(), _ptr(bias), _ptr(init),
             dy.data_ptr(), dx.data_ptr(), dw.data_ptr(), _ptr(db),
             _ptr(dinit), partials.data_ptr(), batch, L, d, W, x_row, dy_row,
             _BF16[x.dtype], _BF16[weight.dtype], _flag("bias", bias),
             _flag("init", init), _flag("init", init), acc_bf16, int(silu),
             _stream(x))
    if err != 0:
        raise RuntimeError(f"causal_conv1d_bwd kernel launch failed: CUDA "
                           f"error {err} at shape {(batch, L, d)}, W {W}, "
                           f"{x.dtype}")
    if not torch.cuda.is_current_stream_capturing():
        causal_conv1d_bwd_cuda.launches += 1
    return dx, dw, db, dinit


causal_conv1d_bwd_cuda.launches = 0


def causal_conv1d_launch_info(backward: bool, dtype) -> dict:
    """The W = 4 instance of the forward or backward kernel the models run
    in ``dtype`` (bf16: the packed kernels of the SiLU case) on the current
    card: registers and spill bytes a thread, resident blocks (of 128
    threads) an SM.  Launches nothing."""
    info = (ctypes.c_int * 3)()
    fn = _lib_fn("zt_causal_conv1d_info", [_I32, _I32, _VP])
    err = fn(int(backward), _BF16[dtype], ctypes.addressof(info))
    if err != 0:
        raise RuntimeError(f"zt_causal_conv1d_info failed: CUDA error {err}")
    return dict(zip(("registers", "spill_bytes", "blocks_per_sm"), info))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(x: torch.Tensor) -> int:
    """The current stream of x's card, as a raw handle (no Stream object:
    the sampling path calls the forward some 1,200 times a batch)."""
    return torch._C._cuda_getCurrentRawStream(x.get_device())
