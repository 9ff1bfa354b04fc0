"""Wrapper of the hand-written CUDA selective-scan forward kernel.

The kernel (``csrc/selective_scan_fwd.cu``) replaces the TPU kernel
``zigma_tpu/ops/scan_pallas.py::_scan_kernel`` (``scan_core_fwd_pallas``).
Its plain PyTorch version is ``selective_scan.selective_scan_ref``, which
``selective_scan`` runs for tensors on the CPU; this wrapper only ever
launches the kernel and raises on anything it does not take.

The wrapper checks device, dtype, shape and layout, allocates every output
with ``torch.empty``, launches on ``torch.cuda.current_stream()`` without
synchronising, raises if ``cudaGetLastError()`` reports a failed launch, and
counts its launches in ``selective_scan_fwd_cuda.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from zigma_tpu_torch.ops import _build

__all__ = ["selective_scan_fwd_cuda", "CARRY_EVERY", "MAX_D_STATE"]

SOURCE = "selective_scan_fwd.cu"
CARRY_EVERY = 128   # chunk-start state period (the Pallas kernel's block_l)
MAX_D_STATE = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load(SOURCE).zt_selective_scan_fwd
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [vp] * 12 + [i32] * 4 + [i64] * 5 + [i32, vp]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _row_stride(name: str, t: torch.Tensor, shape) -> int:
    """Elements between consecutive tokens of a (batch, L, C) tensor whose
    channels are contiguous and whose tokens are evenly spaced (a plain
    contiguous tensor, or a slice along the last dim such as ``z`` out of
    ``xz``)."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if t.stride(2) != 1 or t.stride(0) != t.shape[1] * t.stride(1):
        raise ValueError(f"{name}: needs unit channel stride and evenly "
                         f"spaced tokens, got strides {t.stride()}")
    return t.stride(1)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def selective_scan_fwd_cuda(u, delta, A, B, C, delta_bias,
                            D: Optional[torch.Tensor] = None,
                            z: Optional[torch.Tensor] = None,
                            x0: Optional[torch.Tensor] = None,
                            return_carries: bool = True):
    """Launch the forward kernel; it always takes dt = softplus(delta +
    delta_bias).

    u, delta: (batch, L, d) float32 or bfloat16; A: (d, N) float32 real;
    B, C: (batch, L, N) in u's dtype; delta_bias: (d,) float32;
    D (d,) float32 together with z (batch, L, d): fused ``(y + u*D)*silu(z)``;
    x0: optional (batch, N, d) float32 seed state.

    Returns ``(out, carries, x_last)``: out (batch, L, d) in u's dtype,
    carries (batch, ceil(L/128), N, d) float32 chunk-start states (None when
    ``return_carries`` is false), x_last (batch, N, d) float32.
    """
    tensors = dict(u=u, delta=delta, A=A, B=B, C=C, delta_bias=delta_bias,
                   D=D, z=z, x0=x0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors.values()):
        raise NotImplementedError(
            "selective_scan_fwd_cuda is forward-only: the backward kernel "
            "(the port of scan_pallas._scan_bwd_kernel) lands with the "
            "training slice; run under torch.inference_mode()")
    for name, t in tensors.items():
        if t is not None and t.device.type != "cuda":
            raise ValueError(f"selective_scan_fwd_cuda: {name} is on "
                             f"{t.device}; the kernel takes CUDA tensors "
                             f"(selective_scan runs the plain version on CPU)")
    if A.is_complex() or B.is_complex() or C.is_complex():
        raise NotImplementedError("complex A/B/C (the S4D-complex mode) lands "
                                  "in a later slice of the port")
    if B.dim() != 3 or C.dim() != 3:
        raise NotImplementedError(
            f"the kernel takes variable B/C of shape (batch, L, N); grouped "
            f"or static B/C (got {tuple(B.shape)}, {tuple(C.shape)}) land in "
            f"a later slice of the port")
    if (D is None) != (z is None):
        raise ValueError("the fused gate needs D and z together")
    batch, L, d = u.shape
    N = A.shape[1]
    if N > MAX_D_STATE:
        raise NotImplementedError(f"d_state {N} > {MAX_D_STATE}: larger "
                                  f"states land in a later slice of the port")
    dtype = u.dtype
    if dtype not in _DTYPES:
        raise ValueError(f"u dtype {dtype}: the kernel takes float32 or bfloat16")
    for name in ("delta", "B", "C", "z"):
        t = tensors[name]
        if t is not None and t.dtype != dtype:
            raise ValueError(f"{name} dtype {t.dtype} != u dtype {dtype}")
    for name in ("A", "delta_bias", "D", "x0"):
        t = tensors[name]
        if t is None and name in ("D", "x0"):
            continue
        if t is None or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor")
    if tuple(A.shape) != (d, N) or tuple(delta_bias.shape) != (d,):
        raise ValueError(f"A {tuple(A.shape)} / delta_bias "
                         f"{tuple(delta_bias.shape)} do not match d={d}, N={N}")
    if D is not None and tuple(D.shape) != (d,):
        raise ValueError(f"D shape {tuple(D.shape)} != ({d},)")
    if x0 is not None and tuple(x0.shape) != (batch, N, d):
        raise ValueError(f"x0 shape {tuple(x0.shape)} != {(batch, N, d)}")
    rows = [_row_stride("u", u, (batch, L, d)),
            _row_stride("delta", delta, (batch, L, d)),
            _row_stride("B", B, (batch, L, N)),
            _row_stride("C", C, (batch, L, N)),
            0 if z is None else _row_stride("z", z, (batch, L, d))]

    out = torch.empty((batch, L, d), dtype=dtype, device=u.device)
    n_chunks = -(-L // CARRY_EVERY)
    carries = (torch.empty((batch, n_chunks, N, d), dtype=torch.float32,
                           device=u.device) if return_carries else None)
    x_last = torch.empty((batch, N, d), dtype=torch.float32, device=u.device)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    err = _kernel()(
        _ptr(u), _ptr(delta), _ptr(A), _ptr(delta_bias), _ptr(B), _ptr(C),
        _ptr(x0), _ptr(D), _ptr(z), _ptr(out), _ptr(carries), _ptr(x_last),
        batch, L, d, N, *rows, _DTYPES[dtype], stream)
    if err != 0:
        raise RuntimeError(f"selective_scan_fwd kernel launch failed: CUDA "
                           f"error {err} at shape {(batch, L, d, N)} {dtype}")
    selective_scan_fwd_cuda.launches += 1
    return out, carries, x_last


selective_scan_fwd_cuda.launches = 0
