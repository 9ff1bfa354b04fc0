"""Wrappers of the hand-written CUDA selective-scan kernels.

- K1, ``csrc/selective_scan_fwd.cu``, replaces the TPU kernel
  ``zigma_tpu/ops/scan_pallas.py::_scan_kernel`` (``scan_core_fwd_pallas``);
  its plain PyTorch version is ``selective_scan.selective_scan_ref``.
- K2, ``csrc/selective_scan_bwd.cu``, replaces ``_scan_bwd_kernel``
  (``scan_core_bwd_pallas``); its plain version is
  ``selective_scan.selective_scan_bwd_ref``.

``selective_scan`` runs the plain versions for tensors on the CPU; these
wrappers only ever launch their kernel and raise on anything it does not
take.  Each checks device, dtype, shape and layout, allocates every output
with ``torch.empty``, launches on ``torch.cuda.current_stream()`` without
synchronising, raises if ``cudaGetLastError()`` reports a failed launch, and
counts its launches in ``<wrapper>.launches``.  One wrapper call takes any
batch and counts one launch: past the grid's 65535 sequences the C entry
point launches the kernel on slices of the batch.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from zigma_tpu_torch.ops import _build

__all__ = ["selective_scan_fwd_cuda", "selective_scan_bwd_cuda",
           "selective_scan_fwd_launch_info", "selective_scan_bwd_launch_info",
           "CARRY_EVERY", "MAX_D_STATE"]

SOURCE = "selective_scan_fwd.cu"
SOURCE_BWD = "selective_scan_bwd.cu"
CARRY_EVERY = 128   # chunk-start state period (the Pallas kernel's block_l)
MAX_D_STATE = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None
_bwd = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load(SOURCE).zt_selective_scan_fwd
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [vp] * 12 + [i32] * 4 + [i64] * 5 + [i32, vp]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch_info(source: str, symbol: str, steps_key: str, N: int, L: int,
                 dtype) -> dict:
    fn = getattr(_build.load(source), symbol)
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    keys = ("registers", "spill_bytes", "blocks_per_sm", "threads",
            "channels_per_block", steps_key, "shared_bytes")
    info = (ctypes.c_int * len(keys))()
    err = fn(N, L, _DTYPES[dtype], ctypes.addressof(info))
    if err != 0:
        raise RuntimeError(f"{symbol} failed: CUDA error {err} at N={N}, "
                           f"L={L}, {dtype}")
    return dict(zip(keys, info))


def selective_scan_fwd_launch_info(N: int, L: int, dtype) -> dict:
    """The forward kernel's launch shape and occupancy for d_state ``N``,
    length ``L`` and ``dtype`` on the current card: registers and spill
    bytes a thread (from the compiled kernel), resident blocks an SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), threads and
    channels a block, steps staged a chunk and dynamic shared bytes a block.
    Launches nothing."""
    return _launch_info(SOURCE, "zt_selective_scan_fwd_info",
                        "steps_per_chunk", N, L, dtype)


def selective_scan_bwd_launch_info(N: int, L: int, dtype) -> dict:
    """The backward kernel's launch shape and occupancy, with the keys of
    ``selective_scan_fwd_launch_info`` (``steps_per_tile`` in place of
    ``steps_per_chunk``: the steps staged a tile).  Launches nothing."""
    return _launch_info(SOURCE_BWD, "zt_selective_scan_bwd_info",
                        "steps_per_tile", N, L, dtype)


def _bwd_kernel():
    global _bwd
    if _bwd is None:
        lib = _build.load(SOURCE_BWD)
        fn = lib.zt_selective_scan_bwd
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [vp] * 19 + [i32] * 4 + [i64] * 5 + [i32, vp]
        fn.restype = ctypes.c_int
        cpb = lib.zt_selective_scan_bwd_channels_per_block
        cpb.argtypes, cpb.restype = [i32], i32
        _bwd = (fn, cpb)
    return _bwd


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


def _check_scan_inputs(who: str, tensors: dict, fp32_names):
    """The checks both kernels share.  Returns
    ``(batch, L, d, N, dtype, row strides of u, delta, B, C, z)``."""
    u, delta, A, B, C = (tensors[k] for k in ("u", "delta", "A", "B", "C"))
    D, z, delta_bias = tensors["D"], tensors["z"], tensors["delta_bias"]
    for name, t in tensors.items():
        if t is not None and t.device.type != "cuda":
            raise ValueError(f"{who}: {name} is on {t.device}; the kernel "
                             f"takes CUDA tensors (selective_scan runs the "
                             f"plain version on CPU)")
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
    for name in ("delta", "B", "C", "z", "gy"):
        t = tensors.get(name)
        if t is not None and t.dtype != dtype:
            raise ValueError(f"{name} dtype {t.dtype} != u dtype {dtype}")
    for name in fp32_names:
        t = tensors[name]
        if t is None and name not in ("A", "delta_bias"):
            continue
        if t is None or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor")
    if tuple(A.shape) != (d, N) or tuple(delta_bias.shape) != (d,):
        raise ValueError(f"A {tuple(A.shape)} / delta_bias "
                         f"{tuple(delta_bias.shape)} do not match d={d}, N={N}")
    if D is not None and tuple(D.shape) != (d,):
        raise ValueError(f"D shape {tuple(D.shape)} != ({d},)")
    rows = [_row_stride("u", u, (batch, L, d)),
            _row_stride("delta", delta, (batch, L, d)),
            _row_stride("B", B, (batch, L, N)),
            _row_stride("C", C, (batch, L, N)),
            0 if z is None else _row_stride("z", z, (batch, L, d))]
    return batch, L, d, N, dtype, rows


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
            "selective_scan_fwd_cuda does not record a gradient: call "
            "selective_scan (or SelectiveScanFn), whose backward is the K2 "
            "kernel, or run under torch.no_grad()")
    batch, L, d, N, dtype, rows = _check_scan_inputs(
        "selective_scan_fwd_cuda", tensors, ("A", "delta_bias", "D", "x0"))
    if x0 is not None and tuple(x0.shape) != (batch, N, d):
        raise ValueError(f"x0 shape {tuple(x0.shape)} != {(batch, N, d)}")

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


def selective_scan_bwd_cuda(u, delta, delta_bias, A, B, C, carries, gy,
                            g_last: Optional[torch.Tensor] = None,
                            D: Optional[torch.Tensor] = None,
                            z: Optional[torch.Tensor] = None):
    """Launch the backward kernel (dt = softplus(delta + delta_bias)).

    The inputs of ``selective_scan_fwd_cuda`` plus carries (batch,
    ceil(L/128), N, d) float32 (the forward's chunk-start states), gy
    (batch, L, d) in u's dtype (the cotangent of the gated output when D and
    z are given, else of the raw scan output; made contiguous here) and
    g_last, an optional (batch, N, d) float32 cotangent of the final state.

    Returns ``(du, ddelta, dA, dB, dC, dbias, dx0)`` and, with D and z,
    also ``(dz, dD)``, in the types of ``selective_scan_bwd_ref``: du,
    ddelta, dz in u's dtype; dB, dC in B's dtype (the kernel's per-d-block
    fp32 partials summed here); dA (d, N), dbias (d,), dx0 (batch, N, d),
    dD (d,) float32.
    """
    gy = gy.contiguous()
    tensors = dict(u=u, delta=delta, A=A, B=B, C=C, delta_bias=delta_bias,
                   D=D, z=z, carries=carries, gy=gy, g_last=g_last)
    batch, L, d, N, dtype, rows = _check_scan_inputs(
        "selective_scan_bwd_cuda", tensors,
        ("A", "delta_bias", "D", "carries", "g_last"))
    n_chunks = -(-L // CARRY_EVERY)
    if tuple(carries.shape) != (batch, n_chunks, N, d):
        raise ValueError(f"carries shape {tuple(carries.shape)} != "
                         f"{(batch, n_chunks, N, d)}")
    if tuple(gy.shape) != (batch, L, d):
        raise ValueError(f"gy shape {tuple(gy.shape)} != {(batch, L, d)}")
    if g_last is not None and tuple(g_last.shape) != (batch, N, d):
        raise ValueError(f"g_last shape {tuple(g_last.shape)} != "
                         f"{(batch, N, d)}")
    fn, channels_per_block = _bwd_kernel()
    n_blocks = -(-d // channels_per_block(N))
    dev = u.device
    f32 = dict(dtype=torch.float32, device=dev)
    du = torch.empty((batch, L, d), dtype=dtype, device=dev)
    ddelta = torch.empty_like(du)
    dz = None if z is None else torch.empty_like(du)
    dBp = torch.empty((batch, n_blocks, L, N), **f32)
    dCp = torch.empty_like(dBp)
    dAp = torch.empty((batch, N, d), **f32)
    dx0 = torch.empty((batch, N, d), **f32)
    dDp = None if z is None else torch.empty((batch, d), **f32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(_ptr(u), _ptr(delta), _ptr(A), _ptr(delta_bias), _ptr(B),
             _ptr(C), _ptr(carries), _ptr(gy), _ptr(g_last), _ptr(D), _ptr(z),
             _ptr(du), _ptr(ddelta), _ptr(dz), _ptr(dBp), _ptr(dCp),
             _ptr(dAp), _ptr(dx0), _ptr(dDp),
             batch, L, d, N, *rows, _DTYPES[dtype], stream)
    if err != 0:
        raise RuntimeError(f"selective_scan_bwd kernel launch failed: CUDA "
                           f"error {err} at shape {(batch, L, d, N)} {dtype}")
    selective_scan_bwd_cuda.launches += 1
    # the deterministic partial sums of scan_core_bwd_pallas, as torch.sum;
    # dbias sums the rounded ddelta in fp32 without an fp32 copy of it
    grads = (du, ddelta, dAp.sum(0).t().contiguous(), dBp.sum(1).to(B.dtype),
             dCp.sum(1).to(C.dtype), ddelta.sum((0, 1), dtype=torch.float32),
             dx0)
    if z is None:
        return grads
    return (*grads, dz, dDp.sum(0))


selective_scan_bwd_cuda.launches = 0
