"""Profiling, FLOP accounting and roofline helpers.

Counterpart of ``zigma_tpu/utils/profiling.py`` in torch idiom: a trace
over ``torch.profiler`` (a Chrome trace), FLOPs from
``torch.utils.flop_counter.FlopCounterMode`` with the selective scan's own
rule (the reference's fvcore rule, ``ops.selective_scan.selective_scan_flops``)
and a roofline against the H100's published peaks, the caching allocator's
memory counters per card, and differential timing (``k_big`` against
``k_small`` chained calls of an op), which leaves out what a call costs
once (launch latency, a final synchronise).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch

__all__ = ["trace", "cost_analysis", "device_memory_stats",
           "differential_time", "H100_PEAK"]

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit
H100_PEAK = {"bf16_flops": 989e12, "fp32_flops": 67e12,
             "hbm_bytes_per_sec": 3.35e12}


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace(dir): ...`` writes ``{dir}/trace.json``, a Chrome trace
    (chrome://tracing, Perfetto) of the host's ops and, where there is a
    card, its kernels.  Yields the ``torch.profiler.profile``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _register_scan_flops():
    """The scan's FLOP rule on the registered K1 operator (once)."""
    from torch.utils.flop_counter import flop_registry, register_flop_formula

    from zigma_tpu_torch.ops.selective_scan import selective_scan_flops

    op = torch.ops.zigma.selective_scan_fwd
    if op in flop_registry:
        return

    @register_flop_formula(op)
    def _scan_flops(u, delta, A, B, C, delta_bias, D, z, *args, **kwargs):
        batch, L, d = u
        return selective_scan_flops(batch, L, d, A[1], with_D=D is not None,
                                    with_z=z is not None)


def cost_analysis(fn: Callable, *args, **kwargs) -> dict:
    """FLOPs of ``fn(*args, **kwargs)`` (run once) and a roofline estimate.

    Returns ``{"flops", "flops_by_op", "bytes_accessed", "roofline_seconds"}``.
    ``flops`` counts what ``FlopCounterMode`` has a rule for: matmuls,
    convolutions, attention, and the selective scan where it runs through
    the registered operator ``zigma::selective_scan_fwd`` (every scan under
    autograd: a training forward; a forward without gradients launches K1
    directly and its scans are not counted), each by
    ``selective_scan_flops``.  Elementwise work and the scan's backward
    (K2, called inside the operator's autograd rule) are not counted.
    ``bytes_accessed`` is None: torch keeps no count of the bytes its
    kernels move (XLA's cost analysis has one).  ``roofline_seconds`` is
    the FLOPs over the bf16 tensor-core peak (``H100_PEAK``), the floor the
    JAX helper computes against its chip's bf16 peak, without its bytes
    term."""
    from torch.utils.flop_counter import FlopCounterMode

    _register_scan_flops()
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    by_op = {str(op): int(n)
             for op, n in counter.get_flop_counts()["Global"].items()}
    flops = int(counter.get_total_flops())
    return {"flops": flops, "flops_by_op": by_op, "bytes_accessed": None,
            "roofline_seconds": flops / H100_PEAK["bf16_flops"]}


def device_memory_stats() -> dict:
    """Per card: the caching allocator's ``bytes_in_use``,
    ``peak_bytes_in_use`` (since the last ``reset_peak_memory_stats``) and
    the card's ``bytes_limit`` (the reference logs torch.cuda.memory_*,
    train_acc.py:438-446); empty without a card."""
    stats = {}
    if not torch.cuda.is_available():
        return stats
    for i in range(torch.cuda.device_count()):
        ms = torch.cuda.memory_stats(i)
        stats[f"cuda:{i}"] = {
            "bytes_in_use": ms.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": ms.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return stats


def differential_time(op: Callable, example: torch.Tensor, k_small: int = 2,
                      k_big: int = 16) -> float:
    """Seconds a call of ``op`` (a tensor to a tensor of its shape): the
    time of ``k_big`` chained calls less that of ``k_small``, over
    ``k_big - k_small``, each the least of 3 runs (a pause of the host in
    one run does not count), without gradients.  CUDA events on a CUDA
    tensor, ``time.perf_counter`` on the CPU."""
    if k_big <= k_small:
        raise ValueError(f"k_big ({k_big}) must exceed k_small ({k_small})")
    on_card = example.device.type == "cuda"

    def chain(k):
        x = example
        for _ in range(k):
            x = op(x) * 0.5 + example * 0.5
        return x.sum()

    def seconds(k):
        if not on_card:
            t0 = time.perf_counter()
            float(chain(k))
            return time.perf_counter() - t0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        chain(k)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    with torch.no_grad(), (torch.cuda.device(example.device) if on_card
                           else contextlib.nullcontext()):
        chain(k_small)  # warm-up
        chain(k_big)
        t_small = min(seconds(k_small) for _ in range(3))
        t_big = min(seconds(k_big) for _ in range(3))
    return max(t_big - t_small, 0.0) / (k_big - k_small)
