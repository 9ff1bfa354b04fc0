"""Profiling helpers: the program's spans and counters, a Chrome trace, the
caching allocator's memory counters, differential timing.

**Spans.** ``with span(name, **attrs): ...`` marks one piece of the
program's work.  Recording is off by default, and then a span costs a flag
check and a look at whether a ``torch.profiler`` runs: it returns a shared
object that does nothing, reads no clock and keeps nothing.  ``with
recording() as spans:`` turns it on and yields the list that takes every
``Span`` opened until the block ends (in the order they opened); the
caller owns the list.  A span records its name, id, parent's id, the id of
the unit it belongs to (its root span's), the thread that ran it, its start
and end, and its attributes.  Stamps are ``time.perf_counter_ns()`` plus
one offset to Unix time taken when recording starts: the clock of
``torch.profiler``'s (Kineto's) host events and, through the same
conversion, of CUPTI's device records, so spans and a device trace of the
same run can be laid over each other.

Each thread keeps its own stack of open spans.  A span opened on a thread
with no open span belongs to the open unit, under the innermost open span
of the unit's thread: on a card the autograd engine runs the backward on a
thread of its own, and a remat recompute there nests under
``train_step.backward``.  One unit is open at a time.

A root span also carries ``counters``, the change between its start and its
end of: the K1 / K2 launches (``selective_scan_{fwd,bwd}_cuda.launches``),
the conv kernels' (``conv_launches``, ``conv_bwd_launches``:
``causal_conv1d_{fwd,bwd}_cuda.launches``),
the caching allocator's ``num_device_alloc``, ``num_device_free`` and
``num_alloc_retries`` (None without a card, or where the card's torch has
no such count) and Python's garbage collections.  While recording, each
collection is a span ``host.gc`` with its ``generation``.

Whenever a ``torch.profiler`` runs, recording or not, each span is also a
range of the same name among the profiler's host events, so ``trace(dir)``
shows the program's spans on the timeline of the kernels they launched.
The range is a plain function range (``_RecordFunctionFast``; a torch
build without it has no bridge), not a user annotation (``record_function``): the profiler mirrors a user annotation
onto the device as an event spanning its kernels, which a reader of the
device's operations would count as work and which would hide the device's
idle gaps inside it.

**The rest.**  ``trace`` writes a Chrome trace over ``torch.profiler``
(counterpart of ``zigma_tpu/utils/profiling.py``'s); ``device_memory_stats``
reads the caching allocator's counters per card; ``differential_time``
times an op as ``k_big`` against ``k_small`` chained calls, which leaves
out what a call costs once (launch latency, a final synchronise);
``H100_PEAK`` holds the card's published peaks.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import os
import threading
import time
from typing import Callable

import torch

__all__ = ["span", "recording", "Span", "trace", "device_memory_stats",
           "differential_time", "H100_PEAK"]

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit
H100_PEAK = {"bf16_flops": 989e12, "fp32_flops": 67e12,
             "hbm_bytes_per_sec": 3.35e12}

ALLOCATOR_COUNTS = ("num_device_alloc", "num_device_free", "num_alloc_retries")

_recorder = None  # the _Recorder while recording is on
# the profiler's plain function range; a torch without it gets no bridge
_Range = getattr(getattr(torch._C, "_profiler", None), "_RecordFunctionFast",
                 None)
_profiler_enabled = (torch.autograd._profiler_enabled if _Range is not None
                     else lambda: False)


class _Off:
    """The span of a program that records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, **attrs):
    """A context manager marking ``name``'s work: a ``Span`` while
    recording, a profiler range where only a profiler runs, else a shared
    object that does nothing."""
    if _recorder is None:
        if _profiler_enabled():
            return _Range(name)
        return _OFF
    return Span(_recorder, name, attrs)


class Span:
    """One recorded span; ``end_ns`` is None while it is open, and
    ``counters`` None but on a root span."""

    __slots__ = ("name", "id", "parent", "unit", "thread", "start_ns",
                 "end_ns", "attrs", "counters", "_rec", "_range")

    def __init__(self, rec, name: str, attrs: dict):
        self._rec, self.name, self.attrs = rec, name, attrs
        self.id = self.parent = self.unit = self.thread = None
        self.start_ns = self.end_ns = self.counters = self._range = None

    def __enter__(self):
        self._rec.open(self)
        if _profiler_enabled():
            self._range = _Range(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
        self._rec.close(self)
        return False

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"unit={self.unit}, ns=[{self.start_ns}, {self.end_ns}], "
                f"attrs={self.attrs})")


def _counts(kernels) -> dict:
    fwd, bwd, conv, conv_bwd = kernels
    out = {"k1_launches": fwd.launches, "k2_launches": bwd.launches,
           "conv_launches": conv.launches,
           "conv_bwd_launches": conv_bwd.launches,
           "gc_collections": sum(g["collections"] for g in gc.get_stats())}
    stats = {}
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        stats = torch.cuda.memory_stats_as_nested_dict()
    out.update({k: stats.get(k) for k in ALLOCATOR_COUNTS})
    return out


class _Recorder:
    """The state of one recording: the spans, each thread's open spans and
    the open unit.  Re-entrant: a collection may start inside ``open``."""

    def __init__(self):
        from zigma_tpu_torch.ops import conv_cuda, scan_cuda
        self.kernels = (scan_cuda.selective_scan_fwd_cuda,
                        scan_cuda.selective_scan_bwd_cuda,
                        conv_cuda.causal_conv1d_fwd_cuda,
                        conv_cuda.causal_conv1d_bwd_cuda)
        self.spans, self.stacks, self.unit, self.gc_spans = [], {}, None, {}
        self.lock = threading.RLock()
        self.ids = itertools.count(1)
        a = time.perf_counter_ns()
        unix = time.time_ns()
        self.offset = unix - (a + time.perf_counter_ns()) // 2

    def open(self, s: Span, push: bool = True):
        tid = threading.get_ident()
        with self.lock:
            stack = self.stacks.setdefault(tid, [])
            parent = stack[-1] if stack else None
            if parent is None and self.unit is not None:
                held = self.stacks.get(self.unit.thread)
                parent = held[-1] if held else self.unit
            s.id, s.thread = next(self.ids), tid
            if parent is None:
                s.unit = s.id
                if push:  # a collection outside every unit opens none
                    self.unit, s.counters = s, _counts(self.kernels)
            else:
                s.parent, s.unit = parent.id, parent.unit
            if push:
                stack.append(s)
            self.spans.append(s)
        s.start_ns = time.perf_counter_ns() + self.offset

    def close(self, s: Span, pop: bool = True):
        end = time.perf_counter_ns() + self.offset
        with self.lock:
            s.end_ns = end
            if pop:
                stack = self.stacks[s.thread]
                if stack and stack[-1] is s:
                    stack.pop()
                else:
                    stack.remove(s)
            if self.unit is s:
                self.unit = None
                after = _counts(self.kernels)
                s.counters = {k: None if v is None or after[k] is None
                              else after[k] - v
                              for k, v in s.counters.items()}

    def on_gc(self, phase: str, info: dict):
        tid = threading.get_ident()
        if phase == "start":
            s = Span(self, "host.gc", {"generation": info["generation"]})
            self.open(s, push=False)
            self.gc_spans[tid] = s
        elif tid in self.gc_spans:
            self.close(self.gc_spans.pop(tid), pop=False)


@contextlib.contextmanager
def recording():
    """``with recording() as spans:`` records every span opened in the
    block into the list ``spans`` and every garbage collection as a
    ``host.gc`` span; recording is off again, and ``gc.callbacks`` as it
    was, once the block ends.  Not nested."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("recording is already on")
    rec = _Recorder()
    gc.callbacks.append(rec.on_gc)
    _recorder = rec
    try:
        yield rec.spans
    finally:
        _recorder = None
        gc.callbacks.remove(rec.on_gc)


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
