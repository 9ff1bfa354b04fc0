"""The program's own spans in a cell, for the per-layer metrics that read
them (``host_ms.*``, ``program_idle_ms.*``).

After the traced window, ``read`` runs the traffic's ``trace_units`` units
twice more, with a synchronisation every ``sync_every`` units (1 where the
traffic names none) and at the end, and the program's span recorder on
(``zigma_tpu_torch.utils.profiling.recording``), each pass after a
collection and ``gc.freeze``, as the harness's window starts:

(a) without a profiler: the spans' host durations, free of the slowdown
    CUPTI's records of every launch put on the host's dispatch;
(b) under ``torch.profiler`` with the device's activity alone: the device
    operations (``trace.Trace``) and the spans share one clock (Unix ns),
    so each idle gap (``Trace.gaps``) can be put inside or outside a span.

It leaves recording off and ``gc.callbacks`` as they were.  The result is
computed once a run and kept on the run.  A program without the recorder
gives None, and each metric that reads it then reads nothing.  It prints
the spans' breakdown to standard error: the host's self time a unit by
span, the counters a unit, pass (b)'s idle a unit beside the harness's
traced window's, its collections, and its idle by the innermost span
around each gap.

A unit's root span is the one its job class names (``root_span``:
``train_step`` for training, ``sampler.sample`` for sampling); idle
outside the roots is the harness's (its loop and its synchronisation).
"""

from __future__ import annotations

import gc
import sys
import time
from types import SimpleNamespace

import torch

from portbench.trace import Trace

__all__ = ["read", "host_ms", "program_idle_ms"]


def _sync(cuda):
    if cuda:
        torch.cuda.synchronize()


def _units(job, n, sync_every, cuda):
    _sync(cuda)
    for i in range(n):
        job.unit()
        if (i + 1) % sync_every == 0:
            _sync(cuda)
    _sync(cuda)


def _by_innermost(spans, stretches, units):
    """The stretches' ms a unit by the innermost span around each one's
    middle: the latest-starting span still open there (spans nest)."""
    order = sorted(spans, key=lambda s: s.start_ns)
    out, open_, i = {}, [], 0
    for a, b in stretches:
        mid = (a + b) // 2
        while i < len(order) and order[i].start_ns <= mid:
            while open_ and open_[-1].end_ns < order[i].start_ns:
                open_.pop()
            open_.append(order[i])
            i += 1
        while open_ and open_[-1].end_ns < mid:
            open_.pop()
        name = open_[-1].name if open_ else "outside every span"
        out[name] = out.get(name, 0.0) + (b - a) * 1e-6 / units
    return sorted(out.items(), key=lambda kv: -kv[1])


def _self_ms(spans, units):
    """Each span name's self time a unit (its duration less its children's),
    in ms."""
    kids = {}
    for s in spans:
        if s.parent is not None:
            kids[s.parent] = kids.get(s.parent, 0) + s.end_ns - s.start_ns
    out = {}
    for s in spans:
        own = max(0, s.end_ns - s.start_ns - kids.get(s.id, 0))
        out[s.name] = out.get(s.name, 0.0) + own * 1e-6 / units
    return out


def _fresh_gc():
    """Collect, then freeze what survives (as ``harness.run_cell`` does
    before its window): a pass's collections then walk only the objects
    the pass itself made, not the window's records, the traced window's
    events or an earlier pass's spans.  The harness's ``gc.unfreeze``
    after the readers thaws them."""
    gc.collect()
    gc.freeze()


def _passes(run):
    try:
        from zigma_tpu_torch.utils.profiling import recording
    except ImportError:
        return None
    from torch.profiler import ProfilerActivity, profile
    job, units = run.job, run.traffic["trace_units"]
    sync_every = run.traffic.get("sync_every", 1)
    cuda = torch.device(job.device).type == "cuda"
    acts = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]
    callbacks = list(gc.callbacks)
    try:
        _fresh_gc()
        with recording() as host:
            _units(job, units, sync_every, cuda)
        _fresh_gc()
        with profile(activities=acts) as prof, recording() as traced:
            t0 = time.perf_counter()
            _units(job, units, sync_every, cuda)
            wall = time.perf_counter() - t0
    finally:
        gc.callbacks[:] = callbacks
    out = SimpleNamespace(root=job.root_span, units=units,
                          host=host, traced=traced,
                          trace=Trace(prof, wall, units), window=run.trace)
    _report(out)
    return out


def read(run):
    """The two passes of ``run`` (None without the program's recorder)."""
    if not hasattr(run, "spans"):
        run.spans = _passes(run)
    return run.spans


def _roots(spans, name):
    return [s for s in spans if s.parent is None and s.name == name]


def _root_ms(sp):
    roots = _roots(sp.host, sp.root)
    if not roots:
        return None
    return sum(s.end_ns - s.start_ns for s in roots) * 1e-6 / len(roots)


def host_ms(run):
    """Pass (a): the mean host milliseconds of the unit's root spans."""
    sp = read(run)
    return None if sp is None else _root_ms(sp)


def _program_idle(sp):
    """(idle ns inside the roots, idle ns in all, the gaps) of pass (b):
    the device trace's gaps (``Trace.gaps``) laid over the root spans."""
    gaps = sp.trace.gaps()
    inside = sum(max(0, min(b, s.end_ns) - max(a, s.start_ns))
                 for s in _roots(sp.traced, sp.root) for a, b in gaps)
    return inside, sum(b - a for a, b in gaps), gaps


def program_idle_ms(run):
    """Pass (b): device idle milliseconds a unit inside the unit's root
    spans."""
    sp = read(run)
    if sp is None or not sp.trace.ops or not _roots(sp.traced, sp.root):
        return None
    return _program_idle(sp)[0] * 1e-6 / sp.units


def _report(sp, log=sys.stderr):
    roots = _roots(sp.host, sp.root)
    if not roots:
        print(f"spans: no {sp.root} span recorded", file=log)
        return
    mean = lambda v: None if v[0] is None else sum(v) / len(v)
    counters = {k: mean([r.counters[k] for r in roots])
                for k in roots[0].counters}
    own = sorted(_self_ms(sp.host, len(roots)).items(), key=lambda kv: -kv[1])
    print(f"spans: pass (a) {len(sp.host)} spans, {len(roots)} {sp.root}, "
          f"{_root_ms(sp):.3f} host ms a unit; self ms "
          f"a unit {[(k, round(v, 3)) for k, v in own]}; counters a unit "
          f"{counters}", file=log)
    if not sp.trace.ops:
        return
    inside, total, idle = _program_idle(sp)
    by = _by_innermost(sp.traced, idle, sp.units)
    gcs = [s.end_ns - s.start_ns for s in sp.traced if s.name == "host.gc"]
    window = sp.window
    if window is not None and window.ops:
        window = round(sum(b - a for a, b in window.gaps()) * 1e-6
                       / window.units, 3)
    print(f"spans: pass (b) device busy {sp.trace.busy_s():.4f} s, idle "
          f"{total * 1e-6:.3f} ms over {sp.units} units "
          f"({total * 1e-6 / sp.units:.3f} a unit; the harness's traced "
          f"window {window} a unit), {100.0 * inside / max(total, 1):.2f}% "
          f"inside {sp.root}; host.gc {len(gcs) / sp.units:.1f} a unit, "
          f"{sum(gcs) * 1e-6 / sp.units:.3f} ms a unit; idle ms a unit by "
          f"innermost span {[(k, round(v, 3)) for k, v in by]}", file=log)
