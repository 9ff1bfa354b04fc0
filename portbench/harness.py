"""One run of one cell: set-up, the measured window, the traced window
(``--trace 1``), the check against the plain reference, the result line.

Everything that belongs to a cell is found by name under the root it is
given: the cell in ``BENCHMARK.json``, its configuration in the file the
manifest names (whose ``family`` names the model family in
``families/<family>.py``, ``zigma`` where it names none), its mix in
``traffic/<traffic>.json`` (whose ``kind`` names the kind of work in
``jobs/<kind>.py``), its limits in ``limits/<cell>.json`` and each
per-layer metric's reader in ``metrics/<metric>.py`` (``lookup.py``).

The window holds whole units (sampler batches or training steps) only: it starts
at the first one's start and ends at the last one's end, and runs until
``--seconds`` have passed.  The host synchronises with the card every
``sync_every`` units (the traffic's; 1 where it names none) and at the
window's end.  A rate is all the samples the window finished over all its
time.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import torch

from portbench import lookup
from portbench.lookup import ROOT

__all__ = ["main", "run_cell", "load_cell", "FORBIDDEN"]

FORBIDDEN = ("jax", "jaxlib", "flax", "zigma_tpu")
HOST_THREADS = 2
SMI_QUERY = "clocks.sm,clocks.mem,temperature.gpu,power.draw,power.limit"


def _json(path):
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT):
    """(manifest, cell, configuration, traffic, limits) of a cell name."""
    manifest = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"({', '.join(cells)})")
    cell = cells[name]
    config = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    cfg = _json(os.path.join(root, config["file"]))
    traffic = _json(lookup.path(root, "traffic", cell["traffic"]))
    limits = _json(lookup.path(root, "limits", name))
    return manifest, cell, cfg, traffic, limits


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_state() -> str:
    """The card's SM and memory clocks, temperature, power draw and limit."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={SMI_QUERY}",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace("\n", " | ") or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e.__class__.__name__})"


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _window(job, seconds, device, sync_every=1):
    """Whole units back to back until ``seconds`` have passed, a
    synchronisation every ``sync_every`` units and at the end; returns
    (units, seconds, the seconds a unit of each stretch between two
    synchronisations)."""
    _sync(device)
    t0 = time.perf_counter()
    n, marks = 0, [(0, 0.0)]
    while True:
        job.record(job.unit())
        n += 1
        over = time.perf_counter() - t0 >= seconds
        if over or n % sync_every == 0:
            _sync(device)
            marks.append((n, time.perf_counter() - t0))
            if over:
                return n, marks[-1][1], [
                    (b - a) / (m - k) for (k, a), (m, b) in zip(marks,
                                                                marks[1:])]


def _profiled(job, units, device, acts):
    from torch.profiler import profile
    from portbench.trace import Trace
    _sync(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(units):
            job.unit()
        _sync(device)
        wall = time.perf_counter() - t0
    return Trace(prof, wall, units)


def _traced(job, units, device):
    """The traced window: ``units`` units with the device's activity alone
    traced (the host's ops untouched, so its pace is the window's), then
    one unit with the host's ops traced too, which labels the idle gaps of
    ``breakdown``."""
    from torch.profiler import ProfilerActivity
    if torch.device(device).type != "cuda":
        return _profiled(job, units, device, [ProfilerActivity.CPU])
    tr = _profiled(job, units, device, [ProfilerActivity.CUDA])
    tr.labelled = _profiled(job, 1, device, [ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
    return tr


def _wants(metric, cell, names=None):
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    list, else every cell (an end-to-end metric) or every cell reporting
    the end-to-end metric it moves (a per-layer one, ``names``)."""
    ws = metric.get("workloads")
    if ws is not None:
        return cell in ws
    return names is None or metric.get("moves") in names


def run_cell(name, seed, seconds, trace, device="cuda", t_start=None,
             root=ROOT, cfg_override=None, traffic_override=None,
             log=sys.stderr):
    """One run; returns the result dict (the result's keys, ``checks``
    last).  ``cfg_override`` / ``traffic_override`` replace entries of the
    cell's files (the tests' small sizes)."""
    t_start = time.perf_counter() if t_start is None else t_start
    manifest, cell, cfg, traffic, limits = load_cell(name, root)
    cfg.update(cfg_override or {})
    traffic.update(traffic_override or {})
    torch.set_num_threads(HOST_THREADS)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    job = lookup.make_job(cfg, traffic, seed, device, root)
    job.setup()
    gc.collect()
    gc.freeze()
    before = card_state()
    setup_s = time.perf_counter() - t_start
    units, window_s, unit_s = _window(job, seconds, device,
                                      traffic.get("sync_every", 1))
    after = card_state()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    samples = job.samples(units)
    e2e = {traffic["rate_metric"]: samples / window_s,
           "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
    run = SimpleNamespace(cfg=cfg, traffic=traffic, family=job.family,
                          job=job, units=units, window_s=window_s, trace=None)
    if cuda:
        run.n_sms = torch.cuda.get_device_properties(0).multi_processor_count
        run.sm_clock_mhz = _max_sm_clock()
    if trace:
        run.trace = _traced(job, traffic["trace_units"], device)
    ends = [m for m in manifest["end_to_end"] if _wants(m, name)]
    if trace:
        metrics = {}
        for m in manifest["per_layer"]:
            if _wants(m, name, {e["name"] for e in ends}):
                value = lookup.metric(m["name"], root)(run)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in ends}
    attempted, failed = samples, job.failed()
    job.release()
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    readings = job.check()
    check_s = time.perf_counter() - t_check
    checks = {k: {"value": v, "limit": limits[k]} for k, v in readings.items()}
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values())
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": cell["chips"] if cuda else 0,
                   "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = run.trace.busy_s()
        device_info["window_s"] = run.trace.wall_s
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = checks
    print(f"card before the window: {before}; after: {after}", flush=True)
    print(f"set-up {setup_s:.3f} s, window {window_s:.3f} s ({units} units), "
          f"reference check {check_s:.1f} s", file=log)
    ordered = sorted(unit_s)
    print(f"unit seconds (a stretch between syncs): first "
          f"{[round(u, 4) for u in unit_s[:3]]}, median "
          f"{ordered[len(ordered) // 2]:.4f}, max {ordered[-1]:.4f}",
          file=log)
    if trace:
        print(f"traced: {run.trace.units} units in {run.trace.wall_s:.4f} s, "
              f"device busy {run.trace.busy_s():.4f} s", file=log)
    for k, c in checks.items():
        print(f"check {k} {c['value']:.6g} limit {c['limit']:.6g}", file=log)
    return result


def _max_sm_clock(fallback: float = 1980.0) -> float:
    """The SM clock's maximum (MHz), which the special-function units'
    peak follows; the H100 SXM's published 1980 where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return fallback


def main(argv=None, t_start=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _, cell, _, _, _ = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the port on a card "
              "and has no CPU fallback", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, args.trace,
                      "cuda", t_start)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)} (JAX or the JAX "
              f"package); no result", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0
