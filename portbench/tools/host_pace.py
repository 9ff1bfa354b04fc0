"""The pace of a cell's units under different synchronisation and host
thread settings, in one process on the card: set-up once, then one
stretch of ``--seconds`` a setting, each with the host's dispatch time a
unit (until the unit's call returns) and a pure-Python probe of the host
core's speed beside it.

    python3 portbench/tools/host_pace.py --workload <cell> --seed <n> \\
        --seconds 10 --modes 1:2,100:2,100:0,100:1

A mode is ``sync_every:threads`` (threads 0: torch's default).  Prints one
``PACE`` JSON line a stretch.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402

from portbench import harness, lookup  # noqa: E402


def _probe() -> float:
    """Seconds for a fixed pure-Python loop: the host core's own speed."""
    t0 = time.perf_counter()
    acc = 0
    for i in range(2_000_000):
        acc += i & 7
    return time.perf_counter() - t0


def _cpu() -> int:
    with open("/proc/self/stat") as f:
        return int(f.read().rsplit(")", 1)[1].split()[36])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--modes", default="1:2,100:2,100:0,100:1")
    args = ap.parse_args(argv)
    _, _, cfg, traffic, _ = harness.load_cell(args.workload)
    default_threads = torch.get_num_threads()
    torch.set_num_threads(harness.HOST_THREADS)
    job = lookup.make_job(cfg, traffic, args.seed, "cuda")
    job.setup()
    real, host = job.unit, []

    def timed():
        t0 = time.perf_counter()
        out = real()
        host.append(time.perf_counter() - t0)
        return out

    job.unit = timed
    for mode in args.modes.split(","):
        sync_every, threads = (int(x) for x in mode.split(":"))
        torch.set_num_threads(threads or default_threads)
        host.clear()
        probe = _probe()
        units, secs, per = harness._window(job, args.seconds, "cuda",
                                           sync_every)
        per = sorted(per)
        print("PACE " + json.dumps(dict(
            mode=mode, seed=args.seed, units=units, seconds=secs,
            rate=job.samples(units) / secs, host_s=sum(host) / len(host),
            host_max_s=max(host), unit_median_s=per[len(per) // 2],
            probe_s=probe, cpu=_cpu(), threads=torch.get_num_threads(),
            affinity=len(os.sched_getaffinity(0)))), flush=True)
    job.release()


if __name__ == "__main__":
    main()
