"""The readings the limits of ``correct`` are set from, in one process on
the card: the program on each of ``--seeds`` (a run of the cell with a
short window, as the benchmark runs it), the control (the reference in
float8 e4m3 in the program's place) on each of ``--control-seeds``, and
each fault the cell's job class lists (``faults``; or those ``--faults``
names) planted under the timed path on each of ``--fault-seeds``.

    python3 portbench/tools/readings.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 --fault-seeds 7,8,9 [--faults a,b] [--seconds 2]

Prints one ``READING`` JSON line a run: what ran, the seed, the numbers
compared.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from portbench import harness, lookup  # noqa: E402


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--faults", default="",
                    help="comma-separated fault names (default: all)")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    _, _, cfg, traffic, _ = harness.load_cell(args.workload)

    clock = [time.perf_counter()]

    def show(what, seed, readings, **extra):
        now = time.perf_counter()
        print("READING " + json.dumps(dict(what=what, seed=seed, **readings,
                                           seconds=now - clock[0], **extra)),
              flush=True)
        clock[0] = now

    for seed in _seeds(args.seeds):
        r = harness.run_cell(args.workload, seed, args.seconds, 0, "cuda")
        show("program", seed, {k: c["value"] for k, c in r["checks"].items()},
             correct=r["correct"], metrics=r["metrics"])
    for seed in _seeds(args.control_seeds):
        d = lookup.make_job(dict(cfg), traffic, seed, "cuda")
        d.release()
        show("control", seed, d.control())
    planted = lookup.job(traffic["kind"]).faults
    for name in (args.faults.split(",") if args.faults else planted):
        for seed in _seeds(args.fault_seeds):
            with planted[name]():
                r = harness.run_cell(args.workload, seed, args.seconds, 0,
                                     "cuda")
            show("fault:" + name, seed,
                 {k: c["value"] for k, c in r["checks"].items()},
                 correct=r["correct"])


if __name__ == "__main__":
    main()
