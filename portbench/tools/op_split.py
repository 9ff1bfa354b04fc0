"""Device time of one unit of a cell, split by kind and, within a kind, by
the host op that launched it.

    python3 portbench/tools/op_split.py --workload <cell> --seed <n> \
        [--kinds "elementwise / copy,convolution (patch embed)"] [--top 25]

Builds the cell's job as ``run.py`` does, runs its set-up and warm-up,
then one unit under ``torch.profiler`` with the host's ops and their input
shapes.  Each device kernel is filed under the benchmark's kind
(``kinds.json``) and labelled by the host op that launched it: its aten op
(or, for a kernel the autograd engine launched, the node it evaluates)
and its first input's shape.  Prints one ``SPLIT`` JSON line: device ms by
kind, and the ``--top`` labels of each kind in ``--kinds``.  The host's
op records slow the dispatch, so nothing here is a rate.
"""

import argparse
import json
import os
import sys
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from portbench import harness, lookup, trace  # noqa: E402

NODE = "autograd::engine::evaluate_function: "


def _kind(name, kinds, default):
    low = name.lower()
    return next((k for k, subs in kinds if any(s in low for s in subs)),
                default)


def _node(e):
    """The autograd node an event runs under, or None."""
    while e is not None:
        if e.name.startswith(NODE):
            return e.name[len(NODE):]
        e = e.cpu_parent
    return None


def split(prof, kinds, default):
    """``(ms by kind, {kind: {label: ms}})`` of a profile's kernels: the
    kinds from every device event, the labels ``[node] op [shape]`` from
    the host op each kernel was launched under."""
    from torch.autograd import DeviceType
    totals, by = defaultdict(float), defaultdict(lambda: defaultdict(float))
    for e in prof.events():
        if e.device_type == DeviceType.CPU:
            if not e.kernels:
                continue
            shape = next((list(sh) for sh in e.input_shapes or () if sh), "")
            node = _node(e)
            label = f"{node + ' ' if node else ''}{e.name} {shape}"
            for k in e.kernels:
                by[_kind(k.name, kinds, default)][label] += k.duration / 1e3
        else:
            totals[_kind(e.name, kinds, default)] += (
                e.time_range.end - e.time_range.start) / 1e3
    for kind, total in totals.items():
        rest = total - sum(by[kind].values())
        if rest > 1e-3:
            by[kind]["(launched outside any host op)"] += rest
    return dict(totals), by


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=3100000001)
    ap.add_argument("--kinds", default="elementwise / copy,"
                    "convolution (patch embed)")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile
    _, _, cfg, traffic, _ = harness.load_cell(args.workload)
    job = lookup.make_job(dict(cfg), traffic, args.seed, "cuda")
    job.setup()
    job.unit()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        job.unit()
        torch.cuda.synchronize()
    kinds, default = trace.load_kinds()
    totals, by = split(prof, kinds, default)
    wanted = [k for k in args.kinds.split(",") if k]
    top = lambda d: [(lab, round(ms, 3)) for lab, ms in sorted(
        d.items(), key=lambda kv: -kv[1])[:args.top]]
    res = {"workload": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(0),
           "ms_by_kind": {k: round(v, 3) for k, v in sorted(totals.items())},
           "by_op": {k: top(by.get(k, {})) for k in wanted}}
    print("SPLIT " + json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
