"""elementwise_ms.sample: device milliseconds of the elementwise and copy
operations (the default kind of ``kinds.json``) a model forward, from the
traced batches."""

from portbench.trace import load_kinds


def read(run):
    tr = run.trace
    if not tr.ops:
        return None
    s = tr.seconds_by_kind().get(load_kinds()[1], 0.0)
    return 1e3 * s / (tr.units * run.job.forwards_per_unit)
