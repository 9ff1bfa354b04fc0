"""elementwise_ms.train: device milliseconds of the elementwise and copy
operations (the default kind of ``kinds.json``) a training step, from the
traced steps."""

from portbench.trace import load_kinds


def read(run):
    tr = run.trace
    if not tr.ops:
        return None
    s = tr.seconds_by_kind().get(load_kinds()[1], 0.0)
    return 1e3 * s / (tr.units * run.job.steps_per_unit)
