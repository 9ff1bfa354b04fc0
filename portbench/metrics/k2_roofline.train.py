"""k2_roofline.train: the least time of a training step's backward scans
(each layer's, at the shapes the cell's family gives them, work.k2_work)
times the traced steps, over the device time of the operations of the kind
"K2 selective scan bwd" (``kinds.json``)."""

from portbench.work import k2_work, least_seconds

KIND = "K2 selective scan bwd"


def read(run):
    tr, d = run.trace, run.job
    spent = tr.seconds_by_kind().get(KIND, 0.0)
    if spent <= 0:
        return None
    item = 2 if run.cfg["mixed_precision"] == "bf16" else 4
    least = sum(least_seconds(k2_work(*s, item), run.n_sms, run.sm_clock_mhz)
                for s in run.family.scan_shapes(run.cfg, d.batch))
    return 100.0 * least * tr.units * d.steps_per_unit / spent
