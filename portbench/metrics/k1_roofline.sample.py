"""k1_roofline.sample: the least time of a forward's scans (each layer's,
at the shapes the cell's family gives them, work.k1_work) times the traced
forwards, over the device time of the operations of the kind "K1 selective
scan fwd" (``kinds.json``)."""

from portbench.work import k1_work, least_seconds

KIND = "K1 selective scan fwd"


def read(run):
    tr, d = run.trace, run.job
    spent = tr.seconds_by_kind().get(KIND, 0.0)
    if spent <= 0:
        return None
    item = 2 if run.cfg["mixed_precision"] == "bf16" else 4
    least = sum(least_seconds(k1_work(*s, item), run.n_sms, run.sm_clock_mhz)
                for s in run.family.scan_shapes(run.cfg, d.batch))
    return 100.0 * least * tr.units * d.forwards_per_unit / spent
