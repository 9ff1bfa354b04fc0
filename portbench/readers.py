"""Readers that several per-layer metrics share; each metric's file in
``metrics/`` binds its ``read`` to one of them."""

from portbench.work import PEAK

__all__ = ["idle", "train_mfu"]


def idle(run):
    """The device's idle share of the measured window: one less the union
    of the traced units' device operations' intervals, a unit, over the
    untraced window's host-clock time a unit.  The profiler slows the
    host's dispatch (CUPTI's records of every launch), so the traced
    window's own wall time would read the profiler, not the program."""
    tr = run.trace
    if not tr.ops:
        return None
    return 100.0 * (1.0 - (tr.busy_s() / tr.units)
                    / (run.window_s / run.units))


def train_mfu(run):
    """The model FLOPs of the window's training steps (3 forwards' worth a
    step, forward and backward; remat's recompute is not counted) over the
    window's host-clock time, as a share of the H100's dense bf16 peak;
    the forward's FLOPs are the cell's family's (``forward_flops``)."""
    d = run.job
    flops = (3 * run.family.forward_flops(run.cfg, d.batch)
             * d.steps_per_unit * run.units)
    return 100.0 * flops / run.window_s / PEAK["bf16_flops"]
