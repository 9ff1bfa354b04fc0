"""mfu.sample: the model FLOPs of the window's batches (a forward a
sampler step, counted from the shapes by the cell's family) over the
window's host-clock time, as a share of the H100's dense bf16 peak."""

from portbench.work import PEAK


def read(run):
    d = run.job
    flops = (run.family.forward_flops(run.cfg, d.batch)
             * d.forwards_per_unit * run.units)
    return 100.0 * flops / run.window_s / PEAK["bf16_flops"]
