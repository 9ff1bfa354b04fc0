"""The conv kernels' share of their roofline (``conv_roofline.*``).

Each Mamba-1 block runs one causal depthwise conv over all the model's
tokens (``ops/causal_conv1d.py``, the kernels of ``csrc/causal_conv1d.cu``).
The least time of one launch is its bytes over the memory rate: a forward
reads x and writes y, a backward reads x and dy and writes dx, each of
(tokens, d_inner) elements in the model's working dtype; the operations (4
FMAs and one exp a token and channel) take less than a tenth of that.  The
share is that least time summed over the traced launches, over the traced
device time of every operation whose name holds ``causal_conv1d`` (the
backward's fixed-order sum of its dw / dbias partials included).  The
tokens and d_inner are the first scan's of the cell's family
(``scan_shapes``): every conv of a forward has that many.  A
program without these kernels (before they were written) reads nothing.
"""

from portbench.work import PEAK

__all__ = ["read"]

NAME = "causal_conv1d"


def read(run):
    tr = run.trace
    ops = [(name.lower(), b - a) for name, a, b in tr.ops
           if NAME in name.lower()]
    spent = sum(ns for _, ns in ops) * 1e-9
    if spent <= 0:
        return None
    batch, L, d, _ = run.family.scan_shapes(run.cfg, run.job.batch)[0]
    item = 2 if run.cfg["mixed_precision"] == "bf16" else 4
    one = batch * L * d * item  # bytes of one (tokens, d_inner) tensor
    fwd = sum(1 for name, _ in ops if NAME + "_fwd" in name)
    bwd = sum(1 for name, _ in ops
              if NAME + "_bwd" in name and "_sum" not in name)
    least = (2 * fwd + 3 * bwd) * one / PEAK["hbm_bytes_per_sec"]
    return 100.0 * least / spent
