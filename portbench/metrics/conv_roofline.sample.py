"""conv_roofline.sample: the conv kernels' least time (their bytes) over
their device time in the traced sampler batches (``conv_roofline.read``)."""

from portbench.conv_roofline import read  # noqa: F401
