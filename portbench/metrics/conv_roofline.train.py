"""conv_roofline.train: the conv kernels' least time (their bytes) over
their device time in the traced training steps (``conv_roofline.read``)."""

from portbench.conv_roofline import read  # noqa: F401
