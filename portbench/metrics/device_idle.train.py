"""device_idle.train: the device's idle share of the measured window (readers.idle)."""

from portbench.readers import idle as read  # noqa: F401
