"""mfu.train_eager: the window's training model FLOPs over its time and the bf16 peak (readers.train_mfu)."""

from portbench.readers import train_mfu as read  # noqa: F401
