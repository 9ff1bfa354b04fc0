"""host_ms.train_eager: the host's milliseconds a training step, the mean
length of the program's ``train_step`` spans with recording on and no
profiler (spans.host_ms)."""

from portbench.spans import host_ms as read  # noqa: F401
