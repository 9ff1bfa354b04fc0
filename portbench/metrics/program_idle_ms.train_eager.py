"""program_idle_ms.train_eager: device idle milliseconds a training step
inside the program's ``train_step`` spans, on the clock the spans share
with the device trace (spans.program_idle_ms)."""

from portbench.spans import program_idle_ms as read  # noqa: F401
