"""program_idle_ms.sample: device idle milliseconds a sampler batch inside
the program's ``sampler.sample`` spans, on the clock the spans share with
the device trace (spans.program_idle_ms)."""

from portbench.spans import program_idle_ms as read  # noqa: F401
