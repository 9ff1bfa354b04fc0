"""Reading a ``torch.profiler`` trace: device operations, busy time, idle
gaps and device time by kind.

The kinds are a frozen copy of the port's profile classifier, held as data
in ``kinds.json``: an ordered list of ``[kind, [substrings]]``, the first
kind one of whose substrings the lower-cased operation name contains, else
the default kind.  A later benchmark change that follows a renamed or fused
kernel edits the data, not this code.
"""

from __future__ import annotations

import json
import os

__all__ = ["Trace", "load_kinds"]

HERE = os.path.dirname(os.path.abspath(__file__))


def load_kinds(path=os.path.join(HERE, "kinds.json")):
    with open(path) as f:
        spec = json.load(f)
    return spec["kinds"], spec["default"]


class Trace:
    """The operations of one traced window.

    ``ops``: (name, start_ns, end_ns) of every device operation (kernels,
    copies, sets), sorted by start; ``host``: (name, start_ns, end_ns) of the
    host's events; ``wall_s``: the window's host-clock length; ``units``:
    the units of work (batches, steps) the window ran; ``labelled``: a
    trace with the host's ops too, whose idle gaps ``breakdown`` gives
    (this one's, where it has none)."""

    def __init__(self, prof, wall_s: float, units: int):
        from torch.autograd import DeviceType
        self.ops, self.host = [], []
        for e in prof.profiler.kineto_results.events():
            rec = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            if e.device_type() == DeviceType.CPU:
                self.host.append(rec)
            elif e.duration_ns() > 0:
                self.ops.append(rec)
        self.ops.sort(key=lambda r: r[1])
        self.wall_s, self.units = wall_s, units
        self.labelled = None
        self.kinds, self.default = load_kinds()

    def kind(self, name: str) -> str:
        k = name.lower()
        for kind, subs in self.kinds:
            if any(s in k for s in subs):
                return kind
        return self.default

    def seconds_by_kind(self) -> dict:
        out = {}
        for name, a, b in self.ops:
            kind = self.kind(name)
            out[kind] = out.get(kind, 0.0) + (b - a) * 1e-9
        return out

    def busy_s(self) -> float:
        """The union of the device operations' intervals."""
        busy, end = 0, None
        for _, a, b in self.ops:
            if end is None or a > end:
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        return busy * 1e-9

    def gaps(self) -> list:
        """(start_ns, end_ns) of each stretch with no device operation
        between the first operation and the last."""
        out, end = [], None
        for _, a, b in self.ops:
            if end is not None and a > end:
                out.append((end, a))
            end = b if end is None else max(end, b)
        return out

    def host_at(self, ns: int) -> str:
        """The innermost host event running at ``ns``."""
        best = None
        for name, a, b in self.host:
            if a <= ns <= b and (best is None or b - a < best[1]):
                best = (name, b - a)
        return "host idle" if best is None else best[0]

    def breakdown(self, n: int = 10) -> dict:
        kinds = sorted(self.seconds_by_kind().items(), key=lambda kv: -kv[1])
        src = self.labelled or self
        gaps = sorted(src.gaps(), key=lambda g: g[0] - g[1])[:n]
        return {"device_ops": [[k, v] for k, v in kinds[:n]],
                "idle_gaps": [[src.host_at((a + b) // 2), (b - a) * 1e-9]
                              for a, b in gaps]}
