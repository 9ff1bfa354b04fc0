"""The port's profiling helpers (``zigma_tpu_torch/utils/profiling.py``)
on the CPU: ``device_memory_stats`` is empty and ``differential_time``
times with the host clock; ``trace`` writes a Chrome trace.  The spans are
``tests/test_torch_spans.py``'s.
"""

import json
import os

import numpy as np
import torch

from zigma_tpu_torch.utils.profiling import (device_memory_stats,
                                             differential_time, trace)


def test_differential_time_positive():
    op = lambda x: torch.sin(x) @ x
    dt = differential_time(op, torch.ones(128, 128), k_small=2, k_big=8)
    assert dt > 0.0 and np.isfinite(dt)


def test_device_memory_stats_is_empty_without_a_card():
    stats = device_memory_stats()
    assert isinstance(stats, dict)
    assert stats == {} or all(set(v) == {"bytes_in_use", "peak_bytes_in_use",
                                         "bytes_limit"}
                              for v in stats.values())


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "t")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "t" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert os.path.getsize(tmp_path / "t" / "trace.json") > 0
