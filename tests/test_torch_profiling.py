"""The port's profiling helpers (``zigma_tpu_torch/utils/profiling.py``)
against the JAX package's (``tests/test_profiling.py``'s cases), on the CPU.

FLOPs: a matmul counts 2mnk, XLA's own count of the same product; a tiny
ZigMa's training forward counts each scan by ``selective_scan_flops`` (the
registered K1 operator's rule) once a layer.  ``bytes_accessed`` is None
(torch keeps no byte count).  On the CPU ``device_memory_stats`` is empty
and ``differential_time`` times with the host clock.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import torch

from zigma_tpu.utils.profiling import cost_analysis as jax_cost_analysis
from zigma_tpu_torch.models import ZigMa
from zigma_tpu_torch.ops.selective_scan import selective_scan_flops
from zigma_tpu_torch.utils.profiling import (H100_PEAK, cost_analysis,
                                             device_memory_stats,
                                             differential_time, trace)


def test_cost_analysis_matmul_counts_xlas_flops():
    a = np.ones((256, 256), np.float32)
    ref = jax_cost_analysis(lambda a, b: a @ b, jnp.asarray(a), jnp.asarray(a))
    ca = cost_analysis(lambda a, b: a @ b, torch.from_numpy(a),
                       torch.from_numpy(a))
    assert ca["flops"] == ref["flops"] == 2 * 256 ** 3
    assert ca["bytes_accessed"] is None
    assert ca["roofline_seconds"] == ca["flops"] / H100_PEAK["bf16_flops"]


def test_cost_analysis_counts_the_scan_of_each_layer():
    depth, batch = 2, 2
    model = ZigMa(in_channels=4, embed_dim=32, depth=depth, img_dim=8,
                  patch_size=1, scan_type="zigzagN8", use_pe=2, device="cpu")
    x = torch.randn(batch, 4, 8, 8, generator=torch.Generator().manual_seed(0))
    ca = cost_analysis(lambda: model(x, torch.full((batch,), 0.5)))
    mixer = model.blocks[0].mixer
    per_scan = selective_scan_flops(batch, 64, mixer.d_inner, mixer.d_state,
                                    with_D=True, with_z=True)
    assert ca["flops_by_op"]["zigma.selective_scan_fwd"] == depth * per_scan
    assert ca["flops"] > depth * per_scan  # the projections' GEMMs too


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
