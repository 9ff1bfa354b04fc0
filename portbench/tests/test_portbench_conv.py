"""The conv kernels' roofline reader (``conv_roofline.py``) on made-up
traces: the bytes of each launch by kind, the partials' sum timed but
given no bytes, and a program without the kernels read as nothing."""

import json
import os
import sys
from types import SimpleNamespace

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import conv_roofline, lookup  # noqa: E402
from portbench.trace import Trace  # noqa: E402
from portbench.work import PEAK  # noqa: E402


def _run(config, batch, ops):
    with open(os.path.join(ROOT, "portbench", "configs", config)) as f:
        cfg = json.load(f)
    trace = Trace.__new__(Trace)
    trace.ops = ops
    return SimpleNamespace(cfg=cfg, family=lookup.family(cfg),
                           job=SimpleNamespace(batch=batch), trace=trace)


@pytest.mark.parametrize("config,batch,tokens", [
    ("zigzag8_b1_pe2.json", 16, 16 * 1024),
    ("3d_zigzag8sst_b2.json", 20, 20 * 16 * 256)])
def test_conv_roofline_counts_bytes_by_launch(config, batch, tokens):
    ops = [("void causal_conv1d_fwd_bf16_kernel<4>(Args)", 0, 1000),
           ("void causal_conv1d_fwd_bf16_kernel<4>(Args)", 2000, 3000),
           ("void causal_conv1d_bwd_bf16_kernel<4>(Args)", 4000, 6000),
           ("causal_conv1d_bwd_sum_kernel(float const*, int)", 6000, 6500),
           ("void selective_scan_fwd_kernel<>(Params)", 7000, 9000),
           ("elementwise_kernel", 9000, 9100)]
    got = conv_roofline.read(_run(config, batch, ops))
    one = tokens * 1536 * 2  # bf16 (tokens, d_inner)
    least = (2 * 2 + 3) * one / PEAK["hbm_bytes_per_sec"]
    assert got == pytest.approx(100 * least / 4500e-9)


def test_conv_roofline_reads_nothing_without_the_kernels():
    ops = [("void selective_scan_fwd_kernel<>(Params)", 0, 1000),
           ("cudnn::conv2d_grouped", 1000, 2000)]
    assert conv_roofline.read(_run("zigzag8_b1_pe2.json", 16, ops)) is None
    assert conv_roofline.read(_run("zigzag8_b1_pe2.json", 16, [])) is None
