"""The float64 references of ``chip_smoke.py``'s truth gates, on the CPU.

``chip_smoke.truth_f64`` (the fused scan) and ``chip_smoke.truth_bwd_f64``
(its adjoint) hold the kernels K1 and K2 on the card; here each runs in
float64 on the CPU at a tiny size (two 128-step chunks and a ragged tail)
against the port's plain fp32 versions, ``selective_scan_ref`` and
``selective_scan_bwd_ref``, on the same values.  Tolerance: per output,
max |ref - truth| <= 1e-5 * max |truth|: the plain versions differ from the
truth only by fp32 rounding over a few hundred steps (measured below 1e-6).
Short memory (decays near 0.5) and the flagship's long memory (decays near
0.999, A = -(1 ... N)).
"""

import os
import sys

import numpy as np
import pytest
import torch

from zigma_tpu_torch.ops.selective_scan import (selective_scan_bwd_ref,
                                                selective_scan_ref)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

TOL = 1e-5
NAMES = ("du", "ddelta", "dA", "dB", "dC", "dbias", "dx0", "dz", "dD")


def _inputs(long_memory, batch=2, L=300, D=6, N=4, seed=0):
    rng = np.random.default_rng(seed)
    r = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    d = dict(u=r(batch, L, D), delta=0.5 * r(batch, L, D),
             A=-torch.exp(0.5 * r(D, N)), B=r(batch, L, N), C=r(batch, L, N),
             bias=0.1 * r(D), Dskip=r(D), z=r(batch, L, D), gy=r(batch, L, D))
    if long_memory:  # as chip_smoke.scan_inputs(long_memory=True)
        dt = torch.from_numpy(np.exp(rng.uniform(np.log(0.001), np.log(0.1), D))
                              .astype(np.float32))
        d["bias"] = dt + torch.log(-torch.expm1(-dt))
        d["delta"] = 0.1 * r(batch, L, D)
        d["A"] = -torch.arange(1, N + 1, dtype=torch.float32).repeat(D, 1)
    return d


def _rel(a, truth):
    return ((a.double() - truth).abs().max() / truth.abs().max()).item()


@pytest.mark.parametrize("long_memory", [False, True])
def test_forward_truth_matches_plain_scan(long_memory):
    d = _inputs(long_memory)
    truth = chip_smoke.truth_f64(d, device="cpu")
    plain = selective_scan_ref(d["u"], d["delta"], d["A"], d["B"], d["C"],
                               d["Dskip"], d["z"], d["bias"], True)
    for what, p, t in zip(("y", "carries", "x_last"), plain, truth):
        assert t.dtype == torch.float64 and p.shape == t.shape, what
        assert _rel(p, t) <= TOL, what


@pytest.mark.parametrize("long_memory", [False, True])
def test_adjoint_truth_matches_plain_backward(long_memory):
    d = _inputs(long_memory)
    truth = chip_smoke.truth_bwd_f64(d, device="cpu")
    _, carries, _ = selective_scan_ref(d["u"], d["delta"], d["A"], d["B"],
                                       d["C"], d["Dskip"], d["z"], d["bias"],
                                       True)
    plain = selective_scan_bwd_ref(d["u"], d["delta"], d["bias"], d["A"],
                                   d["B"], d["C"], carries, d["gy"], None,
                                   d["Dskip"], d["z"])
    assert len(truth) == len(plain) == len(NAMES)
    for what, p, t in zip(NAMES, plain, truth):
        assert t.dtype == torch.float64 and p.shape == t.shape, what
        assert _rel(p, t) <= TOL, what
