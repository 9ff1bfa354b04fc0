"""The check that decides ``correct``: the port against the plain reference
at a tiny size on the CPU, the float8 control, and each fault planted
under the timed path.  The card's test runs the control at the cells' own
sizes."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import harness, lookup, reference  # noqa: E402
from zigma_tpu_torch.ops.paths import build_layer_paths  # noqa: E402

TINY = {"depth": 3, "embed_dim": 32, "img_dim": 8}
CELLS = {
    "zigzag8_b1_pe2.train_b16": ({}, {"batch": 4, "pool": 2, "ref_rows": 2}),
    "zigzag8_b1_pe2.euler50_b16": ({}, {"batch": 4, "pool": 2,
                                        "num_steps": 6, "check_rows": 2}),
    "3d_zigzag8sst_b2.train_b20": ({"video_frames": 2},
                                   {"batch": 2, "pool": 2, "ref_rows": 1}),
}
SEED = 2 ** 31 + 977  # past 32 signed bits, as large seeds are


def _run(cell, seed=SEED):
    cfg, traffic = CELLS[cell]
    return harness.run_cell(cell, seed, 0.2, 0, "cpu",
                            cfg_override={**TINY, **cfg},
                            traffic_override=traffic)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_port_agrees_with_the_reference(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    rate = harness.load_cell(cell)[3]["rate_metric"]
    assert set(r["metrics"]) == {rate, "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_reads_far_above_the_program(cell):
    """The reference in float8 in the program's place: at least one number
    three times the program's (at this size; the card's test holds it to
    the cell's limits)."""
    prog = {k: c["value"] for k, c in _run(cell)["checks"].items()}
    cfg, traffic = CELLS[cell]
    _, _, c, t, _ = harness.load_cell(cell)
    c.update({**TINY, **cfg})
    t.update(traffic)
    d = lookup.make_job(c, t, SEED, "cpu")
    d.release()
    ctrl = d.control()
    assert any(ctrl[k] >= 3 * prog[k] for k in prog), (ctrl, prog)


def _job(cell):
    return lookup.job(harness.load_cell(cell)[3]["kind"])


FAULT_CASES = [(cell, name) for cell in sorted(CELLS)
               for name in _job(cell).faults]


@pytest.mark.parametrize("cell,name", FAULT_CASES)
def test_a_planted_fault_is_not_correct(cell, name):
    with _job(cell).faults[name]():
        r = _run(cell)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("scan_type,side,frames", [("zigzagN8", 4, 0),
                                                   ("zigzagN8", 5, 0),
                                                   ("zzvideo_sst", 4, 3)])
def test_reference_paths_match_the_published_construction(scan_type, side,
                                                          frames):
    """The reference's own scan paths against the port's tables (both
    built from the published construction; either one's fault shows)."""
    depth = 9
    paths, rev, st = build_layer_paths(scan_type, depth, side,
                                       video_frames=frames)
    ours = reference.layer_paths(scan_type, depth, side, frames)
    for i, (fold, before, after) in enumerate(ours):
        assert (before == paths[i]).all() and (after == rev[i]).all()
        assert fold == (None if st is None else st[i])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["zigzag8_b1_pe2.train_b16",
                                  "zigzag8_b1_pe2.euler50_b16",
                                  "3d_zigzag8sst_b2.train_b20"])
def test_control_fails_the_limits_at_the_cells_size(cell):
    """On the card, at the cell's own size: the float8 control fails one of
    the cell's limits on three seeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control runs at the cell's "
                    "own size")
    _, _, cfg, traffic, limits = harness.load_cell(cell)
    for seed in (11, 2 ** 31 + 5, 7_000_000_003):
        d = lookup.make_job(dict(cfg), traffic, seed, "cuda")
        d.release()
        ctrl = d.control()
        assert any(v > limits[k] for k, v in ctrl.items()), (seed, ctrl)
