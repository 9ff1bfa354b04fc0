"""The readers of the program's spans (``spans.py``): the idle arithmetic on
made-up intervals, a traced run of each cell that reads them at a tiny size
on the CPU, and a program without the recorder, whose metrics are left
out without an error."""

import os
import sys
from types import SimpleNamespace

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import harness, spans  # noqa: E402
from portbench.trace import Trace  # noqa: E402
from portbench.tests.test_portbench_correct import CELLS, SEED, TINY  # noqa: E402


def _span(name, id_, parent, a, b):
    return SimpleNamespace(name=name, id=id_, parent=parent, start_ns=a,
                           end_ns=b, counters=None)


def test_idle_inside_the_roots():
    """The device trace's own gaps (``Trace.gaps``), laid over the roots
    and put under the innermost span at each gap's middle."""
    trace = Trace.__new__(Trace)
    trace.ops = [("k", 10, 20), ("k", 15, 30), ("k", 40, 50), ("k", 70, 80),
                 ("k", 95, 100)]
    traced = [_span("train_step", 1, None, 5, 60),
              _span("train_step.forward", 2, 1, 5, 35),
              _span("host.gc", 3, 2, 31, 39),
              _span("train_step", 4, None, 65, 85)]
    sp = SimpleNamespace(root="train_step", units=2, traced=traced,
                         trace=trace)
    inside, total, gaps = spans._program_idle(sp)
    assert gaps == [(30, 40), (50, 70), (80, 95)]
    assert (inside, total) == (10 + 10 + 5 + 5, 10 + 20 + 15)
    by = dict(spans._by_innermost(traced, gaps, 1))
    assert by == pytest.approx({"host.gc": 10e-6, "train_step": 20e-6,
                                "outside every span": 15e-6})
    run = SimpleNamespace(spans=sp)
    assert spans.program_idle_ms(run) == pytest.approx(inside * 1e-6 / 2)


def test_self_time_leaves_out_the_children():
    host = [_span("train_step", 1, None, 0, 100),
            _span("train_step.forward", 2, 1, 10, 40),
            _span("model.block", 3, 2, 15, 35),
            _span("train_step.backward", 4, 1, 40, 90)]
    own = spans._self_ms(host, 1)
    assert own == pytest.approx({"train_step": 20e-6,
                                 "train_step.forward": 10e-6,
                                 "model.block": 20e-6,
                                 "train_step.backward": 50e-6})


def _traced_run(cell):
    cfg, traffic = CELLS[cell]
    return harness.run_cell(cell, SEED, 0.2, 1, "cpu",
                            cfg_override={**TINY, **cfg},
                            traffic_override={**traffic, "trace_units": 1})


def test_traced_run_reads_the_host_time_of_a_step():
    """On the CPU there is no device trace: ``program_idle_ms`` reads
    nothing, ``host_ms`` the step's span."""
    r = _traced_run("zigzag8_b1_pe2.train_b16")
    assert r["correct"]
    assert r["metrics"]["host_ms.train_eager"]["value"] > 0
    assert "program_idle_ms.train_eager" not in r["metrics"]


@pytest.mark.parametrize("cell", ["zigzag8_b1_pe2.train_b16",
                                  "zigzag8_b1_pe2.euler50_b16"])
def test_a_program_without_spans_reads_nothing(cell, monkeypatch):
    import zigma_tpu_torch.utils.profiling as profiling
    monkeypatch.delattr(profiling, "recording")
    r = _traced_run(cell)
    assert r["correct"]
    assert not any(k.startswith(("host_ms", "program_idle_ms"))
                   for k in r["metrics"])
