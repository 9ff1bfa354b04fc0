"""The port's spans and counters (``zigma_tpu_torch/utils/profiling.py``)
on the CPU, over a tiny ZigMa (depth 2, embed 32, 8x8 latents, zigzagN8):
off by default; the tree of a training step under remat and of a sampler
batch; the clock shared with ``torch.profiler``'s events; the bridge into
a profiler's trace; garbage collections; spans of other threads."""

import gc
import json
import sys
import threading

import pytest
import torch

from zigma_tpu_torch.models import ZigMa
from zigma_tpu_torch.train import (TrainState, make_diffusion_loss_fn,
                                   train_step)
from zigma_tpu_torch.transport import Sampler, create_transport
from zigma_tpu_torch.utils import profiling
from zigma_tpu_torch.utils.profiling import recording, span, trace

DEPTH = 2
CFG = dict(in_channels=4, embed_dim=32, depth=DEPTH, img_dim=8, patch_size=1,
           scan_type="zigzagN8", use_pe=2, drop_path_rate=0.1)
PARTS = ["train_step.forward", "train_step.backward", "train_step.clip",
         "train_step.optimizer", "train_step.ema"]


def _model(**kw):
    return ZigMa(**CFG, **kw, device="cpu",
                 generator=torch.Generator().manual_seed(0))


def _step(state, seed=1):
    loss_fn = make_diffusion_loss_fn(state.model, create_transport())
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 4, 8, 8, generator=gen)
    return train_step(state, loss_fn, {"x": x}, gen)


def _children(spans, parent):
    return sorted((s for s in spans if s.parent == parent.id),
                  key=lambda s: s.start_ns)


def _under(spans, ancestor, name):
    """The spans called ``name`` below ``ancestor``, at any depth."""
    by_id = {s.id: s for s in spans}

    def below(s):
        while s.parent is not None:
            s = by_id[s.parent]
            if s is ancestor:
                return True
        return False

    return [s for s in spans if s.name == name and below(s)]


def _inside(inner, outer):
    return outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


def test_off_by_default_records_nothing():
    assert profiling._recorder is None
    assert span("train_step", step=0) is span("model.block") is profiling._OFF
    state = TrainState.create(_model())
    _step(state)  # runs every span of a step with recording off
    with recording() as spans:
        pass
    assert spans == [] and profiling._recorder is None
    assert span("model.forward") is profiling._OFF


def test_train_step_tree_under_remat():
    state = TrainState.create(_model(use_checkpoint=True))
    _step(state)  # warm
    with recording() as spans:
        _step(state, seed=2)
    assert all(s.end_ns is not None for s in spans)
    roots = [s for s in spans if s.parent is None and s.name != "host.gc"]
    assert [r.name for r in roots] == ["train_step"]
    root = roots[0]
    assert root.attrs == {"step": 1}
    assert {s.unit for s in spans if s.name != "host.gc"} == {root.id}
    parts = [s for s in _children(spans, root) if s.name != "host.gc"]
    assert [s.name for s in parts] == PARTS
    assert all(_inside(s, root) for s in parts)
    assert all(a.end_ns <= b.start_ns for a, b in zip(parts, parts[1:]))
    forward, backward = parts[0], parts[1]
    for part in (forward, backward):
        blocks = _under(spans, part, "model.block")
        assert sorted(b.attrs["index"] for b in blocks) == list(range(DEPTH))
        assert all(_inside(b, part) for b in blocks)
    assert len(_under(spans, forward, "model.forward")) == 1
    assert [s.name for s in _children(spans, _under(
        spans, forward, "model.forward")[0])] == (
        ["model.embed"] + ["model.block"] * DEPTH + ["model.head"])
    assert len([s for s in spans if s.name == "model.block"]) == 2 * DEPTH


def test_root_counters():
    state = TrainState.create(_model())
    _step(state)
    with recording() as spans:
        _step(state)
        with span("model.forward"):
            gc.collect()
    roots = [s for s in spans if s.parent is None and s.name != "host.gc"]
    assert [r.name for r in roots] == ["train_step", "model.forward"]
    step, alone = roots
    assert set(step.counters) == {"k1_launches", "k2_launches",
                                  "conv_launches", "conv_bwd_launches",
                                  "gc_collections",
                                  *profiling.ALLOCATOR_COUNTS}
    assert step.counters["k1_launches"] == step.counters["k2_launches"] == 0
    assert (step.counters["conv_launches"]
            == step.counters["conv_bwd_launches"] == 0)
    assert all(step.counters[k] is None for k in profiling.ALLOCATOR_COUNTS)
    assert alone.counters["gc_collections"] >= 1
    assert all(s.counters is None for s in spans if s.parent is not None)


@pytest.mark.parametrize("method", ["euler", "heun"])
def test_ode_sampling_tree(method):
    model = _model().eval()
    n = 5
    fn = Sampler(create_transport()).sample_ode(sampling_method=method,
                                                num_steps=n)
    z = torch.randn(2, 4, 8, 8, generator=torch.Generator().manual_seed(3))
    with torch.no_grad(), recording() as spans:
        fn(z, lambda x, t: model(x, t, None))
    spans = [s for s in spans if s.name != "host.gc"]
    root, = [s for s in spans if s.parent is None]
    assert root.name == "sampler.sample"
    assert root.attrs == {"method": method, "num_steps": n}
    steps = _children(spans, root)
    assert [s.attrs["i"] for s in steps] == list(range(n - 1))
    assert {s.name for s in steps} == {"sampler.step"}
    per_step = 1 if method == "euler" else 2
    for s in steps:
        forwards = _children(spans, s)
        assert [f.name for f in forwards] == ["model.forward"] * per_step
        for f in forwards:
            assert _inside(f, s)
            assert len(_under(spans, f, "model.block")) == DEPTH


def test_sde_and_dopri5_steps():
    model = _model().eval()
    sampler = Sampler(create_transport())
    z = torch.randn(2, 4, 8, 8, generator=torch.Generator().manual_seed(4))
    model_fn = lambda x, t: model(x, t, None)
    stats = {}
    with torch.no_grad(), recording() as spans:
        sampler.sample_sde(num_steps=4)(
            z, model_fn, generator=torch.Generator().manual_seed(5))
        sampler.sample_ode(num_steps=2)(z, model_fn, stats=stats)
    spans = [s for s in spans if s.name != "host.gc"]
    sde, ode = [s for s in spans if s.parent is None]
    assert (sde.attrs, ode.attrs) == ({"method": "Euler", "num_steps": 4},
                                      {"method": "dopri5", "num_steps": 2})
    assert len(_children(spans, sde)) == 3 + 1  # steps, then the last step
    stages = _children(spans, ode)
    assert [s.attrs["i"] for s in stages] == list(range(stats["drift_calls"]))
    assert len(_under(spans, ode, "model.forward")) == stats["drift_calls"]


def test_spans_share_the_profilers_clock():
    """A span around a ``record_function`` range contains the range as
    ``torch.profiler`` records it (Kineto's Unix-epoch ns), to 1 ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    a = torch.ones(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):
            a @ a
        with recording() as spans:
            with span("outer") as outer:
                with record_function("inner"):
                    for _ in range(20):
                        a @ a
    inner, = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "inner" and e.device_type() == DeviceType.CPU]
    lo, hi = inner.start_ns(), inner.start_ns() + inner.duration_ns()
    assert [s for s in spans if s.name != "host.gc"] == [outer]
    assert outer.start_ns <= lo + 1_000_000
    assert hi <= outer.end_ns + 1_000_000
    assert outer.end_ns - outer.start_ns < (hi - lo) + 5_000_000


def test_trace_shows_the_spans_with_recording_off(tmp_path):
    model = _model().eval()
    x = torch.randn(2, 4, 8, 8)
    with torch.no_grad(), trace(str(tmp_path / "t")):
        model(x, torch.full((2,), 0.5))
    assert profiling._recorder is None
    with open(tmp_path / "t" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"model.forward", "model.embed", "model.block",
            "model.head"} <= names


def test_a_torch_without_the_fast_range_imports_and_records(monkeypatch):
    """The bridge's range is a private torch symbol: a build without it
    loses the bridge and keeps the recorder."""
    import importlib.util
    monkeypatch.delattr(torch._C._profiler, "_RecordFunctionFast")
    spec = importlib.util.spec_from_file_location("profiling_without_range",
                                                  profiling.__file__)
    copy = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(copy)
    assert copy._Range is None
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        assert copy.span("model.block") is copy._OFF
        with copy.recording() as spans:
            with copy.span("train_step", step=0) as root:
                pass
    assert [s.name for s in spans] == ["train_step"]
    assert root._range is None and root.end_ns >= root.start_ns


def test_gc_collection_is_a_child_span():
    before = list(gc.callbacks)
    with recording() as spans:
        assert len(gc.callbacks) == len(before) + 1
        with span("outer") as outer:
            gc.collect()
    assert gc.callbacks == before
    collections = [s for s in spans if s.name == "host.gc"
                   and s.parent == outer.id]
    assert collections and collections[-1].attrs == {"generation": 2}
    assert all(_inside(s, outer) for s in collections)
    assert all(s.unit == outer.id for s in collections)


def test_recording_does_not_nest():
    with recording():
        with pytest.raises(RuntimeError, match="already on"):
            with recording():
                pass
    assert profiling._recorder is None


def test_other_threads_nest_under_the_open_unit():
    """Threads with no open span of their own (as the autograd engine's
    device thread) open spans under the unit thread's innermost span; more
    threads than cores and a short switch interval, so that a lost update
    of the shared stacks would show."""
    n_threads, n_spans = 16, 50
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with recording() as spans:
            with span("train_step") as root, span("train_step.backward") as bw:
                together = threading.Barrier(n_threads)

                def work():
                    together.wait(timeout=60)  # all alive: distinct idents
                    for i in range(n_spans):
                        with span("model.block", index=i):
                            with span("inner"):
                                pass
                threads = [threading.Thread(target=work)
                           for _ in range(n_threads)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=60)
                assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    spans = [s for s in spans if s.name != "host.gc"]
    blocks = [s for s in spans if s.name == "model.block"]
    inner = [s for s in spans if s.name == "inner"]
    assert len(blocks) == len(inner) == n_threads * n_spans
    assert all(b.parent == bw.id and b.unit == root.id for b in blocks)
    assert {b.thread for b in blocks}.isdisjoint({root.thread})
    assert len({b.thread for b in blocks}) == n_threads
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    assert all(by_id[s.parent].name == "model.block"
               and by_id[s.parent].thread == s.thread for s in inner)
