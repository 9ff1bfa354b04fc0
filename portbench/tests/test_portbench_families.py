"""The harness takes a configuration of another model family and a new kind
of work by new files and new manifest entries alone: in a copy of the
benchmark, a family, a job, a configuration, a traffic mix, its limits
and a per-layer metric's reader are added, the new cell runs ``correct``
on the CPU from them, and every file that was there before is unchanged.
A name with no file fails naming the file looked for."""

import hashlib
import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402

SEED = 2 ** 31 + 4099
CELL = "twin_tiny.forward_b2"

FAMILY = '''"""ZigMa under another family name: ZigMa's functions reused."""
from portbench.families.zigma import (build, conditions, forward_flops,
                                      forward_terms, input_shape, reference,
                                      scan_shapes)
'''

JOB = '''"""forward: one model forward a unit at fixed t, checked against the
family's reference forward."""
import torch
from portbench import weights as W


class Forwards:
    root_span = "model.forward"
    faults = {}
    forwards_per_unit = 1

    def __init__(self, family, cfg, traffic, seed, device):
        self.family, self.cfg, self.device = family, cfg, device
        self.batch = traffic["batch"]
        self.model, self.weights = family.build(cfg, seed, device)
        self.model.eval().requires_grad_(False)
        gen = W.generator(device, seed, 1)
        self.x = W.normal(family.input_shape(cfg, self.batch), gen, device)
        self.t = torch.full((self.batch,), traffic["t"], device=device)
        self.outputs = []

    def setup(self):
        self.unit()

    def unit(self):
        with torch.inference_mode():
            return self.model(self.x, self.t, None)

    def record(self, out):
        self.outputs.append(out)

    def samples(self, units):
        return units * self.batch

    def failed(self):
        return sum(int((~torch.isfinite(o)).any()) for o in self.outputs)

    def release(self):
        del self.model

    def check(self):
        with self.family.reference.fp32_matmuls():
            ref = self.family.reference.forward(self.weights, self.x,
                                                self.t, None, self.cfg)
        gap = (self.outputs[-1].float() - ref).abs().amax() / ref.abs().amax()
        return {"forward_max_gap": float(gap)}


JOB = Forwards
'''

READER = '''"""mfu.forward: the window's forwards' FLOPs (the family's count) over
its time and the bf16 peak."""
from portbench.work import PEAK


def read(run):
    flops = run.family.forward_flops(run.cfg, run.job.batch) * run.units
    return 100.0 * flops / run.window_s / PEAK["bf16_flops"]
'''

CONFIG = {"family": "zigma_twin", "img_dim": 8, "in_channels": 4,
          "patch_size": 2, "embed_dim": 32, "depth": 2,
          "scan_type": "zigzagN8", "use_pe": 2, "use_checkpoint": False,
          "drop_path_rate": 0.0, "num_classes": -1,
          "class_dropout_prob": 0.0, "video_frames": 0, "tpe": False,
          "d_state": 16, "d_conv": 4, "expand": 2, "norm_epsilon": 1e-5,
          "mixed_precision": "fp32"}
TRAFFIC = {"why": "one forward a unit", "kind": "forward",
           "rate_metric": "forwards_per_s", "batch": 2, "t": 0.5,
           "trace_units": 1}
ENTRIES = {
    "configs": {"name": "twin_tiny", "source": "https://example.org/twin",
                "file": "portbench/configs/twin_tiny.json", "reduced": [],
                "why": "a second family"},
    "workloads": {"name": CELL, "config": "twin_tiny",
                  "traffic": "forward_b2", "chips": 1,
                  "why": "a new kind of work"},
    "end_to_end": {"name": "forwards_per_s", "unit": "forwards/s",
                   "better": "higher", "bound": 0.01, "source": "host_clock",
                   "workloads": [CELL]},
    "per_layer": {"name": "mfu.forward", "unit": "%", "better": "higher",
                  "source": "host_clock", "layer": "whole step",
                  "moves": "forwards_per_s", "workloads": [CELL]},
}
NEW = {"families/zigma_twin.py": FAMILY, "jobs/forward.py": JOB,
       "metrics/mfu.forward.py": READER,
       "configs/twin_tiny.json": json.dumps(CONFIG),
       "traffic/forward_b2.json": json.dumps(TRAFFIC),
       "limits/twin_tiny.forward_b2.json": '{"forward_max_gap": 1e-3}'}


def _digests(root):
    out = {}
    for folder, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for name in files:
            path = os.path.join(folder, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    f.read()).hexdigest()
    return out


@pytest.fixture
def tree(tmp_path):
    """A copy of the benchmark with the new cell's files and manifest
    entries added: yields its root; afterwards, every file the copy had
    before is unchanged but the manifest, to which entries were only
    appended."""
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    before = _digests(tmp_path)
    for rel, text in NEW.items():
        path = tmp_path / "portbench" / rel
        assert not path.exists(), rel
        path.write_text(text)
    manifest_path = tmp_path / "BENCHMARK.json"
    old = json.loads(manifest_path.read_text())
    new = json.loads(manifest_path.read_text())
    for group, entry in ENTRIES.items():
        new[group].append(entry)
    manifest_path.write_text(json.dumps(new, indent=2))
    yield str(tmp_path)
    after = _digests(tmp_path)
    changed = [k for k, v in before.items()
               if k != "BENCHMARK.json" and after.get(k) != v]
    assert not changed, changed
    now = json.loads(manifest_path.read_text())
    assert all(now[k] == v + ([ENTRIES[k]] if k in ENTRIES else [])
               if isinstance(v, list) else now[k] == v
               for k, v in old.items())


@pytest.mark.parametrize("trace", [0, 1])
def test_a_new_family_and_kind_run_from_new_files_alone(tree, trace):
    r = harness.run_cell(CELL, SEED, 0.2, trace, "cpu", root=tree)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert set(r["checks"]) == {"forward_max_gap"}
    if trace:
        assert set(r["metrics"]) == {"mfu.forward"}
        assert r["metrics"]["mfu.forward"]["value"] > 0
    else:
        assert set(r["metrics"]) == {"forwards_per_s", "peak_mem_gib",
                                     "setup_s"}


@pytest.mark.parametrize("override,looked_for", [
    ({"cfg_override": {"family": "no_such_family"}},
     "families/no_such_family.py"),
    ({"traffic_override": {"kind": "no_such_kind"}}, "jobs/no_such_kind.py")])
def test_an_unknown_family_or_kind_names_the_file_looked_for(
        tree, override, looked_for):
    with pytest.raises(SystemExit) as e:
        harness.run_cell(CELL, SEED, 0.2, 0, "cpu", root=tree, **override)
    assert os.path.join(tree, "portbench", looked_for) in str(e.value)
