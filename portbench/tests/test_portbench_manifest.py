"""The benchmark's manifest and the files it names, the imports of the
harness and the reference, and the yardstick's arithmetic."""

import ast
import json
import os
import re
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, ROOT)

from portbench import harness, lookup, work  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_manifest_names_and_units(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in manifest["configs"]]
    names += [w["name"] for w in manifest["workloads"]]
    metrics = manifest["end_to_end"] + manifest["per_layer"]
    names += [m["name"] for m in metrics]
    names += [w["traffic"] for w in manifest["workloads"]]
    names += [k for c in manifest["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for group in ("configs", "workloads"):
        ns = [x["name"] for x in manifest[group]]
        assert len(ns) == len(set(ns))
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert any(m["name"] == "setup_s" for m in manifest["end_to_end"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in manifest["end_to_end"])
    assert 1 <= manifest["run_seconds"] <= 51


def test_every_cell_finds_its_files(manifest):
    e2e = {m["name"] for m in manifest["end_to_end"]}
    for w in manifest["workloads"]:
        _, cell, cfg, traffic, limits = harness.load_cell(w["name"])
        assert w["chips"] == 1
        assert traffic["rate_metric"] in e2e
        assert os.path.isfile(lookup.path(ROOT, "jobs", traffic["kind"],
                                          ".py"))
        assert limits and all(v > 0 for v in limits.values())
    for m in manifest["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics", m["name"] + ".py"))
        assert m["moves"] in e2e
        assert all(any(x["name"] == c for x in manifest["workloads"])
                   for c in m["workloads"])
    for c in manifest["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("portbench/")


FAMILY = ("build", "input_shape", "conditions", "forward_terms",
          "forward_flops", "scan_shapes")


def test_every_configuration_resolves_to_a_family(manifest):
    for c in manifest["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        name = cfg.get("family", lookup.DEFAULT_FAMILY)
        assert os.path.isfile(lookup.path(ROOT, "families", name, ".py"))
        family = lookup.family(cfg)
        assert all(callable(getattr(family, k)) for k in FAMILY)
        assert callable(family.reference.forward)


def test_every_traffic_kind_resolves_to_a_job_with_its_root_span():
    folder = os.path.join(BENCH, "traffic")
    kinds = set()
    for name in sorted(os.listdir(folder)):
        with open(os.path.join(folder, name)) as f:
            kinds.add(json.load(f)["kind"])
    assert kinds
    for kind in sorted(kinds):
        job = lookup.job(kind)
        assert isinstance(job.root_span, str) and job.root_span, kind
        assert job.faults and all(callable(f) for f in job.faults.values())


def _imports(path):
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_reference_imports_nothing_of_the_program():
    assert _imports(os.path.join(BENCH, "reference.py")) <= {
        "__future__", "math", "contextlib", "numpy", "torch"}
    code = ("import sys; sys.path.insert(0, %r); import portbench.reference; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'zigma_tpu_torch', 'zigma_tpu', 'jax', 'jaxlib', 'flax'}))"
            % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_harness_loads_no_jax():
    """Whole top-level names: the port's own name begins with the JAX
    package's, so a prefix would wrongly match it."""
    code = ("import sys; sys.path.insert(0, %r); from portbench import "
            "harness, lookup, faults, trace; "
            "lookup.family({}); lookup.job('train'); lookup.job('sample'); "
            "import zigma_tpu_torch.train, zigma_tpu_torch.transport, "
            "zigma_tpu_torch.models.zigma, zigma_tpu_torch.utils.inference; "
            "print(harness.forbidden_modules(), "
            "'zigma_tpu_torch' in sys.modules)" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.split() == ["[]", "True"]


def test_run_without_a_card_fails_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "zigzag8_b1_pe2.train_b16", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "no CUDA device" in out.stderr


def test_flops_match_the_programs_count_on_shared_terms():
    from zigma_tpu_torch.models.zigma import zigma_flops
    zigma = lookup.family({})
    for cfg, batch in (({"embed_dim": 768, "depth": 24, "img_dim": 32,
                         "patch_size": 1, "in_channels": 4}, 16),
                       ({"embed_dim": 32, "depth": 2, "img_dim": 8,
                         "patch_size": 2, "in_channels": 4}, 3)):
        terms = zigma.forward_terms(cfg, batch)
        shared = sum(terms[k] for k in ("in_proj", "x_proj", "dt_proj",
                                        "scan", "out_proj"))
        seq = (cfg["img_dim"] // cfg["patch_size"]) ** 2
        assert shared == zigma_flops(batch, seq, cfg["embed_dim"],
                                     cfg["depth"])
    flagship = {"embed_dim": 768, "depth": 24, "img_dim": 32,
                "patch_size": 1, "in_channels": 4}
    assert abs(zigma.forward_flops(flagship, 16) / 3.0311e12 - 1) < 1e-4


def test_kernel_least_times_at_the_flagship_shape():
    k1 = work.least_seconds(work.k1_work(16, 1024, 1536, 16, 2), 132, 1980)
    k2 = work.least_seconds(work.k2_work(16, 1024, 1536, 16, 2), 132, 1980)
    assert round(k1 * 1e3, 4) == 0.1143
    assert round(k2 * 1e3, 4) == 0.1502


def test_video_scan_shapes():
    cfg = {"embed_dim": 768, "depth": 24, "img_dim": 32, "patch_size": 2,
           "video_frames": 16, "scan_type": "zzvideo_sst"}
    shapes = lookup.family(cfg).scan_shapes(cfg, 20)
    assert shapes.count((320, 256, 1536, 16)) == 16
    assert shapes.count((5120, 16, 1536, 16)) == 8
