"""The port stands alone: no JAX and nothing of ``zigma_tpu`` in it.

A fresh interpreter imports every ``zigma_tpu_torch`` module and
``chip_smoke.py`` and must end with no ``jax*`` and no ``zigma_tpu`` /
``zigma_tpu.*`` module loaded (``zigma_tpu_torch`` itself shares the
prefix, so the match is exact).  An AST scan of the same files finds no
such import either, including imports inside functions.
"""

import ast
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "zigma_tpu_torch")


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith(("jax.", "jaxlib", "flax"))
            or name == "zigma_tpu" or name.startswith("zigma_tpu."))


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_importing_the_port_loads_no_jax():
    code = f"""
import importlib, json, pkgutil, sys
sys.path.insert(0, {REPO!r})
import zigma_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(zigma_tpu_torch.__path__,
                                              "zigma_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
print(json.dumps({{"imported": mods, "loaded": sorted(sys.modules)}}))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    for mod in ("cli.sample", "cli.serve", "ops.scan_cuda", "models.lm",
                "convert.mamba_lm", "evals.lm_harness",
                "tools.benchmark_generation", "parallel.mesh",
                "parallel.seq_parallel", "parallel.collectives"):
        assert f"zigma_tpu_torch.{mod}" in res["imported"]
    bad = [m for m in res["loaded"] if _forbidden(m)]
    assert bad == []


def test_no_jax_import_in_the_source():
    bad = []
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad += [f"{os.path.relpath(path, REPO)}: {n}"
                    for n in names if _forbidden(n)]
    assert len(_port_files()) > 20
    assert bad == []


def test_no_transformers_or_diffusers_outside_the_tokenizer():
    """The card has neither package: the port imports no ``diffusers``, and
    ``transformers`` only inside a function, for the CLIP tokenizer
    (``data/text.py``) and for a hub name's local-cache lookup
    (``convert/mamba_lm.py``)."""
    lazy_ok = {os.path.join("zigma_tpu_torch", "data", "text.py"),
               os.path.join("zigma_tpu_torch", "convert", "mamba_lm.py")}
    bad = []
    for path in _port_files():
        rel = os.path.relpath(path, REPO)
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        lazy = set()
        for fn in ast.walk(tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                lazy |= {id(n) for n in ast.walk(fn)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                allowed = (top == "transformers" and id(node) in lazy
                           and rel in lazy_ok)
                if top in ("transformers", "diffusers") and not allowed:
                    bad.append(f"{rel}: {n}")
    assert bad == []
