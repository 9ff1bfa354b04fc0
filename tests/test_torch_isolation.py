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
    assert "zigma_tpu_torch.cli.sample" in res["imported"]
    assert "zigma_tpu_torch.ops.scan_cuda" in res["imported"]
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
