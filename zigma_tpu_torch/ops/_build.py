"""Build the package's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/*.cu`` file is compiled on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), keyed on a
hash of the flags, the source and every ``csrc`` header it includes
(``#include "..."``, followed through headers); ``build_all`` starts one
``nvcc`` per missing library, all at once, and waits for them together.
Libraries go to ``zigma_tpu_torch/build/`` (listed in ``.gitignore``;
delete it to force a rebuild).  Nothing is built at
import time: the first launch of a kernel builds it, or ``build_all()`` does
all of them up front.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time

__all__ = ["SOURCES", "build_all", "load", "nvcc_path"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
SOURCES = ("selective_scan_fwd.cu", "selective_scan_bwd.cu",
           "causal_conv1d.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)

_loaded: dict = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA "
                       "kernels are built from zigma_tpu_torch/csrc at first use")


def _sources_of(source: str) -> list:
    """``source`` and the ``csrc`` files it includes with ``#include "..."``,
    directly or through other headers, each once, in the order met."""
    seen, todo = [], [source]
    while todo:
        name = todo.pop(0)
        if name in seen:
            continue
        seen.append(name)
        with open(os.path.join(CSRC, name), "rb") as f:
            todo += [m.decode() for m in _INCLUDE.findall(f.read())]
    return seen


def _lib_path(source: str) -> str:
    key = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _sources_of(source):
        with open(os.path.join(CSRC, name), "rb") as f:
            key.update(name.encode() + b"\0" + f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{key.hexdigest()[:16]}.so")


def build_all(sources=SOURCES) -> dict:
    """Compile every missing library, one ``nvcc`` per source, in parallel.
    Returns ``{source: {"path", "seconds", "log"}}``; raises on a failed
    build (after every started ``nvcc`` has ended)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    report, running = {}, {}
    t0 = time.perf_counter()
    for src in sources:
        path = _lib_path(src)
        if os.path.exists(path):
            report[src] = {"path": path, "seconds": 0.0, "log": "cached"}
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[src] = (proc, path, tmp)
    failed = []
    for src, (proc, path, tmp) in running.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src} (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)
        report[src] = {"path": path, "seconds": time.perf_counter() - t0,
                       "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return report


def load(source: str) -> ctypes.CDLL:
    """The loaded library for ``source``, building it first if needed."""
    lib = _loaded.get(source)
    if lib is None:
        path = _lib_path(source)
        if not os.path.exists(path):
            build_all((source,))
        lib = _loaded[source] = ctypes.CDLL(path)
    return lib
