"""ctypes binding and on-demand build of the native tar reader (``zt_tar.cc``).

Own copy of ``zigma_tpu/native/tar_reader.py`` with one change: the shared
library is built with ``g++`` at first use into ``zigma_tpu_torch/build/``
(listed in ``.gitignore``), keyed on a hash of the flags and the source, not
next to the source.  Nothing is built at import time.  If no compiler is
available the build fails once, with a warning, and ``available()`` is false:
callers then read shards with Python's ``tarfile``.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from typing import Iterator, Optional

__all__ = ["NativeTar", "available", "native_tar_samples"]

log = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "zt_tar.cc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _lib_path() -> str:
    key = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        key.update(f.read())
    return os.path.join(BUILD_DIR, f"libzt_tar-{key.hexdigest()[:16]}.so")


def _build(path: str) -> bool:
    # build to a per-process temp file, then rename: concurrent loader
    # processes must never dlopen a half-written library
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = ["g++", *CXX_FLAGS, _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)
        return True
    except (subprocess.SubprocessError, OSError) as e:
        log.warning("native tar reader build failed (%s); using python tarfile",
                    e)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        path = _lib_path()
        if not os.path.exists(path) and not _build(path):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:  # corrupt library: fall back, don't crash
            log.warning("native tar reader unloadable (%s); using python "
                        "tarfile", e)
            _build_failed = True
            return None
        lib.zt_open.restype = ctypes.c_void_p
        lib.zt_open.argtypes = [ctypes.c_char_p]
        lib.zt_count.restype = ctypes.c_long
        lib.zt_count.argtypes = [ctypes.c_void_p]
        lib.zt_name.restype = ctypes.c_char_p
        lib.zt_name.argtypes = [ctypes.c_void_p, ctypes.c_long]
        lib.zt_size.restype = ctypes.c_long
        lib.zt_size.argtypes = [ctypes.c_void_p, ctypes.c_long]
        lib.zt_read.restype = ctypes.c_long
        lib.zt_read.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                ctypes.c_void_p, ctypes.c_long]
        lib.zt_close.restype = None
        lib.zt_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native reader built (building it on the first call)."""
    return _load() is not None


class NativeTar:
    """Indexed random-access tar (native).  Context-manager friendly."""

    def __init__(self, path: str):
        lib = _load()
        if lib is None:
            raise RuntimeError("native tar reader unavailable")
        self._lib = lib
        self._h = lib.zt_open(path.encode())
        if not self._h:
            raise OSError(f"zt_open failed for {path}")
        self.path = path

    def __len__(self) -> int:
        return self._lib.zt_count(self._h)

    def name(self, i: int) -> str:
        nm = self._lib.zt_name(self._h, i)
        if nm is None:
            raise IndexError(i)
        return nm.decode()

    def read(self, i: int) -> bytes:
        size = self._lib.zt_size(self._h, i)
        if size < 0:
            raise IndexError(i)
        buf = ctypes.create_string_buffer(size)
        got = self._lib.zt_read(self._h, i, buf, size)
        if got != size:
            raise OSError(f"short read: {got} != {size} ({self.path}:{i})")
        return buf.raw

    def close(self):
        if self._h:
            self._lib.zt_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def native_tar_samples(url: str) -> Iterator[dict]:
    """Drop-in for ``data.wds.tar_samples`` using the native reader: yields
    ``{'__key__': ..., '<ext>': bytes, ...}`` grouped by basename prefix."""
    with NativeTar(url) as tar:
        current_key, sample = None, {}
        for i in range(len(tar)):
            name = tar.name(i)
            base = os.path.basename(name)
            if "." not in base:
                key, ext = base, ""
            else:
                key, ext = base.split(".", 1)
            key = os.path.join(os.path.dirname(name), key)
            if key != current_key:
                if sample:
                    yield sample
                current_key, sample = key, {"__key__": key}
            sample[ext] = tar.read(i)
        if sample:
            yield sample
