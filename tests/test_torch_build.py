"""The CUDA build's cache key (``zigma_tpu_torch.ops._build``); nothing is
compiled here.

A library is reused while its key holds, so the key must change with the
flags, the ``.cu`` source and every ``csrc`` header the source includes,
directly or through another header; and with nothing else.
"""

import os

import pytest

from zigma_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    files = {
        "k.cu": '#include <cuda_runtime.h>\n#include "a.cuh"\nint k;\n',
        "a.cuh": '#pragma once\n  #  include "b.cuh"\n',
        "b.cuh": "#pragma once\nconstexpr int kB = 1;\n",
        "other.cuh": "#pragma once\n",
    }
    for name, text in files.items():
        (tmp_path / name).write_text(text)
    return tmp_path


def test_key_follows_included_headers(csrc):
    assert _build._sources_of("k.cu") == ["k.cu", "a.cuh", "b.cuh"]
    key = _build._lib_path("k.cu")
    assert os.path.basename(key).startswith("libk-")
    (csrc / "other.cuh").write_text("#pragma once\nint changed;\n")
    assert _build._lib_path("k.cu") == key  # not included: same library
    (csrc / "b.cuh").write_text("#pragma once\nconstexpr int kB = 2;\n")
    key_b = _build._lib_path("k.cu")
    assert key_b != key  # a header included through a header
    (csrc / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n// edit\n')
    assert _build._lib_path("k.cu") not in (key, key_b)


def test_forward_kernel_key_covers_its_header():
    """K1 includes scan_common.cuh: both go into its key."""
    assert _build._sources_of("selective_scan_fwd.cu") == [
        "selective_scan_fwd.cu", "scan_common.cuh"]
    for src in _build.SOURCES:
        assert os.path.dirname(_build._lib_path(src)) == _build.BUILD_DIR


def test_backward_kernel_key_covers_the_shared_header(tmp_path, monkeypatch):
    """K2 includes scan_common.cuh too: an edit to the header alone gives
    both kernels a new library."""
    assert _build._sources_of("selective_scan_bwd.cu") == [
        "selective_scan_bwd.cu", "scan_common.cuh"]
    for name in ("selective_scan_fwd.cu", "selective_scan_bwd.cu",
                 "scan_common.cuh"):
        with open(os.path.join(_build.CSRC, name)) as f:
            (tmp_path / name).write_text(f.read())
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    keys = {src: _build._lib_path(src) for src in _build.SOURCES}
    with open(tmp_path / "scan_common.cuh", "a") as f:
        f.write("// edit\n")
    for src in _build.SOURCES:
        assert _build._lib_path(src) != keys[src], src
