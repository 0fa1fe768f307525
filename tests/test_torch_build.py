"""The port's kernel build cache (kvquant_tpu_torch/ops/kernels/build.py):
a library is named by a hash of its CUDA source, the csrc headers that
source includes and the nvcc flags, so that editing a shared header
rebuilds every library that includes it. CPU only: nothing is compiled."""

import os

import pytest

from kvquant_tpu_torch.ops.kernels import build


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)


def test_library_path_hashes_included_headers(tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    _write(csrc / "shared.cuh", "#pragma once\n#include \"inner.cuh\"\n")
    _write(csrc / "inner.cuh", "#pragma once\nconstexpr int K = 1;\n")
    _write(csrc / "a.cu", "#include <cuda_runtime.h>\n#include \"shared.cuh\"\n")
    _write(csrc / "b.cu", "#include <cuda_runtime.h>\n")
    path = lambda n: build.library_path(n, str(csrc), str(tmp_path / "out"))
    a0, b0 = path("a"), path("b")
    assert os.path.dirname(a0) == str(tmp_path / "out")
    assert os.path.basename(a0).startswith("liba-") and a0.endswith(".so")

    _write(csrc / "inner.cuh", "#pragma once\nconstexpr int K = 2;\n")
    a1 = path("a")
    assert a1 != a0  # a header two includes deep moves the includer
    assert path("b") == b0  # a source that does not include it stays
    _write(csrc / "shared.cuh", "#pragma once\n#include \"inner.cuh\"\n// x\n")
    assert path("a") not in (a0, a1)

    _write(csrc / "b.cu", "#include <cuda_runtime.h>\n// edited\n")
    assert path("b") != b0


def test_host_library_path_hashes_source_and_flags(tmp_path, monkeypatch):
    """A host source (csrc/<name>.cpp, built with $CXX) is keyed like a
    CUDA one: by its text, the local headers it includes and its flags."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    _write(csrc / "h.cuh", "#pragma once\nconstexpr int K = 1;\n")
    _write(csrc / "p.cpp", "#include <cstdint>\n#include \"h.cuh\"\n")
    path = lambda: build.library_path("p", str(csrc), str(tmp_path / "out"))
    p0 = path()
    assert os.path.basename(p0).startswith("libp-") and p0.endswith(".so")
    assert build.source_path("p", str(csrc)) == str(csrc / "p.cpp")
    assert path() == p0  # stable

    _write(csrc / "p.cpp", "#include <cstdint>\n#include \"h.cuh\"\n// e\n")
    p1 = path()
    assert p1 != p0
    _write(csrc / "h.cuh", "#pragma once\nconstexpr int K = 2;\n")
    p2 = path()
    assert p2 not in (p0, p1)
    monkeypatch.setattr(build, "HOST_FLAGS", build.HOST_FLAGS + ["-g"])
    assert path() not in (p0, p1, p2)
    monkeypatch.undo()
    monkeypatch.setattr(build, "FLAGS", build.FLAGS + ["-g"])
    assert path() == p2  # nvcc's flags do not key a host library


def test_library_path_of_the_repository_sources():
    """Every committed source resolves (its local includes exist) and the
    names differ between sources."""
    names = sorted(f[:-3] for f in os.listdir(build.CSRC_DIR)
                   if f.endswith(".cu"))
    assert {"flash_serial", "flash_decode", "attention"} <= set(names)
    paths = [build.library_path(n) for n in names]
    assert len(set(paths)) == len(paths)
    with pytest.raises(FileNotFoundError):
        build.library_path("no_such_source")


@pytest.mark.parametrize("name", ["flash_decode", "attention"])
def test_shared_device_helpers_key_both_sources(name):
    """K1 / K5 (flash_decode.cu) and K3 / K4 (attention.cu) take their
    shared device helpers from csrc/hopper.cuh: the header is part of each
    library's key, so an edit there rebuilds both. fd_chunk's wgmma helpers
    (csrc/wgmma.cuh) key flash_decode.cu alone."""
    own = ["wgmma.cuh"] if name == "flash_decode" else []
    deps = build._sources(os.path.join(build.CSRC_DIR, f"{name}.cu"), [])
    assert [os.path.basename(p) for p in deps] == [f"{name}.cu", "hopper.cuh",
                                                   *own]
