"""Build the port's C++ sources and load them with ctypes.

Each ``kvquant_tpu_torch/csrc/<name>.cu`` (device code) or
``csrc/<name>.cpp`` (host code) exposes a plain C interface and compiles
on first use into ``kvquant_tpu_torch/_build/`` (listed in .gitignore),
keyed by a hash of the source, the ``csrc`` headers it includes
(``#include "<name>.cuh"``) and the flags, so an edited source or header
is rebuilt:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o lib<name>-<hash>.so <name>.cu
    $CXX -std=c++17 -O3 -shared -fPIC -o lib<name>-<hash>.so <name>.cpp

(``$CXX`` defaults to ``g++``.) No PyTorch headers are included, so a
build takes seconds. Nothing is downloaded and nothing outside the
repository is compiled. A failed build raises with the compiler's output;
nothing falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]
HOST_FLAGS = ["-std=c++17", "-O3", "-shared", "-fPIC"]  # csrc/*.cpp

_loaded: dict[str, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}  # wall time of builds in this process


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda)")


def cxx_path() -> str:
    """The host compiler: ``$CXX`` if set, else ``g++``, found on PATH or
    as a path."""
    cxx = os.environ.get("CXX") or "g++"
    found = shutil.which(cxx)
    if found is None:
        raise RuntimeError(f"host compiler {cxx!r} not found ($CXX, else "
                           f"g++ on PATH)")
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources(path: str, seen: list) -> list:
    """``path`` and the headers beside it that it includes, transitively,
    in first inclusion order (quoted includes found elsewhere are not the
    repository's and are skipped)."""
    seen.append(path)
    with open(path, "rb") as f:
        text = f.read()
    for inc in _INCLUDE.findall(text):
        dep = os.path.join(os.path.dirname(path), inc.decode())
        if dep not in seen and os.path.exists(dep):
            _sources(dep, seen)
    return seen


def source_path(name: str, csrc_dir: str = None) -> str:
    """``<csrc_dir>/<name>.cu``, else ``<name>.cpp``."""
    csrc_dir = csrc_dir or CSRC_DIR
    for ext in (".cu", ".cpp"):
        path = os.path.join(csrc_dir, name + ext)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no {name}.cu or {name}.cpp in {csrc_dir}")


def _flags(src: str) -> list:
    return HOST_FLAGS if src.endswith(".cpp") else ARCH_FLAGS + FLAGS


def library_path(name: str, csrc_dir: str = None,
                 build_dir: str = None) -> str:
    """The library of ``<csrc_dir>/<name>.cu`` (or ``.cpp``), named by a
    hash of the source, every local header it includes and the flags."""
    src = source_path(name, csrc_dir)
    h = hashlib.sha256(" ".join(_flags(src)).encode())
    for path in _sources(src, []):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(build_dir or BUILD_DIR,
                        f"lib{name}-{h.hexdigest()[:16]}.so")


def build(name: str, verbose: bool = False) -> str:
    """Compile ``csrc/<name>.cu`` with nvcc (or ``csrc/<name>.cpp`` with
    the host compiler) unless an up-to-date library exists; returns the
    library path. ``verbose`` adds ``-Xptxas -v`` to nvcc and prints its
    report (registers, shared memory, spills per kernel)."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    src = source_path(name)
    host = src.endswith(".cpp")
    cmd = [cxx_path() if host else nvcc_path(), *_flags(src),
           *(["-Xptxas", "-v"] if verbose and not host else [])]
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd += ["-o", tmp, src]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds[name] = time.perf_counter() - t0
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"{os.path.basename(cmd[0])} failed for {os.path.basename(src)} "
            f"({res.returncode}):\n{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
    if verbose:
        print(res.stdout + res.stderr, flush=True)
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` or ``.cpp`` (building it if
    needed)."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name))
        _loaded[name] = lib
    return lib
