"""Build of the port's CUDA sources.

Each source under a kernel's ``csrc/`` has a plain C interface. It is
compiled with ``nvcc`` for ``sm_90a`` into a shared library, loaded with
``ctypes``, at first use. The library lands in ``build/repro_torch_kernels/``
of the checkout, named by a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is not. The first build of a source
prints ptxas's register and spill report to stderr.

``launches`` counts, per kernel name, the launches each wrapper made; a
wrapper adds one where it launches its kernel and nowhere else.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import sys
import time

BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: kernel name -> number of launches since the counts were last cleared
launches: collections.Counter = collections.Counter()
#: kernel name -> {"seconds", "built", "ptxas"}: the load's wall time, whether
#: it compiled, and ptxas's report when it did
builds: dict[str, dict] = {}
_libraries: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",  # the CUDA toolkit's default location
    ]
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def load_library(name: str, source: pathlib.Path) -> ctypes.CDLL:
    """Compile ``source`` (if its hash has no library yet) and load it."""
    if name in _libraries:
        return _libraries[name]
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    path = BUILD_DIR / f"{name}-{digest}.so"
    t0 = time.perf_counter()
    built = not path.exists()
    ptxas = ""
    if built:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
            capture_output=True, text=True,
        )
        ptxas = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name}:\n{ptxas}")
        os.replace(tmp, path)
        print(f"[build] {source.name}:\n{ptxas}", file=sys.stderr)
    lib = ctypes.CDLL(str(path))
    builds[name] = {
        "seconds": time.perf_counter() - t0,
        "built": built,
        "ptxas": ptxas,
    }
    _libraries[name] = lib
    return lib


def loaded() -> frozenset:
    """Names of the libraries this process has built or loaded."""
    return frozenset(_libraries)
