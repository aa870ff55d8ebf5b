"""Build, load and count the port's hand-written CUDA kernels.

Every ``csrc/<name>.cu`` is compiled at first use by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface, under
``build/repro_torch/`` at the root of the checkout, and loaded with
``ctypes``.  All sources are compiled together, one ``nvcc`` process per
source started at once.  A library's file name carries a hash of its
sources and flags, so an edited source is rebuilt and a stale library is
never loaded.  A failed build raises.

Every wrapper adds one to its kernel's launch count where it launches the
kernel, and nowhere else; :func:`launch_counts` reads the counts and
:func:`reset_launch_counts` sets them to zero, so a run can show that it
went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("histogram", "partition", "traversal")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

KERNELS = ("histogram", "histogram_nibble", "histogram_naive", "partition",
           "partition_nibble", "traversal", "ensemble")
_launches: Dict[str, int] = {k: 0 for k in KERNELS}
_libs: Dict[str, ctypes.CDLL] = {}

POINTER = ctypes.c_void_p
INT = ctypes.c_int
INT64 = ctypes.c_longlong


def count(kernel: str) -> None:
    _launches[kernel] += 1


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       f"{home}/bin); the CUDA kernels cannot be built")


def _library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for part in (CSRC / f"{name}.cu", CSRC / "launch.cuh"):
        digest.update(part.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, all in parallel.

    Returns ``{source: library path}``.  ptxas' register and shared-memory
    report for each kernel is kept beside its library as ``<lib>.log``.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _library_path(name) for name in SOURCES}
    jobs = {}
    for name, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, path)
    failed = []
    for name, (proc, tmp, path) in jobs.items():
        log, _ = proc.communicate()
        path.with_suffix(".so.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building all on first use."""
    lib = _libs.get(name)
    if lib is None:
        for src, path in build_all().items():
            if src not in _libs:
                _libs[src] = ctypes.CDLL(str(path))
                _libs[src].repro_error_string.argtypes = [INT]
                _libs[src].repro_error_string.restype = ctypes.c_char_p
        lib = _libs[name]
    return lib


def function(source: str, symbol: str, argtypes: Sequence):
    """A C launch entry with its argument types declared (pointers and the
    stream as ``c_void_p``, so ctypes never cuts them to 32 bits)."""
    fn = getattr(library(source), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = INT
    return fn


def check(source: str, err: int, what: str) -> None:
    """Raise if a launch entry reported a CUDA error."""
    if err != 0:
        msg = library(source).repro_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} "
                           f"({msg})")
