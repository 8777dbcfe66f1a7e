"""Build and load the port's CUDA kernels.

At first use ``nvcc`` compiles every ``csrc/*.cu`` into one shared library
with a plain C interface, which is loaded with ``ctypes``.  The library goes
into ``_build/`` inside the package (git-ignored), named by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
reused.  Nothing here runs at import time: the CPU-only test machines have
no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # No FMA contraction and IEEE divides: the kernels must equal their
    # plain PyTorch versions bit for bit (no --use_fast_math either).
    "-fmad=false", "-prec-div=true", "-prec-sqrt=true",
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels are built from source at first use"
    )


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    hdrs = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs, hdrs


def library_path() -> str:
    srcs, hdrs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + hdrs:
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"librcw_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels unless a library for these sources exists;
    returns its path.  nvcc's report (ptxas registers, shared memory and
    spills per kernel) goes to the path plus ``.log``.  Raises with nvcc's
    output if the build fails."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    srcs, _ = _sources()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp, *srcs],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
            )
        with open(out + ".log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C entry
    points' argument types (every pointer and the stream as c_void_p)."""
    lib = ctypes.CDLL(build())
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rcw_crossing_cast.argtypes = [vp] * 6 + [ci] * 5 + [vp]
    lib.rcw_crossing_cast.restype = ci
    lib.rcw_crossing_cast_max_words.argtypes = []
    lib.rcw_crossing_cast_max_words.restype = ci
    return lib
