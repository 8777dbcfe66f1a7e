"""Build and load the port's CUDA kernels, and the launch helpers their
wrappers share.

At first use ``nvcc`` compiles every ``csrc/*.cu`` (one process per source,
all started together) and links the objects into one shared library with a
plain C interface, which is loaded with ``ctypes``.  The library goes into
``_build/`` inside the package (git-ignored), named by a hash of the sources,
headers and flags, so an edited source rebuilds and an unchanged one is
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

import torch

from .utils import profiling

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
    "-Xcompiler", "-fPIC",
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


def _run_all(cmds):
    """Run the commands at once; raise with the output of the first that
    fails, else return their outputs."""
    cmds = list(cmds)
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    outs = [p.communicate()[0] for p in procs]
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(c)}\n{out}")
    return outs


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
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(s) + ".o") for s in srcs]
        logs = _run_all(
            [nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", "-o", o, s]
            for s, o in zip(srcs, objs)
        )
        lib = os.path.join(tmp, "lib.so")
        logs += _run_all([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o", lib, *objs]])
        with open(out + ".log", "w") as f:
            f.write("".join(logs))
        os.replace(lib, out)  # atomic: a concurrent build never sees half a file
    return out


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C entry
    points' argument types (every pointer and the stream as c_void_p)."""
    lib = ctypes.CDLL(build())
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    cll, cu = ctypes.c_longlong, ctypes.c_uint
    entries = {
        "rcw_max_smem_words": [],
        "rcw_crossing_cast": [vp] * 6 + [ci] * 5 + [vp],
        "rcw_dda_cast": [vp] * 6 + [ci] * 6 + [vp],
        "rcw_dda_render_u32": [vp] * 7 + [ci] * 7 + [cf, cf, vp],
        "rcw_crossing_render_pal8": [vp] * 6 + [ci] * 6 + [cf, cf, vp],
        "rcw_threefry": [vp, cll, cll, vp] + [cu] * 6 + [ci, vp],
        "rcw_flood_fill": [vp] * 3 + [ci] * 4 + [vp],
        "rcw_u32_to_rgb": [vp, vp, cll, vp],
        "rcw_maze_reset": [vp, cll, cll] + [vp] * 10 + [ci] * 8 + [vp],
    }
    for name, argtypes in entries.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ci
    return lib


_THREADS = 128          # threads per block in every kernel
_MAX_RAY_CHUNKS = 65535  # grid.y limit


@functools.lru_cache(maxsize=None)
def _smem_cap_words() -> int:
    return load().rcw_max_smem_words()


def kernel_library(device, n_words: int, b: int, r: int, what: str,
                   **tensors) -> ctypes.CDLL:
    """The loaded library, once the launch of ``what`` on ``device`` is one
    its kernels take: a CUDA device, contiguous ``tensors``, ``n_words``
    packed words per env within the shared memory of a block, and a grid of
    ``b`` envs x ``r`` rays.  Raises otherwise."""
    if device.type != "cuda":
        raise ValueError(f"no {what} kernel for device {device}")
    for name, x in tensors.items():
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = load()
    if n_words > _smem_cap_words():
        raise ValueError(
            f"{what} needs {n_words} words of shared memory per env, more "
            f"than the kernel's block holds ({_smem_cap_words()})"
        )
    if b < 1 or r < 1 or -(-r // _THREADS) > _MAX_RAY_CHUNKS:
        raise ValueError(f"unsupported batch shape B={b}, R={r}")
    return lib


def launch(entry, device, *args, what: str) -> None:
    """Call the C entry ``entry(*args, stream)`` on ``device``'s current
    stream and raise if it reports a CUDA error (a refused launch).  The
    one place every kernel is launched: inside the span
    ``rcw.kernel.<kernel>``, counted as ``kernel_launches.<kernel>``, where
    ``<kernel>`` is the entry's name without ``rcw_`` (``crossing_cast``,
    ``crossing_render_pal8``, ``dda_cast``, ``dda_render_u32``, ``threefry``,
    ``flood_fill``, ``u32_to_rgb``, ``maze_reset``)."""
    kernel = entry.__name__.removeprefix("rcw_")
    with profiling.span(f"rcw.kernel.{kernel}"), torch.cuda.device(device):
        err = entry(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")
    profiling.count(f"kernel_launches.{kernel}")
