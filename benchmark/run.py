"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload single_room_64.device_loop_4096 \
        --seed 7 --seconds 20 --trace 0

Run from the root of a checkout that holds the port beside this folder.
Exits non-zero, printing no result, where the cell's CUDA devices are not
there or where the run loaded JAX or the JAX package.  The port's kernel
build (``raycastworlds_tpu_torch/_build/``) and any torch extension or
Triton cache stay inside the checkout, at fixed paths.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "_bench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
