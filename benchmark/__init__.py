"""The benchmark of ``raycastworlds_tpu_torch`` on one NVIDIA H100.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line.  Configurations (``configs/``), traffic mixes (``traffic/``), loop
drivers (``drivers/``) and per-layer metrics (``metrics/``) are found by
name; the plain reference that decides ``correct`` is ``reference/``.
"""
