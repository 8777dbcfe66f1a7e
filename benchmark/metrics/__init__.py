"""Per-layer metrics, one module each, found by the metric's name in
``BENCHMARK.json``.

Each module names the program calls it needs wrapped in spans (``SPANS``:
span label -> target; ``"<object>.<method>"`` for an object the driver
built, ``"<module>:<name>"`` for a module or class attribute), which span
labels should keep the arguments of each call (``KEEP``), and
``read(trace, ctx)``, which returns the metric's value from the profiled
stretch (``trace``, a ``profile_trace.Trace``) or from the host stretch
(``ctx.host``, the same kind of object over host-clock spans), or None
where they hold nothing to read.  ``ctx`` also carries ``steps`` (the
profiled steps), ``kept`` (label -> list of argument tuples, from the
profiled stretch), ``config``, ``traffic`` and ``device``.
"""
